"""Conditioned, masked linear algebra for GP factorizations.

Counterpart of ``tpubq/ops/linalg.py``: identity-padded Grams (``pad_gram``),
the jitter ladder (``jitter_cholesky``) and its solves. Every function takes
an optional leading batch axis. A failed factorization is a NaN factor (the
contract of ``jnp.linalg.cholesky`` that the ladder's finiteness checks
consume); ``torch.linalg.cholesky_ex`` reports failure through ``info``
instead, so ``_lib_cholesky`` turns a non-zero ``info`` into NaN.

Routes for float32 tensors on a CUDA device that need no gradient
(``hopper_kernels.kernel_route``), chosen from shapes before any launch:
the unbatched jitter ladder factors with ``cholesky_blocked``; a batched
factorization goes to ``chol_batch`` (n ≤ 240) or ``cholesky_batched``
(above); a triangular solve or Cholesky solve under one unbatched factor goes
to ``tri_solve_blocked``, with the right-hand sides of every batch entry as
its columns, and a back substitution as a forward one on the flipped factor.
float64 and batched factors stay with the library.
"""

from __future__ import annotations

import torch

from tpubq_torch.ops import hopper_kernels as hk

__all__ = [
    "pad_gram",
    "cholesky_fixed",
    "cholesky_fixed_fn",
    "posdef_cholesky",
    "posdef_cholesky_batched",
    "jitter_cholesky",
    "chol_solve",
    "tri_solve",
    "chol_solve_vec",
    "chol_inverse",
    "masked_logdet",
    "remove_jitter",
]

#: Relative jitter ladder (multiples of the mean live diagonal), float64.
JITTER_LADDER = (0.0, 1e-12, 1e-10, 1e-8, 1e-6, 1e-4, 1e-2)

#: float32 ladder: rungs below ~1e-6 round away against an f32 diagonal, and
#: K + 1e-4·scale·I of a PSD kernel Gram is well inside f32 Cholesky's reach,
#: so only non-finite inputs fail both rungs.
JITTER_LADDER_F32 = (0.0, 1e-4)


def _eye(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def pad_gram(K: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero padded rows/cols (``mask`` False) and put 1 on their diagonal, so
    the factor restricts to the live block and pads factor to identity."""
    m = mask.to(K.dtype)
    mm = m[..., :, None] * m[..., None, :]
    return K * mm + _eye(K) * (1.0 - m)[..., None, :]


def _diag_scale(K: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of the live diagonal → (...)."""
    m = mask.to(K.dtype)
    n = torch.clamp(m.sum(-1), min=1.0)
    return (torch.diagonal(K, dim1=-2, dim2=-1) * m).sum(-1) / n


def _lib_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Library Cholesky with NaN in each matrix that is not positive definite
    (no host sync: ``info`` is consumed on the device)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, float("nan"))


def cholesky_fixed_fn(mask: torch.Tensor, dtype: torch.dtype, jitter: float = 1e-12,
                      kernel: bool = False):
    """``cholesky_fixed`` as a function K → (L, the absolute jitter), with the
    terms that depend only on the mask formed once: the slice sampler factors
    a new Gram of the same data every lock-step iteration.

    ``kernel`` sends a float32 stack on the card that needs no gradient to
    ``posdef_cholesky_batched`` (``chol_batch``); only the sampler's log
    densities set it. Every other caller (the L-BFGS fit, its restart
    scoring under ``no_grad`` too) factors with the library."""
    m = mask.to(dtype)
    eye = torch.eye(mask.shape[-1], dtype=dtype, device=mask.device)
    mm = m[..., :, None] * m[..., None, :]
    pad = eye * (1.0 - m)[..., None, :]
    live = eye * m[..., None, :]
    n_live = torch.clamp(m.sum(-1), min=1.0)

    def factor(K: torch.Tensor):
        jit = jitter * ((torch.diagonal(K, dim1=-2, dim2=-1) * m).sum(-1) / n_live)
        Kp = K * mm + pad + jit[..., None, None] * live
        if kernel and hk.kernel_route(Kp):
            n = Kp.shape[-1]
            return posdef_cholesky_batched(Kp.reshape(-1, n, n)).reshape(Kp.shape), jit
        return _lib_cholesky(Kp), jit

    return factor


def cholesky_fixed(K: torch.Tensor, mask: torch.Tensor, jitter: float = 1e-12) -> torch.Tensor:
    """Single masked Cholesky with a fixed relative jitter (the library's)."""
    return cholesky_fixed_fn(mask, K.dtype, jitter)(K)[0]


def batched_cholesky(Ks: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """``cholesky_fixed`` over a leading batch axis, one mask per matrix."""
    return cholesky_fixed_fn(masks, Ks.dtype)(Ks)[0]


def posdef_cholesky_batched(A: torch.Tensor) -> torch.Tensor:
    """Cholesky of a (BT, n, n) stack of identity-padded Grams.

    A float32 stack on a CUDA device goes to a hand-written kernel at any BT:
    ``chol_batch`` (the port of the TPU's ``cholesky_batch_major``; on the
    H100 it beats the library from BT = 2 up) where ``chol_batch_supported(n)``,
    ``cholesky_batched`` above that. float64 goes to the library Cholesky,
    where the JAX package sends it to ``jnp.linalg.cholesky``. Either way a
    matrix that is not positive definite gets NaN in its own entry only.
    """
    if hk.kernel_route(A):
        return hk.chol_batch(A) if hk.chol_batch_supported(A.shape[-1]) else hk.cholesky_batched(A)
    return _lib_cholesky(A)


def posdef_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Cholesky of one (n, n) matrix, NaN where it is not positive definite:
    ``cholesky_blocked`` on the kernel route, the library elsewhere (the
    JAX package's ``posdef_cholesky`` for one matrix)."""
    return hk.cholesky_blocked(A) if hk.kernel_route(A) else _lib_cholesky(A)


def _finite_diag(L: torch.Tensor) -> torch.Tensor:
    # A non-finite L[i, j] (j < i) poisons diagonal i, so the diagonal alone
    # detects every failure.
    return torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1)).all(-1)


def jitter_cholesky(K: torch.Tensor, mask: torch.Tensor, base_jitter: float = 0.0):
    """Masked Cholesky with an escalating jitter ladder → (L, jitter, ok).

    ``base_jitter`` must be a Python float: the float32 path decides from it
    whether the rung-0 add is a no-op.

    * float64: the 7-rung ``JITTER_LADDER`` with early exit. Batched, a rung
      is refactored only while some matrix still fails, and each matrix keeps
      its first finite rung (one host sync per rung).
    * float32, unbatched: factor rung 0 and refactor at the 1e-4 rung only
      when rung 0 failed (one host sync).
    * float32, batched: both rungs stacked as (B, 2, n, n) and factored as one
      flat batch through ``posdef_cholesky_batched``; the rung is selected by
      data flow, with no host sync.

    ``jitter`` is in absolute units; the float32 path reports rung 0's jitter
    even when its add was skipped.
    """
    if not isinstance(base_jitter, (int, float)):
        raise TypeError("base_jitter must be a Python float")
    base_jitter = float(base_jitter)
    dtype = K.dtype
    n = K.shape[-1]
    scale = _diag_scale(K, mask)
    Kp = pad_gram(K, mask)
    eye_live = _eye(K) * mask.to(dtype)[..., None, :]

    if dtype == torch.float32:
        j0 = torch.tensor(base_jitter, dtype=dtype, device=K.device) * scale
        j1 = (
            torch.tensor(JITTER_LADDER_F32[1], dtype=dtype, device=K.device)
            + torch.tensor(base_jitter, dtype=dtype, device=K.device)
        ) * scale
        Kp0 = Kp if base_jitter < 1e-8 else Kp + eye_live * j0[..., None, None]
        if K.ndim == 2:
            L0 = posdef_cholesky(Kp0)
            ok0 = _finite_diag(L0)
            if bool(ok0):
                return L0, j0, ok0
            L1 = posdef_cholesky(Kp0 + eye_live * (j1 - j0))
            return L1, j1, _finite_diag(L1)
        K1 = Kp0 + eye_live * (j1 - j0)[..., None, None]
        Ks = torch.stack(torch.broadcast_tensors(Kp0, K1), dim=-3)  # (..., 2, n, n)
        Ls = posdef_cholesky_batched(Ks.reshape(-1, n, n)).reshape(Ks.shape)
        ok_r = _finite_diag(Ls)  # (..., 2)
        ok0, ok1 = ok_r[..., 0], ok_r[..., 1]
        L = torch.where(ok0[..., None, None], Ls[..., 0, :, :], Ls[..., 1, :, :])
        return L, torch.where(ok0, j0, j1), ok0 | ok1

    ladder = torch.tensor(JITTER_LADDER, dtype=dtype, device=K.device) + base_jitter

    def attempt(i):
        L = _lib_cholesky(Kp + eye_live * (ladder[i] * scale)[..., None, None])
        return L, torch.isfinite(L).all(-1).all(-1)

    L, ok = attempt(0)
    rung = torch.zeros(ok.shape, dtype=torch.long, device=K.device)
    for i in range(1, len(JITTER_LADDER)):
        if bool(ok.all()):
            break
        Li, oki = attempt(i)
        retry = ~ok
        L = torch.where(retry[..., None, None], Li, L)
        rung = torch.where(retry, torch.full_like(rung, i), rung)
        ok = torch.where(retry, oki, ok)
    return L, ladder[rung] * scale, ok


def _tri_solve_kernel(T: torch.Tensor, b: torch.Tensor, lower: bool) -> torch.Tensor:
    """``tri_solve`` through ``tri_solve_blocked`` for one (n, n) factor: the
    (..., n, k) right-hand sides become the columns of one (n, Π(...)·k)
    block. An upper-triangular T is solved forward on J T J (J reverses the
    index order): T x = b ⇔ (J T J)(J x) = J b."""
    n = T.shape[-1]
    R = b.movedim(-2, 0).reshape(n, -1)
    if lower:
        X = hk.tri_solve_blocked(T.contiguous(), R.contiguous())
    else:
        X = hk.tri_solve_blocked(T.flip(-2, -1).contiguous(), R.flip(0).contiguous()).flip(0)
    return X.reshape(n, *b.shape[:-2], b.shape[-1]).movedim(0, -2)


def tri_solve(L: torch.Tensor, b: torch.Tensor, lower: bool = True) -> torch.Tensor:
    """Triangular solve L x = b for b of shape (..., n, k); batch axes broadcast.
    ``lower=False`` means L is upper triangular."""
    if L.ndim == 2 and hk.kernel_route(L, b):
        return _tri_solve_kernel(L, b, lower)
    return torch.linalg.solve_triangular(L, b, upper=not lower)


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve K x = b given K = L Lᵀ, for b of shape (..., n, k)."""
    return tri_solve(L.transpose(-1, -2), tri_solve(L, b), lower=False)


def chol_solve_vec(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``chol_solve`` for vector right-hand sides b of shape (..., n)."""
    return chol_solve(L, b[..., None])[..., 0]


def chol_inverse(L: torch.Tensor) -> torch.Tensor:
    """K⁻¹ from its factor. On the kernel route with one factor: Y = L⁻¹ from
    one ``tri_solve_blocked`` against the identity, and K⁻¹ = YᵀY (a plain
    product); elsewhere ``chol_solve(L, I)``."""
    eye = _eye(L)
    if L.ndim == 2 and hk.kernel_route(L):
        Y = tri_solve(L, eye)
        return Y.transpose(-1, -2) @ Y
    return chol_solve(L, eye.expand_as(L))


def masked_logdet(L: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """log|K_live| from the padded factor (pads have L_ii = 1)."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return 2.0 * torch.log(torch.where(mask, d, 1.0)).sum(-1)


def remove_jitter(K: torch.Tensor, jitter, mask: torch.Tensor) -> torch.Tensor:
    """Subtract previously applied diagonal jitter from the live block: the
    factorizations never change the stored Gram (``jitter_cholesky`` returns
    the jitter it applied), so this rebuilds the unconditioned matrix for
    workflows that want it."""
    jitter = torch.as_tensor(jitter, dtype=K.dtype, device=K.device)
    return K - _eye(K) * jitter[..., None, None] * mask.to(K.dtype)[..., None, :]
