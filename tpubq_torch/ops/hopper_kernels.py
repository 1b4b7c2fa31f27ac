"""Hand-written Hopper kernels and their plain PyTorch twins.

Three kernels, each the port of a TPU Pallas kernel of the JAX package:

* ``esm_fused`` (``csrc/esm_fused.cu``) ← ``tpubq/ops/pallas_kernels.py``
  ``esm_fused``: the fused per-candidate ESM scorer behind ``choose_next``.
* ``chol_batch`` (``csrc/chol_batch.cu``) ← ``cholesky_batch_major``: the
  batched float32 Cholesky behind ``marginalize``.
* ``mll_grad_batched`` (``csrc/mll_grad.cu``) ← ``mll_grad_batched``: the
  masked log marginal likelihood and its (h, w) gradient for a batch of
  hyperparameter rows, behind the fused multi-restart fit.

A wrapper takes its plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises. Each wrapper counts its kernel
launches in a plain integer attribute (``esm_fused.launches``,
``chol_batch.launches``, ``mll_grad_batched.launches``), incremented where the kernel is launched and
nowhere else. Nothing here imports a CUDA toolchain at import time: the
library is built by ``_build`` on the first launch.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "esm_params_len",
    "esm_fused",
    "esm_fused_plain",
    "esm_fused_supported",
    "chol_batch",
    "chol_batch_plain",
    "chol_batch_supported",
    "mll_grad_batched",
    "mll_grad_batched_plain",
    "mll_grad_supported",
]

#: Shared memory one block may use on H100 (227 KB).
SMEM_LIMIT = 232448
_ESM_THREADS = (128, 64, 32)
_CHOL_THREADS = 256
_MLL_THREADS = 256  # a power of two: the kernel's block-wide sums are a binary tree
_LOG2PI = math.log(2.0 * math.pi)


def esm_params_len(d: int) -> int:
    """Length of the packed scalar vector of ``esm_fused`` for dimension d:
    [0] h_l², [1] κ, [2] ζ scale, [3] γ, [4] thresh, [5] zᵀα, [6] h_tl²,
    [7] exp cap, [8:8+d] ½/w_l², [8+d:8+2d] ½/w_tl², [8+2d:8+3d] μ,
    [8+3d:8+3d+d²] ½(W_l+Σ)⁻¹ row-major, [8+3d+d²] noise_mult.
    The first 8+3d+d² entries are the TPU kernel's layout."""
    return 9 + 3 * d + d * d


def _esm_launch_config(NP: int, NP2: int, d: int):
    """(threads, kinv_in_smem, smem_bytes) of an ``esm_fused`` launch, or None.

    Shared memory holds each thread's k buffer (max(NP, NP2) floats), the
    problem's vectors and, where they fit, K⁻¹ and K_tl⁻¹. The largest block
    that fits with both inverses in shared memory wins; failing that, the
    inverses are read from device memory through L1.
    """
    npmax = max(NP, NP2)
    vec = esm_params_len(d) + NP * (d + 3) + NP2 * (d + 2)
    mats = NP * NP + NP2 * NP2
    for kinv_in_smem in (1, 0):
        for t in _ESM_THREADS:
            floats = npmax * t + vec + (mats if kinv_in_smem else 0)
            if 4 * floats <= SMEM_LIMIT:
                return t, kinv_in_smem, 4 * floats
    return None


def esm_fused_supported(NP: int, NP2: int, d: int) -> bool:
    """Whether ``esm_fused`` covers these sizes: d ≤ 3 and 32 k-buffers of
    max(NP, NP2) floats plus the problem's vectors within 227 KB of shared
    memory — max(NP, NP2) up to about 1,700 at d = 1."""
    return 1 <= d <= 3 and _esm_launch_config(NP, NP2, d) is not None


def chol_batch_supported(n: int) -> bool:
    """Whether one n × n float32 matrix (plus its n pivots) fits the 227 KB of
    shared memory of one block: n ≤ 240. Larger matrices go to the library
    Cholesky."""
    return 4 * (n * n + n) <= SMEM_LIMIT


def _mll_smem_bytes(n: int) -> int:
    """Shared memory of one ``mll_grad`` block: two n × n matrices, five
    n-vectors and five partial sums per thread."""
    return 4 * (2 * n * n + 5 * n + 5 * _MLL_THREADS)


def mll_grad_supported(n: int) -> bool:
    """Whether ``mll_grad_batched`` covers n data rows (pads included): the
    Gram and its inverse factor, two n × n float32 matrices, within the
    227 KB of shared memory of one block — n ≤ 167."""
    return n >= 1 and _mll_smem_bytes(n) <= SMEM_LIMIT


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _check_f32(name: str, device, **tensors):
    for k, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {k} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: {k} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


# ---------------------------------------------------------------------------
# esm_fused
# ---------------------------------------------------------------------------


def esm_fused_plain(params, grid, xsc, msc, Kinv, uz, alpha, xs, ms, Kinv_tl, alpha_tl):
    """The ESM scorer written in torch tensor ops (same arguments as
    ``esm_fused``): the oracle of the kernel and its CPU path."""
    d = xsc.shape[1]
    h_l2, kappa, zc, gamma, thresh, zTa, h_tl2, cap = params[:8]
    wl, wtl = params[8:8 + d], params[8 + d:8 + 2 * d]
    mu = params[8 + 2 * d:8 + 3 * d]
    Ah = params[8 + 3 * d:8 + 3 * d + d * d].reshape(d, d)
    noise_mult = params[8 + 3 * d + d * d]

    diff = xsc[:, None, :] - grid[None, :, :]  # (NP, G, d)
    r2 = torch.zeros(diff.shape[:2], dtype=grid.dtype, device=grid.device)
    for j in range(d):
        r2 = r2 + diff[..., j] * diff[..., j] * wl[j]
    k = h_l2 * torch.exp(-r2) * msc[:, None]  # (NP, G)
    gam = kappa - (k * (Kinv @ k)).sum(0)
    zv = uz @ k
    ka = alpha @ k
    da = grid - mu
    zeta = zc * torch.exp(-((da @ Ah) * da).sum(-1))
    near = ((diff.abs().amax(-1) < thresh) & (msc[:, None] > 0)).any(0)
    eps = torch.finfo(grid.dtype).eps
    degen = near | (gam <= torch.maximum(eps * kappa, noise_mult * k.sum(0)))
    B = (zeta - zv) / torch.where(degen, torch.ones_like(gam), gam)
    A = zTa - B * ka

    dtl = xs[:, None, :] - grid[None, :, :]
    r2t = torch.zeros(dtl.shape[:2], dtype=grid.dtype, device=grid.device)
    for j in range(d):
        r2t = r2t + dtl[..., j] * dtl[..., j] * wtl[j]
    ktl = h_tl2 * torch.exp(-r2t) * ms[:, None]
    c = torch.clamp(h_tl2 - (ktl * (Kinv_tl @ ktl)).sum(0), min=0.0)
    m = alpha_tl @ ktl
    e1 = torch.exp(torch.minimum(m + 0.5 * c, cap))
    e2 = torch.exp(torch.minimum(2.0 * m + 2.0 * c, cap))
    E1 = gamma * (e1 - 1.0)
    E2 = gamma * gamma * (e2 - 2.0 * e1 + 1.0)
    esm = A * A + 2.0 * A * B * E1 + B * B * E2
    return torch.where(degen, zTa * zTa, esm)


def esm_fused(params, grid, xsc, msc, Kinv, uz, alpha, xs, ms, Kinv_tl, alpha_tl):
    """Fused ESM scores of a grid of d-dimensional points → (G,).

    Shapes: ``params`` (esm_params_len(d),), ``grid`` (G, d), ``xsc`` (NP, d),
    ``msc``/``uz``/``alpha`` (NP,), ``Kinv`` (NP, NP), ``xs`` (NP2, d),
    ``ms``/``alpha_tl`` (NP2,), ``Kinv_tl`` (NP2, NP2); float32, contiguous,
    one device, d ≤ 3, and ``esm_fused_supported(NP, NP2, d)``.
    """
    G, d = grid.shape
    NP, NP2 = xsc.shape[0], xs.shape[0]
    if not 1 <= d <= 3:
        raise ValueError(f"esm_fused supports d <= 3, got d={d}")
    shapes = {
        "params": (params, (esm_params_len(d),)), "xsc": (xsc, (NP, d)),
        "msc": (msc, (NP,)), "Kinv": (Kinv, (NP, NP)), "uz": (uz, (NP,)),
        "alpha": (alpha, (NP,)), "xs": (xs, (NP2, d)), "ms": (ms, (NP2,)),
        "Kinv_tl": (Kinv_tl, (NP2, NP2)), "alpha_tl": (alpha_tl, (NP2,)),
    }
    for k, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"esm_fused: {k} has shape {tuple(t.shape)}, expected {want}")
    tensors = {"grid": grid, **{k: t for k, (t, _) in shapes.items()}}
    _check_f32("esm_fused", grid.device, **tensors)
    if grid.device.type == "cpu":
        return esm_fused_plain(params, grid, xsc, msc, Kinv, uz, alpha, xs, ms, Kinv_tl, alpha_tl)
    if grid.device.type != "cuda":
        raise ValueError(f"esm_fused: unsupported device {grid.device}")
    cfg = _esm_launch_config(NP, NP2, d)
    if cfg is None:
        raise ValueError(
            f"esm_fused: NP={NP}, NP2={NP2} exceed the shared-memory budget "
            "(see esm_fused_supported)"
        )
    out = torch.empty((G,), dtype=torch.float32, device=grid.device)
    if G == 0:
        return out
    from tpubq_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(grid.device):
        err = lib.tpubq_esm_fused(
            params.data_ptr(), grid.data_ptr(), G, d, xsc.data_ptr(), msc.data_ptr(),
            Kinv.data_ptr(), uz.data_ptr(), alpha.data_ptr(), NP, xs.data_ptr(),
            ms.data_ptr(), Kinv_tl.data_ptr(), alpha_tl.data_ptr(), NP2, *cfg,
            out.data_ptr(), _stream_ptr(grid),
        )
        esm_fused.launches += 1
    _check(err, "esm_fused")
    return out


esm_fused.launches = 0


# ---------------------------------------------------------------------------
# chol_batch
# ---------------------------------------------------------------------------


def _chol_columns_plain(Ks: torch.Tensor, clamp_pivot: bool) -> torch.Tensor:
    """The right-looking column recursion of the kernels in torch ops.
    ``clamp_pivot`` takes sqrt(max(c_jj, tiny)) with a NaN c_jj kept
    (``mll_grad``'s contract) instead of sqrt(c_jj) (``chol_batch``'s)."""
    B, n, _ = Ks.shape
    work = Ks.clone()
    L = torch.zeros_like(Ks)
    rows = torch.arange(n, device=Ks.device)[None, :]
    tiny = torch.finfo(Ks.dtype).tiny
    for j in range(n):
        c = work[:, j, j]
        if clamp_pivot:
            c = torch.where(c < tiny, torch.full_like(c, tiny), c)
        d = torch.sqrt(c)[:, None]  # (B, 1)
        l = torch.where(rows > j, work[:, :, j] / d, torch.zeros_like(work[:, :, j]))
        L[:, :, j] = l + torch.where(rows == j, d, torch.zeros_like(d))
        work = work - l[:, :, None] * l[:, None, :]
    return L


def chol_batch_plain(Ks: torch.Tensor) -> torch.Tensor:
    """The right-looking column recursion of ``chol_batch`` in torch ops."""
    return _chol_columns_plain(Ks, clamp_pivot=False)


def chol_batch(Ks: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a (B, n, n) float32 stack of identity-padded
    Grams (the ``pad_gram`` convention), with exact zeros above the diagonal.

    The pivot is not clamped: a matrix that is not positive definite gets NaN
    in its own factor only. Requires ``chol_batch_supported(n)``; only the
    lower triangle is read.
    """
    if Ks.ndim != 3 or Ks.shape[1] != Ks.shape[2]:
        raise ValueError(f"chol_batch needs a (B, n, n) stack, got {tuple(Ks.shape)}")
    _check_f32("chol_batch", Ks.device, Ks=Ks)
    B, n, _ = Ks.shape
    if Ks.device.type == "cpu":
        return chol_batch_plain(Ks)
    if Ks.device.type != "cuda":
        raise ValueError(f"chol_batch: unsupported device {Ks.device}")
    if not chol_batch_supported(n):
        raise ValueError(f"chol_batch: n={n} exceeds the shared-memory budget (n <= 240)")
    L = torch.empty_like(Ks)
    if B == 0 or n == 0:
        return L
    from tpubq_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(Ks.device):
        err = lib.tpubq_chol_batch(
            Ks.data_ptr(), L.data_ptr(), B, n, _CHOL_THREADS, 4 * (n * n + n), _stream_ptr(Ks)
        )
        chol_batch.launches += 1
    _check(err, "chol_batch")
    return L


chol_batch.launches = 0


# ---------------------------------------------------------------------------
# mll_grad_batched
# ---------------------------------------------------------------------------


def mll_grad_batched_plain(thetas, s, x, y, mask, jitter: float = 1e-10):
    """``mll_grad_batched`` step by step in torch ops (same arguments, any
    float dtype): the Gram with identity pads and s² + jitter·h² on the live
    diagonal, the column Cholesky with a clamped pivot, Y = L⁻¹ by forward
    substitution one row per step, K⁻¹ = YᵀY, α = K⁻¹y, and the trace identity
    ∂MLL/∂θ = −½ Σ (K⁻¹ − ααᵀ) ∘ ∂K/∂θ. The oracle of the kernel and its CPU
    path."""
    dtype, dev = x.dtype, x.device
    n = x.shape[0]
    h, w = thetas[:, 0], thetas[:, 1]
    m = mask.to(dtype)
    ym = torch.where(mask, y, torch.zeros_like(y))
    s = torch.as_tensor(s, dtype=dtype, device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev)
    diff = (x - x.T)[None] / w[:, None, None]  # (B, n, n)
    r2 = diff * diff
    h2 = (h * h)[:, None, None]
    K0 = h2 * torch.exp(-0.5 * r2) * (m[:, None] * m[None, :])
    K = K0 + eye * (1.0 - m) + eye * (s * s + jitter * h2) * m

    L = _chol_columns_plain(K, clamp_pivot=True)
    Y = torch.zeros_like(K)
    for j in range(n):
        contrib = (L[:, j, :j, None] * Y[:, :j, :]).sum(1)  # L[j, :j] @ Y[:j, :]
        Y[:, j, :] = (eye[j] - contrib) / L[:, j, j, None]
    Kinv = Y.transpose(1, 2) @ Y
    alpha = (Kinv @ ym[:, None])[..., 0]  # (B, n)
    quad = (ym * alpha).sum(-1)
    diagL = torch.diagonal(L, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.log(torch.where(mask, diagL, torch.ones_like(diagL))).sum(-1)
    mll = -0.5 * (quad + logdet + m.sum() * _LOG2PI)

    G = Kinv - alpha[:, :, None] * alpha[:, None, :]
    dKdh = (2.0 / h)[:, None, None] * K0 + eye * (2.0 * jitter * h)[:, None, None] * m
    dKdw = K0 * r2 / w[:, None, None]
    grad = torch.stack([-0.5 * (G * dKdh).sum((-1, -2)), -0.5 * (G * dKdw).sum((-1, -2))], dim=-1)
    return mll, grad


def mll_grad_batched(thetas, s, x, y, mask, jitter: float = 1e-10):
    """Masked log-MLL and its (h, w) gradient for a batch of hyperparameter
    rows of the 1-D gaussian kernel → (mll (B,), grad (B, 2)).

    Shapes: ``thetas`` (B, 2) positive (h, w); ``s`` a float or a 0-d tensor
    (the noise standard deviation); ``x`` (n, 1); ``y`` (n,); ``mask`` (n,)
    bool; float32, contiguous, one device, and ``mll_grad_supported(n)``.
    ``jitter`` is relative to h² (the live diagonal). The pivot of the
    Cholesky is clamped, so a row whose Gram is not positive definite comes
    back huge or non-finite and the caller filters it. A tensor ``s`` on the
    device costs no host sync.
    """
    if thetas.ndim != 2 or thetas.shape[1] != 2:
        raise ValueError(f"mll_grad_batched: thetas must be (B, 2), got {tuple(thetas.shape)}")
    if x.ndim != 2 or x.shape[1] != 1:
        raise ValueError(f"mll_grad_batched: x must be (n, 1), got {tuple(x.shape)}")
    B, n = thetas.shape[0], x.shape[0]
    for k, t in (("y", y), ("mask", mask)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"mll_grad_batched: {k} has shape {tuple(t.shape)}, expected {(n,)}")
    if mask.dtype != torch.bool or mask.device != x.device or not mask.is_contiguous():
        raise ValueError("mll_grad_batched: mask must be a contiguous bool tensor on x's device")
    s = torch.as_tensor(s, dtype=torch.float32, device=x.device).reshape(())
    _check_f32("mll_grad_batched", x.device, thetas=thetas, x=x, y=y)
    if x.device.type == "cpu":
        return mll_grad_batched_plain(thetas, s, x, y, mask, jitter)
    if x.device.type != "cuda":
        raise ValueError(f"mll_grad_batched: unsupported device {x.device}")
    if not mll_grad_supported(n):
        raise ValueError(f"mll_grad_batched: n={n} exceeds the shared-memory budget (n <= 167)")
    mll = torch.empty((B,), dtype=torch.float32, device=x.device)
    grad = torch.empty((B, 2), dtype=torch.float32, device=x.device)
    if B == 0:
        return mll, grad
    from tpubq_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.tpubq_mll_grad(
            thetas.data_ptr(), s.data_ptr(), x.data_ptr(), y.data_ptr(), mask.data_ptr(),
            float(jitter), B, n, _MLL_THREADS, _mll_smem_bytes(n), mll.data_ptr(),
            grad.data_ptr(), _stream_ptr(x),
        )
        mll_grad_batched.launches += 1
    _check(err, "mll_grad_batched")
    return mll, grad


mll_grad_batched.launches = 0
