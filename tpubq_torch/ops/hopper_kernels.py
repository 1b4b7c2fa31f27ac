"""Hand-written Hopper kernels and their plain PyTorch twins.

Nine kernels, each the port of a TPU Pallas kernel of the JAX package:

* ``esm_fused`` (``csrc/esm_fused.cu``) ← ``tpubq/ops/pallas_kernels.py``
  ``esm_fused``: the fused per-candidate ESM scorer behind ``choose_next``,
  the two quadratic forms as tiled products (two launches).
* ``chol_batch`` (``csrc/chol_batch.cu``) ← ``cholesky_batch_major``: the
  batched float32 Cholesky behind ``marginalize`` and batched refits, n ≤ 240:
  every diagonal block of up to 64 rows factored by one warp in registers;
  up to 32 rows a block per matrix in shared memory, then a warp per matrix
  up to 64, then panels of 32 columns (the C entry picks the regime).
* ``mll_grad_batched`` (``csrc/mll_grad.cu``) ← ``mll_grad_batched``: the
  masked log marginal likelihood and its (h, w) gradient for a batch of
  hyperparameter rows, behind the fused multi-restart fit, at any n (one
  block per row up to 64 rows, 64 × 64 tiles through a device scratch
  above); the rows may belong to several problems, each with its own data.
* ``esm_fleet_l`` (``csrc/esm_fleet_l.cu``) ← ``esm_fleet_l`` and
  ``esm_fleet_tl`` (``csrc/esm_fleet_tl.cu``) ← ``esm_fleet_tl``: the two
  halves of the fleet scorer behind ``BQFleet.choose_next``, B problems × G
  shared grid points per launch.
* ``gaussian_gram`` (``csrc/gaussian_gram.cu``) ← ``gaussian_gram``: the
  gaussian Gram of one kernel-parameter vector, behind ``kernels.gaussian_K``;
  a call that needs no gradient launches without an autograd node.
* ``cholesky_blocked`` (``csrc/chol_blocked.cu``) ← ``cholesky_blocked`` and
  ``tri_solve_blocked`` (``csrc/tri_solve_blocked.cu``) ←
  ``tri_solve_blocked``: the factor and the triangular solves of one large
  matrix, behind the unbatched float32 refits (``linalg``); each is one
  launch whose tiles or row blocks wait for each other through flags in
  device memory.
* ``cholesky_batched`` (``csrc/chol_batched.cu``) ← ``cholesky_batched``: the
  panelled batched factorization above ``chol_batch``'s shared-memory limit.

A wrapper takes its plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises. Each wrapper counts its CUDA kernel
launches in a plain integer attribute (``esm_fused.launches``, …,
``tri_solve_blocked.launches``), incremented where the kernel is launched and
nowhere else; ``esm_fused``, ``cholesky_batched`` and ``mll_grad_batched``
above 64 rows make several launches per call (``esm_fused_launches``,
``cholesky_batched_launches``, ``mll_grad_launches``;
``cholesky_blocked_launches`` and ``tri_solve_blocked_launches`` are one).
Callers choose a kernel route from shapes, dtype and device before any
launch (``kernel_route``). Nothing here imports a CUDA toolchain at import
time: the library is built by ``_build`` on the first launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import torch

__all__ = [
    "esm_params_len",
    "esm_fused",
    "esm_fused_plain",
    "esm_fused_supported",
    "esm_fused_launches",
    "chol_batch",
    "chol_batch_plain",
    "chol_batch_supported",
    "mll_grad_batched",
    "mll_grad_batched_plain",
    "mll_grad_launches",
    "FLEET_PARAMS",
    "esm_fleet_l",
    "esm_fleet_l_plain",
    "esm_fleet_l_supported",
    "esm_fleet_tl",
    "esm_fleet_tl_plain",
    "esm_fleet_tl_supported",
    "on_card",
    "kernel_route",
    "gaussian_gram",
    "gaussian_gram_plain",
    "gaussian_gram_vjp",
    "cholesky_blocked",
    "cholesky_blocked_plain",
    "cholesky_blocked_launches",
    "tri_solve_blocked",
    "tri_solve_blocked_plain",
    "tri_solve_blocked_launches",
    "cholesky_batched",
    "cholesky_batched_plain",
    "cholesky_batched_launches",
    "lower_inverse_doubling",
]

#: Shared memory one block may use on H100 (227 KB).
SMEM_LIMIT = 232448
#: Largest n of ``chol_batch``; larger stacks go to ``cholesky_batched``.
CHOL_BATCH_MAX_N = 240
# mll_grad: one launch, a block or a warp per row, up to this n; tiles above. A block of NP 128
# lost to the tiles at n = 96 and 128 (PERF.md §6, PR 7), so none is built.
_MLL_SMALL_N = 64
_LOG2PI = math.log(2.0 * math.pi)


def esm_params_len(d: int) -> int:
    """Length of the packed scalar vector of ``esm_fused`` for dimension d:
    [0] h_l², [1] κ, [2] ζ scale, [3] γ, [4] thresh, [5] zᵀα, [6] h_tl²,
    [7] exp cap, [8:8+d] ½/w_l², [8+d:8+2d] ½/w_tl², [8+2d:8+3d] μ,
    [8+3d:8+3d+d²] ½(W_l+Σ)⁻¹ row-major, [8+3d+d²] noise_mult.
    The first 8+3d+d² entries are the TPU kernel's layout."""
    return 9 + 3 * d + d * d


#: Rows and columns of one tile of ``esm_fused`` (grid points × columns of
#: K⁻¹), and its partials per point and column tile of each GP.
_ESM_TILE = 64
_ESM_FIELDS = (5, 2)


def esm_fused_launches(NP: int, NP2: int, d: int) -> int:
    """CUDA launches of one ``esm_fused`` call at any size: 2 (the tiles,
    then the per-point finish)."""
    return 2


def esm_fused_supported(NP: int, NP2: int, d: int) -> bool:
    """Whether ``esm_fused`` covers these sizes: d ≤ 3, any NP and NP2 (the
    kernel streams K⁻¹ and K_tl⁻¹ from device memory, so only the
    scratch the wrapper allocates, (5⌈NP/64⌉ + 2⌈NP2/64⌉) floats per grid
    point, limits the sizes)."""
    return 1 <= d <= 3


def chol_batch_supported(n: int) -> bool:
    """Whether ``chol_batch`` takes n × n matrices: n ≤ 240, where the n
    rows fit one block's 227 KB of shared memory. Larger matrices go to
    ``cholesky_batched``."""
    return n <= CHOL_BATCH_MAX_N


def mll_grad_launches(n: int) -> int:
    """CUDA launches of one ``mll_grad_batched`` call with n data rows: 1 up
    to 64 rows (one block per θ row, the whole tile in shared memory), 4
    above (the tiles through a device-memory scratch: factor and inverse,
    alpha, K⁻¹ with the gradient's partial sums, the finish)."""
    return 1 if n <= _MLL_SMALL_N else 4


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on a CUDA device: the one device test of the routes."""
    return t.is_cuda


def kernel_route(*tensors: torch.Tensor) -> bool:
    """Whether these tensors go to a hand-written kernel: float32, on a CUDA
    device, and none of them needs a gradient (the kernels other than
    ``gaussian_gram`` have no backward). Decided before any launch."""
    return all(t.dtype == torch.float32 and on_card(t) and not t.requires_grad for t in tensors)


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _device_of(t: torch.Tensor):
    """The CUDA device context of a launch on ``t``'s card: a no-op where that
    card is current already. Every wrapper enters it: on an H100 host,
    ``torch.cuda.device`` took 3.8–5.0 µs a call and this 1.4–2.3
    (``profile_main_path.py --kernels``' ``device_context``, PERF.md §6)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


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
    out = torch.empty((G,), dtype=torch.float32, device=grid.device)
    if G == 0:
        return out
    if G >= 2**31 - _ESM_TILE:
        raise ValueError(f"esm_fused: too many grid points ({G}) for one launch")
    from tpubq_torch.ops import _build

    lib = _build.library()
    ptrs = (params.data_ptr(), grid.data_ptr(), G, d, xsc.data_ptr(), msc.data_ptr(), Kinv.data_ptr(),
            uz.data_ptr(), alpha.data_ptr(), NP, xs.data_ptr(), ms.data_ptr(), Kinv_tl.data_ptr(),
            alpha_tl.data_ptr(), NP2)
    tiles = [(n + _ESM_TILE - 1) // _ESM_TILE for n in (NP, NP2)]
    if max(tiles) > 65535:
        raise ValueError(f"esm_fused: NP={NP}, NP2={NP2}: more than 65,535 column tiles")
    Gp = (G + _ESM_TILE - 1) // _ESM_TILE * _ESM_TILE
    with _device_of(grid):
        part = torch.empty((sum(f * t for f, t in zip(_ESM_FIELDS, tiles)), Gp), dtype=torch.float32,
                           device=grid.device)
        err = lib.tpubq_esm_fused(*ptrs, part.data_ptr(), out.data_ptr(), _stream_ptr(grid))
        esm_fused.launches += esm_fused_launches(NP, NP2, d)
    _check(err, "esm_fused")
    return out


esm_fused.launches = 0


# ---------------------------------------------------------------------------
# chol_batch
# ---------------------------------------------------------------------------


def _chol_columns_plain(Ks: torch.Tensor, clamp_pivot: bool, report_clamps: bool = False):
    """The right-looking column recursion of the kernels in torch ops.
    ``clamp_pivot`` takes sqrt(max(c_jj, tiny)) with a NaN c_jj kept
    (``mll_grad``'s contract) instead of sqrt(c_jj) (``chol_batch``'s).
    ``report_clamps`` also returns, per matrix, whether a pivot was below
    tiny or NaN → (L, clamped (B,) bool)."""
    B, n, _ = Ks.shape
    work = Ks.clone()
    L = torch.zeros_like(Ks)
    rows = torch.arange(n, device=Ks.device)[None, :]
    tiny = torch.finfo(Ks.dtype).tiny
    clamped = torch.zeros(B, dtype=torch.bool, device=Ks.device)
    for j in range(n):
        c = work[:, j, j]
        if clamp_pivot:
            clamped = clamped | ~(c >= tiny)
            c = torch.where(c < tiny, torch.full_like(c, tiny), c)
        d = torch.sqrt(c)[:, None]  # (B, 1)
        l = torch.where(rows > j, work[:, :, j] / d, torch.zeros_like(work[:, :, j]))
        L[:, :, j] = l + torch.where(rows == j, d, torch.zeros_like(d))
        work = work - l[:, :, None] * l[:, None, :]
    return (L, clamped) if report_clamps else L


def chol_batch_plain(Ks: torch.Tensor) -> torch.Tensor:
    """The right-looking column recursion of ``chol_batch`` in torch ops."""
    return _chol_columns_plain(Ks, clamp_pivot=False)


def chol_batch(Ks: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a (B, n, n) float32 stack of identity-padded
    Grams (the ``pad_gram`` convention), with exact zeros above the diagonal.

    The pivot is not clamped: a matrix that is not positive definite gets NaN
    in its own factor only. Requires ``chol_batch_supported(n)``; only the
    lower triangle is read. One launch, in the regime that
    ``csrc/chol_batch.cu``'s entry point picks from n.
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
        raise ValueError(f"chol_batch: n={n} exceeds the shared-memory budget (n <= {CHOL_BATCH_MAX_N})")
    L = torch.empty_like(Ks)
    if B == 0 or n == 0:
        return L
    from tpubq_torch.ops import _build

    lib = _build.library()
    with _device_of(Ks):
        err = lib.tpubq_chol_batch(Ks.data_ptr(), L.data_ptr(), B, n, 0, _stream_ptr(Ks))
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
    n = x.shape[-2]
    per_problem = x.ndim == 3
    reps = thetas.shape[0] // x.shape[0] if per_problem else 1

    def rows(t):
        """Per-problem values (P, ...) → one per theta row (B, ...); shared
        values gain a broadcast row axis."""
        return t.repeat_interleave(reps, 0) if per_problem else t[None]

    h, w = thetas[:, 0], thetas[:, 1]
    m = rows(mask.to(dtype))  # (B or 1, n)
    ym = rows(torch.where(mask, y, torch.zeros_like(y)))
    s = torch.as_tensor(s, dtype=dtype, device=dev)
    s2 = rows(s * s)[:, None, None] if s.ndim else s * s
    eye = torch.eye(n, dtype=dtype, device=dev)
    diff = rows(x - x.transpose(-1, -2)) / w[:, None, None]  # (B, n, n)
    r2 = diff * diff
    h2 = (h * h)[:, None, None]
    K0 = h2 * torch.exp(-0.5 * r2) * (m[:, :, None] * m[:, None, :])
    K = K0 + eye * (1.0 - m)[:, None, :] + eye * (s2 + jitter * h2) * m[:, None, :]

    L = _chol_columns_plain(K, clamp_pivot=True)
    Y = torch.zeros_like(K)
    for j in range(n):
        contrib = (L[:, j, :j, None] * Y[:, :j, :]).sum(1)  # L[j, :j] @ Y[:j, :]
        Y[:, j, :] = (eye[j] - contrib) / L[:, j, j, None]
    Kinv = Y.transpose(1, 2) @ Y
    alpha = (Kinv @ (ym[..., None] if per_problem else ym[0][:, None]))[..., 0]  # (B, n)
    quad = (ym * alpha).sum(-1)
    diagL = torch.diagonal(L, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.log(torch.where(m > 0, diagL, torch.ones_like(diagL))).sum(-1)
    mll = -0.5 * (quad + logdet + m.sum(-1) * _LOG2PI)

    G = Kinv - alpha[:, :, None] * alpha[:, None, :]
    dKdh = (2.0 / h)[:, None, None] * K0 + eye * (2.0 * jitter * h)[:, None, None] * m[:, None, :]
    dKdw = K0 * r2 / w[:, None, None]
    grad = torch.stack([-0.5 * (G * dKdh).sum((-1, -2)), -0.5 * (G * dKdw).sum((-1, -2))], dim=-1)
    return mll, grad


def mll_grad_batched(thetas, s, x, y, mask, jitter: float = 1e-10, sizes_out=None):
    """Masked log-MLL and its (h, w) gradient for a batch of hyperparameter
    rows of the 1-D gaussian kernel → (mll (B,), grad (B, 2)).

    Shapes: ``thetas`` (B, 2) positive (h, w); ``s`` a float or a 0-d tensor
    (the noise standard deviation); ``x`` (n, 1); ``y`` (n,); ``mask`` (n,)
    bool; float32, contiguous, one device; any n ≥ 1 (``mll_grad_launches(n)``
    launches: one, a row at the NP its live points need, up to 64 points;
    64 × 64 tiles above).
    ``jitter`` is relative to h² (the live diagonal). The pivot of the
    Cholesky is clamped, so a row whose Gram is not positive definite comes
    back huge or non-finite and the caller filters it. A tensor ``s`` on the
    device costs no host sync.

    Per-problem data: ``x`` (P, n, 1), ``y`` and ``mask`` (P, n), ``s`` a
    scalar or (P,), with B a multiple of P: row r is evaluated on the data of
    problem r // (B / P), all in the same launch. With shared data the kernel
    reads exactly what it read before this form existed.

    ``sizes_out``, a (B,) uint8 tensor on x's CUDA device, n ≤ 64 only: each
    row's NP as the kernel ran it (16, 32 or 64: the smallest that holds the
    row's live points). None (the fit's path) writes nothing.
    """
    if thetas.ndim != 2 or thetas.shape[1] != 2:
        raise ValueError(f"mll_grad_batched: thetas must be (B, 2), got {tuple(thetas.shape)}")
    if x.ndim not in (2, 3) or x.shape[-1] != 1:
        raise ValueError(f"mll_grad_batched: x must be (n, 1) or (P, n, 1), got {tuple(x.shape)}")
    B, n = thetas.shape[0], x.shape[-2]
    if n < 1:
        raise ValueError("mll_grad_batched: needs at least one data row")
    data_shape = tuple(x.shape[:-1])  # (n,) or (P, n)
    P = x.shape[0] if x.ndim == 3 else 1
    if x.ndim == 3 and (P == 0 or B % P):
        raise ValueError(f"mll_grad_batched: {B} theta rows do not divide over {P} problems")
    for k, t in (("y", y), ("mask", mask)):
        if tuple(t.shape) != data_shape:
            raise ValueError(f"mll_grad_batched: {k} has shape {tuple(t.shape)}, expected {data_shape}")
    if mask.dtype != torch.bool or mask.device != x.device or not mask.is_contiguous():
        raise ValueError("mll_grad_batched: mask must be a contiguous bool tensor on x's device")
    s = torch.as_tensor(s, dtype=torch.float32, device=x.device)
    if s.numel() == 1:
        s = s.reshape(())
    elif x.ndim != 3 or tuple(s.shape) != (P,):
        raise ValueError(f"mll_grad_batched: s must be a scalar or (P,), got {tuple(s.shape)}")
    _check_f32("mll_grad_batched", x.device, thetas=thetas, x=x, y=y, s=s)
    if sizes_out is not None:
        if x.device.type != "cuda":
            raise ValueError("mll_grad_batched: sizes_out is the CUDA kernel's, and the CPU runs the twin")
        if n > _MLL_SMALL_N:
            raise ValueError(f"mll_grad_batched: sizes_out is the one-block regime's (n ≤ {_MLL_SMALL_N}), n={n}")
        if (sizes_out.dtype != torch.uint8 or tuple(sizes_out.shape) != (B,) or sizes_out.device != x.device
                or not sizes_out.is_contiguous()):
            raise ValueError(f"mll_grad_batched: sizes_out must be a contiguous ({B},) uint8 tensor on x's device")
    if x.device.type == "cpu":
        return mll_grad_batched_plain(thetas, s, x, y, mask, jitter)
    if x.device.type != "cuda":
        raise ValueError(f"mll_grad_batched: unsupported device {x.device}")
    mll = torch.empty((B,), dtype=torch.float32, device=x.device)
    grad = torch.empty((B, 2), dtype=torch.float32, device=x.device)
    if B == 0:
        return mll, grad
    from tpubq_torch.ops import _build

    lib = _build.library()
    scratch = sync = None
    if n > _MLL_SMALL_N:  # the tiles: a scratch of the size the kernel's source gives
        floats, ints = ctypes.c_longlong(), ctypes.c_longlong()
        lib.tpubq_mll_grad_scratch(B, n, ctypes.byref(floats), ctypes.byref(ints))
        scratch = torch.empty((floats.value,), dtype=torch.float32, device=x.device)
        sync = torch.zeros((ints.value,), dtype=torch.int32, device=x.device)
    with _device_of(x):
        err = lib.tpubq_mll_grad(
            thetas.data_ptr(), s.data_ptr(), x.data_ptr(), y.data_ptr(), mask.data_ptr(),
            float(jitter), B, n, B // P, n if x.ndim == 3 else 0, 1 if s.ndim else 0,
            None if scratch is None else scratch.data_ptr(), 0 if scratch is None else scratch.numel(),
            None if sync is None else sync.data_ptr(), 0 if sync is None else sync.numel(),
            mll.data_ptr(), grad.data_ptr(), None if sizes_out is None else sizes_out.data_ptr(), _stream_ptr(x),
        )
        mll_grad_batched.launches += mll_grad_launches(n)
    _check(err, "mll_grad_batched")
    return mll, grad


mll_grad_batched.launches = 0


# ---------------------------------------------------------------------------
# esm_fleet_l / esm_fleet_tl
# ---------------------------------------------------------------------------

#: Scalars per problem of ``esm_fleet_l``: [0] κ, [1] zᵀα, [2] ζ scale,
#: [3:6] μ, [6:6+d²] ½(W_l+Σ)⁻¹ row-major, [15] h_l² (the TPU kernel's (P, 16)
#: block with its spare slot used for h_l²).
FLEET_PARAMS = 16
#: Rows per problem the fleet kernels take: the route's cap. It is the limit of
#: the first design, which held one problem's K⁻¹ and a k column per thread in
#: shared memory; the tiled kernels need far less, but the fleet scorer's
#: precision against float64 is measured only up to 126 rows, so the route
#: stays where it was.
FLEET_MAX_ROWS = 220
#: Grid points per block, points of a thread's register tile and rows of K⁻¹
#: per staged chunk (``csrc/esm_fleet_common.cuh``: kPT, kLDK − kPT, kQP, kJC).
_FLEET_PT, _FLEET_PAD, _FLEET_QP, _FLEET_JC = 128, 4, 8, 64
#: Elements of a (B, NP, tile) intermediate the plain versions allow themselves.
_PLAIN_TILE_ELEMS = 1 << 23


def _fleet_col_width(NP: int) -> int:
    """Width CT of the fleet kernels' column tiles (of V = (K⁻¹k)ᵀ, i.e. rows
    of K⁻¹): NP split evenly over ⌈NP/64⌉ tiles and rounded up to 16 (48 at
    NP 44, 32 at NP 32, 64 at NP 220)."""
    tiles = (NP + 63) // 64
    return ((NP + tiles - 1) // tiles + 15) // 16 * 16


def _fleet_launch_config(NP: int, d: int):
    """(threads, smem_bytes) of a fleet scorer launch, or None: the layout of
    ``csrc/esm_fleet_common.cuh`` (``threads_of``, ``smem_floats``), which the
    kernels check; both kernels use it. A block takes one problem and tiles
    of 128 grid points, one thread per 8 points × 4 columns of a column tile
    CT wide. Shared memory holds the problem's rows (x, m, α, uz: 4 or 8
    floats each), the points' k tile (NP rows of 132 floats), one staged
    chunk of K⁻¹ (min(NP, 64) × CT; two when K⁻¹ takes several) and the
    partial sums (2·CT/4 rows of 128, and 3 per warp of the k pass)."""
    if not (1 <= d <= 3 and 1 <= NP <= FLEET_MAX_ROWS):
        return None
    ct = _fleet_col_width(NP)
    steps = ((NP + 63) // 64) * ((NP + _FLEET_JC - 1) // _FLEET_JC)
    threads = (_FLEET_PT // _FLEET_QP) * (ct // 4)
    record = (d + 6) // 4 * 4
    floats = (NP * (record + _FLEET_PT + _FLEET_PAD) + (2 if steps > 1 else 1) * min(NP, _FLEET_JC) * ct
              + 2 * (ct // 4) * _FLEET_PT + 3 * (threads // 32) * _FLEET_PT)
    return threads, 4 * floats


def esm_fleet_l_supported(NP: int, d: int) -> bool:
    """Whether ``esm_fleet_l`` covers NP rows per problem: d ≤ 3 and
    1 ≤ NP ≤ ``FLEET_MAX_ROWS`` (220)."""
    return _fleet_launch_config(NP, d) is not None


def esm_fleet_tl_supported(NP2: int, d: int) -> bool:
    """Whether ``esm_fleet_tl`` covers NP2 rows per problem (as ``esm_fleet_l``)."""
    return esm_fleet_l_supported(NP2, d)


def _grid_tiles(G: int, B: int, NP: int):
    step = max(1, _PLAIN_TILE_ELEMS // max(1, B * NP))
    return [(g0, min(G, g0 + step)) for g0 in range(0, G, step)]


def _fleet_cross_kernel(h2, w2inv, g, x, m):
    """(k (B, NP, T), r² (B, NP, T), x − g (B, NP, T, d)) of one grid tile."""
    diff = x[:, :, None, :] - g[None, None, :, :]
    r2 = torch.zeros(diff.shape[:3], dtype=g.dtype, device=g.device)
    for j in range(x.shape[-1]):
        r2 = r2 + diff[..., j] * diff[..., j] * w2inv[:, j][:, None, None]
    return h2[:, None, None] * torch.exp(-r2) * m[:, :, None], r2, diff


def esm_fleet_l_plain(params, w2inv, grid, xsc, msc, Kinv, uz, alpha, thresh: float, lam: float):
    """The linear-GP half of the fleet scorer in batched tensor ops (same
    arguments as ``esm_fleet_l``, any float dtype), one tile of the grid at a
    time: the oracle of the kernel and its CPU path."""
    B, NP, d = xsc.shape
    kappa, zTa, zc, h2 = (params[:, i][:, None] for i in (0, 1, 2, 15))
    mu = params[:, 3:3 + d]
    Ah = params[:, 6:6 + d * d].reshape(B, d, d)
    eps = torch.finfo(grid.dtype).eps
    thresh = grid.new_tensor(thresh)  # squared in the working dtype, as the kernel does
    Kabs = Kinv.abs()
    outs = []
    for g0, g1 in _grid_tiles(grid.shape[0], B, NP):
        g = grid[g0:g1]
        k, r2, diff = _fleet_cross_kernel(h2[:, 0], w2inv, g, xsc, msc)
        if d == 1:  # |x − g| < thresh  ⇔  r² < thresh²·(½/w²): the test reuses r²
            near_rows = r2 < (thresh * thresh) * w2inv[:, 0][:, None, None]
        else:
            near_rows = diff.abs().amax(-1) < thresh
        near = (near_rows & (msc[:, :, None] > 0)).any(1)
        s1 = (k * (Kinv @ k)).sum(1)
        bound = (k * (Kabs @ k)).sum(1)
        zv = (uz[:, :, None] * k).sum(1)
        ka = (alpha[:, :, None] * k).sum(1)
        gam = kappa - s1
        degen = near | (gam <= torch.maximum(eps * kappa, lam * bound))
        da = g[None, :, :] - mu[:, None, :]  # (B, T, d)
        q = torch.zeros(da.shape[:2], dtype=g.dtype, device=g.device)
        for i in range(d):
            for j in range(d):
                q = q + Ah[:, i, j][:, None] * da[..., i] * da[..., j]
        zeta = zc * torch.exp(-q)
        Bc = (zeta - zv) / torch.where(degen, torch.ones_like(gam), gam)
        outs.append((zTa - Bc * ka, Bc, degen.to(grid.dtype)))
    if not outs:
        empty = grid.new_empty((B, 0))
        return empty, empty.clone(), empty.clone()
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def esm_fleet_tl_plain(h2, w2inv, grid, xs, ms, Kinv, alpha):
    """The log-GP half of the fleet scorer in batched tensor ops (same
    arguments as ``esm_fleet_tl``, any float dtype): the oracle of the kernel
    and its CPU path."""
    B, NP2, _ = xs.shape
    outs = []
    for g0, g1 in _grid_tiles(grid.shape[0], B, NP2):
        k, _, _ = _fleet_cross_kernel(h2, w2inv, grid[g0:g1], xs, ms)
        quad = (k * (Kinv @ k)).sum(1)
        outs.append(((alpha[:, :, None] * k).sum(1), torch.clamp(h2[:, None] - quad, min=0.0)))
    if not outs:
        empty = grid.new_empty((B, 0))
        return empty, empty.clone()
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


#: Problems of one fleet-kernel launch: they are the grid's y axis
#: (``blockIdx.y``, ``csrc/esm_fleet_common.cuh``), at most 65,535 blocks.
FLEET_MAX_PROBLEMS = 65535


def _check_fleet(name: str, grid, rows: dict, B: int, NP: int, d: int):
    """Shapes, dtype, device and contiguity of a fleet scorer's tensors."""
    if not 1 <= d <= 3:
        raise ValueError(f"{name} supports d <= 3, got d={d}")
    if grid.ndim != 2 or grid.shape[1] != d:
        raise ValueError(f"{name}: grid must be (G, {d}), the problems' dim; got {tuple(grid.shape)}")
    for k, (t, want) in rows.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {k} has shape {tuple(t.shape)}, expected {want}")
    _check_f32(name, grid.device, grid=grid, **{k: t for k, (t, _) in rows.items()})
    if grid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {grid.device}")
    if grid.device.type == "cuda" and _fleet_launch_config(NP, d) is None:
        raise ValueError(
            f"{name}: {NP} rows per problem exceed the fleet route's {FLEET_MAX_ROWS} rows "
            f"(the shared-memory budget of the first design; see {name}_supported)"
        )
    if B > FLEET_MAX_PROBLEMS:
        raise ValueError(f"{name}: at most {FLEET_MAX_PROBLEMS} problems per launch, got {B}")


def esm_fleet_l(params, w2inv, grid, xsc, msc, Kinv, uz, alpha, thresh: float, lam: float):
    """Linear-GP half of the fleet ESM: for B problems × G shared grid points
    the affine coefficients and the degenerate mask → (A, B, degen), each
    (B, G) (degen as 0/1 floats).

    Per (problem, point): k = h²·exp(−r²)·m; s1 = kᵀK⁻¹k; bound = kᵀ|K⁻¹|k;
    γ = κ − s1; degen = near ∨ γ ≤ max(eps·κ, λ·bound), near meaning within
    ``thresh`` (sup-norm) of a live row; B = (ζ − uzᵀk)/γ (γ → 1 where
    degenerate); A = zᵀα − B·αᵀk. Shapes: ``params`` (B, FLEET_PARAMS);
    ``w2inv`` (B, d) = ½/w_l²; ``grid`` (G, d); ``xsc`` (B, NP, d);
    ``msc``/``uz``/``alpha`` (B, NP); ``Kinv`` (B, NP, NP); float32,
    contiguous, one device, ``esm_fleet_l_supported(NP, d)``. ``thresh`` and
    ``lam`` are Python floats. A problem with non-finite inputs gets
    non-finite values in its own row only.
    """
    if xsc.ndim != 3:
        raise ValueError(f"esm_fleet_l: xsc must be (B, NP, d), got {tuple(xsc.shape)}")
    B, NP, d = xsc.shape
    G = grid.shape[0]
    rows = {"params": (params, (B, FLEET_PARAMS)), "w2inv": (w2inv, (B, d)), "xsc": (xsc, (B, NP, d)),
            "msc": (msc, (B, NP)), "Kinv": (Kinv, (B, NP, NP)), "uz": (uz, (B, NP)),
            "alpha": (alpha, (B, NP))}
    _check_fleet("esm_fleet_l", grid, rows, B, NP, d)
    if grid.device.type == "cpu":
        return esm_fleet_l_plain(params, w2inv, grid, xsc, msc, Kinv, uz, alpha, thresh, lam)
    A, Bc, dg = (torch.empty((B, G), dtype=torch.float32, device=grid.device) for _ in range(3))
    if B == 0 or G == 0:
        return A, Bc, dg
    from tpubq_torch.ops import _build

    lib = _build.library()
    threads, smem = _fleet_launch_config(NP, d)
    with _device_of(grid):
        err = lib.tpubq_esm_fleet_l(
            params.data_ptr(), w2inv.data_ptr(), grid.data_ptr(), G, d, xsc.data_ptr(),
            msc.data_ptr(), Kinv.data_ptr(), uz.data_ptr(), alpha.data_ptr(), B, NP,
            float(thresh), float(lam), threads, smem, A.data_ptr(), Bc.data_ptr(), dg.data_ptr(),
            _stream_ptr(grid),
        )
        esm_fleet_l.launches += 1
    _check(err, "esm_fleet_l")
    return A, Bc, dg


esm_fleet_l.launches = 0


def esm_fleet_tl(h2, w2inv, grid, xs, ms, Kinv, alpha):
    """Log-GP half of the fleet ESM: the posterior mean and variance of the
    log-GP for B problems × G shared grid points → (m_a, c_a), each (B, G).

    Per (problem, point): k = h²·exp(−r²)·m; m_a = αᵀk;
    c_a = max(h² − kᵀK⁻¹k, 0). Shapes: ``h2`` (B,) = h_tl²; ``w2inv`` (B, d) =
    ½/w_tl²; ``grid`` (G, d); ``xs`` (B, NP2, d); ``ms``/``alpha`` (B, NP2);
    ``Kinv`` (B, NP2, NP2); float32, contiguous, one device,
    ``esm_fleet_tl_supported(NP2, d)``.
    """
    if xs.ndim != 3:
        raise ValueError(f"esm_fleet_tl: xs must be (B, NP2, d), got {tuple(xs.shape)}")
    B, NP2, d = xs.shape
    G = grid.shape[0]
    rows = {"h2": (h2, (B,)), "w2inv": (w2inv, (B, d)), "xs": (xs, (B, NP2, d)), "ms": (ms, (B, NP2)),
            "Kinv": (Kinv, (B, NP2, NP2)), "alpha": (alpha, (B, NP2))}
    _check_fleet("esm_fleet_tl", grid, rows, B, NP2, d)
    if grid.device.type == "cpu":
        return esm_fleet_tl_plain(h2, w2inv, grid, xs, ms, Kinv, alpha)
    m_a, c_a = (torch.empty((B, G), dtype=torch.float32, device=grid.device) for _ in range(2))
    if B == 0 or G == 0:
        return m_a, c_a
    from tpubq_torch.ops import _build

    lib = _build.library()
    threads, smem = _fleet_launch_config(NP2, d)
    with _device_of(grid):
        err = lib.tpubq_esm_fleet_tl(
            h2.data_ptr(), w2inv.data_ptr(), grid.data_ptr(), G, d, xs.data_ptr(), ms.data_ptr(),
            Kinv.data_ptr(), alpha.data_ptr(), B, NP2, threads, smem, m_a.data_ptr(),
            c_a.data_ptr(), _stream_ptr(grid),
        )
        esm_fleet_tl.launches += 1
    _check(err, "esm_fleet_tl")
    return m_a, c_a


esm_fleet_tl.launches = 0


# ---------------------------------------------------------------------------
# gaussian_gram
# ---------------------------------------------------------------------------


def gaussian_gram_plain(theta, x1, x2):
    """h²·exp(−½ Σ_k (x1_k/w_k − x2_k/w_k)²) in torch ops (same arguments as
    ``gaussian_gram``, any float dtype): the oracle of the kernel and its CPU
    path, with the operations of ``kernels.gaussian_K`` in the same order."""
    h, w = theta[0], theta[1:]
    diff = (x1 / w)[:, None, :] - (x2 / w)[None, :, :]
    return (h * h) * torch.exp(-0.5 * (diff**2).sum(-1))


def gaussian_gram_vjp(theta, x1, x2, K, G):
    """Closed-form backward of the Gram → (∂θ, ∂x1, ∂x2) of Σ G ∘ K, from
    dK/dh = 2K/h, dK/dw_k = K (x1_k − x2_k)²/w_k³ and
    dK/dx1_k = −K (x1_k − x2_k)/w_k² = −dK/dx2_k."""
    h, w = theta[0], theta[1:]
    GK = G * K
    diff = x1[:, None, :] - x2[None, :, :]  # (n1, n2, d)
    g_h = (2.0 / h) * GK.sum()
    g_w = (GK[..., None] * diff * diff).sum((0, 1)) / (w * w * w)
    gx = GK[..., None] * diff / (w * w)
    return torch.cat([g_h[None], g_w]), -gx.sum(1), gx.sum(0)


#: Columns of one launch of ``gaussian_gram`` (65,535 tiles of 128).
_GRAM_MAX_COLS = 128 * 65535


def _gaussian_gram_launch(theta, x1, x2):
    n1, d = x1.shape
    n2 = x2.shape[0]
    K = torch.empty((n1, n2), dtype=torch.float32, device=x1.device)
    if n1 == 0 or n2 == 0:
        return K
    from tpubq_torch.ops import _build

    lib = _build.library()
    with _device_of(x1):
        err = lib.tpubq_gaussian_gram(theta.data_ptr(), x1.data_ptr(), x2.data_ptr(), n1, n2, d,
                                      K.data_ptr(), _stream_ptr(x1))
        gaussian_gram.launches += 1
    _check(err, "gaussian_gram")
    return K


class _GaussianGram(torch.autograd.Function):
    """The kernel as an autograd node, with the closed-form backward of
    ``gaussian_gram_vjp`` in torch ops: ``log_mll`` / ``dlog_mll`` keep their
    gradients through it."""

    @staticmethod
    def forward(ctx, theta, x1, x2):
        K = _gaussian_gram_launch(theta, x1, x2)
        ctx.save_for_backward(theta, x1, x2, K)
        return K

    @staticmethod
    def backward(ctx, G):
        theta, x1, x2, K = ctx.saved_tensors
        g_theta, g_x1, g_x2 = gaussian_gram_vjp(theta, x1, x2, K, G)
        need = ctx.needs_input_grad
        return (g_theta if need[0] else None, g_x1 if need[1] else None, g_x2 if need[2] else None)


def gaussian_gram(theta, x1, x2):
    """Gaussian Gram of one parameter vector → (n1, n2).

    Shapes: ``theta`` (1 + d,) = [h, w_1..w_d]; ``x1`` (n1, d); ``x2``
    (n2, d); float32, contiguous, one device; n2 ≤ 8,388,480 columns per
    launch. Differentiable in all three (closed-form backward); a call in
    which no input needs a gradient launches without the autograd node.
    """
    if x1.ndim != 2 or x2.ndim != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"gaussian_gram needs (n1, d) and (n2, d), got {tuple(x1.shape)}, {tuple(x2.shape)}")
    d = x1.shape[1]
    if tuple(theta.shape) != (1 + d,):
        raise ValueError(f"gaussian_gram: theta has shape {tuple(theta.shape)}, expected {(1 + d,)}")
    _check_f32("gaussian_gram", x1.device, theta=theta, x1=x1, x2=x2)
    if x1.device.type == "cpu":
        return gaussian_gram_plain(theta, x1, x2)
    if x1.device.type != "cuda":
        raise ValueError(f"gaussian_gram: unsupported device {x1.device}")
    if x2.shape[0] > _GRAM_MAX_COLS:
        raise ValueError(f"gaussian_gram: at most {_GRAM_MAX_COLS} columns per launch, got {x2.shape[0]}")
    if torch.is_grad_enabled() and (theta.requires_grad or x1.requires_grad or x2.requires_grad):
        return _GaussianGram.apply(theta, x1, x2)
    return _gaussian_gram_launch(theta, x1, x2)


gaussian_gram.launches = 0


# ---------------------------------------------------------------------------
# cholesky_blocked / tri_solve_blocked (one large matrix)
# ---------------------------------------------------------------------------

#: Tile of ``cholesky_blocked``: the 64 × 64 tiles of the factor's lower
#: triangle are the work items of its one launch.
CHOL_TILE = 64


def cholesky_blocked_launches(n: int) -> int:
    """CUDA launches of one ``cholesky_blocked`` call on an n × n matrix: one
    (the tiles wait for each other through flags, not through stream
    order)."""
    return 1 if n > 0 else 0


def tri_solve_blocked_launches(n: int) -> int:
    """CUDA launches of one ``tri_solve_blocked`` call with n rows: one (the
    row blocks wait for each other through flags, not through stream
    order), whatever the number of columns."""
    return 1 if n > 0 else 0


#: Rows per row block of ``tri_solve_blocked``; panel width of
#: ``cholesky_batched``. The diagonal blocks' inverses are formed by recursive
#: doubling over 16 × 16 leaves, so both are 16 · 2^k.
TRI_BLOCK = 64
CHOL_BATCHED_PANEL = 64
_LEAF = 16
#: Up to this many right-hand-side columns ``tri_solve_blocked`` makes one
#: work item per column and row block; above, 64-column tiles.
_TRI_VEC_MAX_M = 8
#: Largest n of ``cholesky_batched``: its trailing update's lower 128 × 128
#: tiles are a grid axis of at most 65,535 blocks.
_CHOL_BATCHED_MAX_N = 64 + 361 * 128


def cholesky_batched_launches(n: int) -> int:
    """CUDA launches of one ``cholesky_batched`` call on a (B, n, n) stack,
    whatever B: per 64-wide panel the diagonal block, and below all but the
    last the panel product and the trailing update — 3·⌈n/64⌉ − 2."""
    return 3 * ((n + CHOL_BATCHED_PANEL - 1) // CHOL_BATCHED_PANEL) - 2 if n > 0 else 0


def lower_inverse_doubling(Lb: torch.Tensor) -> torch.Tensor:
    """Inverse of a (..., nb, nb) lower-triangular block (nb = 16 · 2^k; only
    the lower triangle is read) as the kernels form it: each 16 × 16 diagonal
    leaf by row substitution, then, for s = 16, 32, …, every pair
    [A 0; C D] of s × s blocks with known inverses as
    [A⁻¹ 0; −D⁻¹(C A⁻¹) D⁻¹]."""
    nb = Lb.shape[-1]
    if nb % _LEAF or (nb // _LEAF) & (nb // _LEAF - 1):
        raise ValueError(f"lower_inverse_doubling: the block must be 16 · 2^k rows, got {nb}")
    Y = torch.zeros_like(Lb)
    eye = torch.eye(_LEAF, dtype=Lb.dtype, device=Lb.device)
    for o in range(0, nb, _LEAF):
        A = Lb[..., o:o + _LEAF, o:o + _LEAF]
        Yl = Y[..., o:o + _LEAF, o:o + _LEAF]
        for r in range(_LEAF):
            s = eye[r] - (A[..., r, :r, None] * Yl[..., :r, :]).sum(-2)
            Yl[..., r, :] = s / A[..., r, r, None]
    s = _LEAF
    while s < nb:
        for o in range(0, nb, 2 * s):
            A = Y[..., o:o + s, o:o + s]
            D = Y[..., o + s:o + 2 * s, o + s:o + 2 * s]
            C = Lb[..., o + s:o + 2 * s, o:o + s]  # wholly below the diagonal
            Y[..., o + s:o + 2 * s, o:o + s] = -(D @ (C @ A))
        s *= 2
    return Y


def cholesky_batched_plain(Ks: torch.Tensor, panel: int = CHOL_BATCHED_PANEL) -> torch.Tensor:
    """``cholesky_batched`` in torch ops, panel by panel as the kernel runs:
    the clamped column recursion inside each diagonal block, its inverse by
    ``lower_inverse_doubling``, the panel L_ik = A_ik Y_kkᵀ and the trailing
    update A_ii −= L_ik L_ikᵀ; NaN in every matrix where a pivot was clamped.
    Only the lower triangles are read. ``panel`` is 16 · 2^k."""
    B, n, _ = Ks.shape
    work = torch.tril(Ks)
    L = torch.zeros_like(Ks)
    clamped = torch.zeros(B, dtype=torch.bool, device=Ks.device)
    for k0 in range(0, n, panel):
        w = min(panel, n - k0)
        Lkk, cl = _chol_columns_plain(work[:, k0:k0 + w, k0:k0 + w], clamp_pivot=True, report_clamps=True)
        clamped |= cl
        L[:, k0:k0 + w, k0:k0 + w] = Lkk
        if k0 + w == n:
            break
        Y = lower_inverse_doubling(Lkk)
        Lik = work[:, k0 + w:, k0:k0 + w] @ Y.transpose(-1, -2)
        L[:, k0 + w:, k0:k0 + w] = Lik
        work[:, k0 + w:, k0 + w:] -= Lik @ Lik.transpose(-1, -2)
    return torch.where(clamped[:, None, None], torch.full_like(L, float("nan")), L)


def cholesky_blocked_plain(A: torch.Tensor, tile: int = CHOL_TILE) -> torch.Tensor:
    """``cholesky_blocked`` in torch ops, tile by tile as the kernel runs:
    column by column of ``tile``-wide tiles, each lower tile
    S_ij = A_ij − Σ_{k<j} L_ik L_jkᵀ (k in order); the diagonal tile factored
    by the clamped column recursion (which the kernel blocks into 16-wide
    leaves), its inverse Y_jj by ``lower_inverse_doubling``, the tiles below
    it L_ij = S_ij Y_jjᵀ; NaN where a pivot was clamped. Only the lower
    triangle is read; ``tile`` is 16 · 2^k."""
    n = A.shape[0]
    L = torch.zeros_like(A)
    clamped = torch.zeros(1, dtype=torch.bool, device=A.device)
    for j0 in range(0, n, tile):
        wj = min(tile, n - j0)
        Y = None
        for i0 in range(j0, n, tile):
            wi = min(tile, n - i0)
            S = A[i0:i0 + wi, j0:j0 + wj]
            S = torch.tril(S) if i0 == j0 else S.clone()
            for k0 in range(0, j0, tile):
                S = S - L[i0:i0 + wi, k0:k0 + tile] @ L[j0:j0 + wj, k0:k0 + tile].T
            if i0 == j0:
                Ljj, cl = _chol_columns_plain(S[None], clamp_pivot=True, report_clamps=True)
                L[j0:j0 + wj, j0:j0 + wj] = Ljj[0]
                clamped |= cl
                if j0 + wj < n:  # only the last tile can be ragged
                    Y = lower_inverse_doubling(Ljj[0])
            else:
                L[i0:i0 + wi, j0:j0 + wj] = S @ Y.T
    return torch.where(clamped, torch.full_like(L, float("nan")), L)


def _check_square(name: str, A: torch.Tensor, ndim: int) -> None:
    if A.ndim != ndim or A.shape[-1] != A.shape[-2]:
        want = "(N, N)" if ndim == 2 else "(B, N, N)"
        raise ValueError(f"{name} needs a {want} matrix, got {tuple(A.shape)}")


def cholesky_blocked(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of one (N, N) float32 matrix, exact zeros above
    the diagonal; only the lower triangle is read.

    One CUDA launch (``cholesky_blocked_launches(N)``): the 64 × 64 tiles of
    the lower triangle as work items, taken in tile-column-major order from a
    ticket counter, each waiting on the tiles it reads through flags in
    device memory (zeroed scratch from ``torch.zeros``); left-looking, with
    sums in a fixed order, so two calls on the same inputs give the same
    bits. The pivot is clamped at tiny and a clamped factor comes back NaN: a
    matrix that is not positive definite gives a NaN factor, the contract of
    the library Cholesky that the jitter ladder reads. No host sync.
    """
    _check_square("cholesky_blocked", A, 2)
    _check_f32("cholesky_blocked", A.device, A=A)
    if A.device.type == "cpu":
        return cholesky_blocked_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"cholesky_blocked: unsupported device {A.device}")
    N = A.shape[0]
    L = torch.empty_like(A)
    if N == 0:
        return L
    T = (N + CHOL_TILE - 1) // CHOL_TILE
    from tpubq_torch.ops import _build

    Yt = torch.empty((max(T - 1, 1), CHOL_TILE, CHOL_TILE), dtype=torch.float32, device=A.device)
    Ps = torch.empty((max(T - 1, 1), CHOL_TILE, CHOL_TILE + 4), dtype=torch.float32, device=A.device)
    sync = torch.zeros((2 + T * (T + 1) // 2 + T,), dtype=torch.int32, device=A.device)
    lib = _build.library()
    with _device_of(A):
        err = lib.tpubq_chol_blocked(A.data_ptr(), L.data_ptr(), Yt.data_ptr(), Ps.data_ptr(), sync.data_ptr(), N,
                                     _stream_ptr(A))
        cholesky_blocked.launches += 1
    _check(err, "cholesky_blocked")
    return L


cholesky_blocked.launches = 0


def tri_solve_blocked_plain(L: torch.Tensor, R: torch.Tensor, block: int = TRI_BLOCK) -> torch.Tensor:
    """``tri_solve_blocked`` in torch ops, row block by row block as the
    kernel runs: X_i = Y_ii (R_i − Σ_{j<i} L_ij X_j), with Y_ii the inverse
    of the diagonal block (identity-padded to ``block`` rows) by
    ``lower_inverse_doubling``. Only the lower triangle of L is read;
    ``block`` is 16 · 2^k."""
    N = L.shape[0]
    X = torch.empty_like(R)
    for i0 in range(0, N, block):
        nb = min(block, N - i0)
        Lb = torch.eye(block, dtype=L.dtype, device=L.device)  # a ragged last block is identity-padded
        Lb[:nb, :nb] = torch.tril(L[i0:i0 + nb, i0:i0 + nb])
        Y = lower_inverse_doubling(Lb)[:nb, :nb]
        X[i0:i0 + nb] = Y @ (R[i0:i0 + nb] - L[i0:i0 + nb, :i0] @ X[:i0])
    return X


def _tri_solve_sync_ints(N: int, M: int) -> int:
    """Zeroed int32 scratch of one ``tri_solve_blocked`` launch: up to 8
    columns, the ticket, a pad and N·M ready-marked 64-bit words of X; above,
    the ticket and one flag per work item (row block × 64-column tile)."""
    if M <= _TRI_VEC_MAX_M:
        return 2 + 2 * N * M
    return 1 + ((N + TRI_BLOCK - 1) // TRI_BLOCK) * ((M + 63) // 64)


def tri_solve_blocked(L: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """X = L⁻¹R for a lower-triangular (N, N) ``L`` and (N, M) ``R``, float32
    and contiguous on one device; only the lower triangle of L is read.

    One CUDA launch (``tri_solve_blocked_launches(N)``): 64-row blocks × column
    tiles as work items, taken in order from a ticket counter, each waiting
    on the items above it through flags or ready-marked words in device
    memory (zeroed scratch from ``torch.zeros``). Deterministic: two
    calls on the same inputs give the same bits. A back substitution with an
    upper-triangular U is the forward one on J U J (J reverses the index
    order): ``linalg.tri_solve(..., lower=False)``. No host sync.
    """
    _check_square("tri_solve_blocked", L, 2)
    if R.ndim != 2 or R.shape[0] != L.shape[0]:
        raise ValueError(f"tri_solve_blocked: R must be ({L.shape[0]}, M), got {tuple(R.shape)}")
    _check_f32("tri_solve_blocked", L.device, L=L, R=R)
    if L.device.type == "cpu":
        return tri_solve_blocked_plain(L, R)
    if L.device.type != "cuda":
        raise ValueError(f"tri_solve_blocked: unsupported device {L.device}")
    N, M = R.shape
    X = torch.empty_like(R)
    if N == 0 or M == 0:
        return X
    if N * M >= 2**31 - 1:
        raise ValueError(f"tri_solve_blocked: too many entries ({N} × {M}) for one launch")
    from tpubq_torch.ops import _build

    sync = torch.zeros((_tri_solve_sync_ints(N, M),), dtype=torch.int32, device=L.device)
    lib = _build.library()
    with _device_of(L):
        err = lib.tpubq_tri_solve_blocked(L.data_ptr(), R.data_ptr(), X.data_ptr(), sync.data_ptr(), N, M,
                                          _stream_ptr(L))
        tri_solve_blocked.launches += 1
    _check(err, "tri_solve_blocked")
    return X


tri_solve_blocked.launches = 0


# ---------------------------------------------------------------------------
# cholesky_batched (a stack of matrices of any size)
# ---------------------------------------------------------------------------

def cholesky_batched(Ks: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a (B, N, N) float32 stack, exact zeros above
    the diagonal; only the lower triangles are read.

    Right-looking with 64-wide panels, the batch a grid axis of every phase:
    ``cholesky_batched_launches(N)`` CUDA launches whatever B (N ≤ 46,272).
    The pivot is clamped at tiny, and a matrix with a clamped pivot comes
    back NaN, in its own entry only. No host sync.
    """
    _check_square("cholesky_batched", Ks, 3)
    _check_f32("cholesky_batched", Ks.device, Ks=Ks)
    if Ks.device.type == "cpu":
        return cholesky_batched_plain(Ks)
    if Ks.device.type != "cuda":
        raise ValueError(f"cholesky_batched: unsupported device {Ks.device}")
    B, n, _ = Ks.shape
    L = torch.empty_like(Ks)
    if B == 0 or n == 0:
        return L
    if B > 2**31 - 1 or n > _CHOL_BATCHED_MAX_N:
        raise ValueError(f"cholesky_batched: B ≤ 2³¹ − 1 and N ≤ {_CHOL_BATCHED_MAX_N}, got {tuple(Ks.shape)}")
    P = CHOL_BATCHED_PANEL
    ldp = (n + 3) // 4 * 4
    flags = torch.empty((B,), dtype=torch.int32, device=Ks.device)
    Yt = torch.empty((B, P, P), dtype=torch.float32, device=Ks.device)
    PT = torch.empty((B, P, ldp) if n > P else (1, 4), dtype=torch.float32, device=Ks.device)
    from tpubq_torch.ops import _build

    launches = ctypes.c_int(0)
    lib = _build.library()
    with _device_of(Ks):
        err = lib.tpubq_chol_batched(Ks.data_ptr(), L.data_ptr(), flags.data_ptr(), Yt.data_ptr(), PT.data_ptr(),
                                     ldp, B, n, ctypes.byref(launches), _stream_ptr(Ks))
        cholesky_batched.launches += launches.value
    _check(err, "cholesky_batched")
    return L


cholesky_batched.launches = 0
