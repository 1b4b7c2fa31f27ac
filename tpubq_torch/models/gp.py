"""Gaussian-process regression engine (counterpart of ``tpubq/models/gp.py``).

A ``GPState`` carries the padded data, mask and cached factorization; every
operation is a plain function. Padded rows of the Gram are identity
(``linalg.pad_gram``), so solves and log-determinants of the live block come
out of fixed-shape operations.

Batching: every function takes an optional leading batch axis on ``theta``
and/or ``y``. A batched ``theta`` gives batched Grams and factors; a batched
``y`` under a shared ``theta`` factors the Gram once and solves for a batch of
``alpha`` (the marginalize path, where θ_tl rows leave the linear GP's Gram
unchanged).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from tpubq_torch.ops import linalg
from tpubq_torch.ops.kernels import get_kernel
from tpubq_torch.utils.device import resolve_device

_LOG2PI = math.log(2.0 * math.pi)


class GPState(NamedTuple):
    """GP snapshot.

    theta: kernel parameters [h, w_1..w_d]; s: noise standard deviation;
    x: (n, d) padded inputs; y: (n,) padded targets; mask: (n,) live flags;
    L: (n, n) Cholesky factor of the padded, conditioned Gram;
    alpha: (n,) K⁻¹y (zero at pads); Kinv: (n, n) explicit K⁻¹, or None when
    the fit was asked not to form it; jitter: absolute diagonal jitter
    applied; ok: False iff no finite factor was found (the jitter ladder
    exhausted, or the fixed-jitter factor not finite), in which case
    ``alpha`` is NaN.
    """

    theta: torch.Tensor
    s: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor
    L: torch.Tensor
    alpha: torch.Tensor
    Kinv: Optional[torch.Tensor]
    jitter: torch.Tensor
    ok: torch.Tensor


def _gram(kfn: Callable, theta, s, x, mask):
    K = kfn(theta, x, x)
    eye = torch.eye(x.shape[-2], dtype=K.dtype, device=K.device)
    return K + eye * (s * s)[..., None, None] * mask.to(K.dtype)[..., None, :]


def _fixed_factor_fn(kfn: Callable, s, x, mask, jitter: float, kernel: bool):
    """θ → (θ, L, absolute jitter): the fixed-jitter factor of the masked Gram
    (``_gram``, then ``linalg.cholesky_fixed``), with the terms that depend
    only on the data (the noise diagonal, the mask's) formed once."""
    s = torch.as_tensor(s, dtype=x.dtype, device=x.device)
    eye = torch.eye(x.shape[-2], dtype=x.dtype, device=x.device)
    noise = eye * (s * s)[..., None, None] * mask.to(x.dtype)[..., None, :]
    factor = linalg.cholesky_fixed_fn(mask, x.dtype, jitter, kernel)

    def fn(theta):
        theta = torch.as_tensor(theta, dtype=x.dtype, device=x.device)
        L, jit = factor(kfn(theta, x, x) + noise)
        return theta, L, jit

    return fn


def fixed_fit_fn(kfn: Callable, s, x, y, mask, base_jitter: float = 1e-12, kernel: bool = False):
    """θ → ``gp_fit(kfn, θ, s, x, y, mask, base_jitter, need_kinv=False,
    ladder=False)``, with the data's terms formed once (the joint slice
    sampler re-anchors the candidates every lock-step iteration). ``kernel``:
    see ``linalg.cholesky_fixed_fn``."""
    gram = _fixed_factor_fn(kfn, s, x, mask, base_jitter, kernel)
    s = torch.as_tensor(s, dtype=x.dtype, device=x.device)
    ym = torch.where(mask, y, 0.0)

    def fit(theta) -> GPState:
        theta, L, jit = gram(theta)
        ok = torch.isfinite(L).all(-1).all(-1)
        alpha = linalg.chol_solve_vec(L, ym)
        alpha = torch.where(ok[..., None], alpha, float("nan"))
        return GPState(theta, s, x, ym, mask, L, alpha, None, jit, ok)

    return fit


def gp_fit(
    kfn: Callable,
    theta,
    s,
    x,
    y,
    mask,
    base_jitter: float = 1e-12,
    need_kinv: bool = True,
    ladder: bool = True,
) -> GPState:
    """Factorize the Gram and cache (L, alpha[, K⁻¹]).

    ``ladder=True`` factors through the escalating jitter ladder (the
    estimation paths); ``ladder=False`` through one fixed-jitter factor
    (``fixed_fit_fn``, the joint sampler's re-anchoring), with
    ``jitter`` recorded in absolute units, ``base_jitter`` times the mean live
    diagonal, and ``ok`` meaning every entry of the factor is finite.

    ``need_kinv`` forms the explicit K⁻¹ (float32 scoring reads it); eager
    PyTorch eliminates no dead code, so paths that never read it (the
    marginalize batch) pass False and skip the n-column solve. The alpha and
    K⁻¹ solves are separate, as in the JAX package. One float32 problem on
    the card runs on the hand-written kernels: the Gram on ``gaussian_gram``,
    the ladder on ``cholesky_blocked``, alpha by a forward and a flipped back
    substitution and K⁻¹ = YᵀY from Y = L⁻¹, all three on
    ``tri_solve_blocked`` (``linalg``).
    """
    if not ladder:
        gp = fixed_fit_fn(kfn, s, x, y, mask, base_jitter)(theta)
        return gp._replace(Kinv=linalg.chol_inverse(gp.L)) if need_kinv else gp
    theta = torch.as_tensor(theta, dtype=x.dtype, device=x.device)
    s = torch.as_tensor(s, dtype=x.dtype, device=x.device)
    K = _gram(kfn, theta, s, x, mask)
    L, jit_used, ok = linalg.jitter_cholesky(K, mask, base_jitter)
    ym = torch.where(mask, y, torch.zeros_like(y))
    alpha = linalg.chol_solve_vec(L, ym)
    Kinv = linalg.chol_inverse(L) if need_kinv else None
    alpha = torch.where(ok[..., None], alpha, torch.full_like(alpha, float("nan")))
    return GPState(theta, s, x, ym, mask, L, alpha, Kinv, jit_used, ok)


def _cross(kfn: Callable, gp: GPState, xo):
    """k(xo, x) with padded columns zeroed → (..., no, n)."""
    return kfn(gp.theta, xo, gp.x) * gp.mask.to(xo.dtype)[..., None, :]


def gp_mean(kfn: Callable, gp: GPState, xo) -> torch.Tensor:
    """Posterior mean at xo (zero prior mean) → (..., no)."""
    return (_cross(kfn, gp, xo) @ gp.alpha[..., None])[..., 0]


def gp_cov(kfn: Callable, gp: GPState, xo) -> torch.Tensor:
    """Posterior covariance at xo → (..., no, no).

    The Cholesky-solve form in every dtype: the covariance is a near-total
    cancellation near observations, which the explicit K⁻¹ loses in float32.
    """
    Kox = _cross(kfn, gp, xo)
    Koo = kfn(gp.theta, xo, xo)
    v = linalg.tri_solve(gp.L, Kox.transpose(-1, -2))  # (..., n, no)
    return Koo - v.transpose(-1, -2) @ v


def gp_var(kfn: Callable, kdiagfn: Callable, gp: GPState, xo) -> torch.Tensor:
    """Posterior marginal variance at xo (diagonal of gp_cov) → (..., no)."""
    v = linalg.tri_solve(gp.L, _cross(kfn, gp, xo).transpose(-1, -2))
    return kdiagfn(gp.theta, xo) - (v * v).sum(-2)


def log_mll_fn(kfn: Callable, s, x, mask, jitter: float = 1e-12, kernel: bool = False):
    """(θ, y) → ``log_mll(kfn, θ, s, x, y, mask, jitter)``, with the data's
    terms formed once: the slice sampler evaluates it every lock-step
    iteration. ``kernel``: see ``linalg.cholesky_fixed_fn``."""
    gram = _fixed_factor_fn(kfn, s, x, mask, jitter, kernel)
    const = mask.to(x.dtype).sum(-1) * _LOG2PI

    def mll(theta, y):
        _, L, _ = gram(theta)
        ym = torch.where(mask, y, 0.0)
        alpha = linalg.chol_solve_vec(L, ym)
        return -0.5 * ((ym * alpha).sum(-1) + linalg.masked_logdet(L, mask) + const)

    return mll


def log_mll(kfn: Callable, theta, s, x, y, mask, jitter: float = 1e-12) -> torch.Tensor:
    """Masked log marginal likelihood −½yᵀK⁻¹y − ½log|K| − (n_live/2) log 2π."""
    return log_mll_fn(kfn, s, x, mask, jitter)(theta, y)


def log_mll_by_name(kernel: str):
    """``log_mll`` of the named kernel family:
    f(theta, s, x, y, mask, jitter=1e-12)."""
    kfn, _ = get_kernel(kernel)

    def f(theta, s, x, y, mask, jitter: float = 1e-12):
        return log_mll(kfn, theta, s, x, y, mask, jitter)

    return f


def fit_log_mll(gp: GPState) -> torch.Tensor:
    """``log_mll`` of a fitted GP from its own factor and α (the same
    arithmetic, without factoring the Gram again); NaN where ``ok`` is False."""
    n_live = gp.mask.to(gp.L.dtype).sum(-1)
    quad = (gp.y * gp.alpha).sum(-1)
    return -0.5 * (quad + linalg.masked_logdet(gp.L, gp.mask) + n_live * _LOG2PI)


def dlog_mll(kfn: Callable, theta, s, x, y, mask, jitter: float = 1e-12) -> torch.Tensor:
    """∂MLL/∂θ by autograd through ``log_mll`` → the shape of ``theta``.

    ``theta`` may be a (B, p) stack: the rows are independent, so the
    gradient of the summed MLL is each row's own gradient. A row whose Gram
    does not factor has a non-finite MLL and gets a NaN gradient; the other
    rows are untouched (``cholesky_fixed`` keeps the failure inside the row).
    """
    theta = torch.as_tensor(theta, dtype=x.dtype, device=x.device).detach().requires_grad_(True)
    with torch.enable_grad():
        val = log_mll(kfn, theta, s, x, y, mask, jitter)
        (g,) = torch.autograd.grad(val.sum(), theta)
    return torch.where(torch.isfinite(val)[..., None], g, torch.full_like(g, float("nan")))


class GP:
    """Object-style facade over the functional engine: ``GP(kernel, theta, x,
    y, s)`` holds one fitted ``GPState`` (the jitter ladder's factor and K⁻¹)
    with ``params`` to read and set (setting refits), ``mean``, ``cov``,
    ``Kxx``, ``inv_Kxx``, ``log_lh``, ``dloglh_dtheta`` and ``copy``.

    ``kernel`` names the family; ``device`` defaults to the CUDA card (the
    constructor raises where there is none; ``device="cpu"`` asks for the
    CPU) and ``dtype`` to float64. A float32 gaussian GP with d = 1 on the
    card fits on the hand-written kernels (``gaussian_gram``,
    ``cholesky_blocked``, ``tri_solve_blocked``), as ``gp_fit`` routes it.
    """

    def __init__(self, kernel, theta, x, y, s=0.0, jitter: float = 1e-12, device="cuda",
                 dtype="float64"):
        self.kernel = kernel
        self._kfn, self._kdiagfn = get_kernel(kernel)
        self._jitter = jitter
        dev = resolve_device(device)
        dtype = torch.float64 if dtype == "float64" else torch.float32
        x = torch.as_tensor(x, dtype=dtype, device=dev)
        if x.ndim == 1:
            x = x[:, None]
        y = torch.as_tensor(y, dtype=dtype, device=dev)
        mask = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
        self._state = gp_fit(self._kfn, torch.as_tensor(theta, dtype=dtype, device=dev), s,
                             x, y, mask, jitter)

    @property
    def x(self):
        return self._state.x

    @property
    def y(self):
        return self._state.y

    @property
    def s(self) -> float:
        return float(self._state.s)

    @property
    def params(self):
        """(theta..., s) as one numpy vector."""
        import numpy as np

        return np.concatenate([self._state.theta.detach().cpu().numpy(), [self.s]])

    @params.setter
    def params(self, p):
        st = self._state
        p = torch.as_tensor(p, dtype=st.x.dtype, device=st.x.device)
        self._state = gp_fit(self._kfn, p[:-1], p[-1], st.x, st.y, st.mask, self._jitter)

    @property
    def Kxx(self):
        st = self._state
        return _gram(self._kfn, st.theta, st.s, st.x, st.mask)

    @property
    def inv_Kxx(self):
        return self._state.Kinv  # formed at fit time

    def _points(self, xo):
        xo = torch.as_tensor(xo, dtype=self._state.x.dtype, device=self._state.x.device)
        return xo[:, None] if xo.ndim == 1 else xo

    def mean(self, xo):
        return gp_mean(self._kfn, self._state, self._points(xo))

    def cov(self, xo):
        return gp_cov(self._kfn, self._state, self._points(xo))

    @property
    def log_lh(self) -> float:
        st = self._state
        return float(log_mll(self._kfn, st.theta, st.s, st.x, st.y, st.mask, self._jitter))

    @property
    def dloglh_dtheta(self):
        st = self._state
        g = dlog_mll(self._kfn, st.theta, st.s, st.x, st.y, st.mask, self._jitter)
        return g.detach().cpu().numpy()

    def copy(self):
        new = object.__new__(GP)
        new.__dict__.update(self.__dict__)  # GPState is immutable: safe to share
        return new
