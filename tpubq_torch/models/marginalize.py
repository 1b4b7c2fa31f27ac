"""Hyperparameter marginalization: slice sampling and the batched estimate.

Counterpart of ``tpubq/models/marginalize.py``. The sampler is Neal's
coordinate-wise slice sampler (step-out, then shrink) in u = log θ with a
weak N(0, prior_std²) prior on each coordinate, driven by an explicit
``torch.Generator``; its control flow is sequential host code, one
``.item()`` per log-density evaluation. ``marginalize`` evaluates the
estimators under all samples as one batch: (B, p) hypers → (B, n, n) Grams →
one batched rung-stack Cholesky (on a CUDA device ``chol_batch`` up to 240
rows, ``cholesky_batched`` above) → batched Z moments.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from tpubq_torch.models import gp as gpm
from tpubq_torch.models.bq import BQState, Z_mean, Z_var, apply_hyper_sample
from tpubq_torch.ops.kernels import get_kernel
from tpubq_torch.utils.options import BQOptions

__all__ = ["slice_sample", "sample_hypers", "marginalize", "param_coords"]

_MAX_STEPOUT = 32
_MAX_SHRINK = 64
_PRIOR_STD = 5.0


def _uniform(gen: torch.Generator) -> float:
    return float(torch.rand((), generator=gen, dtype=torch.float64))


def _slice_coord(gen, logpdf: Callable, u, j, lp0, width):
    """One univariate slice-sampling update of coordinate j → (u_new, lp_new)."""
    logy = lp0 + math.log(_uniform(gen))
    x0 = float(u[j])

    def f(xj):
        v = u.clone()
        v[j] = xj
        return logpdf(v)

    left = x0 - _uniform(gen) * width
    right = left + width
    for _ in range(_MAX_STEPOUT):
        if not f(left) > logy:
            break
        left -= width
    for _ in range(_MAX_STEPOUT):
        if not f(right) > logy:
            break
        right += width
    for _ in range(_MAX_SHRINK):
        x1 = left + _uniform(gen) * (right - left)
        lp1 = f(x1)
        if lp1 >= logy:
            v = u.clone()
            v[j] = x1
            return v, lp1
        if x1 < x0:
            left = x1
        else:
            right = x1
    return u, lp0


def slice_sample(gen: torch.Generator, logpdf: Callable, u0, n: int, nburn: int = 0,
                 width: float = 1.0, coords=None) -> torch.Tensor:
    """Draw ``n`` samples (after ``nburn``) from ``logpdf`` (a map from a
    float64 CPU vector to a Python float) → (n, p) float64 on the CPU.
    ``coords`` lists the coordinates to sweep; the others stay at u0."""
    u = torch.as_tensor(u0, dtype=torch.float64).clone()
    coords = tuple(range(u.shape[0])) if coords is None else tuple(coords)
    lp = logpdf(u)
    out = []
    for it in range(n + nburn):
        for j in coords:
            u, lp = _slice_coord(gen, logpdf, u, j, lp, width)
        if it >= nburn:
            out.append(u)
    return torch.stack(out) if out else torch.empty((0, u.shape[0]), dtype=torch.float64)


def _names_for(opts: BQOptions):
    """Reference hyper names → θ indices (gaussian: h, w_1..w_d)."""
    return {"h": (0,), "w": tuple(range(1, opts.dim + 1))}


def param_coords(params, opts: BQOptions):
    """Resolve hyper names ("h", "w") to coordinates into θ_tl."""
    local = _names_for(opts)
    coords = []
    for name in params:
        if name.endswith("_l") and name[:-2] in local:
            raise NotImplementedError(
                "joint (θ_tl ∥ θ_l) sampling is not ported yet (ROADMAP.md, queue 1)"
            )
        if name not in local:
            raise ValueError(
                f"unknown hyperparameter {name!r} for kernel {opts.kernel!r}; "
                f"valid: {sorted(local)} (+ '_l' suffix for the linear GP)"
            )
        coords.extend(local[name])
    return tuple(sorted(set(coords)))


def sample_hypers(state: BQState, opts: BQOptions, gen: torch.Generator, n: int,
                  nburn: int = 10, params=None, prior_std: float = _PRIOR_STD) -> torch.Tensor:
    """Slice-sample θ_tl from the log-GP's MLL × a weak log-normal prior →
    (n, p) on the state's device, one chain. ``params`` names the hypers
    that move."""
    if params is None:
        params = tuple(sorted(_names_for(opts)))
    coords = param_coords(params, opts)
    kfn, _ = get_kernel(opts.kernel)
    gp_tl = state.gp_log_l
    dtype, dev = state.x_s.dtype, state.x_s.device

    def logpdf(u):
        mll = float(gpm.log_mll(kfn, torch.exp(u).to(dtype=dtype, device=dev), gp_tl.s,
                                state.x_s, state.tl_s, state.obs_mask, opts.base_jitter))
        lp = mll - 0.5 * float(((u / prior_std) ** 2).sum())
        return lp if math.isfinite(lp) else -math.inf

    u0 = torch.log(gp_tl.theta.detach().to("cpu", torch.float64))
    us = slice_sample(gen, logpdf, u0, n, nburn, coords=coords)
    return torch.exp(us).to(dtype=dtype, device=dev)


def marginalize(state: BQState, opts: BQOptions, hyper_samples, funs=(Z_mean, Z_var)):
    """Evaluate ``funs`` under every θ_tl row of ``hyper_samples`` (B, p) as
    one batch → tuple of (B,) tensors."""
    st = apply_hyper_sample(state, opts, hyper_samples, need_kinv=False)
    return tuple(f(st, opts) for f in funs)
