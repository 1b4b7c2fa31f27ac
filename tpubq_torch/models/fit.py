"""Hyperparameter fitting: multi-restart maximization of the masked log-MLL.

Counterpart of ``tpubq/models/fit.py``. Optimization is over u = log θ, which
keeps every scale positive without constraints. Two routes:

* ``fit_params`` / ``fit_params_with_noise``: all restarts advance in lockstep
  as one (R, p) batch through a batched L-BFGS (``_run_restarts``), with
  gradients by autograd through the fixed-jitter masked Cholesky. The JAX
  package steps ``optax.lbfgs`` under ``vmap``; the trajectory here is not
  optax's, the optimum is held to it.
* ``fit_params_fused``: Adam over the ``mll_grad_batched`` kernel, one kernel
  launch per iteration for all restarts, no host sync inside the loop. The
  float32 route for the 1-D gaussian kernel.

Every other family (periodic, Matérn, rq) fits through the batched L-BFGS. Given a fleet's data, (P, n, 1),
  it fits all P problems at once: still one launch per iteration.

Random draws come from an explicit CPU ``torch.Generator``, so a seed gives
the same restarts on every device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tpubq_torch.models import gp as gpm
from tpubq_torch.ops import hopper_kernels as hk
from tpubq_torch.ops.kernels import get_kernel

__all__ = [
    "fit_params", "fit_params_with_noise", "fit_params_fused", "random_restarts",
    "resolve_param_names",
]

_HISTORY = 10      # L-BFGS pairs kept per restart
_MAX_TRIALS = 20   # backtracking cap per iteration (step down to 2⁻¹⁹)
_ARMIJO_C1 = 1e-4


def resolve_param_names(opts, p_len: int, params):
    """Hyper names of ``fit_hypers(params=...)`` → ``(fit_noise, free_mask)``.

    ``params``: None (every kernel hyper of the family free, noise fixed), a
    single name, or a sequence of names from the kernel family's ("h", "w",
    and "p" for periodic or "alpha" for rq) plus "s" (the observation noise). ``fit_noise`` says whether "s" was
    named; ``free_mask`` is None when every θ is free, else a (p_len,) bool
    tensor on the CPU (all False when only "s" was named). Unknown names raise
    with the valid list.
    """
    from tpubq_torch.models.marginalize import _names_for

    local = _names_for(opts)
    if params is None:
        params = tuple(sorted(local))
    elif isinstance(params, str):
        params = (params,)
    else:
        params = tuple(params)
    unknown = set(params) - set(local) - {"s"}
    if unknown:
        raise ValueError(
            f"unknown hyperparameters {sorted(unknown)} for kernel "
            f"{opts.kernel!r}; valid: {sorted(local) + ['s']}"
        )
    free = np.zeros(p_len, bool)
    for nm in params:
        if nm != "s":
            free[list(local[nm])] = True
    return "s" in params, (None if free.all() else torch.as_tensor(free))


# ---------------------------------------------------------------------------
# batched L-BFGS
# ---------------------------------------------------------------------------


def _value_and_grad(obj: Callable, u: torch.Tensor):
    """(values (R,), gradients (R, p), rows where both are finite). The rows
    of ``obj`` are independent, so the gradient of the summed objective is
    each row's own gradient."""
    u = u.detach().requires_grad_(True)
    with torch.enable_grad():
        f = obj(u)
        (g,) = torch.autograd.grad(f.sum(), u)
    f = f.detach()
    return f, g, torch.isfinite(f) & torch.isfinite(g).all(-1)


def _two_loop(g, S, Y, rho, gamma, order):
    """H·g of the L-BFGS inverse-Hessian estimate, batched over restarts.
    ``order`` lists the history slots newest first; a slot a row did not fill
    has rho = 0 there and drops out of that row's recursion."""
    q = g.clone()
    coefs = []
    for i in order:
        a = rho[i] * (S[i] * q).sum(-1)
        q = q - a[:, None] * Y[i]
        coefs.append(a)
    r = gamma[:, None] * q
    for i, a in zip(reversed(order), reversed(coefs)):
        b = rho[i] * (Y[i] * r).sum(-1)
        r = r + S[i] * (a - b)[:, None]
    return r


def _run_restarts(obj: Callable, inits: torch.Tensor, n_iter: int, groups: int = 1):
    """Minimize ``obj`` from every row of ``inits`` (R, p) at once →
    (u_best, best value), non-finite restarts losing. With ``groups`` > 1 the
    rows are that many equal blocks (a fleet's problems, each with its own
    restarts) and the best row of each block comes back →
    ((groups, p), (groups,)).

    All restarts move in lockstep: one batched value-and-gradient per
    evaluation, a batched two-loop recursion over the last ``_HISTORY`` pairs,
    and a backtracking Armijo search with a step of its own for each row,
    capped at ``_MAX_TRIALS`` halvings. A row that starts non-finite never
    moves. A row whose search fails drops its history and tries steepest
    descent next; failing that too, it has converged to rounding and stops.
    The host reads one flag per trial (all rows served) and one per iteration
    (any row left), never one per row.
    """
    R, p = inits.shape
    u = inits.detach().clone()
    f, g, ok = _value_and_grad(obj, u)
    active = ok
    S = u.new_zeros((_HISTORY, R, p))
    Y = u.new_zeros((_HISTORY, R, p))
    rho = u.new_zeros((_HISTORY, R))
    gamma = u.new_ones((R,))
    zero, one = u.new_zeros(()), u.new_ones(())

    for it in range(n_iter):
        active = active & (g.abs().amax(-1) > 0)
        if not bool(active.any()):
            break
        order = [(it - 1 - i) % _HISTORY for i in range(min(it, _HISTORY))]
        d = -_two_loop(g, S, Y, rho, gamma, order)
        gd = (g * d).sum(-1)
        quasi_newton = (rho.sum(0) > 0) & (gd < 0)
        d = torch.where(quasi_newton[:, None], d, -g)
        gd = torch.where(quasi_newton, gd, -(g * g).sum(-1))
        t = torch.where(quasi_newton, one, torch.clamp(1.0 / g.abs().sum(-1), max=1.0))

        served = ~active
        u_new, f_new, g_new = u, f, g
        for _ in range(_MAX_TRIALS):
            u_try = u + t[:, None] * d
            f_try, g_try, ok = _value_and_grad(obj, u_try)
            take = ~served & ok & (f_try <= f + _ARMIJO_C1 * t * gd)
            u_new = torch.where(take[:, None], u_try, u_new)
            f_new = torch.where(take, f_try, f_new)
            g_new = torch.where(take[:, None], g_try, g_new)
            served = served | take
            if bool(served.all()):
                break
            t = torch.where(served, t, 0.5 * t)

        s_k, y_k = u_new - u, g_new - g
        sy, yy, ss = (s_k * y_k).sum(-1), (y_k * y_k).sum(-1), (s_k * s_k).sum(-1)
        valid = active & served & (sy > 1e-10 * torch.sqrt(ss * yy))
        slot = it % _HISTORY
        S[slot] = torch.where(valid[:, None], s_k, zero)
        Y[slot] = torch.where(valid[:, None], y_k, zero)
        rho[slot] = torch.where(valid, 1.0 / sy, zero)
        gamma = torch.where(valid, sy / yy, gamma)
        failed = active & ~served
        active = active & ~(failed & ~quasi_newton)
        rho = torch.where(failed[None, :], zero, rho)
        gamma = torch.where(failed, one, gamma)
        u, f, g = u_new, f_new, g_new

    with torch.no_grad():
        vals = obj(u)
    vals = torch.where(torch.isfinite(vals), vals, torch.full_like(vals, math.inf)).reshape(groups, -1)
    best = torch.argmin(vals, dim=-1, keepdim=True)
    u_best = torch.take_along_dim(u.reshape(groups, -1, p), best[..., None], dim=1)[:, 0]
    val_best = torch.take_along_dim(vals, best, dim=1)[:, 0]
    return (u_best[0], val_best[0]) if groups == 1 else (u_best, val_best)


def _objective(kfn, s, x, y, mask, jitter, free_mask=None, u_frozen=None, rows=None):
    """Negative masked log-MLL as a function of u = log θ, (R, p) → (R,).
    Coordinates outside ``free_mask`` are pinned to ``u_frozen``, so the
    optimizer cannot move them. ``rows`` = (P, R): the rows are P problems'
    R restarts each, against data with a leading problem axis and a
    singleton row axis."""

    def obj(u):
        if free_mask is not None:
            u = torch.where(free_mask, u, u_frozen)
        theta = torch.exp(u) if rows is None else torch.exp(u).reshape(*rows, u.shape[-1])
        return -gpm.log_mll(kfn, theta, s, x, y, mask, jitter).reshape(-1)

    return obj


# ---------------------------------------------------------------------------
# restart initializations
# ---------------------------------------------------------------------------


def _live_count(mask, dtype):
    return torch.clamp(mask.to(dtype).sum(-1), min=1.0)


def _live_std(y, mask):
    """Standard deviation of the live targets (over the last axis), floored
    at 1e-6."""
    m = mask.to(y.dtype)
    n_live = _live_count(mask, y.dtype)
    ymean = (y * m).sum(-1) / n_live
    return torch.sqrt(torch.clamp((m * (y - ymean[..., None]) ** 2).sum(-1) / n_live, min=1e-12))


def _uniform(gen: torch.Generator, shape, lo, hi, like: torch.Tensor):
    """U(lo, hi) draws of ``shape`` in ``like``'s dtype and device; ``lo`` and
    ``hi`` are numbers or tensors that broadcast against ``shape``. The draw
    is scaled in float64 and cast once."""
    r = torch.rand(shape, generator=gen, dtype=torch.float64, device=gen.device)
    lo, hi = (torch.as_tensor(v, dtype=torch.float64, device=r.device) for v in (lo, hi))
    return (lo + (hi - lo) * r).to(dtype=like.dtype, device=like.device)


def random_restarts(gen: torch.Generator, theta0, x, y, mask, n_restart: int,
                    kernel: str = "gaussian") -> torch.Tensor:
    """Data-driven restart initializations in log space → (n_restart, p).

    Row 0 is log θ0 (the incumbent). The others draw log h around the scale
    of the live targets, log(ystd) + U(−2, 2), and each log w_j around that
    dimension's own live input range, log(range_j) + U(log 0.05, log 2). The
    periodic family's w is unitless, log w ~ U(log 0.1, log 2), and its period
    lies between the mean observation spacing and twice the range:
    log p ~ U(log(range / (n_live − 1)), log(2·range)). The rq family's shape
    α draws log α ~ U(log 0.5, log 4). With a leading problem axis on
    ``theta0``, ``x``, ``y`` and ``mask`` the result is (P, n_restart, p),
    drawn in one call.
    """
    get_kernel(kernel)
    theta0 = torch.as_tensor(theta0, dtype=x.dtype, device=x.device)
    big = torch.finfo(x.dtype).max
    live = mask[..., :, None]
    xr = torch.clamp(
        torch.where(live, x, torch.full_like(x, -big)).amax(-2)
        - torch.where(live, x, torch.full_like(x, big)).amin(-2),
        min=1e-6,
    )  # (..., d) per-dimension live ranges
    p = theta0.shape[-1]
    batch = tuple(x.shape[:-2])
    log_h = torch.log(_live_std(y, mask))[..., None, None] + _uniform(
        gen, (*batch, n_restart, 1), -2.0, 2.0, x)
    if kernel == "periodic":
        log_w = _uniform(gen, (*batch, n_restart, 1), math.log(0.1), math.log(2.0), x)
        spacing = xr[..., 0] / torch.clamp(_live_count(mask, x.dtype) - 1.0, min=1.0)
        log_p = _uniform(gen, (*batch, n_restart, 1), torch.log(spacing)[..., None, None],
                         torch.log(2.0 * xr[..., 0])[..., None, None], x)
        u = torch.cat([log_h, log_w, log_p], dim=-1)
    else:
        n_w = p - 2 if kernel == "rq" else p - 1
        log_w = torch.log(xr)[..., None, :] + _uniform(
            gen, (*batch, n_restart, n_w), math.log(0.05), math.log(2.0), x)
        u = torch.cat([log_h, log_w], dim=-1)
        if kernel == "rq":
            log_a = _uniform(gen, (*batch, n_restart, 1), math.log(0.5), math.log(4.0), x)
            u = torch.cat([u, log_a], dim=-1)
    u[..., 0, :] = torch.log(theta0)
    return u


# ---------------------------------------------------------------------------
# the fits
# ---------------------------------------------------------------------------


def _pin_frozen(theta_best, theta0, free_mask):
    """Frozen coordinates come back bit-identical to ``theta0``."""
    return theta_best if free_mask is None else torch.where(free_mask, theta_best, theta0)


def _on(t, like: torch.Tensor, dtype=None):
    return None if t is None else torch.as_tensor(t, dtype=dtype or like.dtype, device=like.device)


def fit_params(
    kernel: str,
    theta0,
    s,
    x,
    y,
    mask,
    gen: torch.Generator,
    n_restart_inits: Optional[torch.Tensor] = None,
    n_iter: int = 60,
    jitter: float = 1e-10,
    free_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximize the masked MLL over the kernel parameters →
    (theta_best, mll_best).

    ``n_restart_inits``: optional (R, p) log-space inits; by default 10
    ``random_restarts``. ``free_mask``: optional (p,) bool — only True
    coordinates are optimized, the rest come back bit-identical to ``theta0``.

    A fleet: ``theta0`` (P, p), ``s`` (P,), ``x`` (P, n, d), ``y`` and
    ``mask`` (P, n), inits (P, R, p) → ((P, p), (P,)). All P·R rows advance
    in one lock-step L-BFGS, each on its own problem's data; each row's
    trajectory is the one it takes alone.
    """
    kfn, _ = get_kernel(kernel)
    theta0 = _on(theta0, x)
    free_mask = _on(free_mask, x, torch.bool)
    if n_restart_inits is None:
        n_restart_inits = random_restarts(gen, theta0, x, y, mask, 10, kernel=kernel)
    inits = _on(n_restart_inits, x)
    if x.ndim == 3:
        P, R, p = inits.shape
        u_frozen = torch.log(theta0)[:, None, :].expand(P, R, p).reshape(P * R, p)
        obj = _objective(kfn, _on(s, x).reshape(P, 1), x[:, None], y[:, None], mask[:, None], jitter,
                         free_mask, u_frozen, rows=(P, R))
        u_best, val_best = _run_restarts(obj, inits.reshape(P * R, p), n_iter, groups=P)
    else:
        obj = _objective(kfn, s, x, y, mask, jitter, free_mask, torch.log(theta0))
        u_best, val_best = _run_restarts(obj, inits, n_iter)
    return _pin_frozen(torch.exp(u_best), theta0, free_mask), -val_best


def fit_params_with_noise(
    kernel: str,
    theta0,
    s0,
    x,
    y,
    mask,
    gen: torch.Generator,
    n_restart: int = 10,
    n_iter: int = 60,
    jitter: float = 1e-10,
    free_mask: Optional[torch.Tensor] = None,
    restart_inits: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Maximize the masked MLL over (θ, s) jointly → (theta, s, mll).

    Optimization is over u = (log θ, log s). An ``s0`` of exactly zero cannot
    start a log-space search, so the incumbent row starts the noise from
    max(s0, 1e-4·ystd); the other rows draw log s from
    log(ystd) + U(log 1e-4, log 0.3). ``free_mask`` (over θ only) freezes the
    unlisted kernel parameters; s is always free here. ``restart_inits``:
    optional (R, p + 1) log-space inits in place of the draws.
    """
    kfn, _ = get_kernel(kernel)
    theta0 = _on(theta0, x)
    free_mask = _on(free_mask, x, torch.bool)
    p = theta0.shape[0]
    u_frozen = torch.log(theta0)

    def obj(u):
        ut = u[:, :p]
        if free_mask is not None:
            ut = torch.where(free_mask, ut, u_frozen)
        return -gpm.log_mll(kfn, torch.exp(ut), torch.exp(u[:, p]), x, y, mask, jitter)

    if restart_inits is None:
        ystd = _live_std(y, mask)
        s_start = torch.maximum(_on(s0, x), 1e-4 * ystd)
        u_theta = random_restarts(gen, theta0, x, y, mask, n_restart, kernel=kernel)
        log_s = torch.log(ystd) + _uniform(gen, (n_restart, 1), math.log(1e-4), math.log(0.3), x)
        restart_inits = torch.cat([u_theta, log_s], dim=1)
        restart_inits[0, p] = torch.log(s_start)  # incumbent row
    u_best, val_best = _run_restarts(obj, _on(restart_inits, x), n_iter)
    theta_best = _pin_frozen(torch.exp(u_best[:p]), theta0, free_mask)
    return theta_best, torch.exp(u_best[p]), -val_best


def _adam_ascent(us, s, x, y, mask, n_iter: int, lr: float, jitter: float, free_mask=None):
    """``n_iter`` Adam steps of every row of ``us`` (R, 2) up the MLL, one
    ``mll_grad_batched`` launch per step → the stepped ``us``.

    Adam as optax writes it: b1 = 0.9, b2 = 0.999, bias-corrected moments,
    eps = 1e-8 outside the root. Non-finite gradients count as zero, and so do
    those of coordinates outside ``free_mask``. The moments stay on the
    device and the step count is a Python integer: nothing here reads a
    device value on the host.
    """
    mu, nu = torch.zeros_like(us), torch.zeros_like(us)
    zero = torch.zeros_like(us)
    b1, b2, eps = 0.9, 0.999, 1e-8
    for it in range(1, n_iter + 1):
        thetas = torch.exp(us)
        _, g_theta = hk.mll_grad_batched(thetas, s, x, y, mask, jitter=jitter)
        g_u = -g_theta * thetas  # chain rule to log space; ascend MLL = descend −MLL
        g_u = torch.where(torch.isfinite(g_u), g_u, zero)
        if free_mask is not None:
            g_u = torch.where(free_mask[None, :], g_u, zero)
        mu.mul_(b1).add_(g_u, alpha=1.0 - b1)
        nu.mul_(b2).addcmul_(g_u, g_u, value=1.0 - b2)
        denom = (nu / (1.0 - b2**it)).sqrt_().add_(eps)
        us = us.addcdiv(mu, denom, value=-lr / (1.0 - b1**it))
    return us


def fit_params_fused(
    theta0,
    s,
    x,
    y,
    mask,
    gen: torch.Generator,
    restart_inits: Optional[torch.Tensor] = None,
    n_iter: int = 150,
    lr: float = 0.05,
    jitter: float = 1e-7,
    free_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-restart fit driven by the fused MLL-and-gradient kernel →
    (theta_best, mll_best).

    All restarts advance together: each iteration is one launch of
    ``hopper_kernels.mll_grad_batched`` for every restart's MLL and analytic
    gradient, stepped by Adam in log space, plus one last launch to rank the
    restarts (a non-finite MLL loses). Gaussian kernel, 1-D x, float32; the
    autograd route (``fit_params``) is the general one.

    A fleet: ``theta0`` (P, 2), ``s`` (P,), ``x`` (P, n, 1), ``y`` and
    ``mask`` (P, n), ``restart_inits`` (P, R, 2) → ((P, 2), (P,)). All P·R
    rows advance in the same launches, each on its own problem's data.
    """
    theta0 = _on(theta0, x)
    free_mask = _on(free_mask, x, torch.bool)
    s = _on(s, x).reshape(x.shape[:-2])
    if restart_inits is None:
        restart_inits = random_restarts(gen, theta0, x, y, mask, 10)
    us = _on(restart_inits, x)
    if free_mask is not None:
        # pin frozen coordinates: the kernel evaluates exp(us) directly
        us = torch.where(free_mask, us, torch.log(theta0)[..., None, :])
    shape = us.shape  # (R, 2) or (P, R, 2)
    us = _adam_ascent(us.reshape(-1, 2), s, x, y, mask, n_iter, lr, jitter, free_mask)
    mll, _ = hk.mll_grad_batched(torch.exp(us), s, x, y, mask, jitter=jitter)
    mll = torch.where(torch.isfinite(mll), mll, torch.full_like(mll, -math.inf)).reshape(shape[:-1])
    best = torch.argmax(mll, dim=-1, keepdim=True)
    u_best = torch.take_along_dim(us.reshape(shape), best[..., None], dim=-2)[..., 0, :]
    mll_best = torch.take_along_dim(mll, best, dim=-1)[..., 0]
    return _pin_frozen(torch.exp(u_best), theta0, free_mask), mll_best
