"""Hyperparameter marginalization: slice sampling and the batched estimate.

Counterpart of ``tpubq/models/marginalize.py``. The sampler is Neal's
coordinate-wise slice sampler (step-out, then shrink) in u = log θ with a
weak N(0, prior_std²) prior on each coordinate, run in lock step over a
leading row axis: the chains of one problem, the chains of every problem of a
fleet, θ_tl rows or joint θ_tl ∥ θ_l rows. Every log density is evaluated for
all rows at once on the state's device, in its dtype; a finished row is
masked, not removed, and the host reads one flag per lock-step iteration
(``slice_sample.host_reads`` counts them), never one per row or per
evaluation. The
uniforms come from the caller's ``torch.Generator``, drawn up front in one
block, so a run is reproducible from its seed and ``slice_sample_plain`` (the
sequential sampler, one row under host control flow) consumes the same
numbers.

``marginalize`` evaluates the estimators under all samples as one batch:
(S, p) hypers → (S, n, n) Grams → one batched rung-stack Cholesky (on a CUDA
device ``chol_batch`` up to 240 rows, ``cholesky_batched`` above) → batched Z
moments; a fleet state takes (B, S, p) rows the same way.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from tpubq_torch.models import gp as gpm
from tpubq_torch.models.bq import BQState, Z_mean, Z_var, apply_hyper_sample, theta_len, with_sample_axis
from tpubq_torch.ops.kernels import get_kernel
from tpubq_torch.utils.options import BQOptions

__all__ = ["slice_sample", "slice_sample_plain", "draw_uniforms", "log_density", "sample_hypers",
           "marginalize", "param_coords"]

_MAX_STEPOUT = 32
_MAX_SHRINK = 64
_PRIOR_STD = 5.0
#: Uniforms per (sweep, coordinate, row): the slice height, the bracket's
#: position and one per shrink.
_N_UNIFORMS = 2 + _MAX_SHRINK


def draw_uniforms(gen: torch.Generator, rows: int, sweeps: int, n_coords: int) -> torch.Tensor:
    """The uniforms of a run, (rows, sweeps, n_coords, 66) float64 on the CPU,
    row-major: a row's numbers do not depend on how many rows follow it."""
    return torch.rand((rows, sweeps, n_coords, _N_UNIFORMS), generator=gen, dtype=torch.float64)


def _set_coord(u, j: int, x):
    """``u`` with coordinate j replaced by ``x`` (broadcast over u's rows)."""
    out = u.clone()
    out[..., j] = x
    return out


def slice_sample(gen: torch.Generator, logpdf: Callable, u0, n: int, nburn: int = 0,
                 width: float = 1.0, coords=None, uniforms=None) -> torch.Tensor:
    """Draw ``n`` samples (after ``nburn`` sweeps) from ``logpdf`` for every
    row of ``u0`` (R, p) in lock step → (R, n, p); a (p,) ``u0`` is one row
    and gives (n, p).

    ``logpdf`` maps (..., R, p) to (..., R) on u0's device, in its dtype; a
    non-finite value counts as −∞. ``coords`` lists the coordinates to sweep;
    the others stay at u0. ``uniforms`` (R, n + nburn, len(coords), 66)
    defaults to ``draw_uniforms(gen, ...)``. The semantics are those of the
    JAX package's ``_slice_coord``: step-out while f(edge) > log y, at most 32
    steps a side, the two sides of a row evaluated in one batch of 2R rows;
    shrink until f(x1) ≥ log y, at most 64 draws, a row that exhausts them
    keeping (x0, lp0).
    """
    single = u0.ndim == 1
    u = (u0[None] if single else u0).clone()
    dtype, dev = u.dtype, u.device
    R, p = u.shape
    coords = tuple(range(p)) if coords is None else tuple(coords)
    sweeps = n + nburn
    if uniforms is None:
        uniforms = draw_uniforms(gen, R, sweeps, len(coords))
    uniforms = uniforms.to(dtype=dtype, device=dev)

    def lp_of(v):
        slice_sample.evaluations += 1
        return torch.nan_to_num(logpdf(v), nan=-math.inf, posinf=-math.inf)

    # a step-out moves the left edges by −width and the right ones by +width
    step = torch.tensor([[-width], [width]], dtype=dtype, device=dev)
    # u with coordinate j set to x is where(at[j], x, u)
    at = {j: torch.arange(p, device=dev) == j for j in coords}
    lp = lp_of(u)
    out = []
    for it in range(sweeps):
        for k, j in enumerate(coords):
            at_j = at[j]
            unif = uniforms[:, it, k]
            logy = lp + torch.log(unif[:, 0])
            x0 = u[:, j]
            left = x0 - unif[:, 1] * width
            # step-out: both edges of every row in one batch of 2R rows
            edge = torch.stack([left, left + width])
            go = torch.ones((2, R), dtype=torch.bool, device=dev)
            for _ in range(_MAX_STEPOUT):
                go = go & (lp_of(torch.where(at_j, edge[..., None], u)) > logy)
                edge = torch.where(go, edge + step, edge)
                slice_sample.host_reads += 1
                if not bool(go.any()):
                    break
            left, right = edge[0], edge[1]
            # shrink; rows already done keep their (x1, lp1) and bracket
            x1, lp1 = x0, lp
            done = torch.zeros(R, dtype=torch.bool, device=dev)
            for s in range(_MAX_SHRINK):
                xc = left + unif[:, 2 + s] * (right - left)
                lpc = lp_of(torch.where(at_j, xc[:, None], u))
                acc = ~done & (lpc >= logy)
                x1 = torch.where(acc, xc, x1)
                lp1 = torch.where(acc, lpc, lp1)
                done = done | acc
                below = xc < x0
                left = torch.where(~done & below, xc, left)
                right = torch.where(~done & ~below, xc, right)
                slice_sample.host_reads += 1
                if bool(done.all()):
                    break
            u = torch.where(at_j, x1[:, None], u)
            lp = lp1
        if it >= nburn:
            out.append(u)
    us = torch.stack(out, dim=1) if out else u.new_empty((R, 0, p))
    return us[0] if single else us


#: Since the counts were last set to 0: host reads (one flag per lock-step
#: iteration) and log-density evaluations (one per iteration, all rows at
#: once, and one for the starting rows of each run).
slice_sample.host_reads = 0
slice_sample.evaluations = 0


def slice_sample_plain(logpdf: Callable, u0, uniforms, n: int, nburn: int = 0,
                       width: float = 1.0, coords=None) -> torch.Tensor:
    """The plain version of ``slice_sample``: one row (p,), sequential host
    control flow, one host read per log density, on the row's uniforms
    (n + nburn, len(coords), 66) → (n, p). ``logpdf`` is called on (1, p)
    rows, as ``slice_sample`` calls it."""
    u = torch.as_tensor(u0, dtype=torch.float64).clone()
    coords = tuple(range(u.shape[0])) if coords is None else tuple(coords)

    def f(v):
        lp = float(logpdf(v[None])[0])
        return lp if math.isfinite(lp) else -math.inf

    lp = f(u)
    out = []
    for it in range(n + nburn):
        for k, j in enumerate(coords):
            unif = [float(a) for a in uniforms[it, k]]
            logy = lp + math.log(unif[0])
            x0 = float(u[j])
            left = x0 - unif[1] * width
            right = left + width
            for _ in range(_MAX_STEPOUT):
                if not f(_set_coord(u, j, left)) > logy:
                    break
                left -= width
            for _ in range(_MAX_STEPOUT):
                if not f(_set_coord(u, j, right)) > logy:
                    break
                right += width
            for s in range(_MAX_SHRINK):
                x1 = left + unif[2 + s] * (right - left)
                lp1 = f(_set_coord(u, j, x1))
                if lp1 >= logy:
                    u, lp = _set_coord(u, j, x1), lp1
                    break
                if x1 < x0:
                    left = x1
                else:
                    right = x1
        if it >= nburn:
            out.append(u)
    return torch.stack(out) if out else torch.empty((0, u.shape[0]), dtype=torch.float64)


def _run_chains(gen: torch.Generator, logpdf: Callable, u0, n: int, nburn: int, coords,
                n_chains: int) -> torch.Tensor:
    """n draws from ``n_chains`` chains of each leading row of ``u0`` (..., p)
    → (..., n, p), the layout of the JAX package's ``_run_chains``: chain 0
    starts at u0, the others at u0 + 0.3·N(0, 1) on the swept coordinates
    only; each chain burns ``nburn`` and draws ⌈n / n_chains⌉; the draws are
    interleaved round-robin, then truncated to n. All chains of all rows are
    one lock-step batch; ``logpdf`` sees them as (..., *batch, n_chains, p)."""
    C = max(1, int(n_chains))
    batch, p = u0.shape[:-1], u0.shape[-1]
    per = -(-n // C)
    u0s = u0[..., None, :].expand(*batch, C, p)
    if C > 1:
        jitter = 0.3 * torch.randn((*batch, C, p), generator=gen, dtype=torch.float64)
        jitter[..., 0, :] = 0.0
        swept = torch.zeros(p, dtype=torch.bool)
        swept[list(coords)] = True
        jitter = torch.where(swept, jitter, torch.zeros_like(jitter)).to(u0.dtype).to(u0.device)
        u0s = u0s + jitter
    R = u0s.numel() // p

    def rows_logpdf(v):  # (..., R, p) → (..., R)
        lead = v.shape[:-2]
        return logpdf(v.reshape(*lead, *batch, C, p)).reshape(*lead, R)

    us = slice_sample(gen, rows_logpdf, u0s.reshape(R, p), per, nburn, coords=coords)  # (R, per, p)
    us = us.reshape(*batch, C, per, p).transpose(-3, -2)
    return us.reshape(*batch, per * C, p)[..., :n, :]


def _names_for(opts: BQOptions):
    """Reference hyper names → θ indices: h, w_1..w_d, and the family's
    period ``p`` (periodic: (h, w, p)) or shape ``alpha`` (rq)."""
    if opts.kernel == "periodic":
        return {"h": (0,), "w": (1,), "p": (2,)}
    if opts.kernel == "rq":
        return {"h": (0,), "w": tuple(range(1, opts.dim + 1)), "alpha": (opts.dim + 1,)}
    return {"h": (0,), "w": tuple(range(1, opts.dim + 1))}


def param_coords(params, opts: BQOptions):
    """Resolve hyper names to (coords, sample_l): ``h`` / ``w`` select the
    log-GP's θ, ``h_l`` / ``w_l`` the linear GP's; the coordinates index the
    stacked log-parameter vector u = (log θ_tl, log θ_l)."""
    local = _names_for(opts)
    p_tl = theta_len(opts)
    coords, sample_l = [], False
    for name in params:
        base, is_l = (name[:-2], True) if name.endswith("_l") else (name, False)
        if base not in local:
            raise ValueError(
                f"unknown hyperparameter {name!r} for kernel {opts.kernel!r}; "
                f"valid: {sorted(local)} (+ '_l' suffix for the linear GP)"
            )
        sample_l = sample_l or is_l
        coords.extend((p_tl if is_l else 0) + j for j in local[base])
    return tuple(sorted(set(coords))), sample_l


def log_density(state: BQState, opts: BQOptions, sample_l: bool = False,
                prior_std: float = _PRIOR_STD) -> Callable:
    """The sampler's target as a function of rows u (..., *batch, C, p) →
    (..., *batch, C), where ``batch`` is the state's problem axes (none for a
    single problem) and C any number of rows per problem: log MLL(e^u) plus
    the N(0, prior_std²) log prior, −∞ where not finite.

    θ_tl rows (p = p_tl): the log-GP's MLL. Joint rows (p = p_tl + p_l, with
    ``sample_l``): the log-GP's MLL plus the linear GP's on candidates
    re-anchored under θ_tl by the fixed-jitter fit (``gp_fit(ladder=False)``,
    then γ·expm1 of its mean at x_c under c_mask), as ``_fit_gps`` applies
    the dependency, so the sampled posterior matches what ``marginalize``
    evaluates."""
    kfn, _ = get_kernel(opts.kernel)
    st = with_sample_axis(state)
    gp_tl, gp_l = st.gp_log_l, st.gp_l
    p_tl = theta_len(opts)
    jitter = opts.base_jitter

    def prior_and_mask(u, mll):
        tot = mll - 0.5 * ((u / prior_std) ** 2).sum(-1)
        return torch.nan_to_num(tot, nan=-math.inf, posinf=-math.inf)

    # The data's terms of both MLLs are formed once here, not per evaluation;
    # ``kernel=True``: a float32 stack on the card factors on ``chol_batch``.
    if not sample_l:
        mll_tl = gpm.log_mll_fn(kfn, gp_tl.s, st.x_s, st.obs_mask, jitter, kernel=True)

        def logpdf(u):
            return prior_and_mask(u, mll_tl(torch.exp(u), st.tl_s))

        return logpdf

    fit_tl = gpm.fixed_fit_fn(kfn, gp_tl.s, st.x_s, st.tl_s, st.obs_mask, jitter, kernel=True)
    mll_l = gpm.log_mll_fn(kfn, gp_l.s, st.x_sc, st.sc_mask, jitter, kernel=True)
    l_s = torch.where(st.obs_mask, st.l_s, 0.0)

    def logpdf(u):
        gp_tl_u = fit_tl(torch.exp(u[..., :p_tl]))
        m_tl_c = gpm.gp_mean(kfn, gp_tl_u, st.x_c)
        l_c = torch.where(st.c_mask, st.gamma[..., None] * torch.expm1(m_tl_c), 0.0)
        l_sc = torch.cat([l_s.expand(*l_c.shape[:-1], -1), l_c], dim=-1)
        # the log-GP's MLL from the same fixed-jitter factor as the re-anchoring
        mll = gpm.fit_log_mll(gp_tl_u) + mll_l(torch.exp(u[..., p_tl:]), l_sc)
        return prior_and_mask(u, mll)

    return logpdf


def sample_hypers(state: BQState, opts: BQOptions, gen: torch.Generator, n: int,
                  nburn: int = 10, params=None, n_chains: int = 1,
                  prior_std: float = _PRIOR_STD) -> torch.Tensor:
    """Slice-sample hyperparameters from MLL × a weak log-normal prior →
    (n, p) for a single state, (B, n, p) for a fleet state, on the state's
    device in its dtype.

    ``params``, a name or a sequence of names, names the hypers that move
    (default: every θ_tl hyper); the rest stay at their current values.
    Plain names (``h``, ``w``) sample θ_tl and give p = p_tl; any ``*_l``
    name samples the joint posterior over
    (θ_tl, θ_l) and gives stacked rows, p = p_tl + p_l, which
    ``marginalize`` and ``choose_next`` take as they are. ``n_chains``
    chains per problem (see ``_run_chains``); a fleet's B·n_chains chains are
    one lock-step batch against each problem's own data.
    """
    if params is None:
        params = tuple(sorted(_names_for(opts)))
    elif isinstance(params, str):
        params = (params,)
    coords, sample_l = param_coords(params, opts)
    u0 = torch.log(state.gp_log_l.theta)
    if sample_l:
        u0 = torch.cat([u0, torch.log(state.gp_l.theta)], dim=-1)
    logpdf = log_density(state, opts, sample_l, prior_std)
    return torch.exp(_run_chains(gen, logpdf, u0, n, nburn, coords, n_chains))


def marginalize(state: BQState, opts: BQOptions, hyper_samples, funs=(Z_mean, Z_var)):
    """Evaluate ``funs`` under every row of ``hyper_samples`` as one batch →
    tuple of (S,) tensors; over a fleet state (B, S, p) rows give (B, S).
    Rows are θ_tl (width p_tl) or joint θ_tl ∥ θ_l (width p_tl + p_l)."""
    st = apply_hyper_sample(state, opts, hyper_samples, need_kinv=False)
    return tuple(f(st, opts) for f in funs)
