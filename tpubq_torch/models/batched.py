"""Fleet API: many independent BQ problems advanced together.

Counterpart of ``tpubq/models/batched.py``. A fleet is one ``BQState`` whose
every leaf has a leading problem axis B. Where the JAX package takes the
``vmap`` of its single-problem program, the port's core functions
(``models/bq.py``, ``models/acquire.py``, ``models/gp.py``, ``ops/linalg.py``)
index their data from the back and run on the batched state directly: a refit
of the fleet is one batched jitter ladder, which in float32 sends all 2·B
Grams of a GP as one (B, 2, n, n) rung stack to the ``chol_batch`` kernel with
no host sync.

All problems share one ``BQOptions`` (static shapes); their data, measures and
hyperparameters vary freely.

Scoring: a float32 gaussian fleet with d ≤ 3 scores a shared grid with two
hand-written kernels, ``esm_fleet_l`` and ``esm_fleet_tl`` (B problems × G
points per launch; their plain versions on the CPU), and one elementwise
combine (``expected_squared_mean_fleet``). Everything else (float64,
per-problem grids, sizes beyond the kernels) takes the plain batched scorer,
``acquire.expected_squared_mean_xla`` over the problem axis.

Hyper-marginalization: ``sample_hypers_batch`` runs all B·n_chains chains of
the fleet as one lock-step slice sampler against each problem's own data
(``marginalize.sample_hypers``); ``marginalize_batch`` installs (B, S, p)
rows as one batched refit (a (B, S, n, n) Gram stack per GP, one ``chol_batch``
launch per rung stack in float32 on the card); ``choose_next_marg_batch``
re-anchors S_chunk rows of every problem at a time and scores them as one
flattened fleet of B·S_chunk problems through ``expected_squared_mean_batch``
(the fleet kernels where ``fleet_scorer_supported``), then averages each
problem's scores over its own rows before the selection.

Persistence and health: ``BQFleet.save`` / ``load`` write and read the whole
batched state through ``utils.io`` (the JAX package's checkpoint layout, the
seed as an extra); ``BQFleet.health`` is ``utils.health.check_state`` on the
batched state, each leaf with a leading (B,) axis.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from tpubq_torch.models import acquire, bq as bqm, fit as fitm, gp as gpm, marginalize as margm
from tpubq_torch.models.bq import BQState
from tpubq_torch.ops import hopper_kernels as hk
from tpubq_torch.utils.device import resolve_device
from tpubq_torch.utils.options import BQOptions, parse_bq_kwargs

__all__ = [
    "BQFleet",
    "init_batch",
    "Z_mean_batch",
    "Z_var_batch",
    "expected_squared_mean_batch",
    "expected_squared_mean_fleet",
    "expected_Z_var_batch",
    "fit_batch",
    "fleet_scorer_supported",
    "choose_next_batch",
    "add_observation_batch",
    "run_active_loop_batch",
    "sample_hypers_batch",
    "marginalize_batch",
    "choose_next_marg_batch",
]

#: Noise multiplier of the fleet scorer's adaptive guard: a Schur complement
#: γ = κ − kᵀK⁻¹k at or below λ·kᵀ|K⁻¹|k is not resolved by a float32 FMA dot
#: and scores as degenerate. The safety factor × float32 unit roundoff of the
#: single-problem scorer (``acquire._LAM_F32``).
_LAM_F32 = acquire._LAM_F32

def _shared_or_per_problem(v, B: int, d: int, what: str, per_problem_shape):
    """A 1-D measure argument: (d,) is shared, (B,) is per problem in 1-D."""
    if v.shape[0] == d:
        if B == d and d > 1:
            warnings.warn(
                f"{what} of shape ({d},) with B == d == {d} is read as ONE shared "
                f"{'d-dimensional mean' if what == 'x_means' else 'diagonal'}; pass an "
                f"explicit {per_problem_shape} array for per-problem values",
                stacklevel=3,
            )
        return True
    if d == 1 and v.shape[0] == B:
        return False
    raise ValueError(
        f"{what} of shape {v.shape} matches neither (d,)=({d},) shared nor "
        f"(B,)=({B},) per-problem (d=1) form"
    )


def init_batch(
    xs,
    ls,
    opts: BQOptions,
    params_tl=None,
    params_l=None,
    s_tl=0.0,
    s_l=0.0,
    gamma=1.0,
    x_means=None,
    x_vars=None,
    device="cuda",
) -> BQState:
    """Build a batched BQState from (B, n) observations on ``device`` (the
    card unless the caller names another).

    ``xs``: (B, n) or (B, n, d); ``ls``: (B, n) positive. Measures broadcast
    like hyperparameters: scalar / (d,) / (d, d) are shared across the fleet,
    (B, d) / (B, d, d) (and (B,) in 1-D) are per problem; the default is the
    standard normal. Hyperparameters may be shared (p,) or per problem
    (B, p). Returns a BQState whose every leaf has a leading B axis.
    """
    np_dtype = np.float64 if opts.dtype == "float64" else np.float32
    dtype = opts.torch_dtype
    dev = resolve_device(device)
    xs = np.asarray(xs, np_dtype)
    if xs.ndim == 2:
        xs = xs[:, :, None]
    ls = np.asarray(ls, np_dtype)
    B, n, d = xs.shape
    if d != opts.dim:
        raise ValueError(f"x has dim {d}, options say {opts.dim}")
    if ls.shape != (B, n):
        raise ValueError("ls must be (B, n) matching xs")
    if np.any(ls <= 0) or not np.all(np.isfinite(ls)):
        raise ValueError("l must be finite and positive")
    if n > opts.max_obs:
        raise ValueError(f"{n} observations exceed max_obs={opts.max_obs}")

    params_tl = bqm.default_params(opts) if params_tl is None else params_tl
    params_l = bqm.default_params(opts) if params_l is None else params_l
    for name, p in (("params_tl", params_tl), ("params_l", params_l)):
        bqm.validate_theta(np.zeros(np.asarray(p, np_dtype).shape[-1]), opts, name)
        bqm.validate_theta_values(p, opts, name)

    if x_means is None:
        x_means = np.zeros((B, d), np_dtype)
    else:
        x_means = np.asarray(x_means, np_dtype)
        if x_means.ndim == 0:
            x_means = np.full((B, d), float(x_means), np_dtype)
        elif x_means.ndim == 1:
            if _shared_or_per_problem(x_means, B, d, "x_means", "(B, d)"):
                x_means = np.broadcast_to(x_means, (B, d))
            else:
                x_means = x_means[:, None]
    x_means = np.asarray(x_means, np_dtype).reshape(B, d)
    if x_vars is None:
        x_vars = np.tile(np.eye(d, dtype=np_dtype)[None], (B, 1, 1))
    else:
        x_vars = np.asarray(x_vars, np_dtype)
        if x_vars.ndim == 0:
            x_vars = np.eye(d, dtype=np_dtype) * x_vars
        elif x_vars.ndim == 1:
            if _shared_or_per_problem(x_vars, B, d, "x_vars", "(B, d, d)"):
                x_vars = np.diag(x_vars)
            else:
                x_vars = x_vars[:, None, None]
        if x_vars.ndim == 2:
            x_vars = np.broadcast_to(x_vars, (B, d, d))
    x_vars = np.asarray(x_vars, np_dtype).reshape(B, d, d)
    bqm.validate_measure(x_vars)
    if not np.isfinite(float(gamma)) or float(gamma) <= 0.0:
        raise ValueError(f"gamma must be finite and > 0, got {gamma}")

    def per_problem(params):
        p = np.asarray(params, np_dtype)
        if p.ndim == 1:
            return np.broadcast_to(p, (B, p.shape[0])).copy()
        if p.shape[0] != B:
            raise ValueError(f"per-problem params must be (B, p); got {p.shape}")
        return p

    def t(v):
        return torch.as_tensor(np.ascontiguousarray(v), dtype=dtype, device=dev)

    def zeros(*shape, dt=dtype):
        return torch.zeros((B, *shape), dtype=dt, device=dev)

    def empty_gp(theta, s, m):
        eye = torch.eye(m, dtype=dtype, device=dev).expand(B, m, m)
        return gpm.GPState(t(per_problem(theta)), torch.full((B,), float(s), dtype=dtype, device=dev),
                           zeros(m, d), zeros(m), zeros(m, dt=torch.bool), eye, zeros(m), eye,
                           zeros(), torch.ones((B,), dtype=torch.bool, device=dev))

    pad = opts.max_obs - n
    nc = opts.n_candidate
    obs_mask = (torch.arange(opts.max_obs, device=dev) < n).repeat(B, 1)
    state = BQState(
        x_s=torch.cat([t(xs), zeros(pad, d)], dim=1),
        l_s=torch.cat([t(ls), zeros(pad)], dim=1),
        tl_s=zeros(opts.max_obs),
        obs_mask=obs_mask,
        ns=torch.full((B,), n, dtype=torch.int64, device=dev),
        x_c=zeros(nc, d),
        l_c=zeros(nc),
        c_mask=zeros(nc, dt=torch.bool),
        gamma=torch.full((B,), float(gamma), dtype=dtype, device=dev),
        x_mean=t(x_means),
        x_var=t(x_vars),
        gp_log_l=empty_gp(params_tl, s_tl, opts.max_obs),
        gp_l=empty_gp(params_l, s_l, opts.max_nsc),
    )
    return bqm._fit_gps(state, opts)


def _require_batched(states: BQState) -> int:
    if states.ns.ndim != 1:
        raise ValueError(
            "a fleet function needs a BATCHED state (every leaf with a leading problem "
            "axis); this looks like a single-problem state"
        )
    return states.ns.shape[0]


def Z_mean_batch(states: BQState, opts: BQOptions) -> torch.Tensor:
    """E[Z] of every problem → (B,)."""
    _require_batched(states)
    return bqm.Z_mean(states, opts)


def Z_var_batch(states: BQState, opts: BQOptions) -> torch.Tensor:
    """V[Z] of every problem → (B,)."""
    _require_batched(states)
    return bqm.Z_var(states, opts)


def fleet_scorer_supported(opts: BQOptions) -> bool:
    """Whether the fleet ESM kernels are the auto-dispatched scorer for this
    configuration: float32 (the device dtype), gaussian kernel, d ≤ 3, and at
    most 220 rows per problem for both GPs (``esm_fleet_l_supported(max_nsc)``,
    ``esm_fleet_tl_supported(max_obs)``).

    The kernels' quadratic forms are full-float32 FMA products, so there is
    no precision boundary below that cap: measured against float64 the
    kernels are as close as the plain batched float32 scorer at 28, 60 and
    126 rows per problem (PERF.md §6). The cap is where the first design's
    shared memory ended; widening it waits for that measurement beyond 126
    rows.
    """
    return (
        opts.dtype == "float32"
        and opts.kernel == "gaussian"
        and opts.dim <= 3
        and hk.esm_fleet_l_supported(opts.max_nsc, opts.dim)
        and hk.esm_fleet_tl_supported(opts.max_obs, opts.dim)
    )


def _inv_det_small(M: torch.Tensor):
    """Closed-form batched inverse and determinant of (..., d, d), d ≤ 3:
    elementwise tensor ops, no library factorization and no host sync."""
    d = M.shape[-1]
    if d == 1:
        det = M[..., 0, 0]
        return (1.0 / det)[..., None, None], det
    if d == 2:
        a, b, c, e = M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1]
        det = a * e - b * c
        adj = torch.stack([torch.stack([e, -b], -1), torch.stack([-c, a], -1)], -2)
        return adj / det[..., None, None], det
    if d == 3:
        a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        e, f, g = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
        h, i, j = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
        A = f * j - g * i
        Bc = -(e * j - g * h)
        C = e * i - f * h
        det = a * A + b * Bc + c * C
        adj = torch.stack(
            [
                torch.stack([A, -(b * j - c * i), b * g - c * f], -1),
                torch.stack([Bc, a * j - c * h, -(a * g - c * e)], -1),
                torch.stack([C, -(a * i - b * h), a * f - b * e], -1),
            ],
            -2,
        )
        return adj / det[..., None, None], det
    raise ValueError(f"d={d} > 3 unsupported")


def fleet_scorer_inputs(states: BQState, opts: BQOptions):
    """Pack a float32 gaussian fleet for the two scorer kernels →
    (``esm_fleet_l``'s tensors (params, w2inv, xsc, msc, Kinv, uz, alpha),
    ``esm_fleet_tl``'s (h2, w2inv, xs, ms, Kinv, alpha), zᵀα (B,)); the grid
    goes in third in both calls.

    The per-problem scalars (κ, zᵀα, the ζ scale and ½(W_l+Σ)⁻¹) come from
    closed-form d ≤ 3 inverses in elementwise ops; the inverses K⁻¹ go in as
    they lie in the state."""
    dtype = states.x_s.dtype
    d = opts.dim
    B = states.ns.shape[0]
    gp_l, gp_tl = states.gp_l, states.gp_log_l
    x_sc = states.x_sc.contiguous()
    m_sc = states.sc_mask.to(dtype)
    h_l, w_l = gp_l.theta[:, 0], gp_l.theta[:, 1:]
    h_tl, w_tl = gp_tl.theta[:, 0], gp_tl.theta[:, 1:]
    Am = torch.diag_embed(w_l * w_l) + states.x_var  # W_l + Σ, (B, d, d)
    Ainv, detA = _inv_det_small(Am)
    zc = h_l * h_l * torch.prod(w_l, dim=1) / torch.sqrt(detA)
    AinvH = 0.5 * Ainv

    # z_i = ∫ k_l(x', x_i) p(x') dx' = zc · exp(−(x_i − μ)ᵀ ½A⁻¹ (x_i − μ)):
    # the quadratic form the kernel evaluates as ζ on the grid
    diff = x_sc - states.x_mean[:, None, :]
    q = torch.zeros(diff.shape[:2], dtype=dtype, device=diff.device)
    for i in range(d):
        for j in range(d):
            q = q + AinvH[:, i, j][:, None] * diff[..., i] * diff[..., j]
    z = zc[:, None] * torch.exp(-q) * m_sc
    uz = (gp_l.Kinv * z[:, None, :]).sum(2)
    zTa = (z * gp_l.alpha).sum(1)
    kappa = h_l * h_l + gp_l.s * gp_l.s + gp_l.jitter

    params = torch.zeros((B, hk.FLEET_PARAMS), dtype=dtype, device=z.device)
    params[:, 0], params[:, 1], params[:, 2] = kappa, zTa, zc
    params[:, 3:3 + d] = states.x_mean
    params[:, 6:6 + d * d] = AinvH.reshape(B, d * d)
    params[:, 15] = h_l * h_l
    args_l = (params, (0.5 / (w_l * w_l)).contiguous(), x_sc, m_sc, gp_l.Kinv.contiguous(),
              uz, gp_l.alpha.contiguous())
    args_tl = (h_tl * h_tl, (0.5 / (w_tl * w_tl)).contiguous(), states.x_s.contiguous(),
               states.obs_mask.to(dtype), gp_tl.Kinv.contiguous(), gp_tl.alpha.contiguous())
    return args_l, args_tl, zTa


def expected_squared_mean_fleet(states: BQState, opts: BQOptions, grid, interpret=None,
                                tile: int = 2048, fast: bool = False,
                                lam: float = None) -> torch.Tensor:
    """(B, G) ESM over a SHARED grid through the two fleet kernels and one
    elementwise combine.

    Semantics are those of the batched ``acquire.expected_squared_mean_xla``
    with the guard γ ≤ max(eps·κ, λ·kᵀ|K⁻¹|k); ``lam`` overrides λ. Needs a
    float32 gaussian fleet with d ≤ 3 and at most 220 rows per problem (any
    such size, whatever ``fleet_scorer_supported`` dispatches).
    ``interpret``, ``tile`` and ``fast`` belong to the JAX package's signature
    (its interpreter, its grid tiling and its single-pass bf16 mode, all
    mechanisms of the TPU kernel) and are accepted and ignored.
    """
    del interpret, tile, fast
    d = opts.dim
    if not (opts.dtype == "float32" and opts.kernel == "gaussian" and d <= 3
            and hk.esm_fleet_l_supported(opts.max_nsc, d)
            and hk.esm_fleet_tl_supported(opts.max_obs, d)):
        raise ValueError(
            "the fleet scorer needs f32 gaussian d<=3 with at most 220 rows per problem; "
            f"got dtype={opts.dtype!r}, kernel={opts.kernel!r}, dim={d}, "
            f"max_nsc={opts.max_nsc}, max_obs={opts.max_obs}"
        )
    _require_batched(states)
    dtype = states.x_s.dtype
    x_a = acquire.as_points(grid, d, dtype, states.x_s.device).contiguous()
    args_l, args_tl, zTa = fleet_scorer_inputs(states, opts)
    params, w2inv_l, *rest_l = args_l
    h2_tl, w2inv_tl, *rest_tl = args_tl
    A, Bc, dg = hk.esm_fleet_l(params, w2inv_l, x_a, *rest_l, float(opts.candidate_thresh),
                               float(_LAM_F32 if lam is None else lam))
    m_a, c_a = hk.esm_fleet_tl(h2_tl, w2inv_tl, x_a, *rest_tl)

    # the lognormal combine, elementwise over (B, G)
    E1, E2 = acquire._lognormal_moments(m_a, c_a, states.gamma[:, None])
    esm = A * A + 2.0 * A * Bc * E1 + Bc * Bc * E2
    return torch.where(dg > 0, (zTa * zTa)[:, None], esm)


def expected_squared_mean_batch(states: BQState, opts: BQOptions, grids,
                                per_problem: bool = False, fast: bool = False) -> torch.Tensor:
    """(B, G) ESM scores.

    ``per_problem=False`` (default): one shared grid, (G,) or (G, d).
    ``per_problem=True``: a grid per problem, (B, G) or (B, G, d). Explicit
    rather than shape-inferred: a shared (G, d) grid with G == B would
    otherwise be misread as per-problem rows.

    A shared grid under ``fleet_scorer_supported(opts)`` goes to the fleet
    kernels; everything else to the plain batched scorer. ``fast`` is the JAX
    package's single-pass bf16 mode of its TPU kernel: accepted, ignored.
    """
    B = _require_batched(states)
    dtype, dev = states.x_s.dtype, states.x_s.device
    if not per_problem:
        if fleet_scorer_supported(opts):
            return expected_squared_mean_fleet(states, opts, grids, fast=fast)
        return acquire.expected_squared_mean_xla(states, opts, grids)
    grids = torch.as_tensor(grids, dtype=dtype, device=dev)
    if grids.ndim == 2:
        if opts.dim != 1:
            raise ValueError("per-problem grids for dim > 1 must be (B, G, d)")
        grids = grids[:, :, None]
    if grids.ndim != 3 or grids.shape[0] != B or grids.shape[2] != opts.dim:
        raise ValueError(f"per-problem grids must be (B, G, d) = ({B}, G, {opts.dim}); "
                         f"got {tuple(grids.shape)}")
    return acquire.expected_squared_mean_xla(states, opts, grids)


def expected_Z_var_batch(states: BQState, opts: BQOptions, grids, per_problem: bool = False,
                         fast: bool = False) -> torch.Tensor:
    """(B, G) expected posterior variance after sampling each grid point:
    Z_mean² + Z_var − ESM per problem."""
    zm = Z_mean_batch(states, opts)
    zv = Z_var_batch(states, opts)
    esm = expected_squared_mean_batch(states, opts, grids, per_problem, fast=fast)
    return (zm * zm + zv)[:, None] - esm


def _fused_fit_ok(opts: BQOptions, fit_noise: bool) -> bool:
    return not fit_noise and opts.kernel == "gaussian" and opts.dim == 1 and opts.dtype == "float32"


def fit_batch(states: BQState, opts: BQOptions, gen: torch.Generator, ntry: int = 10,
              free_mask=None, fit_noise: bool = False) -> BQState:
    """Per-problem multi-restart MLL fit of both GPs (the fleet spelling of
    ``BQ.fit_hypers``): each problem fits θ_tl on its observations, re-anchors
    its candidates, then fits θ_l. ``free_mask``: optional (p,) bool shared
    across the fleet. ``fit_noise``: also fit each GP's observation noise.

    Route: float32, the gaussian kernel, d = 1 and a fixed noise advance all
    B·ntry restart rows of a GP in ONE ``mll_grad_batched`` call per Adam
    iteration (``fit_params_fused`` on the fleet's data) at any size, so a
    whole fleet fit is 2·(n_iter + 1) calls (``mll_grad_launches(n)`` launches
    each). Every other fixed-noise fit (the other kernel families, float64)
    advances all B·ntry rows as one lock-step L-BFGS (``fit_params`` on the
    fleet's data); a noise fit loops the problems over
    ``fit_params_with_noise``. The refits between and after the two stages
    are batched either way.
    """
    B = _require_batched(states)

    def stage(gp, x, y, mask):
        """Fitted (theta (B, p), s (B,) or None) of one GP over the fleet."""
        if not fit_noise:
            inits = fitm.random_restarts(gen, gp.theta, x, y, mask, ntry, kernel=opts.kernel)
            if _fused_fit_ok(opts, fit_noise):
                theta, _ = fitm.fit_params_fused(gp.theta, gp.s, x, y, mask, gen, inits,
                                                 free_mask=free_mask)
            else:
                theta, _ = fitm.fit_params(opts.kernel, gp.theta, gp.s, x, y, mask, gen, inits,
                                           free_mask=free_mask)
            return theta, None
        thetas, ss = [], []
        for i in range(B):
            th, s, _ = fitm.fit_params_with_noise(
                opts.kernel, gp.theta[i], gp.s[i], x[i], y[i], mask[i], gen,
                n_restart=ntry, free_mask=free_mask)
            thetas.append(th)
            ss.append(s)
        return torch.stack(thetas), torch.stack(ss)

    theta_tl, s_tl = stage(states.gp_log_l, states.x_s, states.tl_s, states.obs_mask)
    st = bqm.set_params(states, opts, theta_tl=theta_tl, s_tl=s_tl)
    l_sc = torch.where(st.sc_mask, st.l_sc, torch.zeros_like(st.l_sc))
    theta_l, s_l = stage(st.gp_l, st.x_sc, l_sc, st.sc_mask)
    return bqm.set_params(st, opts, theta_l=theta_l, s_l=s_l)


def choose_next_batch(states: BQState, opts: BQOptions, grid, fast: bool = False):
    """Per-problem argmax of the ESM over a shared grid → ((B, d), (B, G)),
    each problem's selection demoting grid points near its own observations
    (``acquire.demote_near_observed``). ``fast``: accepted, ignored (see
    ``expected_squared_mean_batch``)."""
    scores = expected_squared_mean_batch(states, opts, grid, fast=fast)
    grid2 = acquire.as_points(grid, opts.dim, states.x_s.dtype, states.x_s.device)
    sel = acquire.demote_near_observed(scores, grid2, states.x_s, states.obs_mask,
                                       opts.candidate_thresh)
    return grid2[torch.argmax(sel, dim=1)], scores


def add_observation_batch(states: BQState, opts: BQOptions, x_new, l_new) -> BQState:
    """Append one observation per problem ((B, d), (B,)) and refit the whole
    fleet in one batched refit."""
    _require_batched(states)
    return acquire.add_observation(states, opts, x_new, l_new)


def sample_hypers_batch(states: BQState, opts: BQOptions, gen: torch.Generator, n: int,
                        nburn: int = 10, params=None, n_chains: int = 1,
                        prior_std: float = None) -> torch.Tensor:
    """(B, n, p) per-problem hyper-posterior draws: every problem's
    ``n_chains`` chains, B·n_chains rows in all, advance as one lock-step
    slice sampler (``marginalize.sample_hypers`` on the fleet state)."""
    _require_batched(states)
    return margm.sample_hypers(states, opts, gen, n, nburn=nburn, params=params, n_chains=n_chains,
                               prior_std=margm._PRIOR_STD if prior_std is None else prior_std)


def marginalize_batch(states: BQState, opts: BQOptions, hyper_samples, funs=None):
    """Per-problem hyper-marginalized estimates: ``hyper_samples`` (B, S, p)
    (θ_tl or joint rows, e.g. from ``sample_hypers_batch``) → tuple of (B, S)
    tensors, one batched refit of all B·S rows."""
    B = _require_batched(states)
    if funs is None:
        funs = (bqm.Z_mean, bqm.Z_var)
    hyper_samples = torch.as_tensor(hyper_samples, dtype=states.x_s.dtype, device=states.x_s.device)
    if hyper_samples.ndim != 3 or hyper_samples.shape[0] != B:
        raise ValueError(f"hyper_samples must be (B, S, p) with B = {B}; got {tuple(hyper_samples.shape)}")
    return margm.marginalize(states, opts, hyper_samples, funs)


#: Elements of the scorer's largest intermediate per chunk of
#: ``choose_next_marg_batch``: B·S_chunk·G per output of the fleet kernels,
#: B·S_chunk·G·max(max_nsc, nodes) for the plain batched scorer, where
#: ``bq.int_K_nodes`` counts the node axis of the mixture and series integrals
#: on the grid.
_MARG_CHUNK_ELEMS = 1 << 26


def marg_chunk(B: int, S: int, G: int, opts: BQOptions) -> int:
    """Hyper rows per problem that ``choose_next_marg_batch`` re-anchors and
    scores at a time: memory stays O(B·S_chunk·G) (times max_nsc, or the
    integrals' node axis, on the plain scorer) and B·S_chunk within the fleet
    kernels' launch limit. The Matérn V[Z] sweep of ``marginalize_batch``
    chunks its own rows and node pairs (``integrals.SWEEP_ELEMS``)."""
    if fleet_scorer_supported(opts):
        per_row = G * 8
    else:
        per_row = G * max(opts.max_nsc, bqm.int_K_nodes(opts))
    return max(1, min(S, _MARG_CHUNK_ELEMS // max(1, B * per_row), hk.FLEET_MAX_PROBLEMS // B))


def _marg_scores(states: BQState, opts: BQOptions, grid, thetas) -> torch.Tensor:
    """(B, G) ESM of each problem averaged over its own rows of ``thetas``
    (B, S, p): S_chunk rows of every problem are installed at once and the
    B·S_chunk re-anchored states scored as one flattened fleet; each
    problem's scores are summed over its rows."""
    B = _require_batched(states)
    dtype, dev = states.x_s.dtype, states.x_s.device
    thetas = torch.as_tensor(thetas, dtype=dtype, device=dev)
    if thetas.ndim != 3 or thetas.shape[0] != B:
        raise ValueError(f"thetas must be (B, S, p) with B = {B}; got {tuple(thetas.shape)}")
    grid = acquire.as_points(grid, opts.dim, dtype, dev)
    S, G = thetas.shape[1], grid.shape[0]
    chunk = marg_chunk(B, S, G, opts)
    total = torch.zeros((B, G), dtype=dtype, device=dev)
    for s0 in range(0, S, chunk):
        th = thetas[:, s0:s0 + chunk]
        c = th.shape[1]
        st = bqm.apply_hyper_sample(states, opts, th)
        flat = bqm.tree_map(lambda a: a.expand(B, c, *a.shape[2:]).reshape(B * c, *a.shape[2:]), st)
        total = total + expected_squared_mean_batch(flat, opts, grid).reshape(B, c, G).sum(1)
    return total / S


def choose_next_marg_batch(states: BQState, opts: BQOptions, grid, thetas) -> torch.Tensor:
    """Per-problem hyper-marginalized selection → (B, d): each problem's ESM
    averaged over its own n rows of ``thetas`` (B, n, p), then the
    duplicate-avoiding argmax (``BQ.choose_next(x, n)``, fleet-wide)."""
    scores = _marg_scores(states, opts, grid, thetas)
    grid2 = acquire.as_points(grid, opts.dim, states.x_s.dtype, states.x_s.device)
    sel = acquire.demote_near_observed(scores, grid2, states.x_s, states.obs_mask,
                                       opts.candidate_thresh)
    return grid2[torch.argmax(sel, dim=1)]


def run_active_loop_batch(states: BQState, opts: BQOptions, loglik_fn, grid, n_steps: int,
                          hyper_samples=None, record_moments: bool = True):
    """Fleet-wide active sampling: every problem picks and absorbs its own
    next point each step. ``loglik_fn`` maps a (d,) tensor to the likelihood
    there and is applied across the fleet's choices with ``torch.vmap``.
    ``hyper_samples``: optional (B, n, p) per-problem draws (e.g. from
    ``sample_hypers_batch``), held fixed over the loop; each step's
    acquisition is then marginalized per problem (``choose_next_marg_batch``).
    Returns (final_state, (Z_mean (n_steps, B), Z_var (n_steps, B))), or
    (final_state, None) with ``record_moments=False``, which skips the
    per-step moments and leaves the final state identical.
    """
    lik = torch.vmap(loglik_fn)
    zms, zvs = [], []
    for _ in range(n_steps):
        if hyper_samples is None:
            x_next, _ = choose_next_batch(states, opts, grid)
        else:
            x_next = choose_next_marg_batch(states, opts, grid, hyper_samples)
        states = add_observation_batch(states, opts, x_next, lik(x_next))
        if record_moments:
            zms.append(Z_mean_batch(states, opts))
            zvs.append(Z_var_batch(states, opts))
    if not record_moments:
        return states, None
    empty = states.x_s.new_empty((0, states.ns.shape[0]))
    return states, tuple(torch.stack(z) if z else empty for z in (zms, zvs))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class BQFleet:
    """User-facing fleet: B independent BQ problems advanced together.

    The stateful shell over this module's functions, as ``BQ`` is over the
    single-problem core. All problems share one ``BQOptions`` (static
    shapes); data, measures and hyperparameters vary per problem. ``device``
    defaults to the CUDA card; where there is none the constructor raises,
    and ``device="cpu"`` asks for the CPU.

    Example:
        fleet = BQFleet(xs, ls, dtype="float32", n_candidate=12, candidate_thresh=0.2)
        zm, zv = fleet.Z_mean(), fleet.Z_var()        # (B,), (B,)
        x_next = fleet.choose_next(grid)              # (B, d)
        fleet.add_observation(x_next, l_next)         # one batched refit
    """

    def __init__(self, xs, ls, params_tl=None, params_l=None, device="cuda", **options):
        xs = np.asarray(xs)
        opts, x_means, x_vars, gamma, s_tl, s_l, seed = parse_bq_kwargs(
            options, xs.shape[2] if xs.ndim == 3 else 1, xs.shape[1]
        )
        self.options = opts
        self.device = resolve_device(device)
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        self._states = init_batch(
            xs, ls, opts, params_tl=params_tl, params_l=params_l, s_tl=s_tl, s_l=s_l,
            gamma=gamma, x_means=x_means, x_vars=x_vars, device=self.device,
        )

    @classmethod
    def from_states(cls, states: BQState, opts: BQOptions, seed: int = 0) -> "BQFleet":
        """A fleet over an existing batched state, on the state's device."""
        if states.ns.ndim != 1:
            raise ValueError(
                "BQFleet needs a BATCHED state (every leaf with a leading problem axis); "
                "this looks like a single-problem state — use tpubq_torch.BQ / the "
                "tpubq_torch.models functions for those, or stack states leaf by leaf"
            )
        obj = object.__new__(cls)
        obj.options = opts
        obj.device = states.x_s.device
        obj._states = states
        obj._seed = seed
        obj._rng = np.random.RandomState(seed)
        return obj

    def _generator(self, seed=None) -> torch.Generator:
        if seed is None:
            seed = int(self._rng.randint(0, 2**31 - 1))
        return torch.Generator().manual_seed(int(seed))

    @property
    def states(self) -> BQState:
        return self._states

    def __len__(self) -> int:
        return self._states.ns.shape[0]

    @property
    def ns(self) -> np.ndarray:
        return _np(self._states.ns)

    def problem(self, i: int) -> BQState:
        """Problem ``i`` as a standalone single-problem state (pair it with
        ``self.options`` for any ``tpubq_torch.models`` function)."""
        return bqm.tree_map(lambda a: a[i], self._states)

    # -- estimation -----------------------------------------------------------
    def Z_mean(self) -> np.ndarray:
        return _np(Z_mean_batch(self._states, self.options))

    def Z_var(self) -> np.ndarray:
        return _np(Z_var_batch(self._states, self.options))

    def expected_squared_mean(self, grid, per_problem: bool = False,
                              fast: bool = False) -> np.ndarray:
        return _np(expected_squared_mean_batch(self._states, self.options, grid, per_problem,
                                               fast=fast))

    def expected_Z_var(self, grid, per_problem: bool = False, fast: bool = False) -> np.ndarray:
        return _np(expected_Z_var_batch(self._states, self.options, grid, per_problem, fast=fast))

    # -- hyperparameters ------------------------------------------------------
    def fit(self, params=None, ntry: int = 10, seed=None) -> "BQFleet":
        """Per-problem multi-restart MLL fit of both GPs (the fleet spelling
        of ``BQ.fit_hypers``; ``params`` names subset the free hypers exactly
        as there, including "s" for the observation noise)."""
        fit_noise, free_mask = fitm.resolve_param_names(
            self.options, int(self._states.gp_log_l.theta.shape[1]), params
        )
        self._states = fit_batch(self._states, self.options, self._generator(seed), ntry=ntry,
                                 free_mask=free_mask, fit_noise=fit_noise)
        return self

    fit_hypers = fit

    def sample_hypers(self, params=None, n: int = 100, nburn: int = 10, seed=None,
                      n_chains: int = 1, prior_std: float = None) -> np.ndarray:
        """(B, n, p) per-problem hyper-posterior draws (``BQ.sample_hypers``
        per fleet member; all chains of the fleet in one lock-step sampler)."""
        return _np(sample_hypers_batch(self._states, self.options, self._generator(seed), n,
                                       nburn=nburn, params=params,
                                       n_chains=n_chains, prior_std=prior_std))

    def marginalize(self, funs=None, n: int = 100, params=None, seed=None,
                    prior_std: float = None):
        """Per-problem hyper-marginalized estimates: tuple of (B, n) arrays
        (``BQ.marginalize`` per fleet member, one batched refit)."""
        thetas = sample_hypers_batch(self._states, self.options, self._generator(seed), n,
                                     params=params, prior_std=prior_std)
        named = {"Z_mean": bqm.Z_mean, "Z_var": bqm.Z_var}
        funs = None if funs is None else tuple(named.get(f, f) for f in funs)
        return tuple(_np(o) for o in marginalize_batch(self._states, self.options, thetas, funs))

    # -- active sampling ------------------------------------------------------
    def choose_next(self, grid, n: int = 0, seed=None, fast: bool = False) -> np.ndarray:
        """Per-problem best next location on a shared grid → (B, d); ``n > 0``
        marginalizes each problem's ESM over ``n`` of its own hyper samples
        (``BQ.choose_next(x, n)``, fleet-wide)."""
        if n > 0:
            thetas = sample_hypers_batch(self._states, self.options, self._generator(seed), n)
            return _np(choose_next_marg_batch(self._states, self.options, grid, thetas))
        x_next, _ = choose_next_batch(self._states, self.options, grid, fast=fast)
        return _np(x_next)

    def add_observation(self, x_next, l_next) -> "BQFleet":
        """One new observation per problem, (B, d) and (B,), and one batched
        refit. Raises on a non-positive likelihood, on a fleet member at
        capacity and on a location a problem has already observed; the last
        two are decided on the device and read back as one pair of flags."""
        l_next = np.asarray(l_next)
        if np.any(~np.isfinite(l_next)) or np.any(l_next <= 0):
            raise ValueError("l must be finite and positive")
        st, opts = self._states, self.options
        x_arr = torch.as_tensor(np.asarray(x_next), dtype=st.x_s.dtype,
                                device=st.x_s.device).reshape(len(self), opts.dim)
        dist = (st.x_s - x_arr[:, None, :]).abs().amax(-1)
        min_dist = torch.where(st.obs_mask, dist, torch.full_like(dist, math.inf)).amin(1)
        full, duplicate = torch.stack([(st.ns >= opts.max_obs).any(),
                                       (min_dist < 1e-10).any()]).tolist()
        if full:
            raise ValueError(
                f"a fleet member is at capacity (max_obs={opts.max_obs}); "
                "rebuild the fleet with a larger max_obs"
            )
        if duplicate:
            raise ValueError("duplicate observation location in the fleet")
        self._states = add_observation_batch(st, opts, x_arr, l_next)
        return self

    def run_active_loop(self, loglik_fn, grid, n_steps: int, n: int = 0, seed=None,
                        record_moments: bool = True):
        """Advance every problem ``n_steps``; returns the per-step (Z_mean,
        Z_var) histories, each (n_steps, B), or ``(None, None)`` with
        ``record_moments=False`` (final state identical). ``n > 0``
        marginalizes each step's acquisition over ``n`` per-problem hyper
        samples, drawn once before the loop."""
        ns = self.ns
        if np.any(ns + n_steps > self.options.max_obs):
            raise ValueError(
                f"{n_steps} steps would exceed max_obs={self.options.max_obs} for a fleet "
                f"member (ns={ns.tolist()}); rebuild the fleet with a larger max_obs"
            )
        hyper_samples = None
        if n > 0:
            hyper_samples = sample_hypers_batch(self._states, self.options, self._generator(seed), n)
        self._states, moments = run_active_loop_batch(
            self._states, self.options, loglik_fn, grid, n_steps, hyper_samples=hyper_samples,
            record_moments=record_moments)
        if not record_moments:
            return None, None
        return _np(moments[0]), _np(moments[1])

    # -- persistence ----------------------------------------------------------
    def health(self) -> dict:
        """Per-problem diagnostics: ``utils.health.check_state`` on the
        batched state, every leaf with a leading (B,) axis, tensors on the
        fleet's device."""
        from tpubq_torch.utils import health as _health

        return _health.check_state(self._states, self.options)

    def save(self, path, force: bool = False):
        """Write the batched state, options and seed to one ``.npz``
        (``utils.io.save_state``)."""
        from tpubq_torch.utils.io import save_state

        save_state(path, self._states, self.options, force=force, extras={"seed": self._seed})

    @classmethod
    def load(cls, path, refit: bool = False, device="cuda") -> "BQFleet":
        """A fleet from a ``save`` file on ``device`` (the card unless the
        caller names another); ``refit=True`` refactors every problem in one
        batched refit. The seed comes back with it (0 for a file without),
        so reloaded members keep drawing independent hyper-sample streams."""
        from tpubq_torch.utils.io import load_extras, load_state

        states, opts = load_state(path, refit=refit, device=device)
        return cls.from_states(states, opts, seed=int(load_extras(path).get("seed", 0)))

    def __repr__(self):
        return (f"BQFleet(B={len(self)}, ns={self.ns.tolist()}, device={self.device}, "
                f"options={self.options})")
