"""BQ functional core: state, exp-linearization and Z moments.

Counterpart of ``tpubq/models/bq.py``. The estimator state is a ``BQState``
of statically padded tensors, so adding an observation or re-selecting
candidates never changes a shape. The math (Osborne et al. 2012):

  1. tl = log(l/γ + 1); fit ``gp_log_l`` on (x_s, tl_s).
  2. Candidates x_c fill the observed range; anchors l_c = γ(exp(m_tl(x_c)) − 1);
     fit ``gp_l`` on x_sc = x_s ∪ x_c.
  3. E[Z] = α_l · int_K(x_sc).
  4. V[Z] = ∫∫ (m_l(x)+γ) C_tl(x, x') (m_l(x')+γ) p(x) p(x') dx dx'.

Batching: every function here indexes its data from the back, so a state may
carry leading batch axes. Two layouts are in use: hyperparameters batched
over shared data (``marginalize`` installs a (B, p) stack of θ_tl rows in one
call), and the fleet of ``models/batched.py``, where every leaf, data and
measure included, has a leading problem axis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpubq_torch.models import gp as gpm
from tpubq_torch.ops import integrals as igr
from tpubq_torch.ops import linalg
from tpubq_torch.ops.kernels import get_kernel
from tpubq_torch.utils.device import resolve_device
from tpubq_torch.utils.options import BQOptions


class BQState(NamedTuple):
    """Full estimator state (shapes fixed by BQOptions).

    x_s: (max_obs, d) observations; l_s: (max_obs,) likelihoods; tl_s:
    (max_obs,) log-transformed; obs_mask: (max_obs,) live flags; ns: () live
    count. x_c: (n_candidate, d) candidates; l_c: (n_candidate,) anchors;
    c_mask: (n_candidate,) live flags. gamma: () exp-transform constant.
    x_mean: (d,), x_var: (d, d), the gaussian measure. gp_log_l / gp_l: the
    GP factorizations in log and linear space. A fleet state has a leading
    problem axis on every leaf.
    """

    x_s: torch.Tensor
    l_s: torch.Tensor
    tl_s: torch.Tensor
    obs_mask: torch.Tensor
    ns: torch.Tensor
    x_c: torch.Tensor
    l_c: torch.Tensor
    c_mask: torch.Tensor
    gamma: torch.Tensor
    x_mean: torch.Tensor
    x_var: torch.Tensor
    gp_log_l: gpm.GPState
    gp_l: gpm.GPState

    @property
    def x_sc(self) -> torch.Tensor:
        return torch.cat([self.x_s, self.x_c], dim=-2)

    @property
    def l_sc(self) -> torch.Tensor:
        return torch.cat([self.l_s, self.l_c], dim=-1)

    @property
    def sc_mask(self) -> torch.Tensor:
        return torch.cat([self.obs_mask, self.c_mask], dim=-1)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _dot(a, b):
    return (a * b).sum(-1)


def log_transform(l: torch.Tensor, gamma) -> torch.Tensor:
    """tl = log(l/γ + 1); ``gamma`` broadcasts against ``l``."""
    return torch.log1p(l / gamma)


def inv_log_transform(tl: torch.Tensor, gamma) -> torch.Tensor:
    """l = γ(exp(tl) − 1), with tl clamped below the dtype's exp overflow so
    one posterior spike saturates an anchor instead of injecting inf."""
    cap = 80.0 if tl.dtype == torch.float32 else 700.0
    return gamma * torch.expm1(torch.clamp(tl, max=cap))


def live_bounds(x_s, obs_mask):
    """Per-dimension (lo, hi) of the live observations → ((..., d), (..., d))."""
    big = torch.finfo(x_s.dtype).max
    m = obs_mask[..., :, None]
    lo = torch.where(m, x_s, torch.full_like(x_s, big)).amin(-2)
    hi = torch.where(m, x_s, torch.full_like(x_s, -big)).amax(-2)
    return lo, hi


def choose_candidates(x_s, obs_mask, opts: BQOptions):
    """Candidate grid and mask: a linspace across the live range in 1-D,
    ``n_candidate`` Halton points over the live bounding box for d > 1."""
    d = x_s.shape[-1]
    lo, hi = live_bounds(x_s, obs_mask)
    if d == 1:
        # jnp.linspace(0, 1, n) as XLA evaluates it, to the last bit: i·(1/(n − 1)),
        # the last point exactly 1 (torch.linspace rounds other points otherwise,
        # and a candidate at candidate_thresh from an observation then flips its mask)
        n = opts.n_candidate
        t = torch.arange(n, dtype=x_s.dtype, device=x_s.device) * (1.0 / max(n - 1, 1))
        if n > 1:
            t[-1] = 1.0
        t = t[:, None]
    else:
        from scipy.stats import qmc

        pts = qmc.Halton(d, scramble=False).random(opts.n_candidate + 1)[1:]
        t = torch.as_tensor(pts, dtype=x_s.dtype, device=x_s.device)
    x_c = lo[..., None, :] + t * (hi - lo)[..., None, :]
    return x_c, filter_candidates(x_c, x_s, obs_mask, opts.candidate_thresh)


def filter_candidates(x_c, x_s, obs_mask, thresh):
    """Mask of candidates at least ``thresh`` (sup-norm) from every live
    observation."""
    dist = (x_c[..., :, None, :] - x_s[..., None, :, :]).abs().amax(-1)
    near = ((dist < thresh) & obs_mask[..., None, :]).any(-1)
    return ~near


def tree_map(fn, state: BQState) -> BQState:
    """Apply ``fn`` to every tensor leaf of a state (None leaves stay None)."""

    def gp(g):
        return gpm.GPState(*(None if v is None else fn(v) for v in g))

    return BQState(*(gp(v) if isinstance(v, gpm.GPState) else fn(v) for v in state))


def with_sample_axis(state: BQState) -> BQState:
    """A fleet state with a singleton sample axis after its problem axis on
    every leaf, so that (B, S, p) hyper rows broadcast against each problem's
    own data; a single-problem state is returned as it is (its data carry no
    batch axis, and (S, p) rows broadcast against them already)."""
    k = state.ns.ndim
    return tree_map(lambda a: a.unsqueeze(k), state) if k else state


def _fit_gps(state: BQState, opts: BQOptions, need_kinv: bool = True, ladder: bool = True) -> BQState:
    """(Re)build candidates, linearization anchors and both GP factors
    (``ladder``: the jitter ladder, or one fixed-jitter factor)."""
    kfn, _ = get_kernel(opts.kernel)
    zero = torch.zeros_like(state.l_s)
    gamma = state.gamma[..., None]  # against the trailing point axis
    tl_s = torch.where(state.obs_mask, log_transform(state.l_s, gamma), zero)
    gp_tl = gpm.gp_fit(
        kfn, state.gp_log_l.theta, state.gp_log_l.s, state.x_s, tl_s, state.obs_mask,
        base_jitter=opts.base_jitter, need_kinv=need_kinv, ladder=ladder,
    )
    x_c, c_mask = choose_candidates(state.x_s, state.obs_mask, opts)
    m_tl_c = gpm.gp_mean(kfn, gp_tl, x_c)
    l_c = torch.where(c_mask, inv_log_transform(m_tl_c, gamma), torch.zeros_like(m_tl_c))
    x_sc = torch.cat([state.x_s, x_c], dim=-2)
    l_s = torch.where(state.obs_mask, state.l_s, zero)
    l_sc = torch.cat([l_s.expand(*l_c.shape[:-1], -1), l_c], dim=-1)
    sc_mask = torch.cat([state.obs_mask, c_mask], dim=-1)
    gp_l = gpm.gp_fit(
        kfn, state.gp_l.theta, state.gp_l.s, x_sc, l_sc, sc_mask,
        base_jitter=opts.base_jitter, need_kinv=need_kinv, ladder=ladder,
    )
    return state._replace(tl_s=tl_s, x_c=x_c, l_c=l_c, c_mask=c_mask, gp_log_l=gp_tl, gp_l=gp_l)


def theta_len(opts: BQOptions) -> int:
    """Flat kernel-parameter length of the configured family and dim:
    (h, w, p) for periodic, (h, w_1..w_d, α) for rq, else (h, w_1..w_d)."""
    get_kernel(opts.kernel)
    if opts.kernel == "periodic":
        return 3
    if opts.kernel == "rq":
        return opts.dim + 2
    return opts.dim + 1


def default_params(opts: BQOptions):
    """Unit h and w per dimension, plus the family's shape parameter (period
    or α) at 1."""
    return (1.0,) * theta_len(opts)


def validate_theta(theta, opts: BQOptions, name="theta"):
    """The flat parameter vector must match the family: (h, w_1..w_d) for
    gaussian and Matérn, (h, w_1..w_d, alpha) for rq, (h, w, p) for the
    periodic kernel, which is 1-D only."""
    n = int(np.asarray(theta).reshape(-1).shape[0]) if np.ndim(theta) else 0
    if opts.kernel == "periodic" and opts.dim != 1:
        raise ValueError("periodic kernel is 1-D only")
    want = theta_len(opts)
    if n != want:
        layout = {"periodic": "(h, w, p)", "rq": "(h, w_1..w_d, alpha)"}.get(opts.kernel, "(h, w_1..w_d)")
        raise ValueError(
            f"{name} for {opts.kernel} kernel in dim {opts.dim} must have "
            f"{want} entries {layout}; got {n}"
        )


def validate_theta_values(theta, opts: BQOptions, name="theta") -> None:
    """Every entry (h, w_j and the family's p / α) is a finite, positive scale."""
    v = np.asarray(theta, dtype=np.float64)
    if not np.all(np.isfinite(v)) or np.any(v <= 0.0):
        raise ValueError(f"{name} entries must be finite and > 0 (kernel scales); got {v}")


def periodic_series_floor(theta) -> int:
    """Harmonics the periodic closed forms need to be machine-exact: the
    Jacobi–Anger coefficients a_n = e^{−z} I_n(z), z = 1/w², fall below
    float64 resolution at n ≳ 8.5·√z, whatever the period. Host-side: the
    facade warns when ``n_series`` is below it."""
    w = float(np.asarray(theta, dtype=np.float64).ravel()[1])
    return int(np.ceil(8.5 / w)) + 8


def periodic_gh_floor(theta, x_var) -> int:
    """Gauss–Hermite nodes a periodic kernel needs over N(·, x_var):
    n_req = 32 · (σ / (p · min(1, w)))², σ² the measure's largest variance.
    It governs only the float32 V[Z], the one periodic estimate on the GH
    bilinear form; host-side, the facade warns when ``n_gh`` is below it."""
    th = np.asarray(theta, dtype=np.float64).ravel()
    w, p = float(th[1]), float(th[2])
    v = np.atleast_2d(np.asarray(x_var, dtype=np.float64))
    sigma = float(np.sqrt(np.max(np.linalg.eigvalsh(v))))
    return int(np.ceil(32.0 * (sigma / (p * min(1.0, w))) ** 2))


#: Validated lower edge of the rq Gamma-mixture rule (``integrals.rq_mix_rule``):
#: ≤ 2e-9 absolute for α ∈ [0.5, 128], ~6e-6 at α = 0.25. The facade warns
#: when current or sampled α drops below it.
RQ_ALPHA_FLOOR = 0.5


def rq_gh_floor(theta, x_var) -> int:
    """Gauss–Hermite nodes the rq V[Z] quadrature needs over N(·, x_var):
    max(128, 128 · (σ / w_min)²) per axis, to the power d for the tensor rule.
    Host-side: the facade warns at init, after the fit and on sampled hyper
    batches."""
    th = np.asarray(theta, dtype=np.float64).ravel()
    w_min = float(np.min(th[1:-1]))
    v = np.atleast_2d(np.asarray(x_var, dtype=np.float64))
    d = v.shape[-1]
    sigma = float(np.sqrt(np.max(np.linalg.eigvalsh(v))))
    per_axis = max(128, int(np.ceil(128.0 * (sigma / w_min) ** 2)))
    return per_axis ** d


def validate_measure(x_var) -> None:
    """Raise if a measure covariance (matrix, diagonal or scalar) is not PSD."""
    v = np.asarray(x_var, np.float64)
    if v.ndim >= 2:
        scale = float(np.max(np.abs(v))) if v.size else 0.0
        if not np.allclose(v, np.swapaxes(v, -1, -2), rtol=0.0, atol=1e-8 * max(scale, 1e-300)):
            raise ValueError("x_var must be symmetric")
    ev = np.linalg.eigvalsh(v) if v.ndim >= 2 else v
    tol = 64.0 * np.finfo(np.float64).eps * max(1.0, float(np.max(np.abs(ev))) if ev.size else 0.0)
    if not np.all(np.isfinite(ev)) or np.min(ev) < -tol:
        raise ValueError(
            "x_var must be positive semi-definite; got "
            f"{'eigenvalues' if v.ndim >= 2 else 'variances'} min {np.min(ev)}"
        )


def init_state(
    x,
    l,
    opts: BQOptions,
    params_tl=None,
    params_l=None,
    s_tl=0.0,
    s_l=0.0,
    gamma=1.0,
    x_mean=None,
    x_var=None,
    device="cuda",
) -> BQState:
    """Build a BQState from raw observations on ``device`` (the card unless
    the caller names another)."""
    dtype = opts.torch_dtype
    dev = resolve_device(device)

    def t(v, dt=dtype):
        return torch.as_tensor(np.asarray(v), dtype=dt, device=dev)

    x = t(x)
    if x.ndim == 1:
        x = x[:, None]
    l = t(l)
    n, d = x.shape
    if d != opts.dim:
        raise ValueError(f"x has dim {d}, options say {opts.dim}")
    if n > opts.max_obs:
        raise ValueError(f"{n} observations exceed max_obs={opts.max_obs}")
    if l.shape != (n,):
        raise ValueError("l must be (n,) matching x")
    params_tl = default_params(opts) if params_tl is None else params_tl
    params_l = default_params(opts) if params_l is None else params_l
    validate_theta(params_tl, opts, "params_tl")
    validate_theta(params_l, opts, "params_l")

    pad = opts.max_obs - n
    x_s = torch.cat([x, torch.zeros((pad, d), dtype=dtype, device=dev)])
    l_s = torch.cat([l, torch.zeros((pad,), dtype=dtype, device=dev)])
    obs_mask = torch.arange(opts.max_obs, device=dev) < n

    x_mean = torch.zeros(d, dtype=dtype, device=dev) if x_mean is None else (
        t(x_mean).reshape(-1).expand(d).clone())
    if x_var is None:
        x_var = torch.eye(d, dtype=dtype, device=dev)
    else:
        validate_measure(x_var)
        x_var = t(x_var)
        if x_var.ndim == 0:
            x_var = torch.eye(d, dtype=dtype, device=dev) * x_var
        elif x_var.ndim == 1:
            x_var = torch.diag(x_var)
    gamma_f = float(gamma)
    if not np.isfinite(gamma_f) or gamma_f <= 0.0:
        raise ValueError(f"gamma must be finite and > 0, got {gamma}")

    def empty_gp(theta, s, xg, yg, mask):
        m = mask.shape[0]
        eye = torch.eye(m, dtype=dtype, device=dev)
        return gpm.GPState(t(theta), t(s), xg, yg, mask, eye, torch.zeros(m, dtype=dtype, device=dev),
                           eye, t(0.0), torch.tensor(True, device=dev))

    nc, nsc = opts.n_candidate, opts.max_nsc
    state = BQState(
        x_s=x_s,
        l_s=l_s,
        tl_s=torch.zeros_like(l_s),
        obs_mask=obs_mask,
        ns=torch.tensor(n, dtype=torch.int64, device=dev),
        x_c=torch.zeros((nc, d), dtype=dtype, device=dev),
        l_c=torch.zeros((nc,), dtype=dtype, device=dev),
        c_mask=torch.zeros((nc,), dtype=torch.bool, device=dev),
        gamma=t(gamma_f),
        x_mean=x_mean,
        x_var=x_var,
        gp_log_l=empty_gp(params_tl, s_tl, x_s, l_s, obs_mask),
        gp_l=empty_gp(params_l, s_l, torch.zeros((nsc, d), dtype=dtype, device=dev),
                      torch.zeros((nsc,), dtype=dtype, device=dev),
                      torch.zeros((nsc,), dtype=torch.bool, device=dev)),
    )
    return _fit_gps(state, opts)


def set_params(state: BQState, opts: BQOptions, theta_tl=None, theta_l=None,
               s_tl=None, s_l=None, need_kinv: bool = True, ladder: bool = True) -> BQState:
    """Swap kernel hyperparameters (and optionally the noise) and refactorize.
    ``theta_tl`` / ``theta_l`` may be (S, p) stacks (one refit per row,
    batched)."""
    dtype, dev = state.x_s.dtype, state.x_s.device

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    gp_tl, gp_l = state.gp_log_l, state.gp_l
    if theta_tl is not None:
        gp_tl = gp_tl._replace(theta=t(theta_tl))
    if s_tl is not None:
        gp_tl = gp_tl._replace(s=t(s_tl))
    if theta_l is not None:
        gp_l = gp_l._replace(theta=t(theta_l))
    if s_l is not None:
        gp_l = gp_l._replace(s=t(s_l))
    return _fit_gps(state._replace(gp_log_l=gp_tl, gp_l=gp_l), opts, need_kinv, ladder)


def apply_hyper_sample(state: BQState, opts: BQOptions, theta,
                       need_kinv: bool = True, ladder: bool = True) -> BQState:
    """Install hyper-sample rows and refactorize.

    Width p_tl rows set θ_tl only; width p_tl + p_l rows (joint
    ``sample_hypers``) set both GPs' θ. A single state takes (p,) or (S, p);
    a fleet state (B, p), one row per problem, or (B, S, p), S rows per
    problem (the state then gains a sample axis after its problem axis)."""
    theta = torch.as_tensor(theta, dtype=state.x_s.dtype, device=state.x_s.device)
    p_tl = state.gp_log_l.theta.shape[-1]
    p_l = state.gp_l.theta.shape[-1]
    if theta.shape[-1] not in (p_tl, p_tl + p_l):
        raise ValueError(
            f"hyper sample has width {theta.shape[-1]}; expected {p_tl} (θ_tl) "
            f"or {p_tl + p_l} (joint θ_tl ∥ θ_l)"
        )
    if state.ns.ndim and theta.ndim == state.ns.ndim + 2:
        state = with_sample_axis(state)
    if theta.shape[-1] == p_tl:
        return set_params(state, opts, theta_tl=theta, need_kinv=need_kinv, ladder=ladder)
    return set_params(state, opts, theta_tl=theta[..., :p_tl], theta_l=theta[..., p_tl:],
                      need_kinv=need_kinv, ladder=ladder)


# ---------------------------------------------------------------------------
# Z moments
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _gh_rule(n_axis: int, d: int):
    """Tensor-product probabilists' Gauss–Hermite rule (numpy, float64)."""
    from scipy.special import roots_hermitenorm

    t, w = roots_hermitenorm(n_axis)
    w = w / np.sqrt(2.0 * np.pi)
    if d == 1:
        return t[:, None], w
    grids = np.meshgrid(*([t] * d), indexing="ij")
    wgrids = np.meshgrid(*([w] * d), indexing="ij")
    nodes = np.stack([g.ravel() for g in grids], axis=-1)
    return nodes, np.prod(np.stack(wgrids), axis=0).ravel()


def _measure_nodes(state: BQState, nodes1: np.ndarray):
    dtype, dev = state.x_s.dtype, state.x_s.device
    Lv = torch.linalg.cholesky(state.x_var)
    nodes1 = torch.as_tensor(nodes1, dtype=dtype, device=dev)
    return state.x_mean[..., None, :] + nodes1 @ Lv.transpose(-1, -2)


def _gh_nodes(state: BQState, opts: BQOptions):
    """Gauss–Hermite nodes/weights of N(x_mean, x_var) → ((..., m, d), (m,)):
    ``n_gh`` nodes in 1-D; a tensor rule with ceil(n_gh^(1/d)) nodes per axis
    rotated through chol(x_var) for d > 1. Per-axis floors: 20 / 12 in 2-D /
    3-D for the smooth families; the Matérn family's diagonal cusp defeats
    GH's spectral convergence, so it gets 512 nodes in 1-D and 48 / 16 per
    axis in 2-D / 3-D."""
    d = opts.dim
    cusp = opts.kernel.startswith("matern")
    if d == 1:
        n_axis = max(opts.n_gh, 512) if cusp else opts.n_gh
    else:
        floor = {2: 48, 3: 16} if cusp else {2: 20, 3: 12}
        n_axis = max(int(np.ceil(opts.n_gh ** (1.0 / d))), floor.get(d, 8))
    nodes1, w = _gh_rule(n_axis, d)
    return _measure_nodes(state, nodes1), torch.as_tensor(w, dtype=state.x_s.dtype, device=state.x_s.device)


def _qmc_nodes(state: BQState, opts: BQOptions, n: int):
    """Halton quasi-Monte-Carlo nodes of the measure, equal weights."""
    from scipy.special import ndtri
    from scipy.stats import qmc

    z = ndtri(qmc.Halton(opts.dim, scramble=False).random(n + 1)[1:])
    w = torch.full((n,), 1.0 / n, dtype=state.x_s.dtype, device=state.x_s.device)
    return _measure_nodes(state, z), w


def _nu(opts: BQOptions) -> float:
    return 2.5 if opts.kernel == "matern52" else 1.5


def int_K_measure(state: BQState, opts: BQOptions, theta, x) -> torch.Tensor:
    """∫ k(x', x_i) p(x') dx' for the configured kernel family: the gaussian
    closed form; Matérn by the erfcx closed form in 1-D and the Gamma mixture
    of gaussian closed forms for d ≥ 2; periodic by the Jacobi–Anger series
    truncated at ``n_series``; rq by the Gamma mixture that follows α."""
    mu, Sig = state.x_mean, state.x_var
    if opts.kernel == "gaussian":
        return igr.int_K(x, theta[..., 0], theta[..., 1:], mu, Sig)
    if opts.kernel.startswith("matern"):
        h, w = theta[..., 0], theta[..., 1:]
        if opts.dim == 1:
            fn = igr.int_K_matern52_1d if opts.kernel == "matern52" else igr.int_K_matern32_1d
            return fn(x, h, w, mu, Sig)
        return igr.int_K_matern_mixture(x, h, w, mu, Sig, _nu(opts))
    if opts.kernel == "periodic":
        return igr.int_K_periodic(x, theta[..., 0], theta[..., 1], theta[..., 2], mu, Sig, opts.n_series)
    get_kernel(opts.kernel)
    return igr.int_K_rq_mixture(x, theta[..., 0], theta[..., 1:-1], theta[..., -1], mu, Sig)


def int_K_nodes(opts: BQOptions) -> int:
    """Length of the node (or harmonic) axis ``int_K_measure`` forms per
    point, times d where it forms a (…, node, point, d) tensor: 1 for the
    closed forms."""
    if opts.kernel == "periodic":
        return opts.n_series
    if opts.kernel == "rq":
        return igr.RQ_MIX_NODES * opts.dim
    if opts.kernel.startswith("matern") and opts.dim > 1:
        return igr.matern_mix_nodes(_nu(opts)) * opts.dim
    return 1


def Z_mean(state: BQState, opts: BQOptions) -> torch.Tensor:
    """E[Z] = α_l · int_K(x_sc)."""
    z = int_K_measure(state, opts, state.gp_l.theta, state.x_sc)
    z = torch.where(state.sc_mask, z, torch.zeros_like(z))
    return _dot(z, state.gp_l.alpha)


def _z_var_dispatch(opts: BQOptions):
    """The pre-clamp terms function ``(state, opts) → (raw, gross)`` of V[Z]:

    - float32 Matérn: the closed form (the GH cusp floor reads 1.6e-3 to
      2e-1 where the closed form stays ≤ 7.5e-5);
    - float32 gaussian, periodic and rq: the Gauss–Hermite (d ≤ 3) or Halton
      (d > 3) bilinear form — the closed forms' cancellation exceeds f32;
    - float64 gaussian, Matérn and periodic: the closed form;
    - float64 rq: GH (d ≤ 3) or Halton, with the warned node floor
      ``rq_gh_floor``.
    """
    get_kernel(opts.kernel)
    quad = _z_var_gh_terms if opts.dim <= 3 else _z_var_qmc_terms
    if opts.kernel.startswith("matern"):
        return Z_var_exact_terms
    if opts.dtype == "float32" or opts.kernel == "rq":
        return quad
    return Z_var_exact_terms


def Z_var(state: BQState, opts: BQOptions) -> torch.Tensor:
    """V[Z], clamped at 0 (the raw value can land epsilon-negative at the
    rounding floor of the cancellation)."""
    raw, _ = _z_var_dispatch(opts)(state, opts)
    return torch.clamp(raw, min=0.0)


def Z_var_exact_terms(state: BQState, opts: BQOptions):
    """Closed-form V[Z] pre-clamp → (raw, gross).

    V[Z] = term_mm + 2γ term_m + γ² term_0 with q = int_K(x_s; k_tl),
    Q = int_int_K(k_tl), P = int_K1_K2(x_sc, x_s), T = int_int_K1_K2(x_sc, x_sc),
    U = int_K1_int_K2(x_sc): term_0 = Q − qᵀK_tl⁻¹q, term_m = αᵀ(U − P K_tl⁻¹ q),
    term_mm = αᵀ(T − P K_tl⁻¹ Pᵀ)α. The integral table follows the family:
    the gaussian identities, the Matérn cross family (outer kernel mixed,
    inner exact; x_sc is bound once so that T takes its symmetric sweep), or
    the periodic harmonic series.
    """
    dtype = state.x_s.dtype
    mu, Sig = state.x_mean, state.x_var
    th_l, th_tl = state.gp_l.theta, state.gp_log_l.theta
    h_l, w_l = th_l[..., 0], th_l[..., 1:]
    h_tl, w_tl = th_tl[..., 0], th_tl[..., 1:]
    m_s = state.obs_mask.to(dtype)
    m_sc = state.sc_mask.to(dtype)
    alpha = state.gp_l.alpha
    L_tl = state.gp_log_l.L
    x_sc = state.x_sc

    if opts.kernel.startswith("matern"):
        nu = _nu(opts)
        q = int_K_measure(state, opts, th_tl, state.x_s)
        Q = igr.int_int_K_matern(h_tl, w_tl, mu, Sig, nu)
        P = igr.int_K1_K2_matern(x_sc, state.x_s, h_l, w_l, h_tl, w_tl, mu, Sig, nu)
        T = igr.int_int_K1_K2_matern(x_sc, x_sc, h_l, w_l, h_tl, w_tl, mu, Sig, nu)
        U = igr.int_K1_int_K2_matern(x_sc, h_l, w_l, h_tl, w_tl, mu, Sig, nu)
    elif opts.kernel == "periodic":
        t_l = (th_l[..., 0], th_l[..., 1], th_l[..., 2])
        t_tl = (th_tl[..., 0], th_tl[..., 1], th_tl[..., 2])
        ns = opts.n_series
        q = igr.int_K_periodic(state.x_s, *t_tl, mu, Sig, ns)
        Q = igr.int_int_K_periodic(*t_tl, mu, Sig, ns)
        P = igr.int_K1_K2_periodic(x_sc, state.x_s, t_l, t_tl, mu, Sig, ns)
        T = igr.int_int_K1_K2_periodic(x_sc, x_sc, t_l, t_tl, mu, Sig, ns)
        U = igr.int_K1_int_K2_periodic(x_sc, t_l, t_tl, mu, Sig, ns)
    else:
        q = igr.int_K(state.x_s, h_tl, w_tl, mu, Sig)
        Q = igr.int_int_K(opts.dim, h_tl, w_tl, mu, Sig)
        P = igr.int_K1_K2(x_sc, state.x_s, h_l, w_l, h_tl, w_tl, mu, Sig)
        T = igr.int_int_K1_K2(x_sc, x_sc, h_l, w_l, h_tl, w_tl, mu, Sig)
        U = igr.int_K1_int_K2(x_sc, h_l, w_l, h_tl, w_tl, mu, Sig)
    q = q * m_s
    P = P * m_sc[..., :, None] * m_s[..., None, :]
    T = T * m_sc[..., :, None] * m_sc[..., None, :]
    U = U * m_sc

    beta = linalg.chol_solve_vec(L_tl, q)
    term0 = Q - _dot(q, beta)
    term_m = _dot(alpha, U - _mv(P, beta))
    g = _mv(P.transpose(-1, -2), alpha)
    term_mm = _dot(alpha, _mv(T, alpha)) - _dot(g, linalg.chol_solve_vec(L_tl, g))
    gamma = state.gamma
    t1, t2, t3 = term_mm, 2.0 * gamma * term_m, gamma * gamma * term0
    return t1 + t2 + t3, t1.abs() + t2.abs() + t3.abs()


def _z_var_quad_terms(state: BQState, opts: BQOptions, nodes, w):
    """(raw, gross) of the quadrature bilinear form V = aᵀ C_tl a with
    a_i = w_i (m_l(x_i) + γ)."""
    kfn, _ = get_kernel(opts.kernel)
    m_l = gpm.gp_mean(kfn, state.gp_l, nodes) + state.gamma[..., None]
    C_tl = gpm.gp_cov(kfn, state.gp_log_l, nodes)
    a = w * m_l
    Ca = _mv(C_tl, a)
    return _dot(a, Ca), (a * Ca).abs().sum(-1)


def _z_var_gh_terms(state: BQState, opts: BQOptions):
    return _z_var_quad_terms(state, opts, *_gh_nodes(state, opts))


def _z_var_qmc_terms(state: BQState, opts: BQOptions):
    return _z_var_quad_terms(state, opts, *_qmc_nodes(state, opts, opts.n_qmc))


def Z_var_exact(state: BQState, opts: BQOptions) -> torch.Tensor:
    """Closed-form V[Z], clamped at 0 (``Z_var_exact_terms`` gives the
    pre-clamp terms)."""
    raw, _ = Z_var_exact_terms(state, opts)
    return torch.clamp(raw, min=0.0)


def Z_var_gh(state: BQState, opts: BQOptions) -> torch.Tensor:
    """V[Z] by the Gauss–Hermite bilinear form over the measure (``_gh_nodes``),
    clamped at 0."""
    raw, _ = _z_var_gh_terms(state, opts)
    return torch.clamp(raw, min=0.0)


def Z_var_qmc(state: BQState, opts: BQOptions) -> torch.Tensor:
    """V[Z] by the same bilinear form over ``n_qmc`` Halton nodes (any d),
    clamped at 0."""
    raw, _ = _z_var_qmc_terms(state, opts)
    return torch.clamp(raw, min=0.0)


def Z_var_terms(state: BQState, opts: BQOptions):
    """(raw, gross) of V[Z] before the zero clamp, through ``Z_var``'s
    dispatch: raw < 0 with |raw| ≈ eps·gross is the rounding floor the clamp
    exists for; |raw| a large fraction of gross is a sign error the clamp
    would hide (``utils.health.check_state`` reports the ratio)."""
    return _z_var_dispatch(opts)(state, opts)


def Z_mean_and_var(state: BQState, opts: BQOptions):
    return Z_mean(state, opts), Z_var(state, opts)


# ---------------------------------------------------------------------------
# Quadrature twins: the GP posteriors integrated by the trapezoid rule on a
# dense 1-D grid ``xo``
# ---------------------------------------------------------------------------


def _pdf_1d(xo, state: BQState):
    s2 = state.x_var[..., 0, :1]
    return torch.exp(-0.5 * (xo - state.x_mean[..., :1]) ** 2 / s2) / torch.sqrt(2.0 * np.pi * s2)


def approx_Z_mean(state: BQState, opts: BQOptions, xo) -> torch.Tensor:
    kfn, _ = get_kernel(opts.kernel)
    xo = torch.as_tensor(xo, dtype=state.x_s.dtype, device=state.x_s.device)
    m_l = gpm.gp_mean(kfn, state.gp_l, xo[:, None])
    return torch.trapezoid(m_l * _pdf_1d(xo, state), xo, dim=-1)


def approx_Z_var(state: BQState, opts: BQOptions, xo) -> torch.Tensor:
    kfn, _ = get_kernel(opts.kernel)
    xo = torch.as_tensor(xo, dtype=state.x_s.dtype, device=state.x_s.device)
    X = xo[:, None]
    w = (gpm.gp_mean(kfn, state.gp_l, X) + state.gamma[..., None]) * _pdf_1d(xo, state)
    C_tl = gpm.gp_cov(kfn, state.gp_log_l, X)
    inner = torch.trapezoid(C_tl * w[..., None, :], xo, dim=-1)
    return torch.trapezoid(inner * w, xo, dim=-1)
