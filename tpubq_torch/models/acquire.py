"""Active sampling: expected squared mean, choose_next, add_observation.

Counterpart of ``tpubq/models/acquire.py``. For a hypothetical observation
ℓ_a at x_a, with the linear GP's Schur complement γ_s = κ − kᵀK⁻¹k,
z = int_K(x_sc) and ζ = int_K(x_a):

    E[Z | ℓ_a] = zᵀα + B (ℓ_a − kᵀα),   B = (ζ − zᵀK⁻¹k) / γ_s,

and under the log-GP posterior tl_a ~ N(m_a, c_a), ℓ = γ(e^{tl} − 1):

    ESM(x_a) = A² + 2AB·E[ℓ_a] + B²·E[ℓ_a²],   A = zᵀα − B kᵀα.

Degenerate x_a (within candidate_thresh of a live point, or γ_s below its
noise floor) score Z_mean².

Dispatch (``esm_route``, from shapes before any launch): every float32
gaussian state scores with the fused ``esm_fused`` kernel (on a CUDA device;
its plain twin on the CPU), the quadratic forms as tiled products, with no
cap on the state's size. The plain path below
(``expected_squared_mean_xla``, several (nsc × G) intermediates in device
memory per sweep) scores float64 (the cho_solve parity contract) and the
kernels ``esm_fused`` does not take (d > 3). ``expected_squared_mean_fused``
takes the ``esm_fused`` route whatever ``esm_route`` says.
"""

from __future__ import annotations

import math

import torch

from tpubq_torch.models import gp as gpm
from tpubq_torch.models.bq import (
    BQState,
    Z_mean,
    Z_var,
    _fit_gps,
    apply_hyper_sample,
    int_K_measure,
)
from tpubq_torch.ops import hopper_kernels as hk
from tpubq_torch.ops import linalg
from tpubq_torch.ops.kernels import get_kernel
from tpubq_torch.utils.options import BQOptions

__all__ = [
    "esm_route",
    "expected_squared_mean",
    "expected_squared_mean_xla",
    "expected_squared_mean_fused",
    "approx_expected_squared_mean",
    "expected_Z_var",
    "choose_next",
    "refine_next",
    "demote_near_observed",
    "add_observation",
    "run_active_loop",
]

#: Safety factor × f32 unit roundoff of the adaptive Schur-noise guard.
_LAM_F32 = 32.0 * 2.0**-23


def demote_near_observed(scores, x_a, x_s, obs_mask, thresh, group=None):
    """Selection-only transform: grid points within ``thresh`` (sup-norm) of a
    live observation are excluded from the argmax; when every point is
    excluded, a distance-proportional demotion picks the point farthest from
    observed territory. Reported scores are not changed. ``scores``, ``x_s``
    and ``obs_mask`` may carry a leading problem axis over a shared ``x_a``;
    the all-excluded fallback is then decided per problem.

    ``group``: the process group over which the grid is sharded
    (``parallel/sharded.py``; JAX's ``axis_name``). The all-excluded flag is
    then decided over the whole grid, an int32 ``all_reduce(MIN)``: one
    shard may see only excluded points while another still holds fresh
    ones."""
    dist = (x_a[:, None, :] - x_s[..., None, :, :]).abs().amax(-1)
    dist = torch.where(obs_mask[..., None, :], dist, torch.full_like(dist, math.inf))
    d_min = dist.amin(-1)
    near = d_min < thresh
    closeness = torch.clamp(1.0 - d_min / thresh, 0.0, 1.0)
    demoted = scores - closeness * (0.25 * scores.abs() + 1e-20)
    excluded = torch.where(near, torch.full_like(scores, -math.inf), scores)
    all_near = near.all(-1, keepdim=True)
    if group is not None:
        flag = all_near.to(torch.int32)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MIN, group=group)
        all_near = flag.bool()
    return torch.where(all_near, demoted, excluded)


def as_points(x_a, dim: int, dtype, device):
    """Normalize query locations to (na, d); a 1-D array is na points when
    dim == 1 and one point when dim > 1."""
    x_a = torch.as_tensor(x_a, dtype=dtype, device=device)
    if x_a.ndim == 0:
        if dim != 1:
            raise ValueError("scalar query invalid for dim > 1")
        return x_a.reshape(1, 1)
    if x_a.ndim == 1:
        if dim == 1:
            return x_a[:, None]
        if x_a.shape[0] != dim:
            raise ValueError(f"single query point has dim {x_a.shape[0]}, options say {dim}")
        return x_a.reshape(1, dim)
    if x_a.shape[-1] != dim:
        raise ValueError(f"query points have dim {x_a.shape[-1]}, options say {dim}")
    return x_a


def _safe_exp(x):
    return torch.exp(torch.clamp(x, max=0.5 * math.log(torch.finfo(x.dtype).max)))


def _lognormal_moments(m, c, gamma):
    """First two moments of ℓ = γ(e^t − 1), t ~ N(m, c)."""
    e1 = _safe_exp(m + 0.5 * c)
    e2 = _safe_exp(2.0 * m + 2.0 * c)
    return gamma * (e1 - 1.0), gamma * gamma * (e2 - 2.0 * e1 + 1.0)


def _esm_affine_terms(state: BQState, opts: BQOptions, x_a):
    """(A, B, degenerate, zᵀα, m_a, c_a) of the ESM. A fleet state (a leading
    problem axis on every leaf) scores a shared (na, d) or a per-problem
    (B, na, d) ``x_a`` in batched tensor ops.

    float32 applies the cached K⁻¹ and floors γ_s at the adaptive noise
    bound λ·ρ·κ·‖k‖₁ (ρ the max absolute row sum of K⁻¹): with an
    ill-conditioned Gram the f32 roundoff on γ_s is ~eps·|k|ᵀ|K⁻¹||k|, not
    eps·κ. float64 uses cho_solve and the eps·κ floor.
    """
    kfn, kdiagfn = get_kernel(opts.kernel)
    dtype = state.x_s.dtype
    m_sc = state.sc_mask
    gp_l = state.gp_l
    alpha = gp_l.alpha

    z = int_K_measure(state, opts, gp_l.theta, state.x_sc) * m_sc.to(dtype)
    zeta = int_K_measure(state, opts, gp_l.theta, x_a)
    zTalpha = (z * alpha).sum(-1)
    use_kinv = dtype == torch.float32

    k_a = kfn(gp_l.theta, state.x_sc, x_a) * m_sc.to(dtype)[..., :, None]  # (..., nsc, na)
    v = gp_l.Kinv @ k_a if use_kinv else linalg.chol_solve(gp_l.L, k_a)
    kappa = kdiagfn(gp_l.theta, x_a) + (gp_l.s * gp_l.s + gp_l.jitter)[..., None]
    gam_s = kappa - (k_a * v).sum(-2)

    dist = (x_a[..., :, None, :] - state.x_sc[..., None, :, :]).abs().amax(-1)
    too_close = ((dist < opts.candidate_thresh) & m_sc[..., None, :]).any(-1)
    gam_floor = torch.finfo(dtype).eps * kappa
    if use_kinv:
        rho = gp_l.Kinv.abs().sum(-1).amax(-1)
        gam_floor = torch.maximum(gam_floor, (_LAM_F32 * rho)[..., None] * kappa * k_a.sum(-2))
    degenerate = too_close | (gam_s <= gam_floor)
    safe_gam = torch.where(degenerate, torch.ones_like(gam_s), gam_s)

    B = (zeta - (z[..., None, :] @ v)[..., 0, :]) / safe_gam
    A = zTalpha[..., None] - B * (alpha[..., None, :] @ k_a)[..., 0, :]

    gp_tl = state.gp_log_l
    m_a = gpm.gp_mean(kfn, gp_tl, x_a)
    if use_kinv:
        k_tl = kfn(gp_tl.theta, x_a, gp_tl.x) * gp_tl.mask.to(dtype)[..., None, :]
        c_a = kdiagfn(gp_tl.theta, x_a) - ((k_tl @ gp_tl.Kinv) * k_tl).sum(-1)
    else:
        c_a = gpm.gp_var(kfn, kdiagfn, gp_tl, x_a)
    return A, B, degenerate, zTalpha, m_a, torch.clamp(c_a, min=0.0)


def expected_squared_mean_xla(state: BQState, opts: BQOptions, x_a) -> torch.Tensor:
    """The plain-tensor ESM path (named after its JAX counterpart) → (na,);
    (B, na) for a fleet state, whose ``x_a`` may be (B, na, d)."""
    if not (torch.is_tensor(x_a) and x_a.ndim == 3):
        x_a = as_points(x_a, opts.dim, state.x_s.dtype, state.x_s.device)
    A, B, degenerate, zTalpha, m_a, c_a = _esm_affine_terms(state, opts, x_a)
    E1, E2 = _lognormal_moments(m_a, c_a, state.gamma[..., None])
    esm = A * A + 2.0 * A * B * E1 + B * B * E2
    return torch.where(degenerate, (zTalpha * zTalpha)[..., None], esm)


def approx_expected_squared_mean(state: BQState, opts: BQOptions, x_a) -> torch.Tensor:
    """Gauss–Hermite twin of the ESM: (A + B ℓ_a)² integrated numerically over
    tl_a ~ N(m_a, c_a) with ``n_gh`` nodes (scipy's rule: numpy's hermegauss
    weights overflow above ~384 nodes), a check of the lognormal-moment
    closed form."""
    import numpy as np
    from scipy.special import roots_hermitenorm

    dtype, dev = state.x_s.dtype, state.x_s.device
    x_a = as_points(x_a, opts.dim, dtype, dev)
    gh_x, gh_w = roots_hermitenorm(opts.n_gh)
    gh_x = torch.as_tensor(gh_x, dtype=dtype, device=dev)
    gh_w = torch.as_tensor(gh_w / np.sqrt(2.0 * np.pi), dtype=dtype, device=dev)
    A, B, degenerate, zTalpha, m_a, c_a = _esm_affine_terms(state, opts, x_a)
    t = m_a[..., None] + torch.sqrt(c_a)[..., None] * gh_x
    l_nodes = state.gamma[..., None, None] * torch.expm1(t)
    esm = ((A[..., None] + B[..., None] * l_nodes) ** 2) @ gh_w
    return torch.where(degenerate, (zTalpha * zTalpha)[..., None], esm)


def esm_fused_inputs(state: BQState, opts: BQOptions, x_a):
    """Pack one float32 gaussian problem for ``hopper_kernels.esm_fused``,
    with the production guard noise_mult = λ·ρ·κ → the kernel's argument tuple."""
    dtype = state.x_s.dtype
    gp_l, gp_tl = state.gp_l, state.gp_log_l
    m_sc = state.sc_mask.to(dtype)
    z = int_K_measure(state, opts, gp_l.theta, state.x_sc) * m_sc
    Kinv = gp_l.Kinv
    h_l, w_l = gp_l.theta[0], gp_l.theta[1:]
    h_tl, w_tl = gp_tl.theta[0], gp_tl.theta[1:]
    A = torch.diag(w_l * w_l) + state.x_var  # W_l + Σ
    zc = h_l * h_l * torch.prod(w_l) / torch.sqrt(torch.linalg.det(A))
    kappa = h_l * h_l + gp_l.s * gp_l.s + gp_l.jitter
    rho = Kinv.abs().sum(1).amax()
    cap = torch.tensor(0.5 * math.log(torch.finfo(dtype).max), dtype=dtype, device=z.device)
    thresh = torch.tensor(opts.candidate_thresh, dtype=dtype, device=z.device)
    params = torch.cat([
        torch.stack([h_l * h_l, kappa, zc, state.gamma, thresh, (z * gp_l.alpha).sum(),
                     h_tl * h_tl, cap]),
        0.5 / (w_l * w_l),
        0.5 / (w_tl * w_tl),
        state.x_mean,
        (0.5 * torch.linalg.inv(A)).reshape(-1),
        ((_LAM_F32 * rho) * kappa)[None],
    ])
    return (params, x_a.contiguous(), state.x_sc.contiguous(), m_sc, Kinv.contiguous(),
            (Kinv @ z).contiguous(), gp_l.alpha.contiguous(), state.x_s.contiguous(),
            state.obs_mask.to(dtype), gp_tl.Kinv.contiguous(), gp_tl.alpha.contiguous())


def esm_route(state: BQState, opts: BQOptions) -> str:
    """The scorer ``expected_squared_mean`` takes for one problem:
    "esm_fused" for a float32 gaussian state at d ≤ 3 (any size), else
    "plain" (``expected_squared_mean_xla``)."""
    NP, NP2 = state.x_sc.shape[-2], state.x_s.shape[-2]
    if (state.x_s.dtype == torch.float32 and opts.kernel == "gaussian"
            and hk.esm_fused_supported(NP, NP2, opts.dim)):
        return "esm_fused"
    return "plain"


def expected_squared_mean(state: BQState, opts: BQOptions, x_a) -> torch.Tensor:
    """ESM scores for a batch of locations x_a: (na, d) → (na,)."""
    x_a = as_points(x_a, opts.dim, state.x_s.dtype, state.x_s.device)
    if esm_route(state, opts) == "esm_fused":
        return hk.esm_fused(*esm_fused_inputs(state, opts, x_a))
    return expected_squared_mean_xla(state, opts, x_a)


def expected_squared_mean_fused(state: BQState, opts: BQOptions, x_a, interpret=None) -> torch.Tensor:
    """ESM scores through ``esm_fused`` whatever ``esm_route`` says: a gaussian
    state with d ≤ 3 in float32 (the wrapper raises ``TypeError`` on another
    dtype); on a CPU tensor the kernel's plain twin. ``interpret`` (the TPU
    kernel's interpret mode) is accepted and ignored."""
    del interpret
    if opts.dim > 3 or opts.kernel != "gaussian":
        raise ValueError(
            "expected_squared_mean_fused supports gaussian kernels with dim <= 3; "
            f"got kernel={opts.kernel!r}, dim={opts.dim}"
        )
    x_a = as_points(x_a, opts.dim, state.x_s.dtype, state.x_s.device)
    return hk.esm_fused(*esm_fused_inputs(state, opts, x_a))


def expected_Z_var(state: BQState, opts: BQOptions, x_a) -> torch.Tensor:
    """E[V[Z] after sampling at x_a] = Z_mean² + Z_var − ESM(x_a)."""
    zm = Z_mean(state, opts)
    return zm * zm + Z_var(state, opts) - expected_squared_mean(state, opts, x_a)


def choose_next(state: BQState, opts: BQOptions, x_a, hyper_samples=None):
    """argmax of the (hyper-marginalized) ESM over the grid → (x_best, scores).

    ``hyper_samples``: optional (n, p) rows, θ_tl or joint θ_tl ∥ θ_l
    (``bq.apply_hyper_sample``); the state is re-anchored
    and the grid scored under each row in turn, so memory stays O(grid).
    """
    x_a = as_points(x_a, opts.dim, state.x_s.dtype, state.x_s.device)
    if hyper_samples is None:
        scores = expected_squared_mean(state, opts, x_a)
    else:
        scores = torch.zeros(x_a.shape[0], dtype=x_a.dtype, device=x_a.device)
        for th in hyper_samples:
            scores = scores + expected_squared_mean(apply_hyper_sample(state, opts, th), opts, x_a)
        scores = scores / len(hyper_samples)
    sel = demote_near_observed(scores, x_a, state.x_s, state.obs_mask, opts.candidate_thresh)
    return x_a[torch.argmax(sel)], scores


#: Adam's constants in ``refine_next`` (optax.adam's defaults).
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def refine_next(state: BQState, opts: BQOptions, x0, hyper_samples=None, n_steps: int = 30,
                lr: float = 0.1):
    """Gradient-ascent refinement of a grid pick off the grid → (x_ref, esm_ref).

    ``n_steps`` Adam steps (optax's arithmetic: b1 0.9, b2 0.999, eps 1e-8,
    step ``lr``·w_scale) on −∇ₓESM from ``x0`` (d,), the gradient by autograd
    through the plain scorer (``expected_squared_mean_xla``: the fused
    kernel has no backward, as in the JAX package). w_scale is the linear
    GP's period for the periodic kernel (its w is unitless) and its smallest
    length-scale otherwise, so ``lr`` is unitless. ``hyper_samples`` (S, p)
    rows (θ_tl or joint): the objective is the ESM averaged over the rows,
    all S re-anchored once as one batched state (``apply_hyper_sample``
    with a row axis). Non-finite gradients count as zero; the best iterate
    is returned, never worse than ``x0``. The loop reads nothing back to
    the host.
    """
    dtype, dev = state.x_s.dtype, state.x_s.device
    x0 = torch.as_tensor(x0, dtype=dtype, device=dev).reshape(opts.dim)
    th_l = state.gp_l.theta
    w_scale = th_l[2] if opts.kernel == "periodic" else th_l[1:1 + opts.dim].min()
    if hyper_samples is not None:
        state = apply_hyper_sample(state, opts, hyper_samples)

    def score(x):
        return expected_squared_mean_xla(state, opts, x[None, :]).reshape(-1).mean()

    def value_and_grad(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            v = score(x)
            (g,) = torch.autograd.grad(v, x)
        return v.detach(), g

    step = lr * w_scale
    x, best_x = x0, x0
    best_v = score(x0)
    mu = torch.zeros_like(x0)
    nu = torch.zeros_like(x0)
    for t in range(1, n_steps + 1):
        v, g = value_and_grad(x)
        better = v > best_v
        best_x = torch.where(better, x, best_x)
        best_v = torch.where(better, v, best_v)
        g = -torch.where(torch.isfinite(g), g, torch.zeros_like(g))  # ascend
        mu = (1.0 - _ADAM_B1) * g + _ADAM_B1 * mu
        nu = (1.0 - _ADAM_B2) * g * g + _ADAM_B2 * nu
        mu_hat = mu / (1.0 - _ADAM_B1**t)
        nu_hat = nu / (1.0 - _ADAM_B2**t)
        x = x - step * (mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS))
    v_last = score(x)
    better = v_last > best_v
    return torch.where(better, x, best_x), torch.where(better, v_last, best_v)


def add_observation(state: BQState, opts: BQOptions, x_a, l_a) -> BQState:
    """Write an observation into slot ``ns`` and refit both GPs. At capacity
    it overwrites the last slot: callers grow ``max_obs`` first. For a fleet
    state ``x_a`` is (B, d) and ``l_a`` (B,): one observation per problem, each
    into its own slot, and one batched refit."""
    dtype, dev = state.x_s.dtype, state.x_s.device
    batch = state.ns.shape
    x_a = torch.as_tensor(x_a, dtype=dtype, device=dev).reshape(*batch, state.x_s.shape[-1])
    l_a = torch.as_tensor(l_a, dtype=dtype, device=dev).reshape(batch)
    slot = torch.arange(opts.max_obs, device=dev) == torch.clamp(state.ns, max=opts.max_obs - 1)[..., None]
    st = state._replace(
        x_s=torch.where(slot[..., :, None], x_a[..., None, :], state.x_s),
        l_s=torch.where(slot, l_a[..., None], state.l_s),
        obs_mask=state.obs_mask | slot,
        ns=torch.clamp(state.ns + 1, max=opts.max_obs),
    )
    return _fit_gps(st, opts)


def run_active_loop(state: BQState, opts: BQOptions, loglik_fn, x_grid, n_steps: int,
                    hyper_samples=None, incremental="auto", refresh_every: int = 16,
                    record_moments: bool = True):
    """Closed choose → evaluate → add loop.

    ``loglik_fn`` maps a (d,) tensor to the likelihood there. Returns
    (final_state, (x_next (n_steps, d), Z_mean (n_steps,), Z_var (n_steps,))),
    or (final_state, x_next) with ``record_moments=False`` (the same final
    state, without the per-step V[Z] quadrature).

    ``incremental``: True adds each observation by the exact incremental
    updates of ``models.incremental.add_observation_fast`` (with its full-refit
    fallback and a fresh refit whenever the live count is a multiple of
    ``refresh_every``), False by the full refit; ``"auto"`` takes the
    incremental path where ``opts.max_obs`` lies inside the window measured
    on the card (``incremental.INCREMENTAL_AUTO_WINDOW``).
    """
    from tpubq_torch.models.incremental import add_observation_fast, incremental_auto

    if incremental == "auto":
        incremental = incremental_auto(opts.max_obs)
    xs, zms, zvs = [], [], []
    for _ in range(n_steps):
        x_next, _scores = choose_next(state, opts, x_grid, hyper_samples)
        l_next = loglik_fn(x_next)
        if incremental:
            state = add_observation_fast(state, opts, x_next, l_next, refresh_every)
        else:
            state = add_observation(state, opts, x_next, l_next)
        xs.append(x_next)
        if record_moments:
            zms.append(Z_mean(state, opts))
            zvs.append(Z_var(state, opts))
    if not record_moments:
        return state, torch.stack(xs)
    return state, (torch.stack(xs), torch.stack(zms), torch.stack(zvs))
