"""Incremental (rank-1 / block-Woodbury) observation updates.

Counterpart of ``tpubq/models/incremental.py``. A full ``add_observation``
refits both GPs: two Grams, two factorizations and, per GP, the solves for
alpha and K⁻¹. This module replaces the refit with exact incremental algebra:

  * ``gp_border_add`` — a new observation slot flips dead → live. The padded
    Gram gains one bordered row/col, so the Cholesky factor gains one row
    (``[vᵀ, √s]`` with v = L⁻¹k) and K⁻¹ updates by one symmetric rank-1
    term.
  * ``delete_candidate_slots_kinv`` — candidate slots flip live → dead when
    the new observation lands within ``candidate_thresh`` of them: the
    block-Woodbury identity K⁻¹ − K⁻¹[:,J] (K⁻¹[J,J])⁻¹ K⁻¹[J,:], one
    (n_candidate × n_candidate) solve.
  * ``add_observation_fast`` — the whole ``add_observation`` transition from
    the two primitives, with the exact full refit (``bq._fit_gps``) instead
    whenever the algebra does not apply: the point extends the observed range
    (candidate positions move), a bordered Schur complement is below
    √eps·κ (a near-duplicate), capacity is exhausted, either GP's factor had
    failed, or the new live count is a multiple of ``refresh_every`` (a fresh
    factorization bounds float32 drift). The JAX package's ``lax.cond`` is
    one host branch on ``fast_ok`` here: one host sync per call.

    The linear GP's factor cannot be bordered (candidate slots interleave
    after the observation block), so the fast path refactors it once, on
    ``cholesky_blocked`` for a float32 state on the card; its K⁻¹ still comes
    from the Woodbury updates, so no solve against the identity runs.

Where the port departs from the JAX algebra: the JAX package takes the
bordered row as Lᵀ(K⁻¹k) and both alphas from the updated inverses, so that
its update has no triangular solve (slow on the TPU). In float32 those carry
the inverses' κ·eps error into the factor, alpha and the anchors: over six
fast steps at max_obs 128 (κ ≈ 1e4) E[Z] drifted to 5.7e-5 and V[Z] to 4.9e-2
of float64, against 1.7e-7 and 5.5e-4 for the refit (float32 on the CPU).
Here the row is v = L⁻¹k (one forward solve) with s = κ − ‖v‖², and both
alphas come from their factors (two solves each): five single-column
``tri_solve_blocked`` calls per fast step on the card. K⁻¹ of either GP, which
only the scorer reads, keeps the rank-1 and Woodbury updates.

Exactness: both primitives are algebraically exact, so in float64 a fast
step matches the full refit to roundoff.

When it pays: never, so far, on the card. Measured on an NVIDIA H100 80GB
HBM3 at a 700 W power limit by ``chip_smoke.py``'s large-N timing (the recipe
of ``benchmarks/large_n.py`` at s = 0.05: ms per step of an 8-step
``run_active_loop`` without moments, refit / incremental, the mean of two
turns each; PERF.md §6 keeps every run), with the single-column solve at
~0.04 ms (one launch):

    max_obs     64     96    128    192    256    512   1024
    refit      5.9    6.3    7.3    9.2   12.2   23.6   77.9
    incr.      8.4    8.5    8.9    9.1   14.4   26.7   81.1

The refit wins the loop at every size but 192, where the turns overlap
(refit 10.1 and 8.4, incremental 9.0 and 9.2). The add alone is faster on
the fast path from max_obs 512 up (5.7 against 7.7 ms at 512, 6.7 against
8.4 ms at 1024), but the loop's first picks extend the observed range and
fall back to the refit after the fast path's work, a fast step still
refactors the linear GP (``cholesky_blocked``, 2.3 ms at n = 1036), and at
large max_obs the step's time is the scorer's (``esm_fused``, 92% of the
device time at 1024). So ``"auto"`` takes the refit everywhere.

A fleet state (a leading problem axis) raises: the JAX module forbids
``vmap`` (under batching its cond runs both branches), and the fleet keeps
the batched refit of ``models/batched.py``.
"""

from __future__ import annotations

import torch

from tpubq_torch.models import gp as gpm
from tpubq_torch.models.bq import BQState, _fit_gps, inv_log_transform, live_bounds, log_transform
from tpubq_torch.ops import linalg
from tpubq_torch.ops.kernels import get_kernel
from tpubq_torch.utils.options import BQOptions

__all__ = [
    "gp_border_add",
    "delete_candidate_slots_kinv",
    "add_observation_fast",
    "incremental_auto",
    "INCREMENTAL_AUTO_WINDOW",
]

#: max_obs window [lo, hi) where ``run_active_loop(incremental="auto")`` takes
#: the incremental path: empty, as measured on the H100 (module docstring).
INCREMENTAL_AUTO_WINDOW = (0, 0)


def incremental_auto(max_obs: int) -> bool:
    """Resolve ``incremental="auto"``: True iff ``max_obs`` is inside
    ``INCREMENTAL_AUTO_WINDOW``."""
    lo, hi = INCREMENTAL_AUTO_WINDOW
    return lo <= max_obs < hi


def _one_hot(i: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (torch.arange(n, device=i.device) == i).to(dtype)


def gp_border_add(kfn, kdiagfn, gp: gpm.GPState, i, x_new, y_new, update_L: bool,
                  update_alpha: bool = True):
    """Flip slot ``i`` (a 0-d index tensor) of a padded GP from dead to live —
    exact bordering → (gp', s_schur, κ).

    ``x_new``/``y_new`` are the updated full arrays (slot ``i`` written). The
    caller must treat the update as invalid unless ``s_schur`` is safely
    positive. ``update_L`` also appends the bordered Cholesky row, valid only
    when every live slot is below ``i`` (the observation GP, not the
    observation ∪ candidate GP). ``update_alpha=False`` returns the stale
    alpha, for callers that recompute it against a further-updated K⁻¹.
    """
    dtype = x_new.dtype
    n = x_new.shape[0]
    m_old = gp.mask.to(dtype)
    xi = x_new.index_select(0, i.reshape(1))
    k = kfn(gp.theta, x_new, xi)[:, 0] * m_old
    kappa = kdiagfn(gp.theta, xi)[0] + gp.s * gp.s + gp.jitter
    u = gp.Kinv @ k
    e_i = _one_hot(i, n, dtype)
    if update_L:
        # The bordered row v = L⁻¹k by a forward solve, and s = κ − ‖v‖²: the
        # JAX package forms v = Lᵀ(K⁻¹k) and s = κ − kᵀK⁻¹k from the cached
        # inverse (no triangular solve on the TPU), which in float32 carries
        # the inverse's κ·eps error into the factor and cancels it into s.
        v = linalg.tri_solve(gp.L, k[:, None])[:, 0]
        s_schur = kappa - (v * v).sum()
    else:
        s_schur = kappa - (k * u).sum()
    safe_s = torch.clamp(s_schur, min=torch.finfo(dtype).tiny)
    w = u - e_i
    Kinv = gp.Kinv - torch.outer(e_i, e_i) + torch.outer(w, w) / safe_s
    L = gp.L
    if update_L:
        row = v * (1.0 - e_i) + torch.sqrt(safe_s) * e_i
        L = gp.L * (1.0 - e_i)[:, None] + torch.outer(e_i, row)

    mask = gp.mask | e_i.bool()
    ym = torch.where(mask, y_new, torch.zeros_like(y_new))
    # with the bordered factor, alpha by its two solves; else from the updated inverse
    alpha = (linalg.chol_solve_vec(L, ym) if update_L else Kinv @ ym) if update_alpha else gp.alpha
    ok = gp.ok & torch.isfinite(s_schur)
    return gpm.GPState(gp.theta, gp.s, x_new, ym, mask, L, alpha, Kinv, gp.jitter, ok), s_schur, kappa


def delete_candidate_slots_kinv(Kinv, flip_cand, n_obs: int):
    """Flip candidate slots live → dead in K⁻¹ (block Woodbury).

    ``flip_cand``: (n_candidate,) bool over the candidate block (slots
    ``n_obs:``), True for live slots being deleted. Rows and columns of the
    deleted slots return to identity; the live block becomes the inverse of
    the Gram without them.
    """
    dtype = Kinv.dtype
    f = flip_cand.to(dtype)
    C = Kinv[:, n_obs:]
    Kcc = Kinv[n_obs:, n_obs:]
    M = Kcc * torch.outer(f, f) + torch.diag(1.0 - f)
    G = C * f[None, :]
    sol, _ = torch.linalg.solve_ex(M, G.transpose(0, 1))  # no host sync
    flip_full = torch.cat([torch.zeros(n_obs, dtype=dtype, device=Kinv.device), f])
    return Kinv - G @ sol + torch.diag(flip_full)


def _enforce_pad_pattern(Kinv, mask):
    """Clamp K⁻¹ to its padded pattern (identity at dead slots), killing
    float32 drift into dead rows."""
    m = mask.to(Kinv.dtype)
    eye = torch.eye(Kinv.shape[0], dtype=Kinv.dtype, device=Kinv.device)
    return Kinv * torch.outer(m, m) + eye * (1.0 - m)


def add_observation_fast(state: BQState, opts: BQOptions, x_a, l_a, refresh_every: int = 16) -> BQState:
    """``add_observation`` by exact incremental updates, with the full refit
    where they do not apply (module docstring); the same transition as
    ``acquire.add_observation``. ``refresh_every``: the full refit runs
    whenever the new live count is a multiple of it."""
    if refresh_every < 1:
        raise ValueError(f"refresh_every must be >= 1, got {refresh_every}")
    if state.ns.ndim != 0:
        raise ValueError("add_observation_fast takes one problem; a fleet state keeps the batched refit")
    kfn, kdiagfn = get_kernel(opts.kernel)
    dtype, dev = state.x_s.dtype, state.x_s.device
    d = state.x_s.shape[1]
    x_a = torch.as_tensor(x_a, dtype=dtype, device=dev).reshape(d)
    l_a = torch.as_tensor(l_a, dtype=dtype, device=dev).reshape(())

    i = torch.clamp(state.ns, max=opts.max_obs - 1)
    has_room = state.ns < opts.max_obs
    lo, hi = live_bounds(state.x_s, state.obs_mask)
    inside = (x_a >= lo).all() & (x_a <= hi).all()

    # slot write (both branches); obs_mask stays old for the bordering
    slot = torch.arange(opts.max_obs, device=dev) == i
    st0 = state._replace(
        x_s=torch.where(slot[:, None], x_a[None, :], state.x_s),
        l_s=torch.where(slot, l_a, state.l_s),
        tl_s=torch.where(slot, log_transform(l_a, state.gamma), state.tl_s),
        ns=torch.clamp(state.ns + 1, max=opts.max_obs),
    )
    new_obs_mask = state.obs_mask | slot

    # log-GP: bordering
    gp_tl, s_tl, kap_tl = gp_border_add(
        kfn, kdiagfn, state.gp_log_l._replace(x=st0.x_s, mask=state.obs_mask),
        i, st0.x_s, st0.tl_s, update_L=True,
    )

    # candidates: same positions, the mask can only shrink
    dist = (state.x_c - x_a[None, :]).abs().amax(-1)
    near = dist < opts.candidate_thresh
    flip = state.c_mask & near
    c_mask = state.c_mask & ~near
    l_c = torch.where(c_mask, inv_log_transform(gpm.gp_mean(kfn, gp_tl, state.x_c), state.gamma),
                      torch.zeros_like(state.l_c))

    # linear GP: Woodbury-delete the flipped candidates, border-add the slot
    x_sc = torch.cat([st0.x_s, state.x_c], dim=0)
    l_sc = torch.cat([torch.where(new_obs_mask, st0.l_s, torch.zeros_like(st0.l_s)), l_c])
    mask_mid = torch.cat([state.obs_mask, c_mask])
    Kinv_mid = delete_candidate_slots_kinv(state.gp_l.Kinv, flip, opts.max_obs)
    gp_l, s_l, kap_l = gp_border_add(
        kfn, kdiagfn, state.gp_l._replace(x=x_sc, mask=mask_mid, Kinv=Kinv_mid),
        i, x_sc, l_sc, update_L=False, update_alpha=False,
    )
    sc_mask = gp_l.mask
    Kinv_l = _enforce_pad_pattern(gp_l.Kinv, sc_mask)
    # a fresh factor of the Gram the Woodbury updates inverted: kernel +
    # (s² + jitter) on the live diagonal, identity at pads
    eye = torch.eye(x_sc.shape[0], dtype=dtype, device=dev)
    m_sc = sc_mask.to(dtype)
    K_l = kfn(gp_l.theta, x_sc, x_sc) + eye * (gp_l.s * gp_l.s) * m_sc
    K_l = linalg.pad_gram(K_l, sc_mask) + eye * gp_l.jitter * m_sc
    L_l = linalg.posdef_cholesky(K_l)
    # alpha from the fresh factor's two solves (the JAX package: K⁻¹ l from the
    # Woodbury-updated inverse, whose float32 drift reaches E[Z])
    alpha_l = torch.where(sc_mask, linalg.chol_solve_vec(L_l, torch.where(sc_mask, l_sc, torch.zeros_like(l_sc))),
                          torch.zeros_like(l_sc))
    gp_l = gp_l._replace(L=L_l, Kinv=Kinv_l, alpha=alpha_l)

    # Schur guard √eps·κ: near-duplicates take the full-refit ladder
    guard = torch.finfo(dtype).eps ** 0.5
    fast_ok = torch.stack([
        has_room, inside, s_tl > guard * kap_tl, s_l > guard * kap_l,
        torch.isfinite(torch.diagonal(L_l)).all(), torch.isfinite(gp_tl.L.index_select(0, i.reshape(1))).all(),
        st0.ns % refresh_every != 0, state.gp_log_l.ok, state.gp_l.ok,
    ]).all()
    if bool(fast_ok):  # the one host sync: the JAX package's lax.cond
        return st0._replace(obs_mask=new_obs_mask, l_c=l_c, c_mask=c_mask, gp_log_l=gp_tl, gp_l=gp_l)
    return _fit_gps(st0._replace(obs_mask=new_obs_mask), opts)
