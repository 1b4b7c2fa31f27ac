"""Sharded BQ programs: candidate scoring, marginalization and the fleet
across devices.

Counterpart of ``tpubq/parallel/sharded.py``, laid out over a (dp, sp)
``DeviceMesh`` (``tpubq_torch.parallel.mesh``), one process per device:

  * the candidate grid shards along ``sp``: each process scores its rows,
    and the scores are gathered (``all_gather``) for the selection;
  * hyper-sample rows shard along ``dp`` (``choose_next_sharded``) or along
    the flat dp × sp axis (``marginalize_sharded``); padding rows carry zero
    weight or are trimmed;
  * a fleet's problems shard along ``dp`` (and along dp × sp for the
    moments); the per-problem winner over grid shards is an
    ``all_reduce(MAX)`` of the local best values, then an ``all_reduce(MIN)``
    of the global index among the processes that reach it.

Every process passes the same full inputs (the replicated state, the full
grid, all hyper rows) and gets back the same full outputs, as the JAX
package's global arrays give them; each cuts its own shard from its mesh
coordinates. Each shard runs through the unsharded functions of the port,
and so through the same kernels: ``esm_fused``, the fleet scorer's
``esm_fleet_l`` / ``esm_fleet_tl``, ``chol_batch`` and, for a re-anchored
single state, ``gaussian_gram``, ``cholesky_blocked`` and
``tri_solve_blocked``. The collectives are NCCL's on the card and gloo's on
the CPU, and carry no ``bool``: flags travel as ``int32``. On a (1, 1) mesh
every function computes what its unsharded counterpart does, bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpubq_torch.models import acquire
from tpubq_torch.models import batched as bt
from tpubq_torch.models import bq as bqm
from tpubq_torch.models import marginalize as margm
from tpubq_torch.models.bq import BQState, Z_mean, Z_var, apply_hyper_sample
from tpubq_torch.parallel.mesh import AXIS_GRID, AXIS_SAMPLE, axis_size
from tpubq_torch.utils.options import BQOptions

__all__ = [
    "choose_next_sharded",
    "marginalize_sharded",
    "fleet_Z_moments_sharded",
    "fleet_choose_next_sharded",
    "run_active_loop_fleet_sharded",
    "pad_to_multiple",
]

_INT32_MAX = torch.iinfo(torch.int32).max


def pad_to_multiple(arr: torch.Tensor, m: int, axis: int = 0):
    """Edge-repeat pad along ``axis`` to a multiple of m → (padded, n_real),
    as one ``index_select`` with clamped indices."""
    n = arr.shape[axis]
    rem = (-n) % m
    if rem == 0:
        return arr, n
    idx = torch.clamp(torch.arange(n + rem, device=arr.device), max=n - 1)
    return arr.index_select(axis, idx), n


def _block(a: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """The i-th of n equal blocks of ``a`` along its first axis."""
    k = a.shape[0] // n
    return a[i * k:(i + 1) * k]


def _pad_state(states: BQState, m: int) -> BQState:
    return bqm.tree_map(lambda a: pad_to_multiple(a, m)[0], states)


def _gather(t: torch.Tensor, mesh: DeviceMesh, name: str, dim: int = 0) -> torch.Tensor:
    """Concatenate every process's ``t`` along ``dim`` in mesh order of the
    named dimension (``all_gather``); bool tensors travel as int32."""
    src = t.to(torch.int32) if t.dtype == torch.bool else t
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(axis_size(mesh, name))]
    dist.all_gather(parts, src, group=mesh.get_group(name))
    out = torch.cat(parts, dim)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def _gather_flat(t: torch.Tensor, mesh: DeviceMesh, dim: int = 0) -> torch.Tensor:
    """Gather along the flat dp × sp axis (dp major, as JAX's
    ``P((dp, sp))``): over sp, then over dp."""
    return _gather(_gather(t, mesh, AXIS_GRID, dim), mesh, AXIS_SAMPLE, dim)


def _all_reduce(t: torch.Tensor, op, mesh: DeviceMesh, name: str) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=mesh.get_group(name))
    return t


def _flat_index(mesh: DeviceMesh) -> tuple:
    """(this process's index along the flat dp × sp axis, its length)."""
    n_sp = axis_size(mesh, AXIS_GRID)
    return mesh.get_local_rank(AXIS_SAMPLE) * n_sp + mesh.get_local_rank(AXIS_GRID), \
        axis_size(mesh, AXIS_SAMPLE) * n_sp


def _grid_shard(x_a, opts: BQOptions, like: torch.Tensor, mesh: DeviceMesh):
    """(padded grid, real length, this process's rows, the global index of
    its first row)."""
    x_a = acquire.as_points(x_a, opts.dim, like.dtype, like.device)
    x_pad, n_real = pad_to_multiple(x_a, axis_size(mesh, AXIS_GRID))
    shard = _block(x_pad, mesh.get_local_rank(AXIS_GRID), axis_size(mesh, AXIS_GRID))
    return x_pad, n_real, shard, mesh.get_local_rank(AXIS_GRID) * shard.shape[0]


def choose_next_sharded(
    state: BQState,
    opts: BQOptions,
    x_a,
    mesh: DeviceMesh,
    hyper_samples=None,
):
    """Multi-device ``choose_next``: grid sharded over sp, hyper samples over
    dp → (x_best, scores), the scores of the full grid.

    Without rows each process scores its grid rows on the cached
    factorizations (``acquire.expected_squared_mean``: ``esm_fused`` for a
    float32 gaussian state on the card). With rows, each process re-anchors
    its dp share of them one at a time (``apply_hyper_sample``, as
    ``acquire.choose_next`` does) and sums its scores; the sums and the
    weight counts are summed over dp and divided. The selection runs on the
    gathered scores: the duplicate-avoiding demotion, the pad masked to
    −inf, the argmax.
    """
    x_pad, n_real, shard, _ = _grid_shard(x_a, opts, state.x_s, mesh)
    if hyper_samples is None:
        scores = acquire.expected_squared_mean(state, opts, shard)
    else:
        n_dp = axis_size(mesh, AXIS_SAMPLE)
        hyp = torch.as_tensor(hyper_samples, dtype=state.x_s.dtype, device=state.x_s.device)
        hyp_pad, n_hyp = pad_to_multiple(hyp, n_dp)
        k = hyp_pad.shape[0] // n_dp
        first = mesh.get_local_rank(AXIS_SAMPLE) * k
        live = [first + j < n_hyp for j in range(k)]  # padding rows weigh 0 and are not scored
        total = torch.zeros(shard.shape[0], dtype=shard.dtype, device=shard.device)
        for th, w in zip(_block(hyp_pad, mesh.get_local_rank(AXIS_SAMPLE), n_dp), live):
            if w:
                total = total + acquire.expected_squared_mean(apply_hyper_sample(state, opts, th), opts, shard)
        count = torch.tensor(float(sum(live)), dtype=shard.dtype, device=shard.device)
        total = _all_reduce(total, dist.ReduceOp.SUM, mesh, AXIS_SAMPLE)
        count = _all_reduce(count, dist.ReduceOp.SUM, mesh, AXIS_SAMPLE)
        # divided by a host number, as acquire.choose_next divides by len(rows)
        scores = total / count.item()
    scores = _gather(scores, mesh, AXIS_GRID)
    # the demotion runs before the pad's −inf mask: demoting −inf gives NaN
    sel = acquire.demote_near_observed(scores, x_pad, state.x_s, state.obs_mask, opts.candidate_thresh)
    live_pts = torch.arange(x_pad.shape[0], device=x_pad.device) < n_real
    best = torch.argmax(torch.where(live_pts, sel, torch.full_like(sel, -torch.inf)))
    return x_pad[best], scores[:n_real]


def marginalize_sharded(
    state: BQState,
    opts: BQOptions,
    hyper_samples,
    mesh: DeviceMesh,
    funs=(Z_mean, Z_var),
):
    """Multi-device ``marginalize``: hyper rows sharded over the flat dp × sp
    axis. Each process installs its rows as one batched refit
    (``marginalize.marginalize``: ``chol_batch`` on the card) and evaluates
    ``funs``; the results are gathered and trimmed → a tuple of (n,)
    tensors. Rows are θ_tl or joint θ_tl ∥ θ_l."""
    i, n_total = _flat_index(mesh)
    hyp = torch.as_tensor(hyper_samples, dtype=state.x_s.dtype, device=state.x_s.device)
    thetas, n_real = pad_to_multiple(hyp, n_total)
    outs = margm.marginalize(state, opts, _block(thetas, i, n_total), funs)
    return tuple(_gather_flat(o, mesh)[:n_real] for o in outs)


def shard_grid(x_a: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This process's rows of a candidate grid padded to a multiple of the sp
    extent. (JAX places the whole grid with its rows sharded along sp, a
    ``NamedSharding``; with one process per device the port hands each
    process its own rows.)"""
    x_pad, _ = pad_to_multiple(x_a, axis_size(mesh, AXIS_GRID))
    return _block(x_pad, mesh.get_local_rank(AXIS_GRID), axis_size(mesh, AXIS_GRID))


# ---------------------------------------------------------------------------
# Fleet sharding: B independent problems served across the mesh
# (models/batched.py is the single-device fleet).
# ---------------------------------------------------------------------------


def fleet_Z_moments_sharded(states: BQState, opts: BQOptions, mesh: DeviceMesh):
    """Fleet E[Z] and V[Z] with the problems sharded over the flat dp × sp
    axis (the moments have no grid to split) → ((B,), (B,)), as
    ``batched.Z_mean_batch`` / ``Z_var_batch``."""
    i, n_total = _flat_index(mesh)
    n_b = states.ns.shape[0]
    local = bqm.tree_map(lambda a: _block(a, i, n_total), _pad_state(states, n_total))
    zm, zv = bt.Z_mean_batch(local, opts), bt.Z_var_batch(local, opts)
    return _gather_flat(zm, mesh)[:n_b], _gather_flat(zv, mesh)[:n_b]


def _fleet_winner(states: BQState, opts: BQOptions, shard: torch.Tensor, g0: int, mesh: DeviceMesh):
    """Score this process's (problems × grid rows) block and find each
    problem's winner over the whole grid → (global index (B_local,) int32,
    scores (B_local, G_local)). The all-excluded fallback of the demotion
    is decided over sp; the winner is the largest selection value, the
    smallest global index among the grid shards that reach it."""
    scores = bt.expected_squared_mean_batch(states, opts, shard)
    sel = acquire.demote_near_observed(scores, shard, states.x_s, states.obs_mask, opts.candidate_thresh,
                                       group=mesh.get_group(AXIS_GRID))
    local_best = torch.argmax(sel, dim=1)
    local_val = sel.gather(1, local_best[:, None])[:, 0]
    best_val = _all_reduce(local_val.clone(), dist.ReduceOp.MAX, mesh, AXIS_GRID)
    cand = torch.where(local_val >= best_val, (g0 + local_best).to(torch.int32),
                       torch.full_like(local_best, _INT32_MAX, dtype=torch.int32))
    return _all_reduce(cand, dist.ReduceOp.MIN, mesh, AXIS_GRID), scores


def _local_fleet(states: BQState, mesh: DeviceMesh) -> BQState:
    n_dp = axis_size(mesh, AXIS_SAMPLE)
    return bqm.tree_map(lambda a: _block(a, mesh.get_local_rank(AXIS_SAMPLE), n_dp), _pad_state(states, n_dp))


def fleet_choose_next_sharded(states: BQState, opts: BQOptions, x_a, mesh: DeviceMesh):
    """Fleet ``choose_next`` over a shared grid: problems sharded along dp,
    the grid along sp. Each process scores its block through
    ``batched.expected_squared_mean_batch`` (the fleet kernels for a float32
    gaussian fleet on the card) → ((B, d) picks, (B, G) scores)."""
    x_pad, n_grid, shard, g0 = _grid_shard(x_a, opts, states.x_s, mesh)
    n_b = states.ns.shape[0]
    best_idx, scores = _fleet_winner(_local_fleet(states, mesh), opts, shard, g0, mesh)
    best_idx = torch.clamp(_gather(best_idx, mesh, AXIS_SAMPLE)[:n_b], max=n_grid - 1)
    scores = _gather(_gather(scores, mesh, AXIS_GRID, dim=1), mesh, AXIS_SAMPLE)
    return x_pad[best_idx.long()], scores[:n_b, :n_grid]


def run_active_loop_fleet_sharded(
    states: BQState,
    opts: BQOptions,
    loglik_fn,
    grid,
    n_steps: int,
    mesh: DeviceMesh,
    record_moments: bool = True,
):
    """Multi-device fleet active loop: choose → observe → refit for
    ``n_steps``, problems sharded along dp and the grid along sp; the
    sharded counterpart of ``batched.run_active_loop_batch``. Every process
    runs the same loop, one host iteration a step. Per step and per local
    problem:

      1. score the (B_local × G_local) block (the fleet scorer),
      2. demote near-observed points (the all-excluded fallback decided
         over sp),
      3. reduce (max, min index) over the grid shards → the global winner,
      4. recover the winner's coordinates by a masked ``all_reduce(SUM)``
         over sp (exactly one shard owns any global index),
      5. evaluate ``loglik_fn`` (mapped over the problems with
         ``torch.vmap``) and absorb the observation
         (``batched.add_observation_batch``: ``chol_batch`` on the card).
         Each sp member holds a replica of its dp problems and computes the
         same update, so the replicas stay equal with no further
         communication.

    Returns ``(final_states, (Z_mean (n_steps, B), Z_var (n_steps, B)))``,
    or ``(final_states, picks (n_steps, B, d))`` with
    ``record_moments=False``, as the JAX package's sharded loop does.
    """
    _, _, shard, g0 = _grid_shard(grid, opts, states.x_s, mesh)
    g_local = shard.shape[0]
    n_b = states.ns.shape[0]
    lik = torch.vmap(loglik_fn)
    s = _local_fleet(states, mesh)
    zms, zvs, picks = [], [], []
    for _ in range(n_steps):
        best_idx, _ = _fleet_winner(s, opts, shard, g0, mesh)
        rel = best_idx.long() - g0
        in_shard = (rel >= 0) & (rel < g_local)
        xl = shard[torch.clamp(rel, 0, g_local - 1)]
        x_next = _all_reduce(torch.where(in_shard[:, None], xl, torch.zeros_like(xl)), dist.ReduceOp.SUM,
                             mesh, AXIS_GRID)
        s = bt.add_observation_batch(s, opts, x_next, lik(x_next))
        if record_moments:
            zms.append(bt.Z_mean_batch(s, opts))
            zvs.append(bt.Z_var_batch(s, opts))
        else:
            picks.append(x_next)
    final = bqm.tree_map(lambda a: _gather(a, mesh, AXIS_SAMPLE)[:n_b], s)

    def traj(vals, *tail):
        """(n_steps, B, *tail): the steps' local values gathered over dp."""
        t = torch.stack(vals) if vals else s.x_s.new_empty((0, s.ns.shape[0], *tail))
        return _gather(t, mesh, AXIS_SAMPLE, dim=1)[:, :n_b]

    if record_moments:
        return final, (traj(zms), traj(zvs))
    return final, traj(picks, opts.dim)
