#!/usr/bin/env python3
"""Where the time of the port's float32 main path goes on one CUDA card.

Run from the repository root on a machine with a CUDA card:

    python3 profile_main_path.py [--out profile_main_path.txt] [--root DIR] [--kernels] [--only NAME]
                                 [--profiles N]

Pieces, on the testbed of chip_smoke.py (s = 0.01, max_obs 32, a
10,000-point grid, three active steps taken first):

* ``fit_hypers`` — the multi-restart hyperparameter fit of both GPs (10
  restarts × 150 Adam steps over the mll_grad kernel), from the initial state;
* ``step``       — one choose_next over the grid plus one add_observation;
* ``marginalize`` — marginalize over 100 given θ_tl samples;
* ``sampler``    — sample_hypers(n=20), the slice sampler alone;
* ``sampler_chains_c1`` / ``sampler_chains_c4`` — sample_hypers(n=100) with
  one chain and with four chains in lock step;
* ``refine`` / ``refine_n10`` — ``acquire.refine_next`` from the grid's pick
  (30 Adam steps by autograd through the plain scorer), without and with
  10 given θ_tl rows;
* ``health`` — ``BQ.health()``; ``load_refit`` — ``utils.io.load_state`` of
  the state's checkpoint with ``refit=True``;
* ``fleet_fit``  — ``BQFleet.fit`` of 64 problems (64 × 10 restart rows per
  mll_grad launch), from the initial fleet state;
* ``fleet_step`` — one ``BQFleet.choose_next`` over the grid plus one
  ``add_observation`` at B = 64 (the fleet of chip_smoke.py, after the fit and
  three steps);
* ``fleet_sampler`` — ``BQFleet.sample_hypers(n=100)`` at B = 64 (one
  lock-step sampler of 64 chains), from the fleet's initial state;
* ``fleet_marginalize`` — ``marginalize_batch`` over (64, 100) given θ_tl rows;
* ``fleet_choose_marg`` — ``BQFleet.choose_next(grid, n=10)`` (sampling
  included) at B = 64;
* ``large_refit_step`` / ``large_fast_step`` — at max_obs 1024 (chip_smoke.py's
  large-N recipe, 1,012 observations, s = 0.05, a 512-point grid): one
  choose_next plus one add at an interior point between two observations, by
  the full refit or by a fast incremental step (``add_observation_fast``);
* ``large_marginalize`` — marginalize over 100 given θ_tl rows at max_obs
  1024 (the (200, 1024, 1024) rung stack on cholesky_batched);
* ``large_fit_hypers`` — ``fit_hypers`` at max_obs 1024 on that recipe (10
  restarts × 150 Adam steps over the mll_grad tiles);
* ``family_step_<kernel>_d<d>`` / ``family_marginalize_<kernel>_d<d>`` — for
  each configuration of chip_smoke.py's ``families_path`` (matern52,
  matern32, rq, periodic at d = 1, matern52 at d = 2; float32, max_obs 32,
  after the fit and three steps): one choose_next over its 10⁴-point grid
  plus one add_observation, and marginalize over 100 given θ_tl rows (20 in
  2-D); ``family_fit_matern52_d1`` — its ``fit_hypers`` (L-BFGS over
  autograd, 10 restarts, both GPs); ``family_fleet_fit`` /
  ``family_fleet_step`` — the Matérn-5/2 fleet of 64 problems: ``fit`` (all
  640 restart rows in one lock-step L-BFGS) and a step after it;
* ``parallel_loop`` / ``parallel_loop_unsharded`` — ten steps of the fleet
  loop at B = 64 (chip_smoke.py's ``parallel_path`` fleet, at its initial
  hypers) through ``run_active_loop_fleet_sharded`` on a (1, 1) NCCL mesh,
  and through ``run_active_loop_batch``; beside them
  ``parallel_collectives``, the host µs to enqueue one NCCL ``all_reduce``,
  one ``all_gather`` and one elementwise add of a (64,) tensor on that mesh
  and the µs of each until the device is done (200 calls), and the sharded
  loop's per-operator table by host time in ``--out``.

For each piece it prints one JSON line: the host-clock wall time without the
profiler (mean of ``--iters`` calls, each ending in a synchronize), the device
busy time under ``torch.profiler`` (the union of the kernels' intervals on the
device timeline), the idle share 1 − busy / wall, the kernel count and, for
the pieces that sample, the sampler's host reads in one call. The
per-operator tables go to ``--out``, with each profiled run's count of
every device kernel by name. ``--profiles N`` profiles each piece N times
and adds each run's kernel count and busy time to its line, and the names
whose count differs between the runs. Imports nothing from JAX.

``--kernels`` times kernels alone instead (``kernel_cases``): every kernel
of PERF.md's table at the paths' shapes (``chol_batch`` at ``CHOL_SHAPES``
with the library's ``cholesky_ex`` beside it, ``cholesky_batched`` above 64
rows and panels of 32 forced at 44 (``chol_panels``); ``gaussian_gram``
at ``GRAM_SHAPES``; ``mll_grad`` at (10, 32), (10, 44),
(640, 32), (10, 256) and (10, 1036), and at (10, 64), (10, 96) and (10, 128)
by the wrapper's regime and by the tiles: ``MLL_CROSSOVER``; the fleet
kernels at the three B = 64 fleets of ``FLEET_SHAPES``), with the library
call beside it where there is one, each as CUDA-event ms over a loop of wrapper calls (two turns)
and as device ms per call from ``torch.profiler``'s per-kernel durations;
and ``device_context``, the host µs of entering a wrapper's device context
(``device_context_us``).
``--root DIR`` imports ``tpubq_torch`` from DIR (an unpacked parent commit,
say), so that two versions of the kernels are timed by the same code in one
call: parent, change, change, parent. ``--only NAME[,NAME...]`` keeps the
pieces (with ``--kernels``, the kernels) whose name starts with one of the
NAMEs: ``--only fleet`` profiles the fleet's fit and step, ``--kernels --only
chol_batch,gaussian_gram`` times those two kernels, ``--kernels --only
esm_fleet`` the two fleet kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

import chip_smoke as cs


def busy_us(events) -> tuple[float, int]:
    """(µs covered by the union of the device kernels' intervals, kernel count)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    total, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total, len(spans)


def short_name(name: str) -> str:
    """A device activity's name without its return type, namespace and arguments."""
    return name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0][:60]


def profile_piece(name: str, fn, iters: int, out, profiles: int = 1, count_reads: bool = False) -> dict:
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpubq_torch.models import marginalize as margm

    wall_ms = cs.host_ms(fn, iters)
    count_reads = count_reads and hasattr(margm.slice_sample, "host_reads")  # not in a --root before the count
    if count_reads:
        reads = margm.slice_sample.host_reads
        fn()
        reads = margm.slice_sample.host_reads - reads
    runs = []
    for _ in range(profiles):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy, n_kernels = busy_us(prof.events())
        cs.check(n_kernels > 0, f"{name}: the profiler saw device kernels")
        names = collections.Counter(short_name(e.name) for e in prof.events() if e.device_type == DeviceType.CUDA)
        runs.append((busy * 1e-3, n_kernels, names))
        out.write(json.dumps({"piece": name, "kernel_names": dict(sorted(names.items()))}) + "\n")
    busy_ms, n_kernels, _ = runs[0]
    res = dict(piece=name, wall_ms=wall_ms, device_busy_ms=busy_ms,
               idle_share=max(0.0, 1.0 - busy_ms / wall_ms), device_kernels=n_kernels)
    if count_reads:
        res["host_reads_per_call"] = reads
    if profiles > 1:
        every = sorted(set().union(*(r[2] for r in runs)))
        res.update(device_busy_ms_runs=[r[0] for r in runs], device_kernels_runs=[r[1] for r in runs],
                   kernel_names_differ={k: [r[2][k] for r in runs] for k in every
                                        if len({r[2][k] for r in runs}) > 1})
    out.write(json.dumps(res) + "\n")
    out.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15) + "\n")
    print(json.dumps(res), flush=True)
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="profile_main_path.txt")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--root", default=None, help="import tpubq_torch from this directory")
    ap.add_argument("--kernels", action="store_true", help="time the kernels alone")
    ap.add_argument("--profiles", type=int, default=1, help="profiled runs of each piece")
    ap.add_argument("--only", default=None,
                    help="the pieces (with --kernels: the kernels) whose name starts with one of these "
                         "comma-separated prefixes")
    args = ap.parse_args()
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: no CUDA device")
    import tpubq_torch

    dev = torch.device("cuda", 0)
    label = cs.nvidia_smi()
    print(json.dumps({"card": label, "torch": torch.__version__,
                      "tpubq_torch": os.path.relpath(os.path.dirname(tpubq_torch.__file__))}), flush=True)
    if args.kernels:
        kernel_times(dev, label, args.only)
        return 0

    grid = np.linspace(-4.0, 4.0, cs.G)
    want = lambda *names: not args.only or any(n.startswith(tuple(args.only.split(","))) for n in names)  # noqa: E731
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as out:
        out.write(f"{label}\n")
        if want("fit_hypers", "step", "marginalize", "sampler", "sampler_chains_c1", "sampler_chains_c4",
                "refine", "refine_n10", "health", "load_refit"):
            profile_single(dev, grid, args.iters, out, want, args.profiles)
        if want("fleet_fit", "fleet_step", "fleet_sampler", "fleet_marginalize", "fleet_choose_marg"):
            profile_fleet(dev, grid, args.iters, out, want, args.profiles)
        if want("large_refit_step", "large_fast_step", "large_marginalize"):
            profile_large_n(dev, args.iters, out, args.profiles)
        if want("large_fit_hypers"):
            profile_large_fit(dev, out, args.profiles)
        if want("family"):
            profile_families(dev, args.iters, out, want, args.profiles)
        if want("parallel"):
            profile_parallel(dev, grid, args.iters, out, args.profiles)
    return 0


def profile_parallel(dev, grid, iters: int, out, profiles: int = 1) -> None:
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from tpubq_torch import BQFleet
    from tpubq_torch.models import batched
    from tpubq_torch.parallel import mesh as pmesh, sharded as sh

    xs, _, _ = cs.fleet_data(cs.FLEET_B, cs.FLEET_N_OBS)
    fleet = BQFleet(xs, cs.f_l(xs), device=dev, dtype="float32", params_tl=cs.PARAMS_TL, params_l=cs.PARAMS_L,
                    n_candidate=12, candidate_thresh=0.2, max_obs=cs.FLEET_MAX_OBS, s=cs.S_MAIN)
    st, opts = fleet.states, fleet.options
    g = torch.as_tensor(grid, dtype=torch.float32, device=dev)
    lik = lambda x: torch.exp(-0.5 * ((x[0] - cs.MU_L) / cs.SIG_L) ** 2) / (cs.SIG_L * (2.0 * np.pi) ** 0.5)  # noqa: E731
    steps = cs.PARALLEL_STEPS
    mesh = pmesh.make_mesh(device=dev)
    try:
        sharded = lambda: sh.run_active_loop_fleet_sharded(st, opts, lik, g, steps, mesh, record_moments=False)  # noqa: E731
        profile_piece("parallel_loop", sharded, iters, out, profiles)
        profile_piece("parallel_loop_unsharded",
                      lambda: batched.run_active_loop_batch(st, opts, lik, g, steps, record_moments=False),
                      iters, out, profiles)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sharded()
            torch.cuda.synchronize()
        out.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=25) + "\n")
        t = torch.zeros(cs.FLEET_B, device=dev)
        parts = [torch.empty_like(t)]
        group = mesh.get_group(pmesh.AXIS_GRID)

        def us(fn, n=200):
            """(host µs to enqueue one call, µs per call until the device is done) over n calls."""
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            return 1e6 * (t1 - t0) / n, 1e6 * (time.perf_counter() - t0) / n

        res = dict(piece="parallel_collectives", backend=dist.get_backend(),
                   all_reduce_us=us(lambda: dist.all_reduce(t, group=group)),
                   all_gather_us=us(lambda: dist.all_gather(parts, t, group=group)),
                   elementwise_add_us=us(lambda: t.add_(0.0)))
        out.write(json.dumps(res) + "\n")
        print(json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()


def profile_families(dev, iters: int, out, want, profiles: int = 1) -> None:
    """The family pieces (module docstring) on chip_smoke.py's family
    configurations."""
    import torch

    from tpubq_torch import BQFleet
    from tpubq_torch.models import marginalize as margm

    for kernel, d in cs.FAMILY_CONFIGS:
        tag = f"{kernel}_d{d}"
        if not want(f"family_step_{tag}", f"family_marginalize_{tag}", f"family_fit_{tag}"):
            continue
        x, grid = cs.family_data(d)
        grid = grid if d > 1 else grid[:, 0]
        bq = cs.family_bq(kernel, d, x, dev, "float32")
        st0 = bq.state

        def fit(bq=bq, st0=st0):
            bq._state = st0
            bq.fit_hypers(ntry=cs.FIT_RESTARTS, seed=cs.FIT_SEED)

        if tag == "matern52_d1" and want(f"family_fit_{tag}"):
            profile_piece(f"family_fit_{tag}", fit, 1, out, profiles)
        else:
            fit()
        lik = lambda xn, kernel=kernel, d=d: float(cs.family_lik(kernel, xn if d > 1 else float(xn)))  # noqa: E731
        for _ in range(3):
            xn = bq.choose_next(grid)
            bq.add_observation(xn, lik(xn))
        st = bq.state

        def step(bq=bq, st=st, grid=grid, lik=lik):
            bq._state = st
            xn = bq.choose_next(grid)
            bq.add_observation(xn, lik(xn))

        rows = torch.as_tensor(bq.sample_hypers(n=cs.FAMILY_MARG_N[d], seed=7), device=dev)
        if want(f"family_step_{tag}"):
            profile_piece(f"family_step_{tag}", step, iters, out, profiles)
        if want(f"family_marginalize_{tag}"):
            profile_piece(f"family_marginalize_{tag}", lambda st=st, bq=bq: margm.marginalize(st, bq.options, rows),
                          3, out, profiles)
    if not want("family_fleet_fit", "family_fleet_step"):
        return
    xs, ls, mus = cs.fleet_data(cs.FLEET_B, cs.FLEET_N_OBS)
    fleet = BQFleet(xs, ls, device=dev, dtype="float32", params_tl=cs.PARAMS_TL, params_l=cs.PARAMS_L,
                    n_candidate=12, candidate_thresh=0.2, max_obs=cs.FLEET_MAX_OBS, s=cs.S_MAIN,
                    kernel=cs.FAMILY_FLEET_KERNEL)
    st0 = fleet.states
    grid = np.linspace(-4.0, 4.0, cs.G)

    def fleet_fit():
        fleet._states = st0
        fleet.fit(ntry=cs.FIT_RESTARTS, seed=cs.FIT_SEED)

    if want("family_fleet_fit"):
        profile_piece("family_fleet_fit", fleet_fit, 1, out, profiles)
    else:
        fleet_fit()
    st = fleet.states

    def fleet_step():
        fleet._states = st
        xn = fleet.choose_next(grid)
        fleet.add_observation(xn, cs.fleet_lik(xn[:, 0], mus))

    if want("family_fleet_step"):
        profile_piece("family_fleet_step", fleet_step, iters, out, profiles)


def profile_single(dev, grid, iters: int, out, want, profiles: int = 1) -> None:
    """The single problem's pieces on the testbed: fit_hypers from the
    initial state, then after three active steps a step, marginalize and the
    sampler (those ``want`` keeps)."""
    import torch

    from tpubq_torch.models import marginalize as margm

    bq = cs.make_bq(cs.testbed_x(False), dev, "float32", s=cs.S_MAIN)
    st0 = bq.state

    def fit():
        bq._state = st0
        bq.fit_hypers(ntry=cs.FIT_RESTARTS, seed=cs.FIT_SEED)

    fit()  # builds the kernel library before anything is timed
    bq._state = st0
    for _ in range(3):
        xn = bq.choose_next(grid)
        bq.add_observation(xn, float(cs.f_l(xn)))
    st = bq.state
    thetas = bq.sample_hypers(n=100, seed=7)

    def step():
        bq._state = st
        xn = bq.choose_next(grid)
        bq.add_observation(xn, float(cs.f_l(xn)))

    th = torch.as_tensor(thetas, dtype=torch.float32, device=dev)
    if want("refine", "refine_n10", "health", "load_refit"):
        import tempfile

        from tpubq_torch.models import acquire
        from tpubq_torch.utils import io

        x0, _ = acquire.choose_next(st, bq.options, torch.as_tensor(grid, dtype=torch.float32, device=dev))
        if want("refine"):
            profile_piece("refine", lambda: acquire.refine_next(st, bq.options, x0), iters, out, profiles)
        if want("refine_n10"):
            profile_piece("refine_n10", lambda: acquire.refine_next(st, bq.options, x0, th[:10]), iters, out,
                          profiles)
        if want("health"):
            profile_piece("health", bq.health, iters, out, profiles)
        if want("load_refit"):
            with tempfile.TemporaryDirectory() as tmp:
                io.save_state(os.path.join(tmp, "s"), st, bq.options)
                profile_piece("load_refit", lambda: io.load_state(os.path.join(tmp, "s"), refit=True, device=dev),
                              iters, out, profiles)
    if want("fit_hypers"):
        profile_piece("fit_hypers", fit, 3, out, profiles)
    if want("step"):
        profile_piece("step", step, iters, out, profiles)
    if want("marginalize"):
        profile_piece("marginalize", lambda: margm.marginalize(st, bq.options, th), iters, out, profiles)
    if want("sampler"):
        profile_piece("sampler", lambda: bq.sample_hypers(n=20, seed=8), 2, out, profiles, count_reads=True)
    for C in (1, 4):
        if want(f"sampler_chains_c{C}"):
            profile_piece(f"sampler_chains_c{C}", lambda C=C: bq.sample_hypers(n=100, seed=9, n_chains=C), 2, out,
                          profiles, count_reads=True)
    bq._state = st


def device_ms(fn, iters: int) -> tuple:
    """(ms of device time per call, {device activity: ms per call}) over
    ``iters`` calls of ``fn`` under ``torch.profiler``: the summed durations of
    every kernel, memset and copy the calls put on the device, so that a
    kernel shorter than its wrapper's host cost is read at its own length."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = short_name(e.name)
            by[key] = by.get(key, 0.0) + (e.time_range.end - e.time_range.start) * 1e-3 / iters
    cs.check(bool(by), "the profiler saw device activity")
    return sum(by.values()), by


def kernel_cases(dev) -> list:
    """(kernel, shape, call, calls per timing) for every kernel row of
    PERF.md's table, on the inputs chip_smoke.py builds: the main path's
    shapes, the fleet's at B = 64, and the large-N path's at max_obs 1024;
    ``mll_grad`` also at (640, 32), (10, 256) and (10, 1036), and by both
    regimes at ``MLL_CROSSOVER``."""
    import torch

    from tpubq_torch.models import acquire, batched, fit as fitm
    from tpubq_torch.ops import hopper_kernels as hk

    rng = np.random.RandomState(9)
    cases = []
    bq = cs.make_bq(cs.testbed_x(False), dev, "float32", s=cs.S_MAIN)
    grid = torch.linspace(-4.0, 4.0, cs.G, device=dev)[:, None]
    small = acquire.esm_fused_inputs(bq.state, bq.options, grid)
    st, opts = cs.large_state(dev, 1024, "float32")
    big = acquire.esm_fused_inputs(st, opts, torch.linspace(-4.0, 4.0, cs.LARGE_G, device=dev)[:, None])
    cases += [("esm_fused", "G10000_NP44", lambda: hk.esm_fused(*small), 200),
              ("esm_fused", "G512_NP1036", lambda: hk.esm_fused(*big), 5)]
    for B, n, live in CHOL_SHAPES:
        Ks = cs._gram_stack(B, n, live, rng, dev)
        cases += [("chol_batch", f"{B}x{n}x{n}", lambda Ks=Ks: hk.chol_batch(Ks), 200),
                  ("chol_batch: cholesky_ex (library)", f"{B}x{n}x{n}", lambda Ks=Ks: torch.linalg.cholesky_ex(Ks), 200)]
        if n > 64:  # the other route these n could take
            cases.append(("chol_batch: cholesky_batched", f"{B}x{n}x{n}", lambda Ks=Ks: hk.cholesky_batched(Ks), 50))
        elif n > 32 and B >= 128:  # the same stack in panels of 32
            cases.append(("chol_batch (panels)", f"{B}x{n}x{n}", lambda Ks=Ks: chol_panels(Ks), 200))
    gen = torch.Generator().manual_seed(cs.FIT_SEED)
    for _, theta0, s, x, y, mask in cs.fit_problems(bq.state):
        th = torch.exp(fitm.random_restarts(gen, theta0, x, y, mask, cs.FIT_RESTARTS))
        cases.append(("mll_grad", f"{cs.FIT_RESTARTS}x{x.shape[0]}",
                      lambda th=th, s=s, x=x, y=y, mask=mask: hk.mll_grad_batched(th, s, x, y, mask, jitter=1e-7), 200))
    fleet, fopts = cs.fleet_state(dev, cs.FLEET_B, cs.FLEET_N_OBS, cs.FLEET_MAX_OBS, s=cs.S_MAIN)
    g = fleet.gp_log_l
    th = torch.exp(fitm.random_restarts(gen, g.theta[0], fleet.x_s[0], fleet.tl_s[0], fleet.obs_mask[0],
                                        cs.FIT_RESTARTS)).repeat(cs.FLEET_B, 1)
    cases.append(("mll_grad", f"{th.shape[0]}x{fleet.x_s.shape[1]}",
                  lambda: hk.mll_grad_batched(th, g.s, fleet.x_s, fleet.tl_s, fleet.obs_mask, jitter=1e-7), 100))
    for m in cs.LARGE_MLL_SHAPES:
        th_l, s_l, x_l, y_l, m_l = cs.large_mll_case(dev, m)
        cases.append(("mll_grad", f"{th_l.shape[0]}x{x_l.shape[0]}",
                      lambda th_l=th_l, s_l=s_l, x_l=x_l, y_l=y_l, m_l=m_l:
                      hk.mll_grad_batched(th_l, s_l, x_l, y_l, m_l, jitter=1e-7), 50 if m < 1024 else 10))
    for m in MLL_CROSSOVER:  # the wrapper's regime at n = m, then the tiles on the same rows
        th_c, s_c, x_c, y_c, m_c = cs.large_mll_case(dev, m)
        call = (lambda th_c=th_c, s_c=s_c, x_c=x_c, y_c=y_c, m_c=m_c:
                hk.mll_grad_batched(th_c, s_c, x_c, y_c, m_c, jitter=1e-7))
        cases += [("mll_grad", f"{th_c.shape[0]}x{m}", call, 100),
                  ("mll_grad (tiles)", f"{th_c.shape[0]}x{m}", lambda call=call: tiles_only(call), 100)]
    for n_obs, max_obs, s in FLEET_SHAPES:  # chip_smoke.py's three B = 64 fleets; (44, 32) is the path's
        st_f, o_f = (fleet, fopts) if max_obs == cs.FLEET_MAX_OBS else cs.fleet_state(dev, cs.FLEET_B, n_obs, max_obs, s=s)
        (params, w_l, *rest_l), (h2, w_tl, *rest_tl), _ = batched.fleet_scorer_inputs(st_f, o_f)
        thresh, lam = o_f.candidate_thresh, batched._LAM_F32
        cases += [("esm_fleet_l", f"B{cs.FLEET_B}_G{cs.G}_NP{o_f.max_nsc}",
                   lambda a=(params, w_l, grid, *rest_l, thresh, lam): hk.esm_fleet_l(*a), 50),
                  ("esm_fleet_tl", f"B{cs.FLEET_B}_G{cs.G}_NP2={o_f.max_obs}",
                   lambda a=(h2, w_tl, grid, *rest_tl): hk.esm_fleet_tl(*a), 50)]
    thg = torch.tensor(cs.PARAMS_L, device=dev)
    for n1, n2 in GRAM_SHAPES:
        x1 = torch.as_tensor(np.sort(rng.uniform(-2.2, 2.2, n1))[:, None], dtype=torch.float32, device=dev)
        x2 = x1 if n2 == n1 else torch.as_tensor(rng.uniform(-4.0, 4.0, (n2, 1)), dtype=torch.float32, device=dev)
        cases.append(("gaussian_gram", f"{n1}x{n2}", lambda x1=x1, x2=x2: hk.gaussian_gram(thg, x1, x2), 200))
    n = cs.LARGE_TIMING_N[0]
    for B, N in cs.LARGE_TIMING_BATCHED:
        Kb = torch.stack([cs.path_gram(rng, N, dev) for _ in range(8)]).repeat(B // 8, 1, 1).contiguous()
        cases += [("cholesky_batched", f"{B}x{N}x{N}", lambda Kb=Kb: hk.cholesky_batched(Kb), 3),
                  ("cholesky_ex (library)", f"{B}x{N}x{N}", lambda Kb=Kb: torch.linalg.cholesky_ex(Kb), 3)]
    for N in cs.LARGE_CHOL_TIMING_N:
        A = cs.path_gram(rng, N, dev)
        cases += [("cholesky_blocked", f"{N}x{N}", lambda A=A: hk.cholesky_blocked(A), 50),
                  ("cholesky_ex (library)", f"{N}x{N}", lambda A=A: torch.linalg.cholesky_ex(A), 50)]
    L = torch.linalg.cholesky(cs.path_gram(rng, n, dev)).contiguous()
    for M in (n, 1):
        R = torch.eye(n, device=dev) if M == n else torch.as_tensor(rng.randn(n, M), dtype=torch.float32, device=dev)
        cases += [("tri_solve_blocked", f"{n}x{n}_x_{M}", lambda R=R: hk.tri_solve_blocked(L, R), 20),
                  ("solve_triangular (library)", f"{n}x{n}_x_{M}",
                   lambda R=R: torch.linalg.solve_triangular(L, R, upper=False), 20)]
    return cases


#: ``chol_batch``'s stacks (B, n, live rows): marginalize(100) at max_obs 32,
#: the fleet's two-rung refits at B = 64 (log-GP 32 rows, linear GP 44),
#: small batched refits, marginalize at max_obs 128, and (200, 140) and the
#: card tests' (256, 80), where the panels were held against the
#: ``cholesky_batched`` route; the slice sampler's stacks of R = 1, 4, 64 and
#: 256 rows (a step-out evaluates 2R) at n = 32 (θ_tl) and 44 (the joint
#: density's linear GP), and the fleet marginalize's (12,800, n), both rungs
#: of 64 problems × 100 rows.
CHOL_SHAPES = ((200, 32, 21), (128, 32, 21), (128, 44, 33), (2, 32, 21), (4, 32, 21), (8, 32, 21),
               (2, 44, 33), (4, 44, 33), (8, 44, 33), (200, 128, 116), (200, 140, 128), (256, 80, 61),
               (1, 32, 21), (1, 44, 33), (64, 32, 21), (64, 44, 33), (256, 32, 21), (256, 44, 33),
               (12800, 32, 21), (12800, 44, 33))

#: ``gaussian_gram`` (n1, n2) at d = 1: the linear GP's Gram at max_obs 1024,
#: its column against one point, and 44 rows against a 10⁴-point grid.
GRAM_SHAPES = ((1036, 1036), (1036, 1), (44, 10_000))

#: The fleets of chip_smoke.py's ``check_fleet_kernels`` at B = 64 (n_obs,
#: max_obs, s): (NP, NP2) = (28, 16), (44, 32) — the fleet path's — and (60, 48).
FLEET_SHAPES = ((10, 16, 0.0), (cs.FLEET_N_OBS, cs.FLEET_MAX_OBS, cs.S_MAIN), (8, 48, 0.0))

#: ``mll_grad`` by the wrapper's regime and by the tiles at these n
#: (--kernels): where the one-block kernel gives way to the tiles. Run with
#: ``--root`` on a version whose one-block regime reaches 128 rows to see it
#: against the tiles at 96 and 128.
MLL_CROSSOVER = (64, 96, 128)


def chol_panels(Ks):
    """``chol_batch`` of the stack Ks in panels of 32 columns whatever its n,
    through the C entry's panels_only argument (32 < n ≤ 64 would take the
    warp kernel); a version whose entry has no such argument reports
    ValueError."""
    import torch

    from tpubq_torch.ops import _build

    if len(_build._SIG["tpubq_chol_batch"][0]) != 6:
        raise ValueError("this version has no panels_only")
    B, n, _ = Ks.shape
    L = torch.empty_like(Ks)
    err = _build.library().tpubq_chol_batch(Ks.data_ptr(), L.data_ptr(), B, n, 1,
                                            torch.cuda.current_stream(Ks.device).cuda_stream)
    cs.check(err == 0, f"chol_batch in panels launched at {(B, n)}")
    return L


def device_context_us(dev, reps: int = 20_000, turns: int = 5) -> dict:
    """Host µs per entry and exit of the device context around a launch, in
    ``turns`` alternating turns of ``reps`` each: ``torch.cuda.device`` on the
    tensor's device, ``hk._device_of`` where the version has it (a no-op when
    that card is current), and an empty context as the loop's own cost."""
    import contextlib
    import time

    import torch

    from tpubq_torch.ops import hopper_kernels as hk

    t = torch.zeros(4, device=dev)
    ways = {"nullcontext": contextlib.nullcontext, "torch.cuda.device": lambda: torch.cuda.device(t.device)}
    if hasattr(hk, "_device_of"):
        ways["_device_of"] = lambda: hk._device_of(t)
    res = {k: [] for k in ways}
    for _ in range(turns):
        for k, ctx in ways.items():
            t0 = time.perf_counter()
            for _ in range(reps):
                with ctx():
                    pass
            res[k].append((time.perf_counter() - t0) / reps * 1e6)
    return {f"{k}_us_turns": v for k, v in res.items()}


def tiles_only(fn):
    """``fn()`` with ``mll_grad``'s one-block regime switched off, so that
    every n goes to the tiles; a version without tiles reports ValueError."""
    from tpubq_torch.ops import hopper_kernels as hk

    if not hasattr(hk, "_MLL_SMALL_N"):
        raise ValueError("this version has no tiled regime")
    keep, hk._MLL_SMALL_N = hk._MLL_SMALL_N, 0
    try:
        return fn()
    finally:
        hk._MLL_SMALL_N = keep


def kernel_times(dev, label: str, only: str | None = None) -> None:
    """One JSON line per kernel and shape (``kernel_cases``; with ``only``,
    the kernels whose name starts with it): CUDA-event ms per call over a loop
    of wrapper calls, in two turns (what chip_smoke.py reports, the host's
    pace where a kernel is shorter than its wrapper), and the device ms per
    call under ``torch.profiler`` (``device_ms``). A shape this version of the
    package does not take is reported as such."""
    if not only or "device_context".startswith(tuple(only.split(","))):
        print(json.dumps({"kernel": "device_context", "card": label, **device_context_us(dev)}), flush=True)
    for kernel, shape, fn, it in kernel_cases(dev):
        if only and not kernel.startswith(tuple(only.split(","))):
            continue
        try:
            turns = [cs.cuda_ms(fn, it) for _ in range(2)]
        except ValueError as e:
            print(json.dumps({"kernel": kernel, "shape": shape, "card": label, "unsupported": str(e)}), flush=True)
            continue
        dms, by = device_ms(fn, it)
        print(json.dumps({"kernel": kernel, "shape": shape, "card": label, "event_ms_turns": turns,
                          "event_ms": min(turns), "device_ms": dms, "device_ms_by_activity": by}), flush=True)


def profile_large_fit(dev, out, profiles: int = 1) -> None:
    """``BQ.fit_hypers`` at max_obs 1024 on the large-N recipe, from its
    initial state: the fused Adam route over the tiles, or in a version that
    caps ``mll_grad`` the L-BFGS over autograd."""
    bq = cs.large_bq(dev, "float32")
    st0 = bq.state

    def fit():
        bq._state = st0
        bq.fit_hypers(ntry=cs.FIT_RESTARTS, seed=cs.FIT_SEED)

    profile_piece("large_fit_hypers", fit, 1, out, profiles)


def profile_large_n(dev, iters: int, out, profiles: int = 1) -> None:
    import torch

    from tpubq_torch.models import acquire, incremental as inc, marginalize as margm

    st, opts = cs.large_state(dev, 1024, "float32")
    grid = torch.linspace(-4.0, 4.0, cs.LARGE_G, device=dev)[:, None]
    x_mid = float(st.x_s[512, 0] + st.x_s[513, 0]) / 2.0
    l_mid = float(cs.large_lik(x_mid))

    def step(add):
        acquire.choose_next(st, opts, grid)
        add(st, opts, [x_mid], l_mid)

    profile_piece("large_refit_step", lambda: step(acquire.add_observation), iters, out, profiles)
    profile_piece("large_fast_step", lambda: step(inc.add_observation_fast), iters, out, profiles)
    thetas = torch.as_tensor(np.exp(np.log(cs.PARAMS_TL) + 0.15 * np.random.RandomState(12).randn(cs.LARGE_MARG_N, 2)),
                             dtype=torch.float32, device=dev)
    profile_piece("large_marginalize", lambda: margm.marginalize(st, opts, thetas), 3, out, profiles)


def profile_fleet(dev, grid, iters: int, out, want, profiles: int = 1) -> None:
    import torch

    from tpubq_torch import BQFleet
    from tpubq_torch.models import batched

    xs, ls, mus = cs.fleet_data(cs.FLEET_B, cs.FLEET_N_OBS)
    fleet = BQFleet(xs, ls, device=dev, dtype="float32", params_tl=cs.PARAMS_TL, params_l=cs.PARAMS_L,
                    n_candidate=12, candidate_thresh=0.2, max_obs=cs.FLEET_MAX_OBS, s=cs.S_MAIN)
    st0 = fleet.states
    if want("fleet_sampler"):
        profile_piece("fleet_sampler", lambda: fleet.sample_hypers(n=100, seed=9), 2, out, profiles,
                      count_reads=True)
    if want("fleet_marginalize"):
        rows = torch.as_tensor(fleet.sample_hypers(n=100, seed=10), device=dev)
        profile_piece("fleet_marginalize", lambda: batched.marginalize_batch(st0, fleet.options, rows), iters,
                      out, profiles)
    if want("fleet_choose_marg"):
        profile_piece("fleet_choose_marg", lambda: fleet.choose_next(grid, n=10, seed=11), 3, out, profiles,
                      count_reads=True)
    if not want("fleet_fit", "fleet_step"):
        return

    def fit():
        fleet._states = st0
        fleet.fit(ntry=cs.FIT_RESTARTS, seed=cs.FIT_SEED)

    if want("fleet_fit"):
        profile_piece("fleet_fit", fit, 3, out, profiles)
    else:
        fit()
    for _ in range(3):
        xn = fleet.choose_next(grid)
        fleet.add_observation(xn, cs.fleet_lik(xn[:, 0], mus))
    st = fleet.states

    def step():
        fleet._states = st
        xn = fleet.choose_next(grid)
        fleet.add_observation(xn, cs.fleet_lik(xn[:, 0], mus))

    if want("fleet_step"):
        profile_piece("fleet_step", step, iters, out, profiles)


if __name__ == "__main__":
    raise SystemExit(main())
