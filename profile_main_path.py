#!/usr/bin/env python3
"""Where the time of the port's float32 main path goes on one CUDA card.

Run from the repository root on a machine with a CUDA card:

    python3 profile_main_path.py [--out profile_main_path.txt] [--root DIR] [--kernels]

Pieces, on the testbed of chip_smoke.py (s = 0.01, max_obs 32, a
10,000-point grid, three active steps taken first):

* ``fit_hypers`` — the multi-restart hyperparameter fit of both GPs (10
  restarts × 150 Adam steps over the mll_grad kernel), from the initial state;
* ``step``       — one choose_next over the grid plus one add_observation;
* ``marginalize`` — marginalize over 100 given θ_tl samples;
* ``sampler``    — sample_hypers(n=20), the slice sampler alone;
* ``fleet_fit``  — ``BQFleet.fit`` of 64 problems (64 × 10 restart rows per
  mll_grad launch), from the initial fleet state;
* ``fleet_step`` — one ``BQFleet.choose_next`` over the grid plus one
  ``add_observation`` at B = 64 (the fleet of chip_smoke.py, after the fit and
  three steps);
* ``large_refit_step`` / ``large_fast_step`` — at max_obs 1024 (chip_smoke.py's
  large-N recipe, 1,012 observations, s = 0.05, a 512-point grid): one
  choose_next plus one add at an interior point between two observations, by
  the full refit or by a fast incremental step (``add_observation_fast``);
* ``large_marginalize`` — marginalize over 100 given θ_tl rows at max_obs
  1024 (the (200, 1024, 1024) rung stack on cholesky_batched).

For each piece it prints one JSON line: the host-clock wall time without the
profiler (mean of ``--iters`` calls, each ending in a synchronize), the device
busy time under ``torch.profiler`` (the union of the kernels' intervals on the
device timeline), the idle share 1 − busy / wall, and the kernel count. The
per-operator tables go to ``--out``. Imports nothing from JAX.

``--kernels`` times kernels alone instead, through chip_smoke.py's timing
helpers (CUDA events, two turns each): ``cholesky_blocked`` at n ∈
``chip_smoke.LARGE_CHOL_TIMING_N`` beside ``torch.linalg.cholesky_ex``
(``chol_blocked_turns``), and ``esm_fused`` (``esm_fused_turns``) at the main
path's (G 10⁴, NP 44) and the large-N path's (G 512, NP 1036) states.
``--root DIR`` imports ``tpubq_torch`` from DIR (an unpacked parent commit,
say), so that two versions of the kernels are timed by the same code in one
call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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


def profile_piece(name: str, fn, iters: int, out) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    wall_ms = cs.host_ms(fn, iters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, n_kernels = busy_us(prof.events())
    cs.check(n_kernels > 0, f"{name}: the profiler saw device kernels")
    res = dict(piece=name, wall_ms=wall_ms, device_busy_ms=busy * 1e-3,
               idle_share=max(0.0, 1.0 - busy * 1e-3 / wall_ms), device_kernels=n_kernels)
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
        kernel_times(dev, label)
        return 0

    grid = np.linspace(-4.0, 4.0, cs.G)
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

    from tpubq_torch.models import marginalize as margm

    def step():
        bq._state = st
        xn = bq.choose_next(grid)
        bq.add_observation(xn, float(cs.f_l(xn)))

    th = torch.as_tensor(thetas, dtype=torch.float32, device=dev)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as out:
        out.write(f"{label}\n")
        profile_piece("fit_hypers", fit, 3, out)
        profile_piece("step", step, args.iters, out)
        profile_piece("marginalize", lambda: margm.marginalize(st, bq.options, th), args.iters, out)
        profile_piece("sampler", lambda: bq.sample_hypers(n=20, seed=8), 2, out)
        profile_fleet(dev, grid, args.iters, out)
        profile_large_n(dev, args.iters, out)
    bq._state = st
    return 0


def kernel_times(dev, label: str) -> None:
    """One JSON line per kernel shape: CUDA-event ms per call in two turns
    (kernel, then the library call beside it), on the inputs chip_smoke.py
    builds, timed by chip_smoke.py's own helpers."""
    import torch

    from tpubq_torch.models import acquire

    rng = np.random.RandomState(9)
    for n in cs.LARGE_CHOL_TIMING_N:
        k_ms, lib_ms = cs.chol_blocked_turns(cs.path_gram(rng, n, dev), 50)
        turns = {"cholesky_blocked": k_ms, "cholesky_ex": lib_ms}
        print(json.dumps({"kernel": "cholesky_blocked", "card": label, "n": n, "ms_turns": turns,
                          "ms": {k: min(v) for k, v in turns.items()}}), flush=True)
    st, opts = cs.large_state(dev, 1024, "float32")
    big = acquire.esm_fused_inputs(st, opts, torch.linspace(-4.0, 4.0, cs.LARGE_G, device=dev)[:, None])
    small_bq = cs.make_bq(cs.testbed_x(False), dev, "float32", s=cs.S_MAIN)
    small = acquire.esm_fused_inputs(small_bq.state, small_bq.options, torch.linspace(-4.0, 4.0, cs.G, device=dev)[:, None])
    for name, args, iters in (("G512_NP1036", big, 5), ("G10000_NP44", small, 200)):
        turns = cs.esm_fused_turns(args, iters)
        print(json.dumps({"kernel": "esm_fused", "card": label, "shape": name, "NP": args[2].shape[0],
                          "G": args[1].shape[0], "ms_turns": turns, "ms": min(turns)}), flush=True)


def profile_large_n(dev, iters: int, out) -> None:
    import torch

    from tpubq_torch.models import acquire, incremental as inc, marginalize as margm

    st, opts = cs.large_state(dev, 1024, "float32")
    grid = torch.linspace(-4.0, 4.0, cs.LARGE_G, device=dev)[:, None]
    x_mid = float(st.x_s[512, 0] + st.x_s[513, 0]) / 2.0
    l_mid = float(cs.large_lik(x_mid))

    def step(add):
        acquire.choose_next(st, opts, grid)
        add(st, opts, [x_mid], l_mid)

    profile_piece("large_refit_step", lambda: step(acquire.add_observation), iters, out)
    profile_piece("large_fast_step", lambda: step(inc.add_observation_fast), iters, out)
    thetas = torch.as_tensor(np.exp(np.log(cs.PARAMS_TL) + 0.15 * np.random.RandomState(12).randn(cs.LARGE_MARG_N, 2)),
                             dtype=torch.float32, device=dev)
    profile_piece("large_marginalize", lambda: margm.marginalize(st, opts, thetas), 3, out)


def profile_fleet(dev, grid, iters: int, out) -> None:
    from tpubq_torch import BQFleet

    xs, ls, mus = cs.fleet_data(cs.FLEET_B, cs.FLEET_N_OBS)
    fleet = BQFleet(xs, ls, device=dev, dtype="float32", params_tl=cs.PARAMS_TL, params_l=cs.PARAMS_L,
                    n_candidate=12, candidate_thresh=0.2, max_obs=cs.FLEET_MAX_OBS, s=cs.S_MAIN)
    st0 = fleet.states

    def fit():
        fleet._states = st0
        fleet.fit(ntry=cs.FIT_RESTARTS, seed=cs.FIT_SEED)

    profile_piece("fleet_fit", fit, 3, out)
    for _ in range(3):
        xn = fleet.choose_next(grid)
        fleet.add_observation(xn, cs.fleet_lik(xn[:, 0], mus))
    st = fleet.states

    def step():
        fleet._states = st
        xn = fleet.choose_next(grid)
        fleet.add_observation(xn, cs.fleet_lik(xn[:, 0], mus))

    profile_piece("fleet_step", step, iters, out)


if __name__ == "__main__":
    raise SystemExit(main())
