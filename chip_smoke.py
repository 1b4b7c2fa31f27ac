#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (tpubq_torch) on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero
before the final line):

0. device   — require CUDA; print the card's name and power limit
              (nvidia-smi); require full-float32 matmuls (no TF32).
1. build    — compile the hand-written kernels (one nvcc per source in
              tpubq_torch/csrc, all at once) for sm_90a; print the build
              seconds and ptxas' report.
2. kernels  — each kernel against its plain PyTorch twin on the card, at the
              main paths' shapes and the ones around them (chol_batch at
              the paths' stacks and the edges of its regimes), with stated
              tolerances (the fleet kernels up to the route's 220 rows and
              on a ragged grid); the fleet scorer and the plain batched float32
              scorer against float64 at 28, 60 and 126 rows per problem; the
              large-N kernels (gaussian_gram, cholesky_blocked,
              tri_solve_blocked, cholesky_batched) at n = 44, 128, 300 and
              1036, NaN confinement (a bad pivot past the first panel and
              in the last one) and the solve's determinism included; and
              mll_grad's tiles at (10, 256) and (10, 1036) on the large-N
              recipe's states.
3. main     — the f32 BQ path through the BQ facade on the card: init →
              fit_hypers (10 restarts × 150 Adam steps over the mll_grad
              kernel, both GPs) → Z moments → 10 × (choose_next over 10,000
              points → add_observation) → choose_next(n=10) →
              marginalize(n=100), checked against the port's own float64 CPU
              path on the same data, hypers and hyper samples; every kernel's
              launch counter (gaussian_gram's included) must grow, mll_grad's
              by exactly 2·(n_iter + 1).
4. fleet    — the f32 fleet through the BQFleet facade on the card at full
              width: 64 problems, a shared grid of 10,000 points, fit (all
              64 × 10 restart rows in one mll_grad launch per Adam step) →
              Z moments → 10 × (choose_next → add_observation), checked per
              problem against the port's float64 CPU fleet and, for 4 of the
              problems, against single BQs on the card; esm_fleet_l and
              esm_fleet_tl must launch exactly once per choose_next, esm_fused
              never, mll_grad exactly 2·(n_iter + 1) times for the whole fleet.
4b. marg   — hyper-marginalization on the card: the single testbed's
              BQ.sample_hypers(n=100) with 1 and 4 chains and with the joint
              params (h, w, h_l, w_l), marginalize on θ_tl and on joint rows
              the float64 CPU port drew (held to its float64 estimates),
              BQ.marginalize, choose_next(grid, n=10) (held like the main
              path's picks); the fleet of phase 4 at its initial hypers:
              BQFleet.sample_hypers(n=100), marginalize on the rows of the
              float64 fleet (on the card since PR 11; held to its
              estimates), BQFleet.marginalize,
              choose_next(grid, n=10) (the fleet kernels on the flattened
              fleet of 64 × 10 re-anchored states held to their plain
              versions, the picks to float64 by the fleet path's rule) and
              run_active_loop(n=10) for 3 steps; the sampler's host reads
              (at most one per lock-step iteration) and the exact launches
              of chol_batch, esm_fused and the fleet kernels per call.
4c. families — the four other kernel families through the BQ facade on the
              card in float32 at max_obs 32: matern52, matern32, rq and
              periodic at d = 1 and matern52 at d = 2 (the mixture route),
              each init → fit_hypers (10 restarts) → Z moments → 10 ×
              (choose_next over 10⁴ points, 100 × 100 in 2-D →
              add_observation) → marginalize (100 rows, 20 in 2-D), held to
              the port's float64 path on the card with the card's hypers,
              picks and the float64 sampler's rows (and one pick at the init
              hypers, before the fit, where float32 resolves points for
              every family: the fitted periodic kernel leaves it none, so
              its later picks are the plateau's); then a Matérn-5/2 fleet
              at B = 64: fit → Z → 3 steps, held the same way per problem.
              Each prints its routes, the launches of cholesky_blocked,
              tri_solve_blocked and chol_batch per call kind, the walls of
              the fit, a step and marginalize, and its resolution warnings.
4d. facade — the serving surface on the card: the testbed's float32 BQ
              (max_obs 32) after fit_hypers → choose_next over 10⁴ points
              with refine=True, with no hyper rows and with n = 10 (the
              refined point's float64 ESM, on the port's CPU path with the
              same data, hypers and rows, at least the grid pick's less the
              pick allowance; the refined float32 value at least the start)
              → health() (flags and jitters equal to float64's, cond within
              2×, the clamped share of V[Z] ≤ 1e-3, the report renders) →
              save_state → load_state (moments, scores and pick
              bit-identical; the file also through utils.convert) and
              BQ.save → BQ.load (a refit, within §2's limits) → the next
              choose_next; the large-N recipe's max_obs 1024 state saved and
              reloaded with a refit (exact launches of gaussian_gram,
              cholesky_blocked and tri_solve_blocked; E[Z], V[Z] within the
              large-N limits); a BQFleet at B = 64: fit → choose_next →
              health() ((64,) leaves, 4 rows equal to single BQs' health) →
              save → load (bit-identical moments and picks, the seed) and
              load(refit=True) (one chol_batch launch per GP); the GP
              facade's float32 fit on the card (its exact launches, held to
              float64); then host times of save, load, load(refit=True),
              health and refine (utils.profiling.time_fn) and one
              utils.profiling.trace.
4e. parallel — tpubq_torch.parallel on a (1, 1) mesh of the card (NCCL,
              a world of one process): choose_next_sharded over 10⁴ points
              on the testbed at its initial hypers, directly and with 10 of
              the main path's hyper rows, marginalize_sharded on all 100; on a B = 64 fleet (the
              fleet path's recipe, max_obs 32) fleet_choose_next_sharded,
              fleet_Z_moments_sharded and 10 steps of
              run_active_loop_fleet_sharded. Each result bit-identical to the
              unsharded port's on the same inputs (choose_next, marginalize,
              choose_next_batch, the batched moments, run_active_loop_batch);
              exact launches per call (esm_fused once per direct choose and
              per hyper row, esm_fleet_l / esm_fleet_tl once per fleet choose
              or step, the others as the unsharded call's); picks and
              moments held to float64 by the main and fleet paths' rules;
              the host ms of sharded and unsharded fleet loops of 1 and 10
              steps. Two or
              more ranks need a card each: NCCL refuses two on one device.
4f. oracle — the port held to the C++ oracle (native/bq_native.cpp, built
              with the host's g++ by tpubq_torch.utils.native: on this
              machine, without JAX, the one reference that is not port code)
              and to the quadrature twins: the testbed at s = 0 (the oracle's
              κ = h²), its initial state and the states after each of 5
              active steps, scored over 10⁴ points by
              expected_squared_mean_fused (float32, one esm_fused call a
              state, its launches exact) and by the float64 path on the
              card, each held to native.esm_grid on the points the oracle
              and the port's guard both resolve (float64 at 1e-8, float32 at
              1e-3 of the largest oracle score, the float32 pick by the main
              path's rule); the float64 closed forms on the card against the
              oracle on the testbed's observations and on 1,024 seeded points
              (gaussian 1e-12, periodic at tests/test_native.py's
              tolerances); the closed forms of all five families against
              their trapezoid twins on the card, at the JAX suite's grids
              and tolerances.
5. large N  — the large-max_obs path (benchmarks/large_n.py's recipe) at
              max_obs 128, 256, 512 and 1024: init_state → Z moments →
              run_active_loop (8 steps, incremental False, True, "auto") →
              marginalize(100 θ_tl rows), plus one refit, one fast and one
              refresh step; exact launch counts per step kind; each loop held
              to the port's float64 CPU path on its own picks, "auto" to the
              mode it resolves to; esm_fused held to its twin on the states
              the max_obs 1024 refit loop scored. Then which scorer each
              state size takes (max_obs 32, 1024, 2048: esm_fused at every
              size), card against CPU; and esm_fused against its twin on the
              recipe's max_obs 2048 state (NP 2060), with the float64 γ of
              every point where the two differ. Then BQ.fit_hypers at max_obs
              1024 on the recipe through the fused route (the tiles), with
              its exact launch count, timed once, its MLL gain and E[Z] / V[Z]
              held to the float64 CPU path with the card's hypers.
6. s = 0    — printed, not gated: how many active steps the float32 log-GP
              Gram survives at s = 0 before rung 0 of the jitter ladder fails,
              with fixed hypers, after one fit, and with a refit every step.
7. timing   — CUDA-event times of each kernel, its plain twin and the library
              call or nearest plain route beside it, and host-clock times of
              fit_hypers, add_observation, marginalize and the fleet's calls
              at B = 1, 8 and 64; esm_fused and mll_grad at the large-N
              path's shapes; cholesky_blocked at n = 32 … 1036 beside
              cholesky_ex; the refit / incremental
              sweep (ms per step at max_obs 64 … 1024) that
              INCREMENTAL_AUTO_WINDOW is read from; mll_grad at the
              benchmark fleet's fit shapes (1,024 problems × 10 rows at
              n = 32 and 44), and on a fleet grown to 8, 20 and 40
              observations a problem in turn (n = 52 and 64, rows of
              every NP class in one launch): the NP each row ran at
              (sizes_out), event and device ms beside the bound of the live
              work, and the plain twin's agreement.

Then the kernel summary line (each kernel with its launches on the main,
marginalize, family, facade, parallel and oracle paths), the nvidia-smi line, and the final
{"ok": true, ...} line. Imports nothing from JAX or the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Testbed of tests/util.py: ℓ(x) = N(x; 0.2, 0.5²) under N(0, 1); true Z = N(0.2; 0, 1.25).
MU_L, SIG_L = 0.2, 0.5
BQ_KW = dict(n_candidate=12, candidate_thresh=0.2, x_mean=0.0, x_var=1.0)
PARAMS_TL, PARAMS_L = (0.7, 0.8), (0.3, 0.4)
G = 10_000
# Observation noise of the main path. At s = 0 and these fixed hypers the
# log-GP Gram turns singular to float32 after ~8 active steps (λ_min/λ_max =
# 4e-9 at 18 points), where every f32 Cholesky returns rounding noise and the
# 1e-4 rescue rung inflates V[Z] to its jitter level; s = 0.01 keeps
# λ_min ≥ s² = 1e-4 and the f32 estimate comparable with f64 along the loop.
# The s = 0 near-singular regime is exercised by the kernel phase.
S_MAIN = 0.01

# Tolerances (kernel vs plain twin, on the same card and inputs).
ESM_NORM_TOL = 1e-4     # max|Δ| / max|plain| where both mark the same points degenerate:
                        # f32 sums in another order, expf vs torch.exp
# Degenerate-mask flips between kernel and twin (two float32 sums of γ in
# another order), each required to sit within float32's noise of the guard's
# threshold; none seen on the states checked here.
MAX_FLIPS = 2
CHOL_NORM_TOL = 1e-4      # max|Δ| / max|plain|, or twice the library's own distance
CHOL_BACKWARD_TOL = 1e-5  # max|L Lᵀ − K| / max|K|: ~n·eps32 for a backward-stable Cholesky
# mll_grad against its plain twin, per (h, w) row: |ΔMLL| / |MLL| and
# max|Δgrad| / max|grad|. The two run the same float32 arithmetic with other
# roundings (fused multiply-adds, expf, summation order), which the Gram's
# condition number κ amplifies to O(eps32·κ); so a row passes at the fixed
# tolerance or at MLL_COND_FACTOR·eps32·κ, whichever is larger, with κ the
# condition number of the row's live Gram taken in float64. At the large-N
# shapes (n = 256, 1036) the gradient's n² terms cancel and the twin's own
# gradient sits up to ~20·eps32·κ from float64 (n = 1036, PERF.md §6), so
# there the kernel's gradient is held to float64 at that rule instead.
MLL_RTOL, MLL_GRAD_NORM_TOL, MLL_COND_FACTOR = 1e-4, 1e-3, 4.0
# The fleet fit's rows (64 problems × 10 restarts per GP): 1,280 random rows
# reach further into the tail of eps32·κ than the 20 of a single fit, and some
# cross MLL = 0, so their factor is larger and |MLL| is floored at the live
# count (the size of the terms the MLL sums).
MLL_FLEET_COND_FACTOR = 16.0
# mll_grad against float64 autograd at well-conditioned thetas: the JAX
# suite's pin for the TPU kernel (tests/test_pallas.py).
MLL_PIN = dict(mll_rtol=5e-4, grad_rtol=5e-3, grad_atol=1e-3)
FIT_SEED, FIT_RESTARTS, FIT_ITERS = 11, 10, 150
# The fused float32 fit against the port's float64 L-BFGS fit from the same
# restart rows, in nats of MLL (both evaluated in float64): Adam still circles
# the optimum at step 150, and 0.05 nats moves E[Z] by less than 1e-4.
FIT_MLL_MARGIN = 0.05
FIT_Z_RTOL = 5e-3  # E[Z] after the fit against the closed form (tests/test_fit.py)
# Main path, f32 card vs f64 CPU (the port's own reference path).
ZMEAN_RTOL, ZVAR_RTOL = 1e-4, 5e-2
MARG_MEAN_RTOL = 1e-3
ESM_ARGMAX_RTOL = 1e-5  # or twice the f32 scorer's own error on the step, if larger
# float32 ESM scores against float64 on the points both dtypes' guards resolve,
# relative to the largest float64 score (tests/test_torch_gpu.py's family pin)
ESM_SCORE_RTOL = 1e-3

# The fleet: 64 problems of benchmarks/fleet_esm.py's recipe on one shared grid.
FLEET_B, FLEET_N_OBS, FLEET_MAX_OBS, FLEET_STEPS = 64, 8, 32, 10
# The benchmark's fleet (port_bench/configs/fleet_b1024.json): its fit calls
# mll_grad on FIT_RESTARTS rows of each of 1,024 problems.
FLEET_FIT_B = 1024
# A fleet grown by the active loop: its problems hold GROWN_OBS observations
# in turn at max_obs GROWN_MAX_OBS, so that its fit's calls hold rows of
# every NP class of mll_grad's one-launch regime.
GROWN_MAX_OBS, GROWN_OBS = 52, (8, 20, 40)
FLEET_SINGLES = (0, 21, 42, 63)  # problems replayed as single BQs on the card
FLEET_SINGLE_Z_RTOL = 1e-5
# A fleet kernel against its plain version, per problem and per output (A, B,
# m_a, c_a and the combined score): max|Δ| / max|plain| ≤ FLEET_NORM_TOL, or
# twice the plain version's own distance (the largest over the case's
# problems) to its float64 evaluation on the same float32 inputs where that is
# larger. Near the guard's threshold the Schur
# complement keeps only a few bits, so B = (ζ − uzᵀk)/γ of two float32
# evaluations differs by what either differs from float64. Points where the
# two disagree on the degenerate mask are flips: at most MAX_FLEET_FLIPS per
# case, each with γ within the guard's own noise bound λ·kᵀ|K⁻¹|k of the
# threshold (float64 on the same inputs).
FLEET_NORM_TOL = 1e-4
MAX_FLEET_FLIPS = 6
FLEET_RAGGED = 37  # points past G in the ragged-grid case: the kernels' last block of 128 is cut


_T0 = time.perf_counter()


def emit(phase: str, **kv) -> None:
    """One JSON line per phase; ``t_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, "t_s": round(time.perf_counter() - _T0, 2), **kv}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def f_l(x):
    x = np.asarray(x, np.float64)
    return np.exp(-0.5 * ((x - MU_L) / SIG_L) ** 2) / (SIG_L * math.sqrt(2.0 * math.pi))


def true_Z() -> float:
    v = 1.0 + SIG_L**2
    return math.exp(-0.5 * MU_L**2 / v) / math.sqrt(2.0 * math.pi * v)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, host clock, ending each call in a synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def short_name(name: str) -> str:
    """A device activity's name without its return type, namespace and arguments."""
    return name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0][:60]


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
    check(bool(by), "the profiler saw device activity")
    return sum(by.values()), by


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and
# the float32 rate outside the tensor cores.
PEAK_BYTES_PER_S, PEAK_F32_FLOPS = 3.35e12, 67e12


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def chol_batch_bytes(B: int, n: int) -> int:
    """Bytes ``chol_batch`` must move: the lower triangle of each input read
    once (the contract reads no more), each n × n factor written once."""
    return 4 * B * (n * (n + 1) // 2 + n * n)


def make_bq(x, device, dtype, max_obs=32, n_candidate=12, s=0.0):
    from tpubq_torch import BQ

    kw = {**BQ_KW, "n_candidate": n_candidate}
    bq = BQ(x, f_l(x), device=device, dtype=dtype, max_obs=max_obs, s=s, **kw)
    return bq.init(params_tl=PARAMS_TL, params_l=PARAMS_L)


def testbed_x(near_duplicate: bool):
    x = np.linspace(-2.2, 2.2, 10)
    return np.sort(np.concatenate([x, [0.2 + 1e-4]])) if near_duplicate else x


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain twins
# ---------------------------------------------------------------------------


def flip_margins(args, idx, noise_mult_adaptive: float) -> dict:
    """Where ``esm_fused`` and its twin disagree on the degenerate mask, how
    close each point's γ = κ − kᵀK⁻¹k sits to the guard's threshold.

    γ and Σk are recomputed in float64 from the packed float32 inputs at the
    grid points ``idx``. ``thr`` is the threshold the launch used,
    max(eps32·κ, noise_mult·Σk); ``noise`` is the adaptive guard's bound on
    float32's error in γ, λ·ρ·κ·Σk (``noise_mult_adaptive``·Σk). A flip is one
    rounding may decide iff |γ − thr| ≤ noise.
    """
    import torch

    params, grid, xsc, msc, Kinv = (a.double() for a in args[:5])
    d = xsc.shape[1]
    h_l2, kappa, wl = params[0], params[1], params[8:8 + d]
    noise_mult = params[8 + 3 * d + d * d]
    r2 = (((xsc[:, None, :] - grid[idx][None]) ** 2) * wl).sum(-1)
    k = h_l2 * torch.exp(-r2) * msc[:, None]
    gam = kappa - (k * (Kinv @ k)).sum(0)
    thr = torch.clamp(noise_mult * k.sum(0), min=torch.finfo(torch.float32).eps * kappa.item())
    noise = noise_mult_adaptive * k.sum(0)
    return dict(gamma_over_thr=(gam / thr).tolist(), noise_over_thr=(noise / thr).tolist(),
                within_noise=bool(((gam - thr).abs() <= noise).all()))


def esm_vs_plain(args, guard: str, max_flips: int, **label) -> dict:
    """Launch ``esm_fused`` and its plain twin on the same packed inputs and
    hold the kernel to the twin: finite, and within ESM_NORM_TOL of the
    largest score everywhere except at most ``max_flips`` points. Each such
    point must be a degenerate-mask flip (one side returned the degenerate
    value (zᵀα)², the other did not) whose γ sits within float32's noise of
    the guard's threshold, where two float32 sums of γ in another order may
    fall on either side.

    ``guard`` "adaptive" is the production guard the inputs carry; "tpu"
    zeroes noise_mult, which is the TPU kernel's own γ ≤ eps·κ.
    """
    import torch

    from tpubq_torch.ops import hopper_kernels as hk

    nm_adaptive = args[0][-1].item()
    if guard == "tpu":
        args = list(args)
        args[0] = args[0].clone()
        args[0][-1] = 0.0
    out = hk.esm_fused(*args)
    torch.cuda.synchronize()
    ref = hk.esm_fused_plain(*args)
    zta2 = (args[0][5] * args[0][5]).item()
    diff = (out - ref).abs()
    scale = ref.abs().max().item()
    off = diff > ESM_NORM_TOL * scale
    flip = off & ((out == zta2) != (ref == zta2))
    off_idx = torch.nonzero(off)[:, 0]
    err = diff[~off].max().item()
    case = dict(**label, guard=guard, NP=args[2].shape[0], NP2=args[7].shape[0], max_abs_err=err,
                norm_err=err / scale, at_plateau=int((ref == zta2).sum()),
                degenerate_flips=len(off_idx), flips=flip_margins(args, off_idx, nm_adaptive))
    check(bool(torch.isfinite(out).all()), f"esm_fused output finite ({case})")
    check(bool((flip == off).all()) and len(off_idx) <= max_flips and case["flips"]["within_noise"],
          f"esm_fused differs from the plain twin only at degenerate-mask flips at the threshold ({case})")
    check(case["norm_err"] <= ESM_NORM_TOL, f"esm_fused within {ESM_NORM_TOL} of plain ({case})")
    return case


def check_esm(dev) -> dict:
    import torch

    from tpubq_torch.models import acquire

    grid = torch.linspace(-4.0, 4.0, G, device=dev)[:, None]
    cases = []
    # (NP, NP2) = (28, 16), (44, 32) — the main path's —, (48, 32) and (80, 64)
    for max_obs, n_cand in ((16, 12), (32, 12), (32, 16), (64, 16)):
        for near_dup in (False, True):
            bq = make_bq(testbed_x(near_dup), dev, "float32", max_obs=max_obs, n_candidate=n_cand)
            args = acquire.esm_fused_inputs(bq.state, bq.options, grid)
            # On these fresh states the production guard marks exactly the
            # twin's points; the TPU's own guard admits points whose γ is
            # rounding noise, where the two may disagree.
            cases.append(esm_vs_plain(args, "adaptive", 0, near_duplicate_s0=near_dup))
            cases.append(esm_vs_plain(args, "tpu", MAX_FLIPS, near_duplicate_s0=near_dup))
    emit("kernels_esm", G=G, tol_norm=ESM_NORM_TOL, max_flips=MAX_FLIPS, cases=cases)
    return {"max_abs_err": max(c["max_abs_err"] for c in cases)}


def _gram_stack(B, n, live, rng, dev, rung=1e-4):
    """(B, n, n) identity-padded gaussian Grams over ``live`` points with
    random hypers, at the f32 ladder's 1e-4 rung (the matrices chol_batch
    factors under marginalize)."""
    import torch

    from tpubq_torch.ops import kernels, linalg

    x = torch.as_tensor(np.sort(rng.uniform(-2.2, 2.2, (B, n, 1)), axis=1), dtype=torch.float32, device=dev)
    th = torch.as_tensor(np.exp(np.log([0.7, 0.8]) + 0.3 * rng.randn(B, 2)), dtype=torch.float32, device=dev)
    mask = torch.arange(n, device=dev) < live
    K = linalg.pad_gram(kernels.gaussian_K(th, x, x), mask)
    scale = linalg._diag_scale(K, mask)
    return K + torch.eye(n, device=dev) * (rung * scale)[:, None, None] * mask.float()


#: chol_batch's stacks on the paths (B, n, live rows): marginalize(100) at
#: max_obs 32, the fleet's two-rung refits at B = 64 (log-GP 32 rows, linear
#: GP 44), marginalize at max_obs 128, the card tests' (256, 80), and the
#: fleet's marginalize at B = 64 over 100 rows (both rungs: 12,800 matrices).
CHOL_PATH_SHAPES = ((200, 32, 21), (200, 44, 33), (128, 32, 21), (128, 44, 33), (200, 128, 116), (256, 80, 61),
                    (12800, 32, 21), (12800, 44, 33))
#: ... and at the edges of its regimes (picked by csrc/chol_batch.cu) and of
#: its padded row stride in shared memory (238, the last n it pads).
CHOL_EDGE_SHAPES = tuple((8, n, max(1, 3 * n // 4)) for n in (1, 15, 16, 17, 31, 33, 48, 49, 63, 64, 65, 140, 200, 238, 240))


def check_chol(dev) -> dict:
    """The kernel against its plain twin on the Grams marginalize factors.

    These are f32 Grams at the 1e-4 rescue rung, with condition numbers up to
    ~1e5, where any two f32 Cholesky implementations differ by ~eps32 × cond
    in the trailing pivots. So the kernel is held (a) to a backward error
    max|L Lᵀ − K| / max|K| ≤ CHOL_BACKWARD_TOL, and (b) to the plain twin
    within max(CHOL_NORM_TOL, 2 × the library's own distance to the twin).
    """
    import torch

    from tpubq_torch.ops import hopper_kernels as hk

    def norm_diff(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    rng = np.random.RandomState(0)
    cases, worst = [], 0.0
    for B, n, live in CHOL_PATH_SHAPES + CHOL_EDGE_SHAPES:
        Ks = _gram_stack(B, n, live, rng, dev)
        L = hk.chol_batch(Ks)
        torch.cuda.synchronize()
        ref = hk.chol_batch_plain(Ks)
        lib = torch.linalg.cholesky(Ks)
        L64 = L.double()
        backward = norm_diff(L64 @ L64.transpose(1, 2), Ks.double())
        err = (L - ref).abs().max().item()
        cases.append(dict(shape=[B, n, n], max_abs_err=err, norm_err=norm_diff(L, ref),
                          library_norm_err=norm_diff(lib, ref), backward_err=backward))
        check(bool(torch.isfinite(L).all()), f"chol_batch finite at {(B, n)}")
        check(bool((torch.triu(L, 1) == 0).all()), "chol_batch exact zeros above the diagonal")
        check(backward <= CHOL_BACKWARD_TOL, f"chol_batch backward error ({cases[-1]})")
        check(cases[-1]["norm_err"] <= max(CHOL_NORM_TOL, 2.0 * cases[-1]["library_norm_err"]),
              f"chol_batch vs plain within the library's distance ({cases[-1]})")
        worst = max(worst, err)
    # an indefinite matrix gets NaN in its own factor only, in each regime
    # (one panel of 16 or 32 columns, a warp at 48 or 64, panels of 32)
    for n in (9, 30, 44, 60, 100):
        Ks = _gram_stack(16, n, n, rng, dev)
        Ks[5] = -Ks[5]
        L = hk.chol_batch(Ks)
        ok = torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1)).all(-1).cpu().numpy()
        check(not ok[5] and ok[np.arange(16) != 5].all(), f"chol_batch NaN confined to the indefinite matrix (n = {n})")
        check(bool((torch.triu(L, 1) == 0).all()), f"chol_batch exact zeros above the diagonal (n = {n}, with NaN)")
    emit("kernels_chol", tol_norm=CHOL_NORM_TOL, tol_backward=CHOL_BACKWARD_TOL, cases=cases,
         nan_confined=True)
    return {"max_abs_err": worst}


def fit_problems(state):
    """The two data sets ``fit_hypers`` fits, as (name, theta0, s, x, y, mask):
    the log-GP on the observations and the linear GP on observations ∪
    candidates with the pads' targets zeroed."""
    import torch

    l_sc = torch.where(state.sc_mask, state.l_sc, torch.zeros_like(state.l_sc))
    return (("log_gp", state.gp_log_l.theta, state.gp_log_l.s, state.x_s, state.tl_s, state.obs_mask),
            ("linear_gp", state.gp_l.theta, state.gp_l.s, state.x_sc, l_sc, state.sc_mask))


def _row_errs(mll, grad, mll_ref, grad_ref, mll_floor: float = 0.0):
    """Per-row (|ΔMLL| / max(|MLL_ref|, floor), max|Δgrad| / max|grad_ref|) as float64 CPU tensors."""
    import torch

    mll, grad, mll_ref, grad_ref = (t.double().cpu() for t in (mll, grad, mll_ref, grad_ref))
    return ((mll - mll_ref).abs() / torch.clamp(mll_ref.abs(), min=mll_floor),
            (grad - grad_ref).abs().amax(-1) / grad_ref.abs().amax(-1))


def mll_vs_plain(thetas, s, x, y, mask, jitter: float, cond_factor: float = MLL_COND_FACTOR,
                 mll_floor: float = 0.0, grad_vs_f64: bool = False, **label) -> dict:
    """Launch ``mll_grad_batched`` and its plain twin on the same inputs and
    hold the kernel to the twin row by row (see MLL_RTOL). A row that is
    non-finite on one side must be non-finite on the other, and a second
    launch must repeat the first to the bit. Also reported: each side's
    distance to the same arithmetic in float64 (on x's device). Returns the
    case with its ``failures`` (checked by the caller after printing).
    ``mll_floor`` puts a floor under |MLL| in its relative error: an MLL near a
    zero crossing is a sum of terms of the size of the live count.
    ``grad_vs_f64`` holds each row's gradient to the float64 evaluation
    instead of the twin, at the same tolerance: at n ~ 10³ the gradient's n²
    terms cancel, and the twin itself is then up to ~20·eps32·κ from float64
    (see MLL_RTOL)."""
    import torch

    from tpubq_torch.ops import hopper_kernels as hk
    from tpubq_torch.ops import kernels

    mll, grad = hk.mll_grad_batched(thetas, s, x, y, mask, jitter=jitter)
    mll2, grad2 = hk.mll_grad_batched(thetas, s, x, y, mask, jitter=jitter)
    torch.cuda.synchronize()
    ref_mll, ref_grad = hk.mll_grad_batched_plain(thetas, s, x, y, mask, jitter)
    s64 = torch.as_tensor(s).double()
    m64, g64 = hk.mll_grad_batched_plain(thetas.double(), s64.to(x.device), x.double(), y.double(), mask, jitter)
    fin = lambda m, g: (torch.isfinite(m) & torch.isfinite(g).all(-1)).cpu()  # noqa: E731
    ok_k, ok_t = fin(mll, grad), fin(ref_mll, ref_grad)
    e_mll, e_grad = _row_errs(mll, grad, ref_mll, ref_grad, mll_floor)
    t_mll, t_grad = _row_errs(ref_mll, ref_grad, m64, g64, mll_floor)
    k_mll, k_grad = _row_errs(mll, grad, m64, g64, mll_floor)
    both = ok_k & ok_t
    # condition number of each row's live Gram, float64 on x's device
    th64, s64 = thetas.double(), s64.to(x.device)

    def condition(th, x_live, s_):
        K = kernels.gaussian_K(th, x_live, x_live)
        K = K + torch.eye(x_live.shape[0], dtype=torch.float64, device=x.device) * (
            s_ ** 2 + jitter * th[:, 0] ** 2)[:, None, None]
        ev = torch.linalg.eigvalsh(K)
        return (ev[:, -1] / torch.clamp(ev[:, 0], min=1e-300)).cpu()

    if x.ndim == 3:  # per-problem data: each problem's rows on its own live points
        P = x.shape[0]
        th_p, x_p, s_p = th64.reshape(P, -1, 2), x.double(), s64.expand(P)
        kappa = torch.cat([condition(th_p[i], x_p[i][mask[i]], s_p[i]) for i in range(P)])
    else:
        kappa = condition(th64, x.double()[mask], s64)
    lst = lambda t: [float(v) if math.isfinite(v) else None for v in t.tolist()]  # noqa: E731
    case = dict(**label, B=thetas.shape[0], n=x.shape[-2], live=int(mask.reshape(-1, mask.shape[-1])[0].sum()),
                jitter=jitter,
                finite_kernel=ok_k.tolist(), finite_twin=ok_t.tolist(), gram_condition=lst(kappa),
                mll_rel=lst(e_mll), grad_norm=lst(e_grad), twin_vs_f64_mll_rel=lst(t_mll),
                twin_vs_f64_grad_norm=lst(t_grad), kernel_vs_f64_mll_rel=lst(k_mll),
                kernel_vs_f64_grad_norm=lst(k_grad),
                max_abs_err=max(((mll - ref_mll).abs().cpu()[both]).max().item(),
                                ((grad - ref_grad).abs().amax(-1).cpu()[both]).max().item())
                if bool(both.any()) else 0.0)
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    eps_kappa = cond_factor * torch.finfo(torch.float32).eps * kappa
    over = lambda e, fixed: float((e / (torch.finfo(torch.float32).eps * kappa))[both & (e > fixed)].max()) \
        if bool((both & (e > fixed)).any()) else 0.0  # noqa: E731
    case["worst_over_eps32_kappa"] = dict(mll=over(e_mll, MLL_RTOL), grad=over(e_grad, MLL_GRAD_NORM_TOL))
    tol_m, tol_g = torch.clamp(eps_kappa, min=MLL_RTOL), torch.clamp(eps_kappa, min=MLL_GRAD_NORM_TOL)
    held = {
        "repeats to the bit": torch.equal(bits(mll), bits(mll2)) and torch.equal(bits(grad), bits(grad2)),
        "non-finite on the same rows as the twin": bool((ok_k == ok_t).all()),
        "MLL within tolerance of the twin": bool((e_mll[both] <= tol_m[both]).all()),
    }
    if grad_vs_f64:
        held["gradient within tolerance of float64"] = bool((k_grad[both] <= tol_g[both]).all())
    else:
        held["gradient within tolerance of the twin"] = bool((e_grad[both] <= tol_g[both]).all())
    case["failures"] = [what for what, ok in held.items() if not ok]
    return case


def rows_to_max(case: dict) -> None:
    """A fleet's ``mll_vs_plain`` case with each per-row list replaced by its
    largest finite value (``<key>_max``), so that the log keeps no list of
    thousands of rows."""
    for key in [k for k, v in case.items() if isinstance(v, list) and k != "failures"]:
        vals = [v for v in case.pop(key) if isinstance(v, float)]
        if vals:
            case[key + "_max"] = max(vals)
    case["cond_factor"] = MLL_FLEET_COND_FACTOR


def check_mll(dev) -> dict:
    """``mll_grad_batched`` against its twin at the fit's shapes, (10, 32) for
    the log-GP and (10, 44) for the linear GP of the testbed state: on the
    restart rows ``random_restarts`` draws from the fit's seed, on hard rows
    (w at 2 × and 0.05 × the input range), and at s = 0, jitter = 0 with a row
    whose Gram is not positive definite."""
    import torch

    from tpubq_torch.models import fit as fitm, gp as gpm
    from tpubq_torch.ops import hopper_kernels as hk
    from tpubq_torch.ops.kernels import get_kernel

    bq = make_bq(testbed_x(False), dev, "float32", s=S_MAIN)
    gen = torch.Generator().manual_seed(FIT_SEED)
    cases = []
    for name, theta0, s, x, y, mask in fit_problems(bq.state):
        inits = fitm.random_restarts(gen, theta0, x, y, mask, FIT_RESTARTS)
        cases.append(mll_vs_plain(torch.exp(inits), s, x, y, mask, 1e-7, gp=name, rows="restarts"))
        xr = float(x[mask].max() - x[mask].min())
        h0 = float(theta0[0])
        hard = torch.tensor([[h0, 2.0 * xr], [h0, 0.05 * xr], [10.0 * h0, xr]], device=dev)
        cases.append(mll_vs_plain(hard, s, x, y, mask, 1e-7, gp=name, rows="hard"))
        # s = 0 and jitter = 0: the second row's Gram is all but rank one
        zero = torch.zeros((), device=dev)
        rows0 = torch.stack([theta0, torch.tensor([h0, 50.0 * xr], device=dev)])
        case0 = mll_vs_plain(rows0, zero, x, y, mask, 0.0, gp=name, rows="s0_jitter0")
        if case0["finite_kernel"][1]:
            case0["failures"].append("the row that is not positive definite came back finite")
        cases.append(case0)
    check(cases[0]["n"] == 32 and cases[3]["n"] == 44 and cases[0]["B"] == cases[3]["B"] == FIT_RESTARTS,
          "mll_grad checked at the main path's shapes (10, 32) and (10, 44)")

    # against float64 autograd (log_mll + dlog_mll on the CPU), at well-conditioned thetas
    kfn, _ = get_kernel("gaussian")
    name, theta0, _, x, y, mask = fit_problems(bq.state)[0]
    thetas = torch.tensor([[1.2, 0.8], [0.5, 1.5], [2.0, 0.3]], device=dev)
    mll, grad = hk.mll_grad_batched(thetas, 0.1, x, y, mask, jitter=0.0)
    a64 = (0.1, x.double().cpu(), y.double().cpu(), mask.cpu(), 0.0)
    m64 = gpm.log_mll(kfn, thetas.double().cpu(), *a64)
    g64 = gpm.dlog_mll(kfn, thetas.double().cpu(), *a64)
    dm = ((mll.double().cpu() - m64).abs() / m64.abs()).max().item()
    dg = (grad.double().cpu() - g64).abs()
    pin_ok = bool((dg <= MLL_PIN["grad_atol"] + MLL_PIN["grad_rtol"] * g64.abs()).all())
    emit("kernels_mll", tol=dict(mll_rel=MLL_RTOL, grad_norm=MLL_GRAD_NORM_TOL, cond_factor=MLL_COND_FACTOR),
         cases=cases, vs_f64_autograd=dict(pin=MLL_PIN, mll_rel=dm, grad_max_abs=dg.max().item(),
                                           grad_max_rel=(dg / g64.abs()).max().item()))
    for c in cases:
        check(not c["failures"], f"mll_grad ({c['gp']}, {c['rows']} rows): {c['failures']}")
    check(dm <= MLL_PIN["mll_rtol"] and pin_ok, "mll_grad within the JAX suite's pin of float64 autograd")
    return {"max_abs_err": max(c["max_abs_err"] for c in cases if c["rows"] == "restarts")}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def pick_gap(st, opts, st64, opts64, x_card: float, grid_dev, grid64):
    """(gap, f32 error, resolved points) of the card's pick against the
    float64 ESM; (None, None, 0) where the f32 scorer resolves no point (every
    admissible point demoted: all scores tie at the plateau, and the pick is
    the first admissible grid point).

    The f32 scorer demotes a point whose Schur complement is below its f32
    noise bound (the adaptive guard) to the Z_mean² plateau, so the f64
    optimum is taken over the points the f32 scorer resolves: not
    degenerate in f32 and not within candidate_thresh of an observation.
    ``gap`` is (best − ESM64(pick)) / best there; ``err`` is the f32 scorer's
    largest relative error on those points. Computed with the plain twins
    (no kernel launch).
    """
    import torch

    from tpubq_torch.models import acquire
    from tpubq_torch.ops import hopper_kernels as hk

    xa = grid_dev[:, None]
    esm32 = hk.esm_fused_plain(*acquire.esm_fused_inputs(st, opts, xa)).double().cpu()
    _, _, deg32, *_ = acquire._esm_affine_terms(st, opts, xa)
    esm64 = acquire.expected_squared_mean(st64, opts64, grid64[:, None])
    dist = (grid64[:, None] - st64.x_s[None, :, 0]).abs()
    near = ((dist < opts.candidate_thresh) & st64.obs_mask[None, :]).any(1)
    ok = ~deg32.cpu() & ~near
    if not bool(ok.any()):
        return None, None, 0
    best = esm64[ok].max().item()
    at = esm64[torch.argmin((grid64 - x_card).abs())].item()
    err = ((esm32 - esm64).abs() / esm64.abs())[ok].max().item()
    return (best - at) / best, err, int(ok.sum())


def fit_checks(bq, bq64) -> dict:
    """Hold the card's float32 fit (already run on ``bq``) to float64.

    ``bq64`` is the float64 CPU estimator on the same data at the initial
    hypers. For each GP in turn: the MLL, evaluated in float64 at the card's
    fitted hypers, must not be below the MLL at the initial hypers, nor more
    than FIT_MLL_MARGIN below the port's own float64 L-BFGS fit
    (``fit_params``) from the same restart rows. The card's hypers are then
    installed in ``bq64``, so that it goes on as the reference of the rest of
    the path.
    """
    import torch

    from tpubq_torch.models import bq as bqm, fit as fitm, gp as gpm
    from tpubq_torch.ops.kernels import get_kernel

    kfn, _ = get_kernel("gaussian")
    gen = torch.Generator().manual_seed(FIT_SEED)
    fitted = {"log_gp": bq.state.gp_log_l.theta.double().cpu(), "linear_gp": bq.state.gp_l.theta.double().cpu()}
    out = {}
    for i, name in enumerate(("log_gp", "linear_gp")):
        _, theta0, s, x, y, mask = fit_problems(bq64.state)[i]
        inits = fitm.random_restarts(gen, theta0, x, y, mask, FIT_RESTARTS)
        theta64, mll64 = fitm.fit_params("gaussian", theta0, s, x, y, mask, gen, inits)
        mll = lambda th: float(gpm.log_mll(kfn, th, s, x, y, mask, 1e-10))  # noqa: E731
        out[name] = dict(theta_initial=theta0.tolist(), theta_card_f32=fitted[name].tolist(),
                         theta_cpu_f64=theta64.tolist(), mll_initial=mll(theta0),
                         mll_card_f32=mll(fitted[name]), mll_cpu_f64=float(mll64))
        check(out[name]["mll_card_f32"] >= out[name]["mll_initial"], f"the fit did not lower the MLL ({name}: {out[name]})")
        check(out[name]["mll_card_f32"] >= out[name]["mll_cpu_f64"] - FIT_MLL_MARGIN,
              f"the fused fit reaches the float64 fit's MLL within {FIT_MLL_MARGIN} nats ({name}: {out[name]})")
        kw = {"theta_tl": fitted[name]} if i == 0 else {"theta_l": fitted[name]}
        bq64._state = bqm.set_params(bq64.state, bq64.options, **kw)
    return out


def main_path(dev) -> dict:
    import torch

    from tpubq_torch.models import acquire, marginalize as margm
    from tpubq_torch.ops import hopper_kernels as hk

    x = testbed_x(False)
    bq = make_bq(x, dev, "float32", s=S_MAIN)
    bq64 = make_bq(x, "cpu", "float64", s=S_MAIN)
    grid = np.linspace(-4.0, 4.0, G)
    grid64 = torch.as_tensor(grid, dtype=torch.float64)
    grid_dev = torch.as_tensor(grid, dtype=torch.float32, device=dev)

    for wrapper in (hk.esm_fused, hk.chol_batch, hk.mll_grad_batched, hk.gaussian_gram):
        wrapper.launches = 0
    t0 = time.perf_counter()
    bq.fit_hypers(ntry=FIT_RESTARTS, seed=FIT_SEED)
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - t0
    fit_launches = hk.mll_grad_batched.launches
    fit = fit_checks(bq, bq64)  # float64 on the CPU: launches no kernel
    z64_start = (bq64.Z_mean(), bq64.Z_var())
    t0 = time.perf_counter()
    zm0, zv0 = bq.Z_mean(), bq.Z_var()
    picks, gaps, errs, resolved, states = [], [], [], [], []
    for _ in range(10):
        states.append(bq.state)
        xn = bq.choose_next(grid)
        gap, err, n_ok = pick_gap(bq.state, bq.options, bq64.state, bq64.options, xn, grid_dev, grid64)
        gaps.append(gap)
        errs.append(err)
        resolved.append(n_ok)
        ln = float(f_l(xn))
        bq.add_observation(xn, ln)
        bq64.add_observation(xn, ln)
        picks.append(xn)
    zm1, zv1 = bq.Z_mean(), bq.Z_var()
    x_marg = bq.choose_next(grid, n=10, seed=3)
    zms, zvs = bq.marginalize(n=100, seed=4)
    torch.cuda.synchronize()
    seconds = fit_seconds + time.perf_counter() - t0
    launches = {"esm_fused": hk.esm_fused.launches, "chol_batch": hk.chol_batch.launches,
                "mll_grad": hk.mll_grad_batched.launches, "gaussian_gram": hk.gaussian_gram.launches}

    # the scorer kernel against its twin on each state the loop scored, at the
    # main path's own shapes (after the counts were read: these launches compare)
    esm_cases = [esm_vs_plain(acquire.esm_fused_inputs(st, bq.options, grid_dev[:, None]), "adaptive",
                              MAX_FLIPS, step=i) for i, st in enumerate(states)]
    emit("main_path_esm_vs_plain", G=G, tol_norm=ESM_NORM_TOL, max_flips=MAX_FLIPS, cases=esm_cases)
    # checks against the port's float64 CPU path on the same data
    z64 = (bq64.Z_mean(), bq64.Z_var())
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    thetas = torch.as_tensor(bq64.sample_hypers(n=100, seed=7))
    zm32s, zv32s = margm.marginalize(bq.state, bq.options, thetas.to(dev, torch.float32))
    zm64s, zv64s = margm.marginalize(bq64.state, bq64.options, thetas)
    marg_mean_rel = ((zm32s.double().cpu() - zm64s).abs() / zm64s.abs()).max().item()
    marg_var_rel = rel(zv32s.double().mean().item(), zv64s.mean().item())
    res = dict(
        seconds=seconds, launches=launches, fit_hypers_seconds=fit_seconds, fit=fit,
        picks=picks, x_marginalized_pick=x_marg, Z_mean_start=zm0, Z_var_start=zv0, Z_mean_end=zm1, Z_var_end=zv1,
        Z_mean_end_f64=z64[0], Z_var_end_f64=z64[1], true_Z=true_Z(),
        Z_mean_rel=max(rel(zm0, z64_start[0]), rel(zm1, z64[0])),
        Z_var_rel=max(rel(zv0, z64_start[1]), rel(zv1, z64[1])),
        pick_gaps=gaps, esm_f32_errs=errs, f32_resolved_points=resolved, marg_Z_mean_max_rel=marg_mean_rel,
        marg_Z_var_mean_rel=marg_var_rel, marginalize_n100_finite=bool(
            np.all(np.isfinite(zms)) and np.all(np.isfinite(zvs))),
        tol=dict(Z_mean=ZMEAN_RTOL, Z_var=ZVAR_RTOL, marg_mean=MARG_MEAN_RTOL,
                 esm_argmax=ESM_ARGMAX_RTOL, fit_mll_margin=FIT_MLL_MARGIN, fit_Z=FIT_Z_RTOL),
    )
    emit("main_path", s=S_MAIN, **res)
    check(all(n > 0 for n in launches.values()), f"every kernel launched on the main path {launches}")
    check(fit_launches == launches["mll_grad"] == 2 * (FIT_ITERS + 1),
          f"fit_hypers launched mll_grad 2·(n_iter + 1) = {2 * (FIT_ITERS + 1)} times, got {fit_launches}")
    check(abs(zm0 - true_Z()) / true_Z() < FIT_Z_RTOL, "E[Z] after the fit near the closed-form evidence")
    check(res["Z_mean_rel"] <= ZMEAN_RTOL, "Z_mean f32 card vs f64 CPU")
    check(res["Z_var_rel"] <= ZVAR_RTOL, "Z_var f32 card vs f64 CPU")
    check(resolved[0] > 0, "the f32 scorer resolves points on the state the fit leaves")
    check(all(g <= max(ESM_ARGMAX_RTOL, 2.0 * e) for g, e in zip(gaps, errs) if g is not None),
          "each pick is the f64 ESM maximum over the resolved points, up to the f32 scorer's error")
    check(marg_mean_rel <= MARG_MEAN_RTOL, "marginalized Z_mean f32 card vs f64 CPU")
    check(marg_var_rel <= ZVAR_RTOL, "marginalized mean V[Z] f32 card vs f64 CPU")
    check(res["marginalize_n100_finite"], "marginalize(n=100) finite")
    check(zv1 < zv0, "V[Z] decreased over the active loop")
    check(abs(zm1 - true_Z()) / true_Z() < 2e-3, "E[Z] near the closed-form evidence")
    return {"bq": bq, "thetas": thetas.to(dev, torch.float32), "launches": launches,
            "esm_max_abs_err": max(c["max_abs_err"] for c in esm_cases)}


# ---------------------------------------------------------------------------
# the fleet: kernels against their plain versions, and the fleet path
# ---------------------------------------------------------------------------


def fleet_data(B: int, n_obs: int, seed: int = 0):
    """(xs (B, n_obs), ls (B, n_obs), mus (B,)): the fleet recipe of
    benchmarks/fleet_esm.py — jittered linspaces, ℓ_b = N(x; μ_b, 0.5²)."""
    rng = np.random.RandomState(seed)
    xs = np.stack([np.linspace(-2.2, 2.2, n_obs) + 0.03 * rng.standard_normal(n_obs) for _ in range(B)])
    mus = rng.uniform(-0.5, 0.5, B)
    return xs, fleet_lik(xs, mus[:, None]), mus


def fleet_lik(x, mu):
    return np.exp(-0.5 * (np.asarray(x, np.float64) - mu) ** 2 / 0.25) / math.sqrt(2.0 * math.pi * 0.25)


def dense_fleet_data(B: int, n_obs: int, seed: int = 11):
    """Near-capacity live sets on a domain that widens with n_obs (the
    geometry-boundary recipe of tests/test_pallas.py), for many rows per problem."""
    rng = np.random.RandomState(seed)
    half = 0.09 * n_obs
    xs = np.stack([np.sort(rng.uniform(-half, half, n_obs)) for _ in range(B)])
    mus = rng.uniform(-0.5, 0.5, B)
    ls = np.exp(-0.5 * (xs - mus[:, None]) ** 2) / math.sqrt(2.0 * math.pi) + 1e-3
    return xs, ls, half


def fleet_combine(A, Bc, dg, m_a, c_a, gamma, zTa):
    """The lognormal combine of the two kernels' outputs → (B, G) scores."""
    import torch

    from tpubq_torch.models import acquire

    E1, E2 = acquire._lognormal_moments(m_a, c_a, gamma[:, None])
    return torch.where(dg > 0, (zTa * zTa)[:, None], A * A + 2.0 * A * Bc * E1 + Bc * Bc * E2)


def fleet_scores_plain(states, opts, grid, dtype=None):
    """(scores (B, G), degenerate (B, G) bool, parts) of the fleet scorer from
    the plain versions of both kernels (no launch), in the state's dtype or,
    with ``dtype``, on the same inputs cast to it."""
    from tpubq_torch.models import batched
    from tpubq_torch.ops import hopper_kernels as hk

    args_l, args_tl, zTa = batched.fleet_scorer_inputs(states, opts)
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
    (params, w_l, *rest_l), (h2, w_tl, *rest_tl) = ([cast(a) for a in args] for args in (args_l, args_tl))
    A, Bc, dg = hk.esm_fleet_l_plain(params, w_l, cast(grid), *rest_l, opts.candidate_thresh, batched._LAM_F32)
    m_a, c_a = hk.esm_fleet_tl_plain(h2, w_tl, cast(grid), *rest_tl)
    scores = fleet_combine(A, Bc, dg, m_a, c_a, cast(states.gamma), cast(zTa))
    return scores, dg > 0, dict(A=A, B=Bc, m_a=m_a, c_a=c_a, esm=scores)


def fleet_flip_margins(args_l, grid, thresh, lam, flips) -> dict:
    """At the (problem, point) pairs ``flips`` (n, 2) where kernel and plain
    version disagree on the degenerate mask: γ = κ − kᵀK⁻¹k, the threshold
    max(eps32·κ, λ·kᵀ|K⁻¹|k) and the guard's noise bound λ·kᵀ|K⁻¹|k, in float64
    from the float32 inputs. A flip one rounding may decide has |γ − thr| ≤ noise."""
    import torch

    params, w2inv, xsc, msc, Kinv, _, _ = (a.double() for a in args_l)
    b, g = flips[:, 0], flips[:, 1]
    diff = xsc[b] - grid.double()[g][:, None, :]  # (n, NP, d)
    r2 = (diff * diff * w2inv[b][:, None, :]).sum(-1)
    k = params[b, 15][:, None] * torch.exp(-r2) * msc[b]
    s1 = (k * (Kinv[b] @ k[..., None])[..., 0]).sum(-1)
    noise = lam * (k * (Kinv[b].abs() @ k[..., None])[..., 0]).sum(-1)
    gam = params[b, 0] - s1
    thr = torch.maximum(torch.finfo(torch.float32).eps * params[b, 0], noise)
    near = ((diff.abs().amax(-1) < thresh) & (msc[b] > 0)).any(-1)
    return dict(gamma_over_thr=(gam / thr).tolist(), near=near.tolist(),
                within_noise=bool((((gam - thr).abs() <= noise) | near).all()))


def fleet_vs_plain(states, opts, grid, max_flips: int = MAX_FLEET_FLIPS, skip=(), **label) -> dict:
    """Launch ``esm_fleet_l`` and ``esm_fleet_tl`` on a fleet state and hold
    each output, and the score they combine to, to the plain versions on the
    same inputs by the rule at FLEET_NORM_TOL. ``skip`` lists problems whose
    factor is non-finite: their rows must come back non-finite from both, and
    are left out of the comparison. Returns the case with its ``failures``."""
    import torch

    from tpubq_torch.models import batched
    from tpubq_torch.ops import hopper_kernels as hk

    thresh, lam = float(opts.candidate_thresh), batched._LAM_F32
    args_l, args_tl, zTa = batched.fleet_scorer_inputs(states, opts)
    params, w_l, *rest_l = args_l
    h2, w_tl, *rest_tl = args_tl
    A, Bc, dg = hk.esm_fleet_l(params, w_l, grid, *rest_l, thresh, lam)
    m_a, c_a = hk.esm_fleet_tl(h2, w_tl, grid, *rest_tl)
    torch.cuda.synchronize()
    out = dict(A=A, B=Bc, m_a=m_a, c_a=c_a, esm=fleet_combine(A, Bc, dg, m_a, c_a, states.gamma, zTa))
    _, dg32, ref = fleet_scores_plain(states, opts, grid)
    _, dg64, ref64 = fleet_scores_plain(states, opts, grid, torch.float64)
    keep = torch.ones(A.shape[0], dtype=torch.bool, device=A.device)
    keep[list(skip)] = False
    flip = ((dg > 0) != dg32) & keep[:, None]
    flips = torch.nonzero(flip)
    same = ~flip
    errs, own, held = {}, {}, {}
    for name in out:
        # a problem whose output is 0 everywhere (m_a under a vanishing
        # length-scale) is held to 0 exactly
        scale = ref64[name][keep].abs().amax(1).clamp_min(torch.finfo(torch.float64).tiny)
        tl_side = name in ("m_a", "c_a")  # the log-GP outputs have no mask to flip on
        ok = torch.ones_like(same[keep]) if tl_side else same[keep]
        e = ((out[name][keep] - ref[name][keep]).abs() * ok).amax(1).double() / scale
        o = ((ref[name][keep].double() - ref64[name][keep]).abs() * (ok & (dg32 == dg64)[keep])).amax(1) / scale
        errs[name], own[name] = e.max().item(), o.max().item()
        held[name] = errs[name] <= max(2.0 * own[name], FLEET_NORM_TOL)
    B, NP, d = args_l[2].shape
    case = dict(**label, B=B, G=grid.shape[0], d=d, NP=NP, NP2=args_tl[2].shape[1],
                norm_err=errs, plain_f32_vs_f64=own, degenerate_points=int(dg32[keep].sum()),
                degenerate_flips=len(flips),
                flips=fleet_flip_margins(args_l, grid, thresh, lam, flips[:64]) if len(flips) else None,
                max_abs_err={n: (out[n][keep] - ref[n][keep]).abs()[same[keep] | (n in ("m_a", "c_a"))].max().item()
                             for n in ("A", "B", "m_a", "c_a")})
    fails = [f"{n} beyond tolerance" for n, ok in held.items() if not ok]
    if not bool(all(torch.isfinite(v[keep]).all() for v in out.values())):
        fails.append("non-finite output on a healthy problem")
    for b in skip:
        if bool(torch.isfinite(out["esm"][b]).any()) or bool(torch.isfinite(ref["esm"][b]).any()):
            fails.append(f"problem {b} with a non-finite factor came back finite")
    if len(flips) > max_flips:
        fails.append(f"{len(flips)} degenerate-mask flips (at most {max_flips})")
    if len(flips) and not case["flips"]["within_noise"]:
        fails.append("a degenerate-mask flip away from the guard's threshold")
    case["failures"] = fails
    return case


def fleet_state(dev, B, n_obs, max_obs, n_candidate=12, s=0.0, dtype="float32", per_problem=False):
    from tpubq_torch.models import batched
    from tpubq_torch.utils.options import BQOptions

    xs, ls, _ = fleet_data(B, n_obs)
    opts = BQOptions(n_candidate=n_candidate, candidate_thresh=0.2, max_obs=max_obs, dtype=dtype)
    kw = dict(params_tl=PARAMS_TL, params_l=PARAMS_L, s_tl=s, s_l=s, device=dev)
    if per_problem:  # hypers and measures of their own for every problem
        ramp = np.linspace(0.0, 1.0, B)[:, None]
        kw.update(params_tl=np.array(PARAMS_TL) * (1.0 + 0.2 * ramp), params_l=np.array(PARAMS_L) * (1.0 + 0.3 * ramp),
                  x_means=0.3 * (ramp[:, 0] - 0.5), x_vars=1.0 + ramp[:, 0])
    return batched.init_batch(xs, ls, opts, **kw), opts


def dense_fleet_state(dev, B, max_obs, n_candidate=14, dtype="float32"):
    from tpubq_torch.models import batched
    from tpubq_torch.utils.options import BQOptions

    xs, ls, half = dense_fleet_data(B, max_obs - 6)
    opts = BQOptions(n_candidate=n_candidate, candidate_thresh=0.12, max_obs=max_obs, dtype=dtype)
    states = batched.init_batch(xs, ls, opts, params_tl=PARAMS_TL, params_l=PARAMS_L, s_tl=0.01, s_l=0.01,
                                x_means=np.zeros(1), x_vars=4.0 * np.ones(1), device=dev)
    return states, opts, half


def fleet_state_2d(dev, B=4, dtype="float32"):
    from tpubq_torch.models import batched
    from tpubq_torch.utils.options import BQOptions

    rng = np.random.RandomState(7)
    xs = rng.uniform(-2.0, 2.0, (B, 9, 2))
    mu = 0.1 * np.arange(B)[:, None, None]
    ls = np.exp(-0.5 * ((xs - mu) ** 2).sum(-1) / 0.5) / (2.0 * math.pi * 0.5)
    opts = BQOptions(n_candidate=8, candidate_thresh=0.25, max_obs=16, dim=2, dtype=dtype)
    return batched.init_batch(xs, ls, opts, params_tl=(0.7, 0.8, 0.9), params_l=(0.3, 0.5, 0.6), device=dev), opts


def check_fleet_kernels(dev) -> dict:
    """The two fleet kernels against their plain versions at B = 64, G = 10⁴
    for (NP, NP2) = (28, 16), (44, 32) — the fleet path's — and (60, 48); at
    B = 6 with (126, 112) rows; at B = 8 with (220, 208), the route's edge; at
    B = 4 in d = 2 with (24, 16); with per-problem hypers and measures; with
    one problem whose factor is non-finite; and at (44, 32) on a grid of
    G + FLEET_RAGGED points, whose last block of 128 is ragged. Then ``mll_grad_batched`` with per-problem data (64 × 10 rows)
    against its twin by the rule of ``check_mll``."""
    import torch

    from tpubq_torch.models import fit as fitm

    grid = torch.linspace(-4.0, 4.0, G, device=dev)[:, None]
    cases, kept = [], {}
    for n_obs, max_obs, s in ((10, 16, 0.0), (FLEET_N_OBS, FLEET_MAX_OBS, S_MAIN), (8, 48, 0.0)):
        states, opts = fleet_state(dev, FLEET_B, n_obs, max_obs, s=s)
        kept[(opts.max_nsc, opts.max_obs)] = (states, opts)
        cases.append(fleet_vs_plain(states, opts, grid, geometry="fleet recipe", s=s))
    states, opts = fleet_state(dev, FLEET_B, 10, 16, per_problem=True)
    cases.append(fleet_vs_plain(states, opts, grid, geometry="per-problem hypers and measures"))
    states, opts = kept[(44, 32)]
    nan = float("nan")
    broken = states._replace(gp_l=states.gp_l._replace(
        alpha=states.gp_l.alpha.index_fill(0, torch.tensor([5], device=dev), nan),
        Kinv=states.gp_l.Kinv.index_fill(0, torch.tensor([5], device=dev), nan)))
    cases.append(fleet_vs_plain(broken, opts, grid, skip=(5,), geometry="problem 5 with a non-finite factor"))
    states, opts, half = dense_fleet_state(dev, 6, 112)
    wide = torch.linspace(-half - 1.0, half + 1.0, G, device=dev)[:, None]
    cases.append(fleet_vs_plain(states, opts, wide, geometry="near-capacity rows"))
    states, opts, half = dense_fleet_state(dev, 8, 208, n_candidate=12)
    wide = torch.linspace(-half - 1.0, half + 1.0, G, device=dev)[:, None]
    cases.append(fleet_vs_plain(states, opts, wide, geometry="the route's edge (220 rows)"))
    states, opts = kept[(44, 32)]
    ragged = torch.linspace(-4.0, 4.0, G + FLEET_RAGGED, device=dev)[:, None]
    cases.append(fleet_vs_plain(states, opts, ragged, geometry=f"G = {G} + {FLEET_RAGGED}: a ragged last block"))
    states, opts = fleet_state_2d(dev)
    g1 = torch.linspace(-3.0, 3.0, 100, device=dev)
    grid2 = torch.stack(torch.meshgrid(g1, g1, indexing="ij"), -1).reshape(-1, 2).contiguous()
    cases.append(fleet_vs_plain(states, opts, grid2, geometry="d = 2"))

    # mll_grad with per-problem data: the fleet fit's first launch of each GP
    st, _ = kept[(44, 32)]
    gen = torch.Generator().manual_seed(FIT_SEED)
    l_sc = torch.where(st.sc_mask, st.l_sc, torch.zeros_like(st.l_sc))
    mll_cases = []
    for name, gp, x, y, mask in (("log_gp", st.gp_log_l, st.x_s, st.tl_s, st.obs_mask),
                                 ("linear_gp", st.gp_l, st.x_sc, l_sc, st.sc_mask)):
        inits = fitm.random_restarts(gen, gp.theta, x, y, mask, FIT_RESTARTS)
        mll_cases.append(mll_vs_plain(torch.exp(inits.reshape(-1, 2)), gp.s, x, y, mask, 1e-7,
                                      cond_factor=MLL_FLEET_COND_FACTOR, mll_floor=float(mask[0].sum()),
                                      gp=name, rows="fleet restarts", problems=x.shape[0]))
    for c in mll_cases:  # 640 rows: keep the per-row lists out of the log
        rows_to_max(c)
    emit("kernels_fleet", tol_norm=FLEET_NORM_TOL, max_flips=MAX_FLEET_FLIPS, cases=cases, mll_per_problem=mll_cases)
    for c in cases:
        check(not c["failures"], f"fleet kernels ({c['geometry']}, NP={c['NP']}): {c['failures']}")
    for c in mll_cases:
        check(not c["failures"], f"mll_grad with per-problem data ({c['gp']}): {c['failures']}")
    check({(c["NP"], c["NP2"]) for c in cases} >= {(28, 16), (44, 32), (60, 48), (126, 112), (24, 16), (220, 208)},
          "fleet kernels checked at the shapes named")
    check(any(c["G"] % 128 for c in cases), "fleet kernels checked on a grid that ends inside a block")
    worst = lambda names: max(c["max_abs_err"][n] for c in cases for n in names)  # noqa: E731
    return {"l_max_abs_err": worst(("A", "B")), "tl_max_abs_err": worst(("m_a", "c_a")),
            "mll_max_abs_err": max(c["max_abs_err"] for c in mll_cases), "states": kept}


def fleet_precision(dev) -> dict:
    """The fleet scorer (kernels) and the plain batched float32 scorer against
    the float64 scorer on the same data, at 28, 60 and 126 rows per problem:
    the measurement behind ``fleet_scorer_supported``. The float32 and the
    float64 fleets are built from the same observations; errors are relative
    per point. The kernels must be as close to float64 as the plain float32
    scorer is: max error ≤ max(2 × the plain scorer's, 1e-4), the rule of
    tests/test_pallas.py for the TPU kernel."""
    import torch

    from tpubq_torch.models import acquire, batched

    out = {}
    for rows, build in ((28, lambda dt: fleet_state(dev, 6, 10, 16, dtype=dt) + (4.0,)),
                        (60, lambda dt: dense_fleet_state(dev, 5, 48, 12, dtype=dt)),
                        (126, lambda dt: dense_fleet_state(dev, 3, 112, 14, dtype=dt))):
        st32, o32, half = build("float32")
        st64, o64, _ = build("float64")
        check(o32.max_nsc == rows, f"precision study at {rows} rows per problem")
        span = half if rows == 28 else half + 1.0
        g64 = torch.linspace(-span, span, 2001, device=dev, dtype=torch.float64)[:, None]
        g32 = g64.float()
        truth = acquire.expected_squared_mean_xla(st64, o64, g64)
        res = {}
        for name, scores in (("fleet_kernels", batched.expected_squared_mean_fleet(st32, o32, g32)),
                             ("plain_batched_f32", acquire.expected_squared_mean_xla(st32, o32, g32))):
            rel = ((scores.double() - truth).abs() / (truth.abs() + 1e-300)).flatten()
            res[name] = dict(q95=torch.quantile(rel, 0.95).item(), q99=torch.quantile(rel, 0.99).item(),
                             max=rel.max().item())
        out[f"max_nsc_{rows}"] = res
    emit("fleet_precision", lam=batched._LAM_F32, vs="float64 scorer on the same observations", **out)
    for rows, res in out.items():
        check(res["fleet_kernels"]["max"] <= max(2.0 * res["plain_batched_f32"]["max"], 1e-4),
              f"fleet kernels as close to float64 as the plain float32 scorer ({rows}: {res})")
    return out


def fleet_pick_gaps(st32, opts, st64, opts64, x_card, grid_dev, grid64):
    """``pick_gap`` for every problem of a fleet at once → (gap, err, resolved,
    f32 scores), the first three (B,). Plain versions only (no kernel launch);
    the float64 scores of the CPU's float64 state, computed on the card. A point counts as near an observation where
    the card's own float32 selection excluded it. gap and err are NaN where
    the pick is not a resolved point: the f32 scorer resolved none, or the
    plateau (zᵀα)² that every demoted point scores lies above all its resolved
    scores (the ESM of the linearized model can fall below the squared mean),
    and the pick is the first admissible demoted point."""
    import torch

    from tpubq_torch.models import acquire, bq as bqm

    esm32, deg32, _ = fleet_scores_plain(st32, opts, grid_dev[:, None])
    dist = (grid_dev[None, :, None] - st32.x_s[:, None, :, 0]).abs()
    near = ((dist < opts.candidate_thresh) & st32.obs_mask[:, None, :]).any(-1).cpu()
    esm32, deg32 = esm32.double().cpu(), deg32.cpu()
    # the float64 scores on the card (the CPU takes 1–2 s a sweep of 64 problems)
    dev = grid_dev.device
    esm64 = acquire.expected_squared_mean_xla(bqm.tree_map(lambda a: a.to(dev), st64), opts64,
                                              grid64.to(dev)[:, None]).cpu()
    ok = ~deg32 & ~near
    ninf = torch.full_like(esm64, -math.inf)
    best = torch.where(ok, esm64, ninf).amax(1)
    idx = (grid64[None, :] - torch.as_tensor(x_card, dtype=torch.float64)[:, None]).abs().argmin(1)
    at = esm64.gather(1, idx[:, None])[:, 0]
    err = torch.where(ok, (esm32 - esm64).abs() / esm64.abs(), torch.zeros_like(esm64)).amax(1)
    n_ok = ok.sum(1)
    nan = torch.full_like(best, math.nan)
    held = ok.gather(1, idx[:, None])[:, 0]
    return torch.where(held, (best - at) / best, nan), torch.where(held, err, nan), n_ok, esm32


def fleet_path(dev) -> dict:
    """The fleet through ``BQFleet`` on the card at full width (see the module
    docstring, phase 4)."""
    import torch

    from tpubq_torch import BQ, BQFleet
    from tpubq_torch.models import acquire, bq as bqm, fit as fitm, gp as gpm
    from tpubq_torch.ops import hopper_kernels as hk
    from tpubq_torch.ops.kernels import get_kernel

    xs, ls, mus = fleet_data(FLEET_B, FLEET_N_OBS)
    kw = dict(params_tl=PARAMS_TL, params_l=PARAMS_L, n_candidate=12, candidate_thresh=0.2,
              max_obs=FLEET_MAX_OBS, s=S_MAIN)
    fleet = BQFleet(xs, ls, device=dev, dtype="float32", **kw)
    fleet64 = BQFleet(xs, ls, device="cpu", dtype="float64", **kw)
    opts, opts64 = fleet.options, fleet64.options
    grid = np.linspace(-4.0, 4.0, G)
    grid64 = torch.as_tensor(grid, dtype=torch.float64)
    grid_dev = torch.as_tensor(grid, dtype=torch.float32, device=dev)
    wrappers = dict(esm_fused=hk.esm_fused, chol_batch=hk.chol_batch, mll_grad=hk.mll_grad_batched,
                    esm_fleet_l=hk.esm_fleet_l, esm_fleet_tl=hk.esm_fleet_tl, gaussian_gram=hk.gaussian_gram)
    counts = lambda: {k: w.launches for k, w in wrappers.items()}  # noqa: E731

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    fleet.fit(ntry=FIT_RESTARTS, seed=FIT_SEED)
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - t0
    after_fit = counts()
    zm0, zv0 = fleet.Z_mean(), fleet.Z_var()
    states, picks, per_step = [], [], []
    for _ in range(FLEET_STEPS):
        states.append(fleet.states)
        c0 = counts()
        xn = fleet.choose_next(grid)
        c1 = counts()
        fleet.add_observation(xn, fleet_lik(xn[:, 0], mus))
        c2 = counts()
        picks.append(xn[:, 0].copy())
        per_step.append(dict(choose={k: c1[k] - c0[k] for k in c0}, add={k: c2[k] - c1[k] for k in c0}))
    zm1, zv1 = fleet.Z_mean(), fleet.Z_var()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()

    # ---- everything below compares; none of it counts as the path's launches
    # the fit, in float64 on the CPU: not below the initial hypers for any
    # problem, and within FIT_MLL_MARGIN of the float64 L-BFGS fit for four
    kfn, _ = get_kernel("gaussian")
    st64 = fleet64.states
    th_tl = fleet.states.gp_log_l.theta.double().cpu()
    th_l = fleet.states.gp_l.theta.double().cpu()
    mll_tl0 = gpm.log_mll(kfn, st64.gp_log_l.theta, st64.gp_log_l.s, st64.x_s, st64.tl_s, st64.obs_mask, 1e-10)
    mll_tl1 = gpm.log_mll(kfn, th_tl, st64.gp_log_l.s, st64.x_s, st64.tl_s, st64.obs_mask, 1e-10)
    fit_l_gap = {}
    gen = torch.Generator().manual_seed(FIT_SEED)
    for i in FLEET_SINGLES:
        one = fleet64.problem(i)
        inits = fitm.random_restarts(gen, one.gp_log_l.theta, one.x_s, one.tl_s, one.obs_mask, FIT_RESTARTS)
        _, mll64 = fitm.fit_params("gaussian", one.gp_log_l.theta, one.gp_log_l.s, one.x_s, one.tl_s,
                                   one.obs_mask, gen, inits)
        fit_l_gap[i] = float(mll64) - float(mll_tl1[i])
    st64 = bqm.set_params(st64, opts64, theta_tl=th_tl)
    l_sc = torch.where(st64.sc_mask, st64.l_sc, torch.zeros_like(st64.l_sc))
    mll_l0 = gpm.log_mll(kfn, st64.gp_l.theta, st64.gp_l.s, st64.x_sc, l_sc, st64.sc_mask, 1e-10)
    mll_l1 = gpm.log_mll(kfn, th_l, st64.gp_l.s, st64.x_sc, l_sc, st64.sc_mask, 1e-10)
    fleet64._states = bqm.set_params(st64, opts64, theta_l=th_l)
    rel = lambda a, b: float(np.max(np.abs(a - b) / np.abs(b)))  # noqa: E731
    z_rel = [rel(zm0, fleet64.Z_mean())]
    zv_rel = [rel(zv0, fleet64.Z_var())]

    # the float64 fleet follows the card's picks; each pick is held to the float64 optimum
    gaps, errs, resolved, scores32 = [], [], [], []
    for step, st32 in enumerate(states):
        gap, err, n_ok, esm32 = fleet_pick_gaps(st32, opts, fleet64.states, opts64, picks[step], grid_dev, grid64)
        gaps.append(gap)
        errs.append(err)
        resolved.append(n_ok)
        scores32.append(esm32[list(FLEET_SINGLES)])
        fleet64.add_observation(picks[step][:, None], fleet_lik(picks[step], mus))
    z64 = (fleet64.Z_mean(), fleet64.Z_var())
    z_rel.append(rel(zm1, z64[0]))
    zv_rel.append(rel(zv1, z64[1]))
    gaps, errs, resolved = torch.stack(gaps), torch.stack(errs), torch.stack(resolved)
    gap_ok = torch.isnan(gaps) | (gaps <= torch.clamp(2.0 * errs, min=ESM_ARGMAX_RTOL))
    gap_failures = [dict(step=int(i), problem=int(b), gap=float(gaps[i, b]), err=float(errs[i, b]),
                         resolved=int(resolved[i, b])) for i, b in torch.nonzero(~gap_ok)[:16].tolist()]

    # four of the problems as single BQs on the card, with the fleet's fitted hypers
    singles = {}
    for i in FLEET_SINGLES:
        bq = BQ(xs[i], ls[i], device=dev, dtype="float32", x_mean=0.0, x_var=1.0,
                **{k: v for k, v in kw.items() if not k.startswith("params")})
        bq.init(params_tl=PARAMS_TL, params_l=PARAMS_L)
        bq._state = bqm.set_params(bq.state, bq.options, theta_tl=states[0].gp_log_l.theta[i],
                                   theta_l=states[0].gp_l.theta[i])
        # The single BQ refits through the library's Cholesky where the fleet
        # goes through chol_batch, and its guard, λ·ρ·κ·‖k‖₁, bounds the
        # fleet's per-point λ·kᵀ|K⁻¹|k from above, so it demotes a superset of
        # the fleet's degenerate points. A step agrees if the picks are equal,
        # or the fleet's own float32 score at the single's pick is within twice
        # the float32 scorer's error on that step of the fleet's best (a tie at
        # float32's resolution), or the single scorer has demoted the fleet's
        # pick to its plateau.
        same, tie, demoted = [], [], []
        for step in range(FLEET_STEPS):
            x1 = bq.choose_next(grid)
            x_fleet = torch.as_tensor(picks[step][i], dtype=torch.float32, device=dev).reshape(1, 1)
            same.append(bool(abs(x1 - picks[step][i]) < 1e-6))
            row = scores32[step][FLEET_SINGLES.index(i)]
            at = lambda x: float(row[int(np.argmin(np.abs(grid - x)))])  # noqa: E731
            tol = max(ESM_ARGMAX_RTOL, 2.0 * float(torch.nan_to_num(errs[step, i], nan=0.0)))
            tie.append(bool(at(x1) >= at(picks[step][i]) * (1.0 - tol)))
            demoted.append(bool(acquire._esm_affine_terms(bq.state, bq.options, x_fleet)[2][0]))
            bq.add_observation(picks[step][i], float(fleet_lik(picks[step][i], mus[i])))
        singles[i] = dict(same_picks=same, tie_at_f32_resolution=tie, fleet_pick_demoted_by_single_guard=demoted,
                          Z_mean=bq.Z_mean(), Z_mean_fleet=float(zm1[i]),
                          Z_mean_rel=abs(bq.Z_mean() - float(zm1[i])) / abs(float(zm1[i])))

    # the kernels against their plain versions on every state the loop scored
    cases = [fleet_vs_plain(st, opts, grid_dev[:, None], step=i) for i, st in enumerate(states)]
    emit("fleet_path_kernels_vs_plain", tol_norm=FLEET_NORM_TOL, max_flips=MAX_FLEET_FLIPS, cases=cases)

    truths = np.exp(-0.5 * mus**2 / 1.25) / math.sqrt(2.0 * math.pi * 1.25)
    res = dict(
        B=FLEET_B, G=G, max_obs=FLEET_MAX_OBS, steps=FLEET_STEPS, s=S_MAIN, seconds=seconds,
        fit_seconds=fit_seconds, launches=launches, launches_after_fit=after_fit, per_step_launches=per_step[0],
        mll_tl_gain_min=float((mll_tl1 - mll_tl0).min()), mll_l_gain_min=float((mll_l1 - mll_l0).min()),
        log_gp_mll_gap_to_f64_lbfgs=fit_l_gap, Z_mean_rel=max(z_rel), Z_var_rel=max(zv_rel),
        Z_mean_vs_truth_max_rel=rel(zm1, truths), Z_var_start_max=float(zv0.max()), Z_var_end_max=float(zv1.max()),
        pick_gap_max=float(torch.nan_to_num(gaps, nan=0.0).max()), esm_f32_err_max=float(torch.nan_to_num(errs, nan=0.0).max()),
        f32_resolved_points_min_per_step=resolved.min(1).values.tolist(),
        problems_with_no_resolved_point_per_step=(resolved == 0).sum(1).tolist(),
        picks_on_the_plateau_per_step=torch.isnan(gaps).sum(1).tolist(), pick_gap_failures=gap_failures,
        singles=singles,
        tol=dict(Z_mean=ZMEAN_RTOL, Z_var=ZVAR_RTOL, esm_argmax=ESM_ARGMAX_RTOL, fit_mll_margin=FIT_MLL_MARGIN,
                 single_Z=FLEET_SINGLE_Z_RTOL),
    )
    emit("fleet_path", **res)
    n_fit = 2 * (FIT_ITERS + 1)
    check(after_fit["mll_grad"] == launches["mll_grad"] == n_fit,
          f"the whole fleet fit launched mll_grad 2·(n_iter + 1) = {n_fit} times, got {after_fit['mll_grad']}")
    check(all(p["choose"]["esm_fleet_l"] == 1 and p["choose"]["esm_fleet_tl"] == 1 for p in per_step),
          "each choose_next launched esm_fleet_l and esm_fleet_tl exactly once")
    check(launches["esm_fleet_l"] == launches["esm_fleet_tl"] == FLEET_STEPS, f"fleet scorer launches {launches}")
    check(launches["esm_fused"] == 0, "esm_fused is not on the fleet path")
    check(all(p["add"]["chol_batch"] >= 2 for p in per_step), "each add_observation refits through chol_batch")
    check(res["mll_tl_gain_min"] >= 0.0 and res["mll_l_gain_min"] >= 0.0, f"the fleet fit lowered no problem's MLL ({res})")
    check(all(g <= FIT_MLL_MARGIN for g in fit_l_gap.values()), f"fleet fit within {FIT_MLL_MARGIN} nats of the f64 fit")
    check(res["Z_mean_rel"] <= ZMEAN_RTOL, f"fleet Z_mean f32 card vs f64 CPU ({res['Z_mean_rel']})")
    check(res["Z_var_rel"] <= ZVAR_RTOL, f"fleet Z_var f32 card vs f64 CPU ({res['Z_var_rel']})")
    check(bool(gap_ok.all()), "each fleet pick is the f64 ESM maximum over the resolved points, up to the f32 scorer's error")
    check(bool((resolved[0] > 0).all()), "the f32 fleet scorer resolves points for every problem after the fit")
    check(all(a or b or c for v in singles.values() for a, b, c in zip(
        v["same_picks"], v["tie_at_f32_resolution"], v["fleet_pick_demoted_by_single_guard"])),
        "single BQs on the card make the fleet's picks, up to float32 ties and their wider guard")
    check(all(v["Z_mean_rel"] <= FLEET_SINGLE_Z_RTOL for v in singles.values()), "single BQs reach the fleet's E[Z]")
    check(bool((zv1 < zv0).all()), "V[Z] decreased for every problem")
    for c in cases:
        check(not c["failures"], f"fleet kernels on the path's state {c['step']}: {c['failures']}")
    return {"fleet": fleet, "launches": launches, "state": states[3], "opts": opts,
            "l_max_abs_err": max(max(c["max_abs_err"][n] for n in ("A", "B")) for c in cases),
            "tl_max_abs_err": max(max(c["max_abs_err"][n] for n in ("m_a", "c_a")) for c in cases)}


# ---------------------------------------------------------------------------
# hyper-marginalization: the lock-step slice sampler, marginalize and the
# marginalized choose_next, single and fleet
# ---------------------------------------------------------------------------

MARG_N, MARG_CHOOSE_N, MARG_LOOP_STEPS = 100, 10, 3
JOINT = ("h", "w", "h_l", "w_l")
MARG_WRAPPERS = ("esm_fused", "chol_batch", "gaussian_gram", "cholesky_blocked", "tri_solve_blocked",
                 "cholesky_batched", "esm_fleet_l", "esm_fleet_tl", "mll_grad_batched")


def marg_counts() -> dict:
    from tpubq_torch.models import marginalize as margm
    from tpubq_torch.ops import hopper_kernels as hk

    return {**{k: getattr(hk, k).launches for k in MARG_WRAPPERS},
            "host_reads": margm.slice_sample.host_reads, "evaluations": margm.slice_sample.evaluations}


def marg_call(fn, log: dict, name: str):
    """Run ``fn`` once on the card, ending in a synchronize; record its wall
    seconds, the launches of every kernel, the sampler's host reads and its
    log-density evaluations (one each per lock-step iteration, and one
    evaluation for the starting rows) under ``log[name]``."""
    import torch

    c0 = marg_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    log[name] = dict(seconds=time.perf_counter() - t0, **delta(c0, marg_counts()))
    return out


def marg_pick_gaps(esm32, deg32, esm64, near, idx):
    """``fleet_pick_gaps``' rule on hyper-averaged scores, (B, G) each: the
    pick (grid index ``idx`` (B,)) is held to the float64 optimum over the
    points the float32 scorer resolves under every row (``deg32`` False) away
    from the observations (``near`` False) → (gap, err, resolved), NaN where
    the pick is not such a point."""
    import torch

    ok = ~deg32 & ~near
    best = torch.where(ok, esm64, torch.full_like(esm64, -math.inf)).amax(1)
    at = esm64.gather(1, idx[:, None])[:, 0]
    err = torch.where(ok, (esm32 - esm64).abs() / esm64.abs(), torch.zeros_like(esm64)).amax(1)
    held = ok.gather(1, idx[:, None])[:, 0]
    nan = torch.full_like(best, math.nan)
    return torch.where(held, (best - at) / best, nan), torch.where(held, err, nan), ok.sum(1)


def _z_var_gh(state, opts):
    """V[Z] by the float32 path's estimator (the Gauss–Hermite bilinear form),
    evaluated in the state's dtype."""
    import torch

    from tpubq_torch.models import bq as bqm

    return torch.clamp(bqm._z_var_gh_terms(state, opts)[0], min=0.0)


def marg_vs_f64(zm32, zv32, zm64, zv64, zv64_gh) -> dict:
    """Marginalized estimates on the card (float32) against the float64 CPU
    path on the same rows: E[Z] per row; V[Z] (mean over each problem's
    rows) against the float64 evaluation of the float32 path's own
    estimator, the Gauss–Hermite form, and, reported beside it, against the
    closed form, from which the quadrature departs at rows whose log-GP
    length-scale it cannot resolve (``rows_gh_off_closed_form``: the float64
    quadrature more than 5e-2 off the closed form)."""
    zm32, zv32 = zm32.double().cpu(), zv32.double().cpu()
    mean_rel = lambda a, b: float((a.mean(-1) / b.mean(-1) - 1.0).abs().max())  # noqa: E731
    return dict(Z_mean_max_rel=float(((zm32 - zm64) / zm64).abs().max()), Z_var_mean_rel=mean_rel(zv32, zv64_gh),
                Z_var_mean_rel_closed_form=mean_rel(zv32, zv64),
                rows_gh_off_closed_form=int(((zv64_gh / zv64 - 1.0).abs() > ZVAR_RTOL).sum()),
                finite=bool(np.isfinite(zm32.numpy()).all() and np.isfinite(zv32.numpy()).all()))


def marginalize_path(dev) -> dict:
    """Hyper-marginalization through the facades on the card (see the module
    docstring, phase 4b): the single problem's samplers (θ_tl with 1 and 4
    chains, joint rows), marginalize and choose_next(n = 10); the fleet's
    sampler, marginalize, choose_next(n = 10) and a marginalized loop at
    B = 64, G = 10⁴. Estimates on rows the float64 port drew are held to
    the float64 path (the single problem's on the CPU, the fleet's on the
    card); picks by ``marg_pick_gaps``; launches and host reads
    are counted per call."""
    import torch

    from tpubq_torch import BQFleet
    from tpubq_torch.models import acquire, batched, bq as bqm, marginalize as margm
    from tpubq_torch.ops import hopper_kernels as hk

    grid = np.linspace(-4.0, 4.0, G)
    grid64 = torch.as_tensor(grid, dtype=torch.float64)
    grid_dev = torch.as_tensor(grid, dtype=torch.float32, device=dev)
    funs64 = (bqm.Z_mean, bqm.Z_var, _z_var_gh)  # float64, beside the float32 path's V[Z] estimator
    calls = {}
    zero_counts()
    margm.slice_sample.host_reads = margm.slice_sample.evaluations = 0
    total0 = marg_counts()

    # ---- the single problem (the testbed at its initial hypers)
    x = testbed_x(False)
    bq, bq64 = make_bq(x, dev, "float32", s=S_MAIN), make_bq(x, "cpu", "float64", s=S_MAIN)
    opts, opts64 = bq.options, bq64.options
    th_c1 = marg_call(lambda: bq.sample_hypers(n=MARG_N, seed=21), calls, "sample_hypers_c1")
    th_c4 = marg_call(lambda: bq.sample_hypers(n=MARG_N, seed=22, n_chains=4), calls, "sample_hypers_c4")
    th_j = marg_call(lambda: bq.sample_hypers(params=JOINT, n=MARG_N, seed=23), calls, "sample_hypers_joint")
    zm_fac, zv_fac = marg_call(lambda: bq.marginalize(n=MARG_N, seed=24), calls, "marginalize_sampled")
    rows64 = {"theta_tl": torch.as_tensor(bq64.sample_hypers(n=MARG_N, seed=25)),
              "joint": torch.as_tensor(bq64.sample_hypers(params=JOINT, n=MARG_N, seed=26))}
    single_marg = {}
    for kind, r64 in rows64.items():
        zm32, zv32 = marg_call(lambda: margm.marginalize(bq.state, opts, r64.to(dev, torch.float32)), calls,
                               f"marginalize_{kind}")
        single_marg[kind] = marg_vs_f64(zm32, zv32, *margm.marginalize(bq64.state, opts64, r64, funs64))
    x_pick = marg_call(lambda: bq.choose_next(grid, n=MARG_CHOOSE_N, seed=27), calls, "choose_next_n10")
    torch.cuda.synchronize()

    # ---- the fleet (the fleet path's recipe at its initial hypers)
    xs, ls, mus = fleet_data(FLEET_B, FLEET_N_OBS)
    kw = dict(params_tl=PARAMS_TL, params_l=PARAMS_L, n_candidate=12, candidate_thresh=0.2,
              max_obs=FLEET_MAX_OBS, s=S_MAIN)
    fleet = BQFleet(xs, ls, device=dev, dtype="float32", **kw)
    # the float64 fleet on the card: on the CPU its sampler and its 640
    # re-anchored states' scores take ~20 s (the library routes only: a float64
    # state launches none of the port's kernels)
    fleet64 = BQFleet(xs, ls, device=dev, dtype="float64", **kw)
    fth = marg_call(lambda: fleet.sample_hypers(n=MARG_N, seed=31), calls, "fleet_sample_hypers")
    fzm_fac, fzv_fac = marg_call(lambda: fleet.marginalize(n=MARG_N, seed=32), calls, "fleet_marginalize_sampled")
    frows64 = torch.as_tensor(fleet64.sample_hypers(n=MARG_N, seed=33))
    fzm32, fzv32 = marg_call(lambda: batched.marginalize_batch(fleet.states, fleet.options,
                                                               frows64.to(dev, torch.float32)),
                             calls, "fleet_marginalize")
    fleet_marg = marg_vs_f64(fzm32, fzv32, *(t.cpu() for t in batched.marginalize_batch(
        fleet64.states, fleet64.options, frows64, funs64)))
    fx_pick = marg_call(lambda: fleet.choose_next(grid, n=MARG_CHOOSE_N, seed=34), calls, "fleet_choose_next_n10")
    loop_fleet = BQFleet.from_states(fleet.states, fleet.options)
    lik = lambda x: torch.exp(-0.5 * ((x[0] - MU_L) / SIG_L) ** 2) / (SIG_L * math.sqrt(2.0 * math.pi))  # noqa: E731
    loop_zm, loop_zv = marg_call(lambda: loop_fleet.run_active_loop(lik, grid, MARG_LOOP_STEPS, n=MARG_CHOOSE_N,
                                                                    seed=35), calls, "fleet_run_active_loop_n10")
    total = delta(total0, marg_counts())

    # ---- everything below compares; none of it counts as the path's launches
    # the single pick: the same rows as choose_next drew (same seed, same
    # sampler), scored by the plain twin in float32 and by the float64 path
    rows = torch.as_tensor(bq.sample_hypers(n=MARG_CHOOSE_N, seed=27), device=dev)
    esm32 = torch.zeros(G, dtype=torch.float64)
    deg32 = torch.zeros(G, dtype=torch.bool)
    for r in rows:
        st_r = bqm.apply_hyper_sample(bq.state, opts, r)
        esm32 += hk.esm_fused_plain(*acquire.esm_fused_inputs(st_r, opts, grid_dev[:, None])).double().cpu()
        deg32 |= acquire._esm_affine_terms(st_r, opts, grid_dev[:, None])[2].cpu()
    _, esm64 = acquire.choose_next(bq64.state, opts64, grid64, rows.double().cpu())
    near = ((grid64[:, None] - bq64.state.x_s[None, :, 0]).abs() < opts.candidate_thresh) & bq64.state.obs_mask
    idx = (grid64 - x_pick).abs().argmin()
    gap, err, n_ok = marg_pick_gaps((esm32 / len(rows))[None], deg32[None], esm64[None], near.any(1)[None],
                                    idx[None])

    # the fleet's picks: its rows, the kernels held to their plain twins on
    # the flattened fleet of B·n re-anchored states, the average held to float64
    frows = torch.as_tensor(fleet.sample_hypers(n=MARG_CHOOSE_N, seed=34), device=dev)
    B, S = frows.shape[:2]
    st_f = bqm.apply_hyper_sample(fleet.states, fleet.options, frows)
    flat = bqm.tree_map(lambda a: a.expand(B, S, *a.shape[2:]).reshape(B * S, *a.shape[2:]), st_f)
    flat_case = fleet_vs_plain(flat, fleet.options, grid_dev[:, None], max_flips=MAX_FLEET_FLIPS * S,
                               step="choose_next_n10")
    fesm32, fdeg32, _ = fleet_scores_plain(flat, fleet.options, grid_dev[:, None])
    fesm32 = fesm32.double().cpu().reshape(B, S, G).mean(1)
    fdeg32 = fdeg32.cpu().reshape(B, S, G).any(1)
    fesm64 = batched._marg_scores(fleet64.states, fleet64.options, grid64, frows.double()).cpu()
    dist = (grid_dev[None, :, None] - fleet.states.x_s[:, None, :, 0]).abs()
    fnear = ((dist < fleet.options.candidate_thresh) & fleet.states.obs_mask[:, None, :]).any(-1).cpu()
    fidx = (grid64[None, :] - torch.as_tensor(fx_pick[:, 0], dtype=torch.float64)[:, None]).abs().argmin(1)
    fgap, ferr, fn_ok = marg_pick_gaps(fesm32, fdeg32, fesm64, fnear, fidx)
    fgap_ok = torch.isnan(fgap) | (fgap <= torch.clamp(2.0 * ferr, min=ESM_ARGMAX_RTOL))

    # exact launches: a log density is one chol_batch stack of all rows (θ_tl)
    # or two (joint: the log-GP's fixed-jitter fit, the linear GP's MLL)
    NP, NP2 = opts.max_nsc, opts.max_obs
    chunks = -(-MARG_CHOOSE_N // batched.marg_chunk(FLEET_B, MARG_CHOOSE_N, G, fleet.options))
    want = {
        "sample_hypers_c1": dict(chol_batch=calls["sample_hypers_c1"]["evaluations"], gaussian_gram=0),
        "sample_hypers_c4": dict(chol_batch=calls["sample_hypers_c4"]["evaluations"], gaussian_gram=0),
        "sample_hypers_joint": dict(chol_batch=2 * calls["sample_hypers_joint"]["evaluations"], gaussian_gram=0),
        "marginalize_theta_tl": marginalize_counts(opts),
        "marginalize_joint": dict(chol_batch=2, gaussian_gram=0, cholesky_blocked=0, tri_solve_blocked=0),
        "choose_next_n10": dict(chol_batch=calls["choose_next_n10"]["evaluations"],
                                esm_fused=MARG_CHOOSE_N * hk.esm_fused_launches(NP, NP2, 1)),
        "fleet_sample_hypers": dict(chol_batch=calls["fleet_sample_hypers"]["evaluations"], gaussian_gram=0),
        "fleet_marginalize": dict(chol_batch=2, gaussian_gram=0, esm_fleet_l=0),
        "fleet_choose_next_n10": dict(chol_batch=calls["fleet_choose_next_n10"]["evaluations"] + 2 * chunks,
                                      esm_fleet_l=chunks, esm_fleet_tl=chunks, esm_fused=0),
        "fleet_run_active_loop_n10": dict(
            chol_batch=calls["fleet_run_active_loop_n10"]["evaluations"] + MARG_LOOP_STEPS * (2 * chunks + 2),
            esm_fleet_l=MARG_LOOP_STEPS * chunks, esm_fleet_tl=MARG_LOOP_STEPS * chunks),
    }
    launch_failures = {k: {q: (calls[k][q], v) for q, v in w.items() if calls[k][q] != v}
                       for k, w in want.items() if any(calls[k][q] != v for q, v in w.items())}
    sampler_calls = [k for k in calls if calls[k]["evaluations"]]
    res = dict(
        B=FLEET_B, G=G, n=MARG_N, choose_n=MARG_CHOOSE_N, s=S_MAIN, calls=calls, launches=total,
        sampler_host_reads_per_call={k: calls[k]["host_reads"] for k in sampler_calls},
        sampler_iterations_per_call={k: calls[k]["evaluations"] - 1 for k in sampler_calls},
        draws=dict(c1=[list(th_c1.shape), float(th_c1.min()), float(th_c1.max())],
                   c4=[list(th_c4.shape), float(th_c4.min()), float(th_c4.max())],
                   joint=[list(th_j.shape), float(th_j.min()), float(th_j.max())],
                   fleet=[list(fth.shape), float(fth.min()), float(fth.max())]),
        single_marginalize=single_marg, pick=x_pick, pick_gap=float(gap[0]), esm_f32_err=float(err[0]),
        resolved_points=int(n_ok[0]),
        fleet_marginalize=fleet_marg,
        fleet_pick_gap_max=float(torch.nan_to_num(fgap, nan=0.0).max()),
        fleet_picks_on_the_plateau=int(torch.isnan(fgap).sum()), fleet_resolved_points_min=int(fn_ok.min()),
        fleet_choose_kernels_vs_plain={k: flat_case[k] for k in ("norm_err", "plain_f32_vs_f64", "degenerate_flips",
                                                                   "failures")},
        loop_Z_var_first_last=[loop_zv[0].tolist()[:4], loop_zv[-1].tolist()[:4]],
        launch_failures=launch_failures,
        tol=dict(Z_mean=MARG_MEAN_RTOL, Z_var=ZVAR_RTOL, esm_argmax=ESM_ARGMAX_RTOL),
    )
    emit("marginalize_path", **res)
    finite = lambda a: bool(np.all(np.isfinite(np.asarray(a))))  # noqa: E731
    for name, th in (("c1", th_c1), ("c4", th_c4), ("joint", th_j), ("fleet", fth)):
        check(finite(th) and bool(np.all(th > 0)), f"sampled hypers finite and positive ({name})")
    check(th_c1.shape == th_c4.shape == (MARG_N, 2) and th_j.shape == (MARG_N, 4) and fth.shape == (FLEET_B, MARG_N, 2),
          "sampled hypers' shapes")
    check(all(calls[k]["host_reads"] <= calls[k]["evaluations"] - 1 for k in sampler_calls),
          f"at most one host read per lock-step iteration ({res['sampler_host_reads_per_call']})")
    check(not launch_failures, f"exact launches on the marginalize path: {launch_failures}")
    check(all(total[k] > 0 for k in ("chol_batch", "esm_fused", "esm_fleet_l", "esm_fleet_tl")),
          f"every kernel of the marginalize path launched ({total})")
    for kind, m in single_marg.items():
        check(m["finite"], f"marginalize finite ({kind})")
        check(m["Z_mean_max_rel"] <= MARG_MEAN_RTOL, f"marginalized E[Z] f32 card vs f64 CPU ({kind}: {m})")
        check(m["Z_var_mean_rel"] <= ZVAR_RTOL, f"marginalized mean V[Z] f32 card vs f64 CPU ({kind}: {m})")
    check(finite(zm_fac) and finite(zv_fac) and finite(fzm_fac) and finite(fzv_fac), "BQ / BQFleet.marginalize finite")
    check(fleet_marg["finite"], "fleet marginalize finite")
    check(fleet_marg["Z_mean_max_rel"] <= MARG_MEAN_RTOL, f"fleet marginalized E[Z] f32 card vs f64 CPU ({fleet_marg})")
    check(fleet_marg["Z_var_mean_rel"] <= ZVAR_RTOL, f"fleet marginalized mean V[Z] f32 card vs f64 CPU ({fleet_marg})")
    check(bool(torch.isnan(gap).all() or gap[0] <= max(ESM_ARGMAX_RTOL, 2.0 * float(err[0]))),
          f"the marginalized pick is the f64 optimum over the resolved points ({res['pick_gap']})")
    check(int(n_ok[0]) > 0, "the f32 scorer resolves points under every row")
    check(bool(fgap_ok.all()), "each marginalized fleet pick is the f64 optimum over the resolved points")
    check(not flat_case["failures"], f"fleet kernels on the re-anchored fleet: {flat_case['failures']}")
    check(finite(loop_zm) and finite(loop_zv) and loop_zm.shape == (MARG_LOOP_STEPS, FLEET_B),
          "the marginalized fleet loop's moments")
    check(bool(np.all(loop_fleet.ns == FLEET_N_OBS + MARG_LOOP_STEPS)), "the marginalized loop added its observations")
    return {"launches": total, "host_reads": res["sampler_host_reads_per_call"],
            "calls": calls, "l_max_abs_err": max(flat_case["max_abs_err"][n] for n in ("A", "B")),
            "tl_max_abs_err": max(flat_case["max_abs_err"][n] for n in ("m_a", "c_a"))}


# ---------------------------------------------------------------------------
# the other kernel families: matern52, matern32, rq and periodic through the
# BQ facade (and a Matérn fleet) on the card
# ---------------------------------------------------------------------------

#: (kernel, d) of each single configuration; d = 2 takes the Gamma-mixture route.
FAMILY_CONFIGS = (("matern52", 1), ("matern32", 1), ("rq", 1), ("periodic", 1), ("matern52", 2))
#: (θ_tl, θ_l) at init: the testbed's hypers, with α = 2 for rq and a unit period.
FAMILY_PARAMS = {"matern52": (PARAMS_TL, PARAMS_L), "matern32": (PARAMS_TL, PARAMS_L),
                 "rq": (PARAMS_TL + (2.0,), PARAMS_L + (2.0,)), "periodic": ((0.7, 0.8, 1.0), (0.35, 0.8, 1.0))}
FAMILY_MAX_OBS, FAMILY_N_OBS, FAMILY_STEPS = 32, 10, 10
FAMILY_MARG_N = {1: 100, 2: 20}
FAMILY_GRID_2D = 100  # points per axis of the d = 2 grid (10⁴ in all)
FAMILY_WRAPPERS = ("cholesky_blocked", "tri_solve_blocked", "chol_batch")
FAMILY_FLEET_KERNEL, FAMILY_FLEET_STEPS = "matern52", 3
# float32 V[Z] is held to the float64 path at ZVAR_RTOL, as on the main path:
# after a fit the float32 factors' own error (eps32 × the Gram's condition
# number) reaches V[Z] through the closed form's αᵀTα − gᵀK⁻¹g cancellation,
# 1.5e-3 on the CPU's float32 for Matérn-5/2. The closed form's 1e-4 pin of
# tests/test_matern_zvar.py:92 (unfitted states) is held on the card by
# tests/test_torch_gpu.py.


def family_lik(kernel: str, x):
    """The fixed likelihood of a family configuration: the testbed's
    N(x; 0.2, 0.5²) in 1-D, N(x; (0.2, −0.1), 0.5² I) in 2-D, and for the
    periodic kernel the periodic recipe of tests/test_periodic_exact.py,
    exp(cos 2x)/8 + 0.05 (on the gaussian bump its fit settles on w ≈ 2.3, a
    kernel so close to constant that float32 resolves no grid point)."""
    x = np.asarray(x, np.float64)
    if kernel == "periodic":
        return np.exp(np.cos(2.0 * x)) / 8.0 + 0.05
    if x.ndim == 0 or x.shape[-1] != 2:
        return f_l(x)
    r2 = ((x - np.array([0.2, -0.1])) ** 2).sum(-1) / SIG_L**2
    return np.exp(-0.5 * r2) / (2.0 * math.pi * SIG_L**2)


def family_data(d: int):
    """(x, grid): 10 observations and a 10⁴-point grid (100 × 100 in 2-D)."""
    if d == 1:
        return testbed_x(False), np.linspace(-4.0, 4.0, G)[:, None]
    rng = np.random.RandomState(5)
    x = rng.uniform(-2.0, 2.0, (FAMILY_N_OBS, 2))
    g = np.linspace(-3.0, 3.0, FAMILY_GRID_2D)
    return x, np.stack([a.ravel() for a in np.meshgrid(g, g, indexing="ij")], -1)


def family_bq(kernel, d, x, device, dtype):
    from tpubq_torch import BQ

    bq = BQ(x, family_lik(kernel, x), device=device, dtype=dtype, kernel=kernel, max_obs=FAMILY_MAX_OBS, n_candidate=12,
            candidate_thresh=0.2, x_mean=np.zeros(d), x_var=np.eye(d), s=S_MAIN)
    return bq.init(params_tl=FAMILY_PARAMS[kernel][0] if d == 1 else (0.7, 0.8, 0.8),
                   params_l=FAMILY_PARAMS[kernel][1] if d == 1 else (0.3, 0.4, 0.4))


def family_counts() -> dict:
    from tpubq_torch.ops import hopper_kernels as hk

    return {k: getattr(hk, k).launches for k in MARG_WRAPPERS}


def family_pick_gaps(st32, opts, st64, opts64, x_card, grid32, grid64):
    """``fleet_pick_gaps``' rule for a fleet state (or a single one with a
    leading axis of 1) of any family, with the plain scorer: each pick
    (``x_card`` (B, d)) is held to the float64 optimum over the points the
    float32 scorer resolves away from the observations → (gap, err,
    resolved, score_err), gap and err NaN where the pick is not such a
    point; score_err is the float32 scores' largest error on the points both
    dtypes' guards resolve, over the largest float64 score (NaN where the
    two share no resolved point)."""
    import torch

    from tpubq_torch.models import acquire

    esm32 = acquire.expected_squared_mean_xla(st32, opts, grid32).double()
    deg32 = acquire._esm_affine_terms(st32, opts, grid32)[2]
    esm64 = acquire.expected_squared_mean_xla(st64, opts64, grid64).to(esm32.device)
    deg64 = acquire._esm_affine_terms(st64, opts64, grid64)[2].to(esm32.device)
    dist = (grid32[None, :, None, :] - st32.x_s[:, None, :, :]).abs().amax(-1)
    near = ((dist < opts.candidate_thresh) & st32.obs_mask[:, None, :]).any(-1)
    ok = ~deg32 & ~near
    best = torch.where(ok, esm64, torch.full_like(esm64, -math.inf)).amax(1)
    xc = torch.as_tensor(np.asarray(x_card), dtype=grid32.dtype, device=grid32.device)
    idx = (grid32[None, :, :] - xc[:, None, :]).abs().amax(-1).argmin(1)
    at = esm64.gather(1, idx[:, None])[:, 0]
    err = torch.where(ok, (esm32 - esm64).abs() / esm64.abs(), torch.zeros_like(esm64)).amax(1)
    held = ok.gather(1, idx[:, None])[:, 0]
    nan = torch.full_like(best, math.nan)
    both = ~deg32 & ~deg64
    score_err = torch.where(both, (esm32 - esm64).abs(), torch.zeros_like(esm64)).amax(1) / esm64.abs().amax(1)
    return (torch.where(held, (best - at) / best, nan).cpu(), torch.where(held, err, nan).cpu(), ok.sum(1).cpu(),
            torch.where(both.any(1), score_err, nan).cpu())


def family_zvar_check(zv32, v64_path) -> dict:
    """The float32 V[Z] (a single value or one per fleet problem) against the
    float64 path's ``v64_path`` (its own factors) at ZVAR_RTOL."""
    zv32 = np.atleast_1d(np.asarray(zv32, np.float64))
    v64_path = np.atleast_1d(np.asarray(v64_path, np.float64))
    path_rel = float(np.max(np.abs(zv32 - v64_path) / v64_path))
    return dict(path_rel=path_rel, within=path_rel <= ZVAR_RTOL)


def family_run(dev, kernel: str, d: int) -> dict:
    """One family configuration through the BQ facade on the card in float32
    (init → fit_hypers → Z → 10 × (choose_next → add_observation) →
    marginalize), held to the port's float64 path on the card (the CPU's
    float64 Matérn sweep at 100 rows takes a minute) on the same data, hypers,
    picks and hyper rows. One pick at the init hypers, before the fit, is
    held first: there float32 resolves points for every family, where a
    fitted periodic kernel leaves it none."""
    import warnings

    import torch

    from tpubq_torch.models import acquire, bq as bqm, gp as gpm, marginalize as margm
    from tpubq_torch.ops import hopper_kernels as hk
    from tpubq_torch.ops.kernels import get_kernel

    x, grid = family_data(d)
    grid32 = torch.as_tensor(grid, dtype=torch.float32, device=dev)
    grid64 = torch.as_tensor(grid, dtype=torch.float64, device=dev)
    zv_route = bqm._z_var_dispatch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        bq = family_bq(kernel, d, x, dev, "float32")
        bq64 = family_bq(kernel, d, x, dev, "float64")
        opts, opts64 = bq.options, bq64.options
        one = lambda st: bqm.tree_map(lambda a: a[None], st)  # noqa: E731
        x_init = np.atleast_1d(bq.choose_next(grid if d > 1 else grid[:, 0]))
        init_pick = [float(v[0]) for v in family_pick_gaps(one(bq.state), opts, one(bq64.state), opts64,
                                                           x_init[None, :], grid32, grid64)]
        for k in MARG_WRAPPERS:
            getattr(hk, k).launches = 0
        t0 = time.perf_counter()
        bq.fit_hypers(ntry=FIT_RESTARTS, seed=FIT_SEED)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = family_counts()
        zm0, zv0 = bq.Z_mean(), bq.Z_var()
        step_s, steps = [], []
        for _ in range(FAMILY_STEPS):
            st32 = bq.state
            c0, t1 = family_counts(), time.perf_counter()
            xn = np.atleast_1d(bq.choose_next(grid if d > 1 else grid[:, 0]))
            bq.add_observation(xn if d > 1 else float(xn[0]), float(family_lik(kernel, xn if d > 1 else xn[0])))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            steps.append((st32, xn, delta(c0, family_counts())))
        zm1, zv1 = bq.Z_mean(), bq.Z_var()
        c0, t1 = family_counts(), time.perf_counter()
        zms, zvs = bq.marginalize(n=FAMILY_MARG_N[d], seed=4)
        torch.cuda.synchronize()
        marg_s = time.perf_counter() - t1
        marg_launches = delta(c0, family_counts())
        launches = family_counts()

        # ---- the float64 reference on the card; none of this counts as the path's launches
        kfn, _ = get_kernel(kernel)
        st0 = bq64.state
        th_tl, th_l = (t.to(dev, torch.float64) for t in (bq.state.gp_log_l.theta, bq.state.gp_l.theta))
        mll = lambda th: float(gpm.log_mll(kfn, th, st0.gp_log_l.s, st0.x_s, st0.tl_s, st0.obs_mask, 1e-10))  # noqa: E731
        fit_gain = mll(th_tl) - mll(st0.gp_log_l.theta)
        bq64._state = bqm.set_params(st0, opts64, theta_tl=th_tl, theta_l=th_l)
        z64_start = (bq64.Z_mean(), bq64.Z_var())
        gaps, errs, resolved, score_errs = [], [], [], []
        for st32, xn, _ in steps:
            g, e, n_ok, se = family_pick_gaps(one(st32), opts, one(bq64.state), opts64, xn[None, :], grid32, grid64)
            gaps.append(float(g[0]))
            errs.append(float(e[0]))
            resolved.append(int(n_ok[0]))
            score_errs.append(float(se[0]))
            bq64.add_observation(xn if d > 1 else float(xn[0]), float(family_lik(kernel, xn if d > 1 else xn[0])))
        thetas = torch.as_tensor(bq64.sample_hypers(n=FAMILY_MARG_N[d], seed=7), device=dev)
        zm32s, zv32s = margm.marginalize(bq.state, opts, thetas.float())
        zm64s, zv64s = margm.marginalize(bq64.state, opts64, thetas)
    warned = sorted({str(w.message) for w in caught if issubclass(w.category, UserWarning)})
    zv_start = family_zvar_check(zv0, z64_start[1])
    zv_end = family_zvar_check(zv1, bq64.Z_var())
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    marg_mean_rel = float(((zm32s.double() - zm64s).abs() / zm64s.abs()).max())
    marg_var_rel = rel(float(zv32s.double().mean()), float(zv64s.mean()))
    gap_ok = [math.isnan(g) or g <= max(ESM_ARGMAX_RTOL, 2.0 * e) for g, e in zip(gaps, errs)]
    score_ok = [math.isnan(e) or e <= ESM_SCORE_RTOL for e in score_errs]
    res = dict(
        kernel=kernel, d=d, G=int(grid.shape[0]), max_obs=FAMILY_MAX_OBS, s=S_MAIN,
        routes=dict(fit="lbfgs (autograd; the fused fit is gaussian-only)", esm=acquire.esm_route(bq.state, opts),
                    z_var=zv_route(opts).__name__, z_var_f64=zv_route(opts64).__name__,
                    int_K={"periodic": "harmonic series", "rq": "rq mixture"}.get(
                        kernel, "erfcx closed form" if d == 1 else "matern mixture")),
        theta_tl=th_tl.tolist(), theta_l=th_l.tolist(), fit_mll_gain=fit_gain,
        fit_s=fit_s, step_s=step_s, step_s_median=float(np.median(step_s)), marginalize_s=marg_s,
        launches=dict(fit=fit_launches, step=steps[0][2], marginalize=marg_launches, total=launches),
        Z_mean_rel=max(rel(zm0, z64_start[0]), rel(zm1, bq64.Z_mean())), Z_var_start=zv_start, Z_var_end=zv_end,
        init_pick=dict(x=x_init.tolist(), gap=init_pick[0], esm_f32_err=init_pick[1],
                       f32_resolved_points=int(init_pick[2]), score_err=init_pick[3]),
        pick_gaps=gaps, esm_f32_errs=errs, f32_resolved_points=resolved, score_errs=score_errs,
        marg_n=FAMILY_MARG_N[d], marg_Z_mean_max_rel=marg_mean_rel, marg_Z_var_mean_rel=marg_var_rel,
        marginalize_finite=bool(np.all(np.isfinite(zms)) and np.all(np.isfinite(zvs))),
        warnings=warned, tol=dict(Z_mean=ZMEAN_RTOL, Z_var=ZVAR_RTOL, marg_mean=MARG_MEAN_RTOL,
                                  esm_argmax=ESM_ARGMAX_RTOL, esm_score=ESM_SCORE_RTOL))
    emit("families_path", **res)
    tag = f"{kernel} d={d}"
    check(fit_gain >= 0.0, f"{tag}: the fit did not lower the log-GP's MLL ({fit_gain})")
    check(res["Z_mean_rel"] <= ZMEAN_RTOL, f"{tag}: Z_mean f32 card vs f64 ({res['Z_mean_rel']})")
    check(zv_start["within"] and zv_end["within"], f"{tag}: Z_var f32 card vs f64 ({zv_start}, {zv_end})")
    g0, e0, n0, se0 = init_pick
    check(n0 > 0 and not math.isnan(g0) and g0 <= max(ESM_ARGMAX_RTOL, 2.0 * e0) and se0 <= ESM_SCORE_RTOL,
          f"{tag}: at the init hypers the pick is the f64 optimum over the {n0:.0f} resolved points "
          f"(gap {g0}, err {e0}) and the scores agree with f64 ({se0})")
    check(all(gap_ok), f"{tag}: each pick is the f64 optimum over the resolved points ({gaps}, {errs})")
    check(all(score_ok), f"{tag}: f32 scores vs f64 where both guards resolve ({score_errs})")
    # a fitted periodic kernel whose period the data span resolves no grid
    # point in float32 (the float64 guard about half; ROADMAP §3 g): its
    # picks are the plateau's (gap NaN), and the init pick above holds its
    # scorer to float64
    check(kernel == "periodic" or resolved[0] > 0, f"{tag}: the f32 scorer resolves points after the fit")
    check(res["marginalize_finite"], f"{tag}: marginalize finite")
    check(marg_mean_rel <= MARG_MEAN_RTOL, f"{tag}: marginalized E[Z] f32 vs f64 on the same rows ({marg_mean_rel})")
    check(marg_var_rel <= ZVAR_RTOL, f"{tag}: marginalized mean V[Z] f32 vs f64 on the same rows ({marg_var_rel})")
    check(all(launches[k] > 0 for k in FAMILY_WRAPPERS), f"{tag}: every factorization kernel launched {launches}")
    check(launches["esm_fused"] == 0 and launches["gaussian_gram"] == 0 and launches["mll_grad_batched"] == 0,
          f"{tag}: the gaussian-only kernels stay off the family path {launches}")
    return res


def family_fleet(dev) -> dict:
    """The Matérn-5/2 fleet at B = 64 through BQFleet on the card: fit → Z →
    3 × (choose_next → add_observation), held per problem to the float64
    fleet on the card with the card's hypers and picks."""
    import torch

    from tpubq_torch import BQFleet
    from tpubq_torch.models import bq as bqm
    from tpubq_torch.ops import hopper_kernels as hk

    xs, ls, mus = fleet_data(FLEET_B, FLEET_N_OBS)
    kw = dict(params_tl=PARAMS_TL, params_l=PARAMS_L, n_candidate=12, candidate_thresh=0.2, max_obs=FLEET_MAX_OBS,
              s=S_MAIN, kernel=FAMILY_FLEET_KERNEL)
    fleet = BQFleet(xs, ls, device=dev, dtype="float32", **kw)
    fleet64 = BQFleet(xs, ls, device=dev, dtype="float64", **kw)
    opts, opts64 = fleet.options, fleet64.options
    grid = np.linspace(-4.0, 4.0, G)
    grid32 = torch.as_tensor(grid, dtype=torch.float32, device=dev)[:, None]
    grid64 = torch.as_tensor(grid, dtype=torch.float64, device=dev)[:, None]
    for k in MARG_WRAPPERS:
        getattr(hk, k).launches = 0
    t0 = time.perf_counter()
    fleet.fit(ntry=FIT_RESTARTS, seed=FIT_SEED)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = family_counts()
    zm0, zv0 = fleet.Z_mean(), fleet.Z_var()
    steps, step_s = [], []
    for _ in range(FAMILY_FLEET_STEPS):
        st32, t1 = fleet.states, time.perf_counter()
        xn = fleet.choose_next(grid)
        fleet.add_observation(xn, fleet_lik(xn[:, 0], mus))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        steps.append((st32, xn))
    zm1, zv1 = fleet.Z_mean(), fleet.Z_var()
    torch.cuda.synchronize()
    launches = family_counts()

    st64 = fleet64.states
    fleet64._states = bqm.set_params(st64, opts64, theta_tl=fleet.states.gp_log_l.theta.double(),
                                     theta_l=fleet.states.gp_l.theta.double())
    zv_route = bqm._z_var_dispatch(opts)
    zm64_0, zv64_0 = fleet64.Z_mean(), fleet64.Z_var()
    gaps, errs, score_errs = [], [], []
    for st32, xn in steps:
        g, e, _, se = family_pick_gaps(st32, opts, fleet64.states, opts64, xn, grid32, grid64)
        gaps.append(g)
        errs.append(e)
        score_errs.append(se)
        fleet64.add_observation(xn, fleet_lik(xn[:, 0], mus))
    gaps, errs, score_errs = torch.stack(gaps), torch.stack(errs), torch.stack(score_errs)
    gap_ok = torch.isnan(gaps) | (gaps <= torch.clamp(2.0 * errs, min=ESM_ARGMAX_RTOL))
    score_ok = torch.isnan(score_errs) | (score_errs <= ESM_SCORE_RTOL)
    rel = lambda a, b: float(np.max(np.abs(a - b) / np.abs(b)))  # noqa: E731
    zv_start = family_zvar_check(zv0, zv64_0)
    zv_end = family_zvar_check(zv1, fleet64.Z_var())
    res = dict(kernel=FAMILY_FLEET_KERNEL, B=FLEET_B, G=G, max_obs=FLEET_MAX_OBS, steps=FAMILY_FLEET_STEPS,
               routes=dict(fit="lbfgs, all B·ntry rows in lock step", esm="plain batched",
                           z_var=zv_route.__name__),
               fit_s=fit_s, step_s=step_s, launches=dict(fit=fit_launches, total=launches),
               Z_mean_rel=max(rel(zm0, zm64_0), rel(zm1, fleet64.Z_mean())), Z_var_start=zv_start, Z_var_end=zv_end,
               pick_gap_max=float(torch.nan_to_num(gaps, nan=0.0).max()),
               esm_f32_err_max=float(torch.nan_to_num(errs, nan=0.0).max()),
               score_err_max=float(torch.nan_to_num(score_errs, nan=0.0).max()),
               picks_on_the_plateau=int(torch.isnan(gaps).sum()))
    emit("families_fleet", **res)
    check(res["Z_mean_rel"] <= ZMEAN_RTOL, f"Matérn fleet Z_mean f32 card vs f64 ({res['Z_mean_rel']})")
    check(zv_start["within"] and zv_end["within"], f"Matérn fleet Z_var f32 card vs f64 ({zv_start}, {zv_end})")
    check(bool(gap_ok.all()), "each Matérn fleet pick is the f64 optimum over the resolved points")
    check(bool(score_ok.all()), f"Matérn fleet f32 scores vs f64 where both guards resolve ({res['score_err_max']})")
    check(launches["chol_batch"] > 0, f"the Matérn fleet refits through chol_batch {launches}")
    check(bool(np.all(fleet.ns == FLEET_N_OBS + FAMILY_FLEET_STEPS)), "the Matérn fleet added its observations")
    return res


def families_path(dev) -> dict:
    """Phase 4c: the four other kernel families (see the module docstring)."""
    t0 = time.perf_counter()
    runs = {f"{k}_d{d}": family_run(dev, k, d) for k, d in FAMILY_CONFIGS}
    runs[f"fleet_{FAMILY_FLEET_KERNEL}"] = family_fleet(dev)
    emit("families_elapsed", seconds=time.perf_counter() - t0)
    return {name: r["launches"]["total"] for name, r in runs.items()}


# ---------------------------------------------------------------------------
# phase 4d: the serving surface — refinement, health, checkpoints, the GP
# facade, profiling
# ---------------------------------------------------------------------------

FACADE_MARG_N = 10  # hyper rows of the marginalized refinement
FACADE_SEED = 5
# health() in float32 against the float64 path on the same data and hypers:
# the flags equal, the rung-0 jitter (base_jitter × the mean live diagonal)
# equal up to float32's rounding of that mean, cond(K) ≈ (max/min diag L)²
# within a factor 2, and the clamped share of V[Z] at the rounding floor.
HEALTH_FLAGS = ("l_s_finite", "alpha_l_finite", "alpha_tl_finite", "factor_ok_tl", "factor_ok_l",
                "gp_log_l.finite", "gp_l.finite")
HEALTH_JITTER_RTOL, HEALTH_COND_FACTOR, HEALTH_CLAMP_MAX = 1e-5, 2.0, 1e-3
# The GP facade at the large-N recipe's first 244 points (s = 0.05) in
# float32 on the card against float64 on the CPU: the posterior mean within
# 1e-3 of its largest value, log_lh within 1e-3 relative.
GP_FACADE_MAX_OBS, GP_FACADE_TOL = 256, 1e-3
TIMING_KW = dict(iters=5, warmup=1, repeats=3)


def _leaves(d: dict, prefix: str = ""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def health_vs(d32: dict, d64: dict, what: str) -> dict:
    """Hold one problem's float32 health to another's (float64, or a single
    BQ against its fleet row): flags equal, jitters and cond(K) as above."""
    a, b = dict(_leaves(d32)), dict(_leaves(d64))
    flags = {k: (bool(a[k]), bool(b[k])) for k in HEALTH_FLAGS}
    jit = {k: abs(float(a[k]) - float(b[k])) / abs(float(b[k])) for k in ("jitter_tl", "jitter_l")}
    cond = {k: float(a[k]) / float(b[k]) for k in ("gp_log_l.cond_estimate", "gp_l.cond_estimate")}
    out = dict(flags=flags, jitter_rel=jit, cond_ratio=cond, ns=(int(a["ns"]), int(b["ns"])),
               nc=(int(a["nc"]), int(b["nc"])), z_var_clamped_rel=float(a["z_var_clamped_rel"]))
    check(all(x == y for x, y in flags.values()), f"health flags equal ({what}: {flags})")
    check(out["ns"][0] == out["ns"][1] and out["nc"][0] == out["nc"][1], f"ns and nc equal ({what})")
    check(all(v <= HEALTH_JITTER_RTOL for v in jit.values()), f"jitters equal ({what}: {jit})")
    check(all(1.0 / HEALTH_COND_FACTOR <= v <= HEALTH_COND_FACTOR for v in cond.values()),
          f"cond_estimate within {HEALTH_COND_FACTOR}x ({what}: {cond})")
    return out


def facade_refine(bq, bq64, grid_dev, rows) -> dict:
    """choose_next over the grid, then refine_next from its pick (under the
    hyper rows ``rows`` or none), on the card; the refined point held to the
    grid pick by the float64 ESM of the port's CPU path (the same data,
    hypers and rows), up to PERF.md §2's pick allowance: max(1e-5, 2 × the
    float32 scorer's relative error at either point)."""
    import torch

    from tpubq_torch.models import acquire, bq as bqm

    st, opts = bq.state, bq.options
    x0, _ = acquire.choose_next(st, opts, grid_dev, rows)
    x_ref, v_ref = acquire.refine_next(st, opts, x0, rows)
    _, v0 = acquire.refine_next(st, opts, x0, rows, n_steps=0)  # the plain float32 score at x0
    st64 = bq64.state
    if rows is not None:
        st64 = bqm.apply_hyper_sample(st64, bq64.options, rows.double().cpu())
    e64 = lambda x: acquire.expected_squared_mean_xla(  # noqa: E731
        st64, bq64.options, x.double().cpu()[None, :]).reshape(-1).mean().item()
    v0, v_ref = v0.item(), v_ref.item()
    at0, atr = e64(x0), e64(x_ref)
    err = max(abs(v0 - at0) / abs(at0), abs(v_ref - atr) / abs(atr))
    allowance = max(ESM_ARGMAX_RTOL, 2.0 * err)
    res = dict(n=0 if rows is None else int(rows.shape[0]), x_grid=x0.item(), x_refined=x_ref.item(),
               esm_f32_grid=v0, esm_f32_refined=v_ref, esm_f64_grid=at0, esm_f64_refined=atr,
               f32_rel_err=err, allowance=allowance)
    check(v_ref >= v0, f"the refined float32 ESM is at least the start's ({res})")
    check(atr >= at0 * (1.0 - allowance), f"the refined point's float64 ESM is at least the grid pick's ({res})")
    return res


def facade_path(dev) -> dict:
    """Phase 4d: the single-device serving surface through ``BQ`` and
    ``BQFleet`` on the card (see the module docstring)."""
    import shutil
    import tempfile

    import torch

    from tpubq_torch import BQ, BQFleet
    from tpubq_torch.models import acquire, bq as bqm, gp as gpm
    from tpubq_torch.ops import hopper_kernels as hk
    from tpubq_torch.utils import convert, health, io, profiling

    tmp = tempfile.mkdtemp(prefix="tpubq_facade_")
    t_start = time.perf_counter()
    x = testbed_x(False)
    grid = np.linspace(-4.0, 4.0, G)
    grid_dev = torch.as_tensor(grid, dtype=torch.float32, device=dev)
    zero_counts()
    res = {}

    # the single problem: fit, then the refined pick with and without hyper rows
    bq = make_bq(x, dev, "float32", s=S_MAIN)
    bq64 = make_bq(x, "cpu", "float64", s=S_MAIN)
    bq.fit_hypers(ntry=FIT_RESTARTS, seed=FIT_SEED)
    bq64._state = bqm.set_params(bq64.state, bq64.options, theta_tl=bq.state.gp_log_l.theta.double().cpu(),
                                 theta_l=bq.state.gp_l.theta.double().cpu())
    rows = torch.as_tensor(bq.sample_hypers(n=FACADE_MARG_N, seed=FACADE_SEED), dtype=torch.float32, device=dev)
    res["refine"] = [facade_refine(bq, bq64, grid_dev, None), facade_refine(bq, bq64, grid_dev, rows)]
    x_fac = bq.choose_next(grid, refine=True)
    x_fac_n = bq.choose_next(grid, n=FACADE_MARG_N, seed=FACADE_SEED, refine=True)
    res["facade_picks"] = dict(refine=x_fac, refine_n10=x_fac_n)
    check(x_fac == res["refine"][0]["x_refined"], "BQ.choose_next(refine=True) returns refine_next's point")

    # health, float32 on the card against the float64 path
    d32 = bq.health()
    check(all(v.device.type == dev.type for _, v in _leaves(d32)), "health() leaves stay on the card")
    res["health"] = health_vs(d32, bq64.health(), "single, f32 vs f64")
    check(res["health"]["z_var_clamped_rel"] <= HEALTH_CLAMP_MAX, "V[Z] clamped at the rounding floor only")
    report = bq.health(as_report=True)
    check(len(report.splitlines()) == 8 and report.startswith("ns="), "format_report renders")

    # checkpoints of one problem
    p_state, p_bq = os.path.join(tmp, "state.npz"), os.path.join(tmp, "bq.npz")
    io.save_state(p_state, bq.state, bq.options)
    st2, o2 = io.load_state(p_state, device=dev)
    z = lambda s, o: (bqm.Z_mean(s, o).item(), bqm.Z_var(s, o).item())  # noqa: E731
    pick = lambda s, o: acquire.choose_next(s, o, grid_dev)  # noqa: E731
    (xa, sa), (xb, sb) = pick(bq.state, bq.options), pick(st2, o2)
    res["checkpoint"] = dict(Z=z(bq.state, bq.options), Z_reloaded=z(st2, o2), pick=xa.item(),
                             pick_reloaded=xb.item())
    check(z(st2, o2) == z(bq.state, bq.options), "save_state → load_state: Z_mean, Z_var bit-identical")
    check(torch.equal(xa, xb) and torch.equal(sa, sb), "save_state → load_state: scores and pick bit-identical")
    check(convert.load_tpubq_npz(p_state, device=dev)[0].gp_l.alpha.equal(bq.state.gp_l.alpha)
          and bqm.Z_mean(*convert.load_tpubq_npz(p_state, device=dev)).item() == z(st2, o2)[0],
          "the card's checkpoint loads through utils.convert with the same Z_mean")
    bq.save(p_bq)
    b2 = BQ.load(p_bq, device=dev)
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    res["checkpoint"].update(bq_load_Z=(b2.Z_mean(), b2.Z_var()), bq_load_pick=b2.choose_next(grid, refine=True),
                             bq_load_seed=b2._seed)
    check(rel(b2.Z_mean(), bq.Z_mean()) <= ZMEAN_RTOL and rel(b2.Z_var(), bq.Z_var()) <= ZVAR_RTOL,
          f"BQ.save → BQ.load (a refit) keeps E[Z], V[Z] ({res['checkpoint']})")
    s_st, s_o = convert.load_tpubq_npz(p_bq, device=dev)
    check(rel(bqm.Z_mean(s_st, s_o).item(), bq.Z_mean()) <= ZMEAN_RTOL, "BQ.save's file loads through utils.convert")

    # max_obs 1024: a checkpoint of the large-N recipe's state, reloaded with a refit
    st_l, o_l = large_state(dev, 1024, "float32")
    p_large = os.path.join(tmp, "large.npz")
    io.save_state(p_large, st_l, o_l)
    c0 = kernel_counts()
    st_r, _ = io.load_state(p_large, refit=True, device=dev)
    torch.cuda.synchronize()
    got, want = delta(c0, kernel_counts()), add_counts(o_l, "refit")
    zl, zr = z(st_l, o_l), z(st_r, o_l)
    res["large"] = dict(max_obs=1024, launches=got, expected=want, Z=zl, Z_refit=zr,
                        Z_mean_rel=rel(zr[0], zl[0]), Z_var_rel=rel(zr[1], zl[1]))
    check(got == want, f"load_state(refit=True) at max_obs 1024: exact launches ({got} vs {want})")
    check(res["large"]["Z_mean_rel"] <= LARGE_ZMEAN_RTOL and res["large"]["Z_var_rel"] <= LARGE_ZVAR_RTOL,
          f"the refit load keeps E[Z], V[Z] at max_obs 1024 ({res['large']})")

    # the fleet at B = 64
    xs, ls, _ = fleet_data(FLEET_B, FLEET_N_OBS)
    kw = dict(params_tl=PARAMS_TL, params_l=PARAMS_L, n_candidate=12, candidate_thresh=0.2,
              max_obs=FLEET_MAX_OBS, s=S_MAIN)
    fleet = BQFleet(xs, ls, device=dev, dtype="float32", seed=7, **kw)
    fleet.fit(ntry=FIT_RESTARTS, seed=FIT_SEED)
    fx = fleet.choose_next(grid)
    dh = fleet.health()
    check(all(tuple(v.shape) == (FLEET_B,) for _, v in _leaves(dh)), "fleet health: every leaf is (64,)")
    th_tl, th_l = fleet.states.gp_log_l.theta.cpu().numpy(), fleet.states.gp_l.theta.cpu().numpy()
    row = lambda d, i: {k: row(v, i) if isinstance(v, dict) else v[i] for k, v in d.items()}  # noqa: E731
    singles = {}
    for i in FLEET_SINGLES:
        one = BQ(xs[i], ls[i], device=dev, dtype="float32", **{k: v for k, v in kw.items() if "params" not in k})
        one.init(params_tl=th_tl[i], params_l=th_l[i])
        singles[i] = health_vs(one.health(), row(dh, i), f"fleet row {i} vs its single BQ")
    res["fleet_health"] = dict(singles=singles, max_cond_l=dh["gp_l"]["cond_estimate"].max().item())
    p_fleet = os.path.join(tmp, "fleet")
    fleet.save(p_fleet)
    f2 = BQFleet.load(p_fleet + ".npz", device=dev)
    check(f2._seed == 7, "the fleet's seed survives the checkpoint")
    check(np.array_equal(f2.Z_mean(), fleet.Z_mean()) and np.array_equal(f2.Z_var(), fleet.Z_var()),
          "BQFleet.save → load: moments bit-identical")
    check(np.array_equal(f2.choose_next(grid), fx), "BQFleet.save → load: picks bit-identical")
    c0 = hk.chol_batch.launches
    f3 = BQFleet.load(p_fleet + ".npz", refit=True, device=dev)
    torch.cuda.synchronize()
    n_cb = hk.chol_batch.launches - c0
    zr_rel = float(np.max(np.abs(f3.Z_mean() - fleet.Z_mean()) / np.abs(fleet.Z_mean())))
    res["fleet_checkpoint"] = dict(refit_chol_batch_launches=n_cb, refit_Z_mean_max_rel=zr_rel)
    check(n_cb == 2, f"BQFleet.load(refit=True): one chol_batch launch per GP's rung stack, got {n_cb}")
    check(zr_rel <= ZMEAN_RTOL, "BQFleet.load(refit=True) keeps E[Z]")

    # the GP facade's fit on the card: the large-N recipe's first points
    xg, lg = large_data(GP_FACADE_MAX_OBS)
    yg = np.log(lg)
    c0 = kernel_counts()
    gp32 = gpm.GP("gaussian", PARAMS_TL, xg, yg, s=S_LARGE, device=dev, dtype="float32")
    torch.cuda.synchronize()
    n = len(xg)
    got = delta(c0, kernel_counts())
    want = dict(esm_fused=0, chol_batch=0, gaussian_gram=1, cholesky_blocked=hk.cholesky_blocked_launches(n),
                tri_solve_blocked=3 * hk.tri_solve_blocked_launches(n), cholesky_batched=0)
    gp64 = gpm.GP("gaussian", PARAMS_TL, xg, yg, s=S_LARGE, device="cpu")
    xo = np.linspace(-2.0, 2.0, 9)
    m32, m64 = gp32.mean(xo).double().cpu(), gp64.mean(xo)
    res["gp_facade"] = dict(n=n, launches=got, expected=want,
                            mean_rel=((m32 - m64).abs().max() / m64.abs().max()).item(),
                            log_lh=gp32.log_lh, log_lh_f64=gp64.log_lh, log_lh_rel=rel(gp32.log_lh, gp64.log_lh))
    check(got == want, f"the GP facade's fit runs on gaussian_gram, cholesky_blocked, tri_solve_blocked ({got})")
    check(res["gp_facade"]["mean_rel"] <= GP_FACADE_TOL and res["gp_facade"]["log_lh_rel"] <= GP_FACADE_TOL,
          f"the GP facade f32 card vs f64 CPU ({res['gp_facade']})")

    torch.cuda.synchronize()
    launches = {**kernel_counts(), "mll_grad_batched": hk.mll_grad_batched.launches,
                "esm_fleet_l": hk.esm_fleet_l.launches, "esm_fleet_tl": hk.esm_fleet_tl.launches}
    path_seconds = time.perf_counter() - t_start
    on_path = ("esm_fused", "esm_fleet_l", "esm_fleet_tl", "gaussian_gram", "cholesky_blocked",
               "tri_solve_blocked", "chol_batch", "mll_grad_batched")
    check(all(launches[k] > 0 for k in on_path), f"every kernel of the facade path launched {launches}")

    # host times of the serving calls (utils.profiling.time_fn: a median over
    # three repeats, one synchronize each), then one trace
    times = {}
    tm = lambda name, fn: times.__setitem__(name, profiling.time_fn(fn, **TIMING_KW)[0] * 1e3)  # noqa: E731
    tm("save_ms", lambda: io.save_state(p_state, bq.state, bq.options, force=True))
    tm("load_ms", lambda: io.load_state(p_state, device=dev))
    tm("load_refit_ms", lambda: io.load_state(p_state, refit=True, device=dev))
    tm("bq_load_ms", lambda: BQ.load(p_bq, device=dev))
    tm("health_ms", bq.health)
    tm("refine_ms", lambda: acquire.refine_next(bq.state, bq.options, grid_dev[:1]))
    tm("refine_n10_ms", lambda: acquire.refine_next(bq.state, bq.options, grid_dev[:1], rows))
    tm("large_save_ms", lambda: io.save_state(p_large, st_l, o_l, force=True))
    tm("large_load_refit_ms", lambda: io.load_state(p_large, refit=True, device=dev))
    tm("fleet_save_ms", lambda: fleet.save(p_fleet, force=True))
    tm("fleet_load_ms", lambda: BQFleet.load(p_fleet + ".npz", device=dev))
    tm("fleet_load_refit_ms", lambda: BQFleet.load(p_fleet + ".npz", refit=True, device=dev))
    tm("fleet_health_ms", fleet.health)
    trace_dir = os.path.join(tmp, "trace")
    with profiling.trace(trace_dir):
        with profiling.annotate("facade_choose_next_refine"):
            bq.choose_next(grid, refine=True)
    trace_file = os.path.join(trace_dir, "trace.json")
    trace_bytes = os.path.getsize(trace_file) if os.path.exists(trace_file) else 0
    check(trace_bytes > 0, "profiling.trace wrote its Chrome trace")
    shutil.rmtree(tmp)
    res.update(launches=launches, seconds=path_seconds, times=times, card=nvidia_smi(), trace_bytes=trace_bytes,
               tol=dict(pick=ESM_ARGMAX_RTOL, jitter=HEALTH_JITTER_RTOL, cond_factor=HEALTH_COND_FACTOR,
                        clamp=HEALTH_CLAMP_MAX, Z_mean=ZMEAN_RTOL, Z_var=ZVAR_RTOL, gp_facade=GP_FACADE_TOL))
    emit("facade_path", **res)
    return res


# ---------------------------------------------------------------------------
# parallel/: the sharded functions on a (1, 1) NCCL mesh of the card
# ---------------------------------------------------------------------------

PARALLEL_STEPS, PARALLEL_CHOOSE_N = 10, 10


def _identical(a, b) -> bool:
    """Tensors (and tuples or states of them) equal bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))
    if a is None or b is None:
        return a is None and b is None
    return len(a) == len(b) and all(_identical(x, y) for x, y in zip(a, b))


def parallel_path(dev, rows, label: str) -> dict:
    """``tpubq_torch.parallel`` on a (1, 1) mesh of the card (see the module
    docstring, phase 4e): every sharded function once, its launches counted
    per call; then the unsharded port on the same inputs (bit-identical
    results, the same launches) and the float64 rules of the main and fleet
    paths; then the host ms of sharded and unsharded fleet steps. ``rows``:
    the main path's 100 θ_tl rows (float32 on the card)."""
    import torch
    import torch.distributed as dist

    from tpubq_torch import BQFleet
    from tpubq_torch.models import acquire, batched, bq as bqm, marginalize as margm
    from tpubq_torch.ops import hopper_kernels as hk
    from tpubq_torch.parallel import mesh as pmesh, sharded as sh

    # the testbed at its initial hypers (after the main path's loop the float32 scorer
    # resolves no grid point, and its picks could not be held to float64)
    x = testbed_x(False)
    bq, bq64 = make_bq(x, dev, "float32", s=S_MAIN), make_bq(x, "cpu", "float64", s=S_MAIN)
    st, opts, st64, opts64 = bq.state, bq.options, bq64.state, bq64.options
    grid = np.linspace(-4.0, 4.0, G)
    grid64 = torch.as_tensor(grid, dtype=torch.float64)
    grid_dev = torch.as_tensor(grid, dtype=torch.float32, device=dev)
    # the fleet path's recipe at its initial hypers, observed through one likelihood (the
    # loop maps one loglik_fn over the problems): the testbed's N(x; 0.2, 0.5²)
    xs, _, _ = fleet_data(FLEET_B, FLEET_N_OBS)
    kw = dict(params_tl=PARAMS_TL, params_l=PARAMS_L, n_candidate=12, candidate_thresh=0.2,
              max_obs=FLEET_MAX_OBS, s=S_MAIN)
    fleet64 = BQFleet(xs, f_l(xs), device="cpu", dtype="float64", **kw)
    fleet = BQFleet(xs, f_l(xs), device=dev, dtype="float32", **kw)
    fst, fopts = fleet.states, fleet.options
    lik = lambda x: torch.exp(-0.5 * ((x[0] - MU_L) / SIG_L) ** 2) / (SIG_L * math.sqrt(2.0 * math.pi))  # noqa: E731

    t0 = time.perf_counter()
    mesh = pmesh.make_mesh(device=dev)
    mesh_seconds = time.perf_counter() - t0
    try:
        calls, ref_calls = {}, {}
        zero_counts()
        total0 = marg_counts()
        out = {
            "choose_next": marg_call(lambda: sh.choose_next_sharded(st, opts, grid_dev, mesh), calls, "choose_next"),
            "choose_next_n10": marg_call(lambda: sh.choose_next_sharded(st, opts, grid_dev, mesh,
                                                                        rows[:PARALLEL_CHOOSE_N]),
                                         calls, "choose_next_n10"),
            "marginalize": marg_call(lambda: sh.marginalize_sharded(st, opts, rows, mesh), calls, "marginalize"),
            "fleet_choose_next": marg_call(lambda: sh.fleet_choose_next_sharded(fst, fopts, grid_dev, mesh), calls,
                                           "fleet_choose_next"),
            "fleet_Z_moments": marg_call(lambda: sh.fleet_Z_moments_sharded(fst, fopts, mesh), calls,
                                         "fleet_Z_moments"),
            "fleet_loop": marg_call(lambda: sh.run_active_loop_fleet_sharded(fst, fopts, lik, grid_dev,
                                                                             PARALLEL_STEPS, mesh),
                                    calls, "fleet_loop"),
        }
        launches = {k: v for k, v in delta(total0, marg_counts()).items() if k in MARG_WRAPPERS}

        # ---- everything below compares; none of it counts as the path's launches
        ref = {
            "choose_next": marg_call(lambda: acquire.choose_next(st, opts, grid_dev), ref_calls, "choose_next"),
            "choose_next_n10": marg_call(lambda: acquire.choose_next(st, opts, grid_dev, rows[:PARALLEL_CHOOSE_N]),
                                         ref_calls, "choose_next_n10"),
            "marginalize": marg_call(lambda: margm.marginalize(st, opts, rows), ref_calls, "marginalize"),
            "fleet_choose_next": marg_call(lambda: batched.choose_next_batch(fst, fopts, grid_dev), ref_calls,
                                           "fleet_choose_next"),
            "fleet_Z_moments": marg_call(lambda: (batched.Z_mean_batch(fst, fopts), batched.Z_var_batch(fst, fopts)),
                                         ref_calls, "fleet_Z_moments"),
            "fleet_loop": marg_call(lambda: batched.run_active_loop_batch(fst, fopts, lik, grid_dev, PARALLEL_STEPS),
                                    ref_calls, "fleet_loop"),
        }
        identical = {k: _identical(out[k], ref[k]) for k in out}
        E = hk.esm_fused_launches(opts.max_nsc, opts.max_obs, opts.dim)
        want = {"choose_next": dict(esm_fused=E, esm_fleet_l=0), "choose_next_n10": dict(esm_fused=PARALLEL_CHOOSE_N * E),
                "marginalize": dict(esm_fused=0, esm_fleet_l=0),
                "fleet_choose_next": dict(esm_fleet_l=1, esm_fleet_tl=1, esm_fused=0),
                "fleet_Z_moments": dict(esm_fleet_l=0, esm_fused=0),
                "fleet_loop": dict(esm_fleet_l=PARALLEL_STEPS, esm_fleet_tl=PARALLEL_STEPS, esm_fused=0)}
        launch_failures = {}
        for k, w in want.items():
            w = {**{q: ref_calls[k][q] for q in MARG_WRAPPERS}, **w}  # the unsharded call's, where not fixed above
            bad = {q: (calls[k][q], v) for q, v in w.items() if calls[k][q] != v or ref_calls[k][q] != v}
            if bad:
                launch_failures[k] = bad

        # float64: the single problem's picks by the main path's rules, marginalize on the same rows
        x1, _ = out["choose_next"]
        gap, err, n_ok = pick_gap(st, opts, st64, opts64, float(x1[0]), grid_dev, grid64)
        r10 = rows[:PARALLEL_CHOOSE_N]
        esm32 = torch.zeros(G, dtype=torch.float64)
        deg32 = torch.zeros(G, dtype=torch.bool)
        for r in r10:
            st_r = bqm.apply_hyper_sample(st, opts, r)
            esm32 += hk.esm_fused_plain(*acquire.esm_fused_inputs(st_r, opts, grid_dev[:, None])).double().cpu()
            deg32 |= acquire._esm_affine_terms(st_r, opts, grid_dev[:, None])[2].cpu()
        _, esm64 = acquire.choose_next(st64, opts64, grid64, r10.double().cpu())
        near = (((grid64[:, None] - st64.x_s[None, :, 0]).abs() < opts.candidate_thresh) & st64.obs_mask).any(1)
        x10, _ = out["choose_next_n10"]
        mgap, merr, mn_ok = marg_pick_gaps((esm32 / len(r10))[None], deg32[None], esm64[None], near[None],
                                           (grid64 - float(x10[0])).abs().argmin()[None])
        marg = marg_vs_f64(*out["marginalize"], *margm.marginalize(st64, opts64, rows.double().cpu(),
                                                                   (bqm.Z_mean, bqm.Z_var, _z_var_gh)))

        # float64: the fleet's picks by the fleet path's rule, its moments, the loop replayed in
        # float32 on its own picks (which must reach its final state) with the float64 fleet beside it
        rel = lambda a, b: float(np.max(np.abs(np.asarray(a, np.float64) - b) / np.abs(b)))  # noqa: E731
        fx, _ = out["fleet_choose_next"]
        fgap, ferr, fn_ok, _ = fleet_pick_gaps(fst, fopts, fleet64.states, fleet64.options, fx[:, 0].cpu().numpy(),
                                               grid_dev, grid64)
        gaps, errs, resolved = [fgap], [ferr], [fn_ok]
        zm, zv = (z.cpu().numpy() for z in out["fleet_Z_moments"])
        z_rel, zv_rel = [rel(zm, fleet64.Z_mean())], [rel(zv, fleet64.Z_var())]
        final, (zm_t, zv_t) = out["fleet_loop"]
        ns0 = fst.ns[0].item()
        picks = final.x_s[:, ns0:ns0 + PARALLEL_STEPS, 0].cpu().numpy().T  # (steps, B)
        s32 = fst
        vlik = torch.vmap(lik)
        for i in range(PARALLEL_STEPS):
            g_, e_, n_, _ = fleet_pick_gaps(s32, fopts, fleet64.states, fleet64.options, picks[i], grid_dev, grid64)
            gaps.append(g_)
            errs.append(e_)
            resolved.append(n_)
            xn = torch.as_tensor(picks[i], dtype=torch.float32, device=dev)[:, None]
            s32 = batched.add_observation_batch(s32, fopts, xn, vlik(xn))
            fleet64.add_observation(picks[i][:, None], f_l(picks[i]))
            z_rel.append(rel(zm_t[i].cpu().numpy(), fleet64.Z_mean()))
            zv_rel.append(rel(zv_t[i].cpu().numpy(), fleet64.Z_var()))
        replay_identical = _identical(s32, final)
        gaps, errs, resolved = torch.stack(gaps), torch.stack(errs), torch.stack(resolved)
        gap_ok = torch.isnan(gaps) | (gaps <= torch.clamp(2.0 * errs, min=ESM_ARGMAX_RTOL))

        # host ms of fleet loops (choose → observe → refit at B = 64, G = 10⁴) of 1 and of
        # PARALLEL_STEPS steps, sharded and not, in turns; a sharded call ends in the gather
        # of the final state (one all_gather a leaf)
        loop = dict(sharded=lambda n: sh.run_active_loop_fleet_sharded(fst, fopts, lik, grid_dev, n, mesh,
                                                                       record_moments=False),
                    unsharded=lambda n: batched.run_active_loop_batch(fst, fopts, lik, grid_dev, n,
                                                                     record_moments=False))
        turns = [(k, n, host_ms(lambda: loop[k](n), iters=5, warmup=1))
                 for n in (1, PARALLEL_STEPS) for k in ("sharded", "unsharded", "unsharded", "sharded")]
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()

    res = dict(
        mesh=list(mesh.shape), backend=backend, B=FLEET_B, G=G, steps=PARALLEL_STEPS, choose_n=PARALLEL_CHOOSE_N,
        marginalize_n=len(rows), calls=calls, unsharded_calls=ref_calls, launches=launches,
        bit_identical=identical, loop_replay_bit_identical=replay_identical, launch_failures=launch_failures,
        pick_gap=gap, esm_f32_err=err, resolved_points=n_ok, marg_pick_gap=float(mgap[0]),
        marg_esm_f32_err=float(merr[0]), marg_resolved_points=int(mn_ok[0]), marginalize_vs_f64=marg,
        fleet_Z_mean_rel=max(z_rel), fleet_Z_var_rel=max(zv_rel),
        fleet_pick_gap_max=float(torch.nan_to_num(gaps, nan=0.0).max()),
        fleet_resolved_points_min_per_step=resolved.min(1).values.tolist(),
        fleet_picks_on_the_plateau_per_step=torch.isnan(gaps).sum(1).tolist(),
        mesh_seconds=mesh_seconds, loop_host_ms_turns=turns,
        step_host_ms={k: float(np.mean([t for q, n, t in turns if q == k and n == PARALLEL_STEPS])) / PARALLEL_STEPS
                      for k in ("sharded", "unsharded")},
        one_step_call_host_ms={k: float(np.mean([t for q, n, t in turns if q == k and n == 1]))
                               for k in ("sharded", "unsharded")},
        nvidia_smi=label,
        tol=dict(Z_mean=ZMEAN_RTOL, Z_var=ZVAR_RTOL, marg_mean=MARG_MEAN_RTOL, esm_argmax=ESM_ARGMAX_RTOL),
    )
    emit("parallel_path", **res)
    check(all(identical.values()), f"each sharded result bit-identical to the unsharded port's on a (1, 1) mesh ({identical})")
    check(replay_identical, "the fleet loop's picks, replayed in float32, reach its final state bit for bit")
    check(not launch_failures, f"exact launches of the sharded calls: {launch_failures}")
    check(all(launches[k] > 0 for k in ("esm_fused", "chol_batch", "esm_fleet_l", "esm_fleet_tl", "gaussian_gram",
                                        "cholesky_blocked", "tri_solve_blocked")),
          f"every kernel of the parallel path launched ({launches})")
    check(n_ok > 0 and mn_ok[0] > 0, f"the f32 scorer resolves points, directly and under every row ({n_ok}, {mn_ok})")
    check(gap <= max(ESM_ARGMAX_RTOL, 2.0 * err),
          f"the sharded pick is the f64 ESM maximum over the resolved points ({gap}, {err}, {n_ok})")
    check(bool(torch.isnan(mgap).all() or mgap[0] <= max(ESM_ARGMAX_RTOL, 2.0 * float(merr[0]))),
          f"the sharded marginalized pick is the f64 optimum over the resolved points ({res['marg_pick_gap']})")
    check(marg["finite"] and marg["Z_mean_max_rel"] <= MARG_MEAN_RTOL and marg["Z_var_mean_rel"] <= ZVAR_RTOL,
          f"sharded marginalize f32 card vs f64 CPU ({marg})")
    check(res["fleet_Z_mean_rel"] <= ZMEAN_RTOL and res["fleet_Z_var_rel"] <= ZVAR_RTOL,
          f"sharded fleet moments f32 card vs f64 CPU ({res['fleet_Z_mean_rel']}, {res['fleet_Z_var_rel']})")
    check(bool(gap_ok.all()), "each sharded fleet pick is the f64 ESM maximum over the resolved points")
    check(bool((resolved[0] > 0).all()), "the f32 fleet scorer resolves points for every problem at the start")
    return {"launches": launches, "step_host_ms": res["step_host_ms"],
            "one_step_call_host_ms": res["one_step_call_host_ms"]}


# ---------------------------------------------------------------------------
# phase 4f: the C++ oracle and the quadrature twins
# ---------------------------------------------------------------------------

# The oracle (native/bq_native.cpp, built with the host's g++) shares no code
# with the port: on this machine, without JAX, it is the one reference that is
# not port code. Its ESM algebra takes κ = h², the port's s² + jitter more, so
# its states are the testbed's at s = 0, the initial one and those after each
# of ORACLE_STEPS active steps (the float32 log-GP Gram turns singular after ~8).
ORACLE_STEPS = 5
ORACLE_ESM_RTOL = 1e-8  # float64 scorer against the oracle, per point (tests/test_native.py)
# (rtol, atol) of each closed form against the oracle (tests/test_native.py)
ORACLE_INT_TOLS = dict(int_K=(1e-12, 0.0), int_int_K=(1e-12, 0.0), int_K1_K2=(1e-12, 0.0),
                       int_int_K1_K2=(1e-12, 0.0), int_K1_int_K2=(1e-12, 0.0), int_K_periodic=(1e-12, 0.0),
                       int_int_K1_K2_periodic=(1e-11, 1e-15))
ORACLE_POINTS, ORACLE_SEED = 1024, 14
# Closed forms against the trapezoid twins, float64 on the card, with the JAX
# suite's grids and tolerances: (kernel, θ1, θ2, μ, σ², x1, x2, nodes, half-width,
# {quantity: rtol}); the periodic cross family on its own grid
# (tests/test_periodic_exact.py's two tests), rq at α ≤ 30 on the gaussian's.
_TX1, _TX2 = tuple(np.linspace(-1.6, 1.4, 5)), (-0.9, 0.3, 1.1)
_GX = np.random.RandomState(9)
_GX1, _GX2 = tuple(_GX.randn(4)), tuple(_GX.randn(3))  # tests/test_integrals.py's points
TWIN_CASES = (
    ("gaussian", (0.8, 0.7), (1.3, 0.4), 0.3, 0.9, _GX1, _GX2, 8001, 10.0,
     dict(int_K=1e-6, int_int_K=1e-6, P=1e-6, T=1e-6, U=1e-6)),
    ("matern52", (0.5, 0.45), (0.8, 0.7), 0.1, 0.9, _TX1, _TX2, 6001, 9.0,
     dict(int_K=2e-6, int_int_K=2e-6, P=2e-6, T=2e-6, U=2e-6)),
    ("matern32", (0.5, 0.45), (0.8, 0.7), 0.1, 0.9, _TX1, _TX2, 6001, 9.0,
     dict(int_K=2e-6, int_int_K=2e-6, P=2e-6, T=2e-6, U=2e-6)),
    ("periodic", (1.3, 0.4, 0.7), (1.3, 0.4, 0.7), 0.3, 1.5, (0.85, -1.2, 2.0), (), 40001, 12.0,
     dict(int_K=1e-9, int_int_K=1e-7)),
    ("periodic", (1.1, 0.5, 0.9), (0.8, 0.35, 0.6), 0.1, 0.9, _TX1, _TX2, 12001, 9.0,
     dict(P=1e-7, T=1e-6, U=1e-6)),
    ("rq", (0.8, 0.7, 2.0), (), 0.3, 0.9, _GX1, (), 8001, 10.0, dict(int_K=1e-6)),
    ("rq", (0.8, 0.7, 30.0), (), 0.3, 0.9, _GX1, (), 8001, 10.0, dict(int_K=1e-6)),
)
PERIODIC_SERIES = 90  # harmonics of the periodic closed forms against the twins


def oracle_resolved(st64, opts, grid) -> np.ndarray:
    """The points the oracle resolves, by its own rule on its own inputs: at
    least ``candidate_thresh`` from every live row of the linear GP, and a
    Schur complement h_l² − ‖L⁻¹k‖² above 1e-14 (float64, on the host)."""
    from scipy.linalg import solve_triangular

    m = st64.sc_mask.cpu().numpy()
    xsc = st64.x_sc.double().cpu().numpy()[m, 0]
    L = st64.gp_l.L.double().cpu().numpy()[np.ix_(m, m)]
    h, w = st64.gp_l.theta.double().cpu().numpy()[:2]
    d = xsc[None, :] - grid[:, None]
    v = solve_triangular(L, (h * h * np.exp(-0.5 * (d / w) ** 2)).T, lower=True)
    near = (np.abs(d) < opts.candidate_thresh).any(1)
    return ~near & (h * h - (v * v).sum(0) > 1e-14)


def oracle_integrals(dev, x_obs) -> dict:
    """The port's float64 closed forms on the card against the oracle, on the
    testbed's observations and on ORACLE_POINTS points from the seed: the
    gaussian family at the testbed's hypers (θ_l, θ_tl) and measure, the
    periodic pair at tests/test_native.py's."""
    import torch

    from tpubq_torch.ops import integrals as igr
    from tpubq_torch.utils import native

    (h1, w1), (h2, w2), mu, s2 = PARAMS_L, PARAMS_TL, BQ_KW["x_mean"], BQ_KW["x_var"]
    per_x, t1, t2 = (1.3, 0.45, 0.8), (0.9, 0.5, 1.1), (1.2, 0.4, 0.7)
    rng = np.random.RandomState(ORACLE_SEED)
    f64 = dict(dtype=torch.float64, device=dev)
    out = {}
    for name, x in (("observations", np.asarray(x_obs, np.float64)),
                    (f"points_{ORACLE_POINTS}", rng.uniform(-4.0, 4.0, ORACLE_POINTS))):
        X = torch.as_tensor(x, **f64)[:, None]
        W1, W2 = torch.tensor([w1], **f64), torch.tensor([w2], **f64)
        M, S = torch.tensor([mu], **f64), torch.tensor([[s2]], **f64)
        per_M, per_S = torch.tensor([0.3], **f64), torch.tensor([[0.9]], **f64)
        T1, T2 = (tuple(torch.tensor(v, **f64) for v in t) for t in (t1, t2))
        pairs = dict(
            int_K=(igr.int_K(X, h1, W1, M, S), native.int_K(x, h1, w1, mu, s2)),
            int_int_K=(igr.int_int_K(1, h1, W1, M, S)[None], np.atleast_1d(native.int_int_K(h1, w1, mu, s2))),
            int_K1_K2=(igr.int_K1_K2(X, X, h1, W1, h2, W2, M, S), native.int_K1_K2(x, x, h1, w1, h2, w2, mu, s2)),
            int_int_K1_K2=(igr.int_int_K1_K2(X, X, h1, W1, h2, W2, M, S),
                           native.int_int_K1_K2(x, x, h1, w1, h2, w2, mu, s2)),
            int_K1_int_K2=(igr.int_K1_int_K2(X, h1, W1, h2, W2, M, S),
                           native.int_K1_int_K2(x, h1, w1, h2, w2, mu, s2)),
            int_K_periodic=(igr.int_K_periodic(X, *(torch.tensor(v, **f64) for v in per_x), per_M, per_S, 64),
                            native.int_K_periodic(x, *per_x, 0.3, 0.9, nterms=64)),
            int_int_K1_K2_periodic=(igr.int_int_K1_K2_periodic(X, X, T1, T2, per_M, per_S, 80),
                                    native.int_int_K1_K2_periodic(x, x, t1, t2, 0.3, 0.9, nterms=80)),
        )
        errs = {}
        for q, (got, want) in pairs.items():
            got, (rtol, atol) = got.cpu().numpy(), ORACLE_INT_TOLS[q]
            errs[q] = dict(max_rel=float(np.max(np.abs(got - want) / np.abs(want))), n=int(want.size),
                           ok=bool(np.allclose(got, want, rtol=rtol, atol=atol)), rtol=rtol, atol=atol)
        out[name] = errs
    return out


def twin_errors(dev) -> list:
    """The port's closed forms against its trapezoid twins (float64, on the
    card) for every case of TWIN_CASES → one record per case."""
    import torch

    from tpubq_torch.ops import integrals as igr
    from tpubq_torch.ops.kernels import get_kernel

    f64 = dict(dtype=torch.float64, device=dev)
    out = []
    for kernel, th1, th2, mu, s2, x1, x2, m, half, tols in TWIN_CASES:
        t0 = time.perf_counter()
        kfn, _ = get_kernel(kernel)
        t = lambda v: torch.tensor(v, **f64)  # noqa: E731
        M, S, xo = t([mu]), t([[s2]]), torch.linspace(-half, half, m, **f64)
        X1, X2 = t(x1)[:, None], (t(x2)[:, None] if x2 else None)
        T1, T2 = t(th1), (t(th2) if th2 else None)
        exact, twin = {}, {}
        if "int_K" in tols:
            twin["int_K"] = igr.approx_int_K(kfn, T1, X1, xo, M, S)
        if "int_int_K" in tols:
            twin["int_int_K"] = igr.approx_int_int_K(kfn, T2, xo, M, S)
        if "P" in tols:
            twin["P"] = igr.approx_int_K1_K2(kfn, kfn, T1, T2, X1, X2, xo, M, S)
            twin["T"] = igr.approx_int_int_K1_K2(kfn, kfn, T1, T2, X1, X2, xo, M, S)
            twin["U"] = igr.approx_int_K1_int_K2(kfn, kfn, T1, T2, X1, xo, M, S)
        if kernel == "gaussian":
            w1, w2 = T1[1:], T2[1:]
            exact = dict(int_K=igr.int_K(X1, th1[0], w1, M, S), int_int_K=igr.int_int_K(1, th2[0], w2, M, S),
                         P=igr.int_K1_K2(X1, X2, th1[0], w1, th2[0], w2, M, S),
                         T=igr.int_int_K1_K2(X1, X2, th1[0], w1, th2[0], w2, M, S),
                         U=igr.int_K1_int_K2(X1, th1[0], w1, th2[0], w2, M, S))
        elif kernel.startswith("matern"):
            nu = 2.5 if kernel == "matern52" else 1.5
            one_d = igr.int_K_matern52_1d if kernel == "matern52" else igr.int_K_matern32_1d
            a = (T1[0], T1[1:], T2[0], T2[1:])
            exact = dict(int_K=one_d(X1, T1[0], T1[1:], M, S), int_int_K=igr.int_int_K_matern(T2[0], T2[1:], M, S, nu),
                         P=igr.int_K1_K2_matern(X1, X2, *a, M, S, nu), T=igr.int_int_K1_K2_matern(X1, X2, *a, M, S, nu),
                         U=igr.int_K1_int_K2_matern(X1, *a, M, S, nu))
        elif kernel == "periodic":
            p1, p2 = tuple(T1), tuple(T2)
            n = PERIODIC_SERIES
            if "int_K" in tols:
                exact = dict(int_K=igr.int_K_periodic(X1, *p1, M, S, n), int_int_K=igr.int_int_K_periodic(*p2, M, S, n))
            else:
                exact = dict(P=igr.int_K1_K2_periodic(X1, X2, p1, p2, M, S, n),
                             T=igr.int_int_K1_K2_periodic(X1, X2, p1, p2, M, S, n),
                             U=igr.int_K1_int_K2_periodic(X1, p1, p2, M, S, n))
        else:
            exact = dict(int_K=igr.int_K_rq_mixture(X1, T1[0], T1[1:-1], T1[-1], M, S))
        errs = {}
        for q, rtol in tols.items():
            e, a = exact[q].reshape(-1).cpu().numpy(), twin[q].reshape(-1).cpu().numpy()
            errs[q] = dict(max_rel=float(np.max(np.abs(e - a) / np.abs(a))), rtol=rtol)
        torch.cuda.synchronize()
        out.append(dict(kernel=kernel, theta1=list(th1), theta2=list(th2), nodes=m, half_width=half,
                        seconds=time.perf_counter() - t0, errors=errs))
    return out


def oracle_path(dev) -> dict:
    """Phase 4f (see the module docstring): build the oracle; score the s = 0
    testbed's states with ``expected_squared_mean_fused`` (float32, one
    ``esm_fused`` call a state, counted) and the float64 path on the card, and
    hold both to the oracle on the points both resolve; then the closed forms
    against the oracle and against the quadrature twins."""
    import torch

    from tpubq_torch.models import acquire
    from tpubq_torch.ops import hopper_kernels as hk
    from tpubq_torch.utils import native

    t_phase = time.perf_counter()
    info = native.build()
    native.load()
    gxx = subprocess.run([native.CXX, "--version"], capture_output=True, text=True, timeout=60).stdout.splitlines()[0]

    x = testbed_x(False)
    bq, bq64 = make_bq(x, dev, "float32", s=0.0), make_bq(x, dev, "float64", s=0.0)
    grid = np.linspace(-4.0, 4.0, G)
    grid32 = torch.as_tensor(grid, dtype=torch.float32, device=dev)
    grid64 = torch.as_tensor(grid, dtype=torch.float64, device=dev)
    NP, NP2 = bq.options.max_nsc, bq.options.max_obs
    per_call = hk.esm_fused_launches(NP, NP2, 1)

    # the loop: one fused call a state, its pick observed by both estimators
    c0 = {k: getattr(hk, k).launches for k in MARG_WRAPPERS}
    states, calls, t0 = [], [], time.perf_counter()
    for step in range(ORACLE_STEPS + 1):
        st, opts = bq.state, bq.options
        n0 = hk.esm_fused.launches
        s32 = acquire.expected_squared_mean_fused(st, opts, grid32)
        calls.append(hk.esm_fused.launches - n0)
        sel = acquire.demote_near_observed(s32, grid32[:, None], st.x_s, st.obs_mask, opts.candidate_thresh)
        i = int(torch.argmax(sel))
        states.append((st, bq64.state, s32, i))
        if step < ORACLE_STEPS:
            xn = float(grid32[i])
            bq.add_observation(xn, float(f_l(xn)))
            bq64.add_observation(xn, float(f_l(xn)))
    torch.cuda.synchronize()
    loop_seconds = time.perf_counter() - t0
    launches = delta(c0, {k: getattr(hk, k).launches for k in MARG_WRAPPERS})

    # the comparisons (after the counts were read)
    t0 = time.perf_counter()
    cases = []
    for step, (st, st64, s32, i) in enumerate(states):
        s64 = acquire.expected_squared_mean(st64, bq64.options, grid64).cpu().numpy()
        t_or = time.perf_counter()
        oracle = native.esm_grid_state(st64, bq64.options, grid)
        oracle_ms = (time.perf_counter() - t_or) * 1e3
        res = oracle_resolved(st64, bq64.options, grid)
        _, _, deg32, *_ = acquire._esm_affine_terms(st, bq.options, grid32[:, None])
        _, _, deg64, *_ = acquire._esm_affine_terms(st64, bq64.options, grid64[:, None])
        ok32, ok64 = res & ~deg32.cpu().numpy(), res & ~deg64.cpu().numpy()
        s32 = s32.double().cpu().numpy()
        case = dict(step=step, ns=int(st64.obs_mask.sum()), oracle_resolved=int(res.sum()), compared_f64=int(ok64.sum()),
                    compared_f32=int(ok32.sum()), oracle_ms=oracle_ms, pick=float(grid[i]))
        if ok64.any():
            case["f64_max_rel"] = float(np.max(np.abs(s64 - oracle)[ok64] / np.abs(oracle[ok64])))
        if ok32.any():
            scale = float(np.abs(oracle[ok32]).max())
            case["f32_max_abs_over_max"] = float(np.max(np.abs(s32 - oracle)[ok32])) / scale
            case["f32_max_rel"] = float(np.max(np.abs(s32 - oracle)[ok32] / np.abs(oracle[ok32])))
            best = float(oracle[ok32].max())
            case["pick_gap"] = (best - float(oracle[i])) / best
        cases.append(case)
    compare_seconds = time.perf_counter() - t0

    t0 = time.perf_counter()
    integrals = oracle_integrals(dev, bq64.x_s[:, 0])
    integral_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    twins = twin_errors(dev)
    twin_seconds = time.perf_counter() - t0

    res = dict(build_seconds=info["seconds"], library=os.path.relpath(info["path"], ROOT), compiler=gxx,
               flags=list(native.CXX_FLAGS), G=G, s=0.0, steps=ORACLE_STEPS, launches=launches,
               esm_fused_calls=calls, esm_fused_launches_per_call=per_call, cases=cases, integrals=integrals,
               twins=twins, seconds=dict(loop=loop_seconds, compare=compare_seconds, integrals=integral_seconds,
                                         twins=twin_seconds, phase=time.perf_counter() - t_phase),
               tol=dict(f64_vs_oracle=ORACLE_ESM_RTOL, f32_vs_oracle_over_max=ESM_SCORE_RTOL,
                        esm_argmax=ESM_ARGMAX_RTOL, integrals=ORACLE_INT_TOLS))
    emit("oracle_path", **res)
    check(all(n == per_call for n in calls) and launches["esm_fused"] == per_call * (ORACLE_STEPS + 1),
          f"expected_squared_mean_fused launched esm_fused {per_call} times a call ({calls}, {launches})")
    check(all(c["compared_f64"] > 0 and c["compared_f32"] > 0 for c in cases),
          "every state has points that the oracle and the port's guards resolve")
    check(all(c["f64_max_rel"] <= ORACLE_ESM_RTOL for c in cases), "the float64 scorer on the card against the oracle")
    check(all(c["f32_max_abs_over_max"] <= ESM_SCORE_RTOL for c in cases), "esm_fused's float32 scores against the oracle")
    check(all(c["pick_gap"] <= max(ESM_ARGMAX_RTOL, 2.0 * c["f32_max_rel"]) for c in cases),
          "each float32 pick is the oracle's maximum over the compared points, up to the f32 scorer's error")
    check(all(e["ok"] for errs in integrals.values() for e in errs.values()),
          "the float64 closed forms on the card against the oracle")
    check(all(e["max_rel"] <= e["rtol"] for case in twins for e in case["errors"].values()),
          "the closed forms of the five families against their quadrature twins")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# the large-max_obs path: gaussian_gram, cholesky_blocked, tri_solve_blocked,
# cholesky_batched
# ---------------------------------------------------------------------------

# The JAX package's large-N recipe (benchmarks/large_n.py::bench_active_loop):
# max_obs − 12 sorted uniform(−2.2, 2.2) observations from RandomState(0),
# ℓ(x) = N(x; 0.2, 0.25) + 1e-3, 12 candidates at threshold 1e-3, a
# 512-point grid on [−4, 4], 8 active steps. Full width is max_obs = 1024
# (the log-GP 1,024 rows, the linear GP 1,036); 128 keeps chol_batch under
# marginalize, 256 and above put cholesky_batched there.
LARGE_MAX_OBS = (128, 256, 512, 1024)
LARGE_STEPS, LARGE_G, LARGE_MARG_N = 8, 512, 100
# Observation noise of the large-N path. The points lie 0.004 apart at
# max_obs 1024, so λ_min of either Gram is about s²: at s = 0.05 the live
# Grams' condition numbers are ~8e4 (log-GP) and ~8e3 (linear GP) in float64
# (printed per max_obs), rung 0 of the float32 ladder holds, and a new
# point's Schur complement (≥ s²) clears the incremental path's √eps32·κ
# guard. At s = 0.02 the log-GP Gram reaches κ ≈ 5e5.
S_LARGE = 0.05
LARGE_F64_MARG = 25  # θ_tl rows of the 100 held to float64 at max_obs 1024 (the f64 batch is 100 × 1024²)
# Large-N path, f32 card vs f64 CPU on the same data and picks (E[Z] moves
# by ~3e-7 and V[Z] by ~3e-5 in float32 at s = 0.05 on the initial state):
LARGE_ZMEAN_RTOL, LARGE_ZVAR_RTOL, LARGE_MARG_RTOL = 1e-4, 5e-2, 1e-3
# Incremental against refit on the card, where the two loops make the same picks:
# E[Z] within 1e-5 and V[Z] within 1e-3 per step (two float32 routes to one
# state; each also held to float64 on its own picks at the LARGE_* tolerances).
INC_ZMEAN_RTOL, INC_ZVAR_RTOL = 1e-5, 1e-3
LARGE_SWEEP = (64, 96, 128, 192, 256, 512, 1024)  # refit / incremental crossover
LARGE_KERNEL_NS = (44, 128, 300, 1036)
# Timing shapes at max_obs 1024: the linear GP's n and the log-GP's; the
# marginalize rung stacks (2 × 100 θ_tl rows) at max_obs 256 and 1024.
LARGE_TIMING_N = (1036, 1024)
LARGE_TIMING_BATCHED = ((200, 256), (200, 1024))
# cholesky_blocked timed at LARGE_KERNEL_NS, the main path's 32 rows and the
# log-GP's 1024 at max_obs 1024
LARGE_CHOL_TIMING_N = (32, 44, 128, 300, 1024, 1036)
# esm_fused at the large-N path's scored shape (G 512, max_obs 1024) and on a
# 10⁴-point grid
ESM_LARGE_SHAPES = ((LARGE_G, 1024), (10_000, 1024))
ESM_2060_G = 777  # random points scored on the max_obs 2048 state (a ragged grid)
GRAM_TOL = 1e-6  # max|Δ| / h²: expf against torch.exp, a few float32 ulps
# mll_grad at the large-N path's shapes (the recipe's max_obs): (10, 256), the
# log-GP at 256, and (10, 1036), the linear GP at 1024
LARGE_MLL_SHAPES = (256, 1024)
# BQ.fit_hypers at max_obs 1024 on the recipe (the fused route, the tiles)
LARGE_FIT_MAX_OBS = 1024


def large_data(max_obs: int):
    rng = np.random.RandomState(0)
    x = np.sort(rng.uniform(-2.2, 2.2, max_obs - 12))
    return x, large_lik(x)


def large_lik(x):
    x = np.asarray(x, np.float64)
    return np.exp(-0.5 * (x - 0.2) ** 2 / 0.25) / math.sqrt(2.0 * math.pi * 0.25) + 1e-3


def large_state(dev, max_obs: int, dtype: str):
    from tpubq_torch.models import bq as bqm
    from tpubq_torch.utils.options import BQOptions

    x, l = large_data(max_obs)
    opts = BQOptions(n_candidate=12, candidate_thresh=1e-3, max_obs=max_obs, dtype=dtype)
    st = bqm.init_state(x, l, opts, params_tl=PARAMS_TL, params_l=PARAMS_L, s_tl=S_LARGE, s_l=S_LARGE, device=dev)
    return st, opts


def large_loglik(x):
    """ℓ at a (d,) tensor, on its device (what run_active_loop calls)."""
    import torch

    return torch.exp(-0.5 * (x[0] - 0.2) ** 2 / 0.25) / math.sqrt(2.0 * math.pi * 0.25) + 1e-3


def path_gram(rng, n: int, dev, s: float = S_LARGE):
    """The large-N log-GP Gram of n recipe points plus s² on the diagonal."""
    import torch

    from tpubq_torch.ops import hopper_kernels as hk

    x = torch.as_tensor(np.sort(rng.uniform(-2.2, 2.2, n))[:, None], dtype=torch.float32, device=dev)
    return hk.gaussian_gram_plain(torch.tensor(PARAMS_TL, device=dev), x, x) + s * s * torch.eye(n, device=dev)


def live_conditions(st64) -> dict:
    """Condition numbers, in float64, of both GPs' live Grams (s² and the
    rung-0 jitter on the diagonal)."""
    import torch

    from tpubq_torch.ops import kernels

    out = {}
    for name, gp in (("log_gp", st64.gp_log_l), ("linear_gp", st64.gp_l)):
        x = gp.x[gp.mask]
        K = kernels.gaussian_K(gp.theta, x, x) + (gp.s**2 + gp.jitter) * torch.eye(x.shape[0], dtype=torch.float64)
        ev = torch.linalg.eigvalsh(K)
        out[name] = float(ev[-1] / ev[0])
    return out


def check_large_kernels(dev) -> dict:
    """The four kernels of the large-N path against their plain versions at
    n ∈ {44, 128, 300, 1036} (one and several panels, a ragged last one), on
    Grams of the path's recipe at s = S_LARGE (κ up to ~1e5):

    * gaussian_gram: (n, n) and (n, 1) at d = 1, (300, 512) at d = 3:
      max|Δ| ≤ GRAM_TOL·h²;
    * cholesky_blocked and cholesky_batched: backward error
      max|LLᵀ − A| / max|A| ≤ n·eps32, and within CHOL_NORM_TOL of the plain
      factor (cholesky_blocked's left-looking tiles, cholesky_batched's
      panelled recursion) normwise or twice the library's own distance to it
      where that is larger (two float32 factorizations of a κ ~ 1e5 matrix);
      a matrix made indefinite comes back NaN, in its own entry of a stack
      only, with its bad pivot past the first 64-wide panel and, from n = 128
      up, a second one in the last panel (cholesky_blocked: a bad pivot in a
      middle, the ragged last or the only tile); two cholesky_blocked calls
      give the same bits;
    * tri_solve_blocked: (n, 1), (n, 3), (n, 100) and (n, n) = L⁻¹ against
      float64, within max(1e-4, 2 × the library's own distance) normwise;
      and at n = 1036 two calls on the same inputs give the same bits.
    """
    import torch

    from tpubq_torch.ops import hopper_kernels as hk

    rng = np.random.RandomState(5)
    eps = torch.finfo(torch.float32).eps
    norm = lambda a, b: float((a.double() - b.double()).abs().max() / b.double().abs().max())  # noqa: E731
    gram, chol, tri, batched = [], [], [], []
    for n in LARGE_KERNEL_NS:
        x = torch.as_tensor(np.sort(rng.uniform(-2.2, 2.2, n))[:, None], dtype=torch.float32, device=dev)
        th = torch.tensor(PARAMS_TL, device=dev)
        for x2 in (x, x[n // 2:n // 2 + 1].contiguous()):
            K = hk.gaussian_gram(th, x, x2)
            torch.cuda.synchronize()
            gram.append(dict(shape=[n, x2.shape[0], 1], max_abs_err=float((K - hk.gaussian_gram_plain(th, x, x2)).abs().max())))
        A = path_gram(rng, n, dev)
        L = hk.cholesky_blocked(A)
        torch.cuda.synchronize()
        ref, lib = hk.cholesky_blocked_plain(A), torch.linalg.cholesky(A)
        L64 = L.double()
        chol.append(dict(n=n, finite=bool(torch.isfinite(L).all()), upper_zero=bool((torch.triu(L, 1) == 0).all()),
                         backward_err=norm(L64 @ L64.T, A), norm_err=norm(L, ref), library_norm_err=norm(lib, ref),
                         max_abs_err=float((L - ref).abs().max()), tol_backward=n * eps,
                         bit_identical_on_repeat=bool(torch.equal(L, hk.cholesky_blocked(A)))))
        for M in (1, 3, 100, n):
            R = torch.eye(n, device=dev) if M == n else torch.as_tensor(rng.randn(n, M), dtype=torch.float32, device=dev)
            X = hk.tri_solve_blocked(ref, R)
            torch.cuda.synchronize()
            X64 = torch.linalg.solve_triangular(ref.double(), R.double(), upper=False)
            plain, lib = hk.tri_solve_blocked_plain(ref, R), torch.linalg.solve_triangular(ref, R, upper=False)
            case = dict(n=n, M=M, norm_err_vs_f64=norm(X, X64), library_norm_err_vs_f64=norm(lib, X64),
                        plain_norm_err_vs_f64=norm(plain, X64), max_abs_err=float((X - plain).abs().max()))
            if n == LARGE_KERNEL_NS[-1]:
                case["bit_identical_on_repeat"] = bool(torch.equal(X, hk.tri_solve_blocked(ref, R)))
            tri.append(case)
        B = 16 if n <= 128 else (4 if n <= 300 else 3)
        Ks = torch.stack([path_gram(rng, n, dev) for _ in range(B)])
        bad = [1] if n <= 64 else [1, 2]
        Ks[1, n // 2, n // 2] = -1.0  # indefinite: a pivot past the first panel from n = 128 up
        if n > 64:
            Ks[2, n - 2, n - 2] = -1.0  # and one in the last panel
        Lb = hk.cholesky_batched(Ks)
        torch.cuda.synchronize()
        keep = [i for i in range(B) if i not in bad]
        refb, libb = hk.cholesky_batched_plain(Ks[keep]), torch.linalg.cholesky(Ks[keep])
        Lk = Lb[keep].double()
        batched.append(dict(B=B, n=n, indefinite=bad, upper_zero=bool((torch.triu(Lb[keep], 1) == 0).all()),
                            finite=torch.isfinite(Lb).all(-1).all(-1).tolist(),
                            backward_err=norm(Lk @ Lk.transpose(1, 2), Ks[keep]), norm_err=norm(Lb[keep], refb),
                            library_norm_err=norm(libb, refb), max_abs_err=float((Lb[keep] - refb).abs().max()),
                            tol_backward=n * eps))
    th3 = torch.tensor([0.7, 0.5, 0.9, 1.1], device=dev)
    a, b = (torch.as_tensor(rng.randn(m, 3), dtype=torch.float32, device=dev) for m in (300, 512))
    gram.append(dict(shape=[300, 512, 3], max_abs_err=float((hk.gaussian_gram(th3, a, b) - hk.gaussian_gram_plain(th3, a, b)).abs().max())))
    nan_blocked = True
    for n, at in ((300, 200), (1036, 1030), (44, 10)):  # a pivot of a middle, the ragged last or the only tile
        bad = path_gram(rng, n, dev)
        bad[at, at] = -1.0
        nan_blocked = nan_blocked and bool(torch.isnan(hk.cholesky_blocked(bad)).all())
    emit("kernels_large_n", tol=dict(gram_over_h2=GRAM_TOL, chol_norm=CHOL_NORM_TOL, chol_backward="n·eps32",
                                     tri="max(1e-4, 2 × the library's distance to f64)"),
         gaussian_gram=gram, cholesky_blocked=chol, tri_solve_blocked=tri, cholesky_batched=batched,
         cholesky_blocked_nan_on_indefinite=nan_blocked)
    for c in gram:
        check(c["max_abs_err"] <= GRAM_TOL * PARAMS_TL[0] ** 2,
              f"gaussian_gram within {GRAM_TOL}·h² of plain ({c})")
    for c in chol + batched:
        check(c["backward_err"] <= c["tol_backward"], f"backward error within n·eps32 ({c})")
        check(c["norm_err"] <= max(CHOL_NORM_TOL, 2.0 * c["library_norm_err"]), f"factor within the library's distance ({c})")
    for c in chol:
        check(c["finite"] and c["upper_zero"], f"cholesky_blocked finite, zeros above the diagonal ({c})")
        check(c["bit_identical_on_repeat"], f"cholesky_blocked deterministic ({c})")
    for c in batched:
        check(c["finite"] == [i not in c["indefinite"] for i in range(c["B"])],
              f"cholesky_batched NaN confined to the indefinite matrices ({c})")
        check(c["upper_zero"], f"cholesky_batched zeros above the diagonal ({c})")
    for c in tri:
        check(c["norm_err_vs_f64"] <= max(1e-4, 2.0 * c["library_norm_err_vs_f64"]), f"tri_solve_blocked accuracy ({c})")
        check(c.get("bit_identical_on_repeat", True), f"tri_solve_blocked deterministic ({c})")
    check(nan_blocked, "cholesky_blocked: an indefinite matrix gives a NaN factor")
    return {"gaussian_gram": max(c["max_abs_err"] for c in gram), "cholesky_blocked": max(c["max_abs_err"] for c in chol),
            "tri_solve_blocked": max(c["max_abs_err"] for c in tri),
            "cholesky_batched": max(c["max_abs_err"] for c in batched)}


def large_mll_case(dev, max_obs: int):
    """``mll_grad``'s inputs at a large-N shape: the recipe's state at
    max_obs (s = S_LARGE), the log-GP (n = max_obs) where max_obs < 1024 and
    the linear GP (n = 1036) at 1024, with FIT_RESTARTS θ rows around the
    recipe's hypers (exp(log θ0 + 0.4 N(0, 1)), RandomState(8)) →
    (thetas, s, x, y, mask)."""
    import torch

    st, _ = large_state(dev, max_obs, "float32")
    name, theta0, s, x, y, mask = fit_problems(st)[1 if max_obs >= 1024 else 0]
    rows = np.exp(np.log(theta0.cpu().numpy()) + 0.4 * np.random.RandomState(8).randn(FIT_RESTARTS, 2))
    return torch.as_tensor(rows, dtype=torch.float32, device=dev), s, x, y, mask


def check_large_mll(dev) -> dict:
    """``mll_grad_batched`` against its twin at the large-N path's shapes,
    (10, 256) and (10, 1036) (LARGE_MLL_SHAPES: the tiles, four launches a
    call), by ``mll_vs_plain``'s rule: the MLL to the twin, the gradient to
    float64 (``grad_vs_f64``)."""
    cases = [mll_vs_plain(*large_mll_case(dev, m), 1e-7, grad_vs_f64=True, max_obs=m, rows="around_theta0")
             for m in LARGE_MLL_SHAPES]
    emit("kernels_mll_large_n", tol=dict(mll_rel=MLL_RTOL, grad_norm=MLL_GRAD_NORM_TOL, cond_factor=MLL_COND_FACTOR,
                                          grad_vs="float64"), cases=cases)
    for c in cases:
        check(not c["failures"], f"mll_grad at n = {c['n']}: {c['failures']}")
    check([c["n"] for c in cases] == [256, 1036] and all(c["B"] == FIT_RESTARTS for c in cases),
          "mll_grad checked at (10, 256) and (10, 1036)")
    return {"max_abs_err": max(c["max_abs_err"] for c in cases)}


LARGE_WRAPPERS = ("esm_fused", "chol_batch", "gaussian_gram", "cholesky_blocked", "tri_solve_blocked", "cholesky_batched")


def kernel_counts() -> dict:
    from tpubq_torch.ops import hopper_kernels as hk

    return {k: getattr(hk, k).launches for k in LARGE_WRAPPERS}


def zero_counts() -> None:
    from tpubq_torch.ops import hopper_kernels as hk

    for k in LARGE_WRAPPERS + ("mll_grad_batched", "esm_fleet_l", "esm_fleet_tl"):
        getattr(hk, k).launches = 0


def delta(c0: dict, c1: dict) -> dict:
    return {k: c1[k] - c0[k] for k in c0}


def add_counts(opts, kind: str) -> dict:
    """Expected launches of one large-N add. A refit: per GP a Gram, the
    factor, and alpha forward + back and L⁻¹ (3 solves, one launch each), and
    the cross-Gram of the candidates' anchors. A fast incremental step: two bordering
    cross-Grams, the anchors' cross-Gram, the linear GP's fresh Gram and
    factor, and five single-column solves (the log-GP's bordered row, then
    each GP's alpha forward + back). A fallback (refresh) step: the fast
    step's work, then the refit's."""
    from tpubq_torch.ops import hopper_kernels as hk

    ns, nsc = opts.max_obs, opts.max_nsc
    CB, TB = hk.cholesky_blocked_launches, hk.tri_solve_blocked_launches
    refit = dict(gaussian_gram=3, cholesky_blocked=CB(ns) + CB(nsc), tri_solve_blocked=3 * (TB(ns) + TB(nsc)))
    fast = dict(gaussian_gram=4, cholesky_blocked=CB(nsc), tri_solve_blocked=3 * TB(ns) + 2 * TB(nsc))
    add = {"refit": refit, "fast": fast, "fallback": {k: refit[k] + fast[k] for k in refit}}[kind]
    return dict(esm_fused=0, chol_batch=0, cholesky_batched=0, **add)


def loop_step_counts(opts, kind: str) -> dict:
    """Expected launches of one step of run_active_loop: choose_next (one
    esm_fused call: ``esm_fused_launches`` launches), the add, and the moments
    (Z_var's quadrature: 3 Grams and one solve under the log-GP's factor)."""
    from tpubq_torch.ops import hopper_kernels as hk

    c = add_counts(opts, kind)
    c["esm_fused"] += hk.esm_fused_launches(opts.max_nsc, opts.max_obs, opts.dim)
    c["gaussian_gram"] += 3
    c["tri_solve_blocked"] += hk.tri_solve_blocked_launches(opts.max_obs)
    return c


def marginalize_counts(opts) -> dict:
    """Expected launches of marginalize over a batch of θ_tl rows: the log-GP
    rung stack once (chol_batch up to 240 rows, one launch; cholesky_batched
    above, 3⌈n/64⌉ − 2 launches whatever the batch), the
    linear GP's Gram, factor and alpha (forward + back, the batch of anchors
    as columns), and the V[Z] quadrature's cross-Gram under the linear GP."""
    from tpubq_torch.ops import hopper_kernels as hk

    small = hk.chol_batch_supported(opts.max_obs)
    return dict(esm_fused=0, chol_batch=int(small),
                cholesky_batched=0 if small else hk.cholesky_batched_launches(opts.max_obs), gaussian_gram=2,
                cholesky_blocked=hk.cholesky_blocked_launches(opts.max_nsc),
                tri_solve_blocked=2 * hk.tri_solve_blocked_launches(opts.max_nsc))


def large_n_path(dev) -> dict:
    """The large-max_obs path at max_obs 128, 256, 512 and 1024 (module
    docstring, phase 5), through init_state → Z_mean/Z_var →
    run_active_loop (8 steps, incremental False, True and "auto") →
    marginalize(100 given θ_tl rows), with the launch counters zeroed before
    and read after; then, outside the counted run, the checks against the
    port's float64 CPU path on the same data and picks, and esm_fused against
    its twin (both guards) on each state the max_obs 1024 refit loop scored,
    replayed on the card."""
    import torch

    from tpubq_torch.models import acquire, bq as bqm, incremental as inc, marginalize as margm

    grid64 = torch.linspace(-4.0, 4.0, LARGE_G, dtype=torch.float64)
    grid_dev = grid64.to(dev, torch.float32)
    thetas = torch.as_tensor(np.exp(np.log(PARAMS_TL) + 0.15 * np.random.RandomState(12).randn(LARGE_MARG_N, 2)),
                             dtype=torch.float32, device=dev)
    runs = {}
    zero_counts()
    t_all = time.perf_counter()
    for m in LARGE_MAX_OBS:
        st32, opts = large_state(dev, m, "float32")
        torch.cuda.synchronize()
        run = dict(opts=opts, st0=st32, z0=(float(bqm.Z_mean(st32, opts)), float(bqm.Z_var(st32, opts))),
                   esm_route=acquire.esm_route(st32, opts), modes={})
        for mode in (False, True, "auto"):
            c0 = kernel_counts()
            t0 = time.perf_counter()
            final, (xs, zm, zv) = acquire.run_active_loop(st32, opts, large_loglik, grid_dev[:, None], LARGE_STEPS,
                                                          incremental=mode)
            torch.cuda.synchronize()
            run["modes"][str(mode)] = dict(final=final, xs=xs[:, 0].cpu().double(), zm=zm.cpu().double(),
                                           zv=zv.cpu().double(), seconds=time.perf_counter() - t0,
                                           launches=delta(c0, kernel_counts()))
        c0 = kernel_counts()
        zms, zvs = margm.marginalize(run["modes"]["False"]["final"], opts, thetas)
        torch.cuda.synchronize()
        run["marg"] = dict(zm=zms.cpu().double(), zv=zvs.cpu().double(), launches=delta(c0, kernel_counts()))
        # one step of each kind at an interior point clear of the candidates (midway between
        # two observations): the full refit, a fast incremental step, and a refresh step
        x_mid = float(st32.x_s[m // 2, 0] + st32.x_s[m // 2 + 1, 0]) / 2.0
        l_mid = float(large_lik(x_mid))
        kinds = {}
        for kind, fn in (("refit", lambda: acquire.add_observation(st32, opts, [x_mid], l_mid)),
                         ("fast", lambda: inc.add_observation_fast(st32, opts, [x_mid], l_mid, refresh_every=16)),
                         ("fallback", lambda: inc.add_observation_fast(st32, opts, [x_mid], l_mid,
                                                                       refresh_every=int(st32.ns) + 1))):
            c0 = kernel_counts()
            out = fn()
            torch.cuda.synchronize()
            kinds[kind] = dict(launches=delta(c0, kernel_counts()), Z_mean=float(bqm.Z_mean(out, opts)))
        run["kinds"] = kinds
        runs[m] = run
    seconds = time.perf_counter() - t_all
    launches = kernel_counts()

    # ---- everything below compares; none of it counts as the path's launches
    results, failures, esm_cases = {}, [], []
    for m, run in runs.items():
        opts = run["opts"]
        st64, opts64 = large_state("cpu", m, "float64")
        res = dict(esm_route=run["esm_route"], live_condition_f64=live_conditions(st64), s=S_LARGE)
        z64 = (float(bqm.Z_mean(st64, opts64)), float(bqm.Z_var(st64, opts64)))
        rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
        # each mode's picks replayed in float64 on the CPU and, for the scorer's
        # resolved set, in float32 on the card (the same deterministic steps)
        for mode, add in (("False", lambda st_, o, x, l: acquire.add_observation(st_, o, [x], l)),
                          ("True", lambda st_, o, x, l: inc.add_observation_fast(st_, o, [x], l))):
            loop = run["modes"][mode]
            s32, s64 = run["st0"], st64
            zrel, vrel = [rel(run["z0"][0], z64[0])], [rel(run["z0"][1], z64[1])]
            gaps, errs, resolved = [], [], []
            for k, x in enumerate(loop["xs"].tolist()):
                if mode == "False" and m == LARGE_MAX_OBS[-1]:  # esm_fused against its twin on the scored state
                    args = acquire.esm_fused_inputs(s32, opts, grid_dev[:, None])
                    esm_cases += [esm_vs_plain(args, guard, MAX_FLIPS, max_obs=m, step=k) for guard in ("adaptive", "tpu")]
                gap, err, n_ok = pick_gap(s32, opts, s64, opts64, x, grid_dev, grid64)
                gaps.append(gap)
                errs.append(err)
                resolved.append(n_ok)
                lx = float(large_lik(x))
                s32 = add(s32, opts, x, lx)
                s64 = acquire.add_observation(s64, opts64, [x], lx)
                zrel.append(rel(float(loop["zm"][k]), float(bqm.Z_mean(s64, opts64))))
                vrel.append(rel(float(loop["zv"][k]), float(bqm.Z_var(s64, opts64))))
            key = "refit" if mode == "False" else "incremental"
            res[key] = dict(Z_mean_rel=max(zrel), Z_var_rel=max(vrel), pick_gaps=gaps, esm_f32_errs=errs,
                            f32_resolved_points=resolved, picks=loop["xs"].tolist())
            if mode == "False":
                s64_refit = s64
        n64 = LARGE_F64_MARG if m >= 1024 else LARGE_MARG_N
        zm64s, _ = margm.marginalize(s64_refit, opts64, thetas[:n64].double().cpu())
        res["marg_Z_mean_max_rel"] = float(((run["marg"]["zm"][:n64] - zm64s).abs() / zm64s.abs()).max())
        res["marg_rows_vs_f64"] = n64
        # incremental ≡ refit on the card: each within the float64 tolerances on its own
        # picks, and, where the picks agree, within INC_* of each other step by step
        inc_run, refit = run["modes"]["True"], run["modes"]["False"]
        same = bool(torch.equal(inc_run["xs"], refit["xs"]))
        res["incremental_vs_refit"] = dict(
            same_picks=same, Z_mean_rel=float(((inc_run["zm"] - refit["zm"]).abs() / refit["zm"].abs()).max()),
            Z_var_rel=float(((inc_run["zv"] - refit["zv"]).abs() / refit["zv"].abs()).max()))
        auto_mode = str(inc.incremental_auto(m))
        auto = run["modes"]["auto"]
        res["auto_resolves_to"] = auto_mode
        res["auto_identical"] = all(torch.equal(auto[k], run["modes"][auto_mode][k]) for k in ("xs", "zm", "zv"))
        # launch counts: exact per step kind
        for kind in ("refit", "fast", "fallback"):
            want = add_counts(opts, kind)
            res[f"{kind}_step_launches"] = run["kinds"][kind]["launches"]
            if run["kinds"][kind]["launches"] != want:
                failures.append(f"max_obs {m}: a {kind} step launched {run['kinds'][kind]['launches']}, expected {want}")
        if run["modes"]["False"]["launches"] != {k: LARGE_STEPS * v for k, v in loop_step_counts(opts, "refit").items()}:
            failures.append(f"max_obs {m}: the refit loop launched {run['modes']['False']['launches']}")
        # the incremental loop: k fast steps and 8 − k fallback steps, k read off cholesky_blocked
        got = run["modes"]["True"]["launches"]
        fast, back = loop_step_counts(opts, "fast"), loop_step_counts(opts, "fallback")
        k_fast = (LARGE_STEPS * back["cholesky_blocked"] - got["cholesky_blocked"]) // max(
            1, back["cholesky_blocked"] - fast["cholesky_blocked"])
        want = {k: k_fast * fast[k] + (LARGE_STEPS - k_fast) * back[k] for k in fast}
        res["incremental_loop"] = dict(fast_steps=k_fast, launches=got)
        if got != want:
            failures.append(f"max_obs {m}: the incremental loop launched {got}, not {k_fast} fast + "
                            f"{LARGE_STEPS - k_fast} fallback steps {want}")
        res["marginalize_launches"] = run["marg"]["launches"]
        if run["marg"]["launches"] != marginalize_counts(opts):
            failures.append(f"max_obs {m}: marginalize launched {run['marg']['launches']}, expected {marginalize_counts(opts)}")
        res["fast_step_Z_mean_rel_to_refit"] = rel(run["kinds"]["fast"]["Z_mean"], run["kinds"]["refit"]["Z_mean"])
        res["seconds_per_mode"] = {k: v["seconds"] for k, v in run["modes"].items()}
        results[m] = res
    emit("large_n_esm_vs_plain", G=LARGE_G, tol_norm=ESM_NORM_TOL, max_flips=MAX_FLIPS, cases=esm_cases)
    emit("large_n_path", steps=LARGE_STEPS, G=LARGE_G, s=S_LARGE, seconds=seconds, launches=launches,
         tol=dict(Z_mean=LARGE_ZMEAN_RTOL, Z_var=LARGE_ZVAR_RTOL, marg_mean=LARGE_MARG_RTOL,
                  inc_Z_mean=INC_ZMEAN_RTOL, inc_Z_var=INC_ZVAR_RTOL, esm_argmax=ESM_ARGMAX_RTOL),
         **{f"max_obs_{m}": r for m, r in results.items()})
    check(not failures, f"large-N launch counts: {failures}")
    check(all(launches[k] > 0 for k in ("gaussian_gram", "cholesky_blocked", "tri_solve_blocked", "cholesky_batched")),
          f"every kernel of the large-N path launched ({launches})")
    for m, r in results.items():
        for key in ("refit", "incremental"):
            q = r[key]
            check(q["Z_mean_rel"] <= LARGE_ZMEAN_RTOL, f"max_obs {m}, {key}: Z_mean f32 card vs f64 CPU ({q['Z_mean_rel']})")
            check(q["Z_var_rel"] <= LARGE_ZVAR_RTOL, f"max_obs {m}, {key}: Z_var f32 card vs f64 CPU ({q['Z_var_rel']})")
            check(all(g <= max(ESM_ARGMAX_RTOL, 2.0 * e) for g, e in zip(q["pick_gaps"], q["esm_f32_errs"])
                      if g is not None),
                  f"max_obs {m}, {key}: each pick is the f64 ESM maximum over the resolved points, up to the f32 scorer's error")
        check(r["marg_Z_mean_max_rel"] <= LARGE_MARG_RTOL, f"max_obs {m}: marginalized Z_mean ({r['marg_Z_mean_max_rel']})")
        iv = r["incremental_vs_refit"]
        check(not iv["same_picks"] or (iv["Z_mean_rel"] <= INC_ZMEAN_RTOL and iv["Z_var_rel"] <= INC_ZVAR_RTOL),
              f"max_obs {m}: incremental ≡ refit on the card ({iv})")
        check(r["auto_identical"], f"max_obs {m}: auto ≡ incremental={r['auto_resolves_to']}")
        check(r["fast_step_Z_mean_rel_to_refit"] <= INC_ZMEAN_RTOL, f"max_obs {m}: fast step ≡ refit step")
    return {"launches": launches, "esm_max_abs_err": max(c["max_abs_err"] for c in esm_cases)}


def large_bq(dev, dtype: str):
    """The large-N recipe at LARGE_FIT_MAX_OBS as a ``BQ`` (s = S_LARGE)."""
    from tpubq_torch import BQ

    x, l = large_data(LARGE_FIT_MAX_OBS)
    bq = BQ(x, l, device=dev, dtype=dtype, max_obs=LARGE_FIT_MAX_OBS, n_candidate=12, candidate_thresh=1e-3,
            s=S_LARGE)
    return bq.init(params_tl=PARAMS_TL, params_l=PARAMS_L)


def large_fit(dev) -> dict:
    """``BQ.fit_hypers`` at max_obs 1024 on the large-N recipe (1,024 and
    1,036 rows): the fused route, FIT_ITERS + 1 calls per GP, each
    ``mll_grad_launches(n)`` launches (the tiles), counted exactly with the
    counters zeroed before and read after, and timed once. Then, in float64
    on the CPU: each GP's MLL at the card's fitted hypers must not be below
    its MLL at the initial hypers, and E[Z] and V[Z] of the card after the fit
    are held to the port's float64 CPU path with the card's hypers installed
    (LARGE_ZMEAN_RTOL, LARGE_ZVAR_RTOL)."""
    import torch

    from tpubq_torch.models import bq as bqm, gp as gpm
    from tpubq_torch.ops import hopper_kernels as hk
    from tpubq_torch.ops.kernels import get_kernel

    bq, bq64 = large_bq(dev, "float32"), large_bq("cpu", "float64")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    bq.fit_hypers(ntry=FIT_RESTARTS, seed=FIT_SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {**kernel_counts(), "mll_grad": hk.mll_grad_batched.launches}
    n_s, n_sc = bq.options.max_obs, bq.options.max_nsc
    want = (FIT_ITERS + 1) * (hk.mll_grad_launches(n_s) + hk.mll_grad_launches(n_sc))

    kfn, _ = get_kernel("gaussian")
    fitted = {"log_gp": bq.state.gp_log_l.theta.double().cpu(), "linear_gp": bq.state.gp_l.theta.double().cpu()}
    gains = {}
    for i, name in enumerate(("log_gp", "linear_gp")):
        _, theta0, s_, x, y, mask = fit_problems(bq64.state)[i]
        mll = lambda th: float(gpm.log_mll(kfn, th, s_, x, y, mask, 1e-10))  # noqa: E731
        gains[name] = dict(theta_initial=theta0.tolist(), theta_card_f32=fitted[name].tolist(),
                           mll_initial=mll(theta0), mll_card_f32=mll(fitted[name]))
        kw = {"theta_tl": fitted[name]} if i == 0 else {"theta_l": fitted[name]}
        bq64._state = bqm.set_params(bq64.state, bq64.options, **kw)  # the linear GP's data follow θ_tl
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    res = dict(max_obs=LARGE_FIT_MAX_OBS, rows=(n_s, n_sc), s=S_LARGE, seconds=seconds, launches=launches,
               mll_grad_launches_expected=want, fit=gains, Z_mean=bq.Z_mean(), Z_mean_f64=bq64.Z_mean(),
               Z_var=bq.Z_var(), Z_var_f64=bq64.Z_var(),
               tol=dict(Z_mean=LARGE_ZMEAN_RTOL, Z_var=LARGE_ZVAR_RTOL))
    res["Z_mean_rel"], res["Z_var_rel"] = rel(res["Z_mean"], res["Z_mean_f64"]), rel(res["Z_var"], res["Z_var_f64"])
    emit("large_fit", **res)
    check(launches["mll_grad"] == want,
          f"fit_hypers at max_obs {LARGE_FIT_MAX_OBS} launched mll_grad {want} times, got {launches['mll_grad']}")
    for name, g in gains.items():
        check(g["mll_card_f32"] >= g["mll_initial"], f"the max_obs {LARGE_FIT_MAX_OBS} fit lowered the MLL ({name}: {g})")
    check(res["Z_mean_rel"] <= LARGE_ZMEAN_RTOL, f"E[Z] after the max_obs {LARGE_FIT_MAX_OBS} fit, f32 card vs f64 CPU")
    check(res["Z_var_rel"] <= LARGE_ZVAR_RTOL, f"V[Z] after the max_obs {LARGE_FIT_MAX_OBS} fit, f32 card vs f64 CPU")
    return res


def esm_size_routes(dev) -> dict:
    """Which scorer each state size takes (``acquire.esm_route``), and the
    card's float32 scores held to the CPU's float32 scores on the same route
    at 1e-4 of the largest score, off at most 2 points (degenerate-mask flips
    between two float32 evaluations): the testbed's 10 points at max_obs 32,
    1024 and 2048. Every size takes esm_fused, two launches a sweep (the
    kernel streams the inverses, so no state is too large for it)."""
    import torch

    from tpubq_torch.models import acquire
    from tpubq_torch.ops import hopper_kernels as hk

    grid = np.linspace(-4.0, 4.0, 2001)
    out = {}
    for max_obs in (32, 1024, 2048):
        bq, cpu = (make_bq(testbed_x(False), d, "float32", max_obs=max_obs, s=S_MAIN) for d in (dev, "cpu"))
        e0 = hk.esm_fused.launches
        got = torch.as_tensor(bq.expected_squared_mean(grid))
        torch.cuda.synchronize()
        want = torch.as_tensor(cpu.expected_squared_mean(grid))
        off = (got - want).abs() > 1e-4 * float(want.abs().max())
        out[max_obs] = dict(route=acquire.esm_route(bq.state, bq.options), esm_fused_launches=hk.esm_fused.launches - e0,
                            NP=bq.options.max_nsc, points_off=int(off.sum()),
                            max_rel_err=float(((got - want).abs() / want.abs().max())[~off].max()))
    emit("esm_size_routes", G=len(grid), **{f"max_obs_{m}": r for m, r in out.items()})
    check(all(r["route"] == "esm_fused" for r in out.values()), "max_obs 32, 1024 and 2048 take esm_fused")
    check(all(r["esm_fused_launches"] == hk.esm_fused_launches(r["NP"], m, 1) for m, r in out.items()),
          f"one esm_fused call per sweep, at its launch count ({out})")
    check(all(r["points_off"] <= 2 for r in out.values()), f"card scores ≡ CPU scores on every route ({out})")
    return out


def esm_beyond_1024(dev) -> dict:
    """esm_fused against its twin on the large-N recipe's max_obs 2048 state
    (NP 2060, NP2 2048) on ESM_2060_G random points in [−3, 3]. Under the
    production guard: within ESM_NORM_TOL of the largest score except at
    most max(MAX_FLIPS, 1% of the grid) points, each with its float64 γ
    within float32's noise λ·ρ·κ·Σk of the threshold (``flip_margins``): a
    flip, or a point just past the guard whose B = (ζ − zᵀK⁻¹k)/γ carries γ's
    rounding. Under the TPU kernel's own eps·κ guard, printed, not gated: how
    many points differ beyond ESM_NORM_TOL and how far above float32's noise
    their γ reaches (γ / λρκΣk), the witness that those scores are a quotient
    by rounding noise in both evaluations."""
    import torch

    from tpubq_torch.models import acquire
    from tpubq_torch.ops import hopper_kernels as hk

    st, opts = large_state(dev, 2048, "float32")
    rng = np.random.RandomState(ESM_2060_G)
    grid = torch.as_tensor(rng.uniform(-3.0, 3.0, (ESM_2060_G, 1)), dtype=torch.float32, device=dev)
    args = list(acquire.esm_fused_inputs(st, opts, grid))
    nm = args[0][-1].item()
    out = {}
    for guard in ("adaptive", "tpu"):
        if guard == "tpu":
            args[0] = args[0].clone()
            args[0][-1] = 0.0
        got = hk.esm_fused(*args)
        torch.cuda.synchronize()
        ref = hk.esm_fused_plain(*args)
        zta2 = (args[0][5] * args[0][5]).item()
        scale = ref.abs().max().item()
        off = (got - ref).abs() > ESM_NORM_TOL * scale
        idx = torch.nonzero(off)[:, 0]
        m = flip_margins(args, idx, nm)
        out[guard] = dict(NP=args[2].shape[0], NP2=args[7].shape[0], points_off=len(idx),
                          flips=int(((got == zta2) != (ref == zta2))[idx].sum()),
                          max_gamma_over_noise=max((g / n for g, n in zip(m["gamma_over_thr"], m["noise_over_thr"])),
                                                   default=None),
                          off_rel_err=((got - ref).abs()[idx] / scale).tolist()[:8], finite=bool(torch.isfinite(got).all()),
                          **({"margins": m} if guard == "adaptive" else {"within_noise": m["within_noise"]}))
    emit("esm_beyond_1024", G=ESM_2060_G, tol_norm=ESM_NORM_TOL, **out)
    a = out["adaptive"]
    check(a["finite"] and out["tpu"]["finite"], "esm_fused at NP 2060: finite scores")
    check(a["points_off"] <= max(MAX_FLIPS, ESM_2060_G // 100) and a["margins"]["within_noise"],
          f"esm_fused at NP 2060 differs from its twin only where γ is within float32's noise of the guard ({a})")
    return out


def esm_ops(G: int, NP: int, NP2: int) -> float:
    """float32 operations of one ESM sweep (an expf counted as one): 2 per
    (i, j) term of the two quadratic forms, ~12 per row for the cross-kernel
    and the dots, ~40 per point for the rest."""
    return G * (2 * NP * NP + 2 * NP2 * NP2 + 12 * (NP + NP2) + 40)


def esm_bytes(G: int, NP: int, NP2: int, d: int = 1) -> float:
    """Bytes of one ESM sweep read or written once: the grid, the packed
    scalars, the problem's vectors and inverses, the scores."""
    return 4 * (12 + G * d + (3 + d) * NP + NP * NP + (2 + d) * NP2 + NP2 * NP2 + G)


def mll_ops(B: int, n: int) -> float:
    """float32 operations of ``mll_grad_batched`` on B rows of n points:
    the Cholesky (n³/3), L⁻¹ (n³/3) and the lower half of the symmetric
    K⁻¹ = YᵀY (n³/3), the Gram and the traces (~27 n²)."""
    return B * (n**3 + 27 * n * n)


def mll_bytes(B: int, n: int) -> float:
    """Bytes read or written once: θ, s, x, y, the mask, the MLL and gradient."""
    return 4 * (2 * B + 1 + 2 * n) + n + 4 * 3 * B


def esm_fused_turns(args, it: int) -> list:
    """CUDA-event ms per ``esm_fused`` call on packed inputs ``args``, in two
    turns of ``it`` calls."""
    from tpubq_torch.ops import hopper_kernels as hk

    return [cuda_ms(lambda: hk.esm_fused(*args), it) for _ in range(2)]


def chol_blocked_turns(A, it: int = 20) -> tuple:
    """CUDA-event ms per call of ``cholesky_blocked`` and of
    ``torch.linalg.cholesky_ex`` on A, each in turn (kernel, library, kernel,
    library), ``it`` calls a turn → (kernel turns, library turns)."""
    import torch

    from tpubq_torch.ops import hopper_kernels as hk

    k_ms, lib_ms = [], []
    for _ in range(2):
        k_ms.append(cuda_ms(lambda: hk.cholesky_blocked(A), it))
        lib_ms.append(cuda_ms(lambda: torch.linalg.cholesky_ex(A), it))
    return k_ms, lib_ms


def esm_timing(dev) -> dict:
    """esm_fused on the large-N recipe's max_obs 1024 state (NP 1036, NP2
    1024) at ESM_LARGE_SHAPES, in two turns, beside its plain twin and the
    plain scorer (``expected_squared_mean_xla``, what the port ran for states
    above the old design's shared memory), with its bound."""
    import torch

    from tpubq_torch.models import acquire
    from tpubq_torch.ops import hopper_kernels as hk

    out = {}
    st, opts = large_state(dev, 1024, "float32")
    for Gs, m in ESM_LARGE_SHAPES:
        args = acquire.esm_fused_inputs(st, opts, torch.linspace(-4.0, 4.0, Gs, device=dev)[:, None])
        NP, NP2 = args[2].shape[0], args[7].shape[0]
        it = 20 if Gs <= LARGE_G else 5
        turns = esm_fused_turns(args, it)
        out[f"esm_fused_G{Gs}_NP{NP}"] = dict(
            kernel_ms=min(turns), kernel_ms_turns=turns, launches_per_call=hk.esm_fused_launches(NP, NP2, 1),
            plain_ms=cuda_ms(lambda: hk.esm_fused_plain(*args), 2, warmup=1),
            plain_scorer_ms=cuda_ms(lambda: acquire.expected_squared_mean_xla(st, opts, args[1]), 2, warmup=1),
            **bound(esm_bytes(Gs, NP, NP2), esm_ops(Gs, NP, NP2)))
    return out


def large_timing(dev, label: str) -> dict:
    """CUDA-event times of the four kernels of the large-N path, their plain
    versions and the library call beside each, at the path's max_obs 1024
    shapes (cholesky_blocked, tri_solve_blocked and cholesky_batched in two
    turns with their library calls, kernel then library, the faster turn of
    each reported; cholesky_blocked also at LARGE_CHOL_TIMING_N), with their
    bounds; esm_fused at the path's scoring shapes (``esm_timing``); and the
    refit / incremental sweep: host ms per closed-loop step of
    run_active_loop (8 steps, record_moments=False, turns refit, incremental,
    incremental, refit) and per add at an interior point, at max_obs 64 … 1024."""
    import torch

    from tpubq_torch.models import acquire, incremental as inc
    from tpubq_torch.ops import hopper_kernels as hk

    rng = np.random.RandomState(9)
    n, ns = LARGE_TIMING_N
    th = torch.tensor(PARAMS_L, device=dev)
    x = torch.as_tensor(np.sort(rng.uniform(-2.2, 2.2, n))[:, None], dtype=torch.float32, device=dev)
    kern = {}
    kern["gaussian_gram"] = dict(shape=f"({n}, {n}), d = 1", kernel_ms=cuda_ms(lambda: hk.gaussian_gram(th, x, x), 200),
                                 plain_ms=cuda_ms(lambda: hk.gaussian_gram_plain(th, x, x), 50), library_ms=None)
    for N in LARGE_CHOL_TIMING_N:
        A = path_gram(rng, N, dev)
        k_ms, lib_ms = chol_blocked_turns(A)
        # bytes: A and L once; operations: N³/3 multiply-adds
        kern[f"cholesky_blocked_{N}"] = dict(
            kernel_ms=min(k_ms), kernel_ms_turns=k_ms, plain_ms=cuda_ms(lambda: hk.cholesky_blocked_plain(A), 1, warmup=0),
            library_ms=min(lib_ms), library_ms_turns=lib_ms, launches_per_call=hk.cholesky_blocked_launches(N), **bound(2 * 4 * N * N, N**3 / 3))
    kern.update(esm_timing(dev))
    for m in LARGE_MLL_SHAPES:  # mll_grad at (10, 256) and (10, 1036): the tiles
        thetas, s_, xm, ym, mm = large_mll_case(dev, m)
        B, nm = thetas.shape[0], xm.shape[0]
        kern[f"mll_grad_{B}x{nm}"] = dict(
            kernel_ms=cuda_ms(lambda: hk.mll_grad_batched(thetas, s_, xm, ym, mm, jitter=1e-7), 20),
            plain_ms=cuda_ms(lambda: hk.mll_grad_batched_plain(thetas, s_, xm, ym, mm, 1e-7), 1, warmup=0),
            launches_per_call=hk.mll_grad_launches(nm), **bound(mll_bytes(B, nm), mll_ops(B, nm)))
    L = torch.linalg.cholesky(path_gram(rng, n, dev)).contiguous()
    for M in (n, 1, 3, 100):
        R = torch.eye(n, device=dev) if M == n else torch.as_tensor(rng.randn(n, M), dtype=torch.float32, device=dev)
        # each call in turn (kernel, library, kernel, library), 20 calls a turn
        k_ms, lib_ms = [], []
        for _ in range(2):
            k_ms.append(cuda_ms(lambda: hk.tri_solve_blocked(L, R), 20))
            lib_ms.append(cuda_ms(lambda: torch.linalg.solve_triangular(L, R, upper=False), 20))
        # bytes: L's lower triangle, R and X once; operations: N² M (N² M / 2 multiply-adds)
        kern[f"tri_solve_blocked_{n}x{M}"] = dict(
            kernel_ms=min(k_ms), kernel_ms_turns=k_ms, plain_ms=cuda_ms(lambda: hk.tri_solve_blocked_plain(L, R), 2),
            library_ms=min(lib_ms), library_ms_turns=lib_ms, launches_per_call=hk.tri_solve_blocked_launches(n),
            **bound(4 * (n * (n + 1) / 2 + 2 * n * M), n * n * M))
    for B, N in LARGE_TIMING_BATCHED:
        base = torch.stack([path_gram(rng, N, dev) for _ in range(8)])
        Ks = base.repeat(B // 8, 1, 1).contiguous()
        k_ms, lib_ms = [], []
        for _ in range(2):
            k_ms.append(cuda_ms(lambda: hk.cholesky_batched(Ks), 3, warmup=1))
            lib_ms.append(cuda_ms(lambda: torch.linalg.cholesky_ex(Ks), 3, warmup=1))
        # bytes: the stack read and the factors written once; operations: B N³ / 3
        kern[f"cholesky_batched_{B}x{N}"] = dict(
            kernel_ms=min(k_ms), kernel_ms_turns=k_ms, plain_ms=cuda_ms(lambda: hk.cholesky_batched_plain(Ks), 1, warmup=0),
            library_ms=min(lib_ms), library_ms_turns=lib_ms, launches_per_call=hk.cholesky_batched_launches(N),
            **bound(2 * 4 * B * N * N, B * N**3 / 3))
        del base, Ks
    torch.cuda.empty_cache()

    grid = torch.linspace(-4.0, 4.0, LARGE_G, device=dev)[:, None]
    sweep = {}
    for m in LARGE_SWEEP:
        st, opts = large_state(dev, m, "float32")

        def loop(mode):
            return acquire.run_active_loop(st, opts, large_loglik, grid, LARGE_STEPS, incremental=mode,
                                           record_moments=False)

        t = {True: [], False: []}
        for mode in (False, True, True, False):
            t[mode].append(host_ms(lambda: loop(mode), 2) / LARGE_STEPS)
        c0 = kernel_counts()
        loop(True)
        torch.cuda.synchronize()
        got = delta(c0, kernel_counts())
        fast, back = add_counts(opts, "fast"), add_counts(opts, "fallback")
        k_fast = (LARGE_STEPS * back["cholesky_blocked"] - got["cholesky_blocked"]) // max(
            1, back["cholesky_blocked"] - fast["cholesky_blocked"])
        x_mid = float(st.x_s[m // 2, 0] + st.x_s[m // 2 + 1, 0]) / 2.0
        add_refit = host_ms(lambda: acquire.add_observation(st, opts, [x_mid], 0.3), 5)
        add_fast = host_ms(lambda: inc.add_observation_fast(st, opts, [x_mid], 0.3), 5)
        refit_ms, inc_ms = float(np.mean(t[False])), float(np.mean(t[True]))
        sweep[m] = dict(refit_ms_per_step=refit_ms, incremental_ms_per_step=inc_ms, refit_over_incremental=refit_ms / inc_ms,
                        runs_ms_per_step=dict(refit=t[False], incremental=t[True]), fast_steps_of_8=k_fast,
                        add_refit_ms=add_refit, add_fast_ms=add_fast, add_refit_over_fast=add_refit / add_fast)
    res = dict(card=label, kernels=kern, sweep={f"max_obs_{m}": v for m, v in sweep.items()},
               window=list(inc.INCREMENTAL_AUTO_WINDOW))
    emit("large_n_timing", **res)
    return res


# ---------------------------------------------------------------------------
# phase 6: the s = 0 observation (printed, not gated)
# ---------------------------------------------------------------------------


def s0_observation(dev, max_steps: int = 20) -> dict:
    """How many active steps the float32 path takes at s = 0 before rung 0 of
    the jitter ladder fails on either GP (the factor then comes from the 1e-4
    rung, which inflates V[Z] to its jitter level): with the fixed testbed
    hypers, after one ``fit_hypers`` at the start, and with a refit before
    every step. An observation for PERF.md; nothing is gated on it."""
    grid = np.linspace(-4.0, 4.0, G)

    def rescued(gp) -> bool:
        # rung 0 reports jitter = base_jitter · mean diagonal (~1e-12 h²), the rescue rung 1e-4 h²
        return float(gp.jitter) > 1e-5 * float(gp.theta[0]) ** 2

    out = {}
    for mode in ("fixed_hypers", "fit_once", "refit_every_step"):
        bq = make_bq(testbed_x(False), dev, "float32", s=0.0)
        if mode != "fixed_hypers":
            bq.fit_hypers(seed=FIT_SEED)
        steps, why = 0, "reached max_steps"
        for _ in range(max_steps):
            st = bq.state
            if rescued(st.gp_log_l) or rescued(st.gp_l):
                why = "rung 0 failed on the " + ("log-GP" if rescued(st.gp_log_l) else "linear GP")
                break
            if not (bool(st.gp_log_l.ok) and bool(st.gp_l.ok)):
                why = "the ladder was exhausted"
                break
            xn = bq.choose_next(grid)
            if np.min(np.abs(bq.x_s[:, 0] - xn)) < 1e-10:
                why = "the scorer picked an observed point"
                break
            bq.add_observation(xn, float(f_l(xn)))
            steps += 1
            if mode == "refit_every_step":
                bq.fit_hypers(seed=FIT_SEED + steps)
        st = bq.state
        out[mode] = dict(steps_before_rung0_fails=steps, stopped_because=why, ns=bq.ns,
                         theta_tl=st.gp_log_l.theta.tolist(), theta_l=st.gp_l.theta.tolist(),
                         Z_mean=bq.Z_mean() if bool(st.gp_log_l.ok) and bool(st.gp_l.ok) else None,
                         Z_var=bq.Z_var() if bool(st.gp_log_l.ok) and bool(st.gp_l.ok) else None)
    emit("s0_observation", gated=False, true_Z=true_Z(), **out)
    return out


# ---------------------------------------------------------------------------
# phase 7: timing
# ---------------------------------------------------------------------------


def timing(dev, mp: dict, label: str) -> dict:
    import torch

    from tpubq_torch.models import acquire, fit as fitm, marginalize as margm
    from tpubq_torch.ops import hopper_kernels as hk
    from tpubq_torch.ops.kernels import get_kernel

    bq = mp["bq"]
    st, opts = bq.state, bq.options
    # mll_grad at the fit's two shapes, (10, 32) and (10, 44), on restart rows; beside it its
    # twin and the batched autograd value-and-gradient (log_mll + backward through the
    # library's Cholesky and triangular solves), the nearest a user could write without the kernel
    kfn, _ = get_kernel("gaussian")
    gen = torch.Generator().manual_seed(FIT_SEED)
    mll_t = {}
    for name, theta0, s, x, y, mask in fit_problems(st):
        us = fitm.random_restarts(gen, theta0, x, y, mask, FIT_RESTARTS)
        thetas = torch.exp(us)
        obj = fitm._objective(kfn, s, x, y, mask, 1e-7)
        mll_t[f"{FIT_RESTARTS}x{x.shape[0]}"] = dict(
            gp=name,
            kernel_ms=cuda_ms(lambda: hk.mll_grad_batched(thetas, s, x, y, mask, jitter=1e-7), 200),
            plain_ms=cuda_ms(lambda: hk.mll_grad_batched_plain(thetas, s, x, y, mask, 1e-7), 5),
            autograd_ms=cuda_ms(lambda: fitm._value_and_grad(obj, us), 20),
        )
    st0 = make_bq(testbed_x(False), dev, "float32", s=S_MAIN).state

    def refit():
        bq._state = st0
        bq.fit_hypers(ntry=FIT_RESTARTS, seed=FIT_SEED)

    fit_ms = host_ms(refit, 3)
    bq._state = st
    grid = torch.linspace(-4.0, 4.0, G, device=dev)[:, None]
    args = acquire.esm_fused_inputs(st, opts, grid)
    esm_ms = cuda_ms(lambda: hk.esm_fused(*args), 200)
    esm_plain_ms = cuda_ms(lambda: hk.esm_fused_plain(*args), 50)
    rng = np.random.RandomState(1)
    chol = {}
    # CHOL_PATH_SHAPES: marginalize(n=100)'s rung stack, the fleet's refits
    # at B = 64 and marginalize at max_obs 128; B = 2, 4, 8: the stacks of
    # small batched refits, where posdef_cholesky_batched picks the route
    for B, n, live in CHOL_PATH_SHAPES + ((2, 32, 21), (4, 32, 21), (8, 32, 21), (2, 44, 33), (4, 44, 33),
                                          (8, 44, 33)):
        Ks = _gram_stack(B, n, live, rng, dev)
        chol[f"{B}x{n}x{n}"] = dict(
            kernel_ms=cuda_ms(lambda: hk.chol_batch(Ks), 200),
            library_ms=cuda_ms(lambda: torch.linalg.cholesky_ex(Ks), 200),
            bound_ms=bound(chol_batch_bytes(B, n), B * n**3 // 3)["bound_ms"], dependent_steps=n,
        )
        if B >= 128:
            chol[f"{B}x{n}x{n}"]["plain_ms"] = cuda_ms(lambda: hk.chol_batch_plain(Ks), 10)
    xs = np.linspace(-3.9, 3.9, 7)
    add_ms = host_ms(lambda: [acquire.add_observation(st, opts, xa, 0.01) for xa in xs], 5) / len(xs)
    marg_ms = host_ms(lambda: margm.marginalize(st, opts, mp["thetas"]), 10)
    marg_sampled_ms = host_ms(lambda: bq.marginalize(n=100, seed=5), 2)
    choose_ms = host_ms(lambda: bq.choose_next(grid), 20)
    res = dict(
        card=label, esm_fused_ms=esm_ms, esm_fused_plain_ms=esm_plain_ms,
        esm_points_per_s=G / (esm_ms * 1e-3), esm_plain_points_per_s=G / (esm_plain_ms * 1e-3),
        chol_batch=chol, mll_grad=mll_t, fit_hypers_ms=fit_ms,
        add_observation_ms_per_step=add_ms, choose_next_ms=choose_ms,
        marginalize_n100_ms_given_samples=marg_ms, marginalize_n100_ms_with_sampling=marg_sampled_ms,
    )
    emit("timing", **res)
    return res


def fleet_fit_calls(dev, B: int = FLEET_FIT_B, n_obs: int = FLEET_N_OBS, max_obs: int = FLEET_MAX_OBS) -> list:
    """The first ``mll_grad_batched`` call of each GP in the fit of a fleet of
    B problems of the fleet recipe (s = S_MAIN), FIT_RESTARTS rows a problem,
    as (gp, thetas, s, x, y, mask): the log-GP at n = max_obs (its n_obs
    observations live) and the linear GP at n = max_obs + 12 (the
    observations and the candidates kept, in the tail)."""
    import torch

    from tpubq_torch.models import fit as fitm

    st, _ = fleet_state(dev, B, n_obs, max_obs, s=S_MAIN)
    gen = torch.Generator().manual_seed(FIT_SEED)
    l_sc = torch.where(st.sc_mask, st.l_sc, torch.zeros_like(st.l_sc))
    calls = []
    for name, gp, x, y, mask in (("log_gp", st.gp_log_l, st.x_s, st.tl_s, st.obs_mask),
                                 ("linear_gp", st.gp_l, st.x_sc, l_sc, st.sc_mask)):
        thetas = torch.exp(fitm.random_restarts(gen, gp.theta, x, y, mask, FIT_RESTARTS).reshape(-1, 2))
        calls.append((name, thetas.contiguous(), gp.s, x, y, mask))
    return calls


def grown_fleet_fit_calls(dev, B: int = FLEET_FIT_B) -> list:
    """``fleet_fit_calls`` on a fleet at max_obs GROWN_MAX_OBS whose problems
    hold GROWN_OBS observations in turn, as after the active loop has grown
    them: each GP's call (n = 52 and 64) holds rows of NP 16, 32 and 64 side
    by side."""
    import torch

    parts = [fleet_fit_calls(dev, B, n_obs, GROWN_MAX_OBS) for n_obs in GROWN_OBS]
    turn, problem = torch.arange(B, device=dev) % len(parts), torch.arange(B, device=dev)
    calls = []
    for gp in range(2):
        def pick(k):  # problem i from part i % len(parts)
            shape = parts[0][gp][k].shape
            return torch.stack([p[gp][k].reshape(B, -1) for p in parts])[turn, problem].reshape(shape).contiguous()

        calls.append((parts[0][gp][0], *(pick(k) for k in range(1, 6))))
    return calls


def _np_classes(mask, B: int):
    """The NP at which the one-launch regime of ``mll_grad_batched`` runs each
    of B rows on per-problem data with this (P, n) mask: the smallest of 16,
    32 and the launch's (the least of 16, 32, 64 that holds n) that holds the
    row's live points."""
    import torch

    n = mask.shape[-1]
    live = mask.sum(-1).repeat_interleave(B // mask.shape[0])
    launch = 16 if n <= 16 else 32 if n <= 32 else 64
    return torch.where(live <= 16, 16, torch.where(live <= 32, 32, launch)).to(torch.uint8)


def fleet_fit_mll(dev, label: str) -> dict:
    """``mll_grad_batched`` at the benchmark fleet's fit shapes, 10,240 rows
    at n = 32 and n = 44 (``fleet_fit_calls``), and at the same shapes on a
    grown fleet (``grown_fleet_fit_calls``: rows of every class in one
    launch, eight rows a block): the NP each row ran at (``sizes_out``)
    against the class its mask implies, CUDA-event ms (two turns) and device
    ms beside the bound of the rows' live work (n³ + 27n² a row at its live
    count), and the plain twin's agreement by ``mll_vs_plain``'s rule for a
    fleet."""
    import torch

    from tpubq_torch.ops import hopper_kernels as hk

    out = {}
    calls = [("", c) for c in fleet_fit_calls(dev)] + [("_grown", c) for c in grown_fleet_fit_calls(dev)]
    for tag, (name, thetas, s, x, y, mask) in calls:
        B, n = thetas.shape[0], x.shape[-2]
        sizes = torch.zeros(B, dtype=torch.uint8, device=dev)
        hk.mll_grad_batched(thetas, s, x, y, mask, jitter=1e-7, sizes_out=sizes)
        torch.cuda.synchronize()
        classes, counts = torch.unique(sizes, return_counts=True)
        live = mask.sum(-1).double().repeat_interleave(B // mask.shape[0])
        fn = lambda: hk.mll_grad_batched(thetas, s, x, y, mask, jitter=1e-7)  # noqa: E731
        turns = [cuda_ms(fn, 50) for _ in range(2)]
        dms, by = device_ms(fn, 20)
        case = mll_vs_plain(thetas, s, x, y, mask, 1e-7, cond_factor=MLL_FLEET_COND_FACTOR,
                            mll_floor=float(mask[0].sum()), gp=name, rows="fleet fit restarts",
                            problems=x.shape[0])
        rows_to_max(case)
        b = bound(mll_bytes(B, n * x.shape[0]), float((live**3 + 27.0 * live**2).sum()))
        out[f"{B}x{n}{tag}"] = dict(
            gp=name, live_mean=float(live.mean()), live_max=int(live.max()),
            sizes_hist={int(k): int(v) for k, v in zip(classes.tolist(), counts.tolist())},
            sizes_match_masks=torch.equal(sizes, _np_classes(mask, B)),
            event_ms_turns=turns, event_ms=min(turns), device_ms=dms, device_ms_by_activity=by,
            **b, share_of_bound=b["bound_ms"] / dms, vs_plain=case)
    emit("fleet_fit_mll", card=label, **out)
    for shape, r in out.items():
        check(r["sizes_match_masks"], f"mll_grad at {shape}: sizes_out is the class each row's mask implies")
        check(r["sizes_hist"].get(16, 0) > 0, f"mll_grad at {shape}: rows of the fleet's shapes run at NP 16")
        check(set(r["sizes_hist"]) == {16, 32, 64} or not shape.endswith("_grown"),
              f"mll_grad at {shape}: rows of every NP class in one launch")
        check(not r["vs_plain"]["failures"], f"mll_grad at {shape} ({r['gp']}): {r['vs_plain']['failures']}")
    return out


def fleet_timing(dev, fk: dict, fp: dict, mp: dict, label: str) -> dict:
    """CUDA-event times of the two fleet kernels, their plain versions and the
    plain batched scorer at the three B = 64 shapes; the elementwise combine
    and the selection at the fleet path's shape; 64 back-to-back ``esm_fused``
    launches (what scoring the fleet costs without the fleet kernels); and
    host-clock times of ``BQFleet.choose_next`` / ``add_observation`` / ``fit``
    at B = 1, 8 and 64."""
    import torch

    from tpubq_torch import BQFleet
    from tpubq_torch.models import acquire, batched
    from tpubq_torch.ops import hopper_kernels as hk

    grid = torch.linspace(-4.0, 4.0, G, device=dev)[:, None]
    thresh, lam = 0.2, batched._LAM_F32
    shapes = {}
    states = {**fk["states"], (44, 32): (fp["state"], fp["opts"])}  # the path's own state after three steps
    for (NP, NP2), (st, opts) in sorted(states.items()):
        (params, w_l, *rest_l), (h2, w_tl, *rest_tl), _ = batched.fleet_scorer_inputs(st, opts)
        shapes[f"{NP}x{NP2}"] = dict(
            esm_fleet_l_ms=cuda_ms(lambda: hk.esm_fleet_l(params, w_l, grid, *rest_l, thresh, lam), 50),
            esm_fleet_l_plain_ms=cuda_ms(lambda: hk.esm_fleet_l_plain(params, w_l, grid, *rest_l, thresh, lam), 5),
            esm_fleet_tl_ms=cuda_ms(lambda: hk.esm_fleet_tl(h2, w_tl, grid, *rest_tl), 50),
            esm_fleet_tl_plain_ms=cuda_ms(lambda: hk.esm_fleet_tl_plain(h2, w_tl, grid, *rest_tl), 5),
            plain_batched_scorer_ms=cuda_ms(lambda: acquire.expected_squared_mean_xla(st, opts, grid), 5),
            fleet_scorer_ms=cuda_ms(lambda: batched.expected_squared_mean_fleet(st, opts, grid), 20),
        )
    st, opts = states[(44, 32)]
    args_l, args_tl, zTa = batched.fleet_scorer_inputs(st, opts)
    A, Bc, dg = hk.esm_fleet_l(args_l[0], args_l[1], grid, *args_l[2:], thresh, lam)
    m_a, c_a = hk.esm_fleet_tl(args_tl[0], args_tl[1], grid, *args_tl[2:])
    scores = fleet_combine(A, Bc, dg, m_a, c_a, st.gamma, zTa)
    single_args = acquire.esm_fused_inputs(mp["bq"].state, mp["bq"].options, grid)
    pieces = dict(
        scorer_inputs_ms=cuda_ms(lambda: batched.fleet_scorer_inputs(st, opts), 20),
        combine_ms=cuda_ms(lambda: fleet_combine(A, Bc, dg, m_a, c_a, st.gamma, zTa), 50),
        demote_argmax_ms=cuda_ms(lambda: torch.argmax(acquire.demote_near_observed(
            scores, grid, st.x_s, st.obs_mask, opts.candidate_thresh), dim=1), 20),
        esm_fused_x64_ms=cuda_ms(lambda: [hk.esm_fused(*single_args) for _ in range(FLEET_B)], 10),
    )

    xs, ls, mus = fleet_data(FLEET_B, FLEET_N_OBS)
    kw = dict(params_tl=PARAMS_TL, params_l=PARAMS_L, n_candidate=12, candidate_thresh=0.2,
              max_obs=FLEET_MAX_OBS, s=S_MAIN, device=dev, dtype="float32")
    grid_np = np.linspace(-4.0, 4.0, G)
    facade = {}
    for B in (1, 8, FLEET_B):
        fleet = BQFleet(xs[:B], ls[:B], **kw)
        st0 = fleet.states

        def refit():
            fleet._states = st0
            fleet.fit(ntry=FIT_RESTARTS, seed=FIT_SEED)

        fit_ms = host_ms(refit, 2)
        st1 = fleet.states
        xn = fleet.choose_next(grid_np)
        ln = fleet_lik(xn[:, 0], mus[:B])

        def add():
            fleet._states = st1
            fleet.add_observation(xn, ln)

        choose_ms, add_ms = host_ms(lambda: fleet.choose_next(grid_np), 10), host_ms(add, 10)
        facade[f"B{B}"] = dict(fit_ms=fit_ms, choose_next_ms=choose_ms, add_observation_ms=add_ms,
                               problem_steps_per_s=B / ((choose_ms + add_ms) * 1e-3))
    res = dict(card=label, G=G, B=FLEET_B, shapes=shapes, pieces_44x32=pieces, facade=facade)
    emit("fleet_timing", **res)
    return res


def large_esm_entry(lp: dict, lt: dict) -> dict:
    """The esm_fused entry's fields at the large-N path's shapes: its
    launches on that path, its error against the twin on the max_obs 1024
    states, and per ESM_LARGE_SHAPES its time, bound, twin and plain scorer."""
    out = dict(large_n_launches=lp["launches"]["esm_fused"], large_n_max_abs_err=lp["esm_max_abs_err"])
    for key, v in lt["kernels"].items():
        if key.startswith("esm_fused_G"):
            out[f"at_{key[len('esm_fused_'):]}"] = {k: v[k] for k in ("kernel_ms", "plain_ms", "plain_scorer_ms",
                                                                       "bound_ms", "bound_by", "launches_per_call")}
    return out


def large_kernel_entries(lp: dict, lk: dict, lt: dict) -> list:
    """The kernels-line entries of the large-N path's four kernels at its
    max_obs 1024 shapes: the linear GP's Gram and factor (n = 1036), its K⁻¹
    solve (L⁻¹ against I), marginalize's rung stack (200, 1024, 1024); beside
    the solve its (1036, 1), (1036, 3) and (1036, 100) times and beside the
    stack its (200, 256, 256) time, each with its library time and bound.
    Bounds: Cholesky n³/3 flops (n dependent steps), the solve N²M flops and
    L's lower triangle read once, the Gram 6 operations per entry at d = 1;
    bytes as everywhere."""
    gn = LARGE_TIMING_N[0]
    bB, bn = LARGE_TIMING_BATCHED[-1]
    kt = lt["kernels"]
    g_t, cb_t = kt["gaussian_gram"], kt[f"cholesky_blocked_{gn}"]
    ts_t, cbat_t = kt[f"tri_solve_blocked_{gn}x{gn}"], kt[f"cholesky_batched_{bB}x{bn}"]
    at = lambda t: {k: t[k] for k in ("kernel_ms", "library_ms", "plain_ms", "bound_ms", "bound_by")}  # noqa: E731
    other_tri = {f"at_{gn}x{M}": at(kt[f"tri_solve_blocked_{gn}x{M}"]) for M in (1, 3, 100)}
    other_batched = {f"at_{B}x{N}": at(kt[f"cholesky_batched_{B}x{N}"]) for B, N in LARGE_TIMING_BATCHED[:-1]}
    return [
        dict(name="gaussian_gram", route="cuda", source="tpubq_torch/csrc/gaussian_gram.cu",
             replaces="tpubq/ops/pallas_kernels.py:144", launches=lp["launches"]["gaussian_gram"],
             max_abs_err=lk["gaussian_gram"], ms=g_t["kernel_ms"], plain_ms=g_t["plain_ms"],
             **bound(4 * (2 * gn + 2 + gn * gn), 6 * gn * gn), library_ms=None, shape=g_t["shape"]),
        dict(name="cholesky_blocked", route="cuda", source="tpubq_torch/csrc/chol_blocked.cu",
             replaces="tpubq/ops/pallas_kernels.py:511", launches=lp["launches"]["cholesky_blocked"],
             max_abs_err=lk["cholesky_blocked"], ms=cb_t["kernel_ms"], plain_ms=cb_t["plain_ms"],
             bound_ms=cb_t["bound_ms"], bound_by=cb_t["bound_by"], library_ms=cb_t["library_ms"],
             shape=f"({gn}, {gn})", dependent_steps=gn, launches_per_call=cb_t["launches_per_call"],
             **{f"at_{N}": at(kt[f"cholesky_blocked_{N}"]) for N in LARGE_CHOL_TIMING_N if N != gn}),
        dict(name="tri_solve_blocked", route="cuda", source="tpubq_torch/csrc/tri_solve_blocked.cu",
             replaces="tpubq/ops/pallas_kernels.py:563", launches=lp["launches"]["tri_solve_blocked"],
             max_abs_err=lk["tri_solve_blocked"], ms=ts_t["kernel_ms"], plain_ms=ts_t["plain_ms"],
             bound_ms=ts_t["bound_ms"], bound_by=ts_t["bound_by"], library_ms=ts_t["library_ms"],
             shape=f"({gn}, {gn}) x ({gn}, {gn})", launches_per_call=ts_t["launches_per_call"], **other_tri),
        dict(name="cholesky_batched", route="cuda", source="tpubq_torch/csrc/chol_batched.cu",
             replaces="tpubq/ops/pallas_kernels.py:211", launches=lp["launches"]["cholesky_batched"],
             max_abs_err=lk["cholesky_batched"], ms=cbat_t["kernel_ms"], plain_ms=cbat_t["plain_ms"],
             bound_ms=cbat_t["bound_ms"], bound_by=cbat_t["bound_by"], library_ms=cbat_t["library_ms"],
             shape=f"({bB}, {bn}, {bn})", dependent_steps=bn, launches_per_call=cbat_t["launches_per_call"],
             **other_batched),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    import tpubq_torch  # noqa: F401  (fails outside the repository)
    from tpubq_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    label = nvidia_smi()
    check(torch.backends.cuda.matmul.allow_tf32 is False, "float32 matmuls without TF32")
    emit("device", nvidia_smi=label, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    info = _build.build(verbose=True)
    ptxas = [ln for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=info["seconds"], library=os.path.relpath(info["path"], ROOT),
         nvcc=_build.nvcc_path(), flags=list(_build.NVCC_FLAGS),
         sources=[os.path.relpath(str(_build.CSRC / s), ROOT) for s in _build.SOURCES], ptxas=ptxas)

    esm = check_esm(dev)
    chol = check_chol(dev)
    mll = check_mll(dev)
    fk = check_fleet_kernels(dev)
    lk = check_large_kernels(dev)
    lm = check_large_mll(dev)
    fleet_precision(dev)
    mp = main_path(dev)
    fp = fleet_path(dev)
    mg = marginalize_path(dev)
    fam = families_path(dev)
    fc = facade_path(dev)
    pp = parallel_path(dev, mp["thetas"], label)
    op = oracle_path(dev)
    lp = large_n_path(dev)
    lf = large_fit(dev)
    esm_size_routes(dev)
    esm_beyond_1024(dev)
    s0_observation(dev)
    t = timing(dev, mp, label)
    ft = fleet_timing(dev, fk, fp, mp, label)
    ff = fleet_fit_mll(dev, label)
    lt = large_timing(dev, label)

    # Bounds from this run's shapes: each input read once and each output written once
    # against the HBM rate; float32 operations (an expf counted as one) against the
    # float32 peak. d = 1, NP = max_obs + n_candidate, NP2 = max_obs.
    NP, NP2 = mp["bq"].options.max_nsc, mp["bq"].options.max_obs
    cB, cn = 200, 32  # marginalize(n=100): the two-rung stack of 100 Grams
    mB, mn = FIT_RESTARTS, NP  # the linear GP's fit; the log-GP's is (10, NP2)
    chol_t, mll_ms = t["chol_batch"][f"{cB}x{cn}x{cn}"], t["mll_grad"][f"{mB}x{mn}"]
    # The fleet kernels at the fleet path's shape: B problems × G points, NP rows of the
    # linear GP and NP2 of the log-GP per problem. Bytes: every per-problem input and the
    # grid once, the (B, G) outputs once; operations: 4 per (i, j) term of the two
    # quadratic forms of esm_fleet_l (2 of esm_fleet_tl's one), ~12 / ~8 per row for the
    # cross-kernel and the dots, ~40 / ~10 per point for the rest.
    fB, fNP, fNP2 = FLEET_B, fp["opts"].max_nsc, fp["opts"].max_obs
    fl_t = ft["shapes"][f"{fNP}x{fNP2}"]
    fl_bytes = 4 * (fB * (16 + 1 + 4 * fNP + fNP * fNP) + G + 3 * fB * G)
    fl_ops = fB * G * (4 * fNP * fNP + 12 * fNP + 40)
    ftl_bytes = 4 * (fB * (2 + 3 * fNP2 + fNP2 * fNP2) + G + 2 * fB * G)
    ftl_ops = fB * G * (2 * fNP2 * fNP2 + 8 * fNP2 + 10)
    kernels = [
        dict(name="esm_fused", route="cuda", source="tpubq_torch/csrc/esm_fused.cu",
             replaces="tpubq/ops/pallas_kernels.py:440", launches=mp["launches"]["esm_fused"],
             max_abs_err=max(esm["max_abs_err"], mp["esm_max_abs_err"]), ms=t["esm_fused_ms"],
             plain_ms=t["esm_fused_plain_ms"], **bound(esm_bytes(G, NP, NP2), esm_ops(G, NP, NP2)), library_ms=None,
             shape=f"G={G}, NP={NP}, NP2={NP2}", **large_esm_entry(lp, lt)),
        dict(name="chol_batch", route="cuda", source="tpubq_torch/csrc/chol_batch.cu",
             replaces="tpubq/ops/pallas_kernels.py:641", launches=mp["launches"]["chol_batch"],
             max_abs_err=chol["max_abs_err"], ms=chol_t["kernel_ms"], plain_ms=chol_t["plain_ms"],
             **bound(chol_batch_bytes(cB, cn), cB * cn**3 // 3), library_ms=chol_t["library_ms"],
             shape=f"({cB}, {cn}, {cn})", dependent_steps=cn),
        dict(name="mll_grad_batched", route="cuda", source="tpubq_torch/csrc/mll_grad.cu",
             replaces="tpubq/ops/pallas_kernels.py:304", launches=mp["launches"]["mll_grad"],
             max_abs_err=mll["max_abs_err"], ms=mll_ms["kernel_ms"], plain_ms=mll_ms["plain_ms"],
             **bound(mll_bytes(mB, mn), mll_ops(mB, mn)), library_ms=None,
             shape=f"({mB}, {mn})", dependent_steps=3 * mn, autograd_ms=mll_ms["autograd_ms"],
             ms_at_10x32=t["mll_grad"][f"{mB}x{NP2}"]["kernel_ms"],
             bound_ms_at_10x32=bound(mll_bytes(mB, NP2), mll_ops(mB, NP2))["bound_ms"],
             fleet_launches=fp["launches"]["mll_grad"], fleet_max_abs_err=fk["mll_max_abs_err"],
             fleet_fit={k: {q: v[q] for q in ("event_ms", "device_ms", "bound_ms", "share_of_bound", "sizes_hist")}
                        for k, v in ff.items()},
             fleet_bound_ms=bound(mll_bytes(FLEET_B * FIT_RESTARTS, FLEET_MAX_OBS),
                                  mll_ops(FLEET_B * FIT_RESTARTS, FLEET_MAX_OBS))["bound_ms"],
             large_fit_launches=lf["launches"]["mll_grad"], large_max_abs_err=lm["max_abs_err"],
             **{f"at_{k[len('mll_grad_'):]}": {q: v[q] for q in ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                                                  "launches_per_call")}
                for k, v in lt["kernels"].items() if k.startswith("mll_grad_")}),
        dict(name="esm_fleet_l", route="cuda", source="tpubq_torch/csrc/esm_fleet_l.cu",
             replaces="tpubq/ops/pallas_kernels.py:902", launches=fp["launches"]["esm_fleet_l"],
             max_abs_err=max(fk["l_max_abs_err"], fp["l_max_abs_err"]), ms=fl_t["esm_fleet_l_ms"],
             plain_ms=fl_t["esm_fleet_l_plain_ms"], **bound(fl_bytes, fl_ops), library_ms=None,
             shape=f"B={fB}, G={G}, NP={fNP}", plain_batched_scorer_ms=fl_t["plain_batched_scorer_ms"]),
        dict(name="esm_fleet_tl", route="cuda", source="tpubq_torch/csrc/esm_fleet_tl.cu",
             replaces="tpubq/ops/pallas_kernels.py:1011", launches=fp["launches"]["esm_fleet_tl"],
             max_abs_err=max(fk["tl_max_abs_err"], fp["tl_max_abs_err"]), ms=fl_t["esm_fleet_tl_ms"],
             plain_ms=fl_t["esm_fleet_tl_plain_ms"], **bound(ftl_bytes, ftl_ops), library_ms=None,
             shape=f"B={fB}, G={G}, NP2={fNP2}"),
    ]
    kernels += large_kernel_entries(lp, lk, lt)
    for k in kernels:  # launches on the marginalize (4b), family (4c), facade (4d), parallel (4e) and oracle (4f) paths
        k["marg_launches"] = mg["launches"][k["name"]]
        k["families_launches"] = {run: n[k["name"]] for run, n in fam.items()}
        k["facade_launches"] = fc["launches"][k["name"]]
        k["parallel_launches"] = pp["launches"][k["name"]]
        k["oracle_launches"] = op["launches"][k["name"]]
    by_name = {k["name"]: k for k in kernels}
    by_name["chol_batch"].update(fleet_launches=fp["launches"]["chol_batch"],
                                 large_n_launches=lp["launches"]["chol_batch"],
                                 **{f"at_{k}": v for k, v in t["chol_batch"].items() if k != f"{cB}x{cn}x{cn}"})
    by_name["chol_batch"].update(marg_sampler_host_reads_per_call=mg["host_reads"])
    for name, key in (("esm_fleet_l", "l_max_abs_err"), ("esm_fleet_tl", "tl_max_abs_err")):
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], mg[key])
    by_name["gaussian_gram"].update(single_launches=mp["launches"]["gaussian_gram"],
                                    fleet_launches=fp["launches"]["gaussian_gram"])
    emit("elapsed", seconds=time.perf_counter() - t_start, limit_seconds=1200)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(label, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
