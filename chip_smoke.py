#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (tpubq_torch) on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero
before the final line):

0. device   — require CUDA; print the card's name and power limit
              (nvidia-smi); require full-float32 matmuls (no TF32).
1. build    — compile both hand-written kernels from tpubq_torch/csrc with
              nvcc for sm_90a; print the build seconds and ptxas' report.
2. kernels  — each kernel against its plain PyTorch twin on the card, at the
              main path's shapes and the ones around it, with stated tolerances.
3. main     — the f32 BQ serving path through the BQ facade on the card:
              Z moments → choose_next over 10,000 points → 10 × (choose_next →
              add_observation) → choose_next(n=10) → marginalize(n=100),
              checked against the port's own float64 CPU path on the same data
              and hyper samples; both kernels' launch counters must grow.
4. timing   — CUDA-event times of each kernel and its plain twin, and host-
              clock times of add_observation and marginalize.

Then the kernel summary line, the nvidia-smi line, and the final
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
# Main path, f32 card vs f64 CPU (the port's own reference path).
ZMEAN_RTOL, ZVAR_RTOL = 1e-4, 5e-2
MARG_MEAN_RTOL = 1e-3
ESM_ARGMAX_RTOL = 1e-5  # or twice the f32 scorer's own error on the step, if larger


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


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


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


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
    # (NP, NP2) = (44, 32) — the main path's —, (48, 32) and (80, 64)
    for max_obs, n_cand in ((32, 12), (32, 16), (64, 16)):
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
    for B, n, live in ((200, 32, 21), (200, 44, 33), (256, 80, 61)):
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
    # an indefinite matrix gets NaN in its own factor only
    Ks = _gram_stack(16, 44, 33, rng, dev)
    Ks[5] = -Ks[5]
    L = hk.chol_batch(Ks)
    ok = torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1)).all(-1).cpu().numpy()
    check(not ok[5] and ok[np.arange(16) != 5].all(), "chol_batch NaN confined to the indefinite matrix")
    emit("kernels_chol", tol_norm=CHOL_NORM_TOL, tol_backward=CHOL_BACKWARD_TOL, cases=cases,
         nan_confined=True)
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def pick_gap(bq, bq64, x_card: float, grid_dev, grid64):
    """(gap, f32 error) of the card's pick against the float64 ESM.

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
    st, opts = bq.state, bq.options
    esm32 = hk.esm_fused_plain(*acquire.esm_fused_inputs(st, opts, xa)).double().cpu()
    _, _, deg32, *_ = acquire._esm_affine_terms(st, opts, xa)
    st64 = bq64.state
    esm64 = acquire.expected_squared_mean(st64, bq64.options, grid64[:, None])
    dist = (grid64[:, None] - st64.x_s[None, :, 0]).abs()
    near = ((dist < opts.candidate_thresh) & st64.obs_mask[None, :]).any(1)
    ok = ~deg32.cpu() & ~near
    best = esm64[ok].max().item()
    at = esm64[torch.argmin((grid64 - x_card).abs())].item()
    err = ((esm32 - esm64).abs() / esm64.abs())[ok].max().item()
    return (best - at) / best, err


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

    z64_start = (bq64.Z_mean(), bq64.Z_var())
    hk.esm_fused.launches = 0
    hk.chol_batch.launches = 0
    t0 = time.perf_counter()
    zm0, zv0 = bq.Z_mean(), bq.Z_var()
    picks, gaps, errs, states = [], [], [], []
    for _ in range(10):
        states.append(bq.state)
        xn = bq.choose_next(grid)
        gap, err = pick_gap(bq, bq64, xn, grid_dev, grid64)
        gaps.append(gap)
        errs.append(err)
        ln = float(f_l(xn))
        bq.add_observation(xn, ln)
        bq64.add_observation(xn, ln)
        picks.append(xn)
    zm1, zv1 = bq.Z_mean(), bq.Z_var()
    x_marg = bq.choose_next(grid, n=10, seed=3)
    zms, zvs = bq.marginalize(n=100, seed=4)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"esm_fused": hk.esm_fused.launches, "chol_batch": hk.chol_batch.launches}

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
        seconds=seconds, launches=launches, picks=picks, x_marginalized_pick=x_marg,
        Z_mean_start=zm0, Z_var_start=zv0, Z_mean_end=zm1, Z_var_end=zv1,
        Z_mean_end_f64=z64[0], Z_var_end_f64=z64[1], true_Z=true_Z(),
        Z_mean_rel=max(rel(zm0, z64_start[0]), rel(zm1, z64[0])),
        Z_var_rel=max(rel(zv0, z64_start[1]), rel(zv1, z64[1])),
        pick_gaps=gaps, esm_f32_errs=errs, marg_Z_mean_max_rel=marg_mean_rel,
        marg_Z_var_mean_rel=marg_var_rel, marginalize_n100_finite=bool(
            np.all(np.isfinite(zms)) and np.all(np.isfinite(zvs))),
        tol=dict(Z_mean=ZMEAN_RTOL, Z_var=ZVAR_RTOL, marg_mean=MARG_MEAN_RTOL,
                 esm_argmax=ESM_ARGMAX_RTOL),
    )
    emit("main_path", s=S_MAIN, **res)
    check(launches["esm_fused"] > 0 and launches["chol_batch"] > 0, f"both kernels launched {launches}")
    check(res["Z_mean_rel"] <= ZMEAN_RTOL, "Z_mean f32 card vs f64 CPU")
    check(res["Z_var_rel"] <= ZVAR_RTOL, "Z_var f32 card vs f64 CPU")
    check(all(g <= max(ESM_ARGMAX_RTOL, 2.0 * e) for g, e in zip(gaps, errs)),
          "each pick is the f64 ESM maximum over the resolved points, up to the f32 scorer's error")
    check(marg_mean_rel <= MARG_MEAN_RTOL, "marginalized Z_mean f32 card vs f64 CPU")
    check(marg_var_rel <= ZVAR_RTOL, "marginalized mean V[Z] f32 card vs f64 CPU")
    check(res["marginalize_n100_finite"], "marginalize(n=100) finite")
    check(zv1 < zv0, "V[Z] decreased over the active loop")
    check(abs(zm1 - true_Z()) / true_Z() < 2e-3, "E[Z] near the closed-form evidence")
    return {"bq": bq, "thetas": thetas.to(dev, torch.float32), "launches": launches,
            "esm_max_abs_err": max(c["max_abs_err"] for c in esm_cases)}


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------


def timing(dev, mp: dict, label: str) -> dict:
    import torch

    from tpubq_torch.models import acquire, marginalize as margm
    from tpubq_torch.ops import hopper_kernels as hk

    bq = mp["bq"]
    st, opts = bq.state, bq.options
    grid = torch.linspace(-4.0, 4.0, G, device=dev)[:, None]
    args = acquire.esm_fused_inputs(st, opts, grid)
    esm_ms = cuda_ms(lambda: hk.esm_fused(*args), 200)
    esm_plain_ms = cuda_ms(lambda: hk.esm_fused_plain(*args), 50)
    rng = np.random.RandomState(1)
    chol = {}
    # B = 200: marginalize(n=100)'s rung stack; B = 2, 4, 8: the stacks of
    # small batched refits, where posdef_cholesky_batched picks the route
    for B, n, live in ((200, 32, 21), (200, 44, 33), (2, 32, 21), (4, 32, 21), (8, 32, 21),
                       (2, 44, 33), (4, 44, 33), (8, 44, 33)):
        Ks = _gram_stack(B, n, live, rng, dev)
        chol[f"{B}x{n}x{n}"] = dict(
            kernel_ms=cuda_ms(lambda: hk.chol_batch(Ks), 200),
            library_ms=cuda_ms(lambda: torch.linalg.cholesky_ex(Ks), 200),
        )
        if B == 200:
            chol[f"{B}x{n}x{n}"]["plain_ms"] = cuda_ms(lambda: hk.chol_batch_plain(Ks), 10)
    xs = np.linspace(-3.9, 3.9, 7)
    add_ms = host_ms(lambda: [acquire.add_observation(st, opts, xa, 0.01) for xa in xs], 5) / len(xs)
    marg_ms = host_ms(lambda: margm.marginalize(st, opts, mp["thetas"]), 10)
    marg_sampled_ms = host_ms(lambda: bq.marginalize(n=100, seed=5), 2)
    choose_ms = host_ms(lambda: bq.choose_next(grid), 20)
    res = dict(
        card=label, esm_fused_ms=esm_ms, esm_fused_plain_ms=esm_plain_ms,
        esm_points_per_s=G / (esm_ms * 1e-3), esm_plain_points_per_s=G / (esm_plain_ms * 1e-3),
        chol_batch=chol, add_observation_ms_per_step=add_ms, choose_next_ms=choose_ms,
        marginalize_n100_ms_given_samples=marg_ms, marginalize_n100_ms_with_sampling=marg_sampled_ms,
    )
    emit("timing", **res)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    import tpubq_torch  # noqa: F401  (fails outside the repository)
    from tpubq_torch.ops import _build

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
    mp = main_path(dev)
    t = timing(dev, mp, label)

    kernels = [
        dict(name="esm_fused", route="cuda", source="tpubq_torch/csrc/esm_fused.cu",
             replaces="tpubq/ops/pallas_kernels.py:440", launches=mp["launches"]["esm_fused"],
             max_abs_err=max(esm["max_abs_err"], mp["esm_max_abs_err"]), ms=t["esm_fused_ms"], plain_ms=t["esm_fused_plain_ms"]),
        dict(name="chol_batch", route="cuda", source="tpubq_torch/csrc/chol_batch.cu",
             replaces="tpubq/ops/pallas_kernels.py:641", launches=mp["launches"]["chol_batch"],
             max_abs_err=chol["max_abs_err"], ms=t["chol_batch"]["200x32x32"]["kernel_ms"],
             plain_ms=t["chol_batch"]["200x32x32"]["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(label, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
