#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (tpubq_torch) on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero
before the final line):

0. device   — require CUDA; print the card's name and power limit
              (nvidia-smi); require full-float32 matmuls (no TF32).
1. build    — compile the three hand-written kernels from tpubq_torch/csrc
              with nvcc for sm_90a; print the build seconds and ptxas' report.
2. kernels  — each kernel against its plain PyTorch twin on the card, at the
              main path's shapes and the ones around it, with stated tolerances.
3. main     — the f32 BQ path through the BQ facade on the card: init →
              fit_hypers (10 restarts × 150 Adam steps over the mll_grad
              kernel, both GPs) → Z moments → 10 × (choose_next over 10,000
              points → add_observation) → choose_next(n=10) →
              marginalize(n=100), checked against the port's own float64 CPU
              path on the same data, hypers and hyper samples; every kernel's
              launch counter must grow, mll_grad's by exactly 2·(n_iter + 1).
4. s = 0    — printed, not gated: how many active steps the float32 log-GP
              Gram survives at s = 0 before rung 0 of the jitter ladder fails,
              with fixed hypers, after one fit, and with a refit every step.
5. timing   — CUDA-event times of each kernel, its plain twin and the library
              call or autograd route beside it, and host-clock times of
              fit_hypers, add_observation and marginalize.

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
# mll_grad against its plain twin, per (h, w) row: |ΔMLL| / |MLL| and
# max|Δgrad| / max|grad|. The two run the same float32 arithmetic with other
# roundings (fused multiply-adds, expf, summation order), which the Gram's
# condition number κ amplifies to O(eps32·κ); so a row passes at the fixed
# tolerance or at MLL_COND_FACTOR·eps32·κ, whichever is larger, with κ the
# condition number of the row's live Gram taken in float64.
MLL_RTOL, MLL_GRAD_NORM_TOL, MLL_COND_FACTOR = 1e-4, 1e-3, 4.0
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


# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and
# the float32 rate outside the tensor cores.
PEAK_BYTES_PER_S, PEAK_F32_FLOPS = 3.35e12, 67e12


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


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


def fit_problems(state):
    """The two data sets ``fit_hypers`` fits, as (name, theta0, s, x, y, mask):
    the log-GP on the observations and the linear GP on observations ∪
    candidates with the pads' targets zeroed."""
    import torch

    l_sc = torch.where(state.sc_mask, state.l_sc, torch.zeros_like(state.l_sc))
    return (("log_gp", state.gp_log_l.theta, state.gp_log_l.s, state.x_s, state.tl_s, state.obs_mask),
            ("linear_gp", state.gp_l.theta, state.gp_l.s, state.x_sc, l_sc, state.sc_mask))


def _row_errs(mll, grad, mll_ref, grad_ref):
    """Per-row (|ΔMLL| / |MLL_ref|, max|Δgrad| / max|grad_ref|) as float64 CPU tensors."""
    mll, grad, mll_ref, grad_ref = (t.double().cpu() for t in (mll, grad, mll_ref, grad_ref))
    return ((mll - mll_ref).abs() / mll_ref.abs(),
            (grad - grad_ref).abs().amax(-1) / grad_ref.abs().amax(-1))


def mll_vs_plain(thetas, s, x, y, mask, jitter: float, **label) -> dict:
    """Launch ``mll_grad_batched`` and its plain twin on the same inputs and
    hold the kernel to the twin row by row (see MLL_RTOL). A row that is
    non-finite on one side must be non-finite on the other, and a second
    launch must repeat the first to the bit. Also reported, not gated: each
    side's distance to the same arithmetic in float64 on the CPU. Returns the
    case with its ``failures`` (checked by the caller after printing)."""
    import torch

    from tpubq_torch.ops import hopper_kernels as hk
    from tpubq_torch.ops import kernels

    mll, grad = hk.mll_grad_batched(thetas, s, x, y, mask, jitter=jitter)
    mll2, grad2 = hk.mll_grad_batched(thetas, s, x, y, mask, jitter=jitter)
    torch.cuda.synchronize()
    ref_mll, ref_grad = hk.mll_grad_batched_plain(thetas, s, x, y, mask, jitter)
    m64, g64 = hk.mll_grad_batched_plain(thetas.double().cpu(), float(s), x.double().cpu(),
                                         y.double().cpu(), mask.cpu(), jitter)
    fin = lambda m, g: (torch.isfinite(m) & torch.isfinite(g).all(-1)).cpu()  # noqa: E731
    ok_k, ok_t = fin(mll, grad), fin(ref_mll, ref_grad)
    e_mll, e_grad = _row_errs(mll, grad, ref_mll, ref_grad)
    t_mll, t_grad = _row_errs(ref_mll, ref_grad, m64, g64)
    k_mll, k_grad = _row_errs(mll, grad, m64, g64)
    both = ok_k & ok_t
    # condition number of each row's live Gram, float64
    live = mask.cpu()
    x64, th64 = x.double().cpu()[live], thetas.double().cpu()
    K64 = kernels.gaussian_K(th64, x64, x64)
    K64 = K64 + torch.eye(x64.shape[0], dtype=torch.float64) * (float(s) ** 2 + jitter * th64[:, 0] ** 2)[:, None, None]
    ev = torch.linalg.eigvalsh(K64)
    kappa = ev[:, -1] / torch.clamp(ev[:, 0], min=1e-300)
    lst = lambda t: [float(v) if math.isfinite(v) else None for v in t.tolist()]  # noqa: E731
    case = dict(**label, B=thetas.shape[0], n=x.shape[0], live=int(mask.sum()), jitter=jitter,
                finite_kernel=ok_k.tolist(), finite_twin=ok_t.tolist(), gram_condition=lst(kappa),
                mll_rel=lst(e_mll), grad_norm=lst(e_grad), twin_vs_f64_mll_rel=lst(t_mll),
                twin_vs_f64_grad_norm=lst(t_grad), kernel_vs_f64_mll_rel=lst(k_mll),
                kernel_vs_f64_grad_norm=lst(k_grad),
                max_abs_err=max(((mll - ref_mll).abs().cpu()[both]).max().item(),
                                ((grad - ref_grad).abs().amax(-1).cpu()[both]).max().item())
                if bool(both.any()) else 0.0)
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    eps_kappa = MLL_COND_FACTOR * torch.finfo(torch.float32).eps * kappa
    tol_m, tol_g = torch.clamp(eps_kappa, min=MLL_RTOL), torch.clamp(eps_kappa, min=MLL_GRAD_NORM_TOL)
    held = {
        "repeats to the bit": torch.equal(bits(mll), bits(mll2)) and torch.equal(bits(grad), bits(grad2)),
        "non-finite on the same rows as the twin": bool((ok_k == ok_t).all()),
        "MLL within tolerance of the twin": bool((e_mll[both] <= tol_m[both]).all()),
        "gradient within tolerance of the twin": bool((e_grad[both] <= tol_g[both]).all()),
    }
    case["failures"] = [what for what, ok in held.items() if not ok]
    return case


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


def pick_gap(bq, bq64, x_card: float, grid_dev, grid64):
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
    st, opts = bq.state, bq.options
    esm32 = hk.esm_fused_plain(*acquire.esm_fused_inputs(st, opts, xa)).double().cpu()
    _, _, deg32, *_ = acquire._esm_affine_terms(st, opts, xa)
    st64 = bq64.state
    esm64 = acquire.expected_squared_mean(st64, bq64.options, grid64[:, None])
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

    for wrapper in (hk.esm_fused, hk.chol_batch, hk.mll_grad_batched):
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
        gap, err, n_ok = pick_gap(bq, bq64, xn, grid_dev, grid64)
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
                "mll_grad": hk.mll_grad_batched.launches}

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
# phase 4: the s = 0 observation (printed, not gated)
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
# phase 5: timing
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
        chol_batch=chol, mll_grad=mll_t, fit_hypers_ms=fit_ms,
        add_observation_ms_per_step=add_ms, choose_next_ms=choose_ms,
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
    mll = check_mll(dev)
    mp = main_path(dev)
    s0_observation(dev)
    t = timing(dev, mp, label)

    # Bounds from this run's shapes: each input read once and each output written once
    # against the HBM rate; float32 operations (an expf counted as one) against the
    # float32 peak. d = 1, NP = max_obs + n_candidate, NP2 = max_obs.
    NP, NP2 = mp["bq"].options.max_nsc, mp["bq"].options.max_obs
    esm_bytes = 4 * (12 + G + 4 * NP + NP * NP + 3 * NP2 + NP2 * NP2 + G)
    esm_ops = G * (2 * NP * NP + 2 * NP2 * NP2 + 12 * (NP + NP2) + 40)
    cB, cn = 200, 32  # marginalize(n=100): the two-rung stack of 100 Grams
    mB, mn = FIT_RESTARTS, NP  # the linear GP's fit; the log-GP's is (10, NP2)
    mll_ops = mB * (4 * mn**3 // 3 + 27 * mn * mn)  # Cholesky, L⁻¹, YᵀY, Gram and traces
    chol_t, mll_ms = t["chol_batch"][f"{cB}x{cn}x{cn}"], t["mll_grad"][f"{mB}x{mn}"]
    kernels = [
        dict(name="esm_fused", route="cuda", source="tpubq_torch/csrc/esm_fused.cu",
             replaces="tpubq/ops/pallas_kernels.py:440", launches=mp["launches"]["esm_fused"],
             max_abs_err=max(esm["max_abs_err"], mp["esm_max_abs_err"]), ms=t["esm_fused_ms"],
             plain_ms=t["esm_fused_plain_ms"], **bound(esm_bytes, esm_ops), library_ms=None,
             shape=f"G={G}, NP={NP}, NP2={NP2}"),
        dict(name="chol_batch", route="cuda", source="tpubq_torch/csrc/chol_batch.cu",
             replaces="tpubq/ops/pallas_kernels.py:641", launches=mp["launches"]["chol_batch"],
             max_abs_err=chol["max_abs_err"], ms=chol_t["kernel_ms"], plain_ms=chol_t["plain_ms"],
             **bound(2 * 4 * cB * cn * cn, cB * cn**3 // 3), library_ms=chol_t["library_ms"],
             shape=f"({cB}, {cn}, {cn})", dependent_steps=cn),
        dict(name="mll_grad_batched", route="cuda", source="tpubq_torch/csrc/mll_grad.cu",
             replaces="tpubq/ops/pallas_kernels.py:304", launches=mp["launches"]["mll_grad"],
             max_abs_err=mll["max_abs_err"], ms=mll_ms["kernel_ms"], plain_ms=mll_ms["plain_ms"],
             **bound(4 * (2 * mB + 1 + 2 * mn) + mn + 4 * 3 * mB, mll_ops), library_ms=None,
             shape=f"({mB}, {mn})", dependent_steps=3 * mn, autograd_ms=mll_ms["autograd_ms"],
             ms_at_10x32=t["mll_grad"][f"{mB}x{NP2}"]["kernel_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(label, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
