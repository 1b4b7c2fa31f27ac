"""End-to-end active sampling with the PyTorch / CUDA port (tpubq_torch).

Estimates Z = ∫ ℓ(x) N(x | 0, 1) dx for a gaussian ℓ with a known
closed-form answer, choosing where to evaluate ℓ next; then checks the
estimator's health, checkpoints it and reloads it, and draws its
diagnostics when matplotlib is installed.

Runs on the CUDA card (float32) by default; ``--device cpu`` runs it on the
CPU (float64 unless ``--dtype`` says otherwise).

Run: python examples/torch_active_sampling.py [--steps 5] [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np
from scipy import stats

import tpubq_torch

MU_L, SIG_L = 0.2, 0.5


def f_l(x):
    return stats.norm.pdf(x, MU_L, SIG_L)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--dtype", default=None, choices=["float64", "float32"],
                    help="default: float32 on the card, float64 on the CPU")
    ap.add_argument("--n-hyper", type=int, default=10)
    ap.add_argument("--kernel", default="gaussian",
                    choices=["gaussian", "matern52", "matern32", "periodic"])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "tpubq_torch_example"))
    args = ap.parse_args()
    dtype = args.dtype or ("float64" if args.device == "cpu" else "float32")

    z_true = stats.norm.pdf(MU_L, 0.0, np.sqrt(1.0 + SIG_L**2))
    x = np.linspace(-2.2, 2.2, 6)
    bq = tpubq_torch.BQ(x, f_l(x), device=args.device, dtype=dtype, kernel=args.kernel,
                        n_candidate=10, candidate_thresh=0.2, x_mean=0.0, x_var=1.0)
    # the periodic kernel's third hyper (the period) stays fixed: the fit moves h and w
    extra = (3.0,) if args.kernel == "periodic" else ()
    bq.init(params_tl=(0.7, 0.8) + extra, params_l=(0.3, 0.4) + extra)
    bq.fit(params=("h", "w"), seed=0)
    print(f"true Z = {z_true:.6f}  (device {bq.device}, {dtype})")
    print(f"start : E[Z]={bq.Z_mean():.6f}  V[Z]={bq.Z_var():.3e}  ns={bq.ns}")

    fit_params = ("h", "w") if args.kernel == "periodic" else None
    grid = np.linspace(-4.0, 4.0, 2001)
    for step in range(args.steps):
        x_next = bq.choose_next(grid, n=args.n_hyper, seed=step, refine=True)
        bq.add_observation(x_next, float(f_l(x_next)))
        bq.fit(params=fit_params, seed=100 + step)
        err = abs(bq.Z_mean() - z_true) / z_true
        print(f"step {step}: x_next={x_next:+.3f}  E[Z]={bq.Z_mean():.6f}  "
              f"V[Z]={bq.Z_var():.3e}  rel-err={err:.2e}")

    zm, _ = bq.marginalize(n=100, seed=999)
    print(f"marginalized over 100 hyper draws: E[Z]={zm.mean():.6f} ± {zm.std():.1e}")

    print("health:\n" + bq.health(as_report=True))
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "bq.npz")
    bq.save(path, force=True)
    back = tpubq_torch.BQ.load(path, device=args.device)
    print(f"reloaded from {path}: E[Z]={back.Z_mean():.6f}  V[Z]={back.Z_var():.3e}")

    try:
        import matplotlib

        matplotlib.use("Agg")
    except ImportError:
        print("plotting skipped: matplotlib is not installed")
        return
    import matplotlib.pyplot as plt

    fig, _ = bq.plot(f_l=f_l)
    fig.savefig(os.path.join(args.out, "posterior.png"), dpi=110)
    fig2, ax = plt.subplots()
    bq.plot_expected_squared_mean(ax=ax)
    fig2.savefig(os.path.join(args.out, "esm.png"), dpi=110)
    print(f"plots in {args.out}/")


if __name__ == "__main__":
    main()
