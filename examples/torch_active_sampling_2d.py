"""2-D active sampling with the PyTorch / CUDA port (tpubq_torch).

Estimates Z = ∫ ℓ(x) N(x | 0, I₂) dx for a 2-D gaussian likelihood with a
known closed-form answer: Halton candidates over the live bounding box, the
tensor Gauss–Hermite V[Z], and ``choose_next`` over a 2-D grid, each winner
polished off the grid (``refine=True``).

Runs on the CUDA card (float32) by default; ``--device cpu`` runs it on the
CPU (float64 unless ``--dtype`` says otherwise).

Run: python examples/torch_active_sampling_2d.py [--steps 8] [--device cpu]
"""

import argparse

import numpy as np
from scipy import stats

import tpubq_torch

MU_L = np.array([0.3, -0.2])
SIG_L = 0.55  # isotropic likelihood scale


def f_l(x):
    """ℓ(x) = N(x | MU_L, SIG_L² I), x: (n, 2) or (2,)."""
    x = np.atleast_2d(x)
    return np.exp(-0.5 * np.sum((x - MU_L) ** 2, axis=-1) / SIG_L**2) / (2.0 * np.pi * SIG_L**2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--dtype", default=None, choices=["float64", "float32"],
                    help="default: float32 on the card, float64 on the CPU")
    ap.add_argument("--n-hyper", type=int, default=50, help="hyper samples of the final marginalization")
    args = ap.parse_args()
    dtype = args.dtype or ("float64" if args.device == "cpu" else "float32")

    # Z = ∫ N(x; μ_l, σ² I) N(x; 0, I) dx = N(μ_l; 0, (1 + σ²) I)
    z_true = float(stats.multivariate_normal.pdf(MU_L, mean=np.zeros(2), cov=(1 + SIG_L**2) * np.eye(2)))
    rng = np.random.default_rng(4)
    x0 = rng.uniform(-2.0, 2.0, size=(12, 2))
    bq = tpubq_torch.BQ(x0, f_l(x0), device=args.device, dtype=dtype, n_candidate=16,
                        candidate_thresh=0.3, x_mean=np.zeros(2), x_var=np.eye(2))
    bq.init(params_tl=(0.7, 0.8, 0.8), params_l=(0.3, 0.5, 0.5)).fit(seed=0)
    print(f"true Z = {z_true:.6f}  (device {bq.device}, {dtype})")
    print(f"start : E[Z]={bq.Z_mean():.6f}  V[Z]={bq.Z_var():.3e}  ns={bq.ns}")

    g = np.linspace(-2.5, 2.5, 41)
    grid = np.stack(np.meshgrid(g, g, indexing="ij"), axis=-1).reshape(-1, 2)
    for step in range(args.steps):
        x_next = bq.choose_next(grid, seed=step, refine=True)
        bq.add_observation(x_next, float(f_l(x_next)[0]))
        if (step + 1) % 2 == 0:
            bq.fit_hypers(seed=step)  # refresh the hypers as the data grow
        print(f"step {step + 1}: x_next=({x_next[0]:+.3f}, {x_next[1]:+.3f})  "
              f"E[Z]={bq.Z_mean():.6f}  V[Z]={bq.Z_var():.3e}")

    zm_pt = bq.Z_mean()
    rel = abs(zm_pt - z_true) / z_true
    # a moderately tight hyper prior: with few 2-D observations the MLL is
    # flat along some directions, and the weak default prior lets samples
    # wander to extreme length-scales
    zms, _ = bq.marginalize(n=args.n_hyper, seed=9, prior_std=1.5)
    zm_marg = float(np.median(zms))
    print(f"final : E[Z]={zm_pt:.6f} (rel err {rel:.2%}); "
          f"marginalized (prior_std=1.5) median {zm_marg:.6f}")
    if args.steps >= 6:
        # after a few steps; with 12 points the MLL's optimum may still be a
        # length-scale of ~700 along one axis (28% off at seed 0 on the CPU)
        assert rel < 0.10, "the 2-D estimate lands within 10% of the closed form"
        assert abs(zm_marg - z_true) / z_true < 0.35


if __name__ == "__main__":
    main()
