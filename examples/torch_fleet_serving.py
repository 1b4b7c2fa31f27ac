"""Fleet serving with the PyTorch / CUDA port (tpubq_torch).

B independent evidence estimates (one likelihood family, a different true
mean per problem) advanced together: every fleet operation is one batched
call over all problems. Then per-problem fits, marginalization, health and a
checkpoint round trip.

Runs on the CUDA card (float32) by default; ``--device cpu`` runs it on the
CPU (float64 unless ``--dtype`` says otherwise).

Run: python examples/torch_fleet_serving.py [--problems 16] [--steps 6] [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np
from scipy import stats

import tpubq_torch

SIG_L = 0.5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problems", type=int, default=16)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--dtype", default=None, choices=["float64", "float32"],
                    help="default: float32 on the card, float64 on the CPU")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "tpubq_torch_fleet"))
    args = ap.parse_args()
    dtype = args.dtype or ("float64" if args.device == "cpu" else "float32")

    B = args.problems
    rng = np.random.RandomState(0)
    mus = rng.uniform(-0.8, 0.8, B)  # each problem's (unknown) likelihood centre
    z_true = stats.norm.pdf(mus, 0.0, np.sqrt(1.0 + SIG_L**2))
    xs = np.stack([np.linspace(-2.2, 2.2, 8) for _ in range(B)])
    ls = np.stack([stats.norm.pdf(x, m, SIG_L) for x, m in zip(xs, mus)])

    fleet = tpubq_torch.BQFleet(
        xs, ls, params_tl=(0.7, 0.8), params_l=(0.3, 0.4), device=args.device, dtype=dtype,
        n_candidate=12, candidate_thresh=0.2, x_mean=0.0, x_var=1.0, max_obs=8 + args.steps,
    )
    err0 = np.abs(fleet.Z_mean() - z_true) / z_true
    print(f"fleet of {B} on {fleet.device} ({dtype}): start  median rel-err {np.median(err0):.2e}")

    grid = np.linspace(-4, 4, 2001)[:, None]
    hist = []
    for step in range(args.steps):
        x_next = fleet.choose_next(grid)  # (B, 1)
        fleet.add_observation(x_next, stats.norm.pdf(x_next[:, 0], mus, SIG_L))
        hist.append(np.median(np.abs(fleet.Z_mean() - z_true) / z_true))
        print(f"step {step}: median rel-err {hist[-1]:.2e}  ns={int(fleet.ns[0])}")
    assert not hist or hist[-1] <= err0.max()

    fleet.fit(seed=0)  # every problem's restarts in one batched fit
    print(f"after fit: median rel-err {np.median(np.abs(fleet.Z_mean() - z_true) / z_true):.2e}")
    zms, _ = fleet.marginalize(n=32, seed=1)  # (B, n)
    err_marg = np.abs(zms.mean(axis=1) - z_true) / z_true
    print(f"marginalized (n=32/problem): median rel-err {np.median(err_marg):.2e}")

    diag = fleet.health()  # every leaf (B,), on the fleet's device
    assert bool(diag["alpha_l_finite"].all())
    print(f"health: max cond(K_l) ~ {diag['gp_l']['cond_estimate'].max().item():.1e}, "
          f"max jitter {diag['jitter_l'].max().item():.1e}")

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "fleet.npz")
    fleet.save(path, force=True)
    back = tpubq_torch.BQFleet.load(path, device=args.device)
    assert np.array_equal(back.Z_mean(), fleet.Z_mean())
    print(f"checkpoint {path}: reloaded {len(back)} problems, moments identical")
    print("done: every problem advanced in lock step, one batched call per operation")


if __name__ == "__main__":
    main()
