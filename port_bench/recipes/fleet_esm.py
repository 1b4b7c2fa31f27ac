"""B problems of few observations each: a jittered linspace per problem and a
gaussian likelihood whose centre differs by problem (the JAX package's fleet
recipe, ``benchmarks/fleet_esm.py``).

``data``: ``B``, ``n_obs``, ``lo``, ``hi``, ``jitter``; ``integrand``:
``mu_lo``, ``mu_hi``, ``var``: ℓ_b(x) = N(x; μ_b, var), μ_b ~ U(mu_lo, mu_hi)."""

from __future__ import annotations

import math

import numpy as np


def make(cfg: dict, rng: np.random.Generator) -> dict:
    d, f = cfg["data"], cfg["integrand"]
    B, n = int(d["B"]), int(d["n_obs"])
    x = np.linspace(d["lo"], d["hi"], n)[None, :] + d["jitter"] * rng.standard_normal((B, n))
    x = np.sort(x, axis=1).astype(np.float32).astype(np.float64)
    mu = rng.uniform(f["mu_lo"], f["mu_hi"], B)

    def lik(xq):
        """ℓ_b at points with a leading problem axis, (B,) or (B, k)."""
        xq = np.asarray(xq, np.float64)
        m = mu.reshape((B,) + (1,) * (xq.ndim - 1))
        return np.exp(-0.5 * (xq - m) ** 2 / f["var"]) / math.sqrt(2.0 * math.pi * f["var"])

    return dict(x=x, l=lik(x), lik=lik, P=B)
