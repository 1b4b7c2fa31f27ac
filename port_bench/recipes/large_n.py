"""One problem, many observations: sorted uniform draws over a range and a
gaussian-bump likelihood with a floor (the JAX package's large-N recipe,
``benchmarks/large_n.py::bench_active_loop``).

``data``: ``n_obs``, ``lo``, ``hi``; ``integrand``: ``mu``, ``var``,
``offset``: ℓ(x) = N(x; μ, var) + offset."""

from __future__ import annotations

import math

import numpy as np


def make(cfg: dict, rng: np.random.Generator) -> dict:
    d, f = cfg["data"], cfg["integrand"]
    # float32 values, so the program and the reference see the same points
    x = np.sort(rng.uniform(d["lo"], d["hi"], d["n_obs"])).astype(np.float32).astype(np.float64)
    mu = np.array([float(f["mu"])])

    def lik(xq):
        xq = np.asarray(xq, np.float64)
        m = mu.reshape((1,) + (1,) * (xq.ndim - 1))
        return np.exp(-0.5 * (xq - m) ** 2 / f["var"]) / math.sqrt(2.0 * math.pi * f["var"]) + f["offset"]

    return dict(x=x[None], l=lik(x[None]), lik=lik, P=1)
