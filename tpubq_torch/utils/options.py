"""Static configuration for the BQ estimator (PyTorch port).

Same fields, defaults and validation as ``tpubq.utils.options`` so that
checkpoints and option dicts carry across the two packages unchanged. The
numeric prior moments (``x_mean``, ``x_var``) live in ``BQState``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: Canonical serialization order of BQOptions fields (shared with the JAX
#: package's checkpoints).
FIELD_NAMES = (
    "n_candidate",
    "candidate_thresh",
    "max_obs",
    "dim",
    "kernel",
    "dtype",
    "base_jitter",
    "use_pallas",
    "n_gh",
    "n_qmc",
    "n_series",
)


@dataclasses.dataclass(frozen=True)
class BQOptions:
    """Static options for a BQ estimator.

    Attributes:
      n_candidate: size of the candidate grid that anchors the
        exp-linearization (candidates too close to an observation are masked,
        not dropped, so shapes stay fixed).
      candidate_thresh: minimum sup-norm spacing between a candidate and any
        observation.
      max_obs: capacity for observations; the ``BQ`` facade doubles it when
        ``add_observation`` reaches it.
      dim: input dimensionality d.
      kernel: covariance family: "gaussian", "periodic" (1-D), "matern52",
        "matern32" or "rq" (``ops/kernels.py`` gives each one's parameters).
      dtype: "float64" (parity path) or "float32" (device path).
      base_jitter: relative diagonal conditioning added before factorizing.
      use_pallas: carried for checkpoint compatibility and not consulted (the
        fused-fit switch of the JAX package; here the fused route is the
        float32 fit of the 1-D gaussian kernel, chosen by dtype and shape).
      n_gh: Gauss–Hermite nodes of the float32 V[Z] quadrature.
      n_qmc: Halton nodes for d > 3 quadratures.
      n_series: harmonics of the periodic kernel's Jacobi–Anger series.
    """

    n_candidate: int = 10
    candidate_thresh: float = 0.5
    max_obs: int = 32
    dim: int = 1
    kernel: str = "gaussian"
    dtype: str = "float64"
    base_jitter: float = 1e-12
    use_pallas: bool = False
    n_gh: int = 128
    n_qmc: int = 4096
    n_series: int = 64

    def __post_init__(self):
        if self.kernel not in ("gaussian", "periodic", "matern52", "matern32", "rq"):
            raise ValueError(f"unknown kernel {self.kernel!r}")
        if self.dtype not in ("float64", "float32"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.n_candidate < 1:
            raise ValueError("n_candidate must be >= 1")
        if self.max_obs < 1:
            raise ValueError("max_obs must be >= 1")

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32

    @property
    def max_nsc(self) -> int:
        """Capacity of the combined obs ∪ candidate set."""
        return self.max_obs + self.n_candidate


def parse_bq_kwargs(options: dict, dim_default: int, n_obs: int):
    """Split the flat ``BQ(**options)`` kwargs into
    (BQOptions, x_mean, x_var, gamma, s_tl, s_l, seed); unknown keys raise."""
    x_mean = options.pop("x_mean", None)
    x_var = options.pop("x_var", None)
    gamma = float(options.pop("gamma", 1.0))
    s_tl = float(options.pop("s", options.pop("s_tl", 0.0)))
    s_l = float(options.pop("s_l", s_tl))
    seed = int(options.pop("seed", 0))
    opt_kwargs = {k: options.pop(k) for k in list(options) if k in FIELD_NAMES}
    if options:
        raise ValueError(f"unknown options: {sorted(options)}")
    opt_kwargs.setdefault("dim", dim_default)
    opt_kwargs.setdefault("max_obs", max(2 * n_obs, 32))
    return BQOptions(**opt_kwargs), x_mean, x_var, gamma, s_tl, s_l, seed
