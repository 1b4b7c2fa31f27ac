"""The user-facing ``BQ`` class (counterpart of ``tpubq/models/api.py``).

A thin stateful shell over the functional core: it owns a ``BQState`` on an
explicit ``device`` and a ``BQOptions``. Method names and semantics follow
the JAX package's ``BQ``; hyper fitting (``fit_hypers``/``fit``) is not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from tpubq_torch.models import acquire, bq as bqm, marginalize as margm
from tpubq_torch.utils.options import FIELD_NAMES as _OPTION_KEYS, BQOptions, parse_bq_kwargs

logger = logging.getLogger("tpubq_torch")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class BQ:
    """Osborne-style Bayesian Quadrature estimator of
    Z = ∫ ℓ(x) N(x | x_mean, x_var) dx from observations ``(x, l)``.

    Example:
        bq = BQ(x, l, device="cuda", dtype="float32", n_candidate=10,
                candidate_thresh=0.5, x_mean=0., x_var=1.)
        bq.init(params_tl=(1., 1.), params_l=(0.3, 0.4))
        E, V = bq.Z_mean(), bq.Z_var()
        x_next = bq.choose_next(grid, n=10)
        bq.add_observation(x_next, l(x_next))
    """

    def __init__(self, x, l, device="cpu", **options):
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[:, None]
        l = np.asarray(l)
        if np.any(~np.isfinite(l)) or np.any(l <= 0):
            raise ValueError("l must be finite and positive")
        if x.shape[0] != l.shape[0]:
            raise ValueError("x and l must have matching leading dimension")
        (self.options, self._x_mean0, self._x_var0, self._gamma0,
         self.s_tl, self.s_l, seed) = parse_bq_kwargs(options, x.shape[1], x.shape[0])
        if self._x_var0 is not None:
            bqm.validate_measure(np.asarray(self._x_var0))
        if not np.isfinite(self._gamma0) or self._gamma0 <= 0.0:
            raise ValueError(f"gamma must be finite and > 0, got {self._gamma0}")
        self.device = torch.device(device)
        self._x0 = x
        self._l0 = l
        self._state: Optional[bqm.BQState] = None
        self._ok_state = None
        self._rng = np.random.RandomState(seed)

    # ------------------------------------------------------------------ state
    @property
    def state(self) -> bqm.BQState:
        if self._state is None:
            self.init()
        return self._state

    def init(self, params_tl=None, params_l=None):
        """Construct both GPs (defaults: h = 1, w_j = 1)."""
        if params_tl is not None:
            bqm.validate_theta_values(params_tl, self.options, "params_tl")
        if params_l is not None:
            bqm.validate_theta_values(params_l, self.options, "params_l")
        self._state = bqm.init_state(
            self._x0, self._l0, self.options, params_tl=params_tl, params_l=params_l,
            s_tl=self.s_tl, s_l=self.s_l, gamma=self._gamma0, x_mean=self._x_mean0,
            x_var=self._x_var0, device=self.device,
        )
        return self

    def _generator(self, seed=None) -> torch.Generator:
        if seed is None:
            seed = int(self._rng.randint(0, 2**31 - 1))
        return torch.Generator().manual_seed(int(seed))

    @property
    def ns(self) -> int:
        return int(self.state.ns)

    @property
    def x_s(self) -> np.ndarray:
        return _np(self.state.x_s)[: self.ns]

    @property
    def l_s(self) -> np.ndarray:
        return _np(self.state.l_s)[: self.ns]

    # ------------------------------------------------------------- estimation
    def _check_factorized(self):
        """Raise ``FloatingPointError`` if either GP's jitter ladder found no
        finite factor (checked once per state)."""
        st = self.state
        if st is self._ok_state:
            return
        if not (bool(st.gp_log_l.ok) and bool(st.gp_l.ok)):
            raise FloatingPointError(
                "Gram factorization failed: the jitter ladder was exhausted "
                "without a finite Cholesky factor (check inputs for non-finite x "
                "or pathological kernel params)"
            )
        self._ok_state = st

    def Z_mean(self) -> float:
        self._check_factorized()
        return float(bqm.Z_mean(self.state, self.options))

    def Z_var(self) -> float:
        self._check_factorized()
        return float(bqm.Z_var(self.state, self.options))

    def _is_single_point(self, x_a) -> bool:
        nd = np.ndim(x_a)
        return nd == 0 or (self.options.dim > 1 and nd == 1)

    def expected_squared_mean(self, x_a) -> np.ndarray:
        self._check_factorized()
        out = _np(acquire.expected_squared_mean(self.state, self.options, x_a))
        return out[0] if self._is_single_point(x_a) else out

    def expected_Z_var(self, x_a) -> np.ndarray:
        self._check_factorized()
        out = _np(acquire.expected_Z_var(self.state, self.options, x_a))
        return out[0] if self._is_single_point(x_a) else out

    # ---------------------------------------------------------- hyper samples
    def _norm_params(self, params) -> tuple:
        if params is None:
            return tuple(sorted(margm._names_for(self.options)))
        if isinstance(params, str):
            return (params,)
        return tuple(params)

    def _sample(self, params, n, nburn, seed, prior_std) -> torch.Tensor:
        return margm.sample_hypers(
            self.state, self.options, self._generator(seed), n, nburn,
            self._norm_params(params),
            prior_std=margm._PRIOR_STD if prior_std is None else prior_std,
        )

    def sample_hypers(self, params=None, n: int = None, nburn: int = None, seed=None,
                      prior_std: float = None) -> np.ndarray:
        """Slice-sample θ_tl (``sample_hypers(params, n, nburn)``) → (n, p)."""
        n = 100 if n is None else int(n)
        nburn = 10 if nburn is None else int(nburn)
        return _np(self._sample(params, n, nburn, seed, prior_std))

    def marginalize(self, funs=None, n: int = 100, params=None, seed=None,
                    prior_std: float = None):
        """Estimates under ``n`` sampled θ_tl, evaluated as one batch → tuple
        of (n,) arrays, one per function of ``funs`` (default Z_mean, Z_var)."""
        self._check_factorized()
        named = {"Z_mean": bqm.Z_mean, "Z_var": bqm.Z_var}
        funs = (bqm.Z_mean, bqm.Z_var) if funs is None else tuple(named.get(f, f) for f in funs)
        thetas = self._sample(params, n, 10, seed, prior_std)
        return tuple(_np(o) for o in margm.marginalize(self.state, self.options, thetas, funs))

    # --------------------------------------------------------- active sampling
    def choose_next(self, x_a, n: int = 0, params=None, seed=None, prior_std: float = None):
        """Best next sample location on the grid ``x_a``, with the ESM averaged
        over ``n`` θ_tl samples when ``n`` > 0."""
        self._check_factorized()
        hyper = self._sample(params, n, 10, seed, prior_std) if n and n > 0 else None
        x_best, _ = acquire.choose_next(self.state, self.options, x_a, hyper)
        x_best = _np(x_best)
        return x_best if self.options.dim > 1 else float(x_best[0])

    def add_observation(self, x_a, l_a):
        """Append an observation and refit."""
        l_a = float(l_a)
        if not np.isfinite(l_a) or l_a <= 0:
            raise ValueError("l must be finite and positive")
        x_arr = np.asarray(x_a, dtype=np.float64).reshape((self.options.dim,))
        if np.min(np.max(np.abs(self.x_s - x_arr[None, :]), axis=1)) < 1e-10:
            raise ValueError("duplicate observation location")
        if self.ns >= self.options.max_obs:
            self._grow_capacity()
        self._state = acquire.add_observation(self.state, self.options, x_arr, l_a)
        return self

    def _grow_capacity(self):
        """Double max_obs and rebuild the state (hypers, noise, γ carry over)."""
        st = self.state
        old = self.options
        new_opts = BQOptions(**{**{k: getattr(old, k) for k in _OPTION_KEYS},
                                "max_obs": old.max_obs * 2})
        logger.info("growing max_obs %d -> %d", old.max_obs, new_opts.max_obs)
        self.options = new_opts
        ns = int(st.ns)
        self._state = bqm.init_state(
            _np(st.x_s)[:ns], _np(st.l_s)[:ns], new_opts,
            params_tl=_np(st.gp_log_l.theta), params_l=_np(st.gp_l.theta),
            s_tl=float(st.gp_log_l.s), s_l=float(st.gp_l.s), gamma=float(st.gamma),
            x_mean=_np(st.x_mean), x_var=_np(st.x_var), device=self.device,
        )

    def __repr__(self):
        ns = self.ns if self._state is not None else self._x0.shape[0]
        return f"BQ(ns={ns}, device={self.device}, options={self.options})"
