"""The user-facing ``BQ`` class (counterpart of ``tpubq/models/api.py``).

A thin stateful shell over the functional core: it owns a ``BQState`` on a
``device`` (the CUDA card unless the caller passes ``device="cpu"``) and a
``BQOptions``. Method names and semantics follow the JAX package's ``BQ``.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from tpubq_torch.models import acquire, bq as bqm, fit as fitm, marginalize as margm
from tpubq_torch.utils.device import resolve_device
from tpubq_torch.utils.options import FIELD_NAMES as _OPTION_KEYS, BQOptions, parse_bq_kwargs

logger = logging.getLogger("tpubq_torch")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class BQ:
    """Osborne-style Bayesian Quadrature estimator of
    Z = ∫ ℓ(x) N(x | x_mean, x_var) dx from observations ``(x, l)``.

    Example:
        bq = BQ(x, l, dtype="float32", n_candidate=10,
                candidate_thresh=0.5, x_mean=0., x_var=1.)    # on the card
        bq.init(params_tl=(1., 1.), params_l=(0.3, 0.4)).fit(seed=0)
        E, V = bq.Z_mean(), bq.Z_var()
        x_next = bq.choose_next(grid, n=10)
        bq.add_observation(x_next, l(x_next))

    ``device`` defaults to the CUDA card; where there is none the constructor
    raises, and ``device="cpu"`` asks for the CPU (the float64 parity path).
    """

    def __init__(self, x, l, device="cuda", **options):
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
        self.device = resolve_device(device)
        self._x0 = x
        self._l0 = l
        self._state: Optional[bqm.BQState] = None
        self._ok_state = None
        # the instance RNG's seed, kept for save(): pass seed= for independent
        # streams across the members of an ensemble
        self._seed = seed
        self._rng = np.random.RandomState(seed)

    # ------------------------------------------------------------------ state
    @property
    def state(self) -> bqm.BQState:
        if self._state is None:
            self.init()
        return self._state

    def init(self, params_tl=None, params_l=None):
        """Construct both GPs (defaults: h = 1, w_j = 1, and the period or
        α at 1), and warn where the hypers exceed the resolution of
        ``n_series`` / ``n_gh`` (``_warn_resolution``)."""
        if params_tl is not None:
            bqm.validate_theta_values(params_tl, self.options, "params_tl")
        if params_l is not None:
            bqm.validate_theta_values(params_l, self.options, "params_l")
        self._state = bqm.init_state(
            self._x0, self._l0, self.options, params_tl=params_tl, params_l=params_l,
            s_tl=self.s_tl, s_l=self.s_l, gamma=self._gamma0, x_mean=self._x_mean0,
            x_var=self._x_var0, device=self.device,
        )
        self._warn_resolution()
        return self

    def _warn_resolution(self, sampled=None, context=""):
        """Warn where the hypers exceed the resolution that a static shape
        fixes (the check runs on the host, where θ is concrete):

        * periodic: every estimate uses the Jacobi–Anger series truncated at
          ``n_series``, exact while n_series ≥ 8.5/w + 8
          (``bq.periodic_series_floor``); the float32 V[Z] is the GH bilinear
          form, whose ``n_gh`` must resolve the oscillation
          (``bq.periodic_gh_floor``).
        * rq: V[Z] is GH / QMC quadrature in both dtypes, whose node count
          must resolve the kernel width under the measure (``bq.rq_gh_floor``);
          the mixture rule of the single integrals is validated for
          α ≥ ``bq.RQ_ALPHA_FLOOR``.

        With no argument (at init and after the fit) the current two θs are
        checked. ``sampled``: an (n, p) batch of hyper rows (θ_tl, or joint
        θ_tl ∥ θ_l) that ``sample_hypers`` / ``marginalize`` /
        ``choose_next(n > 0)`` evaluate at; the warning names the fraction of
        rows that exceed.
        """
        kernel = self.options.kernel
        if kernel not in ("periodic", "rq") or self._state is None:
            return
        import warnings

        st = self._state
        if sampled is None:
            rows = [_np(st.gp_log_l.theta), _np(st.gp_l.theta)]
        else:
            sampled = np.asarray(sampled)
            p_tl = int(st.gp_log_l.theta.shape[0])
            rows = list(sampled[:, :p_tl])
            if sampled.shape[1] > p_tl:  # joint rows: θ_tl ∥ θ_l
                rows += list(sampled[:, p_tl:])
        tag = f" ({context})" if context else ""

        def _batch_warn(floor_fn, have, what, fix):
            needs = np.asarray([floor_fn(t) for t in rows])
            bad = needs > have
            if not np.any(bad):
                return
            frac = float(np.mean(bad))
            worst = int(np.max(needs))
            src = (
                f"{frac:.0%} of the {len(rows)} hyper rows" if sampled is not None
                else "the current hypers"
            )
            warnings.warn(
                f"{src}{tag} exceed the {what} resolution: worst needs "
                f"~{worst} but {fix}={have} — raise {fix} (estimates under "
                f"those hypers carry quadrature/truncation error until then)",
                stacklevel=3,
            )

        x_var = _np(st.x_var)
        if kernel == "periodic":
            _batch_warn(bqm.periodic_series_floor, self.options.n_series,
                        "harmonic-series", "n_series")
            if self.options.dtype == "float32":
                _batch_warn(lambda t: bqm.periodic_gh_floor(t, x_var),
                            self.options.n_gh, "float32-V[Z] GH", "n_gh")
        else:  # rq
            _batch_warn(lambda t: bqm.rq_gh_floor(t, x_var),
                        self.options.n_gh, "V[Z] GH", "n_gh")
            alphas = np.asarray([float(np.ravel(t)[-1]) for t in rows])
            bad = alphas < bqm.RQ_ALPHA_FLOOR
            if np.any(bad):
                src = (
                    f"{float(np.mean(bad)):.0%} of the {len(rows)} hyper rows"
                    if sampled is not None else "the current hypers"
                )
                warnings.warn(
                    f"{src}{tag} have rq shape α < {bqm.RQ_ALPHA_FLOOR} "
                    f"(min {alphas.min():.3g}); the exact Gamma-mixture "
                    f"integrals are validated for α ≥ {bqm.RQ_ALPHA_FLOOR} "
                    f"(≤2e-9) and degrade to ~1e-5 absolute by α = 0.25",
                    stacklevel=3,
                )

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

    @property
    def tl_s(self) -> np.ndarray:
        return _np(self.state.tl_s)[: self.ns]

    @property
    def x_c(self) -> np.ndarray:
        st = self.state
        return _np(st.x_c)[_np(st.c_mask)]

    @property
    def l_c(self) -> np.ndarray:
        st = self.state
        return _np(st.l_c)[_np(st.c_mask)]

    @property
    def nc(self) -> int:
        return int(self.state.c_mask.sum())

    @property
    def x_sc(self) -> np.ndarray:
        st = self.state
        return _np(st.x_sc)[_np(st.sc_mask)]

    @property
    def l_sc(self) -> np.ndarray:
        st = self.state
        return _np(st.l_sc)[_np(st.sc_mask)]

    @property
    def gamma(self) -> float:
        """The exp-transform constant γ."""
        return float(self.state.gamma) if self._state is not None else self._gamma0

    @property
    def x_mean(self) -> np.ndarray:
        return _np(self.state.x_mean)

    @property
    def x_var(self) -> np.ndarray:
        return _np(self.state.x_var)

    @property
    def gp_log_l(self):
        return self.state.gp_log_l

    @property
    def gp_l(self):
        return self.state.gp_l

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

    # ---------------------------------------------------------------- fitting
    def fit_hypers(self, params=None, ntry: int = 10, seed=None):
        """Multi-restart MLL fit of the named kernel parameters on both GPs.

        ``params``: None fits every parameter of the family ("h", "w"); a name
        or a tuple of names fits those and leaves the rest bit-identical;
        naming "s" also fits the observation noise. ``ntry`` restarts advance
        as one batch. The log-GP is fitted and installed first, then the
        linear GP on the anchors that follow from it.

        Route: float32, the gaussian kernel, d = 1 and a fixed noise go
        through ``fit_params_fused`` (Adam over the ``mll_grad_batched``
        kernel: launched on a CUDA device, its plain twin on the CPU) at any
        size and whatever ``use_pallas`` says (the JAX package takes its fused
        fit only with ``use_pallas`` on a TPU); everything else, every other
        kernel family included, through the batched L-BFGS of ``fit_params``
        / ``fit_params_with_noise``. The
        route is decided here from dtype and options; once chosen, a kernel
        that fails to build or launch raises.
        """
        st, opts = self.state, self.options
        fit_noise, free_mask = fitm.resolve_param_names(
            opts, int(st.gp_log_l.theta.shape[0]), params
        )
        gen = self._generator(seed)
        fused_ok = (not fit_noise and opts.kernel == "gaussian" and opts.dim == 1
                    and opts.dtype == "float32")

        def _fit(theta, s, x, y, mask):
            if fit_noise:
                return fitm.fit_params_with_noise(
                    opts.kernel, theta, s, x, y, mask, gen, n_restart=ntry, free_mask=free_mask)
            inits = fitm.random_restarts(gen, theta, x, y, mask, ntry, kernel=opts.kernel)
            if fused_ok:
                th, mll = fitm.fit_params_fused(theta, s, x, y, mask, gen, inits, free_mask=free_mask)
            else:
                th, mll = fitm.fit_params(
                    opts.kernel, theta, s, x, y, mask, gen, inits, free_mask=free_mask)
            return th, None, mll

        theta_tl, s_tl, mll_tl = _fit(st.gp_log_l.theta, st.gp_log_l.s, st.x_s, st.tl_s, st.obs_mask)
        st = bqm.set_params(st, opts, theta_tl=theta_tl, s_tl=s_tl)
        l_sc = torch.where(st.sc_mask, st.l_sc, torch.zeros_like(st.l_sc))
        theta_l, s_l, mll_l = _fit(st.gp_l.theta, st.gp_l.s, st.x_sc, l_sc, st.sc_mask)
        self._state = bqm.set_params(st, opts, theta_l=theta_l, s_l=s_l)
        if fit_noise:
            self.s_tl = float(self._state.gp_log_l.s)
            self.s_l = float(self._state.gp_l.s)
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug("fit_hypers: theta_tl=%s (mll=%.4f) theta_l=%s (mll=%.4f)",
                         _np(theta_tl), float(mll_tl), _np(theta_l), float(mll_l))
        self._warn_resolution()
        return self

    #: The JAX package's public spelling.
    fit = fit_hypers

    # ---------------------------------------------------------- hyper samples
    def _sample(self, params, n, nburn, seed, prior_std, n_chains=1) -> torch.Tensor:
        return margm.sample_hypers(
            self.state, self.options, self._generator(seed), n, nburn,
            params, n_chains=n_chains,
            prior_std=margm._PRIOR_STD if prior_std is None else prior_std,
        )

    def sample_hypers(self, params=None, n: int = None, nburn: int = None, seed=None,
                      n_chains: int = 1, prior_std: float = None) -> np.ndarray:
        """Slice-sample hyperparameters (``sample_hypers(params, n, nburn)``)
        → (n, p). ``params`` names the hypers that move: ``h`` / ``w`` sample
        θ_tl; adding ``*_l`` names samples both GPs' θ jointly, and the rows
        come back stacked (θ_tl ∥ θ_l). ``n_chains`` chains run in lock step
        (``marginalize.sample_hypers``)."""
        if isinstance(params, (int, np.integer)):
            raise TypeError(
                "sample_hypers takes params first (reference signature "
                "sample_hypers(params, n, nburn)); the legacy positional "
                "(n, nburn, seed) form was removed — pass n= explicitly"
            )
        n = 100 if n is None else int(n)
        nburn = 10 if nburn is None else int(nburn)
        samples = _np(self._sample(params, n, nburn, seed, prior_std, n_chains))
        self._warn_resolution(sampled=samples, context="sample_hypers")
        return samples

    def marginalize(self, funs=None, n: int = 100, params=None, seed=None,
                    prior_std: float = None, stacked: bool = False):
        """Estimates under ``n`` sampled hypers of the named ``params`` (θ_tl,
        or jointly with ``*_l`` names), evaluated as one batch → tuple of (n,)
        arrays, one per function of ``funs`` (default Z_mean, Z_var), or with
        ``stacked=True`` one (n, len(funs)) array whose column j is funs[j]."""
        self._check_factorized()
        named = {"Z_mean": bqm.Z_mean, "Z_var": bqm.Z_var}
        funs = (bqm.Z_mean, bqm.Z_var) if funs is None else tuple(named.get(f, f) for f in funs)
        thetas = self._sample(params, n, 10, seed, prior_std)
        self._warn_resolution(sampled=_np(thetas), context="marginalize")
        outs = tuple(_np(o) for o in margm.marginalize(self.state, self.options, thetas, funs))
        return np.stack(outs, axis=1) if stacked else outs

    # --------------------------------------------------------- active sampling
    def choose_next(self, x_a, n: int = 0, params=None, seed=None, plot: bool = False,
                    refine: bool = False, prior_std: float = None):
        """Best next sample location on the grid ``x_a``, with the ESM averaged
        over ``n`` hyper samples of the named ``params`` (θ_tl, or jointly
        with ``*_l`` names) when ``n`` > 0.

        ``refine=True`` moves the grid's winner off the grid by a few Adam
        steps on ∇ₓESM under the same hyper samples (``acquire.refine_next``);
        ``plot=True`` draws the grid's scores (``plotting``)."""
        self._check_factorized()
        hyper = None
        if n and n > 0:
            hyper = self._sample(params, n, 10, seed, prior_std)
            self._warn_resolution(sampled=_np(hyper), context="choose_next")
        x_best, scores = acquire.choose_next(self.state, self.options, x_a, hyper)
        if refine:
            x_best, _ = acquire.refine_next(self.state, self.options, x_best, hyper)
        if plot:
            from tpubq_torch.utils import plotting

            grid = _np(x_a) if torch.is_tensor(x_a) else np.asarray(x_a)
            plotting.plot_expected_squared_mean(self, grid, _np(scores))
        x_best = _np(x_best)
        return x_best if self.options.dim > 1 else float(x_best[0])

    def add_observation(self, x_a, l_a):
        """Append an observation and refit."""
        l_a = float(l_a)
        if not np.isfinite(l_a) or l_a <= 0:
            raise ValueError("l must be finite and positive")
        # in the state's dtype, as the duplicate test must see the stored x_s
        x_arr = np.asarray(x_a, dtype=self.options.dtype).reshape((self.options.dim,))
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

    # ------------------------------------------------------------ persistence
    def health(self, as_report: bool = False):
        """Diagnostics of the current state (``utils.health.check_state``: a
        dict of tensors on the state's device), or with ``as_report=True``
        the formatted log lines."""
        from tpubq_torch.utils import health as _health

        diag = _health.check_state(self.state, self.options)
        return _health.format_report(diag) if as_report else diag

    def save(self, filename, force: bool = False):
        """Write the observations, hyperparameters, measure, γ, the RNG seed
        and the options to one ``.npz`` (the JAX package's ``BQ.save``
        layout); ``load`` refits the factors."""
        import os

        if os.path.exists(str(filename)) and not force:
            raise IOError(f"{filename} already exists (use force=True)")
        st = self.state
        np.savez(
            filename,
            x_s=self.x_s,
            l_s=self.l_s,
            theta_tl=_np(st.gp_log_l.theta),
            theta_l=_np(st.gp_l.theta),
            s_tl=float(st.gp_log_l.s),
            s_l=float(st.gp_l.s),
            gamma=float(st.gamma),
            x_mean=_np(st.x_mean),
            x_var=_np(st.x_var),
            seed=self._seed,
            **{f"opt_{k}": getattr(self.options, k) for k in _OPTION_KEYS},
        )

    @classmethod
    def load(cls, filename, device="cuda"):
        """Rebuild a ``BQ`` from a ``save`` file onto ``device`` (the card
        unless the caller names another), refitting both GPs. A file without
        ``theta_tl`` is read as the reference's layout
        (``_load_reference_style``)."""
        from tpubq_torch.utils.convert import options_from_dict

        with np.load(str(filename), allow_pickle=False) as d:
            # a reference-style file may hold a pickled options dict: not read here
            flat = {k: d[k] for k in d.files} if "theta_tl" in d.files else None
        if flat is None:
            return cls._load_reference_style(filename, device)
        opts = options_from_dict(flat, "opt_")
        obj = cls(
            flat["x_s"], flat["l_s"], device=device, x_mean=flat["x_mean"], x_var=flat["x_var"],
            gamma=float(flat["gamma"]), s=float(flat["s_tl"]), s_l=float(flat["s_l"]),
            seed=int(flat["seed"][()]) if "seed" in flat else 0,
            # an option added after the file was saved keeps the constructor's default
            **{k: getattr(opts, k) for k in _OPTION_KEYS if f"opt_{k}" in flat},
        )
        return obj.init(params_tl=flat["theta_tl"], params_l=flat["theta_l"])

    @classmethod
    def _load_reference_style(cls, filename, device="cuda"):
        """Read a file of the reference's layout: observations under
        ``x``/``x_s``/``x_so`` and ``l``/``l_s``/``l_so``, hypers under
        ``params_tl``/``theta_tl`` (and ``_l``), the measure under
        ``x_mean``/``mean`` and ``x_var``/``cov``/``var``, options possibly
        as a pickled dict under ``options`` (unpickled for that key only,
        unknown keys dropped with a warning). Without hypers the defaults are
        installed, with a warning to fit."""
        import warnings

        def pick(d, *names):
            for n in names:
                if n in d.files:
                    return d[n]
            return None

        with np.load(str(filename), allow_pickle=True) as d:
            x = pick(d, "x_s", "x", "x_so")
            l = pick(d, "l_s", "l", "l_so")
            if x is None or l is None:
                raise ValueError(
                    f"{filename} has neither tpubq-native nor reference-style "
                    f"BQ fields (found: {sorted(d.files)})"
                )
            kwargs = {}
            raw_opts = pick(d, "options", "opts")
            if raw_opts is not None and raw_opts.dtype == object:
                raw_opts = raw_opts[()]
                if isinstance(raw_opts, dict):
                    known = set(_OPTION_KEYS) | {"x_mean", "x_var", "gamma", "s", "s_l"}
                    dropped = sorted(set(raw_opts) - known)
                    if dropped:
                        warnings.warn(f"ignoring unknown option keys in {filename}: {dropped}")
                    kwargs.update({k: v for k, v in raw_opts.items() if k in known})
            for key, names in (("x_mean", ("x_mean", "mean")), ("x_var", ("x_var", "cov", "var")),
                               ("gamma", ("gamma",)), ("s", ("s_tl", "s")), ("s_l", ("s_l",))):
                v = pick(d, *names)
                if v is not None:
                    kwargs[key] = float(v) if np.ndim(v) == 0 else v
            kwargs.setdefault("x_mean", 0.0)
            kwargs.setdefault("x_var", 1.0)
            # scalars saved through np.savez arrive as 0-d arrays
            kwargs = {k: (v.item() if isinstance(v, np.ndarray) and v.ndim == 0 else v)
                      for k, v in kwargs.items()}
            if isinstance(kwargs.get("kernel"), (np.str_, np.bytes_)):
                kwargs["kernel"] = str(kwargs["kernel"])
            obj = cls(x, l, device=device, **kwargs)
            p_tl = pick(d, "theta_tl", "params_tl")
            p_l = pick(d, "theta_l", "params_l")
            if p_tl is None and p_l is None:
                warnings.warn(
                    f"{filename} carries no hyperparameters; initialized with "
                    f"defaults — call fit() before trusting estimates"
                )
            obj.init(params_tl=p_tl, params_l=p_l)
        return obj

    # --------------------------------------------------------------- plotting
    def plot_gp_log_l(self, ax=None, f_l=None, xmin=None, xmax=None):
        from tpubq_torch.utils import plotting

        return plotting.plot_gp_log_l(self, ax=ax, f_l=f_l, xmin=xmin, xmax=xmax)

    def plot_gp_l(self, ax=None, f_l=None, xmin=None, xmax=None):
        from tpubq_torch.utils import plotting

        return plotting.plot_gp_l(self, ax=ax, f_l=f_l, xmin=xmin, xmax=xmax)

    def plot_l(self, ax=None, f_l=None, xmin=None, xmax=None):
        from tpubq_torch.utils import plotting

        return plotting.plot_l(self, ax=ax, f_l=f_l, xmin=xmin, xmax=xmax)

    def plot(self, f_l=None, xmin=None, xmax=None):
        """The 1-D panels, or the d = 2 triptych (``plot_2d``)."""
        from tpubq_torch.utils import plotting

        if self.options.dim == 2:
            return plotting.plot_2d(self, f_l=f_l, xmin=xmin, xmax=xmax)
        return plotting.plot(self, f_l=f_l, xmin=xmin, xmax=xmax)

    def plot_2d(self, f_l=None, n=80, xmin=None, xmax=None):
        from tpubq_torch.utils import plotting

        return plotting.plot_2d(self, f_l=f_l, n=n, xmin=xmin, xmax=xmax)

    def plot_expected_squared_mean(self, ax=None, xmin=None, xmax=None):
        from tpubq_torch.utils import plotting

        return plotting.plot_expected_squared_mean_curve(self, ax=ax, xmin=xmin, xmax=xmax)

    def plot_expected_variance(self, ax=None, xmin=None, xmax=None):
        from tpubq_torch.utils import plotting

        return plotting.plot_expected_variance_curve(self, ax=ax, xmin=xmin, xmax=xmax)

    def __repr__(self):
        ns = self.ns if self._state is not None else self._x0.shape[0]
        return f"BQ(ns={ns}, device={self.device}, options={self.options})"
