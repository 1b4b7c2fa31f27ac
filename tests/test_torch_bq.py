"""Parity of the port's BQ slice (tpubq_torch.models) with the JAX package.

Each test starts both packages from the same raw (x, ℓ) and options, and
where it says so also from the same JAX state carried across with
``tpubq_torch.utils.convert``. Tolerances: float64 Z moments rtol 1e-9
(1e-8 along a trajectory and under marginalization); float32 Z_mean rtol
1e-5 and Z_var 1e-3 (marginalized: 1e-4 / 5e-2, the f32-vs-f64 pin of
tests/test_bq.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpubq
import tpubq_torch
from tests import torch_parity as tp
from tpubq.models import acquire as jacq
from tpubq.models import gp as jgp
from tpubq.models import marginalize as jmarg
from tpubq.ops.kernels import get_kernel as jkern
from tpubq.utils import io as jio
from tpubq_torch.models import acquire as tacq
from tpubq_torch.models import bq as tbq
from tpubq_torch.models import gp as tgp
from tpubq_torch.models import marginalize as tmarg
from tpubq_torch.ops.kernels import get_kernel as tkern
from tpubq_torch.utils import convert

GRID = np.linspace(-4.0, 4.0, 401)
# (Z_mean, Z_var) rtol. float32 from raw (x, ℓ): the two packages' f32
# factorizations differ by rounding, which the V[Z] quadrature's cancellation
# amplifies to ~1e-3 (measured 1.1e-3), so 5e-3 there — still 10x inside
# the f32-vs-f64 pin 5e-2 of tests/test_bq.py.
Z_TOL = {("float64", "raw"): (1e-9, 1e-9), ("float64", "converted"): (1e-9, 1e-9),
         ("float32", "converted"): (1e-5, 1e-3), ("float32", "raw"): (1e-5, 5e-3)}


def _hyper_rows(dtype, n=16):
    """θ_tl rows scattered ±10% (log-normal) around the testbed's hypers,
    where the log-GP Gram stays well inside float32 and float64 conditioning
    (a wider spread reaches w_tl ≈ 1.6, where the f64 Gram's condition number
    alone puts the two packages' scores 1e-6 apart)."""
    rng = np.random.RandomState(0)
    return np.exp(np.log(tp.PARAMS_TL) + 0.1 * rng.randn(n, 2)).astype(dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_init_state_matches_jax(dtype):
    bj, bt = tp.make_pair(dtype)
    sj, st = bj.state, bt.state
    # float32: α and K⁻¹ of the s = 0 Grams carry eps32 × condition number
    # (α is ±10 with alternating signs), so they are held through what
    # consumes them — the posterior mean — and the factor normwise.
    tol = dict(rtol=1e-9, atol=1e-12) if dtype == "float64" else dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(tp.np_(st.c_mask), np.asarray(sj.c_mask))
    np.testing.assert_array_equal(tp.np_(st.obs_mask), np.asarray(sj.obs_mask))
    assert int(st.ns) == int(sj.ns)
    for name in ("x_c", "tl_s", "l_c", "x_mean", "x_var"):
        np.testing.assert_allclose(tp.np_(getattr(st, name)), np.asarray(getattr(sj, name)), **tol)
    for gp in ("gp_log_l", "gp_l"):
        gj, gt = getattr(sj, gp), getattr(st, gp)
        assert bool(gt.ok) and bool(gj.ok)
        for f in ("L", "alpha", "Kinv") if dtype == "float64" else ("L",):
            scale = np.abs(np.asarray(getattr(gj, f))).max()
            np.testing.assert_allclose(tp.np_(getattr(gt, f)), np.asarray(getattr(gj, f)),
                                       rtol=tol["rtol"], atol=tol["atol"] * scale)
        np.testing.assert_allclose(float(gt.jitter), float(gj.jitter), rtol=1e-6)
        xo = np.linspace(-3.0, 3.0, 61).astype(dtype)[:, None]
        mj = np.asarray(jgp.gp_mean(jkern("gaussian")[0], gj, jnp.asarray(xo)))
        mt = tp.np_(tgp.gp_mean(tkern("gaussian")[0], gt, torch.as_tensor(xo)))
        # normwise 1e-4 in f32 (measured 2.1e-5 for the log GP, whose f32
        # mean is 7e-6 from f64 in the JAX package and 2.6e-5 in the port)
        atol = (1e-12 if dtype == "float64" else 1e-4) * np.abs(mj).max()
        np.testing.assert_allclose(mt, mj, rtol=tol["rtol"], atol=atol)


@pytest.mark.parametrize("source", ["raw", "converted"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_z_moments_match_jax(dtype, source):
    bj, bt = tp.make_pair(dtype)
    if source == "converted":
        st, opts = tp.to_torch(bj.state, bj.options)
        zm, zv = float(tbq.Z_mean(st, opts)), float(tbq.Z_var(st, opts))
    else:
        zm, zv = bt.Z_mean(), bt.Z_var()
    rm, rv = Z_TOL[dtype, source]
    np.testing.assert_allclose(zm, bj.Z_mean(), rtol=rm)
    np.testing.assert_allclose(zv, bj.Z_var(), rtol=rv)
    # and the evidence itself is right (the testbed's closed form)
    np.testing.assert_allclose(zm, tp.tu.true_Z(), rtol=2e-3)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_2d_slice_matches_jax(dtype):
    """d = 2 from raw (x, ℓ): Halton candidates, the 2-D closed forms (f64)
    or the tensor Gauss–Hermite rule (f32), and the ESM over a small grid.
    Same tolerances as the 1-D testbed from raw; ESM f32 at 2e-5."""
    rng = np.random.RandomState(21)
    x = rng.uniform(-2.0, 2.0, (12, 2))
    l = np.exp(-0.5 * ((x - 0.2) ** 2).sum(1) / 0.5**2) / (2.0 * np.pi * 0.5**2)
    kw = dict(params_tl=(0.7, 0.8, 0.9), params_l=(0.3, 0.4, 0.5), x_var=np.eye(2),
              x_mean=np.zeros(2))
    bj, bt = tp.make_pair(dtype, x=x, l=l, **kw)
    # x_c = lo + t·(hi − lo) rounds to within a few ulps of the box width (4)
    np.testing.assert_allclose(tp.np_(bt.state.x_c), np.asarray(bj.state.x_c), rtol=1e-6,
                               atol=1e-12 if dtype == "float64" else 4 * 4 * 2.0**-23)
    np.testing.assert_array_equal(tp.np_(bt.state.c_mask), np.asarray(bj.state.c_mask))
    rm, rv = Z_TOL[dtype, "raw"]
    np.testing.assert_allclose(bt.Z_mean(), bj.Z_mean(), rtol=rm)
    np.testing.assert_allclose(bt.Z_var(), bj.Z_var(), rtol=rv)
    grid = rng.uniform(-3.0, 3.0, (64, 2)).astype(dtype)
    np.testing.assert_allclose(bt.expected_squared_mean(grid), bj.expected_squared_mean(grid),
                               rtol=1e-9 if dtype == "float64" else 2e-5)


@pytest.mark.parametrize("source", ["raw", "converted"])
def test_choose_next_same_argmax_f64(source):
    bj, bt = tp.make_pair("float64")
    xj, sj = jacq.choose_next(bj.state, bj.options, jnp.asarray(GRID))
    if source == "converted":
        st, opts = tp.to_torch(bj.state, bj.options)
    else:
        st, opts = bt.state, bt.options
    xt, s_t = tacq.choose_next(st, opts, GRID)
    assert float(xt[0]) == float(xj[0])
    np.testing.assert_allclose(tp.np_(s_t), np.asarray(sj), rtol=1e-9)


def test_choose_next_hyper_marginalized_f64():
    """ESM averaged over shared θ_tl rows: same scores and argmax."""
    bj, bt = tp.make_pair("float64")
    rows = _hyper_rows("float64", 3)
    xj, sj = jacq.choose_next(bj.state, bj.options, jnp.asarray(GRID), jnp.asarray(rows))
    xt, s_t = tacq.choose_next(bt.state, bt.options, GRID, torch.as_tensor(rows))
    assert float(xt[0]) == float(xj[0])
    np.testing.assert_allclose(tp.np_(s_t), np.asarray(sj), rtol=1e-8)


def test_active_trajectory_f64():
    """Three choose_next → add_observation steps: same points, same moments."""
    bj, bt = tp.make_pair("float64")
    for _ in range(3):
        xj = bj.choose_next(GRID)
        xt = bt.choose_next(GRID)
        assert xt == xj
        bj.add_observation(xj, float(tp.tu.f_l(xj)))
        bt.add_observation(xt, float(tp.tu.f_l(xt)))
        np.testing.assert_allclose(bt.Z_mean(), bj.Z_mean(), rtol=1e-8)
        np.testing.assert_allclose(bt.Z_var(), bj.Z_var(), rtol=1e-8)
    np.testing.assert_array_equal(bt.x_s, bj.x_s)


def test_run_active_loop_equals_open_loop():
    _, bt = tp.make_pair("float64")
    st0, opts = bt.state, bt.options

    def lik(x):
        return torch.as_tensor(tp.tu.f_l(x.numpy()), dtype=x.dtype).reshape(())

    final, (xs, zms, zvs) = tacq.run_active_loop(st0, opts, lik, GRID, 2)
    st = st0
    for i in range(2):
        x, _ = tacq.choose_next(st, opts, GRID)
        st = tacq.add_observation(st, opts, x, lik(x))
        assert float(xs[i, 0]) == float(x[0])
        assert float(zms[i]) == float(tbq.Z_mean(st, opts))
        assert float(zvs[i]) == float(tbq.Z_var(st, opts))
    assert int(final.ns) == 12


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_marginalize_matches_jax(dtype):
    bj, bt = tp.make_pair(dtype)
    rows = _hyper_rows(dtype)
    zm_j, zv_j = jmarg.marginalize(bj.state, bj.options, jnp.asarray(rows))
    zm_t, zv_t = tmarg.marginalize(bt.state, bt.options, torch.as_tensor(rows))
    rm, rv = (1e-8, 1e-8) if dtype == "float64" else (1e-4, 5e-2)
    np.testing.assert_allclose(tp.np_(zm_t), np.asarray(zm_j), rtol=rm)
    np.testing.assert_allclose(tp.np_(zv_t), np.asarray(zv_j), rtol=rv)
    # the batch equals the per-row refit
    st1 = tbq.apply_hyper_sample(bt.state, bt.options, torch.as_tensor(rows[5]))
    np.testing.assert_allclose(float(zm_t[5]), float(tbq.Z_mean(st1, bt.options)),
                               rtol=1e-12 if dtype == "float64" else 1e-5)


def test_slice_sample_gaussian_moments():
    """Slice sampling a 1-D N(1.5, 0.7²): mean and variance within 3 standard
    errors (batch-means errors over 20 batches, covering autocorrelation)."""
    mu, sd = 1.5, 0.7

    def logpdf(u):
        return -0.5 * ((u[..., 0] - mu) / sd) ** 2

    gen = torch.Generator().manual_seed(3)
    s = tp.np_(tmarg.slice_sample(gen, logpdf, torch.zeros(1), 4000, nburn=50))[:, 0]
    batches = s.reshape(20, -1)
    se_mean = batches.mean(1).std(ddof=1) / math.sqrt(20)
    se_var = batches.var(1).std(ddof=1) / math.sqrt(20)
    assert abs(s.mean() - mu) < 3 * se_mean
    assert abs(s.var() - sd**2) < 3 * se_var


def test_sample_hypers_moves_only_named_params():
    _, bt = tp.make_pair("float64")
    th = bt.sample_hypers(params=("w",), n=20, nburn=2, seed=1)
    assert th.shape == (20, 2) and np.all(th > 0)
    np.testing.assert_array_equal(th[:, 0], np.full(20, tp.PARAMS_TL[0]))
    assert np.unique(th[:, 1]).size > 5
    th_l = bt.sample_hypers(params=("w_l",), n=6, nburn=2, seed=1)  # joint rows (θ_tl ∥ θ_l)
    assert th_l.shape == (6, 4)
    np.testing.assert_array_equal(th_l[:, :3], np.tile(tp.PARAMS_TL + tp.PARAMS_L[:1], (6, 1)))
    assert np.unique(th_l[:, 3]).size > 2
    with pytest.raises(ValueError, match="unknown hyperparameter"):
        bt.sample_hypers(params=("ell",), n=2)
    zm, zv = bt.marginalize(n=8, seed=2)
    assert zm.shape == (8,) and np.all(np.isfinite(zm)) and np.all(zv >= 0)


def test_load_tpubq_npz_bq_save(tmp_path):
    bj, _ = tp.make_pair("float64")
    bj.add_observation(0.37, float(tp.tu.f_l(0.37)))
    path = tmp_path / "bq.npz"
    bj.save(str(path))
    st, opts = convert.load_tpubq_npz(path, device="cpu")
    assert opts.max_obs == bj.options.max_obs and opts.n_candidate == bj.options.n_candidate
    np.testing.assert_allclose(float(tbq.Z_mean(st, opts)), bj.Z_mean(), rtol=1e-9)
    np.testing.assert_allclose(float(tbq.Z_var(st, opts)), bj.Z_var(), rtol=1e-9)


def test_load_tpubq_npz_save_state(tmp_path):
    bj, _ = tp.make_pair("float64")
    path = tmp_path / "state.npz"
    jio.save_state(str(path), bj.state, bj.options)
    st, opts = convert.load_tpubq_npz(path, device="cpu")
    np.testing.assert_allclose(tp.np_(st.gp_l.Kinv), np.asarray(bj.state.gp_l.Kinv), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(tbq.Z_var(st, opts)), bj.Z_var(), rtol=1e-9)


def test_facade_checks_and_capacity_growth():
    x = tp.tu.make_x(10)
    opts = tp.options(max_obs=10)
    bj = tpubq.BQ(x, tp.tu.f_l(x), **opts).init(params_tl=tp.PARAMS_TL, params_l=tp.PARAMS_L)
    bt = tpubq_torch.BQ(x, tp.tu.f_l(x), device="cpu", **opts).init(params_tl=tp.PARAMS_TL, params_l=tp.PARAMS_L)
    with pytest.raises(ValueError, match="duplicate"):
        bt.add_observation(x[3], 0.1)
    with pytest.raises(ValueError, match="finite and positive"):
        bt.add_observation(0.31, -1.0)
    with pytest.raises(ValueError, match="unknown options"):
        tpubq_torch.BQ(x, tp.tu.f_l(x), device="cpu", n_candidates=3)
    bj.add_observation(0.31, float(tp.tu.f_l(0.31)))
    bt.add_observation(0.31, float(tp.tu.f_l(0.31)))
    assert bt.options.max_obs == bj.options.max_obs == 20 and bt.ns == 11
    np.testing.assert_allclose(bt.Z_mean(), bj.Z_mean(), rtol=1e-9)
    st = bt.state
    bt._state = st._replace(gp_l=st.gp_l._replace(ok=torch.tensor(False)))
    with pytest.raises(FloatingPointError):
        bt.Z_mean()


def test_float32_duplicate_observation_is_rejected_by_both_packages():
    """The duplicate test runs in the state's dtype: float32 0.1 is the stored
    x_s, so both packages reject it (the float64 test above cannot see this)."""
    x, l = np.array([-1.0, 0.1, 1.0]), np.array([0.3, 0.9, 0.2])
    kw = dict(dtype="float32", n_candidate=4, candidate_thresh=0.2, max_obs=8)
    bj = tpubq.BQ(x, l, **kw).init(params_tl=tp.PARAMS_TL, params_l=tp.PARAMS_L)
    bt = tpubq_torch.BQ(x, l, device="cpu", **kw).init(params_tl=tp.PARAMS_TL, params_l=tp.PARAMS_L)
    for bq in (bj, bt):
        with pytest.raises(ValueError, match="duplicate observation location"):
            bq.add_observation(0.1, 0.99)
        assert bq.ns == 3


def test_default_device_is_the_card_and_the_cpu_must_be_asked_for(tmp_path):
    """Without ``device=`` the entry points address the CUDA card; on a
    machine without one they raise an error that names ``device="cpu"`` and
    never carry on on the CPU by themselves."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the error path needs one without")
    x = tp.tu.make_x(10)
    with pytest.raises(RuntimeError, match=r'device="cpu"'):
        tpubq_torch.BQ(x, tp.tu.f_l(x), **tp.options())
    bj, bt = tp.make_pair("float64")
    path = tmp_path / "bq.npz"
    bj.save(str(path))
    with pytest.raises(RuntimeError, match=r'device="cpu"'):
        convert.load_tpubq_npz(path)
    opts = convert.options_from_dict({k: getattr(bj.options, k) for k in tp.FIELD_NAMES})
    with pytest.raises(RuntimeError, match=r'device="cpu"'):
        convert.state_from_numpy(tp.flat_state(bj.state), opts)
    assert bt.device == torch.device("cpu") and bt.state.x_s.device.type == "cpu"
    np.testing.assert_allclose(bt.Z_mean(), bj.Z_mean(), rtol=1e-9)
