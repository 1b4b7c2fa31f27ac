"""Parity of the port's serving surface with the JAX package: the public
moment names of ``models/bq.py``, ``linalg.remove_jitter``, ``utils.health``,
``utils.io`` and the ``BQ`` / ``BQFleet`` checkpoints (both ways, with the
reference-style layout), the ``BQ`` properties, ``refine_next`` and
``approx_expected_squared_mean``, the ``GP`` facade and ``log_mll_by_name``,
and the smoke of ``utils.profiling`` and ``utils.plotting``.

float64 on the CPU, on the testbed of ``tests/util.py`` (10 points,
max_obs 16); JAX states are carried into the port through
``tests/torch_parity.py``. A fleet is three testbed problems with other
likelihood means, stacked leaf by leaf. Tolerances are stated at each
assertion: 1e-12 for the moments and every checkpoint round trip, 1e-10 for
health leaves, the GP facade and the Gauss–Hermite ESM, 1e-8 for refinement
(30 Adam steps amplify rounding).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import tpubq
import tpubq_torch
from tests import torch_parity as tp
from tests import util as tu
from tpubq.models import acquire as jacq
from tpubq.models import bq as jbq
from tpubq.models import gp as jgp
from tpubq.ops import linalg as jlinalg
from tpubq.utils import health as jhealth
from tpubq.utils import io as jio
from tpubq_torch.models import acquire as tacq
from tpubq_torch.models import bq as tbq
from tpubq_torch.models import gp as tgp
from tpubq_torch.ops import linalg as tlinalg
from tpubq_torch.utils import health as thealth
from tpubq_torch.utils import io as tio

CPU = dict(device="cpu")
FLEET_MUS = (0.2, -0.4, 0.6)


def _close(a, b, tol, what=""):
    a, b = tp.np_(a).astype(np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(1.0, float(np.max(np.abs(b)))) if b.size else 1.0
    assert np.allclose(a, b, rtol=tol, atol=tol * scale, equal_nan=True), (what, a, b)


_JITTED = {}


def _jit(fn):
    """``fn`` jitted with its options argument static (one compile per
    function and shape: eager JAX dispatches every op of it separately)."""
    if fn not in _JITTED:
        _JITTED[fn] = jax.jit(fn, static_argnums=1)
    return _JITTED[fn]


@pytest.fixture(scope="module")
def pair():
    """(JAX BQ, port BQ carrying the JAX state, port state, port options)."""
    bj, _ = tp.make_pair()
    st, opts = tp.to_torch(bj.state, bj.options)
    bt = tpubq_torch.BQ(tu.make_x(), tu.f_l(tu.make_x()), **CPU, **tp.options())
    bt._state = st
    return bj, bt, st, opts


@pytest.fixture(scope="module")
def fleet():
    """(JAX single states, JAX options, stacked JAX state, port fleet state,
    port options): three testbed problems with other likelihood means."""
    x = tu.make_x()
    singles = []
    for mu in FLEET_MUS:
        bj = tpubq.BQ(x, stats.norm.pdf(x, mu, 0.5), **tp.options())
        singles.append(bj.init(params_tl=tp.PARAMS_TL, params_l=tp.PARAMS_L).state)
    opts_j = bj.options
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *singles)
    st, opts = tp.to_torch(stacked, opts_j)
    return singles, opts_j, stacked, st, opts


# ---------------------------------------------------------------- moments

MOMENTS = ("Z_var_exact", "Z_var_gh", "Z_var_qmc", "Z_var_terms", "Z_mean_and_var")


@pytest.mark.parametrize("name", MOMENTS)
def test_public_moment_names_match_jax(pair, name):
    bj, _, st, opts = pair
    want = _jit(getattr(jbq, name))(bj.state, bj.options)
    got = getattr(tbq, name)(st, opts)
    _close(torch.stack(got) if isinstance(got, tuple) else got,
           np.stack(want) if isinstance(want, tuple) else want, 1e-12, name)


@pytest.mark.parametrize("name", ("approx_Z_mean", "approx_Z_var"))
def test_quadrature_twins_match_jax_and_the_closed_forms(pair, name):
    bj, _, st, opts = pair
    xo = np.linspace(-6.0, 6.0, 801)
    got = getattr(tbq, name)(st, opts, xo)
    _close(got, _jit(getattr(jbq, name))(bj.state, bj.options, xo), 1e-12, name)
    exact = tbq.Z_mean(st, opts) if name == "approx_Z_mean" else tbq.Z_var_exact(st, opts)
    assert abs(got.item() - exact.item()) <= 1e-6 * abs(exact.item())


@pytest.mark.parametrize("name", MOMENTS[:4] + ("approx_Z_mean", "approx_Z_var"))
def test_public_moment_names_take_a_batched_state(fleet, name):
    singles, opts_j, _, st, opts = fleet
    extra = (np.linspace(-6.0, 6.0, 401),) if name.startswith("approx") else ()
    got = getattr(tbq, name)(st, opts, *extra)
    for i, sj in enumerate(singles):
        want = _jit(getattr(jbq, name))(sj, opts_j, *extra)
        if isinstance(want, tuple):
            _close(torch.stack([g[i] for g in got]), np.stack(want), 1e-12, name)
        else:
            _close(got[i], want, 1e-12, name)


def test_remove_jitter_matches_jax():
    rng = np.random.RandomState(3)
    K = rng.standard_normal((6, 6))
    mask = np.array([True] * 4 + [False] * 2)
    want = jlinalg.remove_jitter(jnp.asarray(K), 1e-3, jnp.asarray(mask))
    got = tlinalg.remove_jitter(torch.as_tensor(K), 1e-3, torch.as_tensor(mask))
    _close(got, want, 1e-12)
    Ks = torch.as_tensor(np.stack([K, 2 * K]))  # a batch, one jitter each
    got = tlinalg.remove_jitter(Ks, torch.tensor([1e-3, 2e-3], dtype=torch.float64), torch.as_tensor(mask))
    _close(got[1], jlinalg.remove_jitter(jnp.asarray(2 * K), 2e-3, jnp.asarray(mask)), 1e-12)


# ----------------------------------------------------------------- health


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_check_state_matches_jax(pair):
    bj, bt, st, opts = pair
    dj = _jit(jhealth.check_state)(bj.state, bj.options)
    want, got = dict(_leaves(dj)), dict(_leaves(bt.health()))
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], torch.Tensor) and got[k].device == st.x_s.device, k
        _close(got[k], want[k], 1e-10, k)
    assert bt.health(as_report=True).splitlines() == jhealth.format_report(dj).splitlines()


def test_check_state_fleet_matches_jax_vmap(fleet):
    _, opts_j, stacked, st, opts = fleet
    want = dict(_leaves(jax.jit(jax.vmap(lambda s: jhealth.check_state(s, opts_j)))(stacked)))
    got = dict(_leaves(tpubq_torch.BQFleet.from_states(st, opts).health()))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == (len(FLEET_MUS),), k
        _close(got[k], want[k], 1e-10, k)


def test_check_state_reports_a_failed_factor(pair):
    _, _, st, opts = pair
    bad = st._replace(gp_l=st.gp_l._replace(ok=torch.tensor(False), alpha=st.gp_l.alpha * math.nan))
    d = thealth.check_state(bad, opts)
    assert not bool(d["factor_ok_l"]) and not bool(d["alpha_l_finite"])
    assert "factor_ok: tl=True l=False" in thealth.format_report(d)


# ------------------------------------------------------------ checkpoints


def _moments_j(state, opts):
    return float(jbq.Z_mean(state, opts)), float(jbq.Z_var(state, opts))


def _moments_t(state, opts):
    return tbq.Z_mean(state, opts).item(), tbq.Z_var(state, opts).item()


def test_port_checkpoint_loads_in_jax(pair, tmp_path):
    bj, _, st, opts = pair
    tio.save_state(tmp_path / "port", st, opts)
    sj, oj = jio.load_state(tmp_path / "port")
    assert oj == bj.options
    _close(_moments_j(sj, oj), _moments_j(bj.state, bj.options), 1e-12)
    with np.load(tmp_path / "port.npz") as d:
        with np.load(_save_jax(bj, tmp_path / "jax")) as e:
            assert sorted(d.files) == sorted(e.files)  # the same layout, field for field
            assert all(d[k].dtype == e[k].dtype for k in d.files)


def _save_jax(bj, path):
    jio.save_state(path, bj.state, bj.options, force=True)
    return str(path) + ".npz"


@pytest.mark.parametrize("refit", (False, True))
def test_jax_checkpoint_loads_in_the_port(pair, tmp_path, refit):
    bj, _, _, _ = pair
    st, opts = tio.load_state(_save_jax(bj, tmp_path / "jax"), refit=refit, **CPU)
    assert st.gp_l.Kinv is not None and st.x_s.device.type == "cpu"
    _close(_moments_t(st, opts), _moments_j(bj.state, bj.options), 1e-12)


def test_save_state_guard_suffix_and_a_state_without_kinv(pair, tmp_path):
    _, _, st, opts = pair
    no_kinv = st._replace(gp_l=st.gp_l._replace(Kinv=None), gp_log_l=st.gp_log_l._replace(Kinv=None))
    tio.save_state(tmp_path / "a", no_kinv, opts)
    assert (tmp_path / "a.npz").exists()
    with pytest.raises(IOError):
        tio.save_state(tmp_path / "a", st, opts)
    with pytest.raises(IOError):
        tio.save_state(tmp_path / "a.npz", st, opts)
    tio.save_state(tmp_path / "a", st, opts, force=True, extras={"tag": 7})
    assert tio.load_extras(tmp_path / "a") == {"tag": 7}
    back, _ = tio.load_state(tmp_path / "a.npz", **CPU)
    _close(_moments_t(back, opts), _moments_t(st, opts), 1e-12)
    _close(back.gp_l.Kinv, st.gp_l.Kinv, 1e-12)


def test_bq_save_loads_in_jax_and_back(pair, tmp_path):
    bj, bt, _, _ = pair
    bt._seed = 5
    bt.save(tmp_path / "port_bq.npz")
    with pytest.raises(IOError):
        bt.save(tmp_path / "port_bq.npz")
    lj = tpubq.BQ.load(tmp_path / "port_bq.npz")
    assert lj._seed == 5 and lj.options == bj.options
    _close((lj.Z_mean(), lj.Z_var()), (bj.Z_mean(), bj.Z_var()), 1e-12)
    bj.save(tmp_path / "jax_bq.npz", force=True)
    lt = tpubq_torch.BQ.load(tmp_path / "jax_bq.npz", **CPU)
    assert lt._seed == bj._seed and lt.device.type == "cpu"
    _close((lt.Z_mean(), lt.Z_var()), (bj.Z_mean(), bj.Z_var()), 1e-12)
    lt.save(tmp_path / "again.npz")
    lt2 = tpubq_torch.BQ.load(tmp_path / "again.npz", **CPU)
    _close((lt2.Z_mean(), lt2.Z_var()), (bj.Z_mean(), bj.Z_var()), 1e-12)


def test_reference_style_file_loads_in_both(tmp_path):
    x = tu.make_x()
    opts = {"n_candidate": 12, "candidate_thresh": 0.2, "max_obs": 16, "bogus": 1}
    np.savez(tmp_path / "ref.npz", x=x, l=tu.f_l(x), params_tl=np.array(tp.PARAMS_TL),
             params_l=np.array(tp.PARAMS_L), mean=np.array(0.0), cov=np.array(1.0),
             options=np.array(opts, dtype=object))
    with pytest.warns(UserWarning, match="bogus"):
        lj = tpubq.BQ.load(tmp_path / "ref.npz")
    with pytest.warns(UserWarning, match="bogus"):
        lt = tpubq_torch.BQ.load(tmp_path / "ref.npz", **CPU)
    assert lt.options == tp.convert.options_from_dict({k: getattr(lj.options, k) for k in tp.FIELD_NAMES})
    _close((lt.Z_mean(), lt.Z_var()), (lj.Z_mean(), lj.Z_var()), 1e-12)
    np.savez(tmp_path / "bare.npz", x_s=x, l_s=tu.f_l(x))
    with pytest.warns(UserWarning, match="no hyperparameters"):
        tpubq_torch.BQ.load(tmp_path / "bare.npz", **CPU)
    np.savez(tmp_path / "junk.npz", a=np.zeros(3))
    with pytest.raises(ValueError, match="neither"):
        tpubq_torch.BQ.load(tmp_path / "junk.npz", **CPU)


def test_fleet_checkpoints_carry_the_seed_both_ways(fleet, tmp_path):
    singles, opts_j, stacked, st, opts = fleet
    ft = tpubq_torch.BQFleet.from_states(st, opts, seed=13)
    ft.save(tmp_path / "fleet")
    fj = tpubq.BQFleet.load(tmp_path / "fleet.npz")
    assert fj._seed == 13
    for i, sj in enumerate(singles):
        pj = jax.tree.map(lambda a: a[i], fj.states)
        _close(_moments_j(pj, fj.options), _moments_j(sj, opts_j), 1e-12)
    fj._seed = 21
    fj.save(tmp_path / "jfleet", force=True)
    for refit in (False, True):
        lt = tpubq_torch.BQFleet.load(tmp_path / "jfleet.npz", refit=refit, **CPU)
        assert lt._seed == 21 and len(lt) == len(FLEET_MUS)
        _close(np.stack([lt.Z_mean(), lt.Z_var()]),
               np.array([_moments_j(sj, opts_j) for sj in singles]).T, 1e-12)


# -------------------------------------------------------------- properties

PROPERTIES = ("ns", "x_s", "l_s", "tl_s", "x_c", "l_c", "nc", "x_sc", "l_sc", "gamma", "x_mean", "x_var")


@pytest.mark.parametrize("name", PROPERTIES)
def test_properties_match_the_jax_facade(pair, name):
    bj, bt, _, _ = pair
    _close(getattr(bt, name), getattr(bj, name), 1e-12, name)


@pytest.mark.parametrize("name", ("gp_log_l", "gp_l"))
def test_gp_views_match_the_jax_facade(pair, name):
    bj, bt, _, _ = pair
    gj, gt = getattr(bj, name), getattr(bt, name)
    assert type(gt)._fields == type(gj)._fields
    for f in ("theta", "s", "x", "y", "mask", "L", "alpha", "Kinv", "jitter", "ok"):
        _close(getattr(gt, f), getattr(gj, f), 1e-12, f"{name}.{f}")


# -------------------------------------------------------------- refinement


@pytest.mark.parametrize("rows", (0, 3))
def test_refine_next_matches_jax(pair, rows):
    bj, _, st, opts = pair
    hyp = np.array([[0.6, 0.7], [0.8, 0.9], [0.7, 1.1]])[:rows] if rows else None
    grid = np.linspace(-4.0, 4.0, 9)
    x0, _ = jacq.choose_next(bj.state, bj.options, grid, None if hyp is None else jnp.asarray(hyp))
    xj, vj = jacq.refine_next(bj.state, bj.options, x0, None if hyp is None else jnp.asarray(hyp))
    xt, vt = tacq.refine_next(st, opts, torch.as_tensor(np.array(x0)),
                              None if hyp is None else torch.as_tensor(hyp))
    _close(xt, xj, 1e-8, "x_ref")
    _close(vt, vj, 1e-8, "esm_ref")


def test_refine_next_periodic_step_matches_jax():
    bj, _ = tp.make_pair(kernel="periodic")
    st, opts = tp.to_torch(bj.state, bj.options)
    x0 = jnp.asarray([0.37])
    xj, vj = jacq.refine_next(bj.state, bj.options, x0, n_steps=5)
    xt, vt = tacq.refine_next(st, opts, torch.tensor([0.37], dtype=torch.float64), n_steps=5)
    _close(xt, xj, 1e-8, "x_ref")
    _close(vt, vj, 1e-8, "esm_ref")


def test_refine_next_improves_on_coarse_grid(pair):
    """tests/test_bq.py's gap test on the port: the refined ESM is at least
    the coarse-grid winner's and closes most of the gap to the dense grid's."""
    _, bt, st, opts = pair
    coarse = np.linspace(-4, 4, 9)
    x0, scores = tacq.choose_next(st, opts, coarse)
    v0 = scores.max().item()
    _, v_ref = tacq.refine_next(st, opts, x0)
    dense = np.linspace(-4, 4, 4001)
    v_star = tacq.expected_squared_mean(st, opts, dense).max().item()
    assert v_ref.item() >= v0
    if v_star - v0 > 1e-14:
        assert (v_ref.item() - v0) / (v_star - v0) > 0.7
    xr = bt.choose_next(coarse, refine=True)
    assert np.isfinite(xr) and xr not in coarse
    assert np.isfinite(bt.choose_next(coarse, n=3, seed=2, refine=True))


def test_approx_expected_squared_mean_matches_jax(pair):
    bj, _, st, opts = pair
    grid = np.linspace(-4.0, 4.0, 41)
    got = tacq.approx_expected_squared_mean(st, opts, grid)
    _close(got, _jit(jacq.approx_expected_squared_mean)(bj.state, bj.options, grid), 1e-10)
    _close(got, tacq.expected_squared_mean(st, opts, grid), 1e-8)  # the closed form it checks


# --------------------------------------------------------------- GP facade


@pytest.mark.parametrize("kernel", ("gaussian", "matern52", "matern32", "rq", "periodic"))
def test_gp_facade_and_log_mll_by_name_match_jax(kernel):
    x, y = tu.make_x(8), np.sin(tu.make_x(8))
    theta = tp.FAMILY_PARAMS[kernel][0]
    gj = jgp.GP(kernel, theta, x, y, s=0.1)
    gt = tgp.GP(kernel, theta, x, y, s=0.1, **CPU)
    xo = np.linspace(-2.0, 2.0, 5)
    for name in ("x", "y", "Kxx", "inv_Kxx", "params", "dloglh_dtheta"):
        _close(getattr(gt, name), getattr(gj, name), 1e-10, name)
    assert gt.s == gj.s and abs(gt.log_lh - gj.log_lh) <= 1e-10 * abs(gj.log_lh)
    _close(gt.mean(xo), gj.mean(xo), 1e-10, "mean")
    _close(gt.cov(xo), gj.cov(xo), 1e-10, "cov")
    new = np.array(theta) * 1.1
    g2 = gt.copy()
    g2.params = np.concatenate([new, [0.2]])
    gj.params = np.concatenate([new, [0.2]])
    _close(g2.mean(xo), gj.mean(xo), 1e-10, "mean after the setter")
    assert abs(g2.log_lh - gj.log_lh) <= 1e-10 * abs(gj.log_lh) and gt.s == 0.1  # the copy is apart
    mask = np.array([True] * 6 + [False] * 2)
    args = (np.array(theta), 0.1, x[:, None], y, mask)
    lj = jgp.log_mll_by_name(kernel)(*(jnp.asarray(a) for a in args))
    lt = tgp.log_mll_by_name(kernel)(*(torch.as_tensor(np.asarray(a)) for a in args))
    assert abs(lt.item() - float(lj)) <= 1e-10 * abs(float(lj))


def test_gp_facade_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgp.GP("gaussian", (1.0, 1.0), tu.make_x(4), np.ones(4))


# -------------------------------------------------------- profiling, plots


def test_profiling_on_the_cpu(tmp_path):
    from tpubq_torch.utils import profiling

    calls = []

    @profiling.annotate("tpubq_facade_span")
    def fn(a):
        calls.append(1)
        return a * 2

    secs, out = profiling.time_fn(fn, torch.ones(3), iters=4, warmup=1, repeats=3)
    assert secs > 0 and len(calls) == 1 + 4 * 3 and torch.equal(out, torch.full((3,), 2.0))
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("tpubq_facade_block"):
            fn(torch.ones(3))
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "tpubq_facade_block" in text and "tpubq_facade_span" in text


def test_enable_compile_cache_points_the_build_there(tmp_path, monkeypatch):
    from tpubq_torch.ops import _build
    from tpubq_torch.utils import profiling

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    assert profiling.enable_compile_cache(str(tmp_path)) == str(tmp_path)
    assert _build.so_path().parent == tmp_path


def test_every_plot_method_runs_on_agg(pair, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, bt, _, _ = pair
    for method in ("plot_gp_log_l", "plot_gp_l", "plot_l"):
        assert getattr(bt, method)(f_l=tu.f_l).get_title()
    for method in ("plot_expected_squared_mean", "plot_expected_variance"):
        assert getattr(bt, method)().get_title()
    fig, axes = bt.plot(f_l=tu.f_l)
    assert len(axes) == 3
    bt.choose_next(np.linspace(-4, 4, 21), plot=True)
    bt.choose_next(torch.linspace(-4, 4, 21, dtype=torch.float64), plot=True)
    fig.savefig(tmp_path / "p.png")
    x2 = np.random.RandomState(1).uniform(-2, 2, (8, 2))
    l2 = np.exp(-0.5 * np.sum(x2**2, 1))
    b2 = tpubq_torch.BQ(x2, l2, n_candidate=6, candidate_thresh=0.2, x_mean=np.zeros(2),
                        x_var=np.eye(2), **CPU).init()
    for method in ("plot_gp_log_l", "plot_gp_l", "plot_l", "plot_expected_squared_mean",
                   "plot_expected_variance"):
        with pytest.raises(ValueError, match="1-D"):
            getattr(b2, method)()
    _, axes2 = b2.plot(f_l=lambda X: np.exp(-0.5 * np.sum(X**2, 1)), xmin=-2.0, xmax=2.0)
    assert len(axes2) == 3
    with pytest.raises(ValueError, match="d=2"):
        bt.plot_2d()
    plt.close("all")
