"""Parity of the port's fleet (tpubq_torch.models.batched, ``BQFleet``, the
plain versions of the ``esm_fleet_l`` / ``esm_fleet_tl`` kernels and the
per-problem-data form of ``mll_grad_batched``) with the JAX package.

Both packages get the same inputs, made with numpy from a seed. The Pallas
fleet kernels run in interpret mode, as tests/test_pallas.py runs them on the
CPU, with the same guard multiplier λ on both sides; float32 JAX states are
carried into the port through ``tests/torch_parity.py`` so that both score
with bit-identical inverses. Tolerances are stated at each assertion.
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import tpubq_torch
from tests import torch_parity as tp
from tests import util as tu
from tpubq.models import acquire as jacq
from tpubq.models import batched as jbat
from tpubq.models import gp as jgp
from tpubq.ops import pallas_kernels as pk
from tpubq.ops.kernels import get_kernel as jkern
from tpubq.utils.options import BQOptions as JOptions
from tpubq_torch.models import acquire as tacq
from tpubq_torch.models import batched as tbat
from tpubq_torch.models import bq as tbq
from tpubq_torch.models import fit as tfit
from tpubq_torch.models import gp as tgp
from tpubq_torch.ops import hopper_kernels as hk
from tpubq_torch.ops.kernels import get_kernel as tkern
from tpubq_torch.utils import convert
from tpubq_torch.utils.options import BQOptions as TOptions

OPT_KW = dict(n_candidate=10, candidate_thresh=0.2, max_obs=16)
PARAMS = dict(params_tl=(0.7, 0.8), params_l=(0.3, 0.4))
MUS, SIGS = [0.2, -0.5, 0.8], [0.5, 0.7, 0.4]


def _data(B=3, n=10, seed=0):
    rng = np.random.RandomState(seed)
    xs = np.stack([np.linspace(-2.2, 2.2, n) + 0.04 * rng.standard_normal(n) for _ in range(B)])
    ls = np.stack([stats.norm.pdf(xs[i], MUS[i % 3], SIGS[i % 3]) for i in range(B)])
    return xs, ls


def _pair(xs, ls, dtype="float64", **kw):
    """(JAX fleet state, JAX options, port fleet state, port options)."""
    opt_kw = {**OPT_KW, **{k: kw.pop(k) for k in list(kw) if k in ("max_obs", "n_candidate", "dim")}}
    oj, ot = JOptions(dtype=dtype, **opt_kw), TOptions(dtype=dtype, **opt_kw)
    kw = {**PARAMS, **kw}
    return jbat.init_batch(xs, ls, oj, **kw), oj, tbat.init_batch(xs, ls, ot, device="cpu", **kw), ot


def _assert_states_close(st, sj, rtol=1e-9):
    """Every leaf of the port's state against the JAX state: masks and counts
    equal, the rest to ``rtol`` (plus 1e-12 of the leaf's largest entry)."""
    flat = tp.flat_state(sj)
    for name, ref in flat.items():
        obj = st
        for part in name.split("."):
            obj = getattr(obj, part)
        got = tp.np_(obj)
        assert got.shape == ref.shape, name
        if ref.dtype == bool or name == "ns":
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            scale = np.abs(ref).max() if ref.size else 0.0
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-12 * scale, err_msg=name)


def _lik_t(x):
    return torch.exp(-0.5 * (x[0] - 0.2) ** 2 / 0.25) / math.sqrt(2.0 * math.pi * 0.25)


def _lik_j(x):
    return jnp.exp(-0.5 * (x[0] - 0.2) ** 2 / 0.25) / jnp.sqrt(2 * jnp.pi * 0.25)


# ---------------------------------------------------------------------------
# init_batch and the Z moments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["shared", "per_problem"])
def test_init_batch_and_moments_match_jax_f64(case):
    """Every leaf of the batched state to rtol 1e-9, with shared hypers and the
    default measure, and with per-problem hypers and per-problem 1-D measures;
    Z_mean_batch / Z_var_batch to rtol 1e-8."""
    xs, ls = _data()
    kw = {}
    if case == "per_problem":
        kw = dict(params_tl=np.tile([0.7, 0.8], (3, 1)) * np.linspace(0.8, 1.2, 3)[:, None],
                  x_means=np.array([-0.5, 0.0, 0.5]), x_vars=np.array([0.5, 1.0, 2.0]), s_tl=0.01, gamma=2.0)
    sj, oj, st, ot = _pair(xs, ls, **kw)
    assert st.ns.shape == (3,) and st.x_mean.shape == (3, 1) and st.x_var.shape == (3, 1, 1)
    _assert_states_close(st, sj)
    np.testing.assert_allclose(tp.np_(tbat.Z_mean_batch(st, ot)), np.asarray(jbat.Z_mean_batch(sj, oj)), rtol=1e-8)
    np.testing.assert_allclose(tp.np_(tbat.Z_var_batch(st, ot)), np.asarray(jbat.Z_var_batch(sj, oj)), rtol=1e-8)


def test_init_batch_broadcasting_errors_and_warning():
    """The measure forms of tests/test_batched.py: a shared (1,) mean and
    variance reach every problem; a shape matching neither form, a non-positive
    likelihood, too many observations and a (B', p) hyper stack raise; B == d
    with 1-D measures warns and takes the shared reading."""
    xs, ls = _data()
    opts = TOptions(**OPT_KW)
    st = tbat.init_batch(xs[..., None], ls, opts, x_means=np.array([0.25]), x_vars=np.array([1.5]),
                         device="cpu", **PARAMS)
    np.testing.assert_array_equal(st.x_mean.numpy(), 0.25 * np.ones((3, 1)))
    np.testing.assert_array_equal(st.x_var.numpy(), 1.5 * np.ones((3, 1, 1)))
    with pytest.raises(ValueError, match="neither"):
        tbat.init_batch(xs, ls, opts, x_means=np.zeros(5), device="cpu", **PARAMS)
    with pytest.raises(ValueError, match="neither"):
        tbat.init_batch(xs, ls, opts, x_vars=np.ones(5), device="cpu", **PARAMS)
    with pytest.raises(ValueError, match="positive"):
        tbat.init_batch(xs, -np.ones_like(ls), opts, device="cpu")
    with pytest.raises(ValueError, match="max_obs"):
        tbat.init_batch(np.zeros((2, 17)), np.ones((2, 17)), opts, device="cpu")
    with pytest.raises(ValueError, match=r"\(B, p\)"):
        tbat.init_batch(xs, ls, opts, params_tl=np.ones((2, 2)), device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        tbat.init_batch(xs, ls, opts, gamma=0.0, device="cpu")

    rng = np.random.RandomState(0)
    x2 = rng.uniform(-2, 2, (2, 8, 2))  # B == d == 2
    l2 = np.exp(-0.5 * np.sum(x2**2, axis=-1))
    opts2 = TOptions(n_candidate=6, candidate_thresh=0.25, max_obs=16, dim=2)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        st2 = tbat.init_batch(x2, l2, opts2, x_means=np.array([0.1, 0.2]), x_vars=np.array([1.0, 2.0]),
                              device="cpu")
    assert sum("shared" in str(w.message) for w in rec) == 2
    np.testing.assert_array_equal(st2.x_mean.numpy(), np.tile([0.1, 0.2], (2, 1)))
    np.testing.assert_array_equal(st2.x_var.numpy(), np.tile(np.diag([1.0, 2.0]), (2, 1, 1)))


# ---------------------------------------------------------------------------
# the scorer: the kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _f32_fleet(B=6):
    """The fleet of tests/test_pallas.py's parity test: per-problem hypers, B
    not a multiple of the TPU kernel's packing."""
    rng = np.random.RandomState(3)
    xs = np.stack([np.linspace(-2.2, 2.2, 10) + 0.05 * rng.standard_normal(10) for _ in range(B)])
    mus = rng.uniform(-0.5, 0.5, B)
    ls = np.stack([stats.norm.pdf(xs[i], mus[i], 0.5) for i in range(B)])
    theta_l = np.stack([[0.3 + 0.02 * b, 0.4 + 0.03 * b] for b in range(B)])
    theta_tl = np.stack([[0.7 + 0.01 * b, 0.8 - 0.02 * b] for b in range(B)])
    opts = JOptions(n_candidate=12, candidate_thresh=0.2, max_obs=16, dtype="float32")
    return jbat.init_batch(xs, ls, opts, params_tl=theta_tl, params_l=theta_l), opts


def _pallas_fleet(states, opts, grid, lam, monkeypatch, tile):
    """The JAX fleet scorer run eagerly around its two Pallas kernels in
    interpret mode → (scores, (A, B, degen), (m_a, c_a)), the kernels' outputs
    caught on their way to the combine and cut to (B, G)."""
    caught = {}
    for name in ("esm_fleet_l", "esm_fleet_tl"):
        def spy(*a, _f=getattr(pk, name), _n=name, **k):
            caught[_n] = _f(*a, **k)
            return caught[_n]

        monkeypatch.setattr(pk, name, spy)
    scores = jbat.expected_squared_mean_fleet.__wrapped__(
        states, opts, jnp.asarray(grid), interpret=True, tile=tile, lam=lam)
    B, G = scores.shape
    cut = lambda outs: tuple(np.asarray(o)[:B, :G] for o in outs)  # noqa: E731
    return np.asarray(scores), cut(caught["esm_fleet_l"]), cut(caught["esm_fleet_tl"])


def test_fleet_plain_versions_match_pallas_interpret(monkeypatch):
    """The carried-across float32 state through ``esm_fleet_l_plain`` /
    ``esm_fleet_tl_plain`` against ``pk.esm_fleet_l`` / ``pk.esm_fleet_tl``
    (interpret mode), λ = the JAX package's on both sides.

    The TPU kernel's dot is a three-pass bf16 product (~2⁻¹⁶ per term), the
    port's a float32 sum, so the outputs that pass through K⁻¹ differ by
    ~1e-5 × kᵀ|K⁻¹|k: normwise per problem A ≤ 1e-4 (measured 2.8e-5),
    B ≤ 1e-2 (3.2e-3), c_a ≤ 5e-2 (2.0e-2; K_tl⁻¹ of the s = 0 Gram has
    entries ~1e4), m_a, a plain float32 sum on both sides, ≤ 1e-5 (1.2e-6);
    the degenerate masks agree on ≥ 99.5% of the points (measured: all).
    The combined scores, and the port's fleet scorer against the vmapped
    single-problem JAX scorer, at the JAX suite's pins for its own fleet
    scorer (q95 < 2e-4, q99 < 2e-3, max < 1e-2).
    """
    states, opts = _f32_fleet()
    lam = jbat._LAM_X3
    grid = np.linspace(-4, 4, 300, dtype=np.float32)[:, None]
    out_j, (A_j, B_j, dg_j), (m_j, c_j) = _pallas_fleet(states, opts, grid, lam, monkeypatch, 256)
    st, ot = tp.to_torch(states, opts)
    assert tbat.fleet_scorer_supported(ot)
    g = torch.as_tensor(grid)
    (params, w_l, *rest_l), (h2, w_tl, *rest_tl), _ = tbat.fleet_scorer_inputs(st, ot)
    A, Bc, dg = hk.esm_fleet_l(params, w_l, g, *rest_l, ot.candidate_thresh, lam)  # CPU: the plain version
    m_a, c_a = hk.esm_fleet_tl(h2, w_tl, g, *rest_tl)
    assert hk.esm_fleet_l.launches == 0 and hk.esm_fleet_tl.launches == 0

    def normwise(t, ref):
        return (np.abs(t.numpy() - ref) / np.abs(ref).max(1, keepdims=True)).max()

    assert np.mean(dg.numpy() == dg_j) >= 0.995
    assert normwise(A, A_j) <= 1e-4 and normwise(Bc, B_j) <= 1e-2
    assert normwise(m_a, m_j) <= 1e-5 and normwise(c_a, c_j) <= 5e-2

    def pins(out, ref):
        rel = np.abs(out - ref) / (np.abs(ref) + 1e-12)
        assert np.quantile(rel, 0.95) < 2e-4 and np.quantile(rel, 0.99) < 2e-3 and rel.max() < 1e-2, (
            np.quantile(rel, 0.95), np.quantile(rel, 0.99), rel.max())

    out_t = tbat.expected_squared_mean_fleet(st, ot, g, lam=lam).numpy()
    assert out_t.shape == (6, 300)
    pins(out_t, out_j)
    ref = np.asarray(jax.vmap(jacq.expected_squared_mean, (0, None, None))(states, opts, jnp.asarray(grid)))
    pins(out_t, ref)
    # the port's own λ and its auto-dispatch (expected_squared_mean_batch takes the fleet scorer here)
    pins(tbat.expected_squared_mean_batch(st, ot, g).numpy(), ref)
    np.testing.assert_array_equal(tbat.expected_squared_mean_batch(st, ot, g).numpy(),
                                  tbat.expected_squared_mean_fleet(st, ot, g).numpy())


def test_fleet_scorer_2d_matches_jax_vmapped_scorer():
    """d = 2 (the ζ quadratic form, the sup-norm proximity test, the closed-form
    2 × 2 inverse) against the vmapped JAX scorer at the JAX suite's pins for
    its own fleet scorer in 2-D: q99 < 5e-4, max < 5e-2."""
    rng = np.random.RandomState(7)
    B = 4
    xs = rng.uniform(-2, 2, (B, 9, 2))
    ls = np.stack([stats.multivariate_normal.pdf(xs[b], 0.1 * b * np.ones(2), np.eye(2) * 0.5) for b in range(B)])
    opts = JOptions(n_candidate=8, candidate_thresh=0.25, max_obs=16, dim=2, dtype="float32")
    states = jbat.init_batch(xs, ls, opts, params_tl=(0.7, 0.8, 0.9), params_l=(0.3, 0.5, 0.6),
                             x_vars=np.array([[1.0, 0.3], [0.3, 0.8]]))
    g1 = np.linspace(-3, 3, 16)
    grid = np.stack(np.meshgrid(g1, g1), axis=-1).reshape(-1, 2).astype(np.float32)
    ref = np.asarray(jax.vmap(jacq.expected_squared_mean, (0, None, None))(states, opts, jnp.asarray(grid)))
    st, ot = tp.to_torch(states, opts)
    out = tbat.expected_squared_mean_fleet(st, ot, torch.as_tensor(grid)).numpy()
    rel = np.abs(out - ref) / (np.abs(ref) + 1e-12)
    assert np.quantile(rel, 0.99) < 5e-4 and rel.max() < 5e-2, (np.quantile(rel, 0.99), rel.max())
    # the closed-form small inverses against the library's, d = 1, 2, 3
    for d in (1, 2, 3):
        M = torch.as_tensor(rng.randn(5, d, d))
        M = M @ M.transpose(1, 2) + d * torch.eye(d, dtype=torch.float64)
        inv, det = tbat._inv_det_small(M)
        np.testing.assert_allclose(inv.numpy(), torch.linalg.inv(M).numpy(), rtol=1e-10)
        np.testing.assert_allclose(det.numpy(), torch.linalg.det(M).numpy(), rtol=1e-10)


def test_fleet_launch_config_covers_the_route():
    """The tiled fleet kernels' launch (``_fleet_launch_config``, the layout of
    csrc/esm_fleet_common.cuh) at every size the route takes, 1 … 220 rows at
    d = 1 … 3: one thread per 8 points × 4 columns of a column tile 16 … 64
    wide that covers NP in ⌈NP/64⌉ tiles, within 227 KB of shared memory. The
    route answers as it did before the redesign: 220 rows, d ≤ 3."""
    for d in (1, 2, 3):
        for NP in range(1, 221):
            threads, smem = hk._fleet_launch_config(NP, d)
            ct, tiles = hk._fleet_col_width(NP), (NP + 63) // 64
            assert ct % 16 == 0 and ct <= 64 and ct - 16 < -(-NP // tiles) <= ct  # NP split evenly, up to 16
            assert threads == (128 // hk._FLEET_QP) * (ct // 4) and 0 < smem <= hk.SMEM_LIMIT
    assert (hk._fleet_col_width(44), hk._fleet_col_width(32), hk._fleet_col_width(220)) == (48, 32, 64)
    assert hk.esm_fleet_l_supported(220, 1) and hk.esm_fleet_tl_supported(220, 3)
    assert not hk.esm_fleet_l_supported(224, 1) and not hk.esm_fleet_tl_supported(224, 1)
    assert not hk.esm_fleet_l_supported(221, 2) and not hk.esm_fleet_l_supported(0, 1)
    assert not hk.esm_fleet_l_supported(16, 4) and not hk.esm_fleet_tl_supported(16, 4)
    assert hk._fleet_launch_config(224, 1) is None and hk._fleet_launch_config(16, 4) is None


def test_fleet_scorer_dispatch_and_rejections():
    """What takes the kernels and what the plain batched scorer: float64 and
    per-problem grids go to the plain path; an explicit fleet-scorer call on
    float64 raises; the wrappers raise on shapes, dtypes and sizes they do not
    take instead of falling back."""
    xs, ls = _data()
    o64, o32 = TOptions(**OPT_KW), TOptions(dtype="float32", **OPT_KW)
    assert not tbat.fleet_scorer_supported(o64) and tbat.fleet_scorer_supported(o32)
    assert tbat.fleet_scorer_supported(TOptions(dtype="float32", max_obs=112, n_candidate=14))
    assert not tbat.fleet_scorer_supported(TOptions(dtype="float32", max_obs=256, n_candidate=12))
    assert hk.esm_fleet_l_supported(220, 1) and not hk.esm_fleet_l_supported(224, 1)
    assert not hk.esm_fleet_tl_supported(16, 4)
    st64 = tbat.init_batch(xs, ls, o64, device="cpu", **PARAMS)
    grid = np.linspace(-3, 3, 41)
    with pytest.raises(ValueError, match="f32 gaussian"):
        tbat.expected_squared_mean_fleet(st64, o64, grid)
    shared = tbat.expected_squared_mean_batch(st64, o64, grid)
    grids = np.stack([grid + 0.1 * i for i in range(3)])
    per = tbat.expected_squared_mean_batch(st64, o64, grids, per_problem=True)
    assert shared.shape == per.shape == (3, 41)
    np.testing.assert_allclose(per[0].numpy(), shared[0].numpy(), rtol=1e-12)
    assert not np.allclose(per[1].numpy(), shared[1].numpy())
    with pytest.raises(ValueError, match=r"\(B, G, d\)"):
        tbat.expected_squared_mean_batch(st64, o64, grids[:2], per_problem=True)
    zv = tbat.expected_Z_var_batch(st64, o64, grid)
    zm = tbat.Z_mean_batch(st64, o64)
    np.testing.assert_allclose(zv.numpy(), ((zm * zm + tbat.Z_var_batch(st64, o64))[:, None] - shared).numpy(),
                               rtol=1e-12)

    st32 = tbat.init_batch(xs, ls, o32, device="cpu", **PARAMS)
    (params, w_l, *rest_l), (h2, w_tl, *rest_tl), _ = tbat.fleet_scorer_inputs(st32, o32)
    g = torch.linspace(-3, 3, 41)[:, None]
    with pytest.raises(TypeError):
        hk.esm_fleet_l(params.double(), w_l, g, *rest_l, 0.2, 1e-6)
    with pytest.raises(ValueError, match="params"):
        hk.esm_fleet_l(params[:, :8].contiguous(), w_l, g, *rest_l, 0.2, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        hk.esm_fleet_tl(h2, w_tl, g, rest_tl[0], rest_tl[1], rest_tl[2].transpose(1, 2), rest_tl[3])
    with pytest.raises(ValueError, match="dim"):
        hk.esm_fleet_tl(h2, w_tl, torch.zeros(5, 2), *rest_tl)
    # a problem whose factor is non-finite keeps its NaN to its own row
    bad = st32._replace(gp_l=st32.gp_l._replace(alpha=st32.gp_l.alpha.index_fill(0, torch.tensor([1]), math.nan)))
    out = tbat.expected_squared_mean_fleet(bad, o32, g)
    assert not torch.isfinite(out[1]).any() and torch.isfinite(out[[0, 2]]).all()


# ---------------------------------------------------------------------------
# the fleet is B single problems; the active loop against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fleet_equals_single_problems(dtype):
    """Inside the port: moments, scores, picks and the state after
    ``add_observation_batch`` of a fleet against its problems one by one
    (float64 to 1e-10; float32 moments to 1e-5, picks and counts equal, the
    fleet scorer against the single fused scorer's plain version at 1e-4 of
    the largest score on the points neither demotes)."""
    xs, ls = _data()
    opts = TOptions(dtype=dtype, **OPT_KW)
    st = tbat.init_batch(xs, ls, opts, device="cpu", s_tl=0.01, s_l=0.01, **PARAMS)
    singles = [tbq.init_state(xs[i], ls[i], opts, s_tl=0.01, s_l=0.01, device="cpu", **PARAMS) for i in range(3)]
    grid = np.linspace(-3, 3, 61)
    tol = 1e-10 if dtype == "float64" else 1e-5
    zm, zv = tbat.Z_mean_batch(st, opts), tbat.Z_var_batch(st, opts)
    x_next, scores = tbat.choose_next_batch(st, opts, grid)
    assert x_next.shape == (3, 1) and scores.shape == (3, 61)
    new = tbat.add_observation_batch(st, opts, x_next, tu.f_l(x_next[:, 0].numpy()))
    for i, one in enumerate(singles):
        np.testing.assert_allclose(float(zm[i]), float(tbq.Z_mean(one, opts)), rtol=tol)
        np.testing.assert_allclose(float(zv[i]), float(tbq.Z_var(one, opts)), rtol=100 * tol)
        x1, s1 = tacq.choose_next(one, opts, grid)
        if dtype == "float64":
            np.testing.assert_allclose(scores[i].numpy(), s1.numpy(), rtol=1e-10)
        else:
            both = (scores[i] != scores[i].amin()) & (s1 != s1.amin())  # off both plateaus
            assert float((scores[i] - s1).abs()[both].max()) <= 1e-4 * float(s1.abs().max())
        assert float(x1) == float(x_next[i])
        one_new = tacq.add_observation(one, opts, x1, tu.f_l(x1.numpy()))
        got = tbq.tree_map(lambda a: a[i], new)
        assert int(got.ns) == int(one_new.ns) == 11
        np.testing.assert_allclose(got.x_s.numpy(), one_new.x_s.numpy(), rtol=tol)
        np.testing.assert_allclose(got.l_c.numpy(), one_new.l_c.numpy(), rtol=tol, atol=tol)
        scale = float(one_new.gp_l.L.abs().max())
        np.testing.assert_allclose(got.gp_l.L.numpy(), one_new.gp_l.L.numpy(), rtol=100 * tol, atol=tol * scale)
        np.testing.assert_allclose(float(tbq.Z_mean(got, opts)), float(tbq.Z_mean(one_new, opts)), rtol=tol)


def test_choose_next_batch_single_point_grid_dim2():
    """A 1-D grid array for dim = 2 means ONE 2-D point: every problem gets it back."""
    rng = np.random.RandomState(0)
    opts = TOptions(n_candidate=10, candidate_thresh=0.25, max_obs=16, dim=2)
    xs = rng.uniform(-2, 2, size=(3, 8, 2))
    st = tbat.init_batch(xs, np.exp(-0.5 * np.sum(xs**2, axis=-1)), opts, params_tl=(0.7, 0.8, 0.8),
                         params_l=(0.3, 0.5, 0.5), device="cpu")
    pt = np.array([0.31, -0.42])
    x_next, scores = tbat.choose_next_batch(st, opts, pt)
    np.testing.assert_allclose(x_next.numpy(), np.tile(pt, (3, 1)), rtol=1e-12)
    assert scores.shape == (3, 1)


def test_run_active_loop_batch_matches_jax_f64():
    """Three closed-loop steps in float64: the same picks as the JAX fleet's
    compiled scan, E[Z] per step to rtol 1e-8 and V[Z] to 1e-6 (a V[Z] of 2e-8
    is what cancels out of terms of 1e-1; measured 1.7e-7), every leaf of the
    final state to 1e-7; ``record_moments=False`` returns None and the same
    final state to the bit."""
    xs, ls = _data()
    sj, oj, st, ot = _pair(xs, ls)
    grid = np.linspace(-4, 4, 101)
    fj, (zm_j, zv_j) = jbat.run_active_loop_batch(sj, oj, _lik_j, jnp.asarray(grid)[:, None], 3)
    ft, (zm_t, zv_t) = tbat.run_active_loop_batch(st, ot, _lik_t, grid, 3)
    assert zm_t.shape == (3, 3)
    np.testing.assert_array_equal(tp.np_(ft.ns), np.asarray(fj.ns))
    np.testing.assert_allclose(tp.np_(ft.x_s), np.asarray(fj.x_s), rtol=1e-12)  # the same picks
    np.testing.assert_allclose(tp.np_(zm_t), np.asarray(zm_j), rtol=1e-8)
    np.testing.assert_allclose(tp.np_(zv_t), np.asarray(zv_j), rtol=1e-6)
    _assert_states_close(ft, fj, rtol=1e-7)
    f2, none = tbat.run_active_loop_batch(st, ot, _lik_t, grid, 3, record_moments=False)
    assert none is None
    for a, b in zip(f2[:11], ft[:11]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(f2.gp_l.L.numpy(), ft.gp_l.L.numpy())
    f1, (zm1, _) = tbat.run_active_loop_batch(st, ot, _lik_t, grid, 1, hyper_samples=np.ones((3, 2, 2)))
    assert zm1.shape == (1, 3) and f1.ns.tolist() == [11, 11, 11]


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------


def test_mll_grad_per_problem_data_and_fleet_fused_fit():
    """``mll_grad_batched`` with per-problem data against one call per problem
    (row r on the data of problem r // rows-per-problem; 1e-5, the same float32
    arithmetic with its matrix products batched another way), and a fleet of
    one against the first problem's rows of the fleet of three to the bit. The float32
    fleet fit from given restart rows against ``fit_params_fused`` looped over
    the problems from the same rows: θ to 1e-5 relative."""
    xs, ls = _data(B=3, n=10, seed=4)
    opts = TOptions(dtype="float32", **OPT_KW)
    st = tbat.init_batch(xs, ls, opts, device="cpu", s_tl=0.05, s_l=0.05, **PARAMS)
    gp, x, y, mask = st.gp_log_l, st.x_s, st.tl_s, st.obs_mask
    gen = torch.Generator().manual_seed(5)
    inits = tfit.random_restarts(gen, gp.theta, x, y, mask, 4)
    assert inits.shape == (3, 4, 2)
    np.testing.assert_array_equal(inits[:, 0].numpy(), torch.log(gp.theta).numpy())
    thetas = torch.exp(inits.reshape(-1, 2))
    mll, grad = hk.mll_grad_batched(thetas, gp.s, x, y, mask, jitter=1e-7)
    for i in range(3):
        m1, g1 = hk.mll_grad_batched(thetas[4 * i:4 * i + 4], gp.s[i], x[i], y[i], mask[i], jitter=1e-7)
        np.testing.assert_allclose(mll[4 * i:4 * i + 4].numpy(), m1.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(grad[4 * i:4 * i + 4].numpy(), g1.numpy(), rtol=1e-4, atol=1e-4)
    m_one, g_one = hk.mll_grad_batched(thetas[:4], gp.s[:1], x[:1], y[:1], mask[:1], jitter=1e-7)
    np.testing.assert_array_equal(mll[:4].numpy(), m_one.numpy())  # a problem's rows do not see the others
    np.testing.assert_array_equal(grad[:4].numpy(), g_one.numpy())
    with pytest.raises(ValueError, match="divide"):
        hk.mll_grad_batched(thetas[:5], gp.s, x, y, mask)
    with pytest.raises(ValueError, match="s must be"):
        hk.mll_grad_batched(thetas, gp.s[:2], x, y, mask)

    th_fleet, mll_fleet = tfit.fit_params_fused(gp.theta, gp.s, x, y, mask, gen, inits, n_iter=40)
    assert th_fleet.shape == (3, 2) and mll_fleet.shape == (3,)
    for i in range(3):
        th1, mll1 = tfit.fit_params_fused(gp.theta[i], gp.s[i], x[i], y[i], mask[i], gen, inits[i], n_iter=40)
        np.testing.assert_allclose(th_fleet[i].numpy(), th1.numpy(), rtol=1e-5)
        np.testing.assert_allclose(float(mll_fleet[i]), float(mll1), rtol=1e-5)


def test_fit_batch_routes():
    """float32 takes the fused route for the whole fleet (per-problem hypers
    after it, E[Z] within 5e-3 of each problem's closed form, a seed fixes the
    result to the bit, frozen coordinates bit-identical); float64 advances
    every problem's restart rows in one lock-step L-BFGS (each problem's
    result its own call's, tests/test_torch_fit.py checks) and is held to
    the JAX package's ``fit_batch`` at tests/test_torch_fit.py's rule: the
    port's MLL at its
    fitted hypers is not below the JAX fit's by more than 1e-6 relative, each
    GP in turn on the data the JAX fit left."""
    xs = np.stack([np.linspace(-2.2, 2.2, 10)] * 3)
    ls = np.stack([stats.norm.pdf(xs[i], MUS[i], SIGS[i]) for i in range(3)])
    truths = np.array([stats.norm.pdf(MUS[i], 0.0, np.sqrt(1 + SIGS[i] ** 2)) for i in range(3)])
    fleet = tpubq_torch.BQFleet(xs, ls, device="cpu", dtype="float32", **PARAMS, **OPT_KW)
    assert fleet.fit(seed=0) is fleet and hk.mll_grad_batched.launches == 0
    th = fleet.states.gp_log_l.theta.numpy()
    assert not np.allclose(th[0], th[1])
    assert np.all(np.abs(fleet.Z_mean() - truths) / truths < 5e-3)
    again = tpubq_torch.BQFleet(xs, ls, device="cpu", dtype="float32", **PARAMS, **OPT_KW).fit_hypers(seed=0)
    np.testing.assert_array_equal(again.states.gp_l.theta.numpy(), fleet.states.gp_l.theta.numpy())
    fleet.fit(params=("w",), ntry=3, seed=3)
    np.testing.assert_array_equal(fleet.states.gp_log_l.theta.numpy()[:, 0], th[:, 0])
    assert not np.allclose(fleet.states.gp_log_l.theta.numpy()[:, 1], th[:, 1])
    with pytest.raises(ValueError, match="unknown hyperparameters"):
        fleet.fit(params=("ell",))

    sj, oj, st, ot = _pair(xs[:2], ls[:2])
    fj = jbat.fit_batch(sj, oj, jax.random.PRNGKey(0), ntry=4)
    ft = tbat.fit_batch(st, ot, torch.Generator().manual_seed(0), ntry=4)
    jk, tk = jkern("gaussian")[0], tkern("gaussian")[0]
    for i in range(2):
        one_j, one_t = jax.tree.map(lambda a: a[i], fj), tbq.tree_map(lambda a: a[i], ft)
        for gp_name, x_name, y_j in (("gp_log_l", "x_s", one_j.tl_s),
                                     ("gp_l", "x_sc", jnp.where(one_j.sc_mask, one_j.l_sc, 0.0))):
            gj, gt = getattr(one_j, gp_name), getattr(one_t, gp_name)
            args_j = (gj.s, getattr(one_j, x_name), y_j, gj.mask, 1e-10)
            mll_j = float(jgp.log_mll(jk, gj.theta, *args_j))
            mll_t = float(jgp.log_mll(jk, jnp.asarray(gt.theta.numpy()), *args_j))
            assert mll_t >= mll_j - 1e-6 * abs(mll_j), (gp_name, i, mll_t, mll_j)
        assert float(tgp.log_mll(tk, one_t.gp_log_l.theta, one_t.gp_log_l.s, one_t.x_s, one_t.tl_s,
                                 one_t.obs_mask, 1e-10)) > float(
            tgp.log_mll(tk, torch.tensor(PARAMS["params_tl"], dtype=torch.float64), one_t.gp_log_l.s,
                        one_t.x_s, one_t.tl_s, one_t.obs_mask, 1e-10))
    # the observation noise: only s moves
    noisy = tpubq_torch.BQFleet(xs[:2], ls[:2], device="cpu", **PARAMS, **OPT_KW).fit(params="s", ntry=3, seed=0)
    np.testing.assert_array_equal(noisy.states.gp_log_l.theta.numpy(), np.tile(PARAMS["params_tl"], (2, 1)))
    assert np.all(noisy.states.gp_log_l.s.numpy() > 0)


# ---------------------------------------------------------------------------
# the facade, and states carried across
# ---------------------------------------------------------------------------


def test_bqfleet_surface_and_guard_rails(tmp_path):
    """The facade against the JAX ``BQFleet`` and the single ``BQ`` (float64:
    E[Z] 1e-9), the capacity and duplicate errors, ``from_states`` on an
    unbatched state, health and a checkpoint round trip, and the default
    device."""
    xs = np.stack([tu.make_x(), tu.make_x() + 0.1, tu.make_x() - 0.2])
    ls = np.stack([tu.f_l(x) for x in xs])
    kw = dict(n_candidate=12, candidate_thresh=0.2, x_mean=0.0, x_var=1.0, max_obs=12, **PARAMS)
    fleet = tpubq_torch.BQFleet(xs, ls, device="cpu", **kw)
    import tpubq

    fj = tpubq.BQFleet(xs, ls, **kw)
    assert len(fleet) == 3 and fleet.ns.tolist() == [10, 10, 10]
    assert repr(fleet).startswith("BQFleet(B=3, ns=[10, 10, 10], device=cpu")
    np.testing.assert_allclose(fleet.Z_mean(), fj.Z_mean(), rtol=1e-9)
    np.testing.assert_allclose(fleet.Z_var(), fj.Z_var(), rtol=1e-8)
    bq0 = tpubq_torch.BQ(xs[0], ls[0], device="cpu", **{k: v for k, v in kw.items() if not k.startswith("params")})
    bq0.init(**PARAMS)
    np.testing.assert_allclose(fleet.Z_mean()[0], bq0.Z_mean(), rtol=1e-10)
    grid = np.linspace(-4, 4, 51)
    np.testing.assert_allclose(fleet.expected_squared_mean(grid), fj.expected_squared_mean(grid), rtol=1e-8)
    np.testing.assert_allclose(fleet.expected_Z_var(grid)[0], bq0.expected_Z_var(grid), rtol=1e-8, atol=1e-14)
    x_next = fleet.choose_next(grid)
    np.testing.assert_allclose(x_next, fj.choose_next(grid), rtol=1e-12)
    one = fleet.problem(0)
    assert one.ns.ndim == 0 and np.isfinite(float(tbq.Z_mean(one, fleet.options)))

    with pytest.raises(ValueError, match="positive"):
        fleet.add_observation(x_next, -np.ones(3))
    with pytest.raises(ValueError, match="duplicate"):
        fleet.add_observation(xs[:, :1], ls[:, 0])
    assert fleet.add_observation(x_next, tu.f_l(x_next[:, 0])) is fleet
    assert fleet.ns.tolist() == [11, 11, 11]
    with pytest.raises(ValueError, match="max_obs"):
        fleet.run_active_loop(_lik_t, grid, 2)  # ns = 11, max_obs = 12
    zms, zvs = fleet.run_active_loop(_lik_t, grid, 1)
    assert zms.shape == zvs.shape == (1, 3) and fleet.ns.tolist() == [12, 12, 12]
    assert fleet.run_active_loop(_lik_t, grid, 0, record_moments=False) == (None, None)
    with pytest.raises(ValueError, match="capacity"):
        fleet.add_observation(np.full((3, 1), 3.3), np.ones(3))

    with pytest.raises(ValueError, match="BATCHED"):
        tpubq_torch.BQFleet.from_states(one, fleet.options)
    again = tpubq_torch.BQFleet.from_states(fleet.states, fleet.options, seed=7)
    assert again.device.type == "cpu" and len(again) == 3
    np.testing.assert_array_equal(again.Z_mean(), fleet.Z_mean())
    assert fleet.sample_hypers(n=5, nburn=1, seed=0).shape == (3, 5, 2)
    assert [o.shape for o in fleet.marginalize(n=5, seed=1)] == [(3, 5), (3, 5)]
    assert fleet.choose_next(grid, n=3, seed=2).shape == (3, 1)
    assert [z.shape for z in fleet.run_active_loop(_lik_t, grid, 0, n=3)] == [(0, 3), (0, 3)]
    # health, save and load (tests/test_torch_facade.py holds them to JAX)
    assert fleet.health()["ns"].tolist() == [12, 12, 12]
    path = str(tmp_path / "fleet")
    again.save(path)
    with pytest.raises(IOError, match="exists"):
        again.save(path)
    loaded = tpubq_torch.BQFleet.load(path, device="cpu")
    assert loaded._seed == 7
    np.testing.assert_array_equal(loaded.Z_mean(), fleet.Z_mean())
    with pytest.raises(ValueError, match="unknown options"):
        tpubq_torch.BQFleet(xs, ls, device="cpu", n_candidates=3)
    if not torch.cuda.is_available():  # the card is the default; the CPU must be asked for
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tpubq_torch.BQFleet(xs, ls, **kw)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tbat.init_batch(xs, ls, fleet.options)


def test_fleet_state_and_checkpoint_carry_across(tmp_path):
    """A batched JAX state through ``state_from_numpy`` (every leaf batched, a
    missing ``ok`` defaulting to the batch shape) and a fleet checkpoint of
    ``tpubq.utils.io.save_state`` through ``load_tpubq_npz``: a batched port
    state with K⁻¹ rebuilt from the factor, moments to rtol 1e-9."""
    from tpubq.utils import io as jio

    xs, ls = _data()
    sj, oj, _, ot = _pair(xs, ls)
    zm_j = np.asarray(jbat.Z_mean_batch(sj, oj))
    flat = tp.flat_state(sj)
    flat.pop("gp_l.ok"), flat.pop("gp_log_l.ok"), flat.pop("gp_l.Kinv")
    st = convert.state_from_numpy(flat, ot, "cpu")
    assert st.gp_l.ok.shape == (3,) and bool(st.gp_l.ok.all()) and st.gp_l.Kinv.shape == (3, 26, 26)
    np.testing.assert_allclose(st.gp_l.Kinv.numpy(), np.asarray(sj.gp_l.Kinv), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tbat.Z_mean_batch(st, ot).numpy(), zm_j, rtol=1e-9)
    path = tmp_path / "fleet.npz"
    jio.save_state(path, sj, oj)
    loaded, opts = convert.load_tpubq_npz(path, device="cpu")
    assert opts == ot and loaded.ns.shape == (3,)
    fleet = tpubq_torch.BQFleet.from_states(loaded, opts)
    np.testing.assert_allclose(fleet.Z_mean(), zm_j, rtol=1e-9)
    np.testing.assert_allclose(fleet.Z_var(), np.asarray(jbat.Z_var_batch(sj, oj)), rtol=1e-8)
