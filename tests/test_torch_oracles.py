"""The port against the C++ oracle and the quadrature twins, and the last of
the JAX package's surface.

* ``tpubq_torch.utils.native`` against ``tpubq.utils.native``: bit-identical
  (one source, ``native/bq_native.cpp``, the same flags).
* The port's float64 closed forms and ``expected_squared_mean_xla`` (s = 0)
  against the oracle, at tests/test_native.py's tolerances.
* The five ``approx_*`` twins against JAX's on one grid, for every kernel
  family, at 1e-12; the port's closed forms against the port's twins at the
  JAX suite's tolerances (tests/test_integrals.py, test_matern_zvar.py,
  test_periodic_exact.py; rq at α ≤ 30 on the gaussian's). The single twins
  take the suite's grids; the double ones (an (m, m) product) 2,001 nodes,
  where the trapezoid error of these smooth integrands is still far below
  the tolerances.
* ``expected_squared_mean_fused`` (float32) against JAX's (interpret mode)
  at tests/test_torch_esm.py's rtol 2e-5, and its ``ValueError``s;
  ``batched_cholesky`` at 1e-12; ``BQOptions.np_dtype``; ``native.load()``
  raising when the build fails.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from tpubq.models import acquire as jacq
from tpubq.ops import integrals as jig
from tpubq.ops import linalg as jlin
from tpubq.ops.kernels import get_kernel as jget_kernel
from tpubq.utils import native as jnative
from tpubq.utils.options import BQOptions as JOptions
from tpubq_torch.models import acquire as tacq
from tpubq_torch.ops import _build
from tpubq_torch.ops import integrals as tig
from tpubq_torch.ops import linalg as tlin
from tpubq_torch.ops.kernels import get_kernel
from tpubq_torch.utils import native
from tpubq_torch.utils.options import BQOptions

pytestmark = pytest.mark.skipif(not native.available(), reason="no C++ compiler for the oracle")

H1, W1, H2, W2 = 0.8, 0.7, 1.3, 0.4
MU, S2 = 0.3, 0.9
RNG = np.random.RandomState(5)
X1 = RNG.randn(6)
X2 = RNG.randn(4)
T1P, T2P = (0.9, 0.5, 1.1), (1.2, 0.4, 0.7)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _col(x):
    return _t(x)[:, None]


def _testbed_s0():
    """The float64 testbed at s = 0, the oracle's regime (its κ is h²)."""
    import tpubq_torch

    x = tp.tu.make_x(10)
    bt = tpubq_torch.BQ(x, tp.tu.f_l(x), device="cpu", **tp.options(dtype="float64"))
    bt.init(params_tl=tp.PARAMS_TL, params_l=tp.PARAMS_L)
    return bt.state, bt.options


# every entry point of the oracle with its arguments: (name, args, kwargs)
_NATIVE_CALLS = [
    ("int_K", (X1, H1, W1, MU, S2), {}),
    ("int_int_K", (H1, W1, MU, S2), {}),
    ("int_K1_K2", (X1, X2, H1, W1, H2, W2, MU, S2), {}),
    ("int_int_K1_K2", (X1, X2, H1, W1, H2, W2, MU, S2), {}),
    ("int_K1_int_K2", (X1, H1, W1, H2, W2, MU, S2), {}),
    ("int_K_periodic", (X1, 1.3, 0.45, 0.8, MU, S2), {"nterms": 64}),
    ("int_int_K1_K2_periodic", (X1, X2, T1P, T2P, MU, S2), {"nterms": 80}),
    ("improve_conditioning", (np.exp(-0.5 * (np.array([0.0, 1e-9, 1.0])[:, None]
                                             - np.array([0.0, 1e-9, 1.0])[None, :]) ** 2),), {}),
]


@pytest.mark.parametrize("name,args,kw", _NATIVE_CALLS, ids=[c[0] for c in _NATIVE_CALLS])
def test_native_bit_identical_to_the_jax_loader(name, args, kw):
    want = getattr(jnative, name)(*args, **kw)
    # the port takes CPU tensors as well as numpy arrays
    targs = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    got = getattr(native, name)(*targs, **kw)
    if name == "improve_conditioning":
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] > 0
    else:
        assert np.asarray(got).dtype == np.float64
        np.testing.assert_array_equal(got, want)


def test_native_esm_grid_bit_identical_to_the_jax_loader():
    st, opts = _testbed_s0()
    grid = np.linspace(-3.0, 3.0, 101)
    got = native.esm_grid_state(st, opts, grid)
    m_sc, m_s = st.sc_mask.numpy(), st.obs_mask.numpy()
    want = jnative.esm_grid(
        grid, st.x_sc.numpy()[m_sc, 0], st.gp_l.alpha.numpy()[m_sc], st.gp_l.L.numpy()[np.ix_(m_sc, m_sc)],
        st.x_s.numpy()[m_s, 0], st.gp_log_l.alpha.numpy()[m_s], st.gp_log_l.L.numpy()[np.ix_(m_s, m_s)],
        h_l=float(st.gp_l.theta[0]), w_l=float(st.gp_l.theta[1]), h_tl=float(st.gp_log_l.theta[0]),
        w_tl=float(st.gp_log_l.theta[1]), mu=float(st.x_mean[0]), s2=float(st.x_var[0, 0]),
        gamma=float(st.gamma), thresh=opts.candidate_thresh)
    np.testing.assert_array_equal(got, want)


def test_closed_forms_match_the_oracle():
    mu, S = _t([MU]), _t([[S2]])
    w1, w2 = _t([W1]), _t([W2])
    np.testing.assert_allclose(tig.int_K(_col(X1), H1, w1, mu, S).numpy(), native.int_K(X1, H1, W1, MU, S2),
                               rtol=1e-12)
    np.testing.assert_allclose(float(tig.int_int_K(1, H1, w1, mu, S)), native.int_int_K(H1, W1, MU, S2), rtol=1e-12)
    np.testing.assert_allclose(tig.int_K1_K2(_col(X1), _col(X2), H1, w1, H2, w2, mu, S).numpy(),
                               native.int_K1_K2(X1, X2, H1, W1, H2, W2, MU, S2), rtol=1e-12)
    np.testing.assert_allclose(tig.int_int_K1_K2(_col(X1), _col(X2), H1, w1, H2, w2, mu, S).numpy(),
                               native.int_int_K1_K2(X1, X2, H1, W1, H2, W2, MU, S2), rtol=1e-12)
    np.testing.assert_allclose(tig.int_K1_int_K2(_col(X1), H1, w1, H2, w2, mu, S).numpy(),
                               native.int_K1_int_K2(X1, H1, W1, H2, W2, MU, S2), rtol=1e-12)
    np.testing.assert_allclose(
        tig.int_K_periodic(_col(X1), _t(1.3), _t(0.45), _t(0.8), mu, S, 64).numpy(),
        native.int_K_periodic(X1, 1.3, 0.45, 0.8, MU, S2, nterms=64), rtol=1e-12)
    np.testing.assert_allclose(
        tig.int_int_K1_K2_periodic(_col(X1), _col(X2), tuple(map(_t, T1P)), tuple(map(_t, T2P)), mu, S, 80).numpy(),
        native.int_int_K1_K2_periodic(X1, X2, T1P, T2P, MU, S2, nterms=80), rtol=1e-11, atol=1e-15)


def test_expected_squared_mean_xla_matches_the_oracle():
    st, opts = _testbed_s0()
    grid = np.linspace(-3.0, 3.0, 101)
    got = tacq.expected_squared_mean_xla(st, opts, _t(grid)).numpy()
    np.testing.assert_allclose(got, native.esm_grid_state(st, opts, grid), rtol=1e-8)


# ---------------------------------------------------------------------------
# the quadrature twins
# ---------------------------------------------------------------------------

# (θ1, θ2) per family: tests/test_integrals.py's gaussian, test_matern_zvar.py's
# Matérn, test_periodic_exact.py's cross pair, rq at α = 3 and 20 (≤ 30)
_FAMILY_THETAS = {
    "gaussian": ((H1, W1), (H2, W2)),
    "matern52": ((0.5, 0.45), (0.8, 0.7)),
    "matern32": ((0.5, 0.45), (0.8, 0.7)),
    "periodic": ((1.1, 0.5, 0.9), (0.8, 0.35, 0.6)),
    "rq": ((H1, W1, 3.0), (H2, W2, 20.0)),
}
_TX1 = np.linspace(-1.6, 1.4, 5)[:, None]
_TX2 = np.array([-0.9, 0.3, 1.1])[:, None]
_TMU, _TSIG = np.array([0.1]), np.array([[0.9]])
_DOUBLE_M = 2001


def _port_twins(kernel: str, m_single: int, lo: float, m_double: int = _DOUBLE_M):
    """The port's five twins of ``kernel`` → (int_K, int_int_K, int_K1_K2,
    int_int_K1_K2, int_K1_int_K2) as numpy, the single ones on ``m_single``
    nodes over [lo, −lo], the double ones on ``m_double``."""
    kfn, _ = get_kernel(kernel)
    t1, t2 = map(_t, _FAMILY_THETAS[kernel])
    xs, xd = _t(np.linspace(lo, -lo, m_single)), _t(np.linspace(lo, -lo, m_double))
    mu, S, x1, x2 = _t(_TMU), _t(_TSIG), _t(_TX1), _t(_TX2)
    return tuple(np.asarray(v) for v in (
        tig.approx_int_K(kfn, t1, x1, xs, mu, S),
        tig.approx_int_int_K(kfn, t2, xd, mu, S),
        tig.approx_int_K1_K2(kfn, kfn, t1, t2, x1, x2, xs, mu, S),
        tig.approx_int_int_K1_K2(kfn, kfn, t1, t2, x1, x2, xd, mu, S),
        tig.approx_int_K1_int_K2(kfn, kfn, t1, t2, x1, xd, mu, S),
    ))


@pytest.mark.parametrize("kernel", list(_FAMILY_THETAS))
def test_twins_match_jax(kernel):
    m = 1001
    kj, _ = jget_kernel(kernel)
    t1, t2 = (np.asarray(t) for t in _FAMILY_THETAS[kernel])
    xo = jnp.asarray(np.linspace(-9.0, 9.0, m))
    x1, x2 = jnp.asarray(_TX1), jnp.asarray(_TX2)
    want = (jig.approx_int_K(kj, t1, x1, xo, _TMU, _TSIG),
            jig.approx_int_int_K(kj, t2, xo, _TMU, _TSIG),
            jig.approx_int_K1_K2(kj, kj, t1, t2, x1, x2, xo, _TMU, _TSIG),
            jig.approx_int_int_K1_K2(kj, kj, t1, t2, x1, x2, xo, _TMU, _TSIG),
            jig.approx_int_K1_int_K2(kj, kj, t1, t2, x1, xo, _TMU, _TSIG))
    for got, w in zip(_port_twins(kernel, m, -9.0, m), want):
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-12)


def test_twins_chunk_rows_without_changing_a_sum(monkeypatch):
    """Below the product's size the twins take it in row chunks; each value
    keeps its summation (agreement to rounding, not to the grid's error)."""
    kfn, _ = get_kernel("matern52")
    t1, t2 = map(_t, _FAMILY_THETAS["matern52"])
    xo, mu, S, x1, x2 = _t(np.linspace(-9, 9, 301)), _t(_TMU), _t(_TSIG), _t(_TX1), _t(_TX2)

    def all_five():
        return [tig.approx_int_K(kfn, t1, x1, xo, mu, S), tig.approx_int_int_K(kfn, t2, xo, mu, S),
                tig.approx_int_K1_K2(kfn, kfn, t1, t2, x1, x2, xo, mu, S),
                tig.approx_int_int_K1_K2(kfn, kfn, t1, t2, x1, x2, xo, mu, S),
                tig.approx_int_K1_int_K2(kfn, kfn, t1, t2, x1, xo, mu, S)]

    whole = all_five()
    monkeypatch.setattr(tig, "SWEEP_ELEMS", 64)
    for c, w in zip(all_five(), whole):
        np.testing.assert_allclose(c.numpy(), w.numpy(), rtol=1e-14, atol=0)


def _closed_forms(kernel: str):
    mu, S, x1, x2 = _t(_TMU), _t(_TSIG), _t(_TX1), _t(_TX2)
    (h1, *r1), (h2, *r2) = _FAMILY_THETAS[kernel]
    if kernel == "gaussian":
        w1, w2 = _t(r1), _t(r2)
        return (tig.int_K(x1, h1, w1, mu, S), tig.int_int_K(1, h2, w2, mu, S),
                tig.int_K1_K2(x1, x2, h1, w1, h2, w2, mu, S), tig.int_int_K1_K2(x1, x2, h1, w1, h2, w2, mu, S),
                tig.int_K1_int_K2(x1, h1, w1, h2, w2, mu, S))
    if kernel.startswith("matern"):
        nu = 2.5 if kernel == "matern52" else 1.5
        one_d = tig.int_K_matern52_1d if kernel == "matern52" else tig.int_K_matern32_1d
        w1, w2 = _t(r1), _t(r2)
        return (one_d(x1, _t(h1), w1, mu, S), tig.int_int_K_matern(_t(h2), w2, mu, S, nu),
                tig.int_K1_K2_matern(x1, x2, _t(h1), w1, _t(h2), w2, mu, S, nu),
                tig.int_int_K1_K2_matern(x1, x2, _t(h1), w1, _t(h2), w2, mu, S, nu),
                tig.int_K1_int_K2_matern(x1, _t(h1), w1, _t(h2), w2, mu, S, nu))
    if kernel == "periodic":
        th1, th2 = tuple(map(_t, _FAMILY_THETAS[kernel][0])), tuple(map(_t, _FAMILY_THETAS[kernel][1]))
        return (tig.int_K_periodic(x1, *th1, mu, S, 90), tig.int_int_K_periodic(*th2, mu, S, 90),
                tig.int_K1_K2_periodic(x1, x2, th1, th2, mu, S, 90),
                tig.int_int_K1_K2_periodic(x1, x2, th1, th2, mu, S, 90),
                tig.int_K1_int_K2_periodic(x1, th1, th2, mu, S, 90))
    return (tig.int_K_rq_mixture(x1, _t(h1), _t(r1[:1]), _t(r1[1]), mu, S),)  # rq: int_K only


# (single-twin grid, its half-width, rtol per quantity: int_K, int_int_K, P, T, U)
_CLOSED_VS_TWIN = {
    "gaussian": (8001, 10.0, (1e-6,) * 5),
    "matern52": (6001, 9.0, (2e-6,) * 5),
    "matern32": (6001, 9.0, (2e-6,) * 5),
    "periodic": (40001, 12.0, (1e-9, 1e-7, 1e-7, 1e-6, 1e-6)),
    "rq": (8001, 10.0, (1e-6,)),
}


@pytest.mark.parametrize("kernel", list(_CLOSED_VS_TWIN))
def test_closed_forms_match_the_twins(kernel):
    m, half, rtols = _CLOSED_VS_TWIN[kernel]
    twins = _port_twins(kernel, m, -half)
    for name, exact, twin, rtol in zip(("int_K", "int_int_K", "P", "T", "U"), _closed_forms(kernel), twins, rtols):
        np.testing.assert_allclose(np.asarray(exact), twin, rtol=rtol, err_msg=f"{kernel} {name}")


# ---------------------------------------------------------------------------
# expected_squared_mean_fused, batched_cholesky, np_dtype, the loader's failure
# ---------------------------------------------------------------------------

GRID = np.linspace(-4.0, 4.0, 301)


def test_expected_squared_mean_fused_f32_matches_jax():
    bj, _ = tp.make_pair("float32")
    st, opts = tp.to_torch(bj.state, bj.options)
    grid = GRID.astype(np.float32)
    want = np.asarray(jacq.expected_squared_mean_fused(bj.state, bj.options, jnp.asarray(grid), interpret=True))
    got = tacq.expected_squared_mean_fused(st, opts, torch.as_tensor(grid), interpret=True)
    np.testing.assert_allclose(tp.np_(got), want, rtol=2e-5)
    # on the CPU the route of expected_squared_mean is the same plain twin
    np.testing.assert_array_equal(tp.np_(got), tp.np_(tacq.expected_squared_mean(st, opts, torch.as_tensor(grid))))


@pytest.mark.parametrize("overrides", [dict(dim=4), dict(kernel="matern52")], ids=["d4", "matern52"])
def test_expected_squared_mean_fused_refuses_as_jax(overrides):
    with pytest.raises(ValueError) as ej:
        jacq.expected_squared_mean_fused(None, JOptions(**overrides), GRID)
    with pytest.raises(ValueError) as et:
        tacq.expected_squared_mean_fused(None, BQOptions(**overrides), GRID)
    assert str(et.value) == str(ej.value)


def test_expected_squared_mean_fused_f64_state_gets_the_wrappers_type_error():
    _, bt = tp.make_pair("float64")
    with pytest.raises(TypeError, match="float32"):
        tacq.expected_squared_mean_fused(bt.state, bt.options, GRID)


def test_batched_cholesky_matches_jax():
    rng = np.random.RandomState(4)
    B, n = 5, 7
    A = rng.randn(B, n, n)
    Ks = A @ A.transpose(0, 2, 1) + n * np.eye(n)
    masks = np.arange(n)[None, :] < np.array([7, 5, 3, 1, 6])[:, None]
    want = np.asarray(jlin.batched_cholesky(jnp.asarray(Ks), jnp.asarray(masks)))
    got = tlin.batched_cholesky(_t(Ks), torch.as_tensor(masks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    assert "batched_cholesky" not in tlin.__all__


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_np_dtype(dtype):
    assert BQOptions(dtype=dtype).np_dtype == JOptions(dtype=dtype).np_dtype == np.dtype(dtype)


@pytest.mark.parametrize("cxx", ["tpubq-no-such-compiler", "false"])
def test_load_raises_when_the_build_fails(monkeypatch, tmp_path, cxx):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", cxx)
    with pytest.raises(RuntimeError, match=r"building the C\+\+ oracle failed"):
        native.load()
    assert native._lib is None and not native.available()
    assert not list(tmp_path.iterdir())
