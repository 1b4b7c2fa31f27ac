"""Parity of the port's four other kernel families (matern52, matern32, rq,
periodic) with the JAX package.

Both packages get the same inputs, made with numpy from a seed, in float64
unless a test says otherwise; JAX states are carried into the port with
``tpubq_torch.utils.convert``. The JAX integrals run un-jitted (eager), so the
file compiles few JAX programs: one ``init_state`` per family state and one
``fit_params`` per fitted family. Tolerances (relative unless stated):

  Grams and Kdiag 1e-13; erfcx 2e-7 (float32, against the JAX float32 fit) and
  1e-13 (float64); ive_series 5e-16 absolute (tests/test_periodic_exact.py);
  int_K at d = 1 and 2 1e-12; the Matérn P/Q/T/U 1e-11 and T's symmetric
  sweep against the full one 1e-12 (tests/test_matern_zvar.py); the periodic
  cross family 1e-12; Z_mean / Z_var of a carried state 1e-10; float32 Matérn
  V[Z] against the float64 closed form 1e-4 (tests/test_matern_zvar.py:92);
  ESM scores 1e-9 with the same argmax; the sampler's log density 1e-10.

The family states carry a noise s = 0.01: at s = 0 the periodic recipe's
Gram is so close to singular that the JAX package's own jitted and un-jitted
V[Z] differ by 8.5e-10 (the port's by 8.6e-9), which no 1e-10 comparison of
two implementations can resolve; at s = 0.01 they agree to 2e-11.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import ive

import tpubq
import tpubq_torch
from tests import torch_parity as tp
from tests import util as tu
from tpubq.models import acquire as jacq
from tpubq.models import bq as jbq
from tpubq.models import fit as jfit
from tpubq.models import gp as jgp
from tpubq.models import marginalize as jmarg
from tpubq.ops import integrals as jig
from tpubq.ops import kernels as jker
from tpubq_torch.models import acquire as tacq
from tpubq_torch.models import batched as tbat
from tpubq_torch.models import bq as tbq
from tpubq_torch.models import fit as tfit
from tpubq_torch.models import gp as tgp
from tpubq_torch.models import marginalize as tmarg
from tpubq_torch.ops import integrals as tig
from tpubq_torch.ops import kernels as tker
from tpubq_torch.utils import convert
from tpubq_torch.utils.options import BQOptions

FAMILIES = ("matern52", "matern32", "rq", "periodic")
NU = {"matern52": 2.5, "matern32": 1.5}
GRID = np.linspace(-3.5, 3.5, 141)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _theta(kernel, d, rng):
    """A parameter row of the family: (h, w_1..w_d), with α for rq, (h, w, p)
    for the periodic kernel."""
    if kernel == "periodic":
        return np.array([rng.uniform(0.5, 1.5), rng.uniform(0.5, 1.2), rng.uniform(0.7, 2.0)])
    row = np.concatenate([[rng.uniform(0.5, 1.5)], rng.uniform(0.4, 1.0, d)])
    return np.append(row, rng.uniform(0.7, 4.0)) if kernel == "rq" else row


# ---------------------------------------------------------------------------
# kernels and the special functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", FAMILIES)
def test_grams_and_kdiag_match_jax(kernel):
    """Each family's Gram and Kdiag in float64 at 1e-13, at d = 1 and 2
    (periodic: 1-D), for one θ and for a stack of θ rows (the port's leading
    batch axis, the JAX package's vmap)."""
    rng = np.random.RandomState(0)
    kt, kdt = tker.get_kernel(kernel)
    kj, kdj = jker.get_kernel(kernel)
    for d in (1,) if kernel == "periodic" else (1, 2):
        thetas = np.stack([_theta(kernel, d, rng) for _ in range(3)])
        x1, x2 = rng.uniform(-3, 3, (7, d)), rng.uniform(-3, 3, (5, d))
        got = kt(_t(thetas), _t(x1), _t(x2)).numpy()
        for i, th in enumerate(thetas):
            want = np.asarray(kj(jnp.asarray(th), jnp.asarray(x1), jnp.asarray(x2)))
            np.testing.assert_allclose(got[i], want, rtol=1e-13, atol=0)
            np.testing.assert_allclose(kdt(_t(th), _t(x1)).numpy(), np.asarray(kdj(jnp.asarray(th), jnp.asarray(x1))),
                                       rtol=1e-13)
        assert np.all(np.isfinite(kt(_t(thetas[0]), _t(x1), _t(x1)).numpy()))


def test_get_kernel_covers_every_family_and_the_facade_classes():
    """Every family has a kernel; the facade classes' K is the family's Gram,
    their jacobian and hessian (torch.func.jacfwd) match the JAX package's
    (jax.jacfwd) for the periodic kernel and central differences of K for
    every class."""
    assert set(tker._KERNELS) == set(jker._KERNELS)
    with pytest.raises(ValueError, match="unknown kernel"):
        tker.get_kernel("cosine")
    x1, x2 = np.array([0.1, -0.4, 1.3]), np.array([0.2, 0.9])
    kt = tker.PeriodicKernel(1.1, 0.8, 1.5, device="cpu")
    kj = jker.PeriodicKernel(1.1, 0.8, 1.5)
    np.testing.assert_allclose(kt(x1, x2).numpy(), np.asarray(kj(x1, x2)), rtol=1e-13)
    np.testing.assert_allclose(kt.jacobian(x1, x2).numpy(), np.asarray(kj.jacobian(x1, x2)), rtol=1e-12)
    np.testing.assert_allclose(kt.hessian(x1, x2).numpy(), np.asarray(kj.hessian(x1, x2)), rtol=1e-11, atol=1e-15)
    for cls, args in ((tker.Matern52Kernel, (1.2, 0.7)), (tker.Matern32Kernel, (1.0, 0.5)),
                      (tker.RationalQuadraticKernel, (0.9, 0.6, 2.5)), (tker.GaussianKernel, (1.3, 0.9)), (type(kt), (1.1, 0.8, 1.5))):
        k = cls(*args, device="cpu")
        np.testing.assert_array_equal(k.K(x1, x2).numpy(), tker.get_kernel(k._name)[0](
            _t(args), _t(x1)[:, None], _t(x2)[:, None]).numpy())
        J, H = k.jacobian(x1, x2).numpy(), k.hessian(x1, x2).numpy()
        assert J.shape == (len(args), 3, 2) and H.shape == (len(args), len(args), 3, 2)
        for j in range(len(args)):
            e = 1e-6 * np.eye(len(args))[j]
            kp = cls(*(np.array(args) + e), device="cpu")
            km = cls(*(np.array(args) - e), device="cpu")
            np.testing.assert_allclose(J[j], (kp(x1, x2) - km(x1, x2)).numpy() / 2e-6, rtol=1e-7, atol=1e-9)
            np.testing.assert_allclose(H[j], (kp.jacobian(x1, x2) - km.jacobian(x1, x2)).numpy() / 2e-6,
                                       rtol=1e-6, atol=1e-8)


def test_erfcx_matches_jax():
    u = np.concatenate([np.linspace(0.0, 40.0, 801), [1e-6, 8.999, 9.0, 9.001, 1e3]])
    np.testing.assert_allclose(tig.erfcx(_t(u)).numpy(), np.asarray(jig.erfcx(jnp.asarray(u))), rtol=1e-13)
    u32 = u.astype(np.float32)
    np.testing.assert_allclose(tig.erfcx(_t(u32, torch.float32)).numpy(),
                               np.asarray(jig.erfcx(jnp.asarray(u32))), rtol=2e-7)


def test_ive_series_matches_scipy_per_z_and_over_rows():
    for z in (0.01, 0.5, 6.25, 25.0, 100.0, 400.0):
        N = max(40, int(np.ceil(8.5 * np.sqrt(z))) + 8)
        a = tig.ive_series(_t(z), N).numpy()
        assert np.max(np.abs(a - ive(np.arange(N + 1), z))) < 5e-16, z
    zs = np.array([[0.5, 12.0], [80.0, 3.0]])  # leading axes: rows of z, one recurrence
    a = tig.ive_series(_t(zs), 64).numpy()
    assert a.shape == (2, 2, 65)
    np.testing.assert_allclose(a, ive(np.arange(65), zs[..., None]), rtol=0, atol=5e-16)
    a32 = tig.ive_series(_t(6.25, torch.float32), 48).numpy()
    assert np.max(np.abs(a32 - ive(np.arange(49), 6.25))) < 1e-6


# ---------------------------------------------------------------------------
# the integrals
# ---------------------------------------------------------------------------


def _measure(d, rng):
    A = rng.randn(d, d)
    return rng.randn(d) * 0.3, 0.2 * A @ A.T + 0.8 * np.eye(d)


@pytest.mark.parametrize("kernel,d", [(k, d) for k in FAMILIES for d in (1, 2) if not (k == "periodic" and d == 2)])
def test_int_K_matches_jax_per_row(kernel, d):
    """int_K of each family against the JAX function at 1e-12, for three θ
    rows at once (the port's leading axis) held row by row to JAX."""
    rng = np.random.RandomState(1 + d)
    x = rng.uniform(-2.5, 2.5, (9, d))
    mu, S = _measure(d, rng)
    thetas = np.stack([_theta(kernel, d, rng) for _ in range(3)])
    th = _t(thetas)
    if kernel == "periodic":
        got = tig.int_K_periodic(_t(x), th[:, 0], th[:, 1], th[:, 2], _t(mu), _t(S), 64)
        want = [jig.int_K_periodic(x, *r, mu, S, 64) for r in thetas]
    elif kernel == "rq":
        got = tig.int_K_rq_mixture(_t(x), th[:, 0], th[:, 1:-1], th[:, -1], _t(mu), _t(S))
        want = [jig.int_K_rq_mixture(x, r[0], r[1:-1], r[-1], mu, S) for r in thetas]
    elif d == 1:
        name = f"int_K_{kernel}_1d"
        got = getattr(tig, name)(_t(x), th[:, 0], th[:, 1:], _t(mu), _t(S))
        want = [getattr(jig, name)(x, r[0], r[1:], mu, S) for r in thetas]
    else:
        got = tig.int_K_matern_mixture(_t(x), th[:, 0], th[:, 1:], _t(mu), _t(S), NU[kernel])
        want = [jig.int_K_matern_mixture(x, r[0], r[1:], mu, S, NU[kernel]) for r in thetas]
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(w), rtol=1e-12)


def _jax_cross(x1, x2, h1, w1, h2s, w2s, mu, S, nu):
    """The JAX Matérn cross family as one jitted program (its eager scan costs
    more than the compile): P, Q, U, T and the symmetric T, for each θ_tl row."""
    def one(h2, w2):
        return (jig.int_K1_K2_matern(x1, x2, h1, w1, h2, w2, mu, S, nu), jig.int_int_K_matern(h2, w2, mu, S, nu),
                jig.int_K1_int_K2_matern(x1, h1, w1, h2, w2, mu, S, nu),
                jig.int_int_K1_K2_matern(x1, x2, h1, w1, h2, w2, mu, S, nu),
                jig.int_int_K1_K2_matern(x1, x1, h1, w1, h2, w2, mu, S, nu))
    return [np.asarray(v) for v in jax.jit(jax.vmap(one))(jnp.asarray(h2s), jnp.asarray(w2s))]


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("kernel", ["matern52", "matern32"])
def test_matern_cross_family_matches_jax(kernel, d):
    """P, Q, T and U against JAX at 1e-11; T's symmetric (q, s)-triangle
    sweep (``x1 is x2``) against the full sweep and against its transpose at
    1e-12; and a leading axis of two θ_tl rows held row by row."""
    nu = NU[kernel]
    rng = np.random.RandomState(3)
    x1, x2 = rng.uniform(-1.5, 1.5, (5, d)), rng.uniform(-1.5, 1.5, (3, d))
    mu, S = _measure(d, rng)
    h1, w1 = 0.4, rng.uniform(0.45, 0.7, d)
    h2s = np.array([0.9, 1.3])
    w2s = np.stack([rng.uniform(0.6, 0.9, d), rng.uniform(0.6, 0.9, d)])
    P_j, Q_j, U_j, T_j, Ts_j = _jax_cross(x1, x2, h1, w1, h2s, w2s, mu, S, nu)
    xt = _t(x1)
    for i in range(2):  # one θ_tl row at a time
        a = (_t(h1), _t(w1), _t(h2s[i]), _t(w2s[i]), _t(mu), _t(S))
        np.testing.assert_allclose(tig.int_K1_K2_matern(xt, _t(x2), *a, nu).numpy(), P_j[i], rtol=1e-11)
        np.testing.assert_allclose(float(tig.int_int_K_matern(*a[2:], nu)), Q_j[i], rtol=1e-11)
        np.testing.assert_allclose(tig.int_K1_int_K2_matern(xt, *a, nu).numpy(), U_j[i], rtol=1e-11)
        np.testing.assert_allclose(tig.int_int_K1_K2_matern(xt, _t(x2), *a, nu).numpy(), T_j[i], rtol=1e-11)
        T_sym = tig.int_int_K1_K2_matern(xt, xt, *a, nu).numpy()
        np.testing.assert_allclose(T_sym, Ts_j[i], rtol=1e-11)
        np.testing.assert_allclose(T_sym, tig.int_int_K1_K2_matern(xt, xt.clone(), *a, nu).numpy(), rtol=1e-12)
        np.testing.assert_allclose(T_sym, T_sym.T, rtol=1e-12)
    # both rows at once: the marginalize layout (θ_tl rows against shared points)
    ab = (_t(h1), _t(w1), _t(h2s), _t(w2s), _t(mu), _t(S))
    np.testing.assert_allclose(tig.int_K1_K2_matern(xt, _t(x2), *ab, nu).numpy(), P_j, rtol=1e-11)
    np.testing.assert_allclose(tig.int_int_K_matern(*ab[2:], nu).numpy(), Q_j, rtol=1e-11)
    np.testing.assert_allclose(tig.int_K1_int_K2_matern(xt, *ab, nu).numpy(), U_j, rtol=1e-11)
    np.testing.assert_allclose(tig.int_int_K1_K2_matern(xt, xt, *ab, nu).numpy(), Ts_j, rtol=1e-11)


def test_matern_sweep_chunks_agree(monkeypatch):
    """The node sweeps give the same values whatever the element budget
    cuts them into (one row and one node, or eight pairs, per chunk)."""
    rng = np.random.RandomState(5)
    x = _t(rng.uniform(-1.5, 1.5, (2, 4, 1)))
    a = (_t([0.4, 0.5]), _t([[0.5], [0.6]]), _t([0.9, 1.1]), _t([[0.7], [0.8]]), _t([0.1]), _t([[0.9]]), 2.5)
    whole = [f(*args) for f, args in ((tig.int_K1_K2_matern, (x, x[:, :3]) + a),
                                      (tig.int_int_K1_K2_matern, (x, x) + a),
                                      (tig.int_K1_int_K2_matern, (x,) + a))]
    monkeypatch.setattr(tig, "SWEEP_ELEMS", 1)
    cut = [f(*args) for f, args in ((tig.int_K1_K2_matern, (x, x[:, :3]) + a),
                                    (tig.int_int_K1_K2_matern, (x, x) + a),
                                    (tig.int_K1_int_K2_matern, (x,) + a))]
    for w, c in zip(whole, cut):
        np.testing.assert_allclose(c.numpy(), w.numpy(), rtol=1e-13)


def test_periodic_cross_family_matches_jax():
    rng = np.random.RandomState(4)
    x1, x2 = rng.uniform(-2, 2, (6, 1)), rng.uniform(-2, 2, (4, 1))
    mu, S = np.array([0.3]), np.array([[1.5]])
    t1, t2 = (1.3, 0.4, 0.7), (0.8, 0.9, 1.7)
    tt1, tt2 = tuple(_t(v) for v in t1), tuple(_t(v) for v in t2)
    m, s = _t(mu), _t(S)
    for got, want in (
        (tig.int_int_K_periodic(*tt1, m, s, 64), jig.int_int_K_periodic(*t1, mu, S, 64)),
        (tig.int_K1_K2_periodic(_t(x1), _t(x2), tt1, tt2, m, s, 64), jig.int_K1_K2_periodic(x1, x2, t1, t2, mu, S, 64)),
        (tig.int_int_K1_K2_periodic(_t(x1), _t(x2), tt1, tt2, m, s, 64),
         jig.int_int_K1_K2_periodic(x1, x2, t1, t2, mu, S, 64)),
        (tig.int_K1_int_K2_periodic(_t(x1), tt1, tt2, m, s, 64), jig.int_K1_int_K2_periodic(x1, t1, t2, mu, S, 64)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-300)


def test_rq_mix_rule_follows_alpha_rows():
    alphas = np.array([0.5, 2.0, 30.0])
    s2, w = tig.rq_mix_rule(_t(alphas))
    assert s2.shape == w.shape == (3, tig.RQ_MIX_NODES)
    for i, a in enumerate(alphas):
        s2j, wj = jig.rq_mix_rule(jnp.float64(a))
        np.testing.assert_allclose(s2[i].numpy(), np.asarray(s2j), rtol=1e-12)
        np.testing.assert_allclose(w[i].numpy(), np.asarray(wj), rtol=1e-12, atol=1e-15)


def _rq_corr(alpha, r2):
    """The exact rq correlation (1 + r²/(2α))^{−α}."""
    return np.exp(-alpha * np.log1p(r2 / (2.0 * alpha)))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 2e-9), (torch.float32, 2e-7)])
def test_rq_mix_rule_meets_the_exact_correlation(dtype, tol):
    """The rule's mixture against the exact correlation over r/w ∈ [0, 12]
    at the bound its docstring states, from α = 0.5 to the gaussian limit
    that fits on smooth data reach (10⁵ on the card; the JAX package's rule
    is wrong from α ~ 10³ on, so nothing but the exact correlation holds the
    port there)."""
    r2 = np.linspace(0.0, 12.0, 2001) ** 2
    for a in (0.5, 1.0, 8.0, 128.0, 1e3, 1e4, 1e5, 1e6, 1e8, 1e12, 1e30):
        s2, w = (t.double().numpy() for t in tig.rq_mix_rule(torch.tensor(a, dtype=dtype)))
        mix = (w * np.exp(-0.5 * r2[:, None] / s2)).sum(-1)
        assert np.abs(mix - _rq_corr(a, r2)).max() <= tol, a


@pytest.mark.parametrize("alpha", [1e3, 1e4, 1e5])
@pytest.mark.parametrize("d", [1, 2])
def test_rq_int_K_at_large_alpha_meets_quadrature(d, alpha):
    """int_K_rq_mixture where only the port's rule holds (α ≥ 10³), against
    an independent quadrature of k_rq · N(x; μ, Σ) in float64: scipy's quad
    in 1-D, a 160² Gauss–Hermite product over Σ's Cholesky factor in 2-D
    (it changes by ≤ 1e-11 from 100²). The bound is the rule's 2e-9 absolute
    correlation error times h². And rq_K against the JAX package's power form,
    which float64 still evaluates there, to the α·ε that rounding its base
    1 + r²/(2α) costs."""
    from numpy.polynomial.hermite_e import hermegauss
    from scipy import integrate

    rng = np.random.RandomState(int(np.log10(alpha)) + 10 * d)
    x = rng.uniform(-2.5, 2.5, (6, d))
    h, w = 1.3, rng.uniform(0.3, 1.0, d)
    mu, S = _measure(d, rng)
    got = tig.int_K_rq_mixture(_t(x), _t(h), _t(w), _t(alpha), _t(mu), _t(S)).numpy()
    if d == 1:
        sd = np.sqrt(S[0, 0])

        def f(u, xi):
            return h * h * _rq_corr(alpha, ((u - xi) / w[0]) ** 2) * np.exp(-0.5 * ((u - mu[0]) / sd) ** 2)

        want = np.array([integrate.quad(f, mu[0] - 14 * sd, mu[0] + 14 * sd, args=(xi,), points=[xi],
                                        epsabs=1e-15, epsrel=1e-13, limit=500)[0] for xi in x[:, 0]])
        want /= sd * np.sqrt(2 * np.pi)
    else:
        z, wz = hermegauss(160)
        wz = wz / wz.sum()
        z2 = np.stack(np.meshgrid(z, z, indexing="ij"), -1).reshape(-1, 2)
        pts = mu + z2 @ np.linalg.cholesky(S).T
        want = np.array([(np.outer(wz, wz).ravel() * h * h * _rq_corr(alpha, (((pts - xi) / w) ** 2).sum(-1))).sum()
                         for xi in x])
    assert np.abs(got - want).max() <= 2e-9 * h * h
    th = np.concatenate([[h], w, [alpha]])
    xs = rng.uniform(-3, 3, (7, d))
    want_k = np.asarray(jker.rq_K(jnp.asarray(th), jnp.asarray(xs), jnp.asarray(xs)))
    assert np.all(np.isfinite(want_k))
    np.testing.assert_allclose(tker.rq_K(_t(th), _t(xs), _t(xs)).numpy(), want_k, rtol=alpha * 2.2e-16 + 1e-14)


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------

PARAMS = {k: tp.FAMILY_PARAMS[k] for k in FAMILIES}
U_ROWS = 3  # θ_tl rows of the log-density and marginalize checks


def _family_data(kernel):
    """(x, ℓ, options): the testbed of tests/util.py, and the periodic recipe
    of tests/test_periodic_exact.py for the periodic kernel."""
    if kernel == "periodic":
        x = np.linspace(-2.0, 2.0, 9)
        return x, np.exp(np.cos(2.0 * x)) / 8.0 + 0.05, dict(n_candidate=8, candidate_thresh=0.2, max_obs=16,
                                                              x_mean=0.0, x_var=1.0)
    x = tu.make_x(10)
    return x, tu.f_l(x), dict(tu.DEFAULT_OPTIONS, max_obs=12, n_candidate=8)


def _u_rows(theta, seed=2):
    rng = np.random.RandomState(seed)
    return np.log(np.asarray(theta)) + 0.1 * rng.randn(U_ROWS, len(theta))


def _jax_reference(sj, oj, kernel, grid):
    """Everything the estimator tests hold the port to, from the JAX package
    in ONE jitted program per state (its eager dispatch of the Matérn sweep
    costs several times the compile): E[Z], V[Z], the scores on ``grid`` and
    the pick, and the log density at ``_u_rows`` θ_tl rows."""
    kfn, _ = jker.get_kernel(kernel)
    u = jnp.asarray(_u_rows(sj.gp_log_l.theta))

    def ref(st, g, u):
        tl = st.gp_log_l
        esm = jacq.expected_squared_mean(st, oj, g)
        x_next, _ = jacq.choose_next(st, oj, g)
        lp = jax.vmap(lambda r: jgp.log_mll(kfn, jnp.exp(r), tl.s, st.x_s, st.tl_s, st.obs_mask, oj.base_jitter)
                      - 0.5 * jnp.sum((r / jmarg._PRIOR_STD) ** 2))(u)
        return jbq.Z_mean(st, oj), jbq.Z_var(st, oj), esm, x_next, lp

    out = jax.jit(ref)(sj, jnp.asarray(grid), u)
    return jax.tree_util.tree_map(np.asarray, out), np.asarray(u)


_PAIRS = {}


def _pair(kernel):
    """(JAX BQ, its state carried into the port, port options, port BQ on the
    same raw data, the JAX reference values), built once per family."""
    if kernel not in _PAIRS:
        x, l, opts = _family_data(kernel)
        ptl, pl = PARAMS[kernel]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # rq at these widths warns of the GH floor, in both packages
            bj, bt = tp.make_pair("float64", x=x, l=l, kernel=kernel, params_tl=ptl, params_l=pl, s=0.01, **opts)
        st, ot = tp.to_torch(bj.state, bj.options)
        _PAIRS[kernel] = (bj, st, ot, bt, _jax_reference(bj.state, bj.options, kernel, GRID))
    return _PAIRS[kernel]


@pytest.mark.parametrize("kernel", FAMILIES)
def test_z_moments_of_a_carried_state_match_jax(kernel):
    """E[Z] and V[Z] of the JAX state carried across, and of the port's own
    init on the same raw data, at 1e-10; V[Z] takes the family's route."""
    bj, st, ot, bt, ((zm, zv, *_), _) = _pair(kernel)
    np.testing.assert_allclose(float(tbq.Z_mean(st, ot)), zm, rtol=1e-10)
    np.testing.assert_allclose(float(tbq.Z_var(st, ot)), zv, rtol=1e-10)
    np.testing.assert_allclose(bt.Z_mean(), zm, rtol=1e-10)
    np.testing.assert_allclose(bt.Z_var(), zv, rtol=1e-10)
    for dtype in ("float64", "float32"):
        for d in (1,) if kernel == "periodic" else (1, 4):
            o_t, o_j = BQOptions(kernel=kernel, dtype=dtype, dim=d), tpubq.BQOptions(kernel=kernel, dtype=dtype, dim=d)
            assert tbq._z_var_dispatch(o_t).__name__ == jbq._z_var_dispatch(o_j).__name__


@pytest.mark.parametrize("kernel", FAMILIES)
def test_esm_scores_and_pick_match_jax(kernel):
    _, st, ot, _, ((_, _, esm, x_next, _), _) = _pair(kernel)
    np.testing.assert_allclose(tacq.expected_squared_mean(st, ot, _t(GRID)).numpy(), esm, rtol=1e-9)
    xt, _ = tacq.choose_next(st, ot, _t(GRID))
    assert float(xt[0]) == float(x_next[0])
    assert tacq.esm_route(st, ot) == "plain"


def _marginalize_vs_rows(st, ot, u):
    """marginalize on θ_tl rows (one batch: the rows are a leading axis of
    every integral, the Matérn sweep included) against each row installed
    alone, at 1e-10."""
    zm, zv = tmarg.marginalize(st, ot, _t(np.exp(u)))
    for i, r in enumerate(np.exp(u)):
        st_i = tbq.set_params(st, ot, theta_tl=_t(r))
        np.testing.assert_allclose(float(zm[i]), float(tbq.Z_mean(st_i, ot)), rtol=1e-10)
        np.testing.assert_allclose(float(zv[i]), float(tbq.Z_var(st_i, ot)), rtol=1e-10)


@pytest.mark.parametrize("kernel", FAMILIES)
def test_log_density_and_marginalize_match_jax(kernel):
    """The sampler's log density on θ_tl rows against JAX at 1e-10, and
    marginalize on the same rows against the rows one at a time."""
    _, st, ot, _, ((_, _, _, _, lp), u) = _pair(kernel)
    np.testing.assert_allclose(tmarg.log_density(st, ot)(_t(u)).numpy(), lp, rtol=1e-10)
    _marginalize_vs_rows(st, ot, u)


def test_matern52_2d_slice_matches_jax():
    """d = 2 takes the Gamma-mixture route (Z_mean, the fused T sweep of V[Z],
    the scores, marginalize): a small 2-D state carried across, at the
    tolerances above."""
    rng = np.random.RandomState(6)
    x = rng.uniform(-1.5, 1.5, (6, 2))
    l = np.exp(-0.5 * np.sum((x - 0.2) ** 2, -1) / 0.5) + 0.01
    kw = dict(kernel="matern52", n_candidate=4, candidate_thresh=0.2, max_obs=8, x_var=np.eye(2), s=0.01)
    bj = tpubq.BQ(x, l, **kw).init(params_tl=(0.7, 0.9, 0.8), params_l=(0.3, 0.5, 0.6))
    st, ot = tp.to_torch(bj.state, bj.options)
    g = rng.uniform(-2, 2, (30, 2))
    (zm, zv, esm, x_next, lp), u = _jax_reference(bj.state, bj.options, "matern52", g)
    np.testing.assert_allclose(float(tbq.Z_mean(st, ot)), zm, rtol=1e-10)
    np.testing.assert_allclose(float(tbq.Z_var(st, ot)), zv, rtol=1e-10)
    np.testing.assert_allclose(tacq.expected_squared_mean(st, ot, _t(g)).numpy(), esm, rtol=1e-9)
    np.testing.assert_array_equal(tacq.choose_next(st, ot, _t(g))[0].numpy(), x_next)
    np.testing.assert_allclose(tmarg.log_density(st, ot)(_t(u)).numpy(), lp, rtol=1e-10)
    _marginalize_vs_rows(st, ot, u[:2])


@pytest.mark.parametrize("d,w", [(1, 0.8), (1, 0.2), (2, 0.4)])
def test_f32_matern_z_var_meets_the_closed_form(d, w):
    """float32 Matérn V[Z] takes the closed form and stays within 1e-4 of the
    float64 value (the pin of tests/test_matern_zvar.py:92, at its widths;
    2-D on fewer points), in the port alone on the same raw data."""
    rng = np.random.RandomState(0)
    n = 10 if d == 1 else 6
    X = np.sort(rng.uniform(-2.5, 2.5, (n, d)), axis=0)
    L = np.exp(-0.5 * np.sum((X - 0.2) ** 2, -1) / 0.25)

    def z_var(dtype):
        opts = BQOptions(kernel="matern52", dim=d, n_candidate=12 if d == 1 else 4, max_obs=n,
                         candidate_thresh=min(0.2, w / 2), dtype=dtype)
        st = tbq.init_state(X, L, opts, params_tl=(0.7,) + (w,) * d, params_l=(0.3,) + (w / 2,) * d,
                            x_mean=np.zeros(d), x_var=np.eye(d), device="cpu")
        assert tbq._z_var_dispatch(opts) is tbq.Z_var_exact_terms
        return float(tbq.Z_var(st, opts))

    ref = z_var("float64")
    assert abs(z_var("float32") - ref) / ref < 1e-4


# ---------------------------------------------------------------------------
# fit, names, warnings, the fleet, checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["periodic", "rq"])
def test_fit_params_reaches_the_jax_optimum(kernel):
    """Restart rows drawn once by the JAX ``random_restarts`` (the family's
    own seeding) and handed to both packages' L-BFGS (30 iterations): the
    port's best MLL is not below JAX's by more than 1e-6 relative."""
    bj, st, _, _, _ = _pair(kernel)
    sj = bj.state
    xj, yj, mj = sj.x_s, sj.tl_s, sj.obs_mask
    theta0 = np.array(sj.gp_log_l.theta)
    inits = np.array(jfit.random_restarts(jax.random.PRNGKey(0), jnp.asarray(theta0), xj, yj, mj, 6, kernel=kernel))
    _, mll_j = jfit.fit_params(kernel, jnp.asarray(theta0), 0.01, xj, yj, mj, jax.random.PRNGKey(0),
                               jnp.asarray(inits), n_iter=30)
    th_t, mll_t = tfit.fit_params(kernel, theta0, 0.01, st.x_s, st.tl_s, st.obs_mask, torch.Generator(),
                                  inits, n_iter=30)
    assert float(mll_t) >= float(mll_j) - 1e-6 * abs(float(mll_j))
    assert th_t.shape == (3,) and bool(torch.isfinite(th_t).all())


def test_random_restarts_periodic_and_rq_ranges():
    """The port's own seeding (tests/test_fit.py:65): periodic w in
    [0.1, 2], its period between the spacing and twice the range; rq's α in
    [0.5, 4]; a leading problem axis draws every problem in one call."""
    x = _t(np.linspace(0.0, 50.0, 32))[:, None]
    y = torch.sin(x[:, 0])
    mask = torch.ones(32, dtype=torch.bool)
    u = tfit.random_restarts(torch.Generator().manual_seed(0), torch.ones(3), x, y, mask, 64, kernel="periodic")
    th = np.exp(u[1:].numpy())
    assert th[:, 1].max() <= 2.0 + 1e-6 and th[:, 1].min() >= 0.1 - 1e-6
    spacing = 50.0 / 31.0
    assert th[:, 2].min() >= spacing - 1e-6 and th[:, 2].max() <= 100.0 + 1e-6
    u = tfit.random_restarts(torch.Generator().manual_seed(0), torch.ones(3), x, y, mask, 64, kernel="rq")
    th = np.exp(u[1:].numpy())
    assert th[:, 2].min() >= 0.5 - 1e-9 and th[:, 2].max() <= 4.0 + 1e-9
    assert th[:, 1].min() >= 0.05 * 50 - 1e-6 and th[:, 1].max() <= 2.0 * 50 + 1e-6
    xb, yb, mb = x.expand(2, 32, 1) * _t([1.0, 2.0])[:, None, None], y.expand(2, 32), mask.expand(2, 32)
    ub = tfit.random_restarts(torch.Generator().manual_seed(1), torch.ones(2, 3), xb, yb, mb, 16, kernel="periodic")
    assert ub.shape == (2, 16, 3)
    assert np.exp(ub[1, 1:, 2].numpy()).max() <= 200.0 + 1e-6


def test_names_theta_layouts_and_param_coords():
    for kernel, names in (("periodic", {"h": (0,), "w": (1,), "p": (2,)}),
                          ("rq", {"h": (0,), "w": (1, 2), "alpha": (3,)}), ("matern32", {"h": (0,), "w": (1, 2)})):
        d = 1 if kernel == "periodic" else 2
        ot, oj = BQOptions(kernel=kernel, dim=d), tpubq.BQOptions(kernel=kernel, dim=d)
        assert tmarg._names_for(ot) == jmarg._names_for(oj) == names
        assert tbq.theta_len(ot) == jbq.theta_len(oj)
        params = ("p" if kernel == "periodic" else "h", "h_l")
        assert tmarg.param_coords(params, ot) == jmarg.param_coords(params, oj)
    assert tmarg.param_coords(("alpha", "alpha_l"), BQOptions(kernel="rq")) == ((2, 5), True)
    assert tmarg.param_coords(("p",), BQOptions(kernel="periodic")) == ((2,), False)
    with pytest.raises(ValueError, match="1-D only"):
        tbq.validate_theta((1.0, 1.0, 1.0), BQOptions(kernel="periodic", dim=2))
    with pytest.raises(ValueError, match=r"\(h, w_1..w_d, alpha\)"):
        tbq.validate_theta((1.0, 1.0), BQOptions(kernel="rq"))
    assert tbq.periodic_series_floor((1.0, 0.1, 1.0)) == jbq.periodic_series_floor((1.0, 0.1, 1.0)) == 93
    for th, v in (((1.0, 0.25, 0.5), 1.0), ((1.0, 1.0, 0.25), 1.0)):
        assert tbq.periodic_gh_floor(th, v) == jbq.periodic_gh_floor(th, v)
    for th, v in (((1.0, 0.25, 2.0), 1.0), ((1.0, 0.5, 1.0, 2.0), np.eye(2))):
        assert tbq.rq_gh_floor(th, v) == jbq.rq_gh_floor(th, v)
    assert tbq.RQ_ALPHA_FLOOR == jbq.RQ_ALPHA_FLOOR


def _warns(make, match):
    with pytest.warns(UserWarning, match=match):
        make()


def _silent(make):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make()


def test_resolution_warnings_fire_as_in_jax():
    """The cases of tests/test_bq.py:979 (periodic) and :1125 (rq) on the
    port's facade, a sampled batch naming its fraction and context, and the
    three calls that check their sampled rows."""
    x = np.linspace(-2.0, 2.0, 9)
    kw = dict(n_candidate=6, candidate_thresh=0.2, x_mean=0.0, x_var=1.0, max_obs=16, device="cpu")
    lp = np.exp(np.cos(x)) + 0.01
    per = dict(kernel="periodic", **kw)
    _silent(lambda: tpubq_torch.BQ(x, lp, **per).init(params_tl=(1.0, 1.0, 0.25), params_l=(1.0, 1.0, 0.25)))
    _warns(lambda: tpubq_torch.BQ(x, lp, dtype="float32", **per).init(
        params_tl=(1.0, 1.0, 0.25), params_l=(1.0, 1.0, 0.25)), "GH resolution")
    _warns(lambda: tpubq_torch.BQ(x, lp, **per).init(params_tl=(1.0, 0.1, 1.0), params_l=(1.0, 1.0, 1.0)),
           "harmonic-series")
    lr = np.exp(-0.5 * x**2) + 0.01
    rq = dict(kernel="rq", **kw)
    _silent(lambda: tpubq_torch.BQ(x, lr, **rq).init(params_tl=(1.0, 1.0, 2.0), params_l=(1.0, 1.0, 2.0)))
    _warns(lambda: tpubq_torch.BQ(x, lr, **rq).init(params_tl=(1.0, 0.2, 2.0), params_l=(1.0, 1.0, 2.0)),
           "GH resolution")
    _warns(lambda: tpubq_torch.BQ(x, lr, **rq).init(params_tl=(1.0, 1.0, 0.3), params_l=(1.0, 1.0, 2.0)),
           "rq shape")
    bq = tpubq_torch.BQ(x, lp, **per).init(params_tl=(1.0, 1.0, 1.0), params_l=(1.0, 1.0, 1.0))
    with pytest.warns(UserWarning, match=r"50% of the 2 hyper rows \(marginalize\)"):
        bq._warn_resolution(sampled=np.array([[1.0, 1.0, 1.0], [1.0, 0.1, 1.0]]), context="marginalize")
    seen = []
    bq._warn_resolution = lambda sampled=None, context="": seen.append((np.shape(sampled), context))
    bq.sample_hypers(n=4, nburn=1, seed=0)
    bq.marginalize(n=3, seed=1)
    bq.choose_next(GRID, n=2, seed=2)
    assert seen == [((4, 3), "sample_hypers"), ((3, 3), "marginalize"), ((2, 3), "choose_next")]


@pytest.mark.parametrize("kernel", FAMILIES)
def test_fleet_of_three_equals_three_singles(kernel):
    """A BQFleet with B = 3 per family against three single BQs of the port
    on the same data (float64, 1e-10): moments, scores, picks, one step, and
    marginalize on (3, 2, p) θ_tl rows (the fleet's (B, S) row layout through
    the family's integrals) against each problem's own rows."""
    x, l, opts = _family_data(kernel)
    ptl, pl = PARAMS[kernel]
    xs = np.stack([x * c + o for c, o in ((1.0, 0.07), (0.8, -0.05), (1.25, 0.11))])
    ls = np.stack([l, l, l])
    kw = {**opts, "kernel": kernel, "s": 0.01, "device": "cpu"}
    grid = GRID[::2]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fleet = tpubq_torch.BQFleet(xs, ls, params_tl=ptl, params_l=pl, **kw)
        singles = [tpubq_torch.BQ(xs[i], ls[i], **kw).init(params_tl=ptl, params_l=pl) for i in range(3)]
    np.testing.assert_allclose(fleet.Z_mean(), [b.Z_mean() for b in singles], rtol=1e-10)
    np.testing.assert_allclose(fleet.Z_var(), [b.Z_var() for b in singles], rtol=1e-10)
    esm = fleet.expected_squared_mean(grid)
    for i, b in enumerate(singles):
        np.testing.assert_allclose(esm[i], b.expected_squared_mean(grid), rtol=1e-10)
    picks = fleet.choose_next(grid)
    assert [float(p[0]) for p in picks] == [b.choose_next(grid) for b in singles]
    rows = np.exp(np.log(ptl) + 0.1 * np.random.RandomState(3).randn(3, 2, len(ptl)))
    zm, zv = tbat.marginalize_batch(fleet.states, fleet.options, _t(rows))
    for i in range(3):
        zm1, zv1 = tmarg.marginalize(fleet.problem(i), fleet.options, _t(rows[i]))
        np.testing.assert_allclose(zm[i].numpy(), zm1.numpy(), rtol=1e-10)
        np.testing.assert_allclose(zv[i].numpy(), zv1.numpy(), rtol=1e-10)
    ln = np.array([0.3, 0.2, 0.25])
    fleet.add_observation(picks, ln)
    for i, b in enumerate(singles):
        b.add_observation(float(picks[i, 0]), ln[i])
    np.testing.assert_allclose(fleet.Z_mean(), [b.Z_mean() for b in singles], rtol=1e-10)


def test_jax_matern52_checkpoint_loads(tmp_path):
    bj, _, _, _, ((zm, zv, *_), _) = _pair("matern52")
    path = tmp_path / "matern52.npz"
    bj.save(str(path))
    st, opts = convert.load_tpubq_npz(path, device="cpu")
    assert opts.kernel == "matern52"
    np.testing.assert_allclose(float(tbq.Z_mean(st, opts)), zm, rtol=1e-10)
    np.testing.assert_allclose(float(tbq.Z_var(st, opts)), zv, rtol=1e-10)


@pytest.mark.parametrize("kernel", FAMILIES)
def test_facade_paths_run_for_every_family(kernel):
    """fit_hypers → Z → choose_next / add_observation → marginalize and
    choose_next(n > 0) on the port's facade in float32 (CPU, small): finite
    estimates, V[Z] ≥ 0, a grid point picked, the fit not below the
    incumbent's MLL."""
    x, l, opts = _family_data(kernel)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bq = tpubq_torch.BQ(x, l, device="cpu", dtype="float32", s=0.01, kernel=kernel, **opts)
        bq.init(params_tl=PARAMS[kernel][0], params_l=PARAMS[kernel][1])
        st0 = bq.state
        bq.fit_hypers(ntry=2, seed=0)
        kfn, _ = tker.get_kernel(kernel)
        g = st0.gp_log_l
        mll = [float(tgp.log_mll(kfn, th, g.s, st0.x_s, st0.tl_s, st0.obs_mask, 1e-10))
               for th in (g.theta, bq.state.gp_log_l.theta)]
        zm, zv = bq.Z_mean(), bq.Z_var()
        xn = bq.choose_next(GRID)
        bq.add_observation(xn, float(np.interp(xn, x, l)))
        zms, zvs = bq.marginalize(n=2, seed=1)
        xm = bq.choose_next(GRID, n=2, seed=2)
    assert mll[1] >= mll[0] - 1e-3 * abs(mll[0])
    assert np.isfinite(zm) and zv >= 0.0 and np.all(np.isfinite(zms)) and np.all(zvs >= 0.0)
    assert np.min(np.abs(GRID - xn)) < 1e-6 and np.min(np.abs(GRID - xm)) < 1e-6


def test_marg_chunk_counts_the_integrals_node_axis():
    """``choose_next_marg_batch``'s rows per chunk: the plain scorer's
    (B·S_chunk, G) integrals carry a node axis for the mixtures and the
    series, which the element budget counts."""
    B, S, G = 64, 100, 10_000
    base = tbat.marg_chunk(B, S, G, BQOptions(kernel="matern52", max_obs=32, n_candidate=12))
    assert base == tbat._MARG_CHUNK_ELEMS // (B * G * 44)
    for kernel, d, nodes in (("rq", 1, tig.RQ_MIX_NODES), ("periodic", 1, 64), ("matern32", 2, 80 * 2)):
        opts = BQOptions(kernel=kernel, dim=d, max_obs=32, n_candidate=12)
        assert tbq.int_K_nodes(opts) == nodes
        assert tbat.marg_chunk(B, S, G, opts) == max(1, tbat._MARG_CHUNK_ELEMS // (B * G * nodes)) < base


def _f32_guard(st, ot, x):
    """(γ_s, the float32 guard's floor) of the plain scorer at points ``x``,
    term for term as ``acquire._esm_affine_terms`` forms them."""
    kfn, kdiagfn = tker.get_kernel(ot.kernel)
    gp_l, m = st.gp_l, st.sc_mask.to(st.x_s.dtype)
    k_a = kfn(gp_l.theta, st.x_sc, x) * m[:, None]
    kappa = kdiagfn(gp_l.theta, x) + gp_l.s * gp_l.s + gp_l.jitter
    gam = kappa - (k_a * (gp_l.Kinv @ k_a)).sum(0)
    rho = gp_l.Kinv.abs().sum(-1).amax()
    floor = torch.maximum(torch.finfo(x.dtype).eps * kappa, tacq._LAM_F32 * rho * kappa * k_a.sum(0))
    return gam, floor


def test_fitted_periodic_f32_scorer_demotes_as_jax_does():
    """ROADMAP §3 item 2 settled: the periodic recipe with the port's float64
    fitted hypers (the fit settles on the data's period, p ≈ 0.499) leaves the
    float32 scorer no resolved grid point in the JAX package as in the port.
    The JAX float32 state is carried into the port (K⁻¹ included); the plain
    float32 scorers' degenerate masks agree (a flip only at a γ_s within the
    guard's own band, |γ_s − floor| ≤ floor, at most 5) and so do the picks,
    while the float64 guard still resolves points at the same hypers: a
    float32 limit of the reference, not a fault of the port."""
    x = np.linspace(-2.2, 2.2, 10)
    l = np.exp(np.cos(2.0 * x)) / 8.0 + 0.05
    kw = dict(kernel="periodic", max_obs=32, n_candidate=12, candidate_thresh=0.2, x_mean=0.0, x_var=1.0, s=0.01)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the fitted period warns of the series floor, in both packages
        b64 = tpubq_torch.BQ(x, l, device="cpu", dtype="float64", **kw).init(params_tl=PARAMS["periodic"][0],
                                                                            params_l=PARAMS["periodic"][1])
        b64.fit_hypers(seed=11)
        th_tl, th_l = (tuple(g.theta.tolist()) for g in (b64.state.gp_log_l, b64.state.gp_l))
        assert abs(th_tl[2] - 0.5) < 0.01
        bj = tpubq.BQ(x, l, dtype="float32", **kw).init(params_tl=th_tl, params_l=th_l)
    st, ot = tp.to_torch(bj.state, bj.options)
    grid = np.linspace(-4.0, 4.0, 2001)[:, None]
    deg_j = np.asarray(jax.jit(lambda s, g: jacq._esm_affine_terms(s, bj.options, g)[2])(
        bj.state, jnp.asarray(grid, jnp.float32)))
    gt = _t(grid, torch.float32)
    deg_t = tacq._esm_affine_terms(st, ot, gt)[2].numpy()
    flips = np.nonzero(deg_j != deg_t)[0]
    gam, floor = _f32_guard(st, ot, gt[flips])
    assert len(flips) <= 5 and bool(((gam - floor).abs() <= floor).all())
    assert deg_t.all() and deg_j.all()
    xj, _ = jacq.choose_next(bj.state, bj.options, jnp.asarray(grid, jnp.float32))
    xt, _ = tacq.choose_next(st, ot, gt)
    assert float(xt[0]) == float(np.asarray(xj)[0])
    deg64 = tacq._esm_affine_terms(b64.state, b64.options, _t(grid))[2]
    assert 0 < int((~deg64).sum()) < len(grid)
