"""Parity of the port's hyperparameter fit (tpubq_torch.models.fit, the
``mll_grad_batched`` twin and ``BQ.fit_hypers``) with the JAX package.

Both packages get the same inputs, made with numpy from a seed; restart
initializations are drawn once by the JAX ``random_restarts`` and handed to
both as numpy arrays (the two packages' generators give different numbers
from one seed). The Pallas kernel runs in interpret mode, as tests/test_pallas.py
runs it on the CPU. Tolerances are stated at each assertion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpubq_torch
from tests import util as tu
from tpubq.models import fit as jfit
from tpubq.models import gp as jgp
from tpubq.ops import pallas_kernels as pk
from tpubq.ops.kernels import get_kernel as jkern
from tpubq_torch.models import fit as tfit
from tpubq_torch.models import gp as tgp
from tpubq_torch.ops import hopper_kernels as hk
from tpubq_torch.ops.kernels import get_kernel as tkern

JK, _ = jkern("gaussian")
TK, _ = tkern("gaussian")
THETAS = np.array([[1.2, 0.8], [0.5, 1.5], [2.0, 0.3]])


def _sine_data(n=11, pad=0, seed=7):
    """n live points of a noisy sine, then ``pad`` masked rows of junk."""
    rng = np.random.RandomState(seed)
    x = np.sort(rng.randn(n))
    y = np.sin(2 * x) + 0.05 * rng.randn(n)
    x = np.concatenate([x, rng.randn(pad)])[:, None]
    y = np.concatenate([y, rng.randn(pad)])
    return x, y, np.arange(n + pad) < n


def _gp_draw(n=14, seed=3, s=0.05):
    """A draw from a GP with h = 1.5, w = 0.7 (the problem of tests/test_fit.py)."""
    rng = np.random.RandomState(seed)
    x = np.sort(rng.uniform(-3, 3, n))[:, None]
    K = 1.5**2 * np.exp(-0.5 * (x - x.T) ** 2 / 0.7**2) + s**2 * np.eye(n)
    return x, np.linalg.cholesky(K) @ rng.randn(n), np.ones(n, bool), s


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _testbed(dtype, n=10, l=None, **kw):
    x = tu.make_x(n)
    bq = tpubq_torch.BQ(x, tu.f_l(x) if l is None else l, device="cpu", dtype=dtype,
                        **{**tu.DEFAULT_OPTIONS, **kw})
    return bq.init(params_tl=(0.7, 0.8), params_l=(0.3, 0.4))


# ---------------------------------------------------------------------------
# the kernel's plain twin, and dlog_mll
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad", [0, 3])
@pytest.mark.parametrize("jitter", [0.0, 1e-7])
def test_mll_grad_plain_matches_pallas_interpret(pad, jitter):
    """float32 twin against the Pallas kernel in interpret mode: the same
    arithmetic in another summation order, at well-conditioned thetas —
    rtol 1e-4 on the MLL, 1e-3 (atol 1e-3) on the gradient (measured
    ≤ 5e-6 relative on the MLL, ≤ 1e-4 absolute on the gradient)."""
    x, y, mask = _sine_data(pad=pad)
    mll_j, g_j = pk.mll_grad_batched(
        jnp.asarray(THETAS, jnp.float32), 0.1, jnp.asarray(x, jnp.float32),
        jnp.asarray(y, jnp.float32), jnp.asarray(mask), jitter=jitter, interpret=True)
    mll_t, g_t = hk.mll_grad_batched(
        _t(THETAS, torch.float32), 0.1, _t(x, torch.float32), _t(y, torch.float32),
        torch.as_tensor(mask), jitter=jitter)
    np.testing.assert_allclose(mll_t.numpy(), np.asarray(mll_j), rtol=1e-4)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n,live", [(136, 100), (176, 120)])
def test_mll_grad_plain_matches_pallas_interpret_beyond_the_old_cap(n, live):
    """The twin of both kernel regimes against the Pallas kernel in
    interpret mode past 64 rows (the card's tiled regime) and past the old
    167-row cap, with pads: the tolerances of the test above (measured
    ≤ 9e-6 relative on the MLL, ≤ 5e-5 relative on the gradient)."""
    x, y, mask = _sine_data(n=live, pad=n - live)
    mll_j, g_j = pk.mll_grad_batched(
        jnp.asarray(THETAS, jnp.float32), 0.1, jnp.asarray(x, jnp.float32),
        jnp.asarray(y, jnp.float32), jnp.asarray(mask), jitter=1e-7, interpret=True)
    mll_t, g_t = hk.mll_grad_batched(
        _t(THETAS, torch.float32), 0.1, _t(x, torch.float32), _t(y, torch.float32),
        torch.as_tensor(mask), jitter=1e-7)
    np.testing.assert_allclose(mll_t.numpy(), np.asarray(mll_j), rtol=1e-4)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-3, atol=1e-3)


def test_mll_grad_plain_matches_float64_autograd_and_ignores_pads():
    """The float32 twin against the port's float64 log_mll / dlog_mll at the
    JAX suite's pin (tests/test_pallas.py: rtol 5e-4 on the MLL, rtol 5e-3 /
    atol 1e-3 on the gradient), and the twin in float64 to 1e-9; junk in the
    padded rows changes nothing."""
    x, y, mask = _sine_data(pad=3)
    args64 = (0.1, _t(x), _t(y), torch.as_tensor(mask))
    mll64 = tgp.log_mll(TK, _t(THETAS), *args64, 0.0)
    g64 = tgp.dlog_mll(TK, _t(THETAS), *args64, 0.0)
    mll_p64, g_p64 = hk.mll_grad_batched_plain(_t(THETAS), *args64, 0.0)
    np.testing.assert_allclose(mll_p64.numpy(), mll64.numpy(), rtol=1e-9)
    np.testing.assert_allclose(g_p64.numpy(), g64.numpy(), rtol=1e-9, atol=1e-9)
    f32 = torch.float32
    mll32, g32 = hk.mll_grad_batched(_t(THETAS, f32), 0.1, _t(x, f32), _t(y, f32),
                                     torch.as_tensor(mask), 0.0)
    np.testing.assert_allclose(mll32.numpy(), mll64.numpy(), rtol=5e-4)
    np.testing.assert_allclose(g32.numpy(), g64.numpy(), rtol=5e-3, atol=1e-3)
    x2, y2 = x.copy(), y.copy()
    x2[~mask], y2[~mask] = 17.0, -3.0
    mll_b, g_b = hk.mll_grad_batched(_t(THETAS, f32), 0.1, _t(x2, f32), _t(y2, f32),
                                     torch.as_tensor(mask), 0.0)
    np.testing.assert_array_equal(mll_b.numpy(), mll32.numpy())
    np.testing.assert_array_equal(g_b.numpy(), g32.numpy())


@pytest.mark.parametrize("n,live", [(16, 5), (20, 1), (32, 8), (44, 12), (44, 17), (64, 33)])
def test_mll_grad_plain_equals_its_live_points_gathered_to_the_front(n, live):
    """The premise of the one-block kernel's compaction: a row's MLL and
    gradient on data whose live points are scattered over n slots (a prefix
    of observations, the rest scattered through the tail, junk in the pads,
    as in a fleet's linear GP) equal, in float64 to 1e-12, the same function
    on those points gathered in slot order to the front with n cut to the
    live count."""
    rng = np.random.RandomState(n + live)
    P, reps = 3, 4
    x = rng.uniform(-2.2, 2.2, (P, n, 1))
    y = np.sin(2.0 * x[..., 0]) + 0.05 * rng.randn(P, n)
    head = min(live, 8)
    mask = np.zeros((P, n), bool)
    for p in range(P):
        mask[p, :head] = True
        mask[p, head + rng.choice(n - head, live - head, replace=False)] = True
    thetas = np.exp(np.log([0.7, 0.8]) + 0.4 * rng.randn(P * reps, 2))
    s = _t([0.05, 0.1, 0.2])
    mll, grad = hk.mll_grad_batched_plain(_t(thetas), s, _t(x), _t(y), torch.as_tensor(mask), 1e-7)
    for p in range(P):
        rows = slice(p * reps, (p + 1) * reps)
        m_g, g_g = hk.mll_grad_batched_plain(_t(thetas[rows]), s[p], _t(x[p][mask[p]]), _t(y[p][mask[p]]),
                                             torch.ones(live, dtype=torch.bool), 1e-7)
        np.testing.assert_allclose(mll[rows].numpy(), m_g.numpy(), rtol=1e-12, atol=0.0)
        np.testing.assert_allclose(grad[rows].numpy(), g_g.numpy(), rtol=1e-12, atol=1e-12)


def test_mll_grad_wrapper_rejects_bad_input():
    x, y, mask = _sine_data()
    f32 = torch.float32
    good = (_t(THETAS, f32), 0.1, _t(x, f32), _t(y, f32), torch.as_tensor(mask))
    with pytest.raises(TypeError):
        hk.mll_grad_batched(_t(THETAS), *good[1:])
    with pytest.raises(ValueError, match=r"\(B, 2\)"):
        hk.mll_grad_batched(_t(THETAS, f32)[:, :1], *good[1:])
    with pytest.raises(ValueError, match="mask"):
        hk.mll_grad_batched(*good[:4], torch.as_tensor(mask).float())
    # no size cap: one launch up to 64 rows, four launches of tiles above
    assert [hk.mll_grad_launches(n) for n in (1, 44, 64, 65, 128, 168, 1036)] == [1, 1, 1, 4, 4, 4, 4]
    empty = (_t(np.zeros((0, 1)), f32), _t(np.zeros(0), f32), torch.zeros(0, dtype=torch.bool))
    with pytest.raises(ValueError, match="at least one data row"):
        hk.mll_grad_batched(*good[:2], *empty)
    with pytest.raises(ValueError, match="sizes_out is the CUDA kernel's"):
        hk.mll_grad_batched(*good, sizes_out=torch.zeros(len(THETAS), dtype=torch.uint8))


def test_dlog_mll_matches_jax_and_confines_a_failed_row():
    """float64 autograd gradient against jax.grad (rtol 1e-8); in a stack, a
    row whose Gram does not factor gets a non-finite MLL and a NaN gradient
    and leaves the other rows' gradients as they were."""
    x, y, mask = _sine_data(pad=2)
    args_t = (0.1, _t(x), _t(y), torch.as_tensor(mask), 1e-10)
    args_j = (0.1, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), 1e-10)
    g_t = tgp.dlog_mll(TK, _t(THETAS), *args_t)
    for i, th in enumerate(THETAS):
        g_j = np.asarray(jgp.dlog_mll(JK, jnp.asarray(th), *args_j))
        np.testing.assert_allclose(g_t[i].numpy(), g_j, rtol=1e-8)
        np.testing.assert_allclose(tgp.dlog_mll(TK, th, *args_t).numpy(), g_j, rtol=1e-8)
    bad = np.array([THETAS[0], [1.0, 500.0], THETAS[2]])  # w = 500: singular at s = 0
    args0 = (0.0, _t(x), _t(y), torch.as_tensor(mask), 0.0)
    val = tgp.log_mll(TK, _t(bad), *args0)
    g = tgp.dlog_mll(TK, _t(bad), *args0)
    assert not np.isfinite(val[1].item()) and not np.isfinite(g[1].numpy()).any()
    good = tgp.dlog_mll(TK, _t(bad[[0, 2]]), *args0)
    np.testing.assert_array_equal(g[[0, 2]].numpy(), good.numpy())


# ---------------------------------------------------------------------------
# the fits
# ---------------------------------------------------------------------------


def test_fused_fit_matches_jax_step_for_step_and_at_the_optimum():
    """Adam over the fused kernel from the same restart rows.

    30 steps: ``us`` of the port against optax.adam over the interpret-mode
    Pallas kernel, atol 1e-4 in log space (each step moves a coordinate by
    about lr = 0.05 whatever the gradient's size, so float32 differences in
    the gradient enter only through its normalized form; measured 8e-6).
    The full default run (150 steps): best MLL rtol 1e-4 and theta rtol 2e-3
    (measured 6e-6 and 6e-4: Adam is still circling the optimum at step 150)
    against the jitted ``fit_params_fused``.
    """
    x, y, mask, s = _gp_draw()
    f32 = jnp.float32
    xj, yj, mj = jnp.asarray(x, f32), jnp.asarray(y, f32), jnp.asarray(mask)
    theta0 = np.array([0.3, 2.5], np.float32)
    inits = np.array(jfit.random_restarts(jax.random.PRNGKey(0), jnp.asarray(theta0), xj, yj, mj, 10))
    xt, yt, mt = _t(x, torch.float32), _t(y, torch.float32), torch.as_tensor(mask)

    opt = optax.adam(0.05)
    us_j = jnp.asarray(inits)
    st = opt.init(us_j)
    for _ in range(30):
        _, g = pk.mll_grad_batched(jnp.exp(us_j), s, xj, yj, mj, jitter=1e-7, interpret=True)
        g_u = -g * jnp.exp(us_j)
        upd, st = opt.update(jnp.where(jnp.isfinite(g_u), g_u, 0.0), st, us_j)
        us_j = optax.apply_updates(us_j, upd)
    us_t = tfit._adam_ascent(_t(inits, torch.float32), torch.tensor(s, dtype=torch.float32),
                             xt, yt, mt, 30, 0.05, 1e-7)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), atol=1e-4)

    th_j, mll_j = jfit.fit_params_fused(jnp.asarray(theta0), s, xj, yj, mj, jax.random.PRNGKey(1),
                                        jnp.asarray(inits), interpret=True)
    th_t, mll_t = tfit.fit_params_fused(theta0, s, xt, yt, mt, torch.Generator(), inits)
    np.testing.assert_allclose(float(mll_t), float(mll_j), rtol=1e-4)
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=2e-3)
    mll0, _ = hk.mll_grad_batched(_t(theta0[None], torch.float32), s, xt, yt, mt, jitter=1e-7)
    assert float(mll_t) > float(mll0[0])

    # frozen coordinates: pinned before the loop, bit-identical after it
    th_f, _ = tfit.fit_params_fused(theta0, s, xt, yt, mt, torch.Generator(), inits, n_iter=5,
                                    free_mask=torch.tensor([True, False]))
    assert th_f[1].item() == theta0[1] and th_f[0].item() != theta0[0]


def test_fit_hypers_takes_the_fused_route_past_the_old_cap(monkeypatch):
    """float32 at max_obs 176 (the log-GP's 176 rows, the linear GP's 188,
    past the old 167-row cap): ``BQ.fit_hypers`` fits both GPs with
    ``fit_params_fused``, as the JAX package routes them, not with the
    L-BFGS. Each fit, cut to 3 Adam steps, is held step for step to the JAX
    ``fit_params_fused`` over the interpret-mode Pallas kernel from the same
    data and the port's own restart rows: log θ to atol 1e-4 and the best MLL
    to rtol 1e-4 (the tolerances of the step-for-step test above)."""
    calls = []
    fused = tfit.fit_params_fused

    def spy(theta0, s, x, y, mask, gen, restart_inits=None, **kw):
        th, mll = fused(theta0, s, x, y, mask, gen, restart_inits, n_iter=3, **kw)
        calls.append((theta0, s, x, y, mask, restart_inits, th, mll))
        return th, mll

    monkeypatch.setattr(tfit, "fit_params_fused", spy)
    monkeypatch.setattr(tfit, "fit_params", lambda *a, **k: pytest.fail("the L-BFGS route ran"))
    _testbed("float32", max_obs=176).fit_hypers(seed=0)
    assert [c[2].shape[0] for c in calls] == [176, 188]
    for theta0, s, x, y, mask, inits, th, mll in calls:
        th_j, mll_j = jfit.fit_params_fused(
            jnp.asarray(theta0.numpy()), float(s), jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
            jnp.asarray(mask.numpy()), jax.random.PRNGKey(0), jnp.asarray(inits.numpy()), n_iter=3,
            interpret=True)
        np.testing.assert_allclose(np.log(th.numpy()), np.log(np.asarray(th_j)), atol=1e-4)
        np.testing.assert_allclose(float(mll), float(mll_j), rtol=1e-4)


def test_fit_params_reaches_the_jax_optimum():
    """Batched L-BFGS (float64) against optax.lbfgs from the same restart
    rows: the trajectories differ, the optimum is the same — the port's best
    MLL is not below the JAX package's by more than 1e-6 relative, and theta
    agrees to rtol 1e-4 (the MLL is flat to second order at the optimum;
    measured 5e-14 on the MLL, 2e-5 on theta)."""
    x, y, mask, s = _gp_draw()
    xj, yj, mj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)
    theta0 = np.array([0.3, 2.5])
    inits = np.array(jfit.random_restarts(jax.random.PRNGKey(0), jnp.asarray(theta0), xj, yj, mj, 10))
    th_j, mll_j = jfit.fit_params("gaussian", jnp.asarray(theta0), s, xj, yj, mj,
                                  jax.random.PRNGKey(0), jnp.asarray(inits))
    args = (s, _t(x), _t(y), torch.as_tensor(mask), torch.Generator())
    th_t, mll_t = tfit.fit_params("gaussian", theta0, *args, inits)
    assert float(mll_t) >= float(mll_j) - 1e-6 * abs(float(mll_j))
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=1e-4)
    assert float(mll_t) > float(tgp.log_mll(TK, theta0, *args[:4], 1e-10))

    # subsets: frozen coordinates bit-identical; nothing free returns theta0
    th_h, mll_h = tfit.fit_params("gaussian", theta0, *args, inits, free_mask=torch.tensor([True, False]))
    assert th_h[1].item() == theta0[1] and th_h[0].item() != theta0[0]
    assert float(mll_h) <= float(mll_t)
    th_0, _ = tfit.fit_params("gaussian", theta0, *args, inits, free_mask=torch.tensor([False, False]))
    np.testing.assert_array_equal(th_0.numpy(), theta0)


@pytest.mark.parametrize("kernel,free", [("gaussian", None), ("matern52", None), ("rq", (True, False, True))])
def test_fit_params_on_a_fleet_equals_one_fit_per_problem(kernel, free):
    """``fit_params`` on fleet data ((P, n, d), inits (P, R, p)) advances all
    P·R restart rows in one lock-step L-BFGS; each problem's result equals
    its own call on the same inits at 1e-12 relative (float64), with a
    different live count per problem and, for rq, a frozen coordinate, over
    15 iterations."""
    rng = np.random.RandomState(4)
    P, R, n = 3, 3, 12
    xs, ys, masks = zip(*(_sine_data(n=n - pad, pad=pad, seed=10 + i) for i, pad in enumerate((0, 2, 5))))
    x, y, mask = _t(np.stack(xs)), _t(np.stack(ys)), torch.as_tensor(np.stack(masks))
    p = 3 if kernel == "rq" else 2
    theta0 = np.exp(rng.uniform(-0.5, 0.5, (P, p)))
    s = np.array([0.05, 0.1, 0.02])
    inits = np.log(theta0)[:, None, :] + rng.uniform(-1.0, 1.0, (P, R, p))
    inits[:, 0] = np.log(theta0)
    free_mask = None if free is None else torch.tensor(free)
    th_b, mll_b = tfit.fit_params(kernel, theta0, s, x, y, mask, torch.Generator(), inits, n_iter=15,
                                  free_mask=free_mask)
    assert th_b.shape == (P, p) and mll_b.shape == (P,)
    for i in range(P):
        th_i, mll_i = tfit.fit_params(kernel, theta0[i], s[i], x[i], y[i], mask[i], torch.Generator(), inits[i],
                                      n_iter=15, free_mask=free_mask)
        np.testing.assert_allclose(th_b[i].numpy(), th_i.numpy(), rtol=1e-12)
        np.testing.assert_allclose(float(mll_b[i]), float(mll_i), rtol=1e-12)
        if free is not None:
            assert th_b[i, 1].item() == theta0[i, 1]


def test_fit_params_with_noise_reaches_the_jax_optimum():
    """Joint (θ, s) fit in float64 from the JAX package's own restart rows
    (its key split reproduced here): best MLL not below JAX's by more than
    1e-6 relative; theta and s to rtol 2e-3. With s0 = 0 the incumbent row
    starts at the 1e-4·ystd floor."""
    x, y, mask, _ = _gp_draw(s=0.2)
    xj, yj, mj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)
    theta0 = np.array([0.8, 1.2])
    key = jax.random.PRNGKey(2)
    th_j, s_j, mll_j = jfit.fit_params_with_noise("gaussian", jnp.asarray(theta0), 0.0, xj, yj, mj, key,
                                                  n_restart=6)
    k_theta, k_s = jax.random.split(key)
    ystd = float(np.std(y))
    u_theta = jfit.random_restarts(k_theta, jnp.asarray(theta0), xj, yj, mj, 6)
    log_s = np.log(ystd) + jax.random.uniform(k_s, (6, 1), jnp.float64, np.log(1e-4), np.log(0.3))
    inits = np.concatenate([np.asarray(u_theta), np.asarray(log_s)], axis=1)
    inits[0, 2] = np.log(1e-4 * ystd)
    args = (_t(x), _t(y), torch.as_tensor(mask), torch.Generator())
    th_t, s_t, mll_t = tfit.fit_params_with_noise("gaussian", theta0, 0.0, *args, restart_inits=inits)
    assert float(mll_t) >= float(mll_j) - 1e-6 * abs(float(mll_j))
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=2e-3)
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=2e-3)
    # its own draws: the incumbent row and the ranges of the noise column
    th_d, s_d, mll_d = tfit.fit_params_with_noise(
        "gaussian", theta0, 0.0, *args[:3], torch.Generator().manual_seed(0), n_restart=6,
        free_mask=torch.tensor([False, True]))
    assert th_d[0].item() == theta0[0] and float(s_d) > 0 and np.isfinite(float(mll_d))


def test_random_restarts_rows_ranges_and_seed():
    rng = np.random.RandomState(0)
    x = _t(np.stack([rng.uniform(0, 1.0, 64), rng.uniform(0, 100.0, 64)], -1))
    y = _t(rng.randn(64))
    mask = torch.ones(64, dtype=torch.bool)
    mask[60:] = False
    x[60:] = 1e6  # pads must not widen the ranges
    theta0 = torch.tensor([1.5, 0.5, 2.0], dtype=torch.float64)
    u = tfit.random_restarts(torch.Generator().manual_seed(0), theta0, x, y, mask, 64)
    assert u.shape == (64, 3) and u.dtype == torch.float64
    np.testing.assert_array_equal(u[0].numpy(), np.log(theta0.numpy()))
    ystd = y[:60].std(unbiased=False).item()
    xr = (x[:60].amax(0) - x[:60].amin(0)).numpy()
    lh = u[1:, 0].numpy() - np.log(ystd)
    lw = u[1:, 1:].numpy() - np.log(xr)[None, :]
    assert lh.min() >= -2.0 and lh.max() <= 2.0 and np.ptp(lh) > 2.0
    assert lw.min() >= np.log(0.05) - 1e-12 and lw.max() <= np.log(2.0) + 1e-12
    w = np.exp(u[1:, 1:].numpy())
    assert np.median(w[:, 1]) / np.median(w[:, 0]) > 20.0  # tracks the 100x range ratio
    u2 = tfit.random_restarts(torch.Generator().manual_seed(0), theta0, x, y, mask, 64)
    np.testing.assert_array_equal(u.numpy(), u2.numpy())
    # every family seeds (the periodic and rq ranges: tests/test_torch_families.py);
    # an unknown family raises
    with pytest.raises(ValueError, match="unknown kernel"):
        tfit.random_restarts(torch.Generator(), theta0, x, y, mask, 4, kernel="cosine")


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fit_hypers_end_to_end(dtype):
    """float64 takes the batched L-BFGS, float32 Adam over the fused twin:
    E[Z] lands within 5e-3 of the closed-form evidence (the JAX suite's pin,
    tests/test_fit.py), and a seed fixes the result to the bit."""
    bq = _testbed(dtype)
    before = hk.mll_grad_batched.launches
    assert bq.fit_hypers(seed=0) is bq
    assert hk.mll_grad_batched.launches == before  # the CPU never counts a launch
    Z = tu.true_Z()
    assert abs(bq.Z_mean() - Z) / Z < 5e-3
    assert bq.Z_var() >= 0.0
    bq2 = _testbed(dtype).fit(seed=0)
    np.testing.assert_array_equal(bq2.state.gp_log_l.theta.numpy(), bq.state.gp_log_l.theta.numpy())
    np.testing.assert_array_equal(bq2.state.gp_l.theta.numpy(), bq.state.gp_l.theta.numpy())
    assert not np.array_equal(bq.state.gp_log_l.theta.numpy(), np.asarray((0.7, 0.8), dtype))


def test_fit_hypers_param_subsets():
    bq = _testbed("float64").fit_hypers(params=("h",), ntry=4, seed=1)
    th = bq.state.gp_log_l.theta.numpy()
    assert th[1] == 0.8 and th[0] != 0.7
    assert bq.state.gp_l.theta[1].item() == 0.4
    assert float(bq.state.gp_log_l.s) == 0.0 and bq.s_tl == 0.0

    rng = np.random.RandomState(4)
    x = tu.make_x(14)
    noisy = _testbed("float64", n=14, l=tu.f_l(x) * np.exp(rng.randn(14) * 0.1), max_obs=14)
    noisy.fit_hypers(params=("s",), ntry=4, seed=1)
    np.testing.assert_array_equal(noisy.state.gp_log_l.theta.numpy(), [0.7, 0.8])
    np.testing.assert_array_equal(noisy.state.gp_l.theta.numpy(), [0.3, 0.4])
    s_fit = float(noisy.state.gp_log_l.s)
    assert s_fit > 0.0 and noisy.s_tl == s_fit and noisy.s_l == float(noisy.state.gp_l.s)

    with pytest.raises(ValueError, match=r"unknown hyperparameters \['ell'\].*valid: \['h', 'w', 's'\]"):
        bq.fit_hypers(params=("ell",))
