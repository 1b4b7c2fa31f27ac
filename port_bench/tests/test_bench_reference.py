"""The plain reference against closed forms, quadrature and the port's own
float64 path, on the CPU."""

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from port_bench.reference import bq_gaussian as R  # noqa: E402

MU_L, SIG_L = 0.2, 0.5  # ℓ(x) = N(x; 0.2, 0.5²) under N(0, 1)
CFG = dict(theta_tl=[0.7, 0.8], theta_l=[0.3, 0.4], s=0.05, n_candidate=12, candidate_thresh=1e-3,
           x_mean=0.0, x_var=1.0)


def lik(x):
    return np.exp(-0.5 * ((x - MU_L) / SIG_L) ** 2) / (SIG_L * math.sqrt(2 * math.pi))


def true_z():
    v = 1.0 + SIG_L**2
    return math.exp(-0.5 * MU_L**2 / v) / math.sqrt(2 * math.pi * v)


def model(cfg=CFG, mode="f64"):
    return R.Model(cfg, R.Arith(mode, "cpu"))


def large_data(n=40, seed=0):
    x = np.sort(np.random.RandomState(seed).uniform(-2.2, 2.2, n))
    return x[None], (np.exp(-0.5 * (x - 0.2) ** 2 / 0.25) / math.sqrt(2 * math.pi * 0.25) + 1e-3)[None]


def test_z_mean_matches_the_testbeds_closed_form():
    x = np.linspace(-3, 3, 30)
    m = model(dict(CFG, theta_tl=[1.0, 0.6], theta_l=[0.4, 0.5], s=0.0, candidate_thresh=0.2))
    st = m.state(x[None], lik(x)[None])
    assert abs(float(m.z_mean(st)[0]) - true_z()) < 1e-8
    assert 0.0 <= float(m.z_var(st)[0]) < 1e-7


def test_z_var_closed_form_matches_gauss_hermite():
    """V[Z] = ∫∫ (m_l + γ) C_tl (m_l + γ) p p by a 200-node rule on each axis."""
    m = model()
    x, lv = large_data()
    st = m.state(x, lv)
    t, w = np.polynomial.hermite_e.hermegauss(200)
    w = torch.tensor(w / math.sqrt(2 * math.pi))
    nodes = torch.tensor(t)[None]
    gl, gt = st["gp_l"], st["gp_tl"]
    a = w * (gl.mean(nodes)[0] + m.gamma)
    kt = gt.cross(nodes)[0]
    C = R.gram(m.ar, nodes, nodes, gt.h, gt.w)[0] - kt.T @ gt.solve(kt[None])[0]
    assert float(m.z_var(st)[0]) == pytest.approx(float(a @ C @ a), rel=1e-9)


def test_esm_lognormal_moments_match_quadrature():
    """The ESM's closed form against (A + Bℓ)² integrated over the log-GP."""
    m = model()
    x, lv = large_data()
    st = m.state(x, lv)
    grid = torch.tensor([-3.0, -2.5, 2.45, 3.1], dtype=torch.float64)
    e = m.esm(st, grid)
    gl, gt = st["gp_l"], st["gp_tl"]
    k = gl.cross(grid[None])[0]
    z = m.z_vector(st)[0]
    gam = gl.kappa[0] - (k * gl.solve(k[None])[0]).sum(0)
    zeta = R.int_k(grid[None], gl.h, gl.w, torch.zeros(1, dtype=torch.float64), torch.tensor(1.0))[0]
    B = (zeta - z @ gl.solve(k[None])[0]) / gam
    A = z @ gl.alpha[0] - B * (gl.alpha[0] @ k)
    kt = gt.cross(grid[None])[0]
    mt = gt.alpha[0] @ kt
    ct = gt.h[0] ** 2 - (kt * gt.solve(kt[None])[0]).sum(0)
    t, w = np.polynomial.hermite_e.hermegauss(120)
    t, w = torch.tensor(t), torch.tensor(w / math.sqrt(2 * math.pi))
    ell = torch.expm1(mt[:, None] + torch.sqrt(ct)[:, None] * t[None])
    quad = ((A[:, None] + B[:, None] * ell) ** 2) @ w
    assert torch.allclose(e["raw"][0], quad, rtol=1e-10)


def test_mll_gradient_matches_finite_differences():
    m = model()
    x, lv = large_data(20)
    xs = torch.tensor(x).expand(2, -1)
    ys = torch.log1p(torch.tensor(lv)).expand(2, -1)
    mask = torch.ones_like(xs, dtype=torch.bool)
    s = torch.full((2,), 0.05, dtype=torch.float64)
    u = torch.log(torch.tensor([[0.7, 0.8], [0.4, 1.3]], dtype=torch.float64))
    _, g = m.mll_grad(u, xs, ys, mask, s)
    for j in range(2):
        e = torch.zeros(2, dtype=torch.float64)
        e[j] = 1e-6
        fd = (m.mll_grad(u + e, xs, ys, mask, s)[0] - m.mll_grad(u - e, xs, ys, mask, s)[0]) / 2e-6
        assert torch.allclose(g[:, j], fd, rtol=1e-6, atol=1e-6)


def test_polish_reaches_a_stationary_point_uphill():
    m = model()
    x, lv = large_data(30)
    xs = torch.tensor(x)
    ys = torch.log1p(torch.tensor(lv))
    mask = torch.ones_like(xs, dtype=torch.bool)
    s = torch.full((1,), 0.05, dtype=torch.float64)
    u0 = torch.log(torch.tensor([[0.7, 0.8]], dtype=torch.float64))
    u, m1, m0 = m.polish(u0, xs, ys, mask, s)
    assert float(m1[0]) > float(m0[0])
    assert float(m.mll_grad(u, xs, ys, mask, s)[1].abs().max()) < 1e-6


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-12, -(1.0 + 2**-11 + 2**-20)])
    assert R.tf32_round(x).tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-10, -(1.0 + 2**-10)]


def test_reference_agrees_with_the_ports_float64_path():
    """Two independent implementations of one estimator, on the same inputs."""
    from tpubq_torch.models import acquire, bq as bqm
    from tpubq_torch.utils.options import BQOptions

    x, lv = large_data(40)
    opts = BQOptions(n_candidate=12, candidate_thresh=1e-3, max_obs=64, dtype="float64")
    st = bqm.init_state(x[0], lv[0], opts, params_tl=(0.7, 0.8), params_l=(0.3, 0.4), s_tl=0.05, s_l=0.05,
                        device="cpu")
    m = model()
    rs = m.state(x, lv)
    assert float(m.z_mean(rs)[0]) == pytest.approx(float(bqm.Z_mean(st, opts)), rel=1e-12)
    assert float(m.z_var(rs)[0]) == pytest.approx(float(bqm.Z_var(st, opts)), rel=1e-10)
    grid = np.linspace(-4, 4, 1001)
    port = acquire.expected_squared_mean_xla(st, opts, torch.tensor(grid)[:, None]).numpy()
    e = m.esm(rs, grid)
    ok = e["resolved"][0].numpy()
    assert ok.sum() > 900
    assert np.max(np.abs(port - e["scores"][0].numpy())[ok]) < 1e-12 * np.max(np.abs(port))
    pick, _ = acquire.choose_next(st, opts, torch.tensor(grid)[:, None])
    assert float(m.choose(rs, grid)[0]) == float(pick[0])


def test_tf32_control_departs_from_float64():
    """The control's arithmetic, on the same small problem, misses E[Z] by far
    more than float32 rounding does."""
    x, lv = large_data(40)
    ref = model()
    ctl = model(mode="tf32")
    z64 = float(ref.z_mean(ref.state(x, lv))[0])
    z32 = float(ctl.z_mean(ctl.state(x, lv))[0])
    assert abs(z32 - z64) / z64 > 1e-4
