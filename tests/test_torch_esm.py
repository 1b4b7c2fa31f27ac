"""Parity of the port's ESM scorer with the JAX package.

* ``esm_fused_plain`` with noise_mult = 0 against the TPU kernel
  ``pk.esm_fused`` (interpret mode) on identical packed inputs: rtol 2e-5,
  the pin of tests/test_pallas.py.
* The port's float32 ``expected_squared_mean`` (packing + ``esm_fused``,
  which takes its plain twin on the CPU) against the JAX f32 scorer: rtol 2e-5
  (3e-5 on the numerically singular state, see below) with identical
  degenerate masks; float64 against float64: rtol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from tpubq.models import acquire as jacq
from tpubq.ops import pallas_kernels as pk
from tpubq_torch.models import acquire as tacq
from tpubq_torch.ops import hopper_kernels as hk

GRID = np.linspace(-4.0, 4.0, 301)


def _f32_pair(**overrides):
    bj, _ = tp.make_pair("float32", **overrides)
    st, opts = tp.to_torch(bj.state, bj.options)
    return bj, st, opts


def _near_duplicate(**kw):
    """A state with a near-duplicate observation and s = 0: a numerically
    singular Gram, where the adaptive f32 guard decides the degenerate mask."""
    x = np.sort(np.concatenate([tp.tu.make_x(10), [0.2 + 1e-4]]))
    return _f32_pair(x=x, l=tp.tu.f_l(x), **kw)


def test_esm_fused_plain_matches_pallas_kernel():
    bj, st, opts = _f32_pair()
    args = tacq.esm_fused_inputs(st, opts, torch.as_tensor(GRID, dtype=torch.float32)[:, None])
    params, grid, xsc, msc, Kinv, uz, alpha, xs, ms, Kinv_tl, alpha_tl = args
    params = params.clone()
    params[-1] = 0.0  # noise_mult = 0: the TPU kernel's own guard
    got = tp.np_(hk.esm_fused_plain(params, grid, xsc, msc, Kinv, uz, alpha, xs, ms, Kinv_tl, alpha_tl))

    def col(v):
        return jnp.asarray(tp.np_(v))[:, None]

    want = np.asarray(pk.esm_fused(
        jnp.asarray(tp.np_(params[:-1])), jnp.asarray(tp.np_(grid).T), jnp.asarray(tp.np_(xsc)),
        col(msc), jnp.asarray(tp.np_(Kinv)), col(uz), col(alpha), jnp.asarray(tp.np_(xs)),
        col(ms), jnp.asarray(tp.np_(Kinv_tl)), col(alpha_tl), interpret=True, tile=128,
    ))
    np.testing.assert_allclose(got, want, rtol=2e-5)


# rtol per state: 2e-5 on the testbed (the pin of tests/test_pallas.py);
# 3e-5 on the numerically singular s = 0 state, where the JAX package's own
# two f32 scorers (esm_fused and the XLA path) already differ by 2.2e-5.
@pytest.mark.parametrize("case,rtol", [("testbed", 2e-5), ("near_duplicate_s0", 3e-5)])
def test_expected_squared_mean_f32_matches_jax(case, rtol):
    bj, st, opts = _f32_pair() if case == "testbed" else _near_duplicate()
    grid = GRID.astype(np.float32)
    want = np.asarray(jacq.expected_squared_mean(bj.state, bj.options, jnp.asarray(grid)))
    got = tp.np_(tacq.expected_squared_mean(st, opts, torch.as_tensor(grid)))
    np.testing.assert_allclose(got, want, rtol=rtol)
    # identical degenerate masks: the port's guard marks the JAX guard's
    # points, and the fused scorer gives exactly (zᵀα)² there
    _, _, deg_j, zta, *_ = jacq._esm_affine_terms(bj.state, bj.options, jnp.asarray(grid)[:, None])
    _, _, deg_t, zta_t, *_ = tacq._esm_affine_terms(st, opts, torch.as_tensor(grid)[:, None])
    deg_j = np.asarray(deg_j)
    np.testing.assert_array_equal(tp.np_(deg_t), deg_j)
    np.testing.assert_array_equal(got[deg_j], np.float32(tp.np_(zta_t * zta_t)))
    assert deg_j.sum() > 0


def test_expected_squared_mean_f32_from_raw_matches_jax():
    """Both packages built from the raw (x, ℓ) in float32: the port's fused
    scores hold to the JAX scorer at the same rtol, with the same argmax."""
    bj, bt = tp.make_pair("float32")
    want = bj.expected_squared_mean(GRID.astype(np.float32))
    got = bt.expected_squared_mean(GRID)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert bt.choose_next(GRID) == pytest.approx(bj.choose_next(GRID.astype(np.float32)), abs=1e-6)


def test_adaptive_guard_marks_beyond_proximity():
    """On the numerically singular s = 0 Gram the λ·ρ·κ·‖k‖₁ floor marks
    points that the sup-norm proximity test alone would score."""
    _, st, opts = _near_duplicate()
    x_a = torch.as_tensor(GRID, dtype=torch.float32)[:, None]
    _, _, degenerate, *_ = tacq._esm_affine_terms(st, opts, x_a)
    dist = (x_a[:, None, :] - st.x_sc[None]).abs().amax(-1)
    near = ((dist < opts.candidate_thresh) & st.sc_mask[None]).any(1)
    assert bool((degenerate & ~near).any())


def test_expected_squared_mean_xla_f32_matches_jax():
    bj, st, opts = _near_duplicate()
    grid = GRID.astype(np.float32)
    want = np.asarray(jacq.expected_squared_mean_xla(bj.state, bj.options, jnp.asarray(grid)))
    got = tp.np_(tacq.expected_squared_mean_xla(st, opts, torch.as_tensor(grid)))
    np.testing.assert_allclose(got, want, rtol=3e-5)


def test_expected_squared_mean_f64_matches_jax():
    bj, bt = tp.make_pair("float64")
    st, opts = tp.to_torch(bj.state, bj.options)
    want = np.asarray(jacq.expected_squared_mean(bj.state, bj.options, jnp.asarray(GRID)))
    np.testing.assert_allclose(tp.np_(tacq.expected_squared_mean(st, opts, GRID)), want, rtol=1e-9)
    # from raw (x, l): the port's own init, same scores
    np.testing.assert_allclose(bt.expected_squared_mean(GRID), want, rtol=1e-9)
    ezv = np.asarray(jacq.expected_Z_var(bj.state, bj.options, jnp.asarray(GRID[:50])))
    np.testing.assert_allclose(bt.expected_Z_var(GRID[:50]), ezv, rtol=1e-7, atol=1e-15)


def test_esm_fused_cpu_wrapper_uses_plain_and_checks_shapes():
    _, st, opts = _f32_pair()
    args = tacq.esm_fused_inputs(st, opts, torch.as_tensor(GRID[:7], dtype=torch.float32)[:, None])
    before = hk.esm_fused.launches
    out = hk.esm_fused(*args)
    assert hk.esm_fused.launches == before
    np.testing.assert_array_equal(tp.np_(out), tp.np_(hk.esm_fused_plain(*args)))
    with pytest.raises(ValueError):
        hk.esm_fused(args[0][:-1], *args[1:])
    with pytest.raises(TypeError):
        hk.esm_fused(*[a.double() for a in args])
    assert hk.esm_fused_supported(48, 32, 1) and hk.esm_fused_supported(80, 64, 1)
    assert not hk.esm_fused_supported(48, 32, 4)
    assert hk.esm_fused_supported(4000, 32, 1)  # the inverses are streamed: no shared-memory cap
