"""Parity of the port's ops (tpubq_torch.ops) with the JAX package.

Same numpy-made inputs through both; tolerances: float64 rtol 1e-10 for the
kernel, integrals and factorizations (the two differ only in LAPACK call
order); float32 factors rtol 2e-5; the batched Cholesky's plain twin against
the Pallas kernel (interpret mode on the CPU) at rtol 2e-4 / atol 5e-5, the
pin of tests/test_pallas.py.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import np_
from tpubq.ops import integrals as jig
from tpubq.ops import kernels as jk
from tpubq.ops import linalg as jla
from tpubq.ops import pallas_kernels as pk
from tpubq_torch.ops import hopper_kernels as hk
from tpubq_torch.ops import integrals as tig
from tpubq_torch.ops import kernels as tk
from tpubq_torch.ops import linalg as tla

F64 = dict(rtol=1e-10, atol=1e-14)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _spd(rng, B, N, dtype=np.float32):
    A = rng.randn(B, N, N)
    return (A @ np.transpose(A, (0, 2, 1)) + N * np.eye(N)).astype(dtype)


@pytest.mark.parametrize("d", [1, 2])
def test_gaussian_K_matches_jax(d):
    rng = np.random.RandomState(d)
    theta = np.concatenate([[1.3], rng.uniform(0.4, 1.2, d)])
    x1, x2 = rng.randn(7, d), rng.randn(5, d)
    want = np.asarray(jk.gaussian_K(jnp.asarray(theta), jnp.asarray(x1), jnp.asarray(x2)))
    got = np_(tk.gaussian_K(_t(theta), _t(x1), _t(x2)))
    np.testing.assert_allclose(got, want, **F64)
    np.testing.assert_allclose(np_(tk.gaussian_Kdiag(_t(theta), _t(x1))), np.full(7, 1.69), **F64)


_INTEGRALS = ["int_K", "int_int_K", "int_K1_K2", "int_int_K1_K2", "int_K1_int_K2"]


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("name", _INTEGRALS)
def test_gaussian_integrals_match_jax(name, d):
    rng = np.random.RandomState(10 + d)
    x1, x2 = rng.randn(6, d), rng.randn(4, d)
    h1, h2 = 0.8, 1.4
    w1, w2 = rng.uniform(0.3, 1.0, d), rng.uniform(0.5, 1.5, d)
    mu = rng.randn(d) * 0.3
    A = rng.randn(d, d)
    Sig = A @ A.T + np.eye(d)
    args = {
        "int_K": (x1, h1, w1, mu, Sig),
        "int_int_K": (d, h1, w1, mu, Sig),
        "int_K1_K2": (x1, x2, h1, w1, h2, w2, mu, Sig),
        "int_int_K1_K2": (x1, x2, h1, w1, h2, w2, mu, Sig),
        "int_K1_int_K2": (x1, h1, w1, h2, w2, mu, Sig),
    }[name]
    want = np.asarray(getattr(jig, name)(*[a if isinstance(a, int) else jnp.asarray(a) for a in args]))
    got = np_(getattr(tig, name)(*[a if isinstance(a, int) else _t(a) for a in args]))
    np.testing.assert_allclose(got, want, **F64)


def test_integrals_broadcast_over_batched_hypers():
    """A (B,) stack of hypers gives the per-row integrals (the marginalize path)."""
    rng = np.random.RandomState(3)
    x1, x2 = rng.randn(5, 1), rng.randn(3, 1)
    mu, Sig = np.zeros(1), np.eye(1)
    h2 = rng.uniform(0.5, 1.5, 4)
    w2 = rng.uniform(0.3, 1.0, (4, 1))
    got = np_(tig.int_int_K1_K2(_t(x1), _t(x1), _t(0.8), _t([0.6]), _t(h2), _t(w2), _t(mu), _t(Sig)))
    got_p = np_(tig.int_K1_K2(_t(x1), _t(x2), _t(0.8), _t([0.6]), _t(h2), _t(w2), _t(mu), _t(Sig)))
    for b in range(4):
        a = (jnp.asarray(0.8), jnp.asarray([0.6]), jnp.asarray(h2[b]), jnp.asarray(w2[b]),
             jnp.asarray(mu), jnp.asarray(Sig))
        np.testing.assert_allclose(got[b], np.asarray(jig.int_int_K1_K2(x1, x1, *a)), **F64)
        np.testing.assert_allclose(got_p[b], np.asarray(jig.int_K1_K2(x1, x2, *a)), **F64)


def test_pad_gram_and_cholesky_fixed_match_jax():
    rng = np.random.RandomState(4)
    K = _spd(rng, 1, 9, np.float64)[0]
    mask = np.arange(9) < 6
    np.testing.assert_allclose(
        np_(tla.pad_gram(_t(K), torch.as_tensor(mask))),
        np.asarray(jla.pad_gram(jnp.asarray(K), jnp.asarray(mask))), **F64)
    np.testing.assert_allclose(
        np_(tla.cholesky_fixed(_t(K), torch.as_tensor(mask), 1e-6)),
        np.asarray(jla.cholesky_fixed(jnp.asarray(K), jnp.asarray(mask), 1e-6)), **F64)


def _needs_rung(dtype, N=12, live=10):
    """A live block with one eigenvalue below zero (−3e-6 in float64, −1e-5 in
    float32, against a mean diagonal ~1.5): rung 0 fails, and so does every
    rung below 1e-4, which lifts it to ~1.4e-4 (condition number ~1.4e4)."""
    rng = np.random.RandomState(12)
    Q, _ = np.linalg.qr(rng.randn(live, live))
    lam = np.linspace(1.0, 2.0, live)
    lam[0] = -3e-6 if dtype == "float64" else -1e-5
    K = np.eye(N)
    K[:live, :live] = (Q * lam) @ Q.T
    return K


@pytest.mark.parametrize("case", ["well_conditioned", "needs_rung"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_jitter_cholesky_matches_jax(dtype, case):
    rng = np.random.RandomState(5)
    K = _spd(rng, 1, 12, np.float64)[0] if case == "well_conditioned" else _needs_rung(dtype)
    K = K.astype(dtype)
    mask = np.arange(12) < 10
    Lj, jj, okj = jla.jitter_cholesky(jnp.asarray(K), jnp.asarray(mask), 1e-12)
    Lt, jt, okt = tla.jitter_cholesky(torch.as_tensor(K), torch.as_tensor(mask), 1e-12)
    assert bool(okt) == bool(okj)
    np.testing.assert_allclose(float(jt), float(jj), rtol=1e-6 if dtype == "float32" else 1e-12)
    # float32: the trailing pivot of the rescued factor carries eps32 times
    # the condition number (~1.4e4) in either package, so the f32 pin is
    # rtol 2e-5 plus 2e-5 of the factor's largest entry.
    Lj = np.asarray(Lj)
    tol = dict(rtol=2e-5, atol=2e-5 * np.abs(Lj).max()) if dtype == "float32" else F64
    np.testing.assert_allclose(np_(Lt), Lj, **tol)
    if case == "needs_rung":
        assert float(jt) > 0.0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_jitter_cholesky_batched_selects_per_matrix(dtype):
    """The batched ladder (the f32 rung stack; the f64 per-matrix rung
    selection) equals the unbatched ladder matrix by matrix."""
    rng = np.random.RandomState(6)
    Ks = np.concatenate([_spd(rng, 3, 12, np.float64), _needs_rung(dtype)[None]]).astype(dtype)
    mask = torch.as_tensor(np.arange(12) < 10)
    L, jit, ok = tla.jitter_cholesky(torch.as_tensor(Ks), mask, 1e-12)
    assert bool(ok.all())
    for b in range(4):
        L1, j1, ok1 = tla.jitter_cholesky(torch.as_tensor(Ks[b]), mask, 1e-12)
        np.testing.assert_allclose(np_(L[b]), np_(L1), rtol=1e-6, atol=1e-7)
        assert float(jit[b]) == float(j1)
    assert float(jit[3]) > float(jit[0])


@pytest.mark.parametrize("B,N", [(5, 6), (9, 26), (3, 33), (3, 64)])
def test_chol_batch_plain_matches_pallas(B, N):
    rng = np.random.RandomState(7)
    Ks = _spd(rng, B, N)
    want = np.asarray(pk.cholesky_batch_major(jnp.asarray(Ks), interpret=True))
    got = np_(hk.chol_batch_plain(torch.as_tensor(Ks)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5)
    np.testing.assert_allclose(got, np.linalg.cholesky(Ks.astype(np.float64)), rtol=2e-4, atol=5e-5)
    assert np.all(np.triu(got, 1) == 0.0)


def _pad_batch_with_indefinite(rng):
    K = np.zeros((4, 9, 9), np.float32)
    for b in range(4):
        K[b, :6, :6] = _spd(rng, 1, 6)[0]
        K[b, 6:, 6:] = np.eye(3)
    K[1, :6, :6] = -np.eye(6)
    return K


def test_chol_batch_nan_confined_to_indefinite_matrix():
    K = _pad_batch_with_indefinite(np.random.RandomState(3))
    L = np_(hk.chol_batch(torch.as_tensor(K)))  # CPU tensor → plain twin
    for b in (0, 2, 3):
        np.testing.assert_allclose(L[b], np.linalg.cholesky(K[b].astype(np.float64)), rtol=2e-4, atol=5e-5)
        np.testing.assert_allclose(L[b][6:, 6:], np.eye(3), atol=1e-6)
    assert np.any(~np.isfinite(L[1]))
    assert np.all(np.triu(L[1], 1) == 0.0)


def test_chol_batch_wrapper_checks_inputs():
    with pytest.raises(TypeError):
        hk.chol_batch(torch.eye(3, dtype=torch.float64)[None])
    with pytest.raises(ValueError):
        hk.chol_batch(torch.eye(3)[None, :, :2].contiguous())
    assert hk.chol_batch_supported(80) and hk.chol_batch_supported(240)
    assert not hk.chol_batch_supported(241)


@pytest.mark.parametrize("n", [1, 17, 33, 64, 65, 240])
def test_chol_batch_cpu_matches_float64_at_regime_edges(n):
    """On the CPU the wrapper is its twin, at the edges of the kernel's
    regimes (one panel up to 32 rows, a warp up to 64, panels of 32 up to
    the route's 240): within rtol 2e-4 / atol 5e-5 of float64, exact zeros
    above the diagonal, and NaN in the input's upper triangle never read."""
    K = _spd(np.random.RandomState(n), 2, n)
    dirty = np.where(np.triu(np.ones((n, n), bool), 1), np.nan, K).astype(np.float32)
    L = np_(hk.chol_batch(torch.as_tensor(dirty)))
    np.testing.assert_allclose(L, np.linalg.cholesky(K.astype(np.float64)), rtol=2e-4, atol=5e-5)
    assert np.all(np.triu(L, 1) == 0.0)
    assert hk.chol_batch_supported(n)


def test_posdef_cholesky_batched_cpu_uses_library_with_nan_contract():
    K = _pad_batch_with_indefinite(np.random.RandomState(8))
    Ks = torch.as_tensor(np.concatenate([K, K]))  # 8 matrices, on the CPU
    before = hk.chol_batch.launches
    L = np_(tla.posdef_cholesky_batched(Ks))
    assert hk.chol_batch.launches == before
    assert np.all(np.isnan(L[1])) and np.all(np.isnan(L[5]))
    np.testing.assert_allclose(L[0], np.linalg.cholesky(K[0].astype(np.float64)), rtol=2e-5, atol=1e-6)


def test_port_imports_without_jax():
    """tpubq_torch and all its modules import with JAX made unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import tpubq_torch, tpubq_torch.models.api, tpubq_torch.utils.convert\n"
        "assert 'tpubq' not in sys.modules, 'the port imported the JAX package'\n"
        "print(tpubq_torch.BQ.__name__)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "BQ"
