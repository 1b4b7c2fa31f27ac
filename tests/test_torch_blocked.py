"""The large-matrix kernels of the port (tpubq_torch.ops.hopper_kernels:
gaussian_gram, cholesky_blocked, tri_solve_blocked, cholesky_batched) in
their plain versions, against the Pallas kernels of the JAX package in
interpret mode, and the routes that send a float32 problem on the card to
them (``linalg``, ``kernels.gaussian_K``, ``acquire.esm_route``), followed on
the CPU through the plain versions.

Sizes are small but cross panels: the JAX wrappers take ``block=`` (16 rows
here, so N = 40 has three panels and a ragged last one). Tolerances: the
pins of tests/test_pallas.py — the Gram at atol 1e-6, the blocked Cholesky at
rtol 2e-5 / atol 2e-4, the blocked solve at rtol 2e-4 / atol 2e-4, the batched
Cholesky at atol 5e-5; float32 against float32 on other summation orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import util as tu
from tests.torch_parity import np_
from tpubq.ops import pallas_kernels as pk
from tpubq_torch.models import acquire as tacq, bq as tbq, gp as tgp
from tpubq_torch.ops import hopper_kernels as hk
from tpubq_torch.ops import kernels as tk
from tpubq_torch.ops import linalg as tla
from tpubq_torch.utils.options import BQOptions


def _spd(rng, N, dtype=np.float32):
    A = rng.randn(N, N)
    return (A @ A.T + N * np.eye(N)).astype(dtype)


def _f32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


@pytest.mark.parametrize("n1,n2,d", [(50, 300, 1), (20, 40, 3), (1, 37, 2), (33, 5, 3), (7, 1, 1)])
def test_gaussian_gram_plain_matches_pallas(n1, n2, d):
    rng = np.random.RandomState(7 + d)
    theta = np.concatenate([[1.3], rng.uniform(0.5, 1.1, d)]).astype(np.float32)
    x1, x2 = rng.randn(n1, d).astype(np.float32), rng.randn(n2, d).astype(np.float32)
    want = np.asarray(pk.gaussian_gram(jnp.asarray(theta), jnp.asarray(x1), jnp.asarray(x2), tile=16))
    got = hk.gaussian_gram(_f32(theta), _f32(x1), _f32(x2))  # a CPU tensor takes the plain version
    np.testing.assert_allclose(np_(got), want, atol=1e-6)
    # the plain version runs kernels.gaussian_K's operations in its order
    assert torch.equal(got, tk.gaussian_K(_f32(theta), _f32(x1), _f32(x2)))


def test_gaussian_gram_closed_form_backward_matches_autograd():
    """The backward of the kernel's autograd node (``gaussian_gram_vjp``)
    against autograd through the plain Gram, in float64 at rtol 1e-12."""
    rng = np.random.RandomState(3)
    theta = torch.tensor([1.2, 0.7, 0.9], dtype=torch.float64, requires_grad=True)
    x1 = torch.tensor(rng.randn(6, 2), requires_grad=True)
    x2 = torch.tensor(rng.randn(9, 2), requires_grad=True)
    G = torch.tensor(rng.randn(6, 9))
    K = hk.gaussian_gram_plain(theta, x1, x2)
    want = torch.autograd.grad((K * G).sum(), (theta, x1, x2))
    got = hk.gaussian_gram_vjp(theta.detach(), x1.detach(), x2.detach(), K.detach(), G)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-14)


def test_cholesky_blocked_plain_matches_pallas():
    """The left-looking tiled plain factor (the kernel's algebra) against the
    Pallas kernel in interpret mode: at the kernel's 64-wide tile (one ragged
    tile) through the wrapper, and at 16-wide tiles (three tile-columns, the
    last one ragged); only the lower triangle is read."""
    K = _spd(np.random.RandomState(1), 40)
    want = np.asarray(pk.cholesky_blocked(jnp.asarray(K), block=16))
    L = hk.cholesky_blocked(_f32(K))
    np.testing.assert_allclose(np_(L), want, rtol=2e-5, atol=2e-4)
    assert bool((torch.triu(L, 1) == 0).all())
    Lt = hk.cholesky_blocked_plain(_f32(K) + torch.triu(torch.full((40, 40), 1e30), 1), tile=16)
    np.testing.assert_allclose(np_(Lt), want, rtol=2e-5, atol=2e-4)
    assert bool((torch.triu(Lt, 1) == 0).all())
    assert hk.cholesky_blocked_launches(40) == 1 and hk.cholesky_blocked_launches(1036) == 1


def test_cholesky_blocked_and_batched_nan_where_a_pivot_clamps():
    """A matrix that is not positive definite gives a NaN factor (its pivot
    was clamped), in its own entry of a stack only."""
    rng = np.random.RandomState(4)
    bad = -_spd(rng, 21)
    assert bool(torch.isnan(hk.cholesky_blocked(_f32(bad))).all())
    late = _spd(rng, 40)
    late[37, 37] = -1.0  # a pivot of the ragged last 16-wide tile
    assert bool(torch.isnan(hk.cholesky_blocked_plain(_f32(late), tile=16)).all())
    Ks = np.stack([_spd(rng, 21) for _ in range(5)])
    Ks[2] = bad
    L = hk.cholesky_batched(_f32(Ks))
    fin = torch.isfinite(L).all(-1).all(-1).tolist()
    assert fin == [True, True, False, True, True]


@pytest.mark.parametrize("n,panel,pivots", [(40, 16, (20, 38)), (150, 64, (100, 140))])
def test_cholesky_batched_plain_nan_confined_past_the_first_panel(n, panel, pivots):
    """A pivot that clamps in the second panel (matrix 1) or in the ragged
    last one (matrix 3) makes NaN of its own matrix only; the other factors
    match the Pallas kernel at atol 5e-5."""
    rng = np.random.RandomState(n)
    Ks = np.stack([_spd(rng, n) for _ in range(5)])
    Ks[1, pivots[0], pivots[0]] = -1.0
    Ks[3, pivots[1], pivots[1]] = -1.0
    L = hk.cholesky_batched_plain(_f32(Ks), panel=panel)
    assert torch.isfinite(L).all(-1).all(-1).tolist() == [True, False, True, False, True]
    assert bool(torch.isnan(L[[1, 3]]).all())
    keep = [0, 2, 4]
    want = np.asarray(pk.cholesky_batched(jnp.asarray(Ks[keep])))
    np.testing.assert_allclose(np_(L[keep]), want, atol=5e-5)


@pytest.mark.parametrize("M", [1, 7, 40])
def test_tri_solve_blocked_plain_matches_pallas(M):
    """The blocked forward substitution of the plain version (diagonal blocks
    inverted by recursive doubling, as the kernel does) at 16-row blocks, the
    Pallas kernel's blocking here, and at the kernel's 64 (one ragged block),
    against the Pallas kernel in interpret mode at rtol / atol 2e-4; M = 40
    solves against the identity (L⁻¹, as linalg.chol_inverse does)."""
    rng = np.random.RandomState(2)
    L = np.linalg.cholesky(_spd(rng, 40).astype(np.float64)).astype(np.float32)
    R = np.eye(40, dtype=np.float32) if M == 40 else rng.randn(40, M).astype(np.float32)
    want = np.asarray(pk.tri_solve_blocked(jnp.asarray(L), jnp.asarray(R), block=16))
    for block in (16, hk.TRI_BLOCK):
        got = hk.tri_solve_blocked_plain(_f32(L), _f32(R), block=block)
        np.testing.assert_allclose(np_(got), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np_(hk.tri_solve_blocked(_f32(L), _f32(R))), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n,panel", [(21, hk.CHOL_BATCHED_PANEL), (40, 16)])
def test_cholesky_batched_plain_matches_pallas(n, panel):
    """The panelled plain factor against the Pallas kernel's column recursion
    in interpret mode at atol 5e-5: one ragged panel (n = 21), and n = 40 at
    16-wide panels (three panels, the last one ragged)."""
    rng = np.random.RandomState(7)
    Ks = np.stack([_spd(rng, n) for _ in range(9)])
    want = np.asarray(pk.cholesky_batched(jnp.asarray(Ks)))
    L = hk.cholesky_batched_plain(_f32(Ks), panel=panel)
    np.testing.assert_allclose(np_(L), want, atol=5e-5)
    assert bool((torch.triu(L, 1) == 0).all())
    if panel == hk.CHOL_BATCHED_PANEL:
        assert torch.equal(hk.cholesky_batched(_f32(Ks)), L)  # a CPU tensor takes the plain version


def test_lower_inverse_doubling_matches_the_inverse():
    """The recursive doubling of the kernels' diagonal blocks (16 × 16 leaves,
    then levels of 16, 32) against the float64 inverse, at 64 rows in float32:
    rtol 1e-5 normwise on a well-conditioned factor; zeros above the
    diagonal; the upper triangle of the input is not read."""
    rng = np.random.RandomState(11)
    L64 = np.linalg.cholesky(_spd(rng, 64).astype(np.float64))
    L = _f32(L64) + torch.triu(torch.full((64, 64), 1e30), 1)
    Y = hk.lower_inverse_doubling(L)
    want = np.linalg.inv(L64)
    assert float(np.abs(np_(Y) - want).max() / np.abs(want).max()) < 1e-5
    assert bool((torch.triu(Y, 1) == 0).all())


@pytest.mark.parametrize("n,blocked,solve,batched", [(40, 1, 1, 1), (128, 1, 1, 4), (256, 1, 1, 10),
                                                     (1024, 1, 1, 46), (1036, 1, 1, 49)])
def test_launch_counts_at_the_path_shapes(n, blocked, solve, batched):
    """CUDA launches per call: cholesky_blocked and tri_solve_blocked one
    launch whatever n (and the number of columns); cholesky_batched
    3⌈n/64⌉ − 2 whatever the batch (max_obs 256 … 1024 rung stacks, the linear
    GP's 1036 rows at max_obs 1024)."""
    assert hk.cholesky_blocked_launches(n) == blocked
    assert hk.tri_solve_blocked_launches(n) == solve
    assert hk.cholesky_batched_launches(n) == batched
    assert hk.cholesky_blocked_launches(0) == hk.tri_solve_blocked_launches(0) == hk.cholesky_batched_launches(0) == 0


@pytest.mark.parametrize("lower", [True, False])
def test_tri_solve_kernel_route_batches_rhs_as_columns(lower):
    """The kernel route of ``linalg.tri_solve`` (batch entries as columns; an
    upper factor solved forward on the flipped copy) against the library's
    triangular solve, float32 at rtol 1e-5 on a well-conditioned factor."""
    rng = np.random.RandomState(5)
    L = _f32(np.linalg.cholesky(_spd(rng, 30).astype(np.float64)))
    T = L if lower else L.T
    b = _f32(rng.randn(3, 2, 30, 4))
    want = torch.linalg.solve_triangular(T, b, upper=not lower)
    torch.testing.assert_close(tla._tri_solve_kernel(T, b, lower), want, rtol=1e-5, atol=1e-6)


@pytest.fixture
def card_routes(monkeypatch):
    """Every route takes its card branch on the CPU: the wrappers, given CPU
    tensors, run their plain versions, and each call is counted."""
    calls = {}
    monkeypatch.setattr(hk, "on_card", lambda t: True)
    for name in ("gaussian_gram", "cholesky_blocked", "tri_solve_blocked", "chol_batch",
                 "cholesky_batched", "esm_fused"):
        fn = getattr(hk, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a)

        monkeypatch.setattr(hk, name, counted)
    return calls


def _state(max_obs, n=10, s=0.05, dtype="float32"):
    opts = BQOptions(n_candidate=12, candidate_thresh=0.2, max_obs=max_obs, dtype=dtype)
    x = np.linspace(-2.2, 2.2, n)
    return tbq.init_state(x, tu.f_l(x), opts, params_tl=(0.7, 0.8), params_l=(0.3, 0.4), s_tl=s, s_l=s,
                          device="cpu"), opts


def test_refit_on_the_kernel_routes_matches_the_library_route(card_routes):
    """One float32 refit along the card's routes (Grams on gaussian_gram, the
    ladder on cholesky_blocked, alpha and K⁻¹ = YᵀY on tri_solve_blocked)
    against the library route on the same state: rtol 1e-4 on the factors,
    alpha and K⁻¹ normwise (float32, κ ≈ 1e3)."""
    st, opts = _state(32)
    card_routes.clear()
    routed = tbq._fit_gps(st, opts)
    counts = dict(card_routes)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hk, "on_card", lambda t: False)
        plain = tbq._fit_gps(st, opts)
    assert counts == {"gaussian_gram": 3, "cholesky_blocked": 2, "tri_solve_blocked": 6}
    for name in ("gp_log_l", "gp_l"):
        a, b = getattr(routed, name), getattr(plain, name)
        for f in ("L", "alpha", "Kinv"):
            x, y = getattr(a, f), getattr(b, f)
            assert float((x - y).abs().max() / y.abs().max()) < 1e-4, (name, f)
        assert bool(a.ok)


def test_marginalize_routes(card_routes):
    """marginalize's batched refit: chol_batch up to 240 rows, cholesky_batched
    above; the linear GP (one factor, a batch of right-hand sides) on
    cholesky_blocked and tri_solve_blocked."""
    from tpubq_torch.models import marginalize as tmarg

    thetas = torch.tensor([[0.7, 0.8], [0.6, 0.9], [0.8, 0.7]], dtype=torch.float32)
    for max_obs, batched in ((32, "chol_batch"), (244, "cholesky_batched")):
        st, opts = _state(max_obs)
        card_routes.clear()
        zm, zv = tmarg.marginalize(st, opts, thetas)
        assert card_routes.get(batched) == 1
        assert "chol_batch" not in card_routes or batched == "chol_batch"
        assert card_routes["cholesky_blocked"] == 1 and card_routes["tri_solve_blocked"] == 2
        assert bool(torch.isfinite(zm).all() and (zv >= 0).all())


@pytest.mark.parametrize("NP,NP2,d", [(28, 16, 1), (44, 32, 1), (48, 32, 2), (268, 256, 1), (1036, 1024, 1),
                                      (1036, 1024, 3), (2060, 2048, 1)])
def test_esm_fused_launches_at_the_path_shapes(NP, NP2, d):
    """esm_fused: two launches at every size (the tiled products, then the
    per-point finish): a small state's 28 rows, the main path's 44 and
    max_obs 256 … 2048 of the large-N path."""
    assert hk.esm_fused_launches(NP, NP2, d) == 2
    assert hk.esm_fused_supported(NP, NP2, d)


def test_esm_route_by_size(card_routes):
    """esm_fused for every float32 gaussian state, max_obs 2048 included (the
    kernel has no shared-memory cap); there, followed on the CPU along
    the card's route (esm_fused's plain version), it equals the plain scorer
    expected_squared_mean_xla at 1e-4 of the largest score, off at most 2
    points (degenerate-mask flips between two float32 evaluations)."""
    st, opts = _state(32)
    assert tacq.esm_route(st, opts) == "esm_fused"
    st, opts = _state(2048, s=0.01)
    assert tacq.esm_route(st, opts) == "esm_fused"
    assert hk.esm_fused_supported(2060, 2048, 1) and hk.esm_fused_supported(1036, 1024, 1)
    grid = torch.linspace(-4.0, 4.0, 101)[:, None]
    card_routes.clear()
    got = tacq.expected_squared_mean(st, opts, grid)
    assert card_routes == {"esm_fused": 1}
    want = tacq.expected_squared_mean_xla(st, opts, grid)
    off = (got - want).abs() > 1e-4 * float(want.abs().max())
    assert int(off.sum()) <= 2


def test_gp_fit_unbatched_kinv_is_symmetric_on_the_route(card_routes):
    st, _ = _state(32)
    gp = tgp.gp_fit(tk.gaussian_K, st.gp_l.theta, st.gp_l.s, st.x_sc, st.l_sc, st.sc_mask)
    assert torch.equal(gp.Kinv, gp.Kinv.T)
