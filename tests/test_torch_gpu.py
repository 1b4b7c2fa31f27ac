"""The hand-written Hopper kernels of tpubq_torch on a CUDA card.

Every test here needs a CUDA device: it carries the ``gpu`` marker and skips
without one. The file imports neither JAX nor the JAX package, so it also runs
where JAX is not installed — on the card, from the repository root, with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest`` skips tests/conftest.py, which configures JAX).

Tolerances: each kernel against its plain PyTorch twin on the same card and
inputs — the batched Cholesky at rtol 2e-4 / atol 5e-5 (the pin of
tests/test_pallas.py for the TPU kernel), the ESM scorer at 1e-4 of the
largest score (f32 sums in another order; expf against torch.exp), the fused
MLL-and-gradient at 1e-4 relative on the MLL and 1e-3 of the row's largest
gradient entry, on well-conditioned rows (noise 0.1: condition ≤ ~1e4); the
two fleet scorer kernels, on fleets with noise 0.05, at 1e-4 of each problem's
largest value for m_a, c_a, A and the combined score and 1e-3 for B (a
quotient by the Schur complement), off the few points where the degenerate
masks differ.
"""

import numpy as np
import pytest
import torch

from tpubq_torch.models import acquire, batched
from tpubq_torch.ops import hopper_kernels as hk
from tpubq_torch.utils.options import BQOptions

pytestmark = pytest.mark.gpu

PARAMS_TL, PARAMS_L = (0.7, 0.8), (0.3, 0.4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see the module docstring)")
    return torch.device("cuda")


def _spd(rng, B, N):
    A = rng.randn(B, N, N)
    return (A @ np.transpose(A, (0, 2, 1)) + N * np.eye(N)).astype(np.float32)


def _testbed_bq(device, near_duplicate=False, max_obs=32):
    import tpubq_torch

    x = np.linspace(-2.2, 2.2, 10)
    if near_duplicate:
        x = np.sort(np.concatenate([x, [0.2 + 1e-4]]))
    l = np.exp(-0.5 * ((x - 0.2) / 0.5) ** 2) / (0.5 * np.sqrt(2.0 * np.pi))
    bq = tpubq_torch.BQ(x, l, device=device, dtype="float32", max_obs=max_obs, n_candidate=12,
                        candidate_thresh=0.2, x_mean=0.0, x_var=1.0)
    return bq.init(params_tl=PARAMS_TL, params_l=PARAMS_L)


@pytest.mark.parametrize("B,N", [(200, 32), (200, 44), (256, 80)])
def test_chol_batch_kernel_matches_plain(cuda, B, N):
    Ks = torch.as_tensor(_spd(np.random.RandomState(9), B, N), device=cuda)
    L = hk.chol_batch(Ks)
    torch.cuda.synchronize()
    torch.testing.assert_close(L, hk.chol_batch_plain(Ks), rtol=2e-4, atol=5e-5)
    assert bool((torch.triu(L, 1) == 0).all())


def test_chol_batch_kernel_large_n_dynamic_shared_memory(cuda):
    """n = 200 needs ~161 KB of shared memory per block (the opt-in path)."""
    Ks = torch.as_tensor(_spd(np.random.RandomState(2), 4, 200), device=cuda)
    L = hk.chol_batch(Ks)
    torch.cuda.synchronize()
    torch.testing.assert_close(L, hk.chol_batch_plain(Ks), rtol=2e-4, atol=5e-5)


def test_chol_batch_kernel_nan_confined(cuda):
    K = _spd(np.random.RandomState(3), 12, 9)
    K[4] = -K[4]
    L = hk.chol_batch(torch.as_tensor(K, device=cuda)).cpu().numpy()
    assert np.any(~np.isfinite(L[4]))
    assert np.all(np.isfinite(np.delete(L, 4, axis=0)))


@pytest.mark.parametrize("near_duplicate", [False, True])
def test_esm_fused_kernel_matches_plain(cuda, near_duplicate):
    bq = _testbed_bq(cuda, near_duplicate)
    grid = torch.linspace(-4.0, 4.0, 10_000, device=cuda)[:, None]
    args = acquire.esm_fused_inputs(bq.state, bq.options, grid)
    out = hk.esm_fused(*args)
    torch.cuda.synchronize()
    ref = hk.esm_fused_plain(*args)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def test_esm_fused_kernel_2d_matches_plain(cuda):
    """d = 2: the kernel's D = 2 instantiation (the packed ½(W_l + Σ)⁻¹ block
    and the two-coordinate sup-norm test) against its twin."""
    import tpubq_torch

    rng = np.random.RandomState(21)
    x = rng.uniform(-2.0, 2.0, (12, 2))
    l = np.exp(-0.5 * ((x - 0.2) ** 2).sum(1) / 0.5**2) / (2.0 * np.pi * 0.5**2)
    bq = tpubq_torch.BQ(x, l, device=cuda, dtype="float32", max_obs=32, n_candidate=12,
                        candidate_thresh=0.2, x_mean=np.zeros(2), x_var=np.array([[1.0, 0.3], [0.3, 0.8]]))
    bq.init(params_tl=(0.7, 0.8, 0.9), params_l=(0.3, 0.4, 0.5))
    grid = torch.as_tensor(rng.uniform(-3.0, 3.0, (4096, 2)), dtype=torch.float32, device=cuda)
    args = acquire.esm_fused_inputs(bq.state, bq.options, grid)
    out = hk.esm_fused(*args)
    torch.cuda.synchronize()
    ref = hk.esm_fused_plain(*args)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def test_esm_fused_kernel_large_capacity_reads_inverses_from_device_memory(cuda):
    """At max_obs = 256 the two inverses do not fit beside the k buffers, so
    the kernel reads them through L1; it must still match its twin."""
    bq = _testbed_bq(cuda, max_obs=256)
    NP, NP2 = bq.options.max_nsc, bq.options.max_obs
    assert hk._esm_launch_config(NP, NP2, 1)[1] == 0
    grid = torch.linspace(-4.0, 4.0, 3001, device=cuda)[:, None]
    args = acquire.esm_fused_inputs(bq.state, bq.options, grid)
    out = hk.esm_fused(*args)
    torch.cuda.synchronize()
    ref = hk.esm_fused_plain(*args)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def _mll_problem(rng, B, n, live, device):
    x = np.sort(rng.uniform(-2.2, 2.2, n))[:, None]
    y = np.sin(2.0 * x[:, 0]) + 0.05 * rng.randn(n)
    thetas = np.exp(np.log([0.7, 0.8]) + 0.4 * rng.randn(B, 2))
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(thetas, **f32), torch.as_tensor(x, **f32), torch.as_tensor(y, **f32),
            torch.arange(n, device=device) < live)


@pytest.mark.parametrize("B,n,live", [(10, 32, 10), (10, 44, 22), (1, 5, 5), (3, 167, 120)])
def test_mll_grad_kernel_matches_plain(cuda, B, n, live):
    """The fit's shapes (10, 32) and (10, 44), a tiny problem, and the largest
    supported n (two n × n matrices in 227 KB of shared memory)."""
    thetas, x, y, mask = _mll_problem(np.random.RandomState(5), B, n, live, cuda)
    assert hk.mll_grad_supported(n)
    before = hk.mll_grad_batched.launches
    mll, grad = hk.mll_grad_batched(thetas, 0.1, x, y, mask, jitter=1e-7)
    mll2, grad2 = hk.mll_grad_batched(thetas, torch.tensor(0.1, device=cuda), x, y, mask, jitter=1e-7)
    torch.cuda.synchronize()
    assert hk.mll_grad_batched.launches == before + 2
    assert torch.equal(mll, mll2) and torch.equal(grad, grad2)  # fixed summation order
    ref_mll, ref_grad = hk.mll_grad_batched_plain(thetas, 0.1, x, y, mask, 1e-7)
    torch.testing.assert_close(mll, ref_mll, rtol=1e-4, atol=0.0)
    scale = ref_grad.abs().amax(-1, keepdim=True)
    assert bool(((grad - ref_grad).abs() <= 1e-3 * scale).all())


def test_mll_grad_kernel_rejects_what_it_does_not_take(cuda):
    thetas, x, y, mask = _mll_problem(np.random.RandomState(6), 2, 168, 100, cuda)
    assert not hk.mll_grad_supported(168)
    with pytest.raises(ValueError, match="shared-memory budget"):
        hk.mll_grad_batched(thetas, 0.1, x, y, mask)
    thetas, x, y, mask = _mll_problem(np.random.RandomState(6), 2, 12, 12, cuda)
    with pytest.raises(TypeError):
        hk.mll_grad_batched(thetas.double(), 0.1, x, y, mask)
    with pytest.raises(ValueError):
        hk.mll_grad_batched(thetas, 0.1, x.cpu(), y, mask)


def test_fit_hypers_on_card_goes_through_the_kernel(cuda):
    bq = _testbed_bq(cuda)
    before = hk.mll_grad_batched.launches
    bq.fit_hypers(seed=0)
    assert hk.mll_grad_batched.launches == before + 2 * 151
    Z = np.exp(-0.5 * 0.2**2 / 1.25) / np.sqrt(2.0 * np.pi * 1.25)
    assert abs(bq.Z_mean() - Z) / Z < 5e-3


def test_wrappers_count_launches_and_reject_bad_input(cuda):
    Ks = torch.as_tensor(_spd(np.random.RandomState(1), 8, 6), device=cuda)
    before = hk.chol_batch.launches
    hk.chol_batch(Ks)
    assert hk.chol_batch.launches == before + 1
    with pytest.raises(TypeError):
        hk.chol_batch(Ks.double())
    with pytest.raises(ValueError):
        hk.chol_batch(Ks.transpose(1, 2))  # not contiguous


def test_main_path_on_card_goes_through_both_kernels(cuda):
    bq = _testbed_bq(cuda)
    e0, c0 = hk.esm_fused.launches, hk.chol_batch.launches
    x = bq.choose_next(np.linspace(-4.0, 4.0, 1001))
    zm, zv = bq.marginalize(n=8, seed=0)
    assert hk.esm_fused.launches == e0 + 1
    assert hk.chol_batch.launches == c0 + 1
    assert np.isfinite(x) and np.all(np.isfinite(zm)) and np.all(zv >= 0)


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------


def _fleet_data(B, n_obs, d=1, seed=0):
    rng = np.random.RandomState(seed)
    if d == 1:
        xs = np.stack([np.linspace(-2.2, 2.2, n_obs) + 0.03 * rng.standard_normal(n_obs) for _ in range(B)])
        mus = rng.uniform(-0.5, 0.5, B)
        return xs, np.exp(-0.5 * (xs - mus[:, None]) ** 2 / 0.25) / np.sqrt(2 * np.pi * 0.25)
    xs = rng.uniform(-2.0, 2.0, (B, n_obs, d))
    return xs, np.exp(-0.5 * (xs**2).sum(-1) / 0.5) / (2.0 * np.pi * 0.5)


def _fleet_state(device, B, n_obs, max_obs, n_candidate=12, d=1, s=0.05):
    xs, ls = _fleet_data(B, n_obs, d)
    opts = BQOptions(n_candidate=n_candidate, candidate_thresh=0.2, max_obs=max_obs, dim=d, dtype="float32")
    kw = dict(params_tl=(0.7,) + (0.8,) * d, params_l=(0.3,) + (0.4,) * d, s_tl=s, s_l=s, device=device)
    return batched.init_batch(xs, ls, opts, **kw), opts


def _normwise(a, b, where=None):
    diff = (a - b).abs() if where is None else (a - b).abs() * where
    return float((diff.amax(1) / b.abs().amax(1)).max())


@pytest.mark.parametrize("B,n_obs,max_obs,d", [(64, 10, 16, 1), (8, 8, 48, 1), (5, 9, 16, 2)])
def test_fleet_kernels_match_plain(cuda, B, n_obs, max_obs, d):
    """(NP, NP2) = (28, 16) at B = 64, (60, 48), and d = 2: both kernels against
    their plain versions, and one launch counted for each."""
    states, opts = _fleet_state(cuda, B, n_obs, max_obs, d=d)
    if d == 1:
        grid = torch.linspace(-4.0, 4.0, 5001, device=cuda)[:, None]
    else:
        grid = torch.as_tensor(np.random.RandomState(1).uniform(-3, 3, (3000, 2)), dtype=torch.float32, device=cuda)
    (params, w_l, *rest_l), (h2, w_tl, *rest_tl), zTa = batched.fleet_scorer_inputs(states, opts)
    lam = batched._LAM_F32
    before = hk.esm_fleet_l.launches, hk.esm_fleet_tl.launches
    A, Bc, dg = hk.esm_fleet_l(params, w_l, grid, *rest_l, 0.2, lam)
    m_a, c_a = hk.esm_fleet_tl(h2, w_tl, grid, *rest_tl)
    torch.cuda.synchronize()
    assert (hk.esm_fleet_l.launches, hk.esm_fleet_tl.launches) == (before[0] + 1, before[1] + 1)
    A0, B0, dg0 = hk.esm_fleet_l_plain(params, w_l, grid, *rest_l, 0.2, lam)
    m0, c0 = hk.esm_fleet_tl_plain(h2, w_tl, grid, *rest_tl)
    same = dg == dg0
    assert int((~same).sum()) <= 6
    assert _normwise(m_a, m0) <= 1e-4 and _normwise(c_a, c0) <= 1e-4
    assert _normwise(A, A0, same) <= 1e-4 and _normwise(Bc, B0, same) <= 1e-3

    def combine(A, Bc, dg, m, c):
        E1, E2 = acquire._lognormal_moments(m, c, states.gamma[:, None])
        return torch.where(dg > 0, (zTa * zTa)[:, None], A * A + 2.0 * A * Bc * E1 + Bc * Bc * E2)

    assert _normwise(combine(A, Bc, dg, m_a, c_a), combine(A0, B0, dg0, m0, c0), same) <= 1e-4
    # and through the dispatching entry point
    out = batched.expected_squared_mean_batch(states, opts, grid)
    assert hk.esm_fleet_l.launches == before[0] + 2 and out.shape == (B, grid.shape[0])


def test_fleet_kernels_raise_on_what_they_do_not_take(cuda):
    """A size beyond shared memory, a float64 tensor and a tensor on another
    device raise; nothing falls back to the plain version."""
    B, NP = 2, 224
    assert not hk.esm_fleet_l_supported(NP, 1)
    f = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
    grid = torch.linspace(-1, 1, 64, device=cuda)[:, None]
    with pytest.raises(ValueError, match="shared-memory budget"):
        hk.esm_fleet_l(f(B, hk.FLEET_PARAMS), f(B, 1), grid, f(B, NP, 1), f(B, NP), f(B, NP, NP), f(B, NP),
                       f(B, NP), 0.2, 1e-6)
    with pytest.raises(ValueError, match="shared-memory budget"):
        hk.esm_fleet_tl(f(B), f(B, 1), grid, f(B, NP, 1), f(B, NP), f(B, NP, NP), f(B, NP))
    states, opts = _fleet_state(cuda, 3, 8, 16)
    (params, w_l, *rest_l), (h2, w_tl, *rest_tl), _ = batched.fleet_scorer_inputs(states, opts)
    with pytest.raises(TypeError):
        hk.esm_fleet_tl(h2.double(), w_tl, grid, *rest_tl)
    with pytest.raises(ValueError, match="is on"):
        hk.esm_fleet_l(params.cpu(), w_l, grid, *rest_l, 0.2, 1e-6)


def test_mll_grad_kernel_per_problem_data_matches_plain(cuda):
    """640 rows on 64 problems' data in one launch against the twin, and a
    fleet of one problem against the shared-data form to the bit."""
    states, _ = _fleet_state(cuda, 64, 8, 32, s=0.1)
    x, y, mask, s = states.x_s, states.tl_s, states.obs_mask, states.gp_log_l.s
    rng = np.random.RandomState(3)
    thetas = torch.as_tensor(np.exp(np.log([0.7, 0.8]) + 0.4 * rng.randn(640, 2)), dtype=torch.float32, device=cuda)
    before = hk.mll_grad_batched.launches
    mll, grad = hk.mll_grad_batched(thetas, s, x, y, mask, jitter=1e-7)
    torch.cuda.synchronize()
    assert hk.mll_grad_batched.launches == before + 1
    ref_mll, ref_grad = hk.mll_grad_batched_plain(thetas, s, x, y, mask, 1e-7)
    torch.testing.assert_close(mll, ref_mll, rtol=1e-4, atol=1e-4)
    assert bool(((grad - ref_grad).abs() <= 1e-3 * ref_grad.abs().amax(-1, keepdim=True)).all())
    one = hk.mll_grad_batched(thetas[:10], s[:1], x[:1], y[:1], mask[:1], jitter=1e-7)
    shared = hk.mll_grad_batched(thetas[:10], s[0], x[0], y[0], mask[0], jitter=1e-7)
    assert torch.equal(one[0], shared[0]) and torch.equal(one[1], shared[1])
    assert torch.equal(one[0], mll[:10]) and torch.equal(one[1], grad[:10])


def test_fleet_default_device_is_the_card_and_goes_through_the_kernels(cuda):
    import tpubq_torch

    xs, ls = _fleet_data(8, 8)
    fleet = tpubq_torch.BQFleet(xs, ls, params_tl=PARAMS_TL, params_l=PARAMS_L, dtype="float32",
                                n_candidate=12, candidate_thresh=0.2, max_obs=16, s=0.01)
    assert fleet.device.type == "cuda" and fleet.states.gp_l.Kinv.is_cuda
    counts = lambda: (hk.esm_fleet_l.launches, hk.esm_fleet_tl.launches, hk.esm_fused.launches,  # noqa: E731
                      hk.chol_batch.launches, hk.mll_grad_batched.launches)
    c0 = counts()
    fleet.fit(seed=0)
    c1 = counts()
    assert c1[4] == c0[4] + 2 * 151 and c1[:3] == c0[:3]
    x_next = fleet.choose_next(np.linspace(-4.0, 4.0, 2001))
    c2 = counts()
    assert c2[0] == c1[0] + 1 and c2[1] == c1[1] + 1 and c2[2] == c1[2]
    fleet.add_observation(x_next, np.full(8, 0.3))
    c3 = counts()
    assert c3[3] >= c2[3] + 2 and fleet.ns.tolist() == [9] * 8
    assert np.all(np.isfinite(fleet.Z_mean())) and np.all(fleet.Z_var() >= 0)
