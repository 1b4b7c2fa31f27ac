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
gradient entry, on well-conditioned rows (noise 0.1: condition ≤ ~1e4).
"""

import numpy as np
import pytest
import torch

from tpubq_torch.models import acquire
from tpubq_torch.ops import hopper_kernels as hk

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
