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
gradient entry, on well-conditioned rows (noise 0.1: condition ≤ ~1e4), and
on the large-N recipe's Grams (s = 0.05) at max(that, 4·eps32·κ) per row; the
two fleet scorer kernels, on fleets with noise 0.05 and on float64 GP
posteriors with noise 0.1 at the tiles' edges (there the plain float32
version is within 1.6e-5 of float64), at 1e-4 of each problem's largest
value for m_a, c_a, A and the combined score and 1e-3 for B (a quotient by
the Schur complement), off the few points where the degenerate masks differ,
bit-identical from call to call; the large-max_obs kernels on Grams of the large-N recipe at
s = 0.05 (κ up to ~1e5): the Gram at 1e-6 of h², the two Choleskys at a
backward error of n·eps32 and within max(1e-4, 2 × the library's distance)
of the plain (unblocked / panelled) factor, the blocked solve within
max(1e-4, 2 × the library's distance) of float64 and within 1e-4 of its plain
blocked substitution, bit-identical from call to call. The C++ oracle
(``tpubq_torch.utils.native``, built with the host's g++) is held to the
port's float64 scorer on the card at rtol 1e-8, tests/test_native.py's pin.
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


# (12800, n): the fleet's marginalize at B = 64 and 100 rows, both rungs
@pytest.mark.parametrize("B,N", [(200, 32), (200, 44), (256, 80), (12800, 32), (12800, 44)])
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


# the edges of chol_batch's regimes (picked by csrc/chol_batch.cu): one panel of 16
# or 32 columns up to 32 rows, a warp padded to 48 or 64 columns up to 64,
# panels of 32 from 65 rows to the route's 240 (three to eight panels,
# ragged last panels); 238 is the last n whose rows are padded to a stride
# of 4 mod 8 in shared memory
CHOL_EDGES = (1, 15, 16, 17, 31, 32, 33, 44, 48, 49, 63, 64, 65, 128, 140, 200, 238, 240)


@pytest.mark.parametrize("B", [1, 2, 200])
@pytest.mark.parametrize("n", CHOL_EDGES)
def test_chol_batch_kernel_matches_plain_at_regime_edges(cuda, n, B):
    """Against the twin at rtol 2e-4 / atol 5e-5, exact zeros above the
    diagonal; the upper triangle of the input is filled with NaN, which
    the kernel must not read into the factor."""
    K = _spd(np.random.RandomState(n + B), B, n)
    Ks = torch.as_tensor(K, device=cuda)
    dirty = torch.as_tensor(np.where(np.triu(np.ones((n, n), bool), 1), np.nan, K).astype(np.float32), device=cuda)
    L = hk.chol_batch(dirty)
    torch.cuda.synchronize()
    torch.testing.assert_close(L, hk.chol_batch_plain(Ks), rtol=2e-4, atol=5e-5)
    assert bool((torch.triu(L, 1) == 0).all())


@pytest.mark.parametrize("n", [9, 30, 44, 64, 100, 240])
def test_chol_batch_kernel_nan_confined_in_each_regime(cuda, n):
    """An indefinite matrix (first pivot negative) and one that fails at its
    last pivot get NaN in their own factors only; every other factor is
    finite and matches the twin; exact zeros above every diagonal."""
    K = _spd(np.random.RandomState(n), 7, n)
    K[2] = -K[2]
    K[5, n - 1, n - 1] = -1.0e4 * n  # a negative Schur complement at the last step
    Ks = torch.as_tensor(K, device=cuda)
    L = hk.chol_batch(Ks)
    torch.cuda.synchronize()
    fin = torch.isfinite(L).flatten(1).all(1).cpu().numpy()
    assert not fin[2] and not fin[5] and fin[[0, 1, 3, 4, 6]].all()
    keep = torch.tensor([0, 1, 3, 4, 6], device=cuda)
    torch.testing.assert_close(L[keep], hk.chol_batch_plain(Ks[keep]), rtol=2e-4, atol=5e-5)
    assert bool((torch.triu(L, 1) == 0).all())


def _chol_batch_entry(Ks, B: int, n: int, panels_only: int):
    """csrc/chol_batch.cu's C entry on (B, n) and the buffer Ks → (cudaError, L)."""
    from tpubq_torch.ops import _build

    L = torch.empty_like(Ks)
    err = _build.library().tpubq_chol_batch(Ks.data_ptr(), L.data_ptr(), B, n, panels_only,
                                            torch.cuda.current_stream(Ks.device).cuda_stream)
    torch.cuda.synchronize()
    return err, L


@pytest.mark.parametrize("n", [33, 44, 63, 64])
def test_chol_batch_panels_of_32_in_the_warp_regime(cuda, n):
    """Two panels of 32 columns (two diagonal blocks and a panel between)
    where the warp regime would factor the matrix, forced through the C
    entry's panels_only, as profile_main_path.py's ``chol_panels`` does."""
    Ks = torch.as_tensor(_spd(np.random.RandomState(n), 6, n), device=cuda)
    err, L = _chol_batch_entry(Ks, 6, n, 1)
    assert err == 0
    torch.testing.assert_close(L, hk.chol_batch_plain(Ks), rtol=2e-4, atol=5e-5)
    assert bool((torch.triu(L, 1) == 0).all())


def test_chol_batch_entry_takes_every_n_of_the_route(cuda):
    """The C entry picks a launch for every n = 1 … 240, in its own regime
    and in panels (panels_only), each against the twin; it refuses B = 0,
    n = 0 and n = 241 before any launch."""
    rng = np.random.RandomState(11)
    for n in range(1, hk.CHOL_BATCH_MAX_N + 1):
        Ks = torch.as_tensor(_spd(rng, 3, n), device=cuda)
        ref = hk.chol_batch_plain(Ks)
        for panels_only in (0, 1):
            err, L = _chol_batch_entry(Ks, 3, n, panels_only)
            assert err == 0, (n, panels_only)
            torch.testing.assert_close(L, ref, rtol=2e-4, atol=5e-5)
            assert bool((torch.triu(L, 1) == 0).all())
    Ks = torch.zeros((1, 1, 1), device=cuda)
    for B, n in ((0, 32), (3, 0), (3, hk.CHOL_BATCH_MAX_N + 1)):
        assert _chol_batch_entry(Ks, B, n, 0)[0] != 0


@pytest.mark.parametrize("n", [44, 48])
def test_chol_batch_kernel_on_a_view_off_16_byte_alignment(cuda, n):
    """A contiguous stack that starts 4 bytes past an allocation: the warp
    regime reads its rows a float at a time there (float4 loads would fault)."""
    B = 5
    K = torch.as_tensor(_spd(np.random.RandomState(n), B, n), device=cuda)
    Ks = torch.empty(1 + B * n * n, device=cuda)[1:].view(B, n, n)
    Ks.copy_(K)
    assert Ks.is_contiguous() and Ks.data_ptr() % 16 == 4
    L = hk.chol_batch(Ks)
    torch.cuda.synchronize()
    torch.testing.assert_close(L, hk.chol_batch_plain(K), rtol=2e-4, atol=5e-5)
    assert bool((torch.triu(L, 1) == 0).all())


@pytest.mark.parametrize("B,n", [(200, 32), (128, 44), (200, 128), (4, 240)])
def test_chol_batch_kernel_is_bit_identical_from_call_to_call(cuda, B, n):
    Ks = torch.as_tensor(_spd(np.random.RandomState(5), B, n), device=cuda)
    first = hk.chol_batch(Ks)
    for _ in range(3):
        assert torch.equal(hk.chol_batch(Ks), first)


@pytest.mark.parametrize("near_duplicate", [False, True])
def test_esm_fused_kernel_matches_plain(cuda, near_duplicate):
    bq = _testbed_bq(cuda, near_duplicate)
    grid = torch.linspace(-4.0, 4.0, 10_000, device=cuda)[:, None]
    args = acquire.esm_fused_inputs(bq.state, bq.options, grid)
    out = hk.esm_fused(*args)
    torch.cuda.synchronize()
    ref = hk.esm_fused_plain(*args)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def test_expected_squared_mean_fused_is_one_kernel_call_and_the_route(cuda):
    """The public fused entry makes one ``esm_fused`` call (its launches, no
    more) and returns what ``expected_squared_mean`` routes to, bit for bit."""
    bq = _testbed_bq(cuda)
    st, opts = bq.state, bq.options
    grid = torch.linspace(-4.0, 4.0, 10_000, device=cuda)
    before = hk.esm_fused.launches
    got = acquire.expected_squared_mean_fused(st, opts, grid)
    torch.cuda.synchronize()
    assert hk.esm_fused.launches - before == hk.esm_fused_launches(opts.max_nsc, opts.max_obs, 1)
    assert torch.equal(got, acquire.expected_squared_mean(st, opts, grid))


def test_native_esm_grid_matches_the_float64_path_on_the_card(cuda):
    """The C++ oracle (host, float64) against the port's float64 scorer on the
    card over 10⁴ points, the testbed at s = 0: rtol 1e-8, the pin of
    tests/test_native.py."""
    import tpubq_torch
    from tpubq_torch.utils import native

    x = np.linspace(-2.2, 2.2, 10)
    l = np.exp(-0.5 * ((x - 0.2) / 0.5) ** 2) / (0.5 * np.sqrt(2.0 * np.pi))
    bq = tpubq_torch.BQ(x, l, device=cuda, dtype="float64", max_obs=32, n_candidate=12,
                        candidate_thresh=0.2, x_mean=0.0, x_var=1.0)
    bq.init(params_tl=PARAMS_TL, params_l=PARAMS_L)
    grid = np.linspace(-4.0, 4.0, 10_000)
    got = acquire.expected_squared_mean(bq.state, bq.options, torch.as_tensor(grid, device=cuda)).cpu().numpy()
    np.testing.assert_allclose(got, native.esm_grid_state(bq.state, bq.options, grid), rtol=1e-8)


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
    """At max_obs = 256 (NP 268) the kernel streams the two inverses from
    device memory in two launches; it must still match its twin."""
    bq = _testbed_bq(cuda, max_obs=256)
    NP, NP2 = bq.options.max_nsc, bq.options.max_obs
    assert hk.esm_fused_launches(NP, NP2, 1) == 2
    grid = torch.linspace(-4.0, 4.0, 3001, device=cuda)[:, None]
    args = acquire.esm_fused_inputs(bq.state, bq.options, grid)
    before = hk.esm_fused.launches
    out = hk.esm_fused(*args)
    torch.cuda.synchronize()
    assert hk.esm_fused.launches == before + 2
    ref = hk.esm_fused_plain(*args)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def _esm_state(device, NP, d):
    """A float32 state with NP = max_obs + 12 rows, filled with observations
    (the large-N recipe at d = 1; uniform points under a gaussian bump at
    d = 2), s = 0.05."""
    import tpubq_torch

    max_obs = NP - 12
    if d == 1:
        return _large_n_state(device, max_obs)
    x = np.random.RandomState(NP).uniform(-2.0, 2.0, (max_obs - 4, 2))
    l = np.exp(-0.5 * ((x - 0.2) ** 2).sum(1) / 0.5**2) / (2.0 * np.pi * 0.5**2) + 1e-3
    bq = tpubq_torch.BQ(x, l, device=device, dtype="float32", max_obs=max_obs, n_candidate=12,
                        candidate_thresh=1e-3, s=0.05, x_mean=np.zeros(2), x_var=np.array([[1.0, 0.3], [0.3, 0.8]]))
    bq.init(params_tl=(0.7, 0.8, 0.9), params_l=(0.3, 0.4, 0.5))
    return bq.state, bq.options


def _guard_band(args, idx):
    """Whether grid points ``idx`` sit in the guard's float32 noise band:
    |γ − thr| ≤ λ·ρ·κ·Σk, with γ = κ − kᵀK⁻¹k and Σk in float64 from the
    packed float32 inputs, thr = max(eps32·κ, noise_mult·Σk) the launch's
    threshold and λ·ρ·κ the production guard's factor (the packed
    noise_mult of ``esm_fused_inputs``)."""
    params, grid, xsc, msc, Kinv = (a.double() for a in args[:5])
    d = xsc.shape[1]
    kappa, noise_mult = params[1], params[8 + 3 * d + d * d]
    r2 = (((xsc[:, None, :] - grid[idx][None]) ** 2) * params[8:8 + d]).sum(-1)
    k = params[0] * torch.exp(-r2) * msc[:, None]
    gam = kappa - (k * (Kinv @ k)).sum(0)
    thr = torch.clamp(noise_mult * k.sum(0), min=torch.finfo(torch.float32).eps * float(kappa))
    lam_rho_kappa = float(acquire._LAM_F32 * Kinv.abs().sum(1).amax() * kappa)
    return (gam - thr).abs() <= lam_rho_kappa * k.sum(0)


def _esm_close(args, out, ref):
    """Within 1e-4 of the largest score, except at most max(2, 1% of the
    grid) points, each within the guard's float32 noise band (_guard_band),
    where two float32 sums of γ in another order may fall on either side of
    the threshold, or leave a γ just past it with few bits."""
    off = torch.nonzero((out - ref).abs() > 1e-4 * float(ref.abs().max()))[:, 0]
    assert bool(torch.isfinite(out).all())
    assert len(off) <= max(2, out.shape[0] // 100), len(off)
    assert bool(_guard_band(args, off).all()), off.tolist()


@pytest.mark.parametrize("NP,d,G", [(28, 1, 1000), (44, 1, 10_000), (300, 1, 3001), (1036, 1, 512), (2060, 1, 777),
                                    (28, 2, 777), (44, 2, 4097), (300, 2, 1000), (1036, 2, 513)])
def test_esm_fused_kernel_matches_plain_at_every_size(cuda, NP, d, G):
    """The kernel against its twin at NP 28, 44, 300, 1036 and 2060 (ragged
    grids and ragged column tiles), d = 1 and 2: the exact launch count, the
    twin's scores (_esm_close) under the production guard and, up to NP 1036,
    under the TPU kernel's own eps·κ guard (noise_mult = 0), and the same
    bits from two calls. At NP 2060 the eps·κ guard scores points whose γ is
    up to ~1.5 × float32's noise λ·ρ·κ·Σk, a quotient by rounding in either
    evaluation: chip_smoke.py's esm_beyond_1024 prints how many and how far
    (a quarter of this grid)."""
    st, opts = _esm_state(cuda, NP, d)
    assert st.x_sc.shape[0] == NP
    rng = np.random.RandomState(G)
    grid = torch.as_tensor(rng.uniform(-3.0, 3.0, (G, d)), dtype=torch.float32, device=cuda)
    args = list(acquire.esm_fused_inputs(st, opts, grid))
    for guard in ("adaptive", "tpu") if NP <= 1036 else ("adaptive",):
        if guard == "tpu":
            args[0] = args[0].clone()
            args[0][-1] = 0.0
        before = hk.esm_fused.launches
        out = hk.esm_fused(*args)
        torch.cuda.synchronize()
        assert hk.esm_fused.launches == before + hk.esm_fused_launches(NP, opts.max_obs, d)
        _esm_close(args, out, hk.esm_fused_plain(*args))
        assert torch.equal(out, hk.esm_fused(*args))


def _mll_problem(rng, B, n, live, device):
    x = np.sort(rng.uniform(-2.2, 2.2, n))[:, None]
    y = np.sin(2.0 * x[:, 0]) + 0.05 * rng.randn(n)
    thetas = np.exp(np.log([0.7, 0.8]) + 0.4 * rng.randn(B, 2))
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(thetas, **f32), torch.as_tensor(x, **f32), torch.as_tensor(y, **f32),
            torch.arange(n, device=device) < live)


def _large_n_mll_case(device, n):
    """The large-N recipe's data at s = 0.05 (``_large_n_state``): the log-GP
    at max_obs 300 (n = 300), or the linear GP at max_obs 1024 (n = 1036),
    with 10 θ rows around the recipe's hypers."""
    linear = n == 1036
    st, _ = _large_n_state(device, n - 12 if linear else n)
    if linear:
        x, y, mask, theta0 = st.x_sc, torch.where(st.sc_mask, st.l_sc, torch.zeros_like(st.l_sc)), st.sc_mask, PARAMS_L
    else:
        x, y, mask, theta0 = st.x_s, st.tl_s, st.obs_mask, PARAMS_TL
    assert x.shape[0] == n
    rng = np.random.RandomState(8)
    thetas = torch.as_tensor(np.exp(np.log(theta0) + 0.4 * rng.randn(10, 2)), dtype=torch.float32, device=device)
    return thetas, x, y, mask, 0.05


def _live_condition(thetas, x, mask, s, jitter):
    """Each row's live Gram condition number, float64 on the card."""
    xl = x[mask].double()
    th = thetas.double()
    K = th[:, :1, None] ** 2 * torch.exp(-0.5 * ((xl - xl.T)[None] / th[:, 1:, None]) ** 2)
    K = K + torch.eye(xl.shape[0], dtype=torch.float64, device=x.device) * (s**2 + jitter * th[:, :1, None] ** 2)
    ev = torch.linalg.eigvalsh(K)
    return (ev[:, -1] / ev[:, 0]).cpu()


@pytest.mark.parametrize("n", [5, 32, 44, 64, 65, 128, 129, 167, 300, 1036])
def test_mll_grad_kernel_matches_plain(cuda, n):
    """B = 10 rows at both regimes and their edges: one block per row up to
    64 rows (NP = 16, 32, 64 with identity pads), 64 × 64 tiles above (65
    and 129: one row in the last tile). Up to 167 rows well-conditioned rows
    (noise 0.1), held at 1e-4 relative on the MLL and 1e-3 of the row's
    largest gradient entry; in the tiles |MLL| is floored at the live count
    (the size of the terms it sums: a row can sit near MLL = 0). At 300 and
    1036 the large-N recipe's data (s = 0.05), by chip_smoke.py's rule: the
    MLL at max(1e-4, 4·eps32·κ) of the twin, κ the row's live Gram condition
    number in float64; the gradient, whose n² terms cancel (the twin's own is
    up to ~20·eps32·κ off), at max(1e-3, 4·eps32·κ) of float64. Two calls
    are bit-identical."""
    if n <= 167:
        live = {5: 5, 32: 10, 44: 22, 64: 40, 65: 50, 128: 100, 129: 100, 167: 120}[n]
        thetas, x, y, mask = _mll_problem(np.random.RandomState(5), 10, n, live, cuda)
        s = 0.1
    else:
        thetas, x, y, mask, s = _large_n_mll_case(cuda, n)
    before = hk.mll_grad_batched.launches
    mll, grad = hk.mll_grad_batched(thetas, s, x, y, mask, jitter=1e-7)
    mll2, grad2 = hk.mll_grad_batched(thetas, torch.tensor(s, device=cuda), x, y, mask, jitter=1e-7)
    torch.cuda.synchronize()
    assert hk.mll_grad_batched.launches == before + 2 * hk.mll_grad_launches(n)
    assert hk.mll_grad_launches(n) == (1 if n <= 64 else 4)
    assert torch.equal(mll, mll2) and torch.equal(grad, grad2)  # fixed summation order
    ref_mll, ref_grad = hk.mll_grad_batched_plain(thetas, s, x, y, mask, 1e-7)
    assert bool(torch.isfinite(mll).all() and torch.isfinite(grad).all())
    norm = lambda g, ref: ((g - ref).abs().amax(-1) / ref.abs().amax(-1)).cpu()  # noqa: E731
    if n <= 167:
        floor = float(mask.sum()) if n > 64 else 0.0
        e_mll = ((mll - ref_mll).abs() / torch.clamp(ref_mll.abs(), min=floor)).cpu()
        e_grad = norm(grad, ref_grad)
        assert bool((e_mll <= 1e-4).all()), e_mll
        assert bool((e_grad <= 1e-3).all()), e_grad
        return
    e_mll = ((mll - ref_mll).abs() / ref_mll.abs()).cpu()
    eps_kappa = (4.0 * torch.finfo(torch.float32).eps * _live_condition(thetas, x, mask, s, 1e-7)).float()
    assert bool((e_mll <= torch.clamp(eps_kappa, min=1e-4)).all()), (e_mll, eps_kappa)
    _, g64 = hk.mll_grad_batched_plain(thetas.double(), s, x.double(), y.double(), mask, 1e-7)
    e_grad = norm(grad.double(), g64).float()
    assert bool((e_grad <= torch.clamp(eps_kappa, min=1e-3)).all()), (e_grad, eps_kappa)


def test_mll_grad_kernel_rejects_what_it_does_not_take(cuda):
    """168 rows, past the old shared-memory cap, go to the tiles and match
    the twin; a float64 row or data on another device raise; the kernel's
    entry refuses a scratch smaller than its source's layout, and more than
    64 rows without one."""
    import ctypes

    from tpubq_torch.ops import _build

    thetas, x, y, mask = _mll_problem(np.random.RandomState(6), 2, 168, 100, cuda)
    mll, grad = hk.mll_grad_batched(thetas, 0.1, x, y, mask)
    ref_mll, ref_grad = hk.mll_grad_batched_plain(thetas, 0.1, x, y, mask)
    torch.testing.assert_close(mll, ref_mll, rtol=1e-4, atol=0.0)
    assert bool(((grad - ref_grad).abs() <= 1e-3 * ref_grad.abs().amax(-1, keepdim=True)).all())
    lib = _build.library()
    floats, ints = ctypes.c_longlong(), ctypes.c_longlong()
    lib.tpubq_mll_grad_scratch(2, 168, ctypes.byref(floats), ctypes.byref(ints))
    scratch = torch.empty((floats.value,), dtype=torch.float32, device=cuda)
    sync = torch.zeros((ints.value,), dtype=torch.int32, device=cuda)
    s = torch.tensor(0.1, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def call(sp, nf, yp, ni):
        return lib.tpubq_mll_grad(thetas.data_ptr(), s.data_ptr(), x.data_ptr(), y.data_ptr(), mask.data_ptr(),
                                  1e-10, 2, 168, 2, 0, 0, sp, nf, yp, ni, mll.data_ptr(), grad.data_ptr(), stream)

    assert call(scratch.data_ptr(), floats.value - 1, sync.data_ptr(), ints.value) != 0
    assert call(scratch.data_ptr(), floats.value, sync.data_ptr(), ints.value - 1) != 0
    assert call(None, 0, None, 0) != 0
    torch.cuda.synchronize()
    thetas, x, y, mask = _mll_problem(np.random.RandomState(6), 2, 12, 12, cuda)
    with pytest.raises(TypeError):
        hk.mll_grad_batched(thetas.double(), 0.1, x, y, mask)
    with pytest.raises(ValueError):
        hk.mll_grad_batched(thetas, 0.1, x.cpu(), y, mask)


@pytest.mark.parametrize("max_obs", [32, 256])
def test_fit_hypers_on_card_goes_through_the_kernel(cuda, max_obs):
    """The fused route at any size: 151 calls per GP (150 Adam steps and the
    ranking), each ``mll_grad_launches(n)`` launches: 302 at max_obs 32 (32
    and 44 rows), 1,208 at max_obs 256 (256 and 268 rows, the tiles)."""
    bq = _testbed_bq(cuda, max_obs=max_obs)
    before = hk.mll_grad_batched.launches
    bq.fit_hypers(seed=0)
    want = 151 * (hk.mll_grad_launches(max_obs) + hk.mll_grad_launches(max_obs + 12))
    assert want == {32: 302, 256: 1208}[max_obs]
    assert hk.mll_grad_batched.launches == before + want
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
    """choose_next launches esm_fused; marginalize(n=8) launches chol_batch
    once for its rung stack and once per log density of its sampler."""
    from tpubq_torch.models import marginalize as margm

    bq = _testbed_bq(cuda)
    e0, c0, v0 = hk.esm_fused.launches, hk.chol_batch.launches, margm.slice_sample.evaluations
    x = bq.choose_next(np.linspace(-4.0, 4.0, 1001))
    zm, zv = bq.marginalize(n=8, seed=0)
    assert hk.esm_fused.launches == e0 + hk.esm_fused_launches(bq.options.max_nsc, bq.options.max_obs, 1)
    assert hk.chol_batch.launches == c0 + 1 + (margm.slice_sample.evaluations - v0)
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


#: Distance between neighbouring rows per axis in ``_gp_fleet_inputs``.
SPACING = 0.45


def _gp_fleet_inputs(device, B, NP, NP2, d, seed=0, s=0.1):
    """Both fleet kernels' inputs for B problems with NP (linear GP) and NP2
    (log-GP) rows, from float64 gaussian-GP posteriors cast to float32: the
    live rows first, then a quarter of padding rows (mask 0, identity rows of
    K⁻¹, α = 0) as a fleet state pads, at a density that does not grow with
    the rows (SPACING apart per axis), with a likelihood N(x; 0, I) and its
    log as data and the measure N(0, I). → (args_l, args_tl, zTa, half-width
    of the domain)."""
    rng = np.random.RandomState(seed)
    half = 0.5 * SPACING * max(NP, NP2) ** (1.0 / d)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)  # noqa: E731

    def posterior(n, h, w, y):
        x = rng.uniform(-half, half, (B, n, d))
        m = np.zeros((B, n))
        m[:, :max(1, n - n // 4)] = 1.0
        live = (m[:, :, None] * m[:, None, :]) > 0
        K = h * h * np.exp(-0.5 * (((x[:, :, None] - x[:, None]) / w) ** 2).sum(-1)) + s * s * np.eye(n)
        Kinv = np.where(live, np.linalg.inv(np.where(live, K, np.eye(n))), np.eye(n))
        return x, m, Kinv, (Kinv @ (y(x) * m)[..., None])[..., 0]

    h_l, w_l, h_tl, w_tl = 0.3, 0.4, 0.7, 0.8
    x, m, Kinv, alpha = posterior(NP, h_l, w_l, lambda x: np.exp(-0.5 * (x * x).sum(-1)))
    xt, mt, Kt, at = posterior(NP2, h_tl, w_tl, lambda x: -0.5 * (x * x).sum(-1))
    A = w_l * w_l + 1.0  # W_l + Σ per axis
    zc = h_l * h_l * w_l**d / np.sqrt(A**d)
    z = zc * np.exp(-0.5 / A * (x * x).sum(-1)) * m
    zTa = (z * alpha).sum(1)
    params = np.zeros((B, hk.FLEET_PARAMS))
    params[:, 0], params[:, 1], params[:, 2], params[:, 15] = h_l * h_l + s * s, zTa, zc, h_l * h_l
    for i in range(d):
        params[:, 6 + i * d + i] = 0.5 / A
    args_l = (f32(params), f32(np.full((B, d), 0.5 / w_l**2)), f32(x), f32(m), f32(Kinv),
              f32((Kinv @ z[..., None])[..., 0]), f32(alpha))
    args_tl = (f32(np.full(B, h_tl * h_tl)), f32(np.full((B, d), 0.5 / w_tl**2)), f32(xt), f32(mt), f32(Kt), f32(at))
    return args_l, args_tl, f32(zTa), half


def _fleet_kernels_vs_plain(args_l, args_tl, zTa, grid, thresh):
    """Launch both fleet kernels once and hold them to their plain versions by
    the rule of ``test_fleet_kernels_match_plain`` → the kernels' outputs."""
    (params, w_l, *rest_l), (h2, w_tl, *rest_tl) = args_l, args_tl
    lam = batched._LAM_F32
    before = hk.esm_fleet_l.launches, hk.esm_fleet_tl.launches
    A, Bc, dg = hk.esm_fleet_l(params, w_l, grid, *rest_l, thresh, lam)
    m_a, c_a = hk.esm_fleet_tl(h2, w_tl, grid, *rest_tl)
    torch.cuda.synchronize()
    assert (hk.esm_fleet_l.launches, hk.esm_fleet_tl.launches) == (before[0] + 1, before[1] + 1)
    A0, B0, dg0 = hk.esm_fleet_l_plain(params, w_l, grid, *rest_l, thresh, lam)
    m0, c0 = hk.esm_fleet_tl_plain(h2, w_tl, grid, *rest_tl)
    assert A.shape == (params.shape[0], grid.shape[0]) and bool(torch.isfinite(A).all())
    same = dg == dg0
    assert int((~same).sum()) <= 6
    assert _normwise(m_a, m0) <= 1e-4 and _normwise(c_a, c0) <= 1e-4
    assert _normwise(A, A0, same) <= 1e-4 and _normwise(Bc, B0, same) <= 1e-3
    gamma = torch.ones_like(zTa)

    def combine(A, Bc, dg, m, c):
        E1, E2 = acquire._lognormal_moments(m, c, gamma[:, None])
        return torch.where(dg > 0, (zTa * zTa)[:, None], A * A + 2.0 * A * Bc * E1 + Bc * Bc * E2)

    assert _normwise(combine(A, Bc, dg, m_a, c_a), combine(A0, B0, dg0, m0, c0), same) <= 1e-4
    return A, Bc, dg, m_a, c_a


@pytest.mark.parametrize("NP", [1, 4, 47, 48, 49, 64, 65, 220])
def test_fleet_kernels_at_tile_edges(cuda, NP):
    """NP = NP2 rows on each side of the column tiles' widths (16 … 64, and
    two or four tiles above 64) and at the route's cap, B = 5, a grid of 1,037
    points over the problems' domain."""
    args_l, args_tl, zTa, half = _gp_fleet_inputs(cuda, 5, NP, NP, 1, seed=NP)
    grid = torch.linspace(-half - 1.0, half + 1.0, 1037, device=cuda)[:, None]
    _fleet_kernels_vs_plain(args_l, args_tl, zTa, grid, 0.05)


@pytest.mark.parametrize("G", [1, 63, 10_037])
def test_fleet_kernels_ragged_grid(cuda, G):
    """The fleet path's (NP, NP2) = (44, 32) at B = 64 on grids that end
    inside a block of 128 points: the edge is masked, not padded."""
    args_l, args_tl, zTa, half = _gp_fleet_inputs(cuda, 64, 44, 32, 1, seed=G)
    grid = torch.linspace(-half - 1.0, half + 1.0, G, device=cuda)[:, None]
    _fleet_kernels_vs_plain(args_l, args_tl, zTa, grid, 0.05)


@pytest.mark.parametrize("NP,NP2", [(12, 9), (60, 48)])
def test_fleet_kernels_d3(cuda, NP, NP2):
    """d = 3: rows and grid points in a cube, the sup-norm ``near`` test."""
    args_l, args_tl, zTa, half = _gp_fleet_inputs(cuda, 4, NP, NP2, 3, seed=3)
    grid = torch.as_tensor(np.random.RandomState(5).uniform(-half - 0.5, half + 0.5, (3001, 3)),
                           dtype=torch.float32, device=cuda)
    _fleet_kernels_vs_plain(args_l, args_tl, zTa, grid, 0.05)


@pytest.mark.parametrize("NP,NP2", [(44, 32), (220, 208)])
def test_fleet_kernels_bit_identical(cuda, NP, NP2):
    """Two calls on the same inputs give the same bits: every sum has a fixed
    order and there are no float atomics."""
    args_l, args_tl, zTa, half = _gp_fleet_inputs(cuda, 16, NP, NP2, 1, seed=7)
    grid = torch.linspace(-half - 1.0, half + 1.0, 4099, device=cuda)[:, None]
    first = _fleet_kernels_vs_plain(args_l, args_tl, zTa, grid, 0.05)
    (params, w_l, *rest_l), (h2, w_tl, *rest_tl) = args_l, args_tl
    again = (*hk.esm_fleet_l(params, w_l, grid, *rest_l, 0.05, batched._LAM_F32),
             *hk.esm_fleet_tl(h2, w_tl, grid, *rest_tl))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("max_obs", [32, 256])
def test_mll_grad_kernel_per_problem_data_matches_plain(cuda, max_obs):
    """640 rows on 64 problems' data in one call against the twin, at 32 rows
    (one block per row) and 256 (the tiles), and a fleet of one problem
    against the shared-data form to the bit."""
    states, _ = _fleet_state(cuda, 64, 8, max_obs, s=0.1)
    x, y, mask, s = states.x_s, states.tl_s, states.obs_mask, states.gp_log_l.s
    rng = np.random.RandomState(3)
    thetas = torch.as_tensor(np.exp(np.log([0.7, 0.8]) + 0.4 * rng.randn(640, 2)), dtype=torch.float32, device=cuda)
    before = hk.mll_grad_batched.launches
    mll, grad = hk.mll_grad_batched(thetas, s, x, y, mask, jitter=1e-7)
    torch.cuda.synchronize()
    assert hk.mll_grad_batched.launches == before + hk.mll_grad_launches(max_obs)
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


# ---------------------------------------------------------------------------
# the large-max_obs path: gaussian_gram, cholesky_blocked, tri_solve_blocked,
# cholesky_batched
# ---------------------------------------------------------------------------


def _path_gram(rng, n, s, device, theta=(0.7, 0.8)):
    """The identity-free Gram of n sorted uniform points plus s² on the
    diagonal (the large-N path's log-GP Gram at n = max_obs)."""
    x = torch.as_tensor(np.sort(rng.uniform(-2.2, 2.2, n))[:, None], dtype=torch.float32, device=device)
    th = torch.tensor(theta, dtype=torch.float32, device=device)
    return hk.gaussian_gram(th, x, x) + s * s * torch.eye(n, device=device)


@pytest.mark.parametrize("n1,n2,d", [(1036, 1036, 1), (1036, 1, 1), (300, 512, 3), (44, 10_000, 1),
                                      (1, 1, 1), (1, 1037, 2), (33, 3, 3), (17, 5, 2), (1037, 1037, 1),
                                      (5, 1037, 3), (40, 130, 2)])
def test_gaussian_gram_kernel_matches_plain(cuda, n1, n2, d):
    """At 1e-6 of h² (expf against torch.exp: a few float32 ulps), at the
    path's shapes and at ragged ones: n2 % 4 ≠ 0 (rows not 16-byte aligned:
    scalar stores), one row, widths past a tile of 32 rows × 128 columns."""
    rng = np.random.RandomState(n1 + d)
    f32 = dict(dtype=torch.float32, device=cuda)
    theta = torch.as_tensor(np.concatenate([[0.7], rng.uniform(0.3, 1.0, d)]), **f32)
    x1, x2 = torch.as_tensor(rng.randn(n1, d), **f32), torch.as_tensor(rng.randn(n2, d), **f32)
    before = hk.gaussian_gram.launches
    K = hk.gaussian_gram(theta, x1, x2)
    torch.cuda.synchronize()
    assert hk.gaussian_gram.launches == before + 1
    assert float((K - hk.gaussian_gram_plain(theta, x1, x2)).abs().max()) <= 1e-6 * 0.49


def test_gaussian_gram_launches_without_autograd_node_unless_a_gradient_is_needed(cuda):
    rng = np.random.RandomState(4)
    f32 = dict(dtype=torch.float32, device=cuda)
    theta, x1 = torch.tensor([0.9, 0.6], **f32), torch.as_tensor(rng.randn(30, 1), **f32)
    K = hk.gaussian_gram(theta, x1, x1)
    assert K.grad_fn is None and not K.requires_grad
    th = theta.clone().requires_grad_(True)
    Kg = hk.gaussian_gram(th, x1, x1)
    assert Kg.grad_fn is not None and torch.equal(Kg.detach(), K)
    with torch.no_grad():
        assert hk.gaussian_gram(th, x1, x1).grad_fn is None


def test_gaussian_gram_kernel_backward_matches_autograd_through_plain(cuda):
    rng = np.random.RandomState(1)
    f32 = dict(dtype=torch.float32, device=cuda)
    args = [torch.as_tensor(a, **f32).requires_grad_(True)
            for a in ([0.9, 0.6, 1.1], rng.randn(40, 2), rng.randn(70, 2))]
    G = torch.as_tensor(rng.randn(40, 70), **f32)
    got = torch.autograd.grad((hk.gaussian_gram(*args) * G).sum(), args)
    want = torch.autograd.grad((hk.gaussian_gram_plain(*args) * G).sum(), args)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize("n", [1, 44, 128, 300, 1036])
def test_cholesky_blocked_kernel_matches_plain(cuda, n):
    """One launch; backward error ≤ n·eps32 of max|A|, within 1e-4 of the
    plain tiled factor normwise (or twice the library's distance to it) on a
    Gram of the large-N path at s = 0.05 (κ ≈ 1e5 at n = 1036); two calls
    give the same bits."""
    A = _path_gram(np.random.RandomState(n), n, 0.05, cuda)
    before = hk.cholesky_blocked.launches
    L = hk.cholesky_blocked(A)
    torch.cuda.synchronize()
    assert hk.cholesky_blocked.launches == before + hk.cholesky_blocked_launches(n) == before + 1
    assert bool(torch.isfinite(L).all()) and bool((torch.triu(L, 1) == 0).all())
    L64 = L.double()
    backward = float((L64 @ L64.T - A.double()).abs().max() / A.abs().max())
    assert backward <= max(n, 2) * torch.finfo(torch.float32).eps
    ref, lib = hk.cholesky_blocked_plain(A), torch.linalg.cholesky(A)
    norm = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    assert norm(L, ref) <= max(1e-4, 2.0 * norm(lib, ref))
    assert torch.equal(L, hk.cholesky_blocked(A))
    Au = A + torch.triu(torch.full_like(A, 1e30), 1)  # the upper triangle is not read
    assert torch.equal(L, hk.cholesky_blocked(Au))


def test_cholesky_blocked_kernel_nan_and_input_checks(cuda):
    for n, bad in ((300, 200), (300, 290), (1036, 30), (44, 43)):
        A = _path_gram(np.random.RandomState(3), n, 0.05, cuda)
        A[bad, bad] = -1.0  # a pivot of a middle, the first or the ragged last tile goes negative
        assert bool(torch.isnan(hk.cholesky_blocked(A)).all()), (n, bad)
    with pytest.raises(TypeError):
        hk.cholesky_blocked(A.double())
    with pytest.raises(ValueError):
        hk.cholesky_blocked(A[:, :43])
    with pytest.raises(ValueError):
        hk.cholesky_blocked(A.T[:, ::2])


def _tri_case(rng, n, M, device):
    """The factor of a path Gram and R: the identity at M = n, else normal."""
    L = torch.linalg.cholesky(_path_gram(rng, n, 0.05, device)).contiguous()
    R = torch.eye(n, device=device) if M == n else torch.as_tensor(rng.randn(n, M), dtype=torch.float32, device=device)
    return L, R


def _f64_dist(X, L, R):
    """max|X − X64| / max|X64|, X64 the float64 solve, and the same for the
    library's float32 solve."""
    X64 = torch.linalg.solve_triangular(L.double(), R.double(), upper=False)
    lib = torch.linalg.solve_triangular(L, R, upper=False)
    norm = lambda a: float((a.double() - X64).abs().max() / X64.abs().max())  # noqa: E731
    return norm(X), norm(lib)


@pytest.mark.parametrize("n,M", [(37, 1), (44, 1), (300, 33), (1036, 1), (1036, 3), (1036, 100), (1036, 1036),
                                 (2048, 1)])
def test_tri_solve_blocked_kernel_matches_plain(cuda, n, M):
    """One launch per call; within max(1e-4, 2 × the library's own distance
    to float64), normwise, on the factor of a path Gram; and within 1e-4 of
    the plain blocked substitution, normwise."""
    rng = np.random.RandomState(n + M)
    L, R = _tri_case(rng, n, M, cuda)
    before = hk.tri_solve_blocked.launches
    X = hk.tri_solve_blocked(L, R)
    torch.cuda.synchronize()
    assert hk.tri_solve_blocked.launches == before + hk.tri_solve_blocked_launches(n) == before + 1
    got, lib = _f64_dist(X, L, R)
    assert got <= max(1e-4, 2.0 * lib)
    plain = hk.tri_solve_blocked_plain(L, R)
    assert float((X - plain).abs().max() / plain.abs().max()) <= 1e-4


@pytest.mark.parametrize("n,M", [(1036, 1), (1036, 100), (1036, 1036)])
def test_tri_solve_blocked_kernel_is_deterministic(cuda, n, M):
    """Each work item sums its terms in a fixed order, whatever order the
    flags arrive in: two calls on the same inputs give the same bits."""
    L, R = _tri_case(np.random.RandomState(n * M), n, M, cuda)
    X1 = hk.tri_solve_blocked(L, R)
    X2 = hk.tri_solve_blocked(L, R)
    torch.cuda.synchronize()
    assert torch.equal(X1, X2)


def test_tri_solve_blocked_kernel_back_to_back_on_one_stream(cuda):
    """The flag protocol's stress test: 120 solves of assorted sizes queued
    on one stream with no synchronization between them, each held to its own
    float64 result at max(1e-4, 2 × the library's distance)."""
    rng = np.random.RandomState(17)
    cases = []
    for k in range(120):
        n = int(rng.choice([1, 5, 63, 64, 65, 200, 513, 1036]))
        M = int(rng.choice([1, 2, 5, 8, 9, 64, 70]))
        cases.append(_tri_case(rng, n, M, cuda))
    outs = [hk.tri_solve_blocked(L, R) for L, R in cases]
    torch.cuda.synchronize()
    for (L, R), X in zip(cases, outs):
        got, lib = _f64_dist(X, L, R)
        assert got <= max(1e-4, 2.0 * lib), (tuple(R.shape), got, lib)


def test_tri_solve_blocked_kernel_input_checks(cuda):
    L = torch.eye(8, device=cuda)
    with pytest.raises(ValueError):
        hk.tri_solve_blocked(L, torch.ones(7, 2, device=cuda))
    with pytest.raises(TypeError):
        hk.tri_solve_blocked(L, torch.ones(8, 2, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="is on"):
        hk.tri_solve_blocked(L, torch.ones(8, 2))


@pytest.mark.parametrize("B,n", [(16, 44), (4, 300), (2, 1036), (8, 1024), (3, 1000)])
def test_cholesky_batched_kernel_matches_plain_and_confines_nan(cuda, B, n):
    """One panel (n = 44), several, and a ragged last one (300, 1036, 1000);
    one matrix of the stack made indefinite at its middle pivot (a later
    panel from n = 300 up) gets NaN, the others a backward error within
    n·eps32 and within 1e-4 of the plain panelled factor normwise (or twice
    the library's distance to it); 3⌈n/64⌉ − 2 launches per call."""
    rng = np.random.RandomState(B * n)
    Ks = torch.stack([_path_gram(rng, n, 0.05, cuda) for _ in range(B)])
    Ks[1, n // 2, n // 2] = -1.0
    before = hk.cholesky_batched.launches
    L = hk.cholesky_batched(Ks)
    torch.cuda.synchronize()
    assert hk.cholesky_batched.launches == before + hk.cholesky_batched_launches(n)
    fin = torch.isfinite(L).all(-1).all(-1).tolist()
    assert fin == [i != 1 for i in range(B)]
    keep = [i for i in range(B) if i != 1]
    assert bool((torch.triu(L[keep], 1) == 0).all())
    ref, lib = hk.cholesky_batched_plain(Ks[keep]), torch.linalg.cholesky(Ks[keep])
    norm = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    assert norm(L[keep], ref) <= max(1e-4, 2.0 * norm(lib, ref))
    Lk = L[keep].double()
    backward = float((Lk @ Lk.transpose(1, 2) - Ks[keep].double()).abs().max() / Ks[keep].abs().max())
    assert backward <= n * torch.finfo(torch.float32).eps
    with pytest.raises(ValueError):
        hk.cholesky_batched(Ks[0])


def _large_n_state(device, max_obs, s=0.05, dtype="float32"):
    from tpubq_torch.models import bq as bqm

    rng = np.random.RandomState(0)
    x = np.sort(rng.uniform(-2.2, 2.2, max_obs - 12))
    l = np.exp(-0.5 * (x - 0.2) ** 2 / 0.25) / np.sqrt(2 * np.pi * 0.25) + 1e-3
    opts = BQOptions(n_candidate=12, candidate_thresh=1e-3, max_obs=max_obs, dtype=dtype)
    st = bqm.init_state(x, l, opts, params_tl=PARAMS_TL, params_l=PARAMS_L, s_tl=s, s_l=s, device=device)
    return st, opts


def test_large_n_refit_and_fast_step_go_through_the_kernels(cuda):
    """At max_obs 256 (the log-GP 256 rows, the linear GP 268): a full refit
    launches gaussian_gram 3 times, cholesky_blocked twice and
    tri_solve_blocked six times, one launch each (alpha forward and back, and
    L⁻¹, per GP); a fast incremental step launches gaussian_gram 4 times,
    cholesky_blocked once (the linear GP's fresh factor) and
    tri_solve_blocked five times (the bordered row, and each GP's alpha
    forward and back)."""
    from tpubq_torch.models import acquire as acq, incremental as inc

    st, opts = _large_n_state(cuda, 256)
    wrappers = (hk.gaussian_gram, hk.cholesky_blocked, hk.tri_solve_blocked)
    counts = lambda: [w.launches for w in wrappers]  # noqa: E731
    n_s, n_sc = opts.max_obs, opts.max_nsc
    xa = float(st.x_s[100, 0] + st.x_s[101, 0]) / 2.0
    c0 = counts()
    full = acq.add_observation(st, opts, [xa], 0.3)
    c1 = counts()
    fast = inc.add_observation_fast(st, opts, [xa], 0.3)
    c2 = counts()
    assert [b - a for a, b in zip(c0, c1)] == [3, 2, 6] == [
        3, hk.cholesky_blocked_launches(n_s) + hk.cholesky_blocked_launches(n_sc),
        3 * (hk.tri_solve_blocked_launches(n_s) + hk.tri_solve_blocked_launches(n_sc))]
    assert [b - a for a, b in zip(c1, c2)] == [4, 1, 5] == [
        4, hk.cholesky_blocked_launches(n_sc),
        3 * hk.tri_solve_blocked_launches(n_s) + 2 * hk.tri_solve_blocked_launches(n_sc)]
    zm = [float(acq.Z_mean(s_, opts)) for s_ in (full, fast)]
    assert abs(zm[0] - zm[1]) <= 1e-4 * abs(zm[0])


def test_esm_scores_a_state_above_the_fused_kernels_budget(cuda):
    """max_obs 2048 (2,060 rows), whose inverses no block's shared memory
    holds: the kernel streams them (two launches) and is held to the CPU's
    float32 scores at 1e-4 of the largest score."""
    from tpubq_torch.models import acquire as acq

    bq = _testbed_bq(cuda, max_obs=2048)
    cpu = _testbed_bq("cpu", max_obs=2048)
    grid = np.linspace(-4.0, 4.0, 2001)
    e0 = hk.esm_fused.launches
    got = torch.as_tensor(bq.expected_squared_mean(grid))
    assert hk.esm_fused.launches == e0 + 2
    assert acq.esm_route(bq.state, bq.options) == "esm_fused"
    want = torch.as_tensor(cpu.expected_squared_mean(grid))
    off = (got - want).abs() > 1e-4 * float(want.abs().max())
    assert int(off.sum()) <= 2


# ---------------------------------------------------------------------------
# hyper-marginalization: the lock-step sampler and the flattened fleet scorer
# ---------------------------------------------------------------------------


def _marg_bq(device, dtype):
    import tpubq_torch

    x = np.linspace(-2.2, 2.2, 10)
    l = np.exp(-0.5 * ((x - 0.2) / 0.5) ** 2) / (0.5 * np.sqrt(2.0 * np.pi))
    bq = tpubq_torch.BQ(x, l, device=device, dtype=dtype, max_obs=32, n_candidate=12, candidate_thresh=0.2,
                        x_mean=0.0, x_var=1.0, s=0.01)
    return bq.init(params_tl=PARAMS_TL, params_l=PARAMS_L)


@pytest.mark.parametrize("joint", [False, True], ids=["theta_tl", "joint"])
def test_lockstep_sampler_on_the_card_matches_the_plain_sampler(cuda, joint):
    """The lock-step sampler in float64 on the card, four rows at once,
    against the plain sequential sampler in float64 on the CPU, on the same
    uniforms: the same draws to 1e-9 (the log densities of the two devices
    differ by rounding only)."""
    from tpubq_torch.models import marginalize as margm

    p = 4 if joint else 2
    bq, cpu = _marg_bq(cuda, "float64"), _marg_bq("cpu", "float64")
    u0 = np.log(np.array(PARAMS_TL + PARAMS_L)[:p]) + 0.1 * np.random.RandomState(0).randn(4, p)
    unif = margm.draw_uniforms(torch.Generator().manual_seed(1), 4, 5, p)
    reads = margm.slice_sample.host_reads
    lock = margm.slice_sample(None, margm.log_density(bq.state, bq.options, joint),
                              torch.as_tensor(u0, device=cuda), 3, 2, uniforms=unif).cpu()
    assert margm.slice_sample.host_reads - reads <= margm.slice_sample.evaluations
    lp_cpu = margm.log_density(cpu.state, cpu.options, joint)
    for r in range(4):
        plain = margm.slice_sample_plain(lp_cpu, torch.as_tensor(u0[r]), unif[r], 3, 2)
        np.testing.assert_allclose(lock[r].numpy(), plain.numpy(), rtol=1e-9, atol=1e-9)


def test_float32_sampler_on_the_card(cuda):
    """float32 draws on the card (θ_tl with four chains, joint rows, a fleet
    of 8): finite and positive, of the JAX package's shapes, each log
    density one chol_batch launch per factored stack."""
    from tpubq_torch.models import marginalize as margm

    bq = _marg_bq(cuda, "float32")
    c0, e0 = hk.chol_batch.launches, margm.slice_sample.evaluations
    th = bq.sample_hypers(n=12, nburn=2, seed=3, n_chains=4)
    assert hk.chol_batch.launches - c0 == margm.slice_sample.evaluations - e0
    thj = bq.sample_hypers(params=("h", "w", "h_l", "w_l"), n=6, nburn=2, seed=4)
    states, opts = _fleet_state(cuda, 8, 10, 16)
    thf = batched.sample_hypers_batch(states, opts, torch.Generator().manual_seed(5), 6, nburn=2)
    assert th.shape == (12, 2) and thj.shape == (6, 4) and tuple(thf.shape) == (8, 6, 2)
    for t in (th, thj, thf.cpu().numpy()):
        assert np.all(np.isfinite(t)) and np.all(t > 0)


def _marg_rows(B, S, seed):
    rng = np.random.RandomState(seed)
    return np.exp(np.log(PARAMS_TL) + 0.1 * rng.randn(B, S, 2)).astype(np.float32)


@pytest.mark.parametrize("B,S,G", [(64, 10, 10_000), (64, 1024, 16)])
def test_flattened_fleet_scorer(cuda, monkeypatch, B, S, G):
    """``choose_next_marg_batch``'s scores: B·S re-anchored states scored as
    one flattened fleet through the fleet kernels, against S_chunk = 1 (B
    problems a launch), at B·S = 640 and at the launch limit's edge (S =
    1024, chunks of 1,023 rows: 65,472 problems a launch): each problem's
    averaged score within 1e-4 of its largest off at most 6 points a
    problem, and the same picks but where two scores tie to 1e-4."""
    states, opts = _fleet_state(cuda, B, 10, 16, s=0.01)
    grid = torch.linspace(-4.0, 4.0, G, device=cuda)[:, None]
    rows = torch.as_tensor(_marg_rows(B, S, 7), device=cuda)
    chunk = batched.marg_chunk(B, S, G, opts)
    assert chunk == min(S, hk.FLEET_MAX_PROBLEMS // B) and B * chunk <= hk.FLEET_MAX_PROBLEMS
    l0 = hk.esm_fleet_l.launches
    flat = batched._marg_scores(states, opts, grid, rows)
    assert hk.esm_fleet_l.launches - l0 == -(-S // chunk)
    monkeypatch.setattr(batched, "_MARG_CHUNK_ELEMS", 1)
    one = batched._marg_scores(states, opts, grid, rows)
    assert hk.esm_fleet_l.launches - l0 == -(-S // chunk) + S
    off = (flat - one).abs() > 1e-4 * one.abs().amax(1, keepdim=True)
    assert int(off.sum(1).max()) <= 6
    a, b = flat.argmax(1), one.argmax(1)
    tie = (one.gather(1, a[:, None]) - one.gather(1, b[:, None])).abs()[:, 0] <= 1e-4 * one.abs().amax(1)
    assert bool(((a == b) | tie).all())


# the other kernel families: plain torch Grams and integrals, the factorization kernels
# (JAX-free copy of tests/torch_parity.FAMILY_PARAMS, the source of the CPU tests)
FAMILY_PARAMS = {"matern52": (PARAMS_TL, PARAMS_L), "matern32": (PARAMS_TL, PARAMS_L),
                 "rq": (PARAMS_TL + (2.0,), PARAMS_L + (2.0,)), "periodic": ((0.7, 0.8, 1.0), (0.35, 0.8, 1.0))}


@pytest.mark.parametrize("kernel,d", [("matern52", 1), ("matern32", 1), ("rq", 1), ("periodic", 1), ("matern52", 2)])
def test_family_float32_on_the_card_matches_the_float64_plain_path(cuda, kernel, d):
    """Each family in float32 on the card (its Grams and integrals plain
    torch, its unbatched factors on cholesky_blocked, its solves on
    tri_solve_blocked, a marginalize rung stack on chol_batch) against the
    port's float64 path on the CPU on the same data and hypers: E[Z] at 1e-4,
    V[Z] at 5e-2 (tests/test_torch_bq.py's float32 pins), the scores at 1e-3
    of their largest where both dtypes' guards resolve the point, one
    marginalize over 8 θ_tl rows; for Matérn also the
    float32 closed-form V[Z] at 1e-4 on the recipe of
    tests/test_matern_zvar.py:92 (as tests/test_torch_families.py holds it
    on the CPU)."""
    import tpubq_torch
    from tpubq_torch.models import bq as bqm, marginalize as margm

    rng = np.random.RandomState(1)
    x = np.linspace(-2.2, 2.2, 10) if d == 1 else rng.uniform(-2.0, 2.0, (10, 2))
    l = np.exp(-0.5 * np.sum((np.reshape(x, (10, d)) - 0.2) ** 2, -1) / 0.25) + 1e-3
    ptl, pl = FAMILY_PARAMS[kernel] if d == 1 else ((0.7, 0.8, 0.8), (0.3, 0.4, 0.4))
    kw = dict(kernel=kernel, max_obs=16, n_candidate=8, candidate_thresh=0.2, x_mean=np.zeros(d), x_var=np.eye(d),
              s=0.01)
    counts = {k: getattr(hk, k).launches for k in ("cholesky_blocked", "tri_solve_blocked", "chol_batch")}
    bq = tpubq_torch.BQ(x, l, device=cuda, dtype="float32", **kw).init(params_tl=ptl, params_l=pl)
    bq64 = tpubq_torch.BQ(x, l, device="cpu", dtype="float64", **kw).init(params_tl=ptl, params_l=pl)
    np.testing.assert_allclose(bq.Z_mean(), bq64.Z_mean(), rtol=1e-4)
    np.testing.assert_allclose(bq.Z_var(), bq64.Z_var(), rtol=5e-2)
    if kernel.startswith("matern"):
        X = np.sort(np.random.RandomState(0).uniform(-2.5, 2.5, (10, d)), axis=0)
        L = np.exp(-0.5 * np.sum((X - 0.2) ** 2, -1) / 0.25)
        zvs = []
        for dev, dtype in ((cuda, "float32"), ("cpu", "float64")):
            opts = BQOptions(kernel=kernel, dim=d, n_candidate=12, candidate_thresh=0.2, dtype=dtype)
            st = bqm.init_state(X, L, opts, params_tl=(0.7,) + (0.8,) * d, params_l=(0.3,) + (0.4,) * d,
                                x_mean=np.zeros(d), x_var=np.eye(d), device=dev)
            zvs.append(float(bqm.Z_var(st, opts)))
        assert abs(zvs[0] - zvs[1]) / zvs[1] < 1e-4, zvs
    grid = np.linspace(-3.0, 3.0, 401) if d == 1 else rng.uniform(-3.0, 3.0, (400, 2))
    e32, e64 = bq.expected_squared_mean(grid), bq64.expected_squared_mean(grid)
    g = acquire.as_points(grid, d, torch.float32, cuda)
    resolved = ~(acquire._esm_affine_terms(bq.state, bq.options, g)[2].cpu().numpy()
                 | acquire._esm_affine_terms(bq64.state, bq64.options, g.double().cpu())[2].numpy())
    assert resolved.sum() > 0  # points both scorers resolve (the guards differ by dtype)
    assert np.max(np.abs(e32 - e64)[resolved]) <= 1e-3 * np.max(np.abs(e64))
    thetas = np.exp(np.log(ptl) + 0.1 * rng.randn(8, len(ptl)))
    zm_m, zv_m = margm.marginalize(bq.state, bq.options, torch.as_tensor(thetas, dtype=torch.float32, device=cuda))
    zm_64, zv_64 = margm.marginalize(bq64.state, bq64.options, torch.as_tensor(thetas))
    np.testing.assert_allclose(zm_m.cpu().numpy(), zm_64.numpy(), rtol=1e-3)
    np.testing.assert_allclose(zv_m.double().mean().item(), zv_64.mean().item(), rtol=5e-2)
    torch.cuda.synchronize()
    assert all(getattr(hk, k).launches > n for k, n in counts.items()), counts


# -- the serving surface on the card: refinement, checkpoints, health ---------


def _testbed_pair(cuda):
    """The testbed as a float32 BQ on the card and a float64 BQ on the CPU."""
    import tpubq_torch

    x = np.linspace(-2.2, 2.2, 10)
    l = np.exp(-0.5 * ((x - 0.2) / 0.5) ** 2) / (0.5 * np.sqrt(2.0 * np.pi))
    kw = dict(max_obs=32, n_candidate=12, candidate_thresh=0.2, x_mean=0.0, x_var=1.0, s=0.01)
    b32 = tpubq_torch.BQ(x, l, device=cuda, dtype="float32", **kw).init(params_tl=PARAMS_TL, params_l=PARAMS_L)
    b64 = tpubq_torch.BQ(x, l, device="cpu", dtype="float64", **kw).init(params_tl=PARAMS_TL, params_l=PARAMS_L)
    return b32, b64


@pytest.mark.parametrize("rows", [0, 3])
def test_refine_next_on_card_against_the_f64_path(cuda, rows):
    """The refined point's float64 ESM (the port's CPU path, the same data,
    hypers and rows) is at least the grid pick's, less max(1e-5, 2 × the
    float32 scorer's relative error there); the float32 value never drops."""
    from tpubq_torch.models import bq as bqm

    b32, b64 = _testbed_pair(cuda)
    hyp = torch.tensor([[0.6, 0.7], [0.8, 0.9], [0.7, 1.1]][:rows], device=cuda) if rows else None
    grid = torch.linspace(-4.0, 4.0, 2001, device=cuda)
    x0, _ = acquire.choose_next(b32.state, b32.options, grid, hyp)
    x_ref, v_ref = acquire.refine_next(b32.state, b32.options, x0, hyp)
    _, v0 = acquire.refine_next(b32.state, b32.options, x0, hyp, n_steps=0)
    assert v_ref.item() >= v0.item()
    st64 = b64.state if hyp is None else bqm.apply_hyper_sample(b64.state, b64.options, hyp.double().cpu())

    def e64(x):
        return acquire.expected_squared_mean_xla(st64, b64.options, x.double().cpu()[None, :]).mean().item()

    err = max(abs(v0.item() - e64(x0)) / e64(x0), abs(v_ref.item() - e64(x_ref)) / e64(x_ref))
    assert e64(x_ref) >= e64(x0) * (1.0 - max(1e-5, 2.0 * err))


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """save_state → load_state on the card: moments, scores and pick
    bit-identical; BQ.save → BQ.load (a refit) within 1e-4 / 5e-2."""
    import tpubq_torch
    from tpubq_torch.models import bq as bqm
    from tpubq_torch.utils import io

    b32, _ = _testbed_pair(cuda)
    io.save_state(tmp_path / "s", b32.state, b32.options)
    st, opts = io.load_state(tmp_path / "s", device=cuda)
    assert st.x_s.is_cuda and st.gp_l.Kinv is not None
    for fn in (bqm.Z_mean, bqm.Z_var):
        assert fn(st, opts).item() == fn(b32.state, b32.options).item()
    grid = torch.linspace(-4.0, 4.0, 2001, device=cuda)
    (xa, sa), (xb, sb) = (acquire.choose_next(s, opts, grid) for s in (b32.state, st))
    assert torch.equal(xa, xb) and torch.equal(sa, sb)
    b32.save(tmp_path / "bq.npz")
    back = tpubq_torch.BQ.load(tmp_path / "bq.npz", device=cuda)
    assert back.device.type == "cuda"
    assert abs(back.Z_mean() - b32.Z_mean()) <= 1e-4 * abs(b32.Z_mean())
    assert abs(back.Z_var() - b32.Z_var()) <= 5e-2 * abs(b32.Z_var())


def test_health_float32_single_and_fleet_on_card(cuda):
    """health() in float32 on the card: the flags of the float64 path, the
    leaves on the card; a fleet's leaves each (B,)."""
    import tpubq_torch

    b32, b64 = _testbed_pair(cuda)
    d32, d64 = b32.health(), b64.health()
    for k in ("l_s_finite", "alpha_l_finite", "alpha_tl_finite", "factor_ok_tl", "factor_ok_l"):
        assert d32[k].is_cuda and bool(d32[k]) == bool(d64[k]), k
    for g in ("gp_log_l", "gp_l"):
        ratio = d32[g]["cond_estimate"].item() / d64[g]["cond_estimate"].item()
        assert 0.5 <= ratio <= 2.0 and bool(d32[g]["finite"])
    assert d32["z_var_clamped_rel"].item() <= 1e-3
    assert b32.health(as_report=True).startswith("ns=10")
    rng = np.random.RandomState(0)
    xs = np.stack([np.linspace(-2.2, 2.2, 8) + 0.03 * rng.standard_normal(8) for _ in range(6)])
    ls = np.exp(-0.5 * (xs - 0.1) ** 2 / 0.25)
    fleet = tpubq_torch.BQFleet(xs, ls, params_tl=PARAMS_TL, params_l=PARAMS_L, device=cuda, dtype="float32",
                                n_candidate=12, candidate_thresh=0.2, max_obs=16, s=0.01)
    dh = fleet.health()
    assert dh["ns"].shape == (6,) and dh["gp_l"]["cond_estimate"].shape == (6,)
    assert bool(dh["factor_ok_l"].all()) and bool(dh["alpha_l_finite"].all())


def test_sharded_fleet_on_a_one_card_nccl_mesh_is_bit_identical(cuda):
    """A (1, 1) NCCL mesh of one card (a world of one process): the sharded
    fleet choose and one step of the sharded fleet loop equal the unsharded
    ones bit for bit (float32, B = 16, G = 1,001: the fleet kernels)."""
    import math

    import torch.distributed as dist

    from tpubq_torch.parallel import mesh as pmesh, sharded as sh

    rng = np.random.RandomState(3)
    xs = np.stack([np.linspace(-2.2, 2.2, 8) + 0.03 * rng.standard_normal(8) for _ in range(16)])
    ls = np.exp(-0.5 * ((xs - 0.2) / 0.5) ** 2) / (0.5 * math.sqrt(2.0 * math.pi))
    opts = BQOptions(n_candidate=12, candidate_thresh=0.2, max_obs=16, dtype="float32")
    st = batched.init_batch(xs, ls, opts, params_tl=PARAMS_TL, params_l=PARAMS_L, s_tl=0.01, s_l=0.01, device=cuda)
    grid = torch.linspace(-4.0, 4.0, 1001, device=cuda)

    def lik(x):
        return torch.exp(-0.5 * ((x[0] - 0.2) / 0.5) ** 2) / (0.5 * math.sqrt(2.0 * math.pi))

    assert not dist.is_initialized()
    mesh = pmesh.make_mesh(device=cuda)
    try:
        assert mesh.shape == (1, 1) and dist.get_backend() == "nccl"
        launches = hk.esm_fleet_l.launches
        x_s, sc_s = sh.fleet_choose_next_sharded(st, opts, grid, mesh)
        assert hk.esm_fleet_l.launches == launches + 1
        x_u, sc_u = batched.choose_next_batch(st, opts, grid)
        assert torch.equal(x_s, x_u) and torch.equal(sc_s, sc_u)
        f_s, (zm_s, zv_s) = sh.run_active_loop_fleet_sharded(st, opts, lik, grid, 1, mesh)
        f_u, (zm_u, zv_u) = batched.run_active_loop_batch(st, opts, lik, grid, 1)
        for a, b in ((f_s.x_s, f_u.x_s), (f_s.gp_l.Kinv, f_u.gp_l.Kinv), (f_s.gp_log_l.alpha, f_u.gp_log_l.alpha),
                     (zm_s, zm_u), (zv_s, zv_u)):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
