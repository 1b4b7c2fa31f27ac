"""Parity of the port's hyper-marginalization (tpubq_torch.models.marginalize,
the fleet's ``*_marg*`` / ``sample_hypers_batch``) with the JAX package.

The port's lock-step sampler draws its uniforms from a ``torch.Generator``
and cannot reproduce JAX's key stream, so the sampler is held row by row to
the port's plain sequential sampler on the same uniforms (float64, 1e-12),
and to JAX in distribution (moments). What consumes the draws (the log
density, ``gp_fit(ladder=False)``, ``marginalize``, ``choose_next``, the
fleet's marginalization and its active loop) is held to the JAX package on
the same θ rows: float64 rtol 1e-10 (a single problem's V[Z], the small
remainder of a cancellation, at 1e-10 of the prior variance it cancels
from); float32 against the JAX float64 result at
the marginalized pins of tests/test_torch_bq.py's header (E[Z] 1e-4, V[Z]
5e-2). Small sizes throughout: the 1-D testbed, fleets of 3, a few sweeps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import tpubq_torch
from tests import torch_parity as tp
from tests import util as tu
from tpubq.models import acquire as jacq
from tpubq.models import batched as jbat
from tpubq.models import bq as jbq
from tpubq.models import gp as jgp
from tpubq.models import marginalize as jmarg
from tpubq.ops.kernels import get_kernel as jkern
from tpubq.utils.options import BQOptions as JOptions
from tpubq_torch.models import acquire as tacq
from tpubq_torch.models import batched as tbat
from tpubq_torch.models import bq as tbq
from tpubq_torch.models import gp as tgp
from tpubq_torch.models import marginalize as tmarg
from tpubq_torch.ops import integrals as igr
from tpubq_torch.ops.kernels import get_kernel as tkern
from tpubq_torch.utils.options import BQOptions as TOptions

JOINT = ("h", "w", "h_l", "w_l")
GRID = np.linspace(-4.0, 4.0, 81)
FLEET_KW = dict(n_candidate=10, candidate_thresh=0.2, max_obs=16)
MUS, SIGS = [0.2, -0.5, 0.8], [0.5, 0.7, 0.4]


def _single():
    """(JAX BQ, its state carried into the port, port options)."""
    bj, _ = tp.make_pair("float64")
    st, ot = tp.to_torch(bj.state, bj.options)
    return bj, st, ot


def _u_rows(p, n, seed=0, spread=0.1):
    """n log-θ rows scattered log-normally around the testbed's hypers. At
    ±10% the Grams stay well conditioned, where two float64 factorizations
    agree to 1e-10; at ±30% a row reaches a Gram so close to singular (MLL
    −3.4e3) that the two packages' float64 MLLs differ by 4e-8, the
    condition number times eps64."""
    rng = np.random.RandomState(seed)
    return np.log(np.array(tp.PARAMS_TL + tp.PARAMS_L)[:p]) + spread * rng.randn(n, p)


def _jax_log_density(sj, oj, u, joint):
    """``tpubq/models/marginalize.py:222-258`` assembled from ``tpubq.models.gp``."""
    kfn, _ = jkern("gaussian")
    tl, lg = sj.gp_log_l, sj.gp_l
    u = jnp.asarray(u)
    mll = jgp.log_mll(kfn, jnp.exp(u[:2]), tl.s, sj.x_s, sj.tl_s, sj.obs_mask, oj.base_jitter)
    if joint:
        fit = jgp.gp_fit(kfn, jnp.exp(u[:2]), tl.s, sj.x_s, sj.tl_s, sj.obs_mask,
                         base_jitter=oj.base_jitter, ladder=False)
        m_c = jgp.gp_mean(kfn, fit, sj.x_c)
        l_c = jnp.where(sj.c_mask, sj.gamma * jnp.expm1(m_c), 0.0)
        l_sc = jnp.concatenate([jnp.where(sj.obs_mask, sj.l_s, 0.0), l_c])
        mll = mll + jgp.log_mll(kfn, jnp.exp(u[2:]), lg.s, sj.x_sc, l_sc, sj.sc_mask, oj.base_jitter)
    return float(mll - 0.5 * jnp.sum((u / jmarg._PRIOR_STD) ** 2))


@pytest.mark.parametrize("joint", [False, True], ids=["theta_tl", "joint"])
def test_log_density_matches_jax(joint):
    bj, st, ot = _single()
    u = _u_rows(4 if joint else 2, 5)
    got = tmarg.log_density(st, ot, sample_l=joint)(torch.as_tensor(u)).numpy()
    want = np.array([_jax_log_density(bj.state, bj.options, r, joint) for r in u])
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_gp_fit_fixed_jitter_matches_jax():
    """``gp_fit(ladder=False)`` against the JAX package's in L, α and the
    absolute jitter, for one θ and, batched, for three."""
    bj, st, _ = _single()
    sj = bj.state
    kj, kt = jkern("gaussian")[0], tkern("gaussian")[0]
    thetas = np.exp(_u_rows(2, 3, seed=1))
    got = tgp.gp_fit(kt, torch.as_tensor(thetas), st.gp_log_l.s, st.x_s, st.tl_s, st.obs_mask,
                     base_jitter=1e-10, ladder=False)
    for i, th in enumerate(thetas):
        want = jgp.gp_fit(kj, jnp.asarray(th), sj.gp_log_l.s, sj.x_s, sj.tl_s, sj.obs_mask,
                          base_jitter=1e-10, ladder=False)
        np.testing.assert_allclose(got.L[i].numpy(), np.asarray(want.L), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got.alpha[i].numpy(), np.asarray(want.alpha), rtol=1e-10)
        np.testing.assert_allclose(float(got.jitter[i]), float(want.jitter), rtol=1e-10)
        assert bool(got.ok[i]) and bool(want.ok)


@pytest.mark.parametrize("joint", [False, True], ids=["theta_tl", "joint"])
def test_lockstep_rows_equal_the_plain_sampler(joint):
    """Row r of the lock-step sampler at R = 4 is the plain sequential sampler
    on row r's uniforms (float64, 1e-12); R = 1 gives row 0 the same draws,
    and a row's uniforms do not depend on the rows after it."""
    _, st, ot = _single()
    p = 4 if joint else 2
    logpdf = tmarg.log_density(st, ot, sample_l=joint)
    u0 = torch.as_tensor(_u_rows(p, 4, seed=2))
    n, nburn = 3, 1
    unif = tmarg.draw_uniforms(torch.Generator().manual_seed(5), 4, n + nburn, p)
    lock = tmarg.slice_sample(None, logpdf, u0, n, nburn, uniforms=unif)
    assert lock.shape == (4, n, p) and lock.dtype == torch.float64
    for r in range(4):
        plain = tmarg.slice_sample_plain(logpdf, u0[r], unif[r], n, nburn)
        np.testing.assert_allclose(lock[r].numpy(), plain.numpy(), rtol=1e-12, atol=1e-12)
    one = tmarg.slice_sample(torch.Generator().manual_seed(5), logpdf, u0[0], n, nburn)
    np.testing.assert_allclose(one.numpy(), lock[0].numpy(), rtol=1e-12, atol=1e-12)
    assert torch.equal(tmarg.draw_uniforms(torch.Generator().manual_seed(5), 1, n + nburn, p)[0], unif[0])


def test_n_chains_layout_frozen_coords_and_moments():
    """``n_chains=4``: chain 0 starts at u0, the others at u0 + 0.3·N(0, 1) on
    the swept coordinates, each burns ``nburn`` and draws ⌈n/4⌉, interleaved
    round-robin and truncated (the layout of the JAX ``_run_chains``);
    frozen coordinates are exact; the pooled draws have the single chain's
    moments (tests/test_marginalize.py's check)."""
    _, st, ot = _single()
    coords, _ = tmarg.param_coords(("w",), ot)
    th = tmarg.sample_hypers(st, ot, torch.Generator().manual_seed(3), 7, nburn=2, params=("w",),
                             n_chains=4)
    gen = torch.Generator().manual_seed(3)
    u0 = torch.log(st.gp_log_l.theta)
    jitter = 0.3 * torch.randn((4, 2), generator=gen, dtype=torch.float64)
    jitter[0] = 0.0
    jitter[:, 0] = 0.0  # "h" is frozen
    us = tmarg.slice_sample(gen, tmarg.log_density(st, ot), u0 + jitter, 2, 2, coords=coords)
    want = torch.exp(us.transpose(0, 1).reshape(8, 2)[:7])
    np.testing.assert_array_equal(th.numpy(), want.numpy())
    np.testing.assert_array_equal(th[:, 0].numpy(), np.full(7, tp.PARAMS_TL[0]))

    bt = tpubq_torch.BQ(tu.make_x(), tu.f_l(tu.make_x()), device="cpu", **tu.DEFAULT_OPTIONS)
    bt.init(params_tl=tp.PARAMS_TL, params_l=tp.PARAMS_L)
    th1 = bt.sample_hypers(n=120, nburn=20, seed=4)
    thc = bt.sample_hypers(n=120, nburn=20, seed=4, n_chains=4)
    assert thc.shape == (120, 2) and np.all(thc > 0)
    np.testing.assert_allclose(thc.mean(0), th1.mean(0), rtol=0.25)
    assert 0.3 < np.std(np.log(thc[:, 0])) / max(np.std(np.log(th1[:, 0])), 1e-9) < 3.0
    with pytest.raises(TypeError, match="params first"):
        bt.sample_hypers(20)


def test_sampler_matches_jax_in_distribution():
    """The port's ``sample_hypers(n=120, n_chains=4)`` and the JAX package's
    on the same float64 testbed state draw from the same posterior: per
    coordinate, means within 25% and log-scale standard deviations within a
    factor of 3 (tests/test_marginalize.py's multi-chain tolerances, at its
    seed). The two draw from different random streams."""
    bj, bt = tp.make_pair("float64")
    thj = bj.sample_hypers(n=120, nburn=20, seed=4, n_chains=4)
    tht = bt.sample_hypers(n=120, nburn=20, seed=4, n_chains=4)
    assert tht.shape == thj.shape == (120, 2) and np.all(tht > 0)
    np.testing.assert_allclose(tht.mean(0), thj.mean(0), rtol=0.25)
    ratio = np.std(np.log(tht), 0) / np.maximum(np.std(np.log(thj), 0), 1e-9)
    assert np.all((0.3 < ratio) & (ratio < 3.0)), ratio


def test_only_the_sampler_factors_on_chol_batch(monkeypatch):
    """With every tensor taken for the card's (each wrapper then runs its
    plain version on the CPU), the sampler's float32 log densities factor
    their stacks on ``chol_batch``, while ``log_mll`` under ``no_grad`` (the
    fit's restart scoring) and ``gp_fit(ladder=False)`` stay with the
    library. Both float32 routes stay within 1e-3 of the float64 log density
    (the library's own error there is up to 4.6e-4)."""
    from tpubq_torch.ops import hopper_kernels as hk

    _, b32 = tp.make_pair("float32")
    _, st64, ot64 = _single()
    st, ot = b32.state, b32.options
    calls = []
    chol_batch = hk.chol_batch
    monkeypatch.setattr(hk, "chol_batch", lambda a: calls.append(a.shape) or chol_batch(a))
    kt = tkern("gaussian")[0]
    thetas = torch.as_tensor(np.exp(_u_rows(2, 3, seed=6)), dtype=torch.float32)
    args = (st.gp_log_l.s, st.x_s, st.tl_s, st.obs_mask)
    us = {joint: _u_rows(4 if joint else 2, 3) for joint in (False, True)}
    want = {j: tmarg.log_density(st64, ot64, sample_l=j)(torch.as_tensor(u)).numpy() for j, u in us.items()}
    lib = {j: tmarg.log_density(st, ot, sample_l=j)(torch.as_tensor(u, dtype=torch.float32)).numpy()
           for j, u in us.items()}
    mll_lib = tgp.log_mll(kt, thetas, *args, 1e-10)
    monkeypatch.setattr(hk, "on_card", lambda t: True)
    with torch.no_grad():
        np.testing.assert_array_equal(tgp.log_mll(kt, thetas, *args, 1e-10).numpy(), mll_lib.numpy())
        tgp.gp_fit(kt, thetas, *args, base_jitter=1e-10, ladder=False)
        assert calls == []
        for j, u in us.items():
            got = tmarg.log_density(st, ot, sample_l=j)(torch.as_tensor(u, dtype=torch.float32)).numpy()
            np.testing.assert_allclose(got, want[j], rtol=0, atol=1e-3)
            np.testing.assert_allclose(lib[j], want[j], rtol=0, atol=1e-3)
    assert calls == [(3, 16, 16), (3, 16, 16), (3, 28, 28)]


def test_joint_rows_marginalize_choose_next_and_stacked():
    """On the same joint θ rows the port's ``marginalize``, ``choose_next``
    and ``BQ.marginalize(stacked=True)`` equal the JAX package's (float64,
    1e-10); float32 on the CPU within the marginalized f32-vs-f64 pins;
    ``apply_hyper_sample`` raises the JAX package's ``ValueError`` on a bad
    width."""
    bj, bt = tp.make_pair("float64")
    rows = bt.sample_hypers(params=JOINT, n=4, seed=5)
    assert rows.shape == (4, 4) and np.all(rows > 0)
    assert np.unique(rows[:, 3]).size > 1  # the linear GP's w moved
    stacked = bt.marginalize(n=4, params=JOINT, seed=5, stacked=True)
    assert stacked.shape == (4, 2)
    zm_j, zv_j = (np.asarray(o) for o in jmarg.marginalize(bj.state, bj.options, jnp.asarray(rows)))
    zm_t, zv_t = (tp.np_(o) for o in tmarg.marginalize(bt.state, bt.options, torch.as_tensor(rows)))
    # V[Z] (~1e-6 here) is the remainder of γ²(Q − qᵀK_tl⁻¹q) with Q, the
    # prior variance of the log-GP's integral, ~1e-1: it is held at 1e-10 of
    # γ²Q. The two packages differ by up to 1.6e-14 there (3e-8 of V[Z]).
    st = tbq.apply_hyper_sample(bt.state, bt.options, torch.as_tensor(rows))
    th = st.gp_log_l.theta
    scale = (st.gamma**2 * igr.int_int_K(1, th[:, 0], th[:, 1:], st.x_mean, st.x_var)).numpy()
    for got in ((zm_t, zv_t), (stacked[:, 0], stacked[:, 1])):
        np.testing.assert_allclose(got[0], zm_j, rtol=1e-10)
        assert np.all(np.abs(got[1] - zv_j) <= 1e-10 * scale)

    x_j, sc_j = jacq.choose_next(bj.state, bj.options, jnp.asarray(GRID), jnp.asarray(rows[:2]))
    x_t, sc_t = tacq.choose_next(bt.state, bt.options, GRID, torch.as_tensor(rows[:2]))
    np.testing.assert_allclose(tp.np_(x_t), np.asarray(x_j), rtol=1e-12)
    np.testing.assert_allclose(tp.np_(sc_t), np.asarray(sc_j), rtol=1e-10)

    _, b32 = tp.make_pair("float32")
    zm32, zv32 = (tp.np_(o) for o in tmarg.marginalize(b32.state, b32.options,
                                                       torch.as_tensor(rows, dtype=torch.float32)))
    np.testing.assert_allclose(zm32, zm_j, rtol=1e-4)
    np.testing.assert_allclose(zv32.mean(), zv_j.mean(), rtol=5e-2)

    bad = np.ones(3)
    with pytest.raises(ValueError) as ej:
        jbq.apply_hyper_sample(bj.state, bj.options, jnp.asarray(bad))
    with pytest.raises(ValueError) as et:
        tbq.apply_hyper_sample(bt.state, bt.options, torch.as_tensor(bad))
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------


def _lik_t(x):
    return torch.exp(-0.5 * (x[0] - 0.2) ** 2 / 0.25) / np.sqrt(2.0 * np.pi * 0.25)


def _lik_j(x):
    return jnp.exp(-0.5 * (x[0] - 0.2) ** 2 / 0.25) / jnp.sqrt(2 * jnp.pi * 0.25)


def _fleet(dtype="float64"):
    """(JAX fleet state, JAX options, port fleet state, port options), B = 3."""
    rng = np.random.RandomState(0)
    xs = np.stack([np.linspace(-2.2, 2.2, 10) + 0.04 * rng.standard_normal(10) for _ in range(3)])
    ls = np.stack([stats.norm.pdf(xs[i], MUS[i], SIGS[i]) for i in range(3)])
    oj, ot = JOptions(dtype=dtype, **FLEET_KW), TOptions(dtype=dtype, **FLEET_KW)
    kw = dict(params_tl=tp.PARAMS_TL, params_l=tp.PARAMS_L)
    return jbat.init_batch(xs, ls, oj, **kw), oj, tbat.init_batch(xs, ls, ot, device="cpu", **kw), ot


def test_fleet_sampler_rows_equal_the_plain_sampler_per_problem():
    """``sample_hypers_batch``: problem b's chain is one row of the fleet's
    lock-step batch, on the uniforms of row b; it equals the plain sampler on
    problem b alone (float64, 1e-12), for θ_tl and for joint rows."""
    _, _, st, ot = _fleet()
    for params in (None, JOINT):
        th = tbat.sample_hypers_batch(st, ot, torch.Generator().manual_seed(8), 3, nburn=1, params=params)
        coords, joint = tmarg.param_coords(params or ("h", "w"), ot)
        assert th.shape == (3, 3, len(coords))
        unif = tmarg.draw_uniforms(torch.Generator().manual_seed(8), 3, 4, len(coords))
        for b in range(3):
            one = tbq.tree_map(lambda a: a[b], st)
            u0 = torch.log(one.gp_log_l.theta)
            if joint:
                u0 = torch.cat([u0, torch.log(one.gp_l.theta)])
            plain = tmarg.slice_sample_plain(tmarg.log_density(one, ot, joint), u0, unif[b], 3, 1)
            np.testing.assert_allclose(th[b].numpy(), torch.exp(plain).numpy(), rtol=1e-12)


@pytest.mark.parametrize("joint", [False, True], ids=["theta_tl", "joint"])
def test_marginalize_batch_matches_jax(joint):
    sj, oj, st, ot = _fleet()
    p = 4 if joint else 2
    rows = np.exp(np.stack([_u_rows(p, 4, seed=10 + b) for b in range(3)]))
    zm_j, zv_j = (np.asarray(o) for o in jbat.marginalize_batch(sj, oj, jnp.asarray(rows)))
    zm_t, zv_t = (tp.np_(o) for o in tbat.marginalize_batch(st, ot, rows))
    assert zm_t.shape == (3, 4)
    np.testing.assert_allclose(zm_t, zm_j, rtol=1e-10)
    np.testing.assert_allclose(zv_t, zv_j, rtol=1e-10)


def test_choose_next_marg_batch_and_marginalized_loop_match_jax():
    """Two steps of ``run_active_loop_batch(hyper_samples=)`` match the JAX
    fleet's scan (float64: picks to 1e-12, E[Z] to 1e-8 and V[Z] to 1e-6, the
    pins of tests/test_torch_fleet.py's unmarginalized loop), and
    ``choose_next_marg_batch`` makes the JAX scan's first picks (each step
    there is the JAX ``choose_next_marg_batch``: the per-problem
    ``choose_next`` over the problem's own rows), in one chunk and in chunks
    of one row."""
    sj, oj, st, ot = _fleet()
    rows = np.exp(np.stack([_u_rows(2, 3, seed=20 + b) for b in range(3)]))
    grid = jnp.asarray(GRID)[:, None]
    fj, (zm_j, zv_j) = jbat.run_active_loop_batch(sj, oj, _lik_j, grid, 2, hyper_samples=jnp.asarray(rows))
    ft, (zm_t, zv_t) = tbat.run_active_loop_batch(st, ot, _lik_t, GRID, 2, hyper_samples=rows)
    np.testing.assert_allclose(tp.np_(ft.x_s), np.asarray(fj.x_s), rtol=1e-12)
    np.testing.assert_allclose(tp.np_(zm_t), np.asarray(zm_j), rtol=1e-8)
    np.testing.assert_allclose(tp.np_(zv_t), np.asarray(zv_j), rtol=1e-6)

    x_j = np.asarray(fj.x_s)[:, 10]  # the first step's picks (ns = 10 before it)
    x_t = tp.np_(tbat.choose_next_marg_batch(st, ot, GRID, rows))
    np.testing.assert_allclose(x_t, x_j, rtol=1e-12)
    old = tbat._MARG_CHUNK_ELEMS
    try:
        tbat._MARG_CHUNK_ELEMS = 1  # one row of every problem at a time
        assert tbat.marg_chunk(3, 3, len(GRID), ot) == 1
        np.testing.assert_allclose(tp.np_(tbat.choose_next_marg_batch(st, ot, GRID, rows)), x_j, rtol=1e-12)
    finally:
        tbat._MARG_CHUNK_ELEMS = old


def test_bqfleet_marginalization_facade():
    """``BQFleet.sample_hypers`` / ``marginalize`` / ``choose_next(n > 0)`` /
    ``run_active_loop(n > 0)`` on the CPU: shapes, positivity, a fleet
    marginalize equal to ``marginalize_batch`` on the draws of the same seed,
    and float32 (the fleet kernels' plain twins) picking on the grid."""
    rng = np.random.RandomState(1)
    xs = np.stack([np.linspace(-2.2, 2.2, 10) + 0.04 * rng.standard_normal(10) for _ in range(3)])
    ls = np.stack([stats.norm.pdf(xs[i], MUS[i], SIGS[i]) for i in range(3)])
    fleet = tpubq_torch.BQFleet(xs, ls, device="cpu", params_tl=tp.PARAMS_TL, params_l=tp.PARAMS_L,
                                **FLEET_KW)
    th = fleet.sample_hypers(n=4, nburn=2, seed=1, n_chains=2)
    assert th.shape == (3, 4, 2) and np.all(th > 0)
    zm, zv = fleet.marginalize(n=4, seed=2)
    rows = tbat.sample_hypers_batch(fleet.states, fleet.options, torch.Generator().manual_seed(2), 4)
    zm2, _ = tbat.marginalize_batch(fleet.states, fleet.options, rows)
    assert zm.shape == zv.shape == (3, 4) and np.all(zv >= 0)
    np.testing.assert_array_equal(zm, zm2.numpy())
    assert fleet.marginalize(n=2, params="w", seed=2)[0].shape == (3, 2)
    x_next = fleet.choose_next(GRID, n=2, seed=3)
    assert x_next.shape == (3, 1) and np.all(np.isin(x_next[:, 0], GRID))
    zms, zvs = fleet.run_active_loop(_lik_t, GRID, 2, n=2, seed=4)
    assert zms.shape == zvs.shape == (2, 3) and fleet.ns.tolist() == [12, 12, 12]

    f32 = tpubq_torch.BQFleet(xs, ls, device="cpu", dtype="float32", params_tl=tp.PARAMS_TL,
                              params_l=tp.PARAMS_L, **FLEET_KW)
    x32 = f32.choose_next(GRID, n=2, seed=3)
    assert x32.shape == (3, 1) and np.all(np.isin(x32[:, 0].astype(np.float64), GRID.astype(np.float32)))
