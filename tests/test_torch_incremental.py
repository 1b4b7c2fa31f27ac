"""The port's incremental updates (tpubq_torch.models.incremental) and the
incremental modes of ``run_active_loop`` against the JAX package.

A float64 JAX state of the testbed (tests/util.py: 10 points, max_obs 16) is
carried into the port (``tests/torch_parity.to_torch``) and the same step is
taken by both. The primitives (``gp_border_add``,
``delete_candidate_slots_kinv``) and ``add_observation_fast`` are called
directly in both packages, with no jit; only the loop test compiles one JAX
program. Tolerances: the pins of tests/test_incremental.py — rtol 1e-7 /
atol 1e-10 on the state's vectors and factors, 1e-7 relative to the largest
entry on K⁻¹ (whose entries reach ~1e6 at s = 0: two float64 evaluations
differ by ~1e-16·κ there), and rtol 1e-4 for the near-duplicate location,
whose Gram is conditioned at ~1e9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from tests import util as tu
from tpubq.models import acquire as jacq, incremental as jinc
from tpubq.ops.kernels import get_kernel as jget_kernel
from tpubq_torch.models import acquire as tacq, bq as tbq, incremental as tinc
from tpubq_torch.ops.kernels import get_kernel as tget_kernel


def _pair(**overrides):
    bq = tu.make_bq(**overrides)
    tst, topts = tp.to_torch(bq.state, bq.options)
    return bq, tst, topts


def _close(got, want, rtol=1e-7, atol=1e-10, what=""):
    got, want = tp.np_(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _assert_states_close(port, jax_state, rtol=1e-7, atol=1e-10):
    np.testing.assert_array_equal(tp.np_(port.obs_mask), np.asarray(jax_state.obs_mask))
    np.testing.assert_array_equal(tp.np_(port.c_mask), np.asarray(jax_state.c_mask))
    assert int(port.ns) == int(jax_state.ns)
    for name in ("x_s", "l_s", "tl_s", "x_c", "l_c"):
        _close(getattr(port, name), getattr(jax_state, name), rtol, atol, name)
    for gp_name in ("gp_log_l", "gp_l"):
        gt, gj = getattr(port, gp_name), getattr(jax_state, gp_name)
        assert bool(gt.ok) and bool(gj.ok)
        for f in ("L", "alpha", "y"):
            _close(getattr(gt, f), getattr(gj, f), rtol, atol, f"{gp_name}.{f}")
        kt, kj = tp.np_(gt.Kinv), np.asarray(gj.Kinv)
        assert np.abs(kt - kj).max() <= rtol * np.abs(kj).max(), f"{gp_name}.Kinv"


def _interior_point_clear_of_candidates(bq):
    st, opts = bq.state, bq.options
    x_c = np.asarray(st.x_c)[np.asarray(st.c_mask), 0]
    for cand in np.linspace(-2.0, 2.0, 97):
        if (np.abs(x_c - cand).min() > opts.candidate_thresh
                and np.abs(np.asarray(bq.x_s)[:, 0] - cand).min() > 1e-3):
            return float(cand)
    raise AssertionError("no interior point clear of the candidates")


def _case(bq, case):
    if case == "flip":  # on a live candidate: Woodbury deletion and bordering
        return float(np.asarray(bq.state.x_c)[np.asarray(bq.state.c_mask)][0, 0])
    if case == "no_flip":
        return _interior_point_clear_of_candidates(bq)
    if case == "out_of_range":  # extends the range: the full refit
        return 3.1
    return float(np.asarray(bq.x_s)[4, 0]) + 2e-5  # near-duplicate: the Schur guard


@pytest.mark.parametrize("case", ["flip", "no_flip", "out_of_range", "near_duplicate"])
def test_add_observation_fast_matches_jax(case):
    bq, tst, topts = _pair()
    xa = _case(bq, case)
    la = float(tu.f_l(xa))
    want = jinc.add_observation_fast(bq.state, bq.options, jnp.asarray([xa]), la)
    got = tinc.add_observation_fast(tst, topts, torch.tensor([xa], dtype=torch.float64), la)
    tol = dict(rtol=1e-4, atol=1e-7) if case == "near_duplicate" else {}
    _assert_states_close(got, want, **tol)
    full = tacq.add_observation(tst, topts, torch.tensor([xa], dtype=torch.float64), la)
    if case == "flip":
        assert int(got.c_mask.sum()) < int(tst.c_mask.sum())
    if case == "no_flip":
        assert torch.equal(got.c_mask, tst.c_mask)
    for f in (tbq.Z_mean, tbq.Z_var):  # the fast step against the port's own full refit
        np.testing.assert_allclose(float(f(got, topts)), float(f(full, topts)), rtol=tol.get("rtol", 1e-7))


def test_gp_border_add_matches_jax():
    """The log-GP bordered with its factor row, and the linear GP without,
    on the slot the next observation takes."""
    bq, tst, _ = _pair()
    st = bq.state
    xa = _interior_point_clear_of_candidates(bq)
    i = int(st.ns)
    x_new = np.asarray(st.x_s).copy()
    x_new[i, 0] = xa
    y_new = np.asarray(st.tl_s).copy()
    y_new[i] = float(np.log1p(tu.f_l(xa)))
    kj, kdj = jget_kernel("gaussian")
    kt, kdt = tget_kernel("gaussian")
    for update_L in (True, False):
        gj, sj, cj = jinc.gp_border_add(kj, kdj, st.gp_log_l._replace(x=jnp.asarray(x_new)), i,
                                        jnp.asarray(x_new), jnp.asarray(y_new), update_L)
        gt, stt, ct = tinc.gp_border_add(kt, kdt, tst.gp_log_l._replace(x=torch.tensor(x_new)), torch.tensor(i),
                                         torch.tensor(x_new), torch.tensor(y_new), update_L)
        _close(stt, sj, what="s_schur")
        _close(ct, cj, what="kappa")
        for f in ("L", "alpha", "mask", "y"):
            _close(getattr(gt, f), getattr(gj, f), what=f)
        assert np.abs(tp.np_(gt.Kinv) - np.asarray(gj.Kinv)).max() <= 1e-7 * np.abs(np.asarray(gj.Kinv)).max()


def test_delete_candidate_slots_kinv_matches_jax():
    bq, tst, topts = _pair()
    flip = np.asarray(bq.state.c_mask).copy()
    flip[np.flatnonzero(flip)[1:]] = False  # the first live candidate
    flip[np.flatnonzero(np.asarray(bq.state.c_mask))[-1]] = True  # and the last
    want = np.asarray(jinc.delete_candidate_slots_kinv(bq.state.gp_l.Kinv, jnp.asarray(flip), bq.options.max_obs))
    got = tp.np_(tinc.delete_candidate_slots_kinv(tst.gp_l.Kinv, torch.tensor(flip), topts.max_obs))
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    for j in np.flatnonzero(flip) + topts.max_obs:  # deleted slots return to identity
        np.testing.assert_allclose(got[j], np.eye(got.shape[0])[j], atol=1e-8 * np.abs(want).max())


def test_refresh_cadence_takes_the_full_refit(monkeypatch):
    """ns landing on the cadence takes the full refit (a stamp on the state
    tells the branch); off the cadence the fast path."""
    bq, tst, topts = _pair()  # ns = 10
    xa = torch.tensor([0.55], dtype=torch.float64)
    la = float(tu.f_l(0.55))
    real_fit = tinc._fit_gps

    def stamped(state, o):
        out = real_fit(state, o)
        return out._replace(gamma=out.gamma + 123.0)

    monkeypatch.setattr(tinc, "_fit_gps", stamped)
    assert float(tinc.add_observation_fast(tst, topts, xa, la, refresh_every=11).gamma) > 100.0
    assert float(tinc.add_observation_fast(tst, topts, xa, la, refresh_every=16).gamma) < 100.0
    monkeypatch.setattr(tinc, "_fit_gps", real_fit)
    on_cadence = tinc.add_observation_fast(tst, topts, xa, la, refresh_every=11)
    full = tacq.add_observation(tst, topts, xa, la)
    for gp_name in ("gp_log_l", "gp_l"):
        assert torch.equal(getattr(on_cadence, gp_name).Kinv, getattr(full, gp_name).Kinv)


def test_refresh_every_validated_and_fleet_state_refused():
    _, tst, topts = _pair()
    for bad in (0, -3):
        with pytest.raises(ValueError, match="refresh_every"):
            tinc.add_observation_fast(tst, topts, np.array([0.33]), 0.5, refresh_every=bad)
    fleet = tst._replace(ns=tst.ns[None])
    with pytest.raises(ValueError, match="fleet"):
        tinc.add_observation_fast(fleet, topts, np.array([0.33]), 0.5)


def test_incremental_auto_window():
    """The window measured on the H100 is empty (the refit won the closed
    loop at every max_obs from 64 to 1024, before and after the triangular
    solve became one launch, but at 192 where the runs disagree), so "auto"
    resolves to the refit everywhere; the JAX package's v5e window
    (112, 224) is not carried over."""
    lo, hi = tinc.INCREMENTAL_AUTO_WINDOW
    assert not any(tinc.incremental_auto(m) for m in (16, 64, 96, 128, 192, 256, 512, 1024, 2048))
    assert all(tinc.incremental_auto(m) == (lo <= m < hi) for m in range(0, 2049, 7))


def _lik_j(x):
    s2 = tu.SIG_L**2
    return jnp.exp(-0.5 * (x[0] - tu.MU_L) ** 2 / s2) / jnp.sqrt(2 * jnp.pi * s2)


def _lik_t(x):
    s2 = tu.SIG_L**2
    return torch.exp(-0.5 * (x[0] - tu.MU_L) ** 2 / s2) / np.sqrt(2 * np.pi * s2)


def test_run_active_loop_modes_match_jax():
    """The port's loop with incremental=True, False and "auto" against one JAX
    loop (incremental=True; exact in float64, so every mode agrees): the same
    picks, E[Z] at rtol 1e-8, V[Z] at rtol 1e-6 (the pins of
    tests/test_incremental.py); record_moments=False gives the same final state."""
    bq, tst, topts = _pair(max_obs=32)
    grid = np.linspace(-4, 4, 81)
    _, (xs_j, zm_j, zv_j) = jacq.run_active_loop(bq.state, bq.options, _lik_j, jnp.asarray(grid)[:, None], 5,
                                                 incremental=True)
    g = torch.tensor(grid)[:, None]
    finals, picks = [], []
    for mode in (True, False, "auto"):
        final, (xs, zm, zv) = tacq.run_active_loop(tst, topts, _lik_t, g, 5, incremental=mode)
        picks.append(xs)
        np.testing.assert_allclose(tp.np_(xs), np.asarray(xs_j), atol=1e-12)
        np.testing.assert_allclose(tp.np_(zm), np.asarray(zm_j), rtol=1e-8)
        np.testing.assert_allclose(tp.np_(zv), np.asarray(zv_j), rtol=1e-6, atol=1e-14)
        assert int(final.ns) == 15
        finals.append(final)
    quiet, xs_q = tacq.run_active_loop(tst, topts, _lik_t, g, 5, incremental=True, record_moments=False)
    assert torch.equal(xs_q, picks[0]) and torch.equal(quiet.gp_l.alpha, finals[0].gp_l.alpha)
