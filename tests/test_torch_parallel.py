"""Parity of the port's multi-device slice (``tpubq_torch.parallel``) with the
JAX package's ``tpubq.parallel`` and with the port's own unsharded path.

Four gloo ranks on the CPU form a (2, 2) mesh (``torch.multiprocessing.spawn``
over a ``FileStore``, once for the module); each runs every sharded function
in ``tests/torch_parallel_worker.py`` and writes its outputs. The inputs are
the cases of tests/test_parallel.py, built by the JAX package and carried
across as numpy arrays: 37- and 49-point grids that pad over sp, 5 and 10
hyper rows that pad over dp, joint rows, fleets of B = 3, 5 and 16, three
loop steps, d = 2. JAX runs its sharded functions on the 8-device CPU mesh
of tests/conftest.py. Tolerances, float64, relative: against JAX the port's
unsharded parity pins (scores 1e-10, states 1e-9 as tests/test_torch_fleet.py,
moments 1e-8, V[Z] of joint rows 1e-10 of γ²Q as tests/test_torch_marginalize.py);
against the port's unsharded functions the JAX suite's own
sharded pins (scores 1e-10, picks 1e-12, moments 1e-10 / 1e-8, V[Z] of joint
rows 1e-6). The float32 case is held to JAX's unsharded float32 path (its
pins at the test): JAX's float32 sharded path does not trace (ROADMAP §3,
reference fault a).
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax.numpy as jnp
from tests import torch_parallel_worker as worker
from tests import torch_parity as tp
from tests import util as tu
from tpubq.models import acquire as jacq
from tpubq.models import batched as jbat
from tpubq.models import bq as jbq
from tpubq.models import marginalize as jmarg
from tpubq.parallel import mesh as jmesh
from tpubq.parallel import sharded as jsh
from tpubq.utils.options import BQOptions as JOptions
from tpubq_torch.models import acquire as tacq
from tpubq_torch.models import batched as tbat
from tpubq_torch.models import bq as tbq
from tpubq_torch.models import marginalize as tmarg
from tpubq_torch.ops import integrals as igr
from tpubq_torch.parallel import mesh as tmesh
from tpubq_torch.parallel import sharded as tsh

WORLD = 4
SPAWN_TIMEOUT_S = 300
JOINT = ("h", "w", "h_l", "w_l")


def _fleet(B, shift, **opt_kw):
    """The JAX fleets of tests/test_parallel.py: B shifted copies of the testbed."""
    xs = np.stack([tu.make_x() + shift * i for i in range(B)])
    ls = np.stack([tu.f_l(x) for x in xs])
    opts = JOptions(candidate_thresh=0.2, max_obs=16, **opt_kw)
    return jbat.init_batch(xs, ls, opts, params_tl=(0.7, 0.8), params_l=(0.3, 0.4)), opts


def _state_2d():
    rng = np.random.RandomState(2)
    X = rng.uniform(-2, 2, (10, 2))
    L = np.exp(-0.5 * np.sum((X - 0.3) ** 2 / 0.4, axis=-1))
    opts = JOptions(dim=2, n_candidate=10, candidate_thresh=0.3, max_obs=16)
    return jbq.init_state(X, L, opts, params_tl=(0.7, 0.8, 0.9), params_l=(0.3, 0.4, 0.5),
                          x_mean=np.zeros(2), x_var=np.eye(2)), opts


@pytest.fixture(scope="module")
def cases():
    """{case: (JAX state, JAX options)} and the grids and hyper rows."""
    bq = tu.make_bq()
    bq32 = tu.make_bq(dtype="float32")
    g = np.linspace(-2.5, 2.5, 7)
    states = {
        "single": (bq.state, bq.options),
        "single2d": _state_2d(),
        "single32": (bq32.state, bq32.options),
        "fleet5": _fleet(5, 0.05, n_candidate=12),
        "fleet3": _fleet(3, 0.07, n_candidate=12),
        "loop5": _fleet(5, 0.04, n_candidate=10),
        "loop16": _fleet(16, 0.04, n_candidate=10),
    }
    arrays = {
        "grid37": np.linspace(-3, 3, 37)[:, None],
        "grid24": np.linspace(-3, 3, 24)[:, None],
        "grid49": np.stack(np.meshgrid(g, g), -1).reshape(-1, 2),
        "grid64": np.linspace(-4, 4, 64)[:, None].astype(np.float32),
        "grid101": np.linspace(-4, 4, 101)[:, None],
        "grid41": np.linspace(-4, 4, 41)[:, None],
        "hyp10": np.asarray(bq.sample_hypers(n=10, seed=13)),
        "joint6": np.asarray(bq.sample_hypers(params=JOINT, n=6, seed=3)),
    }
    # five of the rows: one sampler program fewer to compile
    arrays["hyp5"] = arrays["hyp10"][:5]
    arrays["hyp5_32"] = arrays["hyp5"].astype(np.float32)
    return states, arrays


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """Every rank's outputs, from one spawn of WORLD gloo ranks."""
    states, arrays = cases
    d = tmp_path_factory.mktemp("parallel")
    inputs = dict(arrays)
    for name, (st, opts) in states.items():
        inputs.update({f"{name}/{k}": v for k, v in tp.flat_state(st).items()})
        inputs.update({f"{name}/__opt_{k}": np.asarray(getattr(opts, k)) for k in tp.FIELD_NAMES})
    np.savez(d / "inputs.npz", **inputs)
    ctx = mp.spawn(worker.run, args=(WORLD, str(d / "store"), str(d / "inputs.npz"), str(d)), nprocs=WORLD,
                   join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            assert time.monotonic() < deadline, f"the {WORLD} ranks did not finish in {SPAWN_TIMEOUT_S} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    outs = []
    for r in range(WORLD):
        with np.load(d / f"rank{r}.npz") as f:
            outs.append({k: f[k] for k in f.files})
    return outs


@pytest.fixture(scope="module")
def out(ranks):
    return ranks[0]


@pytest.fixture(scope="module")
def port(cases):
    """{case: (port state, port options)}: the JAX states carried across."""
    states, _ = cases
    return {name: tp.to_torch(st, opts) for name, (st, opts) in states.items()}


@pytest.fixture(scope="module")
def mesh8():
    return jmesh.make_mesh(8)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), tp.np_(ref), rtol=rtol, atol=atol)


def _assert_flat_close(got: dict, ref: dict, rtol: float):
    """Every leaf of a flat state against a reference: masks and counts equal,
    the rest to ``rtol`` plus 1e-12 of the leaf's largest entry."""
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = np.asarray(got[name])
        assert g.shape == r.shape, name
        if r.dtype == bool or name == "ns":
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            scale = np.abs(r).max() if r.size else 0.0
            np.testing.assert_allclose(g, r, rtol=rtol, atol=1e-12 * scale, err_msg=name)


# ---------------------------------------------------------------------------
# the mesh, the pad, the demotion
# ---------------------------------------------------------------------------


def test_factor2_and_pad_to_multiple():
    assert tmesh._factor2(8) == (2, 4) and tmesh._factor2(7) == (1, 7) and tmesh._factor2(4) == (2, 2)
    a = torch.arange(10.0, dtype=torch.float64)[:, None]
    p, n = tsh.pad_to_multiple(a, 4)
    assert p.shape == (12, 1) and n == 10
    np.testing.assert_array_equal(p[10:].numpy(), np.full((2, 1), 9.0))
    assert tsh.pad_to_multiple(a, 5)[0] is a
    q, m = tsh.pad_to_multiple(torch.arange(6.0).reshape(2, 3), 2, axis=1)
    assert m == 3 and q[:, 3].tolist() == [2.0, 5.0]


def test_make_mesh_world_of_one_in_process(port):
    """No default group: ``make_mesh(device="cpu")`` makes a world of one gloo
    process in memory and a (1, 1) mesh, on which the sharded functions are
    bit-identical to the unsharded ones; more devices than the world, a shape
    that does not cover them, and a CUDA mesh without a card all raise."""
    assert not dist.is_initialized()
    try:
        mesh = tmesh.make_mesh(device="cpu")
        assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("dp", "sp") and dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="asked for 2 devices, have 1"):
            tmesh.make_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="does not cover"):
            tmesh.make_mesh(1, shape=(1, 2), device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                tmesh.make_mesh(device="cuda")
        st, opts = port["single"]
        grid = torch.linspace(-3, 3, 37, dtype=torch.float64)[:, None]
        for got, ref in zip(tsh.choose_next_sharded(st, opts, grid, mesh), tacq.choose_next(st, opts, grid)):
            assert torch.equal(got, ref)
        fl, fo = port["loop5"]
        g41 = torch.linspace(-4, 4, 41, dtype=torch.float64)[:, None]
        f_s, (zm_s, zv_s) = tsh.run_active_loop_fleet_sharded(fl, fo, worker.loglik, g41, 1, mesh)
        f_u, (zm_u, zv_u) = tbat.run_active_loop_batch(fl, fo, worker.loglik, g41, 1)
        assert torch.equal(f_s.x_s, f_u.x_s) and torch.equal(zm_s, zm_u) and torch.equal(zv_s, zv_u)
    finally:
        dist.destroy_process_group()


def test_every_rank_returns_the_same_full_outputs(ranks):
    """A (2, 2) mesh over the four ranks, each at its own coordinates; every
    output but a rank's grid shard is the same on all ranks."""
    assert ranks[0]["mesh_shape"].tolist() == [2, 2]
    assert sorted(tuple(r["coords"]) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if k not in ("coords", "shard_grid37"):
                np.testing.assert_array_equal(r[k], v, err_msg=k)


def test_shard_grid_gives_each_rank_its_rows(ranks, cases):
    padded = tsh.pad_to_multiple(_t(cases[1]["grid37"]), 2)[0].numpy()
    for r in ranks:
        j = int(r["coords"][1])
        np.testing.assert_array_equal(r["shard_grid37"], padded[19 * j:19 * (j + 1)])


@pytest.mark.parametrize("name", ["mixed", "all_near"])
def test_demote_near_observed_decides_the_fallback_over_the_group(out, name):
    """One sp shard sees only near points: with fresh points elsewhere they
    stay excluded (a shard-local fallback would demote them to finite
    values), and where every point is near the fallback demotes all; both
    equal to the unsharded demotion on the whole grid."""
    sel = out[f"demote_{name}/sel"]
    ref = tacq.demote_near_observed(_t(out[f"demote_{name}/scores"]), _t(out[f"demote_{name}/grid"]),
                                    _t(out["demote/x_s"]), _t(out["demote/mask"]), 0.2)
    np.testing.assert_array_equal(sel, ref.numpy())
    if name == "mixed":
        assert np.isneginf(sel[:20]).all() and np.isfinite(sel[20:]).all()
    else:
        assert np.isfinite(sel).all()


# ---------------------------------------------------------------------------
# the single problem: choose_next and marginalize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,case,grid", [("choose37", "single", "grid37"), ("choose2d", "single2d", "grid49")])
def test_choose_next_sharded_matches_jax_and_unsharded(out, cases, port, mesh8, key, case, grid):
    states, arrays = cases
    sj, oj = states[case]
    xj, scj = jsh.choose_next_sharded(sj, oj, jnp.asarray(arrays[grid]), mesh8)
    _close(out[f"{key}/scores"], scj, 1e-10)
    _close(out[f"{key}/x"], xj, 1e-12)
    xu, scu = tacq.choose_next(*port[case], _t(arrays[grid]))
    _close(out[f"{key}/scores"], scu, 1e-10)
    _close(out[f"{key}/x"], xu, 1e-12)


def test_choose_next_sharded_marginalized_matches_jax_and_unsharded(out, cases, port, mesh8):
    """5 hyper rows over dp = 2 (one padding row of zero weight)."""
    states, arrays = cases
    sj, oj = states["single"]
    xj, scj = jsh.choose_next_sharded(sj, oj, jnp.asarray(arrays["grid24"]), mesh8, jnp.asarray(arrays["hyp5"]))
    _close(out["choose_marg/scores"], scj, 1e-10)
    _close(out["choose_marg/x"], xj, 1e-12)
    xu, scu = tacq.choose_next(*port["single"], _t(arrays["grid24"]), _t(arrays["hyp5"]))
    _close(out["choose_marg/scores"], scu, 1e-8)
    _close(out["choose_marg/x"], xu, 1e-12)


@pytest.mark.parametrize("rows", ["hyp10", "joint6"])
def test_marginalize_sharded_matches_jax_and_unsharded(out, cases, port, mesh8, rows):
    """10 θ_tl rows and 6 joint θ_tl ∥ θ_l rows over the flat axis of 4."""
    states, arrays = cases
    sj, oj = states["single"]
    zmj, zvj = jsh.marginalize_sharded(sj, oj, jnp.asarray(arrays[rows]), mesh8)
    _close(out[f"marg_{rows}/zm"], zmj, 1e-8)
    if rows == "joint6":
        # tests/test_torch_marginalize.py's pin for joint rows: V[Z] (~1e-6) is
        # the remainder of γ²(Q − qᵀK_tl⁻¹q), held at 1e-10 of γ²Q
        st = tbq.apply_hyper_sample(*port["single"], _t(arrays[rows]))
        th = st.gp_log_l.theta
        scale = (st.gamma**2 * igr.int_int_K(1, th[:, 0], th[:, 1:], st.x_mean, st.x_var)).numpy()
        assert np.all(np.abs(out[f"marg_{rows}/zv"] - np.asarray(zvj)) <= 1e-10 * scale)
    else:
        _close(out[f"marg_{rows}/zv"], zvj, 1e-8)
    zmu, zvu = tmarg.marginalize(*port["single"], _t(arrays[rows]))
    _close(out[f"marg_{rows}/zm"], zmu, 1e-10)
    _close(out[f"marg_{rows}/zv"], zvu, 1e-6 if rows == "joint6" else 1e-10)


def test_float32_sharded_matches_jax_unsharded_float32(out, cases):
    """float32 (2, 2): the marginalized choose_next and marginalize against
    JAX's unsharded float32 path: scores, picks and E[Z] at
    tests/test_tpu_f32.py's pins; V[Z] at the float32 V[Z] pin of the port's
    marginalize tests, 5e-2 (tests/test_torch_marginalize.py; the JAX
    package's own float32-vs-float64 pin). V[Z] (~1e-6) is a cancellation
    remainder: on these rows each package's float32 value lies 0.1–0.8% from
    the float64 one, in either direction."""
    states, arrays = cases
    sj, oj = states["single32"]
    grid, hyp = jnp.asarray(arrays["grid64"]), jnp.asarray(arrays["hyp5_32"])
    xu, scu = jacq.choose_next(sj, oj, grid, hyp)
    _close(out["f32_choose/scores"], scu, 2e-4, 1e-8)
    _close(out["f32_choose/x"], xu, 1e-6)
    zmu, zvu = jmarg.marginalize(sj, oj, hyp)
    _close(out["f32_marg/zm"], zmu, 2e-5)
    _close(out["f32_marg/zv"], zvu, 5e-2)


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------


def test_fleet_Z_moments_sharded_matches_jax_and_unsharded(out, cases, port, mesh8):
    """B = 5 over the flat axis of 4 (three padding problems)."""
    sj, oj = cases[0]["fleet5"]
    zmj, zvj = jsh.fleet_Z_moments_sharded(sj, oj, mesh8)
    _close(out["fleet_z/zm"], zmj, 1e-8)
    _close(out["fleet_z/zv"], zvj, 1e-8)
    st, ot = port["fleet5"]
    _close(out["fleet_z/zm"], tbat.Z_mean_batch(st, ot), 1e-10)
    _close(out["fleet_z/zv"], tbat.Z_var_batch(st, ot), 1e-8)


def test_fleet_choose_next_sharded_matches_jax_and_unsharded(out, cases, port, mesh8):
    """B = 3 over dp = 2, a 101-point grid over sp = 2 (both pad)."""
    states, arrays = cases
    sj, oj = states["fleet3"]
    xj, scj = jsh.fleet_choose_next_sharded(sj, oj, arrays["grid101"][:, 0], mesh8)
    _close(out["fleet_choose/scores"], scj, 1e-10)
    _close(out["fleet_choose/x"], xj, 1e-12)
    xu, scu = tbat.choose_next_batch(*port["fleet3"], _t(arrays["grid101"]))
    _close(out["fleet_choose/scores"], scu, 1e-9)
    _close(out["fleet_choose/x"], xu, 1e-12)


@pytest.mark.parametrize("B", [5, 16])
def test_fleet_active_loop_sharded_matches_jax_and_unsharded(out, cases, port, mesh8, B):
    """Three steps, B = 5 (a padding problem) and 16 over dp = 2, the 41-point
    grid over sp = 2: the final state leaf by leaf and the moments per step
    against JAX's sharded loop and the port's unsharded one; the picks of
    ``record_moments=False`` are the observations the loop added."""
    states, arrays = cases
    sj, oj = states[f"loop{B}"]
    assert (worker.MU_L, worker.SIG_L) == (tu.MU_L, tu.SIG_L)

    def loglik(x):
        return jnp.exp(-0.5 * (x[0] - tu.MU_L) ** 2 / tu.SIG_L**2) / (jnp.sqrt(2 * jnp.pi) * tu.SIG_L)

    fj, (zmj, zvj) = jsh.run_active_loop_fleet_sharded(sj, oj, loglik, arrays["grid41"][:, 0],
                                                       worker.LOOP_STEPS, mesh8)
    final = {k[len(f"loop{B}/final."):]: v for k, v in out.items() if k.startswith(f"loop{B}/final.")}
    _assert_flat_close(final, tp.flat_state(fj), 1e-9)
    _close(out[f"loop{B}/zm"], zmj, 1e-8)
    _close(out[f"loop{B}/zv"], zvj, 1e-8)
    fu, (zmu, zvu) = tbat.run_active_loop_batch(*port[f"loop{B}"], worker.loglik, _t(arrays["grid41"]),
                                                worker.LOOP_STEPS)
    np.testing.assert_array_equal(final["ns"], fu.ns.numpy())
    _close(final["x_s"], fu.x_s, 1e-12)
    _close(out[f"loop{B}/zm"], zmu, 1e-9)
    _close(out[f"loop{B}/zv"], zvu, 1e-8, 1e-14)
    ns0 = np.asarray(sj.ns)
    added = np.stack([final["x_s"][np.arange(B), ns0 + i] for i in range(worker.LOOP_STEPS)])
    np.testing.assert_array_equal(out[f"loop{B}/picks"], added)
