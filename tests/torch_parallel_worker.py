"""The rank worker of tests/test_torch_parallel.py: one process of a gloo
world that runs every function of ``tpubq_torch.parallel`` on the CPU.

It imports torch, numpy and the port only (no JAX), so that a spawned rank
starts in a few seconds. Inputs come from one ``.npz`` that the test writes:
each state as the flat checkpoint fields under ``<case>/`` with its options
under ``<case>/__opt_``, and the grids and hyper rows under their own names.
Each rank writes what it computed, as numpy arrays, to ``rank<r>.npz``.
"""

import math

import numpy as np
import torch
import torch.distributed as dist

from tpubq_torch.models import acquire
from tpubq_torch.parallel import mesh as pmesh
from tpubq_torch.parallel import sharded as sh
from tpubq_torch.utils import convert
from tpubq_torch.utils import io as tio

#: The testbed's likelihood N(x; MU_L, SIG_L²) (tests/util.py), the fleet loop's.
MU_L, SIG_L = 0.2, 0.5
LOOP_STEPS = 3


def loglik(x):
    return torch.exp(-0.5 * (x[0] - MU_L) ** 2 / SIG_L**2) / (math.sqrt(2.0 * math.pi) * SIG_L)


def flat_state(state) -> dict:
    """A port state as flat numpy arrays under the checkpoint field names,
    K⁻¹ included (``tests/torch_parity.flat_state``'s layout)."""
    flat = tio._flat(state)
    flat["gp_l.Kinv"] = state.gp_l.Kinv.numpy()
    flat["gp_log_l.Kinv"] = state.gp_log_l.Kinv.numpy()
    return flat


def load_case(inputs: dict, case: str):
    """(port state on the CPU, port options) of one case of the input file."""
    opts = convert.options_from_dict(inputs, f"{case}/__opt_")
    flat = {k[len(case) + 1:]: v for k, v in inputs.items() if k.startswith(f"{case}/") and "/__opt_" not in k}
    return convert.state_from_numpy(flat, opts, "cpu"), opts


def demote_cases(mesh, rng):
    """``demote_near_observed(group=)`` on a 40-point grid whose first half,
    one sp shard of a (2, 2) mesh, lies within the threshold 0.2 of the live
    observations: with the second half fresh ("mixed": the near points are
    excluded) and with it near too ("all_near": the fallback demotion).
    Scores drawn from ``rng``."""
    out = {}
    x_s = torch.tensor([[-1.0], [-0.5], [0.0], [0.5], [1.5]], dtype=torch.float64)
    mask = torch.tensor([True, True, True, True, False])
    near = (x_s[:4] + torch.linspace(-0.15, 0.15, 5, dtype=torch.float64)).reshape(20, 1)
    for name, rest in (("mixed", torch.linspace(1.3, 3.0, 20, dtype=torch.float64)[:, None]),
                       ("all_near", near + 0.01)):
        grid = torch.cat([near, rest])
        scores = torch.as_tensor(rng.uniform(0.1, 1.0, 40))
        shard = sh.shard_grid(grid, mesh)
        g0 = mesh.get_local_rank(pmesh.AXIS_GRID) * shard.shape[0]
        sel = acquire.demote_near_observed(scores[g0:g0 + shard.shape[0]], shard, x_s, mask, 0.2,
                                           group=mesh.get_group(pmesh.AXIS_GRID))
        out[f"demote_{name}/sel"] = sh._gather(sel, mesh, pmesh.AXIS_GRID).numpy()
        out[f"demote_{name}/scores"], out[f"demote_{name}/grid"] = scores.numpy(), grid.numpy()
    out["demote/x_s"], out["demote/mask"] = x_s.numpy(), mask.numpy()
    return out


def run(rank: int, world: int, store_path: str, in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        mesh = pmesh.make_mesh(device="cpu")
        with np.load(in_path) as f:
            inputs = {k: f[k] for k in f.files}
        t = torch.as_tensor
        out = {"mesh_shape": np.array(mesh.shape),
               "coords": np.array([mesh.get_local_rank(pmesh.AXIS_SAMPLE), mesh.get_local_rank(pmesh.AXIS_GRID)])}
        out.update(demote_cases(mesh, np.random.RandomState(7)))

        for key, case, grid in (("choose37", "single", "grid37"), ("choose2d", "single2d", "grid49")):
            x, sc = sh.choose_next_sharded(*load_case(inputs, case), t(inputs[grid]), mesh)
            out[f"{key}/x"], out[f"{key}/scores"] = x.numpy(), sc.numpy()
        st, opts = load_case(inputs, "single")
        x, sc = sh.choose_next_sharded(st, opts, t(inputs["grid24"]), mesh, t(inputs["hyp5"]))
        out["choose_marg/x"], out["choose_marg/scores"] = x.numpy(), sc.numpy()
        for key in ("hyp10", "joint6"):
            zm, zv = sh.marginalize_sharded(st, opts, t(inputs[key]), mesh)
            out[f"marg_{key}/zm"], out[f"marg_{key}/zv"] = zm.numpy(), zv.numpy()
        out["shard_grid37"] = sh.shard_grid(t(inputs["grid37"]), mesh).numpy()

        st32, o32 = load_case(inputs, "single32")
        x, sc = sh.choose_next_sharded(st32, o32, t(inputs["grid64"]).float(), mesh, t(inputs["hyp5_32"]).float())
        out["f32_choose/x"], out["f32_choose/scores"] = x.numpy(), sc.numpy()
        zm, zv = sh.marginalize_sharded(st32, o32, t(inputs["hyp5_32"]).float(), mesh)
        out["f32_marg/zm"], out["f32_marg/zv"] = zm.numpy(), zv.numpy()

        fl, fo = load_case(inputs, "fleet5")
        zm, zv = sh.fleet_Z_moments_sharded(fl, fo, mesh)
        out["fleet_z/zm"], out["fleet_z/zv"] = zm.numpy(), zv.numpy()
        fl, fo = load_case(inputs, "fleet3")
        x, sc = sh.fleet_choose_next_sharded(fl, fo, t(inputs["grid101"]), mesh)
        out["fleet_choose/x"], out["fleet_choose/scores"] = x.numpy(), sc.numpy()
        for B in (5, 16):
            fl, fo = load_case(inputs, f"loop{B}")
            final, (zm, zv) = sh.run_active_loop_fleet_sharded(fl, fo, loglik, t(inputs["grid41"]), LOOP_STEPS, mesh)
            out.update({f"loop{B}/final.{k}": v for k, v in flat_state(final).items()})
            out[f"loop{B}/zm"], out[f"loop{B}/zv"] = zm.numpy(), zv.numpy()
            _, picks = sh.run_active_loop_fleet_sharded(fl, fo, loglik, t(inputs["grid41"]), LOOP_STEPS, mesh,
                                                        record_moments=False)
            out[f"loop{B}/picks"] = picks.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
