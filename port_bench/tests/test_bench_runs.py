"""Whole runs of each cell on the CPU at a small size (the harness's look for
a card skipped): the last line's keys, the imports a run leaves loaded, and
the faults that must turn ``correct`` false."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from port_bench import core, system  # noqa: E402

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Each cell cut to a size the CPU runs in seconds.
SMALL = {
    "fleet.loop": {"data.B": 16, "grid.G": 400, "params.check_problems": 16, "params.trace_units": 3},
    "large.loop": {"data.n_obs": 60, "model.max_obs": 72, "grid.G": 400, "params.trace_units": 3},
    "large.hyper": {"data.n_obs": 24, "model.max_obs": 32, "params.rows": 6, "params.trace_units": 1},
    "fleet.hyper": {"data.B": 2, "params.rows": 6, "params.trace_units": 1},
}
SEED = 2**31 + 12345


def run(cell, trace=0, seconds=0.3):
    with open(os.devnull, "w") as sink:
        return core.run_cell(cell, SEED, seconds, trace, device="cpu", overrides=SMALL[cell], out=sink, err=sink)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_last_line_keys(cell):
    res = run(cell)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    specs = core.metric_specs(cell)
    assert set(res["metrics"]) == {m["name"] for m in specs["end_to_end"]}
    assert all(set(v) == {"value", "unit"} and v["value"] > 0 for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == set(core.load_json("workloads", cell)["limits"])
    json.dumps(res, allow_nan=False)


def test_traced_run_reports_per_layer_metrics_only():
    res = run("large.loop", trace=1)
    layer = {m["name"] for m in core.metric_specs("large.loop")["per_layer"]}
    assert res["metrics"] and set(res["metrics"]) <= layer
    assert {"busy_s", "window_s", "count"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_shapes_count_live_rows(cell):
    """A traced unit's shape gives each problem's live observations and
    candidates, which the rooflines count, and not the padded capacity."""
    r = core.Run(cell, SEED, 0.1, True, "cpu", SMALL[cell])
    c = core.load_module("traffic", r.workload["traffic"]).Cell(r)
    c.setup()
    sh = core.live_counts(c.shape())
    P, nc = int(r.cfg["data"].get("B", 1)), int(r.cfg["model"]["n_candidate"])
    assert sh["P"] == P and sh["ns"] == [int(r.cfg["data"]["n_obs"])] * P
    assert len(sh["nc"]) == P and all(0 <= n <= nc for n in sh["nc"])
    if cell.startswith("fleet"):  # candidates within candidate_thresh of an observation are dropped
        assert sum(sh["nc"]) < P * nc


def test_a_run_loads_no_jax():
    """After a whole run, no module whose top-level name is jax, jaxlib, flax
    or tpubq (compared whole: tpubq_torch is the program) is loaded."""
    code = ("import sys, os; sys.path.insert(0, %r); from port_bench import core, control, system; "
            "import port_bench.run; "
            "core.run_cell('fleet.loop', 1, 0.2, 0, device='cpu', overrides=%r, out=open(os.devnull, 'w'), "
            "err=open(os.devnull, 'w')); print(core.forbidden_modules(), 'tpubq_torch' in sys.modules)"
            % (os.path.dirname(BENCH), SMALL["fleet.loop"]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]


def test_reference_imports_nothing_of_the_program():
    import ast

    for f in os.listdir(os.path.join(BENCH, "reference")):
        if f.endswith(".py"):
            tree = ast.parse(open(os.path.join(BENCH, "reference", f)).read())
            mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
            mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
            assert not {m.split(".")[0] for m in mods} & {"jax", "jaxlib", "flax", "tpubq", "tpubq_torch"}, f


def test_run_without_the_program_exits_nonzero(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "fleet.loop", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


# ---------------------------------------------------------------------------
# faults planted under the timed path
# ---------------------------------------------------------------------------


def plant(monkeypatch, fn):
    """Apply ``fn`` to every estimator the run builds or restores."""
    build, restore = system.build, system.restore
    monkeypatch.setattr(system, "build", lambda run, data: fn(build(run, data)))
    monkeypatch.setattr(system, "restore", lambda est, saved: fn(restore(est, saved)))


def with_method(est, name, make):
    setattr(est, name, make(getattr(est, name), est))
    return est


def wrap_marginalize(cell, monkeypatch, fn):
    """Replace the cell's marginalization entry by ``fn(orig, state, opts, rows)``."""
    from tpubq_torch.models import batched, marginalize

    mod, name = (batched, "marginalize_batch") if cell.startswith("fleet") else (marginalize, "marginalize")
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda st, opts, rows, *a, **k: fn(orig, st, opts, rows))


def unchanged_step(cell, mp):
    """``add_observation`` (a loop) or the fit (a hyper round) returns with
    the state as it was."""
    name = "add_observation" if cell.endswith(".loop") else "fit_hypers"
    plant(mp, lambda est: with_method(est, name, lambda orig, e: lambda *a, **k: e))


def half_batch(cell, mp):
    """Half of a step's or round's work left out: the fleet's second half of
    problems keeps its state at an add; one problem's add refits on every
    other observation; a round marginalizes half of its rows and copies
    their moments over the other half."""
    if cell.endswith(".hyper"):
        def halved(orig, st, opts, rows):
            h = rows.shape[-2] // 2
            zm, zv = orig(st, opts, rows[..., :h, :])
            return tuple(torch.cat([z, z], -1)[..., : rows.shape[-2]] for z in (zm, zv))
        wrap_marginalize(cell, mp, halved)
        return

    def make(orig, est):
        def add(x, l):
            before = system.state(est)
            orig(x, l)
            if system.is_fleet(est):
                B = len(est)
                old = torch.arange(B) >= B // 2
                est._states = _tree2(lambda new, prev: torch.where(
                    old.reshape((B,) + (1,) * (new.ndim - 1)), prev, new)
                    if isinstance(new, torch.Tensor) and new.ndim and new.shape[0] == B else new,
                    est._states, before)
            else:
                from tpubq_torch.models import bq as bqm

                st = est._state
                half = st.obs_mask & (torch.arange(st.obs_mask.shape[0]) % 2 == 0)
                est._state = bqm._fit_gps(st._replace(obs_mask=half), est.options)._replace(obs_mask=st.obs_mask)
            return est
        return add
    plant(mp, lambda est: with_method(est, "add_observation", make))


def _tree2(fn, a, b):
    if isinstance(a, tuple):
        vals = [_tree2(fn, x, y) for x, y in zip(a, b)]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    return fn(a, b)


def altered_answer(cell, mp):
    """An answer altered where it is produced: each pick moved a tenth of the
    grid along; a round's first marginalized E[Z] raised by 10%."""
    if cell.endswith(".hyper"):
        def raised(orig, st, opts, rows):
            zm, zv = orig(st, opts, rows)
            zm = zm.clone()
            zm[..., 0] *= 1.1
            return zm, zv
        wrap_marginalize(cell, mp, raised)
        return

    def make(orig, est):
        def choose(grid, *a, **k):
            x = np.asarray(orig(grid, *a, **k), np.float64)
            g = grid[:, 0].cpu().numpy().astype(np.float64)
            idx = np.abs(g[None, :] - x.reshape(-1, 1)).argmin(-1)
            moved = g[(idx + g.size // 10) % g.size]
            return moved.reshape(x.shape) if x.ndim else float(moved[0])
        return choose
    plant(mp, lambda est: with_method(est, "choose_next", make))


@pytest.mark.parametrize("fault", [unchanged_step, half_batch, altered_answer], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_turns_correct_false(cell, fault, monkeypatch):
    fault(cell, monkeypatch)
    res = run(cell)
    assert res["correct"] is False, res["checks"]
