"""Every file the harness finds by name is there and says what it must, and
``BENCHMARK.json`` keeps to the limits of its format."""

import ast
import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load(sub, name):
    with open(os.path.join(BENCH, sub, f"{name}.json")) as f:
        return json.load(f)


def names(sub, ext):
    return sorted(f[: -len(ext)] for f in os.listdir(os.path.join(BENCH, sub)) if f.endswith(ext))


def defines(sub, name, *functions):
    """``<sub>/<name>.py`` defines each of ``functions`` at its top level."""
    with open(os.path.join(BENCH, sub, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    top = {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    return set(functions) <= top


@pytest.mark.parametrize("config", names("configs", ".json"))
def test_config_names_existing_modules(config):
    cfg = load("configs", config)
    assert cfg["name"] == config
    assert cfg["estimator"] in ("BQ", "BQFleet")
    assert defines("recipes", cfg["recipe"], "make")
    assert defines("reference", cfg["reference"], "Arith", "Model")
    for key in ("source", "model", "grid", "data", "assumed", "reduced"):
        assert key in cfg
    for key in ("theta_tl", "theta_l", "n_candidate", "candidate_thresh", "dtype", "max_obs"):
        assert key in cfg["model"]


@pytest.mark.parametrize("cell", names("workloads", ".json"))
def test_workload_names_existing_files(cell):
    w = load("workloads", cell)
    assert w["name"] == cell
    assert os.path.exists(os.path.join(BENCH, "configs", f"{w['config']}.json"))
    assert defines("traffic", w["traffic"], "Cell", "inputs", "judge", "control_outputs")
    assert isinstance(w["params"], dict) and w["limits"]
    assert all(isinstance(v, (int, float)) and v > 0 for v in w["limits"].values())


def test_benchmark_cells_are_the_workload_files():
    s = spec()
    for cell in s["workloads"]:
        w = load("workloads", cell["name"])
        assert {k: w[k] for k in ("config", "traffic", "chips", "why")} == {
            k: cell[k] for k in ("config", "traffic", "chips", "why")}
    pairs = [(c["config"], c["traffic"]) for c in s["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {c["config"] for c in s["workloads"]}
    for c in s["configs"]:
        assert c["name"] in used
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        assert c["reduced"] == load("configs", c["name"])["reduced"]


@pytest.mark.parametrize("metric", [m["name"] for m in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["per_layer"]])
def test_per_layer_metric_has_a_reader(metric):
    assert defines("metrics", metric, "read")


def test_benchmark_json_limits():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["port_bench"] and s["command"][1] == "port_bench/run.py"
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    cells = {c["name"] for c in s["workloads"]}
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    seen = set()
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer metric in every cell
        assert sum(cell in m.get("workloads", cells) for m in s["end_to_end"]) >= 2
        assert any(cell in m["workloads"] for m in s["per_layer"])
    for c in s["workloads"]:
        assert NAME.match(c["name"]) and c["chips"] == 1 and 1 <= len(c["why"]) <= 200
    assert len(json.dumps(s)) < 64 * 1024
