"""The harness of the port's benchmark: one cell, one seed, one run.

A run makes its data from the seed, builds the system under test
(``tpubq_torch`` and nothing else) through the cell's traffic kind, warms the
cell's own shapes, measures for ``--seconds`` (a traced run instead runs
its ``trace_units`` under the profiler), reads the device's peak memory,
frees the program's state, judges what the window produced against the
plain reference, and prints one JSON line. Everything that belongs to one
configuration, cell, traffic kind or per-layer metric is found by name:

  configs/<config>.json     the deployment (model, data recipe, grid, source)
  workloads/<cell>.json     configuration, traffic kind, parameters, limits
  traffic/<kind>.py         set-up, warm-up, the window's unit, the check
  recipes/<recipe>.py       observations and integrand from the seed
  metrics/<metric>.py       one reader per per-layer metric
  reference/<module>.py     the plain reference the configuration names
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
import traceback

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, ".cache")
#: Top-level module names that must not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpubq")


# ---------------------------------------------------------------------------
# files found by name
# ---------------------------------------------------------------------------


def load_json(sub: str, name: str) -> dict:
    with open(os.path.join(BENCH, sub, f"{name}.json")) as f:
        return json.load(f)


def load_module(sub: str, name: str):
    """``<sub>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH, sub, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {sub} module {name!r} ({path})")
    key = f"port_bench.{sub}.{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of the run's seed (any integer,
    negative or past 64 bits included)."""
    words = [(seed >> s) & 0xFFFFFFFF for s in (0, 32, 64, 96)]
    return np.random.default_rng([*words, int(seed < 0), stream])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``tpubq_torch`` is not ``tpubq``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def emit(out, **kv) -> None:
    print(json.dumps(kv), file=out, flush=True)


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------


class Device:
    """The device a run drives: ``sync`` waits for it, ``span`` names a
    piece of work in the traced part of the window (closed after a sync, so
    that the work launched inside it ends inside it)."""

    def __init__(self, name: str):
        import torch

        self.torch = torch
        self.dev = torch.device(name)
        self.cuda = self.dev.type == "cuda"
        self.tracing = False

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, device: Device, name: str):
        self.device, self.name, self.rf = device, name, None

    def __enter__(self):
        if self.device.tracing:
            self.rf = self.device.torch.profiler.record_function(f"bench.{self.name}")
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.device.sync()
            self.rf.__exit__(*exc)
        return False


# ---------------------------------------------------------------------------
# the trace of the traced units
# ---------------------------------------------------------------------------


class TraceView:
    """What the per-layer readers read: the benchmark's spans and the device's
    operations of the traced units, on the profiler's clock (seconds), with
    the cell's configuration, parameters and per-unit shapes."""

    def __init__(self, spans, ops, cpu_ops, units: int, cfg: dict, params: dict, shapes: list):
        self.spans = spans          # [(name, t0, t1)], names without the "bench." prefix
        self.ops = ops              # [(name, t0, t1)] device kernels, copies and fills
        self.cpu_ops = cpu_ops      # [(name, t0, t1)] host operators
        self.units = units          # traced steps or rounds
        self.cfg, self.params = cfg, params
        self.shapes = shapes        # per traced unit: "P", "S", and per problem live "ns", "nc"
        units_spans = [s for s in spans if s[0] in ("step", "round")]
        self.window = ((min(s[1] for s in units_spans), max(s[2] for s in units_spans))
                       if units_spans else (0.0, 0.0))

    def named(self, name: str) -> list:
        return [s for s in self.spans if s[0] == name]

    def span_mean_ms(self, name: str):
        s = self.named(name)
        return 1e3 * sum(t1 - t0 for _, t0, t1 in s) / len(s) if s else None

    def ops_in(self, name: str) -> list:
        """Device operations that start inside a span of ``name`` (the span
        closes after a sync, so they also end inside it)."""
        iv = sorted((t0, t1) for _, t0, t1 in self.named(name))
        out, i = [], 0
        for op in sorted(self.ops, key=lambda o: o[1]):
            while i < len(iv) and iv[i][1] < op[1]:
                i += 1
            if i < len(iv) and iv[i][0] <= op[1] <= iv[i][1]:
                out.append(op)
        return out

    def device_s(self, name: str) -> float:
        return sum(t1 - t0 for _, t0, t1 in self.ops_in(name))

    def busy_s(self) -> float:
        """Union of the device operations' intervals inside the window."""
        lo, hi = self.window
        busy, end = 0.0, lo
        for _, t0, t1 in sorted(self.ops, key=lambda o: o[1]):
            t0, t1 = max(t0, end), min(t1, hi)
            if t1 > t0:
                busy += t1 - t0
                end = t1
        return busy

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def n_kernels(self) -> int:
        lo, hi = self.window
        return sum(1 for _, t0, _ in self.ops if lo <= t0 <= hi)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps of
        the window summed by what the host was in (the benchmark's span and
        the outermost host operator at the gap's middle)."""
        lo, hi = self.window
        by_op: dict = {}
        for name, t0, t1 in self.ops:
            if lo <= t0 <= hi:
                by_op[name[:120]] = by_op.get(name[:120], 0.0) + (t1 - t0)
        gaps, end = [], lo
        for _, t0, t1 in sorted(self.ops, key=lambda o: o[1]):
            if t0 > end:
                gaps.append((end, min(t0, hi)))
            end = max(end, t1)
            if end >= hi:
                break
        if end < hi:
            gaps.append((end, hi))
        spans = sorted((s for s in self.spans if s[0] not in ("step", "round")), key=lambda s: s[1])
        cpu = sorted(self.cpu_ops, key=lambda o: o[1])
        by_gap: dict = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            span = next((n for n, a, b in spans if a <= mid <= b), "outside")
            host = [(b - a, n) for n, a, b in cpu if a <= mid <= b]
            label = f"{span}|{max(host)[1] if host else 'python'}"[:120]
            by_gap[label] = by_gap.get(label, 0.0) + (g1 - g0)

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_gap)}


def trace_view(prof, cfg, params, shapes, units) -> TraceView:
    """Read the profiler's events in memory (no trace file)."""
    spans, ops, cpu_ops = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0 = e.start_ns() * 1e-9
        t1 = t0 + e.duration_ns() * 1e-9
        dev = str(e.device_type())
        if dev.endswith("CUDA"):
            if not name.startswith("bench."):  # the spans' copies on the device's timeline
                ops.append((name, t0, t1))
        elif name.startswith("bench."):
            spans.append((name[len("bench."):], t0, t1))
        elif name.startswith("aten::") or name.startswith("cuda"):
            cpu_ops.append((name, t0, t1))
    return TraceView(spans, ops, cpu_ops, units, cfg, params, shapes)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


class Run:
    """The state of one run that a traffic kind reads and fills."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, device: str,
                 overrides: dict = None, out=None, err=None):
        self.name = workload
        self.workload = load_json("workloads", workload)
        self.cfg = load_json("configs", self.workload["config"])
        for key, val in (overrides or {}).items():  # tests shrink a cell to a CPU size
            block, field = key.split(".", 1)
            (self.cfg if block in self.cfg else self.workload)[block][field] = val
        self.params = self.workload["params"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = Device(device)
        self.out, self.err = out or sys.stdout, err or sys.stderr

    def rng(self, stream: int) -> np.random.Generator:
        return rng(self.seed, stream)

    def recipe(self):
        return load_module("recipes", self.cfg["recipe"])

    def reference(self):
        return load_module("reference", self.cfg["reference"])


def live_counts(shape: dict) -> dict:
    """A traced unit's shape with its live-row masks (tensors held from
    before the unit) turned into per-problem counts: "ns" observations and
    "nc" candidates that the unit's work really spans."""
    P = int(shape["P"])
    return {k: (v.reshape(P, -1).sum(-1).tolist() if hasattr(v, "reshape") else v) for k, v in shape.items()}


def run_window(run: Run, cell, t_setup0: float) -> dict:
    """Warm-up is done. Untraced: run units of ``cell`` for ``run.seconds``,
    each timed on the host. Traced: run ``trace_units`` units under the
    profiler instead, each in its spans, with the live rows of its state."""
    torch = run.device.torch
    traced_n = int(run.params.get("trace_units", 0)) if run.trace else 0
    host_unit_s, shapes = [], []
    counts = dict(units=0, failed=0, work=0)

    def one(tracing: bool):
        cell.prepare()  # inside the window, outside the unit's own time
        if tracing:
            shapes.append(cell.shape())  # tensors of the state: no device work inside the trace
        t_unit = time.perf_counter()
        try:
            with run.device.span(cell.unit_name):
                w = cell.unit()
            run.device.sync()
            counts["work"] += w
        except Exception:  # a unit that raises is a failed answer: counted, and the state restored
            counts["failed"] += 1
            traceback.print_exc(file=run.err)
            cell.recover()
            w = 0
            if tracing:
                shapes[-1] = None
        counts["units"] += 1
        if w and not tracing:
            host_unit_s.append(time.perf_counter() - t_unit)

    run.device.sync()
    t_start = time.perf_counter()
    prof = None
    if traced_n:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if run.device.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        run.device.tracing = True
        for _ in range(traced_n):
            one(True)
        run.device.tracing = False
        prof.stop()
        shapes = [live_counts(s) if s is not None else None for s in shapes]
    else:
        deadline = t_start + run.seconds
        while time.perf_counter() < deadline:
            one(False)
    t_end = time.perf_counter()
    return dict(setup_s=t_start - t_setup0, window_s=t_end - t_start, host_unit_s=host_unit_s, prof=prof,
                shapes=shapes, traced=traced_n, **counts)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict = None, t0: float = None, out=None, err=None) -> dict:
    """One run of one cell → the result's dictionary (also printed by ``main``)."""
    t0 = time.perf_counter() if t0 is None else t0
    run = Run(workload, seed, seconds, trace, device, overrides, out, err)
    torch = run.device.torch
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations state float32
    torch.backends.cudnn.allow_tf32 = False
    build = {}
    marks = [("start", t0), ("imports", time.perf_counter())]
    if run.device.cuda:
        torch.zeros(1, device=run.device.dev)  # the CUDA context
        marks.append(("context", time.perf_counter()))
        from tpubq_torch.ops import _build
        from tpubq_torch.utils.profiling import enable_compile_cache

        enable_compile_cache(os.path.join(CACHE, "kernels"))
        build = _build.build()
        _build.library()
        marks.append(("library", time.perf_counter()))
    kind = load_module("traffic", run.workload["traffic"])
    cell = kind.Cell(run)
    cell.setup()
    run.device.sync()
    marks.append(("state", time.perf_counter()))
    warm_failed = 0
    try:
        cell.warm()
        run.device.sync()
    except Exception:  # a failed answer in the warm-up, as in the window
        warm_failed = 1
        traceback.print_exc(file=run.err)
        cell.recover()
    marks.append(("warm", time.perf_counter()))
    emit(run.out, phase="setup", build_s=build.get("seconds", 0.0),
         library=os.path.basename(build.get("path", "")),
         **{f"{b[0]}_s": b[1] - a[1] for a, b in zip(marks, marks[1:])})
    if run.device.cuda:
        torch.cuda.reset_peak_memory_stats(run.device.dev)
    win = run_window(run, cell, t0)
    win["failed"] += warm_failed
    memory_peak = int(torch.cuda.max_memory_allocated(run.device.dev)) if run.device.cuda else 0
    emit(run.out, phase="window", setup_s=win["setup_s"], window_s=win["window_s"], units=win["units"],
         failed=win["failed"], work=win["work"], memory_peak_bytes=memory_peak)
    metrics, dev_extra, breakdown = {}, {}, None
    spec_metrics = metric_specs(run.name)
    if trace:
        tv = None
        if win["prof"] is not None:
            tv = trace_view(win["prof"], run.cfg, run.params, win["shapes"], win["traced"])
            win["prof"] = None
        for m in spec_metrics["per_layer"]:
            val = load_module("metrics", m["name"]).read(tv) if tv is not None else None
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        if tv is not None:
            dev_extra = dict(busy_s=tv.busy_s(), window_s=tv.window_s())
            breakdown = tv.breakdown()
    else:
        e2e = cell.end_to_end(win)
        e2e["setup_s"] = win["setup_s"]
        for m in spec_metrics["end_to_end"]:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    emit(run.out, phase="metrics", **{k: v["value"] for k, v in metrics.items()})
    outputs = cell.outputs()
    cell.release()
    if run.device.cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = cell.check(outputs)
    emit(run.out, phase="check", seconds=time.perf_counter() - t_check,
         **{k: v["value"] for k, v in checks.items()})
    correct = win["failed"] == 0 and all(passes(c) for c in checks.values())
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of the JAX package or JAX are loaded: {bad}")
    devinfo = dict(platform="gpu" if run.device.cuda else "cpu",
                   kind=torch.cuda.get_device_name(run.device.dev) if run.device.cuda else "cpu",
                   count=int(run.workload.get("chips", 1)), memory_peak_bytes=memory_peak, **dev_extra)
    result = dict(correct=bool(correct), attempted=int(win["units"]), failed=int(win["failed"]),
                  metrics=metrics, device=devinfo)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {'ok' if passes(c) else 'FAIL'}",
              file=run.err, flush=True)
    return result


def passes(check: dict) -> bool:
    """A number compared passes at or under its limit; one that is missing
    (not finite) fails."""
    return check["value"] is not None and check["value"] <= check["limit"]


def metric_specs(cell: str) -> dict:
    """The cell's end-to-end and per-layer metrics from ``BENCHMARK.json``."""
    spec = benchmark_spec()

    def mine(ms):
        return [m for m in ms if "workloads" not in m or cell in m["workloads"]]

    return dict(end_to_end=mine(spec["end_to_end"]), per_layer=mine(spec["per_layer"]))


def main(args, t0: float) -> int:
    import torch

    spec = benchmark_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(cells)}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0=t0)
    print(json.dumps(result), flush=True)
    return 0
