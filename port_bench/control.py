"""The control of each cell's ``correct``: the plain reference put in the
program's place and computed one precision step below the configurations'
float32 (every matrix product on TF32-rounded operands), at the cell's own
size, judged by the same comparison as a run. It has to come out as not
correct; its readings set the upper end of each limit.

    python3 port_bench/control.py --workload <cell> --seeds <n> [<n> ...] [--mode tf32|f64]

Prints one JSON line per seed: each number compared (a missing one: the
control gave no finite answer somewhere), the same over its finite answers
only, and the cell's limits. ``--mode f64`` puts the float64 reference
itself in the program's place, which has to read near 0 (a check of the
judge). Runs on the CUDA card, or with ``--device cpu`` at a size set by
``--set block.key=value``.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def readings(workload: str, seed: int, mode: str = "tf32", device: str = "cuda", overrides: dict = None) -> dict:
    from port_bench import core

    run = core.Run(workload, seed, 0.0, False, device, overrides)
    kind = core.load_module("traffic", run.workload["traffic"])
    t0 = time.perf_counter()
    data, ctx = kind.inputs(run)
    out = kind.control_outputs(run, data, ctx, mode)
    t1 = time.perf_counter()
    strict = kind.judge(run, data, ctx, out)
    finite = kind.judge(run, data, ctx, out, finite_only=True)
    return dict(workload=workload, seed=seed, mode=mode, control_s=t1 - t0, judge_s=time.perf_counter() - t1,
                values={k: v["value"] for k, v in strict.items()},
                finite_values={k: v["value"] for k, v in finite.items()},
                limits={k: v["limit"] for k, v in strict.items()},
                correct=all(core.passes(v) for v in strict.values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", choices=("tf32", "f64"), default="tf32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], help="block.key=value (a JSON value)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(HERE))
    overrides = {k: json.loads(v) for k, v in (s.split("=", 1) for s in args.set)}
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.mode, args.device, overrides)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
