"""Run one cell of the port's benchmark once and print its result as the last
line of standard output:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells are ``BENCHMARK.json``'s workloads. The program under test is
``tpubq_torch``; the kernel library is built into ``port_bench/.cache/kernels``
on a checkout's first run and loaded from there afterwards. Needs a CUDA
card: without one the run exits 2 and prints no result.
"""

import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = os.path.join(HERE, ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    sys.path.insert(0, ROOT)
    from port_bench import core

    return core.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
