"""Profiling and timing helpers (counterpart of ``tpubq/utils/profiling.py``).

``trace`` captures a ``torch.profiler`` trace of a block (CPU, and the CUDA
device where there is one) and writes it as a Chrome trace; ``annotate``
names a span in it; ``time_fn`` times a function that enqueues work on the
device, synchronising once per repeat; ``enable_compile_cache`` points the
kernel library's build at a directory that later processes reuse.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time
from typing import Callable

import torch

__all__ = ["trace", "annotate", "time_fn", "enable_compile_cache"]


def enable_compile_cache(path: str = None) -> str:
    """Build the hand-written kernels into ``path`` (default
    ``$TMPDIR/tpubq_torch_build``) instead of ``tpubq_torch/_build/``.

    The library's file name carries a hash of its sources and flags, so a
    second process that points here loads the library the first one built
    instead of compiling it again. Takes effect for a process that has not
    loaded the library yet. Returns the directory."""
    import pathlib

    from tpubq_torch.ops import _build

    path = os.path.join(tempfile.gettempdir(), "tpubq_torch_build") if path is None else path
    _build.BUILD_DIR = pathlib.Path(path)
    return str(_build.BUILD_DIR)


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Profile the block with ``torch.profiler`` and write
    ``<log_dir>/trace.json`` (Chrome trace format; default
    ``$TMPDIR/tpubq_torch_trace``). Yields the profiler."""
    log_dir = os.path.join(tempfile.gettempdir(), "tpubq_torch_trace") if log_dir is None else log_dir
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span in the trace, usable as a decorator or a context manager."""
    return torch.profiler.record_function(name)


def _devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _devices(v, found)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _devices(v, found)
    return found


def _block(out) -> None:
    """Wait for the CUDA devices that hold ``out``'s tensors, and for the
    current one where CUDA is in use (a function may return host values of
    work it enqueued); on the CPU the work ran synchronously."""
    devs = _devices(out, set())
    if torch.cuda.is_initialized():
        devs.add(torch.device("cuda", torch.cuda.current_device()))
    for dev in devs:
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, iters: int = 50, warmup: int = 2, repeats: int = 3):
    """Median seconds per call of ``fn(*args)`` → (seconds_per_call, last_output).

    Each repeat enqueues ``iters`` calls and then waits once for the devices
    that hold the output, so the time is the device's pace, not one host
    round trip per call."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _block(out)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _block(out)
        times.append((time.perf_counter() - t0) / iters)
    return statistics.median(times), out
