"""Build and load the hand-written CUDA kernels in ``tpubq_torch/csrc``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one compiler
process per source and all of them at once, and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, from the sources in the package only, into ``BUILD_DIR``
(``tpubq_torch/_build/``, or the directory that
``utils.profiling.enable_compile_cache`` names); the library's name carries a content hash of the
sources and flags, so an edited source never loads a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("esm_fused.cu", "chol_batch.cu", "mll_grad.cu", "esm_fleet_l.cu", "esm_fleet_tl.cu",
           "gaussian_gram.cu", "chol_blocked.cu", "tri_solve_blocked.cu", "chol_batched.cu")
#: Headers the sources include (hashed with them, never compiled alone).
HEADERS = ("chol_tile.cuh", "esm_fleet_common.cuh", "tri_block.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ip = ctypes.POINTER(ctypes.c_int)
_ll, _llp = ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)
_SIG = {
    "tpubq_esm_fused": ([_p, _p, _i, _i, _p, _p, _p, _p, _p, _i, _p, _p, _p, _p, _i, _p, _p, _p], _i),
    "tpubq_chol_batch": ([_p, _p, _i, _i, _i, _p], _i),
    "tpubq_mll_grad": ([_p, _p, _p, _p, _p, _f, _i, _i, _i, _i, _i, _p, _ll, _p, _ll, _p, _p, _p, _p], _i),
    "tpubq_mll_grad_scratch": ([_i, _i, _llp, _llp], None),
    "tpubq_esm_fleet_l": (
        [_p, _p, _p, _i, _i, _p, _p, _p, _p, _p, _i, _i, _f, _f, _i, _i, _p, _p, _p, _p],
        _i,
    ),
    "tpubq_esm_fleet_tl": ([_p, _p, _p, _i, _i, _p, _p, _p, _p, _i, _i, _i, _i, _p, _p, _p], _i),
    "tpubq_gaussian_gram": ([_p, _p, _p, _i, _i, _i, _p, _p], _i),
    "tpubq_chol_blocked": ([_p, _p, _p, _p, _p, _i, _p], _i),
    "tpubq_tri_solve_blocked": ([_p, _p, _p, _p, _i, _i, _p], _i),
    "tpubq_chol_batched": ([_p, _p, _p, _p, _p, _i, _i, _i, _ip, _p], _i),
}

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def so_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libtpubq_kernels-{h.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> dict:
    """Compile the library if it is not built yet → {"path", "seconds", "log"}.

    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills per
    kernel) and returns the compiler's report in ``log``.
    """
    so = so_path()
    if so.exists() and not verbose:
        return {"path": str(so), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{pathlib.Path(src).stem}.o" for src in SOURCES]
    tmp = BUILD_DIR / f"{tag}.tmp"
    t0 = time.perf_counter()
    try:
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
                 "-o", str(obj), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(SOURCES, objs)
        ]
        logs = [(p.communicate()[1], p.returncode) for p in procs]
        for src, (err, rc) in zip(SOURCES, logs):
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {src} ({rc}):\n{err}")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    return {"path": str(so), "seconds": seconds, "log": "".join(err for err, _ in logs)}


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()["path"])
            for name, (argtypes, restype) in _SIG.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib
