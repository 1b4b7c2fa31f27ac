"""ctypes loader of the C++ oracle ``native/bq_native.cpp``.

The source is a sequential float64 reimplementation of the reference's
native layer (bq_c.pyx): the gaussian ``int_K`` family, the periodic
integrals, ``improve_conditioning`` and the 1-D ESM grid scorer. It shares no
code with the port, so it is the one reference on the card's machine that is
not port code. It is read in place, never copied, and compiled with ``g++``
at first use into ``tpubq_torch/_build/`` (``ops._build.BUILD_DIR``), the
library named by a hash of the source and flags.

There is no quiet fallback: ``load()`` raises with the compiler's output
when the build or the library's selftest fails. ``available()`` only tells a
caller that can do without the oracle (a CPU test) whether it loads.

Inputs are numpy arrays or CPU tensors; outputs are numpy float64.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import subprocess
import threading
import time

import numpy as np

from tpubq_torch.ops import _build

__all__ = [
    "SRC",
    "load",
    "available",
    "int_K",
    "int_int_K",
    "int_K1_K2",
    "int_int_K1_K2",
    "int_K1_int_K2",
    "int_K_periodic",
    "int_int_K1_K2_periodic",
    "improve_conditioning",
    "esm_grid",
    "esm_grid_state",
]

SRC = pathlib.Path(__file__).resolve().parents[2] / "native" / "bq_native.cpp"
CXX = "g++"
#: The flags of the JAX package's loader: no -march=native, so a library that
#: outlives its build host does not trap on another CPU.
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_f8 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_d, _n = ctypes.c_double, ctypes.c_size_t
_SIG = {
    "bq_int_K": ([_f8, _f8, _n] + [_d] * 4, None),
    "bq_int_int_K": ([_d] * 4, _d),
    "bq_int_K1_K2": ([_f8, _f8, _n, _f8, _n] + [_d] * 6, None),
    "bq_int_int_K1_K2": ([_f8, _f8, _n, _f8, _n] + [_d] * 6, None),
    "bq_int_K1_int_K2": ([_f8, _f8, _n] + [_d] * 6, None),
    "bq_improve_conditioning": ([_f8, _f8, _n], _d),
    "bq_int_K_periodic": ([_f8, _f8, _n] + [_d] * 5 + [ctypes.c_int], None),
    "bq_int_int_K1_K2_periodic": ([_f8, _f8, _n, _f8, _n] + [_d] * 8 + [ctypes.c_int], None),
    "bq_esm_grid": ([_f8, _f8, _n, _f8, _n, _f8, _f8, _f8, _n, _f8, _f8] + [_d] * 8, None),
}

_lock = threading.Lock()
_lib = None


def so_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return pathlib.Path(_build.BUILD_DIR) / f"libbq_native-{h.hexdigest()[:12]}.so"


def build() -> dict:
    """Compile the oracle if it is not built yet → {"path", "seconds", "log"};
    raises ``RuntimeError`` with the compiler's output if it fails."""
    so = so_path()
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "log": ""}
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building the C++ oracle failed: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the C++ oracle failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, so)
    return {"path": str(so), "seconds": time.perf_counter() - t0, "log": res.stderr}


def _open(so: str):
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        raise RuntimeError(f"loading the C++ oracle failed: {e}") from e
    for name, (argtypes, restype) in _SIG.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    # int_int_K(h=1, w=1, mu=0, s2=1) = 1/sqrt(3): a foreign or broken binary fails here
    got = float(lib.bq_int_int_K(1.0, 1.0, 0.0, 1.0))
    if not math.isfinite(got) or abs(got - 1.0 / math.sqrt(3.0)) > 1e-9:
        raise RuntimeError(f"the C++ oracle's selftest failed: int_int_K(1, 1, 0, 1) = {got}")
    return lib


def load():
    """The loaded oracle library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _open(build()["path"])
    return _lib


def available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def _c(x):
    return np.ascontiguousarray(np.asarray(x, np.float64).reshape(-1))


def _m(x):
    return np.ascontiguousarray(np.asarray(x, np.float64))


def int_K(x, h, w, mu, s2):
    x = _c(x)
    out = np.empty_like(x)
    load().bq_int_K(out, x, x.size, float(h), float(w), float(mu), float(s2))
    return out


def int_int_K(h, w, mu, s2):
    return np.float64(load().bq_int_int_K(float(h), float(w), float(mu), float(s2)))


def int_K1_K2(x1, x2, h1, w1, h2, w2, mu, s2):
    x1, x2 = _c(x1), _c(x2)
    out = np.empty((x1.size, x2.size))
    load().bq_int_K1_K2(out, x1, x1.size, x2, x2.size, *map(float, (h1, w1, h2, w2, mu, s2)))
    return out


def int_int_K1_K2(x1, x2, h1, w1, h2, w2, mu, s2):
    x1, x2 = _c(x1), _c(x2)
    out = np.empty((x1.size, x2.size))
    load().bq_int_int_K1_K2(out, x1, x1.size, x2, x2.size, *map(float, (h1, w1, h2, w2, mu, s2)))
    return out


def int_K1_int_K2(x1, h1, w1, h2, w2, mu, s2):
    x1 = _c(x1)
    out = np.empty_like(x1)
    load().bq_int_K1_int_K2(out, x1, x1.size, *map(float, (h1, w1, h2, w2, mu, s2)))
    return out


def int_K_periodic(x, h, w, p, mu, s2, nterms=64):
    x = _c(x)
    out = np.empty_like(x)
    load().bq_int_K_periodic(out, x, x.size, *map(float, (h, w, p, mu, s2)), int(nterms))
    return out


def int_int_K1_K2_periodic(x1, x2, t1, t2, mu, s2, nterms=64):
    x1, x2 = _c(x1), _c(x2)
    out = np.empty((x1.size, x2.size))
    load().bq_int_int_K1_K2_periodic(out, x1, x1.size, x2, x2.size, *map(float, (*t1[:3], *t2[:3], mu, s2)),
                                     int(nterms))
    return out


def improve_conditioning(K):
    """The factor of K + jitter·I under the reference's jitter ladder → (L, jitter);
    jitter −1 where every rung failed."""
    K = _m(K)
    L = np.empty_like(K)
    jitter = float(load().bq_improve_conditioning(K, L, K.shape[0]))
    return L, jitter


def esm_grid(grid, xsc, alpha, L_l, xs, alpha_tl, L_tl, h_l, w_l, h_tl, w_tl,
             mu, s2, gamma=1.0, thresh=0.0):
    """Sequential ESM scores of a 1-D grid: the linear GP's live rows ``xsc``,
    its ``alpha`` and factor ``L_l``, the log-GP's ``xs``, ``alpha_tl`` and
    ``L_tl``. A point within ``thresh`` of a row of ``xsc``, or whose Schur
    complement h_l² − kᵀK⁻¹k is ≤ 1e-14, scores (zᵀα)²."""
    grid, xsc, alpha, xs, alpha_tl = map(_c, (grid, xsc, alpha, xs, alpha_tl))
    L_l, L_tl = _m(L_l), _m(L_tl)
    out = np.empty_like(grid)
    load().bq_esm_grid(out, grid, grid.size, xsc, xsc.size, alpha, L_l, xs, xs.size, alpha_tl, L_tl,
                       *map(float, (h_l, w_l, h_tl, w_tl, mu, s2, gamma, thresh)))
    return out


def esm_grid_state(state, opts, grid):
    """``esm_grid`` on a 1-D gaussian port state (single, on any device): its
    live rows, factors and alphas in float64, ``thresh = candidate_thresh``."""
    def np64(t):
        return t.detach().double().cpu().numpy()

    m_sc, m_s = np64(state.sc_mask).astype(bool), np64(state.obs_mask).astype(bool)
    gp_l, gp_tl = state.gp_l, state.gp_log_l
    return esm_grid(
        grid,
        np64(state.x_sc)[m_sc, 0], np64(gp_l.alpha)[m_sc], np64(gp_l.L)[np.ix_(m_sc, m_sc)],
        np64(state.x_s)[m_s, 0], np64(gp_tl.alpha)[m_s], np64(gp_tl.L)[np.ix_(m_s, m_s)],
        *np64(gp_l.theta)[:2], *np64(gp_tl.theta)[:2], np64(state.x_mean)[0], np64(state.x_var)[0, 0],
        float(state.gamma), opts.candidate_thresh,
    )
