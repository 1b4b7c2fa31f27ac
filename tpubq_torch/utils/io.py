"""State persistence for raw ``BQState``s (counterpart of ``tpubq/utils/io.py``).

Any state, a fleet's batched state included, round-trips through one
``.npz`` in the JAX package's checkpoint layout, field for field: the state's
leaves under their names (``x_s``, ``gp_l.L``, …; no ``Kinv``, which the
loader derives from ``L``), the options as ``__opt_<field>`` and side-channel
extras as ``__x_<name>``. A checkpoint written by either package loads in
both. The factors are stored, so a load is exact and refit-free;
``refit=True`` recomputes them on the device the state is restored to.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpubq_torch.models import bq as bqm
from tpubq_torch.models.gp import GPState
from tpubq_torch.utils.convert import options_from_dict, state_from_numpy
from tpubq_torch.utils.options import FIELD_NAMES as _OPT_FIELDS, BQOptions

__all__ = ["save_state", "load_state", "load_extras"]


def _npz_path(path) -> str:
    """np.savez appends .npz to a path without it; normalise so that the
    overwrite guard and the loader see the real file."""
    p = str(path)
    return p if p.endswith(".npz") else p + ".npz"


def _leaf(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.astype(np.int32) if name == "ns" else a  # the JAX package's int32 count


def _flat(state: bqm.BQState) -> dict:
    out = {}
    for name, val in state._asdict().items():
        if isinstance(val, GPState):
            for sub, sval in val._asdict().items():
                if sub != "Kinv":  # derived from L on load
                    out[f"{name}.{sub}"] = _leaf(sub, sval)
        else:
            out[name] = _leaf(name, val)
    return out


def save_state(path, state: bqm.BQState, opts: BQOptions, force: bool = False,
               extras: dict = None):
    """Write a state and its options to one ``.npz``.

    ``extras``: optional {name: scalar or array} side-channel fields (the
    fleet's seed), stored as ``__x_<name>`` and read back by ``load_extras``,
    apart from the state's and the options' names."""
    path = _npz_path(path)
    if os.path.exists(path) and not force:
        raise IOError(f"{path} already exists (use force=True)")
    np.savez(
        path,
        **_flat(state),
        **{f"__opt_{k}": getattr(opts, k) for k in _OPT_FIELDS},
        **{f"__x_{k}": np.asarray(v) for k, v in (extras or {}).items()},
    )


def load_extras(path) -> dict:
    """The ``extras`` of ``save_state`` (empty for a checkpoint without)."""
    with np.load(_npz_path(path), allow_pickle=False) as d:
        return {k[len("__x_"):]: d[k][()] for k in d.files if k.startswith("__x_")}


def load_state(path, refit: bool = False, device="cuda"):
    """Read (state, options) back onto ``device`` (the card unless the caller
    names another). Options missing from the file keep their defaults.
    ``refit=True`` recomputes both GPs' factors (``bq._fit_gps``: one refit,
    or one batched refit of a fleet)."""
    with np.load(_npz_path(path), allow_pickle=False) as d:
        flat = {k: d[k] for k in d.files}
    opts = options_from_dict(flat, "__opt_")
    state = state_from_numpy(flat, opts, device, need_kinv=not refit)
    if refit:
        state = bqm._fit_gps(state, opts)
    return state, opts
