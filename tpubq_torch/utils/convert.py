"""Carry estimator state across from the JAX package.

``state_from_numpy`` builds the port's ``BQState`` from a JAX ``BQState``
flattened to numpy arrays under the checkpoint field names of
``tpubq/utils/io.py`` (``x_s``, ``gp_l.L``, ``gp_log_l.alpha``, …); ``Kinv``
is recomputed from ``L`` where the flat dict lacks it, as the JAX loader
does (by ``linalg.chol_inverse``, the route ``gp_fit`` takes). Leaves keep their leading axes, so a fleet's batched state carries
across as a batched state. ``load_tpubq_npz`` reads either checkpoint the JAX
package writes, of one problem or of a fleet.
"""

from __future__ import annotations

import numpy as np
import torch

from tpubq_torch.models import bq as bqm
from tpubq_torch.models.gp import GPState
from tpubq_torch.ops import linalg
from tpubq_torch.utils.device import resolve_device
from tpubq_torch.utils.options import FIELD_NAMES, BQOptions

__all__ = ["options_from_dict", "state_from_numpy", "load_tpubq_npz"]

_BOOL_FIELDS = {"obs_mask", "c_mask", "mask", "ok"}


def _scalar(v):
    v = np.asarray(v)[()]
    if isinstance(v, (np.str_, np.bytes_, str)):
        return str(v)
    return v.item() if hasattr(v, "item") else v


def options_from_dict(d: dict, prefix: str = "") -> BQOptions:
    """BQOptions from ``{prefix + field: value}``; missing fields keep defaults."""
    return BQOptions(**{k: _scalar(d[prefix + k]) for k in FIELD_NAMES if prefix + k in d})


def state_from_numpy(flat: dict, opts: BQOptions, device="cuda", dtype=None,
                     need_kinv: bool = True) -> bqm.BQState:
    """BQState from a flat ``{field: array}`` dict (JAX checkpoint names), on
    ``device`` (the card unless the caller names another). ``need_kinv=False``
    leaves a missing ``Kinv`` as None (for a caller that refits at once)."""
    dtype = opts.torch_dtype if dtype is None else dtype
    dev = resolve_device(device)

    def t(name, leaf):
        a = np.array(flat[name])  # a writable copy
        if leaf in _BOOL_FIELDS:
            return torch.as_tensor(a.astype(bool), device=dev)
        if leaf == "ns":
            return torch.as_tensor(a.astype(np.int64), device=dev)
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def gp(prefix):
        fields = {f: t(f"{prefix}.{f}", f) for f in GPState._fields
                  if f"{prefix}.{f}" in flat}
        if "ok" not in fields:
            fields["ok"] = torch.ones(fields["L"].shape[:-2], dtype=torch.bool, device=dev)
        if "Kinv" not in fields:  # as gp_fit forms it, so a reload scores bit-identically
            fields["Kinv"] = linalg.chol_inverse(fields["L"]) if need_kinv else None
        missing = set(GPState._fields) - set(fields)
        if missing:
            raise KeyError(f"missing GPState fields: {sorted(missing)}")
        return GPState(**fields)

    return bqm.BQState(**{
        name: gp(name) if name in ("gp_log_l", "gp_l") else t(name, name)
        for name in bqm.BQState._fields
    })


def load_tpubq_npz(path, device="cuda"):
    """Read a checkpoint of the JAX package → (BQState, BQOptions) on
    ``device`` (the card unless the caller names another).

    Accepts ``tpubq.utils.io.save_state`` files (the full state, factors
    included) and ``tpubq.BQ.save`` files (observations, hypers and options;
    the factors are rebuilt by ``init_state``).
    """
    with np.load(str(path), allow_pickle=False) as d:
        flat = {k: d[k] for k in d.files}
    device = resolve_device(device)
    if "gp_l.L" in flat:
        opts = options_from_dict(flat, "__opt_")
        return state_from_numpy(flat, opts, device), opts
    if "theta_tl" in flat:
        opts = options_from_dict(flat, "opt_")
        state = bqm.init_state(
            flat["x_s"], flat["l_s"], opts, params_tl=flat["theta_tl"],
            params_l=flat["theta_l"], s_tl=float(flat["s_tl"]), s_l=float(flat["s_l"]),
            gamma=float(flat["gamma"]), x_mean=flat["x_mean"], x_var=flat["x_var"],
            device=device,
        )
        return state, opts
    raise ValueError(f"{path} is not a tpubq checkpoint (fields: {sorted(flat)})")
