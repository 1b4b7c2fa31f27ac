"""The system under test, as a configuration names it: a ``tpubq_torch.BQ``
or a ``tpubq_torch.BQFleet`` built from the configuration's ``model`` block,
and the device copy of its state that each episode or round starts from."""

from __future__ import annotations

import numpy as np


def facade_options(model: dict) -> dict:
    """The facade's keyword options from a configuration's ``model`` block."""
    keys = ("kernel", "dtype", "max_obs", "n_candidate", "candidate_thresh", "x_mean", "x_var",
            "gamma", "base_jitter", "n_gh")
    kw = {k: model[k] for k in keys if k in model}
    kw["s"] = model.get("s_tl", model.get("s", 0.0))
    kw["s_l"] = model.get("s_l", kw["s"])
    return kw


def build(run, data: dict):
    """The estimator over the data's observations (x, l: (P, n))."""
    import tpubq_torch

    model = run.cfg["model"]
    kw = facade_options(model)
    dev = run.device.dev
    if run.cfg["estimator"] == "BQFleet":
        return tpubq_torch.BQFleet(data["x"], data["l"], params_tl=model["theta_tl"], params_l=model["theta_l"],
                                   device=dev, **kw)
    if data["x"].shape[0] != 1:
        raise ValueError("a BQ configuration has one problem")
    return tpubq_torch.BQ(data["x"][0], data["l"][0], device=dev, **kw).init(
        params_tl=model["theta_tl"], params_l=model["theta_l"])


def is_fleet(est) -> bool:
    import tpubq_torch

    return isinstance(est, tpubq_torch.BQFleet)


def state(est):
    return est.states if is_fleet(est) else est.state


def clone(tree):
    """A copy of a state on its device: tensors cloned, tuples rebuilt."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        vals = [clone(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def restore(est, saved):
    """The estimator with a fresh copy of ``saved`` as its state."""
    import tpubq_torch

    if is_fleet(est):
        return tpubq_torch.BQFleet.from_states(clone(saved), est.options)
    est._state = clone(saved)
    return est


def hypers(est) -> tuple:
    """(θ_tl, θ_l) as (P, 2) float64 arrays."""
    st = state(est)
    th_tl = st.gp_log_l.theta.detach().cpu().numpy().astype(np.float64)
    th_l = st.gp_l.theta.detach().cpu().numpy().astype(np.float64)
    return th_tl.reshape(-1, th_tl.shape[-1]), th_l.reshape(-1, th_l.shape[-1])


def moments(est) -> tuple:
    """(E[Z], V[Z]) as (P,) float64 arrays."""
    return (np.atleast_1d(np.asarray(est.Z_mean(), np.float64)),
            np.atleast_1d(np.asarray(est.Z_var(), np.float64)))
