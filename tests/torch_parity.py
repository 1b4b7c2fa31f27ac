"""Shared builders for the parity tests of the PyTorch port (tpubq_torch).

Both packages get the same inputs: the seeded 1-D testbed of ``tests/util.py``
(x = linspace(−2.2, 2.2, 10), ℓ = N(x; 0.2, 0.5²), max_obs = 16), and JAX
states are carried into the port through ``tpubq_torch.utils.convert`` as
numpy arrays.
"""

import numpy as np
import torch

import tpubq
from tests import util as tu
from tpubq.utils import io as jio
from tpubq_torch.utils import convert
from tpubq_torch.utils.options import FIELD_NAMES

PARAMS_TL = (0.7, 0.8)
PARAMS_L = (0.3, 0.4)
#: (θ_tl, θ_l) of each family at d = 1: the testbed's, with α = 2 for rq
#: and (h, w, p) on the periodic recipe of tests/test_periodic_exact.py.
FAMILY_PARAMS = {
    "gaussian": (PARAMS_TL, PARAMS_L),
    "matern52": (PARAMS_TL, PARAMS_L),
    "matern32": (PARAMS_TL, PARAMS_L),
    "rq": (PARAMS_TL + (2.0,), PARAMS_L + (2.0,)),
    "periodic": ((0.7, 0.8, 1.0), (0.35, 0.8, 1.0)),
}


def options(**overrides):
    opts = dict(tu.DEFAULT_OPTIONS)
    opts.update(overrides)
    return opts


def make_pair(dtype="float64", n=10, x=None, l=None, params_tl=None, params_l=None,
              kernel="gaussian", **overrides):
    """(JAX BQ, port BQ) built from the same raw (x, l) and options, with the
    kernel family ``kernel`` (its ``FAMILY_PARAMS`` unless params are given)."""
    import tpubq_torch

    x = tu.make_x(n) if x is None else x
    l = tu.f_l(x) if l is None else l
    params_tl = FAMILY_PARAMS[kernel][0] if params_tl is None else params_tl
    params_l = FAMILY_PARAMS[kernel][1] if params_l is None else params_l
    opts = options(dtype=dtype, kernel=kernel, **overrides)
    bj = tpubq.BQ(x, l, **opts).init(params_tl=params_tl, params_l=params_l)
    bt = tpubq_torch.BQ(x, l, device="cpu", **opts).init(params_tl=params_tl, params_l=params_l)
    return bj, bt


def flat_state(state) -> dict:
    """The JAX state as the checkpoint's flat numpy dict, K⁻¹ included (so
    both packages score with bit-identical inverses)."""
    flat = jio._flat(state)
    flat["gp_l.Kinv"] = np.asarray(state.gp_l.Kinv)
    flat["gp_log_l.Kinv"] = np.asarray(state.gp_log_l.Kinv)
    return flat


def to_torch(state, opts_j, device="cpu"):
    """(port state, port options) carrying the JAX state across."""
    opts = convert.options_from_dict({k: getattr(opts_j, k) for k in FIELD_NAMES})
    return convert.state_from_numpy(flat_state(state), opts, device), opts


def np_(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
