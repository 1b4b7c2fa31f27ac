"""tpubq_torch — the PyTorch / CUDA port of tpubq's Bayesian Quadrature.

The JAX package (``tpubq``), ported to PyTorch: the Osborne-style BQ estimator with a GP on the log-likelihood and
an exp-linearized GP on the likelihood, multi-restart hyperparameter
fitting, ``Z_mean``/``Z_var``, expected-squared-mean scoring,
``choose_next`` (with off-grid refinement) / ``add_observation`` and the
active loop (full refit or incremental updates), hyperparameter
marginalization, and the fleet (``BQFleet``: B independent problems advanced
together), for the five kernel families: gaussian, periodic, Matérn-5/2,
Matérn-3/2 and rational quadratic; with health diagnostics and checkpoints
of one problem or a fleet (``utils.health``, ``utils.io``: the JAX package's
file layout, so a checkpoint of either package loads in both), the ``GP``
facade, plotting and profiling; and ``parallel/``: the sharded scorer,
marginalization and fleet loop on ``torch.distributed``, one process per
device over a (dp, sp) ``DeviceMesh`` (NCCL on the card, gloo on the CPU).
Nine kernels are written by hand for Hopper (sm_90a) in ``csrc/``,
one for each Pallas kernel of the JAX package: the fused ESM scorer, the two
batched Choleskys, the fused MLL-and-gradient of the fit, the two halves of
the fleet scorer, the gaussian Gram, and the blocked Cholesky and triangular
solve of one large matrix. The scorers, the fused fit and the Gram kernel are
gaussian-only, as in the JAX package; the other families' Grams, integrals
and scores are plain torch and run on the same factorization kernels.

The entry points (``BQ``, ``BQFleet``, ``GP``, ``utils.io``, ``utils.convert``) run on
the CUDA card unless the
caller passes ``device="cpu"``, and raise where no card is there; the
functions beneath them work on the device of the tensors they are given.
float64 is the parity dtype; float32 is the device dtype. Matrix products must
run in full float32 (``torch.backends.cuda.matmul.allow_tf32`` False, the
PyTorch default): the posterior covariances are cancellation-dominated.
"""

from tpubq_torch.models.api import BQ
from tpubq_torch.models.batched import BQFleet
from tpubq_torch.utils.options import BQOptions

__version__ = "0.1.0"
__all__ = ["BQ", "BQFleet", "BQOptions", "__version__"]
