"""Covariance kernels (gaussian only), as functions of a flat parameter vector.

``theta = [h, w_1, ..., w_d]`` with k(a, b) = h² exp(−½ Σ_j ((a_j − b_j)/w_j)²).
Counterpart of ``tpubq/ops/kernels.py``. Every function broadcasts over
leading batch axes: ``theta`` (..., 1+d), ``x1`` (..., n1, d), ``x2`` (..., n2, d)
→ (..., n1, n2). A float32 Gram on a CUDA device with one parameter vector
and unbatched inputs is the hand-written ``gaussian_gram`` kernel; Grams with
batch axes (θ rows, the fleet) stay plain torch, as the JAX package computes
them through XLA.
"""

from __future__ import annotations

import torch

from tpubq_torch.ops import hopper_kernels as hk


def sqdist(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Scaled squared distances Σ_j ((x1_i − x2_j)/w_j)² → (..., n1, n2)."""
    a = x1 / w[..., None, :]
    b = x2 / w[..., None, :]
    return ((a[..., :, None, :] - b[..., None, :, :]) ** 2).sum(-1)


def gaussian_K(theta: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Gaussian (RBF) Gram matrix."""
    if (theta.ndim == 1 and x1.ndim == 2 and x2.ndim == 2
            and all(t.dtype == torch.float32 and hk.on_card(t) for t in (theta, x1, x2))):
        return hk.gaussian_gram(theta.contiguous(), x1.contiguous(), x2.contiguous())
    h = theta[..., 0]
    w = theta[..., 1:]
    return (h * h)[..., None, None] * torch.exp(-0.5 * sqdist(x1, x2, w))


def gaussian_Kdiag(theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    h = theta[..., 0]
    return (h * h)[..., None] * torch.ones_like(x[..., 0])


_KERNELS = {"gaussian": (gaussian_K, gaussian_Kdiag)}


def get_kernel(name: str):
    """Return ``(K, Kdiag)`` for a kernel family."""
    if name in _KERNELS:
        return _KERNELS[name]
    if name in ("periodic", "matern52", "matern32", "rq"):
        raise NotImplementedError(
            f"kernel {name!r} is not ported to tpubq_torch yet "
            "(ROADMAP.md, queue 1: other kernel families)"
        )
    raise ValueError(f"unknown kernel {name!r}")
