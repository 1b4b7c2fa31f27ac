"""Covariance kernels of the five families, as functions of a flat parameter vector.

Counterpart of ``tpubq/ops/kernels.py``. Parameterizations:

  gaussian: ``theta = [h, w_1..w_d]``, k = h² exp(−½ r²), r = ‖(a − b)/w‖
  periodic: ``theta = [h, w, p]`` (1-D), k = h² exp(−2 sin²((a − b)/(2p)) / w²)
  matern52: ``theta = [h, w_1..w_d]``, k = h² (1 + √5 r + 5r²/3) exp(−√5 r)
  matern32: ``theta = [h, w_1..w_d]``, k = h² (1 + √3 r) exp(−√3 r)
  rq:       ``theta = [h, w_1..w_d, α]``, k = h² (1 + r²/(2α))^(−α)

Every function broadcasts over leading batch axes: ``theta`` (..., p),
``x1`` (..., n1, d), ``x2`` (..., n2, d) → (..., n1, n2). A float32 gaussian
Gram on a CUDA device with one parameter vector and unbatched inputs is the
hand-written ``gaussian_gram`` kernel; every other Gram is plain torch, as the
JAX package computes it through XLA.
"""

from __future__ import annotations

import math

import torch

from tpubq_torch.ops import hopper_kernels as hk
from tpubq_torch.utils.device import resolve_device

__all__ = [
    "sqdist", "get_kernel",
    "gaussian_K", "gaussian_Kdiag", "periodic_K", "periodic_Kdiag",
    "matern52_K", "matern52_Kdiag", "matern32_K", "matern32_Kdiag", "rq_K", "rq_Kdiag",
    "GaussianKernel", "PeriodicKernel", "Matern52Kernel", "Matern32Kernel", "RationalQuadraticKernel",
]


def sqdist(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Scaled squared distances Σ_j ((x1_i − x2_j)/w_j)² → (..., n1, n2)."""
    a = x1 / w[..., None, :]
    b = x2 / w[..., None, :]
    return ((a[..., :, None, :] - b[..., None, :, :]) ** 2).sum(-1)


def _h2(theta):
    h = theta[..., 0]
    return (h * h)[..., None, None]


def _const_diag(theta, x):
    h = theta[..., 0]
    return (h * h)[..., None] * torch.ones_like(x[..., 0])


def gaussian_K(theta: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Gaussian (RBF) Gram matrix."""
    if (theta.ndim == 1 and x1.ndim == 2 and x2.ndim == 2
            and all(t.dtype == torch.float32 and hk.on_card(t) for t in (theta, x1, x2))):
        return hk.gaussian_gram(theta.contiguous(), x1.contiguous(), x2.contiguous())
    return _h2(theta) * torch.exp(-0.5 * sqdist(x1, x2, theta[..., 1:]))


def periodic_K(theta: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Periodic Gram matrix, ``theta = [h, w, p]``."""
    w, p = theta[..., 1], theta[..., 2]
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    s = torch.sin(diff / (2.0 * p)[..., None, None, None]) ** 2
    return _h2(theta) * torch.exp(-2.0 * s.sum(-1) / (w * w)[..., None, None])


def matern52_K(theta: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Matérn-5/2 Gram matrix: h² (1 + √5 r + 5r²/3) exp(−√5 r)."""
    r2 = sqdist(x1, x2, theta[..., 1:])
    r = torch.sqrt(r2 + 1e-36)  # finite gradient at r = 0
    s5r = math.sqrt(5.0) * r
    return _h2(theta) * (1.0 + s5r + (5.0 / 3.0) * r2) * torch.exp(-s5r)


def matern32_K(theta: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Matérn-3/2 Gram matrix: h² (1 + √3 r) exp(−√3 r)."""
    r = torch.sqrt(sqdist(x1, x2, theta[..., 1:]) + 1e-36)
    s3r = math.sqrt(3.0) * r
    return _h2(theta) * (1.0 + s3r) * torch.exp(-s3r)


def rq_K(theta: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Rational-quadratic Gram: h² (1 + r²/(2α))^(−α), ``theta = [h, w_1..w_d, α]``.

    Evaluated as h² exp(−α log1p(r²/(2α))), where the JAX package takes the
    power of the rounded 1 + r²/(2α): equal in exact arithmetic, but in
    float32 near the gaussian limit (α ≳ 10³, where a fit on smooth data
    drives α) the rounded base leaves the Gram ~1e-4 off and no longer
    positive definite at the jitter ladder's last rung."""
    a = theta[..., -1][..., None, None]
    r2 = sqdist(x1, x2, theta[..., 1:-1])
    return _h2(theta) * torch.exp(-a * torch.log1p(r2 / (2.0 * a)))


# Every family's k(x, x) is h².
gaussian_Kdiag = periodic_Kdiag = matern52_Kdiag = matern32_Kdiag = rq_Kdiag = _const_diag

_KERNELS = {
    "gaussian": (gaussian_K, gaussian_Kdiag),
    "periodic": (periodic_K, periodic_Kdiag),
    "matern52": (matern52_K, matern52_Kdiag),
    "matern32": (matern32_K, matern32_Kdiag),
    "rq": (rq_K, rq_Kdiag),
}


def get_kernel(name: str):
    """Return ``(K, Kdiag)`` for a kernel family."""
    try:
        return _KERNELS[name]
    except KeyError:
        raise ValueError(f"unknown kernel {name!r}") from None


class _KernelFacade:
    """Object-style kernel with parameter derivatives: ``K``, ``jacobian``
    (∂K/∂params, (p, n1, n2)) and ``hessian`` ((p, p, n1, n2)), the
    derivatives by ``torch.func.jacfwd``. float64, on ``device`` (the CUDA
    card unless the caller names another)."""

    _name: str = ""

    def __init__(self, *params, device="cuda"):
        self.device = resolve_device(device)
        self.params = torch.as_tensor(params, dtype=torch.float64, device=self.device)
        self._kfn, self._kdiagfn = get_kernel(self._name)
        self._jac = torch.func.jacfwd(self._kfn)
        self._hess = torch.func.jacfwd(self._jac)

    def _2d(self, x):
        x = torch.as_tensor(x, dtype=torch.float64, device=self.device)
        return x[:, None] if x.ndim == 1 else x

    def K(self, x1, x2):
        return self._kfn(self.params, self._2d(x1), self._2d(x2))

    def jacobian(self, x1, x2):
        return torch.movedim(self._jac(self.params, self._2d(x1), self._2d(x2)), -1, 0)

    def hessian(self, x1, x2):
        return torch.movedim(self._hess(self.params, self._2d(x1), self._2d(x2)), (-2, -1), (0, 1))

    def __call__(self, x1, x2):
        return self.K(x1, x2)


class GaussianKernel(_KernelFacade):
    """k(a, b) = h² exp(−(a − b)²/(2w²)); params (h, w)."""

    _name = "gaussian"

    def __init__(self, h, w, device="cuda"):
        super().__init__(h, w, device=device)


class PeriodicKernel(_KernelFacade):
    """k(a, b) = h² exp(−2 sin²((a − b)/2p)/w²); params (h, w, p)."""

    _name = "periodic"

    def __init__(self, h, w, p, device="cuda"):
        super().__init__(h, w, p, device=device)


class Matern52Kernel(_KernelFacade):
    """Matérn-5/2; params (h, w)."""

    _name = "matern52"

    def __init__(self, h, w, device="cuda"):
        super().__init__(h, w, device=device)


class Matern32Kernel(_KernelFacade):
    """Matérn-3/2; params (h, w)."""

    _name = "matern32"

    def __init__(self, h, w, device="cuda"):
        super().__init__(h, w, device=device)


class RationalQuadraticKernel(_KernelFacade):
    """Rational quadratic; params (h, w, alpha)."""

    _name = "rq"

    def __init__(self, h, w, alpha, device="cuda"):
        super().__init__(h, w, alpha, device=device)
