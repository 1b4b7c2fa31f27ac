"""Closed-form gaussian-kernel integrals against a gaussian measure.

Counterpart of the gaussian family of ``tpubq/ops/integrals.py`` (each
docstring states the identity). The kernel with parameters (h, w) is a scaled
gaussian density, k(a, b) = c · N(a | b, W), W = diag(w²),
c = h² (2π)^{d/2} |W|^{1/2}; the measure is p(x) = N(x | mu, Sigma).

Shapes: points ``x`` (..., n, d); ``h`` (...); ``w`` (..., d); ``mu`` (..., d);
``Sigma`` (..., d, d). Leading batch axes broadcast (marginalize passes (B,)
hypers against shared points and one measure; a fleet gives every argument a
problem axis).
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "gauss_logpdf",
    "int_K",
    "int_int_K",
    "int_K1_K2",
    "int_int_K1_K2",
    "int_K1_int_K2",
]

_LOG2PI = math.log(2.0 * math.pi)


def gauss_logpdf(X: torch.Tensor, mu: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """log N(X | mu, S) for X (..., m, d) and covariances S (..., d, d) → (..., m)."""
    d = S.shape[-1]
    L = torch.linalg.cholesky(S)
    diff = X - mu[..., None, :]
    sol = torch.linalg.solve_triangular(L, diff.transpose(-1, -2), upper=False)  # (..., d, m)
    quad = (sol * sol).sum(-2)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (quad + d * _LOG2PI + logdet[..., None])


def _pairwise_logpdf(X: torch.Tensor, mu: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """gauss_logpdf over a (..., n1, n2, d) grid of points → (..., n1, n2)."""
    n1, n2, d = X.shape[-3:]
    out = gauss_logpdf(X.reshape(*X.shape[:-3], n1 * n2, d), mu, S)
    return out.reshape(*out.shape[:-1], n1, n2)


def _scale(h, w):
    """c = h² (2π)^{d/2} |W|^{1/2}."""
    d = w.shape[-1]
    return (h * h) * ((2.0 * math.pi) ** (0.5 * d)) * torch.prod(w, dim=-1)


def _W(w):
    return torch.diag_embed(w * w)


def _check_w(Sigma, *ws):
    """Every length-scale vector must match the measure's dimension (a
    length-1 w would broadcast into W + Sigma and compute another integral)."""
    d = Sigma.shape[-1]
    for w in ws:
        if w.ndim < 1 or w.shape[-1] != d:
            raise ValueError(
                f"kernel length-scales must be ({d},) vectors matching the "
                f"measure dimension; got shape {tuple(w.shape)}"
            )


def int_K(x, h, w, mu, Sigma):
    """∫ k(x', x_i) N(x' | mu, Sigma) dx' → (..., n).  Identity: c · N(x_i | mu, W + Sigma)."""
    _check_w(Sigma, w)
    return _scale(h, w)[..., None] * torch.exp(gauss_logpdf(x, mu, _W(w) + Sigma))


def int_int_K(d, h, w, mu, Sigma):
    """∫∫ k(x, x') p(x) p(x') dx dx' → (...).  Identity: c · N(0 | 0, W + 2 Sigma)."""
    del d
    _check_w(Sigma, w)
    zero = torch.zeros_like(mu)
    lp = gauss_logpdf(zero[..., None, :], zero, _W(w) + 2.0 * Sigma)[..., 0]
    return _scale(h, w) * torch.exp(lp)


def int_K1_K2(x1, x2, h1, w1, h2, w2, mu, Sigma):
    """∫ k1(x1_i, x) k2(x, x2_j) p(x) dx → (..., n1, n2).

    Identity: with C = (W1⁻¹ + W2⁻¹)⁻¹ and m_ij = C (W1⁻¹ x1_i + W2⁻¹ x2_j):
    c1 c2 · N(x1_i | x2_j, W1 + W2) · N(m_ij | mu, C + Sigma).
    """
    _check_w(Sigma, w1, w2)
    w1s, w2s = w1 * w1, w2 * w2
    C = torch.diag_embed(w1s * w2s / (w1s + w2s))
    ws = (w1s + w2s)[..., None, None, :]
    m = (w2s[..., None, None, :] * x1[..., :, None, :]
         + w1s[..., None, None, :] * x2[..., None, :, :]) / ws
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    term1 = _pairwise_logpdf(diff, torch.zeros_like(mu), _W(w1) + _W(w2))
    term2 = _pairwise_logpdf(m, mu, C + Sigma)
    c = _scale(h1, w1) * _scale(h2, w2)
    return c[..., None, None] * torch.exp(term1 + term2)


def int_int_K1_K2(x1, x2, h1, w1, h2, w2, mu, Sigma):
    """∫∫ k1(x1_a, x) k2(x, x') k1(x', x2_b) p(x) p(x') dx dx' → (..., n1, n2).

    Identity: with A = W1 + Sigma, S1 = (W1⁻¹ + Sigma⁻¹)⁻¹ and
    δm_ab = Sigma A⁻¹ (x1_a − x2_b):
    c1² c2 · N(x1_a | mu, A) · N(x2_b | mu, A) · N(δm_ab | 0, 2 S1 + W2).
    """
    _check_w(Sigma, w1, w2)
    W1, W2 = _W(w1), _W(w2)
    A = W1 + Sigma
    S1 = W1 @ torch.linalg.solve(A, Sigma.expand_as(A))
    M = torch.linalg.solve(A.transpose(-1, -2), Sigma.transpose(-1, -2).expand_as(A)).transpose(-1, -2)
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    dm = torch.einsum("...ij,...abj->...abi", M, diff)
    la = gauss_logpdf(x1, mu, A)
    lb = gauss_logpdf(x2, mu, A)
    lm = _pairwise_logpdf(dm, torch.zeros_like(mu), 2.0 * S1 + W2)
    c1 = _scale(h1, w1)
    c2 = _scale(h2, w2)
    return (c1 * c1 * c2)[..., None, None] * torch.exp(la[..., :, None] + lb[..., None, :] + lm)


def int_K1_int_K2(x1, h1, w1, h2, w2, mu, Sigma):
    """∫∫ k1(x1_a, x) k2(x, x') p(x) p(x') dx dx' → (..., n1).

    Identity: with S3 = ((W2 + Sigma)⁻¹ + Sigma⁻¹)⁻¹:
    c1 c2 · N(0 | 0, W2 + 2 Sigma) · N(x1_a | mu, W1 + S3).
    """
    _check_w(Sigma, w1, w2)
    W1, W2 = _W(w1), _W(w2)
    B = W2 + Sigma
    S3 = B @ torch.linalg.solve(W2 + 2.0 * Sigma, Sigma.expand_as(B))
    zero = torch.zeros_like(mu)
    l0 = gauss_logpdf(zero[..., None, :], zero, W2 + 2.0 * Sigma)
    la = gauss_logpdf(x1, mu, W1 + S3)
    c = _scale(h1, w1) * _scale(h2, w2)
    return c[..., None] * torch.exp(l0 + la)
