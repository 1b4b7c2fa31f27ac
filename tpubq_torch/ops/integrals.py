"""Kernel integrals against a gaussian measure, for the five kernel families.

Counterpart of ``tpubq/ops/integrals.py`` (each docstring states the identity).
The measure is p(x) = N(x | mu, Sigma).

* gaussian: closed forms. The kernel with parameters (h, w) is a scaled
  gaussian density, k(a, b) = c · N(a | b, W), W = diag(w²),
  c = h² (2π)^{d/2} |W|^{1/2}.
* matern52 / matern32: the erfcx closed form in 1-D, a Gamma scale mixture of
  gaussian closed forms for d ≥ 2, and the V[Z] cross family with the outer
  kernel mixed and the inner one exact.
* rq: a Gamma scale mixture whose nodes follow the hyperparameter α.
* periodic (1-D): the Jacobi–Anger harmonic series.

The ``approx_*`` functions are the closed forms' quadrature twins: the
trapezoid rule on a dense 1-D grid, for any kernel function.

Shapes: points ``x`` (..., n, d); ``h`` (...); ``w`` (..., d); ``alpha`` and
``p`` (...); ``mu`` (..., d); ``Sigma`` (..., d, d). Leading batch axes
broadcast (marginalize passes (S,) hypers against shared points and one
measure; a fleet gives every argument a problem axis). Where the JAX package
maps a function over θ rows or mixture nodes with ``vmap``, the port carries
them as tensor axes; the Matérn cross family flattens its batch axes to one
row axis and sweeps rows and mixture nodes in chunks (``SWEEP_ELEMS``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = [
    "gauss_logpdf",
    "int_K",
    "int_int_K",
    "int_K1_K2",
    "int_int_K1_K2",
    "int_K1_int_K2",
    "erfcx",
    "int_K_matern52_1d",
    "int_K_matern32_1d",
    "int_K_matern_mixture",
    "rq_mix_rule",
    "int_K_rq_mixture",
    "int_int_K_matern",
    "int_K1_K2_matern",
    "int_int_K1_K2_matern",
    "int_K1_int_K2_matern",
    "ive_series",
    "int_K_periodic",
    "int_int_K_periodic",
    "int_K1_K2_periodic",
    "int_int_K1_K2_periodic",
    "int_K1_int_K2_periodic",
    "approx_int_K",
    "approx_int_int_K",
    "approx_int_K1_K2",
    "approx_int_int_K1_K2",
    "approx_int_K1_int_K2",
    "SWEEP_ELEMS",
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


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    """``v`` (a tensor or a Python number) as a tensor in ``ref``'s dtype and device."""
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


# ---------------------------------------------------------------------------
# erfcx and the 1-D Matérn closed forms
# ---------------------------------------------------------------------------

#: float32 Chebyshev fits, evaluated by Clenshaw recurrences in plain float32
#: mul/adds (no transcendental library call):
#: - _ERFCX_CHEB: g(u) = erfcx(u)·(1 + 2u/√π) in t = (u−2)/(u+2) ∈ [−1, 1),
#:   covering u ∈ [0, ∞).
#: - _F1_CHEB / _F2_CHEB: the Mills-ratio complements of _int_K_matern_1d,
#:   F1(α) = 1 − αR(α) and F2(α) = (1+α²)R(α) − α with R the standard normal
#:   Mills ratio, as the bounded auxiliaries (1+α²)F1 and (2+α³)F2/2 in
#:   s = α/6 − 1 over α ∈ [0, 12]. They replace the direct assembly, which
#:   amplifies the noise of its inputs by ~α² over α ∈ [0, 6).
_ERFCX_CHEB = (
    8.2795514040283980e-01, -1.9573787691330269e-01, -6.8284124563613852e-03,
    1.4124564819029156e-02, -2.9150593136806134e-03, -7.7569528509570691e-05,
    1.0217740786959869e-04, 9.6073027852599973e-07, -4.1327910094376081e-06,
    -2.1745332359733583e-07, 1.7941956551717353e-07, 2.6676682281496646e-08,
    -6.5575648651772945e-09,
)
_F1_CHEB = (
    9.0697100663526031e-01, 1.0808025887380955e-01, -2.0641794894942188e-02,
    -3.1246544562489067e-02, 4.8924071334601443e-02, -4.6364353671299950e-02,
    3.5841259043470255e-02, -2.4525057080265530e-02, 1.5401423939274385e-02,
    -9.0544974286826188e-03, 5.0455535167581956e-03, -2.6875378266193123e-03,
    1.3767051270831372e-03, -6.8132977866146988e-04, 3.2693092072991556e-04,
    -1.5253907843837115e-04, 6.9366951538234965e-05, -3.0805048412982499e-05,
    1.3381681499386921e-05, -5.6942831870198595e-06, 2.3765405449261400e-06,
    -9.7387313701961196e-07, 3.9221742378352345e-07, -1.5538052107493575e-07,
    6.0594936812565496e-08, -2.3280017144523623e-08, 8.8155524771129735e-09,
)
_F2_CHEB = (
    8.3883377003486781e-01, 1.2847196583842588e-01, 5.2593205744496323e-02,
    -1.3039781241954970e-01, 1.3139911884272656e-01, -9.9523178630157777e-02,
    6.3648966354373185e-02, -3.5833612213943732e-02, 1.8012980684947947e-02,
    -8.0448098734394718e-03, 3.0878187167689506e-03, -9.0585960569216815e-04,
    8.5429929178327269e-05, 1.4578425564798917e-04, -1.6070750521851766e-04,
    1.1761541316780905e-04, -7.3016760199505918e-05, 4.1166560763753485e-05,
    -2.1709368887370796e-05, 1.0878988945571889e-05, -5.2305665917719197e-06,
    2.4283546579951329e-06, -1.0935951255589405e-06, 4.7935511324476047e-07,
    -2.0504871578015308e-07, 8.5776512592994033e-08, -3.5150938452998066e-08,
    1.4131569502928587e-08, -5.5801763485730284e-09, 2.1666974994536749e-09,
    -8.2794920586581966e-10,
)


def _clenshaw(coeffs, t):
    """Chebyshev series Σ c_k T_k(t) by the Clenshaw recurrence (mul/adds only)."""
    t2 = 2.0 * t
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for ck in coeffs[:0:-1]:
        b1, b2 = t2 * b1 - b2 + ck, b1
    return t * b1 - b2 + coeffs[0]


#: Coefficients (−1)^{j+1}(2j−1)!!, j = 1..12, of the Mills-ratio series
#: 1 − αR(α) = Σ_j c_j α^{−2j}; (1+α²)R(α) − α = Σ_j 2j·c_j α^{−2j−1}.
_MILLS = tuple((-1.0) ** (j + 1) * math.prod(range(1, 2 * j, 2)) for j in range(1, 13))


def erfcx(u: torch.Tensor) -> torch.Tensor:
    """Scaled complementary error function e^{u²} erfc(u), for u ≥ 0.

    float32: the degree-12 Chebyshev fit of erfcx(u)·(1 + 2u/√π) in
    t = (u − 2)/(u + 2), as the JAX package evaluates it (≤ 2.7e-7 relative
    with the input's rounding). float64: ``torch.special.erfcx``, where the
    JAX package assembles exp(u²)·erfc(u) below u = 9 and a 10-term
    asymptotic series above it (the two agree to ~1e-14).
    """
    if u.dtype == torch.float32:
        t = (u - 2.0) / (u + 2.0)
        return _clenshaw(_ERFCX_CHEB, t) / (1.0 + u * (2.0 / math.sqrt(math.pi)))
    return torch.special.erfcx(u)


def _int_K_matern_1d(x, h, w, mu, Sigma, sqrt2nu, poly):
    """∫ k_ν(x', x_i) N(x' | mu, σ²) dx' for a 1-D half-integer Matérn kernel.

    The kernel is k(a, b) = h² P(c|a−b|) e^{−c|a−b|} with c = √(2ν)/w and P
    the Matérn polynomial (``poly``: its coefficients in (c·r)^n). Split at
    x' = a: on each side the integrand is an exponentially tilted gaussian,
    so each half is a sum of truncated-gaussian moments, assembled
    overflow-free with G = e^{−(a−μ)²/(2σ²)}:

        Qs = Φ(−α)e^β = ½ erfcx(α/√2) G            (α ≥ 0)
                      = e^β − ½ erfcx(−α/√2) G     (α < 0, where β < 0)
        zs = φ(α)e^β  = G/√(2π)
        T0 = Qs,  T1 = δ·Qs + σ·zs,  T2 = (σ²+δ²)·Qs + σδ·zs,   δ = −σα
        ∫ k N = h² Σ_n poly[n] cⁿ (T_n^{upper} + T_n^{lower})

    T1 and T2 cancel for large positive α; above a crossover (α = 18 in
    float64, 12 in float32) they come from the 12-term Mills-ratio series
    (summed by Horner's rule, where the JAX package sums it term by term),
    and in float32 from the Chebyshev auxiliaries over α ∈ [0, 12). A measure with
    σ² ≤ tiny (a delta at μ) gives k(x_i, μ).
    """
    if Sigma.shape[-1] != 1:
        raise ValueError(
            "the erfcx-form Matérn measure integrals are 1-D; d > 1 uses "
            "the Gamma scale-mixture route (int_K_matern_mixture)"
        )
    _check_w(Sigma, w)
    h = _like(h, x)
    a = x[..., 0]
    dtype = a.dtype
    f32 = dtype == torch.float32
    mu0 = mu[..., 0, None]
    sigma2 = Sigma[..., 0, 0, None]
    tiny = torch.finfo(dtype).tiny
    sig2s = torch.clamp(sigma2, min=tiny)
    sigma = torch.sqrt(sig2s)
    c = sqrt2nu / w[..., 0, None]
    h2 = (h * h)[..., None]
    dm = a - mu0
    G = torch.exp(-0.5 * dm * dm / sig2s)
    zs = G / math.sqrt(2.0 * math.pi)
    csig2 = c * sig2s
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    xover = 12.0 if f32 else 18.0

    acc = torch.zeros_like(dm)
    for s in (1.0, -1.0):
        alpha = (s * dm + csig2) / sigma
        delta = -sigma * alpha
        beta = 0.5 * c * csig2 + s * c * dm
        Qs_pos = 0.5 * erfcx(alpha.abs() * inv_sqrt2) * G
        Qs = torch.where(alpha >= 0.0, Qs_pos, torch.exp(torch.clamp(beta, max=0.0)) - Qs_pos)
        T1_dir = delta * Qs + sigma * zs
        T2_dir = (sig2s + delta * delta) * Qs + sigma * delta * zs
        aa = torch.clamp(alpha, min=xover)
        inv_a2 = 1.0 / (aa * aa)
        s1 = torch.full_like(aa, _MILLS[-1])  # both series by Horner's rule in α⁻²
        s2_ = torch.full_like(aa, 24.0 * _MILLS[-1])
        for j in range(11, 0, -1):
            s1 = s1 * inv_a2 + _MILLS[j - 1]
            s2_ = s2_ * inv_a2 + 2.0 * j * _MILLS[j - 1]
        s1 = s1 * inv_a2
        s2_ = s2_ * inv_a2 / aa
        big = alpha >= xover
        T1 = torch.where(big, zs * sigma * s1, T1_dir)
        T2 = torch.where(big, zs * sig2s * s2_, T2_dir)
        if f32:
            af = torch.clamp(alpha, 0.0, 12.0)
            sfit = af / 6.0 - 1.0
            F1 = _clenshaw(_F1_CHEB, sfit) / (1.0 + af * af)
            F2 = 2.0 * _clenshaw(_F2_CHEB, sfit) / (2.0 + af * af * af)
            mid = (alpha >= 0.0) & (alpha < xover)
            T1 = torch.where(mid, zs * sigma * F1, T1)
            T2 = torch.where(mid, zs * sig2s * F2, T2)
        T = (Qs, T1, T2)
        for n, p in enumerate(poly):
            acc = acc + p * (c ** n) * T[n]

    closed = h2 * acc
    r = dm.abs()
    pt = torch.zeros_like(r)
    for n, p in enumerate(poly):
        pt = pt + p * (c * r) ** n
    point = h2 * pt * torch.exp(-c * r)
    return torch.where(sigma2 <= tiny, point, closed)


def int_K_matern52_1d(x, h, w, mu, Sigma):
    """∫ k_{5/2}(x', x_i) N(x' | mu, σ²) dx' → (..., n). See _int_K_matern_1d."""
    return _int_K_matern_1d(x, h, w, mu, Sigma, math.sqrt(5.0), (1.0, 1.0, 1.0 / 3.0))


def int_K_matern32_1d(x, h, w, mu, Sigma):
    """∫ k_{3/2}(x', x_i) N(x' | mu, σ²) dx' → (..., n). See _int_K_matern_1d."""
    return _int_K_matern_1d(x, h, w, mu, Sigma, math.sqrt(3.0), (1.0, 1.0))


# ---------------------------------------------------------------------------
# Gamma scale mixtures (Matérn d ≥ 2, rq)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _matern_mix_rule(nu: float):
    """Log-trapezoid discretization of the Matérn Gamma scale mixture.

    k_ν(r) = h²/Γ(ν) ∫₀^∞ t^{ν−1} e^{−t} exp(−ν r²/(2t)) dt: a Gamma(ν)
    mixture of gaussian kernels of widths w·√(t/ν). A trapezoid rule in
    u = log t over [−12, 5.5] × 64 nodes (ν = 5/2) or [−18, 5.5] × 80 (ν = 3/2)
    keeps the absolute correlation error over r ∈ [0, 12] at ≤ 7e-13 / ≤ 2e-12.
    Returns numpy (t_q, ω_q), Σω_q = 1 (cached: callers copy).
    """
    from scipy.special import gamma as _gamma

    if nu == 2.5:
        lo, hi, n = -12.0, 5.5, 64
    elif nu == 1.5:
        lo, hi, n = -18.0, 5.5, 80
    else:
        raise ValueError(
            f"int_K_matern_mixture: no tuned mixture rule for nu={nu}; "
            "supported orders are 1.5 and 2.5 (the kernel registry's)"
        )
    u = np.linspace(lo, hi, n)
    t = np.exp(u)
    wq = t**nu * np.exp(-t) * (u[1] - u[0]) / _gamma(nu)
    return t, wq


def matern_mix_nodes(nu: float) -> int:
    """Nodes of the Matérn Gamma mixture of order ``nu``."""
    return len(_matern_mix_rule(nu)[0])


def _outer_mix_nodes(nu: float, ref: torch.Tensor):
    """(ω_q, scale_q²) of the Matérn mixture in ``ref``'s dtype and device."""
    t, wq = _matern_mix_rule(nu)
    return (torch.tensor(wq, dtype=ref.dtype, device=ref.device),
            torch.tensor(t / nu, dtype=ref.dtype, device=ref.device))


def int_K_matern_mixture(x, h, w, mu, Sigma, nu):
    """∫ k_ν(x', x_i) N(x' | mu, Sigma) dx' for half-integer Matérn, any d →
    (..., n). Each Gamma-mixture node is a gaussian kernel, so each node's
    integral is the gaussian closed form ``int_K``; the nodes are a tensor
    axis (the JAX package maps over them)."""
    _check_w(Sigma, w)
    h = _like(h, x)
    wq, s2 = _outer_mix_nodes(nu, x)
    ws = torch.sqrt(s2)[:, None] * w[..., None, :]  # (..., n_mix, d) per-node widths
    vals = int_K(x[..., None, :, :], h[..., None], ws, mu[..., None, :], Sigma[..., None, :, :])
    return torch.einsum("q,...qn->...n", wq, vals)


#: Nodes of the rq mixture rule: 96 on the grid and the analytic left tail.
RQ_MIX_NODES = 97


def _expm1_minus_x_over_x2(v):
    """(e^v − 1 − v) / v², accurate at every v: Taylor's series below |v| = ¼
    (16 terms: 1e-18 at the edge), the direct form above it."""
    small = v.abs() < 0.25
    vs = torch.where(small, v, torch.zeros_like(v))
    series = torch.zeros_like(v)
    for k in range(15, -1, -1):
        series = series * vs + 1.0 / math.factorial(k + 2)
    vd = torch.where(small, torch.ones_like(v), v)
    return torch.where(small, series, (torch.expm1(vd) - vd) / (vd * vd))


def rq_mix_rule(alpha, dtype=None):
    """Gamma(α) scale-mixture rule of the rq kernel → (scale², ω), each (..., 97).

    (1 + u)^{−α} = ∫₀^∞ Gamma(t; α, 1) e^{−t u} dt: k_rq = Σ_q ω_q ·
    gaussian(width w·√(α/t_q)). α is a hyperparameter, so the rule follows
    it: nodes t = α e^{v}, v = ν/s, s = √max(α, 1), ν on the grid [−35, 5] × 96;
    an analytic left-tail node (the mass below the grid, t_lo = α e^{v_lo},
    m₀ = t_lo^α e^{−t_lo}/Γ(α + 1), at its conditional mean t₀ = t_lo·α/(α+1));
    and ω self-normalized to sum to 1. Against the exact correlation over
    r/w ∈ [0, 12] (tests/test_torch_families.py): ≤ 2.0e-9 absolute in float64
    for α ∈ [0.5, 10³⁰], 5e-6 at α = 0.25; ≤ 2e-7 in float32 at every α ≥ 0.5.

    The log weights are taken relative to the Gamma density's mode, where
    every factor of α^α/Γ(α) cancels in the self-normalization:
    log ω_q = −α(e^v − 1 − v) + log(dν/s) and log m₀ = −α(e^{v_lo} − 1 − v_lo)
    − log α, with α(e^v − 1 − v) = min(α, 1)·ν²·(e^v − 1 − v)/v². The JAX
    package forms α log α − lnΓ(α) + αv − t and lacks the tail's e^{−t_lo}:
    the same rule in exact arithmetic while t_lo ≪ 1 (α ≲ 100), but its
    cancellation costs float32 3e-6 at α = 10⁵ and NaN at 10⁹, and the
    missing factor puts 1.1% of the mass on the tail node at α = 1225, all
    of it at α = 2000, and NaN beyond: where an MLL fit on smooth data
    drives α (the rq kernel's gaussian limit).
    """
    lo, hi, n = -35.0, 5.0, RQ_MIX_NODES - 1
    alpha = torch.as_tensor(alpha)
    alpha = alpha.to(dtype or alpha.dtype)[..., None]
    nu = torch.linspace(lo, hi, n, dtype=torch.float64).to(dtype=alpha.dtype, device=alpha.device)
    dnu = (hi - lo) / (n - 1)
    s = torch.sqrt(torch.clamp(alpha, min=1.0))
    c = torch.clamp(alpha, max=1.0)  # α / s²
    v = nu / s
    w = torch.exp(-c * (nu * nu) * _expm1_minus_x_over_x2(v)) * (dnu / s)
    vlo = lo / s
    m0 = torch.exp(-c * (lo * lo) * _expm1_minus_x_over_x2(vlo)) / alpha
    s2 = torch.cat([torch.exp(-v), torch.exp(-vlo) * (alpha + 1.0) / alpha], dim=-1)  # α / t_q
    w = torch.cat([w, m0], dim=-1)
    return s2, w / w.sum(-1, keepdim=True)


def int_K_rq_mixture(x, h, w, alpha, mu, Sigma):
    """∫ k_rq(x', x_i) N(x' | mu, Sigma) dx' for the rq kernel, any d →
    (..., n): the gaussian closed form at each node of ``rq_mix_rule(alpha)``
    (≤ 2e-9 absolute mixture error in float64 for α ≥ 0.5)."""
    _check_w(Sigma, w)
    h = _like(h, x)
    s2, wq = rq_mix_rule(_like(alpha, x))
    ws = torch.sqrt(s2)[..., None] * w[..., None, :]  # (..., 97, d) node widths
    vals = int_K(x[..., None, :, :], h[..., None], ws, mu[..., None, :], Sigma[..., None, :, :])
    return (wq[..., None] * vals).sum(-2)


# ---------------------------------------------------------------------------
# The Matérn V[Z] cross family (both kernels Matérn-ν). Only the outer kernel
# k1 is expanded in the Gamma mixture, k1 = Σ_q ω_q · gaussian(h1,
# w1·√(t_q/ν)); each node is integrated against the measure in closed form,
# and the inner kernel k2 then appears as the measure-smoothed form
# I2(δ; V) = ∫ k2(u, 0) N(u | δ, V) du, which is exact (erfcx in 1-D, the
# mixture for d ≥ 2). Per outer node q (W_q = diag((w1·√(t_q/ν))²),
# A_q = W_q + Σ):
#   N(x | x_i, W_q) N(x | μ, Σ) = N(x_i | μ, A_q) · N(x | m_iq, S_q),
#   m_iq = μ + M_q (x_i − μ),  M_q = Σ A_q⁻¹,  S_q = Σ − Σ A_q⁻¹ Σ.
# ---------------------------------------------------------------------------

#: Elements of the largest intermediate one chunk of a node sweep of the
#: Matérn cross family may form: rows (θ rows, problems) and mixture nodes or
#: node pairs are taken in chunks no larger (at least one row and one node).
SWEEP_ELEMS = 1 << 24


def _flat_rows(*args):
    """Broadcast the leading axes of ``(tensor, n_trailing)`` pairs and flatten
    them to one row axis → (batch shape, [(N, *trailing) tensors])."""
    batch = torch.broadcast_shapes(*(t.shape[:t.ndim - k] for t, k in args))
    n = math.prod(batch)
    return batch, [t.expand((*batch, *t.shape[t.ndim - k:])).reshape(n, *t.shape[t.ndim - k:])
                   for t, k in args]


def _i2_elems(d: int, nu: float) -> int:
    """Elements per point of one smoothed-kernel evaluation I2: the inner
    mixture's node axis (× d) for d ≥ 2."""
    return 1 if d == 1 else matern_mix_nodes(nu) * d


def _chunks(n_rows: int, n_nodes: int, unit: int):
    """(row slice, node slice) pairs covering n_rows × n_nodes, each holding
    at most SWEEP_ELEMS elements at ``unit`` elements per (row, node)."""
    nodes = max(1, min(n_nodes, SWEEP_ELEMS // max(1, unit)))
    rows = max(1, min(n_rows, SWEEP_ELEMS // max(1, unit * nodes)))
    for r0 in range(0, n_rows, rows):
        for q0 in range(0, n_nodes, nodes):
            yield slice(r0, r0 + rows), slice(q0, q0 + nodes)


def _matern_int_K0(points, h, w, V, nu):
    """I2(δ; V) = ∫ k_ν(u, 0) N(u | δ, V) du at each row δ of ``points``
    (..., npts, d) → (..., npts): ``int_K_matern*`` with the points as kernel
    centers and a zero-mean measure (stationarity and evenness)."""
    d = points.shape[-1]
    zero = torch.zeros((d,), dtype=points.dtype, device=points.device)
    if d == 1:
        fn = int_K_matern52_1d if nu == 2.5 else int_K_matern32_1d
        return fn(points, h, w, zero, V)
    return int_K_matern_mixture(points, h, w, zero, V, nu)


def _node_geometry(s2, w1, Sigma, X, mu):
    """Per-node gaussian / measure algebra of the mixture integrals, rows N by
    nodes m: ``s2`` (m,), ``w1`` (N, d), ``Sigma`` (N, d, d), ``X`` (N, n, d),
    ``mu`` (N, d) → (c1 (N, m) the node kernel's density scale, la (N, m, n)
    log N(X_i | μ, A_q), proj (N, m, n, d) M_q (X_i − μ), S (N, m, d, d) the
    conditional covariance S_q, symmetrized)."""
    wq1 = torch.sqrt(s2)[:, None] * w1[:, None, :]
    Sig = Sigma[:, None]
    A = _W(wq1) + Sig
    M = torch.linalg.solve(A.transpose(-1, -2), Sig.transpose(-1, -2).expand_as(A)).transpose(-1, -2)
    S = Sig - M @ Sig
    S = 0.5 * (S + S.transpose(-1, -2))
    la = gauss_logpdf(X[:, None], mu[:, None], A)
    proj = (X - mu[:, None, :])[:, None] @ M.transpose(-1, -2)
    return _scale(1.0, wq1), la, proj, S


def int_int_K_matern(h, w, mu, Sigma, nu):
    """∫∫ k_ν(x, x') p(x) p(x') dx dx' → (...): x − x' ~ N(0, 2Σ) under p × p,
    so this is I2(0; 2Σ)."""
    _check_w(Sigma, w)
    zero = torch.zeros((1, w.shape[-1]), dtype=Sigma.dtype, device=Sigma.device)
    return _matern_int_K0(zero, _like(h, Sigma), w, 2.0 * Sigma, nu)[..., 0]


def _cross_rows(x1, x2, h1, w1, h2, w2, mu, Sigma):
    """The cross family's arguments on one flattened row axis (``x2`` last,
    where there is one)."""
    h1, h2 = _like(h1, x1), _like(h2, x1)
    args = [(x1, 2), (h1, 0), (w1, 1), (h2, 0), (w2, 1), (mu, 1), (Sigma, 2)]
    if x2 is not None:
        args.append((x2, 2))
    return _flat_rows(*args)


def int_K1_K2_matern(x1, x2, h1, w1, h2, w2, mu, Sigma, nu):
    """∫ k1(x1_i, x) k2(x, x2_j) p(x) dx → (..., n1, n2), both kernels Matérn-ν.

    Per outer node q the x-integral collapses to the exact smoothed form:
        P_ij = Σ_q ω_q c_1q N(x1_i | μ, A_q) · I2(x2_j − m_iq; S_q).
    """
    _check_w(Sigma, w1, w2)
    batch, (x1, h1, w1, h2, w2, mu, Sigma, x2) = _cross_rows(x1, x2, h1, w1, h2, w2, mu, Sigma)
    wq, s2s = _outer_mix_nodes(nu, x1)
    N, n1, d = x1.shape
    n2 = x2.shape[1]
    out = x1.new_zeros((N, n1, n2))
    for rows, nodes in _chunks(N, len(wq), n1 * n2 * _i2_elems(d, nu)):
        c1, la, proj, S = _node_geometry(s2s[nodes], w1[rows], Sigma[rows], x1[rows], mu[rows])
        r, q = c1.shape
        mi = mu[rows][:, None, None, :] + proj
        diffs = (x2[rows][:, None, None, :, :] - mi[:, :, :, None, :]).reshape(r, q, n1 * n2, d)
        I2 = _matern_int_K0(diffs, h2[rows][:, None], w2[rows][:, None], S, nu).reshape(r, q, n1, n2)
        vals = ((h1[rows] * h1[rows])[:, None] * c1)[..., None, None] * torch.exp(la)[..., None] * I2
        out[rows] += torch.einsum("q,rqij->rij", wq[nodes], vals)
    return out.reshape(*batch, n1, n2)


def int_K1_int_K2_matern(x1, h1, w1, h2, w2, mu, Sigma, nu):
    """∫∫ k1(x1_a, x) k2(x, x') p(x) p(x') dx dx' → (..., n1), both Matérn-ν.

    Per outer node q, integrating x' first leaves the exact smoothed form in
    the x-conditional mean:
        U_a = Σ_q ω_q c_1q N(x1_a | μ, A_q) · I2(M_q(x1_a − μ); S_q + Σ).
    """
    _check_w(Sigma, w1, w2)
    batch, (x1, h1, w1, h2, w2, mu, Sigma) = _cross_rows(x1, None, h1, w1, h2, w2, mu, Sigma)
    wq, s2s = _outer_mix_nodes(nu, x1)
    N, n1, d = x1.shape
    out = x1.new_zeros((N, n1))
    for rows, nodes in _chunks(N, len(wq), n1 * _i2_elems(d, nu)):
        c1, la, proj, S = _node_geometry(s2s[nodes], w1[rows], Sigma[rows], x1[rows], mu[rows])
        I2 = _matern_int_K0(proj, h2[rows][:, None], w2[rows][:, None], S + Sigma[rows][:, None], nu)
        vals = ((h1[rows] * h1[rows])[:, None] * c1)[..., None] * torch.exp(la) * I2
        out[rows] += torch.einsum("q,rqa->ra", wq[nodes], vals)
    return out.reshape(*batch, n1)


def int_int_K1_K2_matern(x1, x2, h1, w1, h2, w2, mu, Sigma, nu):
    """∫∫ k1(x1_a, x) k2(x, x') k1(x', x2_b) p(x) p(x') dx dx' → (..., n1, n2).

    The V[Z] workhorse with both kernels Matérn-ν. The two k1 factors get
    independent mixture indices (q, s); the inner k2 double integral then
    collapses exactly:
        T_ab = Σ_{q,s} ω_q ω_s c_1q c_1s N(x1_a|μ,A_q) N(x2_b|μ,A_s)
               · I2(M_q(x1_a−μ) − M_s(x2_b−μ); S_q + S_s).

    The (q, s) node-pair sweep is the costly member of the family. It runs in
    chunks of node pairs (a multiple of 8) and rows, so that no chunk forms
    more than SWEEP_ELEMS values and n_mix² × n1 × n2 values never exist at
    once; when ``x1 is x2`` (the V[Z] call: both sides are x_sc) the
    (q,s)↔(s,q) transpose symmetry halves the sweep to the upper triangle. In
    d = 1 the inner I2 is the exact erfcx form; for d ≥ 2 the inner mixture
    is fused into the sweep: the (pair, r) node covariances
    C = S_q + S_s + W_r are inverted as a batch and the point sweep is a
    quadratic form and an exp.
    """
    _check_w(Sigma, w1, w2)
    symmetric = x1 is x2
    batch, (x1, h1, w1, h2, w2, mu, Sigma, x2) = _cross_rows(x1, x2, h1, w1, h2, w2, mu, Sigma)
    wq, s2s = _outer_mix_nodes(nu, x1)
    m = len(wq)
    N, n1, d = x1.shape
    n2 = x2.shape[1]

    c_a, la_a, proj_a, S_a = _node_geometry(s2s, w1, Sigma, x1, mu)
    if symmetric:
        c_b, la_b, proj_b, S_b = c_a, la_a, proj_a, S_a
    else:
        c_b, la_b, proj_b, S_b = _node_geometry(s2s, w1, Sigma, x2, mu)
    ea = (wq * c_a)[..., None] * torch.exp(la_a)  # (N, m, n1) weighted outer factors
    eb = (wq * c_b)[..., None] * torch.exp(la_b)  # (N, m, n2)

    # pair list: the upper triangle when symmetric (each off-diagonal pair
    # contributes its transpose too), else the full product
    if symmetric:
        iu, ju = np.triu_indices(m)
    else:
        iu, ju = (ix.ravel() for ix in np.mgrid[0:m, 0:m])
    dev = x1.device
    iq = torch.as_tensor(iu, device=dev)
    js = torch.as_tensor(ju, device=dev)
    mirror = _like((iu != ju).astype(np.float64), x1)

    if d >= 2:
        # inner mixture of k2, fused: ω_r c_2r = ω_r h2² (2π)^{d/2} ∏w_r, and the
        # node's N(δ|0,C) divides by (2π)^{d/2}|C|^{1/2}, so what remains per
        # point is ω_r h2² ∏w_r · exp(−½ quad − ½ logdet C)
        wq2, s2s2 = _outer_mix_nodes(nu, x1)
        w2r = torch.sqrt(s2s2)[None, :, None] * w2[:, None, :]  # (N, mr, d)
        Wr = _W(w2r)
        cr = wq2 * (h2 * h2)[:, None] * torch.prod(w2r, dim=-1)  # (N, mr)

    def chunk_I2(rows, qi, si):
        pa, pb = proj_a[rows][:, qi], proj_b[rows][:, si]  # (r, p, n, d)
        delta = pa[:, :, :, None, :] - pb[:, :, None, :, :]  # (r, p, n1, n2, d)
        r, p = delta.shape[:2]
        if d == 1:
            V = S_a[rows][:, qi] + S_b[rows][:, si]
            I2 = _matern_int_K0(delta.reshape(r, p, n1 * n2, 1), h2[rows][:, None],
                                w2[rows][:, None], V, nu)
            return I2.reshape(r, p, n1, n2)
        C = S_a[rows][:, qi, None] + S_b[rows][:, si, None] + Wr[rows][:, None]  # (r, p, mr, d, d)
        iC = torch.linalg.inv(C)
        lognorm = -0.5 * torch.linalg.slogdet(C)[1]  # (r, p, mr)
        quad = 0.0
        for i in range(d):
            for j in range(d):
                quad = quad + (iC[..., i, j][..., None, None]
                               * (delta[..., i] * delta[..., j])[:, :, None])
        return torch.einsum("rm,rpmab->rpab", cr[rows],
                            torch.exp(-0.5 * quad + lognorm[..., None, None]))

    unit = n1 * n2 * _i2_elems(d, nu)
    n_pairs = len(iu)
    pc = 8 * max(1, min(-(-n_pairs // 8), SWEEP_ELEMS // (8 * unit * N)))
    rc = max(1, min(N, SWEEP_ELEMS // (pc * unit)))
    A = x1.new_zeros((N, n1, n2))
    B = x1.new_zeros((N, n1, n2)) if symmetric else None
    for r0 in range(0, N, rc):
        rows = slice(r0, r0 + rc)
        for p0 in range(0, n_pairs, pc):
            qi, si = iq[p0:p0 + pc], js[p0:p0 + pc]
            contrib = ea[rows][:, qi, :, None] * eb[rows][:, si, None, :] * chunk_I2(rows, qi, si)
            A[rows] += contrib.sum(1)
            if symmetric:
                B[rows] += torch.einsum("p,rpab->rab", mirror[p0:p0 + pc], contrib)
    h4 = (h1 ** 4)[:, None, None]
    T = h4 * (A + B.transpose(-1, -2)) if symmetric else h4 * A
    return T.reshape(*batch, n1, n2)


# ---------------------------------------------------------------------------
# Periodic-kernel measure integrals by the Jacobi–Anger expansion (1-D).
#
#     k(δ) = h² exp(−2 sin²(δ/(2p))/w²) = h² e^{−z} e^{z cos(ωδ)},
#     z = 1/w²,  ω = 1/p,
#     e^{z cos t} = I₀(z) + 2 Σ_{n≥1} I_n(z) cos(nt),
#
# so with a_n = e^{−z} I_n(z) (a₀ + 2Σa_n = 1), k(δ) = h² Σ_{|n|≤N} a_{|n|}
# e^{inωδ}, and every gaussian-measure integral reduces to characteristic
# functions φ(t) = E[e^{itx}] = e^{itμ − t²σ²/2}. The only approximation is the
# Bessel tail beyond N, at machine precision for N ≳ 8.5/w + 8
# (models/bq.py::periodic_series_floor).
# ---------------------------------------------------------------------------


def ive_series(z, n: int) -> torch.Tensor:
    """Scaled modified Bessel a_k = e^{−z} I_k(z) for k = 0..n → (..., n + 1).

    Miller's backward recurrence I_{k−1} = I_{k+1} + (2k/z) I_k from
    M = n + n//2 + 16 with seed (0, 1), self-normalized by
    a₀ + 2 Σ_{k≥1} a_k = 1; ``z`` (...) is a tensor of any shape and the
    recurrence is a loop of M tensor steps over all of it. Overflow control
    is data-flow: an element's carry rescales by ``factor`` whenever it
    exceeds ``thresh``, each emission records the element's rescale
    generation, and the last pass brings every term to its element's final
    generation (high orders underflow to exact zeros there). float32 clamps
    z ≥ 1e-6 so that 2M/z cannot jump the carry past the dtype's maximum
    between checks (the kernel is constant to 2e-6 there).
    """
    z = torch.as_tensor(z)
    dtype = z.dtype
    f64 = dtype == torch.float64
    thresh = 1e250 if f64 else 1e30
    factor = 1e-250 if f64 else 1e-30
    zc = torch.clamp(z, min=1e-10 if f64 else 1e-6)
    m = n + n // 2 + 16
    fac, one = _like(factor, zc), _like(1.0, zc)
    p_next, p_cur = torch.zeros_like(zc), torch.ones_like(zc)
    c = torch.zeros(zc.shape, dtype=torch.int32, device=zc.device)
    ps, cs = [], []
    for k in range(m, 0, -1):
        p_prev = p_next + (2.0 * k / zc) * p_cur
        resc = p_prev > thresh
        f = torch.where(resc, fac, one)
        c = c + resc.to(torch.int32)
        p_next, p_cur = p_cur * f, p_prev * f
        ps.append(p_cur)
        cs.append(c)
    # emissions are p_{m−1}..p_0, each in its own frame: reverse, bring every
    # term to the final frame, normalize
    ps = torch.stack(ps[::-1], dim=-1)
    cs = torch.stack(cs[::-1], dim=-1)
    vals = ps * torch.pow(fac, (c[..., None] - cs).to(dtype))
    total = vals[..., 0] + 2.0 * vals[..., 1:].sum(-1)
    return vals[..., : n + 1] / total[..., None]


def _per_coeffs(h, w, p, n_series: int, ref: torch.Tensor):
    """(h², ω, harmonics 1..N, a_0..a_N (..., N + 1)) of one periodic kernel."""
    h, w, p = _like(h, ref), _like(w, ref), _like(p, ref)
    a = ive_series(1.0 / (w * w), n_series)
    n = torch.arange(1, n_series + 1, dtype=ref.dtype, device=ref.device)
    return h * h, 1.0 / p, n, a


def int_K_periodic(x, h, w, p, mu, Sigma, n_series: int) -> torch.Tensor:
    """∫ k_per(x', x_i) N(x' | μ, σ²) dx' → (..., n):
    h² [a₀ + 2 Σ_n a_n e^{−n²ω²σ²/2} cos(nω(x_i − μ))]."""
    h2, om, n, a = _per_coeffs(h, w, p, n_series, x)
    mu0, s2 = mu[..., 0], Sigma[..., 0, 0]
    nom = n * om[..., None]
    damp = torch.exp(-0.5 * nom ** 2 * s2[..., None])
    ang = (x[..., 0] - mu0[..., None])[..., :, None] * nom[..., None, :]
    return h2[..., None] * (a[..., :1] + 2.0 * (torch.cos(ang) @ (a[..., 1:] * damp)[..., None])[..., 0])


def int_int_K_periodic(h, w, p, mu, Sigma, n_series: int) -> torch.Tensor:
    """∫∫ k_per(x, x') p(x) p(x') dx dx' → (...): x − x' ~ N(0, 2σ²),
    h² [a₀ + 2 Σ a_n e^{−n²ω²σ²}]."""
    del mu
    h2, om, n, a = _per_coeffs(h, w, p, n_series, Sigma)
    s2 = Sigma[..., 0, 0]
    return h2 * (a[..., 0] + 2.0 * (a[..., 1:] * torch.exp(-((n * om[..., None]) ** 2) * s2[..., None])).sum(-1))


def _per_full_range(theta, n_series: int, ref: torch.Tensor):
    """Full-range harmonic table of θ = (h, w, p): (nω (..., 2N+1),
    A_n = h² a_{|n|} (..., 2N+1)), n = −N..N."""
    h2, om, _, a = _per_coeffs(*theta, n_series, ref)
    nn = torch.arange(-n_series, n_series + 1, device=ref.device)
    return nn.to(ref.dtype) * om[..., None], h2[..., None] * a[..., nn.abs()]


def _phi(t, mu0, s2):
    """Gaussian characteristic function E[e^{itx}] = e^{itμ − t²σ²/2} (complex)."""
    return torch.exp(torch.complex(-0.5 * t * t * s2, t * mu0))


def _cis(t, x, sign: float):
    """e^{± i t_n x_a} → (..., K, n): harmonics ``t`` (..., K), points ``x`` (..., n, 1)."""
    ang = sign * t[..., :, None] * x[..., None, :, 0]
    return torch.exp(torch.complex(torch.zeros_like(ang), ang))


def int_K1_K2_periodic(x1, x2, t1, t2, mu, Sigma, n_series: int):
    """∫ k1(x1_i, x) k2(x, x2_j) N(x | μ, σ²) dx → (..., n1, n2), both periodic
    with their own (h, w, p) ``t1`` / ``t2``:
    Σ_{n,m} A_n B_m e^{i n ω₁ x1_i} φ(mω₂ − nω₁) e^{−i m ω₂ x2_j}, real part."""
    t1f, A = _per_full_range(t1, n_series, x1)
    t2f, B = _per_full_range(t2, n_series, x1)
    mu0, s2 = mu[..., 0, None, None], Sigma[..., 0, 0, None, None]
    Phi = _phi(t2f[..., None, :] - t1f[..., :, None], mu0, s2)
    E1 = A[..., None] * _cis(t1f, x1, 1.0)
    E2c = B[..., None] * _cis(t2f, x2, -1.0)
    return torch.real(E1.transpose(-1, -2) @ Phi @ E2c)


def int_int_K1_K2_periodic(x1, x2, t1, t2, mu, Sigma, n_series: int):
    """∫∫ k1(x1_a, x) k2(x, x') k1(x', x2_b) p(x) p(x') dx dx' → (..., n1, n2),
    both periodic. For a fixed inner harmonic m the two integrals factorize:

        T_ab = Σ_m B_m F_{m,a} G_{m,b}
        F_{m,a} = Σ_n A_n φ(mω₂ − nω₁) e^{inω₁ x1_a}
        G_{m,b} = Σ_n A_n φ(nω₁ − mω₂) e^{−inω₁ x2_b}
    """
    t1f, A = _per_full_range(t1, n_series, x1)
    t2f, B = _per_full_range(t2, n_series, x1)
    mu0, s2 = mu[..., 0, None, None], Sigma[..., 0, 0, None, None]
    dgrid = t2f[..., None, :] - t1f[..., :, None]  # (..., 2N+1, 2M+1) = mω₂ − nω₁
    F = _phi(dgrid, mu0, s2).transpose(-1, -2) @ (A[..., None] * _cis(t1f, x1, 1.0))
    G = _phi(-dgrid, mu0, s2).transpose(-1, -2) @ (A[..., None] * _cis(t1f, x2, -1.0))
    return torch.real((B[..., None] * F).transpose(-1, -2) @ G)


def int_K1_int_K2_periodic(x1, t1, t2, mu, Sigma, n_series: int):
    """∫∫ k1(x1_a, x) k2(x, x') p(x) p(x') dx dx' → (..., n1), both periodic:
    Σ_{n,m} A_n B_m φ(mω₂ − nω₁) φ(−mω₂) e^{inω₁ x1_a}."""
    t1f, A = _per_full_range(t1, n_series, x1)
    t2f, B = _per_full_range(t2, n_series, x1)
    mu0, s2 = mu[..., 0, None], Sigma[..., 0, 0, None]
    Phi = _phi(t2f[..., None, :] - t1f[..., :, None], mu0[..., None], s2[..., None])
    inner = (Phi @ (B * _phi(-t2f, mu0, s2))[..., None])[..., 0]  # (..., 2N+1)
    return torch.real(((A * inner)[..., None] * _cis(t1f, x1, 1.0)).sum(-2))


# ---------------------------------------------------------------------------
# Quadrature twins: the trapezoid rule over a dense 1-D grid xo (m,), the
# reference's approx_* checks of the closed forms. They take any kernel
# function ``kfn(theta, x1, x2)`` of ``kernels.get_kernel``. A product larger
# than SWEEP_ELEMS is formed in chunks of an axis that the chunk's trapezoid
# does not sum over (the output's rows x1 or columns x2, the outer grid
# variable of a double integral), at least one row at a time: every value
# keeps the summation it has unchunked.
# ---------------------------------------------------------------------------


def _pdf_1d(xo, mu, Sigma):
    """N(xo | mu, Sigma) of a 1-D measure on the grid → (m,)."""
    s2 = Sigma.reshape(())
    m = mu.reshape(())
    return torch.exp(-0.5 * (xo - m) ** 2 / s2) / torch.sqrt(2.0 * math.pi * s2)


def _in_row_chunks(f, n_rows: int, per_row: int, dim: int):
    """``f(rows)`` over slices of at least one row covering n_rows (``per_row``
    elements each, no chunk above SWEEP_ELEMS unless one row is), joined
    along ``dim``."""
    rows = max(1, min(n_rows, SWEEP_ELEMS // max(1, per_row)))
    return torch.cat([f(slice(r0, r0 + rows)) for r0 in range(0, n_rows, rows)], dim=dim)


def approx_int_K(kfn, theta, x, xo, mu, Sigma):
    """(n,) trapezoid approximation of int_K on the 1-D grid xo (m,)."""
    p = _pdf_1d(xo, mu, Sigma)
    m = xo.shape[0]
    return _in_row_chunks(lambda r: torch.trapezoid(kfn(theta, xo[:, None], x[r]) * p[:, None], xo, dim=0),
                          x.shape[0], m, 0)


def approx_int_int_K(kfn, theta, xo, mu, Sigma):
    """Trapezoid approximation of int_int_K → (): the inner integral over x'
    for each grid row x, then the outer over x."""
    p = _pdf_1d(xo, mu, Sigma)
    m = xo.shape[0]
    inner = _in_row_chunks(
        lambda r: torch.trapezoid(kfn(theta, xo[r, None], xo[:, None]) * p[None, :], xo, dim=1), m, m, 0)
    return torch.trapezoid(inner * p, xo)


def approx_int_K1_K2(k1fn, k2fn, t1, t2, x1, x2, xo, mu, Sigma):
    """Trapezoid approximation of int_K1_K2 → (n1, n2)."""
    p = _pdf_1d(xo, mu, Sigma)
    K2p = k2fn(t2, xo[:, None], x2) * p[:, None]  # (m, n2)
    m, n2 = K2p.shape

    def rows(r):
        K1 = k1fn(t1, x1[r], xo[:, None])  # (r, m)
        return torch.trapezoid(K1[:, :, None] * K2p[None, :, :], xo, dim=1)

    return _in_row_chunks(rows, x1.shape[0], m * n2, 0)


def approx_int_int_K1_K2(k1fn, k2fn, t1, t2, x1, x2, xo, mu, Sigma):
    """Trapezoid approximation of int_int_K1_K2 → (n1, n2): the inner
    integral over x' as an (m, n2) table, then the outer over x."""
    p = _pdf_1d(xo, mu, Sigma)
    m = xo.shape[0]
    K2 = k2fn(t2, xo[:, None], xo[:, None])  # (m, m): k2(x, x')
    K1bp = k1fn(t1, xo[:, None], x2) * p[:, None]  # (m, n2): k1(x', x2_b) p(x')
    inner = _in_row_chunks(
        lambda c: torch.trapezoid(K2[:, :, None] * K1bp[None, :, c], xo, dim=1), x2.shape[0], m * m, 1)

    def rows(r):
        K1ap = k1fn(t1, x1[r], xo[:, None]) * p[None, :]  # (r, m): k1(x1_a, x) p(x)
        return torch.trapezoid(K1ap[:, :, None] * inner[None, :, :], xo, dim=1)

    return _in_row_chunks(rows, x1.shape[0], m * x2.shape[0], 0)


def approx_int_K1_int_K2(k1fn, k2fn, t1, t2, x1, xo, mu, Sigma):
    """Trapezoid approximation of int_K1_int_K2 → (n1,)."""
    p = _pdf_1d(xo, mu, Sigma)
    m = xo.shape[0]
    ik2 = _in_row_chunks(  # (m,) = ∫ k2(x, x') p(x') dx'
        lambda r: torch.trapezoid(k2fn(t2, xo[r, None], xo[:, None]) * p[None, :], xo, dim=1), m, m, 0)
    w = ik2 * p
    return _in_row_chunks(lambda r: torch.trapezoid(k1fn(t1, x1[r], xo[:, None]) * w[None, :], xo, dim=1),
                          x1.shape[0], m, 0)
