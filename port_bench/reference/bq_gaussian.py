"""Plain reference of the Osborne-style BQ estimator, gaussian kernels, d = 1.

Written from the estimator's equations, in plain torch, with nothing of the
program under test: given observations (x, ℓ), the hypers, the noise, the
measure N(μ, σ²) and the candidate rule of a configuration, it forms

  1. the log-GP on tl = log(ℓ/γ + 1): Gram, Cholesky, α_tl;
  2. ``n_candidate`` candidates spread evenly over the observed range (those
     nearer than ``candidate_thresh`` to an observation dropped), anchored at
     γ(exp(m_tl) − 1), and the linear GP on observations ∪ candidates;
  3. E[Z] = zᵀα_l and V[Z] by the closed-form gaussian integrals;
  4. the expected squared mean (ESM) of a grid point and the pick;
  5. the log marginal likelihood and its gradient in log θ; the multi-restart
     Adam fit that the configuration states.

Problems stack on a leading axis (a fleet, or one problem as a stack of one);
sets of unequal size are padded with masked rows, whose Gram rows are the
identity. ``Arith`` says what the arithmetic is: float64 (the reference), or
float32 with every matrix product's operands rounded to TF32 (the control:
the same computation one precision step below the configuration's float32).
"""

from __future__ import annotations

import math

import torch

#: float32's unit roundoff and the guard's safety factor: the float32 scorer
#: counts a grid point as resolved only where its Schur complement clears
#: max(ε·κ, λ·ρ·κ·Σk), ρ the largest absolute row sum of K_l⁻¹, λ = 32ε.
EPS32 = 2.0 ** -23
LAM32 = 32.0 * EPS32
_LOG2PI = math.log(2.0 * math.pi)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 stored mantissa bits, nearest-even)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return r.view(torch.float32)


class Arith:
    """The arithmetic of one reference computation: ``"f64"`` (float64) or
    ``"tf32"`` (float32, matrix products on TF32-rounded operands with float32
    accumulation, as a TF32 tensor core computes them)."""

    def __init__(self, mode: str, device):
        if mode not in ("f64", "tf32"):
            raise ValueError(f"unknown arithmetic {mode!r}")
        self.mode = mode
        self.dtype = torch.float64 if mode == "f64" else torch.float32
        self.device = torch.device(device)
        # relative jitter ladders: float64 escalates as far as it must, float32 has one rescue rung
        self.ladder = (0.0, 1e-12, 1e-10, 1e-8, 1e-6, 1e-4, 1e-2) if mode == "f64" else (0.0, 1e-4)

    def t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.mode == "tf32":
            return tf32_round(a) @ tf32_round(b)
        return a @ b

    def mv(self, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.mm(a, v[..., None])[..., 0]

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.mm(a[..., None, :], b[..., :, None])[..., 0, 0]

    def cholesky(self, K: torch.Tensor) -> torch.Tensor:
        """Lower factor of each matrix of the stack (NaN where it fails)."""
        if self.mode == "f64":
            L, info = torch.linalg.cholesky_ex(K)
            return torch.where((info == 0)[..., None, None], L, torch.full_like(L, math.nan))
        # left-looking, 8 columns a block: the updates are TF32 products
        n, nb = K.shape[-1], 8
        L = torch.zeros_like(K)
        for j0 in range(0, n, nb):
            j1 = min(n, j0 + nb)
            A = K[..., j0:, j0:j1]
            if j0:
                A = A - self.mm(L[..., j0:, :j0], L[..., j0:j1, :j0].transpose(-1, -2))
            Ljj, info = torch.linalg.cholesky_ex(A[..., : j1 - j0, :])
            Ljj = torch.where((info == 0)[..., None, None], Ljj, torch.full_like(Ljj, math.nan))
            L[..., j0:j1, j0:j1] = Ljj
            if j1 < n:
                L[..., j1:, j0:j1] = torch.linalg.solve_triangular(
                    Ljj, A[..., j1 - j0:, :].transpose(-1, -2), upper=False).transpose(-1, -2)
        return L

    def inverse_factor(self, L: torch.Tensor) -> torch.Tensor:
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
        return torch.linalg.solve_triangular(L, eye, upper=False)


def gram(ar: Arith, xa, xb, h, w):
    """h² exp(−(a − b)²/(2w²)) → (..., na, nb); h and w (...,)."""
    d = (xa[..., :, None] - xb[..., None, :]) / w[..., None, None]
    return (h * h)[..., None, None] * torch.exp(-0.5 * d * d)


def int_k(xa, h, w, mu, var):
    """∫ k(x, a) N(x; μ, σ²) dx = h² w / √(w² + σ²) · exp(−(a − μ)²/(2(w² + σ²)))."""
    v = (w * w + var)[..., None]
    return (h * h * w)[..., None] / torch.sqrt(v) * torch.exp(-0.5 * (xa - mu[..., None]) ** 2 / v)


def _npdf(x, var):
    return torch.exp(-0.5 * x * x / var) / torch.sqrt(2.0 * math.pi * var)


class GP:
    """A factored GP: masked rows are identity rows of the Gram."""

    def __init__(self, ar: Arith, x, y, mask, h, w, s, base_jitter: float):
        m = mask.to(ar.dtype)
        K = gram(ar, x, x, h, w) * (m[..., :, None] * m[..., None, :])
        eye = torch.eye(x.shape[-1], dtype=ar.dtype, device=ar.device)
        K = K + eye * ((s * s)[..., None, None] * m[..., None, :] + (1.0 - m)[..., None, :])
        scale = (torch.diagonal(K, dim1=-2, dim2=-1) * m).sum(-1) / m.sum(-1).clamp(min=1.0)
        L = jit = None
        for rung in ar.ladder:  # each matrix keeps its first finite rung
            j = (rung + base_jitter) * scale
            Li = ar.cholesky(K + eye * (j[..., None, None] * m[..., None, :]))
            if L is None:
                L, jit = Li, j
            else:
                bad = ~torch.isfinite(L).all(-1).all(-1)
                L = torch.where(bad[..., None, None], Li, L)
                jit = torch.where(bad, j, jit)
            if bool(torch.isfinite(L).all()):
                break
        self.ar, self.x, self.mask, self.m = ar, x, mask, m
        self.h, self.w, self.s, self.jitter = h, w, s, jit
        self.L = L
        self.Linv = ar.inverse_factor(L)
        self.y = y * m
        self.alpha = ar.mv(self.Linv.transpose(-1, -2), ar.mv(self.Linv, self.y))
        self.Kinv = ar.mm(self.Linv.transpose(-1, -2), self.Linv)
        self.kappa = h * h + s * s + jit

    def cross(self, xo):
        """k(x_i, xo) with masked rows zeroed → (..., n, no)."""
        return gram(self.ar, self.x, xo, self.h, self.w) * self.m[..., :, None]

    def mean(self, xo):
        return self.ar.mm(self.alpha[..., None, :], self.cross(xo))[..., 0, :]

    def solve(self, b):
        """K⁻¹ b for b (..., n) or (..., n, k)."""
        vec = b.ndim == self.alpha.ndim
        B = b[..., None] if vec else b
        out = self.ar.mm(self.Linv.transpose(-1, -2), self.ar.mm(self.Linv, B))
        return out[..., 0] if vec else out


class Model:
    """The estimator of one configuration (its ``model`` block), for P
    problems at once.

    ``model``: ``theta_tl`` / ``theta_l`` (h, w), ``s`` (or ``s_tl`` / ``s_l``),
    ``gamma``, ``x_mean``, ``x_var``, ``n_candidate``, ``candidate_thresh``,
    ``base_jitter``."""

    def __init__(self, model: dict, ar: Arith):
        self.ar = ar
        self.cfg = model
        self.gamma = float(model.get("gamma", 1.0))
        self.s_tl = float(model.get("s_tl", model.get("s", 0.0)))
        self.s_l = float(model.get("s_l", self.s_tl))
        self.mu = float(model.get("x_mean", 0.0))
        self.var = float(model.get("x_var", 1.0))
        self.nc = int(model["n_candidate"])
        self.thresh = float(model["candidate_thresh"])
        self.base_jitter = float(model.get("base_jitter", 1e-12))

    # ---------------------------------------------------------------- states
    def _theta(self, th, P):
        th = self.ar.t(th)
        return th.expand(P, 2) if th.ndim == 1 else th

    def candidates(self, x):
        """(x_c (P, nc), live mask (P, nc)) over each problem's observed range."""
        lo, hi = x.amin(-1), x.amax(-1)
        t = torch.arange(self.nc, dtype=x.dtype, device=x.device) * (1.0 / max(self.nc - 1, 1))
        if self.nc > 1:
            t[-1] = 1.0
        xc = lo[:, None] + t[None, :] * (hi - lo)[:, None]
        near = ((xc[:, :, None] - x[:, None, :]).abs() < self.thresh).any(-1)
        return xc, ~near

    def state(self, x, l, theta_tl=None, theta_l=None) -> dict:
        """Both GPs fitted to observations x, ℓ (P, n) under the hypers
        (config's where None; (2,) shared or (P, 2) per problem)."""
        ar = self.ar
        x, l = ar.t(x), ar.t(l)
        P, n = x.shape
        th_tl = self._theta(self.cfg["theta_tl"] if theta_tl is None else theta_tl, P)
        th_l = self._theta(self.cfg["theta_l"] if theta_l is None else theta_l, P)
        ones = torch.ones((P, n), dtype=torch.bool, device=ar.device)
        tl = torch.log1p(l / self.gamma)
        s_tl, s_l = ar.t(self.s_tl).expand(P), ar.t(self.s_l).expand(P)
        gp_tl = GP(ar, x, tl, ones, th_tl[:, 0], th_tl[:, 1], s_tl, self.base_jitter)
        xc, cm = self.candidates(x)
        cap = 700.0 if ar.dtype == torch.float64 else 80.0
        lc = self.gamma * torch.expm1(torch.clamp(gp_tl.mean(xc), max=cap))
        xsc = torch.cat([x, xc], -1)
        msc = torch.cat([ones, cm], -1)
        ysc = torch.cat([l, torch.where(cm, lc, torch.zeros_like(lc))], -1)
        gp_l = GP(ar, xsc, ysc, msc, th_l[:, 0], th_l[:, 1], s_l, self.base_jitter)
        return dict(x=x, l=l, tl=tl, xc=xc, cmask=cm, xsc=xsc, msc=msc, gp_tl=gp_tl, gp_l=gp_l)

    # -------------------------------------------------------------- moments
    def _measure(self, like):
        return self.ar.t(self.mu).expand(like.shape[0]), self.ar.t(self.var)

    def z_vector(self, st):
        gp = st["gp_l"]
        mu, var = self._measure(st["x"])
        return int_k(gp.x, gp.h, gp.w, mu, var) * gp.m

    def z_mean(self, st) -> torch.Tensor:
        return self.ar.dot(self.z_vector(st), st["gp_l"].alpha)

    def z_var(self, st) -> torch.Tensor:
        """Closed form of ∫∫ (m_l(x)+γ) C_tl(x, x') (m_l(x')+γ) p(x) p(x'):
        term_mm + 2γ term_m + γ² term_0 (clamped at 0)."""
        ar = self.ar
        gl, gt = st["gp_l"], st["gp_tl"]
        mu, var = self._measure(st["x"])
        hl, wl, ht, wt = gl.h[:, None], gl.w[:, None], gt.h[:, None], gt.w[:, None]
        a = gl.x  # (P, nsc)
        b = gt.x  # (P, ns)
        m0 = mu[:, None]
        A, Bv = wl * wl, wt * wt
        cl = hl * hl * math.sqrt(2.0 * math.pi) * wl
        ct = ht * ht * math.sqrt(2.0 * math.pi) * wt
        # q_j = ∫ k_tl(x, b_j) p(x);  Q = ∫∫ k_tl p p
        q = ct * _npdf(b - m0, Bv + var) * gt.m
        Q = (gt.h * gt.h * gt.w) / torch.sqrt(gt.w * gt.w + 2.0 * var)
        # P_ij = ∫ k_l(x, a_i) k_tl(x, b_j) p(x): N(a; b, A+B) · N(c; μ, C+σ²)
        ai, bj = a[:, :, None], b[:, None, :]
        AB = (A + Bv)[:, :, None]
        c = (ai * Bv[:, :, None] + bj * A[:, :, None]) / AB
        C = (A * Bv)[:, :, None] / AB
        Pm = (cl * ct)[:, :, None] * _npdf(ai - bj, AB) * _npdf(c - m0[:, :, None], C + var)
        Pm = Pm * gl.m[:, :, None] * gt.m[:, None, :]
        # U_i = ∫ k_l(x, a_i) p(x) ∫ k_tl(x, x') p(x') dx' dx
        S1 = Bv + var  # the inner integral is ct·N(x; μ, S1)
        cu = (a * S1 + m0 * A) / (A + S1)
        Cu = A * S1 / (A + S1)
        U = cl * ct * _npdf(a - m0, A + S1) * _npdf(cu - m0, Cu + var) * gl.m
        # T_ij = ∫∫ k_l(x, a_i) p(x) k_tl(x, x') k_l(x', a_j) p(x'):
        # k_l(x, a_i) p(x) = cl N(a_i; μ, A+σ²) N(x; m_i, v), v = Aσ²/(A+σ²)
        v = A * var / (A + var)
        mi = (a * var + m0 * A) / (A + var)
        f = cl * _npdf(a - m0, A + var) * gl.m
        T = f[:, :, None] * f[:, None, :] * ct[:, :, None] * _npdf(
            mi[:, :, None] - mi[:, None, :], (2.0 * v + Bv)[:, :, None])
        alpha = gl.alpha
        beta = gt.solve(q)
        term0 = Q - ar.dot(q, beta)
        term_m = ar.dot(alpha, U - ar.mv(Pm, beta))
        g = ar.mv(Pm.transpose(-1, -2), alpha)
        term_mm = ar.dot(alpha, ar.mv(T, alpha)) - ar.dot(g, gt.solve(g))
        gam = self.gamma
        return torch.clamp(term_mm + 2.0 * gam * term_m + gam * gam * term0, min=0.0)

    # ------------------------------------------------------------------ ESM
    def esm(self, st, grid, guard: float = 1.0, slack: float = 0.0, chunk: int = 2048) -> dict:
        """The ESM on a shared grid (G,) → dict of ``scores`` (P, G), ``raw``
        (P, G), ``resolved`` (P, G) and ``zTa`` (P,).

        ``resolved``: not within ``candidate_thresh`` + ``slack`` of a live
        point of the linear GP, and a Schur complement above ``guard`` times
        the float32 guard max(ε₃₂κ, λ·ρ·κ·Σk); ``scores`` is ``raw`` where
        resolved and zTα² elsewhere, as the configured float32 scorer scores.
        ``raw`` is the closed form wherever the Schur complement is positive."""
        ar = self.ar
        gl, gt = st["gp_l"], st["gp_tl"]
        mu, var = self._measure(st["x"])
        z = self.z_vector(st)
        zTa = ar.dot(z, gl.alpha)
        uz = gl.solve(z)
        rho = gl.Kinv.abs().sum(-1).amax(-1)
        grid = ar.t(grid)
        scores, raw, resolved = [], [], []
        for g0 in range(0, grid.shape[0], chunk):
            g = grid[g0:g0 + chunk]
            k = gl.cross(g)  # (P, nsc, Gc)
            v = gl.solve(k)
            gam = gl.kappa[:, None] - (k * v).sum(-2)
            zeta = int_k(g[None, :], gl.h, gl.w, mu, var)
            B = (zeta - ar.mm(uz[:, None, :], k)[:, 0, :]) / gam
            A = zTa[:, None] - B * ar.mm(gl.alpha[:, None, :], k)[:, 0, :]
            kt = gt.cross(g)
            m_a = ar.mm(gt.alpha[:, None, :], kt)[:, 0, :]
            c_a = torch.clamp((gt.h * gt.h)[:, None] - (kt * gt.solve(kt)).sum(-2), min=0.0)
            cap = 0.5 * math.log(torch.finfo(ar.dtype).max)
            e1 = torch.exp(torch.clamp(m_a + 0.5 * c_a, max=cap))
            e2 = torch.exp(torch.clamp(2.0 * m_a + 2.0 * c_a, max=cap))
            E1 = self.gamma * (e1 - 1.0)
            E2 = self.gamma ** 2 * (e2 - 2.0 * e1 + 1.0)
            esm = A * A + 2.0 * A * B * E1 + B * B * E2
            near = (((gl.x[:, :, None] - g[None, None, :]).abs() < self.thresh + slack)
                    & gl.mask[:, :, None]).any(1)
            floor = guard * torch.maximum(EPS32 * gl.kappa[:, None],
                                          (LAM32 * rho * gl.kappa)[:, None] * k.sum(-2))
            ok = ~near & (gam > floor)
            flat = (zTa * zTa)[:, None].expand_as(esm)
            scores.append(torch.where(ok, esm, flat))
            raw.append(torch.where(gam > 0, esm, flat))
            resolved.append(ok)
        return dict(scores=torch.cat(scores, -1), raw=torch.cat(raw, -1), resolved=torch.cat(resolved, -1),
                    zTa=zTa)

    def choose(self, st, grid):
        """Each problem's pick (P,): the best score away from its observations;
        where every point is near one, the point farthest from them."""
        scores = self.esm(st, grid)["scores"]
        g = self.ar.t(grid)
        d = (g[None, :, None] - st["x"][:, None, :]).abs().amin(-1)
        near = d < self.thresh
        close = torch.clamp(1.0 - d / self.thresh, 0.0, 1.0)
        demoted = scores - close * (0.25 * scores.abs() + 1e-20)
        sel = torch.where(near, torch.full_like(scores, -math.inf), scores)
        sel = torch.where(near.all(-1, keepdim=True), demoted, sel)
        return g[sel.argmax(-1)]

    # ------------------------------------------------------------------ fit
    def mll_grad(self, u, x, y, mask, s):
        """(MLL (R,), ∂MLL/∂log θ (R, 2)) of rows u = log θ (R, 2) on data
        (R, n) (masked rows out)."""
        ar = self.ar
        th = torch.exp(u)
        h, w = th[:, 0], th[:, 1]
        m = mask.to(ar.dtype)
        D2 = ((x[:, :, None] - x[:, None, :]) / w[:, None, None]) ** 2 * (m[:, :, None] * m[:, None, :])
        E = torch.exp(-0.5 * D2) * (m[:, :, None] * m[:, None, :])
        gp = GP(ar, x, y, mask, h, w, s, self.base_jitter)
        ym = gp.y
        logdet = 2.0 * torch.log(torch.where(mask, torch.diagonal(gp.L, dim1=-2, dim2=-1),
                                             torch.ones_like(gp.y))).sum(-1)
        mll = -0.5 * (ar.dot(ym, gp.alpha) + logdet + m.sum(-1) * _LOG2PI)
        G = gp.Kinv - gp.alpha[:, :, None] * gp.alpha[:, None, :]
        h2 = (h * h)[:, None, None]
        dK_dlogh = 2.0 * h2 * E
        dK_dlogw = h2 * E * D2
        grad = torch.stack([-0.5 * (G * dK_dlogh).sum((-1, -2)), -0.5 * (G * dK_dlogw).sum((-1, -2))], -1)
        return mll, grad

    def polish(self, u, x, y, mask, s, iters: int = 40):
        """Newton's method with backtracking on the MLL from rows u = log θ
        → (u*, MLL(u*), MLL(u)): the local optimum nearest each start."""
        step = 1e-4
        mll0, g = self.mll_grad(u, x, y, mask, s)
        mll = mll0
        for _ in range(iters):
            H = torch.stack([(self.mll_grad(u + step * e, x, y, mask, s)[1]
                              - self.mll_grad(u - step * e, x, y, mask, s)[1]) / (2 * step)
                             for e in torch.eye(2, dtype=u.dtype, device=u.device)], -1)
            H = 0.5 * (H + H.transpose(-1, -2))
            neg_def = (H[:, 0, 0] < 0) & (torch.linalg.det(H) > 0)
            newton = -torch.linalg.solve(torch.where(neg_def[:, None, None], H,
                                                     -torch.eye(2, dtype=u.dtype, device=u.device)), g)
            d = torch.where(neg_def[:, None], newton, 0.1 * g / g.norm(dim=-1, keepdim=True).clamp(min=1e-30))
            t = torch.ones_like(mll)
            done = torch.zeros_like(mll, dtype=torch.bool)
            new_u, new_mll, new_g = u.clone(), mll.clone(), g.clone()
            for _ in range(30):
                cand = u + t[:, None] * d
                cm, cg = self.mll_grad(cand, x, y, mask, s)
                take = ~done & torch.isfinite(cm) & (cm >= mll)
                new_u = torch.where(take[:, None], cand, new_u)
                new_mll = torch.where(take, cm, new_mll)
                new_g = torch.where(take[:, None], cg, new_g)
                done = done | take
                if bool(done.all()):
                    break
                t = torch.where(done, t, 0.5 * t)
            moved = (new_mll - mll).abs().amax()
            u, mll, g = new_u, new_mll, new_g
            if float(moved) < 1e-12:
                break
        return u, mll, mll0

    def restarts(self, gen: torch.Generator, theta0, x, y, mask, ntry: int):
        """The configured restart rows in log θ, (P, ntry, 2): row 0 the
        incumbent; log h ~ log std(y) + U(−2, 2), log w ~ log range(x) +
        U(log 0.05, log 2)."""
        ar = self.ar
        m = mask.to(ar.dtype)
        n = m.sum(-1).clamp(min=1.0)
        ymean = (y * m).sum(-1) / n
        ystd = torch.sqrt(torch.clamp((m * (y - ymean[:, None]) ** 2).sum(-1) / n, min=1e-12))
        big = torch.finfo(ar.dtype).max
        xr = torch.clamp(torch.where(mask, x, -big).amax(-1) - torch.where(mask, x, big).amin(-1), min=1e-6)
        P = x.shape[0]
        r = torch.rand((P, ntry, 2), generator=gen, dtype=torch.float64).to(ar.device, ar.dtype)
        log_h = torch.log(ystd)[:, None] + (-2.0 + 4.0 * r[..., 0])
        lo, hi = math.log(0.05), math.log(2.0)
        log_w = torch.log(xr)[:, None] + (lo + (hi - lo) * r[..., 1])
        u = torch.stack([log_h, log_w], -1)
        u[:, 0, :] = torch.log(self._theta(theta0, P))
        return u

    def fit_adam(self, u0, x, y, mask, s, n_iter: int = 150, lr: float = 0.05):
        """The configured fit: Adam up the MLL in log θ from every restart row
        of u0 (P, R, 2), then the best row by MLL → θ (P, 2)."""
        P, R, _ = u0.shape
        rep = lambda a: a.repeat_interleave(R, 0)  # noqa: E731
        xs, ys, ms, ss = rep(x), rep(y), rep(mask), rep(s)
        u = u0.reshape(P * R, 2).clone()
        mom, vel = torch.zeros_like(u), torch.zeros_like(u)
        for it in range(1, n_iter + 1):
            _, g = self.mll_grad(u, xs, ys, ms, ss)
            g = torch.where(torch.isfinite(g), -g, torch.zeros_like(g))
            mom = 0.9 * mom + 0.1 * g
            vel = 0.999 * vel + 0.001 * g * g
            u = u - lr / (1.0 - 0.9 ** it) * mom / (torch.sqrt(vel / (1.0 - 0.999 ** it)) + 1e-8)
        mll, _ = self.mll_grad(u, xs, ys, ms, ss)
        mll = torch.where(torch.isfinite(mll), mll, torch.full_like(mll, -math.inf)).reshape(P, R)
        best = mll.argmax(-1)
        return torch.exp(u.reshape(P, R, 2)[torch.arange(P, device=u.device), best])

    def fit(self, gen: torch.Generator, x, l, ntry: int = 10, theta_tl=None, theta_l=None):
        """Both GPs fitted as the configuration states: θ_tl on the
        observations, then θ_l on observations ∪ candidates anchored under the
        fitted θ_tl → (θ_tl (P, 2), θ_l (P, 2))."""
        ar = self.ar
        st = self.state(x, l, theta_tl, theta_l)
        P = st["x"].shape[0]
        ones = torch.ones_like(st["x"], dtype=torch.bool)
        s_tl = ar.t(self.s_tl).expand(P)
        th_tl = self._theta(self.cfg["theta_tl"] if theta_tl is None else theta_tl, P)
        u0 = self.restarts(gen, th_tl, st["x"], st["tl"], ones, ntry)
        th_tl = self.fit_adam(u0, st["x"], st["tl"], ones, s_tl)
        st = self.state(x, l, th_tl, theta_l)
        gl = st["gp_l"]
        th_l = self._theta(self.cfg["theta_l"] if theta_l is None else theta_l, P)
        u0 = self.restarts(gen, th_l, gl.x, gl.y, gl.mask, ntry)
        th_l = self.fit_adam(u0, gl.x, gl.y, gl.mask, ar.t(self.s_l).expand(P))
        return th_tl, th_l
