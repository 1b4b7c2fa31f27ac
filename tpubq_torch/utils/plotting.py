"""Matplotlib diagnostics (counterpart of ``tpubq/utils/plotting.py``).

The posterior panels of one estimator (``BQ.plot_gp_log_l``, ``plot_gp_l``,
``plot_l``, ``plot``, the ESM and expected-variance curves) in 1-D and a
heat-map triptych in 2-D. Device tensors are read back once per panel.
matplotlib is imported inside the functions, so the package imports without
it; use the Agg backend where there is no display.
"""

from __future__ import annotations

import numpy as np
import torch


def _ax(ax):
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    return ax


def _grid(bq, xmin, xmax, n=400):
    if bq.options.dim != 1:
        raise ValueError(
            "plot_* diagnostics are 1-D (reference parity: the upstream "
            "library is 1-D); for d > 1 evaluate the posteriors on your own "
            "slice/projection via tpubq_torch.models.gp.gp_mean/gp_var"
        )
    xs = bq.x_s[:, 0]
    lo = float(xs.min()) if xmin is None else xmin
    hi = float(xs.max()) if xmax is None else xmax
    pad = 0.1 * (hi - lo)
    return np.linspace(lo - pad, hi + pad, n)


def _points(bq, X):
    st = bq.state
    return torch.as_tensor(np.asarray(X), dtype=st.x_s.dtype, device=st.x_s.device)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _posterior(bq, which, xo):
    from tpubq_torch.models import gp as gpm
    from tpubq_torch.ops.kernels import get_kernel

    kfn, kdiagfn = get_kernel(bq.options.kernel)
    gp = bq.state.gp_log_l if which == "tl" else bq.state.gp_l
    X = _points(bq, xo[:, None])
    m = _np(gpm.gp_mean(kfn, gp, X))
    v = _np(gpm.gp_var(kfn, kdiagfn, gp, X))
    return m, np.sqrt(np.maximum(v, 0.0))


def plot_gp_log_l(bq, ax=None, f_l=None, xmin=None, xmax=None):
    """Log-space posterior ±2σ with the transformed data."""
    ax = _ax(ax)
    xo = _grid(bq, xmin, xmax)
    m, sd = _posterior(bq, "tl", xo)
    ax.fill_between(xo, m - 2 * sd, m + 2 * sd, alpha=0.25, color="C0")
    ax.plot(xo, m, "C0-", label="$m_{\\log\\ell}$")
    if f_l is not None:
        ax.plot(xo, np.log1p(np.asarray(f_l(xo)) / bq.gamma), "k--", label="true")
    ax.plot(bq.x_s[:, 0], bq.tl_s, "ro", label="obs")
    ax.set_title("GP over $\\log \\ell$")
    ax.legend(fontsize=8)
    return ax


def plot_gp_l(bq, ax=None, f_l=None, xmin=None, xmax=None):
    """Linear-space posterior with the candidates marked."""
    ax = _ax(ax)
    xo = _grid(bq, xmin, xmax)
    m, sd = _posterior(bq, "l", xo)
    ax.fill_between(xo, m - 2 * sd, m + 2 * sd, alpha=0.25, color="C1")
    ax.plot(xo, m, "C1-", label="$m_\\ell$")
    if f_l is not None:
        ax.plot(xo, np.asarray(f_l(xo)), "k--", label="true")
    ax.plot(bq.x_s[:, 0], bq.l_s, "ro", label="obs")
    if bq.nc:
        ax.plot(bq.x_c[:, 0], bq.l_c, "bs", mfc="none", label="candidates")
    ax.set_title("GP over $\\ell$")
    ax.legend(fontsize=8)
    return ax


def plot_l(bq, ax=None, f_l=None, xmin=None, xmax=None):
    """The final linearized approximation of ℓ against the truth."""
    ax = _ax(ax)
    xo = _grid(bq, xmin, xmax)
    m_tl, _ = _posterior(bq, "tl", xo)
    m_l, _ = _posterior(bq, "l", xo)
    ax.plot(xo, bq.gamma * np.expm1(m_tl), "C0-", label="$\\gamma(e^{m_{\\log\\ell}}-1)$")
    ax.plot(xo, m_l, "C1-", label="$m_\\ell$")
    if f_l is not None:
        ax.plot(xo, np.asarray(f_l(xo)), "k--", label="true")
    ax.plot(bq.x_s[:, 0], bq.l_s, "ro")
    ax.set_title("approximations of $\\ell$")
    ax.legend(fontsize=8)
    return ax


def plot(bq, f_l=None, xmin=None, xmax=None):
    """The three 1-D panels side by side → (fig, axes)."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    plot_gp_log_l(bq, ax=axes[0], f_l=f_l, xmin=xmin, xmax=xmax)
    plot_gp_l(bq, ax=axes[1], f_l=f_l, xmin=xmin, xmax=xmax)
    plot_l(bq, ax=axes[2], f_l=f_l, xmin=xmin, xmax=xmax)
    fig.tight_layout()
    return fig, axes


def plot_expected_squared_mean_curve(bq, ax=None, xmin=None, xmax=None):
    ax = _ax(ax)
    xo = _grid(bq, xmin, xmax)
    ax.plot(xo, np.asarray(bq.expected_squared_mean(xo)), "C2-")
    ax.axhline(bq.Z_mean() ** 2, color="k", ls=":", lw=0.8)
    ax.set_title("expected squared mean")
    return ax


def plot_expected_variance_curve(bq, ax=None, xmin=None, xmax=None):
    ax = _ax(ax)
    xo = _grid(bq, xmin, xmax)
    ax.plot(xo, np.asarray(bq.expected_Z_var(xo)), "C3-")
    ax.set_title("expected variance after sampling")
    return ax


def plot_expected_squared_mean(bq, x_a, scores, ax=None):
    """ESM over an explicit grid (``choose_next(plot=True)``)."""
    ax = _ax(ax)
    ax.plot(np.asarray(x_a).reshape(-1), np.asarray(scores), "C2-")
    ax.set_title("choose_next scores")
    return ax


def _grid2(bq, n, xmin=None, xmax=None):
    """(xx, yy, X): an n × n box padded 10% around the observations, or
    [xmin, xmax]² where bounds are given."""
    xs = np.asarray(bq.x_s)
    lo = xs.min(axis=0) if xmin is None else np.array([xmin, xmin], float)
    hi = xs.max(axis=0) if xmax is None else np.array([xmax, xmax], float)
    pad = 0.1 * (hi - lo) if (xmin is None and xmax is None) else np.zeros(2)
    ax0 = np.linspace(lo[0] - pad[0], hi[0] + pad[0], n)
    ax1 = np.linspace(lo[1] - pad[1], hi[1] + pad[1], n)
    xx, yy = np.meshgrid(ax0, ax1)
    return xx, yy, np.stack([xx.ravel(), yy.ravel()], axis=1)


def _overlay2(bq, ax):
    ax.plot(bq.x_s[:, 0], bq.x_s[:, 1], "ro", ms=4)
    if bq.nc:
        ax.plot(bq.x_c[:, 0], bq.x_c[:, 1], "ws", mfc="none", ms=4)


def plot_2d(bq, f_l=None, n=80, xmin=None, xmax=None):
    """The d = 2 triptych → (fig, axes): the log-GP's posterior mean, the
    linear GP's, and the ESM surface, each with the observations (dots) and
    candidates (open squares); ``f_l`` (a function of (m, 2) points) adds the
    true likelihood's contours to the middle panel."""
    import matplotlib.pyplot as plt

    from tpubq_torch.models import gp as gpm
    from tpubq_torch.ops.kernels import get_kernel

    if bq.options.dim != 2:
        raise ValueError("plot_2d requires a d=2 problem; use plot for d=1")
    kfn, _ = get_kernel(bq.options.kernel)
    xx, yy, X = _grid2(bq, n, xmin, xmax)
    Xt = _points(bq, X)
    m_tl = _np(gpm.gp_mean(kfn, bq.state.gp_log_l, Xt)).reshape(n, n)
    m_l = _np(gpm.gp_mean(kfn, bq.state.gp_l, Xt)).reshape(n, n)
    esm = np.asarray(bq.expected_squared_mean(X)).reshape(n, n)

    fig, axes = plt.subplots(1, 3, figsize=(12, 3.4))
    for ax, Z, title in zip(axes, (m_tl, m_l, esm),
                            ("$m_{\\log\\ell}$", "$m_\\ell$", "expected squared mean")):
        pc = ax.pcolormesh(xx, yy, Z, shading="auto")
        fig.colorbar(pc, ax=ax, shrink=0.85)
        _overlay2(bq, ax)
        ax.set_title(title)
    if f_l is not None:
        truth = np.asarray(f_l(X)).reshape(n, n)
        axes[1].contour(xx, yy, truth, levels=6, colors="k", linewidths=0.6, alpha=0.6)
    fig.tight_layout()
    return fig, axes
