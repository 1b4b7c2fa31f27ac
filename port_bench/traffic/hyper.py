"""Hyper rounds. A round starts from a device copy of the set-up state
(restored outside the round's time), fits both GPs' hypers
(``fit_hypers(ntry, seed)`` / ``BQFleet.fit``), then marginalizes E[Z] and
V[Z] over θ_tl rows drawn once from the seed: log-normal around the
configuration's θ_tl (``tpubq_torch.models.marginalize.marginalize``, or
``models.batched.marginalize_batch`` for a fleet, (B, S) rows). The round
reads its moments back to the host.

The check holds the window's last round to the plain reference: how far the
fitted hypers sit below the local optimum of the float64 MLL that Newton's
method reaches from them (``fit_gap``, nats; the largest over both GPs), the
program's E[Z] and V[Z] after the fit against the reference's at the fitted
hypers (``zmean_rel``, ``zvar_rel``) and at that optimum (``zmean_opt_rel``,
``zvar_opt_rel``: these judge the fit itself), and each row's E[Z] and V[Z]
under the fitted θ_l. A cell compares the numbers its limits name.

Parameters: ``ntry``, ``rows`` (S), ``row_sigma``, ``trace_units``.
"""

from __future__ import annotations

import numpy as np

from port_bench import system
from port_bench.traffic.loop import limited, worst_rel

#: float64 problems (fit) and problem-rows (marginalization) of one block.
BLOCK = 1024


class Cell:
    unit_name = "round"

    def __init__(self, run):
        self.run = run
        self.round = 0

    def setup(self):
        import torch

        run = self.run
        self.data, self.rows = inputs(run)
        self.est = system.build(run, self.data)
        dt = system.state(self.est).x_s.dtype
        rows = self.rows if system.is_fleet(self.est) else self.rows[0]
        self.rows_dev = torch.as_tensor(rows, dtype=dt, device=run.device.dev)
        self.saved = system.clone(system.state(self.est))
        self.last = None

    def warm(self):
        self.unit()
        self.run.device.sync()

    def prepare(self):
        with self.run.device.span("restore"):
            self.est = system.restore(self.est, self.saved)

    def recover(self):
        self.prepare()

    def fit_seed(self, r: int) -> int:
        return (self.run.seed * 7919 + r) % (2**31 - 1)

    def shape(self) -> dict:
        """The state the next round fits: its live observations and
        candidates (masks, read after the traced units), and the rows."""
        st = system.state(self.est)
        return {"P": self.data["P"], "S": int(self.run.params["rows"]), "ns": st.obs_mask, "nc": st.c_mask}

    def unit(self):
        from tpubq_torch.models import batched, marginalize

        dev = self.run.device
        seed = self.fit_seed(self.round)
        self.round += 1
        with dev.span("fit"):
            self.est.fit_hypers(ntry=int(self.run.params["ntry"]), seed=seed)
        with dev.span("marg"):
            st = system.state(self.est)
            if system.is_fleet(self.est):
                zm, zv = batched.marginalize_batch(st, self.est.options, self.rows_dev)
            else:
                zm, zv = marginalize.marginalize(st, self.est.options, self.rows_dev)
            zm, zv = zm.cpu().numpy(), zv.cpu().numpy()
        self.last = (seed, zm, zv)
        return 1

    def end_to_end(self, win: dict) -> dict:
        return {"hyper_ms": 1e3 * win["window_s"] / win["units"]}

    def outputs(self) -> dict:
        th_tl, th_l = system.hypers(self.est)
        zm, zv = system.moments(self.est)
        P = self.data["P"]
        return dict(theta_tl=th_tl, theta_l=th_l, zmean=zm, zvar=zv,
                    marg_zmean=np.asarray(self.last[1], np.float64).reshape(P, -1),
                    marg_zvar=np.asarray(self.last[2], np.float64).reshape(P, -1))

    def release(self):
        self.est = self.saved = self.rows_dev = None

    def check(self, out: dict) -> dict:
        return judge(self.run, self.data, self.rows, out)


def inputs(run) -> tuple:
    """(data, rows): the observations and likelihood of the seed, and the
    (P, S, 2) θ_tl rows, log-normal around the configuration's θ_tl."""
    data = run.recipe().make(run.cfg, run.rng(1))
    th = np.asarray(run.cfg["model"]["theta_tl"], np.float64)
    shape = (data["P"], int(run.params["rows"]), th.size)
    return data, th * np.exp(float(run.params["row_sigma"]) * run.rng(2).standard_normal(shape))


def judge(run, data: dict, rows: np.ndarray, out: dict, finite_only: bool = False) -> dict:
    """The numbers compared, each with its limit, for one round's outputs:
    ``theta_tl``, ``theta_l`` (P, 2), ``zmean``, ``zvar`` (P,),
    ``marg_zmean``, ``marg_zvar`` (P, S)."""
    import torch

    ref = run.reference()
    dev = run.device.dev
    ar = ref.Arith("f64", dev)
    model = ref.Model(run.cfg["model"], ar)
    P, S = rows.shape[:2]
    x, lv = data["x"], data["l"]
    gaps, zm, zv, zm_opt, zv_opt = [], [], [], [], []
    for b0 in range(0, P, BLOCK):
        sl = slice(b0, b0 + BLOCK)
        th_tl, th_l = out["theta_tl"][sl], out["theta_l"][sl]
        st = model.state(x[sl], lv[sl], th_tl, th_l)
        zm.append(model.z_mean(st).cpu().numpy())
        zv.append(model.z_var(st).cpu().numpy())
        p = st["x"].shape[0]
        s_tl, s_l = ar.t(model.s_tl).expand(p), ar.t(model.s_l).expand(p)
        gt, gl = st["gp_tl"], st["gp_l"]
        u_tl, m1, m0 = model.polish(torch.log(ar.t(th_tl)), gt.x, gt.y, gt.mask, s_tl)
        gaps.append((m1 - m0).cpu().numpy())
        _, m1, m0 = model.polish(torch.log(ar.t(th_l)), gl.x, gl.y, gl.mask, s_l)
        gaps.append((m1 - m0).cpu().numpy())
        # the moments at the optimum the fit heads for: θ_tl*, then θ_l* on the anchors it gives
        gl = model.state(x[sl], lv[sl], torch.exp(u_tl), th_l)["gp_l"]
        u_l, _, _ = model.polish(torch.log(ar.t(th_l)), gl.x, gl.y, gl.mask, s_l)
        st = model.state(x[sl], lv[sl], torch.exp(u_tl), torch.exp(u_l))
        zm_opt.append(model.z_mean(st).cpu().numpy())
        zv_opt.append(model.z_var(st).cpu().numpy())
    gaps = np.concatenate(gaps)
    ok = np.isfinite(gaps)
    gap = float(np.max(gaps[ok])) if ok.any() and (finite_only or ok.all()) else float("nan")
    zm, zv, zm_opt, zv_opt = (np.concatenate(a) for a in (zm, zv, zm_opt, zv_opt))
    mzm, mzv = [], []
    flat_rows = rows.reshape(P * S, -1)
    rep = np.repeat(np.arange(P), S)
    for b0 in range(0, P * S, BLOCK):
        i = rep[b0:b0 + BLOCK]
        st = model.state(x[i], lv[i], flat_rows[b0:b0 + BLOCK], out["theta_l"][i])
        mzm.append(model.z_mean(st).cpu().numpy())
        mzv.append(model.z_var(st).cpu().numpy())
    mzm, mzv = np.concatenate(mzm).reshape(P, S), np.concatenate(mzv).reshape(P, S)
    f = finite_only
    vals = dict(fit_gap=gap, zmean_rel=worst_rel(out["zmean"], zm, f), zvar_rel=worst_rel(out["zvar"], zv, f),
                zmean_opt_rel=worst_rel(out["zmean"], zm_opt, f), zvar_opt_rel=worst_rel(out["zvar"], zv_opt, f),
                marg_zmean_rel=worst_rel(out["marg_zmean"], mzm, f),
                marg_zvar_rel=worst_rel(out["marg_zvar"], mzv, f))
    return limited(run, vals)


def control_outputs(run, data: dict, rows: np.ndarray, mode: str = "tf32") -> dict:
    """One round of the plain reference in the program's place, computed in
    ``mode`` (the control: TF32 products, one step below float32): the
    configured Adam fit from restarts drawn from the seed, the moments at the
    fitted hypers, and the rows' moments."""
    import torch

    ref = run.reference()
    ar = ref.Arith(mode, run.device.dev)
    model = ref.Model(run.cfg["model"], ar)
    gen = torch.Generator().manual_seed(int(run.rng(3).integers(2**31 - 1)))
    P, S = rows.shape[:2]
    th_tl, th_l, zm, zv = [], [], [], []
    for b0 in range(0, P, BLOCK):
        sl = slice(b0, b0 + BLOCK)
        a, b = model.fit(gen, data["x"][sl], data["l"][sl], ntry=int(run.params["ntry"]))
        st = model.state(data["x"][sl], data["l"][sl], a, b)
        th_tl.append(a.double().cpu().numpy())
        th_l.append(b.double().cpu().numpy())
        zm.append(model.z_mean(st).double().cpu().numpy())
        zv.append(model.z_var(st).double().cpu().numpy())
    th_tl, th_l = np.concatenate(th_tl), np.concatenate(th_l)
    flat_rows = rows.reshape(P * S, -1)
    rep = np.repeat(np.arange(P), S)
    mzm, mzv = [], []
    for b0 in range(0, P * S, BLOCK):
        i = rep[b0:b0 + BLOCK]
        st = model.state(data["x"][i], data["l"][i], flat_rows[b0:b0 + BLOCK], th_l[i])
        mzm.append(model.z_mean(st).double().cpu().numpy())
        mzv.append(model.z_var(st).double().cpu().numpy())
    return dict(theta_tl=th_tl, theta_l=th_l, zmean=np.concatenate(zm), zvar=np.concatenate(zv),
                marg_zmean=np.concatenate(mzm).reshape(P, S), marg_zvar=np.concatenate(mzv).reshape(P, S))
