"""Closed-loop active steps. A step is ``choose_next`` on the grid, the
likelihood at the picks on the host (NumPy, as a user's function), then
``add_observation``; hypers stay fixed. Episodes of ``episode_steps`` steps
each start from a device copy of the set-up state, restored outside every
step's time (before the next step, so the last episode of a window is kept).

The check replays the window's last episode in the plain reference on the
program's own picks. Each pick is held to the best float64 ESM among the
points the float32 guard surely resolves: ``pick_loss`` is the share of the
picks' summed best gain (best ESM − (zᵀα)²) that they lost. E[Z] and V[Z]
after the adds are held to the reference's on the same observations.

Parameters: ``episode_steps``, ``check_problems`` (problems whose picks are
replayed, drawn from the seed), ``trace_units``.
"""

from __future__ import annotations

import numpy as np

from port_bench import system

#: The judge's margin on the float32 guard: points whose Schur complement
#: clears twice the guard, and that lie ``SLACK`` beyond ``candidate_thresh``
#: of every live point, are ones the float32 scorer surely resolves.
GUARD_MARGIN, SLACK = 2.0, 1e-5
#: float64 problems of one block of the replay.
BLOCK = 128


class Cell:
    unit_name = "step"

    def __init__(self, run):
        self.run = run
        self.steps = int(run.params["episode_steps"])
        self.k = 0

    # ------------------------------------------------------------ the program
    def setup(self):
        import torch

        run = self.run
        self.data, self.grid_np = inputs(run)
        self.grid = torch.as_tensor(self.grid_np[:, None], device=run.device.dev)
        self.est = system.build(run, self.data)
        self.saved = system.clone(system.state(self.est))
        self.n0 = self.data["x"].shape[1]
        self.picks, self.ls = [], []

    def warm(self):
        for _ in range(self.steps):
            self.unit()
        self.run.device.sync()

    def prepare(self):
        if self.k == self.steps:
            with self.run.device.span("restore"):
                self.est = system.restore(self.est, self.saved)
            self.k, self.picks, self.ls = 0, [], []

    def recover(self):
        self.k = self.steps
        self.prepare()

    def shape(self) -> dict:
        """The state the next step scores: its live observations and
        candidates (masks, read after the traced units)."""
        st = system.state(self.est)
        return {"P": self.data["P"], "ns": st.obs_mask, "nc": st.c_mask}

    def unit(self):
        dev = self.run.device
        with dev.span("choose"):
            x = np.asarray(self.est.choose_next(self.grid), np.float64).reshape(self.data["P"])
        with dev.span("lik"):
            lv = self.data["lik"](x)
        with dev.span("add"):
            if system.is_fleet(self.est):
                self.est.add_observation(x[:, None], lv)
            else:
                self.est.add_observation(float(x[0]), float(lv[0]))
        self.k += 1
        self.picks.append(x)
        self.ls.append(lv)
        return self.data["P"]

    def end_to_end(self, win: dict) -> dict:
        """Problem-steps over the whole window, and the 95th percentile of
        every step's host time (``choose_next`` to the end of its
        ``add_observation``'s work; restores outside it)."""
        steps = sorted(win["host_unit_s"])
        out = {"problem_steps_per_s": win["work"] / win["window_s"]}
        if steps:
            out["step_p95_ms"] = 1e3 * steps[int(np.ceil(0.95 * len(steps))) - 1]
        return out

    def outputs(self) -> dict:
        zm, zv = system.moments(self.est)
        return dict(picks=np.array(self.picks), ls=np.array(self.ls), zmean=zm, zvar=zv)

    def release(self):
        self.est = self.saved = self.grid = None

    # ----------------------------------------------------------------- check
    def check(self, out: dict) -> dict:
        return judge(self.run, self.data, self.grid_np, out)


def inputs(run) -> tuple:
    """(data, grid): the observations and likelihood of the seed, and the
    float32 grid that the program and the reference both score."""
    g = run.cfg["grid"]
    return run.recipe().make(run.cfg, run.rng(1)), np.linspace(g["lo"], g["hi"], int(g["G"])).astype(np.float32)


def judge(run, data: dict, grid_np: np.ndarray, out: dict, finite_only: bool = False) -> dict:
    """The numbers compared, each with its limit, for one episode's outputs
    (``picks`` and ``ls`` (k, P), ``zmean`` and ``zvar`` (P,))."""
    import torch

    ref = run.reference()
    dev = run.device.dev
    ar = ref.Arith("f64", dev)
    model = ref.Model(run.cfg["model"], ar)
    picks, ls = np.asarray(out["picks"], np.float64), np.asarray(out["ls"], np.float64)
    k, P = picks.shape if picks.size else (0, data["P"])
    x_all = np.concatenate([data["x"], picks.T.reshape(P, k)], 1)
    l_all = np.concatenate([data["l"], ls.T.reshape(P, k)], 1)
    n0 = data["x"].shape[1]
    n_check = min(P, int(run.params.get("check_problems", P)))
    sample = np.sort(run.rng(7).choice(P, n_check, replace=False))
    grid = torch.as_tensor(grid_np.astype(np.float64), device=dev)
    lost = gained = worst = 0.0
    for t in range(k):
        for b0 in range(0, n_check, BLOCK):
            idx = sample[b0:b0 + BLOCK]
            st = model.state(x_all[idx, :n0 + t], l_all[idx, :n0 + t])
            e = model.esm(st, grid, guard=GUARD_MARGIN, slack=SLACK)
            best = torch.where(e["resolved"], e["raw"], torch.full_like(e["raw"], -np.inf)).amax(-1)
            gain = best - e["zTa"] ** 2
            at = torch.as_tensor(np.abs(grid_np[None, :] - picks[t, idx][:, None]).argmin(-1), device=dev)
            got = e["raw"].gather(1, at[:, None])[:, 0]
            miss = torch.clamp(best - got, min=0.0)
            judged = gain > 0
            lost += float(miss[judged].sum())
            gained += float(gain[judged].sum())
            if bool(judged.any()):
                worst = max(worst, float((miss / gain)[judged].max()))
    zm_ref, zv_ref = [], []
    for b0 in range(0, P, BLOCK * 8):
        st = model.state(x_all[b0:b0 + BLOCK * 8], l_all[b0:b0 + BLOCK * 8])
        zm_ref.append(model.z_mean(st).cpu().numpy())
        zv_ref.append(model.z_var(st).cpu().numpy())
    zm_ref, zv_ref = np.concatenate(zm_ref), np.concatenate(zv_ref)
    vals = dict(pick_loss=lost / gained if gained > 0 else 0.0,
                zmean_rel=worst_rel(out["zmean"], zm_ref, finite_only),
                zvar_rel=worst_rel(out["zvar"], zv_ref, finite_only))
    print(f"check detail: picks judged {k} steps x {n_check} problems, worst single pick's loss {worst!r}, "
          f"non-finite answers {int(np.sum(~np.isfinite(out['zmean'])) + np.sum(~np.isfinite(out['zvar'])))}",
          file=run.err, flush=True)
    return limited(run, vals)


def worst_rel(got, want, finite_only: bool = False) -> float:
    """The largest relative error over the answers; NaN if any is not finite
    (``finite_only``: over the finite ones, as the control's readings are
    taken)."""
    got = np.asarray(got, np.float64)
    ok = np.isfinite(got)
    if not ok.all() and not finite_only:
        return float("nan")
    return float(np.max((np.abs(got - want) / np.abs(want))[ok])) if ok.any() else float("nan")


def limited(run, vals: dict) -> dict:
    """The numbers the cell compares (those its workload file gives a limit),
    each with its limit; a number that is not finite is None, and fails. The
    others are printed beside them."""
    lim = run.workload["limits"]
    rest = {n: v for n, v in vals.items() if n not in lim}
    if rest:
        print(f"check detail: not compared in this cell {rest!r}", file=run.err, flush=True)
    return {n: {"value": float(vals[n]) if np.isfinite(vals[n]) else None, "limit": lim[n]} for n in lim}


def control_outputs(run, data: dict, grid_np: np.ndarray, mode: str = "tf32") -> dict:
    """One episode of the plain reference in the program's place, computed in
    ``mode`` (the control: TF32 products, one step below float32)."""
    import torch

    ref = run.reference()
    ar = ref.Arith(mode, run.device.dev)
    model = ref.Model(run.cfg["model"], ar)
    grid = torch.as_tensor(grid_np, dtype=ar.dtype, device=run.device.dev)
    x, lv = data["x"], data["l"]
    picks, ls = [], []
    steps = int(run.params["episode_steps"])
    for _ in range(steps):
        xp = []
        for b0 in range(0, data["P"], BLOCK):
            st = model.state(x[b0:b0 + BLOCK], lv[b0:b0 + BLOCK])
            xp.append(model.choose(st, grid).double().cpu().numpy())
        xp = np.concatenate(xp)
        lp = data["lik"](xp)
        picks.append(xp)
        ls.append(lp)
        x, lv = np.concatenate([x, xp[:, None]], 1), np.concatenate([lv, lp[:, None]], 1)
    zm, zv = [], []
    for b0 in range(0, data["P"], BLOCK * 8):
        st = model.state(x[b0:b0 + BLOCK * 8], lv[b0:b0 + BLOCK * 8])
        zm.append(model.z_mean(st).double().cpu().numpy())
        zv.append(model.z_var(st).double().cpu().numpy())
    return dict(picks=np.array(picks), ls=np.array(ls), zmean=np.concatenate(zm), zvar=np.concatenate(zv))
