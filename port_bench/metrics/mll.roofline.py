"""Kernels (``ops/hopper_kernels.py`` ``mll_grad_batched``, and whatever a
later version launches for the same work): the share of its roofline that
the hyper fit reaches, in %.

Numerator, from the cell's shapes: the configured fit evaluates the MLL and
its gradient for every restart row of every problem at each of its 150 Adam
steps and once more to rank them, for both GPs: calls × rows × (n³ + 27n²)
operations, n the problem's live rows in that GP (the log-GP's live
observations; the linear GP's live observations and live candidates; rows
padded to capacity or dropped near an observation are not work the fit
needs), summed over the problems: the Cholesky, L⁻¹ and K⁻¹ = YᵀY's lower half
(n³/3 each) and the Gram and traces (~27n²). Operations bound it; the
factorizations are in truth bound by their n dependent steps, which no peak
counts. Denominator: the device time of every operation launched inside the
traced fit calls (Adam's updates, the restarts and the refits included)."""

from port_bench import peaks

#: The fused fit's Adam steps, plus the call that ranks the restarts.
FIT_CALLS = 150 + 1


def mll_ops(rows: int, n: int) -> float:
    return rows * (n**3 + 27 * n * n)


def mll_bytes(rows: int, n: int) -> float:
    return 4 * (5 * rows + 3 * n)


def read(tv):
    if not tv or not tv.shapes:
        return None
    ntry = int(tv.params["ntry"])
    need = 0.0
    for sh in tv.shapes:
        if sh is None:
            return None
        for gp_rows in (sh["ns"], [ns + nc for ns, nc in zip(sh["ns"], sh["nc"])]):  # log-GP, linear GP
            ops = sum(mll_ops(ntry, n) for n in gp_rows)
            nbytes = sum(mll_bytes(ntry, n) for n in gp_rows)
            need += FIT_CALLS * peaks.bound_s(ops, nbytes)
    dev = tv.device_s("fit")
    return 100.0 * need / dev if dev > 0 else None
