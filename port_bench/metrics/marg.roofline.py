"""Kernels (``ops/hopper_kernels.py`` ``cholesky_batched`` / ``chol_batch``
and the batched triangular solves, and whatever a later version launches for
the same work): the share of its roofline that the marginalization reaches,
in %.

Numerator, from the cell's shapes: for each problem, the linear GP's Gram
does not depend on the θ_tl rows, so one factorization (n_l³/3); for each of
its S rows the log-GP's factorization (n_tl³/3), both GPs' α solves (2n²
each) and the float32 V[Z] quadrature's solve against ``n_gh`` nodes
(n_gh·n_tl²); n the problem's live rows (n_tl its live observations, n_l
those and its live candidates; rows padded to capacity or dropped near an
observation are not work), summed over the problems. Bytes: the data, the rows and the moments,
once. Operations bound it; the factorizations are in truth bound by their n
dependent steps, which no peak counts. Denominator: the device time of every
operation launched inside the traced marginalizations."""

from port_bench import peaks


def marg_ops(S: int, n_tl: int, n_l: int, n_gh: int) -> float:
    """One problem's operations."""
    per_row = n_tl**3 / 3 + 2 * n_tl * n_tl + 2 * n_l * n_l + n_gh * n_tl * n_tl
    return n_l**3 / 3 + S * per_row


def marg_bytes(S: int, n_tl: int, n_l: int) -> float:
    """One problem's bytes."""
    return 4 * (2 * n_tl + 2 * n_l + 4 * S)


def read(tv):
    if not tv or not tv.shapes:
        return None
    n_gh = int(tv.cfg["model"].get("n_gh", 128))
    need = 0.0
    for sh in tv.shapes:
        if sh is None:
            return None
        ops = sum(marg_ops(sh["S"], ns, ns + nc, n_gh) for ns, nc in zip(sh["ns"], sh["nc"]))
        nbytes = sum(marg_bytes(sh["S"], ns, ns + nc) for ns, nc in zip(sh["ns"], sh["nc"]))
        need += peaks.bound_s(ops, nbytes)
    dev = tv.device_s("marg")
    return 100.0 * need / dev if dev > 0 else None
