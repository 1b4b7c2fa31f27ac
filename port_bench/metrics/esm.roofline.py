"""Kernels (``ops/hopper_kernels.py`` ``esm_fused``, and whatever a later
version launches for the same work): the share of its roofline that one
user's scoring reaches, in %.

Numerator, from the cell's shapes: the least time the card could take for
the ESM of G grid points against the live rows of both GPs (NP = live
observations + live candidates of the linear GP, NP2 = live observations of
the log-GP; rows padded to capacity or dropped near an observation are not
work the step needs): 2 operations
per term of the two quadratic forms kᵀK⁻¹k, ~12 per row for the cross-kernel
and the dots, ~40 per point for the rest; bytes: the grid, both inverses and
the problem's vectors read once, the scores written once. Operations bound
it. Denominator: the device time of every operation launched inside the
traced ``choose_next`` calls (preparation, selection and reads included)."""

from port_bench import peaks


def esm_ops(G: int, NP: int, NP2: int) -> float:
    return G * (2 * NP * NP + 2 * NP2 * NP2 + 12 * (NP + NP2) + 40)


def esm_bytes(G: int, NP: int, NP2: int) -> float:
    return 4 * (12 + G + 4 * NP + NP * NP + 3 * NP2 + NP2 * NP2 + G)


def read(tv):
    if not tv or not tv.shapes:
        return None
    G = int(tv.cfg["grid"]["G"])
    need = 0.0
    for sh in tv.shapes:
        if sh is None:
            return None
        ops = sum(esm_ops(G, ns + nc, ns) for ns, nc in zip(sh["ns"], sh["nc"]))
        nbytes = sum(esm_bytes(G, ns + nc, ns) for ns, nc in zip(sh["ns"], sh["nc"]))
        need += peaks.bound_s(ops, nbytes)
    dev = tv.device_s("choose")
    return 100.0 * need / dev if dev > 0 else None
