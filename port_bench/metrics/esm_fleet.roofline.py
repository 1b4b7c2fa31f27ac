"""Kernels (``ops/hopper_kernels.py`` ``esm_fleet_l`` and ``esm_fleet_tl``,
and whatever a later version launches for the same work): the share of its
roofline that the fleet's scoring reaches, in %.

Numerator, from the cell's shapes: the least time the card could take for
the ESM of G grid points against each of the B problems' live rows of both
GPs (NP = its live observations + live candidates, NP2 = its live
observations), operations and bytes summed over the problems: 2 operations
per term of the two quadratic forms kᵀK⁻¹k, ~12 per row for the cross-kernel and
the dots, ~40 per point for the rest; bytes: the shared grid once, each
problem's inverses and vectors once, the (B, G) scores written once.
Operations bound it. Rows the kernels pad to the configuration's capacity,
and candidates dropped within ``candidate_thresh`` of an observation, are not
work the problem needs. Denominator: the device time of every
operation launched inside the traced ``choose_next`` calls (preparation,
combine, selection and reads included)."""

from port_bench import peaks


def esm_ops(G: int, NP: int, NP2: int) -> float:
    """One problem's operations."""
    return G * (2 * NP * NP + 2 * NP2 * NP2 + 12 * (NP + NP2) + 40)


def esm_bytes(G: int, NP: int, NP2: int) -> float:
    """One problem's bytes: its inverses and vectors read, its G scores
    written (the shared grid is counted once per call)."""
    return 4 * (12 + 4 * NP + NP * NP + 3 * NP2 + NP2 * NP2 + G)


def read(tv):
    if not tv or not tv.shapes:
        return None
    G = int(tv.cfg["grid"]["G"])
    need = 0.0
    for sh in tv.shapes:
        if sh is None:
            return None
        ops = sum(esm_ops(G, ns + nc, ns) for ns, nc in zip(sh["ns"], sh["nc"]))
        nbytes = 4 * G + sum(esm_bytes(G, ns + nc, ns) for ns, nc in zip(sh["ns"], sh["nc"]))
        need += peaks.bound_s(ops, nbytes)
    dev = tv.device_s("choose")
    return 100.0 * need / dev if dev > 0 else None
