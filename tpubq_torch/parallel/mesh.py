"""Device meshes over ``torch.distributed``.

Counterpart of ``tpubq/parallel/mesh.py``. The scaling axes are the JAX
package's: the candidate grid ("sp": shard the scored points) and the
hyper-sample or problem batch ("dp"). The port runs one process per device
(SPMD): every process calls the same functions with the same full inputs,
and a ``DeviceMesh`` of two named dimensions tells each process its
coordinates and the process groups of its row and column. The collectives
are NCCL's on CUDA devices and gloo's on the CPU; the backend follows the
device and is never switched quietly.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpubq_torch.utils.device import resolve_device

#: Axis names: dp = hyper-sample / problem (data-parallel-like) axis, sp =
#: candidate grid (sequence-parallel-like) axis.
AXIS_SAMPLE = "dp"
AXIS_GRID = "sp"

#: The backend of each device type.
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into (a, b), a*b = n, as square as possible (a <= b)."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def _init_single_process(backend: str, dev: torch.device) -> None:
    """A world of one process from an in-memory store: no environment
    variable is read and no rendezvous socket opened. NCCL is initialised
    at once (``device_id``), so a failure raises here."""
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, str] = (AXIS_SAMPLE, AXIS_GRID),
    device="cuda",
) -> DeviceMesh:
    """A 2-D (dp, sp) ``DeviceMesh`` over the default process group, rank
    r at row r // n_sp and column r % n_sp.

    Every process of the group calls it (SPMD), and the mesh covers them
    all: one process per device. Where no group exists, a world of one
    process is initialised in memory, on ``nccl`` for a CUDA ``device``
    (the card unless the caller names another) and ``gloo`` for the CPU.
    An existing group must run the device's backend. ``shape`` overrides
    the default near-square factorization; with one process this is a
    (1, 1) mesh and every sharded function computes what its unsharded
    counterpart does.
    """
    dev = resolve_device(device)
    backend = _BACKEND.get(dev.type)
    if backend is None:
        raise ValueError(f"no collective backend for device type {dev.type!r}")
    if not dist.is_initialized():
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        _init_single_process(backend, dev)
    elif backend not in str(dist.get_backend()):
        raise RuntimeError(
            f"the default process group runs {dist.get_backend()!r}; a {dev.type} mesh needs {backend!r}"
        )
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"asked for {n_devices} devices, have {world}")
    if n_devices < world:
        raise ValueError(f"asked for {n_devices} devices of {world} processes: the mesh covers every process")
    if shape is None:
        shape = _factor2(n_devices)
    if math.prod(shape) != n_devices:
        raise ValueError(f"shape {tuple(shape)} does not cover {n_devices} devices")
    ranks = torch.arange(n_devices).reshape(tuple(shape))
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The mesh's extent along the named dimension (JAX's ``mesh.shape[name]``)."""
    return mesh.size(mesh.mesh_dim_names.index(name))

