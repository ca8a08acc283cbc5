"""Rank layouts: the (stream, time) mesh and the 1-D ``blocks`` ring.

Counterpart of ``nfclab/shard/mesh.py``.  nfclab lays one process's
devices out as a ``jax.sharding.Mesh``; here every device belongs to its
own ``torch.distributed`` rank, so a layout is a grid of ranks with this
rank's place in it:

- ``stream``: data parallelism over independent captures/streams;
- ``time``: temporal sharding of one long stream into overlap-save blocks
  (halos make blocks independent; the ring halo exchange serves only the
  sharded channel step, shard/multichip.py);
- ``blocks``: the 1-D layout of shard/launch.global_mesh.

With a process group the (stream, time) grid is
``torch.distributed.device_mesh.init_device_mesh``'s; with none it is one
rank holding the whole batch.  Every layout carries the device its rank
computes on: ``cuda`` unless the caller asks for ``cpu``.
"""

from __future__ import annotations

import typing

import numpy as np
import torch


class Mesh(typing.NamedTuple):
    """A grid of ranks: ``shape`` along ``names``, ``ranks`` the global
    ranks in row-major grid order, ``coords`` this rank's place; ``group``
    spans every rank of the grid (None on one rank, with no process
    group)."""

    device: torch.device
    names: tuple
    shape: tuple
    coords: tuple
    ranks: tuple
    group: object = None

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def distributed() -> bool:
    """True when this process belongs to a torch.distributed group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def make_mesh(stream_parallel: int | None = None, time_parallel: int = 1,
              device="cuda") -> Mesh:
    """Create a (stream, time) layout over every rank of the default
    process group (one rank when there is none)."""
    from ..dsp.cuda_channels import resolve_device

    dev = resolve_device(device)
    if not distributed():
        n = 1
        if stream_parallel is None:
            stream_parallel = n // time_parallel
        if stream_parallel * time_parallel != n:
            raise ValueError(
                f"{stream_parallel}x{time_parallel} != {n} rank (no process "
                "group)")
        return Mesh(dev, ("stream", "time"), (1, 1), (0, 0), (0,))

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if stream_parallel is None:
        stream_parallel = n // time_parallel
    if stream_parallel * time_parallel != n:
        raise ValueError(f"{stream_parallel}x{time_parallel} != {n} ranks")
    dm = init_device_mesh(dev.type, (stream_parallel, time_parallel),
                          mesh_dim_names=("stream", "time"))
    return Mesh(dev, ("stream", "time"), (stream_parallel, time_parallel),
                tuple(dm.get_coordinate()),
                tuple(int(r) for r in dm.mesh.reshape(-1).tolist()),
                dist.group.WORLD)


def shard_batch(mesh: Mesh, arr, axis_name: str = "stream") -> torch.Tensor:
    """This rank's slice of the leading axis of a [B, ...] array, split
    evenly over the mesh axis ``axis_name`` (replicated over the others),
    as a tensor on the mesh's device."""
    ax = mesh.names.index(axis_name)
    parts, i = mesh.shape[ax], mesh.coords[ax]
    t = torch.as_tensor(arr)
    if t.shape[0] % parts:
        raise ValueError(
            f"leading axis {t.shape[0]} does not split over {parts} ranks")
    per = t.shape[0] // parts
    return t[i * per : (i + 1) * per].to(mesh.device)
