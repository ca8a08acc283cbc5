"""Multi-host launch: distributed initialization + global rank layout.

Counterpart of ``nfclab/shard/launch.py``.  Decode work is embarrassingly
parallel at the capture level (file-level data sharding across hosts) and
halo-coupled at the block level (one H-sample ring exchange per rank per
step).  This module provides the launch-side pieces, one rank per device:

- ``initialize``: ``torch.distributed.init_process_group`` -- run the SAME
  program on every rank; a single-process run with no coordinator and no
  ``torchrun`` variables is a no-op, so every code path works unchanged on
  one machine.  The backend is ``nccl`` for CUDA and ``gloo`` for the CPU;
  ``gloo`` runs on the card only when the caller asks for it (the halo then
  crosses host memory, shard/temporal.ring_shift).
- ``global_mesh``: a 1-D ``blocks`` layout over every rank, ordered
  host-major so consecutive overlap-save blocks land on the same host --
  the ring's halo then crosses between hosts only once per host boundary
  per step.
- ``host_local_paths``: partition a capture list across ranks for the
  file-level throughput configuration (each rank decodes its own subset
  with ``runtime.batch.decode_batch``; no communication at all).

``shard.multichip.sharded_capture_channels`` / ``sharded_kernel_channels``
take the ``blocks`` layout directly, so the channel step runs unchanged
over many hosts.
"""

from __future__ import annotations

import os
import typing

import torch

from .mesh import Mesh, distributed

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


class RankInfo(typing.NamedTuple):
    """Where a rank runs: its node (hosts numbered in order of their first
    rank), its place among its node's ranks, and its global rank."""

    node: int
    local_rank: int
    rank: int


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None,
               device="cuda") -> int:
    """Join the process group; returns this process's rank.

    ``coordinator_address``: ``host:port`` (TCP rendezvous) or an
    ``init_method`` URL such as ``file:///path/store``; with none given,
    the ``torchrun`` variables (``env://``).  No-op (returns 0) when no
    coordinator is given and the environment carries no cluster
    configuration -- the single-process case.  ``backend``: ``nccl`` for
    ``device="cuda"`` and ``gloo`` for ``"cpu"`` unless given; a missing
    NCCL raises (there is no silent fall back to gloo)."""
    import torch.distributed as dist

    from ..dsp.cuda_channels import resolve_device

    if distributed():
        return dist.get_rank()
    from_env = all(os.environ.get(k) for k in _TORCHRUN_VARS)
    if coordinator_address is None and num_processes is None and not from_env:
        return 0
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError(
            "NCCL is not available in this PyTorch build; pass "
            "backend='gloo' to move the halos through host memory")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kw = {}
    if num_processes is not None:
        kw = {"world_size": num_processes, "rank": process_id}
    dist.init_process_group(backend, init_method=init_method, **kw)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return dist.get_rank()


def _rank_infos() -> list[RankInfo]:
    """Every rank's RankInfo, gathered from its host name."""
    import socket

    import torch.distributed as dist

    if not distributed():
        return [RankInfo(0, 0, 0)]
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    nodes: dict = {}
    seen: dict = {}
    out = []
    for rank, h in enumerate(hosts):
        node = nodes.setdefault(h, len(nodes))
        out.append(RankInfo(node, seen.get(h, 0), rank))
        seen[h] = seen.get(h, 0) + 1
    return out


def global_devices_host_major(devices=None) -> list[RankInfo]:
    """Ranks ordered (node, local rank), so a 1-D blocks layout keeps
    consecutive blocks on one host (the halo ring crosses hosts only at
    host boundaries).  ``devices``: RankInfo entries to order (default:
    every rank's, gathered from the process group)."""
    devs = [RankInfo(*d) for d in devices] if devices is not None else (
        _rank_infos())
    return sorted(devs)


def global_mesh(devices=None, device="cuda") -> Mesh:
    """1-D ``blocks`` layout over every rank (or the given RankInfo
    entries, which must include this rank), host-major.  A subset of the
    process group gets a group of its own (``new_group``, which every
    rank of the default group must call)."""
    import torch.distributed as dist

    from ..dsp.cuda_channels import resolve_device

    dev = resolve_device(device)
    order = [d.rank for d in global_devices_host_major(devices)]
    if not distributed():
        if order != [0]:
            raise ValueError(f"ranks {order} without a process group")
        return Mesh(dev, ("blocks",), (1,), (0,), (0,))
    if sorted(order) == list(range(dist.get_world_size())):
        group = dist.group.WORLD
    else:
        group = dist.new_group(sorted(order))
    me = dist.get_rank()
    if me not in order:
        raise ValueError(f"rank {me} is not in the layout {order}")
    return Mesh(dev, ("blocks",), (len(order),), (order.index(me),),
                tuple(order), group)


def host_local_paths(paths: list[str], process_id: int | None = None,
                     num_processes: int | None = None) -> list[str]:
    """This rank's share of a capture list (round-robin, so heterogeneous
    file sizes spread evenly) -- the file-level data sharding of the
    multi-host throughput configuration."""
    import torch.distributed as dist

    on = distributed()
    pid = (dist.get_rank() if on else 0) if process_id is None else process_id
    n = (dist.get_world_size() if on else 1) if num_processes is None else (
        num_processes)
    return [p for i, p in enumerate(paths) if i % n == pid]
