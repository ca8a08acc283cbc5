"""Temporal (sequence) sharding: overlap-save block decomposition.

Counterpart of ``nfclab/shard/temporal.py``.  A long sample stream is
split along time into blocks with a left warm-up halo sized for the
conditioning chain's state memory plus the longest correlator window.
Blocks are laid out over the ranks of a (stream, time) layout
(shard/mesh.py) as a [stream, time_blocks, span] array; each rank runs its
blocks independently through the dense frontend, and kept regions are
stitched on the host (or consumed rank-local by the event walk).

For the *streaming* case (blocks arriving over time on different ranks),
``halo_exchange`` passes each block's tail to its right neighbour with
point-to-point sends and receives (``torch.distributed.batch_isend_irecv``)
-- the ring halo pattern nfclab runs with ``jax.lax.ppermute``.
"""

from __future__ import annotations

import numpy as np
import torch

# default halo: covers the IIR (~270), mean EMA (~6k) and envelope carrier-on
# memory (~600 updates) plus the longest correlator window + symbol delay;
# see dsp.conditioner for the exactness story (boundary repair)
DEFAULT_HALO = 16384


def overlap_save_blocks(x: np.ndarray, block: int, halo: int = DEFAULT_HALO):
    """Split [T] -> [nb, halo+block] with left halos (edge-padded)."""
    n = len(x)
    nb = max(1, -(-n // block))
    padded = nb * block
    starts = np.arange(nb) * block
    scan_starts = np.maximum(starts - halo, 0)
    pad = np.pad(x, (0, padded + halo - n), mode="edge")
    idx = scan_starts[:, None] + np.arange(block + halo)[None, :]
    return pad[idx], starts, scan_starts


def stitch_blocks(blocks_out: np.ndarray, starts, scan_starts, n: int):
    """Concatenate kept regions [nb, span] -> [T]."""
    block = starts[1] - starts[0] if len(starts) > 1 else blocks_out.shape[1]
    out = np.empty(starts[-1] + block, blocks_out.dtype)
    for b, (s, ss) in enumerate(zip(starts, scan_starts)):
        drop = s - ss
        out[s : s + block] = blocks_out[b, drop : drop + block]
    return out[:n]


def ring_shift(t: torch.Tensor, group=None, ring=None,
               step: int = 1) -> torch.Tensor:
    """Send ``t`` to the rank ``step`` places on along the ring and return
    the tensor received from the rank ``step`` places back.

    ``ring``: the global ranks of ``group`` in ring order, required with a
    group.  With no process group, or one rank on the ring, this is a
    local copy of ``t`` -- what ``ppermute`` over a one-device axis
    returns.  Both operations go in one ``batch_isend_irecv``, so every
    rank posts its send and its receive together and the ring cannot
    deadlock.  A ``gloo`` group moves a CUDA tensor through host memory
    (gloo's point-to-point operations take CPU tensors); the result lands
    on ``t``'s device."""
    import torch.distributed as dist

    t = t.contiguous()
    if group is None:
        return t.clone()
    if ring is None:
        raise ValueError("ring_shift over a process group needs its ring "
                         "of global ranks")
    n = len(ring)
    if n == 1:
        return t.clone()
    me = ring.index(dist.get_rank())
    dst, src = ring[(me + step) % n], ring[(me - step) % n]
    send = t.cpu() if t.is_cuda and dist.get_backend(group) == "gloo" else t
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group=group),
           dist.P2POp(dist.irecv, recv, src, group=group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(t.device)


def halo_exchange(x: torch.Tensor, halo: int, group=None,
                  ring=None) -> torch.Tensor:
    """Send each rank's tail ``x[..., -halo:]`` to its right neighbour on
    the ring (``ring_shift``); returns the left halo received from the
    left neighbour (this rank's own tail with no process group)."""
    return ring_shift(x[..., -halo:], group, ring, 1)


def sharded_frontend_step(mesh, sample_rate: int):
    """Build the sharded dense frontend step: this rank's [B, NT, span]
    block of a (stream, time) layout (shard/mesh.py) -> the frontend's
    outputs, [B, NT, span] each, on the mesh's device.

    The frontend is elementwise / a scan along the last (span) axis, so
    each rank's step is local and no collective runs: halos were
    materialized into the span axis up front (overlap-save), trading
    ``halo/block`` work for no traffic between ranks.  The conditioning is
    dsp/conditioner_kernel.condition_scan (the CUDA kernel on the card)."""
    from ..core.params import SignalParams
    from ..dsp.frontend import make_frontend

    frontend = make_frontend(SignalParams(sample_rate), device=mesh.device)

    def step(blocks):  # [B, NT, span]
        blocks = torch.as_tensor(blocks, device=mesh.device)
        b, nt, span = blocks.shape
        out = frontend(blocks.reshape(b * nt, span))
        return {k: v.reshape(b, nt, span) for k, v in out.items()}

    return step
