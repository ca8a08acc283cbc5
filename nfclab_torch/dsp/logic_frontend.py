"""Device-side logic-analyzer frontend of the port: per-channel edges and
the packed event mask, in torch on the stream's device.

Counterpart of ``nfclab/dsp/logic_frontend.py``.  The ISO7816 walker
(demod/iso7816.py) only visits sparse events -- IO edges, RST/VCC line
edges, CLK falling edges -- so the device packs those trigger bits into
one byte per sample and the host derives each event index set with a
single ``flatnonzero`` (``event_indices``).

Mask bits:
  1  IO edge     (edge[CH_IO]  != 0)   -> Iso7816 ``io_edges``
  2  IO fall     (edge[CH_IO]  <  0)   -> ``io_falls``
  4  line edge   (edge[CH_RST] != 0 or edge[CH_VCC] != 0) -> ``line_edges``
  8  CLK fall    (edge[CH_CLK] <  0)   -> ``clk_falls``

The edge is one float32 subtract, ``x[t] - x[t - 1]``, as nfclab's, so the
bits equal nfclab's and the host scans' bit for bit (``-0.0 != 0`` is
false, a NaN edge is an edge and no fall).  The carry is the previous
chunk's last sample row ``[..., 1, C]``; ``carry=None`` (stream start)
gives edge 0 at t=0.  Unlike nfclab's, a zero-width block returns the
carry it was given (nfclab returns an empty carry, and its next call
raises: ROADMAP Queue 3).

``MASK_*``, ``MASK_LAYOUT`` and ``event_indices`` are copies of nfclab's
(tests/test_torch_copies.py holds them to it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..demod.iso7816 import CH_CLK, CH_IO, CH_RST, CH_VCC

MASK_IO_EDGE = 1
MASK_IO_FALL = 2
MASK_LINE_EDGE = 4
MASK_CLK_FALL = 8

# mask bit -> StreamingIsoDecoder index-set name
MASK_LAYOUT = (
    ("io_edges", MASK_IO_EDGE),
    ("io_falls", MASK_IO_FALL),
    ("line_edges", MASK_LINE_EDGE),
    ("clk_falls", MASK_CLK_FALL),
)


def _edge(block: torch.Tensor, carry: torch.Tensor, ch: int) -> torch.Tensor:
    """Channel ch's edge [..., T]: x[t] - x[t - 1], x[-1] from the carry."""
    x = block[..., ch]
    e = torch.empty_like(x)
    torch.sub(x[..., 1:], x[..., :-1], out=e[..., 1:])
    torch.sub(x[..., :1], carry[..., ch], out=e[..., :1])
    return e


def logic_event_mask(block, carry=None, device="cuda"):
    """The packed per-sample event mask of one logic chunk.

    block: [T, C] or [B, T, C] float32 levels (C >= 4, IO/CLK/RST/VCC
    layout per demod/iso7816.CH_*); a numpy array goes to ``device``
    (resolve_device: no card raises DeviceUnavailable), a tensor runs where
    it lies.  carry: what the previous call for this stream returned, a
    numpy array of the same shape (a stream's state from nfclab:
    ``np.asarray(jax_carry)``) or None at stream start.

    Returns (mask, carry) on the block's device: mask uint8 [T] / [B, T],
    carry [..., 1, C] float32 for the next chunk.  Each channel's edge is
    built in turn, so the work space is one float32 channel and a few
    bytes a sample, not nfclab's [..., T, C] ``prev`` and int32 sum."""
    if isinstance(block, torch.Tensor):
        block = block.to(torch.float32)
    else:
        from .cuda_channels import resolve_device

        block = torch.as_tensor(np.asarray(block, np.float32),
                                device=resolve_device(device))
    if block.shape[-2] == 0:
        mask = torch.empty(block.shape[:-1], dtype=torch.uint8,
                           device=block.device)
        return mask, carry
    if carry is None:
        carry = block[..., :1, :]
    else:
        if not isinstance(carry, torch.Tensor):  # a copy: it may be read-only
            carry = torch.from_numpy(np.array(carry, np.float32))
        carry = carry.to(block.device, torch.float32)
    e = _edge(block, carry, CH_IO)
    mask = (e != 0).to(torch.uint8)
    mask.add_(e < 0, alpha=MASK_IO_FALL)
    e = _edge(block, carry, CH_RST)
    line = e != 0
    e = _edge(block, carry, CH_VCC)
    line |= e != 0
    mask.add_(line, alpha=MASK_LINE_EDGE)
    e = _edge(block, carry, CH_CLK)
    mask.add_(e < 0, alpha=MASK_CLK_FALL)
    return mask, block[..., -1:, :].clone()


def event_indices(mask: np.ndarray, base: int = 0) -> dict[str, np.ndarray]:
    """Host-side unpack: mask [T] -> the four sorted event index sets the
    ISO7816 walker binds, offset by ``base`` (the chunk's absolute start)."""
    bits = np.asarray(mask)
    return {
        name: np.flatnonzero(bits & bit).astype(np.int64) + base
        for name, bit in MASK_LAYOUT
    }
