"""Logic-analyzer decoder facade of the port: [N, channels] logic capture
in, ISO7816 frames out.

Counterpart of ``nfclab/runtime/logic_decoder.py``.  ``normalize_channel_map``,
``IsoDecoder`` and ``_GrowIdx`` are copies of nfclab's
(tests/test_torch_copies.py holds them to it).  ``StreamingIsoDecoder`` is
ported: with ``frontend="device"`` the event mask comes from
dsp/logic_frontend.logic_event_mask on ``device`` (cuda unless the caller
asks for cpu; no card raises DeviceUnavailable when the decoder is built),
and each feed fetches the mask to the host once, after the device's work
has ended.
"""

from __future__ import annotations

import numpy as np

from ..core.frame import Frame
from ..demod.iso7816 import Iso7816Decoder


def normalize_channel_map(spec, channels: int):
    """Physical-probe-per-role spec -> column permutation into the
    decoder's fixed IO/CLK/RST/VCC = 0/1/2/3 layout (the reference's
    LogicDecoderTask channel-mapping config role).  ``spec`` is None
    (identity), a dict with keys io/clk/rst/vcc (missing keys keep their
    default slot), or a 4-sequence [io, clk, rst, vcc] of physical probe
    indices.  Returns an int index array, or None for identity."""
    if spec is None:
        return None
    if isinstance(spec, dict):
        unknown = set(spec) - {"io", "clk", "rst", "vcc"}
        if unknown:
            raise ValueError(f"unknown channel roles: {sorted(unknown)}")
        order = [int(spec.get("io", 0)), int(spec.get("clk", 1)),
                 int(spec.get("rst", 2)), int(spec.get("vcc", 3))]
    else:
        order = [int(c) for c in spec]
        if len(order) != 4:
            raise ValueError(
                "channel map sequence must be [io, clk, rst, vcc]"
            )
    if len(set(order)) != 4:
        raise ValueError(f"channel map assigns a probe twice: {order}")
    for c in order:
        if not 0 <= c < channels:
            raise ValueError(
                f"channel map probe {c} out of range for {channels} probes"
            )
    rest = [c for c in range(channels) if c not in order]
    perm = np.asarray(order + rest, np.intp)
    if np.array_equal(perm, np.arange(channels)):
        return None
    return perm


class IsoDecoder:
    def __init__(self, enable_iso7816: bool = True, stream_time: float = 0.0,
                 channel_map=None):
        self.enable_iso7816 = enable_iso7816
        self.stream_time = stream_time
        self.channel_map = channel_map

    def decode(self, samples: np.ndarray, sample_rate: int) -> list[Frame]:
        if samples.ndim != 2 or samples.shape[1] < 4:
            raise ValueError("logic decode expects [N, channels>=4] capture")
        if not self.enable_iso7816:
            return []
        perm = normalize_channel_map(self.channel_map, samples.shape[1])
        if perm is not None:
            samples = np.ascontiguousarray(samples[:, perm])
        dec = Iso7816Decoder(sample_rate, self.stream_time)
        return dec.decode(samples)

    def decode_wav(self, path: str) -> list[Frame]:
        from ..io.wav import read_wav

        samples, info = read_wav(path)
        if samples.ndim != 2:
            raise ValueError("logic capture must be multi-channel")
        return self.decode(samples, info.sample_rate)


class _GrowIdx:
    """Append-only int64 index buffer (amortized O(new))."""

    def __init__(self):
        self._buf = np.empty(1024, np.int64)
        self.n = 0

    def append(self, idx: np.ndarray):
        need = self.n + len(idx)
        if len(self._buf) < need:
            new = np.empty(max(need, len(self._buf) * 2), np.int64)
            new[: self.n] = self._buf[: self.n]
            self._buf = new
        self._buf[self.n : need] = idx
        self.n = need

    def view(self) -> np.ndarray:
        return self._buf[: self.n]


class StreamingIsoDecoder:
    """Incremental ISO7816 decode: feed [M, channels] blocks as they arrive
    (the live DSLogic stream case); completed frames return per feed.

    The Iso7816 walker is event-at-a-time with all FSM state on the decoder
    object, so streaming is: grow the dense data/edge buffers, extend the
    event indices over the new tail, rebind, and resume the walk from the
    saved clock.  Feeds are O(block); frames match the one-shot decoder
    (modulo emission order — both sort by sample position).

    ``frontend="device"`` computes each block's event mask on ``device``
    (cuda unless the caller asks for cpu, resolved here: no card raises
    DeviceUnavailable), its edge carry kept there across feeds."""

    def __init__(self, sample_rate: int, channels: int = 4,
                 stream_time: float = 0.0, frontend: str = "host",
                 channel_map=None, device="cuda"):
        from ..demod.iso7816 import Iso7816Decoder

        if channels < 4:
            raise ValueError("logic decode expects channels>=4 (IO/CLK/RST/VCC)")
        if frontend not in ("host", "device"):
            raise ValueError("frontend must be 'host' or 'device'")
        self._dev = None
        if frontend == "device":
            from ..dsp.cuda_channels import resolve_device

            self._dev = resolve_device(device)
        self.sample_rate = sample_rate
        self.channels = channels
        self.frontend = frontend
        self._perm = normalize_channel_map(channel_map, channels)
        self._dec = Iso7816Decoder(sample_rate, stream_time)
        cap = 1 << 16
        self._data = np.empty((cap, channels), np.float32)
        self._edge = np.zeros((cap, channels), np.float32)
        self._n = 0
        self._idx = {k: _GrowIdx() for k in
                     ("io_edges", "io_falls", "line_edges", "clk_falls")}
        self._t = 0
        self._emitted = 0
        self._mask_carry = None  # device-frontend edge carry across feeds

    def feed(self, block: np.ndarray, mask: np.ndarray | None = None
             ) -> list[Frame]:
        """Ingest one [M, channels] block; returns newly completed frames.

        ``mask``: optionally, this block's packed event mask as already
        computed on the device and fetched (dsp/logic_frontend.
        logic_event_mask) — the logic farm batches all streams into one
        dispatch and passes the per-stream host row here."""
        from ..demod.iso7816 import CH_CLK, CH_IO, CH_RST, CH_VCC

        block = np.asarray(block, np.float32)
        if block.ndim != 2 or block.shape[1] != self.channels:
            raise ValueError(f"expected [M, {self.channels}] block")
        if self._perm is not None:
            if mask is not None:
                raise ValueError(
                    "external event masks must be computed over already "
                    "channel-mapped blocks (permute before the device "
                    "dispatch, as TpuLogicFarm does)"
                )
            block = np.ascontiguousarray(block[:, self._perm])
        m = len(block)
        lo, need = self._n, self._n + m
        if len(self._data) < need:
            cap = max(need, len(self._data) * 2)
            for name in ("_data", "_edge"):
                old = getattr(self, name)
                new = np.zeros((cap, self.channels), np.float32)
                new[:lo] = old[:lo]
                setattr(self, name, new)
        self._data[lo:need] = block
        # edge tail (edge[0] stays 0; boundary row uses the previous sample)
        e0 = max(lo, 1)
        self._edge[e0:need] = self._data[e0:need] - self._data[e0 - 1 : need - 1]
        self._n = need

        if mask is not None or self.frontend == "device":
            # edge trigger bits computed on the device, packed one byte
            # per sample; the host derives each index set with a single
            # flatnonzero over the fetched mask (dsp/logic_frontend.py) —
            # edge math is one f32 subtract, bit-identical to the host scan
            from ..dsp.logic_frontend import event_indices, logic_event_mask

            if mask is None:
                mask, self._mask_carry = logic_event_mask(
                    block, self._mask_carry, device=self._dev
                )
                # one blocking copy: it waits for the mask's kernels
                mask = mask.cpu().numpy()
            idx = event_indices(mask, base=lo)
            new_line = idx["line_edges"]
            for name in ("io_edges", "io_falls", "line_edges", "clk_falls"):
                self._idx[name].append(idx[name])
        else:
            tail = self._edge[lo:need]
            new_line = np.union1d(
                np.flatnonzero(tail[:, CH_RST] != 0),
                np.flatnonzero(tail[:, CH_VCC] != 0),
            ) + lo
            self._idx["io_edges"].append(np.flatnonzero(tail[:, CH_IO] != 0) + lo)
            self._idx["io_falls"].append(np.flatnonzero(tail[:, CH_IO] < 0) + lo)
            self._idx["line_edges"].append(new_line)
            self._idx["clk_falls"].append(np.flatnonzero(tail[:, CH_CLK] < 0) + lo)

        dec = self._dec
        dec.bind(
            self._data[: self._n],
            self._edge[: self._n],
            self._n,
            self._idx["io_edges"].view(),
            self._idx["io_falls"].view(),
            self._idx["line_edges"].view(),
            self._idx["clk_falls"].view(),
        )
        dec.emit_line_events(new_line)
        self._t = dec.walk(self._t)

        new = dec.frames[self._emitted :]
        self._emitted = len(dec.frames)
        new.sort(key=lambda f: (f.sample_start, f.sample_end))
        return new

    def finish(self) -> list[Frame]:
        new = self._dec.frames[self._emitted :]
        self._emitted = len(self._dec.frames)
        new.sort(key=lambda f: (f.sample_start, f.sample_end))
        return new
