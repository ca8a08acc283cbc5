"""Incremental streaming radio decoder: bounded-latency live decode.

The reference decodes live streams buffer-by-buffer with carried state
(NfcDecoder.cpp:374-442).  Here:

- conditioning runs per block through the native carry-state kernel
  (`nfclab_condition_stream`) — exact continuation of the sequential scan —
  and the outputs are appended into growable capacity buffers (amortized
  O(block), no per-feed concatenation);
- the dense channel/mask arrays extend themselves over only the new samples
  (LazyChannels is extension-aware with native f64 carries; `rebind` +
  `bind_channels` per feed cost O(block));
- the event walker resumes from its saved clock (`runtime.decoder.walk`
  returns the resume position, and every FSM already treats end-of-array as
  "wait for more samples");
- with ``window=N`` the decoder keeps only the trailing N..2N samples of
  every dense array: all FSM state and event indices stay in absolute
  stream clocks, buffers are compacted by a memmove, channel caches shift
  their windows in lockstep (`LazyChannels.rebind`), and native kernels
  address the windows through virtual pointers — so an unbounded live
  stream decodes in O(block) time AND O(window) memory (and, since the
  window's pages stay resident, without fresh page faults).

Frames are emitted as soon as their final symbol lands.
"""

from __future__ import annotations

import numpy as np

from ..core.frame import Frame, FramePhase, FrameTech, FrameType
from ..core.params import SignalParams
from ..native.binding import Conditioned, alloc_array, new_stream_state
from .decoder import CarrierDetector, DecoderContext, NfcDecoder, walk

_KEYS = (
    "value",
    "envelope",
    "filtered",
    "deviation",
    "average",
    "mod_depth",
    "edge_peak",
    "edge_time",
)


class StreamingNfcDecoder:
    """window: keep only the trailing `window`..2*`window` samples of every
    dense array (None = unbounded).  Must exceed the longest decode
    lookback — frame-waiting windows reach ~37 ms (370k samples at
    10 MS/s), so the default when enabled should be >= 2**20."""

    def __init__(self, sample_rate: int, window: int | None = None,
                 slack: int = 3, **decoder_kwargs):
        if window is not None and window < (1 << 16):
            raise ValueError(
                "window must be >= 65536 samples (and must exceed the "
                "protocol frame-waiting lookback, ~370k at 10 MS/s, for "
                "correct decode)"
            )
        if slack < 2:
            raise ValueError("slack must be >= 2 (compaction keeps a full "
                             "window of history behind the stream end)")
        self.sample_rate = sample_rate
        self.window = window
        self.slack = slack
        self.params = SignalParams(
            sample_rate,
            power_level_threshold=decoder_kwargs.get(
                "power_level_threshold", 0.01
            ),
        )
        self._proto = NfcDecoder(**decoder_kwargs)
        self._state = new_stream_state()
        cap = 1 << 17
        self._bufs = {
            k: alloc_array(cap, np.uint32 if k == "edge_time" else np.float32)
            for k in _KEYS
        }
        self._n = 0
        self._base = 0
        self._ctx: DecoderContext | None = None
        self._carrier: CarrierDetector | None = None
        self._techs: list | None = None
        self._t = 0
        self._finished = False

    @property
    def n(self) -> int:
        return self._n

    @property
    def base(self) -> int:
        return self._base

    def _compact(self):
        """Advance the window base, keeping `window` samples behind both the
        stream end and the walker clock (absolute clocks never change).
        Buffers hold up to `slack` windows before compacting (default 4):
        each compaction copies ~window samples across every dense array
        (~100 B/sample of memmove traffic if triggered every window), so
        extra slack cuts that steady-state cost proportionally for a modest
        memory bump."""
        W = self.window
        if not W or (self._n - self._base) <= self.slack * W:
            return
        new_base = min(self._n - W, self._t - W)
        if new_base <= self._base:
            return
        # bring box running sums current while their inputs are still inside
        # the old window (an entry lagging a full window would otherwise read
        # below the new base after the shift)
        if self._ctx is not None:
            self._ctx.channels.extend_boxes()
        shift = new_base - self._base
        keep = self._n - new_base
        for k in _KEYS:
            buf = self._bufs[k]
            buf[:keep] = buf[shift : shift + keep]
        self._base = new_base

    def _view(self) -> Conditioned:
        from ..core.streamview import StreamView

        filled = self._n - self._base
        if self._base == 0:
            return Conditioned(*[self._bufs[k][:filled] for k in _KEYS])
        return Conditioned(
            *[StreamView(self._bufs[k][:filled], self._base) for k in _KEYS]
        )

    def _warm_channels(self, ctx):
        """Pre-create every decode channel entry so window shifts never meet
        a fresh entry (box running sums must extend continuously)."""
        if not self.window:
            return
        ch = ctx.channels
        for tech in self._techs:
            name = type(tech).__name__
            if name == "NfcATech":
                for br in tech.bitrates:
                    ch.box_sq(br.period2)
                    ch.corr_s0_dense(br)
                for br in tech.bitrates[1:]:
                    ch.bpsk_dense(br)
            elif name == "NfcFTech":
                for br in tech.bitrates:
                    ch.box_value(br.period2)
            elif name == "NfcVTech":
                ch.nfcv_listen_dense(tech.bitrate)
        # NFC-B listen BPSK channels (rates 106k/212k share A's bitrate set)
        for tech in self._techs:
            if type(tech).__name__ == "NfcBTech":
                for br in tech.bitrates[:2]:
                    ch.bpsk_dense(br)

    def _ensure_capacity(self, m: int):
        need = self._n + m - self._base
        if len(self._bufs["value"]) < need:
            steady = self.slack * (self.window or 0) + (1 << 17)
            if self.window and need <= steady:
                # windowed steady state: one right-sized allocation
                # (compaction keeps the filled span under slack*window + feed)
                cap = steady
            else:
                # unbounded, or the walker stalled past the window: grow
                # geometrically so repeated growth stays amortized O(1)
                cap = max(need, len(self._bufs["value"]) * 2)
            filled = self._n - self._base
            for k in _KEYS:
                new = alloc_array(
                    cap, np.uint32 if k == "edge_time" else np.float32
                )
                new[:filled] = self._bufs[k][:filled]
                self._bufs[k] = new

    def feed(self, block: np.ndarray) -> list[Frame]:
        """Condition + decode one block; returns newly completed frames."""
        assert not self._finished, "stream already finished"
        self._compact()
        block = np.ascontiguousarray(block, np.float32)
        self._ensure_capacity(len(block))
        # condition directly into the stream buffers (no per-block outputs)
        from ..native.binding import condition_stream_into

        m = condition_stream_into(
            block, self.params, self._state, self._bufs, self._n - self._base
        )
        self._n += m
        return self._advance()

    def finish(self) -> list[Frame]:
        """Flush: emits the final carrier-state frame the reference produces
        on the in-band EOF buffer (NfcDecoder.cpp:448-463)."""
        out = self._advance() if self.n else []
        if not self._finished and self._ctx is not None:
            self._finished = True
            carrier_on = self._carrier.carrier_on_time if self._carrier else 0
            f = Frame(
                tech_type=int(FrameTech.NfcAnyTech),
                frame_type=int(
                    FrameType.NfcCarrierOn if carrier_on else FrameType.NfcCarrierOff
                ),
                frame_phase=int(FramePhase.NfcCarrierPhase),
                sample_start=self.n - 1,
                sample_end=self.n - 1,
                sample_rate=self.sample_rate,
            )
            f.time_start = (self.n - 1) / self.sample_rate
            f.time_end = f.time_start
            self._ctx.frames.append(f)
            out = out + [f]
        return out

    def _install_external(self, ctx, first: bool) -> None:
        """Hook for subclasses that feed externally computed channel-cache
        entries (e.g. kernel detect masks): called after the channel cache
        exists/rebinds and BEFORE extend_all()/walk, so injected entries are
        already current when the lazy extension pass runs."""

    def _advance(self) -> list[Frame]:
        full = self._view()

        if self._ctx is None:
            ctx = DecoderContext(
                full, self.sample_rate, self.params,
                self._proto.stream_time, thresholds=self._proto.thresholds,
            )
            self._ctx = ctx
            if self.window:
                # channel buffers reach slack*window + one feed at steady
                # state; allocating that up front avoids doubling-growth
                # copies
                ctx.channels.capacity_hint = (
                    self.slack * self.window + (1 << 17)
                )
            self._install_external(ctx, first=True)
            self._carrier = CarrierDetector(ctx)
            self._techs = self._proto._make_techs(ctx)
            for tech in self._techs:
                tech.initialize()
            self._warm_channels(ctx)
        else:
            ctx = self._ctx
            ctx.cond = full
            ctx.n = len(full.value)  # absolute stream end
            # channel cache extends over only the new tail (O(block)) and
            # shifts its windows when the base advanced
            ctx.channels.rebind(full, self._base)
            self._install_external(ctx, first=False)
            # one fused native pass brings every channel current (box sums,
            # derived channels, index scans) — the per-getter lazy extends
            # below then cost nothing
            ctx.channels.extend_all()
            self._carrier.bind(ctx)
            for tech in self._techs:
                tech.bind_channels()

        before = len(ctx.frames)
        self._t = walk(ctx, self._carrier, self._techs, self._t)
        new = ctx.frames[before:]
        return new
