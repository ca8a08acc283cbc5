"""Radio decoder facade: magnitude samples in, frames out.

TPU-native equivalent of ``lab::NfcDecoder`` (NfcDecoder.cpp:292-523): the
dense per-sample work (conditioning, correlators) is array-parallel; the host
walks sparse events.  The main loop mirrors NfcDecoder.cpp:374-467: carrier
detection + per-tech modulation detection until a tech locks, then that tech's
frame decode until it unlocks.
"""

from __future__ import annotations

import numpy as np

from ..core.frame import Frame, FramePhase, FrameTech, FrameType
from ..core.params import SignalParams
from ..core.thresholds import DecoderThresholds
from ..demod.common import next_true
from ..demod.nfca import NfcATech
from ..dsp.channels import LazyChannels


class DecoderContext:
    """Mirror of NfcDecoderStatus (NfcTech.h:317-393) over dense arrays."""

    def __init__(self, cond, sample_rate: int, params: SignalParams,
                 stream_time=0.0, thresholds: DecoderThresholds | None = None):
        self.cond = cond
        self.channels = LazyChannels(cond)
        self.sample_rate = sample_rate
        self.params = params
        self.thresholds = thresholds or DecoderThresholds()
        self.stream_time = stream_time
        self.n = len(cond.value)
        self.power_level_threshold = np.float32(params.power_level_threshold)
        self.frames: list[Frame] = []
        # lock state
        self.bitrate = None
        self.modulation = None
        self.locked_tech = None

    # precomputed power-ok crossing indices for event scheduling
    # (extension-aware: the streaming decoder re-reads after each feed).
    # Run starts only — power-ok is densely true under carrier, so the next
    # power-ok clock >= t is t itself when envelope[t] passes, else the next
    # run start.
    @property
    def _power_idx(self):
        return self.channels.crossing_idx(
            "envelope", self.power_level_threshold, ">="
        )

    def next_power_ok(self, t: int) -> int | None:
        if t < self.n and self.cond.envelope[t] >= self.power_level_threshold:
            return t
        idx = self._power_idx
        i = np.searchsorted(idx, t)
        if i >= len(idx):
            return None
        return int(idx[i])


class CarrierDetector:
    """Carrier presence events (NfcDecoder.cpp:472-523).

    State changes only at hysteresis crossings of the signal average, so the
    walker visits only candidate crossing samples.  Timestamps come from the
    carrier edge tracker (conditioned arrays edge_peak/edge_time), emulating
    the carrierEdgeTime consume-and-clear semantics.
    """

    def __init__(self, ctx: DecoderContext):
        self.carrier_on_time = 0
        self.carrier_off_time = 0
        # last time carrierEdgeTime was consumed+cleared by an event
        self._edge_cleared_at = 0
        self._ni_cache = None
        self.bind(ctx)

    def bind(self, ctx: DecoderContext):
        """(Re)compute crossing masks from the current context; FSM state is
        untouched (streaming rebind)."""
        self.ctx = ctx
        p = ctx.params
        self._high_thr = np.float32(p.signal_high_threshold)
        self._low_thr = np.float32(p.signal_low_threshold)
        # run-start crossings only (O(events)); _next_interesting_compute
        # pairs them with a direct test at the query clock
        self._above_idx = ctx.channels.crossing_idx(
            "average", self._high_thr, ">"
        )
        self._below_idx = ctx.channels.crossing_idx(
            "average", self._low_thr, "<"
        )
        self._ni_cache = None

    def next_interesting(self, t: int) -> int | None:
        c = self._ni_cache
        state = (self.carrier_on_time, self.carrier_off_time)
        if c is not None and c[0] == state and c[1] <= t:
            if c[2] is None or c[2] >= t:
                return c[2]
        val = self._next_interesting_compute(t)
        self._ni_cache = (state, t, val)
        return val

    def _next_interesting_compute(self, t: int) -> int | None:
        avg = self.ctx.cond.average
        in_stream = t < self.ctx.n
        cands = []
        if not self.carrier_on_time:
            if in_stream and avg[t] > self._high_thr:
                cands.append(t)
            else:
                i = np.searchsorted(self._above_idx, t)
                if i < len(self._above_idx):
                    cands.append(int(self._above_idx[i]))
        if not self.carrier_off_time:
            if in_stream and avg[t] < self._low_thr:
                cands.append(t)
            else:
                i = np.searchsorted(self._below_idx, t)
                if i < len(self._below_idx):
                    cands.append(int(self._below_idx[i]))
        return min(cands) if cands else None

    def _edge_or_clock(self, t: int) -> int:
        edge = int(self.ctx.cond.edge_time[t])
        # the conditioner stores carrierEdgeTime as u32; reconstruct the full
        # clock (largest value <= t congruent mod 2^32) so unbounded live
        # streams survive the wrap at ~2^32 samples.  edge == 0 stays the
        # no-edge sentinel (a real edge congruent to 0 is vanishingly rare
        # and only costs a timestamp falling back to the clock).
        if edge != 0 and t >= (1 << 32):
            edge = t - ((t - edge) & 0xFFFFFFFF)
        # carrierEdgeTime was cleared at the last event; only a newer peak
        # update counts (NfcDecoder.cpp:479,495,504,520)
        if edge > self._edge_cleared_at or (edge != 0 and self._edge_cleared_at == 0):
            return edge
        return t

    def step(self, t: int):
        ctx = self.ctx
        if ctx.cond.average[t] > self._high_thr:
            if not self.carrier_on_time:
                self.carrier_on_time = self._edge_or_clock(t)
                self._emit(t, FrameType.NfcCarrierOn, self.carrier_on_time)
                self.carrier_off_time = 0
                self._edge_cleared_at = t
        elif ctx.cond.average[t] < self._low_thr:
            if not self.carrier_off_time:
                self.carrier_off_time = self._edge_or_clock(t)
                self._emit(t, FrameType.NfcCarrierOff, self.carrier_off_time)
                self.carrier_on_time = 0
                self._edge_cleared_at = t

    def _emit(self, t: int, ftype: FrameType, when: int):
        ctx = self.ctx
        f = Frame(
            tech_type=int(FrameTech.NfcAnyTech),
            frame_type=int(ftype),
            frame_phase=int(FramePhase.NfcCarrierPhase),
            sample_start=when,
            sample_end=when,
            sample_rate=ctx.sample_rate,
        )
        f.time_start = when / ctx.sample_rate
        f.time_end = f.time_start
        f.date_time = ctx.stream_time + f.time_start
        ctx.frames.append(f)


class NfcDecoder:
    """One-shot decoder over a full magnitude capture."""

    def __init__(
        self,
        enable_nfca: bool = True,
        enable_nfcb: bool = True,
        enable_nfcf: bool = True,
        enable_nfcv: bool = True,
        power_level_threshold: float = 0.01,
        stream_time: float = 0.0,
        conditioner: str = "native",
        debug: bool = False,
        debug_path: str | None = None,
        thresholds: DecoderThresholds | None = None,
    ):
        self.enable_nfca = enable_nfca
        self.enable_nfcb = enable_nfcb
        self.enable_nfcf = enable_nfcf
        self.enable_nfcv = enable_nfcv
        self.power_level_threshold = power_level_threshold
        self.stream_time = stream_time
        self.conditioner = conditioner
        self.debug = debug
        self.debug_path = debug_path
        self.thresholds = thresholds or DecoderThresholds()

    # per-tech tuning setters (NfcDecoder.h:79-117 parity); min/max apply
    # together, like the reference facade signature
    def set_modulation_threshold_nfca(self, lo: float, hi: float):
        self.thresholds.nfca.min_modulation_deep = float(lo)
        self.thresholds.nfca.max_modulation_deep = float(hi)

    def set_modulation_threshold_nfcb(self, lo: float, hi: float):
        self.thresholds.nfcb.min_modulation_deep = float(lo)
        self.thresholds.nfcb.max_modulation_deep = float(hi)

    def set_modulation_threshold_nfcf(self, lo: float, hi: float):
        self.thresholds.nfcf.min_modulation_deep = float(lo)
        self.thresholds.nfcf.max_modulation_deep = float(hi)

    def set_modulation_threshold_nfcv(self, lo: float, hi: float):
        self.thresholds.nfcv.min_modulation_deep = float(lo)
        self.thresholds.nfcv.max_modulation_deep = float(hi)

    def set_correlation_threshold_nfca(self, value: float):
        self.thresholds.nfca.correlation = float(value)

    def set_correlation_threshold_nfcb(self, value: float):
        self.thresholds.nfcb.correlation = float(value)

    def set_correlation_threshold_nfcf(self, value: float):
        self.thresholds.nfcf.correlation = float(value)

    def set_correlation_threshold_nfcv(self, value: float):
        self.thresholds.nfcv.correlation = float(value)

    def _condition(self, samples: np.ndarray, params: SignalParams):
        if self.conditioner == "native":
            from ..native import condition_exact

            return condition_exact(samples, params)
        if self.conditioner == "jax":
            from ..dsp.conditioner import condition_jax

            return condition_jax(samples, params)
        raise ValueError(f"unknown conditioner {self.conditioner!r}")

    def _make_techs(self, ctx: DecoderContext) -> list:
        techs = []
        if self.enable_nfca:
            techs.append(NfcATech(ctx))
        if self.enable_nfcb:
            from ..demod.nfcb import NfcBTech

            techs.append(NfcBTech(ctx))
        if self.enable_nfcf:
            from ..demod.nfcf import NfcFTech

            techs.append(NfcFTech(ctx))
        if self.enable_nfcv:
            from ..demod.nfcv import NfcVTech

            techs.append(NfcVTech(ctx))
        return techs

    def decode(
        self, samples: np.ndarray, sample_rate: int, cond=None,
        tpu_channels=None,
    ) -> list[Frame]:
        """Decode a full capture; returns frames in emission order
        (carrier + poll + listen; filter by type for golden comparison).
        `cond` may carry precomputed conditioning (the batch API runs the
        TPU pass once for many captures, then walks each on host).
        `tpu_channels` may carry device-computed correlator channels from
        the fused Pallas frontend (dsp.tpu_channels.fused_capture_channels);
        they are preloaded into the channel cache so the walk consumes them
        instead of recomputing on the host."""
        params = SignalParams(
            sample_rate, power_level_threshold=self.power_level_threshold
        )
        if cond is None:
            cond = self._condition(samples, params)
        ctx = DecoderContext(
            cond, sample_rate, params, self.stream_time,
            thresholds=self.thresholds,
        )
        if tpu_channels is not None:
            from ..dsp.cuda_channels import preload_channels

            preload_channels(
                ctx.channels, tpu_channels, sample_rate,
                self.power_level_threshold, thresholds=self.thresholds,
            )
        # build every box channel an ENABLED tech will bind in one fused
        # native pass (independent f64 chains interleave; per-tech lazy
        # builds would run them serially, each chain-latency-bound) — no-op
        # for entries a device frontend already preloaded.  bv consumers:
        # A = every A-rate period2, F = the 212/424k subset, V = its own
        # period2; B binds no box channel.
        from ..core.params import nfca_bitrates
        from ..demod.nfcv import nfcv_bitrate

        bra = nfca_bitrates(sample_rate)
        widths: set[int] = set()
        if self.enable_nfca:
            widths.update(br.period2 for br in bra)
        if self.enable_nfcf:
            widths.update(br.period2 for br in bra[1:])
        if self.enable_nfcv:
            widths.add(nfcv_bitrate(sample_rate).period2)
        ctx.channels.warm_boxes([("bv", w) for w in sorted(widths)])
        carrier = CarrierDetector(ctx)
        techs = self._make_techs(ctx)
        for tech in techs:
            tech.initialize()

        if self.debug:
            # 10-channel internal-signal tap (NfcTech.h:47-126 parity)
            from ..dsp.debugtap import write_radio_debug

            sd = []
            for tech in techs:
                fn = getattr(tech, "debug_sd_channels", None)
                if fn is not None:
                    sd.extend(fn())
            write_radio_debug(cond, sd, sample_rate, self.debug_path)

        walk(ctx, carrier, techs, 0)
        return ctx.frames

    def decode_wav(self, path: str) -> list[Frame]:
        from ..io.wav import read_wav

        samples, info = read_wav(path)
        if samples.ndim != 1:
            raise ValueError("radio decode expects mono magnitude capture")
        return self.decode(samples, info.sample_rate)

    @classmethod
    def from_config(cls, config) -> "NfcDecoder":
        """Build from a runtime.config.Config tree (the Configure-command
        merge-patch surface of RadioDecoderTask.cpp:207-366): per-tech
        enables + correlationThreshold + minimumModulationDeep/
        maximumModulationDeep pairs merge onto the reference defaults."""
        proto = config.get("decoder.protocol", {}) or {}
        return cls(
            enable_nfca=proto.get("nfca", {}).get("enabled", True),
            enable_nfcb=proto.get("nfcb", {}).get("enabled", True),
            enable_nfcf=proto.get("nfcf", {}).get("enabled", True),
            enable_nfcv=proto.get("nfcv", {}).get("enabled", True),
            power_level_threshold=config.get(
                "decoder.powerLevelThreshold", 0.01
            ),
            debug=config.get("decoder.debugEnabled", False),
            thresholds=DecoderThresholds.from_protocol_config(proto),
        )


def _native_detect_available(techs) -> bool:
    try:
        from ..native.binding import native_available

        if not native_available():
            return False
    except Exception:
        return False
    return all(
        type(te).__name__ in ("NfcATech", "NfcBTech", "NfcFTech", "NfcVTech")
        for te in techs
    )


def walk(ctx, carrier, techs, t: int) -> int:
    """Run the main decode loop (NfcDecoder.cpp:374-467 structure) from
    clock t until the stream is exhausted of events; returns the clock to
    resume from when more samples arrive (streaming)."""
    n = ctx.n
    use_native = _native_detect_available(techs)
    while t < n:
        if ctx.modulation is not None:
            t = ctx.locked_tech.decode_run(t - 1) + 1
            continue

        if use_native:
            # full native detect walk: stops at carrier crossings / locks,
            # which are then re-executed exactly in Python
            from .native_walk import run_native_detect_all

            u = run_native_detect_all(ctx, carrier, techs, t, n)
            if u >= n:
                t = n
                break
            carrier.step(u)
            locked = None
            for te in techs:
                if te.detect_step(u):
                    locked = te
                    break
            if locked is not None:
                t = locked.decode_run(u) + 1
            else:
                t = u + 1
            continue

        # techs in bounded mid-search phases must be stepped per sample;
        # the rest contribute scheduled/mask events only
        dirty = [te for te in techs if te.is_dirty()]
        dirty_ids = {id(te) for te in dirty}
        cands = []
        c = carrier.next_interesting(t)
        if c is not None:
            cands.append(c)
        for te in techs:
            if id(te) not in dirty_ids:
                c = te.next_interesting(t)
                if c is not None:
                    cands.append(c)
        if cands:
            tn = min(cands)
        elif dirty:
            tn = n - 1
        else:
            break
        if tn >= n:
            tn = n - 1

        locked = None
        if dirty:
            # fine-step only the dirty techs through (t, tn); clean techs
            # provably have no state changes in this span
            u = t
            if u < tn and all(
                type(te).__name__ in ("NfcBTech", "NfcFTech", "NfcVTech")
                for te in dirty
            ):
                # native span stepper: returns either tn (span done) or the
                # first sample needing Python handling (which re-executes it)
                from .native_walk import run_native_span

                u = run_native_span(ctx, dirty, u, tn)
            while u < tn and locked is None:
                for te in techs:
                    if id(te) in dirty_ids and te.detect_step(u):
                        locked = te
                        break
                if locked is None:
                    u += 1
            if locked is None:
                carrier.step(tn)
                for te in techs:
                    if te.detect_step(tn):
                        locked = te
                        break
                u = tn
        else:
            carrier.step(tn)
            for te in techs:
                if te.detect_step(tn):
                    locked = te
                    break
            u = tn

        if locked is not None:
            t = locked.decode_run(u) + 1
        else:
            t = u + 1
    return t
