"""The generator of the NFC radio mixes (``"generator": "synth"``).

It turns a mix's parameters, a seed and a stream count into looped
magnitude streams at 10 MS/s and the table of every frame it wrote; its
``judge`` is ``check.judge_frames``.

Each stream loops one period: a round of the mix's templates (whole
poll/listen transactions, each template starting and ending on steady
carrier, so every join is clean) in an order drawn for that stream,
then ``field_off_samples`` with the field off; where the field goes
off, the period starts with ``field_on_guard_samples`` of steady
carrier, the wait a reader keeps after switching its field on before
the first command (ISO/IEC 14443-3: at least 5 ms).  Each stream draws its
own gain, offset (on the carrier) and noise.  Every seed gives the same
templates, the same period length and the same frames, in another
order with other gain, offset and noise, so two seeds ask for the same
work.

The templates are those of ``tests/torch_synth.py`` at its seed 7,
rebuilt from the frozen writers beside this module, with the bounds of
each frame noted as it is written; the 424k BPSK listen's preamble is
two slots shorter (see ``templates``).  Nothing here imports the program.
"""

from __future__ import annotations

import typing

import numpy as np

from ..check import CARRIER_OFF, CARRIER_ON, LISTEN, POLL, TECH
from ..check import judge_frames as judge  # noqa: F401  (the interface)
from .crc import crc16_ccitt

RATE = 10_000_000     # the rate the frozen writers write


def crc_a(data: bytes) -> bytes:
    v = crc16_ccitt(data, 0, len(data), 0x6363, True)
    return bytes((v & 0xFF, (v >> 8) & 0xFF))


def crc_b(data: bytes) -> bytes:
    v = (~crc16_ccitt(data, 0, len(data), 0xFFFF, True)) & 0xFFFF
    return bytes((v & 0xFF, (v >> 8) & 0xFF))


def crc_f(data: bytes) -> bytes:
    v = crc16_ccitt(data, 0, len(data), 0x0000, False)
    return bytes(((v >> 8) & 0xFF, v & 0xFF))


class RefFrame(typing.NamedTuple):
    tech: int        # TECH code
    kind: int        # POLL or LISTEN
    data: bytes
    start: int       # first sample the frame's symbols occupy
    end: int         # sample after its last symbol


class Template(typing.NamedTuple):
    name: str
    samples: np.ndarray
    frames: list     # RefFrame, in template coordinates


def _cursor(w) -> int:
    """Where a writer's next symbol starts."""
    if hasattr(w, "chunks"):
        return sum(len(c) for c in w.chunks)
    if hasattr(w, "_pauses"):          # A424Writer: float cursor
        return int(round(w._w))
    return int(w.n)                    # VPollWriter


def _payloads(rng, n, lo=2, hi=8):
    return [bytes(rng.integers(0, 256, int(rng.integers(lo, hi))).tolist())
            for _ in range(n)]


def templates(seed: int = 7) -> dict:
    """The five templates of tests/torch_synth.py (same writers, same
    draws), with each frame's bounds: {name: Template}."""
    from .nfca_bpsk_synth import A424Writer
    from .nfca_synth import ListenWriter
    from .nfcb_synth import BListenWriter
    from .nfcf_synth import FPollWriter
    from .nfcv_synth import VListenWriter

    rng = np.random.default_rng(seed)
    out = {}

    def poll(w, tech, data, frames):
        a = _cursor(w)
        w.frame(data)
        frames.append(RefFrame(TECH[tech], POLL, data, a, _cursor(w)))

    def listen(w, tech, data, frames, delay, **kw):
        a = _cursor(w) + delay
        w.listen_frame(data, delay=delay, **kw)
        frames.append(RefFrame(TECH[tech], LISTEN, data, a, _cursor(w)))

    bpsk = A424Writer(rate_type=2)
    # the TR1 preamble in the middle of the decoder's 3..4-etu (106k)
    # start-of-frame window: the test writer's 16 slots sit on its upper
    # edge, where noise of 2e-4 drops 0.6% of the listen frames (in the
    # port and in nfclab alike); 13-15 slots drop none of 1,500
    bpsk.preamble_slots = 14
    for name, writer, delay in (("nfca_106k", ListenWriter(), 900),
                                ("nfca_424k_bpsk", bpsk, 900)):
        frames = []
        for pp, rp in zip(_payloads(rng, 2), _payloads(rng, 2)):
            poll(writer, "nfca", pp + crc_a(pp), frames)
            listen(writer, "nfca", rp + crc_a(rp), frames, delay)
            writer.gap()
        out[name] = Template(name, writer.build(), frames)

    w, frames = BListenWriter(), []
    pp, rp = _payloads(rng, 2)
    poll(w, "nfcb", pp + crc_b(pp), frames)
    listen(w, "nfcb", rp + crc_b(rp), frames, 2000)
    w.gap(4096)
    out["nfcb"] = Template("nfcb", w.build(), frames)

    w, frames = FPollWriter(), []
    pb, rb = _payloads(rng, 2)
    pbody, rbody = bytes([len(pb) + 1]) + pb, bytes([len(rb) + 1]) + rb
    poll(w, "nfcf", pbody + crc_f(pbody), frames)
    listen(w, "nfcf", rbody + crc_f(rbody), frames, 3000)
    w.gap(4096)
    out["nfcf"] = Template("nfcf", w.build(), frames)

    w, frames = VListenWriter(), []
    pp, rp = _payloads(rng, 2, 1, 2)
    a = _cursor(w)
    w.frame(pp + crc_b(pp))
    # the poll writer's EOF leaves 4096 samples of carrier behind it
    frames.append(RefFrame(TECH["nfcv"], POLL, pp + crc_b(pp), a,
                           _cursor(w) - 4096))
    listen(w, "nfcv", rp + crc_b(rp), frames, 3000)
    w.gap(4096)
    out["nfcv"] = Template("nfcv", w.build(8192), frames)
    return out


class Traffic:
    """Looped streams of one mix: ``block(k)`` is the [n_streams, width]
    float32 view of the k-th block of every stream, ``frames[i]`` and
    ``edges[i]`` the period's frames and field edges of stream i."""

    def __init__(self, mix: dict, seed: int, n_streams: int, width: int,
                 rate: int = RATE):
        if int(rate) != RATE:
            raise ValueError(f"the synth mixes are written at {RATE} samples"
                             f"/s; the configuration runs at {rate}")
        tpl = templates(int(mix.get("template_seed", 7)))
        names = list(mix["templates"])
        off_len = int(mix.get("field_off_samples", 0))
        # steady carrier after the field comes back, before the first poll
        guard = int(mix.get("field_on_guard_samples", 0)) if off_len else 0
        g_lo, g_hi = mix["gain"]
        offset, sigma = float(mix["offset"]), float(mix["noise_sigma"])
        round_len = guard + sum(len(tpl[n].samples) for n in names)
        self.period = round_len + off_len
        self.width = width
        self.n_streams = n_streams
        if width > self.period:
            raise ValueError("a block may not be longer than the period")
        self.buf = np.empty((n_streams, self.period + width), np.float32)
        self.frames: list[list[RefFrame]] = []
        self.order: list[list[str]] = []
        # field edges: (kind, position in the period); the carrier comes
        # back at the period's end, which is the next period's start
        self.edges = ([(CARRIER_OFF, round_len), (CARRIER_ON, self.period)]
                      if off_len else [])
        for i in range(n_streams):
            rng = np.random.default_rng([int(seed) % (1 << 64), i])
            order = [names[j] for j in rng.permutation(len(names))]
            gain = np.float32(rng.uniform(g_lo, g_hi))
            off = np.float32(rng.uniform(-offset, offset))
            lead = np.full(guard, tpl[order[0]].samples[0], np.float32)
            clean = np.concatenate([lead] + [tpl[n].samples for n in order])
            row = np.zeros(self.period, np.float32)
            row[:round_len] = clean * gain + off
            row += rng.standard_normal(self.period, dtype=np.float32) \
                * np.float32(sigma)
            self.buf[i, : self.period] = row
            self.buf[i, self.period:] = row[:width]
            frames, at = [], guard
            for n in order:
                frames += [f._replace(start=f.start + at, end=f.end + at)
                           for f in tpl[n].frames]
                at += len(tpl[n].samples)
            self.frames.append(frames)
            self.order.append(order)

    def block(self, k: int) -> np.ndarray:
        lo = (k * self.width) % self.period
        return self.buf[:, lo : lo + self.width]

    def frames_between(self, i: int, lo: int, hi: int) -> list[RefFrame]:
        """Stream i's frames that lie wholly in samples [lo, hi)."""
        out = []
        for k in range(max(lo, 0) // self.period, hi // self.period + 1):
            at = k * self.period
            out += [f._replace(start=f.start + at, end=f.end + at)
                    for f in self.frames[i]
                    if lo <= f.start + at and f.end + at <= hi]
        return out

    def edges_between(self, lo: int, hi: int) -> list[tuple[int, int]]:
        """Field edges (kind, sample) in [lo, hi), every stream alike."""
        out = []
        for k in range(max(lo, 0) // self.period, hi // self.period + 1):
            out += [(kind, k * self.period + p) for kind, p in self.edges
                    if lo <= k * self.period + p < hi]
        return out
