"""Synthetic ISO7816 logic captures for the nfclab_torch tests and
chip_smoke.py, with no nfclab or JAX import.

``WaveBuilder``, ``_session_head``, ``_t1_crc`` and ``make_session`` are
copies of tests/test_iso7816.py's (which imports nfclab at its top); the
CRC comes from nfclab_torch.protocol.crc.  Captures are [N, 4] float32
levels, IO=0, CLK=1, RST=2, VCC=3, at 24 MS/s with a 4 MHz card clock.

- ``make_session()``: one powered-up session, ATR then a T=0 TPDU.
- ``logic_lane(n_samples, seed)``: back-to-back seeded sessions (power-up,
  ATR in the direct and the inverse convention, PPS, T=0 TPDUs with error
  signalling, T=1 I/R/S-blocks with LRC or CRC epilogues, idle gaps,
  power-down), with the bytes of every frame the lane carries.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 24_000_000
CLOCK_HZ = 4_000_000
ETU_SAMPLES = SAMPLE_RATE * 372 // CLOCK_HZ  # Fi=372, Di=1 -> 2232 samples


class WaveBuilder:
    """Builds a 4-channel logic capture: IO=0, CLK=1, RST=2, VCC=3."""

    def __init__(self):
        self.chunks = []
        self.io = 1.0
        self.clk_on = False
        self.rst = 0.0
        self.vcc = 0.0
        self.t = 0

    def hold(self, samples: int):
        seg = np.zeros((samples, 4), np.float32)
        seg[:, 0] = self.io
        if self.clk_on:
            # square clock at CLOCK_HZ
            phase = ((np.arange(self.t, self.t + samples) * 2 * CLOCK_HZ)
                     // SAMPLE_RATE) & 1
            seg[:, 1] = phase.astype(np.float32)
        seg[:, 2] = self.rst
        seg[:, 3] = self.vcc
        self.chunks.append(seg)
        self.t += samples

    def character(self, byte: int, parity_error: bool = False):
        """start bit + 8 data bits (LSB first) + even parity + 2 etu stop."""
        bits = [0] + [(byte >> i) & 1 for i in range(8)]
        par = bin(byte).count("1") & 1
        if parity_error:
            par ^= 1
        bits.append(par)
        for b in bits:
            self.io = float(b)
            self.hold(ETU_SAMPLES)
        self.io = 1.0
        self.hold(2 * ETU_SAMPLES)

    def character_inverse(self, byte: int):
        """Inverse-convention character (ISO7816-3 §8.1): bits MSB first,
        logic level inverted (state A = logic 1); even parity, also
        inverted on the wire."""
        bits = [0] + [1 - ((byte >> (7 - i)) & 1) for i in range(8)]
        par = bin(byte).count("1") & 1
        bits.append(1 - par)
        for b in bits:
            self.io = float(b)
            self.hold(ETU_SAMPLES)
        self.io = 1.0
        self.hold(2 * ETU_SAMPLES)

    def character_with_error_signal(self, byte: int):
        """T=0 error signaling (ISO7816-3 §10.3.2): the receiver pulls IO
        low during the stop moment, asking for retransmission — the decoder
        must drop this character and accept the repeat."""
        bits = [0] + [(byte >> i) & 1 for i in range(8)]
        par = bin(byte).count("1") & 1
        bits.append(par)
        for b in bits:
            self.io = float(b)
            self.hold(ETU_SAMPLES)
        self.io = 0.0  # error signal low at the stop moment
        self.hold(ETU_SAMPLES)
        self.io = 1.0
        self.hold(2 * ETU_SAMPLES)

    def build(self) -> np.ndarray:
        return np.concatenate(self.chunks, axis=0)


def _session_head() -> WaveBuilder:
    w = WaveBuilder()
    w.hold(1000)
    w.vcc = 1.0
    w.hold(1000)
    w.clk_on = True
    w.hold(1000)
    w.rst = 1.0
    w.hold(5000)
    return w


def _t1_crc(payload: bytes) -> bytes:
    """ISO13239 CRC epilogue as _check_crc expects (Iso7816.cpp:1603-1614):
    inverted CRC16-CCITT (reflected, init 0xFFFF), little-endian."""
    from nfclab_torch.protocol.crc import crc16_ccitt

    crc = (~crc16_ccitt(payload, 0, len(payload), 0xFFFF, True)) & 0xFFFF
    return bytes([crc & 0xFF, crc >> 8])


def make_session(atr=(0x3B, 0x00), tpdu=None, idle_tail=300_000):
    w = WaveBuilder()
    w.hold(1000)  # everything down
    w.vcc = 1.0
    w.hold(1000)  # VCC up
    w.clk_on = True
    w.hold(1000)  # clock starts
    w.rst = 1.0
    w.hold(5000)  # RST rises; card answers after some delay
    for b in atr:
        w.character(b)
    atr_end = w.t
    w.hold(80_000)  # inter-frame gap (> character waiting time would timeout)
    if tpdu:
        for b in tpdu:
            w.character(b)
    w.hold(idle_tail)
    return w.build()


# ------------------------------------------------------------ seeded lanes

PPS_T1 = bytes((0xFF, 0x11, 0x11, 0xFF))  # PPS1 present, T=1, Fi=1/Di=1
SESSION_KINDS = ("t0_direct", "t0_inverse", "t1_lrc", "t1_crc")


def _xor(bs) -> int:
    out = 0
    for b in bs:
        out ^= b
    return out


def _rand(rng, lo, hi) -> int:
    return int(rng.integers(lo, hi))


def _tpdu(rng) -> bytes:
    """A T=0 command-response exchange: CLA INS P1 P2 P3, the procedure
    byte (INS), P3 data bytes, SW1 SW2."""
    ins = int(rng.choice([0xA4, 0xB0, 0xB2, 0xD6, 0xCA, 0x88]))
    p3 = _rand(rng, 1, 9)
    data = rng.integers(0, 256, p3).tolist()
    sw = [int(rng.choice([0x90, 0x61, 0x6A])), _rand(rng, 0, 256)]
    return bytes([_rand(rng, 0, 256) & 0xFE, ins, _rand(rng, 0, 256),
                  _rand(rng, 0, 256), p3, ins] + data + sw)


def _t1_blocks(rng, crc: bool) -> list[bytes]:
    """A T=1 exchange: I-blocks both ways, an R-block and an S(WTX)
    request/response pair, each with its LRC or CRC epilogue."""
    def epilogue(core):
        core = bytes(core)
        return core + (_t1_crc(core) if crc else bytes([_xor(core)]))

    out = []
    seq = 0
    for _ in range(_rand(rng, 1, 3)):
        inf = rng.integers(0, 256, _rand(rng, 1, 9)).tolist()
        out.append(epilogue([0x00, seq << 6, len(inf)] + inf))
        out.append(epilogue([0x00, 0x80 | (seq << 4), 0]))  # R-block
        wtx = _rand(rng, 1, 4)
        out.append(epilogue([0x00, 0xC3, 1, wtx]))           # S(WTX) req
        out.append(epilogue([0x00, 0xE3, 1, wtx]))           # S(WTX) resp
        inf = rng.integers(0, 256, _rand(rng, 1, 5)).tolist()
        out.append(epilogue([0x00, seq << 6, len(inf)] + inf))
        seq ^= 1
    return out


def _session(rng, kind: str, t0: int):
    """One session from power-up to power-down, its clock phase starting
    at lane sample t0: (capture, frame bytes in order)."""
    w = WaveBuilder()
    w.t = t0
    w.hold(_rand(rng, 1000, 4000))  # everything down
    w.vcc = 1.0
    w.hold(1000)
    w.clk_on = True
    w.hold(1000)
    w.rst = 1.0
    w.hold(_rand(rng, 4000, 8000))  # the card answers after some delay
    hist = rng.integers(0, 256, _rand(rng, 0, 5)).tolist()
    sent = []
    if kind in ("t0_direct", "t0_inverse"):
        ts = 0x3B if kind == "t0_direct" else 0x3F
        frames = [bytes([ts, len(hist)] + hist)]
        frames += [_tpdu(rng) for _ in range(_rand(rng, 1, 4))]
    else:
        t0b = 0x80 | len(hist)
        if kind == "t1_lrc":
            atr = [0x3B, t0b, 0x01] + hist       # TD1: T=1
        else:
            atr = [0x3B, t0b, 0x81, 0x41, 0x01] + hist  # TD2, TC3 = CRC
        atr.append(_xor(atr[1:]))                # TCK
        frames = [bytes(atr), PPS_T1, PPS_T1]
        frames += _t1_blocks(rng, crc=kind == "t1_crc")
    retransmit = (kind == "t0_direct" and rng.random() < 0.5)
    for i, fr in enumerate(frames):
        for j, b in enumerate(fr):
            if kind == "t0_inverse":
                w.character_inverse(b)
                continue
            if retransmit and i == 1 and j == 3:
                # the receiver rejects this byte once; it is repeated
                w.character_with_error_signal(b)
            w.character(b)
        sent.append(fr)
        w.hold(_rand(rng, 20_000, 60_000))  # inter-frame gap
    w.rst = 0.0
    w.hold(2000)
    w.clk_on = False
    w.hold(1000)
    w.vcc = 0.0
    w.hold(_rand(rng, 2000, 20_000))
    return w.build(), sent


def logic_lane(n_samples: int, seed: int):
    """Back-to-back ISO7816 sessions of every SESSION_KINDS kind, in a
    seeded order, filling n_samples (the rest powered down): ([n_samples, 4]
    float32 capture, the bytes of each ATR, PPS, TPDU and T=1 block in
    order).  Only whole sessions go in: one that would not fit is drawn
    again, four times at most."""
    rng = np.random.default_rng(seed)
    parts, sent, at = [], [], 0
    kinds = list(SESSION_KINDS)
    rng.shuffle(kinds)
    i = misses = 0
    while misses < 4:
        x, s = _session(rng, kinds[i % len(kinds)], at)
        i += 1
        if at + len(x) > n_samples:
            misses += 1
            continue
        parts.append(x)
        sent += s
        at += len(x)
    parts.append(np.zeros((n_samples - at, 4), np.float32) + [1, 0, 0, 0])
    return np.concatenate(parts).astype(np.float32), sent
