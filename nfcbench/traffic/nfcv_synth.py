# Frozen copy of tests/nfcv_synth.py: the benchmark's traffic does not move when
# the tests change.  Its CRC helpers read the CRC copy beside it.
"""Synthetic NFC-V (ISO15693) 1-of-4 poll waveform generator.

Magnitude-domain 26.48 kbps PPM frames per the decoder's own geometry
(NfcV.cpp:236-435 SOF, :672-795 slot decode, transcribed in
demod/nfcv.py): the SD correlator is a p2-wide box difference, so a
field pause of width p2 produces its correlation peak exactly at the
pause END.  All placements below are in pause-END coordinates:

  SOF (1-of-4): pause ending at E0, second pause ending at E0 + 3*p1
  data symbol:  symbol window of 4 slots x p1; value v = pause ending at
                window_start + (v+1)*p1
  EOF:          pause ending at window_start + 1.5*p1

Bytes are 4 symbols of 2 bits, LSB pair first.  CRC16-B (ISO13239) is
appended by callers via crc_b().
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 10_000_000
P1 = 189     # round(256 * rate / 13.56 MHz) — bitrate periods
P2 = 94
PAUSE = P2   # 9.44 us field pause
# slot geometry uses the UNROUNDED sample-time unit like the decoder's
# PulseParams (round per slot boundary, NOT a rounded unit times i — the
# difference accumulates to a whole slot over a 1-of-256 symbol)
SLOT_F = SAMPLE_RATE / 13.56e6 * 256
LEN4 = round(4 * SLOT_F)
LEN256 = round(256 * SLOT_F)
LEVEL = np.float32(0.5)


class VPollWriter:
    def __init__(self, lead: int = 8192):
        self.n = lead
        self.pauses: list[int] = []  # pause END positions (samples)

    def _advance(self, dn: int):
        self.n += dn

    def sof(self):
        # the decoder anchors symbolStart = peak1 - p2 and requires
        # peak2 == symbolStart + 3*p1, so the second pause ends
        # 3*p1 - p2 after the first (peaks sit at pause ENDS)
        e0 = self.n + PAUSE
        e1 = e0 + 3 * P1 - P2
        self.pauses += [e0, e1]
        # symbol windows start at symbolEnd = peak2 + p1
        self._window = e1 + P1
        self.n = self._window

    def symbol(self, value: int, length: int = LEN4):
        self.pauses.append(self._window + round((value + 1) * SLOT_F))
        self._window += length
        self.n = self._window

    def byte(self, v: int):
        for i in range(4):
            self.symbol((v >> (2 * i)) & 3)

    def eof(self):
        self.pauses.append(self._window + P1 + P1 // 2)
        self._window += 2 * P1
        self.n = self._window + 4096

    def frame(self, data: bytes):
        self.sof()
        for b in data:
            self.byte(b)
        self.eof()

    def gap(self, samples: int = 20000):
        self.n += samples

    def build(self, tail: int = 16384) -> np.ndarray:
        total = self.n + tail
        sig = np.full(total, LEVEL, np.float32)
        for end in self.pauses:
            sig[end - PAUSE : end] = 0.004
        return sig


HB = SLOT_F                          # half-bit = 256 carrier cycles
SUBP = SAMPLE_RATE / 13.56e6 * 16    # half-period of the 423.75 kHz sc
AMP = np.float32(0.015)              # load-mod ripple (~3% of level)
DIP = np.float32(0.012)              # mean dip while the sc is on


class VListenWriter(VPollWriter):
    """Extends the poll writer with single-subcarrier tag responses
    (NfcV.cpp:800-1085 decode; structure measured from the bundled 26k
    capture): all times in half-bits (256 fc cycles),

      SOF:  3 hb unmodulated + 3 hb subcarrier + logic 1 (idle, ON)
      bits: LSB-first; 0 = (ON, idle), 1 = (idle, ON)
      EOF:  logic 0 (ON, idle) + 3 hb subcarrier, then off

    The subcarrier renders as a +-AMP square at fs/32 in absolute sample
    time, with a DIP mean drop while on (mirrors the capture's load
    modulation)."""

    def __init__(self, lead: int = 8192):
        super().__init__(lead)
        self._bursts: list[tuple[int, int]] = []  # (start, end) samples

    def _on(self, start_hb: float, n_hb: float, base: float):
        a = int(round(base + start_hb * HB))
        b = int(round(base + (start_hb + n_hb) * HB))
        self._bursts.append((a, b))

    def listen_frame(self, data: bytes, delay: int = 3000):
        base = float(self.n + delay)
        hb = 3.0                    # 3 hb unmodulated lead-in
        self._on(hb, 3, base); hb += 3          # SOF burst
        hb += 1                                  # SOF logic 1: idle
        self._on(hb, 1, base); hb += 1           #              ON
        for byte in data:
            for i in range(8):
                if (byte >> i) & 1:
                    hb += 1
                    self._on(hb, 1, base); hb += 1
                else:
                    self._on(hb, 1, base); hb += 1
                    hb += 1
        self._on(hb, 1, base); hb += 2           # EOF logic 0
        self._on(hb, 3, base); hb += 3           # EOF burst
        self.n = int(round(base + hb * HB)) + 512

    def build(self, tail: int = 16384) -> np.ndarray:
        sig = super().build(tail)
        t = np.arange(len(sig), dtype=np.int64)
        sub = np.where((t / SUBP).astype(np.int64) & 1, -AMP, AMP) - DIP
        for a, b in self._bursts:
            sig[a:b] += sub[a:b]
        return sig


def crc_b(data: bytes) -> bytes:
    """ISO15693 CRC16 bytes to append (init 0xFFFF, reflected, inverted)."""
    from .crc import crc16_ccitt

    v = (~crc16_ccitt(data, 0, len(data), 0xFFFF, True)) & 0xFFFF
    return bytes((v & 0xFF, (v >> 8) & 0xFF))
