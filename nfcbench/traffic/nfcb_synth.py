# Frozen copy of tests/nfcb_synth.py: the benchmark's traffic does not move when
# the tests change.  Its CRC helpers read the CRC copy beside it.
"""Synthetic NFC-B (ISO14443-B) 106 kbps poll waveform generator.

Magnitude-domain ASK NRZ (NfcB.cpp:238-436 detect, :438-763 decode): SOF
is a falling edge, 10 etu low, rising edge, 2 etu high; each character is
start(0) + 8 data bits LSB-first + stop(1); EOF is 10 etu low then high.
The modulation is a partial drop (LOW below the NfcB edge threshold
min_deep = 0.10 of the envelope, well under the 0.90 recover ceiling).
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 10_000_000
ETU = 94
HIGH = np.float32(0.5)
LOW = np.float32(0.3)


class BPollWriter:
    def __init__(self, lead: int = 8192):
        self.chunks = [np.full(lead, HIGH, np.float32)]

    def _lvl(self, level, etus: float):
        self.chunks.append(
            np.full(int(round(etus * ETU)), level, np.float32)
        )

    def sof(self):
        self._lvl(LOW, 10.5)
        self._lvl(HIGH, 2)

    def char(self, byte: int):
        self._lvl(LOW, 1)  # start bit
        for i in range(8):
            self._lvl(HIGH if (byte >> i) & 1 else LOW, 1)
        self._lvl(HIGH, 1)  # stop bit

    def eof(self):
        self._lvl(LOW, 10.5)
        self._lvl(HIGH, 4)

    def frame(self, data: bytes):
        self.sof()
        for b in data:
            self.char(b)
        self.eof()

    def gap(self, samples: int = 800_000):
        self.chunks.append(np.full(samples, HIGH, np.float32))

    def field_off(self, samples: int = 200_000):
        """Reader field removed (carrier off -> on cycle resets the
        decoders)."""
        self.chunks.append(np.zeros(samples, np.float32))

    def build(self, tail: int = 16384) -> np.ndarray:
        self.chunks.append(np.full(tail, HIGH, np.float32))
        return np.concatenate(self.chunks)


ETU_F = SAMPLE_RATE / 13.56e6 * 128   # exact 106k etu (94.395 samples)
SUBH = SAMPLE_RATE / 13.56e6 * 8      # half-period of the 848 kHz subcarrier
AMP = np.float32(0.04)


class BListenWriter(BPollWriter):
    """Extends the poll writer with BPSK tag responses (NfcB.cpp:767-1040
    decode semantics; structure per ISO14443-3):

      TR1 unmodulated subcarrier (~13 etu, window 1024-3200 carrier
      cycles) -> S1: 10.5 etu of the logic-0 phase -> S2: 2.5 etu of the
      logic-1 phase -> characters (start 0 + 8 data LSB + stop 1,
      back-to-back) -> EOF: 10.5 etu of logic 0 -> subcarrier off.

    Phases are absolute NRZ-L: logic 1 rides the TR1/S2 phase, logic 0
    the inverted one.  Spans sit on the float etu grid; the subcarrier is
    generated in absolute sample time so phase is continuous."""

    def listen_frame(self, data: bytes, delay: int = 2000,
                     bad_stop_at: int | None = None,
                     cut_after: int | None = None):
        """Tag response `delay` samples after the poll EOF.  bad_stop_at
        sends byte i's stop bit as logic 0 (stream error -> Truncated);
        cut_after drops the EOF and kills the subcarrier after byte i
        (PatternO mid-frame)."""
        self.chunks.append(np.full(delay, HIGH, np.float32))
        base = sum(len(c) for c in self.chunks)

        spans: list[tuple[int, float]] = [(1, 13.0), (-1, 10.5), (1, 2.5)]
        for bi, byte in enumerate(data):
            spans.append((-1, 1.0))                      # start bit (0)
            for i in range(8):
                spans.append((1 if (byte >> i) & 1 else -1, 1.0))
            spans.append((-1 if bi == bad_stop_at else 1, 1.0))  # stop (1)
            if cut_after == bi:
                break
        if cut_after is None:
            spans.append((-1, 10.5))                     # EOF

        n = int(round(sum(e for _, e in spans) * ETU_F))
        t = np.arange(n, dtype=np.int64) + base
        sub = np.where((t / SUBH).astype(np.int64) & 1, -AMP, AMP)
        sig = np.full(n, HIGH, np.float32)
        pos = 0.0
        for ph, e in spans:
            a, b = int(round(pos)), int(round(pos + e * ETU_F))
            sig[a:b] += np.float32(ph) * sub[a:b]
            pos += e * ETU_F
        self.chunks.append(sig)


def crc_b(data: bytes) -> bytes:
    """ISO14443-B CRC16 bytes to append (init 0xFFFF, reflected,
    inverted)."""
    from .crc import crc16_ccitt

    v = (~crc16_ccitt(data, 0, len(data), 0xFFFF, True)) & 0xFFFF
    return bytes((v & 0xFF, (v >> 8) & 0xFF))
