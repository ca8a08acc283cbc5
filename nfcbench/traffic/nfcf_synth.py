# Frozen copy of tests/nfcf_synth.py: the benchmark's traffic does not move when
# the tests change.  Its CRC helpers read the CRC copy beside it.
"""Synthetic NFC-F (FeliCa, 212 kbps) Manchester poll waveform generator.

48-symbol zero preamble + 0xB24D sync + LEN-prefixed payload + big-endian
CRC (NfcF.cpp detect :206-408, decode :641-744; MSB-first bytes).  Bit
boundaries use the unrounded 64-carrier-cycle period (47.18 samples at
10 MS/s), sampled per output sample so boundary rounding never
accumulates.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 10_000_000
BIT_F = SAMPLE_RATE / 13.56e6 * 64  # 47.18 samples per 212 kbps symbol
HIGH = np.float32(0.5)
LOW = np.float32(0.3)


def _bits_msb(data: bytes) -> list[int]:
    out = []
    for b in data:
        for i in range(7, -1, -1):
            out.append((b >> i) & 1)
    return out


class FPollWriter:
    def __init__(self, lead: int = 8192):
        self.chunks = [np.full(lead, HIGH, np.float32)]

    def frame(self, data: bytes, polarity: int = 0):
        bits = [0] * 48 + _bits_msb(b"\xb2\x4d") + _bits_msb(data)
        n = int(round(len(bits) * BIT_F))
        t = np.arange(n, dtype=np.float64)
        k = np.minimum((t / BIT_F).astype(np.int64), len(bits) - 1)
        half = (t / BIT_F - k) >= 0.5
        bvals = np.asarray(bits, np.int64)[k]
        # Manchester: bit 0 -> (L, H), bit 1 -> (H, L); polarity flips both
        first_low = (bvals == 0) ^ bool(polarity)
        low = np.where(half, ~first_low, first_low)
        self.chunks.append(np.where(low, LOW, HIGH).astype(np.float32))

    def listen_frame(self, data: bytes, delay: int = 5000,
                     polarity: int = 0):
        """Tag response `delay` samples after the poll: FeliCa listen uses
        the same Manchester coding as the poll (NfcF.cpp:749-1046); the
        decoder types it by the guard..waiting response window."""
        self.chunks.append(np.full(delay, HIGH, np.float32))
        self.frame(data, polarity)

    def gap(self, samples: int = 800_000):
        self.chunks.append(np.full(samples, HIGH, np.float32))

    def build(self, tail: int = 16384) -> np.ndarray:
        self.chunks.append(np.full(tail, HIGH, np.float32))
        return np.concatenate(self.chunks)


def crc_f(data: bytes) -> bytes:
    """FeliCa CRC bytes to append (CCITT init 0x0000, BIG-endian)."""
    from .crc import crc16_ccitt

    v = crc16_ccitt(data, 0, len(data), 0x0000, False)
    return bytes(((v >> 8) & 0xFF, v & 0xFF))
