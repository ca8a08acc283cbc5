# Frozen copy of tests/nfca_bpsk_synth.py: the benchmark's traffic does not move when
# the tests change.  Its CRC helpers read the CRC copy beside it.
"""Synthetic NFC-A 424 kbps waveform generator: modified-Miller polls and
BPSK listen responses (magnitude domain).

High-rate NFC-A frames (NfcA.cpp poll :432-563 at rateType 2; BPSK listen
:1220-1424) differ from 106k in geometry only for polls (float 23.6-sample
etu grid, ~0.8 us pauses) but use a different listen modulation entirely:
the 848 kHz subcarrier is phase-modulated (BPSK NRZ-L).  Structure measured
from test_NFC-A_424kbps_001.wav:

  - ~16 etu of unmodulated subcarrier (TR1 preamble)
  - SOF phase inversion + one full bit of the inverted phase (the logic-0
    reference the decoder's symbol value starts from)
  - data bits NRZ-L: a phase flip at a bit boundary toggles the value;
    bytes LSB-first with odd parity, the LAST byte with even parity
  - EOF: subcarrier stops (product integrator decays below threshold)

This exists for ADVERSARIAL tests: the bundled 424k fixtures cover only
well-formed frames, so the BPSK ParityError / truncation / CRC paths have
no coverage.  Round-trip validated before error injection.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 10_000_000
ETU = SAMPLE_RATE / 13.56e6 * 32      # 23.599 samples per 424 kbps bit
PAUSE = 8                             # ~0.8 us poll field pause
SUBH = SAMPLE_RATE / 13.56e6 * 8      # half-period of the 848 kHz subcarrier
LEVEL = np.float32(0.5)
AMP = np.float32(0.04)
GLOBAL_ETU = SAMPLE_RATE / 13.56e6 * 128  # 106k etu the SoF window uses


class A424Writer:
    """Event-based writer: poll pauses and BPSK spans are placed on a float
    sample cursor so the fractional etu grid never accumulates rounding.

    rate_type 2 = 424 kbps (default, fixture-validated), 1 = 212 kbps —
    both share the modified-Miller poll coding (pause ~0.34 etu) and the
    BPSK listen structure; the TR1 preamble is ~4 GLOBAL (106k) etu of
    absolute time regardless of rate (the integrator rise eats ~0.5 etu,
    landing the measured length inside the decoder's 3..4-etu SoF
    window), so its slot count scales with the bit period."""

    def __init__(self, lead: int = 8192, rate_type: int = 2):
        self.etu = SAMPLE_RATE / 13.56e6 * (128 >> rate_type)
        self.pause = max(4, int(round(0.34 * self.etu)))
        self.preamble_slots = int(round(4.0 * GLOBAL_ETU / self.etu))
        self._w = float(lead)
        self._pauses: list[int] = []          # pause start samples
        self._bpsk: list[tuple[float, list[int]]] = []  # (start, phases)
        self._last_bit = 0

    # ------------------------------------------------------------- poll side

    def _bit(self, v: int):
        if v:                                  # X: pause at bit middle
            self._pauses.append(int(round(self._w + self.etu / 2)))
            self._last_bit = 1
        elif self._last_bit:                   # Y: idle bit
            self._last_bit = 0
        else:                                  # Z: pause at bit start
            self._pauses.append(int(round(self._w)))
            self._last_bit = 0
        self._w += self.etu

    def frame(self, data: bytes, flip_parity_at: int | None = None):
        """One standard poll frame (SOC + LSB-first bytes with odd parity +
        EOC)."""
        self._pauses.append(int(round(self._w)))   # SOC = Z
        self._last_bit = 0
        self._w += self.etu
        for bi, byte in enumerate(data):
            ones = 0
            for i in range(8):
                b = (byte >> i) & 1
                ones += b
                self._bit(b)
            parity = (ones & 1) ^ 1
            if flip_parity_at == bi:
                parity ^= 1
            self._bit(parity)
        self._bit(0)                               # EOC: logic 0 + idle
        self._last_bit = 0
        self._w += 2 * self.etu

    # ----------------------------------------------------------- listen side

    def listen_frame(self, data: bytes, delay: int = 900,
                     flip_parity_at: int | None = None,
                     trailing_bits: int = 0):
        """BPSK tag response `delay` samples after the last poll bit.
        flip_parity_at inverts byte i's parity bit; trailing_bits appends
        extra value-toggle bits after the last parity (malformed tail)."""
        start = self._w + delay
        phases = [1] * self.preamble_slots + [-1]       # TR1 preamble + SOF flip (= logic 0)
        value, cur = 0, -1

        def push(v: int):
            nonlocal value, cur
            if v != value:
                cur = -cur
                value = v
            phases.append(cur)

        last = len(data) - 1
        for bi, byte in enumerate(data):
            ones = 0
            for i in range(8):
                b = (byte >> i) & 1
                ones += b
                push(b)
            # odd parity, except the LAST byte which carries even parity
            parity = (ones & 1) ^ (0 if bi == last else 1)
            if flip_parity_at == bi:
                parity ^= 1
            push(parity)
        for _ in range(trailing_bits):
            push(value ^ 1)
        self._bpsk.append((start, phases))
        self._w = start + len(phases) * self.etu

    # --------------------------------------------------------------- render

    def gap(self, samples: int = 8192):
        self._w += samples

    def build(self, tail: int = 16384) -> np.ndarray:
        n = int(self._w) + tail
        sig = np.full(n, LEVEL, np.float32)
        for p in self._pauses:
            sig[p : p + self.pause] = 0.004
        t = np.arange(n)
        sub = np.where((t / SUBH).astype(np.int64) & 1, -AMP, AMP)
        for start, phases in self._bpsk:
            for s, ph in enumerate(phases):
                a = int(round(start + s * self.etu))
                b = int(round(start + (s + 1) * self.etu))
                sig[a:b] += np.float32(ph) * sub[a:b]
        return sig
