# Frozen copy of tests/nfca_synth.py: the benchmark's traffic does not move when
# the tests change.  Its CRC helpers read the CRC copy beside it.
"""Synthetic NFC-A poll waveform generator (magnitude domain).

Builds 106 kbps modified-Miller poll frames the way a reader's field looks
after IQ->magnitude: steady carrier with ~2.5 us pauses (ISO14443-2 bit
coding; NfcA.cpp:432-563 decode semantics):

  X: pause starting at the bit middle        (logic 1)
  Y: no pause                                (logic 0 after 1 / idle)
  Z: pause at the bit start                  (logic 0 after 0, and SOC)

Frames are LSB-first with an odd parity bit per byte; short frames (REQA/
WUPA) are 7 bits with no parity.  End of comm = logic 0 + one idle bit.

This exists for ADVERSARIAL tests: the bundled reference captures cover
only well-formed frames, so the ParityError/CrcError poll paths have no
fixture coverage.  The synthesizer is validated by round-trip (its frames
decode byte-exact) before being used to inject errors.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 10_000_000
BIT = 94        # 128 / 13.56 MHz at 10 MS/s (period1)
HALF = 47       # period2
PAUSE = 28      # ~2.8 us field pause
LEVEL = np.float32(0.5)


class PollWriter:
    def __init__(self, lead: int = 8192):
        self.chunks = [np.full(lead, LEVEL, np.float32)]
        self._last_bit = 0

    def _pause_bit(self, at: int):
        """One bit period with a pause starting `at` samples in."""
        b = np.full(BIT, LEVEL, np.float32)
        b[at : at + PAUSE] = 0.004
        self.chunks.append(b)

    def _idle_bit(self):
        self.chunks.append(np.full(BIT, LEVEL, np.float32))

    def seq_x(self):
        self._pause_bit(HALF)
        self._last_bit = 1

    def seq_y(self):
        self._idle_bit()
        self._last_bit = 0

    def seq_z(self):
        self._pause_bit(0)
        self._last_bit = 0

    def bit(self, v: int):
        if v:
            self.seq_x()
        elif self._last_bit:
            self.seq_y()
        else:
            self.seq_z()

    def soc(self):
        self.seq_z()
        self._last_bit = 0

    def eoc(self):
        # logic 0 + idle (NfcA end of communication)
        self.bit(0)
        self.seq_y()
        self.seq_y()

    def frame(self, data: bytes, short: bool = False,
              flip_parity_at: int | None = None):
        """One poll frame.  short=True sends only 7 bits of data[0] with no
        parity (REQA/WUPA).  flip_parity_at inverts byte i's parity bit."""
        self.soc()
        if short:
            v = data[0]
            for i in range(7):
                self.bit((v >> i) & 1)
        else:
            for bi, byte in enumerate(data):
                ones = 0
                for i in range(8):
                    b = (byte >> i) & 1
                    ones += b
                    self.bit(b)
                parity = (ones & 1) ^ 1  # odd parity
                if flip_parity_at == bi:
                    parity ^= 1
                self.bit(parity)
        self.eoc()

    def gap(self, samples: int = 4096):
        self.chunks.append(np.full(samples, LEVEL, np.float32))

    def build(self, tail: int = 16384) -> np.ndarray:
        self.chunks.append(np.full(tail, LEVEL, np.float32))
        return np.concatenate(self.chunks)


def crc_a(data: bytes) -> bytes:
    """CRC16-A bytes to append (ISO14443-3: init 0x6363, reflected)."""
    from .crc import crc16_ccitt

    v = crc16_ccitt(data, 0, len(data), 0x6363, True)
    return bytes((v & 0xFF, (v >> 8) & 0xFF))


SUB = 16 * SAMPLE_RATE / 13.56e6 / 2  # half-period of the 848 kHz subcarrier


def _subcarrier(n: int, start_phase: int = 0) -> np.ndarray:
    """±1 square wave at fs/16 (load-modulation ripple), sample-accurate."""
    idx = (np.arange(n) / SUB).astype(np.int64) + start_phase
    return np.where(idx & 1, -1.0, 1.0).astype(np.float32)


class ListenWriter(PollWriter):
    """Extends the poll writer with tag responses: ASK load modulation
    (848 kHz subcarrier, Manchester halves: logic 1 = subcarrier in the
    first half, 0 = second half; SOC = one full-bit burst; EOC = silent
    bit)."""

    AMP = np.float32(0.04)

    def _sub_span(self, on_first: bool | None):
        """One bit period; on_first None = full-bit burst."""
        b = np.full(BIT, LEVEL, np.float32)
        if on_first is None:
            b += self.AMP * _subcarrier(BIT)
        elif on_first:
            b[:HALF] += self.AMP * _subcarrier(HALF)
        else:
            b[HALF:] += self.AMP * _subcarrier(BIT - HALF)
        self.chunks.append(b)

    def listen_frame(self, data: bytes, delay: int = 900,
                     flip_parity_at: int | None = None):
        """Tag response `delay` samples after the last poll bit (must land
        inside the decoder's guard..waiting window)."""
        self.chunks.append(np.full(delay, LEVEL, np.float32))
        self._sub_span(True)  # SOC = D pattern (half-bit burst)
        for bi, byte in enumerate(data):
            ones = 0
            for i in range(8):
                bit = (byte >> i) & 1
                ones += bit
                self._sub_span(bool(bit))
            parity = (ones & 1) ^ 1
            if flip_parity_at == bi:
                parity ^= 1
            self._sub_span(bool(parity))
        self._idle_bit()  # EOC: silent bit
        self._idle_bit()
