"""Entry ``batch_corpus``: ``runtime/batch.decode_batch`` with its own
defaults over recorded sessions, as nfc-laboratory's test-sdr decodes
every ``wav/*.wav``: the host frontend with the device conditioner
(``condition_jax`` on the card, in the parent, capture by capture) and
the walks in a process pool (spawn, since CUDA is live by then).

Set-up writes the traffic's ring of recordings as 32-bit float mono WAVs
(16-bit PCM would clip the mixes' gains of up to 1.25) in a temporary
directory.  The loop is closed: each call hands ``captures_per_call``
recordings, the next of the ring, to ``decode_batch``, and the next call
starts when it returns.  Each recording goes through ``_next_block``, so
the control can drop one.

Positions are on the traffic's line, where recording k has the k-th
place: a frame comes back at its capture's place plus its sample.  One
drain event a call: the line's position after the call's last recording
(every recording whose turn came; under the control a dropped one keeps
its place and its frames never come), the program's counters summed over
calls (``decode_batch``'s ``stats``; none where it takes no such
argument) and the host clock.  The program's ``batch.*`` spans of each
call are copied into ``spans`` under the names the trace reader gives
idle gaps: conditioning as ``device_pass``, the pool and the walks as
``walk``.

A dispatch window is one pass over the ring: ``warm_windows`` 1 decodes
every recording once before the measured window opens, so the window
meets no capture length it has not seen.
"""

from __future__ import annotations

import inspect
import os
import struct
import tempfile
import time

import numpy as np

from nfcbench.drivers.base import Driver as _Base
from nfcbench.drivers.base import host_clock

# the program's spans, by the label trace.summarize names an idle gap by
LABELS = {"batch.condition": "device_pass", "batch.pool": "walk",
          "batch.walk": "walk"}


def write_float_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """`samples` as a mono WAV of 32-bit IEEE floats (format 3)."""
    data = np.ascontiguousarray(samples, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, rate, rate * 4, 4, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data))
                + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(data)))
        f.write(data)


class Driver(_Base):
    def __init__(self, cfg: dict, traffic, device):
        super().__init__(cfg, traffic, device)
        from nfclab_torch.native.binding import native_available
        from nfclab_torch.runtime import batch

        # the host's native library (the walk) is built or loaded here, in
        # set-up, as for the other entries
        if not native_available():
            raise RuntimeError("the native host library is unavailable")
        self.n_streams = 1
        self.window_samples = traffic.period
        self.per_call = int(cfg["captures_per_call"])
        if not 1 <= self.per_call <= traffic.ring:
            raise ValueError("captures_per_call must be 1 to the ring's "
                             f"{traffic.ring} recordings")
        self.settings = dict(cfg["decode_batch"])
        self._decode = batch.decode_batch
        self.stats: dict | None = (
            {} if "stats" in inspect.signature(batch.decode_batch).parameters
            else None)
        self._dir = tempfile.TemporaryDirectory(prefix="nfcbench-corpus-")
        self.paths = []
        for j in range(traffic.ring):
            self.paths.append(os.path.join(self._dir.name, f"rec{j}.wav"))
            write_float_wav(self.paths[-1], traffic.block(j)[0],
                            int(cfg["sample_rate"]))
        self._line = 0      # the line's position of the next recording

    def _call(self) -> None:
        from nfclab_torch.runtime import trace

        paths, bases = [], []
        t0 = time.perf_counter()
        for _ in range(self.per_call):
            k = self._k
            n = self.traffic.block(k).shape[1]
            if self._next_block() is not None:
                paths.append(self.paths[k % self.traffic.ring])
                bases.append(self._line)
                self.handoff.append(t0)
            self._line += n
        kw = dict(self.settings, device=self.device)
        if self.stats is not None:
            kw["stats"] = self.stats
        out = self._decode(paths, **kw) if paths else {}
        t = time.perf_counter()
        for path, base in zip(paths, bases):
            for f in out[path]:
                f.sample_start += base
                f.sample_end += base
                self.frames.append((0, t, f))
        if self.spans_on:
            self.spans += [(sp.start, sp.end, LABELS[sp.name])
                           for sp in trace.spans(t0, t) if sp.name in LABELS]
        self._drained = self._line
        self.events.append((t, self._line, dict(self.stats or {}),
                            host_clock()))

    def run_until(self, stop) -> None:
        while not stop(self):
            self._call()

    def finish(self, timeout: float = 120.0) -> None:
        """Every call returned whole, so nothing is pending: remove the
        recordings."""
        self._dir.cleanup()
