"""What every entry driver records, on the clock of ``time.perf_counter``.

A driver (``nfcbench/drivers/<entry>.py``, named by a configuration's
``entry``) builds the program's entry from the configuration, feeds it
the traffic's blocks in a closed loop and records:

- ``handoff[k]``: when the k-th block fed was handed to the program;
- ``frames``: (stream, time it came back, Frame) for every frame;
- ``events``: drain events, (time, drained samples, farm stats, host
  clock) each time the farm's ``drained_samples`` moved: its walk
  finished a window.  The measured window opens and closes on these.
- ``spans`` (when ``spans_on``): (start, end, name) host spans around the
  farm's device pass and walk, for naming the device's idle gaps.

``skip`` (a callable of the block index) lets a control drop blocks.
"""

from __future__ import annotations

import time


def host_clock() -> tuple:
    """(this process's CPU seconds, all threads; the machine's stolen and
    total CPU ticks from /proc/stat, or zeros where there is none)."""
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:]]
        steal, total = (ticks[7] if len(ticks) > 7 else 0), sum(ticks[:8])
    except (OSError, ValueError):
        steal = total = 0
    return time.process_time(), steal, total


class Driver:
    n_streams: int
    window_samples: int      # samples of one stream in one dispatch window

    def __init__(self, cfg: dict, traffic, device):
        self.cfg = cfg
        self.traffic = traffic
        self.device = device
        self.handoff: list[float] = []
        self.frames: list = []
        self.events: list = []
        self.spans: list = []
        self.spans_on = False
        self.skip = None
        self._k = 0              # next traffic block
        self._drained = 0

    # ------------------------------------------------------ what drivers call

    def _mark(self, farm) -> None:
        d = farm.stats["drained_samples"]
        if d != self._drained:
            self._drained = d
            self.events.append((time.perf_counter(), d, dict(farm.stats),
                                host_clock()))

    def _next_block(self):
        """(traffic block to hand over, or None when the control drops
        it); advances the traffic."""
        k = self._k
        self._k += 1
        if self.skip is not None and self.skip(k):
            return None
        return self.traffic.block(k)

    def _span_farm(self, farm) -> None:
        """Record host spans around the farm's device pass (its IO thread)
        and each window's walk (the caller's side), when spans_on."""
        spans = self.spans
        dev_pass = farm._device_pass

        def device_pass(batch, base0):
            t0 = time.perf_counter()
            try:
                return dev_pass(batch, base0)
            finally:
                if self.spans_on:
                    spans.append((t0, time.perf_counter(), "device_pass"))

        farm._device_pass = device_pass
        drain = farm._pipe.drain

        def drain_spanned(walk, block, on_wait=None):
            def walk_spanned(batch, result):
                t0 = time.perf_counter()
                walk(batch, result)
                if self.spans_on:
                    spans.append((t0, time.perf_counter(), "walk"))
            return drain(walk_spanned, block, on_wait)

        farm._pipe.drain = drain_spanned

    # ----------------------------------------------------- what the harness calls

    @property
    def drained(self) -> int:
        return self._drained

    def run_until(self, stop) -> None:  # pragma: no cover - per entry
        raise NotImplementedError

    def finish(self, timeout: float = 120.0) -> None:  # pragma: no cover
        """Emit every frame due in the window (the flush may add late
        ones) and stop every thread the entry started."""
        raise NotImplementedError
