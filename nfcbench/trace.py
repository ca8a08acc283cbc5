"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) from
before the entry is built to the close of the window, read back from its
Chrome trace and cut to the window.

The profiler's clock is tied to ``time.perf_counter`` by an anchor: a
``record_function`` span whose perf_counter time is noted as it opens.
Device activity is every event of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; ``busy_s`` is the length of their
union inside the window.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

ANCHOR = "nfcbench.anchor"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Profile:
    """Start the profiler now; ``stop()`` ends it and returns the raw
    Chrome trace events and the perf_counter time of the anchor."""

    def __init__(self):
        import torch

        act = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=act)
        self._prof.start()
        with torch.profiler.record_function(ANCHOR):
            self.anchor = time.perf_counter()

    def stop(self) -> dict:
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.unlink(path)
        return {"events": raw.get("traceEvents", raw), "anchor": self.anchor}


def _short(name: str) -> str:
    """A kernel's name without its argument list, at most 100 letters."""
    if name.startswith("void "):
        name = name.split("(", 1)[0]
    return name[:100]


def device_intervals(raw: dict, t_open: float, t_close: float) -> list:
    """(start, end, name) of device events on the perf_counter clock,
    clipped to [t_open, t_close]."""
    events = raw["events"]
    marks = [e for e in events if e.get("name") == ANCHOR and "ts" in e]
    if not marks:
        raise ValueError("the trace holds no anchor")
    ts0 = float(marks[0]["ts"])
    out = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a = raw["anchor"] + (float(e["ts"]) - ts0) * 1e-6
        b = a + float(e["dur"]) * 1e-6
        a, b = max(a, t_open), min(b, t_close)
        if b > a:
            out.append((a, b, _short(str(e.get("name", "?")))))
    out.sort()
    return out


def summarize(intervals: list, t_open: float, t_close: float,
              spans: list) -> dict:
    """busy_s (the union), seconds by device op, and the idle gaps named
    by the host span that covers each gap's middle."""
    busy, ops, gaps = 0.0, {}, []
    cur_a = cur_b = None
    edge = t_open
    for a, b, name in intervals:
        ops[name] = ops.get(name, 0.0) + (b - a)
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            if a > edge:
                gaps.append((edge, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        edge = max(edge, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    if t_close > edge:
        gaps.append((edge, t_close))
    named: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        live = {n for s, e, n in spans if s <= mid <= e}
        label = ("device_pass (host side)" if "device_pass" in live
                 else "walk" if "walk" in live else "feed (no farm span)")
        named.setdefault(label, []).append(b - a)
    longest = sorted(((lab, g) for lab, gs in named.items() for g in gs),
                     key=lambda x: -x[1])[:10]
    return {
        "busy_s": busy,
        "window_s": t_close - t_open,
        "ops": ops,
        "device_ops": sorted(ops.items(), key=lambda x: -x[1])[:10],
        "idle_gaps": [[lab, g] for lab, g in longest],
    }
