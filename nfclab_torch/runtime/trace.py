"""Host spans of the live mask path and of batch decode, on the clock of
``time.perf_counter``.

A span is one step of the program on one thread: a tuple of its name, its
start and end, the thread's name, its parent span's id (None at the top)
and its own id, with a dict of arguments (a dispatch window's ``seq`` and
sample range ``lo``/``hi``, a block's sample ``offset``, a repair's
``stream`` and ``chunks``).  Spans go into one bounded in-memory ring for
the process while ``enable()`` is in force or while a ``torch.profiler``
session records; otherwise a span site checks those two flags and does
nothing else.

While a profiler records, a span also opens a ``record_function`` range of
its name, so it sits in the profiler's trace on the profiler's own clock
(through ``_RecordFunctionFast``, which keeps the interpreter lock: a
range opened as an operator call hands the lock away and may wait up to
a switch interval to get it back).
A profiler records the ranges of the threads it profiles: the thread that
started it, or every thread under
``torch.profiler._ExperimentalConfig(profile_all_threads=True)``.

Waits (``record``: a block's time in the decoder task's queue, the farm's
IO thread idle between windows, the caller blocked on a window) are spans
measured when they end; they go to the ring and to ``export``, not to the
profiler.

The spans of the live path (``nfclab_torch/runtime/pipeline.py`` and
``farm.py``, ``dsp/cuda_channels.py``):

- ``task.queued`` (a block's put to its get in RadioDecoderTask's
  ``signal_queue``), ``task.feed``, ``task.publish``: the task's thread;
- ``farm.stage`` (a feed's staging and launch), ``farm.wait``,
  ``farm.walk``: the farm's caller; ``farm.walk.stream``: a walk thread;
- ``farm.io_idle``, ``farm.device_pass`` (``kind``: serial, segmented,
  backoff or flush) and its steps ``upload``, ``launch``, ``compact``,
  ``fetch``, ``verify``, ``repair`` (which nests its own steps) and
  ``carry``: the farm's IO thread.

The spans of batch decode (``runtime/batch.py``, ``dsp/conditioner.py``),
on the calling thread: ``batch.read``, ``batch.condition`` (``samples``)
with the device conditioner's ``cond.upload``, ``cond.pass1``,
``cond.verify`` (a ``cond.repair`` under it for each repaired ``block``),
``cond.fetch`` and ``cond.edge_tracker`` under it, ``batch.pool`` and
``batch.walk``; with the mask frontend ``batch.condition_native`` (a
capture's native conditioning) and ``batch.masks_wait`` on the calling
thread, and ``batch.masks`` (the device pass, with the engine's steps
under it) on a thread of its own.

Every step of these, and of the offline engines (``chained_batch_masks``,
``_run_batch_chained``, ``fused_batch_all``), goes through one ``Lap``,
which adds its host seconds to the caller's always-on counters and is its
span while spans record.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import NamedTuple

import torch.autograd.profiler as _prof
from torch._C._profiler import _RecordFunctionFast

CAPACITY = 1 << 17  # spans the ring keeps: minutes of the live path


class Span(NamedTuple):
    name: str
    start: float
    end: float
    thread: str
    parent: int | None
    id: int
    args: dict | None


_ring: deque = deque(maxlen=CAPACITY)
_on = False
_ids = itertools.count(1)
_local = threading.local()


class _Enabled:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        disable()
        return False


def enable() -> _Enabled:
    """Record spans from now on (``with enable():`` records until the
    block ends)."""
    global _on
    _on = True
    return _Enabled()


def disable() -> None:
    """Stop recording (a profiler session still records while it runs)."""
    global _on
    _on = False


def active() -> bool:
    """True while spans are recorded: enabled, or a profiler records."""
    return _on or _prof._is_profiler_enabled


def clear() -> None:
    _ring.clear()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Off:
    """The span of a site while nothing records."""

    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "parent", "args", "id", "start", "_rf")

    def __init__(self, name: str, parent: int | None, args: dict | None):
        self.name = name
        self.parent = parent
        self.args = args
        self.id = next(_ids)
        self._rf = None

    def __enter__(self):
        st = _stack()
        if self.parent is None and st:
            self.parent = st[-1].id
        st.append(self)
        if _prof._is_profiler_enabled:
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        st = _stack()
        # spans an error left open above this one close with it, unrecorded
        while st:
            top = st.pop()
            if top._rf is not None:
                top._rf.__exit__(None, None, None)
                top._rf = None
            if top is self:
                break
        _ring.append(Span(self.name, self.start, end,
                          threading.current_thread().name, self.parent,
                          self.id, self.args))
        return False


def span(name: str, parent: int | None = None, **args):
    """``with span(name, **args) as s:`` records the block as a span (its
    parent the innermost span open on this thread, unless `parent` names
    one on another thread; ``s.id`` is its id, None while nothing
    records)."""
    if not (_on or _prof._is_profiler_enabled):
        return _OFF
    return _Open(name, parent, args or None)


def record(name: str, start: float, end: float, parent: int | None = None,
           **args) -> None:
    """Record a wait measured once it ended, [start, end] on perf_counter,
    under the innermost span open on this thread unless `parent` is
    given."""
    if not (_on or _prof._is_profiler_enabled):
        return
    if parent is None:
        st = getattr(_local, "stack", None)
        parent = st[-1].id if st else None
    _ring.append(Span(name, start, end, threading.current_thread().name,
                      parent, next(_ids), args or None))


def add_counts(stats: dict | None, **counts) -> None:
    """Add each count to what `stats`, a caller's always-on counters, holds
    under its key; nothing where `stats` is None."""
    if stats is not None:
        for k, v in counts.items():
            stats[k] = stats.get(k, 0) + v


class Lap:
    """The steps of one pass of a program, always on: ``with
    lap.step(name, **args):`` adds the block's host seconds to
    ``stats[counters[name]]`` (nothing where `stats` is None) and, while
    spans record, is a span of `name` with `args` (and ``seq`` where the
    lap has one).  No step makes a device sync.

    The steps tile the lap from its making: a step counts from the end of
    the lap's previous step to its own end, so what runs between two
    steps counts in the second (the kernels an engine queues without a
    sync count in the step that waits for them).  A step opened inside
    another step of the same lap counts its own block alone, and the
    enclosing step leaves it out."""

    __slots__ = ("stats", "counters", "_args", "_t", "_open")

    def __init__(self, stats: dict | None = None,
                 counters: dict | None = None, seq: int | None = None):
        self.stats = stats
        self.counters = counters
        self._args = {} if seq is None else {"seq": seq}
        self._t = time.perf_counter()
        self._open: list = []

    def _count(self, name: str) -> None:
        now = time.perf_counter()
        if self.stats is not None:
            key = self.counters[name]
            self.stats[key] = self.stats.get(key, 0.0) + (now - self._t)
        self._t = now

    @contextlib.contextmanager
    def step(self, name: str, **args):
        if self._open:
            self._count(self._open[-1])
        self._open.append(name)
        try:
            with span(name, **self._args, **args):
                yield
        finally:
            self._open.pop()
        self._count(name)

    def nested(self) -> "Lap":
        """The lap of an engine call inside the open step (a repair's
        serial chain): its steps are spans with this lap's ``seq`` while
        spans record, and count in the enclosing step alone."""
        return Lap(None, None, self._args.get("seq"))


def spans(t0: float | None = None, t1: float | None = None) -> list:
    """The ring's spans that overlap [t0, t1] on perf_counter (all by
    default), in the order they ended."""
    got = list(_ring)  # one C-level copy: no thread appends meanwhile
    lo = float("-inf") if t0 is None else t0
    hi = float("inf") if t1 is None else t1
    return [s for s in got if s.end >= lo and s.start <= hi]


def export(path, t0: float | None = None, t1: float | None = None) -> int:
    """Write the spans that overlap [t0, t1] to `path` as Chrome-trace JSON
    (chrome://tracing, Perfetto): one complete event each, its time in
    microseconds of perf_counter, id, parent and arguments under
    ``args``.  Returns the number of spans written."""
    got = spans(t0, t1)
    pid = os.getpid()
    tids: dict = {}
    events = []
    for s in got:
        tid = tids.setdefault(s.thread, len(tids) + 1)
        events.append({"name": s.name, "ph": "X", "pid": pid, "tid": tid,
                       "ts": s.start * 1e6, "dur": (s.end - s.start) * 1e6,
                       "args": {"id": s.id, "parent": s.parent,
                                **(s.args or {})}})
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": name}} for name, tid in tids.items()]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": meta + events, "displayTimeUnit": "ms"}, f)
    return len(got)
