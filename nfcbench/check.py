"""The comparison that decides ``correct`` for the radio mixes of
``traffic/synth.py`` (their generator's ``judge``): every frame the
program emitted in the window, and every frame due in it, against the
frames the generator wrote (plain Python and numpy; nothing of the
program).

The generator knows each frame's technology, direction, bytes and the
samples its symbols occupy, and where the field goes off and on.  An
emitted frame is taken as its plain fields (tech, type, flags, data,
sample_start, sample_end), so the comparison never sees a program object.

- A data frame (poll or listen) is right when a written frame of the same
  technology, direction and bytes overlaps its samples and it carries no
  error flag.  Overlap needs no tolerance: the written bounds are the
  symbols themselves, and equal bytes recur only a period later.
- A carrier event is right when a field edge of its kind lies within
  ``carrier_lag`` samples before it (the decoder sees an edge only after
  it): the limit is set from readings (PERF.md).
- A written frame or field edge that lies wholly in the window's samples
  is due: it has to be among everything the run emitted, the flush after
  the window included (late is not wrong).

The numbers compared, each with its limit: ``missing`` (due, never
emitted; limit 0), ``unmatched`` (emitted in the window, matching
nothing written; limit 0) and ``carrier_lag_max`` (the farthest carrier
event of the window from its edge, in samples).
"""

from __future__ import annotations

import bisect
import typing

# the program's Frame codes (RawFrame.h), as plain numbers
TECH = {"nfca": 0x0101, "nfcb": 0x0102, "nfcf": 0x0103, "nfcv": 0x0104}
POLL, LISTEN = 0x0102, 0x0103
CARRIER_OFF, CARRIER_ON = 0x0100, 0x0101
# Truncated, ParityError, CrcError, SyncError (RawFrame.h)
ERROR_FLAGS = 0x08 | 0x10 | 0x20 | 0x40
CARRIERS = (CARRIER_OFF, CARRIER_ON)


class Emitted(typing.NamedTuple):
    stream: int
    tech: int
    kind: int
    flags: int
    data: bytes
    start: int
    end: int
    in_window: bool


def _index(items) -> dict:
    """(tech, kind, data) -> (sorted starts, [(start, end)]) of frames
    without an error flag; frames of one key never overlap each other."""
    out: dict = {}
    for f in items:
        if getattr(f, "flags", 0) & ERROR_FLAGS:
            continue
        out.setdefault((f.tech, f.kind, f.data), []).append((f.start, f.end))
    for key, spans in out.items():
        spans.sort()
        out[key] = ([a for a, _ in spans], spans)
    return out


def _overlaps(index: dict, f) -> bool:
    """Whether a frame of f's key in `index` overlaps f's samples: only
    the last one starting at or before f's end can."""
    got = index.get((f.tech, f.kind, f.data))
    if got is None:
        return False
    k = bisect.bisect_right(got[0], f.end) - 1
    return k >= 0 and got[1][k][1] >= f.start


def _carrier_lag(e: Emitted, edges: dict, period: int) -> float:
    """Samples from the last field edge of e's kind at or before e; a
    whole period where there is none (a mix whose field never drops)."""
    ps = edges.get(e.kind, [])
    k = bisect.bisect_right(ps, e.start) - 1
    return float(e.start - ps[k]) if k >= 0 else float(period)


def emitted(stream: int, f, in_window: bool) -> Emitted:
    """A program frame's plain fields."""
    return Emitted(stream, int(f.tech_type), int(f.frame_type),
                   int(f.frame_flags), bytes(f.data), int(f.sample_start),
                   int(f.sample_end), in_window)


def judge_frames(frames: list, traffic, lo: int, hi: int,
                 limits: dict) -> dict:
    """`judge` over (stream, program frame, in the window) triples."""
    return judge([emitted(*x) for x in frames], traffic, lo, hi, limits)


def judge(emitted: list, traffic, lo: int, hi: int, limits: dict) -> dict:
    """Numbers compared for one run.  `emitted`: every Emitted of the run;
    [lo, hi): the window's samples of each stream (what was walked between
    the drain events that open and close it)."""
    lag_lim = float(limits["carrier_lag_max"])
    missing = unmatched = due = 0
    lag_max = 0.0
    by_stream: dict = {}
    for e in emitted:
        by_stream.setdefault(e.stream, []).append(e)
    for i in range(traffic.n_streams):
        mine = by_stream.get(i, [])
        span = max([e.end for e in mine] + [hi]) + traffic.period
        refs = _index(traffic.frames_between(i, 0, span))
        edges: dict = {}
        for kind, p in traffic.edges_between(0, span):
            edges.setdefault(kind, []).append(p)
        got = _index(e for e in mine if e.kind not in CARRIERS)
        got_carriers: dict = {}
        for e in mine:
            if e.kind in CARRIERS:
                got_carriers.setdefault(e.kind, []).append(e.start)
            if not e.in_window:
                continue
            if e.kind in CARRIERS:
                lag = _carrier_lag(e, edges, traffic.period)
                lag_max = max(lag_max, lag)
                unmatched += lag > lag_lim
            else:
                unmatched += bool(e.flags & ERROR_FLAGS) or not _overlaps(
                    refs, e)
        for r in traffic.frames_between(i, lo, hi):
            due += 1
            missing += not _overlaps(got, r)
        for kind, p in traffic.edges_between(lo, hi - int(lag_lim)):
            due += 1
            starts = sorted(got_carriers.get(kind, []))
            k = bisect.bisect_left(starts, p)
            missing += not (k < len(starts) and starts[k] <= p + lag_lim)
    return {"due": due, "missing": missing, "unmatched": unmatched,
            "carrier_lag_max": lag_max}

