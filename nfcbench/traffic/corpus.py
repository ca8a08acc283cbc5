"""The generator of recorded-session corpora (``"generator": "corpus"``).

It writes a ring of whole recordings at 10 MS/s, as a receiver records
sessions to WAV files, and the table of every frame and field edge in
them; its ``judge`` holds a run's frames to that table.

The ring alternates two kinds of session, built from the five templates
of ``synth.py`` (imported, not copied), each round of them in an order
drawn for it:

- *transaction*: the carrier on throughout, ``transaction_rounds``
  rounds back to back (a reader in a continuous exchange);
- *polling*: ``polling_periods`` periods of ``field_on_guard_samples`` of
  steady carrier, a round, and ``field_off_samples`` with the field off
  (a reader polling with its RF off between loops).

Recording 2i is a transaction of the i-th of ``transaction_rounds`` and
recording 2i + 1 a polling session of the i-th of ``polling_periods``:
every seed gives a ring of the same recordings' lengths and the same
frames, in another order within each round, with other gain, offset (on
the carrier) and noise, so two seeds ask for the same work.  Where the
lists balance (``corpus.json``'s do, four recordings at a time), so does
every call that hands over such a run.  Every recording holds whole
rounds, so no frame crosses either of its ends, and its length is no
multiple of a block.

The line: the recordings handed over, laid end to end (recording k at
the k-th place, the ring repeating), is where ``judge`` reads positions.
A recording's first sample, where the carrier is already on, is no field
edge the program owes: a decoder starts each capture knowing nothing of
the field, so the carrier events it emits there (within ``carrier_lag``)
match the recording's start and nothing is due.  Nothing here imports
the program.
"""

from __future__ import annotations

import bisect

import numpy as np

from ..check import CARRIER_OFF, CARRIER_ON, CARRIERS, ERROR_FLAGS
from ..check import _index, _overlaps, emitted
from .synth import RATE, templates

KINDS = ("transaction", "polling")


def _recording(tpl: dict, names: list, kind: str, count: int, mix: dict,
               rng) -> tuple:
    """(samples, frames, edges) of one recording, in its own coordinates."""
    g_lo, g_hi = mix["gain"]
    offset, sigma = float(mix["offset"]), float(mix["noise_sigma"])
    gain = np.float32(rng.uniform(g_lo, g_hi))
    off = np.float32(rng.uniform(-offset, offset))
    polling = kind == "polling"
    guard = int(mix["field_on_guard_samples"]) if polling else 0
    off_len = int(mix["field_off_samples"]) if polling else 0
    parts, frames, edges, at = [], [], [], 0
    for p in range(count):
        order = [names[j] for j in rng.permutation(len(names))]
        carrier = [np.full(guard, tpl[order[0]].samples[0], np.float32)]
        at += guard
        for n in order:
            frames += [f._replace(start=f.start + at, end=f.end + at)
                       for f in tpl[n].frames]
            carrier.append(tpl[n].samples)
            at += len(tpl[n].samples)
        parts.append(np.concatenate(carrier) * gain + off)
        if polling:
            edges.append((CARRIER_OFF, at))
            parts.append(np.zeros(off_len, np.float32))
            at += off_len
            if p + 1 < count:
                edges.append((CARRIER_ON, at))
    x = np.concatenate(parts).astype(np.float32)
    x += rng.standard_normal(len(x), dtype=np.float32) * np.float32(sigma)
    return x, frames, edges


class Traffic:
    """A ring of recordings on one line: ``block(k)`` is the k-th recording
    handed over, [1, samples] float32 (recording k % ring);
    ``frames[0]``, ``edges`` and ``starts`` are the ring's frames, field
    edges and recordings' first samples on the line; ``period`` is the
    ring's length."""

    def __init__(self, mix: dict, seed: int, n_streams: int, width: int,
                 rate: int = RATE):
        if int(rate) != RATE:
            raise ValueError(f"the corpus is written at {RATE} samples/s; "
                             f"the configuration runs at {rate}")
        if int(n_streams) != 1:
            raise ValueError("the corpus is one line of recordings: "
                             "streams must be 1")
        tpl = templates(int(mix.get("template_seed", 7)))
        names = list(mix["templates"])
        counts = (list(mix["transaction_rounds"]),
                  list(mix["polling_periods"]))
        if len(counts[0]) != len(counts[1]) or min(counts[0] + counts[1]) < 1:
            raise ValueError("transaction_rounds and polling_periods: as "
                             "many counts each, each at least 1")
        s = int(seed) % (1 << 64)
        self.width = width
        self.n_streams = 1
        self.recordings: list[np.ndarray] = []
        self.kinds: list[str] = []
        self.starts: list[int] = []
        self.edges: list[tuple[int, int]] = []
        frames, at = [], 0
        for j in range(2 * len(counts[0])):
            kind = KINDS[j % 2]
            count = int(counts[j % 2][j // 2])
            x, fr, ed = _recording(tpl, names, kind, count, mix,
                                   np.random.default_rng([s, j]))
            self.recordings.append(x)
            self.kinds.append(kind)
            self.starts.append(at)
            frames += [f._replace(start=f.start + at, end=f.end + at)
                       for f in fr]
            self.edges += [(kind_, p + at) for kind_, p in ed]
            at += len(x)
        self.frames = [frames]
        self.period = at

    @property
    def ring(self) -> int:
        return len(self.recordings)

    def block(self, k: int) -> np.ndarray:
        return self.recordings[k % self.ring][None, :]

    def _between(self, items: list, pos, lo: int, hi: int) -> list:
        out = []
        for k in range(max(lo, 0) // self.period, hi // self.period + 1):
            at = k * self.period
            out += [(it, at) for it in items if pos(it, at)]
        return out

    def frames_between(self, i: int, lo: int, hi: int) -> list:
        """The frames that lie wholly in samples [lo, hi) of the line."""
        return [f._replace(start=f.start + at, end=f.end + at)
                for f, at in self._between(
                    self.frames[i], lambda f, at: lo <= f.start + at
                    and f.end + at <= hi, lo, hi)]

    def edges_between(self, lo: int, hi: int) -> list[tuple[int, int]]:
        """Field edges (kind, sample) in [lo, hi): the ones a run owes."""
        return [(kind, p + at) for (kind, p), at in self._between(
            self.edges, lambda e, at: lo <= e[1] + at < hi, lo, hi)]

    def starts_between(self, lo: int, hi: int) -> list[int]:
        """The first samples of the recordings that start in [lo, hi)."""
        return [p + at for p, at in self._between(
            self.starts, lambda p, at: lo <= p + at < hi, lo, hi)]


def judge(frames: list, traffic, lo: int, hi: int, limits: dict) -> dict:
    """The numbers compared for one run (the generator's interface), from
    (stream, program frame, whether it came back in the window) for every
    frame the run emitted and [lo, hi), the window's samples of the line:
    ``judge_emitted`` over their plain fields."""
    return judge_emitted([emitted(*x) for x in frames], traffic, lo, hi,
                         limits)


def judge_emitted(emitted_: list, traffic, lo: int, hi: int,
                  limits: dict) -> dict:
    """``check.judge`` for one line of recordings, but at the recordings'
    starts: a carrier event of either kind within ``carrier_lag`` after
    one matches it, and none is due there; and a due field edge is found
    only by an event before the next recording starts (a capture is
    decoded alone)."""
    lag_lim = float(limits["carrier_lag_max"])
    span = max([e.end for e in emitted_] + [hi]) + traffic.period
    refs = _index(traffic.frames_between(0, 0, span))
    known: dict = {}
    for kind, p in traffic.edges_between(0, span):
        known.setdefault(kind, []).append(p)
    for p in traffic.starts_between(0, span):
        for kind in CARRIERS:
            known.setdefault(kind, []).append(p)
    for ps in known.values():
        ps.sort()
    starts_all = traffic.starts_between(0, span)
    got = _index(e for e in emitted_ if e.kind not in CARRIERS)
    got_carriers: dict = {}
    missing = unmatched = due = 0
    lag_max = 0.0
    for e in emitted_:
        if e.kind in CARRIERS:
            got_carriers.setdefault(e.kind, []).append(e.start)
        if not e.in_window:
            continue
        if e.kind in CARRIERS:
            ps = known.get(e.kind, [])
            k = bisect.bisect_right(ps, e.start) - 1
            lag = float(e.start - ps[k]) if k >= 0 else float(traffic.period)
            lag_max = max(lag_max, lag)
            unmatched += lag > lag_lim
        else:
            unmatched += bool(e.flags & ERROR_FLAGS) or not _overlaps(refs, e)
    for r in traffic.frames_between(0, lo, hi):
        due += 1
        missing += not _overlaps(got, r)
    for kind, p in traffic.edges_between(lo, hi - int(lag_lim)):
        due += 1
        # the event comes from the edge's own capture: before the next
        # recording starts
        n = bisect.bisect_right(starts_all, p)
        until = min(p + lag_lim, starts_all[n] - 1 if n < len(starts_all)
                    else p + lag_lim)
        starts = sorted(got_carriers.get(kind, []))
        k = bisect.bisect_left(starts, p)
        missing += not (k < len(starts) and starts[k] <= until)
    return {"due": due, "missing": missing, "unmatched": unmatched,
            "carrier_lag_max": lag_max}
