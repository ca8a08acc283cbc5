"""Reading the port's live monitor (nfclab_torch.apps.monitor) over HTTP
and holding its snapshot to what `decode_cli live --json` printed: used by
tests/test_torch_reports.py and chip_smoke.py phase 13 (numpy-free, no
nfclab import).

- ``PolledMonitor``: a MonitorServer that GETs its own ``/`` and ``/data``
  just before it stops (the last snapshot, taken after the session's last
  frame), and, given an interval, polls ``/data`` while it runs.  Put it
  in place of ``nfclab_torch.apps.monitor.MonitorServer`` before calling
  ``decode_cli.main``.
- ``check_snapshot``: the checks on the last snapshot.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

# the task statuses a radio session with --monitor publishes
STATUSES = ("radio.receiver", "radio.decoder", "fourier", "adaptive")
_EVENTS = {"CARRIER_ON": "CarrierOn", "CARRIER_OFF": "CarrierOff",
           "POLL": "Poll", "LISTEN": "Listen"}


def get(url: str, timeout: float = 10.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def polled_monitor(interval: float | None = None):
    """The PolledMonitor class (built on first use, so importing this
    module imports nothing of the port)."""
    from nfclab_torch.apps.monitor import MonitorServer

    class PolledMonitor(MonitorServer):
        instances: list = []

        def start(self):
            super().start()
            self.base = f"http://127.0.0.1:{self.port}"
            self.snaps, self.page, self.last = [], None, None
            self._halt = threading.Event()
            self._poller = None
            if interval is not None:
                self._poller = threading.Thread(target=self._poll,
                                                daemon=True)
                self._poller.start()
            PolledMonitor.instances.append(self)
            return self

        def _poll(self):
            while not self._halt.wait(interval):
                self.snaps.append(json.loads(get(self.base + "/data")))

        def stop(self):
            self._halt.set()
            if self._poller is not None:
                self._poller.join(timeout=30)
            self.page = get(self.base + "/").decode()
            self.last = json.loads(get(self.base + "/data"))
            super().stop()

    return PolledMonitor


def _line_row(line: str) -> tuple:
    obj = json.loads(line)
    return (round(obj["time_start"], 6), obj["tech"],
            _EVENTS.get(obj["type"], "?"), obj.get("data", ""),
            obj.get("rate", 0))


def _snap_row(row: dict) -> tuple:
    return (row["time"], row["tech"], row["event"], row["data"], row["rate"])


def check_snapshot(snap: dict, lines: list[str], details: list | None = None,
                   statuses=STATUSES, max_frames: int = 256) -> dict:
    """Raise AssertionError unless the last snapshot `snap` holds, in
    order, the last `max_frames` of the printed `lines` (the StreamModel
    columns, each decodable frame with a detail tree, equal to `details`
    where given: the port's ProtocolParser over the same frames), a
    spectrum of at least 64 bins, waterfall and wave rows, and the
    statuses.  Returns its counts."""
    rows = snap["frames"]
    want = [_line_row(ln) for ln in lines[-max_frames:]]
    if [_snap_row(r) for r in rows] != want:
        raise AssertionError("monitor frames != the last printed lines")
    if snap["total_frames"] != len(lines):
        raise AssertionError(f"monitor counted {snap['total_frames']} "
                             f"frames, the CLI printed {len(lines)}")
    for r in rows:
        if not {"id", "time", "delta", "rate", "tech", "event", "flags",
                "data", "detail"} <= set(r):
            raise AssertionError(f"monitor row without its columns: {r}")
    got = [r["detail"] for r in rows]
    if details is not None and got != details[-max_frames:]:
        raise AssertionError("monitor detail trees != the parser's")
    polls = [r for r in rows if r["event"] in ("Poll", "Listen")]
    if not polls or any(r["detail"] is None for r in polls):
        raise AssertionError("a decoded frame without its detail tree")
    if not snap["spectrum"] or len(snap["spectrum"]) < 64:
        raise AssertionError("monitor spectrum missing")
    if not snap["waterfall"] or not snap["wave"]:
        raise AssertionError("monitor waterfall or wave missing")
    missing = [s for s in statuses if s not in snap["status"]]
    if missing:
        raise AssertionError(f"monitor statuses missing: {missing}")
    return {"frames": len(rows), "total_frames": snap["total_frames"],
            "trees": sum(d is not None for d in got),
            "spectrum_bins": len(snap["spectrum"]),
            "waterfall_rows": len(snap["waterfall"]),
            "wave_points": len(snap["wave"]),
            "statuses": {s: snap["status"][s].get("status")
                         for s in statuses}}


def wait_for(pred, timeout: float = 30.0, interval: float = 0.05) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()
