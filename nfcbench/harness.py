"""One run of one cell: load what ``BENCHMARK.json`` names, set up, warm up,
measure, check, report.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration at the ``file`` the benchmark gives, its traffic mix at
``nfcbench/traffic/<traffic>.json``, the mix's generator (which also
judges the run) at ``nfcbench/traffic/<generator>.py`` (see
``traffic/__init__.py``), the configuration's entry driver at
``nfcbench/drivers/<entry>.py`` and each metric's reader at
``nfcbench/metrics/<metric>.py``.  The limits of the comparison are in
``nfcbench/limits/<cell>.json``, else ``nfcbench/limits/default.json``;
each number they name is compared, and passes at or under its limit.

The window: after the warm-up (``warm_windows`` dispatch windows
walked), it opens at the next drain event and closes at the first drain
event ``seconds`` after it.  Between the two the walk finished whole
dispatch windows, so the samples drained over the time between is all
the work over all the time.  Then the memory peak is read, the program
walks on to emit every frame due in the window (late is not wrong),
every thread is stopped, and the comparison runs on the host.  With
``--trace 1`` the profiler runs from before the entry is built to the
close of the window, and is read for the window alone.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load_module(path: Path, package: str = "nfcbench._found"):
    """Import the file at `path` (names may hold dots) as a module of
    `package`, so that its relative imports resolve there."""
    name = package + "._" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(spec: dict, workload: str, trace: bool) -> list:
    """The metrics this cell reports: its end-to-end ones, or with trace
    its per-layer ones; a metric with a ``workloads`` key only there."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key]
            if "workloads" not in m or workload in m["workloads"]]


class Window:
    """What the metric readers read: the window's clock, its drain events'
    counters and farm stats, the lags of its frames, its trace."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def delta(self, key: str) -> float:
        return self.stats_close[key] - self.stats_open[key]


def load_mix(name: str, root: Path = PKG / "traffic") -> dict:
    """The parameters of traffic mix `name` (``<root>/<name>.json``)."""
    path = Path(root) / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} at {path}")
    return json.loads(path.read_text())


def load_generator(mix: dict, pkg: Path = PKG):
    """The generator module that the mix names."""
    path = pkg / "traffic" / f"{mix['generator']}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic generator at {path}")
    return load_module(path, "nfcbench.traffic")


def verdict(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "ok"}} for each number the limits name."""
    return {name: {"value": numbers[name], "limit": lim,
                   "ok": numbers[name] <= lim}
            for name, lim in limits.items()}


def _limits(workload: str, pkg: Path = PKG) -> dict:
    own = pkg / "limits" / f"{workload}.json"
    return json.loads((own if own.is_file() else
                       pkg / "limits" / "default.json").read_text())


def _window_events(events: list, t_warm: float, seconds: float):
    """(open, close) drain events, or None while the window is open."""
    opened = next((e for e in events if e[0] > t_warm), None)
    if opened is None:
        return None
    closed = next((e for e in events if e[0] >= opened[0] + seconds), None)
    return None if closed is None else (opened, closed)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None, root: Path = ROOT,
             pkg: Path = PKG, setup_hook=None) -> dict:
    """Run one cell once; returns the result's fields (without `device`).
    `setup_hook(driver)`, when given, runs before the warm-up (the
    controls and the tests break the program there)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(root)
    cell = find(spec["workloads"], workload, "workload")
    conf = find(spec["configs"], cell["config"], "config")
    cfg = json.loads((Path(root) / conf["file"]).read_text())
    mix = load_mix(cell["traffic"], pkg / "traffic")
    gen = load_generator(mix, pkg)
    traffic = gen.Traffic(mix, seed, int(cfg["streams"]), int(cfg["block"]),
                          int(cfg["sample_rate"]))
    prof = None
    if trace:
        # started before the program: starting it (CUPTI) while the entry
        # runs stalls the entry for seconds
        from .trace import Profile

        prof = Profile()
    driver = load_module(pkg / "drivers" / f"{cfg['entry']}.py").Driver(
        cfg, traffic, device)
    if setup_hook is not None:
        setup_hook(driver)

    need = int(cfg["warm_windows"]) * driver.window_samples * driver.n_streams
    driver.run_until(lambda d: d.drained >= need)
    t_warm = time.perf_counter()
    driver.spans_on = trace
    found: list = []

    def closed(d):
        got = _window_events(d.events, t_warm, seconds)
        if got is not None:
            found.append(got)
        return got is not None

    driver.run_until(closed)
    (t_open, d_open, st_open, h_open), (t_close, d_close, st_close,
                                        h_close) = found[0]
    raw = prof.stop() if prof is not None else None
    driver.spans_on = False
    mem = _memory_peak(device)
    driver.finish()

    n = driver.n_streams
    bw = traffic.width
    lags, emitted = [], []
    for i, t, f in driver.frames:
        inside = t_open < t <= t_close
        if inside:
            k = max(f.sample_end - 1, 0) // bw
            lags.append(t - driver.handoff[min(k, len(driver.handoff) - 1)])
        emitted.append((i, f, inside))
    summary = None
    if raw is not None:
        from .trace import device_intervals, summarize

        summary = summarize(device_intervals(raw, t_open, t_close),
                            t_open, t_close, driver.spans)
    w = Window(setup_s=t_open - t_start, t_open=t_open, t_close=t_close,
               drained_open=d_open, drained_close=d_close,
               stats_open=st_open, stats_close=st_close, n_streams=n,
               window_samples=driver.window_samples, lags=lags,
               trace=summary, cfg=cfg, workload=workload)

    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        reader = load_module(pkg / "metrics" / f"{m['name']}.py")
        v = reader.read(w)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    limits = _limits(workload, pkg)
    numbers = gen.judge(emitted, traffic, d_open // n, d_close // n, limits)
    checks = verdict(numbers, limits)
    window_s = t_close - t_open
    ticks = h_close[2] - h_open[2]
    out = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": numbers["due"],
        "failed": numbers["missing"] + numbers["unmatched"],
        "metrics": metrics,
        "memory_peak_bytes": mem,
        # the host: cores this process kept busy on average, and the share
        # of the machine's CPU time taken by its hypervisor (steal)
        "diag": {"frames_in_window": len(lags), "window_s": window_s,
                 "samples": d_close - d_open,
                 "host_cores_busy": (h_close[0] - h_open[0]) / window_s,
                 "steal_share": ((h_close[1] - h_open[1]) / ticks
                                 if ticks > 0 else 0.0)},
    }
    if summary is not None:
        out["busy_s"] = summary["busy_s"]
        out["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": [list(x) for x in
                                           summary["device_ops"]],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return out


def _memory_peak(device) -> int:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(dev))

