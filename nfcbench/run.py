"""Run one cell of the benchmark once and print its result line.

    python3 nfcbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It needs as many CUDA cards as the cell
asks for and exits 1, printing no result, without them; there is no CPU
fallback.  The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, with --trace 1 breakdown, and last
the numbers compared with their limits); the same numbers are the last
lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """perf_counter time at which this process started (Linux; else now)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.perf_counter() - max(up - start, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = _process_start()
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every build and kernel cache inside the checkout, at fixed paths (the
# port's own nvcc and g++ builds already live in nfclab_torch/*/_build)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "nfcbench" / "_cache" / sub)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", action="append", default=[],
                    help="break the program (controls and fault checks "
                         "only; nfcbench/faults.py)")
    return ap.parse_args(argv)


def chips_needed(workload: str) -> int:
    from nfcbench.harness import find, load_spec

    return int(find(load_spec(ROOT)["workloads"], workload,
                    "workload")["chips"])


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    chips = chips_needed(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    from nfcbench import faults, guard
    from nfcbench.harness import run_cell

    torch.cuda.set_device(0)
    torch.cuda.reset_peak_memory_stats(0)
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=T_START,
                   setup_hook=faults.hook(args.fault))
    bad = guard.forbidden_loaded()
    if bad:
        print(f"error: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 1
    line = {
        "correct": res["correct"],
        "attempted": res["attempted"],
        "failed": res["failed"],
        "metrics": res["metrics"],
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": chips,
                   "memory_peak_bytes": res["memory_peak_bytes"]},
    }
    if args.trace:
        line["device"]["busy_s"] = res["busy_s"]
        line["device"]["window_s"] = res["window_s"]
        line["breakdown"] = res["breakdown"]
    line["diag"] = res["diag"]
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
