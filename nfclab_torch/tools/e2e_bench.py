"""End-to-end capture->frames benchmark and host<->card link figures.

Counterpart of ``nfclab/tools/e2e_bench.py``.  Prints one JSON object:
the aggregate samples/s over every WAV of a directory for each frontend
(host / mask / fused, ``apps/bench_cli.bench_decode``), the host
frontend's worker-scaling curve, and the measured link between the host
and the card that the device frontends' traffic crosses.

This is a different claim from a kernel-only rate: the kernels' own
times are measured on card-resident data with carried state
(``chip_smoke.py``); this tool measures the whole system, WAV read, host
conditioning, host<->card transfers and the event walk, which is what a
deployment sees.

The host scaling curve runs first, before CUDA is initialized: the
process pool forks its workers only while CUDA is untouched
(``runtime/batch._fork_ok``).  Then the frontends run on ``--device``,
then the link is measured (on the card only).

Usage: python -m nfclab_torch.tools.e2e_bench WAV_DIR [--out E2E.json]
[--device cpu] (nfclab's tool reads the reference decoder's fixture
directory).  Exit 1, with a message, when no directory is given or it
holds no WAV, or there is no card (``--device cpu`` runs the kernels'
plain versions).
"""

from __future__ import annotations

import json
import sys
import time


def _measure_link(device) -> dict:
    """Host<->card transfer rates, each ended by a device sync: a 32 MB
    pageable host array up and back, and the round trip of a one-element
    reduction read with ``.item()``."""
    import numpy as np
    import torch

    def sync(a):
        return a[:, -1].sum().item()

    x = np.random.rand(256, 32768).astype(np.float32)  # 32 MB
    d = torch.from_numpy(x).to(device)
    sync(d)  # warm the allocator and the reduction
    torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    d = torch.from_numpy(x).to(device)
    torch.cuda.synchronize(device)
    up = x.nbytes / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    h = d.cpu()
    torch.cuda.synchronize(device)
    down = h.numel() * 4 / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    for _ in range(5):
        sync(d)
    dispatch = (time.perf_counter() - t0) / 5
    return {
        "upload_MBps": round(up / 1e6, 1),
        "download_MBps": round(down / 1e6, 1),
        "dispatch_floor_s": round(dispatch, 6),
    }


def _burn(n: int = 12_000_000) -> float:
    x = 0
    t0 = time.perf_counter()
    for i in range(n):
        x += i * i
    return time.perf_counter() - t0


def _cpu_capacity() -> dict:
    """Calibrate how much PARALLEL cpu this host actually delivers: a
    pure-Python burn single vs two concurrent processes.  Cloud VMs
    advertise N vcpus but may deliver ~1 core of cycles (observed on this
    host class: two burns take exactly 2x one burn — zero parallelism);
    the walk-scaling curve is only interpretable against this ceiling."""
    import multiprocessing as mp

    single = min(_burn(), _burn())
    ctx = mp.get_context("fork")
    t0 = time.perf_counter()
    ps = [ctx.Process(target=_burn) for _ in range(2)]
    for p in ps:
        p.start()
    for p in ps:
        p.join()
    dual = time.perf_counter() - t0
    speedup = 2.0 * single / dual if dual > 0 else 0.0
    return {
        "burn_single_s": round(single, 3),
        "burn_dual_wall_s": round(dual, 3),
        "parallel_speedup_ceiling": round(speedup, 2),
    }


def scaling_curve(paths: list[str], reps: int) -> dict:
    """The host frontend's aggregate rate over worker counts (serial,
    threads x2..xN, a persistent process pool of N), best of max(reps, 6)
    each, beside the host's measured parallel ceiling.  The host frontend
    never touches the card, so it runs with device="cpu": nothing here
    initializes CUDA."""
    import os

    from ..apps.bench_cli import bench_decode
    from ..runtime.batch import shutdown_pools

    ncpu = os.cpu_count() or 1
    cap = _cpu_capacity()
    out = {"cpus": ncpu, "cpu_capacity": cap, "curve": []}
    configs = [("serial", "process", 1, False)]
    for w in range(2, ncpu + 1):
        configs.append((f"thread_x{w}", "thread", w, False))
    if ncpu >= 2:
        configs.append((f"process_x{ncpu}", "process", ncpu, True))
    base = None
    for label, pool, w, kp in configs:
        best = None
        # best of 6: single reps of a walk-bound run under-read on a host
        # whose page-fault path is noisy
        for _ in range(max(reps, 6)):
            r = bench_decode(paths, frontend="host", workers=w, pool=pool,
                             keep_pool=kp, device="cpu")
            if best is None or r["value"] > best["value"]:
                best = r
        entry = {
            "config": label,
            "workers": w,
            "pool": pool,
            "value": round(best["value"]),
            "unit": "samples/s",
        }
        if kp:
            entry["persistent_pool"] = True
        if label == "serial":
            base = best["value"]
        elif base:
            entry["speedup_vs_serial"] = round(best["value"] / base, 3)
            if cap["parallel_speedup_ceiling"] > 0:
                entry["efficiency_vs_cpu_ceiling"] = round(
                    (best["value"] / base)
                    / min(cap["parallel_speedup_ceiling"], w), 3,
                )
        out["curve"].append(entry)
    shutdown_pools()
    out["note"] = (
        "capture->frames over every WAV of the directory with the host "
        "frontend; the host walk is the ceiling (CPU-bound). speedups are "
        "only meaningful against cpu_capacity.parallel_speedup_ceiling "
        "(two pure-Python burns in two processes against one); "
        "efficiency_vs_cpu_ceiling normalizes for it. The process pool is "
        "persistent (forked before CUDA is initialized, path-only jobs, "
        "warm worker heaps: runtime/batch.persistent_pool)."
    )
    return out


def main(argv=None) -> int:
    import argparse
    import glob

    from ..apps.bench_cli import bench_decode
    from ..core.malloc_tune import malloc_tune
    from ..dsp.cuda_channels import DeviceUnavailable, resolve_device

    malloc_tune()  # bench-only: recycle large buffers without refaulting

    ap = argparse.ArgumentParser(prog="nfclab-torch-e2e-bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("wav_dir", nargs="?")
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--frontends", nargs="*", default=["host", "mask", "fused"]
    )
    ap.add_argument("--reps", type=int, default=2,
                    help="per frontend; the best rep is reported (the "
                    "first pays the kernels' build)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    if args.wav_dir is None:
        print("error: give the directory of WAV captures (see --help)",
              file=sys.stderr)
        return 1
    paths = sorted(glob.glob(f"{glob.escape(args.wav_dir)}/*.wav"))
    if not paths:
        print(f"error: no WAV in {args.wav_dir}", file=sys.stderr)
        return 1
    try:
        dev = resolve_device(args.device)
    except DeviceUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    out: dict = {"fixtures": len(paths), "modes": {}}
    out["aggregate_scaling"] = scaling_curve(paths, args.reps)

    for frontend in args.frontends:
        best = None
        for _ in range(args.reps):
            r = bench_decode(paths, frontend=frontend, device=dev)
            if best is None or r["value"] > best["value"]:
                best = r
        best["value"] = round(best["value"])
        out["modes"][frontend] = best

    out["link"] = _measure_link(dev) if dev.type == "cuda" else None

    # device-frontend traffic per sample (f32 in; per-mode fetch out)
    out["bytes_per_sample"] = {
        "upload_i16_input": 2.0,
        "upload_f32_input_offgrid": 4.0,
        "fused_fetch": 37.0,  # 9 box f32 + mask u8
        "mask_fetch": 1.0,
    }
    out["note"] = (
        "capture->frames aggregate over every WAV of the directory, wall "
        "clock, serial host walk. A device frontend's rate is at most "
        "link_Bps / bytes_per_sample for its upload and for its fetch "
        "(the mask fetch is the compacted triggers, at most 1 B a "
        "sample); the kernels' own times (chip_smoke.py) are a different "
        "claim, on card-resident data."
    )
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
