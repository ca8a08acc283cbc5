"""Throughput benchmark CLI of the port: dense frontend samples/s on a
device.

Counterpart of ``nfclab/apps/bench_cli.py``.  Measures the dense
frontend (``dsp.frontend.jitted_frontend``: the conditioning kernel, the
correlator channels and the masks) on ``--device`` (cuda unless asked for
the CPU) and, optionally, the end-to-end decode rate over WAV captures
(``runtime.batch.decode_batch``, with ``--frontend host|fused|mask``).
Each result names the device it ran on.

    python -m nfclab_torch.apps.bench_cli --batch 64 --span 81920
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def bench_frontend(batch: int, span: int, reps: int, device="cuda") -> dict:
    from ..dsp.cuda_channels import resolve_device
    from ..dsp.frontend import jitted_frontend

    dev = resolve_device(device)
    fn = jitted_frontend(10_000_000, device=dev)
    rng = np.random.default_rng(0)
    blocks = (rng.random((batch, span), dtype=np.float32) * 0.4).astype(
        np.float32)
    x = torch.from_numpy(blocks).to(dev)

    def sync():
        # PyTorch returns before the device finishes: wait for it
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn(x)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(x)
    sync()
    dt = (time.perf_counter() - t0) / reps
    return {
        "metric": "frontend_samples_per_second",
        "value": batch * span / dt,
        "unit": "samples/s",
        "device": _device_name(dev),
    }


def bench_decode(
    paths: list[str], frontend: str = "host", workers: int | None = None,
    conditioner: str = "native", pool: str = "process",
    keep_pool: bool = False, device="cuda",
) -> dict:
    """Capture->frames rate: WAV read + frontend + the host event walk,
    wall clock (the number a deployment sees, host-walk-bound)."""
    from ..dsp.cuda_channels import resolve_device
    from ..io.wav import read_wav
    from ..runtime.batch import decode_batch

    dev = resolve_device(device)
    total = sum(len(read_wav(p)[0]) for p in paths)
    t0 = time.perf_counter()
    results = decode_batch(
        paths, workers=workers, frontend=frontend, conditioner=conditioner,
        pool=pool, keep_pool=keep_pool, device=dev,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    frames = sum(len(v) for v in results.values())
    return {
        "metric": "end_to_end_decode_samples_per_second",
        "frontend": frontend,
        "value": total / dt,
        "unit": "samples/s",
        "captures": len(paths),
        "frames": frames,
        "device": _device_name(dev),
    }


def main(argv=None) -> int:
    from ..core.malloc_tune import malloc_tune
    from ..dsp.cuda_channels import DeviceUnavailable

    malloc_tune()  # bench-only: recycle large buffers without refaulting
    ap = argparse.ArgumentParser(prog="nfclab-torch-bench")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--span", type=int, default=81920)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--decode", nargs="*", help="wav files for end-to-end bench")
    ap.add_argument(
        "--frontend", choices=["host", "fused", "mask"], default="host",
        help="decode frontend: host channels, the fused frontend kernels "
        "(channels + masks fetched), or mask (detect triggers only, "
        "compacted on the device -- the lightest device frontend)",
    )
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument(
        "--pool", choices=["process", "thread"], default="process",
        help="walk fan-out: processes, or threads (GIL-free native walks)",
    )
    ap.add_argument(
        "--conditioner", choices=["native", "jax", "device"],
        default="native",
        help="conditioning backend: native (C++) or jax (the device "
        "conditioner) for frontend=host; device fetches the kernels' "
        "conditioning too for frontend=fused (PCIe hosts)",
    )
    ap.add_argument(
        "--no-kernel", action="store_true",
        help="skip the dense-frontend bench (decode only)",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the device frontend runs: cuda (the kernels) or cpu "
        "(their plain PyTorch versions)",
    )
    args = ap.parse_args(argv)
    try:
        if not args.no_kernel:
            print(json.dumps(bench_frontend(args.batch, args.span, args.reps,
                                            args.device)))
        if args.decode:
            print(json.dumps(
                bench_decode(
                    args.decode, args.frontend, args.workers,
                    args.conditioner, args.pool, device=args.device,
                )
            ))
    except (DeviceUnavailable, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
