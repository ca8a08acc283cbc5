"""Scaling measurement harness: sharded-frontend throughput vs rank count.

Counterpart of ``nfclab/tools/scaling_bench.py``.  The unit under test is
the multi-rank channel step (shard/multichip._sharded_step: blocks
data-parallel over the ranks of a ``blocks`` layout, halos over the ring)
-- the same code the sharded decode certifies for correctness.

What it measures, per world size (weak scaling: fixed blocks per rank):
- ``value``: total samples/s of one step over every rank's blocks, the
  step's time being the slowest rank's (each step ended by a device sync);
- ``total_vs_1dev``: total throughput at n ranks over the first world
  size's.  Ranks that share one host's cores (the CPU mode) saturate it at
  every size, so ~1.0 means the sharding adds no super-linear cost;
- ``collective_share``: the ring halo isolated directly -- the same step
  with the exchange replaced by a local same-shape stand-in, share =
  1 - t_local/t_ring, interleaved best-of-N reps so run-to-run noise hits
  both variants equally.  At world size 1 both variants copy locally.

Modes:
- ``--device cpu``: ``--devices`` gloo ranks on this host (world size 1
  runs in this process, larger sizes as spawned processes);
- ``--device cuda`` (the default): one rank per card over NCCL;
- ``--cuda``: also the per-card rate of the fused kernels, chained over 16
  chunks of 2048 x 65536 with carried state (``bench_cuda_chip``).

Prints one JSON line per measurement; --out writes them as JSONL.

    python -m nfclab_torch.tools.scaling_bench --devices 1 --cuda
    python -m nfclab_torch.tools.scaling_bench --device cpu --devices 1 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

_RANK_TIMEOUT = 1800  # s a spawned world may take


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    # PyTorch returns before the device finishes: wait for it
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_steps(steps, mesh, nb_loc: int, reps: int) -> list[float]:
    """Best-of-reps for several step variants, INTERLEAVED rep-by-rep so
    run-to-run noise hits all variants equally; a step's time is the
    slowest rank's (ranks start each step together)."""
    from ..shard.multichip import DEFAULT_L, _local_rows

    rng = np.random.default_rng(0)
    rows = (rng.random((mesh.size * nb_loc, DEFAULT_L), dtype=np.float32)
            * 0.4).astype(np.float32)
    local = _local_rows(rows, mesh, nb_loc)
    dev = mesh.device

    def barrier():
        if mesh.group is not None:
            import torch.distributed as dist

            dist.barrier(group=mesh.group)

    for step in steps:  # warm
        step(local)
    _sync(dev)
    best = [float("inf")] * len(steps)
    for _ in range(reps):
        for i, step in enumerate(steps):
            barrier()
            t0 = time.perf_counter()
            step(local)
            _sync(dev)
            best[i] = min(best[i], time.perf_counter() - t0)
    if mesh.group is not None:
        import torch.distributed as dist

        t = torch.tensor(best, dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
        best = t.tolist()
    return best


def bench_sharded(mesh, blocks_per_dev: int, reps: int) -> dict:
    """Weak scaling: fixed blocks per rank; total work grows with the
    layout.  Also isolates the ring's share via the no-collective step."""
    from ..core.params import SignalParams
    from ..core.thresholds import DecoderThresholds
    from ..dsp.frontend import _params_tuple
    from ..shard.multichip import DEFAULT_H, DEFAULT_L, _sharded_step

    params = SignalParams(10_000_000)
    mask_params = DecoderThresholds().detect_mask_tuple(
        params.power_level_threshold
    )
    n = mesh.size
    nb = n * blocks_per_dev
    args = (_params_tuple(params), mask_params, 10_000_000, mesh,
            blocks_per_dev, DEFAULT_L, DEFAULT_H)
    step = _sharded_step(*args)
    step_nc = _sharded_step(*args, no_collective=True)
    dt, dt_nc = _time_steps([step, step_nc], mesh, blocks_per_dev, reps)
    backend = "none"
    if mesh.group is not None:
        import torch.distributed as dist

        backend = dist.get_backend(mesh.group)
    return {
        "metric": "sharded_frontend_samples_per_second",
        "devices": n,
        "mesh": f"{backend}-{mesh.device.type}",
        "device": _device_name(mesh.device),
        "host_cpus": os.cpu_count(),
        "value": nb * DEFAULT_L / dt,
        "unit": "samples/s",
        "blocks_per_device": blocks_per_dev,
        "step_ms": dt * 1e3,
        # collective (ring halo) share of step time; the exchange moves
        # H*4 bytes per rank per step
        "collective_share": max(0.0, 1.0 - dt_nc / dt),
    }


def bench_cuda_chip(reps: int = 3) -> dict:
    """Absolute per-card rate of the fused kernels: 16 chained chunks of
    2048 x 65536 with carried state, every output selected, one sum a
    chunk so every output is read."""
    from ..core.params import SignalParams
    from ..core.thresholds import DecoderThresholds
    from ..dsp import fused_frontend as ff
    from ..dsp.cuda_channels import resolve_device
    from ..dsp.frontend import _params_tuple

    dev = resolve_device("cuda")
    params = SignalParams(10_000_000)
    pt = _params_tuple(params)
    mp = DecoderThresholds().detect_mask_tuple(
        params.power_level_threshold
    )
    plan = ff.kernel_plan(10_000_000)
    sel = ff._normalize_select(None, plan)
    batch, chunk, k = 2048, 65536, 16

    def chain(buf_tm):
        state = torch.zeros(plan.nstate, batch, dtype=torch.float32,
                            device=dev)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(k):
            res, state = ff.run_chunk(buf_tm, state, i * chunk, pt, mp,
                                      plan, sel)
            for v in res.values():
                total = total + v[-1].to(torch.float32).sum()
        return total

    rng = np.random.default_rng(0)
    buf = torch.from_numpy(
        (rng.random((batch, chunk), dtype=np.float32) * 0.4).astype(
            np.float32)).to(dev).t().contiguous()
    float(chain(buf))  # warm
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        float(chain(buf))
    dt = (time.perf_counter() - t0) / reps
    return {
        "metric": "fused_kernel_samples_per_second_per_card",
        "devices": 1,
        "mesh": "cuda",
        "device": _device_name(dev),
        "value": k * batch * chunk / dt,
        "unit": "samples/s",
    }


def _rank_main(rank: int, world: int, store: str, device: str,
               blocks_per_dev: int, reps: int, queue) -> None:
    """One rank of a spawned world: join it, run bench_sharded, and (rank
    0) send the row back."""
    from ..shard.launch import global_mesh, initialize

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize(f"file://{store}", world, rank, device=device)
    import torch.distributed as dist

    try:
        row = bench_sharded(global_mesh(device=device), blocks_per_dev,
                            reps)
        if rank == 0:
            queue.put(row)
    finally:
        dist.destroy_process_group()


def _spawn_world(world: int, device: str, blocks_per_dev: int,
                 reps: int) -> dict:
    """bench_sharded over `world` spawned ranks (file-store rendezvous);
    every rank is stopped before this returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        queue = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, os.path.join(tmp, "store"),
                                   device, blocks_per_dev, reps, queue))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            # drain the queue before joining the process that wrote it
            row = queue.get(timeout=_RANK_TIMEOUT)
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"a rank of world {world} exited {bad}")
        return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nfclab-torch-scaling")
    ap.add_argument(
        "--devices", type=int, nargs="+", default=None,
        help="world sizes to sweep (default: 1 2 4 8 on the CPU, the "
             "cards' count and the powers of two below it on cuda)",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; nccl) or cpu (gloo)")
    ap.add_argument("--blocks-per-dev", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cuda", action="store_true",
                    help="also measure the fused kernels' per-card rate")
    ap.add_argument("--out", help="write JSONL artifact")
    args = ap.parse_args(argv)

    from ..dsp.cuda_channels import DeviceUnavailable, resolve_device

    try:
        dev = resolve_device(args.device)
        if args.cuda:
            resolve_device("cuda")
    except DeviceUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    sizes = args.devices
    if sizes is None:
        most = 8 if dev.type == "cpu" else torch.cuda.device_count()
        sizes = [n for n in (1, 2, 4, 8) if n <= most]

    rows = []
    base_rate = None
    for n in sizes:
        if n == 1:
            from ..shard.launch import global_mesh

            row = bench_sharded(global_mesh(device=dev), args.blocks_per_dev,
                                args.reps)
        else:
            row = _spawn_world(n, dev.type, args.blocks_per_dev, args.reps)
        if base_rate is None:
            base_rate = row["value"]
        row["total_vs_1dev"] = row["value"] / base_rate
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.cuda:
        row = bench_cuda_chip()
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
