"""One rank of a multi-process run of nfclab_torch.shard.

Each process joins a ``torch.distributed`` group (file-store rendezvous),
lays the ``blocks`` layout over every rank (shard/launch.global_mesh), and
runs on its blocks ``decode_sharded`` (recording the channels it computes
with ``sharded_capture_channels``) and ``sharded_kernel_channels``; on
the CPU it also lays a (stream, time) DeviceMesh (``make_mesh``).  The
halo ring crosses the process boundary both ways and the rows are
all-gathered, so every rank holds the whole capture's channels: it writes
a digest of each (``digest``) and its frames as JSON, for its caller to
hold against a one-rank run (tests/test_torch_shard_dist.py; chip_smoke.py
phase 14b runs it on the card over gloo).

argv: <rank> <world> <store> <capture.npz> <out.json> <device> <backend>
      <kernel L> <kernel H>
capture.npz holds ``samples`` (f32) and ``rate``.
"""

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def digest(a) -> str:
    """sha256 of an array's bytes, with its dtype and shape: equal digests
    are equal arrays, bit for bit."""
    import numpy as np

    a = np.ascontiguousarray(a)
    return (f"{hashlib.sha256(a.view(np.uint8)).hexdigest()}:{a.dtype}:"
            f"{a.shape}")


def run_world(world: int, capture: Path, out_dir: Path, device="cpu",
              backend="gloo", kernel_lh=(3968, 128), timeout=600) -> list:
    """Run every rank of a ``world``-rank group as its own process on the
    capture (an npz of ``samples`` and ``rate``); returns each rank's
    records (out.json) in rank order.  Every child has the timeout; on a
    timeout or a failure every child of the group is killed."""
    store = out_dir / "store"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), str(store),
             str(capture), str(out_dir / f"rank{r}.json"), device, backend,
             str(kernel_lh[0]), str(kernel_lh[1])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(ROOT))
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0 or f"SHARD-RANK-DONE rank={r}" not in log:
            raise AssertionError(f"rank {r} of {world} failed "
                                 f"({p.returncode}):\n{log[-3000:]}")
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(world)]


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, cap_path, out_path, device, backend = sys.argv[3:8]
    kl, kh = int(sys.argv[8]), int(sys.argv[9])

    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.distributed as dist

    from nfclab_torch.apps.decode_cli import frame_json
    from nfclab_torch.shard import make_mesh, multichip, shard_batch
    from nfclab_torch.shard.launch import global_mesh, initialize

    got = initialize(f"file://{store}", world, rank, backend=backend,
                     device=device)
    assert got == rank and dist.get_world_size() == world
    assert dist.get_backend() == backend
    mesh = global_mesh(device=device)
    assert mesh.size == world and mesh.coords == (rank,)
    if device == "cpu":
        # the (stream, time) layout over the same group: a DeviceMesh
        grid = make_mesh(device=device)
        assert grid.shape == (world, 1) and grid.coords == (rank, 0)
        assert grid.ranks == tuple(range(world))
        part = shard_batch(grid, np.arange(6 * world).reshape(2 * world, 3))
        assert part[:, 0].tolist() == [6 * rank, 6 * rank + 3]
    cap = np.load(cap_path)
    x, rate = cap["samples"], int(cap["rate"])
    seen = {}
    orig = multichip.sharded_capture_channels

    def recorded(*a, **k):
        seen.update(orig(*a, **k))
        return seen

    multichip.sharded_capture_channels = recorded
    t0 = time.perf_counter()
    frames = multichip.decode_sharded(x, rate, mesh=mesh)
    out = {"decode_s": time.perf_counter() - t0,
           "cap": {k: digest(v) for k, v in seen.items()}}
    t0 = time.perf_counter()
    ker = multichip.sharded_kernel_channels(x, rate, mesh=mesh, L=kl, H=kh)
    out["kernel_s"] = time.perf_counter() - t0
    out["ker"] = {k: digest(v) for k, v in ker.items()}
    out["frames"] = [frame_json(f) for f in frames]
    Path(out_path).write_text(json.dumps(out))
    dist.destroy_process_group()
    print(f"SHARD-RANK-DONE rank={rank} frames={len(frames)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
