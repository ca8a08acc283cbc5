"""The v2 fused frontend against the production one, both in chained
carried-state mode: k chunks of one stream batch with the state carried
from chunk to chunk, a reduction over the last column of every output as
the sync, the mean of 5 timed calls after a warm-up.

Counterpart of ``experiments/bench_v2.py``: ``v2`` runs
``experiments.fused_v2.fused_frontend`` at (4096 streams, k=16, chunk
16384) and (4096, 8, 32768); ``prod`` runs ``dsp.fused_frontend.
fused_frontend`` with every output at (2048, 16, 65536).  Both return
[B, T] outputs, so both times include the transposes from the kernels'
time-major layout.

    python -m nfclab_torch.experiments.bench_v2 [v2|prod]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.params import SignalParams
from ..dsp import fused_frontend as prod_ff
from ..dsp.cuda_channels import resolve_device
from ..dsp.frontend import _params_tuple
from . import fused_v2
from .common import device_name

MASK_PARAMS = (0.01, 0.75, 0.10, 0.50, 0.50)
CONFIGS = {"v2": ((4096, 16, 16384), (4096, 8, 32768)),
           "prod": ((2048, 16, 65536),)}
REPS = 5


def _frontend(which: str, dev):
    if which == "v2":
        return lambda x, **kw: fused_v2.fused_frontend(x, device=dev, **kw)
    if which == "prod":
        return prod_ff.fused_frontend
    raise ValueError(f"which must be 'v2' or 'prod', got {which!r}")


def bench(which: str, x: torch.Tensor, k: int, reps: int = REPS) -> dict:
    """Chained carried-state runs of k chunks over x [B, chunk] (the same
    samples at every chunk, at base i * chunk), on x's device: the mean
    seconds of `reps` calls after a warm-up -> {"ms", "gs_per_s",
    "total"}; total is the last call's reduction."""
    fn = _frontend(which, x.device)
    pt = _params_tuple(SignalParams(10_000_000))
    batch, chunk = x.shape

    def red():
        state = None
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(k):
            res, state = fn(x, params=pt, mask_params=MASK_PARAMS,
                            state=state, base=i * chunk, return_state=True)
            total += sum(v[:, -1].sum() for v in res.values())
        return float(total)

    red()
    t0 = time.perf_counter()
    for _ in range(reps):
        total = red()
    dt = (time.perf_counter() - t0) / reps
    return {"ms": dt * 1e3, "gs_per_s": k * batch * chunk / dt / 1e9,
            "total": total}


def run(which: str = "v2", configs=None, reps: int = REPS,
        device="cuda") -> list:
    """Every configuration (batch, k, chunk) of `which`, inputs drawn in
    turn from one rng(0) as rng.random((batch, chunk)) * 0.4 -> a list of
    bench() results with their configuration."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    results = []
    for batch, k, chunk in configs or CONFIGS[which]:
        x = rng.random((batch, chunk), dtype=np.float32) * np.float32(0.4)
        r = bench(which, torch.from_numpy(x).to(dev), k, reps)
        results.append({"which": which, "batch": batch, "k": k,
                        "chunk": chunk, **r})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("which", nargs="?", default="v2", choices=("v2", "prod"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print(f"device: {device_name(resolve_device(args.device))}")
    for r in run(args.which, device=args.device):
        print(f"{r['which']} batch={r['batch']} k={r['k']}: {r['ms']:.1f} ms "
              f"-> {r['gs_per_s']:.3f} GS/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
