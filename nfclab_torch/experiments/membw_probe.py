"""The card's achievable HBM streaming bandwidth (read + write), to anchor
the bytes bounds of the kernel table: NOUT outputs ``x * float32(1 +
1e-7 i)`` over a large f32 buffer, ``sweeps`` full passes in one kernel
launch, synchronized by a scalar fetch.

Counterpart of ``experiments/membw_probe.py``.  ``copy_probe`` launches
the hand-written ``copy_probe_kernel`` (``nfclab_torch/csrc/probes.cu``)
for a CUDA tensor and runs the plain version, ``torch.mul`` per output and
sweep, for a CPU tensor.  The original's ``NOUT`` environment knob is the
``--nout`` option; its other sizes (8192 x 8192, 24 sweeps, best of 4
after a warm-up) are kept.

    python -m nfclab_torch.experiments.membw_probe [--nout 14]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..dsp.cuda_channels import resolve_device
from ..dsp.fused_frontend import _Kernel, _require_device
from .common import best_time, device_name

COPY = _Kernel("copy_probe")

ROWS = COLS = 8192   # 256 MB per buffer
SWEEPS = 24
NOUT = 14


def scales(nout: int) -> list:
    """The output factors float32(1 + 1e-7 i), rounded once from double on
    the host, as the original's np.float32(1.0 + 1e-7 * i)."""
    return [float(np.float32(1.0 + 1e-7 * i)) for i in range(nout)]


def _check(x, nout, sweeps):
    if x.dtype != torch.float32:
        raise TypeError("copy_probe takes float32")
    if nout < 1:
        raise ValueError("nout must be at least 1")
    if sweeps < 1:
        raise ValueError("sweeps must be at least 1")


def copy_probe(x: torch.Tensor, nout: int = NOUT, sweeps: int = 1) -> list:
    """The nout outputs x * scales(nout)[i], each written `sweeps` times
    (one kernel launch for all sweeps on a CUDA tensor)."""
    _check(x, nout, sweeps)
    if _require_device(x) == "cpu":
        return copy_probe_plain(x, nout, sweeps)
    from ..kernels import probes as kp

    if nout > kp.MAX_NOUT:
        raise ValueError(f"the kernel writes at most {kp.MAX_NOUT} outputs")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # 16-byte loads need an aligned base
    outs = [torch.empty_like(x) for _ in range(nout)]
    if x.numel():
        kp.launch_copy(x, outs, scales(nout), sweeps)
        COPY.launches += 1
    return outs


def copy_probe_plain(x: torch.Tensor, nout: int = NOUT,
                     sweeps: int = 1) -> list:
    """Plain PyTorch version of the kernel on x's device: torch.mul per
    output and sweep."""
    _check(x, nout, sweeps)
    outs = [torch.empty_like(x) for _ in range(nout)]
    for _ in range(sweeps):
        for o, s in zip(outs, scales(nout)):
            torch.mul(x, s, out=o)
    return outs


def bandwidth(rows: int = ROWS, cols: int = COLS, sweeps: int = SWEEPS,
              nout: int = NOUT, reps: int = 4, device="cuda") -> dict:
    """The original's measurement: one call of `sweeps` passes, a scalar
    fetch of the outputs' last elements as the sync, best of `reps` after a
    warm-up.  Returns {"gb_per_s", "best_s", "traffic_bytes", "device"}."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((rows, cols), dtype=np.float32)).to(dev)

    def chain():
        outs = copy_probe(x, nout, sweeps)
        return float(sum(o[-1, -1] for o in outs))

    best = best_time(chain, reps)
    # per sweep: read N + write NOUT x N floats
    traffic = sweeps * rows * cols * 4 * (1 + nout)
    return {"gb_per_s": traffic / best / 1e9, "best_s": best,
            "traffic_bytes": traffic, "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nout", type=int, default=NOUT,
                    help="concurrent output streams (default 14)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    r = bandwidth(nout=args.nout, device=args.device)
    print(f"device: {device_name(r['device'])}")
    print(f"achievable HBM streaming bandwidth: {r['gb_per_s']:.0f} GB/s "
          f"({r['best_s'] * 1e3:.1f} ms for {r['traffic_bytes'] / 1e9:.1f} GB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
