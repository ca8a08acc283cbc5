"""Probe: the serial-loop latency floor of the conditioning chain alone.

The fused kernels' serial loop does conditioning plus nine ring-buffer box
sums.  If a conditioning-only loop runs much faster, moving the box sums
to a time-parallel phase is worth the surgery.

Counterpart of ``experiments/probe_serial_floor.py``.  ``serial_probe``
takes ``value[G, T, L]`` f32 (``L = sub * 128`` lanes per group, the
original's ``[g, t, sub, 128]`` flattened in its last two axes) and
returns ``(env, filt, mdev, avg, mod_depth)``, each ``[G, T, L]``: the
conditioning chain (NfcTech.cpp:39-68) from a zero carry, with a float32
silence counter and a clock ``t`` that counts from 0 in every call.  It
launches the hand-written ``serial_probe_kernel``
(``nfclab_torch/csrc/probes.cu``) for a CUDA tensor and runs the plain
version ``serial_probe_plain`` for a CPU tensor.

``main`` runs the original's measurement: ``G`` groups of 2048 lanes x
65536 samples, ``K`` calls chained by feeding ``env`` forward, best of 5
after a warm-up.  The original's ``G`` and ``K`` environment knobs are the
``--g`` and ``--k`` options (defaults 1 and 8); its ``UNROLL`` knob, a TPU
compile choice with identical results, is dropped.

    python -m nfclab_torch.experiments.probe_serial_floor [--g 1] [--k 8]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.params import SignalParams
from ..dsp.cuda_channels import resolve_device
from ..dsp.frontend import _params_tuple
from ..dsp.fused_frontend import _f32, _Kernel, _require_device
from .common import best_time, device_name, mod_depth

SERIAL = _Kernel("serial_probe")

SUB = 16           # 2048 lanes per group
T_PROBE = 65536
OUT_NAMES = ("env", "filt", "mdev", "avg", "mod_depth")


def params() -> tuple:
    """The probes' conditioning parameters: 10 MS/s."""
    return _params_tuple(SignalParams(10_000_000))


def check_value(value: torch.Tensor, name: str):
    if value.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 samples")
    if value.dim() != 3:
        raise ValueError(f"{name} takes [G, T, L] samples")


def serial_probe(value: torch.Tensor) -> tuple:
    """(env, filt, mdev, avg, mod_depth) of value [G, T, L], each
    [G, T, L] on value's device."""
    check_value(value, "serial_probe")
    if _require_device(value) == "cpu":
        return serial_probe_plain(value)
    return launch(value, SERIAL, pair=False)


def launch(value: torch.Tensor, counter: _Kernel, pair: bool) -> tuple:
    """Launch serial_probe_kernel or pair_probe_kernel on value's card and
    count the launch on `counter`."""
    from ..kernels import probes as kp

    value = value.contiguous()
    outs = tuple(torch.empty_like(value) for _ in OUT_NAMES)
    if value.numel():
        kp.launch_probe(value, outs, params(), pair)
        counter.launches += 1
    return outs


def weights(dev) -> tuple:
    """The seven float weights as 0-d float32 tensors on dev (a tensor
    operand rounds like the scalar and skips its per-call wrapping), etu
    and the silence timeout etu * 10."""
    pt = params()
    ws = tuple(torch.tensor(_f32(p), device=dev) for p in pt[:7])
    etu = int(pt[7])
    return ws, etu, _f32(etu * 10.0)


def serial_probe_plain(value: torch.Tensor) -> tuple:
    """Plain PyTorch version of serial_probe_kernel on value's device: a
    per-sample loop over [G, L] tensors in the kernel's float32 operation
    order."""
    check_value(value, "serial_probe")
    g, t, lanes = value.shape
    dev = value.device
    (ew0, ew1, mw0, mw1, aw0, aw1, iir_a), etu, silence = weights(dev)
    zero = torch.zeros(g, lanes, dtype=torch.float32, device=dev)
    env, w1, mdev, avg, pcount = (zero.clone() for _ in range(5))
    outs = [torch.empty_like(value) for _ in range(4)]
    # v * w1 products need no recurrence: one vectorized pass each
    v_ew1 = value * ew1
    v_aw1 = value * aw1
    for j in range(t):
        v = value[:, j]
        diff = (v - env).abs_() / env
        pcount = pcount + 1.0
        update = (diff < 0.05).logical_or_(pcount > silence)
        # seed = ~update & (t < etu): the envelope takes v while t < etu
        env = torch.where(update, env * ew0 + v_ew1[:, j],
                          v if j < etu else env)
        pcount.masked_fill_(update, 0.0)
        w0 = v + w1 * iir_a
        filt = w0 - w1
        w1 = w0
        mdev = mdev * mw0 + filt.abs() * mw1
        avg = avg * aw0 + v_aw1[:, j]
        for o, x in zip(outs, (env, filt, mdev, avg)):
            o[:, j] = x
    return (*outs, mod_depth(value, outs[0]))


def probe_input(g: int, t: int, sub: int, device) -> torch.Tensor:
    """The original's input, rng(0).random((g, t, sub, 128)) * 0.4, as
    [g, t, sub * 128] on device."""
    rng = np.random.default_rng(0)
    x = rng.random((g, t, sub, 128), dtype=np.float32) * np.float32(0.4)
    return torch.from_numpy(x.reshape(g, t, sub * 128)).to(device)


def chain_seconds(probe, x: torch.Tensor, k: int, reps: int) -> float:
    """Best seconds of k chained calls (each fed the previous env, so no
    call can be elided), synchronized by a scalar fetch of the sum of
    every call's last env column."""
    def chain():
        v = x
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for _ in range(k):
            outs = probe(v)
            total = total + outs[0][:, -1].sum()
            v = outs[0]
        return float(total)

    return best_time(chain, reps)


def measure(g: int = 1, t: int = T_PROBE, k: int = 8, sub: int = SUB,
            reps: int = 5, device="cuda") -> dict:
    """The original's measurement -> {"gs_per_s", "ns_per_step", "best_s",
    "lanes", "device"}; ns_per_step is per sample of one lane's chain."""
    dev = resolve_device(device)
    x = probe_input(g, t, sub, dev)
    best = chain_seconds(serial_probe, x, k, reps)
    return {"gs_per_s": k * x.numel() / best / 1e9,
            "ns_per_step": best / (k * g * t) * 1e9, "best_s": best,
            "lanes": g * sub * 128, "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--g", type=int, default=1, help="groups of 2048 lanes")
    ap.add_argument("--k", type=int, default=8,
                    help="chained calls per timed run")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    r = measure(g=args.g, k=args.k, device=args.device)
    print(f"device: {device_name(r['device'])}")
    print(f"conditioning-only serial loop: {r['gs_per_s']:.2f} GS/s "
          f"({r['ns_per_step']:.0f} ns/step, g={args.g} groups x "
          f"{SUB * 128} lanes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
