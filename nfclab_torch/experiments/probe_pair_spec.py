"""Probe: pairwise-speculative conditioning against the serial baseline.

The conditioning chain's critical path per sample is the envelope update:

    diff = |v - env| / env   (divide latency)
    update = (diff < 0.05) | (pcount > etu * 10)
    env' = select(update, env * w0 + v * w1, select(seed, v, env))

Stepping TWO samples at a time and computing sample t+1's quotient for
every candidate env_t (update, seed, hold) lets the three speculative
divides run beside sample t's; the resolved select then picks the
bit-identical quotient.  Same float32 operations, so the outputs equal the
serial loop's bit for bit, with about one divide on the critical path per
pair instead of two.

Counterpart of ``experiments/probe_pair_spec.py``.  ``pair_probe(value,
mode)`` takes and returns what ``probe_serial_floor.serial_probe`` does;
``mode="serial"`` is that function (the same kernel), ``mode="pair"`` the
two-sample body on the hand-written ``pair_probe_kernel``
(``nfclab_torch/csrc/probes.cu``) for a CUDA tensor and the plain version
``pair_probe_plain`` for a CPU tensor.  T must be even in pair mode.

``main`` runs the original's measurement: ``G`` groups of 2048 lanes
(default 8, 16384 lanes) x 65536 samples, ``K`` chained calls, best of 5
after a warm-up, for both modes in one process where the original ran one
``MODE`` per process.  Its ``G``, ``K`` and ``MODE`` environment knobs are
the ``--g``, ``--k`` and ``--mode`` options (``--mode both``, the default,
runs pair then serial).

    python -m nfclab_torch.experiments.probe_pair_spec [--g 8] [--k 8]
"""

from __future__ import annotations

import argparse

import torch

from ..dsp.cuda_channels import resolve_device
from ..dsp.fused_frontend import _Kernel, _require_device
from . import probe_serial_floor as psf
from .common import device_name, mod_depth

PAIR = _Kernel("pair_probe")

TILE = 128   # the original's time block, named in its printed line
MODES = ("pair", "serial")


def _check(value, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    psf.check_value(value, "pair_probe")
    if mode == "pair" and value.shape[1] % 2:
        raise ValueError("pair mode steps two samples at a time: T must be "
                         "even")


def pair_probe(value: torch.Tensor, mode: str = "pair") -> tuple:
    """(env, filt, mdev, avg, mod_depth) of value [G, T, L], as
    serial_probe returns them."""
    _check(value, mode)
    if mode == "serial":
        return psf.serial_probe(value)
    if _require_device(value) == "cpu":
        return pair_probe_plain(value)
    return psf.launch(value, PAIR, pair=True)


def pair_probe_plain(value: torch.Tensor, mode: str = "pair") -> tuple:
    """Plain PyTorch version on value's device: mode="serial" is
    serial_probe_plain; mode="pair" a loop over sample pairs in the pair
    kernel's float32 operation order."""
    _check(value, mode)
    if mode == "serial":
        return psf.serial_probe_plain(value)
    g, t, lanes = value.shape
    dev = value.device
    (ew0, ew1, mw0, mw1, aw0, aw1, iir_a), etu, silence = psf.weights(dev)
    zero = torch.zeros(g, lanes, dtype=torch.float32, device=dev)
    env, w1, mdev, avg, pcount = (zero.clone() for _ in range(5))
    outs = [torch.empty_like(value) for _ in range(4)]

    def quotient(v, e):
        return (v - e).abs_() / e

    for j in range(0, t, 2):
        v1, v2 = value[:, j], value[:, j + 1]
        # envelope chain: sample 2's quotient for each outcome of sample 1
        c_u = env * ew0 + v1 * ew1
        d1 = quotient(v1, env)
        e_u = quotient(v2, c_u)
        e_s = quotient(v2, v1)
        e_h = quotient(v2, env)
        p1 = pcount + 1.0
        u1 = (d1 < 0.05).logical_or_(p1 > silence)
        s1 = ~u1 & (j < etu)
        env1 = torch.where(u1, c_u, torch.where(s1, v1, env))
        pc1 = p1.masked_fill(u1, 0.0)
        d2 = torch.where(u1, e_u, torch.where(s1, e_s, e_h))
        p2 = pc1 + 1.0
        u2 = (d2 < 0.05).logical_or_(p2 > silence)
        s2 = ~u2 & (j + 1 < etu)
        env = torch.where(u2, env1 * ew0 + v2 * ew1,
                          torch.where(s2, v2, env1))
        pcount = p2.masked_fill(u2, 0.0)
        # the linear chains, unrolled twice
        w0a = v1 + w1 * iir_a
        filt1 = w0a - w1
        w1 = v2 + w0a * iir_a
        filt2 = w1 - w0a
        mdev1 = mdev * mw0 + filt1.abs() * mw1
        mdev = mdev1 * mw0 + filt2.abs() * mw1
        avg1 = avg * aw0 + v1 * aw1
        avg = avg1 * aw0 + v2 * aw1
        for o, a, b in zip(outs, (env1, filt1, mdev1, avg1),
                           (env, filt2, mdev, avg)):
            o[:, j] = a
            o[:, j + 1] = b
    return (*outs, mod_depth(value, outs[0]))


def measure(mode: str = "pair", g: int = 8, t: int = psf.T_PROBE,
            k: int = 8, sub: int = psf.SUB, reps: int = 5,
            device="cuda") -> dict:
    """The original's measurement for one mode -> {"gs_per_s",
    "ns_per_step", "best_s", "lanes", "device"}."""
    dev = resolve_device(device)
    x = psf.probe_input(g, t, sub, dev)
    best = psf.chain_seconds(lambda v: pair_probe(v, mode), x, k, reps)
    return {"gs_per_s": k * x.numel() / best / 1e9,
            "ns_per_step": best / (k * g * t) * 1e9, "best_s": best,
            "lanes": g * sub * 128, "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--g", type=int, default=8, help="groups of 2048 lanes")
    ap.add_argument("--k", type=int, default=8,
                    help="chained calls per timed run")
    ap.add_argument("--mode", default="both", choices=(*MODES, "both"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print(f"device: {device_name(resolve_device(args.device))}")
    for mode in MODES if args.mode == "both" else (args.mode,):
        r = measure(mode, g=args.g, k=args.k, device=args.device)
        print(f"{mode}: {r['gs_per_s']:.2f} GS/s ({r['ns_per_step']:.0f} "
              f"ns/step-of-{TILE}, g={args.g})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
