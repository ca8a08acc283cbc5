"""Conditioning scan on CUDA: the conditioning chain alone (envelope, IIR DC
filter, deviation and average EMAs, NfcTech.cpp:39-68) for many
independent streams, each from its own initial state and clock.

Counterpart of ``nfclab/dsp/pallas/conditioner_kernel.py``, with the
contract of its ``condition_scan_pallas``: value ``[B, T]``, the initial
``env, w1, mdev, avg`` (f32) and ``pulse, clock`` (i32) as ``[B]`` rows,
and six ``[B, T]`` outputs ``(env, w1, mdev, avg, filt, pulse)``.  The
JAX function keeps the initial rows as ``[G, 8, 128]`` tiles with stream
b at ``reshape(B)`` order, so its ``[B]`` rows are the port's unchanged.
Any ``B >= 1`` and ``T >= 1``: the TPU's ``B % 1024`` and ``T % 256``
came from its tiling.

The hand-written CUDA kernel ``cond_scan_kernel`` (``nfclab_torch/csrc/
conditioner.cu``) runs one lane per stream on time-major ``[T, B]``
arrays, its three independent chains on three warps, with an envelope
test that takes no divide (``env_near`` mirrors it for the tests).  ``condition_scan`` launches it for a CUDA tensor and runs the
plain PyTorch version ``condition_scan_plain`` (the same float32 operation
order, ``nfclab/dsp/conditioner.py::_scan_fn``) for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from .fused_frontend import _f32, _Kernel, _require_device

COND = _Kernel("condition_scan")

_INIT_DTYPES = (torch.float32,) * 4 + (torch.int32,) * 2
_OUT_DTYPES = (torch.float32,) * 5 + (torch.int32,)


def _check(value_tm, init):
    if value_tm.dtype != torch.float32:
        raise TypeError("condition_scan takes float32 samples")
    if value_tm.dim() != 2:
        raise ValueError("condition_scan takes [B, T] samples")
    b = value_tm.shape[1]
    for t, dt in zip(init, _INIT_DTYPES):
        if t.dtype != dt:
            raise TypeError(
                "initial state: env, w1, mdev, avg float32; pulse, clock "
                f"int32 (got {t.dtype} where {dt} is due)")
        if t.shape != (b,):
            raise ValueError(f"initial state rows must be [{b}], got "
                             f"{tuple(t.shape)}")
        if t.device != value_tm.device:
            raise ValueError("samples and initial state lie on different "
                             "devices")


def condition_scan_tm(value_tm: torch.Tensor, env0, w10, mdev0, avg0,
                      pulse0, clock0, params):
    """Time-major form of condition_scan: value_tm [T, B] in, the six
    outputs [T, B] out (the layout the kernel works in)."""
    init = (env0, w10, mdev0, avg0, pulse0, clock0)
    _check(value_tm, init)
    if _require_device(value_tm) == "cpu":
        return _scan_plain_tm(value_tm, init, params)
    return _scan_cuda_tm(value_tm, init, params)


def condition_scan(value: torch.Tensor, env0, w10, mdev0, avg0, pulse0,
                   clock0, params):
    """value: [B, T] f32; the initial state [B] rows (env, w1, mdev, avg
    f32; pulse, clock i32); params: the 8-tuple of
    dsp.frontend._params_tuple.  Returns (env, w1, mdev, avg, filt, pulse)
    as [B, T] tensors on value's device."""
    outs = condition_scan_tm(value.t(), env0, w10, mdev0, avg0, pulse0,
                             clock0, params)
    return tuple(o.t().contiguous() for o in outs)


def condition_scan_plain(value: torch.Tensor, env0, w10, mdev0, avg0,
                         pulse0, clock0, params):
    """condition_scan through the plain version on value's device (the
    yardstick the CUDA kernel is held to)."""
    init = (env0, w10, mdev0, avg0, pulse0, clock0)
    _check(value.t(), init)
    outs = _scan_plain_tm(value.t(), init, params)
    return tuple(o.t().contiguous() for o in outs)


def _scan_plain_tm(value_tm, init, pt):
    """Plain PyTorch version of the kernel: a per-sample loop over [B]
    tensors in _scan_fn's float32 operation order."""
    T, B = value_tm.shape
    dev = value_tm.device
    # the weights as 0-d float32 tensors: the products round as float32
    # either way, and a tensor operand skips the per-call scalar wrapping
    ew0, ew1, mw0, mw1, aw0, aw1, iir_a = (
        torch.tensor(_f32(p), device=dev) for p in pt[:7])
    etu = int(pt[7])
    silence = etu * 10
    env, w1, mdev, avg, pulse, clock = (t.clone() for t in init)
    outs = [[] for _ in range(6)]
    # v * w1 products need no recurrence: one vectorized pass each
    v_ew1 = value_tm * ew1
    v_aw1 = value_tm * aw1
    # the seeding window (clock < etu) is known ahead for every step; the
    # envelope takes v there unless it updates, as with _scan_fn's
    # seed = ~update & (clock < etu)
    steps = torch.arange(T, dtype=torch.int32, device=dev)
    seeding = (clock[None, :] + steps[:, None]) < etu
    for j in range(T):
        v = value_tm[j]
        # conditional envelope (NfcTech.cpp:39-53)
        pulse = pulse + 1
        # a tensor divisor: PyTorch on CUDA turns a scalar one into a
        # reciprocal multiply
        diff = (v - env).abs_() / env
        update = (diff < 0.05).logical_or_(pulse > silence)
        env = torch.where(update, env * ew0 + v_ew1[j],
                          torch.where(seeding[j], v, env))
        pulse.masked_fill_(update, 0)
        # IIR DC removal (NfcTech.cpp:56-62)
        w0 = v + w1 * iir_a
        filt = w0 - w1
        w1 = w0
        # deviation and average EMAs (NfcTech.cpp:65-68)
        mdev = mdev * mw0 + filt.abs() * mw1
        avg = avg * aw0 + v_aw1[j]
        for o, x in zip(outs, (env, w1, mdev, avg, filt, pulse)):
            o.append(x)
    if T == 0:
        return tuple(torch.empty(0, B, dtype=dt, device=value_tm.device)
                     for dt in _OUT_DTYPES)
    return tuple(torch.stack(o) for o in outs)


# the midpoint between 0.05f and its float32 predecessor: 26843545 * 2^-29
ENV_NEAR_MIDPOINT = 26843545.0 / 2.0 ** 29


def env_near(v: np.ndarray, env: np.ndarray) -> np.ndarray:
    """Mirror of the kernels' divide-free envelope test
    (``csrc/condition_step.cuh::cond_env_near``) on float32 arrays: for
    0 < env < inf, |v - env| (rounded as float32) <= m * env in float64,
    which is exact; elsewhere the float32 quotient's own test.  Equal to
    ``abs(v - env) / env < float32(0.05)`` everywhere."""
    v = np.asarray(v, np.float32)
    env = np.asarray(env, np.float32)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        ad = np.abs(v - env)
        near = ad.astype(np.float64) <= ENV_NEAR_MIDPOINT * env.astype(
            np.float64)
        special = ~((env > 0) & (env < np.inf))
        quotient = ad[special] / env[special]
        near[special] = quotient < np.float32(0.05)
    return near


def _scan_cuda_tm(value_tm, init, pt):
    from ..kernels import conditioner as kc

    T, B = value_tm.shape
    dev = value_tm.device
    outs = tuple(torch.empty(T, B, dtype=dt, device=dev) for dt in _OUT_DTYPES)
    if T == 0 or B == 0:
        return outs
    kc.launch_scan(value_tm.contiguous(), [t.contiguous() for t in init],
                   outs, pt)
    COND.launches += 1
    return outs
