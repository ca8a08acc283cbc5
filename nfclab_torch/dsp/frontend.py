"""Batched dense decode frontend.

Counterpart of ``nfclab/dsp/frontend.py``: everything the host FSMs
consume is computed here as one function over a batch of signal blocks
``[B, T]`` on the device the frontend is built for:

- the conditioning scan (envelope, IIR-filtered, deviation, average): the
  CUDA kernel ``condition_scan`` (dsp/conditioner_kernel.py) for every
  ``B`` and ``T`` -- nfclab took its Pallas kernel only when
  ``B % 1024 == 0 and T % 256 == 0`` and a ``lax.scan`` otherwise;
- modulation depth;
- per-tech/rate correlator channels: half-symbol box sums of the raw value,
  the squared-filtered listen channel, the BPSK product integrator windows
  (NfcA.cpp:236-255, 963-973, 1243-1266 and the B/F/V equivalents);
- detect event masks per tech.

Beside the kernel these are plain PyTorch operations in nfclab's order and
layout (there they were XLA operations), with the same 21 output names and
dtypes at 10 MS/s (13 f32 channels, 8 bool masks).

``make_fused_frontend`` builds the fused frontend instead: the two fused
kernels (dsp/fused_frontend.py) compute the conditioning, mod_depth,
every box channel and the packed all-tech ``detect_mask`` in one pass,
as ``[B, T]`` outputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.params import SignalParams, nfca_bitrates
from .fused_frontend import _f32


def _params_tuple(params: SignalParams):
    return (
        np.float32(params.signal_enve_w0),
        np.float32(params.signal_enve_w1),
        np.float32(params.signal_mdev_w0),
        np.float32(params.signal_mdev_w1),
        np.float32(params.signal_mean_w0),
        np.float32(params.signal_mean_w1),
        np.float32(params.signal_iir_dc_a),
        np.int32(params.elementary_time_unit),
    )


def _box_sum_t(x: torch.Tensor, width: int) -> torch.Tensor:
    """Boxcar sum over the trailing `width` samples along the last axis,
    with an implicit zero left pad (matches the reference ring warm-up).

    The prefix sums accumulate in float64 and are rounded to float32 once,
    on every device: PyTorch's CPU cumsum accumulates float32 in double
    anyway, while on CUDA it would accumulate in float32 in an order of its
    own, so CPU and CUDA agree.  The difference of two prefixes is float32,
    as in nfclab's function."""
    c = torch.cumsum(x, -1, dtype=torch.float64).to(torch.float32)
    return c - F.pad(c[..., :-width], (width, 0))


def _default_corr_thresholds() -> dict:
    """Per-tech detect-trigger thresholds from the single source of truth
    (core.thresholds): A/F/V correlation, B minimumModulationDeep."""
    from ..core.thresholds import DecoderThresholds

    d = DecoderThresholds()
    return {
        "nfca": d.nfca.correlation,
        "nfcb": d.nfcb.min_modulation_deep,
        "nfcf": d.nfcf.correlation,
        "nfcv": d.nfcv.correlation,
    }


def make_frontend(params: SignalParams, corr_thresholds: dict | None = None,
                  device="cuda"):
    """Build the frontend fn: value[B, T] f32 (array or tensor) -> dict of
    dense [B, T] outputs on ``device``, where the input is moved first.

    device: cuda unless the caller asks for the CPU (the kernel's plain
    version); raises DeviceUnavailable here when there is no card.
    corr_thresholds: per-tech correlation thresholds (defaults mirror the
    reference: A=0.75, B=0.10 edge, F=0.50, V=0.50).
    """
    from ..demod.nfcv import nfcv_bitrate
    from .conditioner_kernel import condition_scan
    from .cuda_channels import resolve_device

    dev = resolve_device(device)
    pt = _params_tuple(params)
    thr = _default_corr_thresholds()
    if corr_thresholds:
        thr.update(corr_thresholds)
    bitrates_a = nfca_bitrates(params.sample_rate)
    brv = nfcv_bitrate(params.sample_rate)
    power_thr = _f32(params.power_level_threshold)
    thr_a, thr_b, thr_f, thr_v = (_f32(thr[k])
                                  for k in ("nfca", "nfcb", "nfcf", "nfcv"))

    def pad_right_shift(x, d):
        """x delayed by d samples, zeros before the start."""
        return F.pad(x[:, : x.shape[1] - d], (d, 0)) if d else x

    def frontend(value: torch.Tensor) -> dict:
        value = torch.as_tensor(value, device=dev)
        b, t = value.shape

        def div(x, p):
            # a tensor divisor keeps the division IEEE on CUDA (a CPU
            # scalar divisor becomes a reciprocal multiply there)
            return x / torch.tensor(float(p), dtype=torch.float32,
                                    device=dev)

        zeros_f = torch.zeros(b, dtype=torch.float32, device=dev)
        zeros_i = torch.zeros(b, dtype=torch.int32, device=dev)
        env, _w1, mdev, avg, filt, _pulse = condition_scan(
            value, zeros_f, zeros_f, zeros_f, zeros_f, zeros_i, zeros_i, pt)

        clamped = torch.clamp(torch.minimum(value, env), min=0.0)
        mdepth = (env - clamped) / env

        out = {
            "envelope": env,
            "filtered": filt,
            "deviation": mdev,
            "average": avg,
            "mod_depth": mdepth,
        }

        # NFC-A/B/F detect channels share the raw-value box sums; compute
        # one per distinct half-symbol width
        widths = sorted({br.period2 for br in bitrates_a})
        boxes = {w: _box_sum_t(value, w) for w in widths}

        sq = filt * filt * 10.0

        for br in bitrates_a:
            d, p1, p2 = br.symbol_delay_detect, br.period1, br.period2
            box = boxes[p2]
            gap = p1 - p2
            # SD(t) = ((B(t-d) - B(t-d-gap)) - (B(t-d-gap) - B(t-d-1))) / p2
            bm_g = pad_right_shift(box, gap)
            bm_1 = pad_right_shift(box, 1)
            sd = pad_right_shift(div((box - bm_g) - (bm_g - bm_1), p2), d)
            out[f"sd_a_{br.rate_type}"] = sd
            # detect mask (NfcA.cpp:224-291): |SD| above correlation
            # threshold at power-ok samples
            out[f"mask_a_{br.rate_type}"] = (env >= power_thr) & (
                sd.abs() > thr_a * env)
            # listen squared channel box for this width
            out[f"boxq_{p2}"] = _box_sum_t(sq, p2)

        # BPSK product channels for A r212/424 (p1 lags 47/24)
        for br in bitrates_a[1:]:
            p1, p4, d = br.period1, br.period4, br.symbol_delay_detect
            prod = F.pad(filt[:, p1:] * filt[:, :-p1], (p1, 0)) * 10.0
            pb4 = _box_sum_t(prod, p4)
            out[f"pb4_a_{br.rate_type}"] = pad_right_shift(pb4, d)

        power_ok = env >= power_thr

        # NFC-B falling-edge trigger masks (NfcB.cpp:283): filt[t-d] below
        # -minDeep*env at power-ok samples, delays 0 and p2(106k)*2
        d_b106 = bitrates_a[0].period1  # 94 at 10 MS/s
        for d in (0, d_b106):
            fd = pad_right_shift(filt, d)
            out[f"mask_b_{d}"] = power_ok & (fd < -(thr_b * env))

        # NFC-F correlation masks: A's SD family at d=0 over the same
        # half-symbol boxes (NfcF.cpp detect)
        for br in bitrates_a[1:]:
            p1, p2 = br.period1, br.period2
            box = boxes[p2]
            gap = p1 - p2
            bm_g = pad_right_shift(box, gap)
            bm_1 = pad_right_shift(box, 1)
            sd = div((box - bm_g) - (bm_g - bm_1), p2)
            out[f"mask_f_{br.rate_type}"] = power_ok & (
                sd.abs() > thr_f * env)

        # NFC-V signed SD mask (NfcV.cpp:236-435): reversed-difference SD
        # over the half-symbol box at delay period0
        p2v, p1v, dv = brv.period2, brv.period1, brv.symbol_delay_detect
        gapv = p1v - p2v
        boxv = _box_sum_t(value, p2v)
        u0 = pad_right_shift(boxv, dv)
        ug = pad_right_shift(boxv, dv + gapv)
        sd_v = div(ug - u0, p2v)
        out["mask_v"] = power_ok & (sd_v > thr_v * env)

        return out

    return frontend


@functools.lru_cache(maxsize=8)
def jitted_frontend(sample_rate: int, power_level_threshold: float = 0.01,
                    device="cuda"):
    """The frontend fn of make_frontend for a rate and device, built once
    (nfclab's name: there it was a jitted program; PyTorch runs it
    eagerly)."""
    params = SignalParams(sample_rate,
                          power_level_threshold=power_level_threshold)
    return make_frontend(params, device=device)


def make_fused_frontend(
    params: SignalParams,
    corr_thresholds: dict | None = None,
    native_layout: bool = False,
    device="cuda",
):
    """Production-throughput frontend: the fused kernels (conditioning +
    mod depth + every box channel in one sweep) plus in-kernel detect
    triggers for ALL four technologies packed into the single
    `detect_mask` bitfield output, as [B, T] outputs on ``device`` (cuda
    unless the caller asks for the CPU: the kernels' plain versions; the
    input is moved there first).  Box sums carry the same f32 running-sum
    roundoff family as the reference's own integrators; the bit-exact
    golden path uses the unfused conditioner + host f64 channels.

    native_layout=True is nfclab's [g, t, sub, 128] TPU tiling, which the
    CUDA kernels do not have: it raises ValueError."""
    from .cuda_channels import resolve_device
    from .fused_frontend import fused_frontend

    if native_layout:
        raise ValueError(
            "native_layout=True is the TPU kernel's [g, t, sub, 128] "
            "tiling; the CUDA kernels return [B, T] outputs "
            "(native_layout=False)"
        )
    dev = resolve_device(device)
    pt = _params_tuple(params)
    thr = _default_corr_thresholds()
    if corr_thresholds:
        thr.update(corr_thresholds)
    mask_params = (
        float(params.power_level_threshold),
        float(thr["nfca"]),
        float(thr["nfcb"]),
        float(thr["nfcf"]),
        float(thr["nfcv"]),
    )

    def run(value):
        value = torch.as_tensor(value, device=dev)
        return fused_frontend(value, pt, mask_params=mask_params,
                              sample_rate=params.sample_rate)

    return run


@functools.lru_cache(maxsize=8)
def jitted_fused_frontend(sample_rate: int,
                          power_level_threshold: float = 0.01,
                          device="cuda"):
    """The fn of make_fused_frontend (native_layout=False) for a rate and
    device, built once (nfclab's name: there it was a jitted program;
    PyTorch runs it eagerly)."""
    params = SignalParams(sample_rate,
                          power_level_threshold=power_level_threshold)
    return make_fused_frontend(params, native_layout=False, device=device)
