#!/usr/bin/env python3
"""Drive nfclab_torch on one CUDA card, end to end, and check it.

Run from the repository root, on a machine with an NVIDIA GPU, nvcc and
g++:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Print the card (nvidia-smi name and power limit); build the CUDA kernels
   from nfclab_torch/csrc with nvcc and print the ptxas register and spill
   lines; build the native host library.
2. Kernels against their plain PyTorch versions, on the card: 1024 streams
   x 2 chunks of 4096 samples with carried state -- the fused frontend
   kernels once with every output and once with detect_mask alone, the
   conditioning kernel from a seeded initial state with non-zero clocks and
   pulse counts; every output and the state must be bit-exact.
   Conditioning must be bit-exact against the C++ oracle on 8 streams, for
   both kernels.  Repeated at 3.2 MS/s.
3. The kernels against their plain versions at the main paths' shape and
   on their inputs: two [65536, 1024] chunks of the mask path's captures,
   the second with carried state at a folded clock base, and one 1024 x
   65536 chunk with carried state for the conditioning kernel; bit-exact
   again.  Kernel times on those inputs (CUDA events over 5 launches),
   plain times from the comparison.
4. The mask path at full width: chained_batch_masks over 1024 captures of
   2,097,152 samples at 10 MS/s (one production window: 32 chunks of
   65536), the launch counts read around exactly that call and its time
   split by step (StepTimes, each step ended by a device sync).
5. One capture of each synthetic template decoded to frames from the
   device triggers; they must equal the host-frontend frames and the
   bytes the synthesizer wrote.  Then the CLI with --frontend mask.
6. The dense frontend at full width: jitted_frontend(10 MS/s) over 1024
   streams x 65536 samples of the mask path's captures (time per call,
   samples/s, peak memory, conditioning launches per call), held against
   the same call on the CPU on 64 of the streams.
7. The device conditioner on a long capture: condition_jax over 2**25
   samples of the templates with long field-off stretches, bit-exact
   against the C++ oracle with its repair count and the time of its host
   edge tracker alone; then the conditioning
   path -- NfcDecoder(conditioner="jax") over that capture, launch counts
   read around exactly that call -- gives the native frames;
   decode_batch(conditioner="jax") and the CLI with --conditioner jax give
   the native frames of the template WAVs.

The line before the last is the card's name and power limit; the one
before it a JSON object with one entry per kernel.  The last line is
{"ok": true, "device": {...}}.  --kernels-only stops after phase 2, for
a first call after a kernel change.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RATE = 10_000_000
STREAMS = 1024            # the JAX engine's lane ceiling
WINDOW = 32 * 65536       # one production window: k_chunks x CHAIN_CHUNK
CHECK_CHUNK = 4096        # chunk of the small bit-exact checks
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # f32 outside the tensor cores
TPU_KERNEL = "nfclab/dsp/pallas/fused_frontend.py:259"
SOURCE = "nfclab_torch/csrc/fused_frontend.cu"
COND_TPU_KERNEL = "nfclab/dsp/pallas/conditioner_kernel.py:31"
COND_SOURCE = "nfclab_torch/csrc/conditioner.cu"
COND_OPS = 22             # float and counter operations per sample
LONG = 1 << 25            # the long capture of phase 7 (3.36 s, 512 blocks)
DENSE_CPU_STREAMS = 64    # streams of phase 6's CPU comparison


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _same(a, b) -> bool:
    """Bit-level equality, NaN equal to NaN."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool(torch.equal(a, b))


def _err(a, b) -> float:
    """Largest |a - b| over entries that are not both NaN."""
    import torch

    d = (a.double() - b.double()).abs()
    both_nan = torch.isnan(a.double()) & torch.isnan(b.double())
    d = torch.where(both_nan, torch.zeros_like(d), d)
    d = torch.nan_to_num(d, nan=float("inf"))
    return float(d.max()) if d.numel() else 0.0


def _params(rate):
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.core.thresholds import DecoderThresholds
    from nfclab_torch.dsp.cuda_channels import chained_mask_params
    from nfclab_torch.dsp.frontend import _params_tuple

    pt = _params_tuple(SignalParams(rate))
    mp_all = DecoderThresholds().detect_mask_tuple(0.01)
    return pt, mp_all, chained_mask_params(0.01)


def check_kernels(dev, rate, chunk, n_chunks, errs):
    """Each kernel against its plain version on the same inputs, chunk by
    chunk with carried state, for both selections; then the whole
    fused_frontend against fused_frontend_plain.  Returns the all-output
    run's [B, T] outputs (for the oracle check) and the input."""
    import torch

    from nfclab_torch.dsp import fused_frontend as ff
    from torch_synth import mixed_lanes

    pt, mp, _ = _params(rate)
    plan = ff.kernel_plan(rate)
    x = torch.from_numpy(mixed_lanes(STREAMS, n_chunks * chunk, seed=5)).to(dev)
    extra_names = set(ff._extra_names(plan))
    outs_all = None
    for select in (None, ("detect_mask",)):
        sel = ff._normalize_select(select, plan)
        keep = tuple(n for n in sel if n in extra_names)
        st_k = torch.zeros(plan.nstate, STREAMS, device=dev)
        st_p = st_k.clone()
        for c in range(n_chunks):
            base = c * chunk
            x_tm = x[:, base : base + chunk].t().contiguous()
            deps_k, extra_k, so_k = ff.fused_scan(x_tm, st_k, base, pt, plan,
                                                  keep)
            deps_p, extra_p, so_p = ff._scan_plain(x_tm, st_p, base, pt,
                                                   plan, keep)
            pairs = [(deps_k, deps_p), (so_k, so_p)]
            pairs += [(extra_k[n], extra_p[n]) for n in keep]
            for a, b in pairs:
                errs["fused_scan"] = max(errs["fused_scan"], _err(a, b))
                if not _same(a, b):
                    raise AssertionError(
                        f"fused_scan != plain at {rate} Hz, chunk {c}, "
                        f"select={select}: max err {_err(a, b)}")
            # the mask kernel and its plain version on identical inputs
            so_mk = so_p.clone()
            mk_k = ff.fused_mask(deps_p, x_tm, st_p, so_mk, mp, plan,
                                 "detect_mask" in sel, "mod_depth" in sel)
            mk_p = ff._mask_plain(deps_p, x_tm, st_p, so_p, mp, plan,
                                  "detect_mask" in sel, "mod_depth" in sel)
            for a, b in [(so_mk, so_p)] + [(mk_k[n], mk_p[n]) for n in mk_p]:
                errs["fused_mask"] = max(errs["fused_mask"],
                                         _err(a.float(), b.float()))
                if not _same(a, b):
                    raise AssertionError(
                        f"fused_mask != plain at {rate} Hz, chunk {c}, "
                        f"select={select}")
            st_k, st_p = so_mk, so_p
        torch.cuda.synchronize()
        # the public entry point through both kernels vs fully plain
        got, st = None, None
        want, stw = None, None
        outs_k, outs_p = [], []
        for c in range(n_chunks):
            base = c * chunk
            xc = x[:, base : base + chunk]
            got, st = ff.fused_frontend(xc, pt, mask_params=mp, state=st,
                                        base=base, return_state=True,
                                        select=select, sample_rate=rate)
            want, stw = ff.fused_frontend_plain(
                xc, pt, mask_params=mp, state=stw, base=base,
                return_state=True, select=select, sample_rate=rate)
            outs_k.append(got)
            outs_p.append(want)
        for n in sel:
            a = torch.cat([o[n] for o in outs_k], 1)
            b = torch.cat([o[n] for o in outs_p], 1)
            if not _same(a, b):
                raise AssertionError(f"fused_frontend {n} != plain at {rate}")
        if not _same(st, stw):
            raise AssertionError(f"fused_frontend state != plain at {rate}")
        if select is None:
            outs_all = {n: torch.cat([o[n] for o in outs_k], 1) for n in sel}
        log(f"kernels == plain (bit-exact) at {rate} Hz, {STREAMS} streams x "
            f"{n_chunks} x {chunk}, select={select}")
    return x, outs_all


def check_oracle(x, outs_all, rate, lanes=8):
    """Conditioning of the all-output kernel run against the C++ oracle."""
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.native import condition_exact

    params = SignalParams(rate)
    xs = x[:lanes].cpu().numpy()
    names = {"envelope": "envelope", "filtered": "filtered",
             "deviation": "deviation", "average": "average",
             "mod_depth": "mod_depth"}
    for i in range(lanes):
        c = condition_exact(xs[i], params)
        for out, attr in names.items():
            got = outs_all[out][i].cpu().numpy()
            ref = getattr(c, attr)
            same = (got == ref) | ((got != got) & (ref != ref))
            if not same.all():
                raise AssertionError(
                    f"{out} lane {i} != C++ oracle at {int((~same).sum())} "
                    "samples")
    log(f"conditioning == C++ oracle (bit-exact) on {lanes} lanes at {rate} Hz")


COND_NAMES = ("env", "w1", "mdev", "avg", "filt", "pulse")


def _cond_init(x0, rate, seed):
    """A seeded initial conditioning state for streams whose first sample
    is x0 ([B]): envelope near x0, w1 at its steady state, a small
    deviation, pulse counts up to twice the silence timeout and clocks up
    to three ETU (some streams still in the seeding window)."""
    import numpy as np
    import torch

    from nfclab_torch.core.params import SignalParams

    etu = SignalParams(rate).elementary_time_unit
    rng = np.random.default_rng(seed)
    b, dev = x0.shape[0], x0.device

    def t(a):
        return torch.from_numpy(a).to(dev)

    env0 = x0 * t(rng.uniform(0.9, 1.1, b).astype(np.float32))
    mdev0 = t(rng.uniform(0.0, 1e-3, b).astype(np.float32))
    pulse0 = t(rng.integers(0, 20 * etu, b).astype(np.int32))
    clock0 = t(rng.integers(0, 3 * etu, b).astype(np.int32))
    return env0, x0 * 10.0, mdev0, x0.clone(), pulse0, clock0


def _cond_carry(outs, clock):
    """The state after the last column of condition_scan's [B, T]
    outputs, for a chunk that starts at `clock`."""
    env, w1, mdev, avg, _, pulse = (o[:, -1].contiguous() for o in outs)
    return env, w1, mdev, avg, pulse, clock


def _cond_compare(got, want, errs, what):
    for name, a, b in zip(COND_NAMES, got, want):
        e = _err(a.float(), b.float())
        errs["condition_scan"] = max(errs["condition_scan"], e)
        if not _same(a, b):
            raise AssertionError(
                f"condition_scan {name} != plain, {what}: max err {e}")


def check_condition_kernel(dev, rate, chunk, n_chunks, errs, lanes=8):
    """cond_scan_kernel against condition_scan_plain on the card: STREAMS
    streams x n_chunks chunks from a seeded initial state with non-zero
    clocks and pulse counts, the state carried from chunk to chunk; the
    chained chunks equal one call over the whole span; and, from a fresh
    state at clock 0, the C++ oracle on `lanes` streams."""
    import numpy as np
    import torch

    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp import conditioner_kernel as ck
    from nfclab_torch.dsp.frontend import _params_tuple
    from nfclab_torch.native import condition_exact
    from torch_synth import mixed_lanes

    params = SignalParams(rate)
    pt = _params_tuple(params)
    x = torch.from_numpy(mixed_lanes(STREAMS, n_chunks * chunk,
                                     seed=13)).to(dev)
    init = _cond_init(x[:, 0], rate, seed=17)
    st_k = st_p = init
    parts = []
    for c in range(n_chunks):
        xc = x[:, c * chunk : (c + 1) * chunk]
        got = ck.condition_scan(xc, *st_k, pt)
        want = ck.condition_scan_plain(xc, *st_p, pt)
        _cond_compare(got, want, errs, f"{rate} Hz, chunk {c}")
        parts.append(got)
        st_k = _cond_carry(got, init[5] + (c + 1) * chunk)
        st_p = _cond_carry(want, init[5] + (c + 1) * chunk)
    whole = ck.condition_scan(x, *init, pt)
    chained = [torch.cat([p[i] for p in parts], 1) for i in range(6)]
    _cond_compare(whole, chained, errs, f"{rate} Hz, one call vs chained")
    torch.cuda.synchronize()
    log(f"condition_scan == plain (bit-exact) at {rate} Hz, {STREAMS} "
        f"streams x {n_chunks} x {chunk}, carried state, clocks from "
        f"{int(init[5].min())} to {int(init[5].max())}")

    z = torch.zeros(lanes, dtype=torch.float32, device=dev)
    zi = torch.zeros(lanes, dtype=torch.int32, device=dev)
    env, _, mdev, avg, filt, _ = ck.condition_scan(x[:lanes], z, z, z, z,
                                                   zi, zi, pt)
    xs = x[:lanes].cpu().numpy()
    for i in range(lanes):
        c = condition_exact(xs[i], params)
        for name, a, ref in (("envelope", env, c.envelope),
                             ("filtered", filt, c.filtered),
                             ("deviation", mdev, c.deviation),
                             ("average", avg, c.average)):
            got = a[i].cpu().numpy()
            same = (got.view(np.uint32) == ref.view(np.uint32)) | (
                np.isnan(got) & np.isnan(ref))
            if not same.all():
                raise AssertionError(
                    f"condition_scan {name} lane {i} != C++ oracle at "
                    f"{int((~same).sum())} samples ({rate} Hz)")
    log(f"condition_scan == C++ oracle (bit-exact) on {lanes} lanes at "
        f"{rate} Hz")


def check_condition_main_shape(dev, caps, errs):
    """cond_scan_kernel against its plain version at the main path's
    shape, on its captures: one [65536, 1024] chunk (the second of each
    capture) from the state the kernel carried out of the first, at clock
    65536.  Kernel time on those inputs, plain time from the comparison
    run, and the bound."""
    import numpy as np
    import torch

    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp import conditioner_kernel as ck
    from nfclab_torch.dsp.frontend import _params_tuple

    pt = _params_tuple(SignalParams(RATE))
    chunk = 65536

    def tm(c):
        return torch.from_numpy(np.stack(
            [cp[c * chunk : (c + 1) * chunk] for cp in caps], 1)).to(dev)

    z = torch.zeros(STREAMS, dtype=torch.float32, device=dev)
    zi = torch.zeros(STREAMS, dtype=torch.int32, device=dev)
    out0 = ck.condition_scan_tm(tm(0), z, z, z, z, zi, zi, pt)
    init = tuple(out0[i][-1].contiguous() for i in (0, 1, 2, 3, 5)) + (
        torch.full((STREAMS,), chunk, dtype=torch.int32, device=dev),)
    del out0
    x1 = tm(1)
    got = ck.condition_scan_tm(x1, *init, pt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ck._scan_plain_tm(x1, init, pt)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    _cond_compare(got, want, errs, f"{STREAMS} x {chunk}, carried state")
    log(f"condition_scan == plain (bit-exact) at {STREAMS} streams x "
        f"{chunk}, carried state at clock {chunk}")
    del got, want
    ms = _event_ms(lambda: ck.condition_scan_tm(x1, *init, pt), 5)
    # each input read once (4 B/sample and the 24 B initial state of a
    # stream), each output written once (24 B/sample); COND_OPS float and
    # counter operations per sample at the f32 rate
    n = chunk * STREAMS
    return {"cond_ms": ms, "cond_plain_ms": plain_ms,
            "cond_bound": _bound(28 * n + 24 * STREAMS, COND_OPS * n)}


def _event_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def check_main_shape(dev, caps, errs):
    """Both kernels against their plain versions at the main path's shape,
    on its own inputs: [65536, 1024] chunks of the main path's captures
    with its mask params, chunk 0 from fresh state at clock 0 and chunk 1
    with the state carried from chunk 0 at a folded clock base
    (mod + lo % mod, where the engine's later windows start).  Kernel
    times are taken on chunk 1's inputs, plain times from its comparison
    run.  Returns the times and each kernel's bound."""
    import numpy as np
    import torch

    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.dsp import fused_frontend as ff

    pt, _, mp = _params(RATE)
    plan = ff.kernel_plan(RATE)
    lay = ff._layout(plan)
    chunk = cc.CHAIN_CHUNK
    mod = plan.fold_modulus
    hist = torch.zeros(plan.nstate, dtype=torch.bool, device=dev)
    hist[lay.hist_off : lay.hist_off + lay.hist_rows] = True
    st_k = torch.zeros(plan.nstate, STREAMS, device=dev)
    st_p = st_k.clone()
    t = {}
    for c, base in enumerate((0, mod + chunk % mod)):
        x_tm = torch.from_numpy(np.stack(
            [cp[c * chunk : (c + 1) * chunk] for cp in caps], 1)).to(dev)
        st_in = st_k
        deps_k, _, so_k = ff.fused_scan(x_tm, st_k, base, pt, plan)
        mk_k = ff.fused_mask(deps_k, x_tm, st_k, so_k, mp, plan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        deps_p, _, so_p = ff._scan_plain(x_tm, st_p, base, pt, plan)
        torch.cuda.synchronize()
        t["scan_plain_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mk_p = ff._mask_plain(deps_p, x_tm, st_p, so_p, mp, plan)
        torch.cuda.synchronize()
        t["mask_plain_ms"] = (time.perf_counter() - t0) * 1e3
        # the scan owns the carry, rings and sums; the mask the histories
        pairs = (("fused_scan", "deps", deps_k, deps_p),
                 ("fused_scan", "state", so_k[~hist], so_p[~hist]),
                 ("fused_mask", "detect_mask", mk_k["detect_mask"],
                  mk_p["detect_mask"]),
                 ("fused_mask", "state", so_k[hist], so_p[hist]))
        for name, what, a, b in pairs:
            e = _err(a.float(), b.float())
            errs[name] = max(errs[name], e)
            if not _same(a, b):
                raise AssertionError(
                    f"{name} {what} != plain at the main path's shape, "
                    f"chunk {c} (base {base}): max err {e}")
        log(f"kernels == plain (bit-exact) at {STREAMS} streams x {chunk}, "
            f"chunk {c}, base {base}, select=('detect_mask',)")
        st_k, st_p = so_k, so_p
        del deps_p, so_p, mk_p
    so_t = so_k.clone()
    t["scan_ms"] = _event_ms(
        lambda: ff.fused_scan(x_tm, st_in, base, pt, plan), 5)
    t["mask_ms"] = _event_ms(
        lambda: ff.fused_mask(deps_k, x_tm, st_in, so_t, mp, plan), 5)
    t["chunk_mask_ms"] = _event_ms(
        lambda: ff.run_chunk(x_tm, st_in, base, pt, mp, plan,
                             ("detect_mask",)), 5)
    t["chunk_all_ms"] = _event_ms(
        lambda: ff.run_chunk(x_tm, st_in, base, pt, mp, plan,
                             ff._normalize_select(None, plan)), 5)
    # least times for the mask-only function: each input read once, each
    # output written once, and its float ops.  The scan reads the samples
    # and reads and writes the carry, rings and sums; the mask writes the
    # packed mask and reads and writes the histories.  The six dependency
    # channels passed between the two (24 B/sample written, 24 read back)
    # are a cost of the two-kernel design, not of the function.
    n = chunk * STREAMS
    nbv = len(plan.bv_widths)
    state_b = plan.nstate * STREAMS * 4
    hist_b = lay.hist_rows * STREAMS * 4
    scan_ops = 19 + 2 * nbv + 2 + 2 * len(plan.q_widths) + 4 * len(plan.pb)
    mask_ops = (1 + 9 * len(plan.a_rates) + 9 * len(plan.f_rates)
                + 2 * len(plan.b_delays) + 5)
    t["scan_bound"] = _bound(4 * n + 2 * (state_b - hist_b), scan_ops * n)
    t["mask_bound"] = _bound(n + 2 * hist_b, mask_ops * n)
    t["chunk_mask_bound"] = _bound(5 * n + 2 * state_b,
                                   (scan_ops + mask_ops) * n)
    return t


def _bound(nbytes, ops):
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = ops / H100_F32_OPS_PER_S * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations")


def build_lanes(templates):
    from torch_synth import lane

    caps, reps = [], []
    for i in range(STREAMS):
        x, r = lane(templates[i % len(templates)], WINDOW, seed=1000 + i)
        caps.append(x)
        reps.append(r)
    return caps, reps


def run_main_path(caps):
    """chained_batch_masks over every capture, with its step times; launch
    counts are read around exactly this call."""
    import torch

    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.dsp import fused_frontend as ff

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    from nfclab_torch.dsp.conditioner_kernel import COND

    steps = cc.StepTimes()
    for k in (*ff.KERNELS, COND):
        k.launches = 0
    t0 = time.perf_counter()
    res = cc.chained_batch_masks(caps, RATE, device="cuda", timings=steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ff.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never ran on the main path")
    return res, dt, launches, peak, steps


def _frames_key(frames):
    from nfclab_torch.apps.decode_cli import frame_json

    return [frame_json(f) for f in frames]


def check_decode(caps, reps, res, templates):
    from nfclab_torch.core.frame import FrameType
    from nfclab_torch.runtime.decoder import NfcDecoder

    keep = (int(FrameType.NfcPollFrame), int(FrameType.NfcListenFrame))
    for i, tp in enumerate(templates):
        t0 = time.perf_counter()
        dev_frames = NfcDecoder().decode(caps[i], RATE, tpu_channels=res[i])
        host_frames = NfcDecoder().decode(caps[i], RATE)
        if _frames_key(dev_frames) != _frames_key(host_frames):
            raise AssertionError(f"{tp.name}: device-mask frames != host")
        data = [f.data for f in dev_frames if f.frame_type in keep]
        if data != tp.sent * reps[i]:
            raise AssertionError(f"{tp.name}: frames != synthesized bytes")
        log(f"decode {tp.name}: {len(dev_frames)} frames, device mask == host "
            f"== synth bytes ({len(res[i]['detect_idx'])} triggers, "
            f"{time.perf_counter() - t0:.2f} s)")


def check_cli(templates):
    from nfclab_torch.io.wav import write_wav

    out_dir = ROOT / "chiprun_out" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    wav = out_dir / "nfca_106k.wav"
    write_wav(str(wav), templates[0].samples, RATE)
    lines = {}
    for fe in ("host", "mask"):
        proc = subprocess.run(
            [sys.executable, "-m", "nfclab_torch.apps.decode_cli", "run",
             "--json", "--frontend", fe, str(wav)],
            capture_output=True, text=True, cwd=ROOT, timeout=600,
        )
        if proc.returncode != 0:
            raise AssertionError(f"CLI --frontend {fe} failed:\n{proc.stderr}")
        lines[fe] = proc.stdout.splitlines()
    if not lines["mask"] or lines["mask"] != lines["host"]:
        raise AssertionError("CLI --frontend mask lines != --frontend host")
    log(f"CLI run --frontend mask == --frontend host ({len(lines['mask'])} "
        "lines)")
    return out_dir


COND_CHANNELS = ("envelope", "filtered", "deviation", "average", "mod_depth")


def run_dense_frontend(dev, caps, reps=3):
    """jitted_frontend(10 MS/s) over [STREAMS, 65536] of the captures on
    the card: ms per call (host clock, each call ended by a device sync),
    samples/s, peak memory and conditioning launches per call; then the
    same call on the CPU over DENSE_CPU_STREAMS of the streams.  The
    conditioning channels and mod_depth must be bit-exact; the masks equal
    (their box sums take value prefixes, which accumulate exactly in
    float64 here); the other float channels within 8 float32 ulps of the
    row's input sum (a prefix rounded at a float64 tie; Sum|value| / p2
    for sd_a, which divides its four boxes by the half-symbol width p2,
    10 * Sum filt^2 for the squared and product boxes)."""
    import numpy as np
    import torch

    from nfclab_torch.core.params import nfca_bitrates
    from nfclab_torch.dsp import conditioner_kernel as ck
    from nfclab_torch.dsp.frontend import jitted_frontend

    fn = jitted_frontend(RATE)
    chunk = 65536
    x = torch.from_numpy(np.stack([cp[:chunk] for cp in caps])).to(dev)
    fn(x)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ck.COND.launches = 0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(x)
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    launches = ck.COND.launches / reps
    peak = torch.cuda.max_memory_allocated()
    nbytes = sum(o.numel() * o.element_size() for o in out.values())
    res = {"ms": dt * 1e3, "samples_per_s": x.numel() / dt,
           "max_memory_allocated_gib": peak / 2**30,
           "output_gib": nbytes / 2**30, "cond_launches_per_call": launches,
           "outputs": len(out)}
    if launches != 1:
        raise AssertionError(f"dense frontend launched the conditioning "
                             f"kernel {launches} times per call")

    k = DENSE_CPU_STREAMS
    t0 = time.perf_counter()
    want = jitted_frontend(RATE, device="cpu")(x[:k].cpu())
    res["cpu_check_s"] = time.perf_counter() - t0
    if list(want) != list(out):
        raise AssertionError("dense frontend keys differ between devices")
    xs = x[:k].cpu().double()
    s_val = xs.abs().sum(1, keepdim=True)
    s_sq = (want["filtered"].double() ** 2).sum(1, keepdim=True) * 10.0
    eps = float(np.finfo(np.float32).eps)
    p2 = {f"sd_a_{br.rate_type}": br.period2 for br in nfca_bitrates(RATE)}
    worst = {}
    for name, w in want.items():
        g = out[name][:k].cpu()
        if g.dtype != w.dtype:
            raise AssertionError(f"dense frontend {name}: dtype {g.dtype} "
                                 f"!= {w.dtype} on the CPU")
        if name in COND_CHANNELS or w.dtype == torch.bool:
            if not _same(g, w):
                raise AssertionError(f"dense frontend {name} != CPU")
            continue
        tol = 8 * eps * (s_val / p2[name] if name in p2 else s_sq)
        d = (g.double() - w.double()).abs()
        worst[name] = float(d.max())
        if bool((d > tol).any()):
            raise AssertionError(f"dense frontend {name} off the CPU beyond "
                                 f"tolerance: max err {worst[name]}")
    res["max_abs_err_tolerance_channels"] = max(worst.values())
    del out, want
    return res


def long_capture(templates, seed=21):
    """(samples, expected polls+listens): LONG samples of the templates in
    turn, each at a seeded gain, then a field-off stretch of 200k-400k
    samples (noise about zero), long enough that the envelope keeps no
    memory a halo can recover, so blocks need repairs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = np.empty(LONG, np.float32)
    pos, i = 0, 0
    while pos < LONG:
        tp = templates[i % len(templates)]
        i += 1
        seg = tp.samples * np.float32(rng.uniform(0.8, 1.25))
        off = (np.float32(2e-3) * rng.standard_normal(
            int(rng.integers(200_000, 400_000)))).astype(np.float32)
        for part in (seg, off):
            n = min(len(part), LONG - pos)
            x[pos : pos + n] = part[:n]
            pos += n
    return x


def run_conditioner_path(templates, out_dir):
    """Phase 7: condition_jax on the long capture against the C++ oracle,
    then the conditioning path through NfcDecoder(conditioner="jax") with
    the launch counts read around exactly that call; decode_batch and the
    CLI on the template WAVs."""
    import numpy as np

    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp import conditioner_kernel as ck
    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.dsp.conditioner import _edge_tracker, condition_jax
    from nfclab_torch.native import condition_exact
    from nfclab_torch.runtime.batch import decode_batch
    from nfclab_torch.runtime.decoder import NfcDecoder

    x = long_capture(templates)
    params = SignalParams(RATE)
    stats = {}
    t0 = time.perf_counter()
    cond = condition_jax(x, params, stats=stats)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = condition_exact(x, params)
    wall_native = time.perf_counter() - t0
    for name in ("value", "envelope", "filtered", "deviation", "average",
                 "mod_depth", "edge_peak", "edge_time"):
        a, b = getattr(cond, name), getattr(ref, name)
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(
                a.view(np.uint32), b.view(np.uint32)):
            raise AssertionError(f"condition_jax {name} != C++ oracle on the "
                                 "long capture")
    if stats["repairs"] < 1:
        raise AssertionError("the long capture needed no repair")
    # the host edge tracker's share of condition_jax, timed alone
    t0 = time.perf_counter()
    _edge_tracker(cond.filtered, params)
    wall_tracker = time.perf_counter() - t0
    res = {"samples": LONG, "blocks": stats["blocks"],
           "repairs": stats["repairs"], "condition_jax_s": wall,
           "edge_tracker_s": wall_tracker, "condition_exact_s": wall_native}
    log(f"condition_jax == C++ oracle (bit-exact, 8 arrays) on {LONG} "
        f"samples: {json.dumps(res)}")

    # the conditioning path, launch counts read around exactly this call
    for kern in (*ff.KERNELS, ck.COND):
        kern.launches = 0
    t0 = time.perf_counter()
    frames = NfcDecoder(conditioner="jax").decode(x, RATE)
    res["decode_jax_s"] = time.perf_counter() - t0
    launches = ck.COND.launches
    if launches <= 0:
        raise AssertionError("condition_scan never ran on the conditioning "
                             "path")
    t0 = time.perf_counter()
    native = NfcDecoder().decode(x, RATE)
    res["decode_native_s"] = time.perf_counter() - t0
    if _frames_key(frames) != _frames_key(native):
        raise AssertionError("NfcDecoder(conditioner='jax') frames != native "
                             "on the long capture")
    res["frames"] = len(frames)
    res["cond_launches"] = launches
    log(f"conditioning path: NfcDecoder(conditioner='jax') == native "
        f"({len(frames)} frames, {launches} condition_scan launches)")

    from nfclab_torch.io.wav import write_wav

    paths = []
    for tp in templates:
        paths.append(str(out_dir / f"{tp.name}.wav"))
        write_wav(paths[-1], tp.samples, RATE)
    want = decode_batch(paths, conditioner="native", pool="thread")
    for kw in ({"conditioner": "jax"}, {"frontend": "mask"}):
        got = decode_batch(paths, pool="thread", **kw)
        for p in paths:
            if _frames_key(got[p]) != _frames_key(want[p]) or not got[p]:
                raise AssertionError(f"decode_batch({kw}) {p} != native")
        log(f"decode_batch({kw}) == native on {len(paths)} template WAVs")

    lines = {}
    for extra in ((), ("--conditioner", "jax"),
                  ("--conditioner", "jax", "--frontend", "mask")):
        proc = subprocess.run(
            [sys.executable, "-m", "nfclab_torch.apps.decode_cli", "run",
             "--json", *extra, paths[0]],
            capture_output=True, text=True, cwd=ROOT, timeout=600,
        )
        if proc.returncode != 0:
            raise AssertionError(f"CLI {extra} failed:\n{proc.stderr}")
        lines[extra] = proc.stdout.splitlines()
    if not lines[()] or any(v != lines[()] for v in lines.values()):
        raise AssertionError("CLI --conditioner jax lines != native")
    log(f"CLI run --conditioner jax (with and without --frontend mask) == "
        f"native ({len(lines[()])} lines)")
    return res, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-2)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "nfclab_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # 1. build
    from nfclab_torch.kernels import build as kbuild
    from nfclab_torch.native import build as nbuild

    t0 = time.perf_counter()
    kbuild.build(force=True)
    log(f"nvcc build: {time.perf_counter() - t0:.1f} s")
    for ln in kbuild.ptxas_lines():
        log("  " + ln.strip())
    t0 = time.perf_counter()
    nbuild.build()
    log(f"native build: {time.perf_counter() - t0:.1f} s")

    # 2. kernels vs plain, bit-exact, two rates; C++ oracle
    errs = {"fused_scan": 0.0, "fused_mask": 0.0, "condition_scan": 0.0}
    x, outs = check_kernels(dev, RATE, CHECK_CHUNK, 2, errs)
    check_oracle(x, outs, RATE)
    check_kernels(dev, 3_200_000, CHECK_CHUNK, 2, errs)
    del x, outs
    for rate in (RATE, 3_200_000):
        check_condition_kernel(dev, rate, CHECK_CHUNK, 2, errs)
    if args.kernels_only:
        log(json.dumps({"max_abs_err": errs}))
        return 0

    # 3. kernels vs plain at the main path's shape, on its captures; times
    from torch_synth import templates as make_templates

    tpls = make_templates()
    t0 = time.perf_counter()
    caps, reps = build_lanes(tpls)
    log(f"built {len(caps)} captures x {WINDOW} samples in "
        f"{time.perf_counter() - t0:.1f} s")
    tk = check_main_shape(dev, caps, errs)
    tk.update(check_condition_main_shape(dev, caps, errs))
    log(f"times at {STREAMS} x 65536 (ms): {json.dumps(tk)}")

    # 4. the main path at full width
    res, dt, launches, peak, steps = run_main_path(caps)
    n = len(caps) * WINDOW
    log(f"main path: chained_batch_masks {len(caps)} x {WINDOW}: "
        f"{dt * 1e3:.1f} ms per window, {n / dt:.4g} samples/s, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB, launches {launches}")
    if any(r["n"] != WINDOW for r in res):
        raise AssertionError("main path returned a wrong capture length")
    cap = max(4096, WINDOW // 16)
    counts = [len(r["detect_idx"]) for r in res]
    log("main path steps (s, each ended by a device sync): "
        + json.dumps(dict(steps, unattributed=dt - sum(steps.values()))))
    log(f"compaction cap {cap}: {sum(c > cap for c in counts)} of "
        f"{len(counts)} streams over it, most triggers {max(counts)}")

    # 5. frames
    check_decode(caps, reps, res, tpls)
    del res
    out_dir = check_cli(tpls)

    # 6. the dense frontend at full width
    dense = run_dense_frontend(dev, caps)
    del caps
    log(f"dense frontend {STREAMS} x 65536 at {RATE} Hz: {json.dumps(dense)}")

    # 7. the device conditioner and its callers
    cpath, cond_launches = run_conditioner_path(tpls, out_dir)
    log(f"conditioning path: {json.dumps(cpath)}")

    kernels = []
    for name, key, src, tpu, n in (
            ("fused_scan", "scan", SOURCE, TPU_KERNEL, launches["fused_scan"]),
            ("fused_mask", "mask", SOURCE, TPU_KERNEL, launches["fused_mask"]),
            ("condition_scan", "cond", COND_SOURCE, COND_TPU_KERNEL,
             cond_launches)):
        bound, by = tk[f"{key}_bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": tpu, "launches": n,
            "max_abs_err": errs[name], "ms": tk[f"{key}_ms"],
            "plain_ms": tk[f"{key}_plain_ms"], "bound_ms": bound,
            "bound_by": by, "library_ms": None,
        })
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
