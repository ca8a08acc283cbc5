"""Device-computed channels and detect triggers feeding the host symbol
walk.

Counterpart of ``nfclab/dsp/tpu_channels.py``.  Every entry point runs
captures as independent streams through the fused frontend kernels
(dsp/fused_frontend.py), and ``preload_channels`` stuffs the results into a
decode context's ``LazyChannels`` cache, so the tech FSMs take them from
the device instead of recomputing them on the host:

- the mask frontend (``chained_batch_masks``, ``fused_capture_masks``):
  the chained exact-state engine runs K-chunk windows with carried state
  and compacts the packed detect mask on the device to (indices, bits,
  count); conditioning and box channels build natively on the host.
  ``run_segmented_masks`` splits each stream's window over several kernel
  lanes (the live farm's engine, runtime/farm.py);
- the full-channel frontend (``fused_capture_all``, ``fused_batch_all``):
  the exact chained runner (``_run_batch_chained``) fetches the
  conditioning, the box channels and the dense mask of every sample; only
  the carrier-edge tracker runs on the host;
- the box channels (``fused_capture_channels``, ``fused_batch_channels``):
  the overlap-save block layout (``_run_batch_blocks``), every block an
  independent stream from zero state, with the batch form's triggers
  from the chained engine.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the kernels' plain versions); with no card and no ``device="cpu"`` they
raise.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.params import SignalParams, nfca_bitrates

# body / halo sizes of the overlap-save block layout; H + L must be a
# multiple of the kernels' TILE (128)
DEFAULT_L = 24576
DEFAULT_H = 8192

_WARMUP = 1024  # detect indices start here (channels.py / NfcA.cpp:220-221)

# relative loosening of the A/F/V SD trigger thresholds in the MASK-ONLY
# frontend, covering the kernel-f32 vs host-f64 box-sum roundoff divergence
# with orders-of-magnitude headroom (extra trigger candidates are always
# safe, missing ones never are)
MASK_ONLY_MARGIN = 1.0 / 256

CHAIN_CHUNK = 1 << 16


def channel_plan(sample_rate: int) -> dict:
    """Rate-parametric derivation of the decode channel set — the general
    form of the fused kernel's 10 MS/s constants, built from the same
    bitrate tables the host FSMs use (core.params.nfca_bitrates,
    demod.nfcv.nfcv_bitrate)."""
    from ..demod.nfcv import nfcv_bitrate

    bra = nfca_bitrates(sample_rate)
    brv = nfcv_bitrate(sample_rate)
    bv = sorted({br.period2 for br in bra} | {brv.period2})
    # box_sq consumers: A 106k ASK listen (p2), V listen (p1)
    q = sorted({bra[0].period2, brv.period1})
    # box_bpsk consumers: BPSK listen product integrators, (p1, p4) per A
    # rate (B 106k shares A's table)
    pb = sorted(((br.period1, br.period4) for br in bra), reverse=True)
    return {
        "bv": tuple(bv),
        "q": tuple(q),
        "pb": tuple(pb),
        # detect-trigger parameter tuples (d, gap, p2, box width)
        "a_rates": tuple(
            (br.symbol_delay_detect, br.period1 - br.period2, br.period2)
            for br in bra
        ),
        "b_delays": tuple(br.symbol_delay_detect for br in bra[:2]),
        "f_rates": tuple(
            (0, br.period1 - br.period2, br.period2) for br in bra[1:]
        ),
        "v_rate": (
            brv.symbol_delay_detect, brv.period1 - brv.period2, brv.period2
        ),
    }


def box_keys(sample_rate: int) -> dict:
    """Channel name -> (LazyChannels cache key, kind code, width, lag) for
    the rate's box channel set (see channels.py getters)."""
    plan = channel_plan(sample_rate)
    out = {}
    for w in plan["bv"]:
        out[f"bv{w}"] = (("bv", w), 0, w, 0)
    for w in plan["q"]:
        out[f"q{w}"] = (("bq", w), 1, w, 0)
    for lag, box in plan["pb"]:
        out[f"p{lag}x{box}"] = (("bp", lag, box), 2, box, lag)
    return out


def fetch_names(sample_rate: int) -> tuple:
    """Rate's box channel names + detect_mask (the non-conditioning
    kernel output set)."""
    return tuple(box_keys(sample_rate)) + ("detect_mask",)


_COND_FETCH = ("envelope", "filtered", "deviation", "average", "mod_depth")


class DeviceUnavailable(RuntimeError):
    """CUDA was asked for and there is no card."""


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises DeviceUnavailable when
    CUDA is asked for and there is no card (there is no silent CPU
    fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


_GRID_BLOCK = 1 << 24  # samples per grid-probe block


def _grid_codes(x: np.ndarray):
    """(codes, shift) when every sample of x lies on the int16 grid
    (int8 codes when the low byte is always zero), else None.  Probes in
    blocks so an off-grid input is rejected after its first block."""
    flat = x.reshape(-1)
    if flat.size == 0:
        return None
    scale = np.float32(1 << 15)
    for lo in range(0, flat.size, _GRID_BLOCK):
        s = flat[lo : lo + _GRID_BLOCK] * scale
        if not (np.array_equal(s, np.floor(s))
                and s.min() >= -(1 << 15) and s.max() < (1 << 15)):
            return None
    codes = (x * scale).astype(np.int16)
    if not np.any(codes & 0xFF):
        return (codes >> 8).astype(np.int8), 7
    return codes, 15


def upload_samples(x: np.ndarray, device) -> torch.Tensor:
    """Send a [rows, T] f32 sample matrix to `device`, shrinking the bytes
    when the samples sit on an integer grid: 8-bit sources ship as 1-byte
    codes, 16-bit WAV as 2-byte codes, dequantized on the device by an
    exact power-of-two scale (bit-identical to the host's f32 samples)."""
    x = np.ascontiguousarray(x, np.float32)
    dev = torch.device(device)
    grid = _grid_codes(x)
    if grid is None:
        return torch.from_numpy(x).to(dev)
    codes, shift = grid
    return torch.from_numpy(codes).to(dev).to(torch.float32) * (
        2.0 ** -shift
    )


def chain_state0(n_streams: int = 1024, sample_rate: int = 10_000_000,
                 device="cuda") -> torch.Tensor:
    """Fresh carried kernel state for a chained stream batch:
    [n_streams, kernel_plan(sample_rate).nstate] zeros."""
    from .fused_frontend import kernel_plan

    return torch.zeros(n_streams, kernel_plan(sample_rate).nstate,
                       dtype=torch.float32, device=resolve_device(device))


def chained_mask_params(power_level_threshold: float, thresholds=None):
    """Margined kernel mask params for the chained engine: SD thresholds
    carry MASK_ONLY_MARGIN (kernel f32 boxes vs host f64 walk re-check);
    the power gate needs NO margin here — chained conditioning is the
    exact streaming envelope."""
    from ..core.thresholds import DecoderThresholds

    p, a, b_deep, f, v = (
        thresholds or DecoderThresholds()
    ).detect_mask_tuple(power_level_threshold)
    m = 1.0 - MASK_ONLY_MARGIN
    return (p, a * m, b_deep, f * m, v * m)


def _compact(mm: torch.Tensor, cap: int):
    """Per row of a [n, T] u8 mask: the first `cap` nonzero positions
    (-1 padded), their bits and the full nonzero count — the
    jnp.nonzero(size=cap, fill_value=-1) compaction of the JAX engine."""
    n, T = mm.shape
    dev = mm.device
    idx = torch.full((n, cap), -1, dtype=torch.int32, device=dev)
    bits = torch.zeros((n, cap), dtype=torch.uint8, device=dev)
    cnt = (mm != 0).sum(dim=1, dtype=torch.int32)
    ar = torch.arange(cap, device=dev)
    # torch.nonzero takes fewer than 2**31 elements at a time
    rows_per = max(1, (1 << 30) // max(T, 1))
    for r0 in range(0, n, rows_per):
        sub = mm[r0 : r0 + rows_per]
        nz = torch.nonzero(sub)  # row-major order
        if nz.shape[0] == 0:
            continue
        c = cnt[r0 : r0 + rows_per].to(torch.int64)
        starts = torch.cumsum(c, 0) - c
        valid = ar[None, :] < c[:, None]
        take = (starts[:, None] + ar[None, :]).clamp(max=nz.shape[0] - 1)
        cols = nz[take, 1]
        idx[r0 : r0 + rows_per] = torch.where(valid, cols, -1).to(
            torch.int32
        )
        bits[r0 : r0 + rows_per] = torch.where(
            valid, sub.gather(1, cols), 0
        ).to(torch.uint8)
    return idx, bits, cnt


def _no_lap(step: str) -> None:
    pass


class StepTimes(dict):
    """Seconds spent in each step of chained_batch_masks or
    _run_batch_chained (and fused_batch_all), summed over their windows or
    chunks (pass one as ``timings``).  Each step is ended by a device
    sync, so a kernel's time lands in the step that launched it; without
    a StepTimes the engine adds no sync."""

    def start(self, dev: torch.device):
        self._dev = dev
        self._t = time.perf_counter()
        return self.lap

    def lap(self, step: str) -> None:
        if self._dev.type == "cuda":
            torch.cuda.synchronize(self._dev)
        now = time.perf_counter()
        self[step] = self.get(step, 0.0) + (now - self._t)
        self._t = now


def _stage(caps: list, lo: int, width: int, live: int) -> np.ndarray:
    """[live, width] f32 host block of the live captures from sample lo,
    zero-padded past each capture's end."""
    batch = np.zeros((live, width), np.float32)
    for i in range(live):
        seg = caps[i][lo : lo + width]
        batch[i, : len(seg)] = seg
    return batch


def _run_chunks(x: torch.Tensor, st: torch.Tensor, base0: int, pt, mp,
                plan, chunk: int):
    """The kernels over a [n_live, T] device block, chunk by chunk with
    carried [nstate, B] state (streams past n_live are fed zeros).
    Returns the [n_live, T] u8 detect mask, the new state and the state
    before the last chunk."""
    from .fused_frontend import run_chunk

    n_live, T = x.shape
    xc = torch.zeros(chunk, st.shape[1], dtype=torch.float32,
                     device=x.device)
    mm = torch.empty(n_live, T, dtype=torch.uint8, device=x.device)
    pen = st
    for lo in range(0, T, chunk):
        xc[:, :n_live] = x[:, lo : lo + chunk].t()
        pen = st
        outs, st = run_chunk(xc, st, base0 + lo, pt, mp, plan,
                             ("detect_mask",))
        mm[:, lo : lo + chunk] = outs["detect_mask"][:, :n_live].t()
    return mm, st, pen


def _fetch(mm: torch.Tensor, idx, bits, cnt, cap: int, lap=_no_lap):
    """Per-row (rel_idx i64, bits u8) on the host.  The count vector comes
    first (it also waits for the window), then only what each row needs:
    the compacted prefix for sparse rows, and the dense mask rows of the
    rows that overflow the cap, gathered on the device and moved in one
    transfer."""
    n_live = mm.shape[0]
    cnt_h = cnt.cpu().numpy()
    over = np.flatnonzero(cnt_h > cap)
    idx_h = bits_h = None
    if len(over) < n_live:
        width = int(min(cap, cnt_h.max()))
        idx_h = idx[:, :width].cpu().numpy()
        bits_h = bits[:, :width].cpu().numpy()
    lap("fetch")
    dense = {}
    if len(over):
        rows = mm[torch.from_numpy(over).to(mm.device)].cpu().numpy()
        for i, row in zip(over.tolist(), rows):
            rel = np.flatnonzero(row).astype(np.int64)
            dense[i] = (rel, row[rel])
    lap("overflow_rows")
    out = []
    for i in range(n_live):
        if i in dense:
            out.append(dense[i])
        else:
            c = int(cnt_h[i])
            out.append((idx_h[i][:c].astype(np.int64), bits_h[i][:c]))
    lap("assemble")
    return out


def _state_rows(st: torch.Tensor, n: int | None = None) -> np.ndarray:
    """Host [n, nstate] rows (a copy) of the first n lanes (all by
    default) of a section-major [nstate, B] state."""
    return np.array(st[:, :n].t().cpu().numpy())


def _expand_state(rows: np.ndarray, device) -> torch.Tensor:
    """[n, nstate] host state rows -> the [n, nstate] kernel state on
    `device` (stream i at row i)."""
    return torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(
        device
    )


def run_chained_masks(blocks: np.ndarray, state: torch.Tensor, base0: int,
                      pt, mp, cap_div: int = 16, chunk: int | None = None,
                      sample_rate: int = 10_000_000, lap=_no_lap,
                      want_carry: bool = False):
    """One chained-K window + compacted fetch.

    blocks: [n_live, T] f32 host samples, T % chunk == 0 (chunk defaults
    to the module's CHAIN_CHUNK, read at call time), for the first n_live
    streams of `state` ([B, nstate] on the device to run on; the other
    streams are fed zeros).  Returns (per-stream list of (rel_idx i64,
    bits u8), state_out).  Streams whose trigger count overflows the
    compaction cap take their dense mask row instead.  `lap` ends each
    step (see StepTimes).

    want_carry=True additionally returns {"pen", "end"}: host
    [n_live, nstate] state rows one chunk before the window's end and at
    its end -- the segmented engine's carry handoff
    (run_segmented_masks)."""
    from .fused_frontend import kernel_plan

    if chunk is None:
        chunk = CHAIN_CHUNK
    n_live, T = blocks.shape
    if T % chunk:
        raise ValueError(f"window {T} is not a multiple of chunk {chunk}")
    cap = max(4096, T // cap_div)
    dev = state.device
    if n_live > state.shape[0]:
        raise ValueError(f"{n_live} rows for a state of {state.shape[0]} "
                         "streams")
    plan = kernel_plan(sample_rate)
    x = upload_samples(blocks, dev)
    lap("upload")
    mm, st, pen = _run_chunks(x, state.t().contiguous(), base0, pt, mp,
                              plan, chunk)
    del x
    lap("chunks")
    idx, bits, cnt = _compact(mm, cap)
    lap("compact")
    per = _fetch(mm, idx, bits, cnt, cap, lap)
    if want_carry:
        carry = {"pen": _state_rows(pen, n=n_live),
                 "end": _state_rows(st, n=n_live)}
        return per, st.t().contiguous(), carry
    return per, st.t().contiguous()


# ---------------------------------------------------------------------------
# Segmented speculative-lane engine: the chained engine's device stage is
# serial in the window length (K chunks through one lane per stream), so a
# farm of few streams uses a handful of lanes and the window's device time
# is the FULL window's serial step count.  This engine splits each
# stream's window into S segments that ride S parallel lanes -- device
# time drops to (K/S + 1) chunks -- using the host conditioner's halo +
# verify + repair scheme on the kernels' carried state:
#
# - lane (i, 0) continues stream i's EXACT chain: its incoming state is the
#   previous window's state at (end - chunk) and its halo chunk REPLAYS the
#   previous window's last chunk (same samples, congruent ring phases), so
#   its post-halo state is bit-identical to the previous end state;
# - lanes (i, s>0) are SPECULATIVE: canonical warm-up seed (env/avg = first
#   halo sample, w1 = 10x -- the conditioner's init) over a one-chunk halo
#   of the real preceding samples;
# - verify: a segment is accepted iff its post-halo conditioning carry
#   (env, w1, mdev, avg, pulse -- the rows that determine every downstream
#   value) equals its predecessor's end carry BIT-EXACTLY.  Ring buffers,
#   histories and their phases are exact by construction after the halo
#   (every extent <= 601 samples << the 65536-sample halo, and all segment
#   offsets are congruent mod the fold modulus); the running box sums carry
#   a fresh f32 accumulation of the same windows -- the SAME roundoff family
#   as the production chain vs the host f64 walk, covered by
#   MASK_ONLY_MARGIN (the wrong early-halo contributions are ring-stored
#   and subtracted back out bit-identically when they leave the window);
# - repair: the first unverified segment onward re-runs through the EXACT
#   chained engine (pow2 chunk buckets) from the accepted predecessor's
#   full end state -- worst case one serial window, i.e. the
#   pre-segmentation behavior.
#
# The mask soundness structure is unchanged: the power gate reads an
# envelope that is bit-exactly the true streaming envelope on every
# accepted segment, and SD triggers keep MASK_ONLY_MARGIN.
#
# Lane (i, s) is row i*S + s of the kernels' [nstate, n_lanes] state; the
# kernels take any lane count, so no lane padding is needed.

_NVER = 5  # verified carry rows: env, w1, mdev, avg, pulse-count


def _segmented_masks(x: torch.Tensor, tail: torch.Tensor,
                     carry_in: torch.Tensor, pt, mp, plan, S: int, B: int,
                     chunk: int, base: int, cap: int) -> dict:
    """The device stage of run_segmented_masks: x [n_live, S*B*chunk],
    tail [n_live, chunk] and carry_in [n_live, nstate] on the device ->
    {"mm": [n_lanes, B*chunk] u8, "idx"/"bits"/"cnt" (its compaction),
    "vh"/"ve": [n_lanes, _NVER] carry rows after the halo / at the end,
    "pen"/"end": [nstate, n_live] states of the streams' last lanes one
    chunk before the end / at the end, "st": the [nstate, n_lanes] end
    state}.

    Lane (i, s) = row i*S + s covers body samples [s*B*chunk,
    (s+1)*B*chunk) of stream i after one halo chunk; `base` is the rate's
    fold modulus (all segment offsets are multiples of it, so one base
    serves every lane and chunk with identical ring phases)."""
    from .fused_frontend import run_chunk

    n_live = x.shape[0]
    n_lanes = n_live * S
    dev = x.device
    x4 = x.view(n_live, S, B, chunk)
    # halo chunk per lane: the previous window's tail for s=0, the
    # preceding segment's last chunk for s>0 (device-side slices -- the
    # halo costs no extra upload)
    prev = torch.cat([tail[:, None, :], x4[:, : S - 1, B - 1, :]], dim=1)

    # initial state: speculative lanes get the conditioner's canonical
    # warm-up seed from their halo's first sample; lanes (i, 0) get the
    # carried end-minus-one-chunk state (full nstate rows)
    heads = prev[:, :, 0].reshape(n_lanes)
    st = torch.zeros(plan.nstate, n_lanes, dtype=torch.float32, device=dev)
    st[0] = heads                                  # env
    st[1] = heads * 10.0                           # w1 steady state
    st[3] = heads                                  # avg
    st[:, 0::S] = carry_in.t()

    xc = torch.empty(chunk, n_lanes, dtype=torch.float32, device=dev)
    mm = torch.empty(n_lanes, B * chunk, dtype=torch.uint8, device=dev)
    vh = pen = None
    for k in range(B + 1):
        src = prev if k == 0 else x4[:, :, k - 1, :]
        xc.view(chunk, n_live, S).copy_(src.permute(2, 0, 1))
        if k == B:
            pen = st  # state at window end minus one chunk
        outs, st = run_chunk(xc, st, base, pt, mp, plan, ("detect_mask",))
        if k == 0:
            vh = st[:_NVER].t().contiguous()
        else:
            mm[:, (k - 1) * chunk : k * chunk] = outs["detect_mask"].t()
    idx, bits, cnt = _compact(mm, cap)
    return {"mm": mm, "idx": idx, "bits": bits, "cnt": cnt, "vh": vh,
            "ve": st[:_NVER].t().contiguous(), "pen": pen[:, S - 1 :: S],
            "end": st[:, S - 1 :: S], "st": st}


def run_segmented_masks(blocks: np.ndarray, carry: dict, pt, mp,
                        segments: int, cap_div: int = 16,
                        chunk: int | None = None,
                        sample_rate: int = 10_000_000,
                        k_bucket: int = 32, device="cuda"):
    """Segment-parallel chained masks over one window (see the scheme note
    above).  blocks: [n_live, T] host samples, T = K*chunk, segments | K
    (chunk defaults to the module's CHAIN_CHUNK, read at call time);
    carry: {"pen": [n_live, nstate] state at prev end - chunk,
    "end": same at prev end, "tail": [n_live, chunk] prev last chunk}, on
    the host.  Runs on `device` (``cpu``: the kernels' plain versions).
    Returns (per-stream (rel i64, bits u8) window-relative, new carry,
    {"repaired_streams", "repair_chunks"})."""
    from .fused_frontend import kernel_plan

    if chunk is None:
        chunk = CHAIN_CHUNK
    dev = resolve_device(device)
    n_live, T = blocks.shape
    S = segments
    assert T % chunk == 0
    K = T // chunk
    assert S >= 2 and K % S == 0
    B = K // S
    plan = kernel_plan(sample_rate)
    base = plan.fold_modulus
    cap = max(4096, (B * chunk) // cap_div)
    x = upload_samples(blocks, dev)
    tail = upload_samples(np.ascontiguousarray(carry["tail"]), dev)
    d = _segmented_masks(x, tail, _expand_state(carry["pen"], dev), pt, mp,
                         plan, S, B, chunk, base, cap)
    del x, tail
    vh, ve = d["vh"].cpu().numpy(), d["ve"].cpu().numpy()

    # verify EVERY pairwise boundary (NaN compares unequal, which
    # correctly forces a repair): ok[i][s] means lane (i, s)'s post-halo
    # carry equals lane (i, s-1)'s end carry, i.e. segment s is exact
    # WHENEVER its predecessor is
    boundary_ok = np.ones((n_live, S), bool)
    for i in range(n_live):
        for s in range(1, S):
            l = i * S + s
            boundary_ok[i, s] = np.array_equal(vh[l], ve[l - 1])
    first_bad: dict[int, int] = {
        i: int(np.argmin(boundary_ok[i]))
        for i in range(n_live)
        if not boundary_ok[i].all()
    }

    # every lane's triggers (lanes inside a repair range get overwritten,
    # but fetching them is cheaper than a second round trip when the
    # repair early-stops and re-accepts them)
    per_lane = _fetch(d["mm"], d["idx"], d["bits"], d["cnt"], cap)

    # repair with convergence stop (the conditioner's scheme): re-run the
    # first unverified segment exactly from the accepted predecessor's
    # full end state, then compare the repaired end carry against the
    # NEXT speculative lane's post-halo carry -- a match means that lane
    # (and everything after it, already verified pairwise) is exact, so
    # the remaining speculative results are accepted as-is.  Divergence
    # that persists escalates the repair span by powers of two, so a
    # pause spanning many segments costs O(log S) windows, while the
    # common localized case (a frame near one boundary) costs one.
    rep_seg: dict[tuple, tuple] = {}   # (i, s) -> (rel within seg, bits)
    rep_carry: dict[int, tuple] = {}
    repair_chunks = 0
    max_take = max(1, k_bucket // B)
    for i in first_bad:
        bad = np.flatnonzero(~boundary_ok[i])
        j = 0
        while j < len(bad):
            s = int(bad[j])
            # the predecessor lane is exact here: either it verified
            # pairwise back to an exact ancestor, or an earlier repair
            # rejoined the speculative chain before it
            l = i * S + s - 1
            state_dev = d["st"][:, l : l + 1].t().contiguous()
            step = 1
            rejoined = None
            while s < S:
                take = min(step, S - s, max_take)
                while take & (take - 1):  # pow2 chunk buckets only
                    take -= take & -take
                lo_c = s * B
                kk = take * B
                seg = blocks[i : i + 1, lo_c * chunk : (lo_c + kk) * chunk]
                per, state_dev, c2 = run_chained_masks(
                    seg, state_dev, base, pt, mp, cap_div=cap_div,
                    chunk=chunk, sample_rate=sample_rate, want_carry=True,
                )
                rel, bb = per[0]
                for ss in range(s, s + take):
                    in_seg = (rel >= (ss - s) * B * chunk) & (
                        rel < (ss - s + 1) * B * chunk
                    )
                    rep_seg[(i, ss)] = (
                        rel[in_seg] - (ss - s) * B * chunk, bb[in_seg]
                    )
                repair_chunks += kk
                s += take
                if s >= S:
                    rep_carry[i] = (c2["pen"][0], c2["end"][0])
                    break
                if np.array_equal(c2["end"][0][:_NVER], vh[i * S + s]):
                    rejoined = s  # speculative chain is exact again
                    break
                step *= 2
            if rejoined is None:
                break  # repaired through the window end
            while j < len(bad) and bad[j] <= rejoined:
                j += 1

    new_pen = _state_rows(d["pen"])
    new_end = _state_rows(d["end"])
    out = []
    for i in range(n_live):
        parts_r, parts_b = [], []
        for s in range(S):
            if (i, s) in rep_seg:
                rel, bb = rep_seg[(i, s)]
            else:
                rel, bb = per_lane[i * S + s]
            parts_r.append(rel + s * B * chunk)
            parts_b.append(bb)
        if i in rep_carry:
            new_pen[i], new_end[i] = rep_carry[i]
        out.append((np.concatenate(parts_r), np.concatenate(parts_b)))
    new_carry = {
        "pen": new_pen, "end": new_end,
        "tail": np.ascontiguousarray(blocks[:, -chunk:]),
    }
    stats = {"repaired_streams": len(first_bad),
             "repair_chunks": repair_chunks}
    return out, new_carry, stats


def chained_batch_masks(
    captures: list[np.ndarray],
    sample_rate: int,
    power_level_threshold: float = 0.01,
    thresholds=None,
    k_chunks: int = 32,
    device="cuda",
    timings: StepTimes | None = None,
) -> list[dict]:
    """SPARSE detect triggers for many captures via the chained
    exact-state engine: captures ride the kernels as independent streams
    through K-chunk windows with carried state, the packed mask is
    compacted on the device, and each capture gets
    {"detect_idx": i64 positions, "detect_bits": u8, "n": length}.

    Chained conditioning is the EXACT streaming envelope, so the mask's
    power gate is sound; the SD thresholds keep MASK_ONLY_MARGIN for the
    kernel-f32 vs host-f64 box roundoff.  `timings` (a StepTimes) collects
    the seconds of each step."""
    from .frontend import _params_tuple
    from .fused_frontend import kernel_plan

    dev = resolve_device(device)
    lap = _no_lap if timings is None else timings.start(dev)
    if not captures:
        return []
    # captures sorted by length (desc) so finished ones form a suffix:
    # each window uploads only the LIVE prefix
    order = sorted(range(len(captures)), key=lambda i: -len(captures[i]))
    caps = [np.ascontiguousarray(captures[i], np.float32) for i in order]
    params = SignalParams(
        sample_rate, power_level_threshold=power_level_threshold
    )
    pt = _params_tuple(params)
    mp = chained_mask_params(power_level_threshold, thresholds)
    t_max = len(caps[0])
    state = chain_state0(len(caps), sample_rate=sample_rate, device=dev)
    mod = kernel_plan(sample_rate).fold_modulus
    idx_parts: list[list] = [[] for _ in caps]
    bit_parts: list[list] = [[] for _ in caps]
    lap("setup")
    lo = 0
    while lo < t_max:
        # window width: k_chunks full chunks, the final window bucketed to
        # a power of two (the JAX engine's window sequence)
        rem = -(-(t_max - lo) // CHAIN_CHUNK)
        k = min(k_chunks, rem)
        if k & (k - 1):
            k2 = 1
            while k2 < k:
                k2 *= 2
            k = min(k2, k_chunks)
        width = k * CHAIN_CHUNK
        live = sum(1 for c in caps if len(c) > lo)
        batch = _stage(caps, lo, width, live)
        lap("stage")
        # int32-safe clock fold: every ring size divides the plan's fold
        # modulus and lo is a multiple of CHAIN_CHUNK (>= any ring size),
        # so the folded base keeps every ring phase (and mod >= 512 > etu
        # keeps the stream-head envelope seeding off).  Finished streams
        # are fed zeros, as their padded tails were.
        base0 = 0 if lo == 0 else mod + lo % mod
        per, state = run_chained_masks(batch, state, base0, pt, mp,
                                       chunk=CHAIN_CHUNK,
                                       sample_rate=sample_rate, lap=lap)
        del batch
        for i in range(live):
            rel, bits = per[i]
            keep = rel + lo < len(caps[i])
            idx_parts[i].append(rel[keep] + lo)
            bit_parts[i].append(bits[keep])
        lap("assemble")
        lo += width
    sorted_out = [
        {
            "detect_idx": (
                np.concatenate(ip) if ip else np.empty(0, np.int64)
            ),
            "detect_bits": (
                np.concatenate(bp) if bp else np.empty(0, np.uint8)
            ),
            "n": len(c),
        }
        for ip, bp, c in zip(idx_parts, bit_parts, caps)
    ]
    out: list = [None] * len(captures)
    for pos, i in enumerate(order):
        out[i] = sorted_out[pos]
    lap("assemble")
    return out


def fused_capture_masks(
    samples: np.ndarray,
    sample_rate: int,
    power_level_threshold: float = 0.01,
    thresholds=None,
    device="cuda",
) -> dict:
    """Sparse detect triggers ONLY for one capture — the lightest device
    frontend: O(triggers) off the device, replacing exactly the host's
    trigger-index construction; conditioning and box channels build
    natively on the host."""
    return chained_batch_masks(
        [samples], sample_rate, power_level_threshold,
        thresholds=thresholds, device=device,
    )[0]


def fused_batch_masks(
    captures: list[np.ndarray],
    sample_rate: int,
    power_level_threshold: float = 0.01,
    thresholds=None,
    device="cuda",
) -> list[dict]:
    """Sparse detect triggers for MANY captures (chained exact-state
    engine, one device pass over stream-stacked captures — see
    fused_capture_masks)."""
    return chained_batch_masks(
        captures, sample_rate, power_level_threshold,
        thresholds=thresholds, device=device,
    )


# --------------------------------------------------------------------------
# Dense outputs: the full-channel frontend and the overlap-save box layout


def _fetch_dense(outs: dict, names: tuple, n: int) -> dict:
    """{name: [n, T] host array} of the first n streams of the kernels'
    time-major [T, B] outputs, in ONE device-to-host transfer: every
    output is transposed into one byte buffer on the device (f32 outputs
    first, then the u8 mask), which crosses to the host at once."""
    T = outs[names[0]].shape[0]
    dev = outs[names[0]].device
    fl = [nm for nm in names if outs[nm].dtype == torch.float32]
    u8 = [nm for nm in names if outs[nm].dtype == torch.uint8]
    per = n * T
    nf = 4 * len(fl) * per
    buf = torch.empty(nf + len(u8) * per, dtype=torch.uint8, device=dev)
    f = buf[:nf].view(torch.float32).view(len(fl), n, T)
    m = buf[nf:].view(len(u8), n, T)
    for j, nm in enumerate(fl):
        f[j].copy_(outs[nm][:, :n].t())
    for j, nm in enumerate(u8):
        m[j].copy_(outs[nm][:, :n].t())
    host = buf.cpu().numpy()
    hf = host[:nf].view(np.float32).reshape(len(fl), n, T)
    hm = host[nf:].reshape(len(u8), n, T)
    out = {nm: hf[j] for j, nm in enumerate(fl)}
    out.update({nm: hm[j] for j, nm in enumerate(u8)})
    return out


def _run_batch_blocks(
    captures: list[np.ndarray],
    sample_rate: int,
    power_level_threshold: float,
    L: int,
    H: int,
    fetch: tuple,
    thresholds=None,
    mask_margin: float = 0.0,
    device="cuda",
) -> list[dict[str, np.ndarray]]:
    """Run MANY captures through the fused kernels in ONE launch of each
    and ONE fetch: every capture's overlap-save blocks stack along the
    kernels' stream axis.  Returns one channel dict (host arrays,
    len(samples)) per capture.

    Block scheme: the capture is cut into ``L``-sample bodies, each
    preceded by an ``H``-sample halo; every (halo + body) row runs as an
    independent stream from zero kernel state at clock 0.  Row 0 is
    samples[:H+L] (its body needs no halo: zero state IS the stream
    start), row i samples[i*L-H : i*L+L], its body sliced at H.
    Conditioning memory is short and box lookbacks are <= 474 samples +
    1024 ring warm-up, so an 8k halo makes every body sample's box value
    converge to the continuous-stream value within f32 roundoff.

    mask_margin > 0 loosens the A/F/V SD trigger thresholds by that
    relative amount in the kernel's detect mask ONLY (the fetched channels
    are unchanged), making the mask a conservative superset of the host
    f64 triggers the walk re-checks.

    Block-restart soundness (why this path may NOT feed conditioning
    consumers -- use _run_batch_chained there): each block row restarts at
    clock 0 over a zeros halo, so a halo that BEGINS mid-modulation seeds
    the envelope from the modulated level and the freeze rule
    (NfcTech.cpp:42-53) keeps it low for ~100k samples.  Box sums are
    raw-value windows (exact after the halo, restart only changes the
    roundoff family), but the power gate is not superset-safe under an
    under-estimated envelope: the batch form (fused_batch_channels) takes
    its detect triggers from the chained exact-state engine."""
    from . import fused_frontend as ff
    from ..core.thresholds import DecoderThresholds
    from .frontend import _params_tuple

    T = H + L
    if T % ff.TILE:
        raise ValueError(f"H + L = {T} is not a multiple of {ff.TILE}")
    dev = resolve_device(device)
    layouts = []  # (n, nb, row_offset) per capture
    rows = 0
    caps = []
    for samples in captures:
        samples = np.ascontiguousarray(samples, np.float32)
        caps.append(samples)
        n = len(samples)
        nb = max(1, -(-n // L))
        layouts.append((n, nb, rows))
        rows += nb
    if not rows:
        return []
    x = np.zeros((rows, T), np.float32)
    for samples, (n, nb, ro) in zip(caps, layouts):
        for i in range(nb):
            if i == 0:
                seg = samples[:T]
                x[ro, : len(seg)] = seg
            else:
                s = i * L - H
                seg = samples[s : i * L + L]
                x[ro + i, : len(seg)] = seg

    mask_params = (thresholds or DecoderThresholds()).detect_mask_tuple(
        power_level_threshold
    )
    if mask_margin:
        p, a, b_deep, f, v = mask_params
        m = 1.0 - mask_margin
        mask_params = (p, a * m, b_deep, f * m, v * m)
    params = SignalParams(
        sample_rate, power_level_threshold=power_level_threshold
    )
    plan = ff.kernel_plan(sample_rate)
    sel = ff._normalize_select(fetch, plan)
    xd = upload_samples(x, dev)
    del x
    res, _ = ff.run_chunk(
        xd.t().contiguous(),
        torch.zeros(plan.nstate, rows, dtype=torch.float32, device=dev),
        0, _params_tuple(params), mask_params, plan, sel,
    )
    del xd
    fetched = _fetch_dense(res, sel, rows)
    del res

    outs: list[dict[str, np.ndarray]] = []
    for n, nb, ro in layouts:
        out: dict[str, np.ndarray] = {}
        for name, dense in fetched.items():
            arr = np.empty(n, dense.dtype)
            for i in range(nb):
                body_off = 0 if i == 0 else H
                lo = i * L
                hi = min(lo + L, n)
                arr[lo:hi] = dense[ro + i, body_off : body_off + (hi - lo)]
            out[name] = arr
        outs.append(out)
    return outs


def _run_batch_chained(
    captures: list[np.ndarray],
    sample_rate: int,
    power_level_threshold: float,
    fetch: tuple,
    thresholds=None,
    chunk: int = 1 << 16,
    device="cuda",
    timings: StepTimes | None = None,
) -> list[dict[str, np.ndarray]]:
    """EXACT device frontend: captures ride the kernels as independent
    streams through chained chunks with carried state -- outputs
    bit-identical to a monolithic per-capture pass (fused_frontend.py's
    state contract).

    This is the required path whenever KERNEL CONDITIONING is consumed:
    the overlap-save block path (_run_batch_blocks) seeds each block from
    a zeros halo, and the envelope FREEZES during deep modulation
    (NfcTech.cpp:42-53 update=false), so no halo length can reconstruct a
    frozen envelope across a block boundary that lands mid-frame.

    Captures are sorted by length (desc) so finished streams form a
    suffix: each chunk uploads, runs and fetches only the live prefix,
    with the live streams' [nstate, live] state carried at base = the
    chunk's clock; the kernels take any stream count, so nothing is
    padded.  Each chunk's outputs cross to the host in one transfer
    (_fetch_dense); the results come back in caller order.  `timings` (a
    StepTimes) collects the seconds of each step: setup, stage, upload,
    chunks, fetch, assemble."""
    from . import fused_frontend as ff
    from ..core.thresholds import DecoderThresholds
    from .frontend import _params_tuple

    if chunk % ff.TILE:
        raise ValueError(f"chunk must be a multiple of {ff.TILE}")
    dev = resolve_device(device)
    lap = _no_lap if timings is None else timings.start(dev)
    if not captures:
        return []
    order = sorted(range(len(captures)), key=lambda i: -len(captures[i]))
    caps = [np.ascontiguousarray(captures[i], np.float32) for i in order]
    lens = [len(c) for c in caps]
    t_max = lens[0]
    if t_max >= 2 ** 31:
        raise ValueError("capture exceeds the kernels' int32 clock")
    n_chunks = -(-t_max // chunk)

    params = SignalParams(
        sample_rate, power_level_threshold=power_level_threshold
    )
    mask_params = (thresholds or DecoderThresholds()).detect_mask_tuple(
        power_level_threshold
    )
    pt = _params_tuple(params)
    plan = ff.kernel_plan(sample_rate)
    sel = ff._normalize_select(fetch, plan)

    outs = [
        {
            name: np.empty(
                n, np.uint8 if name == "detect_mask" else np.float32
            )
            for name in sel
        }
        for n in lens
    ]
    state = torch.zeros(plan.nstate, len(caps), dtype=torch.float32,
                        device=dev)
    lap("setup")
    for k in range(n_chunks):
        lo = k * chunk
        live = sum(1 for n in lens if n > lo)
        block = _stage(caps, lo, chunk, live)
        lap("stage")
        x = upload_samples(block, dev).t().contiguous()
        del block
        lap("upload")
        res, state = ff.run_chunk(x, state[:, :live].contiguous(), lo, pt,
                                  mask_params, plan, sel)
        del x
        lap("chunks")
        fetched = _fetch_dense(res, sel, live)
        del res
        lap("fetch")
        for i in range(live):
            hi = min(lens[i], lo + chunk)
            for name in sel:
                outs[i][name][lo:hi] = fetched[name][i, : hi - lo]
        del fetched
        lap("assemble")

    inv = [0] * len(captures)
    for pos, i in enumerate(order):
        inv[i] = pos
    return [outs[inv[i]] for i in range(len(captures))]


def _conditioned(samples: np.ndarray, arrs: dict, params):
    """Conditioned of one capture from the kernels' conditioning outputs;
    the carrier-edge tracker (which the kernels do not emit) runs on the
    host from a zero state at base 0."""
    from ..native.binding import Conditioned, edge_track_into

    n = len(samples)
    bufs = {
        "value": np.ascontiguousarray(samples, np.float32),
        **{k: arrs[k] for k in _COND_FETCH},
        "edge_peak": np.empty(n, np.float32),
        "edge_time": np.empty(n, np.uint32),
    }
    state = np.zeros(2, np.float64)
    edge_track_into(params, state, bufs, 0, n, 0)
    return Conditioned(
        bufs["value"], bufs["envelope"], bufs["filtered"], bufs["deviation"],
        bufs["average"], bufs["mod_depth"], bufs["edge_peak"],
        bufs["edge_time"],
    )


def _run_capture_blocks(
    samples: np.ndarray,
    sample_rate: int,
    power_level_threshold: float,
    L: int,
    H: int,
    fetch: tuple,
    thresholds=None,
    device="cuda",
) -> dict[str, np.ndarray]:
    """Run one capture through the fused kernels as overlap-save blocks;
    returns host arrays (len(samples)) for the requested channels."""
    return _run_batch_blocks(
        [samples], sample_rate, power_level_threshold, L, H, fetch,
        thresholds=thresholds, device=device,
    )[0]


def fused_capture_channels(
    samples: np.ndarray,
    sample_rate: int,
    power_level_threshold: float = 0.01,
    L: int = DEFAULT_L,
    H: int = DEFAULT_H,
    thresholds=None,
    device="cuda",
) -> dict[str, np.ndarray]:
    """Box channels + packed detect_mask for one capture, from the block
    layout (device compute; conditioning stays host-side -- see
    fused_capture_all for the full device frontend)."""
    return _run_capture_blocks(
        samples, sample_rate, power_level_threshold, L, H,
        fetch_names(sample_rate),
        thresholds=thresholds, device=device,
    )


def fused_capture_all(
    samples: np.ndarray,
    sample_rate: int,
    power_level_threshold: float = 0.01,
    L: int = DEFAULT_L,
    H: int = DEFAULT_H,
    thresholds=None,
    device="cuda",
):
    """Full device frontend for one capture: (Conditioned, channels).

    Conditioning comes from the same chained kernel pass that produces the
    box channels and the detect mask (_run_batch_chained: carried state,
    bit-identical to a monolithic pass; overlap-save blocks are NOT sound
    for conditioning), and only the carrier-edge peak tracker runs on the
    host.  L/H are accepted for API compatibility; the chained layout has
    no halo."""
    return fused_batch_all(
        [samples], sample_rate, power_level_threshold,
        thresholds=thresholds, device=device,
    )[0]


def fused_batch_channels(
    captures: list[np.ndarray],
    sample_rate: int,
    power_level_threshold: float = 0.01,
    L: int = DEFAULT_L,
    H: int = DEFAULT_H,
    thresholds=None,
    device="cuda",
) -> list[dict[str, np.ndarray]]:
    """Box channels + detect triggers for MANY captures; one dict per
    capture.  Box channels ride the one-launch overlap-save block layout
    (raw-value windows tolerate block restarts -- only the roundoff family
    changes); the detect triggers come from the chained exact-state engine
    in SPARSE form so their power gate reads the true streaming envelope.
    The SD margin covers the chained-f32 vs block-f32 box roundoff the
    same way it covers f32-vs-host-f64.

    The two device passes are independent until the merge: the chained
    trigger pass runs on a background thread, on a CUDA stream of its own
    whose work it ends before it returns host arrays, while the block pass
    runs on the caller's thread."""
    from concurrent.futures import ThreadPoolExecutor

    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def triggers():
        with torch.cuda.stream(side):
            out = chained_batch_masks(
                captures, sample_rate, power_level_threshold,
                thresholds=thresholds, device=dev,
            )
            if side is not None:
                side.synchronize()
        return out

    with ThreadPoolExecutor(1) as bg:
        fut = bg.submit(triggers)
        boxes = _run_batch_blocks(
            captures, sample_rate, power_level_threshold, L, H,
            tuple(box_keys(sample_rate)), thresholds=thresholds, device=dev,
        )
        sparse = fut.result()
    for b, s in zip(boxes, sparse):
        b.update(s)
    return boxes


def fused_batch_all(
    captures: list[np.ndarray],
    sample_rate: int,
    power_level_threshold: float = 0.01,
    L: int = DEFAULT_L,
    H: int = DEFAULT_H,
    thresholds=None,
    device="cuda",
    timings: StepTimes | None = None,
) -> list[tuple]:
    """Full device frontend for MANY captures; returns one
    (Conditioned, channels) pair per capture.  Runs the EXACT
    carried-state chained path (_run_batch_chained) -- kernel conditioning
    demands it -- with captures stacked as kernel streams, one launch of
    each kernel and one fetch per chunk.  Only the carrier-edge peak
    tracker (not emitted by the kernels) runs per capture on the host;
    `timings` (a StepTimes) gets its seconds as ``edge_tracker`` beside
    the chained runner's steps."""
    arr_sets = _run_batch_chained(
        captures, sample_rate, power_level_threshold,
        fetch_names(sample_rate) + _COND_FETCH, thresholds=thresholds,
        device=device, timings=timings,
    )
    params = SignalParams(
        sample_rate, power_level_threshold=power_level_threshold
    )
    names = fetch_names(sample_rate)
    outs = [(_conditioned(samples, arrs, params),
             {k: arrs[k] for k in names})
            for samples, arrs in zip(captures, arr_sets)]
    if timings is not None and captures:
        timings.lap("edge_tracker")
    return outs


def idx_key_map(sample_rate: int, power_level_threshold: float,
                thresholds=None):
    """(mask bit name, cache key, fx descriptor) for every detect-trigger
    index channel the kernel's detect_mask covers, keyed exactly as the
    tech FSMs' bind_channels request them (thresholds come from the single
    source of truth, core.thresholds, and must match the kernel's
    mask_params — both sides consume the same DecoderThresholds)."""
    from ..core.thresholds import DecoderThresholds
    from ..demod.nfcv import nfcv_bitrate

    th = thresholds or DecoderThresholds()
    # the techs key thresholds through f32 (ctx.power_level_threshold is a
    # SignalParams np.float32); the key must round-trip identically or the
    # preloaded entries silently miss and the host recomputes every detect
    # index channel
    pw = float(np.float32(power_level_threshold))
    out = []
    a_thr = float(np.float32(th.nfca.correlation))
    for r, br in enumerate(nfca_bitrates(sample_rate)):
        d, p1, p2 = br.symbol_delay_detect, br.period1, br.period2
        out.append((
            f"mask_a_{r}",
            ("sdidx", d, p1, p2, a_thr, pw, False),
            ("sd", ("bv", p2), d, p1, p2, a_thr, pw, False),
        ))
    b_deep = float(np.float32(th.nfcb.min_modulation_deep))
    for br, mname in zip(
        nfca_bitrates(sample_rate)[:2], ("mask_b_0", "mask_b_94")
    ):
        d = br.symbol_delay_detect
        out.append((
            mname, ("eidxb", d, b_deep, pw), ("edgeb", d, b_deep, pw)
        ))
    f_thr = float(np.float32(th.nfcf.correlation))
    for br, mname in zip(
        nfca_bitrates(sample_rate)[1:], ("mask_f_1", "mask_f_2")
    ):
        p1, p2 = br.period1, br.period2
        out.append((
            mname,
            ("sdidx", 0, p1, p2, f_thr, pw, False),
            ("sd", ("bv", p2), 0, p1, p2, f_thr, pw, False),
        ))
    v_thr = float(np.float32(th.nfcv.correlation))
    brv = nfcv_bitrate(sample_rate)
    dv, p1v, p2v = brv.symbol_delay_detect, brv.period1, brv.period2
    out.append((
        "mask_v",
        ("sdidx", dv, p1v, p2v, v_thr, pw, True),
        ("sd", ("bv", p2v), dv, p1v, p2v, v_thr, pw, True),
    ))
    return out


def preload_channels(
    channels,
    arrs: dict[str, np.ndarray],
    sample_rate: int,
    power_level_threshold: float,
    thresholds=None,
) -> None:
    """Stuff device-computed channels into a LazyChannels cache so the tech
    FSMs' ``bind_channels`` finds every box channel and detect-index set
    already current (anything not preloaded — carrier crossings, mod-depth
    gates — still computes lazily on the host from the exact conditioning).

    Must run before the techs are created (entries are keyed exactly as the
    techs' getters build them; pass the SAME DecoderThresholds the kernel
    ran with so keys and mask bits agree)."""
    from .fused_frontend import MASK_LAYOUT

    assert channels.base == 0, "device preload is for whole-capture decode"
    sparse = "detect_idx" in arrs
    n = arrs["n"] if sparse else len(arrs["detect_mask"])

    # mask-only sets skip the box preload: the box channels then build
    # natively on the host
    for name, (key, kind_code, width, lag) in box_keys(sample_rate).items():
        if name in arrs:
            channels._cache[key] = {
                "arr": arrs[name],
                "n": n,
                # extension never runs (n is final); a fresh f64 carry
                # would only matter if the stream grew
                "acc": np.zeros(1, np.float64),
                "idx": None,
                "scanned": 0,
                "extend": None,
                "kind": "box",
                "meta": (kind_code, width, lag),
            }

    # detect triggers -> index channels, gated at the 1024-sample warm-up.
    # Dense form: a packed mask byte per sample.  Sparse form (the chained
    # compacted engine): trigger positions + their packed bits.
    if sparse:
        pos = arrs["detect_idx"].astype(np.int64)
        pbits = arrs["detect_bits"].astype(np.int32)
        keep = pos >= _WARMUP
        pos, pbits = pos[keep], pbits[keep]
    else:
        bits = np.asarray(arrs["detect_mask"]).astype(np.int32)
        bits[:_WARMUP] = 0
    masks = {name: w for name, w in MASK_LAYOUT}

    for mname, key, fx in idx_key_map(
        sample_rate, power_level_threshold, thresholds=thresholds
    ):
        if sparse:
            idx = np.ascontiguousarray(pos[(pbits & masks[mname]) != 0])
        else:
            idx = np.flatnonzero(bits & masks[mname]).astype(np.int64)
        channels._cache[key] = {
            "arr": None,
            "n": 0,
            "acc": None,
            "idx": idx,
            "idx_n": len(idx),
            "scanned": n,
            "extend": None,
            "kind": "idx",
            "fx": fx,
        }

    channels._plan = None
