"""Fused frontend on CUDA: conditioning, every correlator channel and the
packed all-tech detect mask, for many streams at once.

Counterpart of ``nfclab/dsp/pallas/fused_frontend.py``.  The function is
the same: per sample, the conditioning chain (envelope, IIR DC filter,
deviation and average EMAs), the running box sums (raw-value boxes bv*,
squared-filtered boxes q*, BPSK product boxes p*), ``mod_depth`` and the
packed one-byte ``detect_mask`` (NFC-A bits 0-2, B bits 3-4, F bits 5-6,
V bit 7).  The state a stream carries from chunk to chunk is one
``[kernel_plan(rate).nstate]`` f32 row in ``KernelPlan.state_sections``
order, so a stream's state moves both ways between the JAX kernel and this
one (``state_from_jax`` / ``state_to_jax``).

Two hand-written CUDA kernels compute it (``nfclab_torch/csrc/
fused_frontend.cu``):

- ``fused_scan``: one lane per stream walks the chunk serially and
  produces the conditioning outputs and the running box sums, the work
  split over four warps of a block fed by a fifth that stages the samples
  in shared memory, where the rings live too.
- ``fused_mask``: parallel in time, a block per 32 (or 16) streams and a
  span of samples; producer warps stage each lag window of the box,
  filtered and envelope channels (the lags from ``kernel_plan``, so any
  rate from 0.5 to 40 MS/s) into shared rings once per span, and consumer
  warps compute ``mod_depth`` and ``detect_mask`` from them, every SD
  threshold test without a divide; then every warp advances its share of
  the history sections of the state.

Inside, the layout is time-major ``[T, B]`` for samples and channels and
section-major ``[nstate, B]`` for the state, so that neighbouring threads
touch neighbouring addresses; the public functions take and return
``[B, T]`` and ``[B, nstate]``.

Each kernel wrapper runs its plain PyTorch version (``_scan_plain``,
``_mask_plain``) when its input lies on the CPU, and launches the kernel
when it lies on a CUDA device.  The plain versions repeat the kernels'
float32 operation order exactly; they are the CPU path and the yardstick
the kernels are held to on the card.
"""

from __future__ import annotations

import functools
import typing

import numpy as np
import torch

# time block of the JAX kernel; the state layout depends on it through the
# `h + TILE` history sections, so it stays fixed
TILE = 128

# detect_mask bit weights
MASK_BITS_A = (1.0, 2.0, 4.0)
MASK_BITS_B = (8.0, 16.0)
MASK_BITS_F = (32.0, 64.0)
MASK_BIT_V = 128.0


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class KernelPlan(typing.NamedTuple):
    """Rate-parametric kernel geometry: box-window widths, ring sizes,
    detect-cascade parameters and history lengths, all derived from the
    same bitrate tables the host FSMs use (core.params.nfca_bitrates,
    demod.nfcv.nfcv_bitrate — the reference re-derives these on any
    sample-rate change, NfcDecoder.cpp:382-388).  The CUDA kernels take
    the geometry as launch arguments, so a new rate needs no rebuild."""

    bv_widths: tuple          # raw-value box widths (A p2 set + V p2)
    q_widths: tuple           # squared-filtered box widths
    pb: tuple                 # BPSK (lag, box) pairs, ascending by lag
    rv_ring: int              # value ring (pow2 > max bv width)
    rf_ring: int              # filtered ring (pow2 > max pb lag)
    rq_ring: int              # squared ring (pow2 > max q width)
    rp_rings: tuple           # product rings (pow2 > box) per pb entry
    a_rates: tuple            # (d, gap, p2, widx into bv_widths) per A rate
    f_rates: tuple            # (d, gap, p2, widx) per F rate
    b_delays: tuple           # filtered-signal lookback delays
    v_rate: tuple             # (d, gap, p2, widx)
    h_bv: tuple               # history length per bv width (max lookback)
    h_filt: int               # filtered history length

    @property
    def h_sizes(self) -> tuple:
        return (*self.h_bv, self.h_filt)

    @property
    def n_sums(self) -> int:
        return len(self.bv_widths) + len(self.q_widths) + len(self.pb)

    @property
    def state_sections(self) -> tuple:
        """(offset, length) pairs covering the carried state, in order:
        carry, rv, rf, rq, product rings, histories (per bv width then
        filt), sums."""
        secs = []
        off = 0
        for ln in (8, self.rv_ring, self.rf_ring, self.rq_ring,
                   *self.rp_rings,
                   *(h + TILE for h in self.h_sizes), self.n_sums):
            secs.append((off, ln))
            off += ln
        return tuple(secs)

    @property
    def nstate(self) -> int:
        off, ln = self.state_sections[-1]
        return off + ln

    @property
    def output_names(self) -> tuple:
        return (
            "envelope", "filtered", "deviation", "average", "mod_depth",
            *(f"bv{w}" for w in self.bv_widths),
            *(f"q{w}" for w in self.q_widths),
            *(f"p{lag}x{box}" for lag, box in self.pb),
            "detect_mask",
        )

    @property
    def mask_deps(self) -> tuple:
        """Channels the detect phase and the history append read."""
        return ("envelope", "filtered",
                *(f"bv{w}" for w in self.bv_widths))

    @property
    def fold_modulus(self) -> int:
        """Clock-fold modulus for unbounded streams: every ring size must
        divide it so folded clocks keep identical ring phases."""
        return max(
            512, self.rv_ring, self.rf_ring, self.rq_ring, *self.rp_rings
        )


@functools.lru_cache(maxsize=16)
def kernel_plan(sample_rate: int) -> KernelPlan:
    """Derive the kernel geometry for a capture rate (see KernelPlan)."""
    from ..core.params import nfca_bitrates
    from ..demod.nfcv import nfcv_bitrate

    bra = nfca_bitrates(sample_rate)
    brv = nfcv_bitrate(sample_rate)
    bv = tuple(sorted({br.period2 for br in bra} | {brv.period2}))
    q = tuple(sorted({bra[0].period2, brv.period1}))
    pb = tuple(sorted((br.period1, br.period4) for br in bra))
    widx = {w: i for i, w in enumerate(bv)}
    a_rates = tuple(
        (br.symbol_delay_detect, br.period1 - br.period2, br.period2,
         widx[br.period2])
        for br in bra
    )
    f_rates = tuple(
        (0, br.period1 - br.period2, br.period2, widx[br.period2])
        for br in bra[1:]
    )
    b_delays = tuple(br.symbol_delay_detect for br in bra[:2])
    v_rate = (
        brv.symbol_delay_detect, brv.period1 - brv.period2, brv.period2,
        widx[brv.period2],
    )
    # history length per bv width = max lookback over its detect consumers
    # (A: d+gap and d+1; F: gap and 1; V: d+gap)
    h_bv = []
    for w in bv:
        need = 1
        for d, gap, p2, wi in a_rates:
            if p2 == w:
                need = max(need, d + gap, d + 1)
        for d, gap, p2, wi in f_rates:
            if p2 == w:
                need = max(need, gap, 1)
        if v_rate[2] == w:
            need = max(need, v_rate[0] + v_rate[1])
        h_bv.append(need)
    return KernelPlan(
        bv_widths=bv,
        q_widths=q,
        pb=pb,
        rv_ring=_pow2_at_least(max(bv) + 1),
        rf_ring=_pow2_at_least(max(lag for lag, _ in pb) + 1),
        rq_ring=_pow2_at_least(max(q) + 1),
        rp_rings=tuple(_pow2_at_least(box + 1) for _, box in pb),
        a_rates=a_rates,
        f_rates=f_rates,
        b_delays=b_delays,
        v_rate=v_rate,
        h_bv=tuple(h_bv),
        h_filt=max(b_delays),
    )


# the reference's recommended 10 MS/s rate: module-level aliases of its
# geometry, as the JAX module exports them
_P10 = kernel_plan(10_000_000)
BV_WIDTHS = _P10.bv_widths          # (12, 24, 47, 94)
Q_WIDTHS = _P10.q_widths            # (47, 189)
PB = _P10.pb                        # ((24, 6), (47, 12), (94, 24))
RV_RING = _P10.rv_ring              # 128
RF_RING = _P10.rf_ring              # 128
RQ_RING = _P10.rq_ring              # 256
RP_RINGS = _P10.rp_rings            # (8, 16, 32)
A_RATES = _P10.a_rates
B_DELAYS = _P10.b_delays
F_RATES = _P10.f_rates
V_RATE = _P10.v_rate
H_SIZES = _P10.h_sizes              # (47, 117, 153, 473, 94)
MASK_DEPS = _P10.mask_deps
NSTATE = _P10.nstate
STATE_SECTIONS = _P10.state_sections
N_OUT = len(_P10.output_names)

OUTPUT_NAMES = list(_P10.output_names)

# per-output dtypes: the packed detect mask is an exact integer 0..255
OUTPUT_DTYPES = {
    n: (np.uint8 if n == "detect_mask" else np.float32) for n in OUTPUT_NAMES
}

# detect_mask bit layout: (name, weight)
MASK_LAYOUT = (
    [(f"mask_a_{r}", int(w)) for r, w in enumerate(MASK_BITS_A)]
    + [(f"mask_b_{d}", int(w)) for d, w in zip(B_DELAYS, MASK_BITS_B)]
    + [(f"mask_f_{r}", int(w)) for r, w in zip((1, 2), MASK_BITS_F)]
    + [("mask_v", int(MASK_BIT_V))]
)


def _normalize_select(select, plan: KernelPlan = None):
    """None (all outputs) or iterable of names -> tuple in the plan's
    output order, validated."""
    names = (plan or _P10).output_names
    if select is None:
        return tuple(names)
    sel = set(select)
    unknown = sel - set(names)
    if unknown:
        raise ValueError(f"unknown fused-frontend outputs: {sorted(unknown)}")
    return tuple(n for n in names if n in sel)


def unpack_detect_mask(mask):
    """detect_mask bitfield -> dict of per-tech/rate boolean tensors."""
    bits = torch.as_tensor(mask).to(torch.int32)
    return {name: (bits & w) != 0 for name, w in MASK_LAYOUT}


# --------------------------------------------------------------------------
# state interop with the JAX kernel's [g, nstate, sub, 128] layout


def state_from_jax(state) -> torch.Tensor:
    """JAX kernel state [g, nstate, sub, 128] -> [B, nstate] rows, with
    B = g * sub * 128 and stream b taken from
    [b // lanes, :, (b % lanes) // 128, b % 128] (lanes = sub * 128)."""
    arr = np.asarray(state, np.float32)
    if arr.ndim != 4 or arr.shape[3] != 128:
        raise ValueError(f"expected [g, nstate, sub, 128], got {arr.shape}")
    g, nstate, sub, _ = arr.shape
    rows = arr.transpose(0, 2, 3, 1).reshape(g * sub * 128, nstate)
    return torch.from_numpy(np.ascontiguousarray(rows))


def state_to_jax(state: torch.Tensor, sub: int) -> np.ndarray:
    """[B, nstate] rows -> JAX kernel state [g, nstate, sub, 128].  Rows
    are zero-padded (a fresh stream's state) up to a multiple of the JAX
    lane count sub * 128."""
    rows = state.detach().to("cpu", torch.float32).numpy()
    b, nstate = rows.shape
    lanes = sub * 128
    g = max(1, -(-b // lanes))
    full = np.zeros((g * lanes, nstate), np.float32)
    full[:b] = rows
    return np.ascontiguousarray(
        full.reshape(g, sub, 128, nstate).transpose(0, 3, 1, 2)
    )


# --------------------------------------------------------------------------
# kernel geometry in the section-major state


class _Layout(typing.NamedTuple):
    ring_off: int      # first ring row (rv, rf, rq, product rings follow)
    ring_rows: int
    rv_off: int
    rf_off: int
    rq_off: int
    rp_offs: tuple
    hist_offs: tuple   # per history channel: bv widths, then filt
    hist_off: int      # first history row
    hist_rows: int
    sums_off: int


@functools.lru_cache(maxsize=16)
def _layout(plan: KernelPlan) -> _Layout:
    secs = plan.state_sections
    n_rp = len(plan.rp_rings)
    n_h = len(plan.h_sizes)
    rings = secs[1 : 4 + n_rp]
    hists = secs[4 + n_rp : 4 + n_rp + n_h]
    return _Layout(
        ring_off=rings[0][0],
        ring_rows=sum(ln for _, ln in rings),
        rv_off=secs[1][0],
        rf_off=secs[2][0],
        rq_off=secs[3][0],
        rp_offs=tuple(off for off, _ in secs[4 : 4 + n_rp]),
        hist_offs=tuple(off for off, _ in hists),
        hist_off=hists[0][0],
        hist_rows=sum(ln for _, ln in hists),
        sums_off=secs[-1][0],
    )


def _dep_index(plan: KernelPlan) -> dict:
    """Row of each mask-dependency channel in the scan's `deps` buffer:
    bv widths, then filtered, then envelope."""
    nbv = len(plan.bv_widths)
    out = {f"bv{w}": i for i, w in enumerate(plan.bv_widths)}
    out["filtered"] = nbv
    out["envelope"] = nbv + 1
    return out


def _extra_names(plan: KernelPlan) -> tuple:
    """Serial outputs written only when selected."""
    return ("deviation", "average",
            *(f"q{w}" for w in plan.q_widths),
            *(f"p{lag}x{box}" for lag, box in plan.pb))


def _f32(x) -> float:
    return float(np.float32(x))


class _Kernel:
    """A CUDA kernel's launch count: plus one at every launch of the kernel
    (the plain versions never count).  SCAN counts every launch of the
    scan, on either kernel; SCAN_NARROW those on ff_scan_kernel_narrow
    (kernels.fused.scan_narrow chooses)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


SCAN = _Kernel("fused_scan")
SCAN_NARROW = _Kernel("fused_scan_narrow")
MASK = _Kernel("fused_mask")
KERNELS = (SCAN, MASK)


def _require_device(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return kind


# --------------------------------------------------------------------------
# scan: conditioning + running box sums, serial in time


def fused_scan(value_tm: torch.Tensor, state_in: torch.Tensor, base: int,
               pt, plan: KernelPlan, keep=()):
    """Serial phase over one chunk.

    value_tm: [T, B] f32; state_in: [nstate, B] f32 (section-major).
    Returns (deps, extra, state_out): deps [n_bv + 2, T, B] holds the bv
    boxes, filtered and envelope (the mask phase's inputs, always
    written); extra maps each name of `keep` (deviation, average, q*, p*)
    to its [T, B] channel; state_out [nstate, B] holds the new carry,
    rings and sums, with the history rows copied unchanged (fused_mask
    advances them)."""
    _check_scan_args(value_tm, state_in, base, plan)
    if _require_device(value_tm) == "cpu":
        return _scan_plain(value_tm, state_in, base, pt, plan, keep)
    return _scan_cuda(value_tm, state_in, base, pt, plan, keep)


def _check_scan_args(value_tm, state_in, base, plan):
    if value_tm.dtype != torch.float32 or state_in.dtype != torch.float32:
        raise TypeError("fused_scan takes float32 samples and state")
    if value_tm.dim() != 2 or state_in.dim() != 2:
        raise ValueError("fused_scan takes [T, B] samples, [nstate, B] state")
    t, b = value_tm.shape
    if state_in.shape != (plan.nstate, b):
        raise ValueError(
            f"state shape {tuple(state_in.shape)} != ({plan.nstate}, {b})"
        )
    if value_tm.device != state_in.device:
        raise ValueError("samples and state lie on different devices")
    if base < 0 or base + t >= 2 ** 31:
        raise ValueError("the clock base + T must lie in [0, 2**31)")


def _scan_plain(value_tm, state_in, base, pt, plan, keep=()):
    """Plain PyTorch version of the scan kernel: a per-sample loop over
    [B] tensors in the kernel's float32 operation order."""
    T, B = value_tm.shape
    dev = value_tm.device
    f32 = torch.float32
    ew0, ew1, mw0, mw1, aw0, aw1, iir_a = (_f32(p) for p in pt[:7])
    etu = int(pt[7])
    silence = _f32(etu * 10.0)
    lay = _layout(plan)
    nbv, nq, npb = len(plan.bv_widths), len(plan.q_widths), len(plan.pb)
    RV, RF, RQ = plan.rv_ring, plan.rf_ring, plan.rq_ring

    st = state_in.clone()
    env, w1, mdev, avg, pcount = (st[k].clone() for k in range(5))
    rv = st[lay.rv_off : lay.rv_off + RV]
    rf = st[lay.rf_off : lay.rf_off + RF]
    rq = st[lay.rq_off : lay.rq_off + RQ]
    rp_lo = lay.rp_offs[0]
    rp = st[rp_lo : rp_lo + sum(plan.rp_rings)]
    s0 = lay.sums_off
    s_bv = st[s0 : s0 + nbv].clone()
    s_q = st[s0 + nbv : s0 + nbv + nq].clone()
    s_p = st[s0 + nbv + nq : s0 + plan.n_sums].clone()

    # ring slot tables per clock phase (ring sizes are powers of two)
    def table(period, fn):
        return [torch.tensor(fn(ph), dtype=torch.long, device=dev)
                for ph in range(period)]

    old_bv = table(RV, lambda ph: [(ph - w + RV) & (RV - 1)
                                   for w in plan.bv_widths])
    old_q = table(RQ, lambda ph: [(ph - w + RQ) & (RQ - 1)
                                  for w in plan.q_widths])
    lag_f = table(RF, lambda ph: [(ph - lag + RF) & (RF - 1)
                                  for lag, _ in plan.pb])
    rp_base = [off - rp_lo for off in lay.rp_offs]
    RPM = max(plan.rp_rings)
    old_p = table(RPM, lambda ph: [
        o + ((ph - box + r) & (r - 1))
        for o, (_, box), r in zip(rp_base, plan.pb, plan.rp_rings)])
    slot_p = table(RPM, lambda ph: [
        o + (ph & (r - 1)) for o, r in zip(rp_base, plan.rp_rings)])

    deps = torch.empty(nbv + 2, T, B, dtype=f32, device=dev)
    cond = torch.empty(T, 2, B, dtype=f32, device=dev)   # mdev, avg
    sums_q = torch.empty(T, nq, B, dtype=f32, device=dev)
    sums_p = torch.empty(T, npb, B, dtype=f32, device=dev)
    # v * w1 products need no recurrence: one vectorized pass each
    v_ew1 = value_tm * ew1
    v_aw1 = value_tm * aw1

    for j in range(T):
        t = base + j
        v = value_tm[j]
        diff = (v - env).abs() / env
        pcount = pcount + 1.0
        update = (diff < 0.05) | (pcount > silence)
        upd = env * ew0 + v_ew1[j]
        # seed = ~update & (t < etu): the envelope takes v while t < etu
        env = torch.where(update, upd, v if t < etu else env)
        pcount = torch.where(update, 0.0, pcount)
        w0 = v + w1 * iir_a
        filt = w0 - w1
        w1 = w0
        mdev = mdev * mw0 + filt.abs() * mw1
        avg = avg * aw0 + v_aw1[j]

        # raw-value boxes: (sum + v) - old
        s_bv = (s_bv + v) - rv.index_select(0, old_bv[t & (RV - 1)])
        rv[t & (RV - 1)] = v
        # squared-filtered boxes over (filt*filt)*10
        q = filt * filt * 10.0
        s_q = (s_q + q) - rq.index_select(0, old_q[t & (RQ - 1)])
        rq[t & (RQ - 1)] = q
        # BPSK product boxes over (filt*filt[t-lag])*10
        prod = filt * rf.index_select(0, lag_f[t & (RF - 1)]) * 10.0
        ph = t & (RPM - 1)
        s_p = (s_p + prod) - rp.index_select(0, old_p[ph])
        rp.index_copy_(0, slot_p[ph], prod)
        rf[t & (RF - 1)] = filt

        deps[:nbv, j] = s_bv
        deps[nbv, j] = filt
        deps[nbv + 1, j] = env
        cond[j, 0] = mdev
        cond[j, 1] = avg
        sums_q[j] = s_q
        sums_p[j] = s_p

    for k, x in enumerate((env, w1, mdev, avg, pcount)):
        st[k] = x
    st[s0 : s0 + nbv] = s_bv
    st[s0 + nbv : s0 + nbv + nq] = s_q
    st[s0 + nbv + nq : s0 + plan.n_sums] = s_p

    sel = {"deviation": cond[:, 0], "average": cond[:, 1]}
    for i, w in enumerate(plan.q_widths):
        sel[f"q{w}"] = sums_q[:, i]
    for i, (lag, box) in enumerate(plan.pb):
        sel[f"p{lag}x{box}"] = sums_p[:, i]
    extra = {n: sel[n].contiguous() for n in keep}
    return deps, extra, st


def _scan_cuda(value_tm, state_in, base, pt, plan, keep=()):
    from ..kernels import fused as kf

    T, B = value_tm.shape
    value_tm = value_tm.contiguous()
    state_in = state_in.contiguous()
    nbv = len(plan.bv_widths)
    deps = torch.empty(nbv + 2, T, B, dtype=torch.float32,
                       device=value_tm.device)
    extra = {n: torch.empty(T, B, dtype=torch.float32, device=value_tm.device)
             for n in _extra_names(plan) if n in keep}
    state_out = torch.empty_like(state_in)
    if kf.launch_scan(value_tm, state_in, state_out, deps, extra, base, pt,
                      plan, _layout(plan)):
        SCAN_NARROW.launches += 1
    SCAN.launches += 1
    return deps, extra, state_out


# --------------------------------------------------------------------------
# mask: mod_depth + detect_mask + history advance, parallel in time


def fused_mask(deps: torch.Tensor, value_tm: torch.Tensor,
               state_in: torch.Tensor, state_out: torch.Tensor, mp,
               plan: KernelPlan, want_mask: bool = True,
               want_mod_depth: bool = False) -> dict:
    """Parallel phase over one chunk.

    deps: the scan's [n_bv + 2, T, B] channels; value_tm [T, B];
    state_in: the chunk's input state (its history rows hold the lookback
    before the chunk).  Writes the advanced history rows into state_out
    IN PLACE (the scan's fresh output state, apart from state_in; no other
    row is touched) and returns {"detect_mask": [T, B] u8, "mod_depth":
    [T, B] f32} for the outputs asked for."""
    if _require_device(deps) == "cpu":
        return _mask_plain(deps, value_tm, state_in, state_out, mp, plan,
                           want_mask, want_mod_depth)
    return _mask_cuda(deps, value_tm, state_in, state_out, mp, plan,
                      want_mask, want_mod_depth)


def _mask_params(mp) -> tuple:
    return tuple(_f32(m) for m in mp)


def _mask_plain(deps, value_tm, state_in, state_out, mp, plan,
                want_mask=True, want_mod_depth=False):
    """Plain PyTorch version of the mask kernel, vectorized over time."""
    power_thr, a_thr, b_min_deep, f_thr, v_thr = _mask_params(mp)
    _, T, B = deps.shape
    dev = deps.device
    lay = _layout(plan)
    nbv = len(plan.bv_widths)
    env = deps[nbv + 1]

    # each history channel extended by its lookback: [h + TILE + T, B]
    ext = []
    for k, h in enumerate(plan.h_sizes):
        n = h + TILE
        off = lay.hist_offs[k]
        e = torch.cat([state_in[off : off + n], deps[k]])
        state_out[off : off + n] = e[-n:]
        ext.append(e)

    def lagged(k, c):
        n = plan.h_sizes[k] + TILE
        return ext[k][n - c : n - c + T]

    out = {}
    if want_mod_depth:
        clamped = torch.clamp(torch.minimum(value_tm, env), min=0.0)
        out["mod_depth"] = (env - clamped) / env
    if not want_mask:
        return out

    def div(x, p):
        # a tensor divisor keeps the division IEEE on CUDA (a CPU scalar
        # divisor becomes a reciprocal multiply there)
        return x / torch.tensor(float(p), dtype=torch.float32, device=dev)

    power_ok = env >= power_thr
    mval = torch.zeros(T, B, dtype=torch.int32, device=dev)
    min_corr_a = a_thr * env
    for r, (d, gap, p2, widx) in enumerate(plan.a_rates):
        b0, b1, bg = lagged(widx, d), lagged(widx, d + 1), lagged(widx, d + gap)
        sd = div((b0 - bg) - (bg - b1), p2)
        mval += torch.where(power_ok & (sd.abs() > min_corr_a),
                            int(MASK_BITS_A[r]), 0).to(torch.int32)
    min_corr_f = f_thr * env
    for r, (d, gap, p2, widx) in enumerate(plan.f_rates):
        b0, b1, bg = lagged(widx, 0), lagged(widx, 1), lagged(widx, gap)
        sd = div((b0 - bg) - (bg - b1), p2)
        mval += torch.where(power_ok & (sd.abs() > min_corr_f),
                            int(MASK_BITS_F[r]), 0).to(torch.int32)
    edge_b = -(b_min_deep * env)
    for r, d in enumerate(plan.b_delays):
        mval += torch.where(power_ok & (lagged(nbv, d) < edge_b),
                            int(MASK_BITS_B[r]), 0).to(torch.int32)
    dv, gapv, p2v, widxv = plan.v_rate
    sd_v = div(lagged(widxv, dv + gapv) - lagged(widxv, dv), p2v)
    mval += torch.where(power_ok & (sd_v > v_thr * env),
                        int(MASK_BIT_V), 0).to(torch.int32)
    out["detect_mask"] = mval.to(torch.uint8)
    return out


def _mask_cuda(deps, value_tm, state_in, state_out, mp, plan,
               want_mask=True, want_mod_depth=False):
    from ..kernels import fused as kf

    _, T, B = deps.shape
    dev = deps.device
    out = {}
    if want_mask:
        out["detect_mask"] = torch.empty(T, B, dtype=torch.uint8, device=dev)
    if want_mod_depth:
        out["mod_depth"] = torch.empty(T, B, dtype=torch.float32, device=dev)
    kf.launch_mask(deps.contiguous(), value_tm.contiguous(),
                   state_in.contiguous(), state_out,
                   out.get("detect_mask"), out.get("mod_depth"),
                   _mask_params(mp), plan, _layout(plan))
    MASK.launches += 1
    return out


# --------------------------------------------------------------------------
# one chunk, both phases


def run_chunk(value_tm: torch.Tensor, state_sm: torch.Tensor, base: int,
              pt, mp, plan: KernelPlan, sel: tuple):
    """Both kernels over one chunk in the internal layouts: value_tm
    [T, B], state_sm [nstate, B].  Returns ({name: [T, B]} for `sel`,
    new state [nstate, B])."""
    extra_names = set(_extra_names(plan))
    keep = tuple(n for n in sel if n in extra_names)
    deps, extra, state_out = fused_scan(value_tm, state_sm, base, pt, plan,
                                        keep)
    mk = fused_mask(deps, value_tm, state_sm, state_out, mp, plan,
                    "detect_mask" in sel, "mod_depth" in sel)
    dep_idx = _dep_index(plan)
    outs = {}
    for n in sel:
        if n in dep_idx:
            outs[n] = deps[dep_idx[n]]
        elif n in extra:
            outs[n] = extra[n]
        else:
            outs[n] = mk[n]
    return outs, state_out


def fused_frontend_plain(value, params, mask_params=(0.01, 0.75, 0.10,
                                                     0.50, 0.50),
                         state=None, base=0, return_state=False,
                         select=None, sample_rate=10_000_000):
    """fused_frontend through the plain versions on the input's device
    (the yardstick the CUDA kernels are held to)."""
    value, state, plan, sel = _prepare(value, state, base, select,
                                       sample_rate)
    x_tm = value.t().contiguous()
    st = state.t().contiguous()
    keep = tuple(n for n in sel if n in set(_extra_names(plan)))
    deps, extra, st_out = _scan_plain(x_tm, st, base, params, plan, keep)
    mk = _mask_plain(deps, x_tm, st, st_out, mask_params, plan,
                     "detect_mask" in sel, "mod_depth" in sel)
    dep_idx = _dep_index(plan)
    res = {}
    for n in sel:
        o = deps[dep_idx[n]] if n in dep_idx else extra.get(n, mk.get(n))
        res[n] = o.t().contiguous()
    if return_state:
        return res, st_out.t().contiguous()
    return res


def _prepare(value, state, base, select, sample_rate):
    value = torch.as_tensor(value)
    if value.dtype != torch.float32:
        value = value.to(torch.float32)
    if value.dim() != 2:
        raise ValueError("value must be [B, T]")
    b, t = value.shape
    if t % TILE:
        raise ValueError(f"T={t} is not a multiple of {TILE}")
    if base < 0:
        raise ValueError("the clock base must be non-negative")
    plan = kernel_plan(sample_rate)
    sel = _normalize_select(select, plan)
    if state is None:
        state = torch.zeros(b, plan.nstate, dtype=torch.float32,
                            device=value.device)
    else:
        state = torch.as_tensor(state)
        if state.shape != (b, plan.nstate):
            raise ValueError(
                f"carried state shape {tuple(state.shape)} does not match "
                f"({b}, kernel_plan({sample_rate}).nstate={plan.nstate}) — "
                "state from a different rate's plan?"
            )
        if state.device != value.device:
            raise ValueError("value and state lie on different devices")
    return value, state, plan, sel


def fused_frontend(value, params,
                   mask_params=(0.01, 0.75, 0.10, 0.50, 0.50),
                   state=None, base=0, return_state=False, select=None,
                   sample_rate=10_000_000):
    """value: [B, T] f32 tensor on the device to run on, T % 128 == 0.

    Returns a dict of [B, T] outputs (f32; detect_mask u8).  sample_rate
    selects the kernel geometry (kernel_plan).  mask_params:
    (power_level_threshold, nfca_corr_thr, nfcb_min_deep, nfcf_corr_thr,
    nfcv_corr_thr), taken as float32.  params: the 8-tuple of
    dsp.frontend._params_tuple.

    select: None for all outputs, or an iterable of names; values are
    bit-identical to the unselected run's.

    Chunked streaming: pass `state` ([B, nstate] from the previous chunk,
    or None at stream start), `base` (this chunk's absolute start clock)
    and `return_state=True`; outputs are bit-identical to one monolithic
    pass over the concatenated chunks."""
    value, state, plan, sel = _prepare(value, state, base, select,
                                       sample_rate)
    outs, st = run_chunk(value.t().contiguous(), state.t().contiguous(),
                         base, params, mask_params, plan, sel)
    res = {n: o.t().contiguous() for n, o in outs.items()}
    if return_state:
        return res, st.t().contiguous()
    return res


def fused_frontend_stream(value, params, chunk=1 << 16,
                          mask_params=(0.01, 0.75, 0.10, 0.50, 0.50),
                          select=None, sample_rate=10_000_000):
    """Generator: feed [B, T] through the kernels in `chunk`-sample slices
    with carried state, yielding (offset, outputs) per chunk; the
    concatenated outputs are bit-identical to one monolithic pass."""
    value = torch.as_tensor(value)
    b, t = value.shape
    if chunk % TILE:
        raise ValueError(f"chunk must be a multiple of {TILE}")
    state = None
    for off in range(0, t, chunk):
        end = min(off + chunk, t)
        if (end - off) % TILE:
            raise ValueError("stream length must be a multiple of TILE")
        res, state = fused_frontend(
            value[:, off:end], params, mask_params=mask_params, state=state,
            base=off, return_state=True, select=select,
            sample_rate=sample_rate,
        )
        yield off, res
