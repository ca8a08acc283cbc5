"""The earlier design of the fused frontend on CUDA: conditioning, every
correlator channel and the all-tech detect mask in one pass per chunk.

Counterpart of ``experiments/fused_v2.py``.  The function is the
production kernel's (``dsp/fused_frontend.py``) with another design and
another state:

- rings of non-power-of-two sizes (value 96, filtered 96, squared 192,
  products 8/16/32), slotted by the absolute clock ``t % RING``;
- the detect mask from rings of box values -- ``rb`` (bv47/bv24/bv12 in
  rings of 64/128/160) and ``rbv`` (bv94 in a ring of 474) -- with carry
  rows 5-9 holding the previous step's bv47/bv24/bv12 and the b0 of the
  d = 94 and d = 141 NFC-A rates;
- ``detect_mask`` as a float32 sum of the bit weights;
- a state of ``NSTATE = 1285`` f32 rows per stream, the JAX kernel's
  ``[g, NSTATE, sub, 128]`` as ``[B, NSTATE]`` rows (``state_from_jax`` /
  ``state_to_jax``), so a stream moves both ways between the two.

The window constants are the 10 MS/s set, as in the original.  Its TPU
tiling (``native_layout``, ``sub``, ``LANES``, ``UNROLL``) is dropped: any
B >= 1; T stays a multiple of TILE, as the original's contract.

Two hand-written CUDA kernels compute it (``nfclab_torch/csrc/
fused_v2.cu``): ``fused_v2_scan``, serial over the chunk with 32 streams a
block and the chains split over warps (conditioning, mod_depth, the nine
box sums; samples staged and rings kept in shared memory), and
``fused_v2_mask``, parallel in time with 32 streams and a span of rows a
block, each lookback channel staged into a shared ring, for detect_mask
and the state rows the mask owns; its threshold tests take no divide
(``sd_above`` mirrors them here).  Each wrapper runs its plain
PyTorch version (``_scan_plain``, ``_mask_plain``, the kernels' float32
operation order) when its input lies on the CPU.  Inside, samples and
outputs are time-major ``[T, B]`` and the state section-major
``[NSTATE, B]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.cuda_channels import resolve_device
from ..dsp.fused_frontend import (  # noqa: F401  (state_* re-exported)
    _f32,
    _Kernel,
    _require_device,
    state_from_jax,
    state_to_jax,
)
from .common import mod_depth

TILE = 32

# 10 MS/s window set
BV_WIDTHS = (12, 24, 47, 94)
Q_WIDTHS = (47, 189)
PB = ((24, 6), (47, 12), (94, 24))  # (lag, box)

RV_RING = 96   # max lookback 94 (bv94)
RF_RING = 96   # max lookback 94 (p94 lag / B delay)
RQ_RING = 192  # max lookback 189 (q189)
RP_RINGS = (8, 16, 32)

# NFC-A detect per rate: (delay cascade d, gap = p1-p2, p2, index of p2 in
# BV_WIDTHS); per-rate box-value ring sized to that rate's max lookback
A_RATES = ((0, 47, 47, 2), (94, 23, 24, 1), (141, 12, 12, 0))
RB_RINGS = (64, 128, 160)  # >= max lookback+1 per rate (48 / 118 / 154)
RB_OFFS = (0, 64, 192)
RB_TOTAL = 352

# NFC-B falling-edge trigger delays (filtered-signal lookbacks, < RF_RING)
B_DELAYS = (0, 94)
# NFC-F detect per rate: (d, gap, p2, A_RATES ring index holding that box)
F_RATES = ((0, 23, 24, 1), (0, 12, 12, 2))
# NFC-V signed SD: (d, gap, p2, BV_WIDTHS index); lookback d+gap+1 = 474
V_RATE = (378, 95, 94, 3)
RBV_RING = 474

# detect_mask bit weights (f32-exact integers)
MASK_BITS_A = (1.0, 2.0, 4.0)
MASK_BITS_B = (8.0, 16.0)
MASK_BITS_F = (32.0, 64.0)
MASK_BIT_V = 128.0

N_OUT = 5 + len(BV_WIDTHS) + len(Q_WIDTHS) + len(PB) + 1

# state layout, per stream: carry (env, w1, mdev, avg, silence counter,
# previous bv47/bv24/bv12, b0 of the d=94/141 rates), every ring, the sums
S_CARRY = 0
S_RV = S_CARRY + 10
S_RF = S_RV + RV_RING
S_RQ = S_RF + RF_RING
S_RP0 = S_RQ + RQ_RING
S_RP1 = S_RP0 + RP_RINGS[0]
S_RP2 = S_RP1 + RP_RINGS[1]
S_RB = S_RP2 + RP_RINGS[2]
S_RBV = S_RB + RB_TOTAL
S_SUMS = S_RBV + RBV_RING
N_SUMS = len(BV_WIDTHS) + len(Q_WIDTHS) + len(PB)
NSTATE = S_SUMS + N_SUMS

OUTPUT_NAMES = (
    ["envelope", "filtered", "deviation", "average", "mod_depth"]
    + [f"bv{w}" for w in BV_WIDTHS]
    + [f"q{w}" for w in Q_WIDTHS]
    + [f"p{lag}x{box}" for lag, box in PB]
    + ["detect_mask"]
)

# detect_mask bit layout: (name, weight)
MASK_LAYOUT = (
    [(f"mask_a_{r}", int(w)) for r, w in enumerate(MASK_BITS_A)]
    + [(f"mask_b_{d}", int(w)) for d, w in zip(B_DELAYS, MASK_BITS_B)]
    + [(f"mask_f_{r}", int(w)) for r, w in zip((1, 2), MASK_BITS_F)]
    + [("mask_v", int(MASK_BIT_V))]
)

_ROW = {n: i for i, n in enumerate(OUTPUT_NAMES)}

# carry rows of b1 = B(t-d-1) at a chunk's first sample: the previous
# step's box value for the d = 0 rates, the previous b0 for the others
PREV_BV_ROW = {47: 5, 24: 6, 12: 7}
PREV_B0_ROW = (None, 8, 9)

# the mask's lookback channels and the state ring holding each before the
# chunk: (state offset, ring size)
_RINGS = {
    f"bv{BV_WIDTHS[widx]}": (S_RB + off, ring)
    for (_, _, _, widx), off, ring in zip(A_RATES, RB_OFFS, RB_RINGS)
}
_RINGS[f"bv{BV_WIDTHS[V_RATE[3]]}"] = (S_RBV, RBV_RING)
_RINGS["filtered"] = (S_RF, RF_RING)

SCAN = _Kernel("fused_v2_scan")
MASK = _Kernel("fused_v2_mask")
KERNELS = (SCAN, MASK)


def mask_state_rows() -> torch.Tensor:
    """[NSTATE] bool: the state rows the mask phase writes (carry rows 5-9
    and the rb / rbv rings); the scan writes every other row."""
    rows = torch.zeros(NSTATE, dtype=torch.bool)
    rows[5:10] = True
    rows[S_RB:S_SUMS] = True
    return rows


FLT_MAX = float(np.finfo(np.float32).max)


def sd_above(n, y, p2) -> np.ndarray:
    """Mirror of the mask kernels' divide-free threshold test
    (``csrc/condition_step.cuh::sd_above``) on float32 arrays: for
    0 < y < FLT_MAX, n > p2 * m or (n = p2 * m and y's last bit 1) in
    float64, m the midpoint of y and its float32 successor, which is exact;
    elsewhere the float32 quotient's own test.  Equal to
    ``n / float32(p2) > y`` everywhere."""
    n = np.asarray(n, np.float32)
    y = np.asarray(y, np.float32)
    n, y = np.broadcast_arrays(n, y)
    bits = y.view(np.uint32)
    up = (bits + np.uint32(1)).view(np.float32)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        mid = (y.astype(np.float64) + up.astype(np.float64)) * 0.5
        lim = float(p2) * mid
        x = n.astype(np.float64)
        above = (x > lim) | ((x == lim) & ((bits & 1) == 1))
        special = ~((y > 0) & (y < np.float32(FLT_MAX)))
        above[special] = n[special] / np.float32(p2) > y[special]
    return above


def unpack_detect_mask(mask):
    """detect_mask f32 bitfield -> dict of per-tech/rate boolean tensors."""
    bits = torch.as_tensor(mask).to(torch.int32)
    return {name: (bits & w) != 0 for name, w in MASK_LAYOUT}


# --------------------------------------------------------------------------
# scan: conditioning, mod_depth and the box sums, serial in time


def v2_scan(value_tm: torch.Tensor, state_in: torch.Tensor, base: int, pt):
    """Serial phase over one chunk: value_tm [T, B] f32, state_in
    [NSTATE, B] f32.  Returns (out [N_OUT, T, B] in OUTPUT_NAMES order,
    state_out [NSTATE, B]); out's detect_mask row and the state rows of
    mask_state_rows() are v2_mask's to write."""
    _check_scan_args(value_tm, state_in, base)
    if _require_device(value_tm) == "cpu":
        return _scan_plain(value_tm, state_in, base, pt)
    from ..kernels import fused_v2 as kv

    T, B = value_tm.shape
    out = torch.empty(N_OUT, T, B, dtype=torch.float32,
                      device=value_tm.device)
    state_out = torch.empty_like(state_in)
    kv.launch_scan(value_tm.contiguous(), state_in.contiguous(), state_out,
                   out, base, pt, NSTATE)
    SCAN.launches += 1
    return out, state_out


def _check_scan_args(value_tm, state_in, base):
    if value_tm.dtype != torch.float32 or state_in.dtype != torch.float32:
        raise TypeError("fused_v2 takes float32 samples and state")
    if value_tm.dim() != 2 or value_tm.shape[0] < 1:
        raise ValueError("fused_v2 takes [T, B] samples, T >= 1")
    if state_in.shape != (NSTATE, value_tm.shape[1]):
        raise ValueError(f"state shape {tuple(state_in.shape)} != "
                         f"({NSTATE}, {value_tm.shape[1]})")
    if value_tm.device != state_in.device:
        raise ValueError("samples and state lie on different devices")
    # the largest int32 ring index the Pallas kernel forms is below
    # t + 2 * RBV_RING; past 2**31 it would wrap
    if base < 0 or base + value_tm.shape[0] + 2 * RBV_RING > 2 ** 31:
        raise ValueError("the clock base must be >= 0 and base + T + "
                         f"{2 * RBV_RING} must stay below 2**31")


def _ring_tables(ring, offsets, dev):
    """Per clock phase t % ring: the slots (t - o) % ring, as index
    tensors."""
    return [torch.tensor([(ph - o) % ring for o in offsets], dtype=torch.long,
                         device=dev) for ph in range(ring)]


def _scan_plain(value_tm, state_in, base, pt):
    """Plain PyTorch version of the scan kernel: a per-sample loop over
    [B] tensors in the kernel's float32 operation order."""
    T, B = value_tm.shape
    dev = value_tm.device
    ew0, ew1, mw0, mw1, aw0, aw1, iir_a = (_f32(p) for p in pt[:7])
    etu = int(pt[7])
    silence = _f32(etu * 10.0)

    st = state_in.clone()
    env, w1, mdev, avg, pcount = (st[k].clone() for k in range(5))
    rv = st[S_RV:S_RF]
    rf = st[S_RF:S_RQ]
    rq = st[S_RQ:S_RP0]
    rp = st[S_RP0:S_RB]      # the three product rings, back to back
    nbv, nq = len(BV_WIDTHS), len(Q_WIDTHS)
    s_bv = st[S_SUMS : S_SUMS + nbv].clone()
    s_q = st[S_SUMS + nbv : S_SUMS + nbv + nq].clone()
    s_p = st[S_SUMS + nbv + nq : NSTATE].clone()

    old_bv = _ring_tables(RV_RING, BV_WIDTHS, dev)
    old_q = _ring_tables(RQ_RING, Q_WIDTHS, dev)
    lag_f = _ring_tables(RF_RING, [lag for lag, _ in PB], dev)
    # the product rings' sizes divide the largest, so its phase indexes all
    rpm = max(RP_RINGS)
    rp_base = [off - S_RP0 for off in (S_RP0, S_RP1, S_RP2)]
    old_p = [torch.tensor([o + (ph - box) % r for o, (_, box), r
                           in zip(rp_base, PB, RP_RINGS)], device=dev)
             for ph in range(rpm)]
    slot_p = [torch.tensor([o + ph % r for o, r in zip(rp_base, RP_RINGS)],
                           device=dev) for ph in range(rpm)]

    out = torch.empty(N_OUT, T, B, dtype=torch.float32, device=dev)
    # v * w1 products need no recurrence: one vectorized pass each
    v_ew1 = value_tm * ew1
    v_aw1 = value_tm * aw1
    for j in range(T):
        t = base + j
        v = value_tm[j]
        diff = (v - env).abs() / env
        pcount = pcount + 1.0
        update = (diff < 0.05) | (pcount > silence)
        # seed = ~update & (t < etu): the envelope takes v while t < etu
        env = torch.where(update, env * ew0 + v_ew1[j],
                          v if t < etu else env)
        pcount = torch.where(update, 0.0, pcount)
        w0 = v + w1 * iir_a
        filt = w0 - w1
        w1 = w0
        mdev = mdev * mw0 + filt.abs() * mw1
        avg = avg * aw0 + v_aw1[j]

        # raw-value boxes: (sum + v) - old
        s_bv = (s_bv + v) - rv.index_select(0, old_bv[t % RV_RING])
        rv[t % RV_RING] = v
        # squared-filtered boxes over (filt*filt)*10
        q = filt * filt * 10.0
        s_q = (s_q + q) - rq.index_select(0, old_q[t % RQ_RING])
        rq[t % RQ_RING] = q
        # BPSK product boxes over (filt*filt[t-lag])*10
        prod = filt * rf.index_select(0, lag_f[t % RF_RING]) * 10.0
        s_p = (s_p + prod) - rp.index_select(0, old_p[t % rpm])
        rp.index_copy_(0, slot_p[t % rpm], prod)
        rf[t % RF_RING] = filt

        out[0, j] = env
        out[1, j] = filt
        out[2, j] = mdev
        out[3, j] = avg
        out[5 : 5 + nbv, j] = s_bv
        out[5 + nbv : 5 + nbv + nq, j] = s_q
        out[5 + nbv + nq : N_OUT - 1, j] = s_p

    out[4] = mod_depth(value_tm, out[0])
    for k, x in enumerate((env, w1, mdev, avg, pcount)):
        st[k] = x
    st[S_SUMS:NSTATE] = torch.cat([s_bv, s_q, s_p])
    return out, st


# --------------------------------------------------------------------------
# mask: detect_mask and the mask's state rows, parallel in time


def v2_mask(out: torch.Tensor, state_in: torch.Tensor,
            state_out: torch.Tensor, base: int, mp) -> None:
    """Parallel phase over one chunk, IN PLACE: writes out's detect_mask
    row from its box and filtered rows and state_in's rings (the lookback
    before the chunk), and the rows of mask_state_rows() of state_out."""
    if _require_device(out) == "cpu":
        return _mask_plain(out, state_in, state_out, base, mp)
    from ..kernels import fused_v2 as kv

    kv.launch_mask(out, state_in.contiguous(), state_out, base,
                   _mask_params(mp), NSTATE)
    MASK.launches += 1


def _mask_params(mp) -> tuple:
    return tuple(_f32(m) for m in mp)


def _mask_plain(out, state_in, state_out, base, mp):
    """Plain PyTorch version of the mask kernel, vectorized over time."""
    power_thr, a_thr, b_min_deep, f_thr, v_thr = _mask_params(mp)
    _, T, B = out.shape
    dev = out.device
    env = out[_ROW["envelope"]]
    t_last = base + T - 1

    # each lookback channel extended to the front by its state ring in
    # clock order: ext[ring + i] is the value at clock base + i
    ext = {}
    for name, (off, ring) in _RINGS.items():
        idx = torch.tensor([(base - ring + i) % ring for i in range(ring)],
                           device=dev)
        ext[name] = torch.cat([state_in[off : off + ring].index_select(0, idx),
                               out[_ROW[name]]])

    def lagged(name, c):
        ring = _RINGS[name][1]
        return ext[name][ring - c : ring - c + T]

    def div(x, p):
        # a tensor divisor keeps the division IEEE on CUDA (a CPU scalar
        # divisor becomes a reciprocal multiply there)
        return x / torch.tensor(float(p), dtype=torch.float32, device=dev)

    def sd(name, d, gap, p2, carry_row):
        b0, bg = lagged(name, d), lagged(name, d + gap)
        # b1 = B(t-d-1) is carried from the previous step
        b1 = torch.cat([state_in[carry_row][None], lagged(name, d + 1)[1:]])
        return div((b0 - bg) - (bg - b1), p2)

    power_ok = env >= power_thr
    mval = torch.zeros(T, B, dtype=torch.int32, device=dev)
    min_corr_a = a_thr * env
    for r, (d, gap, p2, widx) in enumerate(A_RATES):
        w = BV_WIDTHS[widx]
        row = PREV_BV_ROW[w] if d == 0 else PREV_B0_ROW[r]
        hit = power_ok & (sd(f"bv{w}", d, gap, p2, row).abs() > min_corr_a)
        mval += hit * int(MASK_BITS_A[r])
    min_corr_f = f_thr * env
    for r, (d, gap, p2, ridx) in enumerate(F_RATES):
        w = BV_WIDTHS[A_RATES[ridx][3]]
        hit = power_ok & (sd(f"bv{w}", d, gap, p2, PREV_BV_ROW[w]).abs()
                          > min_corr_f)
        mval += hit * int(MASK_BITS_F[r])
    edge_b = -(b_min_deep * env)
    for r, d in enumerate(B_DELAYS):
        mval += (power_ok & (lagged("filtered", d) < edge_b)) * int(
            MASK_BITS_B[r])
    dv, gapv, p2v, widxv = V_RATE
    name_v = f"bv{BV_WIDTHS[widxv]}"
    sd_v = div(lagged(name_v, dv + gapv) - lagged(name_v, dv), p2v)
    mval += (power_ok & (sd_v > v_thr * env)) * int(MASK_BIT_V)
    out[_ROW["detect_mask"]] = mval.to(torch.float32)

    # ring slot s ends holding the value of the chunk's last clock that is
    # s modulo the ring, or keeps its input
    for name, (off, ring) in _RINGS.items():
        if name == "filtered":
            continue   # the scan owns rf
        idx = torch.tensor([ring + T - 1 - (t_last - s) % ring
                            for s in range(ring)], device=dev)
        state_out[off : off + ring] = ext[name].index_select(0, idx)
    # carry rows 5-7: the last step's box values; 8-9: its b0 of the
    # d = 94 and d = 141 rates
    for w, row in PREV_BV_ROW.items():
        state_out[row] = out[_ROW[f"bv{w}"], T - 1]
    for r, (d, _, _, widx) in enumerate(A_RATES):
        if d:
            state_out[PREV_B0_ROW[r]] = lagged(f"bv{BV_WIDTHS[widx]}", d)[-1]


# --------------------------------------------------------------------------
# one chunk, both phases, and the public functions


def run_chunk(value_tm: torch.Tensor, state_sm: torch.Tensor, base: int,
              pt, mp):
    """Both kernels over one chunk in the internal layouts: value_tm
    [T, B], state_sm [NSTATE, B].  Returns (out [N_OUT, T, B], new state
    [NSTATE, B])."""
    out, state_out = v2_scan(value_tm, state_sm, base, pt)
    v2_mask(out, state_sm, state_out, base, mp)
    return out, state_out


def _prepare(value, state, base, dev):
    value = torch.as_tensor(value).to(dev, torch.float32)
    if value.dim() != 2:
        raise ValueError("value must be [B, T]")
    b, t = value.shape
    if t < TILE or t % TILE:
        raise ValueError(f"T={t} is not a positive multiple of {TILE}")
    if state is None:
        state = torch.zeros(b, NSTATE, dtype=torch.float32, device=dev)
    else:
        state = torch.as_tensor(state).to(dev, torch.float32)
        if state.shape != (b, NSTATE):
            raise ValueError(f"carried state shape {tuple(state.shape)} "
                             f"does not match ({b}, {NSTATE})")
    return value.t().contiguous(), state.t().contiguous()


def _public(out, st, return_state):
    res = {n: out[i].t().contiguous() for i, n in enumerate(OUTPUT_NAMES)}
    if return_state:
        return res, st.t().contiguous()
    return res


def fused_frontend(value, params, mask_params=(0.01, 0.75, 0.10, 0.50, 0.50),
                   state=None, base=0, return_state=False, device="cuda"):
    """value: [B, T] samples (any B >= 1, T a multiple of TILE), moved to
    `device` (CUDA unless device="cpu"; without a card it raises).

    Returns a dict of [B, T] f32 outputs in OUTPUT_NAMES order.
    mask_params: (power_level_threshold, nfca_corr_thr, nfcb_min_deep,
    nfcf_corr_thr, nfcv_corr_thr), taken as float32.  params: the 8-tuple
    of dsp.frontend._params_tuple.

    Chunked streaming: pass `state` ([B, NSTATE] from the previous chunk,
    or None at stream start), `base` (this chunk's absolute start clock)
    and `return_state=True`; outputs are bit-identical to one monolithic
    pass over the concatenated chunks."""
    x_tm, st = _prepare(value, state, base, resolve_device(device))
    out, st = run_chunk(x_tm, st, base, params, mask_params)
    return _public(out, st, return_state)


def fused_frontend_plain(value, params,
                         mask_params=(0.01, 0.75, 0.10, 0.50, 0.50),
                         state=None, base=0, return_state=False):
    """fused_frontend through the plain versions on value's device (the
    yardstick the CUDA kernels are held to)."""
    value = torch.as_tensor(value)
    x_tm, st = _prepare(value, state, base, value.device)
    _check_scan_args(x_tm, st, base)
    out, st_out = _scan_plain(x_tm, st, base, params)
    _mask_plain(out, st, st_out, base, mask_params)
    return _public(out, st_out, return_state)


def fused_frontend_stream(value, params, chunk=1 << 16,
                          mask_params=(0.01, 0.75, 0.10, 0.50, 0.50),
                          device="cuda"):
    """Generator: feed [B, T] through the kernels in `chunk`-sample slices
    with carried state, yielding (offset, outputs) per chunk; the
    concatenated outputs are bit-identical to one monolithic pass."""
    value = torch.as_tensor(value)
    _, t = value.shape
    if chunk % TILE:
        raise ValueError(f"chunk must be a multiple of {TILE}")
    state = None
    for off in range(0, t, chunk):
        end = min(off + chunk, t)
        if (end - off) % TILE:
            raise ValueError("stream length must be a multiple of TILE")
        res, state = fused_frontend(
            value[:, off:end], params, mask_params=mask_params, state=state,
            base=off, return_state=True, device=device,
        )
        yield off, res
