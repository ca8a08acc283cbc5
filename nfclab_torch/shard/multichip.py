"""Multi-rank decode: sharded channel computation feeding the walk.

Counterpart of ``nfclab/shard/multichip.py``.  A capture is cut into
``L``-sample body blocks laid out over a 1-D ``blocks`` layout of ranks
(shard/launch.global_mesh; one rank, holding every block, when there is no
process group); each rank conditions and correlates its blocks, and the
``H``-sample left halo every block needs arrives from the left neighbour
over a ring of point-to-point sends and receives
(shard/temporal.halo_exchange) -- blocks interior to a rank take their
halo from the neighbouring row locally, so exactly one halo crosses
between ranks per rank per step.  The rows are all-gathered at the end
(``all_gather_into_tensor``), so every rank holds the whole capture's
channels for the host walk.

Semantics match the overlap-save path (dsp/cuda_channels.
fused_capture_channels): every (halo + body) window is processed from zero
carry, so body values converge to the continuous-stream values within the
halo (H=8192 covers the conditioning memory + the longest correlator
lookback, 473 + 1024-ring warm-up).  Block 0 is bit-exact with a fresh
stream: its halo is zeros and its conditioning clock/pulse counters start
at ``-H``, so the carry entering sample 0 is exactly the zero state (the
scan over a zero halo leaves env/w1/mdev/avg at 0 and the pulse counter
reaches 0 precisely at clock 0).

Outputs are the decode channel set (the 9 box channels + the packed
all-tech ``detect_mask``, same names/bit layout as the fused kernel),
ready for ``dsp.cuda_channels.preload_channels``.  Like nfclab's, every
block's conditioning restarts from zero state over its halo, so the mask's
power gate reads a restarted envelope: a halo that begins mid-modulation
can hold it low (nfclab's ``tpu_channels.py`` block-restart note).

Two channel steps, each on the device of the layout (``cuda`` unless the
caller asks for ``cpu``, where the kernels' plain versions run):

- ``sharded_capture_channels``: conditioning by the CUDA
  ``condition_scan`` kernel, box sums as segmented prefix sums in
  nfclab's summation order (its box channels equal nfclab's bit for bit)
  and the mask as torch operations (nfclab's ``_sharded_step``);
- ``sharded_kernel_channels``: both fused frontend kernels over the
  windows of ``dsp.cuda_channels._run_batch_blocks``'s layout, bit for bit
  equal to ``fused_capture_channels``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# body / halo per block; mirrors dsp/cuda_channels DEFAULT_L/DEFAULT_H
DEFAULT_L = 24576
DEFAULT_H = 8192
SEGMENT = 512  # the segmented box sum's segment


def _f32(x, device) -> torch.Tensor:
    """A 0-d float32 tensor: the operand of an IEEE operation on every
    device (PyTorch on CUDA turns a Python-scalar divisor into a
    reciprocal multiply)."""
    return torch.tensor(float(np.float32(x)), dtype=torch.float32,
                        device=device)


def _shift(a: torch.Tensor, d: int) -> torch.Tensor:
    """a delayed by d samples along its last axis, zeros before the
    start."""
    return F.pad(a[:, : a.shape[-1] - d], (d, 0)) if d else a


def _mask_val(env, filt, boxes, power_thr, thr, plan):
    """Packed all-tech detect mask over window arrays [R, W] -- the same
    trigger formulas and bit weights as the fused kernel's detect phase,
    expressed as whole-array shifts; rate-parametric via ``plan``
    (dsp.cuda_channels.channel_plan).  float32, as nfclab's."""
    from ..dsp.fused_frontend import (
        MASK_BIT_V, MASK_BITS_A, MASK_BITS_B, MASK_BITS_F,
    )

    dev = env.device
    zero = _f32(0.0, dev)
    power_ok = env >= _f32(power_thr, dev)
    mval = torch.zeros_like(env)

    for rates, tech, bits in ((plan["a_rates"], "nfca", MASK_BITS_A),
                              (plan["f_rates"], "nfcf", MASK_BITS_F)):
        level = _f32(thr[tech], dev) * env
        for r, (d, gap, p2) in enumerate(rates):
            box = boxes[p2]
            b0, b1 = _shift(box, d), _shift(box, d + 1)
            bg = _shift(box, d + gap)
            sd = ((b0 - bg) - (bg - b1)) / _f32(p2, dev)
            mask = power_ok & (sd.abs() > level)
            mval = mval + torch.where(mask, _f32(bits[r], dev), zero)

    edge_b = -(_f32(thr["nfcb"], dev) * env)
    for r, d in enumerate(plan["b_delays"]):
        mask = power_ok & (_shift(filt, d) < edge_b)
        mval = mval + torch.where(mask, _f32(MASK_BITS_B[r], dev), zero)

    dv, gapv, p2v = plan["v_rate"]
    box = boxes[p2v]
    u0, ug = _shift(box, dv), _shift(box, dv + gapv)
    sd_v = (ug - u0) / _f32(p2v, dev)
    mask_v = power_ok & (sd_v > _f32(thr["nfcv"], dev) * env)
    return mval + torch.where(mask_v, _f32(MASK_BIT_V, dev), zero)


def _prefix_sum(xs: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive prefix sums along the last axis in nfclab's order, float32
    adds only: the axis is cut into chunks of ``base``, each summed left to
    right, and the chunk tails' exclusive prefix (the same scan, one level
    up) is added to each chunk -- the two-level scan XLA makes of
    ``jnp.cumsum``, so the box channels equal nfclab's bit for bit, and the
    CPU and the card give the same bits."""
    n = xs.shape[-1]
    if n <= base:
        acc, cols = xs[..., 0], [xs[..., 0]]
        for i in range(1, n):
            acc = acc + xs[..., i]
            cols.append(acc)
        return torch.stack(cols, -1)
    if n % base:
        raise ValueError(f"prefix axis {n} is not a multiple of {base}")
    loc = _prefix_sum(xs.reshape(xs.shape[:-1] + (n // base, base)), base)
    inc = _prefix_sum(loc[..., -1], base)
    excl = F.pad(inc[..., :-1], (1, 0))
    return (loc + excl[..., None]).reshape(xs.shape)


def _box_sum(x: torch.Tensor, width: int, seg: int = SEGMENT) -> torch.Tensor:
    """Trailing-window box sum with SEGMENTED prefix sums: both window
    endpoints difference against the same local segment accumulation, so
    roundoff is ~eps*seg_sum instead of ~eps*window_sum (a plain W-long
    f32 prefix difference flips threshold-adjacent decode samples)."""
    r, w_len = x.shape
    if w_len % seg or width > seg:
        raise ValueError(f"window {w_len} / box {width} do not fit segments "
                         f"of {seg}")
    xs = x.reshape(r, w_len // seg, seg)
    c = _prefix_sum(xs)  # local inclusive prefix per segment
    tails = c[..., -1]
    cprev = F.pad(c[:, :-1], (0, 0, 1, 0))
    tprev = F.pad(tails[:, :-1], (1, 0))
    o = torch.arange(seg, device=x.device)
    # window inside one segment: exact local difference
    case1 = c - torch.roll(c, width, dims=-1)
    # window crossing a boundary: local value + tail of prev segment
    c2 = cprev[..., torch.clamp(o + seg - width, 0, seg - 1)]
    case2 = c + (tprev[..., None] - c2)
    return torch.where(o >= width, case1, case2).reshape(r, w_len)


def _left_windows(rows, mesh, nb_loc, L, H, no_collective=False):
    """([nb_loc, H + L] windows [left-halo | body], first-row flags): the
    left halo of each rank's first block arrives from the left
    neighbour's last block tail over the ring; the global first row's halo
    is zeros (the ring's wrap into rank 0 is replaced by the stream
    start).  no_collective takes a local stand-in of the same shape."""
    from .temporal import halo_exchange

    if no_collective:
        recv = rows[-1, L - H:].clone()
    else:
        recv = halo_exchange(rows[-1], H, mesh.group, mesh.ranks)
    halos = torch.cat([recv[None], rows[:-1, L - H:]], 0)
    row_ids = mesh.coords[0] * nb_loc + torch.arange(nb_loc,
                                                     device=rows.device)
    first = row_ids == 0
    halos = torch.where(first[:, None], _f32(0.0, rows.device), halos)
    return torch.cat([halos, rows], 1), first, row_ids


def _sharded_step(params_tuple, mask_params, sample_rate: int, mesh,
                  nb_loc: int, L: int, H: int, no_collective: bool = False):
    """This rank's channel step: rows [nb_loc, L] on the layout's device ->
    the channel dict, [nb_loc, L] each.  Halos travel over the ring.
    Rate-parametric: the channel widths/delays come from
    dsp.cuda_channels.channel_plan(sample_rate).

    no_collective=True replaces the ring halo with a locally-sourced
    stand-in of identical shape/compute -- WRONG values, used only by the
    scaling harness to isolate the collective's share of step time."""
    from ..dsp.conditioner_kernel import condition_scan
    from ..dsp.cuda_channels import channel_plan

    plan = channel_plan(sample_rate)
    power_thr, a_thr, b_deep, f_thr, v_thr = mask_params
    thr = {"nfca": a_thr, "nfcb": b_deep, "nfcf": f_thr, "nfcv": v_thr}

    def local_step(rows):  # [nb_loc, L] on this rank
        windows, first, _ = _left_windows(rows, mesh, nb_loc, L, H,
                                          no_collective)
        # conditioning from zero carry; block 0's clock/pulse start at -H so
        # its zero halo leaves exactly the fresh-stream state at sample 0
        zeros_f = torch.zeros(nb_loc, dtype=torch.float32,
                              device=rows.device)
        neg_h = torch.where(first, -H, 0).to(torch.int32)
        env, _w1, _mdev, _avg, filt, _pulse = condition_scan(
            windows, zeros_f, zeros_f, zeros_f, zeros_f, neg_h, neg_h,
            params_tuple)

        ten = _f32(10.0, rows.device)
        res = {}
        boxes = {}
        for w in plan["bv"]:
            boxes[w] = _box_sum(windows, w)
            res[f"bv{w}"] = boxes[w]
        sq = filt * filt * ten
        for w in plan["q"]:
            res[f"q{w}"] = _box_sum(sq, w)
        for lag, box in plan["pb"]:
            prod = F.pad(filt[:, lag:] * filt[:, :-lag], (lag, 0)) * ten
            res[f"p{lag}x{box}"] = _box_sum(prod, box)
        res["detect_mask"] = _mask_val(env, filt, boxes, power_thr, thr,
                                       plan)
        # keep only the body region (drop the halo)
        return {k: v[:, H:] for k, v in res.items()}

    return local_step


def _layout_rows(samples, L: int, n_ranks: int):
    """(rows [nb_pad, L] f32 zero-padded, n, nb_loc): the capture's blocks,
    nb padded to a multiple of the rank count."""
    samples = np.ascontiguousarray(samples, np.float32)
    n = len(samples)
    nb = max(1, -(-n // L))
    nb_pad = -(-nb // n_ranks) * n_ranks
    rows = np.zeros((nb_pad, L), np.float32)
    rows.reshape(-1)[:n] = samples
    return rows, n, nb_pad // n_ranks


def _local_rows(rows, mesh, nb_loc):
    from ..dsp.cuda_channels import upload_samples

    p = mesh.coords[0]
    return upload_samples(rows[p * nb_loc : (p + 1) * nb_loc], mesh.device)


def _resolve_mesh(mesh, device):
    from .launch import global_mesh

    return global_mesh(device=device) if mesh is None else mesh


def _check_window(L: int, H: int):
    if not 0 < H <= L:
        raise ValueError(f"the halo H={H} must lie in (0, L={L}]")


def sharded_capture_channels(
    samples: np.ndarray,
    sample_rate: int,
    mesh=None,
    L: int = DEFAULT_L,
    H: int = DEFAULT_H,
    power_level_threshold: float = 0.01,
    thresholds=None,
    device="cuda",
) -> dict[str, np.ndarray]:
    """Compute the decode channel set for one capture over a ``blocks``
    layout (default: shard/launch.global_mesh on ``device``); returns host
    f32 arrays (len(samples)) keyed like dsp.cuda_channels.fetch_names
    (box channels + packed detect_mask), the same on every rank."""
    from ..core.params import SignalParams
    from ..core.thresholds import DecoderThresholds
    from ..dsp.cuda_channels import channel_plan
    from ..dsp.frontend import _params_tuple

    # the halo must cover the 1024-sample ring warm-up + the conditioning
    # silence window (10 ETU) + the deepest correlator lookback, all of
    # which scale with the sample rate except the ring
    plan = channel_plan(sample_rate)
    dv, gapv, _ = plan["v_rate"]
    etu = max(1, round(128 * sample_rate / 13.56e6))
    need = 1024 + 2 * (dv + gapv) + 10 * etu
    if H < need:
        raise ValueError(
            f"halo H={H} too small for {sample_rate} S/s (needs >= {need}); "
            "pass a larger H"
        )
    if max(plan["bv"] + plan["q"]) > SEGMENT:
        raise ValueError(
            f"box width exceeds the segmented-cumsum segment ({SEGMENT}); "
            f"sample rate {sample_rate} is beyond the sharded frontend's "
            "current range"
        )
    _check_window(L, H)
    if (H + L) % SEGMENT:
        raise ValueError(f"H + L = {H + L} is not a multiple of the "
                         f"segment ({SEGMENT})")
    mesh = _resolve_mesh(mesh, device)
    rows, n, nb_loc = _layout_rows(samples, L, mesh.size)
    params = SignalParams(
        sample_rate, power_level_threshold=power_level_threshold
    )
    mask_params = (thresholds or DecoderThresholds()).detect_mask_tuple(
        power_level_threshold
    )
    step = _sharded_step(
        _params_tuple(params), mask_params, int(sample_rate), mesh, nb_loc,
        L, H,
    )
    out = step(_local_rows(rows, mesh, nb_loc))
    return {k: _fetch_global(v, mesh).reshape(-1)[:n] for k, v in out.items()}


def _fetch_global(v: torch.Tensor, mesh) -> np.ndarray:
    """This rank's [nb_loc, L] rows -> the whole layout's [nb, L] rows on
    the host, in block order: an all-gather over the layout's group (a
    gloo group gathers host copies), so every rank holds the whole
    capture for the host walk."""
    if mesh.group is None or mesh.size == 1:
        return v.cpu().numpy()
    import torch.distributed as dist

    g = mesh.group
    src = v.contiguous()
    if src.is_cuda and dist.get_backend(g) == "gloo":
        src = src.cpu()
    out = torch.empty((mesh.size * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=g)
    host = out.cpu().numpy().reshape((mesh.size,) + tuple(src.shape))
    # group-rank order -> block order
    where = [dist.get_group_rank(g, r) for r in mesh.ranks]
    return host[where].reshape((-1,) + tuple(src.shape[1:]))


def _sharded_kernel_step(params_tuple, mask_params, mesh, nb_loc: int,
                         L: int, H: int, sample_rate: int):
    """This rank's channel step with the fused frontend kernels: rows
    [nb_loc, L] -> the channel dict, [nb_loc, L] each.  Windows match
    dsp.cuda_channels._run_batch_blocks bit-exactly: row 0 is
    [body | next-H] (fresh-stream state at sample 0), other rows
    [left-halo | body]; the halos cross ranks both ways over the ring.
    The kernels take any stream count, so a rank's rows are not padded."""
    from ..dsp import fused_frontend as ff
    from ..dsp.cuda_channels import fetch_names
    from .temporal import ring_shift

    if (H + L) % ff.TILE:
        raise ValueError(f"H + L = {H + L} is not a multiple of {ff.TILE}")
    plan = ff.kernel_plan(sample_rate)
    sel = ff._normalize_select(fetch_names(sample_rate), plan)
    n_rows = mesh.size * nb_loc

    def local_step(rows):  # [nb_loc, L] on this rank
        windows, first, row_ids = _left_windows(rows, mesh, nb_loc, L, H)
        # stream-head row layout is [body | next-H] (exact fresh-stream
        # conditioning); the next-H of my last row comes from the right
        # neighbour's first row head
        recv_head = ring_shift(rows[0, :H], mesh.group, mesh.ranks, -1)
        nexts = torch.cat([rows[1:, :H], recv_head[None]], 0)
        # the global last row's "next" wraps to the stream head; its true
        # continuation is past-capture zeros (only reachable when the
        # capture fits one row)
        last = row_ids == n_rows - 1
        nexts = torch.where(last[:, None], _f32(0.0, rows.device), nexts)
        windows_head = torch.cat([rows, nexts], 1)
        windows = torch.where(first[:, None], windows_head, windows)

        res, _ = ff.run_chunk(
            windows.t().contiguous(),
            torch.zeros(plan.nstate, nb_loc, dtype=torch.float32,
                        device=rows.device),
            0, params_tuple, tuple(mask_params), plan, sel,
        )
        out = {}
        for k, v in res.items():
            v = v.t()
            out[k] = torch.where(first[:, None], v[:, :L], v[:, H:])
        return out

    return local_step


def sharded_kernel_channels(
    samples: np.ndarray,
    sample_rate: int,
    mesh=None,
    L: int = DEFAULT_L,
    H: int = DEFAULT_H,
    power_level_threshold: float = 0.01,
    thresholds=None,
    device="cuda",
) -> dict[str, np.ndarray]:
    """Multi-rank channel computation with the fused frontend kernels,
    rate-parametric via fused_frontend.kernel_plan.  Bit-identical to
    dsp.cuda_channels.fused_capture_channels (held on the card by
    tools/validate_cuda_shard_kernel)."""
    from ..core.params import SignalParams
    from ..core.thresholds import DecoderThresholds
    from ..dsp.frontend import _params_tuple

    _check_window(L, H)
    mesh = _resolve_mesh(mesh, device)
    rows, n, nb_loc = _layout_rows(samples, L, mesh.size)
    params = SignalParams(
        sample_rate, power_level_threshold=power_level_threshold
    )
    mask_params = (thresholds or DecoderThresholds()).detect_mask_tuple(
        power_level_threshold
    )
    step = _sharded_kernel_step(
        _params_tuple(params), tuple(mask_params), mesh, nb_loc, L, H,
        sample_rate,
    )
    out = step(_local_rows(rows, mesh, nb_loc))
    return {k: _fetch_global(v, mesh).reshape(-1)[:n] for k, v in out.items()}


def decode_sharded(
    samples: np.ndarray,
    sample_rate: int,
    mesh=None,
    device="cuda",
    **decoder_kwargs,
):
    """Full multi-rank decode to frames: sharded channels + host event
    walk.  Returns the same frame list as NfcDecoder.decode."""
    from ..runtime.decoder import NfcDecoder

    dec = NfcDecoder(**decoder_kwargs)
    chans = sharded_capture_channels(
        samples, sample_rate, mesh=mesh,
        power_level_threshold=dec.power_level_threshold,
        thresholds=dec.thresholds, device=device,
    )
    return dec.decode(samples, sample_rate, tpu_channels=chans)
