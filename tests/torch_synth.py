"""Synthetic captures for the nfclab_torch tests and chip_smoke.py.

Built from the waveform writers of tests/*_synth.py (numpy only); CRCs come
from nfclab_torch.protocol.crc, so nothing here imports nfclab or JAX.

- ``templates()``: five short captures, one per decode path (NFC-A 106k
  poll + ASK listen, NFC-A 424k poll + BPSK listen, NFC-B, NFC-F, NFC-V),
  each with the frame bytes it carries.
- ``mixed_lanes()``: a [B, T] batch for kernel parity: template windows,
  noise, field-off pauses and carriers near the power gate.
- ``lane()``: one long stream from a template, repeated, with its own
  seeded gain, offset and noise.
"""

from __future__ import annotations

import typing

import numpy as np

from nfclab_torch.protocol.crc import crc16_ccitt

RATE = 10_000_000


def crc_a(data: bytes) -> bytes:
    v = crc16_ccitt(data, 0, len(data), 0x6363, True)
    return bytes((v & 0xFF, (v >> 8) & 0xFF))


def crc_b(data: bytes) -> bytes:
    """ISO14443-B and ISO15693 CRC16 (init 0xFFFF, reflected, inverted)."""
    v = (~crc16_ccitt(data, 0, len(data), 0xFFFF, True)) & 0xFFFF
    return bytes((v & 0xFF, (v >> 8) & 0xFF))


def crc_f(data: bytes) -> bytes:
    v = crc16_ccitt(data, 0, len(data), 0x0000, False)
    return bytes(((v >> 8) & 0xFF, v & 0xFF))


class Template(typing.NamedTuple):
    name: str
    samples: np.ndarray      # f32 magnitude capture at RATE
    tech: str                # nfca | nfcb | nfcf | nfcv
    sent: list               # frame bytes in emission order


def _payloads(rng, n, lo=2, hi=8):
    return [bytes(rng.integers(0, 256, int(rng.integers(lo, hi))).tolist())
            for _ in range(n)]


def templates(seed: int = 7) -> list[Template]:
    from nfca_bpsk_synth import A424Writer
    from nfca_synth import ListenWriter
    from nfcb_synth import BListenWriter
    from nfcf_synth import FPollWriter
    from nfcv_synth import VListenWriter

    rng = np.random.default_rng(seed)
    out = []

    w, sent = ListenWriter(), []
    for pp, rp in zip(_payloads(rng, 2), _payloads(rng, 2)):
        poll, resp = pp + crc_a(pp), rp + crc_a(rp)
        w.frame(poll)
        w.listen_frame(resp)
        w.gap()
        sent += [poll, resp]
    out.append(Template("nfca_106k", w.build(), "nfca", sent))

    w, sent = A424Writer(rate_type=2), []
    for pp, rp in zip(_payloads(rng, 2), _payloads(rng, 2)):
        poll, resp = pp + crc_a(pp), rp + crc_a(rp)
        w.frame(poll)
        w.listen_frame(resp)
        w.gap()
        sent += [poll, resp]
    out.append(Template("nfca_424k_bpsk", w.build(), "nfca", sent))

    w, sent = BListenWriter(), []
    pp, rp = _payloads(rng, 2)
    poll, resp = pp + crc_b(pp), rp + crc_b(rp)
    w.frame(poll)
    w.listen_frame(resp)
    w.gap(4096)
    sent += [poll, resp]
    out.append(Template("nfcb", w.build(), "nfcb", sent))

    w, sent = FPollWriter(), []
    pb, rb = _payloads(rng, 2)
    pbody, rbody = bytes([len(pb) + 1]) + pb, bytes([len(rb) + 1]) + rb
    poll, resp = pbody + crc_f(pbody), rbody + crc_f(rbody)
    w.frame(poll)
    w.listen_frame(resp, delay=3000)
    w.gap(4096)
    sent += [poll, resp]
    out.append(Template("nfcf", w.build(), "nfcf", sent))

    w, sent = VListenWriter(), []
    pp, rp = _payloads(rng, 2, 1, 2)
    poll, resp = pp + crc_b(pp), rp + crc_b(rp)
    w.frame(poll)
    w.listen_frame(resp)
    w.gap(4096)
    sent += [poll, resp]
    out.append(Template("nfcv", w.build(8192), "nfcv", sent))
    return out


def mixed_lanes(b: int, t: int, seed: int = 0) -> np.ndarray:
    """[b, t] f32 lanes for kernel parity: windows of the templates at
    random offsets and gains, noise, field-off pauses (zeros) and carriers
    near the 0.01 power gate."""
    rng = np.random.default_rng(seed)
    tpl = [tp.samples for tp in templates()]
    x = np.empty((b, t), np.float32)
    for i in range(b):
        src = tpl[i % len(tpl)]
        off = int(rng.integers(0, len(src) - t))
        x[i] = src[off : off + t] * np.float32(rng.uniform(0.5, 1.5))
    kind = rng.integers(0, 4, b)
    noise = rng.standard_normal((b, t)).astype(np.float32)
    x += noise * (np.float32(1e-3) * (kind == 1))[:, None]
    for i in np.flatnonzero(kind == 2):          # field-off pause
        lo = int(rng.integers(0, t // 2))
        x[i, lo : lo + int(rng.integers(t // 8, t // 2))] = 0.0
    near = kind == 3                              # carrier near the gate
    x[near] = x[near] * np.float32(0.0203) + noise[near] * np.float32(2e-4)
    return x


def lane(tp: Template, n: int, seed: int):
    """(samples, repeats): the template repeated as often as it fits in n
    samples, then steady carrier, times a seeded gain plus a seeded offset
    and noise."""
    rng = np.random.default_rng(seed)
    reps = max(1, n // len(tp.samples))
    body = np.tile(tp.samples, reps)
    out = np.empty(n, np.float32)
    out[: len(body)] = body[:n]
    out[len(body):] = tp.samples[-1]
    gain = np.float32(rng.uniform(0.8, 1.25))
    offset = np.float32(rng.uniform(-2e-3, 2e-3))
    out *= gain
    out += offset
    out += rng.standard_normal(n, dtype=np.float32) * np.float32(2e-4)
    return out, min(reps, n // len(tp.samples))


# envelopes and samples at which the envelope test's result comes from
# IEEE special cases: env <= 0, +inf, NaN; v = +-inf, NaN
BOUNDARY_SPECIAL_ENV = (0.0, -0.0, -1.5, -1e-45, float("inf"), float("-inf"),
                        float("nan"))
BOUNDARY_SPECIAL_V = (float("inf"), float("-inf"), float("nan"))


def boundary_lanes(b: int, t: int, seed: int = 0, binades=(-149, 128),
                   specials: bool = True):
    """(env0 [b], x [b, t]) f32 that put the envelope test |v - env| / env
    < 0.05 on its boundary: env0 log-uniform over the binades (by default
    the float32 range, from the subnormals to ~3.4e38), each lane's sample
    v = env0 * (1 +- 0.05) moved by -4..4 ulps and held for the t steps (a
    lane whose envelope does not follow stays on the boundary); with
    specials, one lane in 32 takes a special envelope or sample instead."""
    rng = np.random.default_rng(seed)
    exps = rng.integers(*binades, b)
    env = np.ldexp(rng.uniform(1.0, 2.0, b), exps).astype(np.float32)
    side = rng.choice(np.array([1.0, -1.0]), b)
    with np.errstate(over="ignore"):
        v = (env.astype(np.float64) * (1.0 + side * 0.05)).astype(np.float32)
    k = rng.integers(-4, 5, b)
    for step in range(4):
        up, down = k > step, k < -step
        v[up] = np.nextafter(v[up], np.float32(np.inf))
        v[down] = np.nextafter(v[down], np.float32(-np.inf))
    special = np.flatnonzero(rng.integers(0, 32, b) == 0) if specials \
        else np.zeros(0, np.int64)
    half = special[: len(special) // 2]
    env[half] = rng.choice(np.array(BOUNDARY_SPECIAL_ENV, np.float32),
                           len(half))
    rest = special[len(special) // 2 :]
    v[rest] = rng.choice(np.array(BOUNDARY_SPECIAL_V, np.float32), len(rest))
    x = np.repeat(v[:, None], t, axis=1)
    return env, x


def probe_boundary_lanes(lanes: int, t: int, seed: int = 0, lead: int = 100,
                         binades=(-149, 128), specials: bool = True,
                         off=None) -> np.ndarray:
    """[t, lanes] f32 that put the envelope test of the conditioning
    probes, which start from a zero carry, on its boundary: each lane holds
    its env0 of boundary_lanes for `lead` steps (the envelope seeds on it
    and settles within an ulp or two), then its boundary sample v.  With
    off = (a, b), every 4th lane is 0 on steps [a, b) (the field off, past
    the silence timeout when b - a exceeds 10 ETU)."""
    env, x = boundary_lanes(lanes, max(t - lead, 1), seed, binades, specials)
    out = np.concatenate([np.repeat(env[:, None], lead, 1), x], 1)[:, :t]
    if off is not None:
        out[::4, off[0] : off[1]] = 0.0
    return np.ascontiguousarray(out.T)


# the mask's SD tests, focused: (output channel, row period, d, p2, which
# threshold) -- a target box value every `period` rows is b0 = B(t - d) of
# the test at row r + d, and its gap and previous rows are 0, so the
# test's numerator is the target itself (the V test's ug at d = 473, with
# its u0 at 378 zero)
MASK_FOCI = {
    "a": (("bv47", 48, 0, 47, "a"), ("bv24", 32, 94, 24, "a"),
          ("bv12", 16, 141, 12, "a"), ("bv94", 64, 473, 94, "v")),
    "f": (("bv24", 32, 0, 24, "f"), ("bv12", 16, 0, 12, "f"),
          ("bv47", 48, 0, 47, "a"), ("bv94", 64, 473, 94, "v")),
}
MASK_SPECIAL_ENV = (0.0, -0.0, -1.5, -1e-45, 1e-45, float("inf"),
                    float("-inf"), float("nan"), 3.4028235e38)


def mask_boundary_out(t: int, b: int, seed: int, case: str, mp):
    """(out [15, t, b], state [1285, b]) f32 that put fused_v2's mask tests
    on their boundary: env log-uniform over the float32 range with one
    stream in 16 special (zero, -0, negative, subnormal, inf, NaN,
    FLT_MAX); each focused test's numerator at -2..2 ulps of the float32
    nearest p2 * m(y), m(y) the midpoint of its threshold y = thr * env and
    y's successor (a tie where it is a float32), signed; the filtered
    channel at -2..2 ulps of the NFC-B edge; the state small and seeded.
    mp: the float32 mask parameters (power_thr, a, b, f, v)."""
    from nfclab_torch.experiments import fused_v2 as v2

    rng = np.random.default_rng(seed)
    f32 = np.float32
    _, a_thr, b_min_deep, f_thr, v_thr = (f32(x) for x in mp)
    thr = {"a": a_thr, "f": f_thr, "v": v_thr}
    env = np.ldexp(rng.uniform(1, 2, (t, b)),
                   rng.integers(-149, 128, (t, b))).astype(f32)
    special = rng.random((t, b)) < 1 / 16
    env[special] = rng.choice(np.array(MASK_SPECIAL_ENV, f32),
                              int(special.sum()))
    out = np.zeros((v2.N_OUT, t, b), f32)
    out[v2._ROW["envelope"]] = env

    def nudge(x, k):
        for step in range(2):
            up, down = k > step, k < -step
            x[up] = np.nextafter(x[up], f32(np.inf))
            x[down] = np.nextafter(x[down], f32(-np.inf))
        return x

    with np.errstate(over="ignore", invalid="ignore"):
        for name, period, d, p2, which in MASK_FOCI[case]:
            rows = np.arange(0, t - d, period)
            y = (thr[which] * env[rows + d]).astype(f32)
            up = np.nextafter(y, f32(np.inf))
            lim = p2 * (y.astype(np.float64) + up.astype(np.float64)) * 0.5
            n = nudge(lim.astype(f32), rng.integers(-2, 3, y.shape))
            sign = rng.choice(np.array([1, -1], f32), y.shape)
            out[v2._ROW[name], rows] = n * sign
        edge = (-(b_min_deep * env)).astype(f32)
        out[v2._ROW["filtered"]] = nudge(edge, rng.integers(-2, 3, env.shape))
    state = (rng.random((v2.NSTATE, b), dtype=f32) * f32(1e-2))
    return out, state


def _mask_tests(plan):
    """fused_frontend's SD tests of a plan: (channel, d, gap, p2, which)
    with lags d, d + 1, d + gap (A, F) or d, d + gap (V)."""
    return ([(w, d, gap, p2, "a") for d, gap, p2, w in plan.a_rates]
            + [(w, 0, gap, p2, "f") for _, gap, p2, w in plan.f_rates]
            + [(plan.v_rate[3], plan.v_rate[0], plan.v_rate[1],
                plan.v_rate[2], "v")])


def ff_mask_boundary_deps(plan, t: int, b: int, seed: int, case: int, mp):
    """(deps [n_bv + 2, t, b], value [t, b], state [nstate, b]) f32 that put
    fused_frontend's mask tests on their boundary at a kernel plan: env
    log-uniform over the float32 range with one stream in 16 special; on
    each raw-box channel the case-th of its SD tests focused (a target box
    value every P rows, its b1 and bg rows or its u0 row 0, so that the
    numerator is the target): the target at -2..2 ulps of the float32
    nearest p2 * m(y), m(y) the midpoint of y = thr * env at the test's row
    and y's successor, or at p2 y (1 +- 2^-20) +- 2 ulps (the edge of the
    mask kernel's float32 band), or at p2 y (1 +- 2^-19) (inside it),
    signed.  The channel runs on through its history section of the state,
    oldest first, so that lookbacks before the chunk sit on the boundary
    too.  The filtered channel at -2..2 ulps of the NFC-B edge of the
    case-th delay; the samples at env times 1, 1 +- 1 ulp, 1/2, 2, -1 or 0,
    one in 16 special.  mp: the float32 mask parameters (power_thr, a, b,
    f, v)."""
    from nfclab_torch.dsp.fused_frontend import _layout

    rng = np.random.default_rng(seed)
    f32 = np.float32
    _, a_thr, b_min_deep, f_thr, v_thr = (f32(x) for x in mp)
    thr = {"a": a_thr, "f": f_thr, "v": v_thr}
    nbv = len(plan.bv_widths)
    env = np.ldexp(rng.uniform(1, 2, (t, b)),
                   rng.integers(-149, 128, (t, b))).astype(f32)
    special = rng.random((t, b)) < 1 / 16
    env[special] = rng.choice(np.array(MASK_SPECIAL_ENV, f32),
                              int(special.sum()))
    hlen = [h + 128 for h in plan.h_sizes]
    # each history channel with its lookback: rows -hlen .. t - 1
    ext = [np.zeros((n + t, b), f32) for n in hlen]

    def nudge(x, k):
        for step in range(2):
            up, down = k > step, k < -step
            x[up] = np.nextafter(x[up], f32(np.inf))
            x[down] = np.nextafter(x[down], f32(-np.inf))
        return x

    by_channel = {}
    for test in _mask_tests(plan):
        by_channel.setdefault(test[0], []).append(test)
    with np.errstate(over="ignore", invalid="ignore"):
        for ch, tests in sorted(by_channel.items()):
            _, d, gap, p2, which = tests[case % len(tests)]
            if gap < 2:
                continue
            period = next(p for p in range(16, 64) if gap % p and
                          (which == "v" or (gap - 1) % p))
            lead = d + gap if which == "v" else d   # test row - target row
            n = hlen[ch]
            rows = np.arange(-n, t)
            rows = rows[(rows % period == 0) & (rows + lead >= 0)
                        & (rows + lead < t)]
            y = (thr[which] * env[rows + lead]).astype(f32)
            up = np.nextafter(y, f32(np.inf))
            mid = p2 * (y.astype(np.float64) + up.astype(np.float64)) * 0.5
            kind = rng.integers(0, 3, y.shape)
            side = rng.choice(np.array([1.0, -1.0]), y.shape)
            band = p2 * y.astype(np.float64) * np.where(
                kind == 1, 1 + side * 2.0**-20, 1 + side * 2.0**-19)
            target = np.where(kind == 0, mid, band).astype(f32)
            target = nudge(target, np.where(kind == 2, 0,
                                            rng.integers(-2, 3, y.shape)))
            sign = rng.choice(np.array([1, -1], f32), y.shape)
            ext[ch][rows + n] = target * sign
        d = plan.b_delays[case % len(plan.b_delays)]
        edge = (-(b_min_deep * env[d:])).astype(f32)
        n = hlen[nbv]
        ext[nbv][n - d : n - d + edge.shape[0]] = nudge(
            edge, rng.integers(-2, 3, edge.shape))
        scale = rng.choice(np.array([1.0, 1.0 + 2**-23, 1.0 - 2**-24, 0.5,
                                     2.0, -1.0, 0.0], f32), (t, b))
        value = (env * scale).astype(f32)
    odd = rng.random((t, b)) < 1 / 16
    value[odd] = rng.choice(np.array(BOUNDARY_SPECIAL_V, f32),
                            int(odd.sum()))
    deps = np.zeros((nbv + 2, t, b), f32)
    state = rng.random((plan.nstate, b), dtype=f32) * f32(1e-2)
    offs = _layout(plan).hist_offs
    for k in range(nbv + 1):
        deps[k] = ext[k][hlen[k]:]
        state[offs[k] : offs[k] + hlen[k]] = ext[k][: hlen[k]]
    deps[nbv + 1] = env
    return deps, value, state
