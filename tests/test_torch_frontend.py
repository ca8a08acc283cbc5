"""The port's dense frontend (``dsp.frontend.make_frontend``) against
nfclab's ``jax.jit(make_frontend(params))`` on the CPU, in two cases:

- B = 1024, T = 512: nfclab takes its Pallas conditioning kernel (in TPU
  interpret mode here);
- B = 8, T = 4096: nfclab takes its ``lax.scan``.

The port conditions with ``condition_scan`` in both.  Keys and dtypes are
equal.  The float channels compare within tolerances that have these
reasons:

- FMA contraction: XLA:CPU contracts the conditioning chain's
  multiply-adds, so envelope, filtered, deviation, average and mod_depth
  compare at rtol 1e-5, atol 1e-6 (torch_parity), each stream up to its
  first envelope decision within 1e-4 of 0.05 (``tainted``);
- cumsum order: the box sums are differences of running prefixes.  nfclab's
  f32 cumsum on the CPU is a parallel prefix (error up to about
  log2(T) + 1 roundings of the row's input sum S); the port's prefixes are
  accumulated in float64 and rounded once.  A box is two prefixes and an
  SD four boxes, so sd_a compares within 8 (log2 T + 2) eps S / p2, with
  S the sum of |value| over the row;
- both at once for the squared and product boxes: their input is built
  from the filtered channel, which the FMA moves by up to 1e-6, and the
  prefix carries every such difference, so they compare within
  2 (20e-6 sum|filt| + (log2 T + 2) eps S), S the sum of the input.

A mask bit may differ only where its deciding quantity, recomputed in
float64 from the input and nfclab's envelope and filtered channels, lies
within 1e-4 (relative) plus the error bound above of its threshold, where
the power gate is that close, or where the stream is tainted.
"""

import numpy as np
import pytest
import torch

from torch_parity import ATOL, MARGIN, RTOL, tainted
from torch_synth import mixed_lanes

RATE = 10_000_000
EPS = float(np.finfo(np.float32).eps)
COND = ("envelope", "filtered", "deviation", "average", "mod_depth")


def _params():
    from nfclab_torch.core.params import SignalParams

    return SignalParams(RATE)


def _run_jax(x, interpret):
    import jax

    from nfclab.core.params import SignalParams
    from nfclab.dsp.frontend import make_frontend

    fn = jax.jit(make_frontend(SignalParams(RATE)))
    if interpret:
        from jax.experimental.pallas import tpu as pltpu

        with pltpu.force_tpu_interpret_mode():
            return {k: np.asarray(v) for k, v in fn(x).items()}
    return {k: np.asarray(v) for k, v in fn(x).items()}


@pytest.fixture(scope="module", params=[(1024, 512, True), (8, 4096, False)],
                ids=["pallas_branch", "scan_branch"])
def case(request):
    from nfclab_torch.dsp.frontend import make_frontend

    b, t, interpret = request.param
    x = mixed_lanes(b, t, seed=31)
    ref = _run_jax(x, interpret)
    got = {k: v.numpy()
           for k, v in make_frontend(_params(), device="cpu")(x).items()}
    return x, ref, got


def _shift(a, d):
    if d == 0:
        return a
    return np.concatenate([np.zeros((a.shape[0], d), a.dtype), a[:, :-d]], 1)


def _box64(x, w):
    c = np.cumsum(x.astype(np.float64), 1)
    return c - _shift(c, w)


def _bounds(x):
    """Per-row prefix error bound of the value boxes and the float64
    reference quantities of the detect cascades."""
    t = x.shape[1]
    depth = np.log2(t) + 2
    s_val = np.abs(x.astype(np.float64)).sum(1, keepdims=True)
    return depth, depth * EPS * s_val


def test_keys_and_dtypes(case):
    _, ref, got = case
    assert set(got) == set(ref)
    assert len(got) == 21
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert got[k].shape == ref[k].shape, k
    assert sum(v.dtype == np.bool_ for v in got.values()) == 8


def test_float_channels(case):
    from nfclab_torch.core.params import nfca_bitrates

    x, ref, got = case
    taint = tainted(ref, x)
    assert taint[:, -1].mean() <= 0.01, "too many tainted streams"
    for name in COND:
        bad = ~np.isclose(got[name], ref[name], rtol=RTOL, atol=ATOL,
                          equal_nan=True) & ~taint
        assert not bad.any(), f"{name}: {int(bad.sum())} samples off"
    depth, e_val = _bounds(x)
    filt = got["filtered"].astype(np.float64)
    s_f = np.abs(filt).sum(1, keepdims=True)
    for br in nfca_bitrates(RATE):
        name = f"sd_a_{br.rate_type}"
        d = np.abs(got[name].astype(np.float64) - ref[name])
        assert (d <= 8 * e_val / br.period2).all(), name
        name = f"boxq_{br.period2}"
        s_sq = (10 * filt * filt).sum(1, keepdims=True)
        d = np.abs(got[name].astype(np.float64) - ref[name])
        assert (d <= 2 * (20 * ATOL * s_f + depth * EPS * s_sq)).all(), name
    for br in nfca_bitrates(RATE)[1:]:
        name = f"pb4_a_{br.rate_type}"
        p1 = br.period1
        s_p = 10 * np.abs(filt * _shift(filt, p1)).sum(1, keepdims=True)
        d = np.abs(got[name].astype(np.float64) - ref[name])
        assert (d <= 2 * (20 * ATOL * s_f + depth * EPS * s_p)).all(), name


def test_masks(case):
    from nfclab_torch.core.params import nfca_bitrates
    from nfclab_torch.demod.nfcv import nfcv_bitrate
    from nfclab_torch.dsp.frontend import _default_corr_thresholds

    x, ref, got = case
    p = _params()
    thr = {k: np.float32(v) for k, v in _default_corr_thresholds().items()}
    pthr = np.float64(np.float32(p.power_level_threshold))
    env = ref["envelope"].astype(np.float64)
    filt = ref["filtered"].astype(np.float64)
    _, e_val = _bounds(x)
    taint = tainted(ref, x)
    gate_near = np.abs(env - pthr) <= MARGIN * pthr

    def near(q, level, tol):
        return np.abs(q - level) <= MARGIN * np.abs(level) + tol

    allowed = {}
    bra = nfca_bitrates(RATE)
    for br in bra:
        d, p1, p2 = br.symbol_delay_detect, br.period1, br.period2
        box = _box64(x, p2)
        gap = p1 - p2
        raw = ((box - _shift(box, gap)) - (_shift(box, gap) - _shift(box, 1))
               ) / p2
        tol = 8 * e_val / p2
        allowed[f"mask_a_{br.rate_type}"] = near(
            np.abs(_shift(raw, d)), thr["nfca"] * env, tol)
        if br.rate_type > 0:
            allowed[f"mask_f_{br.rate_type}"] = near(
                np.abs(raw), thr["nfcf"] * env, tol)
    for d in (0, bra[0].period1):
        allowed[f"mask_b_{d}"] = near(_shift(filt, d), -(thr["nfcb"] * env),
                                      2 * ATOL)
    brv = nfcv_bitrate(RATE)
    boxv = _box64(x, brv.period2)
    dv, gapv = brv.symbol_delay_detect, brv.period1 - brv.period2
    sd_v = (_shift(boxv, dv + gapv) - _shift(boxv, dv)) / brv.period2
    allowed["mask_v"] = near(sd_v, thr["nfcv"] * env, 4 * e_val / brv.period2)

    assert set(allowed) == {k for k, v in ref.items() if v.dtype == np.bool_}
    for name, ok in allowed.items():
        excused = ok | gate_near | taint
        differ = got[name] != ref[name]
        assert not (differ & ~excused).any(), (
            f"{name}: {int((differ & ~excused).sum())} samples differ")
        assert excused.mean() < 0.1, name
    # the masks fire: (at T = 512 no NFC-V window is long enough for V)
    assert sum(ref[name].any() for name in allowed) >= 7


def test_jitted_frontend_is_cached_and_runs_on_its_device():
    from nfclab_torch.dsp import conditioner_kernel as ck
    from nfclab_torch.dsp.frontend import jitted_frontend

    fn = jitted_frontend(RATE, device="cpu")
    assert jitted_frontend(RATE, device="cpu") is fn
    x = mixed_lanes(3, 700, seed=2)
    before = ck.COND.launches
    out = fn(x)  # a numpy array, as nfclab's callers pass
    assert ck.COND.launches == before  # CPU: the plain version
    assert all(v.device.type == "cpu" and v.shape == (3, 700)
               for v in out.values())
    same = fn(torch.from_numpy(x))
    assert all(torch.equal(out[k], same[k]) for k in out)


@pytest.mark.parametrize("build", ["make_frontend", "jitted_frontend"])
def test_frontend_raises_without_a_card(monkeypatch, build):
    """Without a card the frontend is refused unless the caller asks for
    the CPU: a numpy input never lands on the CPU by itself."""
    from nfclab_torch.dsp import frontend
    from nfclab_torch.dsp.cuda_channels import DeviceUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {"make_frontend": lambda: frontend.make_frontend(_params()),
            "jitted_frontend": lambda: frontend.jitted_frontend(RATE)}[build]
    with pytest.raises(DeviceUnavailable):
        make()
