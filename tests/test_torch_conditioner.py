"""The port's conditioning kernel module and device conditioner on the CPU
(the kernel's plain version):

- ``condition_scan_plain`` bit-exact with the C++ oracle (the port's
  ``condition_exact``) on streams that start from env = 0, pause the field
  past the 10-ETU silence timeout and sit near the power gate; two chained
  calls, the second from the first's last column with its non-zero clock
  and pulse count, equal one call over the whole span bit for bit;
- ``condition_scan`` against nfclab's ``condition_scan_pallas`` in TPU
  interpret mode (B = 1024, T = 512: two 256-sample time tiles, so its
  carry crosses grid steps) from a seeded random initial state.  XLA:CPU
  contracts FMAs in interpret mode, so f32 outputs compare at
  torch_parity's rtol 1e-5, atol 1e-6; a stream is compared only up to its
  first envelope decision within 1e-4 (relative) of 0.05, and pulse
  exactly up to there.  The Pallas call takes about 7 s here;
- ``condition_jax(device="cpu")`` bit-exact with the oracle on all eight
  ``Conditioned`` arrays, on a synthetic capture and on nfclab's
  carrier-off input (test_conditioner.py) with at least one repaired
  block, and within nfclab's own CPU tolerance of nfclab's
  ``condition_jax`` (rtol 1e-4, atol 1e-6: XLA:CPU contracts FMAs in its
  scan);
- ``_edge_track_native`` (the native library's carrier edge tracker,
  which ``condition_jax`` runs) with peak bits and times identical to the
  copied per-event loop ``_edge_tracker`` on crafted filtered arrays
  (``test_native_edge_tracker_equals_copied_loop``), and
  ``condition_jax``'s ``edge_native`` counter: one a capture where the
  native library loads, none (the loop, the same eight arrays) where it
  does not.
"""

import numpy as np
import pytest
import torch

import torch_synth
from torch_synth import mixed_lanes

RATE = 10_000_000
ARRAYS = ("value", "envelope", "filtered", "deviation", "average",
          "mod_depth", "edge_peak", "edge_time")


def _params(rate=RATE):
    from nfclab_torch.core.params import SignalParams

    return SignalParams(rate)


def _pt(rate=RATE):
    from nfclab_torch.dsp.frontend import _params_tuple

    return _params_tuple(_params(rate))


def _native_ok():
    from nfclab_torch.native.binding import native_available

    return native_available()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _fresh(b):
    z = torch.zeros(b, dtype=torch.float32)
    zi = torch.zeros(b, dtype=torch.int32)
    return z, z, z, z, zi, zi


def _oracle_lanes(n=4096):
    rng = np.random.default_rng(3)
    x = np.full((5, n), 0.5, np.float32)
    x += (0.004 * rng.standard_normal(x.shape)).astype(np.float32)
    x[0, 1200:2600] = 0.0        # field off past the 10*ETU silence timeout
    x[1, :300] = 0.0             # env stays 0 past the seeding window
    x[2] *= np.float32(0.021)    # carrier near the power gate
    x[3, 500:3500:7] = 0.01      # sparse pauses
    x[4] = mixed_lanes(1, n, seed=9)[0]
    return x


@pytest.mark.parametrize("split", [40, 1500, 3000])
def test_condition_scan_plain_bit_exact_with_oracle(split):
    """One call from a fresh state equals the oracle; a second call from
    the first's last column at `split` (clock `split`, inside the seeding
    window at 40 and past the silence timeout of lane 0 at 1500) equals
    the oracle's tail, bit for bit."""
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfclab_torch.dsp.conditioner_kernel import condition_scan_plain
    from nfclab_torch.native import condition_exact

    x = _oracle_lanes()
    pt = _pt()
    xt = torch.from_numpy(x)
    whole = condition_scan_plain(xt, *_fresh(len(x)), pt)
    first = condition_scan_plain(xt[:, :split], *_fresh(len(x)), pt)
    env, w1, mdev, avg, _, pulse = (o[:, -1].contiguous() for o in first)
    clock = torch.full((len(x),), split, dtype=torch.int32)
    if split == 1500:
        assert int(pulse[0]) > 0   # lane 0 carries a running pause count
    second = condition_scan_plain(xt[:, split:], env, w1, mdev, avg, pulse,
                                  clock, pt)
    for a, b, c in zip(whole, first, second):
        assert np.array_equal(_bits(a.numpy()),
                              _bits(torch.cat([b, c], 1).numpy()))
    names = ("envelope", "w1", "deviation", "average", "filtered")
    for i in range(len(x)):
        ref = condition_exact(x[i], _params())
        for name, out in zip(names, whole[:5]):
            if name == "w1":
                continue
            assert np.array_equal(_bits(out[i].numpy()),
                                  _bits(getattr(ref, name))), (name, i)


def test_condition_scan_dispatch_and_checks():
    """A CPU tensor takes the plain version and counts no launch; the
    wrappers refuse other devices, dtypes and shapes."""
    from nfclab_torch.dsp import conditioner_kernel as ck

    x = torch.from_numpy(mixed_lanes(3, 300, seed=1))
    before = ck.COND.launches
    got = ck.condition_scan(x, *_fresh(3), _pt())
    want = ck.condition_scan_plain(x, *_fresh(3), _pt())
    assert ck.COND.launches == before
    assert [o.dtype for o in got] == [torch.float32] * 5 + [torch.int32]
    assert all(o.shape == (3, 300) for o in got)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    z, _, _, _, zi, _ = _fresh(3)
    with pytest.raises(TypeError, match="int32"):
        ck.condition_scan(x, z, z, z, z, z, zi, _pt())
    with pytest.raises(ValueError, match=r"\[3\]"):
        ck.condition_scan(x, *_fresh(4), _pt())
    meta = [t.to("meta") for t in _fresh(3)]
    with pytest.raises(ValueError, match="unsupported device"):
        ck.condition_scan(x.to("meta"), *meta, _pt())


def _tainted(x, env, env0, margin=1e-4):
    """[B, T] bool: True from the first sample whose envelope update
    decision (|v - env|/env < 0.05) lies within `margin` (relative) of its
    threshold; env0 is the envelope before the first sample."""
    prev = np.concatenate([env0[:, None], env[:, :-1]], 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        diff = np.abs(x - prev) / prev
    thr = np.float32(0.05)
    return np.cumsum(np.abs(diff - thr) <= margin * thr, axis=1) > 0


def test_condition_scan_matches_pallas_interpret():
    """Stream b of nfclab's [G, 8, 128] initial-state tiles is row b of
    its [B] inputs (reshape order), so the port's [B] rows go in
    unchanged."""
    from jax.experimental.pallas import tpu as pltpu

    from nfclab.dsp.pallas.conditioner_kernel import condition_scan_pallas
    from nfclab_torch.dsp.conditioner_kernel import condition_scan

    b, t = 1024, 512
    etu = _params().elementary_time_unit
    x = mixed_lanes(b, t, seed=21)
    rng = np.random.default_rng(22)
    init = (
        (x[:, 0] * rng.uniform(0.9, 1.1, b)).astype(np.float32),
        (x[:, 0] * 10.0).astype(np.float32),
        rng.uniform(0.0, 1e-3, b).astype(np.float32),
        x[:, 0].copy(),
        rng.integers(0, 20 * etu, b).astype(np.int32),
        rng.integers(0, 3 * etu, b).astype(np.int32),
    )
    pt = _pt()
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(o) for o in condition_scan_pallas(x, *init, pt)]
    got = [o.numpy() for o in condition_scan(
        torch.from_numpy(x), *(torch.from_numpy(a) for a in init), pt)]
    taint = _tainted(x, ref[0], init[0])
    assert taint[:, -1].mean() <= 0.01, "too many tainted streams"
    for name, a, r in zip(("env", "w1", "mdev", "avg", "filt"), got, ref):
        bad = ~np.isclose(a, r, rtol=1e-5, atol=1e-6, equal_nan=True)
        assert not (bad & ~taint).any(), name
    assert np.array_equal(np.where(taint, 0, got[5]),
                          np.where(taint, 0, ref[5]))
    assert (got[5] != 0).any() and (got[5] == 0).any()


def _check_condition_jax(x, **kw):
    from nfclab.core.params import SignalParams as RefParams
    from nfclab.dsp.conditioner import condition_jax as ref_condition_jax
    from nfclab_torch.dsp.conditioner import condition_jax
    from nfclab_torch.native import condition_exact

    stats = {}
    got = condition_jax(x, _params(), device="cpu", stats=stats, **kw)
    want = condition_exact(x, _params())
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(_bits(a), _bits(b)), name
    # nfclab's own device conditioner on the CPU, at its CPU tolerance
    ref = ref_condition_jax(x, RefParams(RATE), **kw)
    for name in ARRAYS[1:]:
        a, b = getattr(got, name), getattr(ref, name)
        if name == "edge_time":
            assert np.array_equal(a, b)
        else:
            m = np.isfinite(a) & np.isfinite(b)
            np.testing.assert_allclose(a[m], b[m], rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    return stats


def test_condition_jax_bit_exact_synth():
    """A synthetic capture (NFC-A poll + listen, then NFC-V) in four
    blocks of 32768 with a 4096-sample halo."""
    if not _native_ok():
        pytest.skip("native library unavailable")
    tp = torch_synth.templates()
    x = np.concatenate([tp[0].samples, tp[4].samples[:60_000]])
    stats = _check_condition_jax(x, block=32768, halo=4096)
    assert stats["blocks"] == 4
    assert stats["edge_tracker_s"] >= 0.0


def test_condition_jax_repair_path():
    """nfclab's carrier-off input (tests/test_conditioner.py): a 200k
    field-off stretch defeats the halo, so blocks are repaired."""
    if not _native_ok():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(1)
    n = 300_000
    x = np.zeros(n, np.float32)
    x[:50_000] = 0.35 + 0.01 * rng.standard_normal(50_000)
    x[50_000:250_000] = 0.002 * rng.standard_normal(200_000)
    x[250_000:] = 0.35 + 0.01 * rng.standard_normal(n - 250_000)
    x = x.astype(np.float32)
    stats = _check_condition_jax(x, block=32768, halo=8192)
    assert stats["blocks"] == 10
    assert stats["repairs"] >= 1


def test_condition_jax_needs_a_card_unless_asked_for_cpu(monkeypatch):
    from nfclab_torch.dsp.conditioner import condition_jax
    from nfclab_torch.dsp.cuda_channels import DeviceUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.full(1000, 0.5, np.float32)
    with pytest.raises(DeviceUnavailable):
        condition_jax(x, _params())
    with pytest.raises(ValueError, match="at least 1"):
        condition_jax(x, _params(), halo=0, device="cpu")


def _edge_case(name, lo, hi):
    """A crafted filtered array for the edge tracker; `lo` and `hi` are the
    low and high thresholds as float32."""
    f = np.float32
    if name == "field_off":
        return np.zeros(4096, f)
    if name == "at_low":
        # |x| == low is no reset; just below it is
        return np.array([hi * 2, lo, -lo, hi * 3, np.nextafter(lo, f(0)),
                         hi * 1.5, -lo, 0.0, hi * 1.2], f)
    if name == "at_high":
        # |x| == high is no event; just above it is
        return np.array([hi, -hi, np.nextafter(hi, f(1)), hi, -hi,
                         -np.nextafter(hi, f(1)), lo * 0.5, hi, -hi], f)
    if name == "equal_peaks":
        # a strict > keeps the first time of equal peaks
        return np.array([hi * 2, -hi * 2, hi * 2, hi * 1.5, hi * 2, -hi * 2],
                        f)
    if name == "low_resets_rise":
        return np.array([hi * 1.1, hi * 1.5, hi * 3, (lo + hi) / 2, lo / 4,
                         hi * 1.2, hi * 1.4, -hi * 1.3], f)
    if name == "ends_in_peak":
        x = np.zeros(2000, f)
        x[1990:] = hi * np.linspace(1.1, 4.0, 10, dtype=f)
        return x
    if name == "length_1":
        return np.array([-hi * 2], f)
    if name == "all_high":
        rng = np.random.default_rng(5)
        x = hi * (1.0 + rng.random(3000)).astype(f)
        return (x * rng.choice(np.array([-1, 1], f), 3000)).astype(f)
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "field_off", "at_low", "at_high", "equal_peaks", "low_resets_rise",
    "ends_in_peak", "length_1", "all_high", "mixed_lanes"])
def test_native_edge_tracker_equals_copied_loop(name):
    """The native tracker condition_jax runs gives the copied per-event
    loop's peak bits and times; on mixed_lanes (events at most samples)
    also the C++ oracle's own edge_peak and edge_time."""
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfclab_torch.dsp.conditioner import _edge_track_native, _edge_tracker
    from nfclab_torch.native import condition_exact

    p = _params()
    lo = np.float32(p.signal_low_threshold)
    hi = np.float32(p.signal_high_threshold)
    want = None
    if name == "mixed_lanes":
        c = condition_exact(mixed_lanes(8, 8192, seed=31).reshape(-1), p)
        filt, want = c.filtered, (c.edge_peak, c.edge_time)
    else:
        filt = _edge_case(name, lo, hi)
    peak, etime = _edge_track_native(filt, p)
    ref_peak, ref_time = _edge_tracker(filt, p)
    assert peak.dtype == ref_peak.dtype == np.float32
    assert etime.dtype == ref_time.dtype == np.uint32
    assert np.array_equal(_bits(peak), _bits(ref_peak))
    assert np.array_equal(etime, ref_time)
    if want is not None:
        assert np.array_equal(_bits(peak), _bits(want[0]))
        assert np.array_equal(etime, want[1])
        rect = np.abs(filt)
        assert ((rect > hi) | (rect < lo)).mean() > 0.5


@pytest.mark.parametrize("native", [True, False])
def test_condition_jax_counts_native_edge_tracker(native, monkeypatch):
    """edge_native counts the captures whose edges the native tracker
    computed: one a call where the library loads, none where it does not
    (the copied loop runs), and the eight arrays equal the oracle's."""
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfclab_torch.dsp.conditioner import condition_jax
    from nfclab_torch.native import binding, condition_exact

    x = mixed_lanes(1, 20_000, seed=41)[0]
    want = condition_exact(x, _params())
    if not native:
        monkeypatch.setattr(binding, "native_available", lambda: False)
    stats = {}
    for _ in range(2):
        got = condition_jax(x, _params(), block=8192, halo=2048,
                            device="cpu", stats=stats)
        for name in ARRAYS:
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(_bits(a), _bits(b)), name
    assert stats["edge_native"] == (2 if native else 0)
    assert stats["blocks"] == 6
