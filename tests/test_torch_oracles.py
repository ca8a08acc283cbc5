"""nfclab_torch's fused frontend against exact oracles, on the CPU (the
kernels' plain PyTorch versions):

- conditioning bit-exact with the C++ oracle (the port's copy and
  nfclab's), over a field-off pause long enough to fire the silence timeout;
- detect_mask equal to the bits recomputed in numpy from the port's own
  envelope, filtered and box outputs;
- chunked runs equal to one monolithic run, and selected outputs equal to
  the full run, bit for bit;
- the carried state's layout, section by section;
- the geometry and key tables equal to nfclab's at several rates;
- the engine helpers: grid upload, on-device compaction, overflow rows,
  and no CPU fallback when CUDA is asked for.
"""

import numpy as np
import pytest
import torch

from torch_synth import mixed_lanes

RATE = 10_000_000


def _native_ok():
    from nfclab_torch.native.binding import native_available

    return native_available()


def _params(rate=RATE):
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.core.thresholds import DecoderThresholds
    from nfclab_torch.dsp.frontend import _params_tuple

    return (_params_tuple(SignalParams(rate)),
            DecoderThresholds().detect_mask_tuple(0.01))


def _run(x, select=None, state=None, base=0, rate=RATE):
    from nfclab_torch.dsp.fused_frontend import fused_frontend

    pt, mp = _params(rate)
    return fused_frontend(torch.from_numpy(np.ascontiguousarray(x)), pt,
                          mask_params=mp, state=state, base=base,
                          return_state=True, select=select, sample_rate=rate)


def _bits_equal(a, b) -> bool:
    """Same float32 bit patterns (any NaN equal to any NaN)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a) & np.isnan(b)
    return bool(((a.view(np.uint32) == b.view(np.uint32)) | nan).all())


def _oracle_lanes(n=4096):
    rng = np.random.default_rng(3)
    x = np.full((5, n), 0.5, np.float32)
    x += (0.004 * rng.standard_normal(x.shape)).astype(np.float32)
    x[0, 1200:2600] = 0.0        # field off past the 10*ETU silence timeout
    x[1, :300] = 0.0             # field comes on after the seeding window
    x[2] *= np.float32(0.021)    # carrier near the power gate
    x[3, 500:3500:7] = 0.01      # sparse pauses
    x[4] = mixed_lanes(1, n, seed=9)[0]
    return x


@pytest.mark.parametrize("oracle", ["nfclab_torch", "nfclab"])
def test_conditioning_bit_exact_with_cpp_oracle(oracle, tmp_path):
    if not _native_ok():
        pytest.skip("native library unavailable")
    import importlib

    if oracle == "nfclab":
        from torch_native import use_ref_native

        use_ref_native(tmp_path)

    from nfclab_torch.core.params import SignalParams

    native = importlib.import_module(f"{oracle}.native")
    x = _oracle_lanes()
    res, _ = _run(x)
    params = SignalParams(RATE)
    for i in range(len(x)):
        c = native.condition_exact(x[i], params)
        for name in ("envelope", "filtered", "deviation", "average",
                     "mod_depth"):
            assert _bits_equal(res[name][i].numpy(), getattr(c, name)), (
                name, i)


def _numpy_mask(out, mp, plan):
    """detect_mask from the outputs of fresh streams, in numpy float32
    with the kernel's operation order (zero history before sample 0)."""
    f32 = np.float32
    power_thr, a_thr, b_deep, f_thr, v_thr = (f32(m) for m in mp)
    env = out["envelope"]
    b, n = env.shape
    pad = max(plan.h_sizes) + 1

    def lag(name, c):
        ext = np.concatenate([np.zeros((b, pad), f32), out[name]], 1)
        return ext[:, pad - c : pad - c + n]

    ok = env >= power_thr
    m = np.zeros((b, n), np.int32)
    for r, (d, gap, p2, wi) in enumerate(plan.a_rates):
        nm = f"bv{plan.bv_widths[wi]}"
        b0, b1, bg = lag(nm, d), lag(nm, d + 1), lag(nm, d + gap)
        sd = ((b0 - bg) - (bg - b1)) / f32(p2)
        m += np.where(ok & (np.abs(sd) > a_thr * env), 1 << r, 0)
    for r, (d, gap, p2, wi) in enumerate(plan.f_rates):
        nm = f"bv{plan.bv_widths[wi]}"
        b0, b1, bg = lag(nm, 0), lag(nm, 1), lag(nm, gap)
        sd = ((b0 - bg) - (bg - b1)) / f32(p2)
        m += np.where(ok & (np.abs(sd) > f_thr * env), 32 << r, 0)
    for r, d in enumerate(plan.b_delays):
        m += np.where(ok & (lag("filtered", d) < -(b_deep * env)), 8 << r, 0)
    dv, gapv, p2v, wv = plan.v_rate
    nm = f"bv{plan.bv_widths[wv]}"
    sd_v = (lag(nm, dv + gapv) - lag(nm, dv)) / f32(p2v)
    m += np.where(ok & (sd_v > v_thr * env), 128, 0)
    return m.astype(np.uint8)


def test_detect_mask_equals_numpy_recomputation():
    from nfclab_torch.dsp.fused_frontend import kernel_plan

    x = mixed_lanes(96, 1024, seed=4)
    r1, st = _run(x[:, :512], base=40)
    r2, _ = _run(x[:, 512:], state=st, base=552)
    out = {k: np.concatenate([r1[k].numpy(), r2[k].numpy()], 1) for k in r1}
    want = _numpy_mask(out, _params()[1], kernel_plan(RATE))
    assert (want != 0).sum() > 500
    assert np.array_equal(out["detect_mask"], want)


@pytest.mark.parametrize("select", [None, ("detect_mask",),
                                    ("q189", "envelope", "mod_depth")])
def test_chunked_equals_monolithic(select):
    x = mixed_lanes(64, 1024, seed=6)
    mono, st_mono = _run(x, select=select, base=8)
    st, parts, off = None, [], 0
    for n in (256, 128, 384, 256):
        r, st = _run(x[:, off : off + n], select=select, state=st,
                     base=8 + off)
        parts.append(r)
        off += n
    for k in mono:
        assert _bits_equal(torch.cat([p[k] for p in parts], 1).float(),
                           mono[k].float()), k
    assert _bits_equal(st, st_mono)


def test_stream_equals_monolithic():
    from nfclab_torch.dsp.fused_frontend import fused_frontend_stream

    x = mixed_lanes(16, 1024, seed=10)
    pt, mp = _params()
    mono, _ = _run(x)
    parts = list(fused_frontend_stream(torch.from_numpy(x), pt, chunk=384,
                                       mask_params=mp))
    assert [off for off, _ in parts] == [0, 384, 768]
    for k in mono:
        got = torch.cat([r[k] for _, r in parts], 1)
        assert _bits_equal(got.float(), mono[k].float()), k


def test_selection_does_not_change_values_or_state():
    x = mixed_lanes(32, 512, seed=8)
    full, st_full = _run(x)
    for select in (("detect_mask",), ("p94x24", "average"), ("bv12",)):
        part, st = _run(x, select=select)
        assert set(part) == set(select)
        for k in select:
            assert _bits_equal(part[k].float(), full[k].float()), k
        assert _bits_equal(st, st_full)


def test_state_layout():
    """Carry rows 0-4 (env, w1, mdev, avg, pcount; 5-7 zero); rings
    indexed by the absolute clock t & (ring-1); each history section the
    last h + 128 values of its channel, oldest first; then the sums."""
    from nfclab_torch.dsp.fused_frontend import TILE, kernel_plan

    plan = kernel_plan(RATE)
    base, n = 296, 640
    x = mixed_lanes(16, n, seed=12)
    out, st = _run(x, base=base)
    out = {k: v.numpy() for k, v in out.items()}
    st = st.numpy()
    secs = plan.state_sections
    carry = st[:, 0:8]
    assert np.array_equal(carry[:, 0], out["envelope"][:, -1])
    assert np.array_equal(carry[:, 2], out["deviation"][:, -1])
    assert np.array_equal(carry[:, 3], out["average"][:, -1])
    assert np.all(carry[:, 4] == np.floor(carry[:, 4]))
    assert not carry[:, 5:8].any()

    def ring(vals, r):
        want = np.zeros((len(vals), r), np.float32)
        for j in range(n - r, n):
            want[:, (base + j) & (r - 1)] = vals[:, j]
        return want

    off, ln = secs[1]
    assert np.array_equal(st[:, off : off + ln], ring(x, plan.rv_ring))
    off, ln = secs[2]
    assert np.array_equal(st[:, off : off + ln],
                          ring(out["filtered"], plan.rf_ring))
    n_rp = len(plan.rp_rings)
    chans = [f"bv{w}" for w in plan.bv_widths] + ["filtered"]
    for (off, ln), name, h in zip(secs[4 + n_rp : 4 + n_rp + len(chans)],
                                  chans, plan.h_sizes):
        assert ln == h + TILE
        assert np.array_equal(st[:, off : off + ln], out[name][:, -ln:])
    names = ([f"bv{w}" for w in plan.bv_widths]
             + [f"q{w}" for w in plan.q_widths]
             + [f"p{lag}x{box}" for lag, box in plan.pb])
    off, ln = secs[-1]
    assert ln == len(names)
    for k, name in enumerate(names):
        assert np.array_equal(st[:, off + k], out[name][:, -1])


def test_envelope_seeding_depends_on_base():
    """Fresh state: the envelope takes v while the absolute clock is below
    ETU; from a base past ETU it stays 0 (|v-env|/env is inf, never below
    0.05) until the silence counter passes 10*ETU."""
    from nfclab_torch.core.params import SignalParams

    etu = SignalParams(RATE).elementary_time_unit
    x = np.full((1, 1152), 0.5, np.float32)
    seeded, _ = _run(x, base=0)
    assert seeded["envelope"][0, 0] == np.float32(0.5)
    late, _ = _run(x, base=etu + 10)
    env = late["envelope"][0].numpy()
    first = int(np.flatnonzero(env)[0])
    assert first == etu * 10  # pcount 1..940 never passes 940
    assert torch.isnan(late["mod_depth"][0, 0])  # (0 - 0) / 0


def test_geometry_and_tables_match_nfclab():
    import nfclab.dsp.pallas.fused_frontend as jff
    import nfclab.dsp.tpu_channels as jtc
    import nfclab_torch.dsp.cuda_channels as cc
    import nfclab_torch.dsp.fused_frontend as ff

    for rate in (3_200_000, 8_000_000, 10_000_000, 12_000_000):
        assert tuple(ff.kernel_plan(rate)) == tuple(jff.kernel_plan(rate))
        assert ff.kernel_plan(rate).nstate == jff.kernel_plan(rate).nstate
        assert cc.channel_plan(rate) == jtc.channel_plan(rate)
        assert cc.box_keys(rate) == jtc.box_keys(rate)
        assert cc.fetch_names(rate) == jtc.fetch_names(rate)
        assert cc.idx_key_map(rate, 0.01) == jtc.idx_key_map(rate, 0.01)
    assert ff.MASK_LAYOUT == jff.MASK_LAYOUT
    assert list(ff.OUTPUT_NAMES) == list(jff.OUTPUT_NAMES)
    assert ff.OUTPUT_DTYPES == jff.OUTPUT_DTYPES
    assert ff.NSTATE == jff.NSTATE == 2109
    assert cc.chained_mask_params(0.01) == jtc.chained_mask_params(0.01)
    assert (cc.MASK_ONLY_MARGIN, cc.CHAIN_CHUNK, cc._WARMUP) == (
        jtc.MASK_ONLY_MARGIN, jtc.CHAIN_CHUNK, jtc._WARMUP)


def test_unpack_detect_mask():
    from nfclab_torch.dsp.fused_frontend import MASK_LAYOUT, unpack_detect_mask

    m = torch.arange(256, dtype=torch.uint8)
    bits = unpack_detect_mask(m)
    assert set(bits) == {n for n, _ in MASK_LAYOUT}
    for name, w in MASK_LAYOUT:
        assert torch.equal(bits[name], (torch.arange(256) & w) != 0)


@pytest.mark.parametrize("depth", [8, 16, 0])
def test_upload_samples_grid(depth):
    from nfclab_torch.dsp.cuda_channels import _grid_codes, upload_samples

    rng = np.random.default_rng(depth)
    if depth:
        codes = rng.integers(-(1 << (depth - 1)), 1 << (depth - 1),
                             (3, 999))
        x = (codes * 2.0 ** -(depth - 1)).astype(np.float32)
    else:
        x = rng.standard_normal((3, 999)).astype(np.float32)
    grid = _grid_codes(x)
    if depth == 8:
        assert grid[0].dtype == np.int8 and grid[1] == 7
    elif depth == 16:
        assert grid[0].dtype == np.int16 and grid[1] == 15
    else:
        assert grid is None
    got = upload_samples(x, "cpu")
    assert got.dtype == torch.float32
    assert _bits_equal(got.numpy(), x)


def test_compact_matches_nonzero():
    from nfclab_torch.dsp.cuda_channels import _compact

    rng = np.random.default_rng(1)
    mm = (rng.random((5, 3000)) < 0.01) * rng.integers(1, 256, (5, 3000))
    mm[2] = 0
    mm[3, ::2] = 7                     # 1500 triggers > cap
    mm = torch.from_numpy(mm.astype(np.uint8))
    cap = 64
    idx, bits, cnt = _compact(mm, cap)
    for i in range(5):
        nz = np.flatnonzero(mm[i].numpy())
        assert int(cnt[i]) == len(nz)
        k = min(cap, len(nz))
        assert np.array_equal(idx[i, :k].numpy(), nz[:k])
        assert (idx[i, k:] == -1).all()
        assert np.array_equal(bits[i, :k].numpy(), mm[i].numpy()[nz[:k]])
        assert (bits[i, k:] == 0).all()


def test_run_chained_masks_overflow_row():
    """A row with more triggers than the cap takes its dense mask row; a
    sparse row its compacted prefix; both equal one direct pass."""
    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.dsp.fused_frontend import fused_frontend, kernel_plan

    rng = np.random.default_rng(2)
    t = 8192
    x = np.empty((2, t), np.float32)
    x[0] = rng.uniform(0.0, 1.0, t)                 # dense triggers
    x[1] = mixed_lanes(1, t, seed=3)[0]
    pt, _ = _params()
    mp = cc.chained_mask_params(0.01)
    state = cc.chain_state0(3, device="cpu")
    out, st = cc.run_chained_masks(x, state, 0, pt, mp, chunk=4096)
    assert st.shape == (3, kernel_plan(RATE).nstate)
    want = fused_frontend(torch.from_numpy(x), pt, mask_params=mp,
                          select=("detect_mask",))["detect_mask"].numpy()
    assert np.count_nonzero(want[0]) > max(4096, t // 16)
    for i in range(2):
        nz = np.flatnonzero(want[i])
        assert np.array_equal(out[i][0], nz)
        assert np.array_equal(out[i][1], want[i][nz])


def test_cuda_requested_without_card_raises(monkeypatch):
    from nfclab_torch.dsp import cuda_channels as cc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.full(4096, 0.5, np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cc.chained_batch_masks([x], RATE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cc.fused_capture_masks(x, RATE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cc.chain_state0()


def test_wrappers_reject_other_devices():
    from nfclab_torch.dsp import fused_frontend as ff

    plan = ff.kernel_plan(RATE)
    pt, mp = _params()
    x = torch.zeros(128, 4, device="meta")
    st = torch.zeros(plan.nstate, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ff.fused_scan(x, st, 0, pt, plan)
    with pytest.raises(ValueError, match="multiple of 128"):
        ff.fused_frontend(torch.zeros(4, 100), pt)
    with pytest.raises(ValueError, match="nstate"):
        ff.fused_frontend(torch.zeros(4, 128), pt,
                          state=torch.zeros(4, 7))
