"""The port's full-channel device frontend on the CPU (the kernels' plain
versions): dsp/cuda_channels.py's exact chained runner
(``_run_batch_chained``, ``fused_capture_all``, ``fused_batch_all``), the
overlap-save block layout (``_run_batch_blocks``, ``fused_capture_channels``)
and dsp/frontend.py's ``make_fused_frontend``.

- Layout, exact: nfclab's and the port's runners under one deterministic
  stand-in for the kernels (each output x*k + base + lane, the state passed
  through), over captures of unequal lengths that are not multiples of the
  chunk, one shorter than H + L, block sizes that split a capture into
  several blocks, in an unsorted caller order.
- Numerics: nfclab's ``_run_batch_chained`` with its Pallas kernel in TPU
  interpret mode (512-sample chunks) against the port's, at
  torch_parity.py's tolerances and taint rule.
- Oracle and frames: ``fused_capture_all``'s eight arrays bit for bit
  against the C++ oracle, and the frames of ``fused_capture_all`` and
  ``fused_capture_channels`` equal to the host frontend's and the bytes the
  synthesizer wrote, on one capture of each template.  The captures are
  ``torch_synth.lane`` copies of the templates (seeded gain, offset and
  2e-4 noise): on the noise-free NFC-B template the kernel's float32
  BPSK product box p94x24 and the host's float64 one part by 3.6e-6, and
  the listen search's test against a deviation of ~1e-22 takes that
  residual for a phase (test_noise_free_nfcb_divergence_is_the_product_box
  pins the cause; ROADMAP Queue 3).
- A cuda-marked test holds ``fused_batch_all`` on the card to its CPU run.
"""

import numpy as np
import pytest
import torch

import torch_parity as tpar
import torch_synth

RATE = torch_synth.RATE
TEMPLATES = torch_synth.templates()
NAMES = [tp.name for tp in TEMPLATES]


def _native_ok():
    from nfclab_torch.native.binding import native_available

    return native_available()


def _all_names():
    from nfclab_torch.dsp.cuda_channels import _COND_FETCH, fetch_names

    return fetch_names(RATE) + _COND_FETCH


# --------------------------------------------------------------------------
# layout: both packages' runners under one stand-in for the kernels

_K = {name: float(k + 2) for k, name in enumerate(
    ("envelope", "filtered", "deviation", "average", "mod_depth", "bv12",
     "bv24", "bv47", "bv94", "q47", "q189", "p24x6", "p47x12", "p94x24"))}


def _standin_jax(value, params, native_layout=True, mask_params=None,
                 state=None, base=0, return_state=False, select=None,
                 sample_rate=RATE, **_):
    """nfclab's fused_frontend replaced: [B, T] rows, lane = row."""
    import jax.numpy as jnp

    b, _t = value.shape
    lane = jnp.arange(b, dtype=jnp.int32)[:, None]
    res = {}
    for name in select:
        if name == "detect_mask":
            code = jnp.round(value * 64.0).astype(jnp.int32)
            res[name] = ((code + base + lane) % 256).astype(jnp.uint8)
        else:
            res[name] = value * jnp.float32(_K[name]) + (
                base + lane).astype(jnp.float32)
    if return_state:
        if state is None:
            state = jnp.zeros((1, 8, 8, 128), jnp.float32)
        return res, state
    return res


def _standin_port(value_tm, state_sm, base, pt, mp, plan, sel):
    """The port's run_chunk replaced: time-major [T, B], lane = column."""
    _t, b = value_tm.shape
    lane = torch.arange(b, dtype=torch.int32)[None, :]
    outs = {}
    for name in sel:
        if name == "detect_mask":
            code = torch.round(value_tm * 64.0).to(torch.int32)
            outs[name] = ((code + base + lane) % 256).to(torch.uint8)
        else:
            outs[name] = value_tm * _K[name] + (base + lane).to(
                torch.float32)
    return outs, state_sm


def _grid_captures(lengths, seed):
    """Captures on a 1/64 grid (every stand-in output is exact in f32)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(-60, 60, n) / 64.0).astype(np.float32)
            for n in lengths]


@pytest.fixture
def standin(monkeypatch):
    import nfclab.dsp.pallas.fused_frontend as jff

    from nfclab_torch.dsp import fused_frontend as ff

    monkeypatch.setattr(jff, "fused_frontend", _standin_jax)
    monkeypatch.setattr(ff, "run_chunk", _standin_port)


LAYOUT_LENGTHS = (1500, 333, 2048, 1025, 90)


@pytest.mark.parametrize("chunk", [128, 512])
def test_chained_layout_equals_nfclab(standin, chunk):
    """Sorted lanes, live prefixes, ragged suffixes, the per-capture
    reassembly and caller order: equal arrays, name for name."""
    from conftest import ensure_cpu_devices

    import nfclab.dsp.tpu_channels as jtc
    from nfclab_torch.dsp import cuda_channels as cc

    ensure_cpu_devices()
    caps = _grid_captures(LAYOUT_LENGTHS, seed=3)
    names = _all_names()
    want = jtc._run_batch_chained(caps, RATE, 0.01, names, chunk=chunk)
    got = cc._run_batch_chained(caps, RATE, 0.01, names, chunk=chunk,
                                device="cpu")
    assert len(got) == len(want) == len(caps)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == set(names)
        for name in names:
            assert g[name].dtype == w[name].dtype, name
            assert len(g[name]) == len(caps[i]), name
            assert np.array_equal(g[name], w[name]), (i, name)
    # caller order: capture i's outputs carry its own samples, and its
    # lane is its rank by length
    rank = sorted(range(len(caps)), key=lambda i: -len(caps[i]))
    for i, cap in enumerate(caps):
        resid = got[i]["envelope"] - cap * np.float32(_K["envelope"])
        lane = resid - np.arange(len(cap)) // chunk * chunk
        assert np.all(lane == rank.index(i)), i


@pytest.mark.parametrize("L,H", [(384, 128), (256, 256), (896, 128)])
def test_blocks_layout_equals_nfclab(standin, L, H):
    """Block rows (row 0 = samples[:H+L], row i = samples[i*L-H : i*L+L]),
    bodies sliced at H, a capture shorter than H + L and one of zero
    length after it: equal arrays, name for name."""
    from conftest import ensure_cpu_devices

    import nfclab.dsp.tpu_channels as jtc
    from nfclab_torch.dsp import cuda_channels as cc

    ensure_cpu_devices()
    caps = _grid_captures(LAYOUT_LENGTHS + (0,), seed=4)
    names = cc.fetch_names(RATE)
    want = jtc._run_batch_blocks(caps, RATE, 0.01, L, H, names)
    got = cc._run_batch_blocks(caps, RATE, 0.01, L, H, names, device="cpu")
    assert len(got) == len(want) == len(caps)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == set(names)
        for name in names:
            assert g[name].dtype == w[name].dtype, name
            assert np.array_equal(g[name], w[name]), (i, name)
    # the rows really are several blocks: capture 0 spans ceil(1500 / L)
    rows = got[0]["bv12"] - caps[0] * np.float32(_K["bv12"])
    assert len(np.unique(rows)) == -(-LAYOUT_LENGTHS[0] // L)


def test_blocks_refuse_a_ragged_row():
    from nfclab_torch.dsp import cuda_channels as cc

    with pytest.raises(ValueError, match="multiple of 128"):
        cc._run_batch_blocks([np.zeros(100, np.float32)], RATE, 0.01, 100,
                             20, cc.fetch_names(RATE), device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        cc._run_batch_chained([np.zeros(100, np.float32)], RATE, 0.01,
                              _all_names(), chunk=100, device="cpu")


# --------------------------------------------------------------------------
# numerics: nfclab's runner on its Pallas kernel in interpret mode

NUM_LENGTHS = (1024, 700, 901, 512, 333, 1000, 640, 129)


@pytest.fixture(scope="module")
def numerics():
    """(captures, nfclab's outputs, the port's outputs) of one chained
    run of each at 512-sample chunks."""
    from conftest import ensure_cpu_devices
    from jax.experimental.pallas import tpu as pltpu

    import nfclab.dsp.tpu_channels as jtc
    from nfclab_torch.dsp import cuda_channels as cc

    ensure_cpu_devices()
    x = torch_synth.mixed_lanes(len(NUM_LENGTHS), max(NUM_LENGTHS), seed=17)
    caps = [np.ascontiguousarray(x[i, :n]) for i, n in enumerate(NUM_LENGTHS)]
    names = _all_names()
    with pltpu.force_tpu_interpret_mode():
        want = jtc._run_batch_chained(caps, RATE, 0.01, names, chunk=512)
    got = cc._run_batch_chained(caps, RATE, 0.01, names, chunk=512,
                                device="cpu")
    return caps, want, got


def _row(d):
    return {k: np.asarray(v)[None, :] for k, v in d.items()}


def test_chained_numerics_match_nfclab(numerics):
    """Each capture up to its first tainted sample (at most one capture
    cut): the tolerance outputs; the q*/p* sums exactly against each
    implementation's own filtered channel; the mask wherever no deciding
    quantity sits near its threshold."""
    caps, want, got = numerics
    pl = tpar.plan()
    cut = 0
    for cap, w, g in zip(caps, want, got):
        w, g, x = _row(w), _row(g), cap[None, :]
        taint = tpar.tainted(w, x)
        cut += bool(taint[0, -1])
        for name in tpar.TOL_OUTPUTS:
            bad = ~tpar.close(g[name], w[name]) & ~taint
            assert not bad.any(), name
        for impl, out in (("jax", w), ("port", g)):
            sums = tpar.qp_sums(out["filtered"], pl, fma=impl == "jax")
            for name in tpar.exact_sum_names(pl):
                assert np.array_equal(out[name], sums[name]), (impl, name)
        tpar.check_mask(g["detect_mask"], w["detect_mask"], w, x)
    assert cut <= 1


# --------------------------------------------------------------------------
# the C++ oracle and frames, on one capture of each template

_CACHE: dict = {}


def _lane(name):
    tp = TEMPLATES[NAMES.index(name)]
    return tp, torch_synth.lane(tp, len(tp.samples), seed=500 + NAMES.index(
        name))


def _capture_all(name):
    if name not in _CACHE:
        from nfclab_torch.dsp.cuda_channels import fused_capture_all

        tp, (x, reps) = _lane(name)
        _CACHE[name] = fused_capture_all(x, RATE, device="cpu")
    return _CACHE[name]


def _keys(frames):
    from nfclab_torch.apps.decode_cli import frame_json

    return [frame_json(f) for f in frames]


def _check_frames(name, frames, x, reps, tp):
    from nfclab_torch.core.frame import FrameType
    from nfclab_torch.runtime.decoder import NfcDecoder

    host = NfcDecoder().decode(x, RATE)
    assert _keys(frames) == _keys(host)
    keep = (int(FrameType.NfcPollFrame), int(FrameType.NfcListenFrame))
    assert [f.data for f in frames if f.frame_type in keep] == tp.sent * reps


@pytest.mark.parametrize("name", NAMES)
def test_capture_all_conditioning_equals_oracle(name):
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.native import condition_exact

    _, (x, _) = _lane(name)
    cond, chans = _capture_all(name)
    ref = condition_exact(x, SignalParams(RATE))
    for attr in ("value", "envelope", "filtered", "deviation", "average",
                 "mod_depth", "edge_peak", "edge_time"):
        a, b = getattr(cond, attr), getattr(ref, attr)
        assert a.dtype == b.dtype and a.shape == b.shape, attr
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), attr
    from nfclab_torch.dsp.cuda_channels import fetch_names

    assert set(chans) == set(fetch_names(RATE))
    assert all(len(v) == len(x) for v in chans.values())


@pytest.mark.parametrize("name", NAMES)
def test_capture_all_frames(name):
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfclab_torch.runtime.decoder import NfcDecoder

    tp, (x, reps) = _lane(name)
    cond, chans = _capture_all(name)
    frames = NfcDecoder().decode(x, RATE, cond=cond, tpu_channels=chans)
    _check_frames(name, frames, x, reps, tp)


@pytest.mark.parametrize("name", NAMES)
def test_capture_channels_frames(name):
    """The block layout's boxes and mask, native conditioning."""
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfclab_torch.dsp.cuda_channels import fused_capture_channels
    from nfclab_torch.runtime.decoder import NfcDecoder

    tp, (x, reps) = _lane(name)
    chans = fused_capture_channels(x, RATE, device="cpu")
    frames = NfcDecoder().decode(x, RATE, tpu_channels=chans)
    _check_frames(name, frames, x, reps, tp)


def test_batch_all_equals_capture_all():
    """Stacking captures as streams changes nothing: fused_batch_all's
    entry for a capture equals fused_capture_all's, array for array."""
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfclab_torch.dsp.cuda_channels import fused_batch_all

    short = [NAMES[3], NAMES[1]]
    xs = [_lane(n)[1][0] for n in short]
    res = fused_batch_all(xs, RATE, device="cpu")
    for n, (cond, chans) in zip(short, res):
        c0, ch0 = _capture_all(n)
        for attr in ("value", "envelope", "filtered", "deviation",
                     "average", "mod_depth", "edge_peak", "edge_time"):
            assert np.array_equal(getattr(cond, attr), getattr(c0, attr))
        for k in ch0:
            assert np.array_equal(chans[k], ch0[k]), (n, k)


def test_noise_free_nfcb_divergence_is_the_product_box():
    """On the noise-free NFC-B template the kernel's float32 running sum
    p94x24 stays within float32 roundoff of the host's float64 box, and
    with the host's p94x24 in its place the device channels give the host
    frames: the listen search (phase > deviation[t - d], with deviation
    ~1e-22 on a clean carrier) reads the residual."""
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp.cuda_channels import fused_capture_all
    from nfclab_torch.native import condition_exact
    from nfclab_torch.runtime.decoder import DecoderContext, NfcDecoder

    tp = TEMPLATES[NAMES.index("nfcb")]
    x = tp.samples
    params = SignalParams(RATE)
    cond, chans = fused_capture_all(x, RATE, device="cpu")
    ctx = DecoderContext(condition_exact(x, params), RATE, params)
    host_box = ctx.channels.box_bpsk(94, 24)
    eps = float(np.finfo(np.float32).eps)
    diff = np.abs(chans["p94x24"].astype(np.float64) - host_box)
    assert diff.max() <= 64 * eps * np.abs(host_box).max()
    swapped = dict(chans, p94x24=np.asarray(host_box, np.float32))
    frames = NfcDecoder().decode(x, RATE, cond=cond, tpu_channels=swapped)
    assert _keys(frames) == _keys(NfcDecoder().decode(x, RATE))


# --------------------------------------------------------------------------
# make_fused_frontend


def test_make_fused_frontend_equals_fused_frontend(monkeypatch):
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp import frontend as fe
    from nfclab_torch.dsp.cuda_channels import DeviceUnavailable
    from nfclab_torch.dsp.fused_frontend import OUTPUT_NAMES, fused_frontend

    params = SignalParams(RATE, power_level_threshold=0.01)
    x = torch_synth.mixed_lanes(4, 512, seed=9)
    got = fe.make_fused_frontend(params, device="cpu")(x)
    pt, mp = tpar.params()
    want = fused_frontend(torch.from_numpy(x), pt, mask_params=mp)
    assert list(got) == OUTPUT_NAMES == list(want)
    for name in OUTPUT_NAMES:
        assert torch.equal(got[name], want[name]), name
    cached = fe.jitted_fused_frontend(RATE, device="cpu")
    assert cached is fe.jitted_fused_frontend(RATE, device="cpu")
    for name, t in cached(torch.from_numpy(x)).items():
        assert torch.equal(t, want[name]), name
    with pytest.raises(ValueError, match="native_layout"):
        fe.make_fused_frontend(params, native_layout=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        fe.make_fused_frontend(params)


def test_entry_points_raise_without_a_card(monkeypatch):
    from nfclab_torch.dsp import cuda_channels as cc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros(4096, np.float32)
    for fn in (cc.fused_capture_all, cc.fused_capture_channels):
        with pytest.raises(cc.DeviceUnavailable):
            fn(x, RATE)
    for fn in (cc.fused_batch_all, cc.fused_batch_channels):
        with pytest.raises(cc.DeviceUnavailable):
            fn([x], RATE)


# --------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_batch_all_on_the_card_equals_cpu():
    """fused_batch_all at 2 captures x 2 chunks of 4096: the card's arrays
    equal the plain versions' bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (nfclab_torch's kernels run only "
                    "there)")
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfclab_torch.dsp.cuda_channels import fused_batch_all

    xs = [torch_synth.lane(tp, 8192, seed=70 + i)[0][: 8192 - 1000 * i]
          for i, tp in enumerate(TEMPLATES[:2])]
    import nfclab_torch.dsp.cuda_channels as cc

    orig = cc._run_batch_chained

    def small(*a, **k):
        return orig(*a, chunk=4096, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cc, "_run_batch_chained", small)
        card = fused_batch_all(xs, RATE, device="cuda")
        cpu = fused_batch_all(xs, RATE, device="cpu")
    for (cond_c, chans_c), (cond_p, chans_p) in zip(card, cpu):
        for attr in ("value", "envelope", "filtered", "deviation",
                     "average", "mod_depth", "edge_peak", "edge_time"):
            a, b = getattr(cond_c, attr), getattr(cond_p, attr)
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), attr
        for k in chans_p:
            assert np.array_equal(chans_c[k].view(np.uint8),
                                  chans_p[k].view(np.uint8)), k
