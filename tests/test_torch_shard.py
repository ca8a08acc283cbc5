"""nfclab_torch.shard on the CPU (the kernels' plain versions), one rank,
against nfclab.shard on its virtual 8-device CPU mesh.

- The copies (overlap-save blocks and their stitching), the ring at world
  size 1, the launch helpers with no process group, the (stream, time)
  layout and ``shard_batch``.
- ``sharded_frontend_step`` against nfclab's on a 4 x 2 mesh, at the
  dense frontend's tolerances (tests/test_torch_frontend.py).
- ``sharded_capture_channels`` and ``decode_sharded`` against nfclab's on
  8 devices, on ``torch_synth`` lanes of all five templates (frames cross
  block boundaries) at 10 MS/s and one lane at 5 MS/s:
  - conditioning: the first row, started at clock = pulse = -H over its
    zero halo, equals a fresh stream from the C++ oracle bit for bit
    (nfclab's ``lax.scan`` contracts FMAs: rtol 1e-5, atol 1e-6);
  - box channels: the segmented box sum sums in nfclab's order (XLA's
    two-level scan of ``jnp.cumsum``: chunks of 16 left to right, then
    their tails), so the sample box channels equal nfclab's bit for bit;
    within 5e-5 of a float64 windowed sum on test_multichip.py's data (its
    bound); on the lanes, whose segment sums reach ~640, within 2 x 34 eps
    S of the float64 windowed sums, S the sum of |input| over the 1024
    samples up to the sample (the order's error bound: 15 + 15 + 2 adds
    in a prefix, 2 in the box), and the squared and product boxes within
    that plus nfclab's conditioning's FMA noise carried through the
    products (torch_parity's 1e-5 / 1e-6) of nfclab's;
  - ``detect_mask``: equal to nfclab's except where a trigger's deciding
    quantity lies within 1e-4 (relative) plus its box error of its
    threshold (the count is printed);
  - frames: equal to nfclab's ``decode_sharded`` exactly, on the lanes
    and on chip_smoke.py's noise-free long capture (whose nfclab frames
    chip_smoke.py pins for phase 14a); against ``NfcDecoder().decode``
    the float32 box channels may move a bound by up to 2 samples (counts
    printed).
- The halo-size and segment refusals; a threshold change through
  ``decode_sharded`` (tests/test_thresholds.py's sharded case, whose WAV
  is absent here).
- ``_sharded_kernel_step``'s window layout against nfclab's and against
  the port's ``_run_batch_blocks`` under one stand-in for the kernels,
  exactly; ``sharded_kernel_channels`` against ``fused_capture_channels``
  bit for bit on the plain versions.
- No card: every entry point and tool raises ``DeviceUnavailable`` or
  exits 1, and ``device="cuda"`` never becomes gloo or the CPU.
"""

import json

import numpy as np
import pytest
import torch

import torch_synth

RATE = torch_synth.RATE
EPS = float(np.finfo(np.float32).eps)
TEMPLATES = torch_synth.templates()
BAND = 1e-4                       # relative band of a trigger's threshold
DEPTH = 15 + 15 + 2 + 2           # the segmented box sum's error depth
RTOL, ATOL = 1e-5, 1e-6           # nfclab's FMA-contracted conditioning


def _jax_devices(n):
    from conftest import ensure_cpu_devices

    ensure_cpu_devices()
    import jax

    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"needs {n} virtual CPU devices")
    return devs[:n]


def _key(frames):
    """Frames of either package as comparable tuples."""
    return [(int(f.tech_type), int(f.frame_type), int(f.frame_phase),
             int(f.frame_flags), int(f.frame_rate), bytes(f.data),
             int(f.sample_start), int(f.sample_end), f.time_start,
             f.time_end) for f in frames]


# --------------------------------------------------------------------------
# copies, ring, launch helpers, layouts


def test_overlap_save_roundtrip_and_constants():
    import nfclab.shard.multichip as jm
    import nfclab.shard.temporal as jt

    from nfclab_torch.shard import multichip as pm
    from nfclab_torch.shard import overlap_save_blocks, stitch_blocks
    from nfclab_torch.shard import temporal as pt

    x = np.arange(100000, dtype=np.float32)
    blocks, starts, scan_starts = overlap_save_blocks(x, block=16384,
                                                      halo=4096)
    want = jt.overlap_save_blocks(x, block=16384, halo=4096)
    for a, b in zip((blocks, starts, scan_starts), want):
        assert np.array_equal(a, b)
    np.testing.assert_array_equal(
        stitch_blocks(blocks, starts, scan_starts, len(x)), x)
    assert pt.DEFAULT_HALO == jt.DEFAULT_HALO
    assert (pm.DEFAULT_L, pm.DEFAULT_H) == (jm.DEFAULT_L, jm.DEFAULT_H)


def test_halo_exchange_at_world_size_1():
    """No process group: the ring is a local copy of the tail (what
    ppermute over a one-device axis returns), not a view of it."""
    from nfclab_torch.shard.temporal import halo_exchange, ring_shift

    x = torch.arange(24, dtype=torch.float32).reshape(2, 12)
    got = halo_exchange(x, 4)
    assert torch.equal(got, x[..., -4:])
    got[0, 0] = -1.0
    assert x[0, 8] == 8.0
    assert torch.equal(ring_shift(x[1], step=-1), x[1])
    with pytest.raises(ValueError, match="ring of global ranks"):
        ring_shift(x[1], group=object())


def test_launch_helpers_without_a_group(monkeypatch):
    from nfclab_torch.shard import launch

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert launch.initialize() == 0          # single-process no-op
    assert not launch.distributed()
    assert launch.global_devices_host_major() == [launch.RankInfo(0, 0, 0)]
    # host-major: (node, local rank), whatever order they come in
    infos = [(1, 0, 2), (0, 1, 1), (1, 1, 3), (0, 0, 0)]
    got = launch.global_devices_host_major(infos)
    assert [d.rank for d in got] == [0, 1, 2, 3]
    assert [(d.node, d.local_rank) for d in got] == sorted(
        (d[0], d[1]) for d in infos)
    mesh = launch.global_mesh(device="cpu")
    assert (mesh.names, mesh.shape, mesh.coords, mesh.ranks) == (
        ("blocks",), (1,), (0,), (0,))
    assert mesh.group is None and mesh.device.type == "cpu"
    with pytest.raises(ValueError, match="without a process group"):
        launch.global_mesh(infos, device="cpu")
    # round-robin file sharding covers every path exactly once
    paths = [f"c{i}.wav" for i in range(7)]
    parts = [launch.host_local_paths(paths, pid, 3) for pid in range(3)]
    assert sorted(sum(parts, [])) == sorted(paths)
    assert max(len(p) for p in parts) - min(len(p) for p in parts) <= 1
    assert launch.host_local_paths(paths) == paths
    # nfclab's partition, path for path
    from nfclab.shard.launch import host_local_paths

    assert parts == [host_local_paths(paths, pid, 3) for pid in range(3)]


def test_make_mesh_and_shard_batch():
    from nfclab_torch.shard import make_mesh, shard_batch
    from nfclab_torch.shard.mesh import Mesh

    mesh = make_mesh(device="cpu")
    assert mesh.names == ("stream", "time") and mesh.shape == (1, 1)
    assert mesh.size == 1 and mesh.group is None
    with pytest.raises(ValueError, match="4x2"):
        make_mesh(4, 2, device="cpu")
    arr = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    got = shard_batch(mesh, arr)
    assert got.device.type == "cpu" and torch.equal(got, torch.from_numpy(arr))
    # a rank at (stream 2, time 1) of a 4 x 2 layout holds the third
    # quarter of the stream axis, whatever its time coordinate
    grid = Mesh(torch.device("cpu"), ("stream", "time"), (4, 2), (2, 1),
                tuple(range(8)))
    assert torch.equal(shard_batch(grid, arr), torch.from_numpy(arr[4:6]))
    assert torch.equal(shard_batch(grid, arr, "time"),
                       torch.from_numpy(arr[4:8]))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(grid, arr[:7])


def test_sharded_frontend_step_matches_nfclab():
    """The port's step at world size 1 over the whole block against
    nfclab's on its 4 x 2 CPU mesh, at tests/test_torch_frontend.py's
    tolerances, on 960 x 512 mixed lanes laid out [240, 4, 512]: nfclab
    conditions them with its lax.scan (its Pallas branch takes a multiple
    of 1024 rows, and TPU interpret mode does not run under a sharded
    jit)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import test_torch_frontend as tfe
    from nfclab.shard.mesh import make_mesh as jmake_mesh
    from nfclab.shard.temporal import sharded_frontend_step as jstep
    from nfclab_torch.shard import make_mesh, sharded_frontend_step
    from torch_synth import mixed_lanes

    devs = _jax_devices(8)
    jmesh = jmake_mesh(stream_parallel=4, time_parallel=2, devices=devs)
    x = mixed_lanes(960, 512, seed=31)
    blocks = x.reshape(240, 4, 512)
    arr = jax.device_put(blocks, NamedSharding(jmesh,
                                               P("stream", "time", None)))
    ref = {k: np.asarray(v) for k, v in jstep(jmesh, RATE)(arr).items()}
    got = sharded_frontend_step(make_mesh(device="cpu"), RATE)(blocks)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape == (240, 4, 512), k
        assert got[k].device.type == "cpu"
    flat = {k: v.reshape(960, 512) for k, v in ref.items()}
    mine = {k: v.reshape(960, 512).numpy() for k, v in got.items()}
    tfe.test_keys_and_dtypes((x, flat, mine))
    tfe.test_float_channels((x, flat, mine))
    tfe.test_masks((x, flat, mine))


# --------------------------------------------------------------------------
# sharded_capture_channels / decode_sharded against nfclab's


def _lane(i):
    """(capture, rate): three repeats of template i with torch_synth.lane's
    seeded gain, offset and noise, rolled so that the first full repeat's
    first poll starts 1000 samples before the first block boundary (and
    crosses it); i = 5 is template 0 decimated to 5 MS/s
    (test_multichip.py's rate-parametric case)."""
    from nfclab_torch.core.frame import FrameType
    from nfclab_torch.runtime.decoder import NfcDecoder
    from nfclab_torch.shard.multichip import DEFAULT_L

    tp = TEMPLATES[i % 5]
    x, _ = torch_synth.lane(tp, 3 * len(tp.samples), seed=300 + i)
    s0 = next(f.sample_start for f in NfcDecoder().decode(tp.samples, RATE)
              if f.frame_type == FrameType.NfcPollFrame)
    step = 2 if i == 5 else 1
    x = np.roll(x, (step * (DEFAULT_L - 1000) - s0) % len(tp.samples))
    return np.ascontiguousarray(x[::step]), RATE // step


def _recorded(module, fn, *a, **k):
    """(frames of module.decode_sharded, the channels it computed)."""
    seen = {}
    orig = module.sharded_capture_channels

    def rec(*ra, **rk):
        seen.update(orig(*ra, **rk))
        return seen

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "sharded_capture_channels", rec)
        frames = fn(*a, **k)
    return frames, seen


@pytest.fixture(scope="module", params=range(6),
                ids=[tp.name for tp in TEMPLATES] + ["nfca_106k_5MSps"])
def lane_run(request):
    import nfclab.shard.multichip as jm

    from nfclab_torch.runtime.decoder import NfcDecoder
    from nfclab_torch.shard import multichip as pm

    x, rate = _lane(request.param)
    devs = _jax_devices(8)
    frames, chans = _recorded(pm, pm.decode_sharded, x, rate, device="cpu")
    jframes, jchans = _recorded(jm, jm.decode_sharded, x, rate,
                                devices=devs)
    host = NfcDecoder().decode(x, rate)
    return x, rate, frames, chans, jframes, jchans, host


def _window_sum(u, w):
    c = np.concatenate([[0.0], np.cumsum(u)])
    i = np.arange(len(u))
    return c[i + 1] - c[np.maximum(i + 1 - w, 0)]


def _box_inputs(x, rate):
    """{channel: (float64 input, width, FMA noise of the input)} from the
    C++ oracle's conditioning (the blocks' body values converge to it)."""
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp.cuda_channels import channel_plan
    from nfclab_torch.native import condition_exact

    plan = channel_plan(rate)
    filt = condition_exact(x, SignalParams(rate)).filtered.astype(np.float64)
    d_f = ATOL + RTOL * np.abs(filt)
    xd = x.astype(np.float64)
    out = {f"bv{w}": (xd, w, np.zeros_like(xd)) for w in plan["bv"]}
    for w in plan["q"]:
        out[f"q{w}"] = (10 * filt * filt, w, 20 * np.abs(filt) * d_f)
    for lag, box in plan["pb"]:
        g = np.concatenate([np.zeros(lag), filt[:-lag]])
        d_g = np.concatenate([np.zeros(lag), d_f[:-lag]])
        out[f"p{lag}x{box}"] = (10 * filt * g, box,
                                10 * (np.abs(g) * d_f + np.abs(filt) * d_g))
    return out


def test_capture_channels_keys_and_boxes(lane_run):
    from nfclab_torch.dsp.cuda_channels import fetch_names

    x, rate, _, chans, _, jchans, _ = lane_run
    assert set(chans) == set(jchans) == set(fetch_names(rate))
    for k in chans:
        assert chans[k].dtype == jchans[k].dtype == np.float32, k
        assert chans[k].shape == jchans[k].shape == x.shape, k
    for name, (u, w, noise) in _box_inputs(x, rate).items():
        bound = 2 * DEPTH * EPS * _window_sum(np.abs(u), 1024)
        got = chans[name].astype(np.float64)
        assert (np.abs(got - _window_sum(u, w)) <= bound).all(), name
        if name.startswith("bv"):
            assert np.array_equal(chans[name].view(np.uint32),
                                  jchans[name].view(np.uint32)), name
        d = np.abs(got - jchans[name])
        assert (d <= bound + _window_sum(noise, w)).all(), name


def _near_triggers(x, rate, chans):
    """Samples where a detect trigger's deciding quantity lies within BAND
    (relative) plus its box error of its threshold, from the port's own
    box channels and its block-restart conditioning."""
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.core.thresholds import DecoderThresholds
    from nfclab_torch.dsp.conditioner_kernel import condition_scan
    from nfclab_torch.dsp.cuda_channels import channel_plan
    from nfclab_torch.dsp.frontend import _params_tuple
    from nfclab_torch.shard import multichip as pm
    from nfclab_torch.shard.launch import global_mesh

    L, H = pm.DEFAULT_L, pm.DEFAULT_H
    rows, n, nb = pm._layout_rows(x, L, 1)
    win, first, _ = pm._left_windows(torch.from_numpy(rows),
                                     global_mesh(device="cpu"), nb, L, H)
    z = torch.zeros(nb)
    neg = torch.where(first, -H, 0).to(torch.int32)
    env, _, _, _, filt, _ = condition_scan(
        win, z, z, z, z, neg, neg, _params_tuple(SignalParams(rate)))
    env = env[:, H:].reshape(-1)[:n].numpy().astype(np.float64)
    filt = filt[:, H:].reshape(-1)[:n].numpy().astype(np.float64)
    p_thr, a, b_deep, f, v = DecoderThresholds().detect_mask_tuple(0.01)
    f32 = lambda t: float(np.float32(t))  # noqa: E731
    plan = channel_plan(rate)
    err = 2 * DEPTH * EPS * _window_sum(np.abs(x.astype(np.float64)), 1024)

    def sh(a, d):
        return np.concatenate([np.zeros(d), a[: len(a) - d]]) if d else a

    def near(q, level, tol):
        return np.abs(q - level) <= BAND * np.abs(level) + tol

    out = np.abs(env - f32(p_thr)) <= BAND * f32(p_thr)
    for rates, thr in ((plan["a_rates"], a), (plan["f_rates"], f)):
        for d, gap, p2 in rates:
            box = chans[f"bv{p2}"].astype(np.float64)
            sd = ((sh(box, d) - sh(box, d + gap))
                  - (sh(box, d + gap) - sh(box, d + 1))) / p2
            out |= near(np.abs(sd), f32(thr) * env, 4 * err / p2)
    for d in plan["b_delays"]:
        out |= near(sh(filt, d), -(f32(b_deep) * env), 2 * ATOL)
    dv, gapv, p2v = plan["v_rate"]
    box = chans[f"bv{p2v}"].astype(np.float64)
    sd_v = (sh(box, dv + gapv) - sh(box, dv)) / p2v
    return out | near(sd_v, f32(v) * env, 2 * err / p2v)


def test_capture_detect_mask(lane_run):
    x, rate, _, chans, _, jchans, _ = lane_run
    got, want = chans["detect_mask"], jchans["detect_mask"]
    assert got.any()
    differ = got != want
    near = _near_triggers(x, rate, chans)
    print(f"detect_mask: {int(differ.sum())} samples differ, "
          f"{int(near.sum())} within the band of a threshold")
    assert not (differ & ~near).any(), int((differ & ~near).sum())
    assert near.mean() < 0.1


def _moved(got, want, slack=2):
    """How many frames of `got` move a sample bound off `want`'s; every
    frame must keep every other key, and a bound may move by at most
    `slack` samples."""
    assert len(got) == len(want)
    n = 0
    for g, w in zip(got, want):
        if g != w:
            n += 1
            assert g[:6] == w[:6], (g, w)
            assert abs(g[6] - w[6]) <= slack and abs(g[7] - w[7]) <= slack, (
                g, w)
    return n


def test_decode_sharded_frames(lane_run):
    """The frames of the port's decode_sharded equal nfclab's exactly, and
    both packages' against their host decoders (which agree exactly): the
    float32 box channels the walk reads may move a frame's bounds by up to
    2 samples (on the 424k BPSK lane one poll's end moves by one sample in
    both); bytes, types, flags and rates are equal, and no frame is lost
    or added."""
    from nfclab.runtime.decoder import NfcDecoder as JaxDecoder

    from nfclab_torch.core.frame import FrameType
    from nfclab_torch.shard.multichip import DEFAULT_L

    x, rate, frames, _, jframes, _, host = lane_run
    host = _key(host)
    assert _key(JaxDecoder().decode(x, rate)) == host
    mine, theirs = _key(frames), _key(jframes)
    assert mine == theirs
    print(f"frames moved against host: {_moved(mine, host)} of {len(host)}")
    polls = [f for f in frames if f.frame_type in (
        FrameType.NfcPollFrame, FrameType.NfcListenFrame)]
    assert len(polls) >= 4
    # frames cross block boundaries
    assert any(f.sample_start // DEFAULT_L != f.sample_end // DEFAULT_L
               for f in polls)


def test_noise_free_capture_frames_match_nfclab():
    """chip_smoke.py phase 7's long capture (noise-free templates between
    field-off stretches), its first chip_smoke.SHARD_PREFIX samples: the
    port's decode_sharded gives nfclab's frames, frame for frame, and
    those are the frames chip_smoke.py pins for the card
    (SHARD_NFCLAB_FRAMES).  Both part from the host decoder (bounds moved,
    frames garbled or lost where a trigger sits on its threshold), while
    the host walk over the sharded detect_mask alone, with its own float64
    boxes, gives the host's frames: the triggers are sound, the float32
    box channels move the frames (ROADMAP Queue 3)."""
    import hashlib

    import chip_smoke
    import nfclab.shard.multichip as jm

    from nfclab_torch.runtime.decoder import NfcDecoder
    from nfclab_torch.shard import multichip as pm

    devs = _jax_devices(8)
    x = np.ascontiguousarray(
        chip_smoke.long_capture(TEMPLATES)[: chip_smoke.SHARD_PREFIX])
    frames, chans = _recorded(pm, pm.decode_sharded, x, RATE, device="cpu")
    jframes = jm.decode_sharded(x, RATE, devices=devs)
    host = _key(NfcDecoder().decode(x, RATE))
    mask_only = NfcDecoder().decode(
        x, RATE, tpu_channels={"detect_mask": chans["detect_mask"]})
    assert _key(mask_only) == host
    mine = _key(frames)
    assert mine == _key(jframes)
    lines = chip_smoke._frames_key(jframes)
    assert (len(lines), hashlib.sha256("\n".join(lines).encode()).hexdigest()
            ) == chip_smoke.SHARD_NFCLAB_FRAMES
    print(f"host {len(host)} frames; decode_sharded {len(mine)} in both "
          f"packages, {len(set(mine) - set(host))} not among the host's")


def test_first_row_starts_from_the_fresh_state():
    """Row 0 runs its zero halo from clock = pulse = -H: the carry entering
    sample 0 is the zero state, so its body equals a fresh stream of the
    C++ oracle bit for bit, and nfclab's lax.scan (FMAs contracted) at
    torch_parity's rtol 1e-5, atol 1e-6 (w1, the filter's state, reaches
    6)."""
    import jax.numpy as jnp

    from nfclab.dsp.conditioner import _build_scan
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp.conditioner_kernel import condition_scan
    from nfclab_torch.dsp.frontend import _params_tuple
    from nfclab_torch.native import condition_exact
    from nfclab_torch.shard import multichip as pm
    from nfclab_torch.shard.launch import global_mesh

    _jax_devices(1)
    L, H = 4096, 4096
    x, _ = torch_synth.lane(TEMPLATES[0], 3 * L, seed=9)
    rows, _, nb = pm._layout_rows(x, L, 1)
    win, first, _ = pm._left_windows(torch.from_numpy(rows),
                                     global_mesh(device="cpu"), nb, L, H)
    assert first.tolist() == [True, False, False]
    assert not win[0, :H].any()
    z = torch.zeros(nb)
    neg = torch.where(first, -H, 0).to(torch.int32)
    pt = _params_tuple(SignalParams(RATE))
    env, w1, mdev, avg, filt, pulse = condition_scan(win, z, z, z, z, neg,
                                                     neg, pt)
    for t in (env, w1, mdev, avg, filt):
        assert not t[0, :H].any()
    assert pulse[0, H - 1] == 0
    ref = condition_exact(x[:L], SignalParams(RATE))
    for name, t in (("envelope", env), ("filtered", filt),
                    ("deviation", mdev), ("average", avg)):
        a = t[0, H:].numpy()
        assert np.array_equal(a.view(np.uint32),
                              getattr(ref, name).view(np.uint32)), name
    zj = jnp.zeros(nb, jnp.float32)
    negj = jnp.asarray(neg.numpy())
    outs = _build_scan(pt)(jnp.asarray(win.numpy()), zj, zj, zj, zj, negj,
                           negj)
    for mine, theirs in zip((env, w1, mdev, avg, filt),
                            (np.asarray(o).T for o in outs[:5])):
        assert np.allclose(mine.numpy(), theirs, rtol=RTOL, atol=ATOL)


def test_segmented_box_sum_precision():
    """test_multichip.py's data and bound: the port's segmented box sums
    within 5e-5 of the float64 windowed sums, and equal to nfclab's form
    bit for bit."""
    import jax.numpy as jnp

    from nfclab_torch.shard.multichip import _box_sum

    _jax_devices(1)
    rng = np.random.default_rng(7)
    x = (rng.random((2, 32768), dtype=np.float32) * 0.4).astype(np.float32)

    def jbox(xv, width, seg=512):  # nfclab's multichip.py:123-142
        r, w_len = xv.shape
        xs = xv.reshape(r, w_len // seg, seg)
        c = jnp.cumsum(xs, axis=-1)
        tails = c[..., -1]
        cprev = jnp.pad(c[:, :-1], ((0, 0), (1, 0), (0, 0)))
        tprev = jnp.pad(tails[:, :-1], ((0, 0), (1, 0)))
        o = jnp.arange(seg)
        case1 = c - jnp.roll(c, width, axis=-1)
        c2 = cprev[..., jnp.clip(o + seg - width, 0, seg - 1)]
        case2 = c + (tprev[..., None] - c2)
        return jnp.where(o >= width, case1, case2).reshape(r, w_len)

    for width in (12, 94, 189, 512):
        got = _box_sum(torch.from_numpy(x), width).numpy()
        c64 = np.cumsum(x.astype(np.float64), axis=-1)
        want = c64 - np.pad(c64[:, :-width], ((0, 0), (width, 0)))
        assert np.abs(got - want).max() < 5e-5, width
        assert np.array_equal(got, np.asarray(jbox(x, width))), width


def test_refusals():
    from nfclab_torch.shard import multichip as pm

    x = np.zeros(50_000, np.float32)
    with pytest.raises(ValueError, match="too small"):
        pm.sharded_capture_channels(x, RATE, H=2048, device="cpu")
    with pytest.raises(ValueError, match="segment"):
        pm.sharded_capture_channels(x, 40_000_000, H=16384, device="cpu")
    with pytest.raises(ValueError, match="multiple of the segment"):
        pm.sharded_capture_channels(x, RATE, L=24000, device="cpu")
    with pytest.raises(ValueError, match="must lie in"):
        pm.sharded_capture_channels(x, RATE, L=4096, device="cpu")
    with pytest.raises(ValueError, match="must lie in"):
        pm.sharded_kernel_channels(x, RATE, L=256, H=384, device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        pm.sharded_kernel_channels(x, RATE, L=300, H=100, device="cpu")


def test_decode_sharded_respects_thresholds():
    """tests/test_thresholds.py's sharded case on a seeded NFC-A lane: an
    NFC-A correlation no signal crosses flows through decode_sharded's
    mask into NfcDecoder(thresholds=...)'s frames: carrier events only."""
    from nfclab_torch.core.thresholds import DecoderThresholds
    from nfclab_torch.io.golden import GOLDEN_TYPES
    from nfclab_torch.runtime.decoder import NfcDecoder
    from nfclab_torch.shard.multichip import decode_sharded

    x, rate = _lane(0)
    th = DecoderThresholds()
    th.nfca.correlation = 5.0
    tuned = decode_sharded(x, rate, device="cpu", thresholds=th)
    assert not any(f.frame_type in GOLDEN_TYPES for f in tuned)
    assert tuned
    assert _key(tuned) == _key(NfcDecoder(thresholds=th).decode(x, rate))
    assert any(f.frame_type in GOLDEN_TYPES
               for f in NfcDecoder().decode(x, rate))


# --------------------------------------------------------------------------
# the kernel path: layout under a stand-in, then the plain kernels

_K = {name: float(k + 2) for k, name in enumerate(
    ("bv12", "bv24", "bv47", "bv94", "q47", "q189", "p24x6", "p47x12",
     "p94x24"))}


def _standin(win, h, name, xp=np):
    """[R, W] windows -> one output: k v[t] + v[t - h] + 2 v[t + h], zero
    outside the window, so every body value shows its left halo and the
    head row its next-H (exact on a 1/64 grid); xp is numpy or
    jax.numpy."""
    z = xp.zeros((win.shape[0], h), win.dtype)
    back = xp.concatenate([z, win[:, :-h]], 1)
    ahead = xp.concatenate([win[:, h:], z], 1)
    if name == "detect_mask":
        code = xp.round((win + back + 2 * ahead) * 64).astype(xp.int32)
        return (code % 256).astype(xp.uint8)
    return win * xp.float32(_K[name]) + back + 2 * ahead


def _standins(h):
    def jax_fused(value, params, native_layout=False, mask_params=None,
                  select=None, sample_rate=RATE, **_):
        import jax.numpy as jnp

        return {n: _standin(value, h, n, jnp) for n in select}

    def port_run_chunk(value_tm, state_sm, base, pt, mp, plan, sel):
        v = value_tm.t().numpy()
        return ({n: torch.from_numpy(_standin(v, h, n)).t() for n in sel},
                state_sm)

    return jax_fused, port_run_chunk


@pytest.mark.parametrize("L,H", [(384, 128), (256, 256), (896, 128)])
def test_kernel_step_layout_equals_nfclab(L, H):
    """Row 0 = [body | next-H], row i = [left-halo | body]: equal arrays,
    name for name, to nfclab's on 4 devices and to the port's
    _run_batch_blocks (fused_capture_channels), under one stand-in."""
    import nfclab.dsp.pallas.fused_frontend as jff
    import nfclab.shard.multichip as jm

    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.shard import multichip as pm

    devs = _jax_devices(4)
    rng = np.random.default_rng(L + H)
    jax_fused, port_run_chunk = _standins(H)
    jm._sharded_kernel_step.cache_clear()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jff, "fused_frontend", jax_fused)
            mp.setattr(ff, "run_chunk", port_run_chunk)
            for n in (1500, 333, 2048, 1025, 90):
                x = (rng.integers(-60, 60, n) / 64.0).astype(np.float32)
                want = jm.sharded_kernel_channels(x, RATE, devices=devs,
                                                  L=L, H=H)
                got = pm.sharded_kernel_channels(x, RATE, L=L, H=H,
                                                 device="cpu")
                blocks = cc.fused_capture_channels(x, RATE, L=L, H=H,
                                                   device="cpu")
                assert set(got) == set(want) == set(blocks)
                for k in want:
                    assert got[k].dtype == want[k].dtype, k
                    assert np.array_equal(got[k], want[k]), (n, k)
                    assert np.array_equal(got[k], blocks[k]), (n, k)
    finally:
        jm._sharded_kernel_step.cache_clear()


def test_kernel_channels_equal_fused_capture_channels():
    """The plain kernels over 4 blocks of L = 1920, H = 128: bit for
    bit."""
    from nfclab_torch.dsp.cuda_channels import fused_capture_channels
    from nfclab_torch.shard.multichip import sharded_kernel_channels

    x, _ = torch_synth.lane(TEMPLATES[1], 7000, seed=11)
    got = sharded_kernel_channels(x, RATE, L=1920, H=128, device="cpu")
    want = fused_capture_channels(x, RATE, L=1920, H=128, device="cpu")
    assert set(got) == set(want)
    assert got["detect_mask"].dtype == np.uint8 and got["detect_mask"].any()
    for k in want:
        assert np.array_equal(got[k].view(np.uint8), want[k].view(np.uint8)), k


# --------------------------------------------------------------------------
# no card


def test_no_card_raises_and_never_falls_back(monkeypatch, tmp_path, capsys):
    import torch.distributed as dist

    from nfclab_torch.dsp.cuda_channels import DeviceUnavailable
    from nfclab_torch.io.wav import write_wav
    from nfclab_torch.shard import launch, make_mesh
    from nfclab_torch.shard import multichip as pm
    from nfclab_torch.tools import scaling_bench, validate_cuda_shard_kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros(4096, np.float32)
    for fn in (pm.sharded_capture_channels, pm.sharded_kernel_channels,
               pm.decode_sharded):
        with pytest.raises(DeviceUnavailable):
            fn(x, RATE)
    with pytest.raises(DeviceUnavailable):
        make_mesh()
    with pytest.raises(DeviceUnavailable):
        launch.global_mesh()
    with pytest.raises(DeviceUnavailable):
        launch.initialize(f"file://{tmp_path}/store", 1, 0)
    assert not dist.is_initialized()
    wav = tmp_path / "x.wav"
    write_wav(str(wav), TEMPLATES[0].samples, RATE)
    assert validate_cuda_shard_kernel.main([str(wav)]) == 1
    assert validate_cuda_shard_kernel.main([str(tmp_path / "none.wav")]) == 1
    assert scaling_bench.main(["--devices", "1"]) == 1
    err = capsys.readouterr().err
    assert "CUDA is not available" in err and "no such file" in err
    # with a card but no NCCL, device="cuda" raises: gloo only when asked
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL is not available"):
        launch.initialize(f"file://{tmp_path}/store", 1, 0)
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# the tools on the CPU


def test_validate_cuda_shard_kernel_on_a_seeded_wav(tmp_path, capsys):
    from nfclab_torch.io.golden import write_golden_frames
    from nfclab_torch.io.wav import read_wav, write_wav
    from nfclab_torch.runtime.decoder import NfcDecoder
    from nfclab_torch.tools.validate_cuda_shard_kernel import main

    x, _ = torch_synth.lane(TEMPLATES[3], 30_000, seed=12)
    wav = tmp_path / "nfcf.wav"
    write_wav(str(wav), x, RATE)
    samples, _ = read_wav(str(wav))
    frames = NfcDecoder().decode(samples, RATE)
    write_golden_frames(str(tmp_path / "nfcf.json"), frames)
    assert main([str(wav), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "bit-exact" in out and "golden frames OK" in out
    assert out.rstrip().endswith("OK")
    # a golden file that disagrees fails the run
    bad = json.loads((tmp_path / "nfcf.json").read_text())
    bad["frames"] = bad["frames"][1:]
    (tmp_path / "nfcf.json").write_text(json.dumps(bad))
    assert main([str(wav), "--device", "cpu"]) == 1
