"""nfclab_torch's live farm (runtime/farm.py, CudaStreamFarm) against
nfclab's TpuStreamFarm(fetch="mask") on the CPU.

The plumbing tests are nfclab's three of tests/test_mask_farm.py (the
mask-mode pipeline with walk_threads None and 2, the segmented branch,
the adaptive backoff) with the same stubbed engines and mask oracle (the
unfused JAX frontend with the mask margin, ROADMAP "Oracles" (c)), on
tests/torch_synth.py captures instead of the reference WAVs, and with
CHAIN_CHUNK cut to 4096 in both packages so a window is 16384 samples.
Both farms take identical feeds (a reused buffer, a ragged last feed);
their frames must equal each other's and the host streaming decoder's,
and their stats must agree key for key (the seconds keys by name, every
count by value).  Then the port's farm with its real engines
(device="cpu": the kernels' plain versions), the segments policy and its
errors against nfclab's over a grid, and the guards.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (kept on the CPU by conftest.ensure_cpu_devices)

import torch_synth

RATE = torch_synth.RATE
TEMPLATES = torch_synth.templates()
CHUNK = 4096
TIMING_KEYS = ("device_s", "walk_s", "wait_s")


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """nfclab's MaskFedStream conditions natively: its binding loads a copy
    of the port's library (see torch_native.py)."""
    from torch_native import use_ref_native

    use_ref_native(tmp_path_factory.mktemp("native"))


@pytest.fixture
def small_chunk(monkeypatch):
    import nfclab.dsp.tpu_channels as tc

    from nfclab_torch.dsp import cuda_channels as cc

    monkeypatch.setattr(tc, "CHAIN_CHUNK", CHUNK)
    monkeypatch.setattr(cc, "CHAIN_CHUNK", CHUNK)


def _cpu_mask(samples):
    """Packed detect mask of one capture from the unfused JAX frontend on
    the CPU, with the mask frontend's margin on the SD thresholds (the
    oracle of nfclab's tests/test_mask_farm.py)."""
    from conftest import ensure_cpu_devices

    ensure_cpu_devices()
    import jax

    from nfclab.core.params import SignalParams
    from nfclab.core.thresholds import DecoderThresholds
    from nfclab.dsp.frontend import make_frontend
    from nfclab.dsp.pallas.fused_frontend import MASK_LAYOUT
    from nfclab.dsp.tpu_channels import MASK_ONLY_MARGIN

    d = DecoderThresholds()
    m = 1.0 - MASK_ONLY_MARGIN
    thr = {"nfca": d.nfca.correlation * m, "nfcb": d.nfcb.min_modulation_deep,
           "nfcf": d.nfcf.correlation * m, "nfcv": d.nfcv.correlation * m}
    fe = jax.jit(make_frontend(SignalParams(RATE, power_level_threshold=0.01),
                               corr_thresholds=thr))
    x = np.asarray(samples, np.float32)
    pad = (-len(x)) % 256  # the scan path wants a multiple of its unroll
    res = fe(np.concatenate([x, np.zeros(pad, np.float32)])[None, :])
    mask = np.zeros(len(x), np.uint8)
    for name, w in MASK_LAYOUT:
        mask |= np.where(np.asarray(res[name][0][: len(x)]), np.uint8(w),
                         np.uint8(0))
    return mask


def _streams(names, n, seed):
    tps = [tp for tp in TEMPLATES if tp.name in names]
    return [torch_synth.lane(tp, n, seed=seed + i)[0]
            for i, tp in enumerate(tps)]


def _host_frames(s):
    from nfclab_torch.runtime.streaming import StreamingNfcDecoder

    host = StreamingNfcDecoder(RATE)
    want = []
    for off in range(0, len(s), 65536):
        want.extend(host.feed(s[off : off + 65536]))
    want.extend(host.finish())
    return want


def _json(frames, ref=False):
    if ref:
        from nfclab.apps.decode_cli import frame_json
    else:
        from nfclab_torch.apps.decode_cli import frame_json

    return [frame_json(f) for f in frames]


def _drive(farm, sigs, step, reuse=True):
    """Feed [n, step] blocks (the last one ragged) through one reused
    buffer, then finish; per-stream frames."""
    total = len(sigs[0])
    frames = [[] for _ in sigs]
    block = np.empty((len(sigs), step), np.float32)
    for off in range(0, total, step):
        w = min(step, total - off)
        if reuse:
            for i, s in enumerate(sigs):
                block[i, :w] = s[off : off + w]
            blk = block[:, :w]
        else:
            blk = np.stack([s[off : off + w] for s in sigs])
        for i, new in enumerate(farm.feed(blk)):
            frames[i].extend(new)
    for i, new in enumerate(farm.finish()):
        frames[i].extend(new)
    return frames


class _Stubs:
    """nfclab's stubbed engines: run_chained_masks / run_segmented_masks
    answered by the mask oracle, checking the samples and the carry
    threading; one instance per farm run."""

    def __init__(self, sigs, masks, repaired=0):
        self.sigs, self.masks = sigs, masks
        self.repaired = repaired
        self.t = 0
        self.calls = {"serial": 0, "seg": 0}

    def _oracle(self, blocks):
        lo, T = self.t, blocks.shape[1]
        out = []
        for i in range(blocks.shape[0]):
            np.testing.assert_array_equal(blocks[i],
                                          self.sigs[i][lo : lo + T])
            seg = self.masks[i][lo : lo + T]
            rel = np.flatnonzero(seg).astype(np.int64)
            out.append((rel, seg[rel]))
        self.t = lo + T
        return out

    def _carry(self, n):
        return {"pen": np.full((n, 3), self.t - CHUNK, np.float32),
                "end": np.full((n, 3), self.t, np.float32)}

    def run(self, blocks, state, base0, pt, mp, cap_div=8, chunk=None,
            sample_rate=RATE, want_carry=False, lap=None):
        out = self._oracle(blocks)
        self.calls["serial"] += 1
        if want_carry:
            return out, state, self._carry(blocks.shape[0])
        return out, state

    def seg(self, blocks, carry, pt, mp, segments, cap_div=16, chunk=None,
            sample_rate=RATE, k_bucket=32, device=None, lap=None):
        lo = self.t
        assert segments == 2
        # carry threading: the tail is the previous window's last chunk,
        # the end state the previous window's end
        np.testing.assert_array_equal(
            carry["tail"], np.stack([s[lo - CHUNK : lo] for s in self.sigs]))
        assert float(carry["end"][0, 0]) == lo
        assert float(carry["pen"][0, 0]) == lo - CHUNK
        out = self._oracle(blocks)
        self.calls["seg"] += 1
        n = blocks.shape[0]
        new = dict(self._carry(n), tail=blocks[:, -CHUNK:].copy())
        return out, new, {"repaired_streams": self.repaired * n,
                          "repair_chunks": self.repaired * n * 4}


def _patch(mp, stubs, port: bool):
    if port:
        from nfclab_torch.dsp import cuda_channels as mod

        expand = lambda rows, device: object()  # noqa: E731
    else:
        import nfclab.dsp.tpu_channels as mod

        expand = lambda n: (lambda rows: object())  # noqa: E731
    mp.setattr(mod, "run_chained_masks", stubs.run)
    mp.setattr(mod, "run_segmented_masks", stubs.seg)
    mp.setattr(mod, "chain_state0", lambda *a, **k: object())
    mp.setattr(mod, "_expand_state", expand)


def _both_farms(sigs, masks, step, repaired=0, reuse=True, **farm_kw):
    """(frames, stats, segments, stub calls) of nfclab's farm and the
    port's over the same feeds, each with its own stubs."""
    from nfclab.runtime.farm import TpuStreamFarm

    from nfclab_torch.runtime.farm import CudaStreamFarm

    got = {}
    for port in (False, True):
        stubs = _Stubs(sigs, masks, repaired)
        with pytest.MonkeyPatch.context() as mp:
            _patch(mp, stubs, port)
            if port:
                farm = CudaStreamFarm(len(sigs), RATE, fetch="mask",
                                      device="cpu", **farm_kw)
            else:
                farm = TpuStreamFarm(len(sigs), RATE, fetch="mask",
                                     **farm_kw)
            frames = _drive(farm, sigs, step, reuse)
        got[port] = (frames, dict(farm.stats), farm.segments, stubs.calls)
    return got[False], got[True]


def _assert_same(ref, port, sigs):
    from nfclab_torch.runtime.farm import STEP_COUNTERS

    (rf, rs, rseg, rcalls), (pf, ps, pseg, pcalls) = ref, port
    assert rseg == pseg
    assert rcalls == pcalls
    # nfclab's keys, and the port's own seconds beside them
    assert set(ps) == set(rs) | set(STEP_COUNTERS)
    assert all(ps[k] >= 0.0 for k in STEP_COUNTERS)
    for k in rs:
        if k not in TIMING_KEYS:
            assert rs[k] == ps[k], k
    for i, s in enumerate(sigs):
        assert _json(pf[i]) == _json(rf[i], ref=True)
        assert pf[i] == _host_frames(s)
        assert pf[i]


@pytest.mark.parametrize("walk_threads", [None, 2])
def test_farm_mask_pipeline_matches_nfclab(ref_native, small_chunk,
                                           walk_threads):
    """fetch='mask' pipeline plumbing with the serial engine stubbed:
    staging into k_chunks windows, background dispatch ordering,
    compacted-index walk, pow2 + host-tail flush at finish, a reused
    feed buffer and a ragged last feed (nfclab's
    test_pipelined_farm_mask_mode)."""
    sigs = _streams(("nfca_106k", "nfcb"), 4 * 4 * CHUNK + 3 * 4096 + 700,
                    seed=300)
    masks = [_cpu_mask(s) for s in sigs]
    ref, port = _both_farms(sigs, masks, 2560, k_chunks=4,
                            walk_threads=walk_threads, segments=1)
    _assert_same(ref, port, sigs)
    assert port[3]["serial"] >= 4 and port[3]["seg"] == 0


def test_farm_segmented_plumbing_matches_nfclab(ref_native, small_chunk):
    """The segmented branch with both engines stubbed: the first full
    window runs the serial chain and hands off a carry, later full
    windows go through run_segmented_masks with the previous window's
    last chunk as the tail and the end state threading in submission
    order, the finish() flush runs the serial chain (nfclab's
    test_pipelined_farm_segmented_plumbing)."""
    sigs = _streams(("nfca_424k_bpsk", "nfcf"),
                    4 * 4 * CHUNK + 3 * 4096 + 700, seed=310)
    masks = [_cpu_mask(s) for s in sigs]
    ref, port = _both_farms(sigs, masks, 2560, reuse=False, k_chunks=4)
    _assert_same(ref, port, sigs)
    assert port[2] == 2  # auto: largest pow2 <= k_chunks/2 (<= 16)
    assert port[3]["serial"] >= 1 and port[3]["seg"] >= 2
    assert port[1]["seg_dispatches"] == port[3]["seg"]
    assert port[1]["seg_backoff_windows"] == 0


def test_farm_segmented_backoff_matches_nfclab(ref_native, small_chunk):
    """Adaptive backoff: a segmented window that repairs every stream
    sends the next full windows to the serial chain (nfclab's
    test_pipelined_farm_segmented_backoff)."""
    sig = _streams(("nfca_106k",), 9 * 4 * CHUNK + 4096, seed=320)[0]
    sigs = [sig, sig]
    masks = [_cpu_mask(sig)] * 2
    ref, port = _both_farms(sigs, masks, 4 * CHUNK, repaired=1, reuse=False,
                            k_chunks=4)
    _assert_same(ref, port, sigs)
    # window 1 serial (head), window 2 the probe (full repairs), then
    # backoff: the remaining full windows run serial
    assert port[3]["seg"] == 1
    assert port[1]["seg_backoff_windows"] >= 2
    assert port[1]["repaired_streams"] == 2


def test_farm_real_engines_give_host_frames(small_chunk):
    """CudaStreamFarm(fetch="mask", device="cpu", k_chunks=4, segments=2)
    over one stream of each template with the real engines (the kernels'
    plain versions): the first window serial, three segmented windows (with
    repairs), a pow2 flush and a host tail; every stream's frames equal
    the host streaming decoder's and carry the synthesizer's bytes."""
    from nfclab_torch.core.frame import FrameType
    from nfclab_torch.runtime.farm import CudaStreamFarm

    n = 4 * 4 * CHUNK + 3000
    lanes = [torch_synth.lane(tp, n, seed=50 + i)
             for i, tp in enumerate(TEMPLATES)]
    sigs = [x for x, _ in lanes]
    farm = CudaStreamFarm(len(sigs), RATE, fetch="mask", k_chunks=4,
                          segments=2, device="cpu")
    frames = _drive(farm, sigs, 5000)
    st = farm.stats
    assert st["dispatches"] == 4 and st["seg_dispatches"] == 3
    assert st["repaired_streams"] > 0 and st["repair_chunks"] > 0
    assert st["drained_samples"] == len(sigs) * 4 * 4 * CHUNK
    keep = (int(FrameType.NfcPollFrame), int(FrameType.NfcListenFrame))
    for (x, reps), tp, got in zip(lanes, TEMPLATES, frames):
        assert got == _host_frames(x), tp.name
        assert [f.data for f in got if f.frame_type in keep] == (
            tp.sent * reps), tp.name


@pytest.mark.parametrize("k_chunks", [4, 32])
@pytest.mark.parametrize("n_streams", [1, 3, 64, 65, 1024])
def test_farm_segments_policy_matches_nfclab(ref_native, n_streams,
                                             k_chunks):
    """farm.segments, and the constructor's ValueError, equal nfclab's for
    every segments argument."""
    from nfclab.runtime.farm import TpuStreamFarm

    from nfclab_torch.runtime.farm import CudaStreamFarm

    def outcome(cls, seg, **kw):
        try:
            return cls(n_streams, RATE, fetch="mask", k_chunks=k_chunks,
                       segments=seg, **kw).segments
        except ValueError as e:
            return ("ValueError", str(e))

    for seg in (None, 1, 2, 3, 16):
        want = outcome(TpuStreamFarm, seg)
        assert outcome(CudaStreamFarm, seg, device="cpu") == want, seg


def test_farm_without_a_card_raises(monkeypatch):
    from nfclab_torch.dsp.cuda_channels import DeviceUnavailable
    from nfclab_torch.runtime.farm import CudaStreamFarm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        CudaStreamFarm(4, RATE)


def test_farm_full_fetch_names_queue_item():
    """fetch="full" (the default) builds KernelFedStream rows with the
    unmargined mask params and no segments; it refuses an explicit
    segments > 1, which nfclab's farm ignores, and any other fetch is
    refused."""
    from nfclab_torch.core.thresholds import DecoderThresholds
    from nfclab_torch.runtime.farm import CudaStreamFarm, KernelFedStream

    for kw in ({"fetch": "full"}, {}, {"fetch": "full", "segments": 1}):
        farm = CudaStreamFarm(4, RATE, device="cpu", **kw)
        assert farm.fetch == "full" and farm.segments == 1
        assert len(farm.streams) == 4
        assert all(type(st) is KernelFedStream for st in farm.streams)
        assert farm._mp == DecoderThresholds().detect_mask_tuple(0.01)
    for seg in (2, 16):
        with pytest.raises(ValueError, match="needs fetch='mask'"):
            CudaStreamFarm(4, RATE, fetch="full", segments=seg,
                           device="cpu")
    with pytest.raises(ValueError, match="fetch must be"):
        CudaStreamFarm(4, RATE, fetch="dense", device="cpu")


def test_farm_dispatch_error_surfaces_and_recovers(small_chunk, monkeypatch):
    """An error on the IO thread is raised by the feed() that drains its
    window, not swallowed; recover_unprocessed() then hands back every
    sample not yet walked, in order."""
    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.runtime.farm import CudaStreamFarm

    def fail(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(cc, "run_chained_masks", fail)
    farm = CudaStreamFarm(2, RATE, fetch="mask", k_chunks=4, segments=1,
                          pipeline_depth=1, device="cpu")
    x = np.arange(2 * 9 * CHUNK, dtype=np.float32).reshape(2, -1)
    with pytest.raises(RuntimeError, match="launch failed"):
        for off in range(0, x.shape[1], CHUNK):
            farm.feed(x[:, off : off + CHUNK])
    left = farm.recover_unprocessed()
    np.testing.assert_array_equal(np.concatenate(left, axis=1),
                                  x[:, : sum(b.shape[1] for b in left)])
    assert farm.stats["walk_s"] == 0.0
