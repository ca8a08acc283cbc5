"""The port's live capture path (runtime/pipeline.py: RadioDecoderTask and
_MaskLiveDecoder) against nfclab's on the CPU; its CLI is tested in
tests/test_torch_live_cli.py.

The mask frontend's live decoder is a one-stream CudaStreamFarm in mask
mode with k_chunks=8, which the farm's policy splits into 4 segments; on
the CPU (device="cpu") it runs the kernels' plain versions.  As in
tests/test_torch_farm.py, CHAIN_CHUNK is cut to 4096 in both packages for
the in-process runs, so a window is 32768 samples.  Captures come from
tests/torch_synth.py and are served through the mock servers of
tests/torch_sdr_mocks.py: the reference WAVs that nfclab's own live tests
read are not on this host.

- RadioDecoderTask(frontend="mask", device="cpu") fed SignalBuffers through
  Executor gives exactly the frames of nfclab's RadioDecoderTask with the
  mask frontend (its engines stubbed by the CPU mask oracle, as nfclab's
  test_live_mask_frontend_task does) and with the host frontend.
- The one-stream policy: 4 segments, frames equal to segments=1.
- No fallback: a dispatch that fails mid-session ends the task in
  "error", after which no frame is published.
The cuda-marked test runs the task on the card instead.
"""

import queue
import time

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (kept on the CPU by conftest.ensure_cpu_devices)

import torch_synth

RATE = torch_synth.RATE
TEMPLATES = torch_synth.templates()
CHUNK = 4096
BLOCK = 65536


@pytest.fixture(autouse=True, scope="module")
def _native():
    from nfclab_torch.native.binding import native_available

    if not native_available():
        pytest.skip("native library unavailable")


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """nfclab's decoders condition natively: its binding loads a copy of
    the port's library (see torch_native.py)."""
    from torch_native import use_ref_native

    use_ref_native(tmp_path_factory.mktemp("native"))


@pytest.fixture
def small_chunk(monkeypatch):
    import nfclab.dsp.tpu_channels as tc

    from nfclab_torch.dsp import cuda_channels as cc

    monkeypatch.setattr(tc, "CHAIN_CHUNK", CHUNK)
    monkeypatch.setattr(cc, "CHAIN_CHUNK", CHUNK)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (nfclab_torch's kernels run only "
                    "there)")


@pytest.fixture
def live_farms(monkeypatch):
    """The farms the port's live mask decoders build, in order."""
    import nfclab_torch.runtime.pipeline as rp

    farms = []

    class Recording(rp._MaskLiveDecoder):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            farms.append(self._farm)

    monkeypatch.setattr(rp, "_MaskLiveDecoder", Recording)
    return farms


def _json(frames, ref=False):
    if ref:
        from nfclab.apps.decode_cli import frame_json
    else:
        from nfclab_torch.apps.decode_cli import frame_json

    return [frame_json(f) for f in frames]


def _capture(names, seed, pause=None):
    """torch_synth lanes of the named templates back to back, each its
    template once plus 4096 samples of carrier; `pause` = (start, length)
    puts a field-off stretch (noise about zero) there."""
    parts = []
    for i, name in enumerate(names):
        tp = next(t for t in TEMPLATES if t.name == name)
        parts.append(torch_synth.lane(tp, len(tp.samples) + 4096,
                                      seed=seed + i)[0])
    x = np.concatenate(parts)
    if pause is not None:
        lo, n = pause
        rng = np.random.default_rng(seed)
        x[lo : lo + n] = np.float32(2e-3) * rng.standard_normal(
            n).astype(np.float32)
    return x


def _host_frames(x, window=1 << 20):
    from nfclab_torch.runtime.streaming import StreamingNfcDecoder

    dec = StreamingNfcDecoder(RATE, window=window)
    out = []
    for off in range(0, len(x), BLOCK):
        out.extend(dec.feed(x[off : off + BLOCK]))
    out.extend(dec.finish())
    return out


def _run_task(ref, x, frontend, **kw):
    """One session of RadioDecoderTask (nfclab's when `ref`) fed `x` in
    65536-sample SignalBuffers through Executor: (frames, the task's
    statuses, [("frame" | "status", item)] in publication order)."""
    if ref:
        from nfclab.hw import SignalBuffer, SignalType
        from nfclab.runtime.pipeline import Executor, RadioDecoderTask
        from nfclab.runtime.subject import Subject
    else:
        from nfclab_torch.hw import SignalBuffer, SignalType
        from nfclab_torch.runtime.pipeline import Executor, RadioDecoderTask
        from nfclab_torch.runtime.subject import Subject

    Subject.clear_registry()
    events, done = [], queue.Queue()

    def on_frame(f):
        events.append(("frame", f))
        if f is None:
            done.put(None)

    def on_status(s):
        events.append(("status", s))
        if s.get("status") == "error":
            done.put(s)

    Subject.name("radio.decoder.frame").subscribe(on_frame, replay=False)
    Subject.name("radio.decoder.status").subscribe(on_status, replay=False)
    task = RadioDecoderTask(frontend=frontend, **kw)
    ex = Executor(pool_size=1)
    ex.submit(task)
    raw = Subject.name("radio.signal.raw")
    try:
        for off in range(0, len(x), BLOCK):
            raw.next(SignalBuffer(
                x[off : off + BLOCK], RATE, off,
                signal_type=SignalType.SIGNAL_TYPE_RADIO_SAMPLES,
            ))
        raw.next(SignalBuffer.eof(RATE))
        done.get(timeout=300)
    finally:
        ex.shutdown()
    frames = [f for k, f in events if k == "frame" and f is not None]
    statuses = [s for k, s in events if k == "status"]
    return frames, statuses, events


class _RefStubs:
    """nfclab's engines answered by the CPU mask oracle of the capture
    (the stubs of nfclab's test_live_mask_frontend_task, with the
    segmented engine too: nfclab's farm also splits a one-stream window
    into 4 segments)."""

    def __init__(self, x, mask):
        self.x, self.mask, self.t = x, mask, 0
        self.calls = {"serial": 0, "seg": 0}

    def _oracle(self, blocks):
        lo, n = self.t, blocks.shape[1]
        np.testing.assert_array_equal(blocks[0], self.x[lo : lo + n])
        seg = self.mask[lo : lo + n]
        rel = np.flatnonzero(seg).astype(np.int64)
        self.t = lo + n
        return [(rel, seg[rel])]

    def _carry(self):
        return {"pen": np.zeros((1, 3), np.float32),
                "end": np.zeros((1, 3), np.float32)}

    def run(self, blocks, state, base0, pt, mp, cap_div=16, chunk=None,
            sample_rate=RATE, want_carry=False):
        self.calls["serial"] += 1
        out = self._oracle(blocks)
        return (out, state, self._carry()) if want_carry else (out, state)

    def seg(self, blocks, carry, pt, mp, segments, cap_div=16, chunk=None,
            sample_rate=RATE, k_bucket=32, device=None):
        assert segments == 4
        self.calls["seg"] += 1
        out = self._oracle(blocks)
        return out, dict(self._carry(), tail=blocks[:, -CHUNK:].copy()), {
            "repaired_streams": 0, "repair_chunks": 0}

    def install(self, mp):
        import nfclab.dsp.tpu_channels as tc

        mp.setattr(tc, "run_chained_masks", self.run)
        mp.setattr(tc, "run_segmented_masks", self.seg)
        mp.setattr(tc, "chain_state0", lambda *a, **k: object())
        mp.setattr(tc, "_expand_state", lambda n: (lambda rows: object()))


def _no_fallback(statuses):
    assert statuses, "no status published"
    assert not [s for s in statuses if s.get("status") == "error"], statuses
    assert not [s for s in statuses if "frontend_fallback" in s], statuses


@pytest.mark.parametrize("names", [
    ("nfca_106k", "nfcb"), ("nfca_424k_bpsk", "nfcf"), ("nfcv", "nfca_106k"),
], ids=lambda n: "+".join(n))
def test_mask_task_equals_nfclab_tasks(ref_native, small_chunk, live_farms,
                                       names):
    """The port's RadioDecoderTask(frontend="mask", device="cpu") gives
    exactly the frames of nfclab's RadioDecoderTask(frontend="mask") with
    its engines stubbed by the CPU mask oracle, and of nfclab's
    RadioDecoderTask(frontend="host"); neither mask task falls back."""
    from conftest import ensure_cpu_devices
    from test_torch_farm import _cpu_mask

    from nfclab_torch.core.frame import FrameType

    ensure_cpu_devices()
    x = _capture(names, seed=400 + len(names[0]))
    got, st, _ = _run_task(False, x, "mask", device="cpu")
    _no_fallback(st)
    (farm,) = live_farms
    assert farm.segments == 4 and farm.k_chunks == 8
    assert farm.stats["dispatches"] >= 3 and farm.stats["seg_dispatches"] >= 1

    stubs = _RefStubs(x, _cpu_mask(x))
    with pytest.MonkeyPatch.context() as mp:
        stubs.install(mp)
        ref_mask, ref_st, _ = _run_task(True, x, "mask")
    _no_fallback(ref_st)
    assert stubs.calls["seg"] >= 1 and stubs.t >= 3 * 8 * CHUNK
    ref_host, _, _ = _run_task(True, x, "host")
    assert _json(got) == _json(ref_mask, ref=True) == _json(ref_host, ref=True)
    assert got == _host_frames(x)
    keep = (int(FrameType.NfcPollFrame), int(FrameType.NfcListenFrame))
    sent = [b for n in names for t in TEMPLATES if t.name == n for b in t.sent]
    assert [f.data for f in got if f.frame_type in keep] == sent


def test_one_stream_policy_segments_equal_serial(small_chunk, live_farms):
    """With one stream and k_chunks=8 the farm picks 4 segments; on a
    capture whose field-off stretch crosses a segment boundary the
    segmented windows repair and back off, and the frames equal those of
    the same farm with segments=1 and of the host streaming decoder."""
    from nfclab_torch.runtime.farm import CudaStreamFarm
    from nfclab_torch.runtime.pipeline import _MaskLiveDecoder

    assert _MaskLiveDecoder(RATE, device="cpu")._farm.segments == 4
    live_farms.clear()
    w = 8 * CHUNK
    x = _capture(("nfca_106k", "nfcf"), seed=450,
                 pause=(w + 2 * CHUNK - 3000, 9000))
    got, st, _ = _run_task(False, x, "mask", device="cpu")
    _no_fallback(st)
    farm = live_farms[0]
    assert farm.stats["repaired_streams"] >= 1
    assert farm.stats["seg_backoff_windows"] >= 1

    serial = CudaStreamFarm(1, RATE, fetch="mask", k_chunks=8, segments=1,
                            window=1 << 20, device="cpu")
    want = []
    for off in range(0, len(x), BLOCK):
        want.extend(serial.feed(x[None, off : off + BLOCK])[0])
    want.extend(serial.finish()[0])
    assert serial.stats["seg_dispatches"] == 0
    assert got == want == _host_frames(x)


def test_dispatch_failure_ends_the_task_in_error(small_chunk, monkeypatch):
    """A dispatch that fails mid-session (the second window's) is not
    replayed through the host path: the task's status goes to "error"
    and no frame is published after it, not even the session's EOF
    sentinel."""
    from nfclab_torch.dsp import cuda_channels as cc

    orig, calls = cc.run_chained_masks, []

    def fail_second(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("kernel launch failed")
        return orig(*a, **k)

    monkeypatch.setattr(cc, "run_chained_masks", fail_second)
    monkeypatch.setattr(cc, "run_segmented_masks", fail_second)
    x = _capture(("nfca_106k", "nfcb", "nfcf"), seed=470)
    _, statuses, events = _run_task(False, x, "mask", device="cpu")
    assert statuses[-1]["status"] == "error"
    assert "kernel launch failed" in statuses[-1]["error"]
    time.sleep(0.5)  # nothing may follow, even after a while
    first_err = next(i for i, (k, s) in enumerate(events)
                     if k == "status" and s["status"] == "error")
    assert all(k == "status" for k, _ in events[first_err:])
    assert len(calls) >= 2


@pytest.mark.cuda
def test_mask_task_on_the_card(cuda, live_farms):
    """RadioDecoderTask(frontend="mask") on the card, at the real chunk:
    frames equal the host streaming decoder's, both kernels launched (the
    scan on the narrow kernel at the live path's widths), the farm in 4
    segments."""
    from nfclab_torch.dsp import fused_frontend as ff

    x = np.concatenate([torch_synth.lane(tp, 8 * BLOCK, seed=600 + i)[0]
                        for i, tp in enumerate(TEMPLATES)])
    for k in (*ff.KERNELS, ff.SCAN_NARROW):
        k.launches = 0
    got, st, _ = _run_task(False, x, "mask")
    _no_fallback(st)
    assert all(k.launches > 0 for k in ff.KERNELS)
    assert ff.SCAN_NARROW.launches == ff.SCAN.launches
    assert live_farms[0].segments == 4
    assert live_farms[0].stats["seg_dispatches"] >= 1
    assert got == _host_frames(x)
