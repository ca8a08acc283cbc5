"""The port's full-fetch farm mode on the CPU (the kernels' plain versions):
``KernelFedStream`` (a copy of nfclab's, held by test_torch_copies.py) and
``CudaStreamFarm(fetch="full")``.

- KernelFedStream fed the chunks of ``fused_frontend_stream`` (every
  output, unmargined mask params, 16384-sample chunks with carried state)
  gives the host ``StreamingNfcDecoder``'s frames and the bytes the
  synthesizer wrote, whole and windowed (window=65536, slack=2, so the
  buffers compact), as nfclab's tests/test_farm.py does with host-built
  channels; one stream of each template, ``torch_synth.lane`` copies
  repeated three or four times.
- The farm with fetch="full" over one lane of each template, fed widths
  that are multiples of TILE but not of the fold modulus (so the folded
  kernel base takes every residue), gives the host frames too; a ragged
  width is refused.
"""

import numpy as np
import pytest
import torch

import torch_synth

RATE = torch_synth.RATE
TEMPLATES = torch_synth.templates()
NAMES = [tp.name for tp in TEMPLATES]
CHUNK = 16384
STREAM_LEN = 11 * CHUNK       # three or four repetitions of a template
WINDOW = 1 << 16


def _native_ok():
    from nfclab_torch.native.binding import native_available

    return native_available()


def _keys(frames):
    from nfclab_torch.apps.decode_cli import frame_json

    return [frame_json(f) for f in frames]


def _sent(frames):
    from nfclab_torch.core.frame import FrameType

    keep = (int(FrameType.NfcPollFrame), int(FrameType.NfcListenFrame))
    return [f.data for f in frames if f.frame_type in keep]


def _host(x, window=None, block=CHUNK):
    from nfclab_torch.runtime.streaming import StreamingNfcDecoder

    dec = (StreamingNfcDecoder(RATE) if window is None
           else StreamingNfcDecoder(RATE, window=window, slack=2))
    out = []
    for lo in range(0, len(x), block):
        out.extend(dec.feed(x[lo : lo + block]))
    out.extend(dec.finish())
    return out, dec


@pytest.fixture(scope="module")
def streams():
    """(lanes [5, STREAM_LEN], repeats, per-chunk kernel outputs as numpy
    [5, CHUNK] arrays) of one fused_frontend_stream pass."""
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.core.thresholds import DecoderThresholds
    from nfclab_torch.dsp.frontend import _params_tuple
    from nfclab_torch.dsp.fused_frontend import fused_frontend_stream

    lanes = [torch_synth.lane(tp, STREAM_LEN, seed=600 + i)
             for i, tp in enumerate(TEMPLATES)]
    x = np.stack([s for s, _ in lanes])
    chunks = [
        {k: v.numpy() for k, v in res.items()}
        for _, res in fused_frontend_stream(
            torch.from_numpy(x), _params_tuple(SignalParams(RATE)),
            chunk=CHUNK,
            mask_params=DecoderThresholds().detect_mask_tuple(0.01),
        )
    ]
    return x, [r for _, r in lanes], chunks


def _kernel_fed(x, chunks, i, window=None):
    from nfclab_torch.dsp.cuda_channels import box_keys
    from nfclab_torch.runtime.farm import _COND_KEYS, KernelFedStream

    dec = (KernelFedStream(RATE) if window is None
           else KernelFedStream(RATE, window=window, slack=2))
    out = []
    for k, res in enumerate(chunks):
        lo = k * CHUNK
        out.extend(dec.feed_external(
            x[i, lo : lo + CHUNK],
            {n: res[n][i] for n in _COND_KEYS},
            {n: res[n][i] for n in box_keys(RATE)},
            res["detect_mask"][i],
        ))
    out.extend(dec.finish())
    return out, dec


@pytest.mark.parametrize("name", NAMES)
def test_kernel_fed_stream_gives_host_frames(streams, name):
    x, reps, chunks = streams
    i = NAMES.index(name)
    got, _ = _kernel_fed(x, chunks, i)
    want, _ = _host(x[i])
    assert _keys(got) == _keys(want)
    assert _sent(got) == TEMPLATES[i].sent * reps[i]


@pytest.mark.parametrize("name", NAMES)
def test_windowed_kernel_fed_stream_gives_host_frames(streams, name):
    x, reps, chunks = streams
    i = NAMES.index(name)
    got, dec = _kernel_fed(x, chunks, i, window=WINDOW)
    want, ref = _host(x[i], window=WINDOW)
    assert dec.base > 0 and ref.base > 0, "the window never compacted"
    assert _keys(got) == _keys(want)
    assert _sent(got) == TEMPLATES[i].sent * reps[i]


def test_kernel_fed_stream_refuses_host_feeds():
    from nfclab_torch.runtime.farm import KernelFedStream

    with pytest.raises(TypeError, match="feed_external"):
        KernelFedStream(RATE).feed(np.zeros(128, np.float32))


FEED = 10_368   # 81 x 128: a multiple of TILE, not of the fold modulus
FARM_LEN = 65_536


def test_full_farm_gives_host_frames():
    if not _native_ok():
        pytest.skip("native library unavailable")
    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.runtime.farm import CudaStreamFarm

    lanes = [torch_synth.lane(tp, FARM_LEN, seed=700 + i)
             for i, tp in enumerate(TEMPLATES)]
    x = np.stack([s for s, _ in lanes])
    farm = CudaStreamFarm(len(lanes), RATE, device="cpu")
    assert farm.fetch == "full"
    with pytest.raises(ValueError, match="multiple of 128"):
        farm.feed(x[:, :100])
    frames = [[] for _ in lanes]
    buf = np.empty((len(lanes), FEED), np.float32)
    feeds = 0
    s0, m0 = ff.SCAN.launches, ff.MASK.launches
    for lo in range(0, FARM_LEN, FEED):
        w = min(FEED, FARM_LEN - lo)
        buf[:, :w] = x[:, lo : lo + w]   # one reused buffer
        for i, new in enumerate(farm.feed(buf[:, :w])):
            frames[i].extend(new)
        feeds += 1
    for i, new in enumerate(farm.finish()):
        frames[i].extend(new)
    # the plain versions never count a launch
    assert (ff.SCAN.launches, ff.MASK.launches) == (s0, m0)
    st = farm.stats
    assert st["dispatches"] == feeds
    assert st["drained_samples"] == len(lanes) * FARM_LEN
    assert st["walk_s"] > 0 and st["device_s"] > 0
    assert farm._clock == FARM_LEN
    for i, (tp, (s, reps)) in enumerate(zip(TEMPLATES, lanes)):
        want, _ = _host(s)
        assert _keys(frames[i]) == _keys(want), tp.name
        assert _sent(frames[i]) == tp.sent * reps, tp.name
