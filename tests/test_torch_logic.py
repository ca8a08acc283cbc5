"""nfclab_torch's ISO7816 logic path against nfclab's on the CPU, exact
everywhere.

- ``dsp/logic_frontend.logic_event_mask`` (device="cpu") bit for bit
  against nfclab's jitted mask on seeded levels with -0.0, NaN, +-inf and
  fractions, [T, C] and [B, T, C], C = 4 and 8, whole and in uneven
  chunks; the edge carry moved both ways between the packages;
  ``event_indices``.
- ``StreamingIsoDecoder(frontend="device", device="cpu")``: the index sets
  and frames of nfclab's device and host frontends.
- ``IsoDecoder``: nfclab's decoder cases of tests/test_iso7816.py (ATR in
  both conventions, T=0, T=1 with LRC and CRC, WTX, a parity error, error
  signalling, a channel map, the seeded fuzz) and seeded
  ``torch_logic_synth.logic_lane`` lanes, one parametrised test: both
  packages give the same frames, and the expected ones.
- ``CudaLogicFarm(device="cpu")`` against nfclab's TpuLogicFarm with the
  default k_samples, k_samples=0, a permuted channel_map and a ragged last
  feed.
- No card: DeviceUnavailable when the farm or the device-frontend decoder
  is built.  A zero-width chunk: the port keeps the carry where nfclab's
  next call raises (ROADMAP Queue 3, deliberate differences).
The cuda-marked tests run the mask and the farm on the card.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (kept on the CPU by conftest.ensure_cpu_devices)

import torch_logic_synth as tls
from torch_logic_synth import (
    SAMPLE_RATE, _session_head, _t1_crc, _xor, make_session,
)

NAMES = ("io_edges", "io_falls", "line_edges", "clk_falls")
LEVELS = np.array([0.0, 1.0, -0.0, 0.5, 0.9921875, 0.25, -1.0, np.nan,
                   np.inf, -np.inf], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _jax_cpu():
    from conftest import ensure_cpu_devices

    ensure_cpu_devices()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the mask's torch operations run "
                    "there only with a card)")


def _levels(shape, seed):
    """Seeded levels: mostly runs of 0/1 (edges are sparse), with special
    values and fractions sprinkled in."""
    rng = np.random.default_rng(seed)
    x = (rng.random(shape) > 0.5).astype(np.float32)
    x = np.repeat(x[..., ::7, :], 7, axis=-2)[..., : shape[-2], :]
    special = rng.random(shape) < 0.05
    x[special] = rng.choice(LEVELS, int(special.sum()))
    return np.ascontiguousarray(x, np.float32)


def _ref_mask(block, carry=None):
    from nfclab.dsp.logic_frontend import logic_event_mask

    m, c = logic_event_mask(block, carry)
    return np.asarray(m), np.asarray(c)


def _port_mask(block, carry=None):
    from nfclab_torch.dsp.logic_frontend import logic_event_mask

    m, c = logic_event_mask(block, carry, device="cpu")
    return m.numpy(), c


@pytest.mark.parametrize("shape", [(5000, 4), (5000, 8), (3, 4000, 4),
                                   (2, 3000, 8)],
                         ids=["T4", "T8", "B3T4", "B2T8"])
def test_event_mask_matches_nfclab(shape):
    x = _levels(shape, seed=sum(shape))
    want, want_c = _ref_mask(x)
    got, got_c = _port_mask(x)
    assert got.dtype == np.uint8 and got.shape == shape[:-1]
    assert np.array_equal(got, want)
    assert np.array_equal(got_c.numpy(), want_c, equal_nan=True)
    assert set(np.unique(got)) - set(range(16)) == set()
    # uneven chunks with the carry threaded: the one-pass mask
    cuts = [0, 1, 777, 778, 2049, shape[-2]]
    carry, parts = None, []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        m, carry = _port_mask(x[..., lo:hi, :], carry)
        parts.append(m)
    assert np.array_equal(np.concatenate(parts, axis=-1), want)


def test_event_mask_edge_semantics():
    """One f32 subtract: -0.0 after 0.0 is no edge, a NaN edge is an
    edge and no fall, inf - inf is NaN; RST or VCC is a line edge."""
    x = np.zeros((8, 4), np.float32)
    x[1] = [-0.0, -0.0, -0.0, -0.0]
    x[2] = [np.nan, 0, 0, 0]
    x[3] = [np.inf, 0, 1, 0]
    x[4] = [np.inf, -1, 1, 0.5]
    x[5] = [-np.inf, -1, 1, 0.5]
    x[6] = [0.25, 0, 0, 0.5]
    got, _ = _port_mask(x)
    want, _ = _ref_mask(x)
    assert got.tolist() == want.tolist() == [0, 0, 1, 5, 13, 3, 5, 7]


def test_carry_moves_both_ways():
    """nfclab masks chunk 1 and the port chunk 2 from np.asarray of
    nfclab's carry, then the reverse; each equals the one-pass mask."""
    x = _levels((2, 6000, 4), seed=11)
    whole, _ = _ref_mask(x)
    m1, c1 = _ref_mask(x[:, :2500])
    m2, _ = _port_mask(x[:, 2500:], c1)
    assert np.array_equal(np.concatenate([m1, m2], axis=1), whole)
    p1, pc = _port_mask(x[:, :3100])
    r2, _ = _ref_mask(x[:, 3100:], pc.numpy())
    assert np.array_equal(np.concatenate([p1, r2], axis=1), whole)


def test_event_indices_equal():
    from nfclab.dsp.logic_frontend import event_indices as ref

    from nfclab_torch.dsp.logic_frontend import event_indices

    mask, _ = _port_mask(_levels((4096, 4), seed=3))
    a, b = event_indices(mask, base=70), ref(mask, base=70)
    assert list(a) == list(b) == list(NAMES)
    for k in NAMES:
        assert a[k].dtype == np.int64 and np.array_equal(a[k], b[k]), k


def _keys(frames):
    from nfclab_torch.apps.decode_cli import frame_json

    return [frame_json(f) for f in frames]


def _stream(dec, x, block):
    out = []
    for off in range(0, len(x), block):
        out.extend(dec.feed(x[off : off + block]))
    out.extend(dec.finish())
    return out


@pytest.mark.parametrize("block", [50_001, 65_536])
def test_streaming_device_frontend_matches_nfclab(block):
    from nfclab.runtime.logic_decoder import (
        IsoDecoder as RefIso, StreamingIsoDecoder as RefStream,
    )

    from nfclab_torch.runtime.logic_decoder import StreamingIsoDecoder

    x = make_session(atr=(0x3B, 0x00),
                     tpdu=[0x00, 0xA4, 0x04, 0x00, 0x00, 0x90, 0x00])
    want = _keys(RefIso().decode(x, SAMPLE_RATE))
    decs = {
        "port_device": StreamingIsoDecoder(SAMPLE_RATE, frontend="device",
                                           device="cpu"),
        "port_host": StreamingIsoDecoder(SAMPLE_RATE),
        "ref_device": RefStream(SAMPLE_RATE, frontend="device"),
        "ref_host": RefStream(SAMPLE_RATE),
    }
    for name, dec in decs.items():
        assert sorted(_keys(_stream(dec, x, block))) == sorted(want), name
    for k in NAMES:
        idx = [d._idx[k].view() for d in decs.values()]
        assert all(np.array_equal(idx[0], i) for i in idx[1:]), k
    assert len(want) > 0


# ----------------------------------------- the one-shot decoder, both packages

def _t1_head(atr=(0x3B, 0x80, 0x01, 0x80 ^ 0x01)):
    w = _session_head()
    for b in atr:
        w.character(b)
    w.hold(80_000)
    for _ in range(2):  # PPS request and response: T=1
        for b in (0xFF, 0x11, 0x11, 0xFF):
            w.character(b)
        w.hold(80_000)
    return w


ATR, REQ, RESP, EXCH = "ATR", "REQUEST", "RESPONSE", "EXCHANGE"
PPS = "ff:11:11:ff"


def _h(bs) -> str:
    return ":".join(f"{b:02x}" for b in bs)


def case_atr_direct():
    return make_session(atr=(0x3B, 0x00)), [(ATR, "3b:00", [])]


def case_atr_historical():
    return (make_session(atr=(0x3B, 0x02, 0x41, 0x42)),
            [(ATR, "3b:02:41:42", [])])


def case_t0_tpdu():
    tpdu = [0x00, 0xA4, 0x04, 0x00, 0x02, 0xA4, 0x3F, 0x00, 0x90, 0x00]
    return (make_session(atr=(0x3B, 0x00), tpdu=tpdu),
            [(ATR, "3b:00", []), (EXCH, _h(tpdu), [])])


def case_t1_switch_and_block():
    w = _t1_head()
    iblock = [0x00, 0x00, 0x02, 0xA4, 0x04, 0x00 ^ 0x02 ^ 0xA4 ^ 0x04]
    rblock = [0x00, 0x00, 0x01, 0x90, 0x00 ^ 0x01 ^ 0x90]
    for blk in (iblock, rblock):
        for b in blk:
            w.character(b)
        w.hold(80_000)
    w.hold(220_000)
    return w.build(), [(ATR, "3b:80:01:81", []), (REQ, PPS, ["request"]),
                       (RESP, PPS, ["response"]),
                       (REQ, _h(iblock), ["request"]),
                       (RESP, _h(rblock), ["response"])]


def case_parity_error():
    w = _session_head()
    w.character(0x3B)
    w.character(0x00, parity_error=True)
    w.hold(300_000)
    return w.build(), [(ATR, "3b:00", ["parity-error"])]


def case_inverse_convention():
    w = _session_head()
    for b in (0x3F, 0x01, 0xA5):
        w.character_inverse(b)
    w.hold(80_000)
    tpdu = [0x00, 0xB0, 0x00, 0x00, 0x01, 0xB0, 0x42, 0x90, 0x00]
    for b in tpdu:
        w.character_inverse(b)
    w.hold(300_000)
    return w.build(), [(ATR, "3f:01:a5", []), (EXCH, _h(tpdu), [])]


def case_t0_error_signal_retransmission():
    tpdu = [0x00, 0xA4, 0x04, 0x00, 0x02, 0xA4, 0x3F, 0x00, 0x90, 0x00]
    w = _session_head()
    w.character(0x3B)
    w.character(0x00)
    w.hold(80_000)
    for i, b in enumerate(tpdu):
        if i == 3:
            w.character_with_error_signal(b)
        w.character(b)
    w.hold(300_000)
    return w.build(), [(ATR, "3b:00", []), (EXCH, _h(tpdu), [])]


def case_t1_crc():
    atr = [0x3B, 0x80, 0x81, 0x41, 0x01]
    atr.append(_xor(atr[1:]))
    w = _t1_head(atr)
    core = bytes([0x00, 0x00, 0x02, 0xA4, 0x04])
    iblock = core + _t1_crc(core)
    core2 = bytes([0x00, 0x00, 0x01, 0x90])
    bad = bytearray(core2 + _t1_crc(core2))
    bad[-1] ^= 0xFF
    for blk in (iblock, bad):
        for b in blk:
            w.character(b)
        w.hold(80_000)
    w.hold(220_000)
    return w.build(), [(ATR, _h(atr), []), (REQ, PPS, ["request"]),
                       (RESP, PPS, ["response"]),
                       (REQ, _h(iblock), ["request"]),
                       (RESP, _h(bad), ["crc-error", "response"])]


def case_t1_wtx_sblocks():
    w = _t1_head()
    seq = []
    for core in ([0x00, 0x00, 0x02, 0xA4, 0x04], [0x00, 0xC3, 0x01, 0x01],
                 [0x00, 0xE3, 0x01, 0x01], [0x00, 0x00, 0x01, 0x90]):
        seq.append(core + [_xor(core)])
    for blk in seq:
        for b in blk:
            w.character(b)
        w.hold(80_000)
    w.hold(300_000)
    kinds = [(REQ, "request"), (RESP, "response")] * 2
    return w.build(), [(ATR, "3b:80:01:81", []), (REQ, PPS, ["request"]),
                       (RESP, PPS, ["response"])] + [
        (k, _h(blk), [fl]) for (k, fl), blk in zip(kinds, seq)]


def case_fuzz_t0_tpdu_exchanges():
    rng = np.random.default_rng(7)
    w = _session_head()
    for b in (0x3B, 0x00):
        w.character(b)
    w.hold(80_000)
    want = [(ATR, "3b:00", [])]
    for _ in range(6):
        ins = 0xA4
        p3 = int(rng.integers(1, 12))
        data = [int(x) for x in rng.integers(0, 256, p3)]
        sw = [0x90, int(rng.integers(0, 256))]
        tpdu = [int(rng.integers(0, 256)) & 0xFE, ins,
                int(rng.integers(0, 256)), int(rng.integers(0, 256)),
                p3, ins] + data + sw
        for b in tpdu:
            w.character(b)
        w.hold(80_000)
        want.append((EXCH, _h(tpdu), []))
    return w.build(), want


def case_lane_seed_5():
    x, sent = tls.logic_lane(1_500_000, seed=5)
    return x, [(None, _h(b), None) for b in sent]


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def _data_frames(lines):
    import json

    keep = (ATR, REQ, RESP, EXCH)
    out = []
    for ln in lines:
        f = json.loads(ln)
        if f["type"] in keep:
            out.append((f["type"], f.get("data", ""), f.get("flags", [])))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_iso_decoder_cases(case):
    """Both packages' IsoDecoder give the same frames (line events
    included), and the data frames the case expects."""
    from nfclab.runtime.logic_decoder import IsoDecoder as RefIso

    from nfclab_torch.runtime.logic_decoder import IsoDecoder

    x, want = CASES[case]()
    got = _keys(IsoDecoder().decode(x, SAMPLE_RATE))
    assert got == _keys(RefIso().decode(x, SAMPLE_RATE))
    data = _data_frames(got)
    assert len(data) == len(want) > 0
    for (t, d, fl), (wt, wd, wfl) in zip(data, want):
        assert d == wd and (wt is None or t == wt), (t, d)
        assert wfl is None or fl == wfl, (d, fl)
    if case == "atr_direct":
        kinds = {ln.split('"type":"')[1].split('"')[0] for ln in got}
        assert "UNKNOWN" in kinds  # the VCC/RST line events


def test_channel_map_permuted_capture():
    """A capture wired [clk, rst, vcc, io] decodes as the unmapped one
    once the map names the wiring: the one-shot decoder (dict and
    sequence), the streaming decoder and nfclab's; identity maps
    normalize away and bad maps are rejected."""
    from nfclab.runtime.logic_decoder import IsoDecoder as RefIso

    from nfclab_torch.runtime.logic_decoder import (
        IsoDecoder, StreamingIsoDecoder, normalize_channel_map,
    )

    x = make_session(atr=(0x3B, 0x00), tpdu=(0x00, 0xB0, 0x00, 0x00, 0x02))
    want = _keys(IsoDecoder().decode(x, SAMPLE_RATE))
    wired = np.ascontiguousarray(x[:, [1, 2, 3, 0]])
    cmap = {"io": 3, "clk": 0, "rst": 1, "vcc": 2}
    assert _keys(IsoDecoder(channel_map=cmap).decode(wired, SAMPLE_RATE)) \
        == want
    assert _keys(IsoDecoder(channel_map=[3, 0, 1, 2]).decode(
        wired, SAMPLE_RATE)) == want
    assert _keys(RefIso(channel_map=cmap).decode(wired, SAMPLE_RATE)) == want
    for fe in ("host", "device"):
        dec = StreamingIsoDecoder(SAMPLE_RATE, channel_map=cmap,
                                  frontend=fe, device="cpu")
        assert _keys(_stream(dec, wired, 1 << 16)) == want
    with pytest.raises(ValueError, match="external event masks"):
        StreamingIsoDecoder(SAMPLE_RATE, channel_map=cmap).feed(
            wired[:10], mask=np.zeros(10, np.uint8))
    assert normalize_channel_map({"io": 0}, 4) is None
    for bad in ([0, 0, 1, 2], {"io": 9}, {"gnd": 1}, [0, 1, 2]):
        with pytest.raises(ValueError):
            normalize_channel_map(bad, 4)


# --------------------------------------------------------------- the farm

def _farm_input():
    sessions = [
        make_session(atr=(0x3B, 0x00),
                     tpdu=[0x00, 0xA4, 0x04, 0x00, 0x00, 0x90, 0x00]),
        make_session(atr=(0x3B, 0x00),
                     tpdu=[0x00, 0xB0, 0x00, 0x08, 0x00, 0x6A, 0x82]),
        make_session(atr=(0x3B, 0x00)),
    ]
    n = max(len(s) for s in sessions)
    blocks = np.ones((len(sessions), n, 4), np.float32)  # idle-high pad
    for i, s in enumerate(sessions):
        blocks[i, : len(s)] = s
        blocks[i, len(s):] = s[-1]  # hold final line levels
    return blocks


def _run_farm(farm, blocks, chunk):
    """Feed through one reused buffer (the farm must copy what it keeps),
    the last feed ragged."""
    got = [[] for _ in range(len(blocks))]
    buf = np.empty((blocks.shape[0], chunk, blocks.shape[2]), np.float32)
    for off in range(0, blocks.shape[1], chunk):
        w = min(chunk, blocks.shape[1] - off)
        buf[:, :w] = blocks[:, off : off + w]
        for i, fr in enumerate(farm.feed(buf[:, :w])):
            got[i].extend(fr)
        buf[:] = np.nan  # a stale buffer must never reach the walk
    for i, fr in enumerate(farm.finish()):
        got[i].extend(fr)
    return [sorted(_keys(g)) for g in got]


@pytest.mark.parametrize("mode", ["default", "k0", "channel_map",
                                  "ragged_window"])
def test_logic_farm_matches_tpu_logic_farm(mode):
    from nfclab.runtime.farm import TpuLogicFarm
    from nfclab.runtime.logic_decoder import IsoDecoder as RefIso

    from nfclab_torch.runtime.farm import CudaLogicFarm

    blocks = _farm_input()
    want = [sorted(_keys(RefIso().decode(b, SAMPLE_RATE))) for b in blocks]
    kw, chunk = {}, 70_000
    if mode == "k0":
        kw["k_samples"] = 0
    elif mode == "channel_map":
        blocks = np.ascontiguousarray(blocks[:, :, [1, 2, 3, 0]])
        kw["channel_map"] = {"io": 3, "clk": 0, "rst": 1, "vcc": 2}
    elif mode == "ragged_window":
        kw["k_samples"], chunk = 96_000, 40_001  # finish() flushes < k
    got = _run_farm(CudaLogicFarm(3, SAMPLE_RATE, device="cpu", **kw),
                    blocks, chunk)
    ref = _run_farm(TpuLogicFarm(3, SAMPLE_RATE, **kw), blocks, chunk)
    assert got == ref == want
    assert all(len(w) > 0 for w in want)


def test_logic_farm_on_lanes():
    """CudaLogicFarm over seeded lanes: each stream's frames are the
    one-shot decoder's and carry the synthesizer's bytes."""
    from nfclab_torch.core.frame import FrameType
    from nfclab_torch.runtime.farm import CudaLogicFarm
    from nfclab_torch.runtime.logic_decoder import IsoDecoder

    lanes = [tls.logic_lane(1_200_000, seed=s) for s in (1, 2)]
    blocks = np.stack([x for x, _ in lanes])
    farm = CudaLogicFarm(2, SAMPLE_RATE, k_samples=1 << 19, device="cpu")
    got = _run_farm(farm, blocks, 1 << 17)
    keep = {int(t) for t in (FrameType.IsoATRFrame, FrameType.IsoRequestFrame,
                             FrameType.IsoResponseFrame,
                             FrameType.IsoExchangeFrame)}
    for i, (x, sent) in enumerate(lanes):
        want = IsoDecoder().decode(x, SAMPLE_RATE)
        assert got[i] == sorted(_keys(want))
        assert [f.data for f in want if f.frame_type in keep] == sent
        assert sent


@pytest.mark.parametrize("what", ["farm", "streaming"])
def test_no_card_raises_device_unavailable(what, monkeypatch):
    from nfclab_torch.dsp.cuda_channels import DeviceUnavailable
    from nfclab_torch.runtime.farm import CudaLogicFarm
    from nfclab_torch.runtime.logic_decoder import StreamingIsoDecoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        if what == "farm":
            CudaLogicFarm(2, SAMPLE_RATE)
        else:
            StreamingIsoDecoder(SAMPLE_RATE, frontend="device")
    # the host frontend needs no card
    StreamingIsoDecoder(SAMPLE_RATE)


def test_zero_width_chunk_keeps_the_carry():
    """A deliberate difference (ROADMAP Queue 3): after a zero-width chunk
    nfclab's logic_event_mask returns an empty carry and its next call
    raises TypeError; the port returns the carry it was given, so the
    mask, the device-frontend decoder and CudaLogicFarm(k_samples=0) go
    on as if the empty chunk had not come."""
    from nfclab.runtime.farm import TpuLogicFarm

    from nfclab_torch.runtime.farm import CudaLogicFarm
    from nfclab_torch.runtime.logic_decoder import StreamingIsoDecoder

    w = _levels((100, 4), seed=5)
    whole, _ = _port_mask(w)
    m, c = _port_mask(w[:50])
    m0, c0 = _port_mask(w[50:50], c)
    assert m0.shape == (0,) and c0 is c
    m1, _ = _port_mask(w[50:], c0)
    assert np.array_equal(np.concatenate([m, m0, m1]), whole)
    r, rc = _ref_mask(w[:50])
    r0, rc0 = _ref_mask(w[50:50], rc)
    assert rc0.shape == (0, 4)
    with pytest.raises(TypeError):
        _ref_mask(w[50:], rc0)

    x = make_session(atr=(0x3B, 0x00), tpdu=(0x00, 0xB0, 0x00, 0x00, 0x02))
    want = _keys(StreamingIsoDecoder(SAMPLE_RATE).feed(x))
    dec = StreamingIsoDecoder(SAMPLE_RATE, frontend="device", device="cpu")
    got = dec.feed(x[:300_000]) + dec.feed(x[:0]) + dec.feed(x[300_000:])
    assert _keys(got) == want

    blocks = _farm_input()[:, :400_000]
    farms = {"port": CudaLogicFarm(3, SAMPLE_RATE, k_samples=0,
                                   device="cpu"),
             "ref": TpuLogicFarm(3, SAMPLE_RATE, k_samples=0)}
    for name, farm in farms.items():
        farm.feed(blocks[:, :200_000])
        farm.feed(blocks[:, 200_000:200_000])
        if name == "ref":
            with pytest.raises(TypeError):
                farm.feed(blocks[:, 200_000:])
        else:
            farm.feed(blocks[:, 200_000:])
            assert all(st._n == 400_000 for st in farm.streams)


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_event_mask_on_the_card(cuda):
    from nfclab_torch.dsp.logic_frontend import logic_event_mask

    x = _levels((4, 100_000, 8), seed=9)
    want, want_c = _port_mask(x)
    m, c = logic_event_mask(x[:, :33_333])
    m2, c2 = logic_event_mask(torch.from_numpy(x[:, 33_333:]).cuda(), c)
    assert m.is_cuda and c2.is_cuda
    got = np.concatenate([m.cpu().numpy(), m2.cpu().numpy()], axis=1)
    assert np.array_equal(got, want)
    assert np.array_equal(c2.cpu().numpy(), want_c.numpy(), equal_nan=True)


@pytest.mark.cuda
def test_logic_farm_on_the_card(cuda):
    from nfclab_torch.runtime.farm import CudaLogicFarm

    blocks = _farm_input()
    want = _run_farm(CudaLogicFarm(3, SAMPLE_RATE, device="cpu"), blocks,
                     70_000)
    for k in (1 << 20, 0):
        farm = CudaLogicFarm(3, SAMPLE_RATE, k_samples=k)
        assert _run_farm(farm, blocks, 70_000) == want
