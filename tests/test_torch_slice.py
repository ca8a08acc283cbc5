"""The port's first slice end to end on the CPU: synthetic captures of the
five decode paths go through chained_batch_masks (the kernels' plain
versions, CHAIN_CHUNK cut to 4096 and 4-chunk windows so the clock fold and
the live-prefix upload both run), and the port's NfcDecoder walks the
device triggers to frames.  The frames must equal the port's host-frontend
frames, nfclab's frames and the bytes the synthesizer wrote; the triggers
must equal one monolithic pass; and no detect-trigger index may be
recomputed on the host (a missed preload key would recompute them silently
and still give the same frames)."""

import numpy as np
import pytest
import torch

import torch_synth

RATE = torch_synth.RATE
TEMPLATES = torch_synth.templates()
NAMES = [tp.name for tp in TEMPLATES]


def _native_ok():
    from nfclab_torch.native.binding import native_available

    return native_available()


@pytest.fixture(scope="module")
def engine_run():
    """(triggers by template name, its ``stats``, wall seconds) of one
    chained_batch_masks call."""
    if not _native_ok():
        pytest.skip("native library unavailable")
    import time

    from nfclab_torch.dsp import cuda_channels as cc

    steps = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cc, "CHAIN_CHUNK", 4096)
        t0 = time.perf_counter()
        res = cc.chained_batch_masks([tp.samples for tp in TEMPLATES], RATE,
                                     k_chunks=4, device="cpu", stats=steps)
        wall = time.perf_counter() - t0
    return dict(zip(NAMES, res)), steps, wall


@pytest.fixture(scope="module")
def triggers(engine_run):
    return engine_run[0]


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """nfclab's decoder runs on a copy of the port's native library (see
    torch_native.py)."""
    from torch_native import use_ref_native

    use_ref_native(tmp_path_factory.mktemp("native"))


def test_slice_step_times_cover_the_engine(engine_run):
    """The engine's ``stats`` hold the seconds of every step under the
    farm's counter names, and they add up to no more than the call's wall
    time."""
    _, steps, wall = engine_run
    assert set(steps) == {"stage_s", "upload_s", "launch_s", "compact_s",
                          "fetch_s"}
    assert all(s >= 0.0 for s in steps.values())
    assert sum(steps.values()) <= wall


# the counters each offline engine adds to its ``stats``
ENGINE_COUNTERS = {
    "chained_batch_masks": {"stage_s", "upload_s", "launch_s", "compact_s",
                            "fetch_s"},
    "_run_batch_chained": {"stage_s", "upload_s", "launch_s", "fetch_s"},
    "fused_batch_all": {"stage_s", "upload_s", "launch_s", "fetch_s",
                        "edge_tracker_s"},
}


@pytest.mark.parametrize("engine", sorted(ENGINE_COUNTERS))
def test_engine_stats_add_the_step_counters(engine, monkeypatch):
    """Each offline engine adds exactly its steps' counters to ``stats``
    (4096-sample chunks, 4-chunk windows, two captures of unequal length),
    each at least zero, and they sum to no more than the call's wall
    time."""
    import functools
    import time

    from nfclab_torch.dsp import cuda_channels as cc

    if engine == "fused_batch_all" and not _native_ok():
        pytest.skip("native library unavailable")
    monkeypatch.setattr(cc, "CHAIN_CHUNK", 4096)
    monkeypatch.setattr(cc, "_run_batch_chained", functools.partial(
        cc._run_batch_chained, chunk=4096))
    caps = [TEMPLATES[0].samples[:9000], TEMPLATES[1].samples[:5000]]
    stats = {}
    t0 = time.perf_counter()
    if engine == "chained_batch_masks":
        out = cc.chained_batch_masks(caps, RATE, k_chunks=4, device="cpu",
                                     stats=stats)
    elif engine == "_run_batch_chained":
        out = cc._run_batch_chained(caps, RATE, 0.01, cc.fetch_names(RATE),
                                    device="cpu", stats=stats)
    else:
        out = cc.fused_batch_all(caps, RATE, device="cpu", stats=stats)
    wall = time.perf_counter() - t0
    assert len(out) == len(caps)
    assert set(stats) == ENGINE_COUNTERS[engine]
    assert all(s >= 0.0 for s in stats.values())
    assert sum(stats.values()) <= wall


def _json_lines(frames, mod):
    return [mod.frame_json(f) for f in frames]


@pytest.mark.parametrize("name", NAMES)
def test_slice_frames(triggers, ref_native, name):
    import nfclab.apps.decode_cli as ref_cli
    import nfclab.runtime.decoder as ref
    import nfclab_torch.apps.decode_cli as port_cli
    from nfclab_torch.core.frame import FrameType
    from nfclab_torch.runtime.decoder import NfcDecoder

    tp = TEMPLATES[NAMES.index(name)]
    dev = NfcDecoder().decode(tp.samples, RATE, tpu_channels=triggers[name])
    host = NfcDecoder().decode(tp.samples, RATE)
    want = ref.NfcDecoder().decode(tp.samples, RATE)
    assert _json_lines(dev, port_cli) == _json_lines(host, port_cli)
    assert _json_lines(dev, port_cli) == _json_lines(want, ref_cli)
    keep = (int(FrameType.NfcPollFrame), int(FrameType.NfcListenFrame))
    assert [f.data for f in dev if f.frame_type in keep] == tp.sent


def test_slice_triggers_equal_monolithic_pass(triggers):
    """The chained windows (folded clocks, carried state, streams dropping
    out as their captures end) give the triggers of one pass per capture
    from clock 0."""
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp.cuda_channels import chained_mask_params
    from nfclab_torch.dsp.frontend import _params_tuple
    from nfclab_torch.dsp.fused_frontend import fused_frontend

    n = max(len(tp.samples) for tp in TEMPLATES)
    n += -n % 128
    x = np.zeros((len(TEMPLATES), n), np.float32)
    for i, tp in enumerate(TEMPLATES):
        x[i, : len(tp.samples)] = tp.samples
    mask = fused_frontend(
        torch.from_numpy(x), _params_tuple(SignalParams(RATE)),
        mask_params=chained_mask_params(0.01), select=("detect_mask",),
    )["detect_mask"].numpy()
    for i, tp in enumerate(TEMPLATES):
        row = mask[i, : len(tp.samples)]
        nz = np.flatnonzero(row)
        got = triggers[tp.name]
        assert got["n"] == len(tp.samples)
        assert np.array_equal(got["detect_idx"], nz)
        assert np.array_equal(got["detect_bits"], row[nz])


@pytest.mark.parametrize("name", NAMES)
def test_slice_no_host_trigger_recompute(triggers, name):
    """Spy on the lazy index getter: a decode fed the device triggers
    computes no sdidx/eidxb channel on the host."""
    import nfclab_torch.dsp.channels as chmod
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp.cuda_channels import preload_channels
    from nfclab_torch.native import condition_exact
    from nfclab_torch.runtime.decoder import (
        CarrierDetector, DecoderContext, NfcDecoder, walk,
    )

    tp = TEMPLATES[NAMES.index(name)]
    params = SignalParams(RATE, power_level_threshold=0.01)
    ctx = DecoderContext(condition_exact(tp.samples, params), RATE, params)
    preload_channels(ctx.channels, triggers[name], RATE, 0.01)

    computed, served = [], []
    orig = chmod.LazyChannels._idx_chan

    def spy(self, key, *a, **k):
        ent = self._cache.get(key)
        if ent is None or ent.get("idx") is None or (
            ent.get("scanned", 0) < self.n
        ):
            computed.append(key)
        else:
            served.append(key)
        return orig(self, key, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chmod.LazyChannels, "_idx_chan", spy)
        techs = NfcDecoder()._make_techs(ctx)
        for te in techs:
            te.initialize()
        walk(ctx, CarrierDetector(ctx), techs, 0)
    missed = [k for k in computed if k[0] in ("sdidx", "eidxb")]
    assert not missed, f"preload missed detect-index keys: {missed}"
    assert any(k[0] in ("sdidx", "eidxb") for k in served)
