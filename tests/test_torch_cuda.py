"""nfclab_torch's CUDA kernels on the card (marker `cuda`; they skip on a
machine without one).  Run them on the GPU machine with

    python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel must equal its plain PyTorch version bit for bit on the same
CUDA inputs (the experiments/ counterparts included), the mask path on
CUDA must give the triggers of the CPU path, and the device conditioner on
CUDA must equal the C++ oracle."""

import numpy as np
import pytest
import torch

from torch_synth import mixed_lanes, templates

pytestmark = pytest.mark.cuda

RATE = 10_000_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (nfclab_torch's kernels run only there)")
    return torch.device("cuda", 0)


def _same(a, b):
    if a.dtype.is_floating_point:
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool(torch.equal(a, b))


def _params():
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.core.thresholds import DecoderThresholds
    from nfclab_torch.dsp.frontend import _params_tuple

    return (_params_tuple(SignalParams(RATE)),
            DecoderThresholds().detect_mask_tuple(0.01))


@pytest.mark.parametrize("select", [None, ("detect_mask",)])
def test_kernels_equal_plain_on_card(cuda, select):
    from nfclab_torch.dsp import fused_frontend as ff

    pt, mp = _params()
    x = torch.from_numpy(mixed_lanes(300, 1024, seed=2)).to(cuda)
    before = (ff.SCAN.launches, ff.MASK.launches)
    st = stp = None
    for off in (0, 512):
        got, st = ff.fused_frontend(x[:, off : off + 512], pt,
                                    mask_params=mp, state=st, base=40 + off,
                                    return_state=True, select=select)
        want, stp = ff.fused_frontend_plain(
            x[:, off : off + 512], pt, mask_params=mp, state=stp,
            base=40 + off, return_state=True, select=select)
        for k in want:
            assert _same(got[k], want[k]), k
        assert _same(st, stp)
    assert ff.SCAN.launches == before[0] + 2
    assert ff.MASK.launches == before[1] + 2


def test_chained_masks_cuda_equal_cpu(cuda, monkeypatch):
    from nfclab_torch.dsp import cuda_channels as cc

    monkeypatch.setattr(cc, "CHAIN_CHUNK", 4096)
    caps = [tp.samples for tp in templates()]
    got = cc.chained_batch_masks(caps, RATE, k_chunks=4, device="cuda")
    want = cc.chained_batch_masks(caps, RATE, k_chunks=4, device="cpu")
    for g, w in zip(got, want):
        assert g["n"] == w["n"]
        assert np.array_equal(g["detect_idx"], w["detect_idx"])
        assert np.array_equal(g["detect_bits"], w["detect_bits"])


def test_condition_kernel_equals_plain_on_card(cuda):
    """cond_scan_kernel against condition_scan_plain: 300 streams (not a
    multiple of the 32-thread block) from a seeded state with non-zero
    clocks and pulse counts, two chained calls against one."""
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp import conditioner_kernel as ck

    pt, _ = _params()
    etu = SignalParams(RATE).elementary_time_unit
    x = torch.from_numpy(mixed_lanes(300, 1000, seed=3)).to(cuda)
    rng = np.random.default_rng(4)
    init = (x[:, 0] * 1.05, x[:, 0] * 10.0,
            torch.full((300,), 1e-4, device=cuda), x[:, 0].clone(),
            torch.from_numpy(rng.integers(0, 20 * etu, 300).astype(
                np.int32)).to(cuda),
            torch.from_numpy(rng.integers(0, 3 * etu, 300).astype(
                np.int32)).to(cuda))
    before = ck.COND.launches
    whole = ck.condition_scan(x, *init, pt)
    want = ck.condition_scan_plain(x, *init, pt)
    assert ck.COND.launches == before + 1
    for a, b in zip(whole, want):
        assert _same(a, b)
    first = ck.condition_scan(x[:, :613], *init, pt)
    env, w1, mdev, avg, _, pulse = (o[:, -1].contiguous() for o in first)
    second = ck.condition_scan(x[:, 613:], env, w1, mdev, avg, pulse,
                               init[5] + 613, pt)
    for a, b, c in zip(whole, first, second):
        assert _same(a, torch.cat([b, c], 1))


def test_v2_kernels_equal_plain_on_card(cuda):
    """fused_v2_scan and fused_v2_mask against the plain versions: 300
    streams, two chained chunks (the second looks back across the first
    and into the zero rings before the stream), state included."""
    from nfclab_torch.experiments import fused_v2 as v2

    pt, mp = _params()
    x = torch.from_numpy(mixed_lanes(300, 1024, seed=5)).to(cuda)
    before = [k.launches for k in v2.KERNELS]
    st = stp = None
    for off in (0, 512):
        got, st = v2.fused_frontend(x[:, off : off + 512], pt,
                                    mask_params=mp, state=st, base=40 + off,
                                    return_state=True)
        want, stp = v2.fused_frontend_plain(
            x[:, off : off + 512], pt, mask_params=mp, state=stp,
            base=40 + off, return_state=True)
        for k in want:
            assert _same(got[k], want[k]), k
        assert _same(st, stp)
    assert [k.launches for k in v2.KERNELS] == [n + 2 for n in before]


@pytest.mark.parametrize("mode", ["serial", "pair"])
def test_probe_kernels_equal_plain_on_card(cuda, mode):
    """The conditioning probes against their plain versions on 2 groups x
    320 lanes (not a multiple of the 32-thread block), with field-off
    stretches past the silence timeout and a zero first sample; pair
    equals serial bit for bit."""
    from nfclab_torch.experiments import probe_pair_spec as pps

    x = mixed_lanes(640, 2400, seed=6)
    x[::4, 300:1700] = 0.0
    x[0, 0] = 0.0
    v = torch.from_numpy(np.ascontiguousarray(
        x.reshape(2, 320, 2400).transpose(0, 2, 1))).to(cuda)
    got = pps.pair_probe(v, mode)
    want = pps.pair_probe_plain(v, mode)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    other = pps.pair_probe(v, "pair" if mode == "serial" else "serial")
    for a, b in zip(got, other):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_copy_probe_equals_plain_on_card(cuda):
    """The copy kernel on an unaligned view with a ragged tail, several
    sweeps: equal to torch.mul bit for bit."""
    from nfclab_torch.experiments import membw_probe as mb

    base = torch.rand(4 * 1000 + 3, device=cuda)
    x = base[1:]          # 4-byte offset: the wrapper realigns it
    before = mb.COPY.launches
    got = mb.copy_probe(x, nout=5, sweeps=3)
    want = mb.copy_probe_plain(x, nout=5)
    assert mb.COPY.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_condition_jax_and_frontend_on_card(cuda):
    """condition_jax on the card equals the C++ oracle; the dense
    frontend's conditioning channels and masks equal its CPU run."""
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp.conditioner import condition_jax
    from nfclab_torch.dsp.frontend import jitted_frontend
    from nfclab_torch.native import condition_exact

    tp = templates()
    x = np.concatenate([tp[0].samples, np.zeros(150_000, np.float32),
                        tp[2].samples])
    stats = {}
    got = condition_jax(x, SignalParams(RATE), block=32768, halo=8192,
                        device="cuda", stats=stats)
    want = condition_exact(x, SignalParams(RATE))
    for name in ("envelope", "filtered", "deviation", "average",
                 "mod_depth", "edge_peak", "edge_time"):
        a, b = getattr(got, name), getattr(want, name)
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), name
    assert stats["repairs"] >= 1
    xs = torch.from_numpy(mixed_lanes(16, 4096, seed=8))
    dev_out = jitted_frontend(RATE)(xs)
    cpu_out = jitted_frontend(RATE, device="cpu")(xs)
    for k, v in cpu_out.items():
        if k in ("envelope", "filtered", "deviation", "average",
                 "mod_depth") or v.dtype == torch.bool:
            assert _same(dev_out[k].cpu(), v), k
