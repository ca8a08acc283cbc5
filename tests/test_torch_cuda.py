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


def _boundary_carry(env0, x0, rate, seed):
    from nfclab_torch.core.params import SignalParams

    etu = SignalParams(rate).elementary_time_unit
    rng = np.random.default_rng(seed)
    b, dev = x0.shape[0], x0.device
    return (env0, x0 * 10.0,
            torch.from_numpy(rng.uniform(0, 1e-3, b).astype(np.float32)).to(dev),
            x0.clone(),
            torch.from_numpy(rng.integers(0, 20 * etu, b).astype(
                np.int32)).to(dev),
            torch.from_numpy(rng.integers(0, 3 * etu, b).astype(
                np.int32)).to(dev))


@pytest.mark.parametrize("rate", [RATE, 3_200_000])
def test_scans_on_boundary_lanes_on_card(cuda, rate):
    """cond_scan_kernel and ff_scan_kernel, whose envelope test takes no
    divide, on 2**22 streams whose envelope test sits on its boundary
    (v = env * (1 +- 0.05) moved by a few ulps, env from the subnormals to
    3.4e38, special values): bit-exact against the plain versions, with
    ragged shapes (B not a multiple of 32 or of 4, T below the group size
    and not a multiple of the staged tile) at a clock base near the fold
    modulus."""
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp import conditioner_kernel as ck
    from nfclab_torch.dsp import fused_frontend as ff
    from nfclab_torch.dsp.frontend import _params_tuple
    from torch_synth import boundary_lanes

    pt = _params_tuple(SignalParams(rate))
    # the last case: positive envelopes, so the groups of 16 steps take the
    # positive-envelope test alone
    for i, (b, t, binades, specials) in enumerate((
            ((1 << 22) + 5, 6, (-149, 128), True), (1, 29, (-149, 128), True),
            (999, 37, (-149, 128), True), (1 << 20, 48, (-60, 90), False))):
        env0, x = (torch.from_numpy(a).to(cuda)
                   for a in boundary_lanes(b, t, i, binades, specials))
        init = _boundary_carry(env0, x[:, 0], rate, seed=10 + i)
        for a, w in zip(ck.condition_scan(x, *init, pt),
                        ck.condition_scan_plain(x, *init, pt)):
            assert _same(a, w), (b, t)
    plan = ff.kernel_plan(rate)
    mod = plan.fold_modulus
    keep = ff._extra_names(plan)
    gen = torch.Generator(device=cuda)
    cases = [(1 << 18, 6, mod - 3)] * 16 + [(1000, 250, 0), (1001, 5, mod - 1)]
    for i, (b, t, base) in enumerate(cases):
        env0, x = (torch.from_numpy(a).to(cuda)
                   for a in boundary_lanes(b, t, seed=20 + i))
        carry = _boundary_carry(env0, x[:, 0], rate, seed=40 + i)
        gen.manual_seed(i)
        st = torch.rand(plan.nstate, b, generator=gen, device=cuda) * 1e-2
        for row, val in enumerate(carry[:5]):
            st[row] = val.float()
        x_tm = x.t().contiguous()
        got = ff.fused_scan(x_tm, st, base, pt, plan, keep)
        want = ff._scan_plain(x_tm, st, base, pt, plan, keep)
        assert _same(got[0], want[0]), (b, t, base)
        assert _same(got[2], want[2]), (b, t, base)
        for n in keep:
            assert _same(got[1][n], want[1][n]), (n, b, t, base)


def test_experiment_scans_on_boundary_lanes_on_card(cuda):
    """v2_scan_kernel and serial_probe_kernel, whose envelope test takes no
    divide, on lanes whose test sits on its boundary: bit-exact against
    their plain versions.  v2: crafted state rows 0-4 (a float silence
    count up to twice its timeout), B not a multiple of 32, T below a
    group, not a multiple of 6 or of the 96-row tile, a base whose rings
    wrap inside the chunk, one ending at the int32 guard, and lanes that
    go to zero past the silence timeout.  The probe (zero carry): lanes
    that seed on env0 and then take their boundary sample, groups of 999
    lanes, T below a group and ragged, zeros past the timeout."""
    from nfclab_torch.experiments import fused_v2 as v2
    from nfclab_torch.experiments import probe_serial_floor as psf
    from torch_synth import boundary_lanes, probe_boundary_lanes

    pt, _ = _params()
    rows = ~v2.mask_state_rows().to(cuda)
    gen = torch.Generator(device=cuda)
    top = 2**31 - 2 * v2.RBV_RING
    for i, (b, t, base, off) in enumerate((
            ((1 << 16) + 3, 13, 95, None), (1001, 100, top - 100, None),
            (33, 5, 0, None), (64, 1200, 190, (100, 1150)))):
        env0, x = boundary_lanes(b, t, seed=30 + i)
        if off is not None:
            x[::4, off[0] : off[1]] = 0.0
        env0, x = torch.from_numpy(env0).to(cuda), torch.from_numpy(x).to(cuda)
        carry = _boundary_carry(env0, x[:, 0], RATE, seed=50 + i)
        gen.manual_seed(i)
        st = torch.rand(v2.NSTATE, b, generator=gen, device=cuda) * 1e-2
        for row, val in enumerate(carry[:5]):
            st[row] = val.float()
        x_tm = x.t().contiguous()
        got = v2.v2_scan(x_tm, st, base, pt)
        want = v2._scan_plain(x_tm, st, base, pt)
        assert _same(got[0][:-1], want[0][:-1]), (b, t, base)
        assert _same(got[1][rows], want[1][rows]), (b, t, base)
    for i, (g, lanes, t, off) in enumerate((
            (2, 999, 137, None), (1, 33, 5, None), (1, 256, 1200, (150, 1150)))):
        x = probe_boundary_lanes(g * lanes, t, seed=60 + i, off=off)
        v = torch.from_numpy(np.ascontiguousarray(
            x.reshape(t, g, lanes).transpose(1, 0, 2))).to(cuda)
        for a, w in zip(psf.serial_probe(v), psf.serial_probe_plain(v)):
            assert _same(a, w), (g, lanes, t)


def test_pair_probe_on_boundary_lanes_on_card(cuda):
    """pair_probe_kernel, redesigned on the serial probe's warps with a
    pair-speculative envelope warp, on lanes whose envelope test sits on
    its boundary: seeding windows on special, zero and negative samples,
    field-off stretches past the silence timeout, groups of 999 lanes and
    a ragged tail of pairs.  Equal to serial_probe_kernel and to its plain
    version bit for bit."""
    from nfclab_torch.experiments import probe_pair_spec as pps
    from nfclab_torch.experiments import probe_serial_floor as psf
    from torch_synth import probe_boundary_lanes

    for i, (g, lanes, t, off) in enumerate((
            (2, 999, 136, None), (1, 33, 6, None),
            (1, 256, 1200, (150, 1150)))):
        x = probe_boundary_lanes(g * lanes, t, seed=70 + i, off=off)
        v = torch.from_numpy(np.ascontiguousarray(
            x.reshape(t, g, lanes).transpose(1, 0, 2))).to(cuda)
        before = pps.PAIR.launches
        got = pps.pair_probe(v)
        assert pps.PAIR.launches == before + 1
        for a, s, p in zip(got, psf.serial_probe(v), pps.pair_probe_plain(v)):
            assert _same(a, s), (g, lanes, t)
            assert _same(a, p), (g, lanes, t)


def test_v2_mask_on_boundary_outputs_on_card(cuda):
    """v2_mask_kernel, staged and divide-free, on crafted scan outputs
    whose SD numerators sit at -2..2 ulps of the test's boundary in every
    binade of env (special envelopes included), with the power gate at -1,
    0 and its default; a span boundary, B not a multiple of 4, T below the
    largest lag.  Bit-exact against its plain version, state rows
    included."""
    from nfclab_torch.experiments import fused_v2 as v2
    from torch_synth import mask_boundary_out

    rows = v2.mask_state_rows().to(cuda)
    for i, (case, mp, t, b, base) in enumerate((
            ("a", (-1.0, 0.75, 0.10, 0.50, 0.50), 2100, 1029, 0),
            ("f", (0.0, 0.75, 0.10, 0.50, 0.50), 300, 512, 95),
            ("a", (0.01, 0.75, 0.10, 0.50, 0.50), 700, 64, 2**31 - 1648))):
        out, st = (torch.from_numpy(a).to(cuda)
                   for a in mask_boundary_out(t, b, 90 + i, case, mp))
        out_k, so_k = out.clone(), torch.zeros_like(st)
        v2.v2_mask(out_k, st, so_k, base, mp)
        so_p = torch.zeros_like(st)
        v2._mask_plain(out, st, so_p, base, mp)
        assert _same(out_k[-1], out[-1]), (case, t, b, base)
        assert _same(so_k[rows], so_p[rows]), (case, t, b, base)


@pytest.mark.parametrize("rate", [10_000_000, 3_200_000, 40_000_000])
def test_ff_mask_on_boundary_channels_on_card(cuda, rate):
    """ff_mask_kernel, staged per lag window and with its float32 band in
    front of sd_above, on crafted channels whose SD numerators sit on the
    test's boundary and on the band's edge, lookbacks before the chunk
    included, with the power gate at -1, 0 and its default; a span
    boundary, B not a multiple of 4, T below the largest lag.  Bit-exact
    against _mask_plain: mask, mod_depth and the history rows."""
    from nfclab_torch.dsp import fused_frontend as ff
    from torch_synth import ff_mask_boundary_deps

    plan = ff.kernel_plan(rate)
    lay = ff._layout(plan)
    rows = slice(lay.hist_off, lay.hist_off + lay.hist_rows)
    for i, (case, mp, t, b) in enumerate((
            (0, (-1.0, 0.75, 0.10, 0.50, 0.50), 2100, 1029),
            (1, (0.0, 1.0, 0.10, 0.25, 1.0), 300, 512),
            (0, (0.01, 0.75, 0.10, 0.50, 0.50), 700, 64))):
        deps, value, st = (torch.from_numpy(a).to(cuda)
                           for a in ff_mask_boundary_deps(plan, t, b, 40 + i,
                                                          case, mp))
        so_k, so_p = torch.zeros_like(st), torch.zeros_like(st)
        got = ff.fused_mask(deps, value, st, so_k, mp, plan, True, True)
        want = ff._mask_plain(deps, value, st, so_p, mp, plan, True, True)
        for n in want:
            assert _same(got[n], want[n]), (rate, case, t, b, n)
        assert _same(so_k[rows], so_p[rows]), (rate, case, t, b)
