"""nfclab_torch's segmented speculative engine
(cuda_channels.run_segmented_masks) on the CPU.

1. Against nfclab's engine with real kernels: nfclab's run_chained_masks
   (want_carry=True) and run_segmented_masks run the Pallas kernel in TPU
   interpret mode, the port's run the kernels' plain versions, on the same
   numpy input: 2 streams, 2 segments of 1 chunk of 512 samples (the
   10 MS/s fold modulus, the smallest legal chunk), after a serial first
   window of 2 chunks.  Stream 0 verifies: a carrier at 2**-30 (a fixed
   point of the envelope, so the speculative seed equals the true state
   but for the average) that steps up 10**9-fold at the first halo
   sample, which leaves the seed's error in the slow average far below
   an ulp after 512 samples.  Stream 1 has a field-off pause over the
   segment boundary, so it repairs.

   The two engines' arithmetic is not bit-identical (XLA:CPU contracts
   FMAs in interpret mode: ROADMAP Queue 3, the last two notes), yet
   their verify decisions can agree bit for bit: each engine compares
   its own speculative lane against its own predecessor lane, two
   trajectories of the same arithmetic over the same samples, so where
   they merge in one engine they merge in the other.  Held: the
   decisions (which stream repaired), repaired_streams and
   repair_chunks equal; the triggers equal outside the samples
   torch_parity.tainted marks; the pen/end carry rows of both windows
   within torch_parity's state tolerance on the columns the FMA moves
   little (the squared and product rings and sums, which it moves
   more, are held exactly against recomputations in
   test_torch_fused_parity.py and test_torch_state_interop.py).

2. Against the port's own serial chain (CHAIN_CHUNK 4096, 4-chunk
   windows): for 2 and 4 segments, rows 0-4 (env, w1, mdev, avg, pulse)
   of the new pen/end carry equal the serial chain's bit for bit, for
   the accepted streams and for a stream forced to repair by a pause
   across a segment boundary.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (kept on the CPU by conftest.ensure_cpu_devices)

import torch_parity as tp
import torch_synth

RATE = torch_synth.RATE
TEMPLATES = torch_synth.templates()
ICHUNK = 512            # interpret-mode chunk
NVER = 5


def _interp_input():
    x = np.empty((2, 4 * ICHUNK), np.float32)
    x[0, : 2 * ICHUNK + 1] = 2.0 ** -30
    x[0, 2 * ICHUNK + 1 :] = TEMPLATES[0].samples[2000 : 2000 + 2 * ICHUNK - 1]
    x[1] = TEMPLATES[1].samples[5000 : 5000 + 4 * ICHUNK]
    x[1, 1300:1800] = 0.0  # across the boundary at 1536
    return x


def _engine(mod, x, state0, device_kw):
    """(window-1 per-stream triggers and carry, window-2 triggers, new
    carry, stats, repaired stream ids) of one package's engines."""
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp.frontend import _params_tuple

    pt = _params_tuple(SignalParams(RATE))
    mp = mod.chained_mask_params(0.01)
    w = 2 * ICHUNK
    per1, _, c1 = mod.run_chained_masks(x[:, :w], state0, 0, pt, mp,
                                        chunk=ICHUNK, want_carry=True)
    carry = {"pen": c1["pen"], "end": c1["end"],
             "tail": np.ascontiguousarray(x[:, w - ICHUNK : w])}
    repaired = []
    orig = mod.run_chained_masks

    def spy(seg, *a, **k):
        repaired.extend(i for i in range(x.shape[0])
                        if np.array_equal(seg[0], x[i, w + ICHUNK :]))
        return orig(seg, *a, **k)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(mod, "run_chained_masks", spy)
        per2, c2, stats = mod.run_segmented_masks(
            x[:, w:], carry, pt, mp, 2, chunk=ICHUNK, **device_kw)
    return per1, c1, per2, c2, stats, repaired


@pytest.fixture(scope="module")
def interp():
    """Both engines over _interp_input, and the port's plain fused
    frontend over the whole input from clock 0 (the taint reference)."""
    from conftest import ensure_cpu_devices
    from jax.experimental.pallas import tpu as pltpu

    import nfclab.dsp.tpu_channels as jtc

    from nfclab_torch.dsp import cuda_channels as cc

    ensure_cpu_devices()
    x = _interp_input()
    with pltpu.force_tpu_interpret_mode():
        ref = _engine(jtc, x, jtc.chain_state0(), {})
    port = _engine(cc, x, cc.chain_state0(2, device="cpu"),
                   {"device": "cpu"})
    out, _ = tp.run_port(x, None, 0)
    return x, ref, port, out


def _dense(per, n):
    m = np.zeros((len(per), n), np.uint8)
    for i, (rel, bits) in enumerate(per):
        m[i, rel] = bits
    return m


def test_segmented_decisions_match_nfclab(interp):
    _, ref, port, _ = interp
    assert ref[5] == port[5] == [1]  # stream 0 verified, stream 1 repaired
    assert ref[4] == port[4] == {"repaired_streams": 1, "repair_chunks": 1}


@pytest.mark.parametrize("window", [1, 2])
def test_segmented_triggers_match_nfclab(interp, window):
    x, ref, port, out = interp
    k = 0 if window == 1 else 2
    lo = (window - 1) * 2 * ICHUNK
    taint = tp.tainted(out, x)[:, lo : lo + 2 * ICHUNK]
    got, want = _dense(port[k], 2 * ICHUNK), _dense(ref[k], 2 * ICHUNK)
    assert not ((got != want) & ~taint).any()
    assert got[1].any()


@pytest.mark.parametrize("window", [1, 2])
@pytest.mark.parametrize("key", ["pen", "end"])
def test_segmented_carry_matches_nfclab(interp, window, key):
    x, ref, port, out = interp
    k = 1 if window == 1 else 3
    tol = ~tp.derived_cols(tp.plan())
    ok = ~tp.tainted(out, x)[:, -1]
    assert ok.all()
    got, want = port[k][key], ref[k][key]
    assert got.shape == want.shape == (2, tp.plan().nstate)
    assert tp.close(got[:, tol], want[:, tol]).all()


# --------------------------------------------------------------------------
# the port's engine against its own serial chain

CHUNK = 4096
K = 4


def _serial_input():
    """One stream of each template, then a stream whose field-off pause
    covers the middle of window 2 (every segment boundary of 2 and 4
    segments lies inside it or within a halo of it)."""
    n = 2 * K * CHUNK
    x = np.stack([torch_synth.lane(t, n, seed=70 + i)[0]
                  for i, t in enumerate(TEMPLATES)])
    paused = torch_synth.lane(TEMPLATES[0], n, seed=80)[0]
    paused[K * CHUNK + CHUNK - 500 : K * CHUNK + 3 * CHUNK + 500] = 0.0
    return np.concatenate([x, paused[None]])


@pytest.fixture(scope="module")
def serial():
    """Window 1 serial with its carry, then window 2 through the serial
    chain and through the segmented engine at 2 and 4 segments."""
    from nfclab_torch.core.params import SignalParams
    from nfclab_torch.dsp import cuda_channels as cc
    from nfclab_torch.dsp.frontend import _params_tuple
    from nfclab_torch.dsp.fused_frontend import kernel_plan

    pt = _params_tuple(SignalParams(RATE))
    mp = cc.chained_mask_params(0.01)
    x = _serial_input()
    n, w = x.shape[0], K * CHUNK
    st = cc.chain_state0(n, device="cpu")
    per1, st1, c1 = cc.run_chained_masks(x[:, :w], st, 0, pt, mp,
                                         chunk=CHUNK, want_carry=True)
    fold = kernel_plan(RATE).fold_modulus
    _, _, want = cc.run_chained_masks(x[:, w:], st1, fold + w % fold, pt,
                                      mp, chunk=CHUNK, want_carry=True)
    carry = {"pen": c1["pen"], "end": c1["end"],
             "tail": np.ascontiguousarray(x[:, w - CHUNK : w])}
    seg = {}
    orig = cc.run_chained_masks
    for S in (2, 4):
        repaired = set()

        def spy(blk, *a, **k):
            # a repair starts at a segment boundary: find its stream
            for i in range(n):
                for s in range(S):
                    o = w + s * (K // S) * CHUNK
                    if np.array_equal(blk[0], x[i, o : o + blk.shape[1]]):
                        repaired.add(i)
            return orig(blk, *a, **k)

        with pytest.MonkeyPatch.context() as m:
            m.setattr(cc, "run_chained_masks", spy)
            _, c2, stats = cc.run_segmented_masks(
                x[:, w:], carry, pt, mp, S, chunk=CHUNK, device="cpu")
        seg[S] = (c2, stats, repaired)
    return x, want, seg, (per1, st1, c1, pt, mp)


@pytest.mark.parametrize("S", [2, 4])
def test_segmented_accepted_carry_equals_serial(serial, S):
    """Rows 0-4 of every stream's pen/end carry equal the serial chain's
    bit for bit; at least one stream verified every boundary."""
    x, want, seg, _ = serial
    c2, stats, repaired = seg[S]
    assert stats["repaired_streams"] == len(repaired)
    assert len(repaired) < x.shape[0] - 1
    for key in ("pen", "end"):
        assert np.array_equal(c2[key][:, :NVER], want[key][:, :NVER]), key
    np.testing.assert_array_equal(c2["tail"], x[:, -CHUNK:])


@pytest.mark.parametrize("S", [2, 4])
def test_segmented_forced_repair_equals_serial(serial, S):
    """The paused stream verify-fails and repairs; its conditioning carry
    equals the serial chain's bit for bit."""
    x, want, seg, _ = serial
    c2, stats, repaired = seg[S]
    last = x.shape[0] - 1
    assert last in repaired and stats["repair_chunks"] > 0
    for key in ("pen", "end"):
        assert np.array_equal(c2[key][last, :NVER], want[key][last, :NVER])


# --------------------------------------------------------------------------
# the serial engine's carry handoff and its fetch, which both engines share


def test_chained_carry_rows(serial):
    """want_carry: "end" is the returned state, "pen" the state of the same
    chain one chunk before the window's end."""
    from nfclab_torch.dsp import cuda_channels as cc

    x, _, _, (_, st1, c1, pt, mp) = serial
    assert np.array_equal(c1["end"], st1.numpy())
    st = cc.chain_state0(x.shape[0], device="cpu")
    _, st_pen = cc.run_chained_masks(x[:, : (K - 1) * CHUNK], st, 0, pt, mp,
                                     chunk=CHUNK)
    assert np.array_equal(c1["pen"], st_pen.numpy())


def test_over_cap_rows_in_one_transfer(serial, monkeypatch):
    """With the compaction cap forced down to 2048 triggers, the rows over
    it come back as dense mask rows, gathered on the device and moved in
    one transfer: the (idx, bits) pairs equal those of the same window
    at the default cap (4096), where only half the rows take that
    path."""
    import torch

    from nfclab_torch.dsp import cuda_channels as cc

    x, _, _, (per1, _, _, pt, mp) = serial
    small = 2048
    compact, fetch = cc._compact, cc._fetch
    monkeypatch.setattr(cc, "_compact", lambda mm, cap: compact(mm, small))
    moved = []

    def spy_fetch(mm, idx, bits, cnt, cap, *a, **k):
        return fetch(mm, idx, bits, cnt, small, *a, **k)

    cpu = torch.Tensor.cpu

    def spy_cpu(t, *a, **k):
        if t.dtype == torch.uint8 and t.dim() == 2 and t.shape[1] == K * CHUNK:
            moved.append(t.shape[0])
        return cpu(t, *a, **k)

    monkeypatch.setattr(cc, "_fetch", spy_fetch)
    monkeypatch.setattr(torch.Tensor, "cpu", spy_cpu)
    st = cc.chain_state0(x.shape[0], device="cpu")
    got, _ = cc.run_chained_masks(x[:, : K * CHUNK], st, 0, pt, mp,
                                  chunk=CHUNK)
    counts = [len(rel) for rel, _ in per1]
    over = sum(c > small for c in counts)
    assert 0 < sum(c > 4096 for c in counts) < over < len(counts)
    assert moved == [over]
    for (rel, bits), (rel0, bits0) in zip(got, per1):
        assert rel.dtype == np.int64
        assert np.array_equal(rel, rel0) and np.array_equal(bits, bits0)
