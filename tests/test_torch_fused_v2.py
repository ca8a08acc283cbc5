"""nfclab_torch.experiments.fused_v2 against experiments/fused_v2.py's
Pallas kernel in TPU interpret mode, on the same numpy inputs: 1024
streams x 2 chunks of 256 samples with carried state, the first at clock
40 (inside the envelope seeding window, off every ring phase), the second
at 296, over template windows, noise, field-off pauses and carriers near
the power gate.

Tolerances as in torch_parity.py (XLA:CPU contracts FMAs in interpret
mode): the conditioning outputs at rtol 1e-5 / atol 1e-6 up to a stream's
first envelope decision near its threshold; the raw-value boxes and the
rings of box values exactly; the q*/p* sums and the squared and product
rings exactly against each implementation's own filtered channel;
detect_mask wherever no deciding quantity lies near its threshold.  The
state moves both ways: the JAX kernel's chunk-1 state resumes in the port,
the port's in the JAX kernel.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (kept on the CPU by conftest.ensure_cpu_devices)

import torch_parity as tp
from torch_synth import mixed_lanes

B, T, BASE0 = 1024, 256, 40


def _jax_mod():
    from experiments import fused_v2

    return fused_v2


def _port_mod():
    from nfclab_torch.experiments import fused_v2

    return fused_v2


def run_jax(x, state, base):
    from jax.experimental.pallas import tpu as pltpu

    pt, mp = tp.params()
    with pltpu.force_tpu_interpret_mode():
        res, st = _jax_mod().fused_frontend(x, pt, mask_params=mp,
                                            state=state, base=base,
                                            return_state=True)
        return {k: np.asarray(v) for k, v in res.items()}, np.asarray(st)


def run_port(x, state, base):
    pt, mp = tp.params()
    res, st = _port_mod().fused_frontend(x, pt, mask_params=mp, state=state,
                                         base=base, return_state=True,
                                         device="cpu")
    return {k: v.numpy() for k, v in res.items()}, st.numpy()


@pytest.fixture(scope="module")
def runs():
    """x; the JAX kernel's (outputs over both chunks, [chunk-1 state,
    chunk-2 state]); the port's likewise; the port's chunk 2 resumed from
    the JAX chunk-1 state; the JAX chunk 2 resumed from the port's."""
    from conftest import ensure_cpu_devices

    v2 = _port_mod()
    ensure_cpu_devices()
    x = mixed_lanes(B, 2 * T, seed=11)
    j1, js1 = run_jax(x[:, :T], None, BASE0)
    j2, js2 = run_jax(x[:, T:], js1, BASE0 + T)
    p1, ps1 = run_port(x[:, :T], None, BASE0)
    p2, ps2 = run_port(x[:, T:], ps1, BASE0 + T)
    port_from_jax = run_port(x[:, T:], v2.state_from_jax(js1), BASE0 + T)
    jr2, jrs2 = run_jax(x[:, T:], v2.state_to_jax(torch.from_numpy(ps1), 8),
                        BASE0 + T)
    jst = [v2.state_from_jax(s).numpy() for s in (js1, js2)]
    return (x, (tp.cat(j1, j2), jst), (tp.cat(p1, p2), [ps1, ps2]),
            port_from_jax, (jr2, v2.state_from_jax(jrs2).numpy()))


def _derived_cols():
    """State columns derived from the filtered channel through a product:
    the squared and product rings and the q*/p* sums."""
    v2 = _port_mod()
    cols = np.zeros(v2.NSTATE, bool)
    cols[v2.S_RQ : v2.S_RB] = True
    cols[v2.S_SUMS + len(v2.BV_WIDTHS) :] = True
    return cols


def _derived_state(filt, sums):
    """The derived columns after the last sample of `filt` ([B, n] from
    clock BASE0): ring slot t % r holds the value at the latest such
    clock, the sums section the last of `sums`."""
    v2 = _port_mod()
    pl = tp.plan()
    b, n = filt.shape
    vals = [(filt * filt) * np.float32(10.0)]
    vals += [pr * np.float32(10.0) for pr in tp.products(filt, pl)]
    rings = []
    for v, r in zip(vals, (v2.RQ_RING, *v2.RP_RINGS)):
        ring = np.zeros((b, r), np.float32)
        for j in range(max(0, n - r), n):
            ring[:, (BASE0 + j) % r] = v[:, j]
        rings.append(ring)
    last = [sums[k][:, -1:] for k in tp.exact_sum_names(pl)]
    return np.concatenate(rings + last, 1)


def _check_state(got, want, filt, sums, ok_rows):
    """The columns the FMA moves little within tolerance on the untainted
    streams; the derived columns exactly against the implementation's own
    filtered channel and sums."""
    der = _derived_cols()
    bad = ~tp.close(got[ok_rows][:, ~der], want[ok_rows][:, ~der])
    assert not bad.any(), f"{int(bad.sum())} state entries off"
    assert np.array_equal(got[:, der], _derived_state(filt, sums))


def _check_resumed(out2, st2, src_out, src_state1, ref_out, ref_state2, fma,
                   x):
    """A chunk-2 run from another implementation's chunk-1 state against
    a reference run's chunk 2 (see torch_parity.check_resumed)."""
    v2 = _port_mod()
    pl = tp.plan()
    taint = tp.tainted(ref_out, x)
    tp.check_outputs(out2, {k: v[:, T:] for k, v in ref_out.items()},
                     taint[:, T:])
    tp.check_mask(out2["detect_mask"], ref_out["detect_mask"][:, T:],
                  ref_out, x, start=T)
    filt = np.concatenate([src_out["filtered"][:, :T], out2["filtered"]], 1)
    qp0 = v2.S_SUMS + len(v2.BV_WIDTHS)
    want = tp.qp_sums(filt, pl, fma, start=T, s0=src_state1[:, qp0:])
    for name in tp.exact_sum_names(pl):
        assert np.array_equal(out2[name], want[name]), name
    _check_state(st2, ref_state2, filt, want, ~taint[:, -1])


def test_v2_copied_constants_equal_the_original():
    jv2, pv2 = _jax_mod(), _port_mod()
    names = ["TILE", "BV_WIDTHS", "Q_WIDTHS", "PB", "RV_RING", "RF_RING",
             "RQ_RING", "RP_RINGS", "A_RATES", "RB_RINGS", "RB_OFFS",
             "RB_TOTAL", "B_DELAYS", "F_RATES", "V_RATE", "RBV_RING",
             "MASK_BITS_A", "MASK_BITS_B", "MASK_BITS_F", "MASK_BIT_V",
             "N_OUT", "S_CARRY", "S_RV", "S_RF", "S_RQ", "S_RP0", "S_RP1",
             "S_RP2", "S_RB", "S_RBV", "S_SUMS", "N_SUMS", "NSTATE",
             "OUTPUT_NAMES", "MASK_LAYOUT"]
    for n in names:
        assert getattr(pv2, n) == getattr(jv2, n), n
    assert pv2.NSTATE == 1285


def test_v2_mask_geometry_is_the_production_plan():
    """The v2 mask's rates are the production kernel's at 10 MS/s, so
    torch_parity's threshold margins apply to it."""
    v2 = _port_mod()
    pl = tp.plan()
    assert v2.A_RATES == pl.a_rates and v2.B_DELAYS == pl.b_delays
    assert v2.V_RATE == pl.v_rate and v2.BV_WIDTHS == pl.bv_widths
    assert [(d, g, p2, v2.A_RATES[r][3]) for d, g, p2, r in v2.F_RATES] == \
        list(pl.f_rates)


@pytest.mark.parametrize("name", tp.TOL_OUTPUTS)
def test_v2_output_matches_jax(runs, name):
    x, (jout, _), (pout, _), _, _ = runs
    tp.check_outputs(pout, jout, tp.tainted(pout, x), (name,))


def test_v2_box_values_exact(runs):
    """The raw-value boxes are sums of the samples alone: no FMA, so they
    agree bit for bit."""
    _, (jout, _), (pout, _), _, _ = runs
    for w in _port_mod().BV_WIDTHS:
        assert np.array_equal(pout[f"bv{w}"], jout[f"bv{w}"])


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_v2_qp_sums_exact_against_own_filtered(runs, impl):
    _, (jout, _), (pout, _), _, _ = runs
    out = jout if impl == "jax" else pout
    pl = tp.plan()
    want = tp.qp_sums(out["filtered"], pl, fma=impl == "jax")
    for name in tp.exact_sum_names(pl):
        assert np.array_equal(out[name], want[name]), name


def test_v2_detect_mask_matches_jax(runs, capsys):
    x, (jout, _), (pout, _), _, _ = runs
    assert (pout["detect_mask"] != 0).sum() > 1000  # the test has triggers
    assert pout["detect_mask"].dtype == np.float32
    differ, near = tp.check_mask(pout["detect_mask"], jout["detect_mask"],
                                 pout, x)
    with capsys.disabled():
        print(f"\nv2 detect_mask: {differ} of {pout['detect_mask'].size} "
              f"samples differ from the Pallas kernel; {near} lie within "
              f"{tp.MARGIN} of a threshold")


@pytest.mark.parametrize("chunk", [0, 1])
def test_v2_state_matches_jax(runs, chunk):
    x, (jout, jst), (pout, pst), _, _ = runs
    v2 = _port_mod()
    n = (chunk + 1) * T
    ok = ~tp.tainted(pout, x)[:, n - 1]
    want, got = jst[chunk], pst[chunk]
    # the box-value rings and the carried previous boxes are exact
    for lo, hi in ((5, 10), (v2.S_RV, v2.S_RF), (v2.S_RB, v2.S_SUMS)):
        assert np.array_equal(got[:, lo:hi], want[:, lo:hi]), (lo, hi)
    assert got[:, 5:10].any()
    _check_state(got, want, pout["filtered"][:, :n],
                 {k: v[:, :n] for k, v in pout.items()}, ok)
    _check_state(want, got, jout["filtered"][:, :n],
                 {k: v[:, :n] for k, v in jout.items()}, ok)


def test_v2_port_resumes_jax_state(runs):
    """Chunk 2 from the JAX kernel's chunk-1 state matches the JAX
    chunk 2."""
    x, (jout, jst), _, (out2, st2), _ = runs
    _check_resumed(out2, st2, jout, jst[0], jout, jst[1], False, x)


def test_v2_jax_resumes_port_state(runs):
    """The JAX kernel's chunk 2 from the port's chunk-1 state matches the
    port's chunk 2."""
    x, _, (pout, pst), _, (jr2, jrs2) = runs
    _check_resumed(jr2, jrs2, pout, pst[0], pout, pst[1], True, x)


def test_v2_unpack_detect_mask_matches_jax(runs):
    _, (jout, _), (pout, _), _, _ = runs
    want = _jax_mod().unpack_detect_mask(jout["detect_mask"])
    got = _port_mod().unpack_detect_mask(torch.from_numpy(pout["detect_mask"]))
    assert list(got) == list(want)
    assert any(g.any() for g in got.values())
    same = pout["detect_mask"] == jout["detect_mask"]
    for name in got:
        w, g = np.asarray(want[name]), got[name].numpy()
        assert np.array_equal(g[same], w[same]), name


def test_v2_stream_equals_one_pass():
    """fused_frontend_stream's chunks with carried state equal one call
    over the whole span bit for bit, and the wrapper's two phases equal
    the plain function."""
    v2 = _port_mod()
    pt, mp = tp.params()
    x = mixed_lanes(40, 3 * 96, seed=4)
    whole = v2.fused_frontend(x, pt, mask_params=mp, device="cpu")
    parts = list(v2.fused_frontend_stream(x, pt, chunk=96, mask_params=mp,
                                          device="cpu"))
    assert [off for off, _ in parts] == [0, 96, 192]
    plain = v2.fused_frontend_plain(torch.from_numpy(x), pt, mask_params=mp)
    for name in v2.OUTPUT_NAMES:
        got = torch.cat([r[name] for _, r in parts], 1)
        assert torch.equal(got.view(torch.int32),
                           whole[name].view(torch.int32)), name
        assert torch.equal(plain[name].view(torch.int32),
                           whole[name].view(torch.int32)), name


def test_v2_rejects_bad_arguments():
    v2 = _port_mod()
    pt, _ = tp.params()
    x = np.zeros((4, 64), np.float32)
    with pytest.raises(ValueError):
        v2.fused_frontend(x, pt, base=2 ** 31 - 1000, device="cpu")
    with pytest.raises(ValueError):
        v2.fused_frontend(x, pt, base=-1, device="cpu")
    with pytest.raises(ValueError):
        v2.fused_frontend(np.zeros((4, 40), np.float32), pt, device="cpu")
    with pytest.raises(ValueError):
        v2.fused_frontend(x, pt, state=np.zeros((4, 100), np.float32),
                          device="cpu")
