"""nfclab_torch's experiment probes against the Pallas kernels of
experiments/probe_serial_floor.py, probe_pair_spec.py and membw_probe.py,
and the experiment entry points on the CPU.

The JAX oracles are the scripts' own code: their nested ``kernel`` and
``build`` (or ``copy_kernel``) are taken out of ``main()`` with ``ast`` and
run in TPU interpret mode with ``pt`` (10 MS/s), ``TILE = 128``, ``sub =
8`` and ``UNROLL = False`` / ``MODE`` bound, at one group x 256 samples x
1024 lanes.  XLA:CPU contracts FMAs in interpret mode (torch_parity.py),
so the conditioning outputs compare at rtol 1e-5 / atol 1e-6 up to a
lane's first envelope decision near its threshold.  The port's pair and
serial forms must agree bit for bit, as must the copy probe with numpy.
"""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (kept on the CPU by conftest.ensure_cpu_devices)

import torch_parity as tp
from torch_synth import mixed_lanes

ROOT = Path(__file__).resolve().parent.parent
G, T_P, SUB = 1, 256, 8
NAMES = ("envelope", "filtered", "deviation", "average", "mod_depth")


def _from_main(script: str, names, **bind) -> dict:
    """Exec the functions `names` nested in `script`'s main() in a
    namespace holding `bind`; returns the namespace."""
    path = ROOT / "experiments" / script
    src = path.read_text()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    nodes = [n for n in main.body
             if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in nodes) == sorted(names)
    ns = dict(bind)
    exec(compile(ast.Module(body=nodes, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


def _jax_names():
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    return {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu, "np": np,
            "functools": functools}


def _run_probe(script, x, **bind):
    """The script's Pallas conditioning probe over x [G, T, sub, 128] in
    interpret mode -> [G*L, T] numpy outputs by name."""
    from conftest import ensure_cpu_devices
    from jax.experimental.pallas import tpu as pltpu

    from nfclab_torch.experiments import probe_serial_floor as psf

    ensure_cpu_devices()
    ns = _from_main(script, ("kernel", "build"), pt=psf.params(), TILE=128,
                    sub=SUB, **_jax_names(), **bind)
    g, t = x.shape[:2]
    with pltpu.force_tpu_interpret_mode():
        outs = ns["build"](g, t)(x)
        return {n: _lanes_first(np.asarray(o).reshape(g, t, -1))
                for n, o in zip(NAMES, outs)}


def _lanes_first(a):
    """[G, T, L] -> [G*L, T]: one row per lane."""
    g, t, lanes = a.shape
    return a.transpose(0, 2, 1).reshape(g * lanes, t)


def _port(outs):
    return {n: _lanes_first(o.numpy()) for n, o in zip(NAMES, outs)}


def _bits(outs):
    return [o.view(torch.int32) for o in outs]


@pytest.fixture(scope="module")
def probe_x():
    """The scripts' input at a small shape: rng(0).random * 0.4."""
    rng = np.random.default_rng(0)
    return rng.random((G, T_P, SUB, 128), dtype=np.float32) * np.float32(0.4)


def _check_against(ref, got, x):
    taint = tp.tainted(ref, _lanes_first(x.reshape(G, T_P, -1)))
    tp.check_outputs(got, ref, taint, NAMES)


def test_serial_probe_matches_pallas(probe_x):
    from nfclab_torch.experiments import probe_serial_floor as psf

    ref = _run_probe("probe_serial_floor.py", probe_x, UNROLL=False)
    got = psf.serial_probe(torch.from_numpy(probe_x.reshape(G, T_P, -1)))
    _check_against(ref, _port(got), probe_x)


@pytest.mark.parametrize("mode", ["pair", "serial"])
def test_pair_probe_matches_pallas(probe_x, mode):
    from nfclab_torch.experiments import probe_pair_spec as pps

    ref = _run_probe("probe_pair_spec.py", probe_x, MODE=mode)
    got = pps.pair_probe(torch.from_numpy(probe_x.reshape(G, T_P, -1)), mode)
    _check_against(ref, _port(got), probe_x)


def _field_off_input():
    """Template lanes with field-off stretches (zeros) long enough to
    pass the 940-sample silence timeout, and a v = 0 sample at t = 0 on
    lane 0."""
    x = mixed_lanes(96, 3000, seed=9)
    x[::3, 500:2200] = 0.0
    x[1::3, 1000:1200] = 0.0
    x[0, 0] = 0.0
    return torch.from_numpy(x.T.copy()).reshape(1, 3000, 96)


@pytest.mark.parametrize("which", ["seeded", "field_off"])
def test_pair_equals_serial_bit_for_bit(probe_x, which):
    """The speculative pair form is the serial loop's function exactly,
    NaN (0/0 from a zero envelope) included."""
    from nfclab_torch.experiments import probe_pair_spec as pps
    from nfclab_torch.experiments import probe_serial_floor as psf

    if which == "seeded":
        x = torch.from_numpy(probe_x.reshape(G, T_P, -1))
    else:
        x = _field_off_input()
    serial = psf.serial_probe_plain(x)
    pair = pps.pair_probe_plain(x)
    for a, b in zip(_bits(serial), _bits(pair)):
        assert torch.equal(a, b)
    if which == "field_off":
        env, mdev = serial[0], serial[2]
        assert torch.isnan(serial[4]).any()       # 0/0 at a zero envelope
        # the silence timeout forced updates that decay the envelope
        assert (env[0, 2100, ::3] < env[0, 499, ::3]).any()
        assert torch.isfinite(mdev).all()


def test_pair_probe_checks_its_input():
    from nfclab_torch.experiments import probe_pair_spec as pps

    with pytest.raises(ValueError):
        pps.pair_probe(torch.zeros(1, 7, 4))
    with pytest.raises(ValueError):
        pps.pair_probe(torch.zeros(1, 8, 4), "quad")
    with pytest.raises(TypeError):
        pps.pair_probe(torch.zeros(1, 8, 4, dtype=torch.float64))


def test_copy_probe_equals_numpy():
    from nfclab_torch.experiments import membw_probe as mb

    x = np.random.default_rng(3).random((37, 53), dtype=np.float32)
    outs = mb.copy_probe(torch.from_numpy(x), nout=5, sweeps=2)
    assert len(outs) == 5
    for i, o in enumerate(outs):
        want = x * np.float32(1.0 + 1e-7 * i)
        assert np.array_equal(o.numpy().view(np.int32), want.view(np.int32))
    assert mb.scales(3)[1] == float(np.float32(1.0 + 1e-7))


@pytest.mark.parametrize("sweeps", [1, 2])
def test_copy_probe_matches_pallas(sweeps):
    """membw_probe.py's copy_kernel through the original's grid (sweeps,
    row tiles) in interpret mode.  Interpret mode refuses the original's
    revisit of the output blocks in a second sweep, so the oracle runs one
    sweep; the port's outputs after two must be the same."""
    from conftest import ensure_cpu_devices
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from nfclab_torch.experiments import membw_probe as mb

    ensure_cpu_devices()
    rows, cols, tr, nout = 64, 256, 32, 3
    ns = _from_main("membw_probe.py", ("copy_kernel",), np=np)
    x = np.random.default_rng(0).random((rows, cols), dtype=np.float32)
    spec = pl.BlockSpec((tr, cols), lambda k, i: (i, 0))
    with pltpu.force_tpu_interpret_mode():
        want = pl.pallas_call(
            ns["copy_kernel"], grid=(1, rows // tr), in_specs=[spec],
            out_specs=[spec] * nout,
            out_shape=[jax.ShapeDtypeStruct((rows, cols), np.float32)] * nout,
        )(x)
    got = mb.copy_probe(torch.from_numpy(x), nout=nout, sweeps=sweeps)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.int32),
                              np.asarray(w).view(np.int32))


def _entry_points():
    from nfclab_torch.experiments import bench_v2
    from nfclab_torch.experiments import membw_probe as mb
    from nfclab_torch.experiments import probe_pair_spec as pps
    from nfclab_torch.experiments import probe_serial_floor as psf

    return {
        "membw": lambda d: [mb.bandwidth(rows=8, cols=64, sweeps=2, nout=3,
                                         reps=1, device=d)],
        "serial": lambda d: [psf.measure(g=1, t=64, k=2, sub=1, reps=1,
                                         device=d)],
        "pair": lambda d: [pps.measure(m, g=2, t=64, k=2, sub=1, reps=1,
                                       device=d) for m in pps.MODES],
        "bench_v2": lambda d: bench_v2.run("v2", configs=[(6, 2, 64)], reps=1,
                                           device=d)
        + bench_v2.run("prod", configs=[(6, 2, 128)], reps=1, device=d),
    }


@pytest.mark.parametrize("name", ["membw", "serial", "pair", "bench_v2"])
def test_entry_point_runs_on_cpu(name):
    for r in _entry_points()[name]("cpu"):
        nums = [v for k, v in r.items() if k not in ("device", "which")]
        assert nums and all(np.isfinite(v) and v >= 0 for v in nums), r
        if "device" in r:
            assert r["device"] == "cpu"


@pytest.mark.parametrize("name", ["membw", "serial", "pair", "bench_v2",
                                  "fused_v2"])
def test_entry_point_raises_without_a_card(name):
    from nfclab_torch.dsp.cuda_channels import DeviceUnavailable
    from nfclab_torch.experiments import fused_v2

    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    pt, _ = tp.params()
    calls = {**_entry_points(),
             "fused_v2": lambda d: fused_v2.fused_frontend(
                 np.zeros((2, 32), np.float32), pt, device=d)}
    with pytest.raises(DeviceUnavailable):
        calls[name]("cuda")


def test_kernel_wrappers_count_no_plain_run():
    """On CPU tensors the wrappers run the plain versions, which never
    count as launches."""
    from nfclab_torch.experiments import fused_v2, membw_probe
    from nfclab_torch.experiments import probe_pair_spec as pps
    from nfclab_torch.experiments import probe_serial_floor as psf

    counters = (membw_probe.COPY, psf.SERIAL, pps.PAIR, *fused_v2.KERNELS)
    before = [k.launches for k in counters]
    x = torch.rand(1, 32, 4)
    psf.serial_probe(x)
    pps.pair_probe(x)
    membw_probe.copy_probe(x, 2)
    pt, mp = tp.params()
    fused_v2.fused_frontend(torch.rand(3, 32), pt, mask_params=mp,
                            device="cpu")
    assert [k.launches for k in counters] == before
    assert [k.name for k in counters] == [
        "copy_probe", "serial_probe", "pair_probe", "fused_v2_scan",
        "fused_v2_mask"]
