"""What each lever of the serial scans' design buys on the card.

``cond_scan_kernel`` and ``ff_scan_kernel`` take their envelope decision
without a divide (the conditioning scan, where a group of steps keeps its
envelope positive, without a branch either), split their chains over warps, and (the fused
scan) stage their samples in shared memory and issue a group's ring reads
before its ring writes.  This script times them against variant libraries that
each undo one lever, built from patched copies of ``csrc/`` (the program
itself has no switch for any of them):

- ``current``: ``csrc/`` as it is;
- ``quotient``: the envelope test written as the correctly rounded
  quotient ``cond_env_diff(v, env) < 0.05f``;
- ``group1``: the current library, ``ff_scan_kernel`` launched with groups
  of one step (each ring read after the ring writes of the step before);
- ``one_path``: ``cond_scan_kernel``'s envelope warp without its
  per-group choice, every step through ``cond_env_near`` and its
  special-value branch;
- ``base`` and ``base_near`` (with ``--base DIR``, the ``csrc/`` of an
  earlier checkout whose scans run one warp per block): that design as it
  is, and with the divide-free test put in.

Probes of what bounds a step change what the kernels compute, so their
outputs are not compared (``PROBES``):

- ``no_stores``: every per-step store of both scans skipped (the chains
  still run; the state rows are still written);
- ``env_only``: ``cond_scan_kernel`` with its envelope warp alone;
- ``unroll8`` / ``unroll32``: ``cond_scan_kernel`` loading 8 or 32
  samples ahead instead of 16;
- ``no_branch``: ``cond_env_near`` without its special-value branch;
- ``float_test``: the envelope test as one float multiply and compare,
  with no branch.

Each variant runs both scans on the same seeded carrier lanes (1024 x
65536 samples, ASK dips, field-off gaps, noise), the conditioning scan
also at 1 x 65536; a lever's outputs must equal the current kernels' bit
for bit.  Times are CUDA events over 5 launches after a warm-up, each
variant timed in a forward and a backward pass over the list.  One JSON
line per variant, one with the SM clock and power draw that nvidia-smi
reads while the current conditioning scan runs, then the card.

    python -m nfclab_torch.experiments.scan_levers [--base DIR]
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..core.params import SignalParams
from ..dsp import conditioner_kernel as ck
from ..dsp import fused_frontend as ff
from ..dsp.frontend import _params_tuple
from ..kernels import build as kbuild
from ..kernels import conditioner as kc
from ..kernels import fused as kf

RATE = 10_000_000
STREAMS, STEPS = 1024, 65536
LEVER_DIR = kbuild.BUILD_DIR / "levers"

_TEST = "    return (double)ad <= __dmul_rn(m, (double)env);"
QUOTIENT = {"condition_step.cuh": [
    (_TEST, "    return __fdiv_rn(ad, env) < 0.05f;")]}
NEAR = {name: [("(diff < 0.05f)", "cond_env_near(v, env)")]
        for name in ("conditioner.cu", "fused_frontend.cu")}

_NEVER = "if (o == 0xffffffffu) "  # a store no step makes
_SPECIAL = ("    if (__builtin_expect(!(env > 0.0f && env < INFINITY), 0))\n"
            "        near = cond_env_diff(v, env) < 0.05f;\n")
# cond_scan_kernel's envelope warp with every group on cond_env_near (the
# special-value branch in every step)
ONE_PATH = {"conditioner.cu": [
    ("        if (__all_sync(__activemask(), a | b)) {", "        if (false) {")]}
PROBES = {
    "no_stores": {
        "conditioner.cu": [
            ("        out_env[o] = env;\n        out_pulse[o] = (int32_t)pulse;",
             "        " + _NEVER + "{ out_env[0] = env; out_pulse[0] = pulse; }"),
            ("        out_w1[o] = w1;\n        out_filt[o] = filt;\n"
             "        out_mdev[o] = mdev;",
             "        " + _NEVER + "{ out_w1[0] = w1; out_filt[0] = filt; "
             "out_mdev[0] = mdev; }"),
            ("        out_avg[o] = avg;", "        " + _NEVER + "out_avg[0] = avg;"),
        ],
        "fused_frontend.cu": [
            ("        __stcg(cur + o, v);", "        " + _NEVER + "__stcg(cur, v);"),
        ],
    },
    "env_only": {"conditioner.cu": [
        ("    } else if (warp == 1) {", "    } else if (warp == 1 && a.T < 0) {"),
        ("    } else {\n        CondAvgChain c;",
         "    } else if (a.T < 0) {\n        CondAvgChain c;"),
    ]},
    "unroll8": {"conditioner.cu": [("#define COND_UNROLL 16",
                                    "#define COND_UNROLL 8")]},
    "unroll32": {"conditioner.cu": [("#define COND_UNROLL 16",
                                     "#define COND_UNROLL 32")]},
    "no_branch": {"condition_step.cuh": [(_SPECIAL, "")]},
    "float_test": {"condition_step.cuh": [
        (_SPECIAL, ""),
        (_TEST, "    return ad <= __fmul_rn(0.05f, env);"),
    ]},
}


def carrier_lanes(streams: int, steps: int, seed: int = 0) -> np.ndarray:
    """[steps, streams] f32 magnitudes (>= 0): a carrier per lane at a
    seeded gain, 10% ASK dips of 3-40 samples, field-off gaps of 2k-20k
    samples, noise."""
    rng = np.random.default_rng(seed)
    x = np.ones((steps, streams), np.float32)
    x *= rng.uniform(0.5, 1.5, streams).astype(np.float32)
    for b in range(streams):
        starts = rng.integers(0, steps, 400)
        for s, n in zip(starts, rng.integers(3, 40, starts.size)):
            x[s : s + n, b] *= np.float32(0.9)
        for s in rng.integers(0, steps, 2):
            x[s : s + int(rng.integers(2000, 20000)), b] = 0.0
    x += rng.standard_normal(x.shape, dtype=np.float32) * np.float32(2e-4)
    return np.abs(x, out=x)


def clocks_under_load(fn, launches: int) -> dict:
    """The card's SM clock and power draw, read by nvidia-smi while
    `launches` calls of fn are queued on the device."""
    for _ in range(launches):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True).stdout
    torch.cuda.synchronize()
    mhz, watts = (float(f) for f in out.split(",")[:2])
    return {"clocks_sm_mhz": mhz, "power_draw_w": watts}


def build_variant(name: str, src: Path, patches: dict, header: Path = None):
    """Build the kernel library from a copy of src with each (old, new) of
    patches[file] applied (each must match), and header in place of
    condition_step.cuh when given; returns the library's path."""
    root = LEVER_DIR / name
    if root.exists():
        shutil.rmtree(root)
    work = root / "csrc"
    shutil.copytree(src, work)
    if header is not None:
        shutil.copy(header, work / "condition_step.cuh")
    for fname, edits in patches.items():
        text = (work / fname).read_text()
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in {fname}")
            text = text.replace(old, new)
        (work / fname).write_text(text)
    return kbuild.build(force=True, src_dir=work, build_dir=root)


class Variant:
    """A library and its launch geometry: the one-warp design takes 32
    threads a block and shared memory for its rings alone."""

    def __init__(self, name, path, one_warp=False, group=None, probe=False):
        self.name, self.path = name, path
        self.one_warp, self.group, self.probe = one_warp, group, probe
        self.lib = None

    def __enter__(self):
        if self.lib is None:
            self.lib = kf.bind(self.path)
        self.saved = (kf.library, kc.library, kf.SCAN_THREADS, kf.scan_smem,
                      kc.THREADS, kf.scan_group)
        kf.library = kc.library = lambda: self.lib
        if self.one_warp:
            kf.SCAN_THREADS, kc.THREADS = 32, 32
            kf.scan_smem = lambda rows: rows * 32 * 4
        if self.group is not None:
            kf.scan_group = lambda plan: self.group
        return self

    def __exit__(self, *exc):
        (kf.library, kc.library, kf.SCAN_THREADS, kf.scan_smem, kc.THREADS,
         kf.scan_group) = self.saved


def _event_ms(fn, reps=5) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def run(base: Path = None, device="cuda") -> list:
    dev = torch.device(device)
    pt = _params_tuple(SignalParams(RATE))
    plan = ff.kernel_plan(RATE)
    x = torch.from_numpy(carrier_lanes(STREAMS, STEPS)).to(dev)
    x1 = x[:, :1].contiguous()
    init = (x[0].clone(), x[0] * 10.0, torch.zeros_like(x[0]), x[0].clone(),
            torch.zeros(STREAMS, dtype=torch.int32, device=dev),
            torch.zeros(STREAMS, dtype=torch.int32, device=dev))
    init1 = tuple(t[:1].contiguous() for t in init)
    st = torch.zeros(plan.nstate, STREAMS, device=dev)

    current = kbuild.build()
    variants = [Variant("current", current),
                Variant("quotient", build_variant("quotient", kbuild.SRC_DIR,
                                                  QUOTIENT)),
                Variant("group1", current, group=1),
                Variant("one_path", build_variant(
                    "one_path", kbuild.SRC_DIR, ONE_PATH))]
    if base is not None:
        header = kbuild.SRC_DIR / "condition_step.cuh"
        variants += [Variant("base", build_variant("base", base, {}), True),
                     Variant("base_near", build_variant("base_near", base,
                                                        NEAR, header), True)]
    for name, patches in PROBES.items():
        variants.append(Variant(name, build_variant(name, kbuild.SRC_DIR,
                                                    patches), probe=True))

    want = None
    for v in variants:
        if v.probe:
            continue
        with v:
            got = (ck.condition_scan_tm(x, *init, pt),
                   ck.condition_scan_tm(x1, *init1, pt),
                   ff.fused_scan(x, st, 0, pt, plan))
        flat = [*got[0], *got[1], got[2][0], got[2][2]]
        if want is None:
            want = flat
        elif not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                     for a, b in zip(flat, want)):
            raise AssertionError(f"variant {v.name} differs from current")
        del got, flat
    times = {v.name: [] for v in variants}
    for v in variants + variants[::-1]:
        with v:
            times[v.name].append((
                _event_ms(lambda: ck.condition_scan_tm(x, *init, pt)),
                _event_ms(lambda: ck.condition_scan_tm(x1, *init1, pt)),
                _event_ms(lambda: ff.fused_scan(x, st, 0, pt, plan))))
    rows = []
    with variants[0]:
        load = clocks_under_load(
            lambda: ck.condition_scan_tm(x, *init, pt), 200)
    for v in variants:
        t = np.array(times[v.name])
        row = {"variant": v.name, "probe": v.probe}
        for i, key in enumerate(("cond_ms", "cond_repair_ms", "ff_scan_ms")):
            row[key] = float(t[:, i].mean())
            row[key.replace("_ms", "_ns_per_step")] = float(
                t[:, i].mean() * 1e6 / STEPS)
            row[key + "_passes"] = [float(a) for a in t[:, i]]
        rows.append(row)
    rows.append({"during": "200 current conditioning scans", **load})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", type=Path, default=None,
                    help="csrc/ of an earlier checkout (one-warp scans)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_levers: needs a CUDA device")
    for row in run(args.base):
        print(json.dumps(row), flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
