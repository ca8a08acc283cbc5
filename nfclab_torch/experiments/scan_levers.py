"""What each lever of the redesigned kernels' design buys on the card.

The four serial scans -- ``cond_scan_kernel``, ``ff_scan_kernel``,
``v2_scan_kernel`` and ``serial_probe_kernel`` -- and the pair probe take
their envelope decision without a divide (where a group of steps keeps its
envelope positive, without a branch either), split their chains over
warps, and (the fused scans) stage their samples in shared memory and
issue a group's ring reads before its ring writes; ``v2_scan_kernel``
keeps its rings rotated to the chunk in power-of-two sizes, so a step
takes a mask and no modulo, and v2 and the probes run mod_depth's divide
on a warp of its own.  ``v2_mask_kernel`` stages each lookback channel in
a shared ring and decides its thresholds without a divide.  This script
times them against variant libraries that each undo one lever, built from
patched copies of ``csrc/`` (the program itself has no switch for any of
them):

- ``current``: ``csrc/`` as it is;
- ``quotient``: the envelope test written as the correctly rounded
  quotient ``cond_env_diff(v, env) < 0.05f``;
- ``one_path``: no per-group vote, every step through ``cond_env_near``
  and its special-value branch;
- ``group1``: ring reads not ahead: ``ff_scan_kernel`` launched with
  groups of one step, ``v2_scan_kernel`` built with them;
- ``modulo``: ``v2_scan_kernel``'s rings in their state sizes (96, 96,
  192, ...), each slot taken with a modulo;
- ``md_inline``: mod_depth computed by the envelope warp, in v2 and the
  probes, and their mod_depth warps idle;
- ``md_divide``: the mod_depth warps divide at every step
  (``cond_mod_depth``), where the numerator is zero too;
- ``pair_quotient``: the pair probe's four envelope tests as the
  quotients the TPU original wrote (``d1``, ``e_u``, ``e_s``, ``e_h``);
- ``mask_divide``: the v2 mask's seven threshold tests as the correctly
  rounded divide, staged as now;
- ``mask_zero_split``: the divide, with only its zero numerator taken
  apart (``+-0 / p2 > y`` is ``0 > y``);
- ``mask_unstaged``: the divide-free tests, every lookback read from
  memory where it lies, nothing staged;
- ``mask_unstaged_divide``: neither;
- ``mask_warps8``: the v2 mask with 8 consumer warps instead of 16;
- ``mask_producers1``: the v2 mask with one producer warp instead of 4;
- ``mask_tile32`` / ``mask_stages4`` / ``mask_tile16``: the v2 mask's
  pipeline as 3 stages of 32 rows, 4 of 32 or 6 of 16 (2 of 64 as built);
- ``ffmask_divide``: ``ff_mask_kernel``'s SD tests as the correctly
  rounded divide, with no band and no ``sd_above``;
- ``ffmask_exact``: no band, every SD test through ``sd_above``;
- ``ffmask_unstaged``: its lookbacks read from memory where they lie,
  nothing staged;
- ``ffmask_md_divide``: its mod_depth divided at every sample
  (``cond_mod_depth``, no zero split);
- ``ffmask_warps8``: 8 consumer warps instead of 16, two groups of rows
  each a sub-tile; ``ffmask_producers2`` / ``ffmask_producers6``: 2 or 6
  producer warps instead of 4;
- ``ffmask_tile16`` / ``ffmask_tile32`` / ``ffmask_stages3``: its
  pipeline as 8 stages of 16 rows (4 teams of 4 consumer warps taking the
  sub-tiles in turn), 4 of 32 (2 teams of 8) or 3 of 64 (2 of 64 in one
  team of 16 as built; the last needs 16 streams a block at 10 MS/s);
  ``ffmask_t40s3w10`` / ``ffmask_t32s4w8``: 3 stages of 40 rows for 10
  consumer warps, or 4 of 32 for 8, in the rings of 2 x 64;
- ``ffmask_streams16``: 16 streams a block where 32 fit;
- ``base`` (with ``--base DIR``, the ``csrc/`` of an earlier checkout
  whose pair probe runs one thread per lane in one warp a block and whose
  v2 and fused masks run one thread per (row, stream)): that design as it
  is.

Probes of what bounds a step change what the kernels compute, so their
outputs are not compared (``PROBES``):

- ``no_stores``: every per-step store of the scans skipped but the
  mod_depth warps' (the chains still run; the state rows are still
  written);
- ``md_nodiv`` / ``md_off``: the mod_depth warps of v2 and the probes
  without the divide, or without any work but their waits;
- ``no_handoff``: those warps read the env stages without waiting for
  them (nor the probes' envelope warp for their release);
- ``probe_env_only``: the probes' envelope warp alone (serial and pair);
- ``mask_idle`` / ``mask_no_copy``: the v2 mask's consumers only waiting
  for the producer's copies, or computing on zeroed rings with nothing
  copied; ``ffmask_idle`` / ``ffmask_no_copy`` the same for
  ``ff_mask_kernel``;
- ``env_only``: ``cond_scan_kernel`` with its envelope warp alone;
- ``unroll8`` / ``unroll32``: groups of 8 or 32 steps instead of 16;
- ``no_branch``: ``cond_env_near`` without its special-value branch;
- ``float_test``: the envelope test as one float multiply and compare,
  with no branch.

Each variant runs the conditioning and fused scans on the same seeded
carrier lanes (1024 x 65536 samples, ASK dips, field-off gaps, noise), the
conditioning scan also at 1 x 65536; ``v2_scan_kernel`` on ``bench_v2``'s
first configuration (4096 x 16384 of its noise, carried state); both
probes on the probe's own input at one group (1 x 65536 x 2048, where the
chain's latency bounds them) and at eight (the pair probe's measurement);
``v2_mask_kernel`` on the v2 scan's outputs of that bench_v2 chunk and of
the carrier lanes (1024 x 65536 from a fresh state); ``ff_mask_kernel`` on
the fused scan's outputs of the carrier lanes (mask alone) and of the
lanes in ``--lanes`` (a ``.npy`` of [T, 1024] f32 samples, T >= 2 x 65536,
such as the mask path's captures: its second chunk of 65536 from the state
of its first, mask alone and mask with mod_depth).  ``--only ffmask``
builds and times ``ff_mask_kernel``'s variants and probes alone.  A
lever's outputs must equal the current kernels' bit for bit, and the
pair probe's the serial probe's.  Times are CUDA events over 5 launches
after a warm-up, each variant timed in a forward and a backward pass over
the list.  One JSON line per variant, one with the SM clock and power
draw that nvidia-smi reads while the current v2 scan runs (the fused
mask with ``--only ffmask``), then the card.

    python -m nfclab_torch.experiments.scan_levers [--base DIR]
        [--lanes FILE.npy] [--only ffmask]
"""

from __future__ import annotations

import argparse
import ctypes
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
from ..kernels import fused_v2 as kv
from ..kernels import probes as kp
from . import fused_v2 as v2
from . import probe_pair_spec as pps
from . import probe_serial_floor as psf

RATE = 10_000_000
STREAMS, STEPS = 1024, 65536
V2_STREAMS, V2_STEPS = 4096, 16384
LEVER_DIR = kbuild.BUILD_DIR / "levers"
HEADER = "condition_step.cuh"

_TEST = "    return (double)ad <= __dmul_rn(m, (double)env);"
QUOTIENT = {HEADER: [
    (_TEST, "    return __fdiv_rn(ad, env) < 0.05f;")]}
ONE_PATH = {HEADER: [
    ("        return __all_sync(__activemask(), a | b | pass);",
     "        return false;")]}
GROUP1 = {"fused_v2.cu": [("v2_consume<V2_GROUP>", "v2_consume<1>")]}
MODULO = {"fused_v2.cu": [
    ("constexpr int PV_RING = 128, PF_RING = 128, PQ_RING = 256;",
     "constexpr int PV_RING = RV_RING, PF_RING = RF_RING, PQ_RING = RQ_RING;"),
    ("    return j & (p - 1);", "    return (j % p + p) % p;"),
]}
# the envelope sinks receive v as well; the envelope warps store mod_depth
# and the mod_depth warps store nothing
_MD_NEVER = "if (B == 0u) "
MD_INLINE = {
    HEADER: [("        sink.put(k, env, cnt);", "        sink.put(k, env, cnt, v);"),
             ("        this->sink.put(k, env1, cnt);",
              "        this->sink.put(k, env1, cnt, v1);"),
             ("        this->sink.put(k + 1, env, cnt);",
              "        this->sink.put(k + 1, env, cnt, v2);")],
    "conditioner.cu": [("const CondPulseCounter &c)", "const CondPulseCounter &c, float)")],
    "fused_v2.cu": [
        ("""                                        const CondFloatCounter &)
    {
        etile[(r + k) * 32] = env;
        if (valid) out.put((uint32_t)(r + k) * B, env);""",
         """                                        const CondFloatCounter &, float v)
    {
        etile[(r + k) * 32] = env;
        if (valid) out.put((uint32_t)(r + k) * B, env);
        if (valid) __stcg(out.cur + md_off + (uint32_t)(r + k) * B,
                          cond_mod_depth_split(v, env));"""),
        ("    float *etile;      // the stage's env tile, at this lane's column\n",
         "    float *etile;      // the stage's env tile, at this lane's column\n"
         "    size_t md_off;\n"),
        ("        r.c.sink.out.init(a.out + O_ENV * TB, b);\n",
         "        r.c.sink.out.init(a.out + O_ENV * TB, b);\n"
         "        r.c.sink.md_off = (size_t)(O_MOD_DEPTH - O_ENV) * TB;\n"),
        ("            if (valid) out.put((uint32_t)(r + k) * B, md);",
         "            if (valid) " + _MD_NEVER + "out.put((uint32_t)(r + k) * B, md);"),
    ],
    "probes.cu": [
        ("""                                        const CondFloatCounter &)
    {
        out[(uint32_t)k * L] = env;""",
         """                                        const CondFloatCounter &, float v)
    {
        out[(uint32_t)k * L] = env;
        md[(uint32_t)k * L] = cond_mod_depth_split(v, env);"""),
        ("    float *__restrict__ out;\n    ProbeStages st;\n",
         "    float *__restrict__ out;\n    float *__restrict__ md;\n"
         "    ProbeStages st;\n"),
        ("        out += n;\n        mbar_arrive(st.full + stage);",
         "        out += n;\n        md += n;\n        mbar_arrive(st.full + stage);"),
        ("        c.sink.out = a.env + o0;\n",
         "        c.sink.out = a.env + o0;\n        c.sink.md = a.mod_depth + o0;\n"),
        ("            out[(uint32_t)k * L] = cond_mod_depth_split(v[k], env[k]);",
         "            if (L == 0u) out[(uint32_t)k * L] = "
         "cond_mod_depth_split(v[k], env[k]);"),
        ("        out[(uint32_t)k * L] = cond_mod_depth_split(v, e[k * 32]);",
         "        if (L == 0u) out[(uint32_t)k * L] = "
         "cond_mod_depth_split(v, e[k * 32]);"),
    ],
}
# mod_depth's warps dividing on every step, the zero numerator included
MD_DIVIDE = {f: [("cond_mod_depth_split(", "cond_mod_depth(")]
             for f in ("fused_v2.cu", "probes.cu")}
# the pair probe's four envelope tests as the quotients the TPU original
# wrote, with no vote taking effect
PAIR_QUOTIENT = {HEADER: [
    ("        return Pos ? cond_env_near_pos(v, env) : cond_env_near(v, env);",
     "        return cond_env_diff(v, env) < 0.05f;")]}
# the mask's threshold tests as the correctly rounded divide; or the divide
# with only its zero numerator taken apart (+-0 / p2 > y is 0 > y)
_SD = ("    bool above = sd_above_pos(n, y, mid, p2);\n"
       "    if (__builtin_expect(divide, 0)) above = __fdiv_rn(n, (float)p2) > y;\n"
       "    return above;")
MASK_DIVIDE = {HEADER: [(_SD, "    return __fdiv_rn(n, (float)p2) > y;")]}
MASK_ZERO_SPLIT = {HEADER: [
    (_SD, "    return n == 0.0f ? 0.0f > y : __fdiv_rn(n, (float)p2) > y;")]}
# the mask's lookbacks read from memory (L2) where they lie, nothing staged
MASK_UNSTAGED = {"fused_v2.cu": [
    ("    return rings[(v2_mask_ring_base(C) + ((j - l) & (g.ring - 1))) * 32];",
     "    return b < a.B ? v2_mask_src<C>(a, j - l, b)[0] : 0.0f;"),
    ("    const bool lane_ok = b0 + lane < a.B;\n",
     "    const bool lane_ok = b0 + lane < a.B;\n    if (lo < hi) return;\n"),
]}
# the mask with half its consumer warps, or one producer warp (each
# launched with its warp count)
MASK_WARPS8 = {"fused_v2.cu": [("#define V2_MASK_WARPS 16", "#define V2_MASK_WARPS 8")]}
MASK_PRODUCERS1 = {"fused_v2.cu": [("#define V2_MASK_PRODUCERS 4",
                                    "#define V2_MASK_PRODUCERS 1")]}
MASK_THREADS = {"mask_warps8": (8 + 4) * 32, "mask_producers1": (16 + 1) * 32}
# the mask's pipeline: sub-tile rows and stages in flight (bv12's ring
# shrunk where its spread and the stages fit 256 rows)
_RINGS_OK = ('static_assert(V2_MASK_RING_ROWS == 128 + 4 * 256 + 512, "the rings\' rows");',
             "")
_BV12_256 = ("        : c == MC_BV12 ? V2Lags{O_BV12, 0, 153, 512,",
             "        : c == MC_BV12 ? V2Lags{O_BV12, 0, 153, 256,")


def _mask_pipeline(tile, stages, bv12_256):
    return {"fused_v2.cu": [
        ("#define V2_MASK_TILE 64", f"#define V2_MASK_TILE {tile}"),
        ("#define V2_MASK_STAGES 2", f"#define V2_MASK_STAGES {stages}"),
        _RINGS_OK, *([_BV12_256] if bv12_256 else [])]}

# ff_mask_kernel's levers: its lookbacks from memory, nothing staged
_FF = "fused_frontend.cu"
_FF_GLOBAL = """// lookbacks read from memory, where they lie
template <int W>
__device__ __forceinline__ const float *ff_mask_src(const FFMaskLaunch &k,
                                                    const FFMaskLag &l, int j)
{
    const FFMaskWin &g = k.win[l.win];
    const int64_t b = (int64_t)blockIdx.x * W + (threadIdx.x & 31) % W;
    const int r = j - l.lag;
    return b < k.a.B ? (r < 0 ? g.hist : g.src) + (int64_t)r * k.a.B + b
                     : nullptr;
}
template <int W, int G>
__device__ __forceinline__ void ff_mask_global(const FFMaskLaunch &k,
                                               const FFMaskLag &l, int j0,
                                               float (&v)[G])
{
#pragma unroll
    for (int r = 0; r < G; ++r) {
        const float *p = ff_mask_src<W>(k, l, j0 + r * (32 / W));
        v[r] = p ? *p : 0.0f;
    }
}

// detect_mask at chunk row j of this lane's stream"""
_FF_NO_COPY = ("        for (int w = 0; w < k.n_win && lane_ok; ++w) {",
               "        for (int w = 0; w < 0 && lane_ok; ++w) {")
FFMASK_UNSTAGED = {_FF: [
    ("// detect_mask at chunk row j of this lane's stream", _FF_GLOBAL),
    ("ff_mask_load<W>(col, ", "ff_mask_global<W>(k, "),
    ("return ff_mask_at<W>(col, l, j);",
     "const float *p = ff_mask_src<W>(k, l, j); return p ? *p : 0.0f;"),
    _FF_NO_COPY]}
FFMASK_MD_DIVIDE = {_FF: [
    ("cond_mod_depth_split(v[r], env[r])", "cond_mod_depth(v[r], env[r])")]}
# every SD test as the correctly rounded divide, no band, no sd_above
FFMASK_DIVIDE = {_FF: [
    ("sd_band(fabsf(n), k.rla[q], k.rha[q], y[r], slow[r])",
     "(__fdiv_rn(fabsf(n), (float)k.p2a[q]) > y[r])"),
    ("sd_band(fabsf(n), k.rlf[q], k.rhf[q], y[r], slow[r])",
     "(__fdiv_rn(fabsf(n), (float)k.p2f[q]) > y[r])"),
    ("""sd_band(__fsub_rn(ug[r], u0[r]), k.rlv, k.rhv,
                            __fmul_rn(a.v_thr, env[r]), slow[r])""",
     """(__fdiv_rn(__fsub_rn(ug[r], u0[r]), (float)k.p2v)
                         > __fmul_rn(a.v_thr, env[r]))"""),
    ("        slow[r] = !(env[r] >= k.env_lo && env[r] <= k.env_hi);",
     "        slow[r] = false;")]}
# no band: every test of every row through sd_above (ff_mask_row)
FFMASK_EXACT = {_FF: [
    ("        slow[r] = !(env[r] >= k.env_lo && env[r] <= k.env_hi);",
     "        slow[r] = true;")]}


def _ff_define(name, old, new):
    return (f"#define {name} {old}", f"#define {name} {new}")


def _ff_pipeline(tile, stages):
    return {_FF: [_ff_define("FF_MASK_TILE", 64, tile),
                  _ff_define("FF_MASK_STAGES", 2, stages)]}


FFMASK_STREAMS16 = {_FF: [
    ("    k->streams = ff_mask_smem(rows, 32) <= FF_SMEM_LIMIT ? 32",
     "    k->streams = false ? 32")]}
FFMASK_VARIANTS = {
    "ffmask_divide": FFMASK_DIVIDE,
    "ffmask_exact": FFMASK_EXACT,
    "ffmask_unstaged": FFMASK_UNSTAGED,
    "ffmask_md_divide": FFMASK_MD_DIVIDE,
    "ffmask_warps8": {_FF: [_ff_define("FF_MASK_WARPS", 16, 8)]},
    "ffmask_producers2": {_FF: [_ff_define("FF_MASK_PRODUCERS", 4, 2)]},
    "ffmask_producers6": {_FF: [_ff_define("FF_MASK_PRODUCERS", 4, 6)]},
    "ffmask_tile16": _ff_pipeline(16, 8),
    "ffmask_tile32": _ff_pipeline(32, 4),
    "ffmask_stages3": _ff_pipeline(64, 3),
    "ffmask_t40s3w10": {_FF: [*_ff_pipeline(40, 3)[_FF],
                              _ff_define("FF_MASK_WARPS", 16, 10),
                              _ff_define("FF_MASK_SPAN", 2048, 2040)]},
    "ffmask_t32s4w8": {_FF: [*_ff_pipeline(32, 4)[_FF],
                             _ff_define("FF_MASK_WARPS", 16, 8)]},
    "ffmask_streams16": FFMASK_STREAMS16,
}
FFMASK_PROBES = {
    "ffmask_idle": {_FF: [
        ("                ff_mask_group<W>(k, col, J + r0, nv, b, valid);",
         "                if (B == 0) a.out_mask[0] = (uint8_t)col[r0];")]},
    "ffmask_no_copy": {_FF: [
        _FF_NO_COPY,
        ("    __syncthreads();\n\n    if (warp >= FF_MASK_WARPS) {",
         "    for (int i = threadIdx.x; i < (k.smem - FF_MASK_BARS) / 4;\n"
         "         i += blockDim.x)\n"
         "        rings[i] = 0.0f;\n"
         "    __syncthreads();\n\n    if (warp >= FF_MASK_WARPS) {")]},
}

_NEVER = "if (B == 0u) "  # a store no step makes
_SPECIAL = ("    if (__builtin_expect(!(env > 0.0f && env < INFINITY), 0))\n"
            "        near = cond_env_diff(v, env) < 0.05f;\n")
PROBES = {
    "no_stores": {
        "conditioner.cu": [
            ("        out_env[o] = env;\n        out_pulse[o] = (int32_t)c.pulse;",
             "        " + _NEVER + "{ out_env[o] = env; out_pulse[o] = c.pulse; }"),
        ],
        HEADER: [
            ("        if (W1) out_w1[o] = w1;\n        out_filt[o] = filt;\n"
             "        out_mdev[o] = mdev;",
             "        " + _NEVER + "{ out_w1[o] = w1; out_filt[o] = filt; "
             "out_mdev[o] = mdev; }"),
            ("        out_avg[(uint32_t)k * B] = avg;",
             "        " + _NEVER + "out_avg[0] = avg;"),
        ],
        "fused_frontend.cu": [
            ("        __stcg(cur + o, v);",
             "        if (o == 0xffffffffu) __stcg(cur, v);"),
        ],
        "fused_v2.cu": [
            ("        __stcg(cur + o, v);",
             "        if (o == 0xffffffffu) __stcg(cur, v);"),
        ],
        "probes.cu": [
            ("        out[(uint32_t)k * L] = env;", "        if (L == 0u) out[0] = env;"),
        ],
    },
    "md_nodiv": {HEADER: [
        ("    const float q = __fdiv_rn(zero ? env : num, env);\n"
         "    return zero ? 0.0f : q;", "    return zero ? 0.0f : num;")]},
    "md_off": {
        "fused_v2.cu": [
            ("            const float md =\n"
             "                cond_mod_depth_split(sv[(r + k) * 32], etile[(r + k) * 32]);\n"
             "            if (valid) out.put((uint32_t)(r + k) * B, md);",
             "            if (B == 0u) out.put(0, etile[0]);")],
        "probes.cu": [
            ("            out[(uint32_t)k * L] = cond_mod_depth_split(v[k], env[k]);",
             "            if (L == 0u) out[0] = env[k];")],
    },
    "no_handoff": {
        "fused_v2.cu": [
            ("        mbar_arrive(env_bar + s);  // one arrival per lane", ""),
            ("        mbar_wait(env_bar + s, parity);", "")],
        "probes.cu": [
            ("        mbar_arrive(st.full + stage);\n        if (++stage",
             "        if (++stage"),
            ("        if (round > 0) mbar_wait(st.empty + stage, (round - 1) & 1u);",
             ""),
            ("        if (rem > 0) mbar_arrive(st.full + stage);", ""),
            ("        mbar_wait(st.full + stage, round & 1u);", ""),
            ("        mbar_arrive(st.empty + stage);", "")],
    },
    "probe_env_only": {"probes.cu": [
        ("        if (round > 0) mbar_wait(st.empty + stage, (round - 1) & 1u);",
         ""),
        ("    } else if (warp == 1) {\n        CondFiltChain<false> c;",
         "    } else if (a.T < 0) {\n        CondFiltChain<false> c;"),
        ("    } else if (warp == 2) {\n        CondAvgChain c;",
         "    } else if (a.T < 0) {\n        CondAvgChain c;"),
        ("    } else {\n        ProbeDepthChain c;",
         "    } else if (a.T < 0) {\n        ProbeDepthChain c;")]},
    "env_only": {"conditioner.cu": [
        ("    } else if (warp == 1) {", "    } else if (warp == 1 && a.T < 0) {"),
        ("    } else {\n        CondAvgChain c;",
         "    } else if (a.T < 0) {\n        CondAvgChain c;"),
    ]},
    "mask_idle": {"fused_v2.cu": [
        ("            const float m = v2_mask_row(a, col, b, J + k, carry);\n"
         "            if (valid) __stcg(mask + (int64_t)(J + k) * a.B, m);",
         "            if (a.B == 0) __stcg(mask, col[0]);")]},
    "mask_no_copy": {"fused_v2.cu": [
        *MASK_UNSTAGED["fused_v2.cu"][1:],
        ("    __syncthreads();\n\n    if (warp >= V2_MASK_WARPS) {",
         "    for (int i = threadIdx.x; i < V2_MASK_RING_ROWS * 32; i += blockDim.x)\n"
         "        rings[i] = 0.0f;\n"
         "    __syncthreads();\n\n    if (warp >= V2_MASK_WARPS) {")]},
    "unroll8": {HEADER: [("#define COND_UNROLL 16", "#define COND_UNROLL 8")]},
    "unroll32": {HEADER: [("#define COND_UNROLL 16", "#define COND_UNROLL 32")]},
    "no_branch": {HEADER: [(_SPECIAL, "")]},
    "float_test": {HEADER: [
        (_SPECIAL, ""),
        (_TEST, "    return ad <= __fmul_rn(0.05f, env);"),
    ]},
    **FFMASK_PROBES,
}
# every patch of the current sources, for the test that they apply
VARIANTS = {"quotient": QUOTIENT, "one_path": ONE_PATH, "group1": GROUP1,
            "modulo": MODULO, "md_inline": MD_INLINE, "md_divide": MD_DIVIDE,
            "pair_quotient": PAIR_QUOTIENT, "mask_divide": MASK_DIVIDE,
            "mask_zero_split": MASK_ZERO_SPLIT,
            "mask_unstaged": MASK_UNSTAGED,
            "mask_unstaged_divide": {**MASK_UNSTAGED, **MASK_DIVIDE},
            "mask_warps8": MASK_WARPS8, "mask_producers1": MASK_PRODUCERS1,
            "mask_tile32": _mask_pipeline(32, 3, True),
            "mask_stages4": _mask_pipeline(32, 4, False),
            "mask_tile16": _mask_pipeline(16, 6, True),
            **FFMASK_VARIANTS}


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


def build_variant(name: str, src: Path, patches: dict):
    """Build the kernel library from a copy of src with each (old, new) of
    patches[file] applied (each must match); returns the library's
    path."""
    root = LEVER_DIR / name
    if root.exists():
        shutil.rmtree(root)
    work = root / "csrc"
    shutil.copytree(src, work)
    for fname, edits in patches.items():
        text = (work / fname).read_text()
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in {fname}")
            text = text.replace(old, new)
        (work / fname).write_text(text)
    return kbuild.build(force=True, src_dir=work, build_dir=root)


class Variant:
    """A library and its launch geometry: the earlier design (``base``)
    runs its pair probe one warp a block and its v2 mask one thread per
    (row, stream) in blocks of 256."""

    def __init__(self, name, path, base=False, group=None, probe=False,
                 mask_threads=None):
        self.name, self.path = name, path
        self.base, self.group, self.probe = base, group, probe
        self.mask_threads = mask_threads
        self.lib = None

    def __enter__(self):
        if self.lib is None:
            self.lib = kf.bind(self.path)
        self.saved = (kf.library, kc.library, kv.library, kp.library,
                      kf.scan_group, kv.MASK_THREADS, kv.scan_smem,
                      kp.PAIR_THREADS)
        kf.library = kc.library = kv.library = kp.library = lambda: self.lib
        # the library sizes the v2 scan's shared memory (a variant's rings
        # differ)
        kv.scan_smem = lambda stages=None: self.lib.nfclab_v2_scan_smem()
        if self.base:
            kv.MASK_THREADS, kp.PAIR_THREADS = 256, 32
        if self.mask_threads is not None:
            kv.MASK_THREADS = self.mask_threads
        if self.group is not None:
            kf.scan_group = lambda plan: self.group
        return self

    def __exit__(self, *exc):
        (kf.library, kc.library, kv.library, kp.library, kf.scan_group,
         kv.MASK_THREADS, kv.scan_smem, kp.PAIR_THREADS) = self.saved


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


KEYS = ("cond", "cond_repair", "ff_scan", "v2_scan", "serial_probe",
        "pair_probe", "serial_probe8", "pair_probe8", "v2_mask",
        "v2_mask_carrier")
FF_KEYS = ("ff_mask_carrier", "ff_mask", "ff_mask_md")
MASK_PARAMS = (0.01, 0.75, 0.10, 0.50, 0.50)


def _ff_inputs(x_tm, pt, plan, chunks):
    """The fused scan's outputs on chunk `chunks - 1` of x_tm (65536 rows a
    chunk) from the state it carries out of the ones before: (deps, the
    chunk, its input state, its output state)."""
    st = torch.zeros(plan.nstate, x_tm.shape[1], device=x_tm.device)
    with torch.no_grad():
        for c in range(chunks):
            xc = x_tm[c * STEPS : (c + 1) * STEPS].contiguous()
            deps, _, so = ff.fused_scan(xc, st, c * STEPS, pt, plan)
            if c + 1 < chunks:
                st = so
    return deps, xc, st, so


def _ff_mask(v, inputs, want_md, plan):
    """ff_mask_kernel of variant v on the inputs; an earlier design
    (``base``) through its own launch geometry, one thread per (row,
    stream) in blocks of 256, on the same arguments."""
    deps, xc, st_in, st_out = inputs
    if not v.base:
        out = ff.fused_mask(deps, xc, st_in, st_out, MASK_PARAMS, plan, True,
                            want_md)
        return out["detect_mask"], out.get("mod_depth"), st_out
    T, B = xc.shape
    out_m = torch.empty(T, B, dtype=torch.uint8, device=xc.device)
    out_d = torch.empty(T, B, device=xc.device) if want_md else None
    a = kf.mask_args(deps, xc, st_in, st_out, out_m, out_d,
                     ff._mask_params(MASK_PARAMS), plan, ff._layout(plan))
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    kf.check(v.lib, v.lib.nfclab_ff_mask(ctypes.byref(a), xc.device.index,
                                         256, stream), "ff_mask (base)")
    return out_m, out_d, st_out


def run(base: Path = None, lanes: Path = None, only: str = None,
        device="cuda") -> list:
    dev = torch.device(device)
    pt = _params_tuple(SignalParams(RATE))
    plan = ff.kernel_plan(RATE)
    x = torch.from_numpy(carrier_lanes(STREAMS, STEPS)).to(dev)
    calls = {}
    keys = () if only == "ffmask" else KEYS
    # ff_mask_kernel's inputs: the fused scan's outputs of the carrier
    # lanes (chunk 0) and of the second chunk of --lanes
    hist = ff._layout(plan)
    hist_rows = torch.zeros(plan.nstate, dtype=torch.bool, device=dev)
    hist_rows[hist.hist_off : hist.hist_off + hist.hist_rows] = True
    ff_in = {"ff_mask_carrier": _ff_inputs(x, pt, plan, 1)}
    if lanes is not None:
        xl = torch.from_numpy(np.load(lanes)[: 2 * STEPS]).to(dev)
        if xl.shape != (2 * STEPS, STREAMS):
            raise ValueError(f"--lanes: need [{2 * STEPS}, {STREAMS}] "
                             f"samples, got {tuple(xl.shape)}")
        ff_in["ff_mask"] = ff_in["ff_mask_md"] = _ff_inputs(xl, pt, plan, 2)
        del xl
    for k, inputs in ff_in.items():
        calls[k] = (lambda v, i=inputs, md=k.endswith("_md"):
                    _ff_mask(v, i, md, plan))
    keys += tuple(k for k in FF_KEYS if k in ff_in)
    if only != "ffmask":
        x1 = x[:, :1].contiguous()
        init = (x[0].clone(), x[0] * 10.0, torch.zeros_like(x[0]),
                x[0].clone(),
                torch.zeros(STREAMS, dtype=torch.int32, device=dev),
                torch.zeros(STREAMS, dtype=torch.int32, device=dev))
        init1 = tuple(t[:1].contiguous() for t in init)
        st = torch.zeros(plan.nstate, STREAMS, device=dev)
        # bench_v2's input, its second chunk from the state of its first
        rng = np.random.default_rng(0)
        xv = torch.from_numpy(rng.random((2 * V2_STEPS, V2_STREAMS),
                                         dtype=np.float32) * np.float32(0.4)
                              ).to(dev)
        xv1 = xv[V2_STEPS:].contiguous()
        xp = psf.probe_input(1, psf.T_PROBE, psf.SUB, dev)
        xp8 = psf.probe_input(8, psf.T_PROBE, psf.SUB, dev)
        with Variant("current", kbuild.build()):
            stv = v2.v2_scan(xv[:V2_STEPS].contiguous(),
                             torch.zeros(v2.NSTATE, V2_STREAMS, device=dev),
                             0, pt)[1]
            # the mask's inputs: the scan's outputs on bench_v2's chunk and
            # on the carrier lanes (chunk 0, zero state)
            outv, sov = v2.v2_scan(xv1, stv, V2_STEPS, pt)
            stc = torch.zeros(v2.NSTATE, STREAMS, device=dev)
            outc, soc = v2.v2_scan(x, stc, 0, pt)
        del xv

        def mask(out, st_in, st_out, base_clock):
            v2.v2_mask(out, st_in, st_out, base_clock, MASK_PARAMS)
            return out[-1], st_out

        calls.update({
            "cond": lambda v: ck.condition_scan_tm(x, *init, pt),
            "cond_repair": lambda v: ck.condition_scan_tm(x1, *init1, pt),
            "ff_scan": lambda v: ff.fused_scan(x, st, 0, pt, plan),
            "v2_scan": lambda v: v2.v2_scan(xv1, stv, V2_STEPS, pt),
            "serial_probe": lambda v: psf.serial_probe(xp),
            "pair_probe": lambda v: pps.pair_probe(xp),
            "serial_probe8": lambda v: psf.serial_probe(xp8),
            "pair_probe8": lambda v: pps.pair_probe(xp8),
            "v2_mask": lambda v: mask(outv, stv, sov, V2_STEPS),
            "v2_mask_carrier": lambda v: mask(outc, stc, soc, 0),
        })

    current = kbuild.build()
    variants = [Variant("current", current)]
    for name, patches in VARIANTS.items():
        if only == "ffmask" and not name.startswith("ffmask"):
            continue
        variants.append(Variant(
            name, build_variant(name, kbuild.SRC_DIR, patches),
            group=1 if name == "group1" else None,
            mask_threads=MASK_THREADS.get(name)))
    if base is not None:
        variants.append(Variant("base", build_variant("base", base, {}),
                                base=True))
    for name, patches in PROBES.items():
        if only == "ffmask" and not name.startswith("ffmask"):
            continue
        variants.append(Variant(name, build_variant(name, kbuild.SRC_DIR,
                                                    patches), probe=True))

    # the v2 scan owns every state row but the mask's
    scan_rows = ~v2.mask_state_rows().to(dev)
    want = None
    for v in variants:
        if v.probe:
            continue
        with v:
            flat = []
            if only != "ffmask":
                # eight groups: the pair probe equals the serial one (20 GB
                # of outputs each, not kept)
                for a, b in zip(calls["pair_probe8"](v),
                                calls["serial_probe8"](v)):
                    if not torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)):
                        raise AssertionError(f"variant {v.name}: pair != "
                                             f"serial")
                got = {k: calls[k](v) for k in KEYS if not k.endswith("8")}
                for a, b in zip(got["pair_probe"], got["serial_probe"]):
                    if not torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)):
                        raise AssertionError(f"variant {v.name}: pair != "
                                             f"serial")
                flat += [*got["cond"], *got["cond_repair"], got["ff_scan"][0],
                         got["ff_scan"][2], got["v2_scan"][0][:-1],
                         got["v2_scan"][1][scan_rows]]
                for k in ("serial_probe", "pair_probe"):
                    flat += [t.clone() for t in got[k]]
                for k in ("v2_mask", "v2_mask_carrier"):
                    flat += [got[k][0].clone(), got[k][1][~scan_rows]]
                del got
            for k in FF_KEYS:
                if k in calls:
                    m, md, so = calls[k](v)
                    flat += [m.clone(), so[hist_rows].clone()]
                    flat += [md.clone()] if md is not None else []
        if want is None:
            want = flat
        elif not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                     for a, b in zip(flat, want)):
            raise AssertionError(f"variant {v.name} differs from current")
        del flat
    del want
    times = {v.name: [] for v in variants}
    for v in variants + variants[::-1]:
        with v:
            times[v.name].append(tuple(_event_ms(lambda: calls[k](v))
                                       for k in keys))
    rows = []
    # the clocks under the v2 scan, or under ff_mask_kernel alone
    probe_key = "v2_scan" if only != "ffmask" else keys[-1]
    with variants[0]:
        load = clocks_under_load(lambda: calls[probe_key](variants[0]), 500)
    steps = {"cond": STEPS, "cond_repair": STEPS, "ff_scan": STEPS,
             "v2_scan": V2_STEPS, "serial_probe": psf.T_PROBE,
             "pair_probe": psf.T_PROBE, "serial_probe8": psf.T_PROBE,
             "pair_probe8": psf.T_PROBE, "v2_mask": V2_STEPS,
             "v2_mask_carrier": STEPS, "ff_mask_carrier": STEPS,
             "ff_mask": STEPS, "ff_mask_md": STEPS}
    for v in variants:
        t = np.array(times[v.name])
        row = {"variant": v.name, "probe": v.probe}
        for i, key in enumerate(keys):
            row[key + "_ms"] = float(t[:, i].mean())
            row[key + "_ns_per_step"] = float(
                t[:, i].mean() * 1e6 / steps[key])
            row[key + "_ms_passes"] = [float(a) for a in t[:, i]]
        rows.append(row)
    rows.append({"during": f"500 current {probe_key} calls", **load})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", type=Path, default=None,
                    help="csrc/ of an earlier checkout (one-warp pair "
                         "probe, one thread per (row, stream) masks)")
    ap.add_argument("--lanes", type=Path, default=None,
                    help=".npy of [T, 1024] f32 samples, T >= 131072, for "
                         "ff_mask_kernel's second chunk")
    ap.add_argument("--only", choices=["ffmask"], default=None,
                    help="build and time ff_mask_kernel's variants alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_levers: needs a CUDA device")
    for row in run(args.base, args.lanes, args.only):
        print(json.dumps(row), flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
