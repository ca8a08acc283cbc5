"""Streaming and serving throughput: one JSON object of samples/s.

Counterpart of ``nfclab/tools/streaming_bench.py``.  Measures the live
decode paths that ``e2e_bench`` does not cover, on a looped capture
(``--wav``):

- single_stream_windowed: ``StreamingNfcDecoder`` with a bounded window
  fed fixed-size chunks, the host hot path of ``decode_cli live``; wall
  and user-CPU rates, per 10 M-sample segment.
- farm_cuda*: ``runtime/farm.CudaStreamFarm``'s aggregate rate over N
  concurrent streams in six configurations (full fetch; mask fetch on
  dense, frame-sparse and recorded-idle traffic; 16 streams of each
  idle kind), each the best of two sessions after a warm pass, with
  the farm's stage seconds (``device_s``, ``walk_s``, ``wait_s``), its
  dispatches and the host<->card link at the time
  (``e2e_bench._measure_link``).
- ``--soak PER_STREAM``: a >= 1 G-sample aggregate 4-stream mask-mode
  session with its per-segment rates and resident set.  It runs for many
  minutes and only when asked, by hand; nothing else runs it.

Usage: python -m nfclab_torch.tools.streaming_bench --wav PATH
[--out FILE] [--total N] [--farm-total N] [--streams N] [--skip-farm]
[--skip-single] [--soak PER_STREAM] [--device cpu].  Prints the sparse
single-stream entry (or everything, when it was skipped); writes the
whole object to ``--out`` only when that is given.  nfclab's tool loops
the reference decoder's fixture test_NFC-A_106kbps_001.  Exit 1, with a
message, when ``--wav`` is not given or missing, or there is no card
(``--device cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import json
import resource
import time

import numpy as np


def _looped_capture(wav: str, total: int, idle_ratio: int = 0,
                    idle: str = "const") -> tuple[np.ndarray, int]:
    """Tile the capture at ``wav`` to `total` samples; idle_ratio appends
    that many capture-lengths of idle carrier between repetitions (live
    traffic is frame-sparse; the looped capture alone is ~10x denser).

    idle="const" is flat 0.5 carrier, a worst case for the farm's
    segmented engine: EXACTLY constant f32 input has multiple EMA fixed
    points, so speculative boundary states never bit-converge and the
    farm backs off to the serial chain.  idle="recorded" tiles a real
    idle-carrier stretch of the capture itself (noisy on the i16 grid,
    like any live SDR stream: the noise dithers the conditioning
    trajectories together, which is what production idle looks like)."""
    from ..io.wav import read_wav

    samples, info = read_wav(wav)
    if idle_ratio:
        n_idle = len(samples) * idle_ratio
        if idle == "recorded":
            stretch = np.asarray(samples[2048:10240], np.float32)
            pad = np.tile(stretch, n_idle // len(stretch) + 1)[:n_idle]
        else:
            pad = np.full(n_idle, np.float32(0.5))
        samples = np.concatenate([samples, pad])
    reps = total // len(samples) + 1
    return np.tile(samples, reps)[:total], info.sample_rate


def bench_single_stream(wav: str, total: int = 40_000_000,
                        chunk: int = 65536, window: int = 1 << 20,
                        idle_ratio: int = 0) -> dict:
    """Full-session wall rate over `total` samples, segmented so warmup
    (the session-start buffer populate) and the sustained steady-state
    rate are both visible.  The real-time claim is the SESSION AVERAGE:
    it includes warmup."""
    from ..runtime.streaming import StreamingNfcDecoder

    seg_len = 10_000_000
    sig, rate = _looped_capture(wav, seg_len, idle_ratio)
    dec = StreamingNfcDecoder(rate, window=window)
    frames = 0
    segments = []
    total_wall = 0.0
    total_user = 0.0
    done = 0
    while done < total:
        n = min(seg_len, total - done)
        u0 = resource.getrusage(resource.RUSAGE_SELF).ru_utime
        t0 = time.perf_counter()
        for off in range(0, n, chunk):
            frames += len(dec.feed(sig[off : off + chunk]))
        wall = time.perf_counter() - t0
        user = resource.getrusage(resource.RUSAGE_SELF).ru_utime - u0
        segments.append(round(n / wall))
        total_wall += wall
        total_user += user
        done += n
    frames += len(dec.finish())
    sustained = segments[1:] or segments
    return {
        "metric": "streaming_samples_per_second",
        "value": round(done / total_wall),
        "unit": "samples/s",
        "user_cpu_samples_per_second": round(done / max(total_user, 1e-9)),
        "segment_rates": segments,
        "sustained_samples_per_second": round(
            sum(sustained) / len(sustained)
        ),
        "window": window,
        "chunk": chunk,
        "samples": done,
        "frames": frames,
        "idle_ratio": idle_ratio,
    }


def _stages(stats: dict) -> dict:
    out = {
        "device_link_s": round(stats["device_s"], 3),
        "host_walk_s": round(stats["walk_s"], 3),
        "pipeline_wait_s": round(stats["wait_s"], 3),
        "dispatches": stats["dispatches"],
    }
    if stats.get("seg_dispatches"):
        for key in ("seg_dispatches", "repaired_streams", "repair_chunks"):
            out[key] = stats[key]
    return out


def bench_farm(wav: str, n_streams: int = 4, total: int = 2_000_000,
               chunk: int = 65536, window: int | None = 1 << 21,
               fetch: str = "full", idle_ratio: int = 0,
               idle: str = "const", warm: bool = True, device="cuda",
               **farm_kwargs) -> dict:
    """CudaStreamFarm's aggregate rate: every stream fed the same looped
    capture, `chunk` samples a feed, one session of `total` samples a
    stream (after a warm pass when `warm`)."""
    from ..runtime.farm import CudaStreamFarm

    sig, rate = _looped_capture(wav, total, idle_ratio, idle)

    def run(n_samples: int) -> tuple[float, float, int, dict, list]:
        farm = CudaStreamFarm(n_streams, rate, window=window, fetch=fetch,
                              device=device, **farm_kwargs)
        blocks = np.empty((n_streams, chunk), np.float32)
        frames = 0
        # segment on DRAINED (fully processed) samples: fed samples stage
        # instantly in the pipeline and would alias the segment clock
        seg_len = max(chunk, n_samples // 8 // chunk * chunk) * n_streams
        segments = []
        t0 = time.perf_counter()
        t_seg = t0
        seg_mark = 0
        r0 = resource.getrusage(resource.RUSAGE_SELF)
        for off in range(0, n_samples, chunk):
            part = sig[off : off + chunk]
            if len(part) < chunk:
                break
            for s in range(n_streams):
                blocks[s] = part
            frames += sum(len(f) for f in farm.feed(blocks))
            drained = farm.stats["drained_samples"]
            if drained - seg_mark >= seg_len:
                now = time.perf_counter()
                segments.append(
                    round((drained - seg_mark) / (now - t_seg))
                )
                t_seg, seg_mark = now, drained
        frames += sum(len(f) for f in farm.finish())
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        cpu = (r1.ru_utime + r1.ru_stime) - (r0.ru_utime + r0.ru_stime)
        return time.perf_counter() - t0, cpu, frames, dict(farm.stats), \
            segments

    if warm:
        # a warm pass that reaches a full k_chunks dispatch from BOTH
        # clock bases (0 and the fold): the kernels' build and the
        # process's first-touch page faults otherwise land inside the
        # measured session
        run(min(total, 65536 * (2 * farm_kwargs.get("k_chunks", 32) + 1)))
    wall, cpu, frames, stats, segments = run(total)
    done = (total // chunk) * chunk * n_streams
    steady = (
        round(sum(segments[len(segments) // 2 :])
              / max(1, len(segments) - len(segments) // 2))
        if segments else round(done / wall)
    )
    out = {
        "metric": "farm_aggregate_samples_per_second",
        "value": round(done / wall),
        "unit": "samples/s",
        # session-start page faults dominate short sessions; the
        # steady-state segment rate is the deployment figure
        "sustained_samples_per_second": steady,
        "segment_rates": segments,
        "user_cpu_aggregate_samples_per_second": round(done / max(cpu, 1e-9)),
        "n_streams": n_streams,
        "fetch": fetch,
        "idle_ratio": idle_ratio,
        "idle": idle,
        "samples_per_stream": (total // chunk) * chunk,
        "frames": frames,
        "note": "pipelined chained engine: device+link work overlaps the "
                "host walk; wall ~= max(stage), not sum",
    }
    if stats.get("dispatches"):
        out["stages"] = _stages(stats)
    return out


def bench_farm_soak(wav: str, n_streams: int = 4,
                    per_stream: int = 256_000_000, chunk: int = 65536,
                    window: int | None = 1 << 21, idle_ratio: int = 4,
                    segment: int = 32_000_000, idle: str = "const",
                    device="cuda", **farm_kwargs) -> dict:
    """Deployment-length farm soak: a >=1 G-sample aggregate 4-stream
    mask-mode session with O(window) host memory.  Reports per-segment
    aggregate rates (flatness = no state/leak-driven slowdown) and the
    resident-set trajectory (bounded = windowing holds under the farm)."""
    import os

    from ..runtime.farm import CudaStreamFarm

    def rss_mb() -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e6

    sig, rate = _looped_capture(wav, segment, idle_ratio, idle)
    farm = CudaStreamFarm(n_streams, rate, window=window, fetch="mask",
                          device=device, **farm_kwargs)
    blocks = np.empty((n_streams, chunk), np.float32)
    frames = 0
    segments = []
    rss = []
    done = 0
    t_all = time.perf_counter()
    while done < per_stream:
        t0 = time.perf_counter()
        seg_done = 0
        lim = min(segment, per_stream - done)
        for off in range(0, lim, chunk):
            part = sig[off % segment : off % segment + chunk]
            if len(part) < chunk:
                break
            for s in range(n_streams):
                blocks[s] = part
            frames += sum(len(f) for f in farm.feed(blocks))
            seg_done += chunk
        done += seg_done
        segments.append(
            round(n_streams * seg_done / (time.perf_counter() - t0))
        )
        rss.append(round(rss_mb()))
    frames += sum(len(f) for f in farm.finish())
    wall = time.perf_counter() - t_all
    return {
        "metric": "farm_soak_aggregate_samples_per_second",
        "value": round(n_streams * done / wall),
        "unit": "samples/s",
        "n_streams": n_streams,
        "samples_per_stream": done,
        "aggregate_samples": n_streams * done,
        "frames": frames,
        "idle_ratio": idle_ratio,
        "idle": idle,
        "window": window,
        "segment_rates": segments,
        "rss_mb": rss,
        "stages": {
            **_stages(farm.stats),
            **{key: farm.stats[key] for key in (
                "seg_dispatches", "repaired_streams", "repair_chunks")},
        },
        "note": "flat segment_rates + bounded rss_mb = the windowed farm "
                "holds deployment-length sessions; rates include all "
                "pipeline stages (overlapped)",
    }


FARM_CONFIGS = (
    # (key, streams (None: --streams), keyword arguments of bench_farm)
    ("farm_cuda", None, {}),
    # mask mode (device triggers compacted to O(triggers)): dense worst
    # case and frame-sparse live-like traffic, then 16 streams
    ("farm_cuda_mask_dense", None, {"fetch": "mask"}),
    ("farm_cuda_mask_sparse", None, {"fetch": "mask", "idle_ratio": 4}),
    # "recorded" idle: the capture's own noisy idle carrier (what live
    # SDR traffic looks like; the segmented engine verifies and keeps its
    # speedup) against the exactly constant idle above (the worst case:
    # the farm backs off to the serial chain, see _looped_capture)
    ("farm_cuda_mask_sparse_live", None,
     {"fetch": "mask", "idle_ratio": 4, "idle": "recorded"}),
    ("farm_cuda_mask_16", 16,
     {"fetch": "mask", "window": 1 << 21, "idle_ratio": 4}),
    ("farm_cuda_mask_16_live", 16,
     {"fetch": "mask", "window": 1 << 21, "idle_ratio": 4,
      "idle": "recorded"}),
)


def main(argv=None) -> int:
    import argparse
    import os
    import sys

    from ..dsp.cuda_channels import DeviceUnavailable, resolve_device
    from .fixtures import missing

    ap = argparse.ArgumentParser(prog="nfclab-torch-streaming-bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--wav", help="the capture to loop")
    ap.add_argument("--out", default=None,
                    help="write the whole JSON object here")
    ap.add_argument("--total", type=int, default=40_000_000)
    ap.add_argument("--farm-total", type=int, default=2_000_000)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--skip-farm", action="store_true")
    ap.add_argument("--soak", type=int, default=0, metavar="PER_STREAM",
                    help="run the >=1G-sample farm soak with this many "
                    "samples per stream (e.g. 256000000)")
    ap.add_argument("--skip-single", action="store_true",
                    help="keep the single-stream entries already in --out")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    if missing([args.wav] if args.wav else []):
        return 1
    try:
        dev = None if args.skip_farm else resolve_device(args.device)
    except DeviceUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    out = {}
    if args.skip_single:
        if args.out and os.path.exists(args.out):
            with open(args.out) as f:
                out = json.load(f)
    else:
        # back-to-back frames (looped capture) and frame-sparse live-like
        # traffic (1 capture : 9 idle): the walk cost scales with frame
        # density, so both bound the deployment range
        out["single_stream_windowed_dense"] = bench_single_stream(
            args.wav, args.total)
        out["single_stream_windowed_sparse"] = bench_single_stream(
            args.wav, args.total, idle_ratio=9)
    if dev is not None:
        from .e2e_bench import _measure_link

        for key, streams, kw in FARM_CONFIGS:
            best = None
            for _ in range(2):
                r = bench_farm(args.wav, streams or args.streams,
                               args.farm_total, device=dev, **kw)
                if best is None or r["value"] > best["value"]:
                    best = r
            if dev.type == "cuda":
                best["link_at_bench"] = _measure_link(dev)
            out[key] = best
        if args.soak:
            out["farm_soak"] = bench_farm_soak(args.wav, args.streams,
                                               args.soak, device=dev)
            out["farm_soak_live_idle"] = bench_farm_soak(
                args.wav, args.streams, args.soak, idle="recorded",
                device=dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    key = out.get("single_stream_windowed_sparse")
    print(json.dumps(key if key is not None else out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
