"""Batch decode: many captures through one device conditioning pass,
parallel host symbol walks.

Counterpart of ``nfclab/runtime/batch.py``.  This is the data-parallel
throughput configuration: the device frontend batches across captures on
``device`` (cuda unless the caller asks for the CPU), while the thin event
walks fan out over host workers.

The walks' executor, by default (``pool="process"``), follows one rule
read from the process's state: fork workers while the parent may fork
(``_fork_ok``: one thread, CUDA never initialized), otherwise threads over
the parent's own arrays (the walk's native calls release the interpreter
lock), so nothing is pickled and no interpreter boots.
``pool="thread"`` always walks on threads.

- ``frontend="host"`` with ``conditioner="jax"`` (the default): the device
  conditioner ``dsp.conditioner.condition_jax`` runs in the parent, capture
  by capture; the workers walk.
- ``frontend="host"`` with ``conditioner="native"``: the C++ conditioner
  runs in the workers.
- ``frontend="mask"``: the detect triggers of every capture come from the
  fused frontend kernels in one chained pass
  (``dsp.cuda_channels.fused_batch_masks``), while the parent conditions
  natively.
- ``frontend="fused"`` with ``conditioner="device"``: the full-channel
  device frontend (``dsp.cuda_channels.fused_batch_all``): conditioning,
  every correlator channel and the detect mask from the fused kernels'
  exact chained pass; only the carrier-edge tracker and the walks run on
  the host.
- ``frontend="fused"`` with another conditioner: the box channels (the
  overlap-save block layout) and the detect triggers (the chained
  engine) from the fused kernels (``dsp.cuda_channels.
  fused_batch_channels``); native conditioning runs in the workers.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from ..core.frame import Frame
from ..core.params import SignalParams
from ..io.wav import read_wav
from .decoder import NfcDecoder

# stats counters of decode_batch's steps (trace.Lap)
_COUNTERS = {"batch.read": "read_s", "batch.condition": "condition_s",
             "batch.pool": "pool_s", "batch.walk": "walk_wait_s",
             "batch.masks": "masks_s",
             "batch.condition_native": "native_condition_s",
             "batch.masks_wait": "masks_wait_s"}

# job list inherited by fork-pool workers (copy-on-write pages: no sample
# pickling, no interpreter boot — see _fork_ok)
_FORK_JOBS: list | None = None


def _walk_fork(i: int) -> list[Frame]:
    return _walk_one(_FORK_JOBS[i])


# ------------------------------------------------------- persistent pool
# Deployment-shaped worker pool: processes stay alive across decode_batch
# calls so their heaps stay warm.  Jobs are PATHS, not samples: each
# worker reads + conditions + walks its captures end to end, so nothing
# big crosses the pipe in either direction but the frames.

_PERSIST: dict[int, object] = {}


def _persist_init() -> None:
    from ..core.malloc_tune import malloc_tune

    malloc_tune()


def _walk_path(args) -> list[Frame]:
    path, kwargs = args
    samples, info = read_wav(path)
    dec = NfcDecoder(**kwargs)
    return dec.decode(samples, info.sample_rate)


def persistent_pool(workers: int) -> ProcessPoolExecutor:
    """Shared long-lived worker pool (fork when safe, else spawn)."""
    ex = _PERSIST.get(workers)
    if ex is None:
        ctx = "fork" if _fork_ok() else "spawn"
        ex = ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context(ctx),
            initializer=_persist_init,
        )
        _PERSIST[workers] = ex
    return ex


def shutdown_pools() -> None:
    for ex in _PERSIST.values():
        ex.shutdown()
    _PERSIST.clear()


def _fork_ok() -> bool:
    """Fork workers are safe (and much cheaper than spawn) only while the
    parent is single-threaded and has not initialized CUDA: a forked child
    of a process with a CUDA context cannot use it and may deadlock on
    CUDA's own threads.  This replaces nfclab's check for a live XLA
    backend."""
    import threading

    import torch

    if not hasattr(os, "fork"):
        return False
    if threading.active_count() > 1:
        return False
    return not torch.cuda.is_initialized()


def _walk_one(args) -> list[Frame]:
    """Host-side walk over precomputed conditioning (runs in a worker;
    imports stay local so workers never touch the device).
    cond_arrays=None means the worker conditions locally with the native
    C++ chain — the dominant host cost, parallelized across the pool."""
    samples, sample_rate, cond_arrays, tpu_channels, kwargs = args
    dec = NfcDecoder(**kwargs)
    if cond_arrays is None:
        return dec.decode(samples, sample_rate, tpu_channels=tpu_channels)
    from ..native.binding import Conditioned

    cond = Conditioned(*cond_arrays)
    return dec.decode(
        samples, sample_rate, cond=cond, tpu_channels=tpu_channels
    )


def _masks_pass(captures: list, rate: int, power_thr: float, thresholds,
                device) -> tuple:
    """The mask frontend's device pass over every capture, on the thread
    that calls it: (the captures' trigger sets, the pass's own counters).
    The counters are a dict of this thread's: ``masks_s`` (the pass, span
    ``batch.masks``) and fused_batch_masks' counters, each prefixed
    ``masks_`` so they never mix with the device conditioner's."""
    from ..dsp.cuda_channels import fused_batch_masks
    from . import trace

    own: dict = {}
    engine: dict = {}
    with trace.Lap(own, _COUNTERS).step(
            "batch.masks", captures=len(captures),
            samples=sum(len(x) for x in captures)):
        sets = fused_batch_masks(captures, rate, power_thr,
                                 thresholds=thresholds, device=device,
                                 stats=engine)
    own.update({f"masks_{k}": v for k, v in engine.items()})
    return sets, own


def _pool_map(pool, kind: str, fn, items: list,
              stats: dict | None) -> list:
    """fn over items on `pool`, an executor of `kind` ("thread" or "fork")
    shut down at the end, in order.  Submitting every item is the step
    ``batch.pool`` (``pool_s``: a process pool starts its workers as the
    first items go in); waiting for the results and the shutdown is
    ``batch.walk`` (``walk_wait_s``; its span's ``pool`` is `kind`)."""
    from . import trace

    with pool:
        lap = trace.Lap(stats, _COUNTERS)
        with lap.step("batch.pool"):
            results = pool.map(fn, items)
        with lap.step("batch.walk", pool=kind):
            out = list(results)
            pool.shutdown()
    return out


def decode_batch(
    paths: list[str],
    workers: int | None = None,
    conditioner: str = "jax",
    frontend: str = "host",
    pool: str = "process",
    keep_pool: bool = False,
    device="cuda",
    stats: dict | None = None,
    **decoder_kwargs,
) -> dict[str, list[Frame]]:
    """Decode many wav captures: the device frontend in the parent process
    on ``device``, event walks across a worker pool (see the module
    docstring for the frontend/conditioner pairs).

    ``pool`` picks the walks' executor.  ``"process"`` (the default): fork
    workers while ``_fork_ok()`` holds (the parent has one thread and no
    CUDA context), otherwise min(captures, cores) threads walking the
    parent's own arrays: the hot native calls release the GIL for their
    ctypes duration, so threads scale without interpreter boot or sample
    pickling.  ``"thread"``: threads always.  One capture, or one worker,
    is walked in the parent.

    ``stats``, when given, adds to what it holds (one dict can total many
    calls): ``captures``, ``thread_walks`` (the captures walked on
    threads), ``samples`` (read by the parent), and the host
    seconds of ``read_s`` (the WAVs), ``condition_s`` (the device
    conditioner, capture by capture), ``pool_s`` (submitting the walks to
    the pool) and ``walk_wait_s`` (waiting on the walks, or walking, and
    the pool's shutdown), with the device conditioner's own counters
    (``condition_jax``'s ``stats`` but its ``samples``).  With
    ``frontend="mask"``: ``masks_s`` (the device pass, on its own thread),
    ``native_condition_s`` (the parent's native conditioning, capture by
    capture), ``masks_wait_s`` (the parent blocked on the device pass once
    its conditioning is done), and the pass's engine counters prefixed
    ``masks_`` (``masks_stage_s``, ``masks_upload_s``, ``masks_launch_s``,
    ``masks_compact_s``, ``masks_fetch_s``, ``masks_windows``: streams x
    dispatch windows).  Each step is a step of a ``trace.Lap`` made where
    it starts, so it counts its own block, and a span while spans record:
    ``batch.read``, ``batch.condition``, ``batch.masks`` (the pass's
    thread; ``captures``, ``samples``), ``batch.condition_native``
    (``samples``), ``batch.masks_wait``, ``batch.pool``, ``batch.walk``
    (its ``pool``: ``"thread"``, ``"fork"``, or ``"serial"`` where the
    parent walks)."""
    from ..dsp.conditioner import condition_jax
    from ..native import condition_exact
    from . import trace

    if frontend not in ("host", "mask", "fused"):
        raise ValueError(f"unknown frontend {frontend!r}")
    if conditioner not in ("jax", "native", "device"):
        raise ValueError(f"unknown conditioner {conditioner!r}")
    if pool not in ("process", "thread"):
        raise ValueError(f"unknown pool {pool!r}")
    if not paths:
        return {}
    trace.add_counts(stats, captures=len(paths), thread_walks=0)
    power_thr = decoder_kwargs.get("power_level_threshold", 0.01)
    thresholds = decoder_kwargs.get("thresholds")

    if keep_pool and pool == "process" and frontend == "host" \
            and conditioner != "jax" and len(paths) > 1:
        # persistent path-only pool: workers read + condition + walk their
        # captures end to end.  Long captures dispatch first so the tail of
        # the schedule stays balanced.
        if workers is None:
            workers = min(len(paths), os.cpu_count() or 1)
        if workers > 1:
            order = sorted(
                range(len(paths)),
                key=lambda i: -os.path.getsize(paths[i]),
            )
            lap = trace.Lap(stats, _COUNTERS)
            with lap.step("batch.pool"):
                ex = persistent_pool(workers)
                results = ex.map(
                    _walk_path,
                    [(paths[i], decoder_kwargs) for i in order],
                )
            with lap.step("batch.walk"):
                frames = list(results)
            return {paths[i]: f for i, f in zip(order, frames)}

    all_samples: list[np.ndarray] = []
    rates: list[int] = []
    with trace.Lap(stats, _COUNTERS).step("batch.read"):
        for path in paths:
            samples, info = read_wav(path)
            all_samples.append(samples)
            rates.append(info.sample_rate)
    trace.add_counts(stats, samples=sum(len(x) for x in all_samples))

    channel_sets: list = [None] * len(paths)
    cond_sets: list = [None] * len(paths)
    if frontend == "mask":
        # one chained device pass for every capture's detect triggers; it
        # runs on a second thread while the parent conditions natively
        from ..dsp.cuda_channels import resolve_device

        resolve_device(device)
        if len(set(rates)) > 1:
            raise ValueError(
                "fused batch decode requires a uniform sample rate; "
                f"got {sorted(set(rates))}"
            )
        lap = trace.Lap(stats, _COUNTERS)
        with ThreadPoolExecutor(1) as bg:
            fut = bg.submit(_masks_pass, all_samples, rates[0], power_thr,
                            thresholds, device)
            for i, (samples, rate) in enumerate(zip(all_samples, rates)):
                params = SignalParams(
                    rate, power_level_threshold=power_thr
                )
                with lap.step("batch.condition_native",
                              samples=len(samples)):
                    cond_sets[i] = condition_exact(samples, params)
            with lap.step("batch.masks_wait"):
                channel_sets, mask_stats = fut.result()
        trace.add_counts(stats, **mask_stats)
    elif frontend == "fused":
        # all captures in one device pass; captures must share one sample
        # rate
        from ..dsp.cuda_channels import resolve_device

        resolve_device(device)
        if len(set(rates)) > 1:
            raise ValueError(
                "fused batch decode requires a uniform sample rate; "
                f"got {sorted(set(rates))}"
            )
        if conditioner == "device":
            # full device frontend: conditioning AND channels from the
            # fused kernels (5 extra dense f32 fetches a capture)
            from ..dsp.cuda_channels import fused_batch_all

            for i, (cond, chans) in enumerate(fused_batch_all(
                all_samples, rates[0], power_thr, thresholds=thresholds,
                device=device,
            )):
                cond_sets[i] = cond
                channel_sets[i] = chans
        else:
            # channels + detect indices from the device; conditioning runs
            # natively IN the workers (cond=None), parallel across the pool
            from ..dsp.cuda_channels import fused_batch_channels

            channel_sets = fused_batch_channels(
                all_samples, rates[0], power_thr, thresholds=thresholds,
                device=device,
            )

    jobs = []
    cond_stats = None if stats is None else {}
    for samples, rate, cond, tpu_channels in zip(
        all_samples, rates, cond_sets, channel_sets
    ):
        params = SignalParams(rate, power_level_threshold=power_thr)
        cond_arrays = None
        if frontend == "host" and conditioner == "jax":
            # device conditioning runs in the parent (workers never touch
            # the device)
            with trace.Lap(stats, _COUNTERS).step("batch.condition",
                                                  samples=len(samples)):
                cond = condition_jax(samples, params, device=device,
                                     stats=cond_stats)
        # otherwise native conditioning runs IN the workers
        # (cond_arrays=None): it is the dominant host cost, so serializing
        # it in the parent would cap the pool's speedup
        if cond is not None:
            cond_arrays = (
                cond.value,
                cond.envelope,
                cond.filtered,
                cond.deviation,
                cond.average,
                cond.mod_depth,
                cond.edge_peak,
                cond.edge_time,
            )
        jobs.append(
            (samples, rate, cond_arrays, tpu_channels, decoder_kwargs)
        )
    if cond_stats:
        # the captures' samples are counted once, as read
        cond_stats.pop("samples")
        trace.add_counts(stats, **cond_stats)

    kind = "fork" if pool == "process" and _fork_ok() else "thread"
    if workers is None:
        workers = min(len(paths), os.cpu_count() or 1)
    if workers <= 1 or len(paths) == 1:
        with trace.Lap(stats, _COUNTERS).step("batch.walk", pool="serial"):
            return {path: _walk_one(job) for path, job in zip(paths, jobs)}

    if kind == "thread":
        trace.add_counts(stats, thread_walks=len(jobs))
        frames = _pool_map(ThreadPoolExecutor(max_workers=workers), kind,
                           _walk_one, jobs, stats)
        return dict(zip(paths, frames))

    # fork workers inherit the job list as copy-on-write pages: no
    # interpreter boot, no sample pickling
    global _FORK_JOBS
    _FORK_JOBS = jobs
    try:
        frames = _pool_map(ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("fork"),
        ), kind, _walk_fork, list(range(len(jobs))), stats)
    finally:
        _FORK_JOBS = None
    return dict(zip(paths, frames))
