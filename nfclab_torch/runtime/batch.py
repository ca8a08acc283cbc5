"""Batch decode: many captures through one device conditioning pass,
parallel host symbol walks.

Counterpart of ``nfclab/runtime/batch.py``.  This is the data-parallel
throughput configuration: the device frontend batches across captures on
``device`` (cuda unless the caller asks for the CPU), while the thin event
walks fan out over host workers (threads or processes).

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
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..core.frame import Frame
from ..core.params import SignalParams
from ..io.wav import read_wav
from .decoder import NfcDecoder

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


def decode_batch(
    paths: list[str],
    workers: int | None = None,
    conditioner: str = "jax",
    frontend: str = "host",
    pool: str = "process",
    keep_pool: bool = False,
    device="cuda",
    **decoder_kwargs,
) -> dict[str, list[Frame]]:
    """Decode many wav captures: the device frontend in the parent process
    on ``device``, event walks across a worker pool (see the module
    docstring for the frontend/conditioner pairs).

    pool="thread" fans the walks over threads instead of processes: the hot
    native calls release the GIL for their ctypes duration, so threads
    scale on few-core hosts without paying interpreter boot + sample
    pickling."""
    from ..dsp.conditioner import condition_jax
    from ..native import condition_exact

    if frontend not in ("host", "mask", "fused"):
        raise ValueError(f"unknown frontend {frontend!r}")
    if conditioner not in ("jax", "native", "device"):
        raise ValueError(f"unknown conditioner {conditioner!r}")
    if not paths:
        return {}
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
            ex = persistent_pool(workers)
            frames = list(ex.map(
                _walk_path,
                [(paths[i], decoder_kwargs) for i in order],
            ))
            return {paths[i]: f for i, f in zip(order, frames)}

    all_samples: list[np.ndarray] = []
    rates: list[int] = []
    for path in paths:
        samples, info = read_wav(path)
        all_samples.append(samples)
        rates.append(info.sample_rate)

    channel_sets: list = [None] * len(paths)
    cond_sets: list = [None] * len(paths)
    if frontend == "mask":
        # one chained device pass for every capture's detect triggers; it
        # runs on a second thread while the parent conditions natively
        from concurrent.futures import ThreadPoolExecutor as _TPE

        from ..dsp.cuda_channels import fused_batch_masks, resolve_device

        resolve_device(device)
        if len(set(rates)) > 1:
            raise ValueError(
                "fused batch decode requires a uniform sample rate; "
                f"got {sorted(set(rates))}"
            )
        with _TPE(1) as bg:
            fut = bg.submit(
                fused_batch_masks, all_samples, rates[0], power_thr,
                thresholds=thresholds, device=device,
            )
            for i, (samples, rate) in enumerate(zip(all_samples, rates)):
                params = SignalParams(
                    rate, power_level_threshold=power_thr
                )
                cond_sets[i] = condition_exact(samples, params)
            channel_sets = fut.result()
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
    for samples, rate, cond, tpu_channels in zip(
        all_samples, rates, cond_sets, channel_sets
    ):
        params = SignalParams(rate, power_level_threshold=power_thr)
        cond_arrays = None
        if frontend == "host" and conditioner == "jax":
            # device conditioning runs in the parent (workers never touch
            # the device)
            cond = condition_jax(samples, params, device=device)
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

    fork_ok = _fork_ok()
    if workers is None:
        ncpu = os.cpu_count() or 1
        if pool == "thread" or fork_ok:
            workers = min(len(paths), ncpu)
        else:
            # spawn-pool overhead (interpreter boot + sample pickling)
            # costs more than it buys below ~4 cores; threads scale even
            # there (GIL-free native walks)
            workers = 1 if ncpu <= 2 else min(len(paths), ncpu)
    results: dict[str, list[Frame]] = {}
    if workers <= 1 or len(paths) == 1:
        for path, job in zip(paths, jobs):
            results[path] = _walk_one(job)
        return results

    if pool == "thread":
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as tp:
            for path, frames in zip(paths, tp.map(_walk_one, jobs)):
                results[path] = frames
        return results

    if fork_ok:
        # fork workers inherit the job list as copy-on-write pages: no
        # interpreter boot, no sample pickling.  Only taken while the
        # parent is single-threaded with CUDA never initialized (_fork_ok).
        global _FORK_JOBS
        _FORK_JOBS = jobs
        try:
            with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("fork"),
            ) as pp:
                for path, frames in zip(
                    paths, pp.map(_walk_fork, range(len(jobs)))
                ):
                    results[path] = frames
        finally:
            _FORK_JOBS = None
        return results

    # spawn, not fork: the parent holds a CUDA context or other threads,
    # and forking it risks deadlock in the children
    with ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn")
    ) as pp:
        for path, frames in zip(paths, pp.map(_walk_one, jobs)):
            results[path] = frames
    return results
