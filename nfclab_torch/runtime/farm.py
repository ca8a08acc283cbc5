"""Multi-stream decode farm on CUDA: N live magnitude streams decoded
concurrently, the dense phase on the card.

Counterpart of ``nfclab/runtime/farm.py``'s ``TpuStreamFarm``, in both
of its modes:

- ``fetch="full"`` (the default): the fused frontend kernels
  (dsp/fused_frontend.py) condition every stream and compute every
  correlator channel and the packed detect mask, one chunk a feed with
  carried state; the chunk's outputs cross to the host in one transfer,
  and the host runs only the carrier-edge tracker, the lazily computed
  event channels that read the exact conditioning and the per-stream
  event walk + protocol FSMs (KernelFedStream), on the caller's thread;
- ``fetch="mask"``: the kernels compute every stream's packed detect mask
  chunk by chunk with carried state, the mask is compacted on the card to
  O(triggers), and the host runs the native conditioner, the lazy event
  channels and the walk (MaskFedStream).  One background thread owns
  upload + dispatch + fetch on a CUDA stream of the farm's own while the
  caller's thread walks the previous window; with ``segments`` > 1 full
  windows after the first go through the segmented speculative engine
  (cuda_channels.run_segmented_masks).

Kernel base clocks are int32: for unbounded streams the farm folds the
absolute chunk clock to ``fold + clock % fold`` where ``fold`` is the
rate's plan modulus (every ring size divides it, and the fold keeps
``t >= ETU`` so the stream-head envelope seeding never re-triggers), so
ring phases stay consistent forever while frame clocks remain absolute
int64 on the host.

``CudaLogicFarm`` is the counterpart of nfclab's ``TpuLogicFarm``: N
logic-analyzer (ISO7816) streams, each window's event masks computed in
one dispatch on the card (dsp/logic_frontend) on the same pipeline.

``KernelFedStream``, ``_init_idx_entries``, ``_append_mask_idx``,
``_append_sparse_idx``, ``_DispatchPipeline`` and ``MaskFedStream`` are
copies of nfclab's (tests/test_torch_copies.py holds them to it).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..core.frame import Frame
from ..core.params import SignalParams
from ..dsp.cuda_channels import (
    _WARMUP, box_keys, idx_key_map, resolve_device,
)
from ..dsp.fused_frontend import SCAN, SCAN_NARROW
from . import trace
from .decoder import CarrierDetector, DecoderContext, walk
from .streaming import StreamingNfcDecoder

# the mask farm's counters beyond nfclab's (see CudaStreamFarm.stats):
# seconds, then the scan's launches
STEP_COUNTERS = ("io_idle_s", "upload_s", "launch_s", "compact_s", "fetch_s",
                 "verify_s", "repair_s", "walk_busy_s", "walk_cpu_s",
                 "scan_launches", "scan_narrow_launches")

# the segments policy's lane ceiling: nfclab's kernel tile width, kept so
# the farm splits a window exactly as nfclab's does (the CUDA kernels
# themselves take any lane count)
LANES = 1024

_COND_KEYS = ("envelope", "filtered", "deviation", "average", "mod_depth")


class KernelFedStream(StreamingNfcDecoder):
    """Incremental decoder whose conditioning + correlator channels arrive
    as externally computed chunks (from the fused TPU kernel); the host
    runs only the edge tracker, the lazy event channels and the walk.

    ``window=N`` bounds memory exactly like the host streaming decoder:
    only the trailing N..slack*N samples of every dense array stay
    resident, clocks stay absolute, and the kernel-fed cache entries shift
    with the window (LazyChannels.rebind handles them generically)."""

    def __init__(self, sample_rate: int, window: int | None = None,
                 **decoder_kwargs):
        super().__init__(sample_rate, window=window, **decoder_kwargs)
        self._edge_state = np.zeros(2, np.float64)
        self._box_entries: list | None = None
        self._idx_entries: list | None = None

    def feed(self, block):  # pragma: no cover - guard
        raise TypeError(
            "KernelFedStream consumes kernel chunks via feed_external(); "
            "use StreamingNfcDecoder for host-conditioned feeds"
        )

    # ----------------------------------------------------------- kernel feed

    def feed_external(
        self,
        value: np.ndarray,
        cond_chunks: dict[str, np.ndarray],
        box_chunks: dict[str, np.ndarray],
        mask_chunk: np.ndarray,
    ) -> list[Frame]:
        """Ingest one chunk: raw samples, the kernel's five conditioned
        channels, the nine box channels and the packed detect mask (all of
        equal length); returns newly completed frames."""
        assert not self._finished, "stream already finished"
        self._compact()
        m = len(value)
        self._ensure_capacity(m)
        abs_lo = self._n  # absolute clock of this chunk's first sample
        plo = abs_lo - self._base  # physical offset in the window buffers
        self._bufs["value"][plo : plo + m] = value
        for k in _COND_KEYS:
            self._bufs[k][plo : plo + m] = cond_chunks[k]
        from ..native.binding import edge_track_into

        edge_track_into(
            self.params, self._edge_state, self._bufs, plo, m, self._base
        )
        self._n += m

        full = self._view()
        if self._ctx is None:
            ctx = DecoderContext(
                full, self.sample_rate, self.params,
                self._proto.stream_time, thresholds=self._proto.thresholds,
            )
            self._ctx = ctx
            if self.window:
                ctx.channels.capacity_hint = (
                    self.slack * self.window + (1 << 17)
                )
            self._init_kernel_entries(ctx.channels)
            self._append_kernel_chunks(
                ctx.channels, box_chunks, mask_chunk, abs_lo, abs_lo + m
            )
            self._carrier = CarrierDetector(ctx)
            self._techs = self._proto._make_techs(ctx)
            for tech in self._techs:
                tech.initialize()
        else:
            ctx = self._ctx
            ctx.cond = full
            ctx.n = len(full.value)
            ctx.channels.rebind(full, self._base)
            self._append_kernel_chunks(
                ctx.channels, box_chunks, mask_chunk, abs_lo, abs_lo + m
            )
            # host-lazy entries (carrier crossings, mod-depth gates) extend
            # over the new tail; kernel-fed entries are already current
            ctx.channels.extend_all()
            self._carrier.bind(ctx)
            for tech in self._techs:
                tech.bind_channels()

        before = len(ctx.frames)
        self._t = walk(ctx, self._carrier, self._techs, self._t)
        return ctx.frames[before:]

    # ------------------------------------------------------- entry plumbing

    def _init_kernel_entries(self, lz):
        """Create the box/index cache entries the kernel feeds, BEFORE the
        techs bind (so no getter ever host-computes them)."""
        from ..dsp.fused_frontend import MASK_LAYOUT
        from ..native.binding import alloc_array

        cap = max(len(self._bufs["value"]), 4096, lz.capacity_hint)
        self._box_entries = []
        for name, (key, kind_code, width, lag) in box_keys(
            self.sample_rate
        ).items():
            lz._cache[key] = {
                "arr": alloc_array(cap, np.float32),
                "n": 0,
                "acc": np.zeros(1, np.float64),
                "idx": None,
                "scanned": 0,
                "extend": None,
                "kind": "box",
                "meta": (kind_code, width, lag),
            }
            self._box_entries.append((name, key))
        self._idx_entries = _init_idx_entries(
            lz, self.sample_rate, self.params.power_level_threshold,
            self._proto.thresholds,
        )
        lz._plan = None

    def _append_kernel_chunks(self, lz, box_chunks, mask_chunk,
                              abs_lo, abs_hi):
        """Append one chunk (absolute clocks [abs_lo, abs_hi)) into the
        kernel-fed entries; physical buffer offsets follow the window."""
        from ..dsp.channels import LazyChannels

        plo, phi = abs_lo - lz.base, abs_hi - lz.base
        for name, key in self._box_entries:
            ent = lz._entry(key)  # grows the buffer with the window
            ent["arr"][plo:phi] = box_chunks[name]
            ent["n"] = abs_hi
        _append_mask_idx(lz, self._idx_entries, mask_chunk, abs_lo, abs_hi)



def _init_idx_entries(lz, sample_rate, power_level_threshold, thresholds):
    """Create the detect-trigger index entries the kernel's packed mask
    feeds (keyed exactly as the tech FSMs request them), BEFORE the techs
    bind; returns [(mask bit weight, cache key)]."""
    from ..dsp.fused_frontend import MASK_LAYOUT

    masks = dict(MASK_LAYOUT)
    out = []
    for mname, key, fx in idx_key_map(
        sample_rate, power_level_threshold, thresholds=thresholds
    ):
        lz._cache[key] = {
            "arr": None,
            "n": 0,
            "acc": None,
            "idx": None,
            "idx_n": 0,
            "scanned": 0,
            "extend": None,
            "kind": "idx",
            "fx": fx,
        }
        out.append((masks[mname], key))
    return out


def _append_mask_idx(lz, idx_entries, mask_chunk, abs_lo, abs_hi):
    """Unpack one mask chunk (absolute clocks [abs_lo, abs_hi)) into the
    index entries, gated at the reference's 1024-sample warm-up."""
    from ..dsp.channels import LazyChannels

    bits = mask_chunk.astype(np.int32)
    if abs_lo < _WARMUP:
        bits[: min(abs_hi, _WARMUP) - abs_lo] = 0
    for weight, key in idx_entries:
        ent = lz._cache[key]
        idx = (np.flatnonzero(bits & weight) + abs_lo).astype(np.int64)
        LazyChannels._append_idx(ent, idx, abs_hi)


def _append_sparse_idx(lz, idx_entries, rel_idx, bits, abs_lo, abs_hi):
    """Sparse form of _append_mask_idx: device-compacted trigger positions
    (relative to abs_lo) + their packed bits; O(triggers) per feed."""
    from ..dsp.channels import LazyChannels

    pos = rel_idx.astype(np.int64) + abs_lo
    b32 = bits.astype(np.int32)
    if abs_lo < _WARMUP:
        keep = pos >= _WARMUP
        pos, b32 = pos[keep], b32[keep]
    for weight, key in idx_entries:
        ent = lz._cache[key]
        LazyChannels._append_idx(ent, pos[(b32 & weight) != 0], abs_hi)


class _DispatchPipeline:
    """Staging + ordered background dispatch + bounded-depth drain —
    the pipeline machinery the stream and logic farms share.

    Batches ([n_streams, width, ...] arrays, staged as PRIVATE copies by
    the caller) dispatch on ONE IO thread, so carried device state
    threads in submission order; `drain` consumes (batch, result) pairs
    in completion order on the caller's thread, blocking only when the
    in-flight depth exceeds `depth` (backpressure) or on an explicit
    flush.  A failed dispatch leaves its batch queued
    (result-before-popleft), so `recover_batches` can hand every
    unprocessed sample to a host-path fallback losslessly."""

    def __init__(self, depth: int):
        self.depth = depth
        self.staged: list[np.ndarray] = []
        self.staged_len = 0
        self.inflight: "deque" = deque()
        self._io = None

    def stage(self, batch: np.ndarray) -> None:
        self.staged.append(batch)
        self.staged_len += batch.shape[1]

    def take(self, width: int) -> np.ndarray:
        """Pop exactly `width` staged columns as one batch."""
        parts, got = [], 0
        while got < width:
            piece = self.staged[0]
            need = width - got
            if piece.shape[1] <= need:
                parts.append(piece)
                got += piece.shape[1]
                self.staged.pop(0)
            else:
                parts.append(piece[:, :need])
                self.staged[0] = piece[:, need:]
                got = width
        self.staged_len -= width
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)

    def submit(self, fn, batch: np.ndarray) -> None:
        if self._io is None:
            from concurrent.futures import ThreadPoolExecutor

            self._io = ThreadPoolExecutor(1)  # ordered state threading
        self.inflight.append((self._io.submit(fn, batch), batch))

    def drain(self, walk, block: bool, on_wait=None) -> None:
        import time

        while self.inflight:
            fut, batch = self.inflight[0]
            if not (block or len(self.inflight) > self.depth
                    or fut.done()):
                break
            t0 = time.perf_counter()
            result = fut.result()  # before popleft: see class docstring
            self.inflight.popleft()
            if on_wait is not None:
                on_wait(time.perf_counter() - t0)
            walk(batch, result)

    def recover_batches(self) -> list[np.ndarray]:
        """Ordered unprocessed batches (in-flight first, then staged);
        clears the pipeline for a host-path fallback."""
        out = [b for _f, b in self.inflight] + list(self.staged)
        self.inflight.clear()
        self.staged.clear()
        self.staged_len = 0
        self.shutdown(wait=False)
        return out

    def shutdown(self, wait: bool = True) -> None:
        if self._io is not None:
            self._io.shutdown(wait=wait)
            self._io = None


class MaskFedStream(StreamingNfcDecoder):
    """Host-conditioned streaming decoder whose detect-trigger indices
    arrive from the fused kernel's packed mask (the farm's ``fetch="mask"``
    mode — compacted to O(triggers) on device, see
    tpu_channels.run_chained_masks).

    Conditioning + box channels build natively on the host (the bit-exact
    f64 contract path, same as StreamingNfcDecoder); the kernel mask is
    dispatched with MASK_ONLY_MARGIN on the SD thresholds so the
    f32-derived triggers are a conservative superset of the host-f64
    triggers the walk re-checks.  The power gate needs no margin: the
    chained dispatch carries exact kernel state, so its envelope is the
    true streaming envelope (bit-exact on TPU)."""

    def __init__(self, sample_rate: int, window: int | None = None,
                 **decoder_kwargs):
        super().__init__(sample_rate, window=window, **decoder_kwargs)
        self._idx_entries: list | None = None
        self._pending_mask: tuple | None = None
        self._pending_idx: tuple | None = None

    def feed_mask(self, block: np.ndarray, mask_chunk: np.ndarray):
        """Condition + decode one block, detect triggers from the kernel
        mask; returns newly completed frames."""
        assert not self._finished, "stream already finished"
        self._compact()
        block = np.ascontiguousarray(block, np.float32)
        self._ensure_capacity(len(block))
        from ..native.binding import condition_stream_into

        abs_lo = self._n
        m = condition_stream_into(
            block, self.params, self._state, self._bufs,
            self._n - self._base,
        )
        self._n += m
        self._pending_mask = (mask_chunk, abs_lo, abs_lo + m)
        return self._advance()

    def feed_mask_idx(self, block: np.ndarray, rel_idx: np.ndarray,
                      bits: np.ndarray):
        """Condition + decode one block with SPARSE kernel triggers:
        rel_idx (positions relative to the block start, ascending) and the
        packed mask bits at those positions — the device-compacted form,
        O(triggers) over the link instead of O(samples)."""
        assert not self._finished, "stream already finished"
        self._compact()
        block = np.ascontiguousarray(block, np.float32)
        self._ensure_capacity(len(block))
        from ..native.binding import condition_stream_into

        abs_lo = self._n
        m = condition_stream_into(
            block, self.params, self._state, self._bufs,
            self._n - self._base,
        )
        self._n += m
        self._pending_idx = (rel_idx, bits, abs_lo, abs_lo + m)
        return self._advance()

    def _install_external(self, ctx, first: bool) -> None:
        lz = ctx.channels
        if first:
            self._idx_entries = _init_idx_entries(
                lz, self.sample_rate, self.params.power_level_threshold,
                self._proto.thresholds,
            )
            lz._plan = None
        if self._pending_mask is not None:
            mask_chunk, abs_lo, abs_hi = self._pending_mask
            self._pending_mask = None
            _append_mask_idx(lz, self._idx_entries, mask_chunk,
                             abs_lo, abs_hi)
        if self._pending_idx is not None:
            rel_idx, bits, abs_lo, abs_hi = self._pending_idx
            self._pending_idx = None
            _append_sparse_idx(lz, self._idx_entries, rel_idx, bits,
                               abs_lo, abs_hi)


class CudaStreamFarm:
    """Decode ``n_streams`` independent magnitude streams with the
    dense phase on the card; host walkers emit frames per stream.

    feed(blocks[n_streams, width]) -> list of per-stream new frames.
    Streams that end early can be padded with zeros (silence decodes to
    carrier events only).

    ``fetch="full"`` (the default) runs both kernels over each feed's
    chunk (its width a multiple of the kernels' TILE) with every output
    selected and carried state, fetches the 15 outputs densely in one
    transfer (57 B/sample at 10 MS/s) and walks synchronously on the
    caller's thread (KernelFedStream): the kernel-fed-channel
    configuration for hosts on the card's PCIe.  ``segments`` > 1 is
    refused there (the segmented engine splits mask windows only).

    ``fetch="mask"`` runs a PIPELINED chained engine: feeds stage until
    ``k_chunks`` x CHAIN_CHUNK samples accumulate, then one window chains
    the K chunks through the kernels with carried state (exact streaming
    conditioning makes the mask's power gate sound) and compacts the
    detect mask ON THE CARD so the fetch is O(triggers).  A background
    thread owns upload + dispatch + fetch, on a CUDA stream of the farm's
    own, while the caller's thread walks the previous window.  Frames for
    a window surface on a later feed() (up to ``pipeline_depth`` windows
    behind); finish() flushes everything.  An error on that thread (a build,
    launch or CUDA error) surfaces from the feed() or finish() that
    drains its window; ``recover_unprocessed()`` then hands back every
    sample not yet walked.

    ``segments`` (mask mode): split each stream's window across that many
    parallel kernel lanes via the speculative halo + verify + repair
    scheme (cuda_channels.run_segmented_masks) -- the device stage's
    serial step count drops by ~segments-fold.  Default (None) picks the
    largest power of two <= 16 that divides ``k_chunks`` (halving it at
    least once) and keeps n_streams*segments within ``LANES``; pass 1 to
    force the plain serial chain.  Accepted segments are bit-identical in
    conditioning state and carry the same margined-mask contract, so
    frames are unchanged.

    Segmentation is ADAPTIVE: speculative warm-up cannot converge through
    field-off pauses (the true envelope decays by path-dependent silence
    timeouts), so pause-heavy windows verify-fail and pay speculative +
    exact repair.  When a window repairs more than half the streams the
    farm backs off to the serial chain and re-probes with exponentially
    growing spacing; dense or carrier-on traffic keeps the full speedup.

    ``device="cpu"`` runs the kernels' plain versions; with no card and
    no ``device="cpu"`` the constructor raises DeviceUnavailable.

    ``stats``: ``device_s`` (the IO thread's upload + launches + fetch in
    mask mode; the same steps on the caller's thread in full mode),
    ``walk_s``, ``wait_s``, ``dispatches`` (windows in mask mode, feeds in
    full mode), ``drained_samples`` and the segmented engine's counts.
    Mask mode also sums, always and with no device sync (host
    ``perf_counter`` seconds): ``io_idle_s`` (the IO thread idle between
    one device pass and the next), ``device_s`` split by step
    (``upload_s``, ``launch_s``, ``compact_s``, ``fetch_s``,
    ``verify_s``, ``repair_s``: the steps of one ``trace.Lap`` a pass,
    named by cuda_channels.LAP_COUNTERS) and, over streams, each stream's
    walk in wall seconds (``walk_busy_s``) and in its thread's CPU
    seconds (``walk_cpu_s``); and the scan's launches in
    the device passes (``scan_launches``), of them those on the narrow
    kernel (``scan_narrow_launches``; fused_frontend.SCAN and
    SCAN_NARROW, the process's counts, gained while a pass runs).  While
    spans record (runtime/trace) the same steps are spans, those of one
    window sharing its ``seq``."""

    def __init__(
        self,
        n_streams: int,
        sample_rate: int = 10_000_000,
        power_level_threshold: float = 0.01,
        window: int | None = None,
        fetch: str = "full",
        k_chunks: int = 32,
        pipeline_depth: int = 2,
        cap_div: int = 16,
        walk_threads: int | None = None,
        segments: int | None = None,
        adaptive_segments: bool = True,
        device="cuda",
        **decoder_kwargs,
    ):
        if fetch not in ("full", "mask"):
            raise ValueError("fetch must be 'full' or 'mask'")
        if k_chunks & (k_chunks - 1):
            raise ValueError("k_chunks must be a power of two")
        self._dev = resolve_device(device)

        self._segments_explicit = segments is not None
        if segments is None:
            segments = 1
            if fetch == "mask":
                while (segments * 2 <= 16
                       and segments * 4 <= k_chunks
                       and n_streams * segments * 2 <= LANES):
                    segments *= 2
        else:
            if segments < 1 or segments & (segments - 1):
                raise ValueError("segments must be a power of two >= 1")
            if segments > 1 and fetch != "mask":
                # nfclab's farm ignores it; here it is refused
                raise ValueError(
                    f"segments={segments} needs fetch='mask': the full "
                    "fetch runs one chunk a feed and has no windows to "
                    "segment"
                )
            if segments > 1 and (k_chunks % segments
                                 or n_streams * segments > LANES):
                raise ValueError(
                    f"segments={segments} must divide k_chunks={k_chunks} "
                    f"and keep n_streams*segments <= {LANES}"
                )
        self.segments = segments
        self._carry = None  # segmented-engine handoff (pen/end/tail)
        self.fetch = fetch
        self.n_streams = n_streams
        self.sample_rate = sample_rate
        self.k_chunks = k_chunks
        self.pipeline_depth = pipeline_depth
        self.cap_div = cap_div
        self.walk_threads = walk_threads
        self._walk_pool = None
        self.params = SignalParams(
            sample_rate, power_level_threshold=power_level_threshold
        )
        from ..core.thresholds import DecoderThresholds
        from ..dsp.cuda_channels import chained_mask_params
        from ..dsp.frontend import _params_tuple

        self._pt = _params_tuple(self.params)
        # one DecoderThresholds governs the kernel mask params AND every
        # stream's FSM thresholds (single source of truth)
        th = decoder_kwargs.get("thresholds") or DecoderThresholds()
        decoder_kwargs["thresholds"] = th
        if fetch == "mask":
            self._mp = chained_mask_params(power_level_threshold, th)
        else:
            self._mp = th.detect_mask_tuple(power_level_threshold)
        cls = MaskFedStream if fetch == "mask" else KernelFedStream
        self.streams = [
            cls(
                sample_rate,
                window=window,
                power_level_threshold=power_level_threshold,
                **decoder_kwargs,
            )
            for _ in range(n_streams)
        ]
        from ..dsp.fused_frontend import kernel_plan

        # clock-fold modulus: every ring size of this rate's kernel plan
        # divides it, and it exceeds the ETU so folded clocks never
        # re-enable the stream-head envelope seeding
        self._fold = kernel_plan(sample_rate).fold_modulus
        assert self._fold > self.params.elementary_time_unit
        from ..dsp.cuda_channels import CHAIN_CHUNK

        if self.segments > 1 and CHAIN_CHUNK % self._fold:
            # segment offsets must be congruent mod the fold modulus for
            # the shared base (only reachable at extreme rates)
            if self._segments_explicit:
                raise ValueError(
                    "segments>1 needs the chunk to be a multiple of the "
                    f"rate's fold modulus ({self._fold})"
                )
            self.segments = 1
        self._state = None
        self._clock = 0
        self._pipe = _DispatchPipeline(pipeline_depth)  # mask-mode pipeline
        # the IO thread's CUDA stream: the dispatch never shares the
        # default stream with the caller's own device work
        self._stream = (torch.cuda.Stream(self._dev)
                        if self._dev.type == "cuda" and fetch == "mask"
                        else None)
        # stage accounting (seconds + dispatch count): device_s is the
        # background upload+dispatch+fetch time, walk_s the host walk time;
        # in steady state the pipeline overlaps them so wall ~= max, not sum
        self.stats = {"device_s": 0.0, "walk_s": 0.0, "dispatches": 0,
                      "wait_s": 0.0, "drained_samples": 0,
                      "seg_dispatches": 0, "repaired_streams": 0,
                      "repair_chunks": 0, "seg_backoff_windows": 0,
                      **{k: 0.0 for k in STEP_COUNTERS if k.endswith("_s")},
                      "scan_launches": 0, "scan_narrow_launches": 0}
        # the IO thread's own: windows passed, samples passed, the end of
        # the last pass; the caller's: windows walked
        self._io_seq = self._io_clock = 0
        self._io_end = None
        self._walk_seq = 0
        # adaptive segmentation backoff (see class docstring);
        # adaptive_segments=False keeps segmenting regardless of repair
        # rate (validation harnesses exercising the repair path)
        self.adaptive_segments = adaptive_segments
        self._seg_backoff = 0       # serial windows left before re-probe
        self._seg_backoff_next = 8  # next backoff span (exponential, capped)

    def _kernel_base(self) -> int:
        # int32-safe fold (see self._fold); dispatch widths are multiples
        # of the modulus, so the folded base is always 0 or `fold`
        m = self._fold
        return self._clock if self._clock == 0 else m + (self._clock % m)

    def feed(self, blocks: np.ndarray) -> list[list[Frame]]:
        blocks = np.ascontiguousarray(blocks, np.float32)
        n_s, width = blocks.shape
        if n_s != self.n_streams:
            raise ValueError(f"expected {self.n_streams} stream rows")
        if self.fetch == "mask":
            # any feed width is fine: dispatches always consume
            # k*CHAIN_CHUNK columns (multiples of the fold modulus), and
            # the sub-chunk remainder at finish() walks on the host path.
            # COPY at staging: consumption (upload + the deferred
            # pipelined walk) happens up to k_chunks feeds later, and
            # callers legitimately reuse their feed buffer every call
            with trace.span("farm.stage",
                            offset=self._clock + self._pipe.staged_len):
                self._pipe.stage(blocks.copy())
                self._launch_ready()
            return self._drain(block=False)
        from ..dsp.fused_frontend import TILE

        if width % TILE:
            raise ValueError(f"chunk must be a multiple of {TILE}")
        return self._feed_full(blocks)

    # --------------------------------------------------- mask-mode pipeline

    def _launch_ready(self):
        from ..dsp.cuda_channels import CHAIN_CHUNK

        target = self.k_chunks * CHAIN_CHUNK
        while self._pipe.staged_len >= target:
            self._submit(self._pipe.take(target))

    def _submit(self, batch: np.ndarray):
        base0 = self._kernel_base()
        self._clock += batch.shape[1]
        self._pipe.submit(
            lambda b, base0=base0: self._device_pass(b, base0), batch
        )

    def recover_unprocessed(self) -> list[np.ndarray]:
        """Ordered unprocessed [n_s, width] batches after a dispatch
        failure; clears the pipeline (host-path fallback support)."""
        return self._pipe.recover_batches()

    def _device_pass(self, batch: np.ndarray, base0: int):
        """Background stage: upload (1- or 2-byte codes when on-grid) +
        chained dispatch + compacted fetch, on the farm's CUDA stream.
        Runs on the single IO thread, so kernel state (and the segmented
        engine's carry) threads through dispatches in submission order;
        only host arrays leave it, after the stream's work has ended.
        Full windows after the first go through the segment-parallel
        speculative engine when ``segments`` > 1; the first window (true
        stream-head seeding semantics) and sub-window flushes run the
        plain serial chain."""
        import time

        from ..dsp.cuda_channels import CHAIN_CHUNK, LAP_COUNTERS

        t0 = time.perf_counter()
        seq, lo = self._io_seq, self._io_clock
        # the lap's steps tile the pass from here
        lap = trace.Lap(self.stats, LAP_COUNTERS, seq)
        self._io_seq += 1
        self._io_clock += batch.shape[1]
        if self._io_end is not None:
            self.stats["io_idle_s"] += t0 - self._io_end
            trace.record("farm.io_idle", self._io_end, t0, seq=seq)
        seg = self.segments
        full = batch.shape[1] == self.k_chunks * CHAIN_CHUNK
        use_seg = seg > 1 and self._carry is not None and full
        kind = "segmented" if use_seg else "serial" if full else "flush"
        if use_seg and self._seg_backoff > 0:
            # pause-heavy traffic: serial windows until the next probe
            self._seg_backoff -= 1
            self.stats["seg_backoff_windows"] += 1
            use_seg = False
            kind = "backoff"
        scans = (SCAN.launches, SCAN_NARROW.launches)
        try:
            with trace.span("farm.device_pass", kind=kind, seq=seq, lo=lo,
                            hi=self._io_clock):
                with torch.cuda.stream(self._stream):
                    per_stream = self._run_engines(batch, base0, use_seg,
                                                   lap)
                    if self._stream is not None:
                        self._stream.synchronize()
        finally:
            self._io_end = time.perf_counter()
            self.stats["scan_launches"] += SCAN.launches - scans[0]
            self.stats["scan_narrow_launches"] += (SCAN_NARROW.launches
                                                   - scans[1])
        self.stats["device_s"] += self._io_end - t0
        self.stats["dispatches"] += 1
        return per_stream

    def _run_engines(self, batch: np.ndarray, base0: int, use_seg: bool,
                     lap):
        """One window through the segmented engine, or through the serial
        chain from the carried state (rebuilt on the card first where a
        segmented window left none)."""
        from ..dsp.cuda_channels import (
            CHAIN_CHUNK, _expand_state, chain_state0, run_chained_masks,
            run_segmented_masks,
        )

        seg = self.segments
        if use_seg:
            per_stream, self._carry, rst = run_segmented_masks(
                batch, self._carry, self._pt, self._mp, seg,
                cap_div=self.cap_div, sample_rate=self.sample_rate,
                k_bucket=self.k_chunks, device=self._dev, lap=lap,
            )
            self._state = None  # rebuilt from carry["end"] if needed
            self.stats["seg_dispatches"] += 1
            self.stats["repaired_streams"] += rst["repaired_streams"]
            self.stats["repair_chunks"] += rst["repair_chunks"]
            if (self.adaptive_segments
                    and rst["repaired_streams"] * 2 > self.n_streams):
                # most streams verify-failed (pauses spanning boundaries):
                # back off to the serial chain, re-probe later
                self._seg_backoff = self._seg_backoff_next
                self._seg_backoff_next = min(64, self._seg_backoff_next * 2)
            else:
                self._seg_backoff_next = 8
            return per_stream
        if self._state is None:
            with lap.step("upload"):
                if self._carry is not None:
                    self._state = _expand_state(self._carry["end"],
                                                self._dev)
                else:
                    self._state = chain_state0(
                        self.n_streams, sample_rate=self.sample_rate,
                        device=self._dev,
                    )
        if seg > 1:
            per_stream, self._state, c2 = run_chained_masks(
                batch, self._state, base0, self._pt, self._mp,
                cap_div=self.cap_div, sample_rate=self.sample_rate,
                lap=lap, want_carry=True,
            )
            self._carry = {
                "pen": c2["pen"], "end": c2["end"],
                "tail": np.ascontiguousarray(batch[:, -CHAIN_CHUNK:]),
            }
            return per_stream
        per_stream, self._state = run_chained_masks(
            batch, self._state, base0, self._pt, self._mp,
            cap_div=self.cap_div, sample_rate=self.sample_rate, lap=lap,
        )
        return per_stream

    def _drain(self, block: bool) -> list[list[Frame]]:
        import time

        from ..dsp.cuda_channels import CHAIN_CHUNK

        out = [[] for _ in self.streams]

        def on_wait(dt):
            self.stats["wait_s"] += dt
            now = time.perf_counter()
            trace.record("farm.wait", now - dt, now, seq=self._walk_seq)

        def walk(batch, per_stream):
            t0 = time.perf_counter()
            width = batch.shape[1]
            seq = self._walk_seq
            self._walk_seq += 1
            lo0 = self.stats["drained_samples"] // len(self.streams)
            ws = trace.span("farm.walk", seq=seq, lo=lo0, hi=lo0 + width)

            def walk_one(i):
                # wall and thread-CPU seconds, the CPU's read inside the
                # wall's interval: the difference is time off a CPU
                t1, c1 = time.perf_counter(), time.thread_time()
                st = self.streams[i]
                rel, bits = per_stream[i]
                frames = []
                with trace.span("farm.walk.stream", parent=ws.id, seq=seq,
                                stream=i):
                    # walk in window-memory-safe sub-chunks
                    for lo in range(0, width, CHAIN_CHUNK):
                        hi = min(lo + CHAIN_CHUNK, width)
                        sel = (rel >= lo) & (rel < hi)
                        frames.extend(
                            st.feed_mask_idx(
                                batch[i, lo:hi], rel[sel] - lo, bits[sel]
                            )
                        )
                cpu = time.thread_time() - c1
                return frames, time.perf_counter() - t1, cpu

            with ws:
                if self.walk_threads and self.walk_threads > 1:
                    # streams are independent; the hot walk is
                    # GIL-releasing native code, so per-stream threads
                    # scale on multi-core hosts (each stream keeps ITS OWN
                    # decoder -- no sharing)
                    if self._walk_pool is None:
                        from concurrent.futures import ThreadPoolExecutor

                        self._walk_pool = ThreadPoolExecutor(
                            self.walk_threads)
                    walked = list(self._walk_pool.map(
                        walk_one, range(len(self.streams))))
                else:
                    walked = [walk_one(i) for i in range(len(self.streams))]
            for i, (frames, busy, cpu) in enumerate(walked):
                out[i].extend(frames)
                self.stats["walk_busy_s"] += busy
                self.stats["walk_cpu_s"] += cpu
            self.stats["walk_s"] += time.perf_counter() - t0
            self.stats["drained_samples"] += width * len(self.streams)

        self._pipe.drain(walk, block, on_wait)
        return out

    # ----------------------------------------------------- full fetch mode

    def _feed_full(self, blocks: np.ndarray) -> list[list[Frame]]:
        """Both kernels over the live rows, every output selected, at the
        folded kernel base; one dense transfer of the 15 outputs; then
        each stream's walk on the caller's thread."""
        import time

        from ..dsp import fused_frontend as ff
        from ..dsp.cuda_channels import (
            _fetch_dense, chain_state0, upload_samples,
        )

        t0 = time.perf_counter()
        n_s, chunk = blocks.shape
        plan = ff.kernel_plan(self.sample_rate)
        if self._state is None:
            self._state = chain_state0(n_s, sample_rate=self.sample_rate,
                                       device=self._dev)
        names = ff._normalize_select(
            (*_COND_KEYS, *box_keys(self.sample_rate), "detect_mask"), plan
        )
        x = upload_samples(blocks, self._dev).t().contiguous()
        res, st = ff.run_chunk(x, self._state.t().contiguous(),
                               self._kernel_base(), self._pt, self._mp,
                               plan, names)
        del x
        self._state = st.t().contiguous()
        self._clock += chunk
        self.stats["drained_samples"] += chunk * n_s
        fetch = _fetch_dense(res, names, n_s)
        del res
        t1 = time.perf_counter()
        self.stats["device_s"] += t1 - t0
        self.stats["dispatches"] += 1

        out = []
        for i, st in enumerate(self.streams):
            cond = {k: fetch[k][i] for k in _COND_KEYS}
            boxes = {k: fetch[k][i] for k in box_keys(self.sample_rate)}
            out.append(
                st.feed_external(blocks[i], cond, boxes,
                                 fetch["detect_mask"][i])
            )
        self.stats["walk_s"] += time.perf_counter() - t1
        return out

    def finish(self) -> list[list[Frame]]:
        from ..dsp.cuda_channels import CHAIN_CHUNK

        out = [[] for _ in self.streams]
        if self.fetch == "mask":
            # flush staged windows in power-of-two chunk dispatches
            while self._pipe.staged_len >= CHAIN_CHUNK:
                k = 1
                while (k * 2 <= self.k_chunks
                       and k * 2 * CHAIN_CHUNK <= self._pipe.staged_len):
                    k *= 2
                self._submit(self._pipe.take(k * CHAIN_CHUNK))
            for i, new in enumerate(self._drain(block=True)):
                out[i].extend(new)
            if self._pipe.staged_len:
                # sub-chunk tail: host path (the kernel-fed index entries
                # host-extend past the kernel-appended range -- fx
                # descriptors in LazyChannels)
                tail = self._pipe.take(self._pipe.staged_len)
                for i, st in enumerate(self.streams):
                    out[i].extend(st.feed(tail[i]))
            self._pipe.shutdown()
            if self._walk_pool is not None:
                self._walk_pool.shutdown()
                self._walk_pool = None
        for i, st in enumerate(self.streams):
            out[i].extend(st.finish())
        return out


class CudaLogicFarm:
    """Decode ``n_streams`` independent logic-analyzer streams (ISO7816):
    batched dispatches on the card compute every stream's packed event
    mask (dsp/logic_frontend, per-stream edge carry kept on the device);
    the host walkers consume only the sparse event indices.

    feed(blocks[n_streams, width, channels]) -> per-stream new frames.
    The counterpart of nfclab's TpuLogicFarm, with the same pipeline:
    feeds stage until ``k_samples`` accumulate, one dispatch computes the
    whole window's masks, a single background IO thread owns upload +
    mask + fetch, on a CUDA stream of the farm's own, while the caller's
    thread walks the previous window (frames may surface up to
    ``pipeline_depth`` windows late; finish() flushes).  ``k_samples=0``
    dispatches synchronously per feed.  ``device="cpu"`` computes the
    masks on the CPU; with no card and no ``device="cpu"`` the
    constructor raises DeviceUnavailable."""

    def __init__(
        self,
        n_streams: int,
        sample_rate: int,
        channels: int = 4,
        stream_time: float = 0.0,
        channel_map=None,
        k_samples: int = 1 << 20,
        pipeline_depth: int = 2,
        device="cuda",
    ):
        from .logic_decoder import StreamingIsoDecoder, normalize_channel_map

        self._dev = resolve_device(device)
        self.n_streams = n_streams
        self.channels = channels
        self.k_samples = k_samples
        self.pipeline_depth = pipeline_depth
        # the farm permutes blocks BEFORE the batched device dispatch so
        # the event masks are computed over the decoder layout; the streams
        # then consume identity-mapped blocks + masks
        self._perm = normalize_channel_map(channel_map, channels)
        self.streams = [
            StreamingIsoDecoder(
                sample_rate, channels=channels, stream_time=stream_time
            )
            for _ in range(n_streams)
        ]
        self._carry = None
        self._pipe = _DispatchPipeline(pipeline_depth)
        # the mask's CUDA stream: the dispatch never shares the default
        # stream with the caller's own device work
        self._stream = (torch.cuda.Stream(self._dev)
                        if self._dev.type == "cuda" else None)

    def feed(self, blocks: np.ndarray) -> list[list[Frame]]:
        blocks = np.ascontiguousarray(blocks, np.float32)
        if blocks.ndim != 3 or blocks.shape[0] != self.n_streams or (
            blocks.shape[2] != self.channels
        ):
            raise ValueError(
                f"expected [{self.n_streams}, width, {self.channels}] blocks"
            )
        if self._perm is not None:
            blocks = np.ascontiguousarray(blocks[:, :, self._perm])
        if not self.k_samples:
            mask = self._mask(blocks)
            return [
                st.feed(blocks[i], mask=mask[i])
                for i, st in enumerate(self.streams)
            ]
        # COPY at staging (callers reuse feed buffers; the channel-map
        # permute above already produced a private array when it ran)
        self._pipe.stage(
            blocks if self._perm is not None else blocks.copy()
        )
        while self._pipe.staged_len >= self.k_samples:
            self._pipe.submit(self._mask, self._pipe.take(self.k_samples))
        return self._drain(block=False)

    def _mask(self, batch: np.ndarray) -> np.ndarray:
        """Upload, mask and fetch one [n_streams, width, channels] batch on
        the farm's stream; only the host mask leaves, after the stream's
        work has ended."""
        from ..dsp.logic_frontend import logic_event_mask

        with torch.cuda.stream(self._stream):
            x = torch.from_numpy(batch).to(self._dev)
            mask, self._carry = logic_event_mask(x, self._carry)
            mask = mask.cpu()
            if self._stream is not None:
                self._stream.synchronize()
        return mask.numpy()

    def _drain(self, block: bool) -> list[list[Frame]]:
        out = [[] for _ in self.streams]

        def walk(batch, mask):
            for i, st in enumerate(self.streams):
                out[i].extend(st.feed(batch[i], mask=mask[i]))

        self._pipe.drain(walk, block)
        return out

    def finish(self) -> list[list[Frame]]:
        out = [[] for _ in self.streams]
        if self.k_samples:
            if self._pipe.staged_len:
                self._pipe.submit(
                    self._mask, self._pipe.take(self._pipe.staged_len)
                )
            for i, new in enumerate(self._drain(block=True)):
                out[i].extend(new)
            self._pipe.shutdown()
        for i, st in enumerate(self.streams):
            out[i].extend(st.finish())
        return out
