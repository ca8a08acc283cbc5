"""Entry ``live_task``: ``decode_cli live --frontend mask``'s decoder,
``runtime/pipeline.RadioDecoderTask(frontend="mask")`` under an
``Executor``, fed ``SignalBuffer`` blocks on the ``radio.signal.raw``
Subject and read on ``radio.decoder.frame``.  Inside it is the one-stream
``CudaStreamFarm`` of ``_MaskLiveDecoder``.

The loop is closed, as the live bridge's bounded queue makes it: a block
is published while fewer than ``queue_bound`` blocks wait in the task's
``signal_queue``, so the backlog is bounded and no block is dropped.
The drain events are read from the task's farm after each block it
decodes, on the task's thread."""

from __future__ import annotations

import threading
import time

from nfcbench.drivers.base import Driver as _Base

POLL_S = 0.0002     # the feeder's wait while the queue is full


class Driver(_Base):
    def __init__(self, cfg: dict, traffic, device):
        super().__init__(cfg, traffic, device)
        from nfclab_torch.dsp import cuda_channels
        from nfclab_torch.hw.signal import SignalBuffer
        from nfclab_torch.native.binding import native_available
        from nfclab_torch.runtime.pipeline import Executor, RadioDecoderTask
        from nfclab_torch.runtime.subject import Subject

        # the host's native library (conditioner and walk) is built or
        # loaded here, in set-up, as the program builds its kernel library
        # before a session: built inside the first walk, it would hold a
        # backlog of blocks past the warm-up
        if not native_available():
            raise RuntimeError("the native host library is unavailable")
        self.n_streams = 1
        self.rate = int(cfg["sample_rate"])
        self.bound = int(cfg["queue_bound"])
        self._buffer = SignalBuffer
        Subject.clear_registry()
        self.task = RadioDecoderTask(device=device, **cfg["decoder"])
        self.farm = None
        self._made = threading.Event()
        make = self.task._make_decoder

        def make_decoder(sample_rate):
            dec = make(sample_rate)
            farm = dec._farm
            self._span_farm(farm)
            feed = dec.feed

            def feed_marked(block):
                out = feed(block)
                self._mark(farm)
                return out

            dec.feed = feed_marked
            self.farm = farm
            self.window_samples = farm.k_chunks * cuda_channels.CHAIN_CHUNK
            self._made.set()
            return dec

        self.task._make_decoder = make_decoder
        self._done = threading.Event()
        Subject.name("radio.decoder.frame").subscribe(self._on_frame,
                                                      replay=False)
        self.raw = Subject.name("radio.signal.raw")
        self.executor = Executor(pool_size=1)
        self.executor.submit(self.task)
        # the first block makes the decoder (and its farm); wait for it
        self._publish()
        if not self._made.wait(60.0):
            raise RuntimeError("the decoder task made no decoder")

    def _on_frame(self, frame) -> None:
        if frame is None:
            self._done.set()
        else:
            self.frames.append((0, time.perf_counter(), frame))

    def _publish(self) -> None:
        blk = self._next_block()
        if blk is None:
            return
        self.handoff.append(time.perf_counter())
        self.raw.next(self._buffer(blk[0], self.rate,
                                   (len(self.handoff) - 1) * blk.shape[1]))

    def run_until(self, stop) -> None:
        q = self.task.signal_queue
        while not stop(self):
            if not all(t.is_alive() for t in self.executor._threads):
                raise RuntimeError("the decoder task ended: "
                                   f"{self.task.status.value}")
            if q.qsize() < self.bound:
                self._publish()
            else:
                time.sleep(POLL_S)

    def finish(self, timeout: float = 120.0) -> None:
        self.raw.next(self._buffer.eof(self.rate))
        ok = self._done.wait(timeout)
        self.executor.shutdown(timeout)
        if not ok:
            raise RuntimeError("the decoder task did not flush in time")
