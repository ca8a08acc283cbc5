"""Entry ``stream_farm``: ``runtime/farm.CudaStreamFarm`` with the
configuration's ``farm`` settings, fed [streams, block] float32 blocks
from the caller's thread, as a test rig's receivers arrive.  The loop is
closed: the next block goes in when ``feed`` returns, so the farm's
pipeline (staging, its IO thread, the walk) sets the pace."""

from __future__ import annotations

import time

from nfcbench.drivers.base import Driver as _Base


class Driver(_Base):
    def __init__(self, cfg: dict, traffic, device):
        super().__init__(cfg, traffic, device)
        from nfclab_torch.dsp import cuda_channels
        from nfclab_torch.native.binding import native_available
        from nfclab_torch.runtime.farm import CudaStreamFarm

        # the host's native library (conditioner and walk) is built or
        # loaded here, in set-up, as the program builds its kernel library
        # before a session: built inside the first walk, it would hold a
        # backlog of blocks past the warm-up
        if not native_available():
            raise RuntimeError("the native host library is unavailable")
        self.n_streams = int(cfg["streams"])
        self.farm = CudaStreamFarm(self.n_streams, int(cfg["sample_rate"]),
                                   device=device, **cfg["farm"])
        self.window_samples = self.farm.k_chunks * cuda_channels.CHAIN_CHUNK
        self._span_farm(self.farm)

    def _take(self, out, t: float) -> None:
        for i, frames in enumerate(out):
            self.frames += [(i, t, f) for f in frames]

    def run_until(self, stop) -> None:
        while not stop(self):
            blk = self._next_block()
            if blk is None:
                continue
            self.handoff.append(time.perf_counter())
            out = self.farm.feed(blk)
            self._take(out, time.perf_counter())
            self._mark(self.farm)

    def finish(self, timeout: float = 120.0) -> None:
        """Walk one more dispatch window (a frame is emitted a little after
        its last sample is walked), then stop the farm's threads; what is
        still staged or in flight is dropped, not walked."""
        n = len(self.events)
        self.run_until(lambda d: len(d.events) > n)
        self.farm._pipe.shutdown(wait=True)
        if self.farm._walk_pool is not None:
            self.farm._walk_pool.shutdown(wait=True)
