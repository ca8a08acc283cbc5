"""Entry ``batch_corpus_mask``: ``runtime/batch.decode_batch`` over
recorded sessions with ``frontend="mask"``, as ``decode_cli run
--frontend mask`` decodes a directory: the chained mask engine on the
card over the call's captures as streams, on a thread of its own, while
the parent conditions natively, then the walks on threads.

Everything but the span labels is ``batch_corpus``'s driver: the ring of
recordings written as float WAVs in set-up, ``captures_per_call`` of them
a call in a closed loop, one drain event a call.  The mask branch's spans
of each call are copied into ``spans`` under the names the trace reader
gives idle gaps: the device pass and the parent's wait on it as
``device_pass``, the parent's native conditioning as ``condition`` (the
reader names a gap by ``device_pass`` or ``walk`` alone, so a gap under
the parent's conditioning takes the device pass's name while it runs).
"""

from __future__ import annotations

import time

from nfcbench.drivers import batch_corpus

# the mask branch's spans, by the label trace.summarize names an idle gap
# by (batch_corpus.LABELS names the others)
LABELS = {"batch.masks": "device_pass", "batch.masks_wait": "device_pass",
          "batch.condition_native": "condition"}


class Driver(batch_corpus.Driver):
    def _call(self) -> None:
        from nfclab_torch.runtime import trace

        t0 = time.perf_counter()
        super()._call()
        if self.spans_on:
            t = self.events[-1][0]
            self.spans += [(sp.start, sp.end, LABELS[sp.name])
                           for sp in trace.spans(t0, t) if sp.name in LABELS]
