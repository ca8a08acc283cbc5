"""Ways to break the timed path, for the control and the fault checks that
show the comparison fails them.  The benchmark's own runs apply none.

- ``drop_block`` (the control): one block in 16 is never handed to the
  program, which breaks the configurations' guarantee that no sample is
  lost (the live bridge's bounded queue, the rig's closed loop).
- ``state_unchanged``: each block's conditioning step (the float64
  conditioner every stream runs before its walk) leaves the stream's
  carried state as it found it, so every block starts from the first.
- ``half_batch``: half of each window's triggers are left out: those of
  the second half of the streams (the second half of the window where
  there is one stream).
- ``token_altered``: one data frame in seven comes out of the walk with
  its last byte altered.

Each applies by replacing a function of the program in this process
(or, for ``drop_block``, the entry driver's ``skip``).
"""

from __future__ import annotations

import numpy as np

DROP_EVERY = 16
ALTER_EVERY = 7


def _drop_block(driver, patch) -> None:
    driver.skip = lambda k: k % DROP_EVERY == DROP_EVERY - 1


def _state_unchanged(driver, patch) -> None:
    from nfclab_torch.native import binding

    condition = binding.condition_stream_into

    def frozen(value, params, state, bufs, lo):
        return condition(value, params, state.copy(), bufs, lo)

    patch(binding, "condition_stream_into", frozen)


def _half_batch(driver, patch) -> None:
    farm = driver.farm
    device_pass = farm._device_pass

    def halved(batch, base0):
        per = device_pass(batch, base0)
        n, width = batch.shape
        if n > 1:
            none = (np.zeros(0, np.int64), np.zeros(0, np.uint8))
            return per[: n // 2] + [none] * (n - n // 2)
        rel, bits = per[0]
        keep = rel < width // 2
        return [(rel[keep], bits[keep])]

    patch(farm, "_device_pass", halved)


def _token_altered(driver, patch) -> None:
    from nfclab_torch.runtime import farm as farm_mod

    feed = farm_mod.MaskFedStream.feed_mask_idx
    count = [0]

    def altered(self, *args, **kw):
        frames = feed(self, *args, **kw)
        for f in frames:
            if f.data and f.frame_type in (0x0102, 0x0103):
                count[0] += 1
                if count[0] % ALTER_EVERY == 0:
                    f.data = f.data[:-1] + bytes([f.data[-1] ^ 0x01])
        return frames

    patch(farm_mod.MaskFedStream, "feed_mask_idx", altered)


FAULTS = {"drop_block": _drop_block, "state_unchanged": _state_unchanged,
          "half_batch": _half_batch, "token_altered": _token_altered}


def hook(names, patch=setattr):
    """A setup hook applying the named faults, or None for none; `patch`
    (setattr by default) replaces each attribute, so a test can undo it."""
    if not names:
        return None
    unknown = [n for n in names if n not in FAULTS]
    if unknown:
        raise ValueError(f"unknown faults {unknown}; known: {list(FAULTS)}")

    def apply(driver):
        for n in names:
            FAULTS[n](driver, patch)

    return apply
