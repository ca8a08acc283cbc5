"""Validate the device logic frontend (dsp/logic_frontend) on the card.

Counterpart of ``nfclab/tools/validate_tpu_logic.py``.  nfclab
synthesizes its ISO7816-3 sessions; this tool takes 4-channel logic WAVs
(8-bit, as ``decode_cli run`` reads them, channels in decoder order: IO,
CLK, RST, VCC) and checks, on each:

- ``logic_event_mask`` run in uneven 50,001-sample chunks with the carry
  threaded: the four event index sets equal the dense host scans exactly
  (the edge is one float32 subtract), and on the card the mask and carry
  equal a ``device="cpu"`` run bit for bit;
- ``StreamingIsoDecoder(frontend="device")`` fed the same chunks gives
  exactly ``IsoDecoder``'s one-shot frames, and at least one;

then ``runtime/farm.CudaLogicFarm`` over all the captures at once, each
padded with its last sample to the longest, fed 70,000 samples at a time:
each stream's frames equal its padded capture's one-shot frames, and are
not empty.

Run: python -m nfclab_torch.tools.validate_cuda_logic LOGIC.wav [...]
[--device cpu].  Prints one line per check, then PASS; exit 1, with a
message, on a failure, a missing file or a missing card (``--device
cpu`` runs everything on the CPU).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

CHUNK = 50_001      # nfclab's uneven chunk
FARM_FEED = 70_000  # samples a farm feed


def _key(f):
    return (f.sample_start, f.sample_end, f.frame_type)


def dense_indices(capture: np.ndarray) -> dict[str, np.ndarray]:
    """The host oracle: each event index set from a dense scan."""
    from ..demod.iso7816 import CH_CLK, CH_IO, CH_RST, CH_VCC

    edge = np.zeros_like(capture)
    edge[1:] = capture[1:] - capture[:-1]
    return {
        "io_edges": np.flatnonzero(edge[:, CH_IO] != 0),
        "io_falls": np.flatnonzero(edge[:, CH_IO] < 0),
        "line_edges": np.union1d(
            np.flatnonzero(edge[:, CH_RST] != 0),
            np.flatnonzero(edge[:, CH_VCC] != 0),
        ),
        "clk_falls": np.flatnonzero(edge[:, CH_CLK] < 0),
    }


def check_capture(name: str, capture: np.ndarray, rate: int,
                  device) -> list[str]:
    """The mask and streaming checks on one capture; returns failures."""
    import torch

    from ..dsp.logic_frontend import event_indices, logic_event_mask
    from ..runtime.logic_decoder import IsoDecoder, StreamingIsoDecoder

    failures = []
    carry = cpu_carry = None
    masks = []
    same_as_cpu = True
    for off in range(0, len(capture), CHUNK):
        block = capture[off : off + CHUNK]
        m, carry = logic_event_mask(block, carry, device=device)
        masks.append(m.cpu().numpy())
        if device.type == "cuda":
            cm, cpu_carry = logic_event_mask(block, cpu_carry, device="cpu")
            same_as_cpu &= bool(torch.equal(m.cpu(), cm)
                                and torch.equal(carry.cpu(), cpu_carry))
    if device.type == "cuda":
        if same_as_cpu:
            print(f"{name}: mask and carry bit for bit device='cpu'")
        else:
            failures.append(f"{name}: mask or carry != device='cpu'")
    got = event_indices(np.concatenate(masks))
    for key, want in dense_indices(capture).items():
        if np.array_equal(got[key], want):
            print(f"{name} {key}: exact ({len(want)} events)")
        else:
            failures.append(f"{name} {key}: index sets differ")

    ref = IsoDecoder().decode(capture, rate)
    dec = StreamingIsoDecoder(rate, channels=4, frontend="device",
                              device=device)
    frames = []
    for off in range(0, len(capture), CHUNK):
        frames.extend(dec.feed(capture[off : off + CHUNK]))
    frames.extend(dec.finish())
    if ref and sorted(frames, key=_key) == sorted(ref, key=_key):
        print(f"{name} frames: identical ({len(frames)})")
    else:
        failures.append(f"{name} frames: device-fed decode ({len(frames)}) "
                        f"differs from the one-shot host decode ({len(ref)})")
    return failures


def check_farm(captures: list[np.ndarray], rate: int, device) -> list[str]:
    """CudaLogicFarm over every capture, padded with its last sample."""
    from ..runtime.farm import CudaLogicFarm
    from ..runtime.logic_decoder import IsoDecoder

    n = max(len(c) for c in captures)
    blocks = np.ones((len(captures), n, 4), np.float32)
    for i, c in enumerate(captures):
        blocks[i, : len(c)] = c
        blocks[i, len(c):] = c[-1]
    want = [IsoDecoder().decode(blocks[i], rate)
            for i in range(len(captures))]
    farm = CudaLogicFarm(len(captures), rate, device=device)
    got = [[] for _ in captures]
    for off in range(0, n, FARM_FEED):
        for i, fr in enumerate(farm.feed(blocks[:, off : off + FARM_FEED])):
            got[i].extend(fr)
    for i, fr in enumerate(farm.finish()):
        got[i].extend(fr)
    failures = []
    for i in range(len(captures)):
        if want[i] and sorted(got[i], key=_key) == sorted(want[i], key=_key):
            print(f"CUDA LOGIC FARM stream {i}: OK ({len(want[i])} frames)")
        else:
            failures.append(f"logic farm stream {i}: frames differ "
                            f"({len(got[i])} vs {len(want[i])})")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nfclab-torch-validate-cuda-logic",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("wavs", nargs="*", metavar="LOGIC.wav")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..dsp.cuda_channels import DeviceUnavailable, resolve_device
    from ..io.wav import read_wav
    from .fixtures import missing

    if missing(args.wavs):
        return 1
    captures, rates = [], set()
    for p in args.wavs:
        samples, info = read_wav(p)
        if info.channels != 4:
            print(f"error: {p}: {info.channels} channels, a logic capture "
                  "has 4", file=sys.stderr)
            return 1
        captures.append(np.ascontiguousarray(samples, np.float32))
        rates.add(info.sample_rate)
    if len(rates) != 1:
        print(f"error: the captures' rates differ: {sorted(rates)}",
              file=sys.stderr)
        return 1
    rate = rates.pop()
    try:
        dev = resolve_device(args.device)
        failures = []
        for p, c in zip(args.wavs, captures):
            failures += check_capture(os.path.basename(p), c, rate, dev)
        failures += check_farm(captures, rate, dev)
    except DeviceUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if failures:
        print("FAIL:")
        for f in failures:
            print(" -", f)
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
