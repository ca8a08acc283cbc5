"""Validate the fused frontend on the card against the dense frontend.

Counterpart of ``nfclab/tools/validate_fused.py``.  Compares the fused
kernels (``dsp/fused_frontend``, through ``dsp/frontend.
make_fused_frontend``) against the dense frontend (``dsp/frontend.
make_frontend``: the conditioning kernel and torch operations) on
nfclab's random bursty input (2048 streams x 4096 samples, seed 42, two
attenuated stretches):

- the five conditioning outputs (envelope, filtered, deviation, average,
  mod_depth) must be bit-exact;
- each NFC detect bit of ``MASK_LAYOUT`` may differ in at most 1e-4 of
  the samples (the fused kernels' box sums are float32 running sums, the
  dense frontend's float64 prefix sums rounded once);
- ``fused_frontend_stream`` in chunks of 1024 samples with carried state
  must be bit-identical to the monolithic pass on ten outputs.

nfclab chose 2048 streams for its TPU kernel's 16-row tile path, which
the CUDA kernels do not have; the size is kept so the tool runs nfclab's
input unchanged, and it fills 64 of the kernels' 32-stream blocks.

Run: python -m nfclab_torch.tools.validate_fused [--device cpu].  Prints
one line per check, then PASS; exit 1, with a message, on any failure or
when there is no card (``--device cpu`` runs the kernels' plain versions
instead, in a few seconds).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

COND_OUTPUTS = ("envelope", "filtered", "deviation", "average", "mod_depth")
OUT_CHECK = (
    "envelope", "filtered", "average", "bv12", "bv94", "q47", "q189",
    "p24x6", "p94x24", "detect_mask",
)


def nfclab_input() -> np.ndarray:
    """nfclab's input: 2048 x 4096 samples uniform in [0.01, 0.41), seed
    42, with two attenuated stretches."""
    rng = np.random.default_rng(42)
    x = (rng.random((2048, 4096), dtype=np.float32) * 0.4
         + 0.01).astype(np.float32)
    x[:, 1000:1100] *= 0.05
    x[:, 2000:2100] *= 0.3
    return x


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def validate(x: np.ndarray, device="cuda") -> list[str]:
    """Run the three checks on x; returns the failures (empty: pass)."""
    import torch

    from ..core.params import SignalParams
    from ..core.thresholds import DecoderThresholds
    from ..dsp.cuda_channels import resolve_device
    from ..dsp.frontend import (_params_tuple, make_frontend,
                                make_fused_frontend)
    from ..dsp.fused_frontend import MASK_LAYOUT, fused_frontend_stream

    dev = resolve_device(device)
    params = SignalParams(10_000_000)
    xd = torch.from_numpy(x).to(dev)
    ref = make_frontend(params, device=dev)(xd)
    fused = make_fused_frontend(params, native_layout=False, device=dev)(xd)

    failures = []
    for name in COND_OUTPUTS:
        a, b = _np(ref[name]), _np(fused[name])
        if not np.array_equal(a, b, equal_nan=True):
            failures.append(f"{name}: not bit-exact "
                            f"(maxdiff {np.nanmax(np.abs(a - b)):.3e})")
        else:
            print(f"{name}: bit-exact")

    packed = _np(fused["detect_mask"]).astype(np.int32)
    for name, w in MASK_LAYOUT:
        a = _np(ref[name]).astype(bool)
        b = (packed & w) != 0
        diff = int(np.sum(a != b))
        frac = diff / a.size
        print(f"{name}: {diff}/{a.size} bits differ ({frac:.2e})")
        if frac > 1e-4:
            failures.append(f"{name}: {frac:.2e} of bits differ (>1e-4)")

    # chunked streaming must be bit-identical to the monolithic pass
    mp = DecoderThresholds().detect_mask_tuple(params.power_level_threshold)
    pieces = {name: [] for name in OUT_CHECK}
    for _off, res in fused_frontend_stream(xd, _params_tuple(params),
                                           chunk=1024, mask_params=mp):
        for name in OUT_CHECK:
            pieces[name].append(_np(res[name]))
    for name in OUT_CHECK:
        chunked = np.concatenate(pieces[name], axis=1)
        whole = _np(fused[name])
        if np.array_equal(chunked, whole, equal_nan=True):
            print(f"chunked {name}: bit-exact")
        else:
            diff = np.abs(chunked.astype(np.float64) - whole)
            failures.append(f"chunked {name}: differs from monolithic pass "
                            f"(maxdiff {np.nanmax(diff):.3e})")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nfclab-torch-validate-fused",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    from ..dsp.cuda_channels import DeviceUnavailable

    try:
        failures = validate(nfclab_input(), args.device)
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
