"""nfclab_torch — the PyTorch / CUDA port of nfclab.

The package decodes NFC captures like ``nfclab`` does, with the device
frontend written for an NVIDIA Hopper GPU: its kernels are hand-written
CUDA (``csrc/``), built with nvcc at the first CUDA call (``kernels/``).
The host layers (``core``, ``io``, ``protocol``, ``native``, ``demod``, the
walk) are copies of nfclab's, so the port imports nothing of nfclab and
nothing of JAX.

Layer map (as nfclab's):
    core/      data model, constants, bitrate params (copies)
    io/        WAV + TRZ + golden-JSON storage (copies)
    dsp/       device frontends: conditioning, channels, masks, spectrum
    csrc/      the CUDA kernels; kernels/ builds and binds them
    demod/     per-tech demodulator state machines (copies)
    protocol/  CRC, protocol detail parsers (copies)
    shard/     temporal tiling + rank layouts over torch.distributed
    runtime/   decoder facade, farms, streaming pipeline, tasks
    native/    C++ oracle kernels + hot-loop runtime (a copy, ctypes)
    apps/      CLI entry points (decode, bench, monitor)
    tools/     trace reader, reports, the shard validator, scaling bench
    experiments/  counterparts of the repository's experiments/

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
tensor-level functions run where their input tensor lies.  On the CPU the
kernels' plain PyTorch versions run in their place.
"""

__version__ = "0.1.0"
