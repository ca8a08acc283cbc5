"""Spectrum processor of the port: windowed FFT of the IQ stream.

Counterpart of ``nfclab/dsp/spectrum.py`` (FourierProcessTask parity:
1024-point C2C FFT over decimated IQ, the reference's "Hamming" window,
which is a sin^2 Hann, magnitude, fftshift).  nfclab computes it with
``jnp.fft`` in a jitted program, outside any Pallas kernel, so the port
computes it with ``torch.fft`` on ``device``: cuFFT on the card, PyTorch's
CPU FFT with ``device="cpu"``.  No kernel is written by hand here.

``WINDOW_*`` and ``make_window`` are copies of nfclab's
(tests/test_torch_copies.py holds them to it).
"""

from __future__ import annotations

import numpy as np
import torch

WINDOW_NONE = 0
WINDOW_HAMMING = 1
WINDOW_HANN = 2


def make_window(length: int, window: int) -> np.ndarray:
    n = np.arange(length, dtype=np.float64)
    if window == WINDOW_HAMMING:
        # FourierProcessTask.cpp:126-129 ("Hamming" label, sin^2 shape)
        w = np.sin(np.pi * n / length) ** 2
    elif window == WINDOW_HANN:
        w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / (length - 1)))
    else:
        w = np.ones(length)
    return w.astype(np.float32)


def spectrum(iq: torch.Tensor, window: torch.Tensor,
             decimation: int) -> torch.Tensor:
    """[B, len(window) * decimation, 2] float32 IQ on window's device ->
    [B, len(window)] float32 magnitudes, fftshifted (nfclab's ``_jitted``
    body in float32 / complex64)."""
    x = iq[:, ::decimation]
    z = torch.complex(x[..., 0], x[..., 1]) * window
    return torch.fft.fftshift(torch.fft.fft(z, dim=-1).abs(), dim=-1)


class SpectrumProcessor:
    """Streaming 1024-bin spectrum over IQ blocks, a pure function over the
    latest block, on ``device`` (cuda unless the caller asks for cpu;
    DeviceUnavailable without a card).

    On a card the work runs on a CUDA stream of the processor's own, which
    is synchronised before the result leaves: the spectrum shares the card
    with the live farm's IO thread, and neither queues behind the other's
    work on the default stream."""

    def __init__(self, length: int = 1024, window: int = WINDOW_HAMMING,
                 bandwidth: float = 10e6, device="cuda"):
        from .cuda_channels import resolve_device

        self.length = length
        self.window = window
        self.bandwidth = bandwidth
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        with torch.cuda.stream(self._stream):
            self._window = torch.from_numpy(
                make_window(length, window)).to(self.device)
            if self._stream is not None:
                self._stream.synchronize()

    def process(self, iq: np.ndarray, sample_rate: int) -> np.ndarray:
        """iq: [N, 2] or [B, N, 2] float32; returns [*, length] magnitudes
        (fftshifted, centered on the tuned frequency).  Only the first
        length * decimation pairs of each row go up to the device."""
        decimation = max(1, int(sample_rate / self.bandwidth))
        batched = iq.ndim == 3
        if not batched:
            iq = iq[None]
        need = self.length * decimation
        if iq.shape[1] < need:
            raise ValueError(f"need at least {need} IQ samples")
        host = np.ascontiguousarray(iq[:, :need], np.float32)
        with torch.cuda.stream(self._stream):
            x = torch.from_numpy(host).to(self.device)
            mag = spectrum(x, self._window, decimation).cpu()
            if self._stream is not None:
                self._stream.synchronize()
        out = mag.numpy()
        return out if batched else out[0]
