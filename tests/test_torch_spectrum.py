"""nfclab_torch's spectrum (dsp/spectrum.py, torch.fft) and FourierTask
against nfclab's (jnp.fft on JAX-CPU) on the CPU.

Tolerance: the two FFTs round differently, so a row may differ by at most
1e-5 of its own maximum, and its argmax must be equal (the largest
difference seen on these inputs is ~3e-7 of the row's maximum).

- ``SpectrumProcessor(device="cpu").process`` on seeded IQ: 3.2, 10, 20
  and 24 MS/s (decimation 1, 1, 2, 2), every window, 512 and 1024 points,
  [B, N, 2] and [N, 2]; nfclab's 1.2 MHz tone test; the short-input
  ValueError text.
- ``FourierTask(device="cpu")`` and nfclab's FourierTask, each on its own
  package's bus, fed the same IQ blocks (interleaved 1-D and [N, 2], a
  short one, an EOF buffer): equal signal.fft buffers.
- No card: DeviceUnavailable when the processor or the task is built
  without device="cpu"; a process() that raises ends the task in "error".
The cuda-marked test runs the processor on the card against device="cpu".
"""

import queue

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (kept on the CPU by conftest.ensure_cpu_devices)

TOL = 1e-5   # of each row's maximum
TONE = 1.2e6


@pytest.fixture(autouse=True, scope="module")
def _jax_cpu():
    from conftest import ensure_cpu_devices

    ensure_cpu_devices()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (cuFFT runs only there)")


def _iq(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((*shape, 2)).astype(np.float32)


def _hold(got, want):
    """Equal shapes and dtype, each row within TOL of its maximum, equal
    argmax."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    err = np.abs(g - w).max(axis=1) / w.max(axis=1)
    assert err.max() <= TOL, err.max()
    assert np.array_equal(g.argmax(axis=1), w.argmax(axis=1))


@pytest.mark.parametrize("length", [512, 1024])
@pytest.mark.parametrize("window", [0, 1, 2])
@pytest.mark.parametrize("rate", [3_200_000, 10_000_000, 20_000_000,
                                  24_000_000])
def test_spectrum_matches_nfclab(rate, window, length):
    """[8, N, 2] and [N, 2] IQ with N a few pairs above what the rate's
    decimation needs: the port's process() equals nfclab's within TOL."""
    from nfclab.dsp.spectrum import SpectrumProcessor as Ref

    from nfclab_torch.dsp.spectrum import SpectrumProcessor

    dec = max(1, int(rate / 10e6))
    iq = _iq((8, length * dec + 13), seed=rate // 1000 + 10 * window + length)
    ref = Ref(length=length, window=window)
    port = SpectrumProcessor(length=length, window=window, device="cpu")
    _hold(port.process(iq, rate), ref.process(iq, rate))
    _hold(port.process(iq[3], rate), ref.process(iq[3], rate))
    assert port.process(iq[3], rate).shape == (length,)


def _tone(rate, n):
    t = np.arange(n) / rate
    return np.stack([np.cos(2 * np.pi * TONE * t),
                     np.sin(2 * np.pi * TONE * t)], axis=-1).astype(np.float32)


def test_spectrum_tone_peak():
    """nfclab's tone test (tests/test_tasks.py::test_spectrum): a 1.2 MHz
    tone at 10 MS/s peaks at bin 512 + 123 +- 1, in both packages."""
    from nfclab.dsp.spectrum import SpectrumProcessor as Ref

    from nfclab_torch.dsp.spectrum import SpectrumProcessor

    rate = 10_000_000
    iq = _tone(rate, 4096)
    mag = SpectrumProcessor(length=1024, bandwidth=10e6,
                            device="cpu").process(iq, rate)
    assert mag.shape == (1024,)
    expect = 512 + int(round(TONE / rate * 1024))
    assert abs(int(np.argmax(mag)) - expect) <= 1
    _hold(mag, Ref(length=1024, bandwidth=10e6).process(iq, rate))


def test_spectrum_short_input_error_equal():
    """Fewer pairs than length * decimation: the same ValueError text."""
    from nfclab.dsp.spectrum import SpectrumProcessor as Ref

    from nfclab_torch.dsp.spectrum import SpectrumProcessor

    for rate, n in ((10_000_000, 1023), (20_000_000, 2047)):
        iq = _iq((n,), seed=n)
        with pytest.raises(ValueError) as want:
            Ref().process(iq, rate)
        with pytest.raises(ValueError) as got:
            SpectrumProcessor(device="cpu").process(iq, rate)
        assert str(got.value) == str(want.value)


def _blocks(rate):
    """IQ blocks as sources publish them: interleaved 1-D (an odd length
    too), [N, 2], one too short to process, then an EOF."""
    rng = np.random.default_rng(7)
    out = []
    for i, n in enumerate((4096, 2048, 1000, 3000, 2049)):
        iq = rng.standard_normal((n, 2)).astype(np.float32)
        iq[:, 0] += np.cos(2 * np.pi * TONE * np.arange(n) / rate)
        data = iq if i % 2 else iq.reshape(-1)
        if i == 4:
            data = data[:-1]  # an odd count of interleaved values
        out.append((data, 4096 * i))
    return out


def _run_task(pkg, rate, **kw):
    """The package's FourierTask on its own bus, fed _blocks(rate) and an
    EOF through Executor: (signal.fft buffers, the last status)."""
    import importlib

    pl = importlib.import_module(f"{pkg}.runtime.pipeline")
    subject = importlib.import_module(f"{pkg}.runtime.subject").Subject
    sig = importlib.import_module(f"{pkg}.hw.signal")
    subject.clear_registry()
    out = queue.Queue()
    subject.name("signal.fft").subscribe(out.put, replay=False)
    task = pl.FourierTask(**kw)
    ex = pl.Executor(pool_size=1)
    ex.submit(task)
    iq = subject.name("radio.signal.iq")
    blocks = _blocks(rate)
    for data, off in blocks:
        iq.next(sig.SignalBuffer(data, rate, off,
                                 signal_type=sig.SignalType.
                                 SIGNAL_TYPE_RADIO_SAMPLES))
    iq.next(sig.SignalBuffer.eof(rate))
    want = sum(len(d) // (1 if d.ndim == 2 else 2) >= 1024 * max(
        1, int(rate / 10e6)) for d, _ in blocks)
    got = [out.get(timeout=30) for _ in range(want)]
    ex.shutdown()
    assert out.empty()
    return got, subject.name("fourier.status").value


@pytest.mark.parametrize("rate", [10_000_000, 20_000_000])
def test_fourier_task_matches_nfclab(rate):
    """Both packages' tasks publish as many signal.fft buffers, with equal
    offset, sample_rate and signal_type, and data within TOL; both end
    "complete"."""
    ref, ref_status = _run_task("nfclab", rate)
    got, status = _run_task("nfclab_torch", rate, device="cpu")
    assert len(got) == len(ref) >= 3
    for g, r in zip(got, ref):
        assert (g.offset, g.sample_rate) == (r.offset, r.sample_rate)
        assert int(g.signal_type) == int(r.signal_type)
        assert g.signal_type.name == "SIGNAL_TYPE_FFT_BIN"
        _hold(np.asarray(g.data), np.asarray(r.data))
    assert status == ref_status == {"status": "complete"}


def test_no_card_raises_when_built(monkeypatch):
    """Without a card and without device="cpu": DeviceUnavailable when the
    processor or the task is built."""
    from nfclab_torch.dsp.cuda_channels import DeviceUnavailable
    from nfclab_torch.dsp.spectrum import SpectrumProcessor
    from nfclab_torch.runtime.pipeline import FourierTask

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        SpectrumProcessor()
    with pytest.raises(DeviceUnavailable):
        FourierTask()


def test_fourier_process_failure_ends_in_error(monkeypatch):
    """A process() that raises ends the task with Executor's "error"
    status, and nothing is published on signal.fft (no host fallback)."""
    from nfclab_torch.dsp import spectrum
    from nfclab_torch.hw.signal import SignalBuffer
    from nfclab_torch.runtime.pipeline import Executor, FourierTask
    from nfclab_torch.runtime.subject import Subject

    def fail(*a, **k):
        raise RuntimeError("cuFFT failed")

    monkeypatch.setattr(spectrum, "spectrum", fail)
    Subject.clear_registry()
    out, statuses = [], queue.Queue()
    Subject.name("signal.fft").subscribe(out.append, replay=False)
    Subject.name("fourier.status").subscribe(statuses.put, replay=False)
    ex = Executor(pool_size=1)
    ex.submit(FourierTask(device="cpu"))
    assert statuses.get(timeout=30)["status"] == "streaming"
    data, off = _blocks(10_000_000)[0]
    Subject.name("radio.signal.iq").next(SignalBuffer(data, 10_000_000, off))
    status = statuses.get(timeout=30)
    ex.shutdown()
    assert status["status"] == "error" and "cuFFT failed" in status["error"]
    assert out == []


@pytest.mark.cuda
def test_spectrum_on_the_card(cuda):
    """The processor on the card against device="cpu" at the task's shape
    and batched, every window, 10 and 20 MS/s."""
    from nfclab_torch.dsp.spectrum import SpectrumProcessor

    for rate in (10_000_000, 20_000_000):
        dec = max(1, int(rate / 10e6))
        for window in (0, 1, 2):
            iq = _iq((64, 1024 * dec), seed=window)
            card = SpectrumProcessor(window=window)
            cpu = SpectrumProcessor(window=window, device="cpu")
            _hold(card.process(iq, rate), cpu.process(iq, rate))
            _hold(card.process(iq[0], rate), cpu.process(iq[0], rate))
