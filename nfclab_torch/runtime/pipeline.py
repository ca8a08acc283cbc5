"""Streaming task pipeline of the port.

Long-lived worker tasks connected by named Subject streams, run on an
executor thread pool (rt::Executor).  Stream topology matches the
reference wire protocol:

    radio.signal.iq    IQ blocks from source      -> fourier, storage
    radio.signal.raw   magnitude blocks           -> decoder, resampler
    signal.fft         spectrum bins              -> consumers (the monitor)
    adaptive.signal    adaptive render stream     -> consumers, trace writer
    radio.decoder.frame                           decoded frames
    logic.signal.raw   logic-analyzer blocks      -> logic decoder, resampler
    logic.decoder.frame                           decoded ISO7816 frames
    <task>.status / <task>.command                control plane

The radio decoder is incremental: each signal block feeds the streaming
decoder and completed frames publish immediately.  With
``frontend="mask"`` the detect triggers come from the fused frontend
kernels on ``device`` through a one-stream CudaStreamFarm.

Executor, Task, the radio source tasks, ResamplingTask,
DeviceMonitorTask, the storage and trace tasks and run_radio_pipeline are
copies of nfclab's (tests/test_torch_copies.py holds them to it);
RadioDecoderTask and _MaskLiveDecoder are ported.  Unlike nfclab's, the
mask frontend never falls back to the host frontend: a missing card
raises DeviceUnavailable when the task is built, and a failed dispatch
propagates, so Executor's fence publishes the task's "error" status.
The logic-analyzer tasks (LogicDecoderTask, LogicSourceTask,
LiveLogicSourceTask) are copies too: the live ISO7816 decoder runs
StreamingIsoDecoder's host frontend, as nfclab's does.  FourierTask is
ported: its spectrum runs on ``device`` (dsp.spectrum, torch.fft), and a
missing card raises DeviceUnavailable when it is built.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable

import numpy as np

from ..core.frame import Frame
from ..dsp.magnitude import SoftwareAgc, iq_to_magnitude
from ..hw.record import RecordDevice
from ..hw.signal import SignalBuffer, SignalType
from . import trace
from .metrics import Throughput
from .subject import Subject


class Executor:
    """Fixed worker pool with exception-fenced task bodies
    (rt/Executor.h:31-48, Executor.cpp:87-104)."""

    def __init__(self, pool_size: int = 10):
        self.pool_size = pool_size
        self._threads: list[threading.Thread] = []
        self._tasks: list["Task"] = []

    def submit(self, task: "Task"):
        self._tasks.append(task)
        t = threading.Thread(target=self._run, args=(task,), daemon=True)
        self._threads.append(t)
        t.start()

    @staticmethod
    def _run(task: "Task"):
        try:
            task.run()
        except Exception as e:  # exception fence: one task crash is contained
            task.status.next({"status": "error", "error": repr(e)}, retain=True)

    def shutdown(self, timeout: float = 10.0):
        for task in self._tasks:
            task.terminate()
        for t in self._threads:
            t.join(timeout)


class Task:
    """AbstractTask parity (lab-tasks/tasks/AbstractTask.h:37-79): auto-wired
    <subject>.status / <subject>.command pair + command queue."""

    def __init__(self, name: str, subject: str):
        self.task_name = name
        self.status = Subject.name(f"{subject}.status")
        self.command = Subject.name(f"{subject}.command")
        self.commands: "queue.Queue[dict]" = queue.Queue()
        self.command.subscribe(self.commands.put, replay=False)
        self.throughput = Throughput()
        self.streaming = True
        self._stop_flush = False
        self._terminated = threading.Event()

    def update_status(self, status: str, **fields):
        self.status.next({"status": status, **fields}, retain=True)

    # ------------------------------------------------- command control plane
    #
    # The reference's per-task Start/Stop/Query/Configure commands
    # (AbstractTask + RadioDecoderTask.cpp:92-151) in one place; tasks call
    # handle_commands() in their loop and override the two hooks.

    def handle_commands(self):
        from .subject import Event

        while True:
            try:
                cmd = self.commands.get_nowait()
            except queue.Empty:
                return
            code = cmd.code if isinstance(cmd, Event) else str(cmd)
            try:
                if code == "start":
                    self.streaming = True
                    self.update_status("streaming")
                elif code == "stop":
                    self.streaming = False
                    self._stop_flush = True  # end the current session
                    self.update_status("idle")
                elif code == "configure":
                    if isinstance(cmd, Event):
                        self._on_configure(cmd.params)
                elif code == "clear":
                    # drop pending buffers / caches without ending the
                    # session (RadioDecoderTask.cpp:368-375 clearDecoder,
                    # TraceStorageTask.cpp:242-252 clearQueue)
                    self._on_clear()
                elif code != "query":
                    if isinstance(cmd, Event):
                        cmd.reject(f"unknown command {code!r}")
                    continue
                if isinstance(cmd, Event):
                    cmd.resolve(self._command_snapshot())
            except Exception as e:
                if isinstance(cmd, Event):
                    cmd.reject(repr(e))

    def _on_configure(self, params: dict):  # hook
        pass

    def _on_clear(self):  # hook: tasks with pending queues drain them
        pass

    def _command_snapshot(self) -> dict:  # hook
        return {"status": "streaming" if self.streaming else "idle"}

    @staticmethod
    def _drain(q: "queue.Queue") -> int:
        n = 0
        while True:
            try:
                q.get_nowait()
                n += 1
            except queue.Empty:
                return n

    def terminate(self):
        self._terminated.set()

    @property
    def terminated(self) -> bool:
        return self._terminated.is_set()

    def run(self):  # pragma: no cover - overridden
        raise NotImplementedError


class RadioSourceTask(Task):
    """Replay source: WAV -> radio.signal.iq + radio.signal.raw with
    IQ->magnitude conversion and software AGC (RadioDeviceTask parity).
    Live SDR capture plugs in behind the same Device interface."""

    def __init__(self, device: RecordDevice, block: int = 65536):
        super().__init__("worker.RadioSource", "radio.receiver")
        self.device = device
        self.block = block
        self.iq_stream = Subject.name("radio.signal.iq")
        self.raw_stream = Subject.name("radio.signal.raw")
        self.agc = SoftwareAgc()
        self._avrg = 0.0

    def run(self):
        self.device.open("read")
        self.update_status("streaming")
        rate = 0
        while not self.terminated and not self.device.is_eof():
            self.handle_commands()
            if not self.streaming:  # Stop command: pause the replay
                self._stop_flush = False
                self._terminated.wait(0.05)
                continue
            buf = self.device.read(self.block)
            rate = buf.sample_rate
            if buf.signal_type == SignalType.SIGNAL_TYPE_RADIO_IQ:
                mag, power, self._avrg = iq_to_magnitude(buf.data, self._avrg)
                self.iq_stream.next(buf)
                raw = SignalBuffer(
                    mag, buf.sample_rate, buf.offset,
                    signal_type=SignalType.SIGNAL_TYPE_RADIO_SAMPLES,
                )
                self.raw_stream.next(raw)
                self.agc.update(self._avrg, buf.offset, buf.elements)
            else:
                self.raw_stream.next(buf)
            self.throughput.update(buf.elements)
        # in-band EOF (RadioDeviceTask.cpp:229-233)
        self.iq_stream.next(SignalBuffer.eof(rate, SignalType.SIGNAL_TYPE_RADIO_IQ))
        self.raw_stream.next(SignalBuffer.eof(rate))
        self.update_status("complete", samples=self.throughput.total)


class LiveRadioSourceTask(Task):
    """Live SDR capture -> radio.signal.iq + radio.signal.raw.

    Drives a native-bridge device (loopback / rtltcp / vendor drivers) via
    hw.sdr.NativeSdrDevice: the bridge's reader thread queues float blocks,
    this task drains them, converts interleaved IQ to magnitude
    (RadioDeviceTask.cpp:560-660 role), runs the software AGC, and publishes
    both streams.  `config` maps param ids -> values applied before start
    (RadioDeviceTask.cpp `setup`)."""

    #: device types the reference's RadioDeviceTask registers and hotplug-
    #: scans (RadioDeviceTask.cpp:101-104)
    SCAN_SCHEMES = ("airspy", "hydrasdr", "rtlsdr", "mirisdr")

    def __init__(self, ident: str, config: dict | None = None,
                 duration_blocks: int | None = None,
                 reconnect: bool = False, rescan_interval: float = 1.0):
        super().__init__("worker.LiveRadioSource", "radio.receiver")
        self.ident = ident
        # hotplug DISCOVERY (RadioDeviceTask.cpp:194-246 `refresh`): ident
        # "auto" (or "auto://scheme1,scheme2") attaches to whatever the
        # device factory enumerates, re-scanning every rescan_interval while
        # absent and after a disconnect — the reference task never takes a
        # fixed device either; it opens the first enumerated receiver.
        self._scan: tuple[str, ...] | None = None
        if ident == "auto":
            self._scan = self.SCAN_SCHEMES
        elif ident.startswith("auto://"):
            self._scan = tuple(
                s for s in ident[len("auto://"):].split(",") if s
            ) or self.SCAN_SCHEMES
        self.config = dict(config or {})
        self.duration_blocks = duration_blocks
        # hotplug recovery (RadioDeviceTask.cpp:167-246 refresh loop): keep
        # rescanning/reopening an absent or disconnected device instead of
        # completing on the first EOF.  Off by default so the one-shot CLI
        # exits promptly on server disconnect; discovery mode always
        # rescans (waiting for a device to appear is its whole point).
        self.reconnect = reconnect or self._scan is not None
        self.rescan_interval = rescan_interval
        self.iq_stream = Subject.name("radio.signal.iq")
        self.raw_stream = Subject.name("radio.signal.raw")
        self.agc = SoftwareAgc()
        self._avrg = 0.0
        self.samples_lost = 0

    def run(self):
        rate = 0
        offset = 0
        blocks = 0
        while not self.terminated:
            self.handle_commands()
            if not self.streaming:  # Stopped via command: idle until Start
                self._stop_flush = False
                self.update_status("idle")
                self._terminated.wait(0.05)
                continue
            dev = self._attach()
            if dev is None or not dev.open():
                self.update_status("absent")
                if not self.reconnect:
                    self.iq_stream.next(
                        SignalBuffer.eof(0, SignalType.SIGNAL_TYPE_RADIO_IQ)
                    )
                    self.raw_stream.next(SignalBuffer.eof(0))
                    return
                self._terminated.wait(self.rescan_interval)
                continue
            rate, offset, blocks, disconnected = self._stream(
                dev, offset, blocks
            )
            dev.stop()
            dev.close()
            self.samples_lost += dev.samples_lost
            done = self.terminated or (
                self.duration_blocks and blocks >= self.duration_blocks
            )
            if self._stop_flush and not done:
                # Stop command mid-session (QtControl DecoderControlEvent
                # Stop -> receiver task stop): end the decode session with an
                # in-band EOF, then idle at the top of the loop until Start
                self._stop_flush = False
                self.iq_stream.next(
                    SignalBuffer.eof(rate, SignalType.SIGNAL_TYPE_RADIO_IQ)
                )
                self.raw_stream.next(SignalBuffer.eof(rate))
                continue
            if disconnected and self.reconnect and not done:
                # in-band EOF then rescan, like the reference's hotplug loop
                self.iq_stream.next(
                    SignalBuffer.eof(rate, SignalType.SIGNAL_TYPE_RADIO_IQ)
                )
                self.raw_stream.next(SignalBuffer.eof(rate))
                self.update_status("absent")
                self._terminated.wait(self.rescan_interval)
                continue
            break
        self.iq_stream.next(SignalBuffer.eof(rate, SignalType.SIGNAL_TYPE_RADIO_IQ))
        self.raw_stream.next(SignalBuffer.eof(rate))
        self.update_status(
            "complete", samples=self.throughput.total, lost=self.samples_lost
        )

    def _attach(self):
        """Resolve the device for this session: the fixed ident, or (in
        discovery mode) the first device any scanned scheme enumerates
        (RadioDeviceTask.cpp:194-246).  None while nothing is plugged in."""
        from ..hw.device import DeviceFactory
        from ..hw.sdr import NativeSdrDevice

        if self._scan is None:
            return NativeSdrDevice(self.ident)
        for scheme in self._scan:
            for ident in DeviceFactory.enumerate(scheme):
                dev = DeviceFactory.new_instance(ident)
                if dev is not None:
                    return dev
        return None

    def _stream(self, dev, offset: int, blocks: int):
        """Configure + drain one device session; returns (rate, offset,
        blocks, disconnected)."""
        from ..dsp.magnitude import level_average
        from ..hw.device import (
            PARAM_GAIN_MODE,
            PARAM_GAIN_VALUE,
            PARAM_SAMPLE_RATE,
            PARAM_SAMPLE_TYPE,
        )

        for param, value in self.config.items():
            dev.set(param, value)
        rate = int(dev.get(PARAM_SAMPLE_RATE, 10_000_000))
        dev.start()
        self.update_status("streaming")
        # the driver reports its delivered sample format (PARAM_SAMPLE_TYPE:
        # every RadioDevice driver in the native table answers this); all
        # network/USB radio hardware delivers interleaved IQ, so default to
        # IQ when a (third-party) driver doesn't answer — only the synthetic
        # loopback is magnitude-native
        stype = dev.get(PARAM_SAMPLE_TYPE)
        if stype is not None:
            is_iq = int(stype) == SignalType.SIGNAL_TYPE_RADIO_IQ
        else:
            is_iq = not dev.ident.startswith("loopback")
        # software AGC (RadioDeviceTask.cpp:660-686): every gain-capable
        # driver unless the gain mode was explicitly set to manual (1)
        agc_on = self.config.get(PARAM_GAIN_MODE) != 1
        disconnected = False
        while not self.terminated:
            self.handle_commands()
            if self._stop_flush:  # Stop command: end this capture session
                break
            block = dev.read(timeout=0.25)
            if block is None:
                continue
            if len(block) == 0:  # driver EOF (e.g. server disconnect)
                disconnected = True
                break
            if is_iq:
                iq = SignalBuffer(
                    block, rate, offset,
                    signal_type=SignalType.SIGNAL_TYPE_RADIO_IQ,
                )
                mag, power, self._avrg = iq_to_magnitude(
                    block.reshape(-1, 2), self._avrg
                )
                self.iq_stream.next(iq)
            else:
                mag = block
                self._avrg = level_average(mag, self._avrg)
            raw = SignalBuffer(
                mag, rate, offset,
                signal_type=SignalType.SIGNAL_TYPE_RADIO_SAMPLES,
            )
            offset += len(mag)
            self.raw_stream.next(raw)
            if agc_on:
                step = self.agc.update(self._avrg, offset, len(mag))
                if step is not None:
                    dev.set(PARAM_GAIN_VALUE, step)
            self.throughput.update(len(block))
            blocks += 1
            if self.duration_blocks and blocks >= self.duration_blocks:
                break
        return rate, offset, blocks, disconnected


def _mask_device(device):
    """The device of a mask-frontend decoder (DeviceUnavailable when CUDA
    is asked for and there is no card), with the kernel library built
    and loaded when it is a card, so no live session waits on nvcc."""
    from ..dsp.cuda_channels import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..kernels.fused import library

        library()
    return dev


class RadioDecoderTask(Task):
    """radio.signal.raw -> radio.decoder.frame (RadioDecoderTask parity).

    Truly streaming: each block feeds the incremental decoder and completed
    frames are published immediately.  The ``radio.decoder.command``
    subject carries the reference's control plane
    (RadioDecoderTask.cpp:92-151): Start/Stop gate whether signal buffers
    are consumed, Query resolves the current config, Configure merge-
    patches decoder settings (enables, powerLevelThreshold, per-tech
    protocol thresholds — configDecoder :207-366 semantics) applied from
    the next decode session on.

    ``frontend="mask"`` takes the detect triggers from the fused kernels
    on ``device`` (``cpu``: their plain versions) through _MaskLiveDecoder;
    the device is resolved and the kernel library built here, so a
    missing card raises DeviceUnavailable before any capture starts.
    There is no host fallback: an error of the device path ends the task
    with Executor's "error" status.

    Spans (runtime/trace), each with the block's sample ``offset``:
    ``task.queued`` (the block's put to its get in ``signal_queue``),
    ``task.feed`` (the decoder's feed) and ``task.publish`` (its frames
    on ``radio.decoder.frame``)."""

    def __init__(self, window: int | None = 1 << 20, frontend: str = "host",
                 device="cuda", **decoder_kwargs):
        # window 2^20 (vs 2^21): still 2.8x the ~370k FWT lookback at
        # 10 MS/s, but halves the dense-array footprint, so a session
        # reaches steady state sooner
        super().__init__("worker.RadioDecoder", "radio.decoder")
        self.window = window
        self.frontend = frontend
        self.device = _mask_device(device) if frontend == "mask" else device
        self.decoder_kwargs = decoder_kwargs
        self.frame_stream = Subject.name("radio.decoder.frame")
        self.signal_queue: "queue.Queue[SignalBuffer]" = queue.Queue()
        # the put time of each queued block, in queue order (the queue
        # holds the blocks alone)
        self._put_times: deque = deque()
        self._put_lock = threading.Lock()
        Subject.name("radio.signal.raw").subscribe(self._put, replay=False)

    def _put(self, buf: SignalBuffer) -> None:
        with self._put_lock:
            self._put_times.append(time.perf_counter())
            self.signal_queue.put(buf)

    # ------------------------------------------------------------- commands

    def _command_snapshot(self) -> dict:
        """Current config as the reference's Query/status JSON shape
        (RadioDecoderTask.cpp:405-455)."""
        from ..core.thresholds import DecoderThresholds

        kw = self.decoder_kwargs
        th = kw.get("thresholds") or DecoderThresholds()
        proto = {}
        for name in ("nfca", "nfcb", "nfcf", "nfcv"):
            tech = th.for_tech(name)
            proto[name] = {
                "enabled": bool(kw.get(f"enable_{name}", True)),
                "correlationThreshold": tech.correlation,
                "minimumModulationDeep": tech.min_modulation_deep,
                "maximumModulationDeep": tech.max_modulation_deep,
            }
        return {
            "status": "streaming" if self.streaming else "idle",
            "powerLevelThreshold": kw.get("power_level_threshold", 0.01),
            "protocol": proto,
        }

    def _on_configure(self, cfg: dict):
        """Configure merge-patch (configDecoder semantics)."""
        from ..core.thresholds import DecoderThresholds

        kw = self.decoder_kwargs
        if "powerLevelThreshold" in cfg:
            kw["power_level_threshold"] = float(cfg["powerLevelThreshold"])
        proto = cfg.get("protocol") or {}
        for name in ("nfca", "nfcb", "nfcf", "nfcv"):
            sect = proto.get(name)
            if sect and "enabled" in sect:
                kw[f"enable_{name}"] = bool(sect["enabled"])
        # copy before merging: the incoming DecoderThresholds may be shared
        # with the caller (CLI args object, another task)
        th = kw.get("thresholds") or DecoderThresholds()
        kw["thresholds"] = th.copy().merge_protocol_config(proto)

    def _on_clear(self):
        # RadioDecoderTask.cpp:368-375: drop pending signal buffers without
        # ending the session (the in-progress decoder state is untouched;
        # the next buffer resumes at its absolute offset)
        with self._put_lock:
            for _ in range(self._drain(self.signal_queue)):
                if self._put_times:
                    self._put_times.popleft()

    def _make_decoder(self, sample_rate: int):
        from .streaming import StreamingNfcDecoder

        if self.frontend == "mask":
            return _MaskLiveDecoder(
                sample_rate, window=self.window, device=self.device,
                **self.decoder_kwargs,
            )
        return StreamingNfcDecoder(
            sample_rate, window=self.window, **self.decoder_kwargs
        )

    def run(self):
        self.update_status("streaming")
        dec = None

        def flush(d):
            if d is not None:
                for frame in d.finish():
                    self.frame_stream.next(frame)
            # per-stream boundary sentinel (in-band EOF re-published on the
            # frame stream); the task itself stays alive for the next
            # session, like the reference worker (RadioDecoderTask.cpp runs
            # until a Stop command, not until an EOF buffer)
            self.frame_stream.next(None)

        while not self.terminated:
            self.handle_commands()
            if self._stop_flush:  # Stop ends the current decode session
                self._stop_flush = False
                if dec is not None:
                    flush(dec)
                    dec = None
            try:
                buf = self.signal_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if self._put_times:
                trace.record("task.queued", self._put_times.popleft(),
                             time.perf_counter(), offset=int(buf.offset))
            if not buf.valid:  # in-band EOF: flush + await the next session
                flush(dec)
                dec = None
                self.update_status("idle", frames=self.throughput.total)
                continue
            if not self.streaming:
                continue  # Stopped: drop buffers (RadioDecoderTask.cpp:76-79)
            if dec is None:
                dec = self._make_decoder(buf.sample_rate)
            off = int(buf.offset)
            with trace.span("task.feed", offset=off):
                frames = dec.feed(np.asarray(buf.data, np.float32))
            with trace.span("task.publish", offset=off, frames=len(frames)):
                for frame in frames:
                    self.frame_stream.next(frame)
            self.throughput.update(buf.elements)
        if dec is not None:
            flush(dec)
        self.update_status("complete", frames=self.throughput.total)


class _MaskLiveDecoder:
    """StreamingNfcDecoder-shaped adapter over a one-stream CudaStreamFarm
    in mask mode: live blocks stage into pipelined chained kernel
    dispatches (device-compacted detect triggers), the host walks with
    bit-exact native conditioning.  k_chunks=8 keeps frame latency at
    ~0.05 s/MS-of-rate while still amortizing the dispatch floor; with one
    stream the farm's policy splits each window after the first into 4
    segments.

    Constructing it resolves ``device`` (DeviceUnavailable without a card)
    and builds the kernel library.  An error of a dispatch (a build,
    launch or CUDA error on the farm's IO thread) is raised by the feed()
    or finish() that drains its window; there is no host fallback."""

    def __init__(self, sample_rate: int, window: int | None = None,
                 device="cuda", **decoder_kwargs):
        from .farm import CudaStreamFarm

        self._farm = CudaStreamFarm(
            1, sample_rate, fetch="mask", window=window, k_chunks=8,
            device=_mask_device(device), **decoder_kwargs,
        )

    def feed(self, block: np.ndarray) -> list[Frame]:
        block = np.asarray(block, np.float32)
        return self._farm.feed(block[None, :])[0]

    def finish(self) -> list[Frame]:
        return self._farm.finish()[0]


class LogicDecoderTask(Task):
    """logic.signal.raw -> logic.decoder.frame (LogicDecoderTask parity).

    Truly streaming: each logic block feeds the incremental ISO7816 decoder
    and completed frames publish immediately (the live DSLogic case)."""

    def __init__(self, channel_map=None):
        super().__init__("worker.LogicDecoder", "logic.decoder")
        # probe->role mapping (the reference LogicDecoderTask's channel
        # config): dict io/clk/rst/vcc or [io, clk, rst, vcc] probe indices
        self.channel_map = channel_map
        self.frame_stream = Subject.name("logic.decoder.frame")
        self.signal_queue: "queue.Queue[SignalBuffer]" = queue.Queue()
        Subject.name("logic.signal.raw").subscribe(
            self.signal_queue.put, replay=False
        )

    def _on_configure(self, params: dict):
        """LogicDecoderTask Configure parity: the channel map (applies from
        the next decode session)."""
        if "channelMap" in params:
            self.channel_map = params["channelMap"]

    def _command_snapshot(self) -> dict:
        return {
            "status": "streaming" if self.streaming else "idle",
            "channelMap": self.channel_map,
        }

    def _on_clear(self):
        # LogicDecoderTask.cpp:117 Clear parity: drop pending logic buffers
        self._drain(self.signal_queue)

    def run(self):
        from .logic_decoder import StreamingIsoDecoder

        self.update_status("streaming")
        dec: StreamingIsoDecoder | None = None

        def flush(d):
            if d is not None:
                for frame in d.finish():
                    self.frame_stream.next(frame)
            self.frame_stream.next(None)

        while not self.terminated:
            self.handle_commands()
            if self._stop_flush:  # Stop ends the current decode session
                self._stop_flush = False
                if dec is not None:
                    flush(dec)
                    dec = None
            try:
                buf = self.signal_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if not buf.valid:  # in-band EOF: flush + await the next session
                flush(dec)
                dec = None
                self.update_status("idle")
                continue
            if not self.streaming:
                continue  # Stopped: drop buffers (reference gating)
            block = np.asarray(buf.data, np.float32)
            if dec is None:
                dec = StreamingIsoDecoder(
                    buf.sample_rate, channels=block.shape[1],
                    channel_map=self.channel_map,
                )
                self.update_status("streaming")
            for frame in dec.feed(block):
                self.frame_stream.next(frame)
            self.throughput.update(len(block))
        if dec is not None:
            flush(dec)
        self.update_status("complete")


class ResamplingTask(Task):
    """radio/logic raw -> adaptive.signal (SignalResamplingTask parity)."""

    def __init__(self):
        super().__init__("worker.SignalResampling", "adaptive")
        from ..dsp.resample import resample_logic, resample_radio

        self._radio = resample_radio
        self._logic = resample_logic
        self.out = Subject.name("adaptive.signal")
        self.q: "queue.Queue[SignalBuffer]" = queue.Queue()
        Subject.name("radio.signal.raw").subscribe(self.q.put, replay=False)
        Subject.name("logic.signal.raw").subscribe(self.q.put, replay=False)

    def run(self):
        self.update_status("streaming")
        while not self.terminated:
            self.handle_commands()
            try:
                buf = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            if not buf.valid:
                # forward the in-band boundary so downstream consumers (the
                # TRZ writer) can order themselves against this stream; the
                # resampler itself is stateless
                self.out.next(buf)
                continue
            if buf.signal_type == SignalType.SIGNAL_TYPE_RADIO_SAMPLES:
                vals, offs = self._radio(buf.data)
                self.out.next(
                    SignalBuffer(
                        np.stack([vals, offs], axis=-1),
                        buf.sample_rate,
                        buf.offset,
                        signal_type=SignalType.SIGNAL_TYPE_RADIO_SIGNAL,
                    )
                )
            elif buf.signal_type == SignalType.SIGNAL_TYPE_LOGIC_SAMPLES:
                for ch, (vals, offs) in self._logic(buf.data).items():
                    self.out.next(
                        SignalBuffer(
                            np.stack([vals, offs], axis=-1),
                            buf.sample_rate,
                            buf.offset,
                            signal_type=SignalType.SIGNAL_TYPE_LOGIC_SIGNAL,
                            stream_id=ch,
                        )
                    )
            self.throughput.update(buf.elements)
        self.update_status("complete")


class DeviceMonitorTask(Task):
    """1 Hz device hotplug scan (RadioDeviceTask.cpp:167-246 refresh loop):
    re-enumerates the factory registry, publishes attach/detach status."""

    def __init__(self, pattern: str = "*", interval: float = 1.0):
        super().__init__("worker.DeviceMonitor", "device.monitor")
        from ..hw.device import DeviceFactory

        self.factory = DeviceFactory
        self.pattern = pattern
        self.interval = interval
        self.present: set[str] = set()

    def run(self):
        self.update_status("scanning")
        while not self.terminated:
            self.handle_commands()
            found = set(self.factory.enumerate(self.pattern))
            for ident in sorted(found - self.present):
                self.update_status("attached", device=ident)
            for ident in sorted(self.present - found):
                self.update_status("detached", device=ident)
            self.present = found
            self._terminated.wait(self.interval)


class LogicSourceTask(Task):
    """Replay source for logic captures: WAV -> logic.signal.raw
    (LogicDeviceTask parity; live DSLogic/Sipeed capture plugs in behind the
    same Device interface)."""

    def __init__(self, device: RecordDevice, block: int = 65536):
        super().__init__("worker.LogicSource", "logic.receiver")
        self.device = device
        self.block = block
        self.raw_stream = Subject.name("logic.signal.raw")

    def run(self):
        self.device.open("read")
        self.update_status("streaming")
        rate = 0
        while not self.terminated and not self.device.is_eof():
            self.handle_commands()
            if not self.streaming:  # Stop command: pause the replay
                self._stop_flush = False
                self._terminated.wait(0.05)
                continue
            buf = self.device.read(self.block)
            rate = buf.sample_rate
            self.raw_stream.next(buf)
            self.throughput.update(buf.elements)
        self.raw_stream.next(
            SignalBuffer.eof(rate, SignalType.SIGNAL_TYPE_LOGIC_SAMPLES)
        )
        self.update_status("complete", samples=self.throughput.total)


class LiveLogicSourceTask(Task):
    """Live logic-analyzer capture -> logic.signal.raw.

    Drives a native-bridge logic driver (logicloop / logictcp — the
    stream-mode network transport shaped like DSLogicDevice.cpp:247-412's
    bulk capture; a libusb DSLogic/Sipeed backend slots behind the same
    driver table) via hw.sdr.NativeSdrDevice.  Blocks arrive as interleaved
    probe floats and publish as [N, channels] logic sample buffers, feeding
    the streaming ISO7816 decoder (LogicDeviceTask parity)."""

    def __init__(self, ident: str, config: dict | None = None,
                 duration_blocks: int | None = None):
        super().__init__("worker.LiveLogicSource", "logic.receiver")
        self.ident = ident
        self.config = dict(config or {})
        self.duration_blocks = duration_blocks
        self.raw_stream = Subject.name("logic.signal.raw")
        self.samples_lost = 0

    def run(self):
        from ..hw.device import PARAM_CHANNEL_COUNT, PARAM_SAMPLE_RATE
        from ..hw.sdr import NativeSdrDevice

        rate = 0
        dev = NativeSdrDevice(self.ident)
        if not dev.open():
            self.update_status("absent")
            self.raw_stream.next(
                SignalBuffer.eof(0, SignalType.SIGNAL_TYPE_LOGIC_SAMPLES)
            )
            return
        for param, value in self.config.items():
            dev.set(param, value)
        rate = int(dev.get(PARAM_SAMPLE_RATE, 10_000_000))
        channels = int(dev.get(PARAM_CHANNEL_COUNT, 4))
        dev.start()
        self.update_status("streaming")
        offset = 0
        blocks = 0
        carry = np.empty(0, np.float32)
        while not self.terminated:
            self.handle_commands()
            if self._stop_flush:  # Stop command: end this capture session
                break
            block = dev.read(timeout=0.25)
            if block is None:
                continue
            if len(block) == 0:  # driver EOF (server disconnect)
                break
            if len(carry):
                block = np.concatenate([carry, block])
            usable = len(block) - len(block) % channels
            carry = block[usable:]
            if not usable:
                continue
            data = block[:usable].reshape(-1, channels)
            buf = SignalBuffer(
                data, rate, offset,
                signal_type=SignalType.SIGNAL_TYPE_LOGIC_SAMPLES,
            )
            offset += len(data)
            self.raw_stream.next(buf)
            self.throughput.update(len(data))
            blocks += 1
            if self.duration_blocks and blocks >= self.duration_blocks:
                break
        dev.stop()
        dev.close()
        self.samples_lost = dev.samples_lost
        self.raw_stream.next(
            SignalBuffer.eof(rate, SignalType.SIGNAL_TYPE_LOGIC_SAMPLES)
        )
        self.update_status(
            "complete", samples=self.throughput.total, lost=self.samples_lost
        )


class FourierTask(Task):
    """Latest IQ block -> signal.fft spectrum bins (FourierProcessTask
    parity; the reference refreshes at ~100 fps, here per published block).

    nfclab's task with the spectrum on ``device``: a missing card raises
    DeviceUnavailable here, before any capture starts, and a failed
    ``process`` ends the task with Executor's "error" status (no host
    fallback)."""

    def __init__(self, length: int = 1024, bandwidth: float = 10e6,
                 device="cuda"):
        super().__init__("worker.FourierProcess", "fourier")
        from ..dsp.spectrum import SpectrumProcessor

        self.processor = SpectrumProcessor(length=length, bandwidth=bandwidth,
                                           device=device)
        self.out = Subject.name("signal.fft")
        self.q: "queue.Queue[SignalBuffer]" = queue.Queue()
        Subject.name("radio.signal.iq").subscribe(self.q.put, replay=False)

    def run(self):
        self.update_status("streaming")
        while not self.terminated:
            self.handle_commands()
            try:
                buf = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            if not buf.valid:
                continue  # stream boundary; keep serving the next session
            data = np.asarray(buf.data, np.float32)
            if data.ndim == 1:
                # live sources publish interleaved IQ; the processor takes
                # [N, 2] pairs
                data = data[: len(data) // 2 * 2].reshape(-1, 2)
            need = self.processor.length * max(
                1, int(buf.sample_rate / self.processor.bandwidth)
            )
            if len(data) < need:
                continue
            mag = self.processor.process(data, buf.sample_rate)
            self.out.next(
                SignalBuffer(
                    mag,
                    buf.sample_rate,
                    buf.offset,
                    signal_type=SignalType.SIGNAL_TYPE_FFT_BIN,
                )
            )
            self.throughput.update(buf.elements)
        self.update_status("complete")


class SignalStorageTask(Task):
    """Record raw streams to WAV (SignalStorageTask write path parity)."""

    def __init__(self, path: str, source_subject: str = "radio.signal.raw"):
        super().__init__("worker.SignalStorage", "recorder")
        self.device = RecordDevice(path)
        self.q: "queue.Queue[SignalBuffer]" = queue.Queue()
        Subject.name(source_subject).subscribe(self.q.put, replay=False)

    def run(self):
        self.device.open("write")
        self.update_status("recording")
        while not self.terminated:
            self.handle_commands()
            try:
                buf = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            if buf.valid:
                self.device.write(buf)
                self.throughput.update(buf.elements)
            # EOF buffers are stream boundaries: recording runs until Stop
            # (terminate), like the reference's recorder worker
        while True:  # drain what was already queued before the Stop
            try:
                buf = self.q.get_nowait()
            except queue.Empty:
                break
            if buf.valid:
                self.device.write(buf)
                self.throughput.update(buf.elements)
        self.device.close()
        self.update_status("complete", samples=self.throughput.total)


class TraceStorageTask(Task):
    """Accumulate frames + adaptive streams, write a TRZ on completion
    (TraceStorageTask write path parity)."""

    def __init__(self, path: str, sample_range: tuple[int, int] | None = None):
        super().__init__("worker.TraceStorage", "storage")
        self.path = path
        self.sample_range = sample_range
        self.frames: list[Frame] = []
        self.signals: list[SignalBuffer] = []
        self._done = threading.Event()
        self._adaptive_done = threading.Event()
        Subject.name("radio.decoder.frame").subscribe(
            self._on_frame, replay=False
        )
        Subject.name("logic.decoder.frame").subscribe(
            self._on_frame, replay=False
        )
        Subject.name("adaptive.signal").subscribe(
            self._on_signal, replay=False
        )

    def _on_frame(self, frame):
        if frame is None:
            self._done.set()
        else:
            self.frames.append(frame)

    def _on_clear(self):
        # TraceStorageTask.cpp:242-252 clearQueue: drop the accumulated
        # frame + signal caches (a following Write starts empty)
        self.frames.clear()
        self.signals.clear()

    def _on_signal(self, buf):
        if buf.valid:
            self.signals.append(buf)
        else:
            self._adaptive_done.set()

    def _write(self, path: str, sample_range=None):
        from ..io.trz import SignalStream, write_trace

        streams = []
        for buf in self.signals:
            kind = (
                "logic"
                if buf.signal_type == SignalType.SIGNAL_TYPE_LOGIC_SIGNAL
                else "radio"
            )
            streams.append(
                SignalStream(
                    buf.stream_id,
                    buf.sample_rate,
                    kind,
                    (buf.data[:, 1] + buf.offset).astype(np.int64),
                    buf.data[:, 0],
                    buf.offset,
                )
            )
        write_trace(path, self.frames, streams, sample_range=sample_range)

    def _on_configure(self, params: dict):
        """Write command parity (TraceStorageTask doWriteFile flow,
        QtControl -> Event{Write,{fileName,sampleStart,sampleEnd}}): dump
        whatever has accumulated to the given file immediately."""
        if "fileName" in params:
            rng = None
            if "sampleStart" in params and "sampleEnd" in params:
                rng = (int(params["sampleStart"]), int(params["sampleEnd"]))
            self._write(params["fileName"], rng)

    def _command_snapshot(self) -> dict:
        return {
            "status": "accumulating",
            "frames": len(self.frames),
            "signals": len(self.signals),
        }

    def run(self):
        self.update_status("accumulating")
        # wait for the frame-stream EOF, then for the adaptive-stream
        # boundary (the resampler runs on its own thread, so frame EOF alone
        # doesn't order us after the render stream); terminate always wins
        # and writes whatever accumulated (reference Stop semantics).
        # Commands (mid-capture Write snapshots) are served throughout.
        while not self.terminated and not self._done.wait(0.1):
            self.handle_commands()
        while not self.terminated and not self._adaptive_done.wait(0.1):
            self.handle_commands()
        self._write(self.path, self.sample_range)
        self.update_status("complete", frames=len(self.frames))
        # worker semantics: stay alive serving Write commands (snapshot
        # saves) until Stop/terminate, like the reference storage task
        while not self.terminated:
            self.handle_commands()
            self._terminated.wait(0.05)


class TraceReplayTask(Task):
    """Read a TRZ trace and republish its contents: frames on
    ``storage.frame``, adaptive signal streams on ``storage.signal``
    (TraceStorageTask.cpp:258-320 read path, readFrameEntry :364-455).

    In-band EOF (None on the frame stream, invalid buffer on the signal
    stream) marks the end of the replay, mirroring the live pipeline's
    stream-boundary convention."""

    def __init__(self, path: str):
        super().__init__("worker.TraceReplay", "storage")
        self.path = path
        self.frame_stream = Subject.name("storage.frame")
        self.signal_stream = Subject.name("storage.signal")

    def run(self):
        from ..io.trz import read_trace

        self.update_status("reading")
        frames, streams = read_trace(self.path)
        rate = 0
        for frame in frames:
            if self.terminated:
                break
            self.handle_commands()
            self.frame_stream.next(frame)
            rate = frame.sample_rate or rate
        for s in streams:
            if self.terminated:
                break
            kind_type = (
                SignalType.SIGNAL_TYPE_LOGIC_SIGNAL
                if s.kind == "logic"
                else SignalType.SIGNAL_TYPE_RADIO_SIGNAL
            )
            self.signal_stream.next(
                SignalBuffer(
                    np.stack(
                        [s.values, (s.offsets - s.start_offset).astype(np.float32)],
                        axis=-1,
                    ),
                    s.sample_rate,
                    s.start_offset,
                    signal_type=kind_type,
                    stream_id=s.stream_id,
                )
            )
            rate = s.sample_rate or rate
        self.frame_stream.next(None)
        self.signal_stream.next(SignalBuffer.eof(rate))
        self.update_status(
            "complete", frames=len(frames), signals=len(streams)
        )


def run_radio_pipeline(wav_path: str, timeout: float = 300.0) -> list[Frame]:
    """Wire up source -> decoder (+resampler) and run to completion; the
    app-rx orchestration in one call."""
    Subject.clear_registry()
    frames: list[Frame] = []
    done = threading.Event()

    def collect(frame):
        if frame is None:
            done.set()
        else:
            frames.append(frame)

    source = RadioSourceTask(RecordDevice(wav_path))
    decoder = RadioDecoderTask()
    resampler = ResamplingTask()
    Subject.name("radio.decoder.frame").subscribe(collect, replay=False)

    executor = Executor()
    executor.submit(decoder)
    executor.submit(resampler)
    executor.submit(source)
    done.wait(timeout)
    executor.shutdown()
    return frames
