"""Mock SDR servers for the port's live-capture tests and chip_smoke.py.

Copies of ``MockRtlTcpServer`` and ``MockSpyServer`` of
tests/test_sdr_bridge.py (the rtl_tcp and Airspy SpyServer protocols the
native bridge speaks), with no nfclab import and one option added:
``rate`` paces the sends at that many samples (IQ pairs) a second, as a
radio delivers them; None sends as fast as the socket takes them.

- ``iq_int16(x)``: a magnitude capture as SpyServer INT16 IQ, I = the
  signal, Q = 0 (its magnitude is |I| / 32768).
- ``iq_uint8(x)``: the same as rtl_tcp's unsigned 8-bit IQ, Q at mid-scale.

``MockLogicTcpServer`` is a copy of tests/test_logic_capture.py's (the
logictcp logic-analyzer wire format), unchanged.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

import numpy as np


def iq_int16(x: np.ndarray) -> np.ndarray:
    iq = np.zeros(2 * len(x), np.int16)
    iq[0::2] = np.clip(np.round(np.asarray(x, np.float64) * 32768.0),
                       -32768, 32767).astype(np.int16)
    return iq


def iq_uint8(x: np.ndarray) -> np.ndarray:
    iq = np.empty(2 * len(x), np.uint8)
    iq[0::2] = np.clip(np.round(np.asarray(x) * 127.5 + 127.5), 0,
                       255).astype(np.uint8)
    iq[1::2] = 128  # (128 - 127.5) / 127.5 ~ 0
    return iq


class _Pacer:
    """Sleeps until `n` samples are due at `rate` samples/s from the first
    call; never sleeps when rate is None."""

    def __init__(self, rate):
        self.rate = rate
        self.t0 = None

    def wait(self, n: int):
        if self.rate is None:
            return
        if self.t0 is None:
            self.t0 = time.perf_counter()
        due = self.t0 + n / self.rate - time.perf_counter()
        if due > 0:
            time.sleep(due)


class MockRtlTcpServer:
    """Minimal rtl_tcp server: header, command capture, deterministic IQ."""

    def __init__(self, n_bytes: int = 3 * 65536, payload=None,
                 min_commands: int = 4, rate: float | None = None):
        self.commands = []
        self.min_commands = min_commands
        self.payload = (
            payload
            if payload is not None
            else (np.arange(n_bytes) % 256).astype(np.uint8)
        )
        self.n_bytes = len(self.payload)
        self.pacer = _Pacer(rate)
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        conn, _ = self.sock.accept()
        conn.settimeout(5.0)
        # header: magic + tuner type (R820T=5) + gain count
        conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
        # stream payload in chunks, polling for commands throughout (the
        # whole payload may fit in kernel buffers before the client even
        # issues its set-param commands)
        conn.setblocking(False)
        sent = 0
        pending = b""
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                pending += conn.recv(1024)
            except (BlockingIOError, InterruptedError):
                pass
            while len(pending) >= 5:
                op = pending[0]
                arg = struct.unpack(">I", pending[1:5])[0]
                self.commands.append((op, arg))
                pending = pending[5:]
            if sent < self.n_bytes:
                self.pacer.wait(sent // 2)  # two bytes an IQ sample
                try:
                    sent += conn.send(
                        self.payload[sent : sent + 16384].tobytes()
                    )
                except (BlockingIOError, InterruptedError):
                    time.sleep(0.01)
            elif len(self.commands) >= self.min_commands:
                break
            else:
                time.sleep(0.01)
        # keep the socket open briefly so the client drains everything
        time.sleep(0.5)
        try:
            conn.close()
        except OSError:
            pass


class MockSpyServer:
    """Minimal Airspy SpyServer: HELLO handshake -> DEVICE_INFO +
    CLIENT_SYNC, then INT16 IQ messages once streaming is enabled.
    All little-endian, per the protocol (see sdr_bridge.cpp spyserver).
    ``chunk`` is the int16 values of one message (two an IQ sample), at
    most 2**19 (the client's 1 MiB message limit)."""

    MSG_DEVICE_INFO = 0
    MSG_CLIENT_SYNC = 1
    MSG_INT16_IQ = 101

    def __init__(self, payload_i16: np.ndarray, max_rate: int = 10_000_000,
                 chunk: int = 8192, rate: float | None = None):
        self.payload = payload_i16.astype(np.int16)
        self.max_rate = max_rate
        self.chunk = chunk
        self.pacer = _Pacer(rate)
        self.settings = []
        self.hello = None
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _msg(self, mtype: int, body: bytes) -> bytes:
        return struct.pack("<5I", 0x02000000 | 1700, mtype, 0, 0,
                           len(body)) + body

    def _serve(self):
        conn, _ = self.sock.accept()
        conn.settimeout(10.0)
        # CMD_HELLO: header + version + client name
        cmd, blen = struct.unpack("<2I", self._recv(conn, 8))
        body = self._recv(conn, blen)
        assert cmd == 0
        self.hello = (struct.unpack("<I", body[:4])[0], body[4:].decode())
        info = struct.pack(
            "<12I",
            1,            # DeviceType = AIRSPY_ONE
            0xA1B2C3D4,   # serial
            self.max_rate,
            self.max_rate,
            8,            # decimation stages
            1,            # gain stages
            21,           # max gain index
            24_000_000, 1_800_000_000,  # frequency range
            12,           # resolution bits
            0,            # minimum IQ decimation
            0,            # forced IQ format
        )
        conn.sendall(self._msg(self.MSG_DEVICE_INFO, info))
        sync = struct.pack("<9I", 1, 10, 27_120_000, 27_120_000, 0, 0, 0, 0, 0)
        conn.sendall(self._msg(self.MSG_CLIENT_SYNC, sync))

        # settings until STREAMING_ENABLED=1
        streaming = False
        deadline = time.time() + 20
        while not streaming and time.time() < deadline:
            cmd, blen = struct.unpack("<2I", self._recv(conn, 8))
            body = self._recv(conn, blen)
            if cmd == 2 and blen == 8:
                setting, value = struct.unpack("<2I", body)
                self.settings.append((setting, value))
                if setting == 1 and value == 1:
                    streaming = True
        # stream the payload as INT16 IQ messages
        raw = self.payload.tobytes()
        for off in range(0, len(raw), self.chunk * 2):
            self.pacer.wait(off // 4)  # four bytes an IQ sample
            conn.sendall(
                self._msg(self.MSG_INT16_IQ, raw[off : off + self.chunk * 2])
            )
        time.sleep(0.5)  # let the client drain before the close
        try:
            conn.close()
        except OSError:
            pass

    @staticmethod
    def _recv(conn, n):
        buf = b""
        while len(buf) < n:
            part = conn.recv(n - len(buf))
            if not part:
                raise ConnectionError("client closed")
            buf += part
        return buf


class MockLogicTcpServer:
    """Serves the logictcp wire format: 12-byte header ("LGC0" + u8
    channels + 3 reserved + u32 BE sample rate), then one packed byte per
    sample (bit i = probe i), then an orderly close."""

    def __init__(self, capture: np.ndarray, sample_rate: int):
        bits = (capture > 0.5).astype(np.uint8)
        packed = np.zeros(len(bits), np.uint8)
        for c in range(bits.shape[1]):
            packed |= bits[:, c] << c
        self.payload = packed.tobytes()
        self.channels = capture.shape[1]
        self.sample_rate = sample_rate
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        conn, _ = self.sock.accept()
        conn.settimeout(10.0)
        conn.sendall(
            b"LGC0"
            + bytes([self.channels, 0, 0, 0])
            + struct.pack(">I", self.sample_rate)
        )
        conn.sendall(self.payload)
        conn.shutdown(socket.SHUT_WR)
        try:
            conn.recv(1)  # wait for the client to finish
        except OSError:
            pass
        conn.close()
        self.sock.close()
