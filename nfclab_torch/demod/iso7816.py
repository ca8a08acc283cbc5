"""ISO7816 contact smart-card decoder (4-channel logic capture).

Event-driven parity with tech/Iso7816.cpp: VCC/RST line events
(Iso7816.cpp:271-307), clock frequency measurement from CLK falling edges
(:312-344), RST-rise reset detection (:349-362), SYNC/ETU measurement from the
first two IO falling edges (:367-437), TS convention detection (:442-489), ATR
parse with TA/TB/TC interface bytes driving Fi/Di, guard/waiting-time updates
(:494-559, 1028-1169), PPS (:1174-1230), and T=0 TPDU / T=1 block framing
(:705-796) over the start-bit + 8-data + parity character decoder (:801-947).

Channel layout (Iso7816.cpp:39-42): IO=0, CLK=1, RST=2, VCC=3.

The host walk visits only: channel edges (sparse), every-10th CLK falling
edge (frequency estimation groups), and scheduled sync/guard times — all
per-sample reads in the reference are no-ops elsewhere.
"""

from __future__ import annotations

import numpy as np

from ..core.frame import Frame, FrameFlags, FramePhase, FrameTech, FrameType
from ..protocol.crc import crc16_ccitt
from .common import check_parity

# search mode states (Iso7816.cpp:33-37)
SEARCH_MODE_RESET = 0
SEARCH_MODE_SYNC = 1
SEARCH_MODE_TS = 2
SEARCH_MODE_ATR = 3

CH_IO, CH_CLK, CH_RST, CH_VCC = 0, 1, 2, 3

ATR_MIN_LEN, ATR_MAX_LEN = 2, 32
ATR_TA_MASK, ATR_TB_MASK, ATR_TC_MASK, ATR_TD_MASK = 0x10, 0x20, 0x40, 0x80
PROTO_T0, PROTO_T1 = 0, 1
PPS_MIN_LEN, PPS_MAX_LEN, PPS_CMD = 3, 6, 0xFF
PPS_PPS1_MASK, PPS_PPS2_MASK, PPS_PPS3_MASK = 0x10, 0x20, 0x40
T0_TPDU_MIN_LEN, T0_TPDU_MAX_LEN = 5, 255
T0_CLA, T0_INS, T0_P1, T0_P2, T0_P3, T0_PROC = 0, 1, 2, 3, 4, 5
T1_PRO_LEN, T1_LRC_LEN, T1_CRC_LEN = 3, 1, 2
T1_NAD, T1_PCB, T1_LEN, T1_INF = 0, 1, 2, 3
GT_THRESHOLD = 0.5
WT_THRESHOLD = 0.5

# symbol/character results (Iso7816.cpp:88-104)
IncompleteSymbol = -1
TimeoutSymbol = 0
FullSymbol = 1
PowerLowSymbol = 8
ResetLowSymbol = 9

DirectConvention = 1
InverseConvention = 2

ResultInvalid = -1
ResultSuccess = 0
ResultFailed = 1

LRCCode = 0
CRCCode = 1

# ISO7816-3 tables (lab/iso/Iso.h:28-67)
ISO_7816_FI_DEF = 1
ISO_7816_DI_DEF = 1
ISO_7816_IFSC_DEF = 254
ISO_7816_CGT_DEF = 12
ISO_7816_CWT_DEF = 9600
ISO_7816_BGT_DEF = 22
ISO_7816_BWT_DEF = 9600
ISO_7816_EGT_DEF = 0
ISO_FI_TABLE = (0, 372, 558, 744, 1116, 1488, 1860, 0, 0, 512, 768, 1024, 1536, 2048, 0, 0)
ISO_DI_TABLE = (0, 1, 2, 4, 8, 16, 32, 64, 12, 20, 0, 0, 0, 0, 0, 0)
ISO_FM_TABLE = (0, 5000000, 6000000, 8000000, 12000000, 5000000, 5000000, 0, 0,
                12000000, 12000000, 12000000, 12000000, 12000000, 0, 0)
ISO_CWT_TABLE = tuple(1 << n for n in range(16))
ISO_BWT_TABLE = (960, 1920, 3840, 7680, 15360, 30720, 61440, 122880, 245760, 491520, 0, 0, 0, 0, 0, 0)


class _Protocol:
    """IsoProtocolStatus (Iso7816.cpp:128-201)."""

    def __init__(self):
        self.protocol_type = 0
        self.error_code_type = LRCCode
        self.symbol_convention = DirectConvention
        self.clock_frequency = 0.0
        self.symbols_per_second = 0.0
        self.elementary_time_unit = 0.0
        self.elementary_time = 0.0
        self.elementary_half_time = 0.0
        self.frequency_factor_index = ISO_7816_FI_DEF
        self.frequency_factor = 372
        self.baud_rate_factor_index = ISO_7816_DI_DEF
        self.baud_rate_factor = 1
        self.extra_guard_time_units = 0
        self.extra_guard_time = 0
        self.character_guard_time_units = 0
        self.character_guard_time = 0
        self.character_waiting_time_units = 0
        self.character_waiting_time = 0
        self.block_guard_time_units = 0
        self.block_guard_time = 0
        self.block_waiting_time_units = 0
        self.block_waiting_time = 0
        self.maximum_information_size = 0
        self.protocol_parameters_change = False


class _Modulation:
    """IsoModulationStatus (IsoTech.h:136-152)."""

    def __init__(self):
        self.search_mode_state = SEARCH_MODE_RESET
        self.search_start_time = 0
        self.search_end_time = 0
        self.search_sync_time = 0
        self.sync_start_time = 0
        self.sync_end_time = 0
        self.clock_edge_time = 0
        self.clock_counter = 0
        self.clock_frequency = 0.0


class _Character:
    """IsoCharacterStatus (IsoTech.h:169-177)."""

    def __init__(self):
        self.bits = 0
        self.data = 0
        self.flags = 0
        self.parity = 0
        self.start = 0
        self.end = 0

    def reset(self):
        self.__init__()


class _FrameState:
    """IsoFrameStatus (IsoTech.h:182-196)."""

    def __init__(self):
        self.last_command = 0
        self.frame_type = 0
        self.symbol_rate = 0
        self.frame_start = 0
        self.frame_end = 0
        self.frame_flags = 0
        self.guard_time = 0.0
        self.waiting_time = 0.0
        self.data = bytearray()


class Iso7816Decoder:
    """One-shot ISO7816 decoder over a [N, channels] logic capture."""

    def __init__(self, sample_rate: int, stream_time: float = 0.0):
        self.sample_rate = sample_rate
        self.sample_time = 1.0 / float(sample_rate)
        self.stream_time = stream_time
        self.frames: list[Frame] = []

        self.mod = _Modulation()
        self.protocol = _Protocol()
        self.char = _Character()
        self.frame = _FrameState()
        self.locked = False
        # symbol status
        self.sym_value = 0
        self.sym_data = 0
        self.sym_start = 0
        self.sym_end = 0
        self._clk_ptr = 0  # next unconsumed falling clock edge (monotonic)

        self.reset_modulation()

    # ------------------------------------------------------------- lifecycle

    def reset_modulation(self):
        """Iso7816.cpp:1330-1373."""
        self.mod = _Modulation()
        self.char = _Character()
        self.frame = _FrameState()
        self.protocol = _Protocol()
        self.locked = False
        self.protocol.maximum_information_size = ISO_7816_IFSC_DEF
        self.protocol.character_guard_time_units = ISO_7816_CGT_DEF
        self.protocol.character_waiting_time_units = ISO_7816_CWT_DEF
        self.protocol.extra_guard_time_units = ISO_7816_EGT_DEF
        self.protocol.block_guard_time_units = ISO_7816_BGT_DEF
        self.protocol.block_waiting_time_units = ISO_7816_BWT_DEF
        self.update_protocol(0.0, ISO_7816_FI_DEF, ISO_7816_DI_DEF)
        self.frame.frame_type = int(FrameType.IsoATRFrame)
        self.frame.guard_time = self.protocol.character_guard_time
        self.frame.waiting_time = self.protocol.character_waiting_time

    def update_protocol(self, clock_frequency: float, fi: int, di: int):
        """Iso7816.cpp:1378-1435."""
        p = self.protocol
        rate = float(self.sample_rate)
        fn = float(ISO_FI_TABLE[fi])
        dn = float(ISO_DI_TABLE[di])
        p.clock_frequency = clock_frequency
        p.frequency_factor = int(fn)
        p.baud_rate_factor = int(dn)
        p.frequency_factor_index = fi
        p.baud_rate_factor_index = di
        if clock_frequency > 0:
            p.elementary_time = rate * fn / (dn * clock_frequency)
            p.elementary_half_time = p.elementary_time / 2
            p.elementary_time_unit = p.elementary_time * self.sample_time
            p.character_guard_time = int(round(p.elementary_time * p.character_guard_time_units))
            p.character_waiting_time = int(round(p.elementary_time * p.character_waiting_time_units))
            p.block_guard_time = int(round(p.elementary_time * p.block_guard_time_units))
            p.block_waiting_time = int(round(p.elementary_time * p.block_waiting_time_units))
            p.extra_guard_time = int(round(p.elementary_time * p.extra_guard_time_units))
            self.frame.guard_time = p.character_guard_time - GT_THRESHOLD * p.elementary_time
            self.frame.waiting_time = p.character_waiting_time + WT_THRESHOLD * p.elementary_time
            self.frame.symbol_rate = int(1.0 / p.elementary_time_unit)
        else:
            p.elementary_time = 0.0
            p.elementary_half_time = 0.0
            p.elementary_time_unit = 0.0
            p.character_guard_time = 0
            p.character_waiting_time = 0
            p.block_guard_time = 0
            p.block_waiting_time = 0
            p.extra_guard_time = 0
        p.protocol_parameters_change = False

    # ------------------------------------------------------------ main decode

    def bind(self, data, edge, n, io_edges, io_falls, line_edges, clk_falls):
        """(Re)bind the dense arrays + event indices the walker reads.
        FSM state (mod/char/frame/protocol and the consumed-clock pointer)
        is untouched, so the streaming decoder can rebind after each feed
        and resume the walk (indices must be append-only extensions)."""
        self._data = data
        self._edge = edge
        self._n = n
        self._io_edges = io_edges
        self._io_falls = io_falls
        self._line_edges = line_edges
        self._clk_falls = clk_falls

    def emit_line_events(self, line_edges) -> None:
        """detectLines over the given edge clocks (independent of FSM
        state; the streaming decoder passes only the new tail's edges)."""
        for t in line_edges:
            self._emit_line_events(int(t))

    def walk(self, t: int) -> int:
        """Run the event walk from clock t to the end of the bound arrays;
        returns the resume clock (== n when all events consumed)."""
        n = self._n
        while t < n:
            t = self._step_from(t)
        return t

    def decode(self, samples: np.ndarray) -> list[Frame]:
        """samples: [N, channels>=4] float (logic levels)."""
        n, ch = samples.shape
        data = samples.astype(np.float32)
        edge = np.zeros_like(data)
        edge[1:] = data[1:] - data[:-1]

        rst_edges = np.flatnonzero(edge[:, CH_RST] != 0)
        vcc_edges = np.flatnonzero(edge[:, CH_VCC] != 0)
        self.bind(
            data,
            edge,
            n,
            np.flatnonzero(edge[:, CH_IO] != 0),
            np.flatnonzero(edge[:, CH_IO] < 0),
            np.union1d(rst_edges, vcc_edges),
            np.flatnonzero(edge[:, CH_CLK] < 0),
        )

        # emit line events in one pass (detectLines, independent of FSM state)
        self.emit_line_events(self._line_edges)

        self.walk(0)
        # frames are emitted in walk order; line events were pre-emitted, so
        # order by start time for a stable stream
        self.frames.sort(key=lambda f: (f.sample_start, f.sample_end))
        return self.frames

    def _emit_line_events(self, t: int):
        """detectLines (Iso7816.cpp:271-307)."""
        for chn, low_t, high_t in (
            (CH_VCC, FrameType.IsoVccLow, FrameType.IsoVccHigh),
            (CH_RST, FrameType.IsoRstLow, FrameType.IsoRstHigh),
        ):
            e = self._edge[t, chn]
            if e != 0:
                f = Frame(
                    tech_type=int(FrameTech.IsoAnyTech),
                    frame_type=int(low_t if e < 0 else high_t),
                    frame_phase=int(FramePhase.IsoAnyPhase),
                    sample_start=t,
                    sample_end=t,
                    sample_rate=self.sample_rate,
                )
                f.time_start = t / self.sample_rate
                f.time_end = f.time_start
                f.date_time = self.stream_time + f.time_start
                self.frames.append(f)

    def _advance_clock(self, t: int):
        """detectClock (Iso7816.cpp:312-344): consume CLK falling edges up to
        and including clock t, updating the frequency estimate per 10-edge
        group."""
        falls = self._clk_falls
        m = self.mod
        while self._clk_ptr < len(falls) and falls[self._clk_ptr] <= t:
            te = int(falls[self._clk_ptr])
            self._clk_ptr += 1
            m.clock_counter += 1
            if m.clock_counter == 10:
                denom = te - m.clock_edge_time
                clock_value = (
                    float(self.sample_rate * m.clock_counter) / denom
                    if denom
                    else 0.0
                )
                drift = (
                    abs(clock_value - m.clock_frequency) / m.clock_frequency
                    if m.clock_frequency
                    else float("inf")
                )
                m.clock_counter = 0
                m.clock_edge_time = te
                m.clock_frequency = clock_value
                if drift < 0.05 and self.protocol.clock_frequency > 0:
                    drift = (
                        abs(m.clock_frequency - self.protocol.clock_frequency)
                        / self.protocol.clock_frequency
                    )
                    if drift > 0.05:
                        self.update_protocol(
                            m.clock_frequency,
                            self.protocol.frequency_factor_index,
                            self.protocol.baud_rate_factor_index,
                        )

    @staticmethod
    def _next_in(idx: np.ndarray, t: int) -> int | None:
        i = np.searchsorted(idx, t)
        return int(idx[i]) if i < len(idx) else None

    def _step_from(self, t: int) -> int:
        """Process the next event at or after clock t; returns next clock."""
        m = self.mod
        n = self._n

        # determine the next sample where anything can happen
        cands = []
        state = m.search_mode_state if not self.locked else None

        if not self.locked:
            if state == SEARCH_MODE_RESET:
                c = self._next_in(self._line_edges, t)
                if c is None:
                    return n  # no more line activity: nothing can start
                cands.append(c)
            elif state == SEARCH_MODE_SYNC:
                for c in (
                    self._next_in(self._io_falls, t),
                    self._next_in(self._line_edges, t),
                ):
                    if c is not None:
                        cands.append(c)
                if m.search_start_time > t:
                    # reference still checks line drops below searchStart;
                    # line edges are events, so just clamp other candidates
                    pass
                if not cands:
                    return n
            else:  # TS / ATR / locked decode share the symbol machinery
                cands = self._symbol_event_cands(t)
                if not cands:
                    return n
        else:
            cands = self._symbol_event_cands(t)
            if not cands:
                return n

        te = min(cands)
        if te >= n:
            return n

        # the clock estimator runs per sample in the reference; advancing it
        # to te before processing preserves update ordering (its protocol
        # updates only ever happen at CLK falling edges)
        self._advance_clock(te)

        if not self.locked:
            if m.search_mode_state == SEARCH_MODE_RESET:
                self._detect_reset(te)
            elif m.search_mode_state == SEARCH_MODE_SYNC:
                self._detect_sync(te)
            elif m.search_mode_state == SEARCH_MODE_TS:
                self._detect_ts(te)
            elif m.search_mode_state == SEARCH_MODE_ATR:
                self._detect_atr(te)
        else:
            self._decode_stream(te)
        return te + 1

    def _symbol_event_cands(self, t: int) -> list[int]:
        m = self.mod
        cands = []
        for c in (
            self._next_in(self._io_falls, t),
            self._next_in(self._line_edges, t),
        ):
            if c is not None:
                cands.append(c)
        if m.search_sync_time and m.search_sync_time >= t:
            cands.append(int(m.search_sync_time))
        if m.search_end_time and m.search_end_time >= t:
            cands.append(int(m.search_end_time))
        # a start-bit search below search_start_time is gated; the io-fall
        # events cover it (the gate re-checks)
        return cands

    # ----------------------------------------------------------- detect modes

    def _detect_reset(self, t: int):
        """Iso7816.cpp:349-362."""
        if (
            self._data[t, CH_VCC] > 0
            and self._edge[t, CH_RST] > 0
            and t > 2
        ):
            self.mod.search_mode_state = SEARCH_MODE_SYNC
            self.mod.search_start_time = t

    def _detect_sync(self, t: int):
        """Iso7816.cpp:367-437."""
        m = self.mod
        if self._edge[t, CH_VCC] < 0 or self._edge[t, CH_RST] < 0:
            self.reset_modulation()
            return
        if t < m.search_start_time:
            return
        data_fall = self._edge[t, CH_IO] < 0
        if not m.sync_start_time:
            if data_fall:
                m.sync_start_time = t
            return
        if not m.sync_end_time:
            if data_fall:
                m.sync_end_time = t
            else:
                return
        else:
            return

        # SYNC pattern complete (Iso7816.cpp:404-436)
        self.char.start = m.sync_start_time
        self.char.end = 0
        self.char.bits = 3
        self.char.data = 3
        self.char.flags = 0
        self.char.parity = 0
        self.protocol.symbol_convention = DirectConvention

        etu_samples = (m.sync_end_time - m.sync_start_time) / 3.0
        clock_frequency = (self.sample_rate / etu_samples) * (
            ISO_FI_TABLE[ISO_7816_FI_DEF] / ISO_DI_TABLE[ISO_7816_DI_DEF]
        )
        self.update_protocol(clock_frequency, ISO_7816_FI_DEF, ISO_7816_DI_DEF)

        self.frame.guard_time = (
            self.protocol.character_guard_time
            - GT_THRESHOLD * self.protocol.elementary_time
        )
        self.frame.waiting_time = (
            self.protocol.character_waiting_time
            + WT_THRESHOLD * self.protocol.elementary_time
        )

        m.search_mode_state = SEARCH_MODE_TS
        m.search_sync_time = int(
            self.char.start
            + self.protocol.elementary_time * 3
            + self.protocol.elementary_half_time
        )
        m.search_start_time = 0
        m.search_end_time = 0

    def _detect_ts(self, t: int):
        """Iso7816.cpp:442-489."""
        if self._decode_character(t) == 1:  # FullCharacter
            ch = self.char
            if ch.data == 0x3B:
                self.protocol.symbol_convention = DirectConvention
            elif ch.data == 0x03:
                ch.data = 0x3F
                ch.parity = 0 if ch.parity else 1
                self.protocol.symbol_convention = InverseConvention
            else:
                self.reset_modulation()
                return

            self.mod.search_mode_state = SEARCH_MODE_ATR
            fs = self.frame
            fs.frame_type = int(FrameType.IsoATRFrame)
            fs.frame_start = ch.start
            fs.frame_end = ch.end
            fs.frame_flags = 0
            fs.data = bytearray([ch.data])
            fs.symbol_rate = int(1.0 / self.protocol.elementary_time_unit)
            self.char.reset()

    def _detect_atr(self, t: int):
        """Iso7816.cpp:494-559."""
        result = ResultInvalid
        r = self._decode_character(t)
        if r == 1:  # FullCharacter; falls through to completion check
            ch = self.char
            fs = self.frame
            fs.frame_end = ch.end
            fs.frame_flags |= ch.flags
            fs.data.append(ch.data)
            self.char.reset()
        if r in (1, 0):  # FullCharacter or TimeoutCharacter
            fs = self.frame
            result = self._is_atr(bytes(fs.data))
            if result == ResultSuccess:
                frame = self._build_frame(int(FrameType.IsoATRFrame))
                self.process(frame)
                self.frames.append(frame)
                self.locked = True
                return
        if result == ResultFailed:
            self.reset_modulation()

    # --------------------------------------------------------------- decoding

    def _decode_stream(self, t: int):
        """decodeStreamT0/T1 (Iso7816.cpp:588-700)."""
        if self.protocol.protocol_type == PROTO_T0:
            done = self._decode_frame_t0(t)
        elif self.protocol.protocol_type == PROTO_T1:
            done = self._decode_frame_t1(t)
        else:
            return
        if done:
            fs = self.frame
            if len(fs.data) == 0:
                self.frame = _FrameState()
                self.frame.frame_type = int(FrameType.IsoExchangeFrame)
                self.mod = _Modulation()
                self.char.reset()
                # keep decode lock (reference keeps bitrate set)
                return
            frame = self._build_frame(fs.frame_type)
            self.process(frame)
            self.frames.append(frame)

    def _build_frame(self, frame_type: int) -> Frame:
        fs = self.frame
        f = Frame(
            tech_type=int(FrameTech.Iso7816Tech),
            frame_type=frame_type,
            frame_rate=fs.symbol_rate,
            frame_flags=fs.frame_flags,
            data=bytes(fs.data),
            sample_start=fs.frame_start,
            sample_end=fs.frame_end,
            sample_rate=self.sample_rate,
        )
        f.time_start = fs.frame_start / self.sample_rate
        f.time_end = fs.frame_end / self.sample_rate
        f.date_time = self.stream_time + f.time_start
        return f

    def _decode_frame_t0(self, t: int) -> bool:
        """Iso7816.cpp:705-754."""
        result = self._decode_character(t)
        if result == 1:
            fs = self.frame
            ch = self.char
            if not fs.frame_start:
                fs.frame_start = ch.start
            fs.frame_end = ch.end
            fs.frame_flags |= ch.flags
            fs.data.append(ch.data)
            self.char.reset()

            if self._is_pps(bytes(fs.data)) == ResultSuccess:
                fs.frame_type = int(
                    FrameType.IsoResponseFrame
                    if self.protocol.protocol_parameters_change
                    else FrameType.IsoRequestFrame
                )
                return True
            if self._is_tpdu(bytes(fs.data)) == ResultSuccess:
                fs.frame_type = int(FrameType.IsoExchangeFrame)
                return True
            # reset search end to keep waiting (Iso7816.cpp:738-743)
            self.mod.search_end_time = 0
            if len(fs.data) == self.protocol.maximum_information_size:
                return True
            return False
        return result == 0  # TimeoutCharacter completes the frame

    def _decode_frame_t1(self, t: int) -> bool:
        """Iso7816.cpp:759-796."""
        result = self._decode_character(t)
        if result == 1:
            fs = self.frame
            ch = self.char
            if not fs.frame_start:
                fs.frame_start = ch.start
            fs.frame_end = ch.end
            fs.frame_flags |= ch.flags
            fs.data.append(ch.data)
            self.char.reset()

            if self._is_pps(bytes(fs.data)) == ResultSuccess:
                return True
            if self._is_block(bytes(fs.data)) == ResultSuccess:
                return True
            epilogue = (
                T1_LRC_LEN
                if self.protocol.error_code_type == LRCCode
                else T1_CRC_LEN
            )
            if len(fs.data) >= (
                self.protocol.maximum_information_size + T1_PRO_LEN + epilogue
            ):
                return True
            return False
        return result == 0

    def _decode_character(self, t: int) -> int:
        """Iso7816.cpp:801-887; returns 1=Full, 0=Timeout, -1=Incomplete,
        9=ResetLow."""
        sym = self._decode_symbol(t)
        if sym == FullSymbol:
            ch = self.char
            m = self.mod
            p = self.protocol
            if ch.bits == 0:
                ch.data = 0
                ch.start = self.sym_start
            elif ch.bits < 9:
                if p.symbol_convention == DirectConvention:
                    ch.data |= self.sym_data << (ch.bits - 1)
                else:
                    ch.data |= self.sym_data << (8 - ch.bits)
            elif ch.bits == 9:
                ch.end = self.sym_end
                ch.parity = self.sym_data
                if check_parity(ch.data, ch.parity):
                    ch.flags |= FrameFlags.ParityError

            if ch.bits >= 9:
                if p.protocol_type == PROTO_T0:
                    if ch.bits == 10:
                        m.search_start_time = int(ch.start + self.frame.guard_time)
                        m.search_end_time = int(ch.start + self.frame.waiting_time)
                        m.search_sync_time = 0
                        if self.sym_value:
                            return 1
                        self.char.reset()
                        return -1
                elif p.protocol_type == PROTO_T1:
                    m.search_start_time = int(ch.start + self.frame.guard_time)
                    m.search_end_time = int(ch.start + self.frame.waiting_time)
                    m.search_sync_time = 0
                    return 1

            ch.bits += 1
            m.search_sync_time = int(
                ch.start + p.elementary_time * ch.bits + p.elementary_half_time
            )
            return -1

        if sym == ResetLowSymbol:
            return 9
        if sym == TimeoutSymbol:
            return 0
        return -1

    def _decode_symbol(self, t: int) -> int:
        """Iso7816.cpp:892-947."""
        m = self.mod
        p = self.protocol
        if self._edge[t, CH_VCC] < 0:
            self.reset_modulation()
            return PowerLowSymbol
        if self._edge[t, CH_RST] < 0:
            self.reset_modulation()
            return ResetLowSymbol
        if m.search_start_time and t < m.search_start_time:
            return IncompleteSymbol
        if m.search_end_time and t >= m.search_end_time:
            return TimeoutSymbol
        if not m.search_sync_time and self._edge[t, CH_IO] < 0:
            m.search_start_time = 0
            m.search_end_time = 0
            m.search_sync_time = int(t + p.elementary_half_time)
        if not m.search_sync_time or t < m.search_sync_time:
            return IncompleteSymbol

        data_value = 1 if self._data[t, CH_IO] > 0 else 0
        self.sym_value = data_value
        self.sym_start = int(m.search_sync_time - p.elementary_half_time)
        self.sym_end = int(m.search_sync_time + p.elementary_half_time)
        self.sym_data = (
            data_value
            if p.symbol_convention == DirectConvention
            else 1 - data_value
        )
        return FullSymbol

    # ----------------------------------------------------------------- checks

    @staticmethod
    def _is_atr(atr: bytes) -> int:
        """Iso7816.cpp:1440-1475.  The reference reads from a zero-filled
        1024-byte frame buffer, so out-of-range interface bytes read as 0."""
        size = len(atr)
        if size < ATR_MIN_LEN:
            return ResultInvalid
        if size > ATR_MAX_LEN:
            return ResultFailed

        def rd(j):
            return atr[j] if j < size else 0

        i, n, c = 1, 1, 0
        hb = rd(n) & 0x0F
        n += 1
        while True:
            if rd(i) & ATR_TA_MASK:
                n += 1
            if rd(i) & ATR_TB_MASK:
                n += 1
            if rd(i) & ATR_TC_MASK:
                n += 1
            if not (rd(i) & ATR_TD_MASK):
                break
            i = n
            n += 1
            c |= rd(i) & 0x0F
            if not (n < size):
                break
        if size < n + hb + (1 if c else 0):
            return ResultInvalid
        return ResultSuccess

    @staticmethod
    def _is_pps(pps: bytes) -> int:
        """Iso7816.cpp:1480-1506."""
        size = len(pps)
        if size < PPS_MIN_LEN or size > PPS_MAX_LEN:
            return ResultInvalid
        if pps[0] != PPS_CMD:
            return ResultInvalid
        n = PPS_MIN_LEN
        if pps[1] & PPS_PPS1_MASK:
            n += 1
        if pps[1] & PPS_PPS2_MASK:
            n += 1
        if pps[1] & PPS_PPS3_MASK:
            n += 1
        if size != n:
            return ResultInvalid
        ck = 0
        for b in pps:
            ck ^= b
        return ResultSuccess if not ck else ResultFailed

    @staticmethod
    def _is_tpdu(tpdu: bytes) -> int:
        """Iso7816.cpp:1511-1544."""
        size = len(tpdu)
        if size < T0_TPDU_MIN_LEN:
            return ResultInvalid
        if tpdu[T0_CLA] == PPS_CMD:
            return ResultInvalid
        if (tpdu[T0_INS] & 0xF0) in (0x60, 0x90):
            return ResultInvalid
        offset = T0_PROC
        while offset < size:
            b = tpdu[offset]
            if b == 0x60:
                offset += 1
                continue
            if (b & 0xF0) in (0x60, 0x90):
                return ResultSuccess if size == offset + 2 else ResultInvalid
            if b == tpdu[T0_INS]:
                offset += tpdu[T0_P3]
            elif b == (tpdu[T0_INS] ^ 0xFF):
                offset += 1
            offset += 1
        return ResultInvalid

    def _is_block(self, block: bytes) -> int:
        """Iso7816.cpp:1549-1565."""
        epilogue = (
            T1_LRC_LEN if self.protocol.error_code_type == LRCCode else T1_CRC_LEN
        )
        size = len(block)
        if size < T1_PRO_LEN + epilogue:
            return ResultInvalid
        if block[T1_NAD] == PPS_CMD:
            return ResultInvalid
        if size != T1_PRO_LEN + block[T1_LEN] + epilogue:
            return ResultInvalid
        return ResultSuccess

    @staticmethod
    def _check_lrc(data: bytes) -> bool:
        """Iso7816.cpp:1588-1598 — xor of all bytes after the first."""
        rc = 0
        for b in data[1:]:
            rc ^= b
        return not rc

    @staticmethod
    def _check_crc(data: bytes) -> bool:
        """Iso7816.cpp:1603-1614 — ISO13239 (same as CRC_B)."""
        size = len(data)
        if size < 3:
            return False
        crc = (~crc16_ccitt(data, 0, size - 2, 0xFFFF, True)) & 0xFFFF
        res = data[size - 2] | (data[size - 1] << 8)
        return res == crc

    # ---------------------------------------------------------------- process

    def process(self, frame: Frame):
        """Iso7816.cpp:952-1023."""
        while True:
            if self.process_atr(frame):
                break
            if self.process_pps(frame):
                break
            if self.process_tpdu(frame):
                break
            if self.process_iblock(frame):
                break
            if self.process_rblock(frame):
                break
            if self.process_sblock(frame):
                break
            break

        p = self.protocol
        fs = self.frame
        if p.protocol_type == PROTO_T1:
            if frame.frame_type == int(FrameType.IsoRequestFrame):
                fs.frame_type = int(FrameType.IsoResponseFrame)
            elif frame.frame_type == int(FrameType.IsoResponseFrame):
                fs.frame_type = int(FrameType.IsoRequestFrame)

        if p.extra_guard_time_units == 255:
            if p.protocol_type == PROTO_T0:
                fs.guard_time = (12 - GT_THRESHOLD) * p.elementary_time
            else:
                fs.guard_time = (11 - GT_THRESHOLD) * p.elementary_time
        else:
            fs.guard_time = p.character_guard_time - GT_THRESHOLD * p.elementary_time
        fs.waiting_time = p.character_waiting_time + WT_THRESHOLD * p.elementary_time

        m = self.mod
        m.search_start_time = 0
        m.search_end_time = 0
        m.search_sync_time = 0

        fs.frame_start = 0
        fs.frame_end = 0
        fs.frame_flags = 0
        fs.data = bytearray()
        fs.symbol_rate = int(1.0 / p.elementary_time_unit) if p.elementary_time_unit else 0

    def process_atr(self, frame: Frame) -> bool:
        """Iso7816.cpp:1028-1169."""
        if frame.frame_type != int(FrameType.IsoATRFrame):
            return False
        data = frame.data
        p = self.protocol
        update_parameters = False

        def rd(j):
            return data[j] if j < len(data) else 0

        i, n, k, c = 1, 2, 1, 0
        while True:
            if rd(i) & ATR_TA_MASK:
                ta = rd(n)
                n += 1
                if k == 3:
                    p.maximum_information_size = ta
            if rd(i) & ATR_TB_MASK:
                tb = rd(n)
                n += 1
                if k == 3:
                    bwi = tb >> 4
                    cwi = tb & 0x0F
                    update_parameters = True
                    p.block_waiting_time_units = 11 + ISO_BWT_TABLE[bwi]
                    p.character_waiting_time_units = 11 + ISO_CWT_TABLE[cwi]
            if rd(i) & ATR_TC_MASK:
                tc = rd(n)
                n += 1
                dn = ISO_DI_TABLE[p.baud_rate_factor_index]
                if k == 1:
                    update_parameters = True
                    p.extra_guard_time_units = tc
                elif k == 2:
                    update_parameters = True
                    p.character_waiting_time_units = (
                        tc * 960 * dn if tc > 0 else ISO_7816_CWT_DEF
                    )
                elif k == 3:
                    # TC3 selects the T=1 error detection code (bit 0: 0 =
                    # LRC, 1 = CRC).  The reference logs the selection but
                    # never applies it (Iso7816.cpp:1098-1102), leaving its
                    # CRC epilogue path (Iso7816.cpp:1603-1614) dead;
                    # applying it makes T=1 CRC captures decode correctly
                    p.error_code_type = CRCCode if tc & 1 else LRCCode
            if not (rd(i) & ATR_TD_MASK):
                break
            k += 1
            i = n
            n += 1
            c |= rd(i) & 0x0F
            if not (n < len(data)):
                break

        if c:
            if not self._check_lrc(frame.data):
                frame.set_flags(FrameFlags.CrcError)
        if update_parameters:
            self.update_protocol(
                p.clock_frequency, p.frequency_factor_index, p.baud_rate_factor_index
            )
        return True

    def process_pps(self, frame: Frame) -> bool:
        """Iso7816.cpp:1174-1230."""
        if not frame.data or frame.data[0] != PPS_CMD:
            return False
        p = self.protocol
        i = 1
        pps0 = frame.data[i]
        i += 1
        if pps0 & PPS_PPS1_MASK:
            pps1 = frame.data[i]
            i += 1
            fi = pps1 >> 4
            di = pps1 & 0x0F
            if p.protocol_parameters_change:
                p.protocol_type = pps0 & 0x0F
                self.frame.frame_type = int(
                    FrameType.IsoExchangeFrame
                    if p.protocol_type == PROTO_T0
                    else FrameType.IsoRequestFrame
                )
                self.update_protocol(p.clock_frequency, fi, di)
            else:
                p.protocol_parameters_change = True
        return True

    def process_tpdu(self, frame: Frame) -> bool:
        """Iso7816.cpp:1235-1248."""
        if frame.frame_type != int(FrameType.IsoExchangeFrame):
            return False
        if len(frame.data) < T0_TPDU_MIN_LEN or len(frame.data) > T0_TPDU_MAX_LEN:
            return False
        if frame.data[T0_CLA] == PPS_CMD:
            return False
        return True

    def _block_common(self, frame: Frame):
        """Iso7816.cpp:1314-1325."""
        if self.protocol.error_code_type == LRCCode:
            if not self._check_lrc(frame.data):
                frame.set_flags(FrameFlags.CrcError)
        else:
            if not self._check_crc(frame.data):
                frame.set_flags(FrameFlags.CrcError)

    def process_iblock(self, frame: Frame) -> bool:
        if frame.frame_type not in (
            int(FrameType.IsoRequestFrame),
            int(FrameType.IsoResponseFrame),
        ):
            return False
        if len(frame.data) < 2 or frame.data[1] & 0x80:
            return False
        self._block_common(frame)
        return True

    def process_rblock(self, frame: Frame) -> bool:
        if frame.frame_type not in (
            int(FrameType.IsoRequestFrame),
            int(FrameType.IsoResponseFrame),
        ):
            return False
        if len(frame.data) < 2 or (frame.data[1] & 0xC0) != 0x80:
            return False
        self._block_common(frame)
        return True

    def process_sblock(self, frame: Frame) -> bool:
        if frame.frame_type not in (
            int(FrameType.IsoRequestFrame),
            int(FrameType.IsoResponseFrame),
        ):
            return False
        if len(frame.data) < 2 or (frame.data[1] & 0xC0) != 0xC0:
            return False
        self._block_common(frame)
        return True
