"""Trace analysis: command detection and frame annotation.

Capability parity with ``tools/py_nfclab`` (README.md:1-60): protocol command
detection over decoded frames, with both a stateless best-effort detector and
a stateful pass that reuses the full protocol parser chain (so responses are
named from their preceding request, which the stateless tool cannot do).
"""

from __future__ import annotations

from ..core.frame import Frame, FrameTech, FrameType
from ..protocol.parser import ProtocolParser

# stateless NFC-A command table
_NFCA_CMDS = {
    0x26: "REQA",
    0x52: "WUPA",
    0x50: "HLTA",
    0x93: "SEL1",
    0x95: "SEL2",
    0x97: "SEL3",
    0xE0: "RATS",
    0x60: "AUTH_A",
    0x61: "AUTH_B",
    0x6A: "VASUP-A",
    0x30: "READ",
    0xA0: "WRITE",
    0xA2: "WRITE4",
    0xC0: "DECREMENT",
    0xC1: "INCREMENT",
    0xC2: "RESTORE",
    0xB0: "TRANSFER",
    0x1A: "AUTH_ULC",
    0x1B: "PWD_AUTH",
    0x39: "READ_CNT",
    0x3A: "FAST_READ",
    0x3C: "READ_SIG",
    0x4B: "VCSL",
    0x60 | 0x80: "GET_VERSION",  # 0xE0 conflicts with RATS; RATS wins below
}

_NFCV_CMDS = {
    # standard (ISO/IEC 15693-3)
    0x01: "INVENTORY",
    0x02: "STAY_QUIET",
    0x20: "READ_SINGLE",
    0x21: "WRITE_SINGLE",
    0x22: "LOCK_BLOCK",
    0x23: "READ_MULTIPLE",
    0x24: "WRITE_MULTIPLE",
    0x25: "SELECT",
    0x26: "RESET_TO_READY",
    0x27: "WRITE_AFI",
    0x28: "LOCK_AFI",
    0x29: "WRITE_DSFID",
    0x2A: "LOCK_DSFID",
    0x2B: "GET_SYSTEM_INFO",
    0x2C: "GET_SECURITY_STATUS",
    0x2D: "FAST_READ_MULTIPLE",
    # extended addressing
    0x30: "EXT_READ_SINGLE",
    0x31: "EXT_WRITE_SINGLE",
    0x32: "EXT_LOCK_SINGLE",
    0x33: "EXT_READ_MULTIPLE",
    0x34: "EXT_WRITE_MULTIPLE",
    0x35: "AUTHENTICATE",
    0x39: "CHALLENGE",
    0x3A: "READ_BUFFER",
    0x3B: "EXT_GET_SYSTEM_INFO",
    0x3C: "EXT_GET_SECURITY_STATUS",
    0x3D: "FAST_EXT_READ_MULTIPLE",
    # vendor fast commands
    0xC0: "FAST_READ_SINGLE",
    0xC1: "WRITE_CONFIGURATION",
    0xC2: "PICK_RANDOM_UID",
    0xC3: "FAST_READ_MULTIPLE_BLOCKS",
}

# NFC-V response error codes (ISO 15693-3 table 4)
_NFCV_ERRORS = {
    0x01: "NOT_SUPPORTED",
    0x02: "NOT_RECOGNIZED",
    0x0F: "UNKNOWN",
    0x10: "BLOCK_NOT_AVAILABLE",
    0x11: "ALREADY_LOCKED",
    0x12: "LOCKED",
    0x13: "NOT_PROGRAMMED",
    0x14: "NOT_LOCKED",
}

# FeliCa command codes (JIS X 6319-4 / Sony spec numbering)
_FELICA_CMDS = {
    0x00: "POLLING",
    0x02: "REQUEST_SERVICE",
    0x04: "REQUEST_RESPONSE",
    0x06: "READ_WITHOUT_ENCRYPTION",
    0x08: "WRITE_WITHOUT_ENCRYPTION",
    0x0A: "SEARCH_SERVICE_CODE",
    0x0C: "REQUEST_SYSTEM_CODE",
    0x10: "AUTHENTICATION1",
    0x12: "AUTHENTICATION2",
    0x14: "READ_SECURE",
    0x16: "WRITE_SECURE",
    0x3C: "REQUEST_SPEC_VERSION",
    0x3E: "RESET_MODE",
}


def detect_command(frame: Frame) -> str | None:
    """Stateless best-effort command detection (py_nfclab detect_command
    parity)."""
    data = frame.data
    if not data:
        return None
    tech = int(frame.tech_type)
    poll = frame.frame_type in (
        int(FrameType.NfcPollFrame),
        int(FrameType.IsoExchangeFrame),
        int(FrameType.IsoRequestFrame),
    )
    if tech == int(FrameTech.NfcATech) and poll:
        b = data[0]
        if (b & 0xF0) == 0xD0:
            return "PPS"
        if (b & 0xE2) == 0x02 and len(data) > 4:
            return "I-BLOCK"
        if (b & 0xE6) == 0xA2 and len(data) == 3:
            return "R-BLOCK"
        if (b & 0xC7) == 0xC0 and len(data) == 4:
            return "S-BLOCK"
        return _NFCA_CMDS.get(b)
    if tech == int(FrameTech.NfcBTech) and poll:
        if data[0] == 0x05:
            return "WUPB" if len(data) > 2 and data[2] & 0x08 else "REQB"
        if data[0] == 0x1D:
            return "ATTRIB"
        if data[0] == 0x50:
            return "HLTB"
        return None
    if tech == int(FrameTech.NfcFTech) and len(data) > 1:
        return _FELICA_CMDS.get(data[1]) if poll else None
    if tech == int(FrameTech.NfcVTech):
        if poll and len(data) > 1:
            return _NFCV_CMDS.get(data[1])
        if not poll and len(data) >= 1 and data[0] & 0x01:
            # response error flag set; name the error code when present
            err = _NFCV_ERRORS.get(data[1]) if len(data) > 1 else None
            return f"ERROR({err})" if err else "ERROR"
    if tech == int(FrameTech.Iso7816Tech):
        if frame.frame_type == int(FrameType.IsoATRFrame):
            return "ATR"
        if data[0] == 0xFF:
            return "PPS"
        if frame.frame_type == int(FrameType.IsoExchangeFrame):
            return "TPDU"
    return None


def annotate_frames(frames: list[Frame]) -> list[dict]:
    """Stateful annotation: full parser pass naming requests AND responses."""
    parser = ProtocolParser()
    out = []
    for frame in frames:
        node = parser.parse(frame)
        name = node.name if node is not None and node.name else None
        if name is None:
            name = detect_command(frame)
        out.append(
            {
                "time": frame.time_start,
                "tech": FrameTech(frame.tech_type).name
                if frame.tech_type in FrameTech._value2member_map_
                else hex(frame.tech_type),
                "type": frame.frame_type,
                "command": name,
                "data": frame.hex_data,
                "tree": node.to_json() if node is not None else None,
            }
        )
    return out
