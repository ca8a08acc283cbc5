"""Parser base classes.

Parity with ``ParserNfc`` / ``ParserNfcIsoDep``
(app-qt/src/main/cpp/parser/ParserNfc.h:30-65, ParserNfc.cpp): shared root /
child node construction, APDU detection, and the ISO-DEP I/R/S block layer
that every NFC tech falls back to.
"""

from __future__ import annotations

from ...core.frame import Frame, FrameFlags, FrameType
from .tree import (
    APPLICATION_FRAME,
    AUTH_FRAME,
    CRC_ERROR,
    PARITY_ERROR,
    REQUEST_FRAME,
    RESPONSE_FRAME,
    SELECTION_FRAME,
    SYNC_ERROR,
    ProtocolNode,
)


def _frame_flags(frame: Frame) -> int:
    flags = 0
    if frame.has_flags(FrameFlags.CrcError):
        flags |= CRC_ERROR
    if frame.has_flags(FrameFlags.ParityError):
        flags |= PARITY_ERROR
    if frame.has_flags(FrameFlags.SyncError):
        flags |= SYNC_ERROR
    if frame.frame_type in (
        int(FrameType.NfcPollFrame),
        int(FrameType.IsoRequestFrame),
        int(FrameType.IsoExchangeFrame),
    ):
        flags |= REQUEST_FRAME
    elif frame.frame_type in (
        int(FrameType.NfcListenFrame),
        int(FrameType.IsoResponseFrame),
    ):
        flags |= RESPONSE_FRAME
    return flags


class ParserNfc:
    IS_APDU = 1

    def __init__(self):
        self.last_command = 0
        self.frame_chain = 0

    def reset(self):
        self.last_command = 0
        self.frame_chain = 0

    # ------------------------------------------------------------- node build

    def root(self, name: str, frame: Frame, kind: int = 0) -> ProtocolNode:
        return ProtocolNode(name, frame.data, kind | _frame_flags(frame))

    @staticmethod
    def child(root: ProtocolNode, name: str, frame: Frame, start: int, length: int):
        """buildChildInfo with frame slicing; negative start counts from the
        end (the reference's CRC fields use start=-2)."""
        data = frame.data
        if start < 0:
            start = len(data) + start
        return root.add(name, data[start : start + length])

    # ----------------------------------------------------------- generic APDU

    @staticmethod
    def is_apdu(data: bytes) -> bool:
        """ParserNfc::isApdu — plausible ISO7816-4 APDU shape."""
        if len(data) < 4:
            return False
        cla, ins = data[0], data[1]
        if cla == 0xFF:
            return False
        if (ins & 0xF0) in (0x60, 0x90):
            return False
        return True

    def parse_apdu(self, name: str, frame: Frame, start: int, length: int) -> ProtocolNode:
        data = frame.data[start : start + length]
        root = ProtocolNode(name, data, APPLICATION_FRAME | _frame_flags(frame))
        if len(data) >= 4:
            root.add("CLA", data[0:1])
            root.add("INS", data[1:2])
            root.add("P1", data[2:3])
            root.add("P2", data[3:4])
            if len(data) == 5:
                root.add("LE", data[4:5])
            elif len(data) > 5:
                lc = data[4]
                root.add("LC", data[4:5])
                if 5 + lc <= len(data):
                    root.add("DATA", data[5 : 5 + lc])
                    if len(data) == 5 + lc + 1:
                        root.add("LE", data[5 + lc : 5 + lc + 1])
        return root

    def parse_request_unknown(self, frame: Frame) -> ProtocolNode:
        return self.root("(unk)", frame)

    def parse_response_unknown(self, frame: Frame) -> ProtocolNode:
        return self.root("", frame)

    def parse(self, frame: Frame) -> ProtocolNode:  # pragma: no cover
        raise NotImplementedError


class ParserNfcIsoDep(ParserNfc):
    """ISO-DEP (ISO14443-4) I/R/S block layer (ParserNfc.cpp ParserNfcIsoDep)."""

    def parse(self, frame: Frame) -> ProtocolNode | None:
        info = self.parse_iblock(frame)
        if info is None:
            info = self.parse_rblock(frame)
        if info is None:
            info = self.parse_sblock(frame)
        if info is None:
            if frame.frame_type == int(FrameType.NfcPollFrame):
                info = self.parse_request_unknown(frame)
            else:
                info = self.parse_response_unknown(frame)
        return info

    def parse_iblock(self, frame: Frame) -> ProtocolNode | None:
        data = frame.data
        if len(data) < 4 or (data[0] & 0xE2) != 0x02:
            return None
        pcb = data[0]
        offset = 1
        root = self.root("I-Block", frame, APPLICATION_FRAME)
        pcb_node = root.add("PCB", data[0:1])
        pcb_node.add("CHAINING" if pcb & 0x10 else "NO-CHAINING", "")
        if pcb & 0x08:
            root.add("CID", data[offset : offset + 1])
            offset += 1
        if pcb & 0x04:
            root.add("NAD", data[offset : offset + 1])
            offset += 1
        inf = data[offset : len(data) - 2]
        if inf:
            if self.is_apdu(inf):
                root.children.append(self.parse_apdu("APDU", frame, offset, len(inf)))
            else:
                root.add("INF", inf)
        self.child(root, "CRC", frame, -2, 2)
        return root

    def parse_rblock(self, frame: Frame) -> ProtocolNode | None:
        data = frame.data
        if len(data) < 3 or (data[0] & 0xE6) != 0xA2:
            return None
        pcb = data[0]
        name = "R(ACK)" if not (pcb & 0x10) else "R(NAK)"
        root = self.root(name, frame, APPLICATION_FRAME)
        root.add("PCB", data[0:1])
        offset = 1
        if pcb & 0x08:
            root.add("CID", data[offset : offset + 1])
        self.child(root, "CRC", frame, -2, 2)
        return root

    def parse_sblock(self, frame: Frame) -> ProtocolNode | None:
        data = frame.data
        # S-block PCB is 11...010 (ParserNfc.cpp:245: (pcb & 0xC7) != 0xC2)
        if len(data) < 3 or (data[0] & 0xC7) != 0xC2:
            return None
        pcb = data[0]
        kind = (pcb >> 4) & 0x3
        name = {0: "S(DESELECT)", 3: "S(WTX)"}.get(kind, "S-Block")
        root = self.root(name, frame, APPLICATION_FRAME)
        root.add("PCB", data[0:1])
        offset = 1
        if pcb & 0x08:
            root.add("CID", data[offset : offset + 1])
            offset += 1
        if kind == 3 and offset < len(data) - 2:
            root.add("WTXM", data[offset : offset + 1])
        self.child(root, "CRC", frame, -2, 2)
        return root
