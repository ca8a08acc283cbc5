"""NFC-V (ISO15693) protocol detail parser.

Parity with ``ParserNfcV`` (app-qt/src/main/cpp/parser/ParserNfcV.cpp): the
request flags byte, Inventory, StayQuiet, Read/Write single & multiple,
Lock, Select, ResetToReady, AFI/DSFID writes, GetSystemInfo, and response
flags/error decoding.
"""

from __future__ import annotations

from ...core.frame import Frame, FrameType
from .base import ParserNfc
from .tree import APPLICATION_FRAME, SELECTION_FRAME, ProtocolNode

_COMMANDS = {
    0x01: "Inventory",
    0x02: "StayQuiet",
    0x20: "ReadSingle",
    0x21: "WriteSingle",
    0x22: "LockBlock",
    0x23: "ReadMultiple",
    0x24: "WriteMultiple",
    0x25: "Select",
    0x26: "ResetToReady",
    0x27: "WriteAFI",
    0x28: "LockAFI",
    0x29: "WriteDSFID",
    0x2A: "LockDSFID",
    0x2B: "GetSystemInfo",
    0x2C: "GetSecurityStatus",
}

_ERRORS = {
    0x01: "command not supported",
    0x02: "command not recognised",
    0x0F: "unknown error",
    0x10: "block not available",
    0x11: "block already locked",
    0x12: "block locked",
    0x13: "block not successfully programmed",
    0x14: "block not successfully locked",
}


class ParserNfcV(ParserNfc):
    def parse(self, frame: Frame) -> ProtocolNode | None:
        if frame.frame_type == int(FrameType.NfcPollFrame):
            return self.parse_request(frame)
        return self.parse_response(frame)

    def _flags_node(self, root: ProtocolNode, flags: int, request: bool):
        node = root.add("FLAGS", bytes([flags]))
        if request:
            node.add(f"subcarrier {'two' if flags & 0x01 else 'one'}", "")
            node.add(f"data rate {'high' if flags & 0x02 else 'low'}", "")
            if flags & 0x04:
                node.add("inventory flag set", "")
            if flags & 0x10:
                node.add("select flag" if not flags & 0x04 else "AFI present", "")
            if flags & 0x20:
                node.add("address flag" if not flags & 0x04 else "1 slot", "")
            if flags & 0x40:
                node.add("option flag", "")
        else:
            if flags & 0x01:
                node.add("error", "")

    def parse_request(self, frame: Frame) -> ProtocolNode:
        d = frame.data
        if len(d) < 2:
            return self.parse_request_unknown(frame)
        flags, cmd = d[0], d[1]
        self.last_command = cmd
        name = _COMMANDS.get(cmd, f"CMD {cmd:02X}")
        kind = SELECTION_FRAME if cmd in (0x01, 0x02, 0x25, 0x26) else APPLICATION_FRAME
        root = self.root(name, frame, kind)
        self._flags_node(root, flags, request=True)
        offset = 2
        if cmd == 0x01:
            # Inventory: optional AFI, mask length + mask
            if flags & 0x10 and offset < len(d) - 2:
                root.add("AFI", d[offset : offset + 1])
                offset += 1
            if offset < len(d) - 2:
                mlen = d[offset]
                root.add("MLEN", d[offset : offset + 1])
                offset += 1
                nbytes = (mlen + 7) // 8
                if nbytes:
                    root.add("MASK", d[offset : offset + nbytes])
                    offset += nbytes
        else:
            # addressed mode: address flag set AND not inventory
            # (ParserNfcV.cpp:488: (frame[0] & 0x24) == 0x20)
            if (flags & 0x24) == 0x20 and offset + 8 <= len(d) - 2:
                root.add("UID", d[offset : offset + 8])
                offset += 8
            if (cmd in (0x20, 0x21, 0x22, 0x23, 0x24, 0x2C)
                    and offset < len(d) - 2):
                root.add("BLOCK", d[offset : offset + 1])
                offset += 1
            # multi-block commands carry a count (ReadMultiple :441,
            # WriteMultiple :495, GetSecurity :938)
            if cmd in (0x23, 0x24, 0x2C) and offset < len(d) - 2:
                root.add("COUNT", d[offset : offset + 1])
                offset += 1
            if cmd in (0x27,) and offset < len(d) - 2:
                root.add("AFI", d[offset : offset + 1])
                offset += 1
            if cmd in (0x29,) and offset < len(d) - 2:
                root.add("DSFID", d[offset : offset + 1])
                offset += 1
            rest = d[offset : len(d) - 2]
            if rest:
                root.add("DATA", rest)
        self.child(root, "CRC", frame, -2, 2)
        return root

    def parse_response(self, frame: Frame) -> ProtocolNode:
        d = frame.data
        if len(d) < 1:
            return self.parse_response_unknown(frame)
        flags = d[0]
        root = self.root("", frame, APPLICATION_FRAME)
        self._flags_node(root, flags, request=False)
        if flags & 0x01 and len(d) >= 2:
            err = root.add("ERROR", d[1:2])
            err.add(_ERRORS.get(d[1], "reserved"), "")
        elif self.last_command == 0x01 and len(d) >= 12:
            root.add("DSFID", d[1:2])
            root.add("UID", d[2:10])
        elif self.last_command == 0x2B and len(d) >= 12:
            info = root.add("INFO", d[1:2])
            offset = 2
            root.add("UID", d[offset : offset + 8])
            offset += 8
            if d[1] & 0x01 and offset < len(d) - 2:
                root.add("DSFID", d[offset : offset + 1])
                offset += 1
            if d[1] & 0x02 and offset < len(d) - 2:
                root.add("AFI", d[offset : offset + 1])
                offset += 1
            if d[1] & 0x04 and offset + 2 <= len(d) - 2:
                root.add("SIZE", d[offset : offset + 2])
                offset += 2
            if d[1] & 0x08 and offset < len(d) - 2:
                root.add("IC", d[offset : offset + 1])
        else:
            payload = d[1 : len(d) - 2]
            if payload:
                root.add("DATA", payload)
        self.child(root, "CRC", frame, -2, 2)
        self.last_command = 0
        return root
