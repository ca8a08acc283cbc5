"""NFC-F (FeliCa) protocol detail parser: polling request/response plus the
common FeliCa service commands (check/update, request service/response)."""

from __future__ import annotations

from ...core.frame import Frame, FrameType
from .base import ParserNfc
from .tree import APPLICATION_FRAME, SELECTION_FRAME, ProtocolNode

_FELICA_COMMANDS = {
    0x00: "POLLING",
    0x02: "REQUEST_SERVICE",
    0x04: "REQUEST_RESPONSE",
    0x06: "READ_WITHOUT_ENCRYPTION",
    0x08: "WRITE_WITHOUT_ENCRYPTION",
    0x0C: "REQUEST_SYSTEM_CODE",
    0x10: "AUTHENTICATION1",
    0x12: "AUTHENTICATION2",
    0x14: "READ",
    0x16: "WRITE",
}


class ParserNfcF(ParserNfc):
    def parse(self, frame: Frame) -> ProtocolNode | None:
        d = frame.data
        if len(d) < 2:
            return self.parse_request_unknown(frame)
        cmd = d[1]
        if frame.frame_type == int(FrameType.NfcPollFrame):
            if cmd == 0x00:
                return self.req_polling(frame)
            name = _FELICA_COMMANDS.get(cmd, f"CMD {cmd:02X}")
            self.last_command = cmd
            root = self.root(name, frame, APPLICATION_FRAME)
            root.add("LEN", d[0:1])
            root.add("CMD", d[1:2])
            if len(d) >= 10:
                root.add("IDm", d[2:10])
            if len(d) > 10:
                root.add("DATA", d[10 : len(d) - 2])
            self.child(root, "CRC", frame, -2, 2)
            return root
        # responses: command code is request+1
        if self.last_command == 0x00 and cmd == 0x01:
            return self.resp_polling(frame)
        name = _FELICA_COMMANDS.get(cmd - 1, f"CMD {cmd - 1:02X}")
        root = self.root("", frame, APPLICATION_FRAME)
        root.add("LEN", d[0:1])
        root.add("RSP", d[1:2])
        if len(d) >= 10:
            root.add("IDm", d[2:10])
        if len(d) > 10:
            root.add("DATA", d[10 : len(d) - 2])
        self.child(root, "CRC", frame, -2, 2)
        self.last_command = 0
        return root

    def req_polling(self, frame: Frame):
        d = frame.data
        self.last_command = 0x00
        root = self.root("REQC", frame, SELECTION_FRAME)
        root.add("LEN", d[0:1])
        root.add("CMD", d[1:2])
        if len(d) >= 6:
            sc = root.add("SC", d[2:4])
            if d[2] == 0xFF and d[3] == 0xFF:
                sc.add("wildcard system code", "")
            rc = root.add("RC", d[4:5])
            rc.add(
                {
                    0: "no request",
                    1: "system code request",
                    2: "communication performance request",
                }.get(d[4], "unknown"),
                "",
            )
            root.add("TSN", d[5:6])
        self.child(root, "CRC", frame, -2, 2)
        return root

    def resp_polling(self, frame: Frame):
        d = frame.data
        root = self.root("", frame, SELECTION_FRAME)
        root.add("LEN", d[0:1])
        root.add("RSP", d[1:2])
        if len(d) >= 18:
            root.add("IDm", d[2:10])
            root.add("PMm", d[10:18])
        if len(d) >= 22:
            root.add("RD", d[18:20])
        self.child(root, "CRC", frame, -2, 2)
        self.last_command = 0
        return root
