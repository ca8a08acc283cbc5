"""Protocol detail tree node.

Parity with ``ProtocolFrame`` (app-qt protocol/ProtocolFrame.h): a named node
with payload bytes (or a formatted string), flags, and children — rendered by
the GUI as the frame-detail tree and serialized by the test-parser harness as
JSON (src/nfc-test/test-parser/src/main/cpp/main.cpp:96-140).
"""

from __future__ import annotations

from dataclasses import dataclass, field


# node flags (ProtocolFrame flags)
SELECTION_FRAME = 0x0001
APPLICATION_FRAME = 0x0002
AUTH_FRAME = 0x0004
REQUEST_FRAME = 0x0010
RESPONSE_FRAME = 0x0020
FRAME_FIELD = 0x0100
FIELD_INFO = 0x0200
CRC_ERROR = 0x1000
PARITY_ERROR = 0x2000
SYNC_ERROR = 0x4000


@dataclass
class ProtocolNode:
    name: str
    data: bytes | str | None = None
    flags: int = 0
    children: list["ProtocolNode"] = field(default_factory=list)

    def add(self, name: str, data: bytes | str | None = None, flags: int = 0):
        node = ProtocolNode(name, data, flags | FRAME_FIELD)
        self.children.append(node)
        return node

    def to_json(self) -> dict:
        out: dict = {"name": self.name}
        if isinstance(self.data, bytes):
            if self.data:
                out["data"] = " ".join(f"{b:02X}" for b in self.data)
        elif self.data:
            out["data"] = str(self.data)
        flags = []
        if self.flags & CRC_ERROR:
            flags.append("CRC_ERROR")
        if self.flags & PARITY_ERROR:
            flags.append("PARITY_ERROR")
        if self.flags & SYNC_ERROR:
            flags.append("SYNC_ERROR")
        if self.flags & REQUEST_FRAME:
            flags.append("REQUEST")
        if self.flags & RESPONSE_FRAME:
            flags.append("RESPONSE")
        if flags:
            out["flags"] = flags
        if self.children:
            out["children"] = [c.to_json() for c in self.children]
        return out
