"""Protocol parser dispatcher.

Parity with ``ProtocolParser`` (app-qt/src/main/cpp/protocol/ProtocolParser):
routes each decoded frame to its tech parser and accumulates per-tech parser
state (the anticollision/command chains).  `parse_frames_to_json` reproduces
the test-parser harness output (src/nfc-test/test-parser/main.cpp:96-140).
"""

from __future__ import annotations

from ...core.frame import Frame, FrameTech, FrameType
from .iso7816 import ParserISO7816
from .nfca import ParserNfcA
from .nfcb import ParserNfcB
from .nfcf import ParserNfcF
from .nfcv import ParserNfcV
from .tree import ProtocolNode


class ProtocolParser:
    def __init__(self):
        self.parsers = {
            int(FrameTech.NfcATech): ParserNfcA(),
            int(FrameTech.NfcBTech): ParserNfcB(),
            int(FrameTech.NfcFTech): ParserNfcF(),
            int(FrameTech.NfcVTech): ParserNfcV(),
            int(FrameTech.Iso7816Tech): ParserISO7816(),
        }

    def reset(self):
        for p in self.parsers.values():
            p.reset()

    def parse(self, frame: Frame) -> ProtocolNode | None:
        parser = self.parsers.get(int(frame.tech_type))
        if parser is None:
            return None
        return parser.parse(frame)


def parse_frames_to_json(frames: list[Frame]) -> list[dict]:
    parser = ProtocolParser()
    out = []
    for frame in frames:
        node = parser.parse(frame)
        if node is not None:
            out.append(node.to_json())
    return out
