"""NFC-B protocol detail parser (ParserNfcB.cpp parity): REQB/WUPB, ATQB,
ATTRIB, HLTB, with ISO-DEP fallback."""

from __future__ import annotations

from ...core.frame import Frame, FrameType
from .base import ParserNfcIsoDep
from .tree import SELECTION_FRAME, ProtocolNode

NFC_FDS_TABLE = (16, 24, 32, 40, 48, 64, 96, 128, 256, 512, 1024, 2048, 4096, 0, 0, 0)


class ParserNfcB(ParserNfcIsoDep):
    def parse(self, frame: Frame) -> ProtocolNode | None:
        if frame.frame_type == int(FrameType.NfcPollFrame):
            info = (
                self.req_reqb(frame)
                or self.req_attrib(frame)
                or self.req_hltb(frame)
            )
            if info is None:
                info = ParserNfcIsoDep.parse(self, frame)
        else:
            info = (
                self.resp_reqb(frame)
                or self.resp_attrib(frame)
                or self.resp_hltb(frame)
            )
            if info is None:
                info = ParserNfcIsoDep.parse(self, frame)
        return info

    def req_reqb(self, frame: Frame):
        d = frame.data
        if len(d) != 5 or d[0] != 0x05:
            return None
        self.last_command = 0x05
        wup = d[2] & 0x08
        root = self.root("WUPB" if wup else "REQB", frame, SELECTION_FRAME)
        root.add("AFI", d[1:2])
        param = root.add("PARAM", d[2:3])
        param.add(f"{'WUPB' if wup else 'REQB'}", "")
        param.add(f"N {1 << (d[2] & 0x07)} slots", "")
        self.child(root, "CRC", frame, -2, 2)
        return root

    def resp_reqb(self, frame: Frame):
        if self.last_command != 0x05:
            return None
        d = frame.data
        if len(d) < 1 or d[0] != 0x50:
            return None
        root = self.root("", frame, SELECTION_FRAME)
        if len(d) >= 12:
            self.child(root, "PUPI", frame, 1, 4)
            appdata = root.add("APPDATA", d[5:9])
            appdata.add("AFI", d[5:6])
            appdata.add("CRC_B(AID)", d[6:8])
            appdata.add("NAPP", d[8:9])
            proto = root.add("PROTINFO", d[9:12])
            proto.add(f"bitrate capability {d[9]:02X}", "")
            proto.add(
                f"FSCI {(d[10] >> 4) & 0x0F} "
                f"(FSC {NFC_FDS_TABLE[(d[10] >> 4) & 0x0F]} bytes)",
                "",
            )
            proto.add(f"protocol type {d[10] & 0x0F}", "")
            proto.add(f"FWI {(d[11] >> 4) & 0x0F}", "")
            proto.add(f"ADC {(d[11] >> 2) & 0x03}", "")
            proto.add(f"FO {d[11] & 0x03}", "")
        self.child(root, "CRC", frame, -2, 2)
        self.last_command = 0
        return root

    def req_attrib(self, frame: Frame):
        d = frame.data
        if len(d) < 9 or d[0] != 0x1D:
            return None
        self.last_command = 0x1D
        root = self.root("ATTRIB", frame, SELECTION_FRAME)
        self.child(root, "ID", frame, 1, 4)
        p1 = root.add("PARAM1", d[5:6])
        tr0 = (d[5] >> 6) & 0x3
        p1.add(f"TR0 {tr0}", "")
        p1.add(f"SOF {'suppressed' if d[5] & 0x10 else 'required'}", "")
        p1.add(f"EOF {'suppressed' if d[5] & 0x08 else 'required'}", "")
        p2 = root.add("PARAM2", d[6:7])
        p2.add(f"bitrate D(PICC->PCD) {(d[6] >> 6) & 3}, D(PCD->PICC) {(d[6] >> 4) & 3}", "")
        p2.add(
            f"FSDI {d[6] & 0x0F} (FSD {NFC_FDS_TABLE[d[6] & 0x0F]} bytes)", ""
        )
        p3 = root.add("PARAM3", d[7:8])
        p3.add(f"TR2 {(d[7] >> 2) & 3}", "")
        p3.add(f"protocol type {d[7] & 0x3}", "")
        p4 = root.add("PARAM4", d[8:9])
        p4.add(f"CID {d[8] & 0x0F}", "")
        hli = d[9 : len(d) - 2]
        if hli:
            root.add("HLINF", hli)
        self.child(root, "CRC", frame, -2, 2)
        return root

    def resp_attrib(self, frame: Frame):
        if self.last_command != 0x1D:
            return None
        d = frame.data
        root = self.root("", frame, SELECTION_FRAME)
        if len(d) >= 1:
            b = root.add("MBLI-CID", d[0:1])
            b.add(f"MBLI {(d[0] >> 4) & 0x0F}", "")
            b.add(f"CID {d[0] & 0x0F}", "")
        self.child(root, "CRC", frame, -2, 2)
        self.last_command = 0
        return root

    def req_hltb(self, frame: Frame):
        d = frame.data
        if len(d) < 5 or d[0] != 0x50:
            return None
        self.last_command = 0x50
        root = self.root("HLTB", frame, SELECTION_FRAME)
        self.child(root, "ID", frame, 1, 4)
        self.child(root, "CRC", frame, -2, 2)
        return root

    def resp_hltb(self, frame: Frame):
        if self.last_command != 0x50:
            return None
        self.last_command = 0
        root = self.root("", frame, SELECTION_FRAME)
        self.child(root, "CRC", frame, -2, 2)
        return root
