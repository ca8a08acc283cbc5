"""NFC-A protocol detail parser.

Parity with ``ParserNfcA`` (app-qt/src/main/cpp/parser/ParserNfcA.cpp):
REQA/WUPA, HLTA, SELn anticollision (NVB/CT/UID/BCC), RATS/ATS interface
bytes, PPS, Mifare AUTH two-pass chain, VASUP-A, with ISO-DEP fallback.
"""

from __future__ import annotations

from ...core.frame import Frame, FrameFlags, FrameType
from .base import ParserNfcIsoDep
from .tree import AUTH_FRAME, SELECTION_FRAME, ProtocolNode

NFC_FDS_TABLE = (16, 24, 32, 40, 48, 64, 96, 128, 256, 512, 1024, 2048, 4096, 0, 0, 0)


class ParserNfcA(ParserNfcIsoDep):
    def parse(self, frame: Frame) -> ProtocolNode | None:
        info = None
        if frame.frame_type == int(FrameType.NfcPollFrame):
            if self.frame_chain == 0:
                if not frame.has_flags(FrameFlags.Encrypted):
                    info = (
                        self.req_reqa(frame)
                        or self.req_wupa(frame)
                        or self.req_hlta(frame)
                        or self.req_seln(frame)
                        or self.req_rats(frame)
                        or self.req_ppsr(frame)
                        or self.req_auth(frame)
                        or self.req_vasup(frame)
                    )
                if info is None:
                    info = ParserNfcIsoDep.parse(self, frame)
            elif self.frame_chain in (0x60, 0x61):
                info = self.req_auth(frame)
        else:
            if not frame.has_flags(FrameFlags.Encrypted):
                info = (
                    self.resp_reqa(frame)
                    or self.resp_hlta(frame)
                    or self.resp_seln(frame)
                    or self.resp_rats(frame)
                    or self.resp_ppsr(frame)
                    or self.resp_auth(frame)
                )
            if info is None:
                info = ParserNfcIsoDep.parse(self, frame)
        return info

    # -------------------------------------------------------------- requests

    def req_reqa(self, frame: Frame):
        if frame.data != b"\x26":
            return None
        self.last_command = 0x26
        return self.root("REQA", frame, SELECTION_FRAME)

    def req_wupa(self, frame: Frame):
        if frame.data != b"\x52":
            return None
        self.last_command = 0x52
        return self.root("WUPA", frame, SELECTION_FRAME)

    def req_hlta(self, frame: Frame):
        d = frame.data
        if len(d) < 1 or d[0] != 0x50:
            return None
        self.last_command = 0x50
        root = self.root("HLTA", frame, SELECTION_FRAME)
        if len(d) >= 4:
            self.child(root, "CRC", frame, -2, 2)
        return root

    def req_seln(self, frame: Frame):
        d = frame.data
        if len(d) < 2 or d[0] not in (0x93, 0x95, 0x97):
            return None
        self.last_command = d[0]
        name = {0x93: "SEL1", 0x95: "SEL2", 0x97: "SEL3"}[d[0]]
        root = self.root(name, frame, SELECTION_FRAME)
        nvb = d[1] >> 4
        root.add("NVB", f"{nvb}")
        if nvb == 7 and len(d) >= 7:
            if d[2] == 0x88:  # cascade tag
                self.child(root, "CT", frame, 2, 1)
                self.child(root, "UID", frame, 3, 3)
            else:
                self.child(root, "UID", frame, 2, 4)
            self.child(root, "BCC", frame, 6, 1)
            self.child(root, "CRC", frame, -2, 2)
        return root

    def req_rats(self, frame: Frame):
        d = frame.data
        if len(d) < 2 or d[0] != 0xE0:
            return None
        self.last_command = 0xE0
        root = self.root("RATS", frame, SELECTION_FRAME)
        param = root.add("PARAM", d[1:2])
        fsdi = (d[1] >> 4) & 0x0F
        cid = d[1] & 0x0F
        param.add(f"FSDI {fsdi} (FSD {NFC_FDS_TABLE[fsdi]} bytes)", "")
        param.add(f"CID {cid}", "")
        self.child(root, "CRC", frame, -2, 2)
        return root

    def req_ppsr(self, frame: Frame):
        d = frame.data
        if len(d) < 2 or (d[0] & 0xF0) != 0xD0:
            return None
        self.last_command = 0xD0
        root = self.root("PPS", frame, SELECTION_FRAME)
        root.add("CID", f"{d[0] & 0x0F}")
        root.add("PPS0", d[1:2])
        offset = 2
        if d[1] & 0x10 and len(d) > offset + 2:
            pps1 = root.add("PPS1", d[offset : offset + 1])
            pps1.add(f"DSI {(d[offset] >> 2) & 0x3}", "")
            pps1.add(f"DRI {d[offset] & 0x3}", "")
        self.child(root, "CRC", frame, -2, 2)
        return root

    def req_auth(self, frame: Frame):
        d = frame.data
        if self.frame_chain == 0:
            if len(d) < 1 or d[0] not in (0x60, 0x61):
                return None
            self.last_command = d[0]
            name = "AUTH(A)" if d[0] == 0x60 else "AUTH(B)"
            root = self.root(name, frame, AUTH_FRAME)
            if len(d) >= 2:
                root.add("BLOCK", d[1:2])
            if len(d) >= 4:
                self.child(root, "CRC", frame, -2, 2)
            self.frame_chain = d[0]
            return root
        # second pass: token
        root = self.root(
            "AUTH(A)" if self.frame_chain == 0x60 else "AUTH(B)", frame, AUTH_FRAME
        )
        root.add("TOKEN", d)
        self.frame_chain = 0
        return root

    def req_vasup(self, frame: Frame):
        d = frame.data
        if len(d) < 1 or d[0] != 0x6A:
            return None
        self.last_command = 0x6A
        root = self.root("VASUP-A", frame, SELECTION_FRAME)
        if len(d) >= 2:
            root.add("FORMAT", d[1:2])
        if len(d) >= 4:
            self.child(root, "CRC", frame, -2, 2)
        return root

    # ------------------------------------------------------------- responses

    def resp_reqa(self, frame: Frame):
        if self.last_command not in (0x26, 0x52):
            return None
        d = frame.data
        root = self.root("", frame, SELECTION_FRAME)
        atqa = root.add("ATQA", d[0:2])
        if len(d) >= 2:
            word = d[0] | (d[1] << 8)
            atqa.add(f"anticollision bits {word & 0x1F:05b}", "")
            atqa.add(f"UID size {'single' if not (word >> 6) & 3 else 'double/triple'}", "")
        self.last_command = 0
        return root

    def resp_hlta(self, frame: Frame):
        if self.last_command != 0x50:
            return None
        self.last_command = 0
        return self.root("", frame, SELECTION_FRAME)

    def resp_seln(self, frame: Frame):
        if self.last_command not in (0x93, 0x95, 0x97):
            return None
        d = frame.data
        root = self.root("", frame, SELECTION_FRAME)
        if len(d) == 5:
            if d[0] == 0x88:
                self.child(root, "CT", frame, 0, 1)
                self.child(root, "UID", frame, 1, 3)
            else:
                self.child(root, "UID", frame, 0, 4)
            self.child(root, "BCC", frame, 4, 1)
        elif len(d) == 3:
            sak = root.add("SAK", d[0:1])
            if d[0] & 0x20:
                sak.add("ISO14443-4 compliant", "")
            if d[0] & 0x04:
                sak.add("UID not complete", "")
            self.child(root, "CRC", frame, -2, 2)
        return root

    def resp_rats(self, frame: Frame):
        if self.last_command != 0xE0:
            return None
        d = frame.data
        root = self.root("", frame, SELECTION_FRAME)
        if len(d) < 1:
            return root
        ats = root.add("ATS", d[: len(d) - 2] if len(d) > 2 else d)
        tl = d[0]
        ats.add("TL", d[0:1])
        offset = 1
        if tl > 0 and len(d) > 1:
            t0 = d[1]
            t0n = ats.add("T0", d[1:2])
            t0n.add(f"FSCI {t0 & 0x0F} (FSC {NFC_FDS_TABLE[t0 & 0x0F]} bytes)", "")
            offset = 2
            if t0 & 0x10 and offset < len(d):
                ta = ats.add("TA1", d[offset : offset + 1])
                offset += 1
            if t0 & 0x20 and offset < len(d):
                tb = d[offset]
                tbn = ats.add("TB1", d[offset : offset + 1])
                tbn.add(f"FWI {(tb >> 4) & 0x0F}", "")
                tbn.add(f"SFGI {tb & 0x0F}", "")
                offset += 1
            if t0 & 0x40 and offset < len(d):
                tc = d[offset]
                tcn = ats.add("TC1", d[offset : offset + 1])
                tcn.add(f"NAD {'supported' if tc & 1 else 'not supported'}", "")
                tcn.add(f"CID {'supported' if tc & 2 else 'not supported'}", "")
                offset += 1
            hist = d[offset : len(d) - 2]
            if hist:
                ats.add("HIST", hist)
        self.child(root, "CRC", frame, -2, 2)
        self.last_command = 0
        return root

    def resp_ppsr(self, frame: Frame):
        if self.last_command != 0xD0:
            return None
        self.last_command = 0
        root = self.root("", frame, SELECTION_FRAME)
        self.child(root, "CRC", frame, -2, 2)
        return root

    def resp_auth(self, frame: Frame):
        if self.last_command not in (0x60, 0x61):
            return None
        root = self.root("", frame, AUTH_FRAME)
        root.add("TOKEN", frame.data)
        return root
