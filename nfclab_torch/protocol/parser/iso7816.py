"""ISO7816 protocol detail parser.

Parity with ``ParserISO7816`` (app-qt/src/main/cpp/parser/ParserISO7816.cpp):
ATR with TS/T0/TA-TB-TC-TD interface byte chain and historical bytes, PPS,
T=0 TPDU (header/procedure/SW), and T=1 block prologue/epilogue.
"""

from __future__ import annotations

from ...core.frame import Frame, FrameType
from .base import ParserNfc
from .tree import APPLICATION_FRAME, SELECTION_FRAME, ProtocolNode

_SW1_MEANING = {
    0x90: "normal completion",
    0x61: "response bytes available",
    0x62: "warning: state unchanged",
    0x63: "warning: state changed",
    0x64: "error: state unchanged",
    0x65: "error: state changed",
    0x67: "wrong length",
    0x68: "functions in CLA not supported",
    0x69: "command not allowed",
    0x6A: "wrong parameters P1-P2",
    0x6B: "wrong parameters",
    0x6C: "wrong Le field",
    0x6D: "INS not supported",
    0x6E: "CLA not supported",
    0x6F: "no precise diagnosis",
}


class ParserISO7816(ParserNfc):
    def parse(self, frame: Frame) -> ProtocolNode | None:
        t = frame.frame_type
        if t == int(FrameType.IsoATRFrame):
            return self.parse_atr(frame)
        if frame.data and frame.data[0] == 0xFF and len(frame.data) <= 6:
            return self.parse_pps(frame)
        if t == int(FrameType.IsoExchangeFrame):
            return self.parse_tpdu(frame)
        if t in (int(FrameType.IsoRequestFrame), int(FrameType.IsoResponseFrame)):
            return self.parse_block(frame)
        return self.parse_request_unknown(frame)

    def parse_atr(self, frame: Frame) -> ProtocolNode:
        d = frame.data
        root = self.root("ATR", frame, SELECTION_FRAME)
        if not d:
            return root
        ts = root.add("TS", d[0:1])
        ts.add("direct convention" if d[0] == 0x3B else "inverse convention", "")
        if len(d) < 2:
            return root
        t0 = d[1]
        t0n = root.add("T0", d[1:2])
        hb = t0 & 0x0F
        t0n.add(f"{hb} historical bytes", "")
        i, n, k = 1, 2, 1
        td = t0
        while True:
            if td & 0x10 and n < len(d):
                ta = root.add(f"TA{k}", d[n : n + 1])
                if k == 1:
                    ta.add(f"Fi index {d[n] >> 4}, Di index {d[n] & 0x0F}", "")
                n += 1
            if td & 0x20 and n < len(d):
                root.add(f"TB{k}", d[n : n + 1])
                n += 1
            if td & 0x40 and n < len(d):
                tc = root.add(f"TC{k}", d[n : n + 1])
                if k == 1:
                    tc.add(f"extra guard time {d[n]} ETU", "")
                n += 1
            if not (td & 0x80) or n >= len(d):
                break
            td = d[n]
            tdn = root.add(f"TD{k}", d[n : n + 1])
            tdn.add(f"protocol T={td & 0x0F}", "")
            n += 1
            k += 1
        if hb and n + hb <= len(d):
            root.add("HIST", d[n : n + hb])
            n += hb
        if n < len(d):
            root.add("TCK", d[n : n + 1])
        return root

    def parse_pps(self, frame: Frame) -> ProtocolNode:
        d = frame.data
        root = self.root("PPS", frame, SELECTION_FRAME)
        root.add("PPSS", d[0:1])
        if len(d) >= 2:
            pps0 = root.add("PPS0", d[1:2])
            pps0.add(f"protocol T={d[1] & 0x0F}", "")
            i = 2
            for bit, name in ((0x10, "PPS1"), (0x20, "PPS2"), (0x40, "PPS3")):
                if d[1] & bit and i < len(d):
                    root.add(name, d[i : i + 1])
                    i += 1
            if i < len(d):
                root.add("PCK", d[i : i + 1])
        return root

    def parse_tpdu(self, frame: Frame) -> ProtocolNode:
        d = frame.data
        root = self.root("TPDU", frame, APPLICATION_FRAME)
        if len(d) >= 5:
            root.add("CLA", d[0:1])
            root.add("INS", d[1:2])
            root.add("P1", d[2:3])
            root.add("P2", d[3:4])
            root.add("P3", d[4:5])
            body = d[5:]
            # walk procedure bytes like the decoder does (Iso7816.cpp:1524-1541)
            i = 0
            ins = d[1]
            while i < len(body):
                b = body[i]
                if b == 0x60:
                    root.add("NULL", body[i : i + 1])
                    i += 1
                    continue
                if (b & 0xF0) in (0x60, 0x90):
                    sw = root.add("SW", body[i : i + 2])
                    sw.add(_SW1_MEANING.get(b, "status"), "")
                    i += 2
                    continue
                if b == ins:
                    count = d[4]
                    root.add("PROC", body[i : i + 1])
                    if count:
                        root.add("DATA", body[i + 1 : i + 1 + count])
                    i += 1 + count
                elif b == (ins ^ 0xFF):
                    root.add("PROC", body[i : i + 1])
                    root.add("DATA", body[i + 1 : i + 2])
                    i += 2
                else:
                    root.add("DATA", body[i:])
                    break
        return root

    def parse_block(self, frame: Frame) -> ProtocolNode:
        d = frame.data
        if len(d) < 4:
            return self.parse_request_unknown(frame)
        pcb = d[1]
        if not pcb & 0x80:
            name = "I-Block"
        elif (pcb & 0xC0) == 0x80:
            name = "R-Block"
        else:
            name = "S-Block"
        root = self.root(name, frame, APPLICATION_FRAME)
        root.add("NAD", d[0:1])
        pn = root.add("PCB", d[1:2])
        if name == "I-Block":
            pn.add(f"N(S) {(pcb >> 6) & 1}", "")
            if pcb & 0x20:
                pn.add("chaining", "")
        elif name == "R-Block":
            pn.add(f"N(R) {(pcb >> 4) & 1}", "")
            if pcb & 0x03:
                pn.add("error signalled", "")
        root.add("LEN", d[2:3])
        ln = d[2]
        if ln:
            inf = d[3 : 3 + ln]
            if name == "I-Block" and self.is_apdu(inf):
                root.children.append(self.parse_apdu("APDU", frame, 3, ln))
            else:
                root.add("INF", inf)
        root.add("EDC", d[3 + ln :])
        return root
