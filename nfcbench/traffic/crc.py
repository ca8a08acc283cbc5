# Frozen copy of nfclab_torch/protocol/crc.py's crc16_ccitt (numpy-free,
# imports nothing of the program).
"""CRC16-CCITT, normal and bit-reflected variants.

Parity with ``lab::Crc::ccitt16``
(src/nfc-lib/lib-lab/lab-data/src/main/cpp/Crc.cpp:96-113): table-driven, the
reflected (refin) variant is used by NFC-A (init 0x6363 — CRC_A of ISO14443-3)
and NFC-B/ISO (init 0xFFFF with final complement — CRC_B).  The tables are the
standard CCITT polynomial 0x1021 (normal) and its bit-reverse 0x8408, generated
here rather than hard-coded.
"""

from __future__ import annotations


def _gen_table_normal() -> list[int]:
    table = []
    for byte in range(256):
        crc = byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
        table.append(crc)
    return table


def _gen_table_reflected() -> list[int]:
    table = []
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
        table.append(crc)
    return table


_TABLE1 = _gen_table_normal()
_TABLE2 = _gen_table_reflected()


def crc16_ccitt(data: bytes, start: int, end: int, init: int, refin: bool) -> int:
    """CRC over data[start:end]; matches Crc.cpp:96-113 including the
    degenerate empty-range return of ~init."""
    crc = init & 0xFFFF
    if end - start <= 0:
        return (~init) & 0xFFFF
    if refin:
        for i in range(start, end):
            crc = (crc >> 8) ^ _TABLE2[(crc & 0xFF) ^ data[i]]
    else:
        for i in range(start, end):
            crc = ((crc << 8) & 0xFFFF) ^ _TABLE1[((crc >> 8) ^ data[i]) & 0xFF]
    return crc & 0xFFFF

