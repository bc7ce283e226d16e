# Frozen copy of the JAX package's pymodem_tpu/ops/crc.py at commit
# 0117b87, only _POLY, _build_table, CRC_TABLE, np_crc16,
# crc_bit_distance, np_check_packet, np_append_crc; its jax imports and
# device functions left out. The benchmark's reference: it is not the
# port's code, and it is not edited to follow either package.
"""CRC-16 (X.25 / CRC-CCITT reflected, poly 0x8408) utilities.

The reference computes the CRC bit-serially per packet (crc_functions.py:44-55,
init 0xFFFF, final xor 0xFFFF, LSB-first) and declares a packet valid when the
carried CRC -- little-endian in the last two bytes -- exactly equals the
calculated one (the Hamming-distance threshold in CheckCRC is <= 0, i.e.
equality; crc_functions.py:56-61).

We use the standard byte-at-a-time table form, which is algebraically
identical; equivalence is asserted against the reference in tests/test_primitives.py.
"""

from __future__ import annotations

import numpy as np

_POLY = 0x8408


def _build_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint16)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ _POLY if crc & 1 else crc >> 1
        table[byte] = crc
    return table


CRC_TABLE = _build_table()


def np_crc16(data: np.ndarray) -> int:
    """CRC over a byte array (host)."""
    crc = np.uint16(0xFFFF)
    table = CRC_TABLE
    for byte in np.asarray(data, dtype=np.uint8):
        crc = np.uint16(crc >> 8) ^ table[np.uint8(crc) ^ byte]
    return int(crc ^ np.uint16(0xFFFF))


def crc_bit_distance(carried: int, calculated: int) -> int:
    """Hamming distance between a packet's carried and calculated CRCs --
    the reference's ``Distance8``-table near-miss metric
    (crc_functions.py:14-61).  Its shipped validity test is
    ``distance <= 0`` (plain equality, which np_check_packet applies),
    but the metric itself is part of the CheckCRC surface: a caller can
    rank almost-valid packets by how many CRC bits disagree."""
    return int(bin((carried ^ calculated) & 0xFFFF).count("1"))


def np_check_packet(data: np.ndarray,
                    max_distance: int = 0) -> tuple[int, int, bool]:
    """(carried, calculated, valid) for a packet whose last two bytes carry
    the CRC little-endian (crc_functions.py:9-61).

    ``max_distance``: accept packets whose CRCs differ in at most that
    many bits -- the reference's near-miss knob, hardcoded to 0
    (equality) in its shipped CheckCRC; exposed here for the same
    ranking/diagnostic uses its Distance8 table enables."""
    data = np.asarray(data)
    carried = int(data[-1]) * 256 + int(data[-2])
    calc = np_crc16(data[:-2])
    return carried, calc, crc_bit_distance(carried, calc) <= max_distance


def np_append_crc(data: list[int]) -> None:
    """Append CRC low byte then high byte in place (crc_functions.py:63-76)."""
    crc = np_crc16(np.asarray(data, dtype=np.uint8))
    data.append(crc & 0xFF)
    data.append(crc >> 8)


