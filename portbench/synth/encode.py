# Frozen copy of pymodem_tpu_torch/synth/encode.py at commit 0117b87, its
# codec imports pointed at the reference's frozen copies of the JAX
# package's host modules.  The benchmark keeps its own copy so that later
# changes to the port do not move the yardstick; do not edit it to follow
# the port.
"""Transmit-side frame encoders (test-fixture generators), jax-free.

Port of ``pymodem_tpu.synth.encode`` over the port's re-homed numpy codec
modules, so audio can be synthesised where JAX is not installed.  The
reference is decode-only, so every encoder is defined by
``decode(encode(x)) == x``:

* AX.25/HDLC: flags + LSB-first bytes + zero stuffing + trailing CRC-16
  (the deframer at ax25.py:25-93 consumes exactly this).
* IL2P: syncword + 13-byte type-1 header (bitfield layout inverted from
  il2p.py:214-290) + RS parity + scrambled payload blocks + Hamming(7,4)
  trailing CRC (il2p.py:360-519).
* Multiplicative scrambler: the feedback inverse of the feed-forward
  descrambler in ops/lfsr.py.
"""

from __future__ import annotations

import numpy as np

from ..reference.frozen.codecs_host import (
    SCRAMBLE_POLY,
    SCRAMBLE_SEED,
    SYNC24,
    Il2pHeader,
    block_layout,
    synthesize_ax25_header,
)
from ..reference.frozen import rs as rs_ops
from ..reference.frozen.crc import np_crc16
from ..reference.frozen.hamming import HAMMING74_CODEWORDS
from ..reference.frozen.lfsr import poly_tap_positions


# ---------------------------------------------------------------------------
# bit helpers
# ---------------------------------------------------------------------------


def bytes_to_bits_msb(data) -> list[int]:
    out = []
    for byte in data:
        out.extend((int(byte) >> k) & 1 for k in range(7, -1, -1))
    return out


def bytes_to_bits_lsb(data) -> list[int]:
    out = []
    for byte in data:
        out.extend((int(byte) >> k) & 1 for k in range(8))
    return out


def bits_to_bytes_msb(bits) -> list[int]:
    assert len(bits) % 8 == 0
    return [
        sum(b << (7 - k) for k, b in enumerate(bits[i : i + 8]))
        for i in range(0, len(bits), 8)
    ]


def scramble_bits(bits, polynomial: int, invert: bool = False,
                  seed: int = 0) -> list[int]:
    """Inverse of ops/lfsr.descramble_bits: produce the line bits whose
    descramble equals ``bits``.  Solves b[n] = out[n] ^ seed[n] ^
    XOR_{j>0 in taps} b[n-j] (tap 0 is always set in the supported polys)."""
    taps = [j for j in poly_tap_positions(polynomial) if j > 0]
    out = list(bits)
    if invert:
        out = [b ^ 1 for b in out]
    line = [0] * len(out)
    for n in range(len(out)):
        b = out[n] ^ ((seed >> n) & 1 if n < seed.bit_length() else 0)
        for j in taps:
            if n - j >= 0:
                b ^= line[n - j]
        line[n] = b
    return line


def scramble_bytes(data, polynomial: int, invert: bool = False,
                   seed: int = 0) -> list[int]:
    return bits_to_bytes_msb(
        scramble_bits(bytes_to_bits_msb(data), polynomial, invert, seed)
    )


# ---------------------------------------------------------------------------
# AX.25 / HDLC
# ---------------------------------------------------------------------------


def ax25_address_field(dest: str, source: str, dest_ssid: int = 0,
                       source_ssid: int = 0) -> list[int]:
    """14-byte AX.25 address field (callsigns shifted left, final ext bit)."""
    out = [ord(c) << 1 for c in dest.ljust(6)[:6]]
    out.append(((dest_ssid & 0xF) << 1) + 0x60 + 0x80)  # command bit set
    out += [ord(c) << 1 for c in source.ljust(6)[:6]]
    out.append(((source_ssid & 0xF) << 1) + 0x60 + 0x01)  # extension bit
    return out


def ax25_ui_frame(dest: str, source: str, payload: bytes,
                  pid: int = 0xF0) -> list[int]:
    """Address + UI control (0x03) + PID + payload + CRC16 (little-endian)."""
    frame = ax25_address_field(dest, source)
    frame += [0x03, pid]
    frame += list(payload)
    crc = np_crc16(np.asarray(frame, dtype=np.uint8))
    frame += [crc & 0xFF, crc >> 8]
    return frame


def hdlc_encode(frame, flag_count: int = 4) -> list[int]:
    """Frame bytes -> HDLC bit stream: flags, LSB-first bits, zero stuffing
    after five 1s, closing flag."""
    flag = [0, 1, 1, 1, 1, 1, 1, 0]
    bits: list[int] = []
    for _ in range(flag_count):
        bits += flag
    ones = 0
    for bit in bytes_to_bits_lsb(frame):
        bits.append(bit)
        ones = ones + 1 if bit else 0
        if ones == 5:
            bits.append(0)
            ones = 0
    bits += flag
    return bits


# ---------------------------------------------------------------------------
# IL2P
# ---------------------------------------------------------------------------


def il2p_pack_header(dest: str, source: str, payload_count: int,
                     dest_ssid: int = 0, source_ssid: int = 0,
                     ui: bool = True, pid_nibble: int = 0xF,
                     control: int = 0x03) -> list[int]:
    """13 header bytes, the exact bit layout unpack_il2p_header reads
    (il2p.py:214-290), type-1."""
    buf = [0] * 13
    d = [ord(c) for c in dest.ljust(6)[:6]]
    s = [ord(c) for c in source.ljust(6)[:6]]
    for i in range(6):
        buf[i] |= (d[i] - 0x20) & 0x3F
        buf[i + 6] |= (s[i] - 0x20) & 0x3F
    buf[12] = ((dest_ssid & 0xF) << 4) | (source_ssid & 0xF)
    buf[1] |= 0x80  # header_type = 1
    if ui:
        buf[0] |= 0x40
    for i in range(10):  # 10-bit payload count, MSB in buf[2]
        if payload_count & (0x200 >> i):
            buf[i + 2] |= 0x80
    for i in range(4):
        if pid_nibble & (0x8 >> i):
            buf[i + 1] |= 0x40
    for i in range(7):
        if control & (0x40 >> i):
            buf[i + 5] |= 0x40
    return buf


def il2p_frame(dest: str, source: str, payload: bytes,
               append_crc: bool = True, ui: bool = True,
               pid_nibble: int = 0xF, control: int = 0x03) -> list[int]:
    """Full IL2P transmission unit: sync24 + RS(15,13) header + RS-coded
    scrambled payload blocks (+ Hamming CRC trailer).

    The trailing CRC covers what the *decoder* reconstructs: its
    re-synthesized AX.25 header plus the payload (il2p.py:432,503-518).
    """
    payload = list(payload)
    count = len(payload)
    header13 = il2p_pack_header(
        dest, source, count, ui=ui, pid_nibble=pid_nibble, control=control
    )
    out = [(SYNC24 >> 16) & 0xFF, (SYNC24 >> 8) & 0xFF, SYNC24 & 0xFF]
    scrambled = scramble_bytes(header13, SCRAMBLE_POLY, seed=SCRAMBLE_SEED)
    coded = rs_ops.rs_encode_np(rs_ops.RS_HEADER, np.asarray(scrambled))
    out += [int(v) for v in coded]

    if count:
        block_count, block_size, big_blocks = block_layout(count)
        sizes = [block_size + 1] * big_blocks
        sizes += [block_size] * (block_count - big_blocks)
        pos = 0
        for size in sizes:
            chunk = payload[pos : pos + size]
            pos += size
            scrambled = scramble_bytes(chunk, SCRAMBLE_POLY, seed=SCRAMBLE_SEED)
            coded = rs_ops.rs_encode_np(rs_ops.RS_BLOCK, np.asarray(scrambled))
            out += [int(v) for v in coded]

    if append_crc:
        header = Il2pHeader(
            header_type=1, count=count, pid_nibble=pid_nibble,
            control=control,
            dest=[ord(c) for c in dest.ljust(6)[:6]] + [0],
            source=[ord(c) for c in source.ljust(6)[:6]] + [0],
            ui=ui,
        )
        decoded_data = synthesize_ax25_header(header) + payload
        crc = np_crc16(np.asarray(decoded_data, dtype=np.uint8))
        for i in range(4):
            nibble = (crc >> (12 - 4 * i)) & 0xF
            out.append(HAMMING74_CODEWORDS[nibble])
    return out
