"""CRC-16 (X.25 / CRC-CCITT reflected, poly 0x8408), on the host and the
device.

Port of ``pymodem_tpu.ops.crc``: numpy copies of its host functions, and
its masked device CRC (``crc16_masked``) on torch tensors, which imports
torch when called (the host half serves the torch-free synthesizer).  The reference
computes the
CRC bit-serially per packet (crc_functions.py:44-55, init 0xFFFF, final xor
0xFFFF, LSB-first) and declares a packet valid when the carried CRC --
little-endian in the last two bytes -- exactly equals the calculated one.
The byte-at-a-time table form here is algebraically identical.
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
    """Hamming distance between a packet's carried and calculated CRCs
    (the reference's ``Distance8`` near-miss metric, crc_functions.py:14-61)."""
    return int(bin((carried ^ calculated) & 0xFFFF).count("1"))


def np_check_packet(data: np.ndarray,
                    max_distance: int = 0) -> tuple[int, int, bool]:
    """(carried, calculated, valid) for a packet whose last two bytes carry
    the CRC little-endian (crc_functions.py:9-61); ``max_distance`` is the
    reference's near-miss knob, 0 (equality) in its shipped CheckCRC."""
    data = np.asarray(data)
    carried = int(data[-1]) * 256 + int(data[-2])
    calc = np_crc16(data[:-2])
    return carried, calc, crc_bit_distance(carried, calc) <= max_distance


def np_append_crc(data: list[int]) -> None:
    """Append CRC low byte then high byte in place (crc_functions.py:63-76)."""
    crc = np_crc16(np.asarray(data, dtype=np.uint8))
    data.append(crc & 0xFF)
    data.append(crc >> 8)


def _crc_apply_map(rows: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Apply a GF(2)-linear 16->16 map (given as images of the 16 basis
    bits) to an array of uint values."""
    r = np.zeros_like(np.asarray(v, dtype=np.uint32))
    for j in range(16):
        r ^= np.where((v >> j) & 1, np.uint32(rows[j]), np.uint32(0))
    return r


_CRC_LIN_CACHE: dict[int, tuple] = {}


def _crc_linear_ops(n: int):
    """Static GF(2) operators for the matmul CRC over an n-byte buffer.

    The byte step ``crc' = (crc >> 8) ^ table[(crc ^ b) & 0xFF]`` is affine
    over GF(2): with L(c) = (c >> 8) ^ table[c & 0xFF] and T(b) = table[b]
    (both linear), crc' = L(crc) ^ T(b).  Unrolled over a fixed n-byte
    zero-padded buffer:

        crc_n = L^n(init)  ^  XOR_i  (L^(n-1-i) o T)(byte_i)

    which is ONE binary matrix product over the buffer's bits instead of an
    n-step scan.  The masked (first-``length``-bytes) state is recovered by
    inverting the trailing ``n - length`` zero-byte steps: crc_len =
    L^-(n-length)(crc_n), applied per row by binary decomposition of the
    exponent.

    Returns (M (n*8, 16) float32, init_n uint16, inv_tabs (K, 2, 256)
    uint16 hi/lo lookup tables for L^(-2^k)).
    """
    if n in _CRC_LIN_CACHE:
        return _CRC_LIN_CACHE[n]
    tab = CRC_TABLE.astype(np.uint32)

    def L_apply(c):
        c = np.asarray(c, dtype=np.uint32)
        return (c >> 8) ^ tab[c & 0xFF]

    # positional maps: M_rows[i] = images of byte-bit basis under L^(n-1-i) o T
    t_rows = tab[np.uint32(1) << np.arange(8, dtype=np.uint32)]
    m_rows = np.zeros((n, 8), dtype=np.uint32)
    cur = t_rows.copy()
    for i in range(n - 1, -1, -1):
        m_rows[i] = cur
        cur = L_apply(cur)
    bit_w = np.arange(16, dtype=np.uint32)
    m = ((m_rows[..., None] >> bit_w) & 1).reshape(n * 8, 16).astype(
        np.float32)

    init_n = np.uint32(0xFFFF)
    for _ in range(n):
        init_n = L_apply(init_n)

    # L as a GF(2) matrix, inverted by Gaussian elimination (L is invertible:
    # the polynomial has its constant term set, so x^8 is a unit mod poly)
    l_rows = L_apply(np.uint32(1) << bit_w)
    lm = ((l_rows[:, None] >> bit_w) & 1).astype(np.uint8)  # lm[b, j]
    aug = np.concatenate([lm, np.eye(16, dtype=np.uint8)], axis=1)
    for col in range(16):
        piv = col + int(np.argmax(aug[col:, col]))
        assert aug[piv, col], "CRC step map must be invertible"
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        elim = (aug[:, col] == 1) & (np.arange(16) != col)
        aug[elim] ^= aug[col]
    inv_rows = np.zeros(16, dtype=np.uint32)
    for b in range(16):
        inv_rows[b] = int(np.sum(aug[b, 16:].astype(np.uint32) << bit_w))
    # binary-power hi/lo byte tables for L^(-2^k), k up to covering z <= n
    n_k = max(int(n).bit_length(), 1)
    bytes_256 = np.arange(256, dtype=np.uint32)
    inv_tabs = np.zeros((n_k, 2, 256), dtype=np.uint16)
    p_rows = inv_rows
    for k in range(n_k):
        inv_tabs[k, 0] = _crc_apply_map(p_rows, bytes_256 << 8)
        inv_tabs[k, 1] = _crc_apply_map(p_rows, bytes_256)
        p_rows = _crc_apply_map(p_rows, p_rows)  # compose: P o P
    _CRC_LIN_CACHE[n] = (m, np.uint16(init_n), inv_tabs)
    return _CRC_LIN_CACHE[n]


def crc16_masked(data: torch.Tensor, length: torch.Tensor,
                 chunk_size: int = 2048) -> torch.Tensor:
    """CRC of the first ``length`` bytes of a fixed-size buffer (device).

    data: (..., L) uint8; length: (...) integers.  Bytes at index >= length
    do not affect the result.  The GF(2) product of _crc_linear_ops is a
    float32 matmul of 0/1 operands (each sum counts at most 8*L ones, exact
    in float32), in chunks of ``chunk_size`` rows; the exponent unwind is
    table lookups.  The state is held in int64 (torch has no usable
    uint16/uint32 on CUDA).  Returns (...) int64 CRC values.
    """
    import torch

    from ..device import constant

    max_len = data.shape[-1]
    batch_shape = data.shape[:-1]
    dev = data.device
    d2 = data.reshape(-1, max_len)
    len2 = torch.broadcast_to(torch.as_tensor(length, device=dev),
                              batch_shape).reshape(-1).to(torch.int64)
    m, init_n, inv_tabs = _crc_linear_ops(max_len)
    m_t = constant(m, dev)
    idx = torch.arange(max_len, device=dev)
    d2 = torch.where(idx[None, :] < len2[:, None], d2, 0).to(torch.uint8)
    shifts8 = torch.arange(8, dtype=torch.uint8, device=dev)
    weights16 = torch.arange(16, device=dev)
    parts = []
    for lo in range(0, d2.shape[0], chunk_size):
        rows = d2[lo : lo + chunk_size]
        bits = ((rows[..., None] >> shifts8) & 1).reshape(
            rows.shape[0], max_len * 8).to(torch.float32)
        prod = torch.matmul(bits, m_t).to(torch.int64)
        parts.append(((prod & 1) << weights16).sum(1))
    crc = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64,
                                                     device=dev)
    crc = crc ^ int(init_n)
    z = max_len - len2.clamp(0, max_len)
    tabs = constant(inv_tabs, dev).long()
    for k in range(inv_tabs.shape[0]):
        stepped = tabs[k, 0][(crc >> 8) & 0xFF] ^ tabs[k, 1][crc & 0xFF]
        crc = torch.where(((z >> k) & 1) == 1, stepped, crc)
    return (crc ^ 0xFFFF).reshape(batch_shape)
