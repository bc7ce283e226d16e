"""Host (numpy/python) codecs: the reference-exact state machines.

Re-homed copy of ``pymodem_tpu.codecs.host`` (the JAX package's module
reaches jax through its RS import).  These bit-exact mirrors of the
reference FSMs run on the host in the port's banked host-codec route, fed
by the device-computed byte streams and sync candidate maps, and decode
the blocks the device codecs mark ``dropped``.  Codec input is tiny (the
slicer emits ~1 byte per 8 symbols), so host execution costs microseconds
per block.

AX.25 deframer semantics (reference ax25.py:25-93):
* bytes assemble LSB-first via right-shifts; input bits MSB-first per byte
* run of five 1s -> next 0 is stuffed padding, dropped
* run of six 1s + 0 -> flag: close the packet if >= 18 bytes collected and
  the flag lands byte-aligned (bit_index == 7)
* run of > 6 ones -> abort (byte/bit counters reset, collected bytes REMAIN
  in the working packet -- a reference quirk kept)
* a packet's data is everything collected since the previous flag.

IL2P codec semantics (reference il2p.py:109-519): see Il2pDecoder below.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import rs_host as rs_ops
from ..ops.crc import np_append_crc
from ..ops.hamming import hamming74_decode
from ..ops.lfsr import np_descramble_bytes
from ..packets import Packet

# ---------------------------------------------------------------------------
# AX.25 / HDLC
# ---------------------------------------------------------------------------


def ax25_decode_host(data: np.ndarray, addresses: np.ndarray, ident,
                     min_packet_length: int = 18,
                     max_packet_length: int = 1023) -> list[Packet]:
    packets: list[Packet] = []
    collected: list[int] = []
    working = 0
    one_run = 0
    bit_index = 0
    byte_index = 0
    for value, address in zip(np.asarray(data), np.asarray(addresses)):
        value = int(value)
        for bit_pos in range(7, -1, -1):
            bit = (value >> bit_pos) & 1
            if bit:
                working |= 0x80
                one_run += 1
                bit_index += 1
                if one_run > 6:  # abort: reset counters, keep collected bytes
                    bit_index = 0
                    byte_index = 0
                if bit_index == 8:
                    bit_index = 0
                    collected.append(working)
                    byte_index += 1
                    if byte_index > max_packet_length:
                        byte_index = 0
                        one_run = 0
                working >>= 1
            else:
                if one_run < 5:
                    bit_index += 1
                    if bit_index == 8:
                        bit_index = 0
                        collected.append(working)
                        byte_index += 1
                        if byte_index > max_packet_length:
                            byte_index = 0
                    working >>= 1
                elif one_run == 5:
                    pass  # stuffed zero
                elif one_run == 6:  # flag (one_run > 6 only resets the count)
                    if byte_index >= min_packet_length and bit_index == 7:
                        packets.append(
                            Packet(
                                data=collected,
                                streamaddress=int(address),
                                source_decoder=ident,
                            )
                        )
                    collected = []
                    byte_index = 0
                    bit_index = 0
                one_run = 0
    return packets


# ---------------------------------------------------------------------------
# IL2P
# ---------------------------------------------------------------------------

SYNC24 = 0xF15E48  # il2p.py:370
SYNC32 = 0x5D57DF7F  # il2p.py:372
SCRAMBLE_POLY = 0x211  # x^9+x^4+1, il2p.py:128-129
SCRAMBLE_SEED = 0x1F0  # il2p.py:161
MAX_PAYLOAD_BLOCK = 239

# IL2P PID nibble -> AX.25 PID byte; 0 means "omit" (il2p.py:267)
PID_TABLE = (0, 0, 0x10, 0x01, 0x06, 0x07, 0x08, 0xC3, 0xC4, 0xCA, 0xCB,
             0xCC, 0xCD, 0xCE, 0xCF, 0xF0)
# AX.25 unnumbered-frame control opcodes (il2p.py:91)
U_CONTROL = (0x2F, 0x43, 0x0F, 0x63, 0x87, 0x03, 0xAF, 0xE3)


def _popcount32(value: int) -> int:
    return bin(value & 0xFFFFFFFF).count("1")


@dataclass
class Il2pHeader:
    header_type: int
    count: int
    pid_nibble: int
    control: int
    dest: list[int]
    source: list[int]
    ui: bool


def parse_il2p_header(buf) -> Il2pHeader:
    """Unpack the 13 descrambled header bytes (il2p.py:214-290)."""
    count = 0
    for i in range(10):
        if int(buf[i + 2]) & 0x80:
            count |= 0x200 >> i
    pid = 0
    for i in range(4):
        if int(buf[i + 1]) & 0x40:
            pid |= 0x8 >> i
    control = 0
    for i in range(7):
        if int(buf[i + 5]) & 0x40:
            control |= 0x40 >> i
    dest = [(int(buf[i]) & 0x3F) + 0x20 for i in range(6)] + [int(buf[12]) >> 4]
    source = [(int(buf[i + 6]) & 0x3F) + 0x20 for i in range(6)] + [int(buf[12]) & 0xF]
    return Il2pHeader(
        header_type=(int(buf[1]) & 0x80) >> 7,
        count=count,
        pid_nibble=pid,
        control=control,
        dest=dest,
        source=source,
        ui=bool(int(buf[0]) & 0x40),
    )


def synthesize_ax25_header(h: Il2pHeader) -> list[int]:
    """Re-create the AX.25 header bytes from IL2P fields (il2p.py:89-107,
    248-344).  Returns [] for type-0 (transparent) headers."""
    if h.header_type != 1:
        return []
    if h.ui:
        ax25_type = "UI"
    elif h.pid_nibble == 0x0:
        ax25_type = "S"
    elif h.pid_nibble == 0x1:
        ax25_type = "U"
    else:
        ax25_type = "I"

    pf_bit = bool(h.control & 0x40)
    c_bit = False
    nr = ns = opcode = 0
    if ax25_type == "I":
        ns = h.control & 0x7
        nr = (h.control >> 3) & 0x7
        c_bit = True
    elif ax25_type == "S":
        nr = (h.control >> 3) & 0x7
        c_bit = bool(h.control & 0x4)
        opcode = h.control & 0x3
    else:  # U / UI
        c_bit = bool(h.control & 0x4)
        opcode = (h.control >> 3) & 0x7

    out = [h.dest[i] << 1 for i in range(6)]
    ssid = (h.dest[6] << 1) + 0x60
    if c_bit:
        ssid += 0x80
    out.append(ssid)
    out += [h.source[i] << 1 for i in range(6)]
    ssid = (h.source[6] << 1) + 0x60
    if not c_bit:
        ssid += 0x80
    ssid += 1  # extension bit on the final address byte
    out.append(ssid)

    if ax25_type in ("U", "UI"):
        control_byte = U_CONTROL[opcode]
        if pf_bit:
            control_byte |= 0x10
    elif ax25_type == "S":
        control_byte = 0x1 | (opcode << 2) | (nr << 5)
        if pf_bit:
            control_byte |= 0x10
    else:  # I
        control_byte = (ns << 1) | (nr << 5)
        if pf_bit:
            control_byte |= 0x10
    out.append(control_byte)

    pid_byte = PID_TABLE[h.pid_nibble]
    if pid_byte != 0:
        out.append(pid_byte)
    return out


def block_layout(count: int) -> tuple[int, int, int]:
    """(block_count, small_block_size, big_blocks) for a payload byte count
    (il2p.py:346-358)."""
    block_count = -(-count // MAX_PAYLOAD_BLOCK)
    block_size = int(count / block_count)
    big_blocks = count - block_count * block_size
    return block_count, block_size, big_blocks


class Il2pDecoder:
    """Bit-serial IL2P decoder, behaviourally identical to il2p.py:360-519.

    Carried state across input bytes: the 32-bit sliding word (shared between
    sync search and byte collection, so its masking history affects sync
    re-acquisition -- preserved) and the working packet.
    """

    def __init__(self, ident, collect_trailing_crc=True, disable_rs=False,
                 min_distance=0, sync_tolerance=0):
        self.ident = ident
        self.collect_crc = collect_trailing_crc
        self.disable_rs = disable_rs
        self.min_distance = min_distance
        self.sync_tolerance = sync_tolerance
        self.word = 0xFFFFFF
        self.buffer: list[int] = []
        self.packet_data: list[int] = []
        self.bytes_corrected = 0

    def _rs_decode(self, code: rs_ops.RSCode) -> bool:
        """Decode self.buffer in place; True on failure."""
        if self.disable_rs:
            return False
        buf = np.array(self.buffer, dtype=np.int32)
        result = rs_ops.rs_decode_np(code, buf, len(buf), self.min_distance)
        self.buffer = [int(v) for v in buf]
        if result < 0:
            return True
        self.bytes_corrected += result
        return False

    def _descramble(self, n: int) -> None:
        head = np_descramble_bytes(
            np.array(self.buffer[:n], dtype=np.uint8), SCRAMBLE_POLY,
            seed=SCRAMBLE_SEED,
        )
        self.buffer[:n] = [int(v) for v in head]

    @staticmethod
    def _word_at(bits: np.ndarray, i: int) -> int:
        """32-bit sliding-window value ending at bit i (pure bits, i >= 31)."""
        word = 0
        for b in bits[i - 31 : i + 1]:
            word = (word << 1) | int(b)
        return word

    @staticmethod
    def _find_sync(bits: np.ndarray, start: int, word: int,
                   tolerance: int) -> tuple[int, int] | None:
        """First bit index >= start where the sliding 32-bit word matches a
        syncword, plus the word value there; None if no match.

        The first 32 positions evolve the caller's carried word serially
        (its history -- seed 0xFFFFFF at stream start, or the last collected
        byte after a packet/abort -- still occupies the high bits, exactly
        as il2p.py:367-376).  Beyond 32 bits the word is a pure function of
        the bit stream, so matches are found with vectorized popcounts.
        """
        n = len(bits)
        for i in range(start, min(start + 32, n)):
            word = ((word << 1) | int(bits[i])) & 0xFFFFFFFF
            if (
                _popcount32((word & 0xFFFFFF) ^ SYNC24) <= tolerance
                or _popcount32(word ^ SYNC32) <= tolerance
            ):
                return i, word
        base = start + 32
        if base >= n:
            return None
        m = n - base
        v = np.zeros(m, dtype=np.uint64)
        for k in range(32):
            v = (v << np.uint64(1)) | bits[base - 31 + k : base - 31 + k + m]
        d24 = np.bitwise_count((v & np.uint64(0xFFFFFF)) ^ np.uint64(SYNC24))
        d32 = np.bitwise_count(v ^ np.uint64(SYNC32))
        hits = np.flatnonzero((d24 <= tolerance) | (d32 <= tolerance))
        if hits.size == 0:
            return None
        idx = int(hits[0])
        return base + idx, int(v[idx])

    def _find_sync_from_candidates(self, bits: np.ndarray, start: int,
                                   word: int) -> tuple[int, int] | None:
        """Like _find_sync but jumps through device-precomputed candidate
        indices (ops/sync.py) instead of rescanning on host."""
        n = len(bits)
        for i in range(start, min(start + 32, n)):
            word = ((word << 1) | int(bits[i])) & 0xFFFFFFFF
            if (
                _popcount32((word & 0xFFFFFF) ^ SYNC24) <= self.sync_tolerance
                or _popcount32(word ^ SYNC32) <= self.sync_tolerance
            ):
                return i, word
        # Candidate maps may be built at a bank-wide (max) tolerance; re-check
        # each candidate against THIS chain's tolerance before accepting, so a
        # low-tolerance chain banked with a high-tolerance one never syncs on
        # a near-miss word the reference would reject (il2p.py:367-376).
        pos = np.searchsorted(self.sync_candidates, start + 32)
        while pos < len(self.sync_candidates):
            i = int(self.sync_candidates[pos])
            w = self._word_at(bits, i)
            if (
                _popcount32((w & 0xFFFFFF) ^ SYNC24) <= self.sync_tolerance
                or _popcount32(w ^ SYNC32) <= self.sync_tolerance
            ):
                return i, w
            pos += 1
        return None

    def _collect(self, bits: np.ndarray, pos: int, count: int) -> int | None:
        """Collect ``count`` bytes from the bit stream into self.buffer;
        returns the new bit position or None if the stream ends first."""
        end = pos + 8 * count
        if end > len(bits):
            return None
        self.buffer = [int(b) for b in np.packbits(bits[pos:end])]
        return end

    def decode(self, data: np.ndarray, addresses: np.ndarray,
               sync_candidates: np.ndarray | None = None) -> list[Packet]:
        """Decode a byte stream; sync-search is vectorized (the FSM only runs
        from candidate sync positions), byte collection is array slicing.
        Behaviourally identical to the reference's per-bit FSM
        (il2p.py:360-519); asserted bit-exact in tests/test_codec_differential.

        ``sync_candidates``: optional sorted bit indices (>= 32) where the
        history-free 32-bit window matches a syncword, e.g. from the device
        scan in ops/sync.py; skips the host-side rescan entirely.
        """
        data = np.asarray(data).astype(np.uint8)
        addresses = np.asarray(addresses)
        bits = np.unpackbits(data).astype(np.uint64)
        n = len(bits)
        self.sync_candidates = (
            None if sync_candidates is None else np.asarray(sync_candidates)
        )
        packets: list[Packet] = []
        pos = 0
        word = self.word
        while pos < n:
            if self.sync_candidates is not None:
                found = self._find_sync_from_candidates(bits, pos, word)
            else:
                found = self._find_sync(bits, pos, word, self.sync_tolerance)
            if found is None:
                break
            pos, word = found
            pos += 1
            self.packet_data = []
            self.bytes_corrected = 0
            # --- header: 15 bytes = 13 + 2 RS parity (il2p.py:377-432)
            nxt = self._collect(bits, pos, 15)
            if nxt is None:
                break
            pos = nxt
            word = self.buffer[-1]  # raw last byte: the 8-bit rx word state
            fail = self._rs_decode(rs_ops.RS_HEADER)
            self._descramble(13)
            header = parse_il2p_header(self.buffer)
            self.packet_data = synthesize_ax25_header(header)
            if fail:
                continue
            if header.count > 0:
                block_count, block_size, big_blocks = block_layout(header.count)
                sizes = [block_size + 1] * big_blocks
                sizes += [block_size] * (block_count - big_blocks)
                failed = False
                for size in sizes:
                    nxt = self._collect(bits, pos, size + 16)
                    if nxt is None:
                        break
                    pos = nxt
                    word = self.buffer[-1]
                    fail = self._rs_decode(rs_ops.RS_BLOCK)
                    self._descramble(size)
                    self.packet_data.extend(self.buffer[:size])
                    if fail:
                        failed = True
                        break
                else:
                    failed = False
                if nxt is None:
                    break
                if failed:
                    continue
            if self.collect_crc:
                nxt = self._collect(bits, pos, 4)
                if nxt is None:
                    break
                pos = nxt
                word = self.buffer[-1]
                crc16 = 0
                for i in range(4):
                    crc16 |= hamming74_decode(self.buffer[i]) << (12 - 4 * i)
                self.packet_data.append(crc16 & 0xFF)
                self.packet_data.append(crc16 >> 8)
            else:
                np_append_crc(self.packet_data)
            packets.append(
                Packet(
                    data=self.packet_data,
                    streamaddress=int(addresses[(pos - 1) // 8]),
                    source_decoder=self.ident,
                    bytes_corrected=self.bytes_corrected,
                )
            )
            self.packet_data = []
        return packets


def il2p_seeded_sync_possible(first_bytes: np.ndarray, tolerance: int = 0) -> bool:
    """Whether the seeded 0xFFFFFF word can sync within the first 32 bits.

    The device candidate map (ops/sync.py) is a pure function of the bits;
    the only matches it can miss are in a stream's first 32 bits where the
    decoder's initial word still occupies the window.  This 32-step check
    closes that gap so empty-candidate blocks can be skipped exactly.
    """
    word = 0xFFFFFF
    for byte in np.asarray(first_bytes[:4], dtype=np.int64):
        for k in range(7, -1, -1):
            word = ((word << 1) | ((int(byte) >> k) & 1)) & 0xFFFFFFFF
            if (
                _popcount32((word & 0xFFFFFF) ^ SYNC24) <= tolerance
                or _popcount32(word ^ SYNC32) <= tolerance
            ):
                return True
    return False


def il2p_seeded_sync_any(first_bytes: np.ndarray, tolerance: int = 0) -> np.ndarray:
    """Vectorized il2p_seeded_sync_possible over a batch: first_bytes
    (..., 4) uint8 -> (...) bool."""
    fb = np.asarray(first_bytes, dtype=np.uint64)
    word = np.full(fb.shape[:-1], 0xFFFFFF, dtype=np.uint64)
    hit = np.zeros(fb.shape[:-1], dtype=bool)
    for byte_i in range(4):
        for k in range(7, -1, -1):
            bit = (fb[..., byte_i] >> np.uint64(k)) & np.uint64(1)
            word = ((word << np.uint64(1)) | bit) & np.uint64(0xFFFFFFFF)
            hit |= (
                np.bitwise_count((word & np.uint64(0xFFFFFF)) ^ np.uint64(SYNC24))
                <= tolerance
            ) | (np.bitwise_count(word ^ np.uint64(SYNC32)) <= tolerance)
    return hit


def il2p_decode_host(data: np.ndarray, addresses: np.ndarray, ident,
                     collect_trailing_crc=True, disable_rs=False,
                     min_distance=0, sync_tolerance=0,
                     sync_candidates: np.ndarray | None = None) -> list[Packet]:
    return Il2pDecoder(
        ident,
        collect_trailing_crc=collect_trailing_crc,
        disable_rs=disable_rs,
        min_distance=min_distance,
        sync_tolerance=sync_tolerance,
    ).decode(data, addresses, sync_candidates=sync_candidates)
