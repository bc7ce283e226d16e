"""IL2P decode fully on the device: batched bit and GF ops, no host FSM.

Port of ``pymodem_tpu.codecs.il2p_device``.  The sync scan (ops/sync.py)
yields candidate bit positions; every candidate decodes independently in
fixed shapes -- header, up to MAX_BLOCKS Reed-Solomon payload blocks and
the Hamming CRC trailer -- with all candidates batched through the
vectorized RS decoder (ops/rs.py ``rs_decode``).  A short scan over each
block's candidates then enforces the FSM's consumption rule: a sync match
inside an already-consumed packet span is ignored.

Known deviation from the bit-serial reference, kept as the JAX package
keeps it: sync matches that depend on carried word history (the 0xFFFFFF
seed in a stream's first 32 bits, or the last consumed byte right after a
packet) are not in the pure-bit candidate map; probability < 2^-20 per
boundary, and the exact host path (codecs/host.py) remains available for
parity runs.

Outputs are fixed-capacity packet buffers per block: (max_packets,
packet length) bytes, lengths, stream addresses, validity and corrected
counts, and a per-block ``dropped`` count that sends a block whose result
may be incomplete to the host FSM.  Integer stage: every output equals the
JAX package's value for value.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import constant
from ..ops import rs as rs_ops
from ..ops.bits import place_rows_shifted, take_rows_shifted
from ..ops.crc import crc16_masked
from ..ops.hamming import HAMMING74_DECODE
from ..ops.lfsr import descramble_bytes
from ..ops.sync import _POPCOUNT8
from .host import PID_TABLE, SCRAMBLE_POLY, SCRAMBLE_SEED, U_CONTROL

MAX_BLOCKS = 5  # ceil(1023 / 239), il2p.py:346-358
MAX_PAYLOAD = 1023
MAX_AX25_HEADER = 16
MAX_PACKET_LEN = MAX_AX25_HEADER + MAX_PAYLOAD + 2
_HAMMING = torch.from_numpy(HAMMING74_DECODE.astype(np.int64))
_PID = torch.tensor(PID_TABLE, dtype=torch.int64)
_UCTL = torch.tensor(U_CONTROL, dtype=torch.int64)
# the trailing CRC's four Hamming nibbles, most significant first
_NIBBLE_SHIFTS = torch.tensor([12, 8, 4, 0], dtype=torch.int64)
# _SETBIT_POS[v, r] = stream-order index (0 = MSB) of the (r+1)-th set bit
# of byte value v (unused ranks point at 0; rank validity is guaranteed by
# the popcount cumsum that produced the rank)
_SETBIT_POS = torch.zeros((256, 8), dtype=torch.int64)
for _v in range(256):
    _k = [i for i in range(8) if (_v >> (7 - i)) & 1]
    _SETBIT_POS[_v, : len(_k)] = torch.tensor(_k, dtype=torch.int64)
del _v, _k


def _parse_header(buf: torch.Tensor):
    """Unpack descrambled header bytes (il2p.py:214-290), one row per
    candidate.  buf: (T, 13) int64."""
    dev = buf.device
    i10 = torch.arange(10, device=dev)
    count = torch.where((buf[:, 2:12] & 0x80) != 0, 0x200 >> i10, 0).sum(1)
    i4 = torch.arange(4, device=dev)
    pid = torch.where((buf[:, 1:5] & 0x40) != 0, 0x8 >> i4, 0).sum(1)
    i7 = torch.arange(7, device=dev)
    control = torch.where((buf[:, 5:12] & 0x40) != 0, 0x40 >> i7, 0).sum(1)
    header_type = (buf[:, 1] & 0x80) >> 7
    ui = (buf[:, 0] & 0x40) != 0
    dest = (buf[:, :6] & 0x3F) + 0x20
    dest_ssid = buf[:, 12] >> 4
    source = (buf[:, 6:12] & 0x3F) + 0x20
    source_ssid = buf[:, 12] & 0xF
    return (count, pid, control, header_type, ui, dest, dest_ssid, source,
            source_ssid)


def _ax25_header(count, pid, control, header_type, ui, dest, dest_ssid,
                 source, source_ssid):
    """Re-synthesize the AX.25 header (il2p.py:292-344) in fixed shape.

    Returns (header_bytes (T, 16), header_len (T,)).  Type 0 -> length 0.
    """
    dev = pid.device
    # frame type: UI > (pid==0 -> S) > (pid==1 -> U) > I
    is_s = (~ui) & (pid == 0)
    is_u = (~ui) & (pid == 1)
    is_i = (~ui) & (pid > 1)

    pf = torch.where((control & 0x40) != 0, 0x10, 0)
    ns = control & 0x7
    nr = (control >> 3) & 0x7
    c_bit = torch.where(is_i, True, (control & 0x4) != 0)
    opcode = torch.where(is_s, control & 0x3, (control >> 3) & 0x7)

    dssid = (dest_ssid << 1) + 0x60 + torch.where(c_bit, 0x80, 0)
    sssid = (source_ssid << 1) + 0x60 + torch.where(c_bit, 0, 0x80) + 1
    u_ctl = constant(_UCTL, dev)[opcode.clamp(0, 7)] | pf
    s_ctl = 0x1 | (opcode << 2) | (nr << 5) | pf
    i_ctl = (ns << 1) | (nr << 5) | pf
    control_byte = torch.where(is_u | ui, u_ctl,
                               torch.where(is_s, s_ctl, i_ctl))
    pid_byte = constant(_PID, dev)[pid.clamp(0, 15)]
    has_pid = pid_byte != 0
    out = torch.cat([dest << 1, dssid[:, None], source << 1, sssid[:, None],
                     control_byte[:, None], pid_byte[:, None]], dim=1)
    length = torch.where(header_type == 1, torch.where(has_pid, 16, 15), 0)
    return out, length


def _descramble_fixed(data: torch.Tensor, n_valid) -> torch.Tensor:
    """Block descramble (il2p.py:160-163) along the last axis: feed-forward
    XOR with the 0x211/0x1F0 seed over each row's first ``n_valid`` bytes
    (an int, or one per row); the rest passed through."""
    out = descramble_bytes(data.to(torch.uint8), SCRAMBLE_POLY,
                           seed=SCRAMBLE_SEED).to(torch.int64)
    idx = torch.arange(data.shape[-1], device=data.device)
    if isinstance(n_valid, torch.Tensor):
        n_valid = n_valid[..., None]
    return torch.where(idx < n_valid, out, data.to(torch.int64))


def il2p_decode_blocks(data: torch.Tensor, sync_packed: torch.Tensor,
                       counts: torch.Tensor, addresses: torch.Tensor,
                       max_packets: int = 8, collect_crc: bool = True,
                       disable_rs: bool = False, min_distance: int = 0,
                       total_candidates: int | None = None,
                       total_rs_blocks: int | None = None,
                       scan_cap: int = 64,
                       rs_fail_frac: int | None = 2,
                       max_payload: int = MAX_PAYLOAD) -> dict:
    """Decode IL2P packets from byte-stream blocks, fully on the device.

    data: (..., K) uint8 descrambled stream bytes; sync_packed: (..., K)
    uint8 packed candidate bitmap (ops/sync.py); counts: (...,) valid byte
    counts; addresses: (..., K) per-byte stream addresses.

    Returns a dict of (..., max_packets, ...) tensors: ``packet`` bytes
    (uint8), ``length``, ``address``, ``ok`` (structurally complete),
    ``crc_ok``, ``corrected``, and the per-block ``dropped`` counts.

    ``total_candidates``: global candidate-slot capacity across the batch
    (default blocks * max_packets).  ``total_rs_blocks``: global payload-RS
    row budget (default 2 * total_candidates).  ``scan_cap``: candidates a
    block's acceptance scan visits.  ``rs_fail_frac``: the syndrome-zero
    split of the batched RS decodes (the correction path runs on ~1/frac
    of each decode chunk's rows; None turns it off).  ``max_payload``: the
    per-candidate payload-byte budget that shapes every per-candidate
    buffer.  Every budget's overflow marks the affected stream blocks
    ``dropped``, for the caller to escalate or decode on the host, so
    packets never depend on a budget.
    """
    batch_shape = data.shape[:-1]

    def flat(a):
        return a.reshape((-1,) + a.shape[len(batch_shape):])

    out = _il2p_decode_flat(
        flat(data), flat(sync_packed), counts.reshape(-1), flat(addresses),
        max_packets, collect_crc, disable_rs, min_distance, total_candidates,
        total_rs_blocks, scan_cap, rs_fail_frac, max_payload,
    )
    return {k: v.reshape(batch_shape + v.shape[1:]) for k, v in out.items()}


_RS_CHUNK = 2048  # rs_decode's default chunk_size


def _rs_fail_budget(rows: int, frac: int | None) -> int | None:
    """Per-chunk correction-row budget for the syndrome-zero split:
    ~rows/frac, bucketed {2^k, 1.5*2^k}.  None (or a budget that covers the
    whole chunk, or a batch under 512 rows) disables the split."""
    if frac is None or rows < 512:
        return None
    per = min(rows, _RS_CHUNK)
    need = max(64, per // frac + 32)
    p = 1 << (need - 1).bit_length()
    b = p - p // 4 if need <= p - p // 4 else p
    return b if b < per else None


def _candidate_spans(data, blk, start_bit, span_w):
    """(T, span_w) candidate-aligned bytes: span[t, i] is byte i of the bit
    stream of block ``blk[t]`` read from bit ``start_bit[t]``, zero past
    the block's K bytes.  Gathers the span_w + 1 source bytes each
    candidate needs straight from ``data`` (the JAX package shifts whole
    (T, K) candidate rows, then takes the window: the same bytes)."""
    N, K = data.shape
    dev = data.device
    byte0 = (start_bit // 8).clamp(0, K)
    col = byte0[:, None] + torch.arange(span_w + 1, device=dev)
    src = blk[:, None] * K + col.clamp(max=K - 1)
    g = data.reshape(-1)[src].to(torch.int32)
    g = torch.where(col < K, g, 0)
    shv = (start_bit % 8)[:, None].to(torch.int32)
    return (((g[:, :-1] << shv) | (g[:, 1:] >> (8 - shv))) & 0xFF).to(
        torch.uint8)


def _il2p_decode_flat(data, sync_packed, counts, addresses, max_packets,
                      collect_crc, disable_rs, min_distance,
                      total_candidates=None, total_rs_blocks=None,
                      scan_cap=64, rs_fail_frac=2,
                      max_payload=MAX_PAYLOAD):
    """Globally candidate-compacted decode.

    Candidates compact ACROSS the whole flattened block batch before any
    decode work, so the batched RS decodes scale with T candidate slots
    instead of blocks x max_packets.  Compaction keeps the (block, pos)
    order, so one scan with per-block resets enforces the FSM's span
    consumption rule; results scatter back to (N, max_packets) slots.
    """
    N, K = data.shape
    dev = data.device
    n_bits_total = K * 8
    counts = counts.to(torch.int64)
    T = total_candidates if total_candidates else N * max_packets
    T = max(T, 8)

    # ---- global compaction: flat index = block * K8 + pos (sorted) ----
    # byte-granular: the rank cumsum runs over byte popcounts, and the bit
    # within the source byte comes from the set-bit-position table
    masked = torch.where(torch.arange(K, device=dev)[None, :]
                         < counts[:, None], sync_packed, 0).to(torch.uint8)
    pcb2 = constant(_POPCOUNT8, dev)[masked.long()]  # (N, K)
    pcb = pcb2.reshape(-1)
    bcs = torch.cumsum(pcb, 0, dtype=torch.int32)
    total = bcs[-1]
    slots = torch.arange(1, T + 1, device=dev, dtype=torch.int32)
    bsrc = torch.searchsorted(bcs, slots).clamp(0, N * K - 1)
    cand_valid = slots <= total
    before = bcs[bsrc] - pcb[bsrc]
    rank_in_byte = (slots - 1 - before).clamp(0, 7)
    bytev = masked.reshape(-1)[bsrc].long()
    k_in = constant(_SETBIT_POS, dev)[bytev, rank_in_byte.long()]
    src = bsrc * 8 + k_in
    blk = src // n_bits_total
    pos = src % n_bits_total
    n_bits_of = counts[blk] * 8  # (T,)

    # ---- bit-aligned candidate spans ----
    # payload-byte budget shapes every per-candidate buffer; headers
    # announcing more mark their block dropped below
    mp = int(min(max(max_payload, 64), MAX_PAYLOAD))
    mb = -(-mp // 239)
    pkt_len = MAX_AX25_HEADER + mp + 2
    # header + max coded payload + CRC trailer, plus slack so the fixed
    # 255-wide block reads below never clamp
    span_w = 15 + mp + 16 * mb + 255
    spans = _candidate_spans(data, blk, pos + 1, span_w)

    # ---- per-candidate fixed-shape decode ----
    # dead tail slots (slots > total) read garbage span bytes; zero them so
    # the syndrome-zero split sees them clean
    hdr_raw = torch.where(cand_valid[:, None], spans[:, :15].long(), 0)
    hdr_ovf = torch.zeros((T,), dtype=torch.bool, device=dev)
    if disable_rs:
        hdr_corr, hdr_res = hdr_raw, torch.zeros((T,), dtype=torch.int64,
                                                 device=dev)
    else:
        fb_hdr = _rs_fail_budget(T, rs_fail_frac)
        out_h = rs_ops.rs_decode(
            hdr_raw, torch.full((T,), 15, dtype=torch.int64, device=dev),
            num_roots=2, min_distance=min_distance, fail_budget=fb_hdr,
        )
        if fb_hdr is None:
            hdr_corr, hdr_res = out_h
        else:
            hdr_corr, hdr_res, hdr_ovf = out_h
    hdr = _descramble_fixed(hdr_corr[:, :13], 13)

    parsed = _parse_header(hdr)
    hdr_fail = hdr_res < 0
    count = parsed[0].clamp(0, MAX_PAYLOAD)
    # a header announcing a payload past the budget cannot decode in these
    # shapes: zero its layout and mark the block dropped
    too_long = cand_valid & (~hdr_fail) & (count > mp)
    # failed headers and dead slots take no payload work
    count_live = torch.where(hdr_fail | ~cand_valid | too_long, 0, count)
    ax25, ax25_len = _ax25_header(*parsed)

    # block layout (il2p.py:346-358)
    block_count = (-(-count_live // 239)).clamp(min=0)
    base_size = torch.where(block_count > 0,
                            count_live // block_count.clamp(min=1), 0)
    big_blocks = count_live - block_count * base_size
    k_idx = torch.arange(mb, device=dev)[None, :]
    sizes = torch.where(
        k_idx < big_blocks[:, None], base_size[:, None] + 1,
        torch.where(k_idx < block_count[:, None], base_size[:, None], 0),
    )  # (T, mb)
    coded_sizes = torch.where(sizes > 0, sizes + 16, 0)
    coded_total = coded_sizes.sum(1)
    coded_cum = torch.cumsum(coded_sizes, 1)
    # byte offset of each coded block within the candidate span
    block_byte_off = 15 + (coded_cum - coded_sizes)

    # compact the LIVE (candidate, block) pairs before the 16-root RS
    # decode; budget overflow marks the candidate (host fallback)
    Rb = total_rs_blocks if total_rs_blocks else 2 * T
    Rb = min(max(Rb, 8), T * mb)
    flat_sizes = coded_sizes.reshape(-1)  # (T*mb,)
    live = flat_sizes > 0
    lcsum = torch.cumsum(live.to(torch.int64), 0)
    n_live = lcsum[-1]
    rs_slots = torch.arange(1, Rb + 1, device=dev)
    rs_src = torch.searchsorted(lcsum, rs_slots).clamp(0, T * mb - 1)
    rs_valid = rs_slots <= n_live
    rs_cand = rs_src // mb
    rs_off = block_byte_off.reshape(-1)[rs_src]
    rows_rs = take_rows_shifted(spans[rs_cand], rs_off, 255).long()
    rows_rs = torch.where(rs_valid[:, None], rows_rs, 0)
    sizes_rs = flat_sizes[rs_src].clamp(min=1)
    pay_ovf = torch.zeros((Rb,), dtype=torch.bool, device=dev)
    if disable_rs:
        bc_c, br_c = rows_rs, torch.zeros((Rb,), dtype=torch.int64,
                                          device=dev)
    else:
        fb_pay = _rs_fail_budget(Rb, rs_fail_frac)
        out_p = rs_ops.rs_decode(
            rows_rs, sizes_rs, num_roots=16, min_distance=min_distance,
            fail_budget=fb_pay,
        )
        if fb_pay is None:
            bc_c, br_c = out_p
        else:
            bc_c, br_c, pay_ovf = out_p
    # per-slot RS results scatter back to (T, mb)
    dest = lcsum - 1  # compact index of each live flat slot
    in_budget = live & (dest < Rb)
    safe_dest = dest.clamp(0, Rb - 1)
    blk_res = torch.where(in_budget, br_c[safe_dest], 0).reshape(T, mb)
    blk_ovf = (in_budget & pay_ovf[safe_dest]).reshape(T, mb)
    rs_overflow = (
        (live & ~in_budget).reshape(T, mb).any(1)
        | blk_ovf.any(1)
        | hdr_ovf
        | too_long
    )

    # descramble the corrected data bytes on the compact rows, route them
    # back to the (T, mb) slot grid, then place block k's data bytes at its
    # payload offset (blocks are disjoint in payload space)
    data_sizes_rs = (sizes_rs - 16).clamp(min=0)
    plain_rs = _descramble_fixed(bc_c, data_sizes_rs)
    col255 = torch.arange(255, device=dev)[None, :]
    upd = torch.where((col255 < data_sizes_rs[:, None]) & rs_valid[:, None],
                      plain_rs, 0).to(torch.uint8)
    pdata = torch.where(in_budget[:, None], upd[safe_dest], 0).to(
        torch.uint8).reshape(T, mb, 255)
    starts = torch.cumsum(sizes, 1) - sizes
    payload = torch.zeros((T, mp), dtype=torch.uint8, device=dev)
    pw = min(255, mp)  # block data bytes never exceed min(239, mp)
    for k in range(mb):
        payload = payload + place_rows_shifted(pdata[:, k, :pw],
                                               starts[:, k], mp)

    # trailing CRC (il2p.py:503-518): 4 bytes right after the coded payload
    crc_raw = take_rows_shifted(spans, 15 + coded_total, 4).long()
    nib = constant(_HAMMING, dev)[crc_raw & 0x7F]
    sh = constant(_NIBBLE_SHIFTS, dev)
    carried_crc = (nib << sh[None, :]).sum(1)

    # packet = ax25 header + payload (+2 CRC bytes): the payload, masked to
    # ``count`` bytes, is placed at its header offset
    slot = torch.arange(pkt_len, device=dev)[None, :]
    pay_idx = torch.arange(mp, device=dev)[None, :]
    pay_masked = torch.where(pay_idx < count[:, None], payload, 0).to(
        torch.uint8)
    placed = place_rows_shifted(pay_masked, ax25_len, pkt_len)
    hdr_pad = F.pad(ax25, (0, pkt_len - MAX_AX25_HEADER))
    pkt = torch.where(slot < ax25_len[:, None], hdr_pad, placed.long())
    data_len = ax25_len + count
    total_len = data_len + 2
    calc_crc = crc16_masked(pkt.to(torch.uint8), data_len)
    trail = carried_crc if collect_crc else calc_crc
    pkt = torch.where(slot == data_len[:, None], trail[:, None] & 0xFF, pkt)
    pkt = torch.where(slot == (data_len + 1)[:, None], trail[:, None] >> 8,
                      pkt)

    # span consumed (bits): sync bit + header + blocks (+ crc)
    span_ok = 1 + 120 + 8 * coded_total + (32 if collect_crc else 0)
    bad_blk = (blk_res < 0) & (coded_sizes > 0)
    blk_fail_any = bad_blk.any(1)
    first_bad = torch.argmax(bad_blk.to(torch.int32), dim=1)
    span_blk_fail = 1 + 120 + 8 * torch.gather(coded_cum, 1,
                                               first_bad[:, None])[:, 0]
    span = torch.where(hdr_fail, 1 + 120,
                       torch.where(blk_fail_any, span_blk_fail, span_ok))
    structural_ok = (
        cand_valid & (~hdr_fail) & (~blk_fail_any) & (~rs_overflow)
        & (pos + span <= n_bits_of) & (pos < n_bits_of)
    )
    corrected = hdr_res.clamp(min=0) + torch.where(
        coded_sizes > 0, blk_res.clamp(min=0), 0).sum(1)

    # ---- acceptance scan (candidates are (block, pos)-ordered) ----
    # ``take`` consumes the candidate's span (the FSM moves past a failed
    # RS decode's bytes too); only EMITTED packets count towards a block's
    # max_packets.  Candidates sit contiguously per block, so the scan runs
    # scan_cap steps of (N,)-wide ops over per-block windows; a block with
    # more than scan_cap candidates reports the excess as ``dropped``.
    # dead tail slots go past every real block
    blk_s = torch.where(cand_valid, blk, N)
    bstart = torch.searchsorted(blk_s, torch.arange(N + 1, device=dev,
                                                    dtype=blk_s.dtype))
    bcount = bstart[1:] - bstart[:-1]  # (N,) candidates per block
    starts_b = bstart[:-1]
    win_idx = starts_b[:, None] + torch.arange(scan_cap, device=dev)

    def win(a):
        return F.pad(a, (0, scan_cap))[win_idx]  # (N, scan_cap)

    pos2 = win(pos)
    end2 = pos2 + win(span)
    inb = torch.arange(scan_cap, device=dev)[None, :] < bcount[:, None]
    live2 = (win(cand_valid.to(torch.int32)) > 0) & inb
    s2 = win(structural_ok.to(torch.int32)) > 0
    moves2 = pos2 < (counts * 8)[:, None]  # inside the block's valid bits
    resume = torch.zeros((N,), dtype=pos.dtype, device=dev)
    emit_cols = []
    for j in range(scan_cap):
        p = pos2[:, j]
        take = live2[:, j] & (p >= resume)
        resume = torch.where(take & moves2[:, j], end2[:, j], resume)
        emit_cols.append(take & s2[:, j])
    emit2 = torch.stack(emit_cols, dim=1)  # (N, scan_cap)
    # each candidate's rank: the packets the block emitted before it
    emit2_i = emit2.to(torch.int64)
    rank2 = torch.cumsum(emit2_i, 1) - emit2_i
    # windowed scatter back to flat candidate slots (a window may overlap
    # the next block's region; masked entries add zero)
    flat_idx = win_idx.reshape(-1)
    emit = torch.zeros((T + scan_cap,), dtype=torch.int64, device=dev)
    emit.index_add_(0, flat_idx, (emit2 & inb).to(torch.int64).reshape(-1))
    emit = emit[:T] > 0
    rank = torch.zeros((T + scan_cap,), dtype=torch.int64, device=dev)
    rank.index_add_(0, flat_idx, torch.where(inb, rank2, 0).reshape(-1))
    rank = rank[:T]
    scan_over = (bcount - scan_cap).clamp(min=0)

    last_bit = (pos + span - 1).clamp(0, n_bits_total - 1)
    address = addresses[blk, (last_bit // 8).clamp(0, K - 1)].to(torch.int64)
    crc_ok = (calc_crc == carried_crc) if collect_crc else torch.ones_like(
        emit)

    # ---- scatter back to (N, max_packets) slots ----
    # not-emitted candidates land in a dummy row N, sliced off
    out_blk = torch.where(emit & (rank < max_packets), blk, N)
    out_rank = rank.clamp(0, max_packets - 1)

    def scatter(values, fill=0):
        buf = torch.full((N + 1, max_packets) + tuple(values.shape[1:]),
                         fill, dtype=values.dtype, device=dev)
        buf[out_blk, out_rank] = values
        return buf[:N]

    def per_block(mask):
        # a histogram by scatter-add: bincount reads its input's maximum
        # back to the host, which waits for the whole stream
        idx = torch.where(mask, blk, N)
        return torch.zeros(N + 1, dtype=torch.int64, device=dev).scatter_add_(
            0, idx, torch.ones_like(idx))[:N]

    # per-block saturation: candidates lost to global compaction (slot
    # budget T exhausted), emitted packets beyond max_packets, RS and
    # payload budget overflows, and candidates past the scan's reach.
    # dropped > 0 means this block's result may be incomplete.
    per_block_cands = pcb2.sum(1)
    dropped = ((per_block_cands - per_block(cand_valid))
               + per_block(emit & (rank >= max_packets))
               + per_block(cand_valid & rs_overflow) + scan_over)

    return {
        "packet": scatter(pkt.to(torch.uint8)),
        "length": scatter(torch.where(emit, total_len, 0)),
        "address": scatter(torch.where(emit, address, 0)),
        "ok": scatter(emit),
        "crc_ok": scatter(emit & crc_ok),
        "corrected": scatter(torch.where(emit, corrected, 0)),
        "dropped": dropped,
    }
