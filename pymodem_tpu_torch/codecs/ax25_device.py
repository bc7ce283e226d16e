"""AX.25/HDLC deframing on the device: the bit FSM (kernel K9) + vectorized
packetization.

Port of ``pymodem_tpu.codecs.ax25_device``.  The reference deframer
(ax25.py:25-93) is a per-bit Python FSM; the JAX package runs it as one
``lax.scan`` over each block's bits (``_ax25_flat``), emitting per bit
(completed byte, byte-done flag, flag, closing flag), and compacts those
into a dense byte stream tagged with segment ids (flags start new
segments) plus the closing flags' positions.  Here the scan and that
compaction are one step, ``ax25_deframe_rows``: kernel K9
(``csrc/ax25_deframe.cu``, a bit-parallel scan, a block of 4 warps a
(chain, block) row) on the card,
the plain twin ``ax25_deframe`` (a loop over bits with the JAX step's
selects, vectorized across rows, then the JAX compaction) on the CPU.
Packet extraction is then plain tensor work, as in the JAX package: each
closing flag gathers its segment's bytes into a fixed-capacity packet
buffer and checks the CRC (``ops/crc.crc16_masked``).

Semantics preserved from the reference, including the quirks: a stuffed
zero after five 1s is dropped; a run of >6 ones resets the bit/byte
counters but keeps already-collected bytes in the working packet; a flag
closes the packet only when >= min_packet_length bytes collected and the
bit phase lands on 7.  Deviation, kept as the JAX package keeps it: the
reference's max-packet-length overflow path also zeroes ``one_count`` when
the overflowing bit is a 1 (ax25.py:46-52), subtly changing stuffing state
for >1023-byte frames; such frames are CRC-garbage in practice and this
path treats the overflow as a plain counter reset.  Integer stage: every
output equals the JAX package's value for value (``packet`` is uint8
here, int32 there).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.crc import crc16_masked

_SEG_FILL = 1 << 30  # stream_seg of an unfilled stream slot


def ax25_decode_blocks(data: torch.Tensor, counts: torch.Tensor,
                       addresses: torch.Tensor, max_packets: int = 8,
                       max_packet_len: int | None = None,
                       min_packet_length: int = 18,
                       max_packet_length: int = 1023) -> dict:
    """Deframe HDLC packets from byte-stream blocks on the device.

    data: (..., K) uint8; counts: (...,) int32 valid byte counts;
    addresses: (..., K) per-byte stream addresses.  Returns
    (..., max_packets, ...) buffers: ``packet`` (uint8), ``length``,
    ``address``, ``ok``, ``crc_ok``, and the per-block ``dropped`` count
    of closing flags past ``max_packets`` (the result is incomplete there;
    callers fall back to the host FSM).

    ``max_packet_len`` (packet-buffer width) defaults to
    ``max_packet_length + 2`` -- the largest frame the FSM can close
    (payload cap + CRC, ax25.py:15).  A caller-narrowed buffer never
    truncates silently: frames longer than the buffer are marked not-ok.
    """
    if max_packet_len is None:
        max_packet_len = max_packet_length + 2
    batch = data.shape[:-1]
    K = data.shape[-1]
    fsm = ax25_deframe_rows(
        data.reshape(-1, K).contiguous(),
        counts.reshape(-1).to(torch.int32).contiguous(), max_packets,
        min_packet_length, max_packet_length)
    out = _packetize(*fsm, addresses.reshape(-1, K), max_packets,
                     max_packet_len)
    return {k: v.reshape(batch + v.shape[1:]) for k, v in out.items()}


def ax25_deframe(data: torch.Tensor, counts: torch.Tensor, max_packets: int,
                 min_packet_length: int, max_packet_length: int):
    """The plain twin of kernel K9 over (N, K) uint8 rows with (N,) int32
    byte counts: the JAX step (``_ax25_flat``'s ``step``) as a loop over
    bits, vectorized across rows, then the JAX package's compaction of its
    per-bit outputs.  Returns int32 tensors ``(stream (N, K), stream_seg
    (N, K), n_stream (N,), close_bit (N, P), close_seg (N, P), close_end
    (N, P), n_close (N,))`` (module docstring of csrc/ax25_deframe.cu)."""
    N, K = data.shape
    dev = data.device
    P = max_packets
    n_bits = K * 8
    shifts = 7 - torch.arange(8, device=dev, dtype=torch.int32)
    bits = ((data.to(torch.int32)[..., None] >> shifts) & 1).reshape(
        N, n_bits).t()
    alive = (torch.arange(n_bits, device=dev)[:, None]
             < counts.to(torch.int64)[None, :] * 8)
    ones_in = ((bits == 1) & alive).contiguous()
    zeros_in = ((bits == 0) & alive).contiguous()
    z = torch.zeros(N, dtype=torch.int32, device=dev)
    working, one_count, bit_index, byte_index = z, z, z, z
    byte_done = torch.empty((n_bits, N), dtype=torch.bool, device=dev)
    byte_val = torch.empty((n_bits, N), dtype=torch.int32, device=dev)
    flag_any = torch.empty((n_bits, N), dtype=torch.bool, device=dev)
    flag_close = torch.empty((n_bits, N), dtype=torch.bool, device=dev)
    for b in range(n_bits):
        is_one, is_zero = ones_in[b], zeros_in[b]
        # '1' branch (ax25.py:33-53)
        working1 = working | 0x80
        one1 = one_count + 1
        abort = one1 > 6
        bidx1 = torch.where(abort, 0, bit_index + 1)
        done1 = bidx1 == 8
        bidx1 = torch.where(done1, 0, bidx1)
        byidx1 = torch.where(abort, 0, byte_index) + done1.to(torch.int32)
        byidx1 = torch.where(byidx1 > max_packet_length, 0, byidx1)
        # '0' branch (ax25.py:54-92)
        dz = one_count < 5
        flag = one_count == 6
        bidx0 = torch.where(dz, bit_index + 1, bit_index)
        done0 = dz & (bidx0 == 8)
        bidx0 = torch.where(done0, 0, bidx0)
        byidx0 = byte_index + done0.to(torch.int32)
        byidx0 = torch.where(byidx0 > max_packet_length, 0, byidx0)
        close = flag & (byte_index >= min_packet_length) & (bit_index == 7)
        bidx0 = torch.where(flag, 0, bidx0)
        byidx0 = torch.where(flag, 0, byidx0)
        working0 = torch.where(dz, working >> 1, working)

        byte_done[b] = (is_one & done1) | (is_zero & done0)
        byte_val[b] = torch.where(is_one, working1, working) & 0xFF
        flag_any[b] = is_zero & flag
        flag_close[b] = is_zero & close
        working = torch.where(is_one, working1 >> 1,
                              torch.where(is_zero, working0, working))
        one_count = torch.where(is_one, one1,
                                torch.where(is_zero, 0, one_count))
        bit_index = torch.where(is_one, bidx1,
                                torch.where(is_zero, bidx0, bit_index))
        byte_index = torch.where(is_one, byidx1,
                                 torch.where(is_zero, byidx0, byte_index))

    # the JAX package's compaction (ax25_device.py:132-161), rows last
    seg = (torch.cumsum(flag_any.to(torch.int32), 0, dtype=torch.int32)
           - flag_any.to(torch.int32))
    cnt = torch.cumsum(byte_done.to(torch.int32), 0, dtype=torch.int32)
    # every completed byte took 8 alive bits, so positions stay below K;
    # column K is the dummy slot of the bits that complete no byte
    pos = torch.where(byte_done, cnt - 1, K).t().long()
    stream = torch.zeros((N, K + 1), dtype=torch.int32, device=dev)
    stream.scatter_(1, pos, byte_val.t().contiguous())
    stream_seg = torch.full((N, K + 1), _SEG_FILL, dtype=torch.int32,
                            device=dev)
    stream_seg.scatter_(1, pos, seg.t().contiguous())
    fpos = torch.cumsum(flag_close.to(torch.int32), 0, dtype=torch.int32) - 1
    fslot = torch.where(flag_close & (fpos < P), fpos, P).t().long()
    bit_ids = torch.arange(n_bits, dtype=torch.int32, device=dev)

    def closing(values):
        out = torch.zeros((N, P + 1), dtype=torch.int32, device=dev)
        out.scatter_(1, fslot, values.t().contiguous())
        return out[:, :P].contiguous()

    return (stream[:, :K].contiguous(), stream_seg[:, :K].contiguous(),
            byte_done.sum(0, dtype=torch.int32),
            closing(bit_ids[:, None].expand(n_bits, N)), closing(seg),
            closing(cnt), flag_close.sum(0, dtype=torch.int32))


def ax25_deframe_rows(data: torch.Tensor, counts: torch.Tensor,
                      max_packets: int, min_packet_length: int,
                      max_packet_length: int):
    """Kernel K9 (``csrc/ax25_deframe.cu``) over (N, K) uint8 rows with
    (N,) int32 byte counts; returns what ``ax25_deframe`` returns.

    A CUDA tensor launches the kernel on the current stream (or raises);
    only a CPU tensor takes the plain twin ``ax25_deframe``."""
    if data.ndim != 2 or counts.shape != (data.shape[0],):
        raise ValueError(f"bad shapes data {tuple(data.shape)} counts "
                         f"{tuple(counts.shape)}")
    if data.device.type == "cpu":
        return ax25_deframe(data, counts, max_packets, min_packet_length,
                            max_packet_length)
    from .. import _ext

    _ext.require(data.device, torch.uint8, data=data)
    _ext.require(data.device, torch.int32, counts=counts)
    N, K = data.shape
    dev = data.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    outs = (empty(N, K), empty(N, K), empty(N), empty(N, max_packets),
            empty(N, max_packets), empty(N, max_packets), empty(N))
    _ext.launch("ax25_deframe_rows", dev,
                (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 5,
                data.data_ptr(), counts.data_ptr(),
                *(t.data_ptr() for t in outs), N, K, max_packets,
                min_packet_length, max_packet_length)
    ax25_deframe_rows.launches += 1
    return outs


ax25_deframe_rows.launches = 0


def _packetize(stream, stream_seg, n_stream, close_bit, close_seg, close_end,
               n_close, addresses, max_packets: int, max_packet_len: int):
    """The closing flags' packets (ax25_device.py:150-188): each gathers its
    segment's bytes from the row's stream into a (max_packet_len,) buffer;
    ``ok`` when the slot holds a flag and the frame fits, ``crc_ok`` when
    its trailing CRC-16 matches."""
    N, K = stream.shape
    dev = stream.device
    P, L = max_packets, max_packet_len
    slot_ok = torch.arange(P, device=dev)[None, :] < n_close[:, None]
    # bytes of segment s: the stream positions whose stream_seg is s
    start = torch.searchsorted(stream_seg, close_seg).to(torch.int32)
    raw_length = close_end - start
    length = raw_length.clamp(0, L)
    slot = torch.arange(L, device=dev, dtype=torch.int32)
    src = (start[:, :, None] + slot).clamp(0, K - 1).long()
    pkt = torch.gather(stream, 1, src.reshape(N, P * L)).reshape(N, P, L)
    pkt = torch.where(slot < length[:, :, None], pkt, 0).to(torch.uint8)
    address = torch.gather(addresses.to(torch.int32), 1,
                           (close_bit // 8).clamp(0, K - 1).long())
    ok = slot_ok & (length > 0) & (raw_length <= L)
    calc = crc16_masked(pkt, (length - 2).clamp(min=0))

    def at(idx):
        return torch.gather(pkt, 2, idx.clamp(0, L - 1).long()[..., None]
                            )[..., 0].to(torch.int64)

    carried = at(length - 1) * 256 + at(length - 2)
    return {
        "packet": pkt,
        "length": torch.where(ok, length, 0),
        "address": torch.where(ok, address, 0),
        "ok": ok,
        "crc_ok": ok & (calc == carried),
        "dropped": (n_close - P).clamp(min=0),
    }
