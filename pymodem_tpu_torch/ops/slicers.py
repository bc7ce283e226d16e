"""Symbol-timing slicers: kernels K1, K7, K8, K10 and K12, their twins,
compaction.

Port of ``pymodem_tpu.ops.slicers`` (``binary_slice``,
``quadrature_slice``, ``four_level_slice``, ``compact_bytes``,
``compact_windowed``, ``safe_compact_window``) and of the Pallas kernels
that replace the scans on the TPU,
``pymodem_tpu.ops.pallas_slicers._binary_kernel``
(``binary_slice_lanes_pallas``, ``decode_emissions``), ``_quad_kernel``
(``quadrature_slice_lanes_pallas``) and ``_four_level_kernel``
(``four_level_slice_lanes_pallas``).  At float64, the JAX package's
parity mode, it runs the scans; their counterparts on the card are K10
(``binary_slice_f64_lanes``) and K12 (``four_level_slice_f64_lanes``),
to which ``binary_slice_lanes`` and ``four_level_slice_lanes`` route a
float64 CUDA tensor; K7 takes float32 only.

The slicer is a per-sample FSM (reference slicer.py:59-107): a phase clock
advances by 1.0 per sample, a bit decision fires when it crosses
``sps/2 - 0.5`` (then the clock rewinds by ``sps``), and a zero crossing
multiplies the clock by ``lock_rate``.  Lanes are (chain, block) streams
handed over as ``(L, T)`` rows (two of them, I and Q, for the quadrature
slicer); per-lane constants come as two rows ``(sps, lock_rate)``.  The
four-level slicer runs two such clocks (``four_level_slice``).

Emission encoding, shared by kernel and twin (the Pallas kernel's): with
``window == 1`` an (L, T) int32 stream, ``0x100 | byte`` on the sample that
completed a byte and 0 elsewhere; with ``window == w > 1`` an
(L, ceil(T/w)) stream holding each window's single emission as
``(pos_in_window << 16) | 0x100 | byte``.  Compare/select/shift arithmetic
only, so kernel and twin agree bitwise.

Compaction (cumsum + scatter) packs the emissions into dense
(bytes, addresses, count) rows, bitwise as the JAX package does.
Addresses are 1-based sample indices of the demod stream (slicer.py:75).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F


class SlicerOut(NamedTuple):
    """Per-sample emission stream (valid, byte)."""

    valid: torch.Tensor  # (..., N) bool
    byte: torch.Tensor  # (..., N) uint8


def safe_compact_window(samples_per_symbol: float, lock_rate: float,
                        bits_per_symbol: int) -> int:
    """Largest power-of-two window guaranteed to hold at most one byte
    emission: a byte takes 8/bps symbol decisions, each at least
    ~samples_per_symbol * lock_rate samples after the previous."""
    spacing = (8.0 / bits_per_symbol) * samples_per_symbol * lock_rate
    w = 1
    while w * 2 <= max(spacing * 0.45, 1.0):
        w *= 2
    return min(w, 256)


def _encode(emits: list, bytes_: list, window: int) -> torch.Tensor:
    """Per-step (L,) emit flags and bytes -> the (L, ceil(T/w)) int32
    emission stream (module docstring)."""
    emit = torch.stack(emits)
    enc = torch.where(emit, 0x100 | torch.stack(bytes_), 0)  # (T, L)
    if window > 1:
        # one code per window: OR of the window's per-sample codes, the
        # in-window position in bits 16+
        T, L = enc.shape
        n_out = -(-T // window)
        pos = (torch.arange(T, device=enc.device, dtype=torch.int32)
               % window)[:, None] << 16
        enc = torch.where(emit, enc | pos, 0)
        enc = F.pad(enc, (0, 0, 0, n_out * window - T))
        enc = enc.reshape(n_out, window, L)
        acc = enc[:, 0]
        for k in range(1, window):
            acc = acc | enc[:, k]
        enc = acc
    return enc.t().contiguous()


def _crossings(xt: torch.Tensor) -> torch.Tensor:
    """(T, L) zero crossings against the previous sample (0 before the
    first)."""
    last = torch.cat([torch.zeros_like(xt[:1]), xt[:-1]])
    return ((last < 0.0) & (xt >= 0.0)) | ((last >= 0.0) & (xt < 0.0))


def binary_slice(x: torch.Tensor, lane_params: torch.Tensor,
                 window: int = 1) -> torch.Tensor:
    """Plain PyTorch twin of kernel K1: vectorised over lanes, a loop over
    time.  x: (L, T) float; lane_params: (2, L) rows (sps, lock_rate) of the
    same dtype.  Returns the int32 emission stream (module docstring)."""
    L, T = x.shape
    dev = x.device
    sps, lock_rate = lane_params.to(x.dtype)
    rollover = sps / 2.0 - 0.5
    xt = x.t()
    # the per-sample inputs of the recurrence that depend on x alone --
    # the decided bit and the zero crossing -- are computed for all t up
    # front
    bits = (xt >= 0).to(torch.int32).unbind(0)
    crossings = _crossings(xt).unbind(0)
    clock = torch.zeros(L, dtype=x.dtype, device=dev)
    byte = torch.zeros(L, dtype=torch.int32, device=dev)
    bit_count = torch.zeros_like(byte)
    emits, bytes_ = [], []
    for t in range(T):
        clock = clock + 1.0
        decide = clock >= rollover
        clock = torch.where(decide, clock - sps, clock)
        byte = torch.where(decide, ((byte << 1) & 0xFF) | bits[t], byte)
        # bit_count counts decisions and resets at 8, so reaching 8 marks
        # a decision that completed a byte (decide & bit_count >= 8)
        bit_count = bit_count + decide
        emit = bit_count >= 8
        bit_count = torch.where(emit, 0, bit_count)
        clock = torch.where(crossings[t], clock * lock_rate, clock)
        emits.append(emit)
        bytes_.append(byte)
    return _encode(emits, bytes_, window)


def quadrature_slice(i_lanes: torch.Tensor, q_lanes: torch.Tensor,
                     lane_params: torch.Tensor, demap, state_mask: int,
                     bits_per_symbol: int, window: int = 1) -> torch.Tensor:
    """Plain PyTorch twin of kernel K7, the IQ slicer (reference
    slicer.py:193-242): the state register takes ``(I >= 0, Q >= 0)`` at
    each decision, the byte takes ``demap[state]``, ``bits_per_symbol``
    bits at a time, and a zero crossing on either rail scales the clock by
    ``lock_rate``.  i_lanes, q_lanes: (L, T); lane_params: (2, L) rows
    (sps, lock_rate); ``demap`` a sequence of ints.  Returns the int32
    emission stream (module docstring)."""
    L, T = i_lanes.shape
    dev = i_lanes.device
    sps, lock_rate = lane_params.to(i_lanes.dtype)
    rollover = sps / 2.0 - 0.5
    table = torch.as_tensor(tuple(demap), dtype=torch.int32, device=dev)
    it, qt = i_lanes.t(), q_lanes.t()
    signs = (torch.where(it >= 0, 2, 0)
             | torch.where(qt >= 0, 1, 0)).to(torch.int32).unbind(0)
    crossings = (_crossings(it) | _crossings(qt)).unbind(0)
    clock = torch.zeros(L, dtype=i_lanes.dtype, device=dev)
    byte = torch.zeros(L, dtype=torch.int32, device=dev)
    bit_count = torch.zeros_like(byte)
    state = torch.zeros_like(byte)
    emits, bytes_ = [], []
    for t in range(T):
        clock = clock + 1.0
        decide = clock >= rollover
        clock = torch.where(decide, clock - sps, clock)
        state = torch.where(decide, ((state << 2) & state_mask) | signs[t],
                            state)
        byte = torch.where(decide, (byte << bits_per_symbol)
                           | table.take(state.long()), byte)
        bit_count = torch.where(decide, bit_count + bits_per_symbol,
                                bit_count)
        emit = bit_count >= 8
        bit_count = torch.where(emit, 0, bit_count)
        out_byte = byte & 0xFF
        byte = torch.where(emit, out_byte, byte)
        clock = torch.where(crossings[t], clock * lock_rate, clock)
        emits.append(emit)
        bytes_.append(out_byte)
    return _encode(emits, bytes_, window)


FL_DEPTH = 8  # the four-level slicer's threshold ring


def four_level_slice(x: torch.Tensor, lane_params: torch.Tensor, demap,
                     window: int = 1) -> torch.Tensor:
    """Plain PyTorch twin of kernel K8, the fix-forward 4FSK slicer
    (reference slicer.py:329-441, the JAX scan ``four_level_slice``):
    vectorised over lanes, a loop over time.  x: (L, T); lane_params: (2,
    L) rows (sps, lock_rate); ``demap`` 4 ints.  Returns the int32 emission
    stream (module docstring).

    Clock 1 (rollover at ``sps/2 - 0.5``, strictly above, scaled by
    ``lock_rate`` at zero crossings) samples each symbol: it pushes
    ``|x| * 2 / 3`` into an 8-deep ring and ``x > 0`` into a 16-bit sync
    register.  The sync patterns 0x5555 and 0xCCCC set the threshold to the
    ring's mean and align clock 2 to clock 1; clock 2 decides the symbol
    (3/2 above/below the threshold, 1/0 below/above its negative), 2 bits
    at a time.  The threshold starts at 0.  Op forms as the scan's:
    ``*2`` then ``/3``, the ring summed in order ``r0 + r1 + ... + r7``,
    then ``/8``."""
    L, T = x.shape
    dev = x.device
    sps, lock_rate = lane_params.to(x.dtype)
    rollover = sps / 2.0 - 0.5
    table = torch.as_tensor(tuple(demap), dtype=torch.int32, device=dev)
    xt = x.t()
    # a 0-d tensor on x's device: torch on CUDA turns a division by a CPU
    # scalar into a multiply by its reciprocal, which rounds otherwise
    three = torch.tensor(3.0, dtype=x.dtype, device=dev)
    new_vals = (xt.abs() * 2.0 / three).unbind(0)
    positive = (xt > 0).unbind(0)
    crossings = _crossings(xt).unbind(0)
    xs = xt.unbind(0)
    zero = torch.zeros(L, dtype=x.dtype, device=dev)
    clock1, clock2, threshold = zero, zero, zero
    ring = [zero] * FL_DEPTH
    izero = torch.zeros(L, dtype=torch.int32, device=dev)
    byte, bit_count, sync, ring_index = izero, izero, izero, izero
    emits, bytes_ = [], []
    for t in range(T):
        x_t = xs[t]
        clock1 = clock1 + 1.0
        roll1 = clock1 > rollover
        clock1 = torch.where(roll1, clock1 - sps, clock1)
        ring_index = torch.where(
            roll1, torch.where(ring_index + 1 >= FL_DEPTH, 0, ring_index + 1),
            ring_index)
        ring = [torch.where(roll1 & (ring_index == r), new_vals[t], ring[r])
                for r in range(FL_DEPTH)]
        sync = torch.where(roll1, ((sync << 1) & 0xFFFF) + positive[t],
                           sync)
        sync_hit = roll1 & ((sync == 0x5555) | (sync == 0xCCCC))
        ring_sum = ring[0]
        for r in range(1, FL_DEPTH):
            ring_sum = ring_sum + ring[r]
        threshold = torch.where(sync_hit, ring_sum / FL_DEPTH, threshold)
        clock2 = torch.where(sync_hit, clock1, clock2) + 1.0
        roll2 = clock2 > rollover
        clock2 = torch.where(roll2, clock2 - sps, clock2)
        symbol = torch.where(
            positive[t], torch.where(x_t >= threshold, 3, 2),
            torch.where(x_t <= -threshold, 0, 1))
        byte = torch.where(roll2, ((byte << 2) & 0xFF)
                           + table.take(symbol.long()), byte)
        bit_count = torch.where(roll2, bit_count + 2, bit_count)
        emit = roll2 & (bit_count >= 8)
        bit_count = torch.where(emit, 0, bit_count)
        clock1 = torch.where(crossings[t], clock1 * lock_rate, clock1)
        emits.append(emit)
        bytes_.append(byte)
    return _encode(emits, bytes_, window)


def _check_window(window: int) -> None:
    if window < 1 or window & (window - 1) or window > 256:
        raise ValueError(f"window must be a power of two <= 256: {window}")


def binary_slice_lanes(x: torch.Tensor, lane_params: torch.Tensor,
                       window: int = 1) -> torch.Tensor:
    """Kernel K1 (``csrc/binary_slicer.cu``) over (L, T) lanes.  ``x``'s
    rows need unit stride, not to follow one another: rows 16-byte aligned
    a multiple of 4 floats apart go to the kernel as they are, others
    through padded copies (``_ext.lane_rows``).

    A CUDA tensor launches the kernel on the current stream (or raises);
    only a CPU tensor takes the plain twin ``binary_slice``.  A float64
    CUDA tensor goes to K10 (``binary_slice_f64_lanes``)."""
    if x.dtype == torch.float64 and x.device.type != "cpu":
        return binary_slice_f64_lanes(x, lane_params, window)
    if x.ndim != 2 or lane_params.shape != (2, x.shape[0]):
        raise ValueError(f"bad shapes x {tuple(x.shape)} "
                         f"lane_params {tuple(lane_params.shape)}")
    _check_window(window)
    if x.device.type == "cpu":
        return binary_slice(x, lane_params, window)
    from .. import _ext

    _ext.require(x.device, torch.float32, lane_params=lane_params)
    _ext.require_rows(x.device, torch.float32, x=x)
    L, T = x.shape
    rows = _ext.lane_rows(x)
    out = torch.empty((L, -(-T // window)), dtype=torch.int32,
                      device=x.device)
    _ext.launch("binary_slice_lanes", x.device,
                (ctypes.c_void_p, ctypes.c_int) + (ctypes.c_void_p,) * 2
                + (ctypes.c_int,) * 3,
                rows.data_ptr(), rows.stride(0), lane_params.data_ptr(),
                out.data_ptr(), L, T, window)
    binary_slice_lanes.launches += 1
    return out


# the longest demap table K7 takes (a 4-bit state register)
DEMAP_MAX = 16


def quadrature_slice_lanes(i_lanes: torch.Tensor, q_lanes: torch.Tensor,
                           lane_params: torch.Tensor, demap,
                           state_mask: int, bits_per_symbol: int,
                           window: int = 1) -> torch.Tensor:
    """Kernel K7 (``csrc/quadrature_slicer.cu``) over (L, T) I/Q lane
    pairs.  ``demap``, ``state_mask`` and ``bits_per_symbol`` are
    bank-uniform (part of the bank grouping key) and go to the kernel as
    arguments.  Rows that are not 16-byte aligned, or a T that is not a
    multiple of 4, go to the kernel through padded copies
    (``_ext.lane_rows``).

    A CUDA tensor launches the kernel on the current stream (or raises);
    only a CPU tensor takes the plain twin ``quadrature_slice``."""
    demap = tuple(int(v) for v in demap)
    if (i_lanes.ndim != 2 or q_lanes.shape != i_lanes.shape
            or lane_params.shape != (2, i_lanes.shape[0])):
        raise ValueError(f"bad shapes i {tuple(i_lanes.shape)} q "
                         f"{tuple(q_lanes.shape)} lane_params "
                         f"{tuple(lane_params.shape)}")
    _check_window(window)
    if not (len(demap) <= DEMAP_MAX and (state_mask | 3) < len(demap)
            and all(0 <= v <= 3 for v in demap)
            and bits_per_symbol in (1, 2)):
        raise ValueError(f"demap {demap}, state_mask {state_mask:#x}, "
                         f"bits_per_symbol {bits_per_symbol}: the kernel "
                         f"takes a demap of at most {DEMAP_MAX} entries of "
                         "0-3 covering the state mask and 1 or 2 bits per "
                         "decision")
    if i_lanes.device.type == "cpu":
        return quadrature_slice(i_lanes, q_lanes, lane_params, demap,
                                state_mask, bits_per_symbol, window)
    from .. import _ext

    _ext.require(i_lanes.device, torch.float32, i_lanes=i_lanes,
                 q_lanes=q_lanes, lane_params=lane_params)
    L, T = i_lanes.shape
    i_rows, q_rows = _ext.lane_rows(i_lanes), _ext.lane_rows(q_lanes)
    out = torch.empty((L, -(-T // window)), dtype=torch.int32,
                      device=i_lanes.device)
    packed = sum(v << (2 * s) for s, v in enumerate(demap))  # 2 bits each
    _ext.launch("quadrature_slice_lanes", i_lanes.device,
                (ctypes.c_void_p,) * 2 + (ctypes.c_int,)
                + (ctypes.c_void_p,) * 2 + (ctypes.c_uint,)
                + (ctypes.c_int,) * 5,
                i_rows.data_ptr(), q_rows.data_ptr(), i_rows.stride(0),
                lane_params.data_ptr(), out.data_ptr(), packed, L, T,
                window, state_mask, bits_per_symbol)
    quadrature_slice_lanes.launches += 1
    return out


def four_level_slice_lanes(x: torch.Tensor, lane_params: torch.Tensor, demap,
                           window: int = 1) -> torch.Tensor:
    """Kernel K8 (``csrc/four_level_slicer.cu``) over (L, T) lanes.  The
    4-entry ``demap`` is bank-uniform (part of the bank grouping key) and
    goes to the kernel as an argument.  ``x``'s rows need unit stride, as
    for ``binary_slice_lanes``.

    A CUDA tensor launches the kernel on the current stream (or raises);
    only a CPU tensor takes the plain twin ``four_level_slice``.  A
    float64 CUDA tensor goes to K12 (``four_level_slice_f64_lanes``)."""
    if x.dtype == torch.float64 and x.device.type != "cpu":
        return four_level_slice_f64_lanes(x, lane_params, demap, window)
    demap = tuple(int(v) for v in demap)
    if x.ndim != 2 or lane_params.shape != (2, x.shape[0]):
        raise ValueError(f"bad shapes x {tuple(x.shape)} "
                         f"lane_params {tuple(lane_params.shape)}")
    _check_window(window)
    if len(demap) != 4 or not all(0 <= v <= 3 for v in demap):
        raise ValueError(f"demap {demap}: the four-level slicer takes 4 "
                         "entries of 0-3")
    if x.device.type == "cpu":
        return four_level_slice(x, lane_params, demap, window)
    from .. import _ext

    _ext.require(x.device, torch.float32, lane_params=lane_params)
    _ext.require_rows(x.device, torch.float32, x=x)
    L, T = x.shape
    rows = _ext.lane_rows(x)
    out = torch.empty((L, -(-T // window)), dtype=torch.int32,
                      device=x.device)
    _ext.launch("four_level_slice_lanes", x.device,
                (ctypes.c_void_p, ctypes.c_int) + (ctypes.c_void_p,) * 2
                + (ctypes.c_int,) * 7,
                rows.data_ptr(), rows.stride(0), lane_params.data_ptr(),
                out.data_ptr(), *demap, L, T, window)
    four_level_slice_lanes.launches += 1
    return out


def _f64_slicer(entry, x, lane_params, window, *args):
    """Launch K10 or K12 (``entry``) over the (L, T) float64 rows of ``x``
    (unit stride, any row stride >= T: taken as they lie); returns the
    (L, ceil(T/window)) int32 emission stream."""
    from .. import _ext

    _ext.require(x.device, torch.float64, lane_params=lane_params)
    _ext.require_rows(x.device, torch.float64, x=x)
    L, T = x.shape
    out = torch.empty((L, -(-T // window)), dtype=torch.int32,
                      device=x.device)
    _ext.launch(entry, x.device,
                (ctypes.c_void_p, ctypes.c_int) + (ctypes.c_void_p,) * 2
                + (ctypes.c_int,) * (len(args) + 3),
                x.data_ptr(), x.stride(0), lane_params.data_ptr(),
                out.data_ptr(), *args, L, T, window)
    return out


def binary_slice_f64_lanes(x: torch.Tensor, lane_params: torch.Tensor,
                           window: int = 1) -> torch.Tensor:
    """Kernel K10 (``csrc/binary_slicer_f64.cu``), the float64 binary
    slicer, over (L, T) float64 lanes with (2, L) float64 rows (sps,
    lock_rate); ``binary_slice_lanes`` routes float64 CUDA tensors here.
    Its emissions are K1's.  Only a CPU tensor takes the plain twin
    ``binary_slice``."""
    if x.ndim != 2 or lane_params.shape != (2, x.shape[0]):
        raise ValueError(f"bad shapes x {tuple(x.shape)} "
                         f"lane_params {tuple(lane_params.shape)}")
    _check_window(window)
    if x.device.type == "cpu":
        return binary_slice(x, lane_params, window)
    out = _f64_slicer("binary_slice_f64_lanes", x, lane_params, window)
    binary_slice_f64_lanes.launches += 1
    return out


def four_level_slice_f64_lanes(x: torch.Tensor, lane_params: torch.Tensor,
                               demap, window: int = 1) -> torch.Tensor:
    """Kernel K12 (``csrc/four_level_slicer_f64.cu``), the float64
    four-level slicer, over (L, T) float64 lanes; ``four_level_slice_lanes``
    routes float64 CUDA tensors here.  Its emissions are K8's.  Only a CPU
    tensor takes the plain twin ``four_level_slice``."""
    demap = tuple(int(v) for v in demap)
    if x.ndim != 2 or lane_params.shape != (2, x.shape[0]):
        raise ValueError(f"bad shapes x {tuple(x.shape)} "
                         f"lane_params {tuple(lane_params.shape)}")
    _check_window(window)
    if len(demap) != 4 or not all(0 <= v <= 3 for v in demap):
        raise ValueError(f"demap {demap}: the four-level slicer takes 4 "
                         "entries of 0-3")
    if x.device.type == "cpu":
        return four_level_slice(x, lane_params, demap, window)
    out = _f64_slicer("four_level_slice_f64_lanes", x, lane_params, window,
                      *demap)
    four_level_slice_f64_lanes.launches += 1
    return out


binary_slice_lanes.launches = 0
quadrature_slice_lanes.launches = 0
four_level_slice_lanes.launches = 0
binary_slice_f64_lanes.launches = 0
four_level_slice_f64_lanes.launches = 0


def decode_emissions(enc: torch.Tensor) -> SlicerOut:
    """(..., T) int32 encoded emissions (window 1) -> SlicerOut."""
    return SlicerOut((enc & 0x100) != 0, (enc & 0xFF).to(torch.uint8))


def _scatter_dense(valid: torch.Tensor, byte: torch.Tensor,
                   address: torch.Tensor, capacity: int):
    """Rank the valid slots (cumsum) and scatter bytes and addresses into
    (..., capacity) rows; slots past capacity drop, count stays the full
    number of valid slots (the JAX scatter's mode="drop")."""
    idx = valid.to(torch.int64).cumsum(-1) - 1
    pos = torch.where(valid & (idx < capacity), idx, capacity)
    shape = valid.shape[:-1] + (capacity + 1,)
    data = torch.zeros(shape, dtype=torch.int32, device=valid.device)
    addr = torch.zeros(shape, dtype=torch.int32, device=valid.device)
    zero = torch.zeros_like(address)
    data.scatter_(-1, pos, torch.where(valid, byte, zero))
    addr.scatter_(-1, pos, torch.where(valid, address, zero))
    count = valid.sum(-1, dtype=torch.int32)
    return data[..., :capacity], addr[..., :capacity], count


def compact_bytes(out: SlicerOut, capacity: int, window: int = 1):
    """Pack valid slots of a per-sample emission stream into dense
    (bytes, addresses, count) arrays; with ``window > 1`` emissions are
    first reduced over non-overlapping windows (each holds at most one
    emission, see safe_compact_window)."""
    valid, byte = out.valid, out.byte.to(torch.int32)
    n = valid.shape[-1]
    if window > 1:
        pad = (-n) % window
        if pad:
            valid = F.pad(valid, (0, pad))
            byte = F.pad(byte, (0, pad))
        v = valid.reshape(*valid.shape[:-1], -1, window)
        byte = torch.where(v, byte.reshape(v.shape), 0).sum(
            -1, dtype=torch.int32)
        base = torch.arange(v.shape[-2], dtype=torch.int32,
                            device=v.device) * window
        address = base + v.to(torch.int32).argmax(-1).to(torch.int32) + 1
        valid = v.any(-1)
    else:
        address = torch.arange(1, n + 1, dtype=torch.int32,
                               device=valid.device).expand(valid.shape)
    return _scatter_dense(valid, byte, address, capacity)


def compact_windowed(enc: torch.Tensor, window: int, capacity: int):
    """compact_bytes for kernel-windowed emissions: enc (..., NW) int32
    holds each window's single emission as
    ``(pos_in_window << 16) | 0x100 | byte`` (0 = none)."""
    valid = (enc & 0x100) != 0
    nw = enc.shape[-1]
    base = torch.arange(nw, dtype=torch.int32, device=enc.device) * window
    address = base + (enc >> 16) + 1
    return _scatter_dense(valid, enc & 0xFF, address, capacity)
