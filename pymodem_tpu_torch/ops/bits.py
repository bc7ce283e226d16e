"""Bit/byte packing and per-row shifted windows (device side).

Port of ``pymodem_tpu.ops.bits``.  The JAX package builds
``take_rows_shifted`` and ``place_rows_shifted`` from static binary rolls
because a per-row dynamic slice is slow on the TPU (docs/ROOFLINE.md); on
the GPU they are one ``torch.gather`` each, with the same clamping of the
shift and the same zero fill.  Integer stage: equal to the JAX package
value for value.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import constant

_MSB_SHIFTS = torch.arange(7, -1, -1, dtype=torch.uint8)


def bytes_to_bits_msb(data: torch.Tensor) -> torch.Tensor:
    """(..., K) uint8 -> (..., K*8) {0,1} uint8, MSB first within each byte."""
    shifts = constant(_MSB_SHIFTS, data.device)
    bits = (data[..., :, None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def bits_to_bytes_msb(bits: torch.Tensor) -> torch.Tensor:
    """(..., K*8) {0,1} -> (..., K) uint8, MSB first within each byte."""
    k8 = bits.shape[-1]
    grouped = bits.reshape(*bits.shape[:-1], k8 // 8, 8).to(torch.uint8)
    return (grouped << constant(_MSB_SHIFTS, bits.device)).sum(
        -1, dtype=torch.uint8)


def shift_right_zero_fill(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Delay a bit stream by k positions along the last axis, zero filling."""
    if k == 0:
        return bits
    return F.pad(bits, (k, 0))[..., : bits.shape[-1]]


def take_rows_shifted(rows: torch.Tensor, shift: torch.Tensor,
                      width: int) -> torch.Tensor:
    """out[r, i] = rows[r, shift[r] + i] for i < width, zero past the row's
    end.  rows: (R, W0); shift: (R,) integers, clamped to [0, W0]."""
    _, w0 = rows.shape
    s = shift.clamp(0, w0).to(torch.int64)
    col = s[:, None] + torch.arange(width, device=rows.device)
    out = torch.gather(rows, 1, col.clamp(max=max(w0 - 1, 0)))
    return torch.where(col < w0, out, torch.zeros((), dtype=rows.dtype,
                                                  device=rows.device))


def place_rows_shifted(rows: torch.Tensor, shift: torch.Tensor,
                       width: int) -> torch.Tensor:
    """out[r, shift[r] + j] = rows[r, j] in a ``width``-wide zero buffer:
    the inverse of take_rows_shifted.  rows: (R, W0), W0 <= width; shift is
    clamped to [0, width - 1] and positions wrap modulo ``width``, as the
    JAX package's rolls do (callers keep the bytes past a row's content
    zero, so a wrapped position only carries zeros)."""
    _, w0 = rows.shape
    assert w0 <= width, (w0, width)
    r = F.pad(rows, (0, width - w0))
    s = shift.clamp(0, width - 1).to(torch.int64)
    col = (torch.arange(width, device=rows.device) - s[:, None]) % width
    return torch.gather(r, 1, col)
