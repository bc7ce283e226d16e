"""IL2P syncword scanning on the device, and bit packing.

Port of ``pymodem_tpu.ops.sync.il2p_sync_candidates`` and
``pymodem_tpu.runtime.bank.pack_bits``.  The 32-bit sliding window over the
descrambled bit stream is compared against the 24- and 32-bit syncwords
(il2p.py:367-376); only the candidate positions reach the host FSM, which
re-checks the first 32 bits of a stream serially.

torch has weak ``uint32`` support, so each window is built in ``int64``
from five consecutive bytes and masked to 32 bits, and the popcount goes
through a byte table.  Integer stage: bitwise equal to the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..codecs.host import SYNC24, SYNC32
from ..device import constant

_POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)],
                          dtype=torch.int64)
_MSB_WEIGHTS = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int64)


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    table = constant(_POPCOUNT8, v.device)
    return (table[v & 0xFF] + table[(v >> 8) & 0xFF]
            + table[(v >> 16) & 0xFF] + table[(v >> 24) & 0xFF])


def il2p_sync_candidates(data: torch.Tensor, tolerance: int = 0) -> torch.Tensor:
    """Candidate map for a byte stream.

    data: (..., K) uint8 -> (..., K*8) bool; entry i is True when the 32-bit
    window ending at bit i (bits i-31..i, zero-filled off the left edge)
    matches either syncword within ``tolerance``.  Entries i < 32 must be
    re-checked serially by the caller (the decoder's seeded history).
    """
    k = data.shape[-1]
    d = F.pad(data.to(torch.int64), (4, 0))
    # v[k]: bytes k-4..k big-endian (40 bits); bit j (MSB first) of byte k
    # ends the window (v[k] >> (7 - j)) & 0xFFFFFFFF
    v = ((d[..., 0:k] << 32) | (d[..., 1:k + 1] << 24)
         | (d[..., 2:k + 2] << 16) | (d[..., 3:k + 3] << 8) | d[..., 4:k + 4])
    shifts = torch.arange(7, -1, -1, device=data.device, dtype=torch.int64)
    window = (v[..., None] >> shifts) & 0xFFFFFFFF  # (..., K, 8)
    d24 = _popcount32((window & 0xFFFFFF) ^ SYNC24)
    d32 = _popcount32(window ^ SYNC32)
    hit = (d24 <= tolerance) | (d32 <= tolerance)
    return hit.reshape(*data.shape[:-1], k * 8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., K*8) {0,1} -> (..., K) uint8 MSB-first (np.unpackbits inverse)."""
    k8 = bits.shape[-1]
    grouped = bits.reshape(*bits.shape[:-1], k8 // 8, 8).to(torch.int64)
    return (grouped * constant(_MSB_WEIGHTS, bits.device)).sum(-1).to(
        torch.uint8)
