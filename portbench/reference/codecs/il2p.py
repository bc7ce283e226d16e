"""IL2P (upstream il2p.py): the frozen host decoder, RS and trailing CRC."""

from __future__ import annotations

import numpy as np

from ..frozen.codecs_host import il2p_decode_host


def max_packet_seconds(spec, bit_rate: float) -> float:
    """sync(3) + header(15) + 1023 payload + 16 parity per 239-byte block
    + CRC(4) bytes."""
    payload = 1023
    return (3 + 15 + payload + -(-payload // 239) * 16 + 4) * 8 / bit_rate


def decode(spec, raw, addresses):
    return il2p_decode_host(
        np.asarray(raw, np.int64), addresses, spec.ident,
        collect_trailing_crc=spec.collect_trailing_crc,
        disable_rs=spec.disable_rs, min_distance=spec.min_distance,
        sync_tolerance=spec.sync_tolerance)
