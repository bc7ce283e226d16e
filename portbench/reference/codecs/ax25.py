"""AX.25 over HDLC (upstream ax25.py): the frozen host deframer."""

from __future__ import annotations

import numpy as np

from ..frozen.codecs_host import ax25_decode_host


def max_packet_seconds(spec, bit_rate: float) -> float:
    """max_packet_length decoded bytes at the worst-case HDLC stuffing of
    6/5, plus flags."""
    return (spec.max_packet_length * 8 * 1.2 + 32) / bit_rate


def decode(spec, raw, addresses):
    return ax25_decode_host(
        np.asarray(raw, np.int64), addresses, spec.ident,
        min_packet_length=spec.min_packet_length,
        max_packet_length=spec.max_packet_length)
