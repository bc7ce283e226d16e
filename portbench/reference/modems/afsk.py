"""The AFSK tone correlator (upstream afsk.py): band-pass, mark and space
I/Q correlators, envelope difference, low-pass."""

from __future__ import annotations

import numpy as np

from ..frozen.modems import afsk_params

COHERENT = False
BYTES_PER_CHAIN_SAMPLE = 16


def params(spec):
    p = afsk_params(spec)
    if p.oversample != 1:
        raise ValueError("the reference decodes no output oversample")
    return p


def trim(p) -> int:
    return sum(len(t) - 1 for t in (p.input_bpf, p.mark_i, p.output_lpf))


def baseband(spec, p, frame: np.ndarray, normal: float, arith) -> np.ndarray:
    x = arith.fir(frame, p.input_bpf)
    mi, mq, si, sq = (arith.fir(x, t)
                      for t in (p.mark_i, p.mark_q, p.space_i, p.space_q))
    diff = np.sqrt(mi * mi + mq * mq) - np.sqrt(si * si + sq * sq)
    return arith.fir(diff, p.output_lpf)
