"""Debug / porting dumpers.

Port of ``pymodem_tpu.debug``, on the port's own table builders; the text
equals the JAX package's.  The reference carries a few table printers used
when porting its DSP to C firmware and a pair of codec hex dumps used when
debugging IL2P framing:
``hilbert.print`` (hilbert.py:36-46), ``print_qpsk_pd``
(phase_detector.py:50-63), ``il2p.dump_block`` / ``dump_header_hex``
(il2p.py:155-158, 183-186).  These are their equivalents over this
framework's precomputed table builders (dsp/window_design.py) and plain
byte arrays -- same output formats, so existing downstream tooling that
scrapes the C-style dumps keeps working.
"""

from __future__ import annotations

import sys

import numpy as np

from .dsp.window_design import hilbert_taps, qpsk_error_table


def print_hilbert(tap_count: int, amplitude: float, window: str = "hann",
                  file=None) -> None:
    """C-array dump of integer-scaled Hilbert taps (hilbert.py:36-46)."""
    file = file or sys.stdout
    taps = hilbert_taps(tap_count, window)
    body = ", ".join(str(int(round(t * amplitude))) for t in taps)
    print(f"HilbertFilter[{tap_count}] = {{ {body} }};", file=file)


def print_qpsk_pd(granularity: int, gain: float, file=None) -> None:
    """C-array dump of the quantized QPSK phase-detector table
    (phase_detector.py:50-63): granularity^2 entries, row-major over
    (real, imag), 5-wide, line-continuation per real row."""
    file = file or sys.stdout
    table = qpsk_error_table(granularity, gain)
    n = granularity * granularity
    print(f"PhaseDetectorTable[{n}] = {{ \\", file=file)
    count = 0
    for real in range(granularity):
        parts = []
        for imag in range(granularity):
            count += 1
            sep = ", " if count < n else " };"
            parts.append(f"{int(table[real][imag]):5d}{sep}")
        tail = " \\" if count < n else ""
        print("".join(parts) + tail, file=file)


def dump_block_hex(block: np.ndarray, file=None) -> None:
    """Hex dump of one IL2P codeword block (il2p.py:155-158)."""
    file = file or sys.stdout
    print(" ".join(hex(int(b)) for b in np.asarray(block).reshape(-1)),
          end=" \nend block\n", file=file)


def dump_header_hex(header: np.ndarray, file=None) -> None:
    """Hex dump of the 13-byte descrambled IL2P header (il2p.py:183-186)."""
    file = file or sys.stdout
    h = np.asarray(header).reshape(-1)[:13]
    print(" ".join(hex(int(b)) for b in h), end=" end header\n", file=file)
