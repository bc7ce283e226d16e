"""The port's debug dumpers (``pymodem_tpu_torch.debug``) against the JAX
package's (``pymodem_tpu.debug``): the same text, character for character,
as tests/test_debug_dumpers.py holds the JAX package's against the
reference's printers."""

import io

import numpy as np
import pytest

from pymodem_tpu import debug as jdebug
from pymodem_tpu_torch import debug as tdebug


def _text(fn, *args):
    buf = io.StringIO()
    fn(*args, file=buf)
    return buf.getvalue()


@pytest.mark.parametrize("tap_count,amplitude,window",
                         [(21, 32767.0, "hann"), (41, 1000.0, "hann"),
                          (31, 512.0, "hamming")])
def test_print_hilbert_equals_jax(tap_count, amplitude, window):
    got = _text(tdebug.print_hilbert, tap_count, amplitude, window)
    assert got == _text(jdebug.print_hilbert, tap_count, amplitude, window)
    assert got.startswith(f"HilbertFilter[{tap_count}] = {{ ")


@pytest.mark.parametrize("granularity,gain", [(16, 1.0), (24, 2.0), (8, 0.5)])
def test_print_qpsk_pd_equals_jax(granularity, gain):
    got = _text(tdebug.print_qpsk_pd, granularity, gain)
    assert got == _text(jdebug.print_qpsk_pd, granularity, gain)
    assert got.count("\n") == granularity + 1


def test_hex_dumps_equal_jax():
    rng = np.random.default_rng(3)
    for n in (32, 13, 255):
        block = rng.integers(0, 256, n).astype(np.int64)
        for name in ("dump_block_hex", "dump_header_hex"):
            got = _text(getattr(tdebug, name), block)
            assert got == _text(getattr(jdebug, name), block)
