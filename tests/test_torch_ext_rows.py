"""The row-alignment helpers of the staged lane kernels (``_ext.rows_aligned``,
``_ext.lane_rows``, and for the two-rail kernels ``_ext.pair_aligned`` and
``_ext.lane_rows_pair``), which count 16-byte bulk-copy units by element
size: float32 rows (K1-K8) as before, float64 rows (K10, K11, K15, K16) at
2 doubles a unit.  CPU only: the helpers read strides and addresses, not
the card."""

import numpy as np
import pytest
import torch

from pymodem_tpu_torch import _ext


def _float_rule(t) -> bool:
    """The float32 rule the helpers kept from before they counted bytes:
    16-byte aligned rows a multiple of 4 floats apart, at least T long."""
    return (t.stride(-1) == 1 and t.stride(0) % 4 == 0
            and t.stride(0) >= t.shape[-1] and t.data_ptr() % 16 == 0)


def _rows(dtype, layout, T, n=3):
    """(n, T) rows of ``dtype``: contiguous; a view of rows at an odd
    stride, 5 or 6 elements longer; a view of rows padded to a whole
    16-byte unit and one more (the FIR's wider rows); or contiguous rows
    starting one element past a 16-byte boundary."""
    g = np.random.default_rng(T)
    x = torch.from_numpy(g.standard_normal((n, T))).to(dtype)
    per = 16 // x.element_size()
    if layout == "contiguous":
        return x
    if layout == "odd_stride":
        wide = x.new_zeros((n, (T + 5) // 2 * 2 + 1))
    elif layout == "unit_stride":
        wide = x.new_zeros((n, -(-T // per) * per + per))
    else:  # "offset"
        return torch.empty(n * T + 1, dtype=dtype)[1:].view(n, T).copy_(x)
    wide[:, :T] = x
    return wide[:, :T]


_LAYOUTS = ["contiguous", "odd_stride", "unit_stride", "offset"]


@pytest.mark.parametrize("layout", _LAYOUTS)
@pytest.mark.parametrize("T", [1, 4, 127, 128, 130, 131])
def test_float32_rows_keep_the_rule_of_four_floats(T, layout):
    """For float32 rows both helpers answer as the 4-float rule did: rows
    it took as they are come back as they are, the others as one
    zero-padded copy into rows of T rounded up to 4 floats."""
    x = _rows(torch.float32, layout, T)
    want = _float_rule(x)
    assert _ext.rows_aligned(x) == want
    copies = _ext.lane_rows.copies
    rows = _ext.lane_rows(x)
    assert _ext.lane_rows.copies == copies + (not want)
    assert (rows is x) == want
    if not want:
        assert rows.shape == (x.shape[0], -(-T // 4) * 4)
        assert rows.is_contiguous() and rows.data_ptr() % 16 == 0
        assert not rows[:, T:].any()
    assert torch.equal(rows[:, :T], x)


@pytest.mark.parametrize("layout", _LAYOUTS)
@pytest.mark.parametrize("T", [1, 2, 63, 64, 65, 130])
def test_float64_rows_count_two_doubles_a_unit(T, layout):
    """Float64 rows go to the bulk copies as they are when they start
    16-byte aligned a multiple of 2 doubles apart; a row stride that is
    not a multiple of 16 bytes, or a start off a 16-byte boundary, gets
    one zero-padded copy into rows of T rounded up to 2 doubles, whose
    first T samples are equal."""
    x = _rows(torch.float64, layout, T)
    want = (x.stride(0) % 2 == 0 and x.data_ptr() % 16 == 0
            and x.stride(0) >= T)
    assert want == (layout == "unit_stride"
                    or (layout == "contiguous" and T % 2 == 0))
    assert _ext.rows_aligned(x) == want
    copies = _ext.lane_rows.copies
    rows = _ext.lane_rows(x)
    assert _ext.lane_rows.copies == copies + (not want)
    assert (rows is x) == want
    if not want:
        assert rows.shape == (x.shape[0], -(-T // 2) * 2)
        assert rows.stride(0) * 8 % 16 == 0 and rows.data_ptr() % 16 == 0
        assert rows.dtype == torch.float64
        assert not rows[:, T:].any()
    assert torch.equal(rows[:, :T], x)


# (I or re rail, Q or im rail) layouts: one stride, two strides, one rail or
# both off the bulk copies' rule
_PAIRS = [("contiguous", "contiguous"), ("unit_stride", "unit_stride"),
          ("contiguous", "unit_stride"), ("unit_stride", "contiguous"),
          ("offset", "contiguous"), ("unit_stride", "odd_stride"),
          ("odd_stride", "offset")]


@pytest.mark.parametrize("pair", _PAIRS, ids=["-".join(p) for p in _PAIRS])
@pytest.mark.parametrize("T", [1, 127, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_two_rails_go_to_the_kernels_at_one_stride(dtype, T, pair):
    """The two-rail kernels (K6, K7, K15, K16) take one row stride for both
    rails: ``lane_rows_pair`` hands over both rails as they are when they
    are aligned at one stride; else it keeps a rail that is aligned and
    copies the other into rows of its stride, or copies both into rows of
    T rounded up to 16 bytes; the samples are unchanged and the padding
    zero."""
    a = _rows(dtype, pair[0], T)
    b = -_rows(dtype, pair[1], T)
    a_ok, b_ok = _ext.rows_aligned(a), _ext.rows_aligned(b)
    same = a_ok and b_ok and a.stride(0) == b.stride(0)
    assert _ext.pair_aligned(a, b) == same
    copies = _ext.lane_rows.copies
    ra, rb = _ext.lane_rows_pair(a, b)
    kept = (True, True) if same else (a_ok, not a_ok and b_ok)
    assert _ext.lane_rows.copies == copies + kept.count(False)
    assert ((ra is a), (rb is b)) == kept
    assert ra.stride(0) == rb.stride(0)
    assert _ext.pair_aligned(ra, rb)
    for got, want, keep in ((ra, a, kept[0]), (rb, b, kept[1])):
        assert got.shape == want.shape and got.dtype == dtype
        assert torch.equal(got, want)
        if not keep:
            whole = got.as_strided((got.shape[0], got.stride(0)),
                                   (got.stride(0), 1))
            assert not whole[:, T:].any()
