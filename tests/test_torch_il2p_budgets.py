"""The port's device IL2P codec against pymodem_tpu's when a budget
overflows: too few global candidate slots, a block's acceptance scan past
``scan_cap``, more packets than ``max_packets``, and a header announcing
more payload than ``max_payload``.  Each marks the affected blocks
``dropped`` (for the caller to escalate or decode on the host); every
output key, ``dropped`` included, must equal the JAX package's.

The batch is tests/test_torch_il2p_device.py's.
"""

from test_torch_il2p_device import assert_equal, case_streams, decode_both


def _check(**kw):
    streams = case_streams()
    got, want = decode_both(list(streams.values()), **kw)
    assert_equal(got, want)
    assert got["dropped"].sum() > 0
    return dict(zip(streams, got["dropped"])), got


def test_total_candidates_overflow_matches_jax():
    dropped, _ = _check(total_candidates=8, scan_cap=16)
    assert dropped["blocks_5"] > 0  # a late block lost its candidate slot


def test_scan_cap_overflow_matches_jax():
    dropped, _ = _check(scan_cap=8)
    assert dropped["embedded_syncs"] > 0  # 10 syncs, 8 scan steps


def test_max_packets_overflow_matches_jax():
    dropped, got = _check(max_packets=2, scan_cap=16)
    assert dropped["clean"] > 0 and got["ok"].sum(1).max() == 2


def test_payload_budget_overflow_matches_jax():
    dropped, _ = _check(max_payload=128, scan_cap=16)
    assert dropped["blocks_2"] > 0 and dropped["blocks_5"] > 0
