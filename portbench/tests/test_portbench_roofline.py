"""The kernels' byte counts against a hand count; they read the traffic
only, so a change of the block plan cannot move them."""

import json

from portbench.reference import decode
from portbench.roofline import binary_slicer, coherent_loop
from portbench.tests.tiny_bench import SRC


def _chains(name):
    cfg = json.loads((SRC / f"configs/{name}.json").read_text())
    return decode.chains_from_lines(cfg["lines"], cfg["sample_rate"])


def test_binary_slicer_hand_count():
    chains = _chains("afsk300_pll_sweep64")  # 300 Bd at 8 kHz, lock 0.75
    # a byte every 8 x 26.67 x 0.75 = 160 samples at least: window 64
    assert binary_slicer.safe_compact_window(8000 / 300, 0.75, 1) == 64
    n = 28_800_000
    assert binary_slicer.bytes_needed(chains, n) == 64 * (4 * n + 4 * n / 64)
    ax = _chains("afsk1200_ax25_sweep8")  # 36.75 samples a bit: window 64
    assert binary_slicer.bytes_needed(ax, 1000) == 8 * (4000 + 4000 / 64)


def test_coherent_loop_hand_count():
    chains = _chains("afsk300_pll_sweep64")  # one band-pass shared by 64
    n = 28_800_000
    assert coherent_loop.bytes_needed(chains, n) == (
        4 * n + 64 * 4 * n + 64 * 60 + 1024)
    assert coherent_loop.bytes_needed(_chains("afsk1200_ax25_sweep8"), n) == 1024


def test_counts_do_not_see_the_block_plan():
    chains = _chains("afsk300_pll_sweep64")
    n = 4_800_000
    g1 = decode.geometry(chains, n, 8000)
    g2 = decode.geometry(chains, n, 8000, block_seconds=30.0,
                         overlap_seconds=10.0)
    assert g1.block_len != g2.block_len
    # the functions take the chains and the samples, nothing of a plan
    assert binary_slicer.bytes_needed(chains, n) == binary_slicer.bytes_needed(
        chains, g2.n_audio)
