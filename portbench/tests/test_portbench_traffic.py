"""The generator: the same seed gives the same recordings; every seed the
same amount of work."""

import json

import numpy as np
import pytest

from portbench import loadgen
from portbench.tests import tiny_bench
from portbench.tests.tiny_bench import SRC

SEED = 2**33 + 17


def _small(config: str, mix: str) -> tuple[dict, dict]:
    cfg = (tiny_bench.qpsk2400_sweep() if config == "qpsk2400" else
           json.loads((SRC / f"configs/{config}.json").read_text()))
    m = json.loads((SRC / f"traffic/{mix}.json").read_text())
    m["seconds"] = m["segment_seconds"] = 120
    return cfg, m


@pytest.mark.parametrize("config,mix", [
    ("afsk300_pll_sweep64", "busy_10min"),
    ("afsk1200_ax25_sweep8", "busy_10min"),
    ("afsk300_pll_sweep64", "quiet_hour"),
    ("qpsk2400", "busy_10min"),
])
def test_deterministic_for_a_seed(config, mix):
    cfg, m = _small(config, mix)
    a, sent_a = loadgen.recordings(cfg, m, SEED)
    b, sent_b = loadgen.recordings(cfg, m, SEED)
    c, sent_c = loadgen.recordings(cfg, m, SEED + 1)
    assert sent_a == sent_b and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert len(a) == m["recordings"] and a[0].dtype == np.int16
    assert len(a[0]) == int(120 * cfg["sample_rate"])
    assert abs(sent_c - sent_a) <= 0.1 * sent_a + 1


def test_quiet_mix_fixes_the_frame_count():
    cfg, m = _small("afsk300_pll_sweep64", "quiet_hour")
    m["seconds"], m["segment_seconds"] = 720, 360
    counts = {loadgen.recordings(cfg, m, s)[1] for s in (1, 2, 3)}
    assert counts == {2 * 2 * 3}  # 3 a segment, 2 segments, 2 recordings


def test_no_clipping_at_the_highest_snr():
    cfg, m = _small("afsk300_pll_sweep64", "busy_10min")
    recs, _ = loadgen.recordings(cfg, m, SEED)
    assert np.abs(recs[0].astype(np.int32)).max() < 32767
