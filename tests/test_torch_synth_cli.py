"""The port's golden-WAV generator CLI (``python -m pymodem_tpu_torch.synth``)
against the JAX package's (``pymodem_tpu.synth.__main__.main``).

For one config path and seed per family line, both CLIs write the same WAV
bytes and print the same lines; an absent family config returns 3 in both.
The family shorthands name the reference's bundled configs, which a
checkout of this repository does not hold, so the configs here are JSONL
files written from in-repo lines, named as the bundled configs are (the
CLIs pick the sample rate from the file name).  The port's CLI imports no
torch (tests/test_torch_imports.py).
"""

import io
import json
import os
from contextlib import redirect_stdout

import pytest

from pymodem_tpu.synth.__main__ import main as jmain
from pymodem_tpu_torch.synth.__main__ import FAMILIES, _CONFIG_DIR
from pymodem_tpu_torch.synth.__main__ import main as tmain


def _line(modem, preset, slicer, slicer_preset, poly="0x3", invert="no",
          codec="il2p"):
    return {
        "object_name": f"{modem} {preset}", "object_type": "demod_chain",
        "modem": {"type": modem, "config": preset, "options": {}},
        "slicer": {"type": slicer, "config": slicer_preset, "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": poly,
                                               "invert": invert}},
        "codec": {"type": codec, "options": {"crc": "yes"}},
    }


# config file name (its prefix picks the rate) -> the chain line
CONFIGS = {
    "afsk_300.json": _line("afsk", "300", "binary", "300"),
    "afsk_300_pll.json": _line("afsk_pll", "300", "binary", "300", invert="yes"),
    "afsk_1200_ax25.json": _line("afsk", "1200", "binary", "1200", "0x3",
                                 "yes", "ax25"),
    "bpsk_300.json": _line("bpsk", "300", "binary", "300"),
    "bpsk_1200.json": _line("bpsk", "1200", "binary", "1200"),
    "qpsk_2400.json": _line("qpsk", "2400", "quadrature", "qpsk_2400",
                            "0x1"),
    "fsk_9600.json": _line("fsk", "9600", "binary", "9600", "0x63003"),
    "4fsk_9600.json": _line("fsk", "4800", "4level", "4800", "0x1"),
    "mpsk_qpsk_600.json": _line("mpsk", "qpsk_600", "quadrature",
                                "qpsk_600", "0x1"),
}


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        code = main(argv)
    return code, buf.getvalue()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_wav_and_stdout_equal_jax(name, tmp_path):
    cfg = tmp_path / name
    cfg.write_text(json.dumps(CONFIGS[name]) + "\n" + json.dumps({
        "object_name": "report", "object_type": "report",
        "options": {"style": "decoded_headers"}}) + "\n")
    args = ["--seconds", "3", "--seed", "7"]
    if name == "afsk_300.json":
        args += ["--snr", "20"]
    out = {}
    for pkg, main in (("jax", jmain), ("port", tmain)):
        wav = tmp_path / f"{pkg}.wav"
        code, text = _run(main, [str(cfg), str(wav), *args])
        assert code == 0, text
        out[pkg] = (wav.read_bytes(), text.replace(f"{pkg}.wav", "X.wav"))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert "frame 0: " in out["port"][1]


def test_family_names_and_absent_config(tmp_path):
    """A family name resolves under the reference's config directory, as in
    the JAX package; where that directory is absent both return 3 with the
    same message."""
    assert FAMILIES["afskpll300"] == ("afsk_300_pll.json", 8000)
    for family in ("afskpll300", "fsk9600"):
        want = _run(jmain, [family, str(tmp_path / "j.wav")])
        got = _run(tmain, [family, str(tmp_path / "j.wav")])
        assert got == want
        if not os.path.isdir(_CONFIG_DIR):
            assert got[0] == 3
            assert got[1].startswith("config not found: ")
    missing = str(tmp_path / "none.json")
    assert _run(tmain, [missing, str(tmp_path / "x.wav")]) == \
        _run(jmain, [missing, str(tmp_path / "x.wav")])
