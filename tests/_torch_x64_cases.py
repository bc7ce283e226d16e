"""Cases shared by the float64 tests of the port (test_torch_x64.py and
test_torch_x64_banked.py): chain lines, one chain of each family at its
preset's own rate and its short recording, and the packet rows the tests
compare."""

import os

import numpy as np
import torch

from pymodem_tpu.ops.crc import np_crc16
from pymodem_tpu_torch.config import ReportSpec, build_chain_spec
from pymodem_tpu_torch.synth import fixtures as tfx
from pymodem_tpu_torch.synth import modulate as tmod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
REPORTS = (ReportSpec("decoded", style="decoded_headers"),
           ReportSpec("raw", style="raw"))


def _line(modem, preset, slicer, slicer_preset, poly="0x3", invert="no",
          name=None):
    return {
        "object_name": name or f"{modem} {preset}",
        "object_type": "demod_chain",
        "modem": {"type": modem, "config": preset, "options": {}},
        "slicer": {"type": slicer, "config": slicer_preset, "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": poly,
                                               "invert": invert}},
        "codec": {"type": "il2p", "options": {"crc": "yes"}},
    }


# the families of the f64 mode on the card, each at its preset's own rate
FAMILIES = {
    "afsk300": (_line("afsk", "300", "binary", "300"), 8000.0),
    "afsk300_pll": (_line("afsk_pll", "300", "binary", "300"), 8000.0),
    "bpsk1200": (_line("bpsk", "1200", "binary", "1200"), 44100.0),
    "fsk9600": (_line("fsk", "9600", "binary", "9600", "0x63003"),
                96000.0),
    "fsk4_9600": (_line("fsk", "4800", "4level", "4800", "0x1"), 48000.0),
    "qpsk2400_costas": (_line("qpsk", "2400", "quadrature", "qpsk_2400",
                              "0x1"), 44100.0),
    "mpsk_qpsk2400": (_line("mpsk", "qpsk_2400", "quadrature", "qpsk_2400",
                            "0x1"), 44100.0),
    # at 16 kHz, as the f32 PSK tests run it: the twins step in Python
    "mpsk_bpsk1200": (_line("mpsk", "bpsk_1200", "quadrature", "bpsk_1200"),
                      16000.0),
}
_AUDIO: dict = {}


def _audio(family):
    """(payloads, int16 audio): 2 frames of 10 bytes 300 idle bits apart,
    line-coded per the chain (1-2 s: the twins step in Python); the
    AFSK-300 correlator's on 1600/1800 Hz tones, which the "300" preset
    decodes from any phase."""
    if family not in _AUDIO:
        line, rate = FAMILIES[family]
        chain = build_chain_spec(rate, line)
        rng = np.random.default_rng(20261117)
        if family == "afsk300":
            sent = tfx.payloads(rng, count=2, size=10)
            x = tmod.afsk_modulate(tfx.il2p_line_bits(sent, gap_bits=300),
                                   rate, 300.0, 1600.0, 1800.0)
        else:
            sent, x = tfx.synthesize_for_chain(chain, rate, rng, n_frames=2,
                                               size=10, gap_bits=300)
        _AUDIO[family] = (sent, tmod.to_int16(x))
    return _AUDIO[family]


def _packets(chains):
    return [[(list(map(int, p.data)), np_crc16(np.asarray(p.data[:-2])),
              int(p.streamaddress), int(p.bytes_corrected)) for p in chain]
            for chain in chains]

