"""Byte count of kernel K2, the fused AGC and AFSK PLL
(``pymodem_tpu_torch/csrc/coherent_loop.cu``), from the traffic alone.

K2 needs its band-passed input read once: one float32 stream a distinct
input band-pass (chains that share the band-pass share the stream), the
loop's output (a float32 a sample) written once per chain, each chain's 15
constants and the 256-entry sine table read once.  Block overlap and lane
padding are not counted."""

from __future__ import annotations

KERNEL = "coherent_loop_kernel"


def bytes_needed(chains: list, n_samples: int) -> float:
    loops = [c for c in chains if c.modem.kind == "afsk_pll"]
    bands = {(c.modem.sample_rate, c.modem.input_bpf_low_cutoff,
              c.modem.input_bpf_high_cutoff, c.modem.input_bpf_span)
             for c in loops}
    return (4.0 * n_samples * len(bands) + 4.0 * n_samples * len(loops)
            + 60.0 * len(loops) + 1024.0)
