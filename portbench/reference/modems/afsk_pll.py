"""The AFSK PLL (upstream afsk_pll.py): band-pass, the AGC follower and
the PLL as one plain loop a sample, low-pass of the PI proportional term."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np

from ..frozen.modems import _loop_params_host, afsk_pll_params

COHERENT = True
BYTES_PER_CHAIN_SAMPLE = 40


def params(spec):
    p = afsk_pll_params(spec)
    return SimpleNamespace(input_bpf=p.input_bpf, output_lpf=p.output_lpf,
                           agc=p.agc, loop=_loop_params_host(spec))


def trim(p) -> int:
    return len(p.input_bpf) - 1 + len(p.output_lpf) - 1


def _agc_pll(x: list, att: float, dec: float, sus_t: float, sus_inc: float,
             target: float, loop, q) -> list:
    """The AGC follower and the AFSK PLL over one lane (upstream agc.py
    and afsk_pll.py, the port's op order); returns the PI proportional
    term.  ``q`` rounds each state (``float`` in the reference)."""
    two_pi = 2.0 * math.pi
    sine = [float(v) for v in loop.wavetable]
    phase_scale, set_freq = float(loop.phase_scale), float(loop.set_frequency)
    index_scale = float(loop.index_scale)
    b0, a1 = float(loop.iir_b0), float(loop.iir_a1)
    gp, gain, pi_i = float(loop.pi_gp), float(loop.pi_gain), float(loop.pi_i)
    limit, integral = float(loop.pi_limit), float(loop.pi_integral0)
    env = sustain = phase = control = iir_x = iir_y = 0.0
    out = [0.0] * len(x)
    for t, v in enumerate(x):
        cv = abs(v)
        if cv > env:
            env = q(min(env + att, cv))
            sustain = 0.0
        if sustain >= sus_t:
            env = q(max(env - dec, 0.0))
        sustain = q(sustain + sus_inc)
        xs = q(target * v / env) if env != 0.0 else v
        phase = q(phase + phase_scale * (set_freq + control))
        if phase >= two_pi:
            phase -= two_pi
        if phase >= two_pi:
            phase -= two_pi
        if phase < 0.0:
            phase += two_pi
        if phase < 0.0:
            phase += two_pi
        mixer = q(xs * sine[int(phase * index_scale) & 255])
        y = q((b0 * mixer + b0 * iir_x) + a1 * iir_y)
        prop = q(gp * y)
        integral = q(min(max(integral + gain * (pi_i * y), -limit), limit))
        control = q(prop + integral)
        out[t] = prop
        iir_x, iir_y = mixer, y
    return out


def baseband(spec, p, frame: np.ndarray, normal: float, arith) -> np.ndarray:
    x = arith.fir(frame, p.input_bpf)
    a = p.agc
    prop = _agc_pll(x.tolist(), float(a.scaled_attack) * normal,
                    float(a.scaled_decay) * normal, float(a.sustain_time),
                    float(a.sustain_increment), float(a.target), p.loop,
                    arith.q)
    return arith.fir(np.asarray(prop), p.output_lpf)
