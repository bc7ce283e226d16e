"""The AFSK PLL carrier loop with fused AGC: kernel K2 and its plain twin.

Port of ``pymodem_tpu.dsp.loops.afsk_pll`` (the scan) and of the Pallas
kernel that replaces it on the TPU,
``pymodem_tpu.dsp.pallas_loops._loop_kernel`` (kind ``afsk_pll``, AGC fused,
``loop_lanes_pallas``).  Lanes are independent (chain, block) streams
handed over as ``(L, T)`` rows; per-lane constants come as 15 rows:
``PLL_PARAMS`` then ``AGC_PARAMS``.

Per sample, in the JAX package's op order (reference afsk_pll.py:152-165,
agc.py:26-80, nco.py:34-53, iir.py:38-54, pi_control.py:25-33):

    x     = AGC(x)                                   (dsp/agc.agc_step)
    phase = wrap(phase + phase_scale * (set_frequency + control))
    idx   = int(phase * index_scale)                 (truncation)
    mixer = x * sine[idx]
    y     = (b0 * mixer + b0 * mixer_prev) + a1 * y_prev
    prop  = gp * y
    integral = clip(integral + gain * (i_rate * y), -limit, limit)
    control  = prop + integral;   output = prop

The NCO sine is a 256-entry table indexed by the quantised phase, handed in
as a tensor.  ``sin`` of the same f32 angle differs by an ulp between XLA,
torch-CPU and CUDA on a few of the 256 angles, so kernel and twin read one
table and agree bitwise; ``nco_sine_table`` builds it as
``float32(sin(float64(angle_f32)))``.  At f64 (twin only) the table is the
reference's own wavetable, as the JAX f64 path gathers it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .agc import agc_step

TWO_PI = 6.283185307179586476925286766559
WAVETABLE_SIZE = 256

# per-lane parameter rows, in the JAX package's order (pallas_loops.py)
PLL_PARAMS = ("phase_scale", "set_frequency", "index_scale", "iir_b0",
              "iir_a1", "pi_gp", "pi_gain", "pi_i", "pi_limit",
              "pi_integral0")
AGC_PARAMS = ("attack_step", "decay_step", "sustain_time",
              "sustain_increment", "target")


class LoopParams(NamedTuple):
    """Per-chain loop constants (numpy on the host, stacked per bank)."""

    wavetable: np.ndarray  # (256,) reference NCO sine table
    set_frequency: np.ndarray  # carrier frequency in Hz
    phase_scale: np.ndarray  # 2*pi/sample_rate (nco.py:31)
    index_scale: np.ndarray  # wavetable_size/(2*pi) (nco.py:27)
    iir_b0: np.ndarray  # loop LPF numerator (b1 == b0)
    iir_a1: np.ndarray  # loop LPF denominator
    pi_gp: np.ndarray  # gain * p_rate, pre-fused
    pi_gain: np.ndarray  # gain (kept separate for the integral term)
    pi_i: np.ndarray  # i_rate
    pi_limit: np.ndarray  # integral saturation bound
    pi_integral0: np.ndarray  # initial integral


def nco_sine_table() -> np.ndarray:
    """(256,) float32: sin of each quantised f32 NCO angle
    ``f32(i) * f32(2*pi/256)``, evaluated in float64 and rounded once."""
    angle = (np.arange(WAVETABLE_SIZE, dtype=np.float32)
             * np.float32(TWO_PI / WAVETABLE_SIZE))
    return np.sin(angle.astype(np.float64)).astype(np.float32)


def lane_params_from_loop(loop: dict, n_chains: int,
                          blocks_per_chain: int,
                          dtype=torch.float32) -> torch.Tensor:
    """(10, C*B) per-lane rows from (C,)-leaf loop constants (tensors)."""
    return torch.stack([
        torch.as_tensor(loop[name]).to(dtype).reshape(n_chains)
        .repeat_interleave(blocks_per_chain)
        for name in PLL_PARAMS
    ])


def agc_lane_params(agc: dict, normals: torch.Tensor, n_chains: int,
                    blocks_per_chain: int,
                    dtype=torch.float32) -> torch.Tensor:
    """(5, C*B) AGC rows.  ``normals`` is the per-chain whole-recording
    signed max (agc.py:67) that scales the attack and decay steps."""
    normals = normals.to(dtype).reshape(n_chains)

    def leaf(name):
        return torch.as_tensor(agc[name]).to(
            dtype=dtype, device=normals.device).reshape(n_chains)

    rows = [
        leaf("scaled_attack") * normals,
        leaf("scaled_decay") * normals,
        leaf("sustain_time"),
        leaf("sustain_increment"),
        leaf("target"),
    ]
    return torch.stack([r.repeat_interleave(blocks_per_chain) for r in rows])


def _wrap_phase(p: torch.Tensor, two_pi) -> torch.Tensor:
    """Wrap into [0, 2pi) by conditional +-2pi, twice each way
    (nco.py:36-39)."""
    p = torch.where(p >= two_pi, p - two_pi, p)
    p = torch.where(p >= two_pi, p - two_pi, p)
    p = torch.where(p < 0, p + two_pi, p)
    p = torch.where(p < 0, p + two_pi, p)
    return p


def afsk_pll(x: torch.Tensor, lane_params: torch.Tensor,
             sine_table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of kernel K2: vectorised over lanes, a loop over
    time.  x: (L, T); lane_params: (15, L); sine_table: (256,), all of one
    float dtype (f32, or f64 for parity runs).  Returns the (L, T) PI
    proportional term."""
    dtype, dev = x.dtype, x.device
    p = lane_params.to(dtype)
    (phase_scale, set_freq, index_scale, b0, a1, gp, gain, pi_i, limit,
     integral0, att, dec, sus_t, sus_inc, target) = p
    table = sine_table.to(dtype)
    two_pi = torch.tensor(TWO_PI, dtype=dtype, device=dev)
    zero = torch.zeros(x.shape[0], dtype=dtype, device=dev)
    phase, control, iir_x, iir_y = zero, zero, zero, zero
    integral = integral0.clone()
    env, sustain = zero, zero
    out = []
    for x_t in x.t().unbind(0):
        xs, env, sustain = agc_step(x_t, env, sustain, att, dec, sus_t,
                                    sus_inc, target, zero)
        phase = _wrap_phase(phase + phase_scale * (set_freq + control), two_pi)
        # truncation toward zero, as the kernel's int conversion
        idx = (phase * index_scale).long() & (WAVETABLE_SIZE - 1)
        mixer = xs * table.take(idx)
        y = (b0 * mixer + b0 * iir_x) + a1 * iir_y
        prop = gp * y
        integral = torch.minimum(
            torch.maximum(integral + gain * (pi_i * y), -limit), limit)
        control = prop + integral
        out.append(prop)
        iir_x, iir_y = mixer, y
    return torch.stack(out, dim=1)


def afsk_pll_lanes(x: torch.Tensor, lane_params: torch.Tensor,
                   sine_table: torch.Tensor) -> torch.Tensor:
    """Kernel K2 (``csrc/afsk_pll_loop.cu``) over (L, T) lanes.

    A CUDA tensor launches the kernel on the current stream (or raises);
    only a CPU tensor takes the plain twin ``afsk_pll``."""
    n_rows = len(PLL_PARAMS) + len(AGC_PARAMS)
    if x.ndim != 2 or lane_params.shape != (n_rows, x.shape[0]):
        raise ValueError(f"bad shapes x {tuple(x.shape)} "
                         f"lane_params {tuple(lane_params.shape)}")
    if sine_table.shape != (WAVETABLE_SIZE,):
        raise ValueError(f"sine_table must be ({WAVETABLE_SIZE},)")
    if x.device.type == "cpu":
        return afsk_pll(x, lane_params, sine_table)
    if x.device.type != "cuda":
        raise ValueError(f"afsk_pll_lanes: unsupported device {x.device}")
    from .. import _ext

    for name, t in (("x", x), ("lane_params", lane_params),
                    ("sine_table", sine_table)):
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous float32 tensor on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    L, T = x.shape
    out = torch.empty_like(x)
    fn = _ext.kernel("afsk_pll_lanes", (ctypes.c_void_p,) * 4
                     + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _ext.check("afsk_pll_lanes", fn(
            x.data_ptr(), lane_params.data_ptr(), sine_table.data_ptr(),
            out.data_ptr(), L, T, stream))
    afsk_pll_lanes.launches += 1
    return out


afsk_pll_lanes.launches = 0
