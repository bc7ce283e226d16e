"""Automatic gain control: the envelope follower, kernels K4 and K13 and
their twin.

Port of ``pymodem_tpu.dsp.agc.agc_apply`` (reference agc.py:26-80) and of
the Pallas kernel that runs it over lanes on the TPU,
``pymodem_tpu.dsp.pallas_loops._loop_kernel`` kind ``agc``
(``loop_lanes_pallas``):

* a non-causal pre-pass takes ``normal = max(buffer)`` (signed max over the
  whole buffer, agc.py:67), which scales the attack and decay steps;
* per sample: if |x| > env, env += attack*normal (clipped up to |x|) and
  sustain resets; if sustain >= sustain_time, env -= decay*normal (clipped
  at 0); sustain += 1/fs;
* output: target * x / env when env != 0, else x unchanged.

The follower runs fused inside the AFSK-PLL and BPSK loop kernels
(``dsp/loops.py``) and on its own, as kernel K4, ahead of the MPSK Hilbert
FIR; at float64, the JAX package's parity mode, as kernel K13
(``agc_f64_lanes``, staged as K4 is; the JAX package's f64 ``agc_apply``
scan has no Pallas kernel).  ``agc_step`` is the one copy of its op order, shared by
``agc_follower`` (the twin of K4 and K13, the port's ``agc_apply`` over
lanes) and the loops' twins.
"""

from __future__ import annotations

import ctypes

import torch

# per-lane parameter rows of K4 (and the AGC rows the loop kernels append),
# in the JAX package's order (pallas_loops.py _AGC_PARAMS)
AGC_PARAMS = ("attack_step", "decay_step", "sustain_time",
              "sustain_increment", "target")


def agc_step(x, env, sustain, attack_step, decay_step, sustain_time,
             sustain_increment, target, zero):
    """One follower step over a vector of lanes; returns (out, env,
    sustain).  ``zero``: a zero tensor shaped like ``env``."""
    cv = x.abs()
    rising = cv > env
    env = torch.where(rising, torch.minimum(env + attack_step, cv), env)
    sustain = torch.where(rising, zero, sustain)
    decaying = sustain >= sustain_time
    env = torch.where(decaying, torch.maximum(env - decay_step, zero), env)
    sustain = sustain + sustain_increment
    out = torch.where(env != 0, target * x / env, x)
    return out, env, sustain


def agc_follower(x: torch.Tensor, lane_params: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of kernels K4 and K13: the follower over (L, T)
    lanes, vectorised over lanes with a loop over time.  lane_params:
    (5, L) rows in ``AGC_PARAMS`` order, the steps already scaled by each
    lane's ``normal`` (``dsp/loops.agc_lane_params``)."""
    att, dec, sus_t, sus_inc, target = lane_params.to(x.dtype)
    zero = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    env, sustain = zero, zero
    out = []
    for x_t in x.t().unbind(0):
        y, env, sustain = agc_step(x_t, env, sustain, att, dec, sus_t,
                                   sus_inc, target, zero)
        out.append(y)
    return torch.stack(out, dim=1)


def agc_lanes(x: torch.Tensor, lane_params: torch.Tensor) -> torch.Tensor:
    """Kernel K4 (``csrc/agc_lanes.cu``) over (L, T) lanes.  Rows that are
    not 16-byte aligned, or a T that is not a multiple of 4, go to the
    kernel through a padded copy (``_ext.lane_rows``), and the output is
    then a view of padded rows.

    A CUDA tensor launches the kernel on the current stream (or raises);
    only a CPU tensor takes the plain twin ``agc_follower``.  A float64
    CUDA tensor goes to K13 (``agc_f64_lanes``)."""
    if x.dtype == torch.float64 and x.device.type != "cpu":
        return agc_f64_lanes(x, lane_params)
    _check_shapes(x, lane_params)
    if x.device.type == "cpu":
        return agc_follower(x, lane_params)
    from .. import _ext

    _ext.require(x.device, torch.float32, x=x, lane_params=lane_params)
    L, T = x.shape
    x = _ext.lane_rows(x)
    out = torch.empty((L, -(-T // 4) * 4), dtype=x.dtype, device=x.device)
    _ext.launch("agc_lanes", x.device,
                (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p) + (ctypes.c_int,) * 3,
                x.data_ptr(), x.stride(0), lane_params.data_ptr(),
                out.data_ptr(), out.stride(0), L, T)
    agc_lanes.launches += 1
    return out[:, :T]


def agc_f64_lanes(x: torch.Tensor, lane_params: torch.Tensor) -> torch.Tensor:
    """Kernel K13 (``csrc/coherent_loop_f64.cu``), the follower alone at
    float64, over (L, T) float64 lanes of unit stride with (5, L) float64
    rows; ``agc_lanes`` routes float64 CUDA tensors here.  Rows that are
    not 16-byte aligned a multiple of 2 doubles apart go to the kernel
    through a padded copy (``_ext.lane_rows``).  Returns (L, T) float64, a
    view of padded rows when T is odd.  Only a CPU tensor takes the plain
    twin ``agc_follower``."""
    _check_shapes(x, lane_params)
    if x.device.type == "cpu":
        return agc_follower(x, lane_params)
    from .. import _ext

    _ext.require_rows(x.device, torch.float64, x=x)
    _ext.require(x.device, torch.float64, lane_params=lane_params)
    L, T = x.shape
    x = _ext.lane_rows(x)
    out = torch.empty((L, -(-T // 2) * 2), dtype=torch.float64,
                      device=x.device)
    _ext.launch("agc_f64_lanes", x.device,
                (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p) + (ctypes.c_int,) * 3,
                x.data_ptr(), x.stride(0), lane_params.data_ptr(),
                out.data_ptr(), out.stride(0), L, T)
    agc_f64_lanes.launches += 1
    return out[:, :T]


def _check_shapes(x, lane_params) -> None:
    if x.ndim != 2 or lane_params.shape != (len(AGC_PARAMS), x.shape[0]):
        raise ValueError(f"bad shapes x {tuple(x.shape)} "
                         f"lane_params {tuple(lane_params.shape)}")


agc_lanes.launches = 0
agc_f64_lanes.launches = 0
