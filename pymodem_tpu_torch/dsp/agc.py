"""Automatic gain control: the envelope follower as a plain recurrence.

Port of ``pymodem_tpu.dsp.agc.agc_apply`` (reference agc.py:26-80):

* a non-causal pre-pass takes ``normal = max(buffer)`` (signed max over the
  whole buffer, agc.py:67), which scales the attack and decay steps;
* per sample: if |x| > env, env += attack*normal (clipped up to |x|) and
  sustain resets; if sustain >= sustain_time, env -= decay*normal (clipped
  at 0); sustain += 1/fs;
* output: target * x / env when env != 0, else x unchanged.

On the main path the follower runs fused inside the AFSK-PLL loop kernel
(``dsp/loops.py``); ``agc_step`` is the one copy of its op order, shared by
``agc_apply`` and the loop's plain twin.
"""

from __future__ import annotations

import torch


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


def agc_apply(x: torch.Tensor, scaled_attack, scaled_decay, sustain_time,
              sustain_increment, target_amplitude,
              normal=None) -> torch.Tensor:
    """Apply AGC along the last axis of ``x`` (any leading lane dims).

    The scalar constants are cast to ``x``'s dtype; ``normal`` defaults to
    the signed max over the whole of ``x`` (agc.py:67)."""
    dtype, dev = x.dtype, x.device

    def c(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    if normal is None:
        normal = x.max()
    normal = c(normal)
    attack_step = c(scaled_attack) * normal
    decay_step = c(scaled_decay) * normal
    st, si, tg = c(sustain_time), c(sustain_increment), c(target_amplitude)
    xt = x.movedim(-1, 0)
    env = torch.zeros(xt.shape[1:], dtype=dtype, device=dev)
    sustain = zero = torch.zeros_like(env)
    out = []
    for x_t in xt.unbind(0):
        y, env, sustain = agc_step(x_t, env, sustain, attack_step,
                                   decay_step, st, si, tg, zero)
        out.append(y)
    return torch.stack(out).movedim(0, -1)
