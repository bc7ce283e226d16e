"""Bulk FIR filtering on tensors.

Port of ``pymodem_tpu.dsp.fir``'s batched engines.  The reference applies
every FIR with ``numpy.convolve(x, taps, 'valid')`` (afsk.py:151-166), so
each stage shortens the stream by ``len(taps) - 1`` samples; stream
addresses downstream count the shortened stream.

Engines, chosen by dtype and tap count as the JAX package's ``auto``
chooses them:

* ``shift`` (f32, <= 8 taps: the AFSK tone correlators): t multiply-adds in
  the JAX shift engine's order.
* ``matmul`` (f32, longer taps): the banded-Toeplitz matmul of the JAX
  package -- the signal framed into 128-sample output tiles with a
  (t-1)-sample halo, each tile one product against a banded matrix of the
  taps -- run by cuBLAS/MKL in full float32 (TF32 off, ``device.py``).
  Every output is a plain f32 dot product of its t terms, as in JAX.
  (cuDNN's ``conv1d`` chooses its algorithm per shape, FFT ones included,
  so its rounding is not pinned; the correlator's decisions are marginal.)
* ``direct`` (f64 on the CPU): ``conv1d`` with the taps flipped, as the
  JAX package's ``conv_general_dilated``.
* f64 on the card (the float64 parity mode): the ``matmul`` engine in
  float64, a DGEMM on cuBLAS, which has no reduced-precision path.  cuDNN's
  ``conv1d`` would pick its algorithm per shape, so its rounding would
  turn on the shape; the banded product pins the engine.  Each output is
  then an f64 dot product of its t terms in cuBLAS's order, within a few
  f64 ulps of the summed terms of the CPU's ``direct`` engine.

Results agree with the JAX package to a few f32 ulps of the summed terms
(another summation order; XLA:CPU also contracts multiply-adds into FMAs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MM_TILE = 128


def _method(x: torch.Tensor, t: int) -> str:
    if x.dtype == torch.float64:
        return "direct" if x.device.type == "cpu" else "matmul"
    return "shift" if t <= 8 else "matmul"


def _as_taps(taps, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(taps, dtype=x.dtype, device=x.device)


def _shift(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """sum_j taps[..., j] * x[..., t-1-j : t-1-j+nout], accumulated in the
    JAX shift engine's order; taps (..., t) broadcast against x (..., n)."""
    t = taps.shape[-1]
    nout = x.shape[-1] - t + 1
    acc = taps[..., t - 1, None] * x[..., 0:nout]
    for j in range(t - 1):
        acc = acc + taps[..., j, None] * x[..., t - 1 - j : t - 1 - j + nout]
    return acc


def _frames(x: torch.Tensor, t: int):
    """(..., n) -> ((..., n_tiles, K) tile frames, n_tiles, nout) with
    K = 128 + t - 1: frame i holds x[i*128 : i*128 + K] (zero padded)."""
    n = x.shape[-1]
    nout = n - t + 1
    k_len = _MM_TILE + t - 1
    n_tiles = -(-nout // _MM_TILE)
    xp = F.pad(x, (0, (n_tiles - 1) * _MM_TILE + k_len - n))
    return xp.unfold(-1, k_len, _MM_TILE), n_tiles, nout


def _band(taps: torch.Tensor) -> torch.Tensor:
    """(..., t) taps -> (..., K, 128) band, band[k, o] = taps[t-1-(k-o)]
    inside the band and 0 outside."""
    t = taps.shape[-1]
    k = torch.arange(_MM_TILE + t - 1, device=taps.device)[:, None]
    o = torch.arange(_MM_TILE, device=taps.device)[None, :]
    idx = t - 1 - (k - o)
    inside = (idx >= 0) & (idx < t)
    band = taps[..., idx.clamp(0, t - 1)]
    return torch.where(inside, band, torch.zeros((), dtype=taps.dtype,
                                                 device=taps.device))


def _matmul(x: torch.Tensor, band: torch.Tensor, t: int) -> torch.Tensor:
    """Banded-Toeplitz FIR: x (..., n) @ band (..., K, 128*k) ->
    (..., n_tiles*128*k) laid out per tile, trimmed by the caller."""
    frames, n_tiles, nout = _frames(x, t)
    return torch.matmul(frames, band), n_tiles, nout


def fir_valid_nd(x: torch.Tensor, taps) -> torch.Tensor:
    """'valid' convolution over the last axis of a batched signal.

    x: (..., n); taps: (t,) shared across the batch.  Output (..., n-t+1),
    out[k] = sum_j x[k + t - 1 - j] * taps[j] (numpy.convolve semantics).
    """
    taps = _as_taps(taps, x)
    t = taps.shape[-1]
    n = x.shape[-1]
    method = _method(x, t)
    if method == "shift":
        return _shift(x, taps)
    if method == "matmul":
        y, n_tiles, nout = _matmul(x, _band(taps), t)
        return y.reshape(*x.shape[:-1], n_tiles * _MM_TILE)[..., :nout]
    out = F.conv1d(x.reshape(-1, 1, n), taps.flip(-1).reshape(1, 1, t))
    return out.reshape(*x.shape[:-1], n - t + 1)


def fir_valid_multi(x: torch.Tensor, taps_stack) -> torch.Tensor:
    """Valid convolution of one signal with K tap sets in one pass.

    x: (..., n); taps_stack: (K, t) -> (K, ..., n-t+1).  The matmul engine
    shares the frames and puts the K bands side by side in one product."""
    taps = _as_taps(taps_stack, x)
    k, t = taps.shape
    n = x.shape[-1]
    method = _method(x, t)
    if method == "shift":
        return torch.stack([_shift(x, taps[i]) for i in range(k)])
    if method == "matmul":
        band = _band(taps)  # (K, Kl, 128)
        y, n_tiles, nout = _matmul(x, torch.cat(list(band), dim=-1), t)
        y = y.reshape(*x.shape[:-1], n_tiles, k, _MM_TILE).movedim(-2, 0)
        return y.reshape(k, *x.shape[:-1], n_tiles * _MM_TILE)[..., :nout]
    out = F.conv1d(x.reshape(-1, 1, n), taps.flip(-1).reshape(k, 1, t))
    return out.movedim(1, 0).reshape(k, *x.shape[:-1], n - t + 1)


def fir_valid_per_chain(x: torch.Tensor, taps) -> torch.Tensor:
    """Per-chain taps over a stacked signal: x (C, B, n), taps (C, t) ->
    (C, B, n-t+1), chain c filtered with taps[c] (the JAX package's
    ``vmap(fir_valid_nd)`` over the chain axis)."""
    taps = _as_taps(taps, x)
    c, t = taps.shape
    n = x.shape[-1]
    method = _method(x, t)
    if method == "shift":
        return _shift(x, taps[:, None, :])
    if method == "matmul":
        y, n_tiles, nout = _matmul(x, _band(taps)[:, None], t)
        return y.reshape(c, x.shape[1], n_tiles * _MM_TILE)[..., :nout]
    out = F.conv1d(x.transpose(0, 1).reshape(-1, c, n),
                   taps.flip(-1).reshape(c, 1, t), groups=c)
    return out.reshape(x.shape[1], c, n - t + 1).transpose(0, 1)
