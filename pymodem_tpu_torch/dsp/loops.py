"""Carrier loops: kernels K2, K3, K5, K6 and K11 and their plain twins.

Port of the ``pymodem_tpu.dsp.loops`` scans ``afsk_pll``, ``bpsk_costas``,
``qpsk_costas`` and ``mpsk_loop`` and of the Pallas kernels that replace
them on the TPU: ``pymodem_tpu.dsp.pallas_loops._loop_kernel`` kinds
``afsk_pll`` and ``bpsk`` (AGC fused, ``loop_lanes_pallas``) and
``_iq_loop_kernel`` kinds ``qpsk`` (AGC fused or not) and ``mpsk``
(``iq_loop_lanes_pallas``).  Lanes are independent (chain, block) streams
read from ``(R, T)`` input rows, lane l from row ``row_of_lane[l]`` (a
pre-shared bank's C chains share its B band-passed rows; without the map
R == L and lane l reads row l); per-lane constants come as rows:
``PLL_PARAMS`` then ``AGC_PARAMS`` (15) for K2 and K3, ``PLL_PARAMS``,
``BRANCH_PARAMS`` and optionally ``AGC_PARAMS`` (17 or 12) for K5,
``PLL_PARAMS`` then ``PD_PARAMS`` (12) for K6.

Per sample, in the JAX package's op order (reference afsk_pll.py:152-165,
psk.py:173-189, 437-467 and 734-747, agc.py:26-80, nco.py:34-53,
iir.py:38-54, pi_control.py:25-33):

    x     = AGC(x)                         (K2, K3, K5: dsp/agc.agc_step)
    phase = wrap(phase + phase_scale * (set_frequency + control))
    idx   = int(phase * index_scale)       (truncation)
    K2:  e = x * sin[idx];                 output prop (below)
    K3:  i = x * cos[idx]; q = x * (-sin[idx]); e = i * q;  output i
    K5:  c = IIR_b(x * cos[idx]); s = IIR_b(x * sin[idx]);
         e = c * sgn(s) - s * sgn(c);      output (s, c)
    K6:  re' = (re * cos) - (im * (-sin)); im' = (cos * im) + (re * (-sin))
         e = pd[fold(floor(re' * g/2), floor(im' * g/2))];  output re', im'
    y     = (b0 * e + b0 * e_prev) + a1 * y_prev
    prop  = gp * y
    integral = clip(integral + gain * (i_rate * y), -limit, limit)
    control  = prop + integral             (K6: rounded half to even)

The NCO reads sin and cos of the quantised phase from 256-entry tables
handed in as tensors: ``sin``/``cos`` of the same f32 angle differ by an
ulp between XLA, torch-CPU and CUDA on a few of the 256 angles, so kernel
and twin read one table and agree bitwise; ``nco_sine_table`` and
``nco_cos_table`` build them as ``float32(f(float64(angle_f32)))``.  K6's
phase detector is a pure function of the folded integer pair ``(a, b)`` in
``[0, g)^2`` and the chain's gain: ``pd_error_table`` evaluates the JAX
package's f32 formula once per pair on the host, and kernel and twin look
the error up (in place of the Pallas kernel's minimax atan and of CUDA's
``atan2f``, whose rounding is not XLA's).  At f64 the tables
are the reference's own wavetable and table, as the JAX f64 path gathers
(``f64_nco_tables``).

Float64 lanes on the card run kernel K11 (``coherent_loop_f64_lanes``),
the AGC fused with the AFSK PLL or the BPSK Costas loop: one thread a
lane in the twins' op order, the JAX package's f64 scans having no Pallas
kernel to port.  ``afsk_pll_lanes`` and ``bpsk_costas_lanes`` route a
float64 CUDA tensor to it; K5 and K6 take float32 only and refuse float64.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .agc import AGC_PARAMS, agc_step

TWO_PI = 6.283185307179586476925286766559
WAVETABLE_SIZE = 256

# per-lane parameter rows, in the JAX package's order (pallas_loops.py)
PLL_PARAMS = ("phase_scale", "set_frequency", "index_scale", "iir_b0",
              "iir_a1", "pi_gp", "pi_gain", "pi_i", "pi_limit",
              "pi_integral0")
PD_PARAMS = ("pd_gain", "pd_granularity")
BRANCH_PARAMS = ("branch_b0", "branch_a1")  # K5's branch IIR


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
    pi_integral0: np.ndarray  # initial integral (psk.py:703 for mpsk)


def _nco_angles() -> np.ndarray:
    return (np.arange(WAVETABLE_SIZE, dtype=np.float32)
            * np.float32(TWO_PI / WAVETABLE_SIZE)).astype(np.float64)


def nco_sine_table() -> np.ndarray:
    """(256,) float32: sin of each quantised f32 NCO angle
    ``f32(i) * f32(2*pi/256)``, evaluated in float64 and rounded once."""
    return np.sin(_nco_angles()).astype(np.float32)


def nco_cos_table() -> np.ndarray:
    """(256,) float32: cos of the same quantised angles, built the same
    way as ``nco_sine_table``."""
    return np.cos(_nco_angles()).astype(np.float32)


def f64_nco_tables(wavetable: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The NCO's (256,) float64 sine and cosine tables at f64: the
    reference wavetable, and the same table read at (index + 64) mod 256,
    as the JAX package's f64 NCO gathers them
    (``pymodem_tpu.dsp.loops._nco_step``)."""
    table = np.asarray(wavetable, np.float64)
    return table, np.roll(table, -(WAVETABLE_SIZE // 4))


def pd_error_table(granularity: int, gain: float) -> np.ndarray:
    """(granularity**2,) int32: the f32 MPSK phase detector of the JAX
    package (``pymodem_tpu.dsp.loops._pd_lookup``, non-f64 path) at every
    folded pair, entry ``a * g + b``: ``round(gain * (atan2(b, a) deg -
    45))`` where ``0.15 g <= |(a, b)| <= 0.76 g``, else 0; every step in
    float32, rounding half to even."""
    g = np.float32(granularity)
    a, b = np.meshgrid(np.arange(granularity, dtype=np.float32),
                       np.arange(granularity, dtype=np.float32),
                       indexing="ij")
    mag2 = a * a + b * b
    gate = ((mag2 >= np.float32(0.15 * 0.15) * g * g)
            & (mag2 <= np.float32(0.76 * 0.76) * g * g))
    deg = np.arctan2(b, a) * np.float32(180.0 / np.pi)
    err = np.round(np.float32(gain) * (deg - np.float32(45.0)))
    return np.where(gate, err, np.float32(0.0)).astype(np.int32).reshape(-1)


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


def _nco(phase, control, phase_scale, set_freq, index_scale, two_pi):
    """One NCO step: the wrapped phase and the truncated table index."""
    phase = _wrap_phase(phase + phase_scale * (set_freq + control), two_pi)
    # truncation toward zero, as the kernels' int conversion
    idx = (phase * index_scale).long() & (WAVETABLE_SIZE - 1)
    return phase, idx


def _pi(y, integral, gp, gain, pi_i, limit):
    """PI update_saturate: (prop, integral)."""
    prop = gp * y
    integral = torch.minimum(
        torch.maximum(integral + gain * (pi_i * y), -limit), limit)
    return prop, integral


def _coherent_loop(x, lane_params, sine_table, cos_table, kind,
                   row_of_lane):
    """Twin of K2 (``kind="afsk_pll"``) and K3 (``"bpsk"``): the fused
    AGC and carrier loop over L lanes with 15 rows, lane l on input row
    ``row_of_lane[l]`` of x (None: row l)."""
    if row_of_lane is not None:
        x = x[row_of_lane.long()]
    dtype, dev = x.dtype, x.device
    (phase_scale, set_freq, index_scale, b0, a1, gp, gain, pi_i, limit,
     integral0, att, dec, sus_t, sus_inc, target) = lane_params.to(dtype)
    sine = sine_table.to(dtype)
    cosine = None if cos_table is None else cos_table.to(dtype)
    two_pi = torch.tensor(TWO_PI, dtype=dtype, device=dev)
    zero = torch.zeros(x.shape[0], dtype=dtype, device=dev)
    phase, control, iir_x, iir_y = zero, zero, zero, zero
    integral = integral0.clone()
    env, sustain = zero, zero
    out = []
    for x_t in x.t().unbind(0):
        xs, env, sustain = agc_step(x_t, env, sustain, att, dec, sus_t,
                                    sus_inc, target, zero)
        phase, idx = _nco(phase, control, phase_scale, set_freq,
                          index_scale, two_pi)
        if kind == "afsk_pll":
            mixer = xs * sine.take(idx)
        else:
            i_mixer = xs * cosine.take(idx)
            q_mixer = xs * -sine.take(idx)
            mixer = i_mixer * q_mixer
        y = (b0 * mixer + b0 * iir_x) + a1 * iir_y
        prop, integral = _pi(y, integral, gp, gain, pi_i, limit)
        control = prop + integral
        out.append(prop if kind == "afsk_pll" else i_mixer)
        iir_x, iir_y = mixer, y
    return torch.stack(out, dim=1)


def afsk_pll(x: torch.Tensor, lane_params: torch.Tensor,
             sine_table: torch.Tensor,
             row_of_lane: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch twin of kernel K2: vectorised over lanes, a loop over
    time.  x: (R, T) input rows; lane_params: (15, L); sine_table: (256,),
    all of one float dtype (f32, or f64 for parity runs); row_of_lane (L,)
    the input row of each lane (None: lane l reads row l, R == L).
    Returns the (L, T) PI proportional term."""
    return _coherent_loop(x, lane_params, sine_table, None, "afsk_pll",
                          row_of_lane)


def bpsk_costas(x: torch.Tensor, lane_params: torch.Tensor,
                sine_table: torch.Tensor, cos_table: torch.Tensor,
                row_of_lane: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch twin of kernel K3, the BPSK Costas loop with the AGC
    fused: x (R, T) input rows, lane_params (15, L), the two (256,) tables,
    row_of_lane as ``afsk_pll``.  Returns the (L, T) I-mixer stream."""
    return _coherent_loop(x, lane_params, sine_table, cos_table, "bpsk",
                          row_of_lane)


def qpsk_costas(x: torch.Tensor, lane_params: torch.Tensor,
                sine_table: torch.Tensor, cos_table: torch.Tensor,
                row_of_lane: torch.Tensor | None = None):
    """Plain PyTorch twin of kernel K5, the QPSK Costas loop with branch
    IIRs: x (R, T) input rows; lane_params (17, L) with the AGC fused or
    (12, L) without (``PLL_PARAMS``, ``BRANCH_PARAMS``, then
    ``AGC_PARAMS``); the two (256,) tables; row_of_lane (L,) the input row
    of each lane (None: lane l reads row l, R == L).  Returns (i, q), each
    (L, T): I is the sine branch's IIR output and Q the cosine branch's
    (psk.py:453-454).  The phase detector's sign takes +1 at 0."""
    if row_of_lane is not None:
        x = x[row_of_lane.long()]
    dtype, dev = x.dtype, x.device
    rows = lane_params.to(dtype)
    (phase_scale, set_freq, index_scale, b0, a1, gp, gain, pi_i, limit,
     integral0, bb0, ba1) = rows[:12]
    agc_rows = rows[12:] if rows.shape[0] > 12 else None
    sine, cosine = sine_table.to(dtype), cos_table.to(dtype)
    two_pi = torch.tensor(TWO_PI, dtype=dtype, device=dev)
    zero = torch.zeros(x.shape[0], dtype=dtype, device=dev)
    phase, control, iir_x, iir_y = zero, zero, zero, zero
    cos_x, cos_y, sin_x, sin_y = zero, zero, zero, zero
    integral = integral0.clone()
    env, sustain = zero, zero
    outs_i, outs_q = [], []
    for x_t in x.t().unbind(0):
        if agc_rows is not None:
            x_t, env, sustain = agc_step(x_t, env, sustain, *agc_rows, zero)
        phase, idx = _nco(phase, control, phase_scale, set_freq,
                          index_scale, two_pi)
        i_mixer = x_t * cosine.take(idx)
        cos_out = (bb0 * i_mixer + bb0 * cos_x) + ba1 * cos_y
        q_mixer = x_t * sine.take(idx)
        sin_out = (bb0 * q_mixer + bb0 * sin_x) + ba1 * sin_y
        cos_sgn = torch.where(cos_out >= 0, 1.0, -1.0).to(dtype)
        sin_sgn = torch.where(sin_out >= 0, 1.0, -1.0).to(dtype)
        loop_mixer = (cos_out * sin_sgn) - (sin_out * cos_sgn)
        y = (b0 * loop_mixer + b0 * iir_x) + a1 * iir_y
        prop, integral = _pi(y, integral, gp, gain, pi_i, limit)
        control = prop + integral
        outs_i.append(sin_out)
        outs_q.append(cos_out)
        iir_x, iir_y = loop_mixer, y
        cos_x, cos_y, sin_x, sin_y = i_mixer, cos_out, q_mixer, sin_out
    return torch.stack(outs_i, dim=1), torch.stack(outs_q, dim=1)


def mpsk_loop(re: torch.Tensor, im: torch.Tensor, lane_params: torch.Tensor,
              sine_table: torch.Tensor, cos_table: torch.Tensor,
              pd_tables: torch.Tensor, pd_index: torch.Tensor,
              row_of_lane: torch.Tensor | None = None):
    """Plain PyTorch twin of kernel K6, the MPSK loop on the analytic
    signal: re, im (R, T) input rows; lane_params (12, L); the two NCO
    tables; pd_tables (U, g*g) int32 phase-detector tables
    (``pd_error_table``, or the f64 reference table at f64); pd_index (L,)
    the table of each lane; row_of_lane (L,) the input row of each lane
    (None: lane l reads row l, R == L).  Returns the rotated (out_re,
    out_im), each (L, T)."""
    if row_of_lane is not None:
        rows = row_of_lane.long()
        re, im = re[rows], im[rows]
    dtype, dev = re.dtype, re.device
    (phase_scale, set_freq, index_scale, b0, a1, gp, gain, pi_i, limit,
     integral0, _pd_gain, gf) = lane_params.to(dtype)
    sine, cosine = sine_table.to(dtype), cos_table.to(dtype)
    table = pd_tables[pd_index.long()].to(torch.int64)  # (L, g*g)
    gi = gf.to(torch.int32)
    half = gf * 0.5
    two_pi = torch.tensor(TWO_PI, dtype=dtype, device=dev)
    zero = torch.zeros(re.shape[0], dtype=dtype, device=dev)
    phase, control, iir_x, iir_y = zero, zero, zero, zero
    integral = integral0.clone()
    outs_re, outs_im = [], []
    for re_t, im_t in zip(re.t().unbind(0), im.t().unbind(0)):
        phase, idx = _nco(phase, control, phase_scale, set_freq,
                          index_scale, two_pi)
        s, c = sine.take(idx), cosine.take(idx)
        out_re = (re_t * c) - (im_t * -s)
        out_im = (c * im_t) + (re_t * -s)
        # quantise, clamp to +-(g-1), fold into the first quadrant
        r = torch.floor(out_re * half).to(torch.int32)
        i = torch.floor(out_im * half).to(torch.int32)
        r = torch.where(r >= gi, gi - 1, r)
        i = torch.where(i >= gi, gi - 1, i)
        r = torch.where(r <= -gi, -(gi - 1), r)
        i = torch.where(i <= -gi, -(gi - 1), i)
        rn, inn = r >= 0, i >= 0
        a = torch.where(rn, torch.where(inn, r, -i), torch.where(inn, i, -r))
        b = torch.where(rn, torch.where(inn, i, r), torch.where(inn, -r, -i))
        flat = (a * gi + b).long()
        err = table.gather(1, flat[:, None])[:, 0].to(dtype)
        y = (b0 * err + b0 * iir_x) + a1 * iir_y
        prop, integral = _pi(y, integral, gp, gain, pi_i, limit)
        control = torch.round(prop + integral)  # half to even
        outs_re.append(out_re)
        outs_im.append(out_im)
        iir_x, iir_y = err, y
    return torch.stack(outs_re, dim=1), torch.stack(outs_im, dim=1)


def _check_lanes(name, x, lane_params, n_rows, row_of_lane, *tables):
    """Raise ValueError unless lane_params is (n, L) with n in ``n_rows``,
    x holds (R, T) input rows for the L lanes (R == L without
    ``row_of_lane``, else ``row_of_lane`` (L,) int32 in [0, R)) and every
    table is (256,).  Returns L.  On the card the range of ``row_of_lane``
    is asserted on the device (``torch._assert_async``): reading it back
    would wait for every launch queued before it, and a failed assertion
    stops the stream before the kernel reads out of range."""
    n = lane_params.shape[0] if lane_params.ndim == 2 else -1
    if n not in n_rows:
        raise ValueError(f"{name}: {n} lane rows, need "
                         f"{' or '.join(map(str, n_rows))}")
    L = lane_params.shape[1]
    if x.ndim != 2 or (row_of_lane is None and x.shape[0] != L):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)} "
                         f"lane_params {tuple(lane_params.shape)}")
    for t in tables:
        if t.shape != (WAVETABLE_SIZE,):
            raise ValueError(f"{name}: NCO tables must be "
                             f"({WAVETABLE_SIZE},), got {tuple(t.shape)}")
    if row_of_lane is not None:
        if row_of_lane.dtype != torch.int32 or row_of_lane.shape != (L,):
            raise ValueError(f"{name}: row_of_lane must be ({L},) int32, "
                             f"got {tuple(row_of_lane.shape)} "
                             f"{row_of_lane.dtype}")
        if L and row_of_lane.device.type == "cuda":
            torch._assert_async(((row_of_lane >= 0)
                                 & (row_of_lane < x.shape[0])).all())
        elif L and not (0 <= int(row_of_lane.min())
                        and int(row_of_lane.max()) < x.shape[0]):
            raise ValueError(f"{name}: row_of_lane outside the "
                             f"{x.shape[0]} input rows")
    return L


def _staged_rows(x, L, row_of_lane):
    """What the staged loop kernels (K2, K3, K5, K6) take for input rows:
    ``x`` as bulk copies can move it (``_ext.lane_rows``) and each lane's
    row, the identity when ``row_of_lane`` is None."""
    from .. import _ext

    if row_of_lane is None:
        row_of_lane = torch.arange(L, dtype=torch.int32, device=x.device)
    _ext.require(x.device, torch.int32, row_of_lane=row_of_lane)
    return _ext.lane_rows(x), row_of_lane


_COHERENT_ROWS = (len(PLL_PARAMS) + len(AGC_PARAMS),)


def _coherent_lanes(entry, x, lane_params, sine_table, cos_table,
                    row_of_lane):
    """Launch K2 or K3 (``entry``, ``csrc/coherent_loop.cu``) over L lanes
    on (R, T) rows; returns (L, T), a view of rows padded to a multiple of
    4 floats."""
    from .. import _ext

    tables = {"sine_table": sine_table}
    if cos_table is not None:
        tables["cos_table"] = cos_table
    _ext.require_rows(x.device, torch.float32, x=x)
    _ext.require(x.device, torch.float32, lane_params=lane_params, **tables)
    L = lane_params.shape[1]
    R, T = x.shape
    x, row_of_lane = _staged_rows(x, L, row_of_lane)
    out = torch.empty((L, -(-T // 4) * 4), dtype=x.dtype, device=x.device)
    _ext.launch(entry, x.device,
                (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_int) + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3,
                x.data_ptr(), x.stride(0), row_of_lane.data_ptr(), R,
                lane_params.data_ptr(), sine_table.data_ptr(),
                None if cos_table is None else cos_table.data_ptr(),
                out.data_ptr(), out.stride(0), L, T)
    return out[:, :T]


def afsk_pll_lanes(x: torch.Tensor, lane_params: torch.Tensor,
                   sine_table: torch.Tensor,
                   row_of_lane: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K2 (``csrc/coherent_loop.cu``) over L lanes reading (R, T)
    input rows (``row_of_lane`` (L,) int32 in [0, R), None for R == L and
    lane l on row l); returns the (L, T) PI proportional term.  Rows that
    are not 16-byte aligned a multiple of 4 floats apart go to the kernel
    through a padded copy (``_ext.lane_rows``), and the output is a view of
    padded rows when T is not a multiple of 4.

    A CUDA tensor launches the kernel on the current stream (or raises);
    only a CPU tensor takes the plain twin ``afsk_pll``.  A float64 CUDA
    tensor goes to K11 (``coherent_loop_f64_lanes``)."""
    if x.dtype == torch.float64 and x.device.type != "cpu":
        return coherent_loop_f64_lanes("afsk_pll", x, lane_params,
                                       sine_table, None, row_of_lane)
    _check_lanes("afsk_pll_lanes", x, lane_params, _COHERENT_ROWS,
                 row_of_lane, sine_table)
    if x.device.type == "cpu":
        return afsk_pll(x, lane_params, sine_table, row_of_lane)
    out = _coherent_lanes("afsk_pll_lanes", x, lane_params, sine_table, None,
                          row_of_lane)
    afsk_pll_lanes.launches += 1
    return out


def bpsk_costas_lanes(x: torch.Tensor, lane_params: torch.Tensor,
                      sine_table: torch.Tensor, cos_table: torch.Tensor,
                      row_of_lane: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K3 (``csrc/coherent_loop.cu``) over L lanes reading (R, T)
    input rows, as ``afsk_pll_lanes``; returns the (L, T) I-mixer stream.

    A CUDA tensor launches the kernel on the current stream (or raises);
    only a CPU tensor takes the plain twin ``bpsk_costas``.  A float64
    CUDA tensor goes to K11 (``coherent_loop_f64_lanes``)."""
    if x.dtype == torch.float64 and x.device.type != "cpu":
        return coherent_loop_f64_lanes("bpsk", x, lane_params, sine_table,
                                       cos_table, row_of_lane)
    _check_lanes("bpsk_costas_lanes", x, lane_params, _COHERENT_ROWS,
                 row_of_lane, sine_table, cos_table)
    if x.device.type == "cpu":
        return bpsk_costas(x, lane_params, sine_table, cos_table, row_of_lane)
    out = _coherent_lanes("bpsk_costas_lanes", x, lane_params, sine_table,
                          cos_table, row_of_lane)
    bpsk_costas_lanes.launches += 1
    return out


def coherent_loop_f64_lanes(kind: str, x: torch.Tensor,
                            lane_params: torch.Tensor,
                            sine_table: torch.Tensor,
                            cos_table: torch.Tensor | None,
                            row_of_lane: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Kernel K11 (``csrc/coherent_loop_f64.cu``): the AGC fused with the
    AFSK PLL (``kind="afsk_pll"``, twin ``afsk_pll``) or the BPSK Costas
    loop (``"bpsk"``, twin ``bpsk_costas``) at float64, over L lanes on
    (R, T) float64 input rows of unit stride (``row_of_lane`` as
    ``afsk_pll_lanes``); the tables are the reference wavetable and, for
    ``bpsk``, the same table at index + 64 (``f64_nco_tables``).
    ``afsk_pll_lanes`` and ``bpsk_costas_lanes`` route float64 CUDA
    tensors here.  Returns (L, T) float64.

    Only a CPU tensor takes the plain twins."""
    if kind not in ("afsk_pll", "bpsk"):
        raise ValueError(f"coherent_loop_f64_lanes: no kind {kind!r}")
    tables = (sine_table,) if kind == "afsk_pll" else (sine_table, cos_table)
    L = _check_lanes("coherent_loop_f64_lanes", x, lane_params,
                     _COHERENT_ROWS, row_of_lane, *tables)
    if x.device.type == "cpu":
        return _coherent_loop(x, lane_params, sine_table, cos_table, kind,
                              row_of_lane)
    from .. import _ext

    named = dict(zip(("sine_table", "cos_table"), tables))
    _ext.require_rows(x.device, torch.float64, x=x)
    _ext.require(x.device, torch.float64, lane_params=lane_params, **named)
    R, T = x.shape
    if row_of_lane is None:
        row_of_lane = torch.arange(L, dtype=torch.int32, device=x.device)
    _ext.require(x.device, torch.int32, row_of_lane=row_of_lane)
    out = torch.empty((L, T), dtype=torch.float64, device=x.device)
    _ext.launch("coherent_loop_f64_lanes", x.device,
                (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_int) + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4,
                x.data_ptr(), x.stride(0), row_of_lane.data_ptr(), R,
                lane_params.data_ptr(), sine_table.data_ptr(),
                None if kind == "afsk_pll" else cos_table.data_ptr(),
                out.data_ptr(), out.stride(0), L, T, int(kind == "bpsk"))
    coherent_loop_f64_lanes.launches += 1
    return out


def qpsk_costas_lanes(x: torch.Tensor, lane_params: torch.Tensor,
                      sine_table: torch.Tensor, cos_table: torch.Tensor,
                      row_of_lane: torch.Tensor | None = None):
    """Kernel K5 (``csrc/qpsk_costas_loop.cu``) over L lanes reading (R, T)
    input rows (``row_of_lane`` (L,) int32 in [0, R), None for R == L and
    lane l on row l): 17 rows run the AGC fused (the bank's form), 12 rows
    the loop alone.  Returns (i, q), each (L, T).  Rows that are not
    16-byte aligned, or a T that is not a multiple of 4, go to the kernel
    through a padded copy (``_ext.lane_rows``), and the outputs are then
    views of padded rows.

    A CUDA tensor launches the kernel on the current stream (or raises);
    only a CPU tensor takes the plain twin ``qpsk_costas``."""
    n_loop = len(PLL_PARAMS) + len(BRANCH_PARAMS)
    L = _check_lanes("qpsk_costas_lanes", x, lane_params,
                     (n_loop, n_loop + len(AGC_PARAMS)), row_of_lane,
                     sine_table, cos_table)
    if x.device.type == "cpu":
        return qpsk_costas(x, lane_params, sine_table, cos_table,
                           row_of_lane)
    from .. import _ext

    _ext.require(x.device, torch.float32, x=x, lane_params=lane_params,
                 sine_table=sine_table, cos_table=cos_table)
    R, T = x.shape
    x, row_of_lane = _staged_rows(x, L, row_of_lane)
    out_i = torch.empty((L, -(-T // 4) * 4), dtype=x.dtype, device=x.device)
    out_q = torch.empty_like(out_i)
    _ext.launch("qpsk_costas_lanes", x.device,
                (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_int) + (ctypes.c_void_p,) * 5
                + (ctypes.c_int,) * 4,
                x.data_ptr(), x.stride(0), row_of_lane.data_ptr(), R,
                lane_params.data_ptr(), sine_table.data_ptr(),
                cos_table.data_ptr(), out_i.data_ptr(), out_q.data_ptr(),
                out_i.stride(0), L, T, int(lane_params.shape[0] > n_loop))
    qpsk_costas_lanes.launches += 1
    return out_i[:, :T], out_q[:, :T]


# K6's dynamic shared memory left for its detector tables on Hopper (227 KB
# a block): csrc/mpsk_loop.cu stages 3 tiles of 128 + 4 samples of re and
# im for its 32 lanes and the (cos, -sin) table, 1 KB held back for its
# static arrays
MPSK_TABLE_SMEM = 232_448 - (3 * 2 * 32 * 132 * 4 + 8 * WAVETABLE_SIZE) - 1024


def mpsk_tables_staged(pd_ints: int) -> bool:
    """Whether K6 stages its ``pd_ints`` detector-table entries in shared
    memory beside its tiles (else it reads them through the read-only
    cache)."""
    return 4 * pd_ints <= MPSK_TABLE_SMEM


def mpsk_loop_lanes(re: torch.Tensor, im: torch.Tensor,
                    lane_params: torch.Tensor, sine_table: torch.Tensor,
                    cos_table: torch.Tensor, pd_tables: torch.Tensor,
                    pd_index: torch.Tensor,
                    row_of_lane: torch.Tensor | None = None):
    """Kernel K6 (``csrc/mpsk_loop.cu``) over L lanes reading (R, T) input
    rows (``row_of_lane`` (L,) int32, None for R == L and lane l on row l);
    returns (out_re, out_im), each (L, T).  Rows that are not 16-byte
    aligned, or a T that is not a multiple of 4, go to the kernel through
    padded copies (``_ext.lane_rows``), and the outputs are then views of
    padded rows.

    A CUDA tensor launches the kernel on the current stream (or raises);
    only a CPU tensor takes the plain twin ``mpsk_loop``.  ``pd_tables``
    (U, g*g) may hold any number of tables; each lane's granularity must be
    the tables' g."""
    L = _check_lanes("mpsk_loop_lanes", re, lane_params,
                     (len(PLL_PARAMS) + len(PD_PARAMS),), row_of_lane,
                     sine_table, cos_table)
    if im.shape != re.shape or pd_tables.ndim != 2 or pd_index.shape != (L,):
        raise ValueError(f"mpsk_loop_lanes: bad shapes re {tuple(re.shape)}"
                         f" im {tuple(im.shape)} pd_tables "
                         f"{tuple(pd_tables.shape)} pd_index "
                         f"{tuple(pd_index.shape)} for {L} lanes")
    if re.device.type == "cpu":
        return mpsk_loop(re, im, lane_params, sine_table, cos_table,
                         pd_tables, pd_index, row_of_lane)
    from .. import _ext

    _ext.require(re.device, torch.float32, re=re, im=im,
                 lane_params=lane_params, sine_table=sine_table,
                 cos_table=cos_table)
    _ext.require(re.device, torch.int32, pd_tables=pd_tables,
                 pd_index=pd_index)
    n_tab, gg = pd_tables.shape
    g = int(round(gg ** 0.5))
    if g * g != gg or n_tab == 0:
        raise ValueError(f"mpsk_loop_lanes: pd_tables "
                         f"{tuple(pd_tables.shape)} must be (U, g*g)")
    R, T = re.shape
    re, row_of_lane = _staged_rows(re, L, row_of_lane)
    im = _ext.lane_rows(im)
    out_re = torch.empty((L, -(-T // 4) * 4), dtype=re.dtype,
                         device=re.device)
    out_im = torch.empty_like(out_re)
    _ext.launch("mpsk_loop_lanes", re.device,
                (ctypes.c_void_p,) * 2 + (ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_int)
                + (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6,
                re.data_ptr(), im.data_ptr(), re.stride(0),
                row_of_lane.data_ptr(), R, lane_params.data_ptr(),
                sine_table.data_ptr(), cos_table.data_ptr(),
                pd_tables.data_ptr(), pd_index.data_ptr(), out_re.data_ptr(),
                out_im.data_ptr(), out_re.stride(0), L, T, g, n_tab,
                int(mpsk_tables_staged(pd_tables.numel())))
    mpsk_loop_lanes.launches += 1
    return out_re[:, :T], out_im[:, :T]


afsk_pll_lanes.launches = 0
bpsk_costas_lanes.launches = 0
coherent_loop_f64_lanes.launches = 0
qpsk_costas_lanes.launches = 0
mpsk_loop_lanes.launches = 0
