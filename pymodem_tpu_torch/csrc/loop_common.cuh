// Device helpers shared by the carrier-loop kernels K2-K6:
// the AGC envelope follower, the NCO step and the PI update, each in the
// JAX package's op order (pymodem_tpu/dsp/loops.py, dsp/agc.py), so that a
// kernel built with -fmad=false and without fast math equals its plain
// PyTorch twin (pymodem_tpu_torch/dsp/loops.py, dsp/agc.py) bitwise.

#pragma once

#include <cuda_runtime.h>

namespace pymodem {

constexpr int kTableSize = 256;

// NaN-propagating min/max, as torch.minimum/maximum and jnp.minimum/maximum
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// min(max(v, lo), hi) by PTX max.NaN and min.NaN, one instruction each
// where min_nan and max_nan take a compare and a select: the same number
// for lo < hi, and the NaN where an operand is NaN (the canonical one, as
// the card's float operations make every NaN that reaches the loops'
// clamp)
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(v), "f"(lo));
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(m), "f"(hi));
  return m;
}

// The AGC follower's per-lane rows (dsp/agc.py AGC_PARAMS) and carries.
struct Agc {
  float attack, decay, sustain_time, sustain_inc, target;
  float env = 0.0f, sustain = 0.0f;

  // rows: the lane's five AGC rows, ``stride`` floats apart
  __device__ Agc(const float* rows, int stride)
      : attack(rows[0]),
        decay(rows[stride]),
        sustain_time(rows[2 * stride]),
        sustain_inc(rows[3 * stride]),
        target(rows[4 * stride]) {}

  // the envelope and sustain update of one step (dsp/agc.py agc_step);
  // returns the new envelope
  __device__ __forceinline__ float follow(float x) {
    const float cv = fabsf(x);
    if (cv > env) {
      env = min_nan(env + attack, cv);
      sustain = 0.0f;
    }
    if (sustain >= sustain_time) env = max_nan(env - decay, 0.0f);
    sustain = sustain + sustain_inc;
    return env;
  }

  // the step's output for envelope e: target * x / e is an IEEE divide,
  // and x passes unchanged while e is 0
  __device__ __forceinline__ float gain(float x, float e) const {
    return e != 0.0f ? target * x / e : x;
  }

  // one step: follow, then gain
  __device__ __forceinline__ float step(float x) { return gain(x, follow(x)); }
};

// The NCO, loop IIR and PI controller of one lane: rows PLL_PARAMS
// (dsp/loops.py), ``stride`` floats apart.
struct Loop {
  float phase_scale, set_freq, index_scale, b0, a1, gp, gain, pi_i, limit;
  float phase = 0.0f, control = 0.0f, iir_x = 0.0f, iir_y = 0.0f;
  float integral;

  __device__ Loop(const float* rows, int stride)
      : phase_scale(rows[0]),
        set_freq(rows[stride]),
        index_scale(rows[2 * stride]),
        b0(rows[3 * stride]),
        a1(rows[4 * stride]),
        gp(rows[5 * stride]),
        gain(rows[6 * stride]),
        pi_i(rows[7 * stride]),
        limit(rows[8 * stride]),
        integral(rows[9 * stride]) {}

  // The NCO step: phase + phase_scale * (set_freq + control), wrapped by
  // +-2pi twice each way in that order (dsp/loops.py _wrap_phase), then
  // the truncated table index.  The four conditional wraps are selects
  // among candidates computed side by side: a phase at or above 2pi never
  // ends below 0, so the taken path does the same arithmetic and the phase
  // is the same, in fewer dependent steps.  The index goes through a
  // 64-bit conversion, as the twins' .long() on the card (exact below
  // 2^63, saturating above, NaN to 0): a 32-bit one saturates at 2^31 and
  // differs on a phase that has run away past 2^31 / index_scale
  __device__ __forceinline__ int nco_select() {
    const float two_pi = __int_as_float(0x40c90fdb);  // float32(2*pi)
    const float p = phase + phase_scale * (set_freq + control);
    const float d1 = p - two_pi;
    const float d2 = d1 - two_pi;
    const float u1 = p + two_pi;
    const float u2 = u1 + two_pi;
    const float down = d1 >= two_pi ? d2 : d1;
    const float up = u1 < 0.0f ? u2 : u1;
    const float ph = p >= two_pi ? down : (p < 0.0f ? up : p);
    phase = ph;
    return static_cast<int>(__float2ll_rz(ph * index_scale)) &
           (kTableSize - 1);
  }

  // loop IIR on the error e, then PI with a saturated integral; returns
  // prop and leaves prop + integral for the caller to make the control
  __device__ __forceinline__ float filter(float e) {
    const float y = (b0 * e + b0 * iir_x) + a1 * iir_y;
    iir_x = e;
    iir_y = y;
    integral = clamp_nan(integral + gain * (pi_i * y), -limit, limit);
    return gp * y;
  }
};

}  // namespace pymodem
