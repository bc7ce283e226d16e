// Device helpers shared by the float64 parity kernels K11 and K13-K15
// (coherent_loop_f64.cu for K11 and K13, iq_loop_f64.cu for K14 and K15):
// the step arithmetic of the AGC (``Agc``) and of the NCO, loop IIR and PI
// (``Loop``), in the plain twins' op order, so that a build with
// -fmad=false and no fast math equals the twins bitwise.
//
// Those kernels replace lax.scan recurrences that the JAX package runs at
// float64 (it runs no Pallas kernel at f64).  They stage their rows in
// shared memory (lane_tiles_f64.cuh), as the f64 slicers K10, K12 and K16
// do, and take the structs' pieces from here.

#pragma once

#include <cuda_runtime.h>

namespace pymodem {
namespace f64 {

constexpr int kLanes = 32;  // lanes a block (lane_tiles.cuh's kLanes)
constexpr int kTableSize = 256;  // the NCO's wavetable
constexpr double kTwoPi = 6.283185307179586476925286766559;

// NaN-propagating min/max, as torch.minimum/maximum
__device__ __forceinline__ double min_nan(double a, double b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ double max_nan(double a, double b) {
  return (a > b || a != a) ? a : b;
}

// The AGC follower of one lane (dsp/agc.py agc_step): its five rows
// (AGC_PARAMS), ``stride`` doubles apart, and its carries.
struct Agc {
  double attack, decay, sustain_time, sustain_inc, target;
  double env = 0.0, sustain = 0.0;

  __device__ Agc(const double* rows, int stride)
      : attack(rows[0]),
        decay(rows[stride]),
        sustain_time(rows[2 * stride]),
        sustain_inc(rows[3 * stride]),
        target(rows[4 * stride]) {}

  // the envelope and sustain update of one step, by selects in the twin's
  // order; returns the new envelope
  __device__ __forceinline__ double follow(double x) {
    const double cv = fabs(x);
    const bool rising = cv > env;
    env = rising ? min_nan(env + attack, cv) : env;
    sustain = rising ? 0.0 : sustain;
    env = sustain >= sustain_time ? max_nan(env - decay, 0.0) : env;
    sustain = sustain + sustain_inc;
    return env;
  }

  // the step's output for envelope e: (target * x) / e, an IEEE divide,
  // and x itself while e is 0
  __device__ __forceinline__ double gain(double x, double e) const {
    return e != 0.0 ? target * x / e : x;
  }

  // follow over n samples of a staged row x (lane_tiles_f64.cuh), two a
  // double2, the envelopes into env; past an odd n the last step reads the
  // row's padding and writes only env's
  __device__ __forceinline__ void follow_tile(const double* x, double* env,
                                              int n) {
#pragma unroll 4
    for (int c = 0; c < n; c += 2) {
      const double2 a = *reinterpret_cast<const double2*>(x + c);
      double2 e;
      e.x = follow(a.x);
      e.y = follow(a.y);
      *reinterpret_cast<double2*>(env + c) = e;
    }
  }

  // gain in place over the double2 columns c0, c0 + step, ... of n samples
  // of a staged row x whose envelopes are env
  __device__ __forceinline__ void gain_tile(double* x, const double* env,
                                            int n, int c0, int step) const {
#pragma unroll 2
    for (int c = c0; c < n; c += step) {
      const double2 a = *reinterpret_cast<const double2*>(x + c);
      const double2 e = *reinterpret_cast<const double2*>(env + c);
      *reinterpret_cast<double2*>(x + c) =
          make_double2(gain(a.x, e.x), gain(a.y, e.y));
    }
  }
};

// The NCO, loop IIR and PI controller of one lane (dsp/loops.py _nco,
// _pi): its rows PLL_PARAMS, ``stride`` doubles apart, and its carries.
struct Loop {
  double phase_scale, set_freq, index_scale, b0, a1, gp, gain, pi_i, limit;
  double phase = 0.0, control = 0.0, iir_x = 0.0, iir_y = 0.0;
  double integral;

  __device__ Loop(const double* rows, int stride)
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

  // The NCO's step: phase + phase_scale * (set_freq + control), wrapped
  // as the twins wrap it (by -2pi while >= 2pi, twice, then by +2pi while
  // < 0, twice), then the table index truncated through a 64-bit
  // conversion (the twins' .long()).  The wraps are selects among
  // candidates computed side by side, in fewer dependent steps than four
  // conditional wraps in turn: a phase at or above 2pi never ends below 0
  // (p - 2pi >= 0 exactly or after rounding, as rounding is monotone), and
  // one below 0 is never wrapped down, so the taken path does the twins'
  // arithmetic and the phase and index are theirs bit for bit.
  __device__ __forceinline__ int nco_select() {
    const double p = phase + phase_scale * (set_freq + control);
    const double d1 = p - kTwoPi;
    const double d2 = d1 - kTwoPi;
    const double u1 = p + kTwoPi;
    const double u2 = u1 + kTwoPi;
    const double down = d1 >= kTwoPi ? d2 : d1;
    const double up = u1 < 0.0 ? u2 : u1;
    const double ph = p >= kTwoPi ? down : (p < 0.0 ? up : p);
    phase = ph;
    return static_cast<int>(__double2ll_rz(ph * index_scale)) &
           (kTableSize - 1);
  }

  // the loop IIR on the error e, then PI with a saturated integral;
  // returns prop, the caller making the control from prop + integral
  __device__ __forceinline__ double filter(double e) {
    const double y = (b0 * e + b0 * iir_x) + a1 * iir_y;
    integral = min_nan(max_nan(integral + gain * (pi_i * y), -limit), limit);
    iir_x = e;
    iir_y = y;
    return gp * y;
  }
};

}  // namespace f64
}  // namespace pymodem
