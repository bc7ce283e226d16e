// Device helpers shared by the float64 parity kernels K10-K16
// (binary_slicer_f64.cu, coherent_loop_f64.cu for K11 and K13,
// four_level_slicer_f64.cu, iq_loop_f64.cu for K14 and K15,
// quadrature_slicer_f64.cu).
//
// Those kernels replace lax.scan recurrences that the JAX package runs at
// float64 (it runs no Pallas kernel at f64): one thread a lane, the lane's
// state in registers, its row read straight from global memory a chunk of
// kChunk samples at a time (the loads of a chunk are independent of the
// state, so they are in flight together), and every step in the plain
// twin's op order, so that a build with -fmad=false and no fast math
// equals the twin bitwise.  32 lanes a block, so that the lanes spread
// over as many SMs as there are warps.

#pragma once

#include <cuda_runtime.h>

namespace pymodem {
namespace f64 {

constexpr int kLanes = 32;  // threads a block, one lane each
constexpr int kChunk = 8;   // samples loaded ahead of the steps
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

  // one step, by selects in the twin's order; the output is
  // (target * x) / env, and x itself while env is 0
  __device__ __forceinline__ double step(double x) {
    const double cv = fabs(x);
    const bool rising = cv > env;
    env = rising ? min_nan(env + attack, cv) : env;
    sustain = rising ? 0.0 : sustain;
    env = sustain >= sustain_time ? max_nan(env - decay, 0.0) : env;
    sustain = sustain + sustain_inc;
    return env != 0.0 ? target * x / env : x;
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

  // phase + phase_scale * (set_freq + control), wrapped by +-2pi twice
  // each way in that order, then the table index truncated through a
  // 64-bit conversion (the twins' .long())
  __device__ __forceinline__ int nco() {
    double ph = phase + phase_scale * (set_freq + control);
    ph = ph >= kTwoPi ? ph - kTwoPi : ph;
    ph = ph >= kTwoPi ? ph - kTwoPi : ph;
    ph = ph < 0.0 ? ph + kTwoPi : ph;
    ph = ph < 0.0 ? ph + kTwoPi : ph;
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

// Copy ``n`` values from global to shared memory, the block's threads
// striding; the caller synchronises.
template <typename V>
__device__ __forceinline__ void stage(V* dst, const V* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// The zero crossing of the slicers' twins (ops/slicers.py _crossings):
// last = 0 before a row's first sample; a NaN crosses nothing.
__device__ __forceinline__ bool crossing(double last, double x) {
  return (last < 0.0 && x >= 0.0) || (last >= 0.0 && x < 0.0);
}

// The emission encoding of ops/slicers.py: at window 1 the dense
// 0x100 | byte stream; at a window of w samples (a power of two <= 256)
// each window's single emission as (pos << 16) | 0x100 | byte (the OR of
// its samples' codes), 0 for none.
struct Emitter {
  int* row;  // the lane's output row, ceil(T / w) ints
  int window, code = 0;

  __device__ __forceinline__ void add(int t, int T, bool emit, int byte) {
    if (window == 1) {
      row[t] = emit ? (0x100 | byte) : 0;
      return;
    }
    const int pos = t & (window - 1);
    code |= emit ? ((pos << 16) | 0x100 | byte) : 0;
    if (pos == window - 1 || t == T - 1) {
      row[t / window] = code;
      code = 0;
    }
  }
};

// Walk a lane's row of T samples in chunks, calling step(t, x) on each
// sample in time order.
template <typename Step>
__device__ __forceinline__ void for_each_sample(const double* row, int T,
                                                Step&& step) {
  int t0 = 0;
  for (; t0 + kChunk <= T; t0 += kChunk) {
    double xv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) xv[j] = row[t0 + j];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) step(t0 + j, xv[j]);
  }
  for (int t = t0; t < T; ++t) step(t, row[t]);
}

// for_each_sample over two rows side by side: step(t, a, b).
template <typename Step>
__device__ __forceinline__ void for_each_pair(const double* row_a,
                                              const double* row_b, int T,
                                              Step&& step) {
  int t0 = 0;
  for (; t0 + kChunk <= T; t0 += kChunk) {
    double av[kChunk], bv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      av[j] = row_a[t0 + j];
      bv[j] = row_b[t0 + j];
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) step(t0 + j, av[j], bv[j]);
  }
  for (int t = t0; t < T; ++t) step(t, row_a[t], row_b[t]);
}

}  // namespace f64
}  // namespace pymodem
