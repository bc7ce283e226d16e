// Device helpers shared by the float64 parity kernels K10-K12
// (binary_slicer_f64.cu, coherent_loop_f64.cu, four_level_slicer_f64.cu).
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

// NaN-propagating min/max, as torch.minimum/maximum
__device__ __forceinline__ double min_nan(double a, double b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ double max_nan(double a, double b) {
  return (a > b || a != a) ? a : b;
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

// Walk a lane's row of T samples ``stride`` apart in chunks, calling
// step(t, x) on each sample in time order.
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

}  // namespace f64
}  // namespace pymodem
