// K10: the binary symbol-timing slicer at float64 over (chain x block)
// lanes.
//
// Replaces the lax.scan pymodem_tpu/ops/slicers.py binary_slice (reference
// slicer.py:59-107) on float64 input, which the JAX package runs in its
// float64 parity mode (its Pallas kernel, which K1 replaces, runs float32
// only).  The plain twin is ops/slicers.py binary_slice on float64
// tensors; the emissions are K1's (lanes_f64.cuh Emitter), so the port's
// compaction serves both.
//
// Per sample: the phase clock advances by 1; at a decision (clock reached
// sps/2 - 0.5, then rewound by sps) the byte takes the bit x >= 0; a byte
// completes every 8 decisions; a zero crossing scales the clock by
// lock_rate.
//
// Design (lanes_f64.cuh): one thread a lane, 32 lanes a block, the row
// read from global memory in chunks; clock, byte and bit count in
// registers, updated by selects.

#include <cuda_runtime.h>

#include "lanes_f64.cuh"

namespace {

using namespace pymodem::f64;

__global__ void __launch_bounds__(kLanes)
    binary_slice_f64_kernel(const double* __restrict__ x, int in_stride,
                            const double* __restrict__ params,
                            int* __restrict__ out, int L, int T, int window) {
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= L) return;
  const double sps = params[lane];
  const double lock_rate = params[L + lane];
  const double rollover = sps / 2.0 - 0.5;
  const int n_out = (T + window - 1) / window;
  Emitter em{out + static_cast<size_t>(lane) * n_out, window};
  double clock = 0.0, last = 0.0;
  int byte = 0, bit_count = 0;
  for_each_sample(x + static_cast<size_t>(lane) * in_stride, T,
                  [&](int t, double v) {
    clock = clock + 1.0;
    const bool decide = clock >= rollover;
    clock = decide ? clock - sps : clock;
    const int bit = v >= 0.0;
    byte = decide ? (((byte << 1) & 0xFF) | bit) : byte;
    bit_count += decide;
    // bit_count only reaches 8 on a decision and resets there
    const bool emit = bit_count >= 8;
    bit_count = emit ? 0 : bit_count;
    clock = crossing(last, v) ? clock * lock_rate : clock;
    last = v;
    em.add(t, T, emit, byte);
  });
}

}  // namespace

// Input rows ``in_stride`` doubles apart (any stride >= T); params (2, L)
// rows (sps, lock_rate); out (L, ceil(T / window)) int32.
extern "C" int binary_slice_f64_lanes(const double* x, int in_stride,
                                      const double* params, int* out, int L,
                                      int T, int window, void* stream) {
  if (in_stride < T) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0 && T > 0) {
    binary_slice_f64_kernel<<<blocks, kLanes, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        x, in_stride, params, out, L, T, window);
  }
  return static_cast<int>(cudaGetLastError());
}
