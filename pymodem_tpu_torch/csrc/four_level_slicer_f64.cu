// K12: the four-level (4FSK) symbol-timing slicer at float64 over
// (chain x block) lanes.
//
// Replaces the lax.scan pymodem_tpu/ops/slicers.py four_level_slice
// (reference slicer.py:329-441, fix-forward) on float64 input, which the
// JAX package runs in its float64 parity mode (its Pallas kernel, which K8
// replaces, runs float32 only).  The plain twin is ops/slicers.py
// four_level_slice on float64 tensors; the emissions are K8's
// (lanes_f64.cuh Emitter).
//
// Per sample, in the twin's order: clock 1 (rollover strictly above
// sps/2 - 0.5) pushes |x| * 2 / 3 into an 8-deep ring and x > 0 into a
// 16-bit sync register; the patterns 0x5555 and 0xCCCC set the threshold
// to the ring's mean (summed r0 + r1 + ... + r7, then / 8) and align
// clock 2 to clock 1; clock 2 decides the symbol (3/2 above/below the
// threshold, 1/0 below/above its negative) through the demap, 2 bits at a
// time; a zero crossing scales clock 1 by lock_rate.
//
// Design (lanes_f64.cuh): one thread a lane, 32 lanes a block, the row
// read from global memory in chunks; both clocks, the ring (eight
// registers, written by selects on the ring index) and the registers of
// the byte and the sync pattern updated by selects.

#include <cuda_runtime.h>

#include "lanes_f64.cuh"

namespace {

using namespace pymodem::f64;

constexpr int kDepth = 8;  // the threshold ring (ops/slicers.py FL_DEPTH)

__global__ void __launch_bounds__(kLanes)
    four_level_slice_f64_kernel(const double* __restrict__ x, int in_stride,
                                const double* __restrict__ params,
                                int* __restrict__ out, int d0, int d1, int d2,
                                int d3, int L, int T, int window) {
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= L) return;
  const double sps = params[lane];
  const double lock_rate = params[L + lane];
  const double rollover = sps / 2.0 - 0.5;
  const int n_out = (T + window - 1) / window;
  Emitter em{out + static_cast<size_t>(lane) * n_out, window};
  double clock1 = 0.0, clock2 = 0.0, threshold = 0.0, last = 0.0;
  double ring[kDepth];
#pragma unroll
  for (int r = 0; r < kDepth; ++r) ring[r] = 0.0;
  int byte = 0, bit_count = 0, sync = 0, ring_index = 0;
  for_each_sample(x + static_cast<size_t>(lane) * in_stride, T,
                  [&](int t, double v) {
    const double new_val = fabs(v) * 2.0 / 3.0;
    const bool positive = v > 0.0;
    clock1 = clock1 + 1.0;
    const bool roll1 = clock1 > rollover;
    clock1 = roll1 ? clock1 - sps : clock1;
    ring_index = roll1 ? (ring_index + 1 >= kDepth ? 0 : ring_index + 1)
                       : ring_index;
#pragma unroll
    for (int r = 0; r < kDepth; ++r) {
      ring[r] = (roll1 && ring_index == r) ? new_val : ring[r];
    }
    sync = roll1 ? ((sync << 1) & 0xFFFF) + positive : sync;
    const bool sync_hit = roll1 && (sync == 0x5555 || sync == 0xCCCC);
    double ring_sum = ring[0];
#pragma unroll
    for (int r = 1; r < kDepth; ++r) ring_sum = ring_sum + ring[r];
    threshold = sync_hit ? ring_sum / kDepth : threshold;
    clock2 = (sync_hit ? clock1 : clock2) + 1.0;
    const bool roll2 = clock2 > rollover;
    clock2 = roll2 ? clock2 - sps : clock2;
    const int symbol = positive ? (v >= threshold ? 3 : 2)
                                : (v <= -threshold ? 0 : 1);
    const int bits = symbol == 3 ? d3 : symbol == 2 ? d2 : symbol == 1 ? d1
                                                                      : d0;
    byte = roll2 ? ((byte << 2) & 0xFF) + bits : byte;
    bit_count = roll2 ? bit_count + 2 : bit_count;
    const bool emit = roll2 && bit_count >= 8;
    bit_count = emit ? 0 : bit_count;
    clock1 = crossing(last, v) ? clock1 * lock_rate : clock1;
    last = v;
    em.add(t, T, emit, byte);
  });
}

}  // namespace

// Input rows ``in_stride`` doubles apart (any stride >= T); params (2, L)
// rows (sps, lock_rate); the 4-entry demap; out (L, ceil(T / window))
// int32.
extern "C" int four_level_slice_f64_lanes(const double* x, int in_stride,
                                          const double* params, int* out,
                                          int d0, int d1, int d2, int d3,
                                          int L, int T, int window,
                                          void* stream) {
  if (in_stride < T) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0 && T > 0) {
    four_level_slice_f64_kernel<<<blocks, kLanes, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        x, in_stride, params, out, d0, d1, d2, d3, L, T, window);
  }
  return static_cast<int>(cudaGetLastError());
}
