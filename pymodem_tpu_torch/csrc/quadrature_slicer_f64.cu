// K16: the quadrature (IQ) symbol-timing slicer at float64 over
// (chain x block) lanes.
//
// Replaces the lax.scan pymodem_tpu/ops/slicers.py quadrature_slice
// (reference slicer.py:193-242) on float64 input, which the JAX package
// runs in its float64 parity mode (its Pallas kernel, which K7 replaces,
// runs float32 only).  The plain twin is ops/slicers.py quadrature_slice
// on float64 tensors; the emissions are K7's (lanes_f64.cuh Emitter).
//
// Per sample, in the twin's order: the phase clock advances by 1; at a
// decision (clock reached sps/2 - 0.5, then rewound by sps) the state
// register becomes ((state << 2) & state_mask) | (I >= 0) << 1 | (Q >= 0),
// the working byte takes demap[state], bps bits at a time, and the bit
// count grows by bps; a byte completes when the count reaches 8 (the count
// resets and the byte keeps its low 8 bits); a zero crossing on either
// rail scales the clock by lock_rate.
//
// What bounds it: each lane is one sequential recurrence whose only float
// dependency is the clock (add, compare, subtract, multiply), the lanes
// (944 on the 8-chain PSK banks) are the parallelism; 16 bytes a sample
// in, 4 out per window.
//
// Design (lanes_f64.cuh): one thread a lane, 32 lanes a block, both rows
// read from global memory in chunks; clock, state, byte and bit count in
// registers, updated by selects; the demap packed two bits an entry into
// one register, as K7 takes it.

#include <cuda_runtime.h>

#include "lanes_f64.cuh"

namespace {

using namespace pymodem::f64;

__global__ void __launch_bounds__(kLanes)
    quadrature_slice_f64_kernel(const double* __restrict__ i_in,
                                const double* __restrict__ q_in,
                                int in_stride,
                                const double* __restrict__ params,
                                int* __restrict__ out, unsigned demap, int L,
                                int T, int window, int state_mask, int bps) {
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= L) return;
  const double sps = params[lane];
  const double lock_rate = params[L + lane];
  const double rollover = sps / 2.0 - 0.5;
  const int n_out = (T + window - 1) / window;
  Emitter em{out + static_cast<size_t>(lane) * n_out, window};
  double clock = 0.0, last_i = 0.0, last_q = 0.0;
  int byte = 0, bit_count = 0, state = 0;
  const size_t row = static_cast<size_t>(lane) * in_stride;
  for_each_pair(i_in + row, q_in + row, T, [&](int t, double vi, double vq) {
    const int signs = (vi >= 0.0 ? 2 : 0) | (vq >= 0.0 ? 1 : 0);
    clock = clock + 1.0;
    const bool decide = clock >= rollover;
    clock = decide ? clock - sps : clock;
    state = decide ? (((state << 2) & state_mask) | signs) : state;
    byte = decide ? ((byte << bps) |
                     static_cast<int>((demap >> (2 * state)) & 3u))
                  : byte;
    bit_count = decide ? bit_count + bps : bit_count;
    const bool emit = bit_count >= 8;
    bit_count = emit ? 0 : bit_count;
    const int out_byte = byte & 0xFF;
    byte = emit ? out_byte : byte;
    clock = (crossing(last_i, vi) || crossing(last_q, vq)) ? clock * lock_rate
                                                           : clock;
    last_i = vi;
    last_q = vq;
    em.add(t, T, emit, out_byte);
  });
}

}  // namespace

// I and Q rows ``in_stride`` doubles apart (any stride >= T); params
// (2, L) rows (sps, lock_rate); demap entry s (0-3) in bits 2s, 2s + 1;
// out (L, ceil(T / window)) int32.
extern "C" int quadrature_slice_f64_lanes(const double* i_in,
                                          const double* q_in, int in_stride,
                                          const double* params, int* out,
                                          unsigned demap, int L, int T,
                                          int window, int state_mask, int bps,
                                          void* stream) {
  if (in_stride < T) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0 && T > 0) {
    quadrature_slice_f64_kernel<<<blocks, kLanes, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        i_in, q_in, in_stride, params, out, demap, L, T, window, state_mask,
        bps);
  }
  return static_cast<int>(cudaGetLastError());
}
