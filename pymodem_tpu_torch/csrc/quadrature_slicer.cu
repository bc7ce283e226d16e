// K7: the quadrature (IQ) symbol-timing slicer over (chain x block) lanes.
//
// Replaces the Pallas TPU kernel pymodem_tpu/ops/pallas_slicers.py
// _quad_kernel (quadrature_slice_lanes_pallas), itself the lane form of
// the scan pymodem_tpu/ops/slicers.py quadrature_slice (reference
// slicer.py:193-242).
//
// Per sample: the phase clock advances by 1; at a decision (clock crossed
// sps/2 - 0.5, then rewound by sps) the state register becomes
// ((state << 2) & state_mask) | (I >= 0) << 1 | (Q >= 0) and the working
// byte takes demap[state], bps bits at a time; a zero crossing on either
// rail scales the clock by lock_rate.  Emissions are K1's encoding
// (binary_slicer.cu): 0x100 | byte per sample, or one
// (pos << 16) | 0x100 | byte per window.
//
// What bounds it on an H100: like K1, each lane is one strictly sequential
// recurrence (~20 dependent compare/select/shift operations per sample),
// so the lane count sets the parallelism (~950 lanes on the QPSK bank, 8
// blocks of 128 threads on 132 SMs) and the run time is T times the
// per-step latency; 8 bytes in per sample, 4 out per window.
//
// Design: one thread per lane, the carry in registers for the whole T; the
// bank-uniform demap (at most 16 entries), state mask and bits per
// decision come as arguments, the demap staged in shared memory.  Lanes
// are masked by index.  Compare/select/shift only, in the JAX op order, so
// the output equals the plain twin (ops/slicers.py quadrature_slice)
// bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDemapMax = 16;

struct Demap {
  int v[kDemapMax];
};

__global__ void quadrature_slice_kernel(const float* __restrict__ i_in,
                                        const float* __restrict__ q_in,
                                        const float* __restrict__ params,
                                        int* __restrict__ out, Demap demap,
                                        int L, int T, int window,
                                        int state_mask, int bps) {
  __shared__ int dm[kDemapMax];
  if (threadIdx.x < kDemapMax) dm[threadIdx.x] = demap.v[threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const float sps = params[lane];
  const float lock_rate = params[L + lane];
  const float rollover = sps / 2.0f - 0.5f;
  const float* il = i_in + static_cast<size_t>(lane) * T;
  const float* ql = q_in + static_cast<size_t>(lane) * T;
  const int n_out = (T + window - 1) / window;
  int* ol = out + static_cast<size_t>(lane) * n_out;

  float clock = 0.0f;
  float last_i = 0.0f;
  float last_q = 0.0f;
  int byte = 0;
  int bit_count = 0;
  int state = 0;
  int acc = 0;
  for (int t = 0; t < T; ++t) {
    const float xi = il[t];
    const float xq = ql[t];
    clock = clock + 1.0f;
    const bool decide = clock >= rollover;
    if (decide) {
      clock = clock - sps;
      state = ((state << 2) & state_mask) | (xi >= 0.0f ? 2 : 0) |
              (xq >= 0.0f ? 1 : 0);
      byte = (byte << bps) | dm[state];
      bit_count += bps;
    }
    const bool emit = decide && bit_count >= 8;
    const int out_byte = byte & 0xFF;
    if (emit) {
      bit_count = 0;
      byte = out_byte;
    }
    const bool crossing =
        (last_i < 0.0f && xi >= 0.0f) || (last_i >= 0.0f && xi < 0.0f) ||
        (last_q < 0.0f && xq >= 0.0f) || (last_q >= 0.0f && xq < 0.0f);
    if (crossing) clock = clock * lock_rate;
    last_i = xi;
    last_q = xq;
    if (window == 1) {
      ol[t] = emit ? (0x100 | out_byte) : 0;
    } else {
      // at most one emission per window (safe_compact_window)
      const int pos = t & (window - 1);
      const int enc = emit ? ((pos << 16) | 0x100 | out_byte) : 0;
      acc = pos == 0 ? enc : (acc | enc);
      if (pos == window - 1 || t == T - 1) ol[t / window] = acc;
    }
  }
}

}  // namespace

extern "C" int quadrature_slice_lanes(const float* i_in, const float* q_in,
                                      const float* params, int* out,
                                      const int* demap, int L, int T,
                                      int window, int state_mask, int bps,
                                      void* stream) {
  Demap d = {};
  for (int k = 0; k < kDemapMax; ++k) d.v[k] = demap[k];
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  if (blocks > 0) {
    quadrature_slice_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        i_in, q_in, params, out, d, L, T, window, state_mask, bps);
  }
  return static_cast<int>(cudaGetLastError());
}
