// K1: the binary symbol-timing slicer over (chain x block) lanes.
//
// Replaces the Pallas TPU kernel pymodem_tpu/ops/pallas_slicers.py
// _binary_kernel (binary_slice_lanes_pallas), itself the lane form of the
// scan pymodem_tpu/ops/slicers.py binary_slice (reference slicer.py:59-107).
//
// What bounds it on an H100: each lane is one strictly sequential
// recurrence (phase clock, last sample, working byte, bit count), so a lane
// costs one dependent chain of ~15 compare/select/shift operations per
// sample, and the lane count sets the parallelism: the 64-chain sweep bank
// gives ~2.6k lanes, about 21 blocks of 128 threads on 132 SMs, so most of
// the card idles and the run time is T times the per-step latency.
// Memory is light: 4 bytes in per sample, 4 bytes out per window.
//
// Design: one thread per lane, the carry in registers for the whole T and
// a loop over time inside the thread, in place of the TPU's sequential
// time-chunk grid and its VMEM scratch.  Lanes are masked by index (no
// padding to the TPU's 1024-lane tile, no sps=1 padded lanes).  Input is
// (L, T) row-major as the runtime hands it over, so neighbouring threads
// read addresses T apart: uncoalesced, but each thread's next 31 samples
// sit in the same 128-byte line, which stays in L1.  Making this fast
// (time-splitting, staged tiles) is later work.
//
// Numerics: compare/select/shift only, in the JAX op order, so the output
// equals the plain twin (ops/slicers.py binary_slice) bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void binary_slice_kernel(const float* __restrict__ x,
                                    const float* __restrict__ params,
                                    int* __restrict__ out, int L, int T,
                                    int window) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const float sps = params[lane];
  const float lock_rate = params[L + lane];
  const float rollover = sps / 2.0f - 0.5f;
  const float* xl = x + static_cast<size_t>(lane) * T;
  const int n_out = (T + window - 1) / window;
  int* ol = out + static_cast<size_t>(lane) * n_out;

  float clock = 0.0f;
  float last = 0.0f;
  int byte = 0;
  int bit_count = 0;
  int acc = 0;
  for (int t = 0; t < T; ++t) {
    const float xt = xl[t];
    clock = clock + 1.0f;
    const bool decide = clock >= rollover;
    if (decide) {
      clock = clock - sps;
      byte = ((byte << 1) & 0xFF) | (xt >= 0.0f ? 1 : 0);
      bit_count += 1;
    }
    const bool emit = decide && bit_count >= 8;
    if (emit) bit_count = 0;
    const bool crossing =
        (last < 0.0f && xt >= 0.0f) || (last >= 0.0f && xt < 0.0f);
    if (crossing) clock = clock * lock_rate;
    last = xt;
    if (window == 1) {
      ol[t] = emit ? (0x100 | byte) : 0;
    } else {
      // at most one emission per window (safe_compact_window): the
      // window's code is the OR of its per-sample codes, position in
      // bits 16+
      const int pos = t & (window - 1);
      const int enc = emit ? ((pos << 16) | 0x100 | byte) : 0;
      acc = pos == 0 ? enc : (acc | enc);
      if (pos == window - 1 || t == T - 1) ol[t / window] = acc;
    }
  }
}

}  // namespace

extern "C" int binary_slice_lanes(const float* x, const float* params,
                                  int* out, int L, int T, int window,
                                  void* stream) {
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  if (blocks > 0) {
    binary_slice_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        x, params, out, L, T, window);
  }
  return static_cast<int>(cudaGetLastError());
}
