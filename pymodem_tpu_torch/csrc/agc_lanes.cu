// K4: the standalone AGC envelope follower over (chain x block) lanes.
//
// Replaces the Pallas TPU kernel pymodem_tpu/dsp/pallas_loops.py
// _loop_kernel, kind "agc" (loop_lanes_pallas with the five AGC rows),
// itself the lane form of agc_apply in pymodem_tpu/dsp/agc.py (reference
// agc.py:26-80).  The MPSK path runs it between the band-pass and the
// Hilbert FIR, over the B shared lanes of a carrier sweep or over all C*B
// lanes (runtime/bank.py mpsk_analytic).
//
// What bounds it on an H100: each lane is a sequential recurrence with 2
// carries (envelope, sustain): ~12 dependent operations per sample with an
// IEEE divide, and the lane count (~120 to ~240 on the main path's MPSK
// banks, one or two blocks) sets the parallelism, so the run time is T
// times the per-step latency.  The 8 bytes a sample moves are far below
// what the card streams.
//
// Design: one thread per lane, both carries in registers for the whole T,
// a loop over time inside the thread; lanes masked by index.  Built with
// -fmad=false and without fast math: target * x / env rounds the product
// and the IEEE quotient on their own, as the twin (dsp/agc.py
// agc_follower) and the JAX package do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "loop_common.cuh"

namespace {

__global__ void agc_kernel(const float* __restrict__ x,
                           const float* __restrict__ params,
                           float* __restrict__ out, int L, int T) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  pymodem::Agc agc(params + lane, L);
  const float* xl = x + static_cast<size_t>(lane) * T;
  float* ol = out + static_cast<size_t>(lane) * T;
  for (int t = 0; t < T; ++t) ol[t] = agc.step(xl[t]);
}

}  // namespace

extern "C" int agc_lanes(const float* x, const float* params, float* out,
                         int L, int T, void* stream) {
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  if (blocks > 0) {
    agc_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, params, out, L, T);
  }
  return static_cast<int>(cudaGetLastError());
}
