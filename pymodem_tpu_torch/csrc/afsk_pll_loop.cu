// K2: the AFSK PLL carrier loop with the AGC envelope follower fused.
//
// Replaces the Pallas TPU kernel pymodem_tpu/dsp/pallas_loops.py
// _loop_kernel, kind "afsk_pll" with fuse_agc (loop_lanes_pallas), itself
// the lane form of agc_apply + afsk_pll in pymodem_tpu/dsp/agc.py and
// pymodem_tpu/dsp/loops.py (reference agc.py:26-80, afsk_pll.py:152-165).
//
// What bounds it on an H100: every lane is a strictly sequential
// recurrence with 7 carries (phase, control, IIR x/y, PI integral, AGC
// envelope and sustain), so a lane costs one dependent chain per sample of
// ~40 operations including an IEEE divide and a table read, and the lane
// count sets the parallelism: the 8-chain PLL bank over 600 s is ~350
// lanes, 3 blocks of 128 threads on 132 SMs.  The run time is T times the
// per-step latency; bytes moved (8 per sample) are far below what the card
// streams.
//
// Design: one thread per lane, the carries in registers for the whole T
// and a loop over time inside the thread, in place of the TPU's sequential
// time-chunk grid and its VMEM scratch; lanes masked by index, no padding.
// The AGC step, the NCO and the PI update are loop_common.cuh's, shared
// with K3, K4 and K6.
// The NCO reads sin of the quantised phase from a 256-entry table that the
// caller hands in and each block stages in shared memory: XLA, torch-CPU
// and CUDA round sin differently on a few of the 256 angles, so one table
// makes kernel and twin agree bitwise.  Built with -fmad=false and without
// fast math, every multiply and add rounds on its own, in the JAX op order
// (dsp/loops.py docstring); the divide is IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

#include "loop_common.cuh"

namespace {

using pymodem::Agc;
using pymodem::kTableSize;
using pymodem::Loop;

constexpr int kLoopRows = 10;  // PLL_PARAMS, then the five AGC rows

__global__ void afsk_pll_kernel(const float* __restrict__ x,
                                const float* __restrict__ params,
                                const float* __restrict__ sine_table,
                                float* __restrict__ out, int L, int T) {
  __shared__ float sine[kTableSize];
  pymodem::stage(sine, sine_table, kTableSize);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;

  Loop loop(params + lane, L);
  Agc agc(params + kLoopRows * L + lane, L);
  const float* xl = x + static_cast<size_t>(lane) * T;
  float* ol = out + static_cast<size_t>(lane) * T;
  for (int t = 0; t < T; ++t) {
    const float xv = agc.step(xl[t]);
    const int idx = loop.nco();
    // mixer, loop IIR, PI with saturated integral; output = prop
    const float prop = loop.filter(xv * sine[idx]);
    loop.control = prop + loop.integral;
    ol[t] = prop;
  }
}

}  // namespace

extern "C" int afsk_pll_lanes(const float* x, const float* params,
                              const float* sine_table, float* out, int L,
                              int T, void* stream) {
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  if (blocks > 0) {
    afsk_pll_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        x, params, sine_table, out, L, T);
  }
  return static_cast<int>(cudaGetLastError());
}
