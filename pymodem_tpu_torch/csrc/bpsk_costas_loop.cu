// K3: the BPSK Costas carrier loop with the AGC envelope follower fused.
//
// Replaces the Pallas TPU kernel pymodem_tpu/dsp/pallas_loops.py
// _loop_kernel, kind "bpsk" with fuse_agc (loop_lanes_pallas), itself the
// lane form of agc_apply + bpsk_costas in pymodem_tpu/dsp/agc.py and
// pymodem_tpu/dsp/loops.py (reference agc.py:26-80, psk.py:173-189).
//
// Per sample: AGC, NCO, i = x * cos, q = x * (-sin), error i * q, loop IIR,
// PI with a saturated integral, control = prop + integral; the output is
// the I mixer.
//
// What bounds it on an H100: as K2 (afsk_pll_loop.cu), each lane is a
// strictly sequential recurrence with 7 carries, one dependent chain of
// ~45 operations per sample (an IEEE divide, two table reads), and the lane
// count sets the parallelism: the 8-chain BPSK bank over 600 s at 44.1 kHz
// is ~900 lanes, 8 blocks of 128 threads on 132 SMs.  The run time is T
// times the per-step latency; the 8 bytes a sample moves are far below
// what the card streams.
//
// Design: one thread per lane, the carries in registers for the whole T,
// a loop over time inside the thread; lanes masked by index.  Sine and
// cosine come from 256-entry tables handed in by the caller and staged in
// shared memory, as in K2, so kernel and twin read the same numbers.
// Built with -fmad=false and without fast math, in the JAX op order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "loop_common.cuh"

namespace {

using pymodem::Agc;
using pymodem::kTableSize;
using pymodem::Loop;

constexpr int kLoopRows = 10;  // PLL_PARAMS, then the five AGC rows

__global__ void bpsk_costas_kernel(const float* __restrict__ x,
                                   const float* __restrict__ params,
                                   const float* __restrict__ sine_table,
                                   const float* __restrict__ cos_table,
                                   float* __restrict__ out, int L, int T) {
  __shared__ float sine[kTableSize];
  __shared__ float cosine[kTableSize];
  pymodem::stage(sine, sine_table, kTableSize);
  pymodem::stage(cosine, cos_table, kTableSize);
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
    const float i_mixer = xv * cosine[idx];
    const float q_mixer = xv * (-sine[idx]);
    const float prop = loop.filter(i_mixer * q_mixer);
    loop.control = prop + loop.integral;
    ol[t] = i_mixer;
  }
}

}  // namespace

extern "C" int bpsk_costas_lanes(const float* x, const float* params,
                                 const float* sine_table,
                                 const float* cos_table, float* out, int L,
                                 int T, void* stream) {
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  if (blocks > 0) {
    bpsk_costas_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        x, params, sine_table, cos_table, out, L, T);
  }
  return static_cast<int>(cudaGetLastError());
}
