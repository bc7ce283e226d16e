// K5: the QPSK Costas carrier loop with branch IIRs, the AGC envelope
// follower fused.
//
// Replaces the Pallas TPU kernel pymodem_tpu/dsp/pallas_loops.py
// _iq_loop_kernel, kind "qpsk" (iq_loop_lanes_pallas), itself the lane form
// of agc_apply + qpsk_costas in pymodem_tpu/dsp/agc.py and
// pymodem_tpu/dsp/loops.py (reference agc.py:26-80, psk.py:437-467).
//
// Per sample: AGC (17-row form only), NCO; i = x * cos and q = x * sin,
// each through the branch IIR (b0, a1 from rows 10 and 11):
// cos_out = (b0 * i + b0 * i_prev) + a1 * cos_prev, sin_out alike; the sign
// phase detector e = cos_out * sgn(sin_out) - sin_out * sgn(cos_out) with
// sgn(0) = +1; loop IIR, PI with a saturated integral, control = prop +
// integral.  Outputs: I is the sine branch (sin_out), Q the cosine branch
// (cos_out), as psk.py:453-454.
//
// Rows: the 10 PLL rows, branch_b0, branch_a1, then the 5 AGC rows (17);
// the Pallas kernel's unfused form has 12 rows and no AGC, selected here by
// the fuse_agc flag.
//
// What bounds it on an H100: as K3 (bpsk_costas_loop.cu), each lane is a
// strictly sequential recurrence, here with 11 carries and one dependent
// chain of ~60 operations per sample (an IEEE divide, two table reads, two
// branch IIRs), and the lane count sets the parallelism: the 8-chain
// Costas-QPSK bank over 600 s at 44.1 kHz is ~950 lanes, 8 blocks of 128
// threads on 132 SMs.  The run time is T times the per-step latency; the
// 12 bytes a sample moves are far below what the card streams.
//
// Design: one thread per lane, every carry in registers for the whole T, a
// loop over time inside the thread; lanes masked by index.  Sine and cosine
// come from the 256-entry tables handed in by the caller, read through the
// read-only data cache, so kernel and twin read the same numbers.  Built
// with -fmad=false and without fast math, in the JAX op order, so the
// outputs equal the plain twin (dsp/loops.py qpsk_costas) bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "loop_common.cuh"

namespace {

using pymodem::Agc;
using pymodem::Loop;

constexpr int kLoopRows = 10;    // PLL_PARAMS
constexpr int kBranchRows = 12;  // then branch_b0, branch_a1; then the AGC

// The unfused form's gain stage: the input as it is.
struct NoAgc {
  __device__ NoAgc(const float*, int) {}
  __device__ __forceinline__ float step(float x) const { return x; }
};

template <class Gain>
__global__ void qpsk_costas_kernel(const float* __restrict__ x,
                                   const float* __restrict__ params,
                                   const float* __restrict__ sine_table,
                                   const float* __restrict__ cos_table,
                                   float* __restrict__ out_i,
                                   float* __restrict__ out_q, int L, int T) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;

  Loop loop(params + lane, L);
  const float b0 = params[kLoopRows * L + lane];
  const float a1 = params[(kLoopRows + 1) * L + lane];
  Gain gain(params + kBranchRows * L + lane, L);
  float cos_x = 0.0f, cos_y = 0.0f, sin_x = 0.0f, sin_y = 0.0f;
  const float* xl = x + static_cast<size_t>(lane) * T;
  float* il = out_i + static_cast<size_t>(lane) * T;
  float* ql = out_q + static_cast<size_t>(lane) * T;
  for (int t = 0; t < T; ++t) {
    const float xv = gain.step(xl[t]);
    const int idx = loop.nco();
    const float sine = __ldg(sine_table + idx);
    const float cosine = __ldg(cos_table + idx);
    const float i_mixer = xv * cosine;
    const float cos_out = (b0 * i_mixer + b0 * cos_x) + a1 * cos_y;
    const float q_mixer = xv * sine;
    const float sin_out = (b0 * q_mixer + b0 * sin_x) + a1 * sin_y;
    const float cos_sgn = cos_out >= 0.0f ? 1.0f : -1.0f;
    const float sin_sgn = sin_out >= 0.0f ? 1.0f : -1.0f;
    const float prop = loop.filter((cos_out * sin_sgn) - (sin_out * cos_sgn));
    loop.control = prop + loop.integral;
    cos_x = i_mixer;
    cos_y = cos_out;
    sin_x = q_mixer;
    sin_y = sin_out;
    il[t] = sin_out;
    ql[t] = cos_out;
  }
}

}  // namespace

extern "C" int qpsk_costas_lanes(const float* x, const float* params,
                                 const float* sine_table,
                                 const float* cos_table, float* out_i,
                                 float* out_q, int L, int T, int fuse_agc,
                                 void* stream) {
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    if (fuse_agc) {
      qpsk_costas_kernel<Agc><<<blocks, threads, 0, s>>>(
          x, params, sine_table, cos_table, out_i, out_q, L, T);
    } else {
      qpsk_costas_kernel<NoAgc><<<blocks, threads, 0, s>>>(
          x, params, sine_table, cos_table, out_i, out_q, L, T);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
