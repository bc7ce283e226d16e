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
// The NCO reads sin of the quantised phase from a 256-entry table that the
// caller hands in and each block stages in shared memory: XLA, torch-CPU
// and CUDA round sin differently on a few of the 256 angles, so one table
// makes kernel and twin agree bitwise.  Built with -fmad=false and without
// fast math, every multiply and add rounds on its own, in the JAX op order
// (dsp/loops.py docstring); the divide is IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTableSize = 256;
constexpr int kRows = 15;

// NaN-propagating min/max, as torch.minimum/maximum and jnp.minimum/maximum
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void afsk_pll_kernel(const float* __restrict__ x,
                                const float* __restrict__ params,
                                const float* __restrict__ sine_table,
                                float* __restrict__ out, int L, int T) {
  __shared__ float table[kTableSize];
  for (int i = threadIdx.x; i < kTableSize; i += blockDim.x) {
    table[i] = sine_table[i];
  }
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;

  float p[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) p[r] = params[r * L + lane];
  const float phase_scale = p[0], set_freq = p[1], index_scale = p[2];
  const float b0 = p[3], a1 = p[4], gp = p[5], gain = p[6], pi_i = p[7];
  const float limit = p[8];
  const float attack = p[10], decay = p[11], sustain_time = p[12];
  const float sustain_inc = p[13], target = p[14];
  const float two_pi = __int_as_float(0x40c90fdb);  // float32(2*pi)

  const float* xl = x + static_cast<size_t>(lane) * T;
  float* ol = out + static_cast<size_t>(lane) * T;
  float phase = 0.0f, control = 0.0f, iir_x = 0.0f, iir_y = 0.0f;
  float integral = p[9];
  float env = 0.0f, sustain = 0.0f;
  for (int t = 0; t < T; ++t) {
    // AGC envelope follower (dsp/agc.py agc_step)
    float xv = xl[t];
    const float cv = fabsf(xv);
    if (cv > env) {
      env = min_nan(env + attack, cv);
      sustain = 0.0f;
    }
    if (sustain >= sustain_time) env = max_nan(env - decay, 0.0f);
    sustain = sustain + sustain_inc;
    if (env != 0.0f) xv = target * xv / env;
    // NCO: wrap by +-2pi twice each way, truncated table index
    float ph = phase + phase_scale * (set_freq + control);
    if (ph >= two_pi) ph = ph - two_pi;
    if (ph >= two_pi) ph = ph - two_pi;
    if (ph < 0.0f) ph = ph + two_pi;
    if (ph < 0.0f) ph = ph + two_pi;
    const int idx = __float2int_rz(ph * index_scale) & (kTableSize - 1);
    // mixer, loop IIR, PI with saturated integral; output = prop
    const float mixer = xv * table[idx];
    const float y = (b0 * mixer + b0 * iir_x) + a1 * iir_y;
    const float prop = gp * y;
    integral = min_nan(max_nan(integral + gain * (pi_i * y), -limit), limit);
    control = prop + integral;
    ol[t] = prop;
    phase = ph;
    iir_x = mixer;
    iir_y = y;
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
