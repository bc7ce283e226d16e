// K6: the MPSK carrier loop on the analytic signal.
//
// Replaces the Pallas TPU kernel pymodem_tpu/dsp/pallas_loops.py
// _iq_loop_kernel, kind "mpsk" (iq_loop_lanes_pallas), itself the lane form
// of mpsk_loop in pymodem_tpu/dsp/loops.py (reference psk.py:734-747).
//
// Per sample: NCO; the analytic sample (re, im) rotated by (cos, -sin) as
// re' = (re * cos) - (im * (-sin)), im' = (cos * im) + (re * (-sin));
// the phase detector quantises floor(re' * g/2), floor(im' * g/2), clamps
// to +-(g-1), folds into the first quadrant and looks the error up; loop
// IIR on the error; PI with a saturated integral (pre-seeded, row 9);
// control = round-half-to-even(prop + integral).  Outputs re' and im'.
//
// What bounds it on an H100: each lane is a strictly sequential recurrence
// with 5 carries, one dependent chain of ~50 operations per sample (three
// table reads), and the lane count sets the parallelism: the 8-chain QPSK
// bank over 600 s at 44.1 kHz is ~950 lanes, 8 blocks of 128 threads on
// 132 SMs.  The run time is T times the per-step latency; the 16 bytes a
// sample moves are far below what the card streams.
//
// Design: one thread per lane, the carries in registers for the whole T,
// a loop over time inside the thread; lanes masked by index.  The phase
// detector is a pure function of the folded pair (a, b) in [0, g)^2 and
// the chain's gain, so the caller hands in int32 error tables (U, g*g),
// built on the host from the JAX package's f32 formula (dsp/loops.py
// pd_error_table), with each lane's table; the lane reads its table
// through the read-only data cache (a 16 KB table at the presets' g = 64
// stays cached), so a bank may carry any number of distinct gains.  This
// replaces the Pallas kernel's minimax atan (which Mosaic needed) and
// CUDA's atan2f, whose rounding is not XLA's.  Sine and cosine come from
// 256-entry tables staged in shared memory, as in K2 and K3.  Built with
// -fmad=false and without fast math, in the JAX op order; rintf rounds
// half to even like jnp.round and torch.round.

#include <cuda_runtime.h>
#include <stdint.h>

#include "loop_common.cuh"

namespace {

using pymodem::kTableSize;
using pymodem::Loop;

constexpr int kLoopRows = 10;  // PLL_PARAMS, then pd_gain, pd_granularity

__global__ void mpsk_loop_kernel(const float* __restrict__ re,
                                 const float* __restrict__ im,
                                 const float* __restrict__ params,
                                 const float* __restrict__ sine_table,
                                 const float* __restrict__ cos_table,
                                 const int* __restrict__ pd_tables,
                                 const int* __restrict__ pd_index,
                                 float* __restrict__ out_re,
                                 float* __restrict__ out_im, int L, int T,
                                 int g, int n_tables) {
  __shared__ float sine[kTableSize];
  __shared__ float cosine[kTableSize];
  const int gg = g * g;
  pymodem::stage(sine, sine_table, kTableSize);
  pymodem::stage(cosine, cos_table, kTableSize);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;

  Loop loop(params + lane, L);
  const float gf = params[(kLoopRows + 1) * L + lane];
  const int gi = __float2int_rz(gf);
  const float half = gf * 0.5f;
  // the clamps only keep a mismatched call inside the tables
  const int which = min(max(pd_index[lane], 0), n_tables - 1);
  const int* table = pd_tables + static_cast<size_t>(which) * gg;
  const float* rl = re + static_cast<size_t>(lane) * T;
  const float* il = im + static_cast<size_t>(lane) * T;
  float* orl = out_re + static_cast<size_t>(lane) * T;
  float* oil = out_im + static_cast<size_t>(lane) * T;
  for (int t = 0; t < T; ++t) {
    const float re_t = rl[t];
    const float im_t = il[t];
    const int idx = loop.nco();
    const float c = cosine[idx];
    const float ns = -sine[idx];
    const float o_re = (re_t * c) - (im_t * ns);
    const float o_im = (c * im_t) + (re_t * ns);
    // quantise, clamp to +-(g-1), fold into the first quadrant
    int r = __float2int_rz(floorf(o_re * half));
    int i = __float2int_rz(floorf(o_im * half));
    r = r >= gi ? gi - 1 : r;
    i = i >= gi ? gi - 1 : i;
    r = r <= -gi ? -(gi - 1) : r;
    i = i <= -gi ? -(gi - 1) : i;
    const bool rn = r >= 0;
    const bool inn = i >= 0;
    const int a = rn ? (inn ? r : -i) : (inn ? i : -r);
    const int b = rn ? (inn ? i : r) : (inn ? -r : -i);
    // (a, b) lies in [0, g)^2 when the lane's granularity is the tables'
    // (runtime/bank.py builds both from the same leaf)
    const int flat = min(max(a * gi + b, 0), gg - 1);
    const float prop = loop.filter(static_cast<float>(__ldg(table + flat)));
    loop.control = rintf(prop + loop.integral);
    orl[t] = o_re;
    oil[t] = o_im;
  }
}

}  // namespace

extern "C" int mpsk_loop_lanes(const float* re, const float* im,
                               const float* params, const float* sine_table,
                               const float* cos_table, const int* pd_tables,
                               const int* pd_index, float* out_re,
                               float* out_im, int L, int T, int g,
                               int n_tables, void* stream) {
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  if (blocks > 0) {
    mpsk_loop_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        re, im, params, sine_table, cos_table, pd_tables, pd_index, out_re,
        out_im, L, T, g, n_tables);
  }
  return static_cast<int>(cudaGetLastError());
}
