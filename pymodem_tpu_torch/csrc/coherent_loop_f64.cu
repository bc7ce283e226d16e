// K11 and K13: the float64 AGC, fused with the AFSK PLL (K11 kind
// afsk_pll) or the BPSK Costas loop (K11 kind bpsk), or alone (K13), over
// (chain x block) lanes.
//
// Replaces the lax.scans that the JAX package runs in its float64 parity
// mode (its Pallas loop kernel, which K2, K3 and K4 replace, runs float32
// only): pymodem_tpu/dsp/agc.py agc_apply, alone (ahead of the MPSK
// Hilbert FIR) or followed by pymodem_tpu/dsp/loops.py afsk_pll or
// bpsk_costas (reference afsk_pll.py:152-165, psk.py:173-189,
// agc.py:26-80, nco.py:34-53, iir.py:38-54, pi_control.py:25-33).  The
// plain twins are dsp/loops.py afsk_pll and bpsk_costas and dsp/agc.py
// agc_follower on float64 tensors.
//
// Per sample, in the twins' order (dsp/loops.py module docstring):
//
//     x     = AGC(x)                      (dsp/agc.py agc_step)
//     K13: output x
//     phase = wrap(phase + phase_scale * (set_frequency + control))
//     idx   = int(phase * index_scale)    (truncation)
//     afsk_pll: e = x * sin[idx];                     output prop
//     bpsk:     i = x * cos[idx]; e = i * (x * -sin[idx]); output i
//     y     = (b0 * e + b0 * e_prev) + a1 * y_prev
//     prop  = gp * y
//     integral = clip(integral + gain * (i_rate * y), -limit, limit)
//     control  = prop + integral
//
// The NCO gathers the reference's 256-entry wavetable, as the JAX package
// does at f64 (pymodem_tpu/dsp/loops.py _nco_step): sin[i] is the table
// and cos[i] the table at (i + 64) mod 256, handed in as two tables.
//
// What bounds it: each lane is one sequential recurrence, ~40 dependent
// f64 operations a step for K11 and ~10 for K13, and the lanes (~100 to
// ~1,000 on the banks) are the parallelism; 16 bytes a sample move.
//
// Design (lanes_f64.cuh): one thread a lane, 32 lanes a block; lane l
// reads input row row_of_lane[l] (a pre-shared bank's B shared rows; K13
// reads row l) straight from global memory in chunks; the tables in shared
// memory; the AGC, NCO, IIR and PI state in registers.

#include <cuda_runtime.h>

#include "lanes_f64.cuh"

namespace {

using namespace pymodem::f64;

template <bool kBpsk>
__global__ void __launch_bounds__(kLanes)
    coherent_loop_f64_kernel(const double* __restrict__ x, int in_stride,
                             const int* __restrict__ row_of_lane,
                             const double* __restrict__ params,
                             const double* __restrict__ sine,
                             const double* __restrict__ cosine,
                             double* __restrict__ out, int out_stride, int L,
                             int T) {
  __shared__ double sin_s[kTableSize];
  __shared__ double cos_s[kTableSize];
  stage(sin_s, sine, kTableSize);
  if (kBpsk) stage(cos_s, cosine, kTableSize);
  __syncthreads();
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= L) return;
  Loop loop(params + lane, L);
  Agc agc(params + 10 * L + lane, L);
  double* orow = out + static_cast<size_t>(lane) * out_stride;
  for_each_sample(
      x + static_cast<size_t>(row_of_lane[lane]) * in_stride, T,
      [&](int t, double v) {
        const double xs = agc.step(v);
        const int idx = loop.nco();
        double mixer, emitted = 0.0;
        if (kBpsk) {
          const double i_mixer = xs * cos_s[idx];
          const double q_mixer = xs * -sin_s[idx];
          mixer = i_mixer * q_mixer;
          emitted = i_mixer;
        } else {
          mixer = xs * sin_s[idx];
        }
        const double prop = loop.filter(mixer);
        loop.control = prop + loop.integral;
        orow[t] = kBpsk ? emitted : prop;
      });
}

__global__ void __launch_bounds__(kLanes)
    agc_f64_kernel(const double* __restrict__ x, int in_stride,
                   const double* __restrict__ params,
                   double* __restrict__ out, int out_stride, int L, int T) {
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= L) return;
  Agc agc(params + lane, L);
  double* orow = out + static_cast<size_t>(lane) * out_stride;
  for_each_sample(x + static_cast<size_t>(lane) * in_stride, T,
                  [&](int t, double v) { orow[t] = agc.step(v); });
}

}  // namespace

// K11.  Input rows ``in_stride`` doubles apart (any stride >= T), lane l
// on row row_of_lane[l] < R; params (15, L), PLL_PARAMS then AGC_PARAMS
// (dsp/loops.py); the two (256,) tables (cosine unused, and may be null,
// for kind 0); out (L, T) rows ``out_stride`` apart.  kind 0 is
// afsk_pll, 1 bpsk.
extern "C" int coherent_loop_f64_lanes(const double* x, int in_stride,
                                       const int* row_of_lane, int R,
                                       const double* params,
                                       const double* sine,
                                       const double* cosine, double* out,
                                       int out_stride, int L, int T, int kind,
                                       void* stream) {
  if (in_stride < T || out_stride < T || R < 1 || kind < 0 || kind > 1 ||
      (kind == 1 && cosine == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0 && T > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind == 1) {
      coherent_loop_f64_kernel<true><<<blocks, kLanes, 0, s>>>(
          x, in_stride, row_of_lane, params, sine, cosine, out, out_stride,
          L, T);
    } else {
      coherent_loop_f64_kernel<false><<<blocks, kLanes, 0, s>>>(
          x, in_stride, row_of_lane, params, sine, cosine, out, out_stride,
          L, T);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K13.  Input rows ``in_stride`` doubles apart (any stride >= T), lane l
// on row l; params (5, L), AGC_PARAMS (dsp/agc.py); out (L, T) rows
// ``out_stride`` apart.
extern "C" int agc_f64_lanes(const double* x, int in_stride,
                             const double* params, double* out,
                             int out_stride, int L, int T, void* stream) {
  if (in_stride < T || out_stride < T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0 && T > 0) {
    agc_f64_kernel<<<blocks, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        x, in_stride, params, out, out_stride, L, T);
  }
  return static_cast<int>(cudaGetLastError());
}
