// K11: the AGC fused with the AFSK PLL (kind afsk_pll) or the BPSK Costas
// loop (kind bpsk) at float64 over (chain x block) lanes.
//
// Replaces the lax.scans that the JAX package runs in its float64 parity
// mode (its Pallas loop kernel, which K2 and K3 replace, runs float32
// only): pymodem_tpu/dsp/agc.py agc_apply followed by
// pymodem_tpu/dsp/loops.py afsk_pll or bpsk_costas (reference
// afsk_pll.py:152-165, psk.py:173-189, agc.py:26-80, nco.py:34-53,
// iir.py:38-54, pi_control.py:25-33).  The plain twins are dsp/loops.py
// afsk_pll and bpsk_costas on float64 tensors.
//
// Per sample, in the twins' order (dsp/loops.py module docstring):
//
//     x     = AGC(x)                      (dsp/agc.py agc_step)
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
// Design (lanes_f64.cuh): one thread a lane, 32 lanes a block; lane l
// reads input row row_of_lane[l] (a pre-shared bank's B shared rows)
// straight from global memory in chunks; the tables in shared memory; the
// AGC, NCO, IIR and PI state in registers.

#include <cuda_runtime.h>

#include "lanes_f64.cuh"

namespace {

using namespace pymodem::f64;

constexpr int kTableSize = 256;

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
  for (int i = threadIdx.x; i < kTableSize; i += kLanes) {
    sin_s[i] = sine[i];
    if (kBpsk) cos_s[i] = cosine[i];
  }
  __syncthreads();
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= L) return;
  const double* p = params + lane;
  const double phase_scale = p[0], set_freq = p[L], index_scale = p[2 * L];
  const double b0 = p[3 * L], a1 = p[4 * L], gp = p[5 * L];
  const double gain = p[6 * L], pi_i = p[7 * L], limit = p[8 * L];
  double integral = p[9 * L];
  const double attack = p[10 * L], decay = p[11 * L];
  const double sustain_time = p[12 * L], sustain_inc = p[13 * L];
  const double target = p[14 * L];
  const double two_pi = 6.283185307179586476925286766559;
  double env = 0.0, sustain = 0.0;
  double phase = 0.0, control = 0.0, iir_x = 0.0, iir_y = 0.0;
  double* orow = out + static_cast<size_t>(lane) * out_stride;
  for_each_sample(
      x + static_cast<size_t>(row_of_lane[lane]) * in_stride, T,
      [&](int t, double v) {
        // the AGC follower (dsp/agc.py agc_step)
        const double cv = fabs(v);
        const bool rising = cv > env;
        env = rising ? min_nan(env + attack, cv) : env;
        sustain = rising ? 0.0 : sustain;
        env = sustain >= sustain_time ? max_nan(env - decay, 0.0) : env;
        sustain = sustain + sustain_inc;
        const double xs = env != 0.0 ? target * v / env : v;
        // the NCO (dsp/loops.py _nco, _wrap_phase)
        double ph = phase + phase_scale * (set_freq + control);
        ph = ph >= two_pi ? ph - two_pi : ph;
        ph = ph >= two_pi ? ph - two_pi : ph;
        ph = ph < 0.0 ? ph + two_pi : ph;
        ph = ph < 0.0 ? ph + two_pi : ph;
        phase = ph;
        const int idx =
            static_cast<int>(__double2ll_rz(ph * index_scale)) &
            (kTableSize - 1);
        double mixer, emitted = 0.0;
        if (kBpsk) {
          const double i_mixer = xs * cos_s[idx];
          const double q_mixer = xs * -sin_s[idx];
          mixer = i_mixer * q_mixer;
          emitted = i_mixer;
        } else {
          mixer = xs * sin_s[idx];
        }
        // loop IIR, then PI with a saturated integral (dsp/loops.py _pi)
        const double y = (b0 * mixer + b0 * iir_x) + a1 * iir_y;
        const double prop = gp * y;
        integral = min_nan(max_nan(integral + gain * (pi_i * y), -limit),
                           limit);
        control = prop + integral;
        iir_x = mixer;
        iir_y = y;
        orow[t] = kBpsk ? emitted : prop;
      });
}

}  // namespace

// Input rows ``in_stride`` doubles apart (any stride >= T), lane l on row
// row_of_lane[l] < R; params (15, L), PLL_PARAMS then AGC_PARAMS
// (dsp/loops.py); the two (256,) tables (cosine unused,
// and may be null, for kind 0); out (L, T) rows ``out_stride`` apart.
// kind 0 is afsk_pll, 1 bpsk.
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
