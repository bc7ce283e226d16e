// K14 and K15: the float64 QPSK Costas loop with its branch IIRs (K14,
// the AGC fused or not) and the MPSK loop on the analytic signal (K15),
// over (chain x block) lanes.
//
// Replaces the lax.scans that the JAX package runs in its float64 parity
// mode (its Pallas kernel _iq_loop_kernel, which K5 and K6 replace, runs
// float32 only): pymodem_tpu/dsp/agc.py agc_apply then
// pymodem_tpu/dsp/loops.py qpsk_costas (reference psk.py:437-467), and
// pymodem_tpu/dsp/loops.py mpsk_loop with its f64 table detector
// _pd_lookup (reference psk.py:734-747, phase_detector.py:124-149).  The
// plain twins are dsp/loops.py qpsk_costas and mpsk_loop on float64
// tensors.
//
// Per sample, in the twins' order (dsp/loops.py module docstring):
//
//   K14: x = AGC(x) (17 rows only); NCO;
//        c = (bb0 * x cos[idx] + bb0 * c_in_prev) + ba1 * c_prev, and s
//        likewise on x sin[idx]; e = c * sgn(s) - s * sgn(c), sgn(v) =
//        v >= 0 ? 1 : -1 (NaN takes -1); loop IIR and PI; control =
//        prop + integral; outputs (s, c).
//   K15: NCO; re' = (re * cos) - (im * (-sin)), im' = (cos * im) +
//        (re * (-sin)); r = int(floor(re' * g/2)), i likewise, each
//        clamped to +-(g-1) in the twin's order and folded into the first
//        quadrant (a, b); e = table[a * g + b], the reference's int32
//        qpsk_error_table as a double; loop IIR and PI; control =
//        rint(prop + integral) (half to even, as torch.round and
//        jnp.round); outputs (re', im').
//
// What bounds it: each lane is one sequential recurrence of ~50 (K14)
// and ~45 (K15) dependent f64 operations a step, with two shared-memory
// gathers (K15 three), and the lanes (944 on the 8-chain PSK banks) are the
// parallelism; 16 (K14) or 32 (K15) bytes a sample move.
//
// Design (lanes_f64.cuh): one thread a lane, 32 lanes a block; lane l
// reads input row row_of_lane[l] (a pre-shared bank's B shared rows)
// straight from global memory in chunks; the NCO's wavetable and its
// quarter-turn shift (and for K15 the detector tables, (U, g*g) int32,
// when they fit) in shared memory; every carry in registers.

#include <cuda_runtime.h>

#include "lanes_f64.cuh"

namespace {

using namespace pymodem::f64;

// K15's detector tables staged in dynamic shared memory up to this many
// bytes (Hopper: 227 KB a block; the NCO tables take 4 KB static), else
// read from global memory through the read-only cache
constexpr int kPdSharedMax = 200 * 1024;

__device__ __forceinline__ double sgn(double v) {
  return v >= 0.0 ? 1.0 : -1.0;
}

template <bool kAgc>
__global__ void __launch_bounds__(kLanes)
    qpsk_costas_f64_kernel(const double* __restrict__ x, int in_stride,
                           const int* __restrict__ row_of_lane,
                           const double* __restrict__ params,
                           const double* __restrict__ sine,
                           const double* __restrict__ cosine,
                           double* __restrict__ out_i,
                           double* __restrict__ out_q, int out_stride, int L,
                           int T) {
  __shared__ double sin_s[kTableSize];
  __shared__ double cos_s[kTableSize];
  stage(sin_s, sine, kTableSize);
  stage(cos_s, cosine, kTableSize);
  __syncthreads();
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= L) return;
  const double* p = params + lane;
  Loop loop(p, L);
  const double bb0 = p[10 * L], ba1 = p[11 * L];
  // the AGC's rows follow the branch IIR's; unread without kAgc
  Agc agc(p + (kAgc ? 12 * L : 0), L);
  double cos_x = 0.0, cos_y = 0.0, sin_x = 0.0, sin_y = 0.0;
  double* irow = out_i + static_cast<size_t>(lane) * out_stride;
  double* qrow = out_q + static_cast<size_t>(lane) * out_stride;
  for_each_sample(
      x + static_cast<size_t>(row_of_lane[lane]) * in_stride, T,
      [&](int t, double v) {
        const double xs = kAgc ? agc.step(v) : v;
        const int idx = loop.nco();
        const double i_mixer = xs * cos_s[idx];
        const double cos_out = (bb0 * i_mixer + bb0 * cos_x) + ba1 * cos_y;
        const double q_mixer = xs * sin_s[idx];
        const double sin_out = (bb0 * q_mixer + bb0 * sin_x) + ba1 * sin_y;
        const double e = (cos_out * sgn(sin_out)) - (sin_out * sgn(cos_out));
        const double prop = loop.filter(e);
        loop.control = prop + loop.integral;
        cos_x = i_mixer;
        cos_y = cos_out;
        sin_x = q_mixer;
        sin_y = sin_out;
        irow[t] = sin_out;
        qrow[t] = cos_out;
      });
}

template <bool kPdShared>
__global__ void __launch_bounds__(kLanes)
    mpsk_loop_f64_kernel(const double* __restrict__ re,
                         const double* __restrict__ im, int in_stride,
                         const int* __restrict__ row_of_lane,
                         const double* __restrict__ params,
                         const double* __restrict__ sine,
                         const double* __restrict__ cosine,
                         const int* __restrict__ pd_tables,
                         const int* __restrict__ pd_index,
                         double* __restrict__ out_re,
                         double* __restrict__ out_im, int out_stride, int L,
                         int T, int g, int n_tables) {
  __shared__ double sin_s[kTableSize];
  __shared__ double cos_s[kTableSize];
  extern __shared__ int pd_s[];
  stage(sin_s, sine, kTableSize);
  stage(cos_s, cosine, kTableSize);
  const int gg = g * g;
  if (kPdShared) stage(pd_s, pd_tables, n_tables * gg);
  __syncthreads();
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= L) return;
  const double* p = params + lane;
  Loop loop(p, L);
  // row 11 is the lane's granularity (row 10, pd_gain, built its table);
  // int() of it as the twin's .to(int32), kept within the tables' g so a
  // mismatched call reads inside its table
  const double gf = p[11 * L];
  const int gi = min(max(static_cast<int>(gf), 0), g);
  const double half = gf * 0.5;
  const int* table = (kPdShared ? pd_s : pd_tables) +
                     static_cast<size_t>(pd_index[lane]) * gg;
  const size_t row = static_cast<size_t>(row_of_lane[lane]) * in_stride;
  double* rrow = out_re + static_cast<size_t>(lane) * out_stride;
  double* mrow = out_im + static_cast<size_t>(lane) * out_stride;
  for_each_pair(re + row, im + row, T, [&](int t, double a_re, double a_im) {
    const int idx = loop.nco();
    const double s = sin_s[idx], c = cos_s[idx];
    const double o_re = (a_re * c) - (a_im * -s);
    const double o_im = (c * a_im) + (a_re * -s);
    // quantise (floor, then int: exact for the in-range values), clamp
    // to +-(g-1) in the twin's order, fold into the first quadrant
    int r = static_cast<int>(floor(o_re * half));
    int i = static_cast<int>(floor(o_im * half));
    r = r >= gi ? gi - 1 : r;
    i = i >= gi ? gi - 1 : i;
    r = r <= -gi ? -(gi - 1) : r;
    i = i <= -gi ? -(gi - 1) : i;
    const bool rn = r >= 0, in = i >= 0;
    const int a = rn ? (in ? r : -i) : (in ? i : -r);
    const int b = rn ? (in ? i : r) : (in ? -r : -i);
    const double e =
        static_cast<double>(kPdShared ? table[a * gi + b]
                                      : __ldg(table + a * gi + b));
    const double prop = loop.filter(e);
    loop.control = rint(prop + loop.integral);
    rrow[t] = o_re;
    mrow[t] = o_im;
  });
}

}  // namespace

// K14.  Input rows ``in_stride`` doubles apart (any stride >= T), lane l
// on row row_of_lane[l] < R; params (17, L) with the AGC fused (agc = 1)
// or (12, L) without (PLL_PARAMS, BRANCH_PARAMS, AGC_PARAMS); the two
// (256,) tables; out_i, out_q (L, T) rows ``out_stride`` apart.
extern "C" int qpsk_costas_f64_lanes(const double* x, int in_stride,
                                     const int* row_of_lane, int R,
                                     const double* params, const double* sine,
                                     const double* cosine, double* out_i,
                                     double* out_q, int out_stride, int L,
                                     int T, int agc, void* stream) {
  if (in_stride < T || out_stride < T || R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0 && T > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (agc) {
      qpsk_costas_f64_kernel<true><<<blocks, kLanes, 0, s>>>(
          x, in_stride, row_of_lane, params, sine, cosine, out_i, out_q,
          out_stride, L, T);
    } else {
      qpsk_costas_f64_kernel<false><<<blocks, kLanes, 0, s>>>(
          x, in_stride, row_of_lane, params, sine, cosine, out_i, out_q,
          out_stride, L, T);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K15.  re, im rows ``in_stride`` doubles apart (any stride >= T), lane l
// on row row_of_lane[l] < R; params (12, L), PLL_PARAMS then pd_gain,
// pd_granularity; the two (256,) tables; pd_tables (n_tables, g*g) int32,
// lane l's table pd_index[l] < n_tables; out_re, out_im (L, T) rows
// ``out_stride`` apart.
extern "C" int mpsk_loop_f64_lanes(const double* re, const double* im,
                                   int in_stride, const int* row_of_lane,
                                   int R, const double* params,
                                   const double* sine, const double* cosine,
                                   const int* pd_tables, const int* pd_index,
                                   double* out_re, double* out_im,
                                   int out_stride, int L, int T, int g,
                                   int n_tables, void* stream) {
  if (in_stride < T || out_stride < T || R < 1 || g < 1 || n_tables < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0 && T > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t pd_bytes =
        sizeof(int) * static_cast<size_t>(n_tables) * g * g;
    if (pd_bytes <= static_cast<size_t>(kPdSharedMax)) {
      cudaError_t err = cudaFuncSetAttribute(
          mpsk_loop_f64_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(pd_bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      mpsk_loop_f64_kernel<true><<<blocks, kLanes, pd_bytes, s>>>(
          re, im, in_stride, row_of_lane, params, sine, cosine, pd_tables,
          pd_index, out_re, out_im, out_stride, L, T, g, n_tables);
    } else {
      mpsk_loop_f64_kernel<false><<<blocks, kLanes, 0, s>>>(
          re, im, in_stride, row_of_lane, params, sine, cosine, pd_tables,
          pd_index, out_re, out_im, out_stride, L, T, g, n_tables);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
