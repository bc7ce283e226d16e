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
// with 5 carries, one dependent chain of ~40 operations and two
// shared-memory reads per sample, and the lane count sets the parallelism
// (~950 lanes on the 8-chain QPSK bank), so the run time is T times the
// chain's latency; the 16 bytes a sample moves are far below what the
// card streams.
//
// Design (lane_tiles.cuh): a block serves 32 lanes with one lane thread
// and one copy thread each, and walks time in tiles of 128 samples over
// three stages.  Lane l reads input row row_of_lane[l] of (R, T) rows, so
// the C chains of a pre-shared bank read its B shared analytic rows.
// While the lanes run tile k, the copy warp stores tile k - 1 and loads
// tile k + 1, one bulk copy a lane and rail.  A lane thread reads its row
// as float4s, four steps at a time, and writes re' and im' back in place.
// Sine and cosine of the 256 NCO angles sit in one shared float2 table
// (cos, -sin), one 8-byte read a step; the NCO's four conditional wraps
// become selects (Loop::nco_select).  The phase detector is a pure
// function of the folded pair (a, b) in [0, g)^2 and the chain's gain, so
// the caller hands in int32 error tables (U, g*g), built on the host from
// the JAX package's f32 formula (dsp/loops.py pd_error_table), with each
// lane's table; a launch stages them in shared memory as floats when the
// U tables fit beside the tiles (faster on the QPSK bank, PERF.md) and
// reads them through the read-only data cache otherwise, so a bank may
// carry any number of distinct gains.  This replaces the Pallas kernel's
// minimax atan (which Mosaic needed) and CUDA's atan2f, whose rounding is
// not XLA's.  Built with -fmad=false and without fast math, in the JAX op
// order; rintf rounds half to even like jnp.round and torch.round.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tiles.cuh"
#include "loop_common.cuh"

namespace {

using pymodem::kLanes;
using pymodem::kStride;
using pymodem::kTableSize;
using pymodem::kTile;
using pymodem::Loop;

constexpr int kLoopRows = 10;  // PLL_PARAMS, then pd_gain, pd_granularity
// tile stages: tile k + 2 loads while tile k runs and tile k - 1 stores
constexpr int kStages = 3;
constexpr int kTileFloats = kLanes * kStride;  // one rail of a stage

struct Lane {
  Loop loop;
  int gi;
  float half;
  const float* table_f;  // the lane's detector table, staged as floats
  const int* table_i;    // or in device memory

  // one sample: rotate (re, im) by the NCO into (o_re, o_im), then the
  // detector and the loop update
  template <bool kPdShared>
  __device__ __forceinline__ void step(const float2* sc, float re_t,
                                       float im_t, float& o_re, float& o_im) {
    const float2 cs = sc[loop.nco_select()];
    const float c = cs.x;
    const float ns = cs.y;
    o_re = (re_t * c) - (im_t * ns);
    o_im = (c * im_t) + (re_t * ns);
    // quantise (floor, then to int: one rounding-down conversion), clamp
    // to +-(g-1) (r >= g and r <= -g are r > g-1 and r < -(g-1)), fold into
    // the first quadrant
    int r = __float2int_rd(o_re * half);
    int i = __float2int_rd(o_im * half);
    r = max(min(r, gi - 1), -(gi - 1));
    i = max(min(i, gi - 1), -(gi - 1));
    const bool rn = r >= 0;
    const bool inn = i >= 0;
    const int a = rn ? (inn ? r : -i) : (inn ? i : -r);
    const int b = rn ? (inn ? i : r) : (inn ? -r : -i);
    // (a, b) lies in [0, gi)^2 with gi <= g (the setup clamps it), so the
    // entry lies in the table
    const int flat = a * gi + b;
    const float e = kPdShared ? table_f[flat]
                              : static_cast<float>(__ldg(table_i + flat));
    const float prop = loop.filter(e);
    loop.control = rintf(prop + loop.integral);
  }
};

// Threads [0, kLanes) are the lanes; threads [kLanes, 2 kLanes) the copy
// warp: each starts its lane's bulk loads and stores, so the lanes never
// wait on a copy's start.
template <bool kPdShared>
__global__ void __launch_bounds__(2 * kLanes, 1)
    mpsk_loop_kernel(const float* __restrict__ re,
                     const float* __restrict__ im, int in_stride,
                     const int* __restrict__ row_of_lane, int n_rows,
                     const float* __restrict__ params,
                     const float* __restrict__ sine_table,
                     const float* __restrict__ cos_table,
                     const int* __restrict__ pd_tables,
                     const int* __restrict__ pd_index,
                     float* __restrict__ out_re, float* __restrict__ out_im,
                     int out_stride, int L, int T, int g, int n_tables) {
  extern __shared__ __align__(16) float smem[];
  __shared__ const float* re_rows[kLanes];
  __shared__ const float* im_rows[kLanes];
  __shared__ uint64_t bars[kStages];
  const int gg = g * g;
  // [stage][rail][lane][kStride] tiles, the (cos, -sin) table, then the
  // detector tables when they are staged (as floats: the entries are
  // small integers, exact in float32)
  float2* sc = reinterpret_cast<float2*>(smem + 2 * kStages * kTileFloats);
  float* pd_shared = reinterpret_cast<float*>(sc + kTableSize);
  const int tid = threadIdx.x;
  const bool copier = tid >= kLanes;
  const int r = copier ? tid - kLanes : tid;  // the lane row this thread serves
  const int lane0 = blockIdx.x * kLanes;
  const int lane = lane0 + r;
  const bool active = lane < L;
  const int n_active = min(kLanes, L - lane0);
  for (int k = tid; k < kTableSize; k += blockDim.x) {
    sc[k] = make_float2(cos_table[k], -sine_table[k]);
  }
  if (kPdShared) {
    for (int k = tid; k < n_tables * gg; k += blockDim.x) {
      pd_shared[k] = static_cast<float>(pd_tables[k]);
    }
  }
  if (!copier) {
    // the clamps only keep a mismatched call inside the rows and tables
    const int row = active ? min(max(row_of_lane[lane], 0), n_rows - 1) : 0;
    re_rows[r] = re + static_cast<size_t>(row) * in_stride;
    im_rows[r] = im + static_cast<size_t>(row) * in_stride;
  }
  if (tid < kStages) pymodem::mbar_init(&bars[tid]);
  __syncthreads();

  const int pl = active ? lane : 0;
  Lane s{Loop(params + pl, L)};
  const float gf = params[(kLoopRows + 1) * L + pl];
  // a granularity above the tables' g (a mismatched call, which the twin
  // refuses) is clamped so the lookups stay inside the tables
  s.gi = min(max(__float2int_rz(gf), 0), g);
  s.half = gf * 0.5f;
  const int which = min(max(pd_index[pl], 0), n_tables - 1);
  s.table_f = pd_shared + static_cast<size_t>(which) * gg;
  s.table_i = pd_tables + static_cast<size_t>(which) * gg;

  // tile k goes to stage k % kStages by one bulk copy a lane and rail from
  // the copy warp, completing on the stage's barrier
  auto fetch = [&](int k) {
    const int t0 = k * kTile;
    const unsigned bytes = 4u * pymodem::padded4(min(kTile, T - t0));
    const int st = k % kStages;
    float* dst = smem + 2 * st * kTileFloats;
    if (tid == kLanes) pymodem::mbar_expect(&bars[st], 2u * bytes * n_active);
    if (copier && active) {
      pymodem::bulk_load(dst + r * kStride, re_rows[r] + t0, bytes,
                         &bars[st]);
      pymodem::bulk_load(dst + kTileFloats + r * kStride, im_rows[r] + t0,
                         bytes, &bars[st]);
    }
  };
  // tile k (re', im' in place in its stage) to the (L, T) outputs
  auto store = [&](int k) {
    if (!copier) return;
    const int t0 = k * kTile;
    const unsigned bytes = 4u * pymodem::padded4(min(kTile, T - t0));
    const float* src = smem + 2 * (k % kStages) * kTileFloats;
    if (active) {
      const size_t o = static_cast<size_t>(lane) * out_stride + t0;
      pymodem::bulk_store(out_re + o, src + r * kStride, bytes);
      pymodem::bulk_store(out_im + o, src + kTileFloats + r * kStride, bytes);
    }
    pymodem::bulk_commit();
  };

  const int n_tiles = (T + kTile - 1) / kTile;
  if (n_tiles > 0) fetch(0);
  for (int k = 0; k < n_tiles; ++k) {
    __syncthreads();  // the lanes are done with tile k - 1
    // while the lanes run tile k: store tile k - 1, load tile k + 1 into
    // the stage of tile k - 2 once its store has read it
    if (k > 0) store(k - 1);
    if (copier) pymodem::bulk_wait_read<1>();
    if (k + 1 < n_tiles) fetch(k + 1);
    if (!copier && active) {
      const int st = k % kStages;
      pymodem::mbar_wait(&bars[st], (k / kStages) & 1);
      const int n = min(kTile, T - k * kTile);
      float* cur = smem + 2 * st * kTileFloats;
      float* xr = cur + r * kStride;
      float* xi = cur + kTileFloats + r * kStride;
      // m of the four samples at column c, replaced by (re', im') in place
      auto quad = [&](int c, int m) {
        const float4 a = *reinterpret_cast<const float4*>(xr + c);
        const float4 b = *reinterpret_cast<const float4*>(xi + c);
        float4 o_re = a;
        float4 o_im = b;
        s.step<kPdShared>(sc, a.x, b.x, o_re.x, o_im.x);
        if (m > 1) s.step<kPdShared>(sc, a.y, b.y, o_re.y, o_im.y);
        if (m > 2) s.step<kPdShared>(sc, a.z, b.z, o_re.z, o_im.z);
        if (m > 3) s.step<kPdShared>(sc, a.w, b.w, o_re.w, o_im.w);
        *reinterpret_cast<float4*>(xr + c) = o_re;
        *reinterpret_cast<float4*>(xi + c) = o_im;
      };
      if (n == kTile) {
        for (int c = 0; c < kTile; c += 4) quad(c, 4);
      } else {
        for (int c = 0; c < n; c += 4) quad(c, min(4, n - c));
      }
      // the bulk store reads what these generic stores wrote
      pymodem::fence_proxy_async();
    }
  }
  __syncthreads();
  if (n_tiles > 0) store(n_tiles - 1);
  if (copier) pymodem::bulk_wait_all();
}

size_t smem_bytes(int pd_ints) {
  return sizeof(float) * 2 * kStages * static_cast<size_t>(kTileFloats) +
         sizeof(float2) * kTableSize + sizeof(int) * static_cast<size_t>(pd_ints);
}

template <bool kPdShared>
int launch(const float* re, const float* im, int in_stride,
           const int* row_of_lane, int n_rows, const float* params,
           const float* sine_table, const float* cos_table,
           const int* pd_tables, const int* pd_index, float* out_re,
           float* out_im, int out_stride, int L, int T, int g, int n_tables,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(kPdShared ? n_tables * g * g : 0);
  cudaError_t err = cudaFuncSetAttribute(
      mpsk_loop_kernel<kPdShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0) {
    mpsk_loop_kernel<kPdShared><<<blocks, 2 * kLanes, smem, stream>>>(
        re, im, in_stride, row_of_lane, n_rows, params, sine_table,
        cos_table, pd_tables, pd_index, out_re, out_im, out_stride, L, T, g,
        n_tables);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// re and im rows ``in_stride`` floats apart, outputs ``out_stride`` apart,
// all 16-byte aligned with strides that are multiples of 4 and >= T
// (lane_tiles.cuh; dsp/loops.py mpsk_loop_lanes copies other rails into
// rows of one such stride).
// ``pd_shared``: stage the detector tables in shared memory (1) or read
// them through the read-only cache (0); dsp/loops.py
// mpsk_tables_staged picks it with the same shared-memory count
// (smem_bytes).
extern "C" int mpsk_loop_lanes(const float* re, const float* im,
                               int in_stride, const int* row_of_lane,
                               int n_rows, const float* params,
                               const float* sine_table,
                               const float* cos_table, const int* pd_tables,
                               const int* pd_index, float* out_re,
                               float* out_im, int out_stride, int L, int T,
                               int g, int n_tables, int pd_shared,
                               void* stream) {
  if ((n_rows <= 0 && L > 0) || !pymodem::rows_ok(re, in_stride, T) ||
      !pymodem::rows_ok(im, in_stride, T) ||
      !pymodem::rows_ok(out_re, out_stride, T) ||
      !pymodem::rows_ok(out_im, out_stride, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pd_shared
             ? launch<true>(re, im, in_stride, row_of_lane, n_rows, params,
                            sine_table, cos_table, pd_tables, pd_index,
                            out_re, out_im, out_stride, L, T, g, n_tables, s)
             : launch<false>(re, im, in_stride, row_of_lane, n_rows, params,
                             sine_table, cos_table, pd_tables, pd_index,
                             out_re, out_im, out_stride, L, T, g, n_tables,
                             s);
}
