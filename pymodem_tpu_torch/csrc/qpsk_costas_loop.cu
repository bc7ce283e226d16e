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
// What bounds it on an H100: each lane is a strictly sequential recurrence
// with 9 carries and one dependent chain of ~30 operations and one
// shared-memory read per sample (NCO, table, mixers, branch IIRs, sign
// detector, loop IIR, PI), and the lane count sets the parallelism: the
// 8-chain Costas-QPSK bank over 600 s at 44.1 kHz is ~950 lanes.  The run
// time is T times the chain's latency; the 12 bytes a sample moves are far
// below what the card streams.
//
// Design (lane_tiles.cuh): a block serves 32 lanes with one lane thread
// and one copy thread each, and walks time in tiles of 128 samples over
// three stages of two rails.  Lane l reads input row row_of_lane[l] of
// (R, T) rows, so the C chains of a pre-shared bank read its B shared
// band-passed rows.  The copy warp loads each lane's tiles two ahead of
// the lanes (one bulk copy a lane), and in the fused form copy thread l
// runs lane l's AGC follower over each tile one ahead, writing the gained
// samples in place and keeping the envelope and sustain in its registers
// from tile to tile: the AGC and its IEEE divide leave the lane's chain.
// A lane thread reads its row as float4s, four steps at a time, writes I
// in place over its input and Q into the stage's second rail, and the
// copy warp stores both by bulk copies one tile behind.  Cosine and sine
// of the 256 NCO angles sit in one shared float2 table, one 8-byte read a
// step, from the tables handed in by the caller, so kernel and twin read
// the same numbers; the NCO's four conditional wraps become selects
// (Loop::nco_select).  Built with -fmad=false and without fast math, in
// the JAX op order, so the outputs equal the plain twin (dsp/loops.py
// qpsk_costas) bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lane_tiles.cuh"
#include "loop_common.cuh"

namespace {

using pymodem::Agc;
using pymodem::kLanes;
using pymodem::kStride;
using pymodem::kTableSize;
using pymodem::kTile;
using pymodem::Loop;

constexpr int kLoopRows = 10;    // PLL_PARAMS
constexpr int kBranchRows = 12;  // then branch_b0, branch_a1; then the AGC
constexpr int kStages = 3;
constexpr int kTileFloats = kLanes * kStride;  // one rail of a stage

// The 12-row form's AGC: none, and no rows read.
struct NoAgc {
  __device__ NoAgc(const float*, int) {}
};

// The loop of one lane: the NCO, the branch IIRs and the detector.
struct Lane {
  Loop loop;
  float b0, a1;
  float cos_x = 0.0f, cos_y = 0.0f, sin_x = 0.0f, sin_y = 0.0f;

  // one sample xv: the outputs o_i (sine branch) and o_q (cosine branch)
  __device__ __forceinline__ void step(const float2* sc, float xv,
                                       float& o_i, float& o_q) {
    const float2 cs = sc[loop.nco_select()];  // (cos, sin)
    const float i_mixer = xv * cs.x;
    const float cos_out = (b0 * i_mixer + b0 * cos_x) + a1 * cos_y;
    const float q_mixer = xv * cs.y;
    const float sin_out = (b0 * q_mixer + b0 * sin_x) + a1 * sin_y;
    const float cos_sgn = cos_out >= 0.0f ? 1.0f : -1.0f;
    const float sin_sgn = sin_out >= 0.0f ? 1.0f : -1.0f;
    const float e = (cos_out * sin_sgn) - (sin_out * cos_sgn);
    const float prop = loop.filter(e);
    loop.control = prop + loop.integral;
    cos_x = i_mixer;
    cos_y = cos_out;
    sin_x = q_mixer;
    sin_y = sin_out;
    o_i = sin_out;
    o_q = cos_out;
  }
};

// Threads [0, kLanes) are the lanes; threads [kLanes, 2 kLanes) the copy
// warp: copy thread r starts lane r's bulk copies and, with kFuseAgc, runs
// lane r's AGC one tile ahead of it.
template <bool kFuseAgc>
__global__ void __launch_bounds__(2 * kLanes, 1)
    qpsk_costas_kernel(const float* __restrict__ x, int in_stride,
                       const int* __restrict__ row_of_lane, int n_rows,
                       const float* __restrict__ params,
                       const float* __restrict__ sine_table,
                       const float* __restrict__ cos_table,
                       float* __restrict__ out_i, float* __restrict__ out_q,
                       int out_stride, int L, int T) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bars[kStages];
  // [stage][rail][lane][kStride] tiles (rail 0: the input, then I in
  // place; rail 1: Q), then the (cos, sin) table
  float2* sc = reinterpret_cast<float2*>(smem + 2 * kStages * kTileFloats);
  const int tid = threadIdx.x;
  const bool copier = tid >= kLanes;
  const int r = copier ? tid - kLanes : tid;  // the lane row this thread serves
  const int lane0 = blockIdx.x * kLanes;
  const int lane = lane0 + r;
  const bool active = lane < L;
  const int n_active = min(kLanes, L - lane0);
  for (int k = tid; k < kTableSize; k += blockDim.x) {
    sc[k] = make_float2(cos_table[k], sine_table[k]);
  }
  if (tid < kStages) pymodem::mbar_init(&bars[tid]);
  __syncthreads();

  const int pl = active ? lane : 0;
  // the clamp only keeps a mismatched call inside the rows
  const float* row =
      x + static_cast<size_t>(min(max(row_of_lane[pl], 0), n_rows - 1)) *
              in_stride;
  Lane s{Loop(params + pl, L), params[kLoopRows * L + pl],
         params[(kLoopRows + 1) * L + pl]};
  std::conditional_t<kFuseAgc, Agc, NoAgc> agc(
      params + kBranchRows * L + pl, L);

  // tile k goes to rail 0 of stage k % kStages by one bulk copy a lane
  // from the copy warp, completing on the stage's barrier
  auto fetch = [&](int k) {
    const int t0 = k * kTile;
    const unsigned bytes = 4u * pymodem::padded4(min(kTile, T - t0));
    const int st = k % kStages;
    if (tid == kLanes) pymodem::mbar_expect(&bars[st], bytes * n_active);
    if (copier && active) {
      pymodem::bulk_load(smem + 2 * st * kTileFloats + r * kStride, row + t0,
                         bytes, &bars[st]);
    }
  };
  // copy thread r, once tile k has landed: lane r's AGC over it, in place
  auto gain = [&](int k) {
    const int st = k % kStages;
    pymodem::mbar_wait(&bars[st], (k / kStages) & 1);
    if constexpr (kFuseAgc) {  // (the 12-row form keeps the input)
      float* xr = smem + 2 * st * kTileFloats + r * kStride;
      const int n = min(kTile, T - k * kTile);
      for (int c = 0; c < n; c += 4) {
        float4 a = *reinterpret_cast<const float4*>(xr + c);
        a.x = agc.step(a.x);
        a.y = agc.step(a.y);
        a.z = agc.step(a.z);
        a.w = agc.step(a.w);
        *reinterpret_cast<float4*>(xr + c) = a;
      }
      // ordered before the bulk copies that later read or refill the stage
      pymodem::fence_proxy_async();
    }
  };
  // tile k (I in place, Q in rail 1) to the (L, T) outputs
  auto store = [&](int k) {
    const int t0 = k * kTile;
    const unsigned bytes = 4u * pymodem::padded4(min(kTile, T - t0));
    const float* src = smem + 2 * (k % kStages) * kTileFloats + r * kStride;
    if (active) {
      const size_t o = static_cast<size_t>(lane) * out_stride + t0;
      pymodem::bulk_store(out_i + o, src, bytes);
      pymodem::bulk_store(out_q + o, src + kTileFloats, bytes);
    }
    pymodem::bulk_commit();
  };

  // raw tiles run two ahead of the lanes, gained ones one ahead
  const int n_tiles = (T + kTile - 1) / kTile;
  for (int k = 0; k < min(2, n_tiles); ++k) fetch(k);
  if (copier && active && n_tiles > 0) gain(0);
  for (int k = 0; k < n_tiles; ++k) {
    __syncthreads();  // tile k is gained; the lanes are done with k - 1
    if (copier) {
      // while the lanes run tile k: store tile k - 1, gain tile k + 1,
      // then load tile k + 2 into the stage of tile k - 1 once its store
      // has read it
      if (k > 0) store(k - 1);
      if (active && k + 1 < n_tiles) gain(k + 1);
      pymodem::bulk_wait_read<0>();
    }
    if (k + 2 < n_tiles) fetch(k + 2);
    if (!copier && active) {
      const int st = k % kStages;
      pymodem::mbar_wait(&bars[st], (k / kStages) & 1);
      const int n = min(kTile, T - k * kTile);
      float* xr = smem + 2 * st * kTileFloats + r * kStride;
      float* qr = xr + kTileFloats;
      // four samples at column c: I in place, Q beside it; past T (the
      // last tile of a row whose T is not a multiple of 4) the steps make
      // only outputs in the rows' padding.  Two columns a pass ran faster
      // on an H100 than one or four.
#pragma unroll 2
      for (int c = 0; c < n; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(xr + c);
        float4 o_i, o_q;
        s.step(sc, a.x, o_i.x, o_q.x);
        s.step(sc, a.y, o_i.y, o_q.y);
        s.step(sc, a.z, o_i.z, o_q.z);
        s.step(sc, a.w, o_i.w, o_q.w);
        *reinterpret_cast<float4*>(xr + c) = o_i;
        *reinterpret_cast<float4*>(qr + c) = o_q;
      }
      // the bulk store reads what these generic stores wrote
      pymodem::fence_proxy_async();
    }
  }
  __syncthreads();
  if (copier && n_tiles > 0) store(n_tiles - 1);
  if (copier) pymodem::bulk_wait_all();
}

template <bool kFuseAgc>
int launch(const float* x, int in_stride, const int* row_of_lane,
           int n_rows, const float* params, const float* sine_table,
           const float* cos_table, float* out_i, float* out_q,
           int out_stride, int L, int T, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * kStages * kTileFloats +
                      sizeof(float2) * kTableSize;
  cudaError_t err = cudaFuncSetAttribute(
      qpsk_costas_kernel<kFuseAgc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0) {
    qpsk_costas_kernel<kFuseAgc><<<blocks, 2 * kLanes, smem, stream>>>(
        x, in_stride, row_of_lane, n_rows, params, sine_table, cos_table,
        out_i, out_q, out_stride, L, T);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Input rows ``in_stride`` floats apart, outputs ``out_stride`` apart,
// both 16-byte aligned with strides that are multiples of 4 and >= T
// (lane_tiles.cuh; dsp/loops.py qpsk_costas_lanes pads other rows).
extern "C" int qpsk_costas_lanes(const float* x, int in_stride,
                                 const int* row_of_lane, int n_rows,
                                 const float* params,
                                 const float* sine_table,
                                 const float* cos_table, float* out_i,
                                 float* out_q, int out_stride, int L, int T,
                                 int fuse_agc, void* stream) {
  if ((n_rows <= 0 && L > 0) || !pymodem::rows_ok(x, in_stride, T) ||
      !pymodem::rows_ok(out_i, out_stride, T) ||
      !pymodem::rows_ok(out_q, out_stride, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fuse_agc ? launch<true>(x, in_stride, row_of_lane, n_rows, params,
                                 sine_table, cos_table, out_i, out_q,
                                 out_stride, L, T, s)
                  : launch<false>(x, in_stride, row_of_lane, n_rows, params,
                                  sine_table, cos_table, out_i, out_q,
                                  out_stride, L, T, s);
}
