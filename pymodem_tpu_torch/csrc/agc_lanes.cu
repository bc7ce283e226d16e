// K4: the standalone AGC envelope follower over (chain x block) lanes.
//
// Replaces the Pallas TPU kernel pymodem_tpu/dsp/pallas_loops.py
// _loop_kernel, kind "agc" (loop_lanes_pallas with the five AGC rows),
// itself the lane form of agc_apply in pymodem_tpu/dsp/agc.py (reference
// agc.py:26-80).  The MPSK path runs it between the band-pass and the
// Hilbert FIR, over the B shared lanes of a carrier sweep or over all C*B
// lanes (runtime/bank.py mpsk_analytic).
//
// What bounds it on an H100: each lane is a sequential recurrence with 2
// carries (envelope, sustain), ~10 dependent operations a step (compare,
// add, NaN-aware min, select; compare, subtract, NaN-aware max, select),
// and the lane count (~120 to ~190 on the main path's MPSK banks) sets
// the parallelism, so the run time is T times that chain's latency.  The
// outputs target * x / env are off the chain, but each IEEE divide is a
// chain of its own behind a branch to its slow path, ~70 ns a sample on
// one warp.  The 8 bytes a sample moves are far below what the card
// streams.
//
// Design (lane_tiles.cuh): a block serves 32 lanes with a lane warp, a
// copy warp and four gain warps, and walks time in tiles of 128 samples
// over four stages.  While the lanes run tile k and write each step's
// envelope into the stage's second rail, the gain warps form the outputs
// of tile k - 1 in place over its input (gain thread (g, l) the columns
// [32 g, 32 g + 32) of lane l), and the copy warp stores tile k - 2 and
// loads tile k + 1, one bulk copy a lane.  So the lane thread runs the
// envelope recurrence and nothing else.  Built with -fmad=false and
// without fast math: target * x / env rounds the product and the IEEE
// quotient on their own, as the twin (dsp/agc.py agc_follower) and the
// JAX package do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tiles.cuh"
#include "loop_common.cuh"

namespace {

using pymodem::Agc;
using pymodem::kLanes;
using pymodem::kStride;
using pymodem::kTile;

// tile k + 1 loads while tile k runs, tile k - 1 gains and tile k - 2
// stores
constexpr int kStages = 4;
constexpr int kGainWarps = 4;
constexpr int kThreads = (2 + kGainWarps) * kLanes;
constexpr int kTileFloats = kLanes * kStride;  // one rail of a stage

// Warp 0 is the lanes, warp 1 the copy warp (it starts its lane's bulk
// loads and stores), warps 2.. the gain warps.
__global__ void __launch_bounds__(kThreads, 1)
    agc_kernel(const float* __restrict__ x, int in_stride,
               const float* __restrict__ params, float* __restrict__ out,
               int out_stride, int L, int T) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bars[kStages];
  // [stage][rail][lane][kStride]: rail 0 the input, then the outputs in
  // place; rail 1 the envelopes
  const int tid = threadIdx.x;
  const int warp = tid / kLanes;
  const int r = tid % kLanes;  // the lane row this thread serves
  const int lane0 = blockIdx.x * kLanes;
  const int lane = lane0 + r;
  const bool active = lane < L;
  const int n_active = min(kLanes, L - lane0);
  if (tid < kStages) pymodem::mbar_init(&bars[tid]);
  __syncthreads();

  const int pl = active ? lane : 0;
  Agc agc(params + pl, L);
  auto tile_n = [&](int k) { return min(kTile, T - k * kTile); };
  auto row_of = [&](int k) {
    return smem + 2 * (k % kStages) * kTileFloats + r * kStride;
  };

  // copy warp: tile k to its stage by one bulk copy a lane, completing on
  // the stage's barrier
  auto fetch = [&](int k) {
    const unsigned bytes = 4u * pymodem::padded4(tile_n(k));
    uint64_t* bar = &bars[k % kStages];
    if (r == 0) pymodem::mbar_expect(bar, bytes * n_active);
    if (active) {
      pymodem::bulk_load(row_of(k),
                         x + static_cast<size_t>(lane) * in_stride +
                             k * kTile,
                         bytes, bar);
    }
  };
  // copy warp: the outputs of tile k to the (L, T) output
  auto store = [&](int k) {
    if (active) {
      pymodem::bulk_store(
          out + static_cast<size_t>(lane) * out_stride + k * kTile,
          row_of(k), 4u * pymodem::padded4(tile_n(k)));
    }
    pymodem::bulk_commit();
  };
  // gain warp g: target * x / env over its 32 columns of tile k, in place
  auto gain = [&](int k, int g) {
    // long passed: orders the bulk load before these reads
    pymodem::mbar_wait(&bars[k % kStages], (k / kStages) & 1);
    float* xr = row_of(k);
    const float* er = xr + kTileFloats;
    const int end = min(32 * (g + 1), tile_n(k));
    for (int c = 32 * g; c < end; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(xr + c);
      const float4 e = *reinterpret_cast<const float4*>(er + c);
      *reinterpret_cast<float4*>(xr + c) =
          make_float4(agc.gain(a.x, e.x), agc.gain(a.y, e.y),
                      agc.gain(a.z, e.z), agc.gain(a.w, e.w));
    }
    // the bulk store reads what these generic stores wrote
    pymodem::fence_proxy_async();
  };
  // lane warp: the envelopes of tile k into rail 1, four steps at a time;
  // past T (the last tile of a row whose T is not a multiple of 4) the
  // steps make only outputs in the rows' padding
  auto run = [&](int k) {
    pymodem::mbar_wait(&bars[k % kStages], (k / kStages) & 1);
    float* xr = row_of(k);
    for (int c = 0; c < tile_n(k); c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(xr + c);
      float4 e;
      e.x = agc.follow(a.x);
      e.y = agc.follow(a.y);
      e.z = agc.follow(a.z);
      e.w = agc.follow(a.w);
      *reinterpret_cast<float4*>(xr + kTileFloats + c) = e;
    }
  };

  const int n_tiles = (T + kTile - 1) / kTile;
  if (warp == 1 && n_tiles > 0) fetch(0);
  for (int k = 0; k < n_tiles + 2; ++k) {
    __syncthreads();  // the lanes are done with k - 1, the gains with k - 2
    if (warp == 1) {
      // store tile k - 2, then load tile k + 1 into the stage of tile
      // k - 3 once its store has read it
      if (k >= 2) store(k - 2);
      pymodem::bulk_wait_read<1>();
      if (k + 1 < n_tiles) fetch(k + 1);
    } else if (warp >= 2) {
      if (active && k >= 1 && k <= n_tiles) gain(k - 1, warp - 2);
    } else if (active && k < n_tiles) {
      run(k);
    }
  }
  if (warp == 1) pymodem::bulk_wait_all();
}

}  // namespace

// Input rows ``in_stride`` floats apart, outputs ``out_stride`` apart,
// both 16-byte aligned with strides that are multiples of 4 and >= T
// (lane_tiles.cuh; dsp/agc.py agc_lanes pads other rows).
extern "C" int agc_lanes(const float* x, int in_stride, const float* params,
                         float* out, int out_stride, int L, int T,
                         void* stream) {
  if (!pymodem::rows_ok(x, in_stride, T) ||
      !pymodem::rows_ok(out, out_stride, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * 2 * kStages * kTileFloats;
  cudaError_t err = cudaFuncSetAttribute(
      agc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0) {
    agc_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        x, in_stride, params, out, out_stride, L, T);
  }
  return static_cast<int>(cudaGetLastError());
}
