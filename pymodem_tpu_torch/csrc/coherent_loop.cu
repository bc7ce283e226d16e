// K2 and K3: the AFSK PLL and the BPSK Costas carrier loops, each with the
// AGC envelope follower fused.
//
// Replaces the Pallas TPU kernel pymodem_tpu/dsp/pallas_loops.py
// _loop_kernel, kinds "afsk_pll" (K2) and "bpsk" (K3) with fuse_agc
// (loop_lanes_pallas), itself the lane form of agc_apply + afsk_pll and of
// agc_apply + bpsk_costas in pymodem_tpu/dsp/agc.py and
// pymodem_tpu/dsp/loops.py (reference agc.py:26-80, afsk_pll.py:152-165,
// psk.py:173-189).
//
// Per sample: the AGC (the envelope follower, then target * x / env, or x
// while env is 0), the NCO, then
//   K2: e = x * sin;                              output prop
//   K3: i = x * cos, q = x * (-sin), e = i * q;   output i
// the loop IIR, PI with a saturated integral, control = prop + integral.
// Rows: the 10 PLL rows, then the 5 AGC rows (15).
//
// What bounds it on an H100: each lane is a strictly sequential recurrence
// (phase, control, IIR x and y, PI integral), ~22 dependent operations and
// one shared-memory table read a step, and the lane count sets the
// parallelism: 344 lanes on the PLL sweep, 744 on the BPSK sweep, 11 and
// 24 blocks on 132 SMs.  The run time is T times the chain's latency; the
// 8 bytes a sample moves are far below what the card streams.  The AGC
// does not depend on the loop, so it leaves the lane's chain: its envelope
// follower is a recurrence of its own (~28.5 ns a step, K4), and its IEEE
// divide sits behind a branch to its slow path (~70 ns a sample on one
// warp), too slow to ride beside a follower on one thread.
//
// Design (lane_tiles.cuh): a block serves 32 lanes with a lane warp, a copy
// warp and a gain warp, and walks time in tiles of 128 samples over
// five stages of two rails.  Lane l reads input row row_of_lane[l] of
// (R, T) rows, so the C chains of a pre-shared bank read its B shared
// band-passed rows.  While the lanes run the loop over tile k - 2, gain
// thread l forms target * x / env of lane l's tile k - 1 in place over its
// input, and copy thread l runs lane l's envelope follower over tile k, writing the
// envelopes into the stage's second rail; the copy warp also stores tile
// k - 3 and loads tile k + 1, one bulk copy a lane each.  The lane thread
// reads its gained row as float4s, four steps at a time, and writes its
// output (K2 prop, K3 i) in place.  The table is one shared-memory read a
// step: K2's sine, K3's (cos, -sin) pairs (negating is exact), from the
// tables handed in by the caller, so kernel and twin read the same
// numbers.  The NCO's wraps are selects and the integral's clamp PTX
// max.NaN/min.NaN (loop_common.cuh).  Built with -fmad=false and
// without fast math, in the JAX op order, so the outputs equal the plain
// twins (dsp/loops.py afsk_pll, bpsk_costas) bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tiles.cuh"
#include "loop_common.cuh"

namespace {

using pymodem::Agc;
using pymodem::kLanes;
using pymodem::kStride;
using pymodem::kTableSize;
using pymodem::kTile;
using pymodem::Loop;

constexpr int kLoopRows = 10;  // PLL_PARAMS, then the five AGC rows
// tile k + 1 loads while tile k follows, k - 1 gains, k - 2 runs the loop
// and k - 3 stores
constexpr int kStages = 5;
// the lane, copy and gain warps; one gain warp keeps up with the lanes
// (two and four were no faster, PERF.md)
constexpr int kThreads = 3 * kLanes;
constexpr int kTileFloats = kLanes * kStride;  // one rail of a stage

// K2: the mixer x * sin; the output is prop
struct AfskPll {
  using Entry = float;  // sin
  __device__ static Entry entry(const float* sine, const float*, int k) {
    return sine[k];
  }
  __device__ static __forceinline__ float step(Loop& loop, const Entry* tab,
                                               float xv) {
    const float prop =
        loop.filter(xv * tab[loop.nco_select()]);
    loop.control = prop + loop.integral;
    return prop;
  }
};

// K3: i = x * cos, q = x * (-sin), e = i * q; the output is i
struct BpskCostas {
  using Entry = float2;  // (cos, -sin)
  __device__ static Entry entry(const float* sine, const float* cosine,
                                int k) {
    return make_float2(cosine[k], -sine[k]);
  }
  __device__ static __forceinline__ float step(Loop& loop, const Entry* tab,
                                               float xv) {
    const float2 cs = tab[loop.nco_select()];
    const float i_mixer = xv * cs.x;
    const float prop = loop.filter(i_mixer * (xv * cs.y));
    loop.control = prop + loop.integral;
    return i_mixer;
  }
};

// Warp 0 is the lanes, warp 1 the copy warp (it starts its lane's bulk
// copies and runs its lane's envelope follower), warp 2 the gain warp.
template <class Kind>
__global__ void __launch_bounds__(kThreads, 1)
    coherent_loop_kernel(const float* __restrict__ x, int in_stride,
                         const int* __restrict__ row_of_lane, int n_rows,
                         const float* __restrict__ params,
                         const float* __restrict__ sine_table,
                         const float* __restrict__ cos_table,
                         float* __restrict__ out, int out_stride, int L,
                         int T) {
  using Entry = typename Kind::Entry;
  // [stage][rail][lane][kStride] tiles (rail 0: the input, gained in
  // place, then the outputs in place; rail 1: the envelopes)
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bars[kStages];
  __shared__ Entry tab[kTableSize];  // the NCO table
  const int tid = threadIdx.x;
  const int warp = tid / kLanes;
  const int r = tid % kLanes;  // the lane row this thread serves
  const int lane0 = blockIdx.x * kLanes;
  const int lane = lane0 + r;
  const bool active = lane < L;
  const int n_active = min(kLanes, L - lane0);
  for (int k = tid; k < kTableSize; k += kThreads) {
    tab[k] = Kind::entry(sine_table, cos_table, k);
  }
  if (tid < kStages) pymodem::mbar_init(&bars[tid]);
  __syncthreads();

  const int pl = active ? lane : 0;
  // the clamp only keeps a mismatched call inside the rows
  const float* row =
      x + static_cast<size_t>(min(max(row_of_lane[pl], 0), n_rows - 1)) *
              in_stride;
  Loop loop(params + pl, L);
  Agc agc(params + kLoopRows * L + pl, L);
  auto tile_n = [&](int k) { return min(kTile, T - k * kTile); };
  auto row_at = [&](int k) {
    return smem + 2 * (k % kStages) * kTileFloats + r * kStride;
  };

  // copy warp: tile k to rail 0 of its stage by one bulk copy a lane,
  // completing on the stage's barrier
  auto fetch = [&](int k) {
    const unsigned bytes = 4u * pymodem::padded4(tile_n(k));
    uint64_t* bar = &bars[k % kStages];
    if (r == 0) pymodem::mbar_expect(bar, bytes * n_active);
    if (active) pymodem::bulk_load(row_at(k), row + k * kTile, bytes, bar);
  };
  // copy warp: the outputs of tile k to the (L, T) output
  auto store = [&](int k) {
    if (active) {
      pymodem::bulk_store(
          out + static_cast<size_t>(lane) * out_stride + k * kTile,
          row_at(k), 4u * pymodem::padded4(tile_n(k)));
    }
    pymodem::bulk_commit();
  };
  // copy warp: the envelopes of tile k into rail 1, four steps at a time;
  // past T (the last tile of a row whose T is not a multiple of 4) the
  // steps make only outputs in the rows' padding
  auto follow = [&](int k) {
    pymodem::mbar_wait(&bars[k % kStages], (k / kStages) & 1);
    float* xr = row_at(k);
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
  // gain warp: target * x / env over tile k, in place
  auto gain = [&](int k) {
    // long passed: orders the bulk load before these reads
    pymodem::mbar_wait(&bars[k % kStages], (k / kStages) & 1);
    float* xr = row_at(k);
    const float* er = xr + kTileFloats;
    for (int c = 0; c < tile_n(k); c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(xr + c);
      const float4 e = *reinterpret_cast<const float4*>(er + c);
      *reinterpret_cast<float4*>(xr + c) =
          make_float4(agc.gain(a.x, e.x), agc.gain(a.y, e.y),
                      agc.gain(a.z, e.z), agc.gain(a.w, e.w));
    }
    // ordered before the bulk copies that later refill the stage
    pymodem::fence_proxy_async();
  };
  // lane warp: the loop over tile k, the outputs in place.  Two columns a
  // pass, as K5.
  auto run = [&](int k) {
    float* xr = row_at(k);
    const int n = tile_n(k);
#pragma unroll 2
    for (int c = 0; c < n; c += 4) {
      float4 a = *reinterpret_cast<const float4*>(xr + c);
      a.x = Kind::step(loop, tab, a.x);
      a.y = Kind::step(loop, tab, a.y);
      a.z = Kind::step(loop, tab, a.z);
      a.w = Kind::step(loop, tab, a.w);
      *reinterpret_cast<float4*>(xr + c) = a;
    }
    // the bulk store reads what these generic stores wrote
    pymodem::fence_proxy_async();
  };

  const int n_tiles = (T + kTile - 1) / kTile;
  if (warp == 1 && n_tiles > 0) fetch(0);
  for (int k = 0; k < n_tiles + 3; ++k) {
    // the follower is done with k - 1, the gains with k - 2, the lanes
    // with k - 3
    __syncthreads();
    if (warp == 1) {
      // store tile k - 3, then load tile k + 1 into the stage of tile
      // k - 4 once its store has read it, then follow tile k
      if (k >= 3) store(k - 3);
      pymodem::bulk_wait_read<1>();
      if (k + 1 < n_tiles) fetch(k + 1);
      if (active && k < n_tiles) follow(k);
    } else if (warp == 2) {
      if (active && k >= 1 && k <= n_tiles) gain(k - 1);
    } else if (active && k >= 2 && k < n_tiles + 2) {
      run(k - 2);
    }
  }
  if (warp == 1) pymodem::bulk_wait_all();
}

template <class Kind>
int launch(const float* x, int in_stride, const int* row_of_lane,
           int n_rows, const float* params, const float* sine_table,
           const float* cos_table, float* out, int out_stride, int L, int T,
           void* stream) {
  if ((n_rows <= 0 && L > 0) || !pymodem::rows_ok(x, in_stride, T) ||
      !pymodem::rows_ok(out, out_stride, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * 2 * kStages * kTileFloats;
  cudaError_t err = cudaFuncSetAttribute(
      coherent_loop_kernel<Kind>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0) {
    coherent_loop_kernel<Kind>
        <<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
            x, in_stride, row_of_lane, n_rows, params, sine_table, cos_table,
            out, out_stride, L, T);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries: L lanes on (R, T) input rows ``in_stride`` floats apart
// (lane l on row row_of_lane[l]), (15, L) lane rows, outputs ``out_stride``
// apart; rows 16-byte aligned with strides that are multiples of 4 and
// >= T (lane_tiles.cuh; dsp/loops.py pads other rows).  K2 reads no cosine
// table (``cos_table`` may be null).
extern "C" int afsk_pll_lanes(const float* x, int in_stride,
                              const int* row_of_lane, int n_rows,
                              const float* params, const float* sine_table,
                              const float* cos_table, float* out,
                              int out_stride, int L, int T, void* stream) {
  return launch<AfskPll>(x, in_stride, row_of_lane, n_rows, params,
                         sine_table, cos_table, out, out_stride, L, T,
                         stream);
}

extern "C" int bpsk_costas_lanes(const float* x, int in_stride,
                                 const int* row_of_lane, int n_rows,
                                 const float* params, const float* sine_table,
                                 const float* cos_table, float* out,
                                 int out_stride, int L, int T, void* stream) {
  return launch<BpskCostas>(x, in_stride, row_of_lane, n_rows, params,
                            sine_table, cos_table, out, out_stride, L, T,
                            stream);
}
