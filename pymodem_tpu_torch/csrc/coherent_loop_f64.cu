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
// What bounds it on an H100: each lane is one sequential recurrence, and
// the lanes (384 on pll_sweep8 at f64, 744 on the BPSK sweep, one on the
// executor) are the parallelism, so the run time is T times one step's
// latency; the 16 bytes a sample moves are far below what the card
// streams.  K11's step on one thread was ~40 dependent f64 operations:
// the AGC follower (~10: compares, selects, NaN-propagating min and max),
// the IEEE f64 divide target * x / env (a reciprocal seed, Newton steps
// and a branch to its slow path, the longest latency of the step), then
// the NCO (~10 with its four wraps), the table read, the mixer, the IIR
// and PI (~15); 243 ns a step at one lane, 303 ns on bank lanes, whose
// rows a warp read 8 samples at a time, one memory round trip a chunk.
// The AGC does not depend on the loop, so it leaves the lane's chain.
//
// Design of K11 (lane_tiles_f64.cuh): a block serves 32 lanes with a lane
// warp, a copy warp and kGainWarps gain warps (one: two measured within
// 1.1% of one on an H100, PERF.md), and
// walks time in tiles of 64 samples over five stages of two rails, 165 KB
// of dynamic shared memory (128-sample tiles would need 325 KB at f64).
// Lane l reads input row row_of_lane[l] of (R, T) rows (a pre-shared
// bank's B shared rows).  While the lanes run the loop over tile k - 2,
// the gain warp forms Agc::gain, target * x / env, of tile k - 1 in place
// over its input, and copy thread l runs lane l's Agc::follow over tile
// k, writing the envelopes into the stage's second rail; the copy warp
// also stores tile k - 3 and loads tile k + 1, one bulk copy a lane each.
// The lane thread's chain is the NCO (Loop::nco_select, its wraps as
// selects side by side), the table read, the mixer and Loop::filter, ~25
// dependent operations; it reads its gained row as double2s and writes
// its output (afsk_pll prop, bpsk i) in place.  The table is one
// shared-memory read a step: afsk_pll's sine, bpsk's (cos, -sin) pairs
// (negating is exact).  Built with -fmad=false and without fast math, in
// the twins' op order, so the outputs equal the plain twins (dsp/loops.py
// afsk_pll, bpsk_costas) bitwise.
//
// Design of K13 (K4's at f64, lane_tiles_f64.cuh): with no loop behind
// it, the follower is the lane's whole chain (~10 dependent operations a
// step: compares, selects, NaN-propagating min and max) and stays on the
// lane warp; the divides leave it.  A block serves 32 lanes with a lane
// warp, a copy warp and kAgcGainWarps gain warps (four: one warp's
// divides do not keep up with the follower; at 118 lanes on an H100 one
// gain warp took 93.5 ns a step, two 48.3, four 43.6 and eight 44.2,
// tools/k13_gain_warps.py), and walks time in tiles of 64 samples over
// four stages of two rails, 135,168 B (128-sample tiles would need 266
// KB).  While lane thread l runs Agc::follow over
// tile k of row l and writes each envelope into the stage's second rail,
// the gain warps form Agc::gain, target * x / env, of tile k - 1 in place
// over its input, and the copy warp stores tile k - 2 and loads tile
// k + 1, one bulk copy a lane each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tiles_f64.cuh"
#include "lanes_f64.cuh"

namespace {

using namespace pymodem::f64;

constexpr int kLoopRows = 10;  // PLL_PARAMS, then the five AGC rows
constexpr int kGainWarps = 1;  // warps forming the AGC's quotients
constexpr int kTile = 64;      // samples a tile
constexpr int kStride = row_stride(kTile);  // doubles a lane row of a rail
// tile k + 1 loads while tile k follows, k - 1 gains, k - 2 runs the loop
// and k - 3 stores
constexpr int kStages = 5;
constexpr int kRail = kLanes * kStride;  // doubles of one rail of a stage
// dynamic shared memory: kStages stages of two rails
constexpr int kSmemBytes = 8 * 2 * kStages * kRail;

// K13: tile k + 1 loads while tile k follows, k - 1 gains and k - 2
// stores
constexpr int kAgcStages = 4;
constexpr int kAgcGainWarps = 4;  // warps forming K13's quotients
constexpr int kAgcThreads = (2 + kAgcGainWarps) * kLanes;
constexpr int kAgcSmemBytes = 8 * 2 * kAgcStages * kRail;

// afsk_pll: the mixer x * sin; the output is prop
struct AfskPll {
  using Entry = double;  // sin
  __device__ static Entry entry(const double* sine, const double*, int k) {
    return sine[k];
  }
  __device__ static __forceinline__ double step(Loop& loop, const Entry* tab,
                                                double xs) {
    const double prop = loop.filter(xs * tab[loop.nco_select()]);
    loop.control = prop + loop.integral;
    return prop;
  }
};

// bpsk: i = x * cos, q = x * (-sin), e = i * q; the output is i
struct BpskCostas {
  using Entry = double2;  // (cos, -sin)
  __device__ static Entry entry(const double* sine, const double* cosine,
                                int k) {
    return make_double2(cosine[k], -sine[k]);
  }
  __device__ static __forceinline__ double step(Loop& loop, const Entry* tab,
                                                double xs) {
    const double2 cs = tab[loop.nco_select()];
    const double i_mixer = xs * cs.x;
    const double prop = loop.filter(i_mixer * (xs * cs.y));
    loop.control = prop + loop.integral;
    return i_mixer;
  }
};

// Warp 0 is the lanes, warp 1 the copy warp (it starts its lane's bulk
// copies and runs its lane's envelope follower), warps 2 and up the gain
// warps: gain warp g forms the quotients of the tile's double2 columns
// c with c % kGainWarps == g.
template <class Kind>
__global__ void __launch_bounds__((2 + kGainWarps) * kLanes, 1)
    coherent_loop_f64_kernel(const double* __restrict__ x, int in_stride,
                             const int* __restrict__ row_of_lane, int n_rows,
                             const double* __restrict__ params,
                             const double* __restrict__ sine,
                             const double* __restrict__ cosine,
                             double* __restrict__ out, int out_stride, int L,
                             int T) {
  using Entry = typename Kind::Entry;
  constexpr int kThreads = (2 + kGainWarps) * kLanes;
  // [stage][rail][lane][kStride] tiles (rail 0: the input, gained in
  // place, then the outputs in place; rail 1: the envelopes)
  extern __shared__ __align__(16) double smem[];
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
    tab[k] = Kind::entry(sine, cosine, k);
  }
  if (tid < kStages) pymodem::mbar_init(&bars[tid]);
  __syncthreads();

  const int pl = active ? lane : 0;
  // the clamp only keeps a mismatched call inside the rows
  const double* row =
      x + static_cast<size_t>(min(max(row_of_lane[pl], 0), n_rows - 1)) *
              in_stride;
  Loop loop(params + pl, L);
  Agc agc(params + kLoopRows * L + pl, L);
  auto tile_n = [&](int k) { return min(kTile, T - k * kTile); };
  auto row_at = [&](int k) {
    return smem + 2 * (k % kStages) * kRail + r * kStride;
  };

  // copy warp: tile k to rail 0 of its stage by one bulk copy a lane,
  // completing on the stage's barrier
  auto fetch = [&](int k) {
    const unsigned bytes = tile_bytes(tile_n(k));
    uint64_t* bar = &bars[k % kStages];
    if (r == 0) pymodem::mbar_expect(bar, bytes * n_active);
    if (active) pymodem::bulk_load(row_at(k), row + k * kTile, bytes, bar);
  };
  // copy warp: the outputs of tile k to the (L, T) output
  auto store = [&](int k) {
    if (active) {
      pymodem::bulk_store(
          out + static_cast<size_t>(lane) * out_stride + k * kTile,
          row_at(k), tile_bytes(tile_n(k)));
    }
    pymodem::bulk_commit();
  };
  // copy warp: the envelopes of tile k into rail 1, two steps at a time;
  // past T (the last tile of a row whose T is odd) the step makes only an
  // output in the rows' padding
  auto follow = [&](int k) {
    pymodem::mbar_wait(&bars[k % kStages], (k / kStages) & 1);
    double* xr = row_at(k);
    agc.follow_tile(xr, xr + kRail, tile_n(k));
  };
  // gain warp g: target * x / env over its columns of tile k, in place
  auto gain = [&](int k, int g) {
    // long passed: orders the bulk load before these reads
    pymodem::mbar_wait(&bars[k % kStages], (k / kStages) & 1);
    double* xr = row_at(k);
    agc.gain_tile(xr, xr + kRail, tile_n(k), 2 * g, 2 * kGainWarps);
    // ordered before the bulk copies that later refill the stage
    pymodem::fence_proxy_async();
  };
  // lane warp: the loop over tile k, the outputs in place
  auto run = [&](int k) {
    double* xr = row_at(k);
    const int n = tile_n(k);
#pragma unroll 2
    for (int c = 0; c < n; c += 2) {
      double2 a = *reinterpret_cast<const double2*>(xr + c);
      a.x = Kind::step(loop, tab, a.x);
      a.y = Kind::step(loop, tab, a.y);
      *reinterpret_cast<double2*>(xr + c) = a;
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
    } else if (warp >= 2) {
      if (active && k >= 1 && k <= n_tiles) gain(k - 1, warp - 2);
    } else if (active && k >= 2 && k < n_tiles + 2) {
      run(k - 2);
    }
  }
  if (warp == 1) pymodem::bulk_wait_all();
}

// K13: warp 0 is the lanes (the follower), warp 1 the copy warp, warps 2
// and up the gain warps: gain warp g forms the quotients of the tile's
// double2 columns c with c % kAgcGainWarps == g.
__global__ void __launch_bounds__(kAgcThreads, 1)
    agc_f64_kernel(const double* __restrict__ x, int in_stride,
                   const double* __restrict__ params,
                   double* __restrict__ out, int out_stride, int L, int T) {
  // [stage][rail][lane][kStride] tiles (rail 0: the input, then the
  // outputs in place; rail 1: the envelopes)
  extern __shared__ __align__(16) double smem[];
  __shared__ uint64_t bars[kAgcStages];
  const int tid = threadIdx.x;
  const int warp = tid / kLanes;
  const int r = tid % kLanes;  // the lane row this thread serves
  const int lane0 = blockIdx.x * kLanes;
  const int lane = lane0 + r;
  const bool active = lane < L;
  const int n_active = min(kLanes, L - lane0);
  if (tid < kAgcStages) pymodem::mbar_init(&bars[tid]);
  __syncthreads();

  const int pl = active ? lane : 0;
  const double* row = x + static_cast<size_t>(pl) * in_stride;
  Agc agc(params + pl, L);
  auto tile_n = [&](int k) { return min(kTile, T - k * kTile); };
  auto row_at = [&](int k) {
    return smem + 2 * (k % kAgcStages) * kRail + r * kStride;
  };

  // copy warp: tile k to rail 0 of its stage by one bulk copy a lane,
  // completing on the stage's barrier
  auto fetch = [&](int k) {
    const unsigned bytes = tile_bytes(tile_n(k));
    uint64_t* bar = &bars[k % kAgcStages];
    if (r == 0) pymodem::mbar_expect(bar, bytes * n_active);
    if (active) pymodem::bulk_load(row_at(k), row + k * kTile, bytes, bar);
  };
  // copy warp: the outputs of tile k to the (L, T) output
  auto store = [&](int k) {
    if (active) {
      pymodem::bulk_store(
          out + static_cast<size_t>(lane) * out_stride + k * kTile,
          row_at(k), tile_bytes(tile_n(k)));
    }
    pymodem::bulk_commit();
  };
  // lane warp: the envelopes of tile k into rail 1, two steps at a time;
  // past T (the last tile of a row whose T is odd) the step makes only an
  // output in the rows' padding
  auto follow = [&](int k) {
    pymodem::mbar_wait(&bars[k % kAgcStages], (k / kAgcStages) & 1);
    double* xr = row_at(k);
    agc.follow_tile(xr, xr + kRail, tile_n(k));
  };
  // gain warp g: target * x / env over its columns of tile k, in place
  auto gain = [&](int k, int g) {
    // long passed: orders the bulk load before these reads
    pymodem::mbar_wait(&bars[k % kAgcStages], (k / kAgcStages) & 1);
    double* xr = row_at(k);
    agc.gain_tile(xr, xr + kRail, tile_n(k), 2 * g, 2 * kAgcGainWarps);
    // the bulk store reads what these generic stores wrote
    pymodem::fence_proxy_async();
  };

  const int n_tiles = (T + kTile - 1) / kTile;
  if (warp == 1 && n_tiles > 0) fetch(0);
  for (int k = 0; k < n_tiles + 2; ++k) {
    // the lanes are done with k - 1, the gains with k - 2
    __syncthreads();
    if (warp == 1) {
      // store tile k - 2, then load tile k + 1 into the stage of tile
      // k - 3 once its store has read it
      if (k >= 2) store(k - 2);
      pymodem::bulk_wait_read<1>();
      if (k + 1 < n_tiles) fetch(k + 1);
    } else if (warp >= 2) {
      if (active && k >= 1 && k <= n_tiles) gain(k - 1, warp - 2);
    } else if (active && k < n_tiles) {
      follow(k);
    }
  }
  if (warp == 1) pymodem::bulk_wait_all();
}

using LoopKernel = void (*)(const double*, int, const int*, int,
                           const double*, const double*, const double*,
                           double*, int, int, int);

}  // namespace

// K11.  L lanes on (R, T) input rows ``in_stride`` doubles apart (lane l
// on row row_of_lane[l] < R), params (15, L), PLL_PARAMS then AGC_PARAMS
// (dsp/loops.py), the two (256,) tables (cosine unused, and may be null,
// for kind 0), out (L, T) rows ``out_stride`` apart; rows 16-byte aligned
// with strides that are multiples of 2 and >= T (lane_tiles_f64.cuh;
// dsp/loops.py pads other rows).  kind 0 is afsk_pll, 1 bpsk.
extern "C" int coherent_loop_f64_lanes(const double* x, int in_stride,
                                       const int* row_of_lane, int R,
                                       const double* params,
                                       const double* sine,
                                       const double* cosine, double* out,
                                       int out_stride, int L, int T, int kind,
                                       void* stream) {
  if ((R < 1 && L > 0) || kind < 0 || kind > 1 ||
      (kind == 1 && cosine == nullptr) || !rows_ok(x, in_stride, T) ||
      !rows_ok(out, out_stride, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LoopKernel kernel = kind == 1 ? coherent_loop_f64_kernel<BpskCostas>
                                      : coherent_loop_f64_kernel<AfskPll>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0 && T > 0) {
    kernel<<<blocks, (2 + kGainWarps) * kLanes, kSmemBytes,
             static_cast<cudaStream_t>(stream)>>>(
        x, in_stride, row_of_lane, R, params, sine, cosine, out, out_stride,
        L, T);
  }
  return static_cast<int>(cudaGetLastError());
}

// K11's dynamic shared memory a block, bytes
extern "C" int coherent_loop_f64_smem_bytes() { return kSmemBytes; }

// K13.  Input rows ``in_stride`` doubles apart, lane l on row l; params
// (5, L), AGC_PARAMS (dsp/agc.py); out (L, T) rows ``out_stride`` apart;
// rows 16-byte aligned with strides that are multiples of 2 and >= T
// (lane_tiles_f64.cuh; dsp/agc.py pads other rows).
extern "C" int agc_f64_lanes(const double* x, int in_stride,
                             const double* params, double* out,
                             int out_stride, int L, int T, void* stream) {
  if (!rows_ok(x, in_stride, T) || !rows_ok(out, out_stride, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      agc_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kAgcSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0 && T > 0) {
    agc_f64_kernel<<<blocks, kAgcThreads, kAgcSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
        x, in_stride, params, out, out_stride, L, T);
  }
  return static_cast<int>(cudaGetLastError());
}

// K13's dynamic shared memory a block, bytes
extern "C" int agc_f64_smem_bytes() { return kAgcSmemBytes; }
