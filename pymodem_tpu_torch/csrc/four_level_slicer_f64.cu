// K12: the four-level (4FSK) symbol-timing slicer at float64 over
// (chain x block) lanes.
//
// Replaces the lax.scan pymodem_tpu/ops/slicers.py four_level_slice
// (reference slicer.py:329-441, fix-forward) on float64 input, which the
// JAX package runs in its float64 parity mode (its Pallas kernel, which K8
// replaces, runs float32 only).  The plain twin is ops/slicers.py
// four_level_slice on float64 tensors; the emissions are K8's
// (slicer_words.cuh).
//
// Per sample, in the twin's order: clock 1 (rollover strictly above
// sps/2 - 0.5) pushes |x| * 2 / 3 into an 8-deep ring and x > 0 into a
// 16-bit sync register; the patterns 0x5555 and 0xCCCC set the threshold
// to the ring's mean (summed r0 + r1 + ... + r7, then / 8) and align
// clock 2 to clock 1; clock 2 decides the symbol (3/2 above/below the
// threshold, 1/0 below/above its negative) through the demap, 2 bits at a
// time; a zero crossing scales clock 1 by lock_rate.
//
// What bounds it on an H100: each lane is one sequential recurrence, and
// the lanes (1224 on the 4FSK bank at f64, one on the executor) are the
// parallelism, so the run time is T times one step's latency; 8 bytes in
// a sample, 4 out a window.  The chain runs through both f64 clocks, and
// each step also sums the ring (7 dependent f64 adds) and would divide
// |x| * 2 by 3 (an IEEE f64 divide, a long sequence behind a branch to its
// slow path).  One thread a lane, the row read from global memory 8
// samples at a time, the ring in 8 registers updated by selects, took
// 452.4 ns a step on bank lanes and 230.4 ns at one lane.
//
// Design (lane_tiles_f64.cuh, slicer_words.cuh; K8's at f64, as K10 is
// K1's): a block serves 32 lanes with a lane warp, a copy warp and
// kValueWarps value warps, and walks time in tiles of 64 samples.  The
// copy warp brings each lane's tiles into shared memory two tiles ahead
// (one bulk copy a lane and tile; three stages of two rails of 32 rows of
// 66 doubles, 101,376 B) and one tile ahead packs each lane's x > 0 and
// zero-crossing words (the twin's predicates on the doubles: a negative
// subnormal is < 0, a NaN crosses nothing).  One tile ahead too, the
// value warps form |x| * 2 / 3 of every sample into the stage's second
// rail, so no divide is on the lane warp.  The lane thread carries both
// clocks, the ring slot, the sync register, the threshold, the byte, the
// bit count and the window's code, each updated by selects, with no
// branch in a step.  The ring is a row of shared memory a lane (10
// doubles: 5 double2s, an odd count, so a quarter warp's 16-byte loads hit
// 8 distinct bank groups): every step stores its value, to the new slot on
// a rollover and else to slot 8, and reads slots 0-7 back by four 16-byte
// loads for the sum r0 + r1 + ... + r7, which a sync hit makes the
// threshold through an f64 PTX select (a plain ?: lets the compiler move
// the loads and the sum into a branch on the rollover, which some lane of
// a warp takes in almost every step).  The lane reads x itself only for
// the symbol decision.  Window codes leave through a shared buffer in
// coalesced runs.  Built with -fmad=false and without fast math, so the
// output equals the plain twin bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tiles_f64.cuh"
#include "slicer_words.cuh"

namespace {

using pymodem::Codes;
using pymodem::kCodeRow;
using pymodem::kLanes;

constexpr int kTile = 64;  // samples a tile
constexpr int kStride = pymodem::f64::row_stride(kTile);  // doubles a row
constexpr int kStages = 3;  // raw tiles: two in flight, one being packed
constexpr int kRail = kLanes * kStride;  // doubles of one rail of a stage
// two value warps: the fastest of 1, 2, 4 and 8 at the 4FSK bank's f64
// shape (tools/design_sweep.py; PERF.md)
constexpr int kValueWarps = 2;
constexpr int kThreads = (2 + kValueWarps) * kLanes;
constexpr int kDepth = 8;  // the threshold ring (ops/slicers.py FL_DEPTH)
// a lane's ring row: 8 slots and slot kDepth for the stores of the steps
// that do not roll over, padded to 5 double2s
constexpr int kRingRow = 10;
// a lane's words of a tile: (x > 0, crossing) per 32 samples, rows padded
// to an odd count so the lanes' reads hit distinct banks
constexpr int kWordRow = 2 * (kTile / 32) + 1;
// dynamic shared memory: the tile stages of both rails (x, then its ring
// values), two tiles of words and the window codes
constexpr int kSmemBytes =
    8 * 2 * kStages * kRail + 4 * kLanes * (2 * kWordRow + kCodeRow);

// p ? a : b as one PTX select, so that the compiler cannot move the work
// that forms a or b into a branch on p
__device__ __forceinline__ double select_f64(bool p, double a, double b) {
  double out;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %1, 0;\n"
      " selp.f64 %0, %2, %3, q;\n}\n"
      : "=d"(out)
      : "r"(static_cast<unsigned>(p)), "d"(a), "d"(b));
  return out;
}

struct Slicer {
  double clock1 = 0.0, clock2 = 0.0, threshold = 0.0;
  double sps, lock_rate, rollover;
  int byte = 0, bit_count = 0, sync = 0;
  int slot = 0;  // the ring index
  int d0, d1, d2, d3;  // the demap
  double* ring;  // the lane's ring row (16-byte aligned)

  // One sample at time t: x, its ring value v = |x| * 2 / 3, pos = x > 0,
  // cross the zero crossing.  Every update is a select.
  __device__ __forceinline__ void step(int t, double x, double v, int pos,
                                       bool cross, Codes& codes, int* orow,
                                       int ob) {
    clock1 = clock1 + 1.0;
    const bool roll1 = clock1 > rollover;
    const double rewound1 = clock1 - sps;
    clock1 = roll1 ? rewound1 : clock1;
    const int next = (slot + 1) & (kDepth - 1);
    slot = roll1 ? next : slot;
    ring[roll1 ? slot : kDepth] = v;
    const int shifted = ((sync << 1) & 0xFFFF) + pos;
    sync = roll1 ? shifted : sync;
    // & and |, not && and ||: the compiler makes branches of those
    const bool hit = roll1 & ((sync == 0x5555) | (sync == 0xCCCC));
    const double2 a = *reinterpret_cast<const double2*>(ring);
    const double2 b = *reinterpret_cast<const double2*>(ring + 2);
    const double2 c = *reinterpret_cast<const double2*>(ring + 4);
    const double2 d = *reinterpret_cast<const double2*>(ring + 6);
    const double sum = a.x + a.y + b.x + b.y + c.x + c.y + d.x + d.y;
    // * 0.125 is / 8 exactly (a power of two)
    threshold = select_f64(hit, sum * 0.125, threshold);
    clock2 = (hit ? clock1 : clock2) + 1.0;
    const bool roll2 = clock2 > rollover;
    const double rewound2 = clock2 - sps;
    clock2 = roll2 ? rewound2 : clock2;
    const int bits = pos ? (x >= threshold ? d3 : d2)
                         : (x <= -threshold ? d0 : d1);
    const int shifted_byte = ((byte << 2) & 0xFF) + bits;
    byte = roll2 ? shifted_byte : byte;
    bit_count = roll2 ? bit_count + 2 : bit_count;
    // bit_count only reaches 8 on a decision and resets there
    const bool emit = bit_count >= 8;
    bit_count = emit ? 0 : bit_count;
    const double locked = clock1 * lock_rate;
    clock1 = cross ? locked : clock1;
    codes.add(t, emit, byte, orow, ob);
  }
};

// Warp 0 is the lanes, warp 1 the copy warp (it starts its lane's bulk
// copies and packs its words), warps 2.. the value warps.
__global__ void __launch_bounds__(kThreads, 1)
    four_level_slice_f64_kernel(const double* __restrict__ x, int in_stride,
                                const double* __restrict__ params,
                                int* __restrict__ out, int d0, int d1, int d2,
                                int d3, int L, int T, int window) {
  extern __shared__ __align__(16) double smem[];
  __shared__ uint64_t bars[kStages];
  __shared__ __align__(16) double rings[kLanes * kRingRow];
  // [stage][rail][lane][kStride] input tiles and their ring values,
  // [2][lane][kWordRow] words, then the [lane][kCodeRow] window codes
  unsigned* words =
      reinterpret_cast<unsigned*>(smem + 2 * kStages * kRail);
  const int tid = threadIdx.x;
  const int warp = tid / kLanes;
  const int r = tid % kLanes;  // the lane row this thread serves
  const int lane0 = blockIdx.x * kLanes;
  const int lane = lane0 + r;
  const bool active = lane < L;
  const int n_active = min(kLanes, L - lane0);
  const double* row = x + static_cast<size_t>(active ? lane : 0) * in_stride;
  if (tid < kStages) pymodem::mbar_init(&bars[tid]);
  if (warp == 0) {
    for (int d = 0; d < kRingRow; ++d) rings[r * kRingRow + d] = 0.0;
  }
  __syncthreads();

  Slicer s;
  s.sps = active ? params[lane] : 0.0;
  s.lock_rate = active ? params[L + lane] : 0.0;
  s.rollover = s.sps / 2.0 - 0.5;
  s.d0 = d0;
  s.d1 = d1;
  s.d2 = d2;
  s.d3 = d3;
  s.ring = rings + r * kRingRow;
  Codes codes = pymodem::codes_for(window);
  pymodem::CodeBuffer cb = pymodem::code_buffer(
      reinterpret_cast<int*>(words + 2 * kLanes * kWordRow), window, T);
  int* orow = cb.row(r);
  pymodem::Crossings crossings;
  auto tile_n = [&](int k) { return min(kTile, T - k * kTile); };
  // lane r's row of tile k's x; its ring values lie kRail doubles on
  auto tile_row = [&](int k) {
    return smem + 2 * (k % kStages) * kRail + r * kStride;
  };

  // copy warp: tile k to stage k % kStages by one bulk copy a lane,
  // completing on the stage's barrier
  auto fetch = [&](int k) {
    const unsigned bytes = pymodem::f64::tile_bytes(tile_n(k));
    uint64_t* bar = &bars[k % kStages];
    if (r == 0) pymodem::mbar_expect(bar, bytes * n_active);
    if (active) pymodem::bulk_load(tile_row(k), row + k * kTile, bytes, bar);
  };
  // copy warp: lane r's words of tile k
  auto pack = [&](int k) {
    pymodem::mbar_wait(&bars[k % kStages], (k / kStages) & 1);
    const double* xr = tile_row(k);
    unsigned* w = words + ((k & 1) * kLanes + r) * kWordRow;
    for (int c0 = 0; c0 < tile_n(k); c0 += 32) {
      const pymodem::Signs sg = pymodem::signs32<true>(xr + c0);
      w[2 * (c0 >> 5)] = sg.gt;
      w[2 * (c0 >> 5) + 1] = crossings.next(sg);
    }
  };
  // value warp g: |x| * 2 / 3 over its columns of lane r's tile k (the
  // twin's op order, each rounded); past an odd tile the last double2
  // reads the row's padding
  auto form_values = [&](int k, int g) {
    constexpr int kCols = kTile / kValueWarps;
    pymodem::mbar_wait(&bars[k % kStages], (k / kStages) & 1);
    const double* xr = tile_row(k);
    double* vr = tile_row(k) + kRail;
    const int end = min(kCols * (g + 1), tile_n(k));
    for (int c = kCols * g; c < end; c += 2) {
      const double2 a = *reinterpret_cast<const double2*>(xr + c);
      *reinterpret_cast<double2*>(vr + c) =
          make_double2(fabs(a.x) * 2.0 / 3.0, fabs(a.y) * 2.0 / 3.0);
    }
  };
  // lane warp: tile k, two steps a double2 of x and of the values
  auto run = [&](int k) {
    pymodem::mbar_wait(&bars[k % kStages], (k / kStages) & 1);
    const double* xr = tile_row(k);
    const double* vr = xr + kRail;
    const unsigned* w = words + ((k & 1) * kLanes + r) * kWordRow;
    const int n = tile_n(k);
    for (int c0 = 0; c0 < n; c0 += 32) {
      const unsigned pos = w[2 * (c0 >> 5)];
      const unsigned cross = w[2 * (c0 >> 5) + 1];
      const int tc = k * kTile + c0;
      if (n - c0 >= 32) {
#pragma unroll
        for (int q = 0; q < 32; q += 2) {
          const double2 a = *reinterpret_cast<const double2*>(xr + c0 + q);
          const double2 v = *reinterpret_cast<const double2*>(vr + c0 + q);
          s.step(tc + q, a.x, v.x, (pos >> q) & 1u, (cross >> q) & 1u, codes,
                 orow, cb.ob);
          s.step(tc + q + 1, a.y, v.y, (pos >> (q + 1)) & 1u,
                 (cross >> (q + 1)) & 1u, codes, orow, cb.ob);
        }
      } else {
        for (int b = 0; b < n - c0; ++b) {
          s.step(tc + b, xr[c0 + b], vr[c0 + b], (pos >> b) & 1u,
                 (cross >> b) & 1u, codes, orow, cb.ob);
        }
      }
    }
  };

  // raw tiles run two ahead of the lanes, words and values one ahead
  const int n_tiles = (T + kTile - 1) / kTile;
  if (warp == 1) {
    for (int k = 0; k < min(2, n_tiles); ++k) fetch(k);
  }
  __syncthreads();
  if (active && n_tiles > 0) {
    if (warp == 1) pack(0);
    if (warp >= 2) form_values(0, warp - 2);
  }
  for (int k = 0; k < n_tiles; ++k) {
    // words and values of tile k are in; the lanes are done with k - 1
    __syncthreads();
    if (warp == 1) {
      if (k + 2 < n_tiles) fetch(k + 2);
      if (active && k + 1 < n_tiles) pack(k + 1);
    } else if (warp >= 2) {
      if (active && k + 1 < n_tiles) form_values(k + 1, warp - 2);
    } else if (active) {
      run(k);
    }
    cb.after_tile(k == n_tiles - 1, k * kTile + tile_n(k),
                  warp == 0 && active, codes, r, out, lane0, n_active);
  }
}

}  // namespace

// Input rows ``in_stride`` doubles apart, 16-byte aligned with a stride
// that is a multiple of 2 and >= T (lane_tiles_f64.cuh; ops/slicers.py
// four_level_slice_f64_lanes pads other rows); params (2, L) rows (sps,
// lock_rate); the 4-entry demap; out (L, ceil(T / window)) int32.
extern "C" int four_level_slice_f64_lanes(const double* x, int in_stride,
                                          const double* params, int* out,
                                          int d0, int d1, int d2, int d3,
                                          int L, int T, int window,
                                          void* stream) {
  if (!pymodem::f64::rows_ok(x, in_stride, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      four_level_slice_f64_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0 && T > 0) {
    four_level_slice_f64_kernel<<<blocks, kThreads, kSmemBytes,
                                  static_cast<cudaStream_t>(stream)>>>(
        x, in_stride, params, out, d0, d1, d2, d3, L, T, window);
  }
  return static_cast<int>(cudaGetLastError());
}

// K12's dynamic shared memory a block, bytes
extern "C" int four_level_slice_f64_smem_bytes() { return kSmemBytes; }
