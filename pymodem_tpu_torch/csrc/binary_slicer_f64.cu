// K10: the binary symbol-timing slicer at float64 over (chain x block)
// lanes.
//
// Replaces the lax.scan pymodem_tpu/ops/slicers.py binary_slice (reference
// slicer.py:59-107) on float64 input, which the JAX package runs in its
// float64 parity mode (its Pallas kernel, which K1 replaces, runs float32
// only).  The plain twin is ops/slicers.py binary_slice on float64
// tensors; the emissions are K1's (slicer_words.cuh), so the port's
// compaction serves both.
//
// Per sample: the phase clock advances by 1; at a decision (clock reached
// sps/2 - 0.5, then rewound by sps) the byte takes the bit x >= 0; a byte
// completes every 8 decisions; a zero crossing scales the clock by
// lock_rate.
//
// What bounds it on an H100: each lane is one sequential recurrence, and
// the lane count (384 on pll_sweep8 at f64, 744 on the BPSK sweep, one on
// the executor) sets the parallelism, so the run time is T times one
// step's latency.  The only float dependency from step to step is the f64
// clock (add, compare, subtract, multiply, ~6 dependent operations with
// the selects); 8 bytes in a sample, 4 out a window.  One thread a lane
// took 45.6 ns a step at one lane and 113.5 ns on bank lanes, where the
// loads (a round trip every 8 samples, a warp touching 32 rows) and the
// stores (one int a window straight to global memory, one a sample at
// window 1) cost more than the clock.
//
// Design (lane_tiles_f64.cuh, slicer_words.cuh; K1's at f64): a block
// serves 32 lanes with one lane thread and one copy thread each, and walks
// time in tiles of 128 samples.  The copy warp brings each lane's tiles
// into shared memory two tiles ahead (one bulk copy a lane and tile; three
// stages of 32 rows of 130 doubles), and one tile ahead packs them into
// bit words: per 32 samples the sign bits (x >= 0) and the zero-crossing
// flags, with the twin's own predicates on the doubles (a negative
// subnormal is < 0, a NaN crosses nothing and becomes the last sample).
// The lane thread carries only the f64 clock, the byte, the bit count and
// the window's code, each updated by selects (no divergent branch), and
// leaves each window's code in a shared buffer that the block stores in
// coalesced runs.  Compare/select/shift and the clock's f64 operations in
// the twin's order, so the output equals the plain twin bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tiles_f64.cuh"
#include "slicer_words.cuh"

namespace {

using pymodem::Codes;
using pymodem::kCodeRow;
using pymodem::kLanes;
using pymodem::kTile;

constexpr int kStride = pymodem::f64::row_stride(kTile);  // doubles a row
constexpr int kStages = 3;  // raw tiles: two in flight, one being packed
constexpr int kTileDoubles = kLanes * kStride;  // a stage
// a lane's words of a tile: (x >= 0, crossing) per 32 samples, rows padded
// to an odd count so the lanes' reads hit distinct banks
constexpr int kWordRow = 2 * (kTile / 32) + 1;
// dynamic shared memory: the tile stages, two tiles of words and the
// window codes
constexpr int kSmemBytes =
    8 * kStages * kTileDoubles + 4 * kLanes * (2 * kWordRow + kCodeRow);

struct Slicer {
  double clock = 0.0;
  double sps, lock_rate, rollover;
  int byte = 0, bit_count = 0;

  // One sample at time t: bit = x >= 0, cross the zero crossing.
  __device__ __forceinline__ void step(int t, int bit, bool cross,
                                       Codes& codes, int* orow, int ob) {
    clock = clock + 1.0;
    const bool decide = clock >= rollover;
    const double rewound = clock - sps;
    clock = decide ? rewound : clock;
    const int shifted = ((byte << 1) & 0xFF) | bit;
    byte = decide ? shifted : byte;
    bit_count += decide;
    // bit_count only reaches 8 on a decision and resets there
    const bool emit = bit_count >= 8;
    bit_count = emit ? 0 : bit_count;
    const double locked = clock * lock_rate;
    clock = cross ? locked : clock;
    codes.add(t, emit, byte, orow, ob);
  }
};

// Threads [0, kLanes) are the lanes; threads [kLanes, 2 kLanes) the copy
// warp.  Copy thread r starts lane r's bulk copies and packs lane r's sign
// and crossing words one tile ahead.
__global__ void __launch_bounds__(2 * kLanes, 1)
    binary_slice_f64_kernel(const double* __restrict__ x, int in_stride,
                            const double* __restrict__ params,
                            int* __restrict__ out, int L, int T,
                            int window) {
  extern __shared__ __align__(16) double smem[];
  __shared__ uint64_t bars[kStages];
  // [stage][lane][kStride] input tiles, [2][lane][kWordRow] words, then
  // the [lane][kCodeRow] window codes
  unsigned* words =
      reinterpret_cast<unsigned*>(smem + kStages * kTileDoubles);
  const int tid = threadIdx.x;
  const bool copier = tid >= kLanes;
  const int r = copier ? tid - kLanes : tid;  // the lane row this thread serves
  const int lane0 = blockIdx.x * kLanes;
  const int lane = lane0 + r;
  const bool active = lane < L;
  const int n_active = min(kLanes, L - lane0);
  const double* row = x + static_cast<size_t>(active ? lane : 0) * in_stride;
  if (tid < kStages) pymodem::mbar_init(&bars[tid]);
  __syncthreads();

  Slicer s;
  s.sps = active ? params[lane] : 0.0;
  s.lock_rate = active ? params[L + lane] : 0.0;
  s.rollover = s.sps / 2.0 - 0.5;
  Codes codes = pymodem::codes_for(window);
  pymodem::CodeBuffer cb = pymodem::code_buffer(
      reinterpret_cast<int*>(words + 2 * kLanes * kWordRow), window, T);
  int* orow = cb.row(r);
  pymodem::Crossings crossings;

  // tile k goes to stage k % kStages by one bulk copy a lane from the copy
  // warp, completing on the stage's barrier
  auto fetch = [&](int k) {
    const int t0 = k * kTile;
    const unsigned bytes = pymodem::f64::tile_bytes(min(kTile, T - t0));
    const int st = k % kStages;
    if (tid == kLanes) pymodem::mbar_expect(&bars[st], bytes * n_active);
    if (copier && active) {
      pymodem::bulk_load(smem + st * kTileDoubles + r * kStride, row + t0,
                         bytes, &bars[st]);
    }
  };
  // copy thread r: lane r's words of tile k
  auto pack = [&](int k) {
    const int st = k % kStages;
    pymodem::mbar_wait(&bars[st], (k / kStages) & 1);
    const double* xr = smem + st * kTileDoubles + r * kStride;
    unsigned* w = words + ((k & 1) * kLanes + r) * kWordRow;
    const int n = min(kTile, T - k * kTile);
    for (int c0 = 0; c0 < n; c0 += 32) {
      const pymodem::Signs sg = pymodem::signs32<false>(xr + c0);
      w[2 * (c0 >> 5)] = sg.ge;
      w[2 * (c0 >> 5) + 1] = crossings.next(sg);
    }
  };

  // raw tiles run two ahead of the lanes, words one ahead
  const int n_tiles = (T + kTile - 1) / kTile;
  for (int k = 0; k < min(2, n_tiles); ++k) fetch(k);
  __syncthreads();
  if (copier && active && n_tiles > 0) pack(0);
  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = k * kTile;
    const int n = min(kTile, T - t0);
    __syncthreads();  // words of tile k are in; the lanes are done with k - 1
    if (k + 2 < n_tiles) fetch(k + 2);
    if (copier && active && k + 1 < n_tiles) pack(k + 1);
    if (!copier && active) {
      const unsigned* w = words + ((k & 1) * kLanes + r) * kWordRow;
      for (int c0 = 0; c0 < n; c0 += 32) {
        const unsigned bits = w[2 * (c0 >> 5)];
        const unsigned cross = w[2 * (c0 >> 5) + 1];
        const int tc = t0 + c0;
        if (n - c0 >= 32) {
#pragma unroll
          for (int b = 0; b < 32; ++b) {
            s.step(tc + b, (bits >> b) & 1u, (cross >> b) & 1u, codes, orow,
                   cb.ob);
          }
        } else {
          for (int b = 0; b < n - c0; ++b) {
            s.step(tc + b, (bits >> b) & 1u, (cross >> b) & 1u, codes, orow,
                   cb.ob);
          }
        }
      }
    }
    cb.after_tile(k == n_tiles - 1, t0 + n, !copier && active, codes, r,
                  out, lane0, n_active);
  }
}

}  // namespace

// Input rows ``in_stride`` doubles apart, 16-byte aligned with a stride
// that is a multiple of 2 and >= T (lane_tiles_f64.cuh; ops/slicers.py
// binary_slice_f64_lanes pads other rows); params (2, L) rows (sps,
// lock_rate); out (L, ceil(T / window)) int32.
extern "C" int binary_slice_f64_lanes(const double* x, int in_stride,
                                      const double* params, int* out, int L,
                                      int T, int window, void* stream) {
  if (!pymodem::f64::rows_ok(x, in_stride, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      binary_slice_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0 && T > 0) {
    binary_slice_f64_kernel<<<blocks, 2 * kLanes, kSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(
        x, in_stride, params, out, L, T, window);
  }
  return static_cast<int>(cudaGetLastError());
}

// K10's dynamic shared memory a block, bytes
extern "C" int binary_slice_f64_smem_bytes() { return kSmemBytes; }
