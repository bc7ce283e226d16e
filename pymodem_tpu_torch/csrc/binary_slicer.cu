// K1: the binary symbol-timing slicer over (chain x block) lanes.
//
// Replaces the Pallas TPU kernel pymodem_tpu/ops/pallas_slicers.py
// _binary_kernel (binary_slice_lanes_pallas), itself the lane form of the
// scan pymodem_tpu/ops/slicers.py binary_slice (reference slicer.py:59-107).
//
// Per sample: the phase clock advances by 1; at a decision (clock reached
// sps/2 - 0.5, then rewound by sps) the byte takes the bit x >= 0; a byte
// completes every 8 decisions; a zero crossing scales the clock by
// lock_rate.  Emissions (slicer_words.cuh): 0x100 | byte per sample, or one
// (pos << 16) | 0x100 | byte per window.
//
// What bounds it on an H100: each lane is one strictly sequential
// recurrence, and the lane count (2624 on the 64-chain AFSK sweep, 3456 on
// the FSK-9600 sweep) sets the parallelism, so the run time is T times the
// per-step time of one warp.  The only float dependency from step to step
// is the clock (add, compare, subtract, multiply); 4 bytes in per sample,
// 4 out per window.
//
// Design (lane_tiles.cuh, slicer_words.cuh; K7's with one rail): a block
// serves 32 lanes with one lane thread and one copy thread each, and walks
// time in tiles of 128 samples.  The copy warp brings each lane's tiles
// into shared memory two tiles ahead (one bulk copy a lane and tile; three
// stages), and one tile ahead packs them into bit words: per 32 samples
// the sign bits (x >= 0) and the zero-crossing flags, with the twin's own
// predicates.  The lane thread carries only the clock, the byte, the bit
// count and the window's code, each updated by selects (no divergent
// branch), and leaves each window's code in a shared buffer that the block
// stores in coalesced runs.  Compare/select/shift only, in the JAX op
// order, so the output equals the plain twin (ops/slicers.py binary_slice)
// bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "slicer_words.cuh"

namespace {

using pymodem::Codes;
using pymodem::kCodeRow;
using pymodem::kLanes;
using pymodem::kStride;
using pymodem::kTile;

constexpr int kStages = 3;  // raw tiles: two in flight, one being packed
constexpr int kTileFloats = kLanes * kStride;  // a stage
// a lane's words of a tile: (x >= 0, crossing) per 32 samples, rows padded
// to an odd count so the lanes' reads hit distinct banks
constexpr int kWordRow = 2 * (kTile / 32) + 1;

struct Slicer {
  float clock = 0.0f;
  float sps, lock_rate, rollover;
  int byte = 0, bit_count = 0;

  // One sample at time t: bit = x >= 0, cross the zero crossing.
  __device__ __forceinline__ void step(int t, int bit, bool cross,
                                       Codes& codes, int* orow, int ob) {
    clock = clock + 1.0f;
    const bool decide = clock >= rollover;
    const float rewound = clock - sps;
    clock = decide ? rewound : clock;
    const int shifted = ((byte << 1) & 0xFF) | bit;
    byte = decide ? shifted : byte;
    bit_count += decide;
    // bit_count only reaches 8 on a decision and resets there
    const bool emit = bit_count >= 8;
    bit_count = emit ? 0 : bit_count;
    const float locked = clock * lock_rate;
    clock = cross ? locked : clock;
    codes.add(t, emit, byte, orow, ob);
  }
};

// Threads [0, kLanes) are the lanes; threads [kLanes, 2 kLanes) the copy
// warp.  Copy thread r starts lane r's bulk copies and packs lane r's sign
// and crossing words one tile ahead.
__global__ void __launch_bounds__(2 * kLanes, 1)
    binary_slice_kernel(const float* __restrict__ x, int in_stride,
                        const float* __restrict__ params,
                        int* __restrict__ out, int L, int T, int window) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bars[kStages];
  // [stage][lane][kStride] input tiles, [2][lane][kWordRow] words, then
  // the [lane][kCodeRow] window codes
  unsigned* words = reinterpret_cast<unsigned*>(smem + kStages * kTileFloats);
  const int tid = threadIdx.x;
  const bool copier = tid >= kLanes;
  const int r = copier ? tid - kLanes : tid;  // the lane row this thread serves
  const int lane0 = blockIdx.x * kLanes;
  const int lane = lane0 + r;
  const bool active = lane < L;
  const int n_active = min(kLanes, L - lane0);
  const float* row = x + static_cast<size_t>(active ? lane : 0) * in_stride;
  if (tid < kStages) pymodem::mbar_init(&bars[tid]);
  __syncthreads();

  Slicer s;
  s.sps = active ? params[lane] : 0.0f;
  s.lock_rate = active ? params[L + lane] : 0.0f;
  s.rollover = s.sps / 2.0f - 0.5f;
  Codes codes = pymodem::codes_for(window);
  pymodem::CodeBuffer cb = pymodem::code_buffer(
      reinterpret_cast<int*>(words + 2 * kLanes * kWordRow), window, T);
  int* orow = cb.row(r);
  pymodem::Crossings crossings;

  // tile k goes to stage k % kStages by one bulk copy a lane from the copy
  // warp, completing on the stage's barrier
  auto fetch = [&](int k) {
    const int t0 = k * kTile;
    const unsigned bytes = 4u * pymodem::padded4(min(kTile, T - t0));
    const int st = k % kStages;
    if (tid == kLanes) pymodem::mbar_expect(&bars[st], bytes * n_active);
    if (copier && active) {
      pymodem::bulk_load(smem + st * kTileFloats + r * kStride, row + t0,
                         bytes, &bars[st]);
    }
  };
  // copy thread r: lane r's words of tile k
  auto pack = [&](int k) {
    const int st = k % kStages;
    pymodem::mbar_wait(&bars[st], (k / kStages) & 1);
    const float* xr = smem + st * kTileFloats + r * kStride;
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

// Input rows ``in_stride`` floats apart, 16-byte aligned with a stride
// that is a multiple of 4 and >= T (lane_tiles.cuh; ops/slicers.py
// binary_slice_lanes pads other rows).
extern "C" int binary_slice_lanes(const float* x, int in_stride,
                                  const float* params, int* out, int L, int T,
                                  int window, void* stream) {
  if (!pymodem::rows_ok(x, in_stride, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the tile stages, two tiles of words and the window codes
  const size_t smem = sizeof(float) * (kStages * kTileFloats +
                                       kLanes * (2 * kWordRow + kCodeRow));
  cudaError_t err = cudaFuncSetAttribute(
      binary_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0) {
    binary_slice_kernel<<<blocks, 2 * kLanes, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        x, in_stride, params, out, L, T, window);
  }
  return static_cast<int>(cudaGetLastError());
}
