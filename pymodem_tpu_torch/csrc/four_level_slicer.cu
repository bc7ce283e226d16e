// K8: the four-level (4FSK) symbol-timing slicer over (chain x block) lanes.
//
// Replaces the Pallas TPU kernel pymodem_tpu/ops/pallas_slicers.py
// _four_level_kernel (four_level_slice_lanes_pallas), itself the lane form
// of the scan pymodem_tpu/ops/slicers.py four_level_slice, the fix-forward
// form of the reference slicer.py:329-441.
//
// Per sample: clock 1 advances by 1; when it passes sps/2 - 0.5 (strictly)
// it rewinds by sps, the ring index advances (mod 8), |x| * 2 / 3 goes into
// that slot of the 8-deep ring and (x > 0) into the 16-bit sync register.
// On a sync pattern (0x5555 or 0xCCCC) the threshold becomes the ring's
// mean and clock 2 takes clock 1's value.  Clock 2 then advances and, when
// it rolls over, decides the symbol (3 / 2 for x > 0 at / below the
// threshold, 0 / 1 for x <= 0 at / above its negative), shifting
// demap[symbol] into the byte, 2 bits at a time.  A zero crossing scales
// clock 1 by lock_rate.  Emissions (slicer_words.cuh): 0x100 | byte per
// sample, or one (pos << 16) | 0x100 | byte per window.
//
// What bounds it on an H100: like K1 and K7, each lane is one strictly
// sequential recurrence, and the lane count (~1200 on the 4FSK bank) sets
// the parallelism, so the run time is T times the per-step time of one
// warp; 4 bytes in per sample, 4 out per window.  The dependent chain runs
// through both clocks (clock 1 -> roll -> sync register -> sync compare ->
// clock 2 -> roll).  The ring's values |x| * 2 / 3 are IEEE-rounded
// divides, each behind a branch to its slow path: on one warp they would
// cost more than the whole recurrence.
//
// Design (lane_tiles.cuh, slicer_words.cuh, as K1 and K7): a block serves
// 32 lanes with a lane warp, a copy warp and four value warps, and walks
// time in tiles of 128 samples.  The copy warp brings each lane's tiles
// into shared memory two tiles ahead (one bulk copy a lane and tile; three
// stages) and one tile ahead packs each lane's x > 0 and zero-crossing
// words (the twin's predicates).  One tile ahead too, the value warps form
// |x| * 2 / 3 for every sample into a second rail (value thread (g, l) the
// columns [32 g, 32 g + 32) of lane l), so no divide is on the lane warp.
// The lane thread carries the clocks, the ring slot, the sync register,
// the threshold, the byte, the bit count and the window's code, each
// updated by selects, with no branch in a step, so the compiler overlaps
// one step's byte work with the next steps' clocks.  The ring is a row of
// shared memory a lane: every step stores its value, to the new slot on a
// rollover and else to the row's padding, and reads the row back by two
// 16-byte loads for the sum r0 + r1 + ... + r7 (the scan's order), which a
// sync hit makes the threshold.  A predicated store, a plain ?: on the
// threshold or a short-circuit && in the sync test let the compiler move
// the loads and the sum into a branch on the lane's rollover, where the
// warp waited for them in almost every step (one lane of 32 or more rolls
// over).  What limits the kernel is that sum: store, loads and 7 dependent
// adds a step, whose latency the warp's in-order issue exposes (PERF.md).
// The lane reads x itself only for the symbol decision, which feeds the
// byte and no clock.  Window codes
// leave through the shared buffer in coalesced runs.  Built with
// -fmad=false and without fast math, so the output equals the plain twin
// (ops/slicers.py four_level_slice) bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "slicer_words.cuh"

namespace {

using pymodem::Codes;
using pymodem::kCodeRow;
using pymodem::kLanes;
using pymodem::kStride;
using pymodem::kTile;

constexpr int kDepth = 8;   // the threshold ring
// a lane's ring row: 8 slots padded to 12 floats, so the 16-byte loads of
// a quarter warp hit 8 distinct groups of 4 banks; slot kDepth takes the
// stores of the steps that do not roll over
constexpr int kRingRow = 12;

// p ? a : b as one PTX select, so that the compiler cannot move the work
// that forms a or b into a branch on p
__device__ __forceinline__ float select_f32(bool p, float a, float b) {
  float out;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %1, 0;\n"
      " selp.f32 %0, %2, %3, q;\n}\n"
      : "=f"(out)
      : "r"(static_cast<unsigned>(p)), "f"(a), "f"(b));
  return out;
}
constexpr int kStages = 3;  // raw tiles: two in flight, one being packed
constexpr int kValueWarps = 4;
constexpr int kThreads = (2 + kValueWarps) * kLanes;
constexpr int kTileFloats = kLanes * kStride;  // a stage, a value tile
// a lane's words of a tile: (x > 0, crossing) per 32 samples, rows padded
// to an odd count so the lanes' reads hit distinct banks
constexpr int kWordRow = 2 * (kTile / 32) + 1;

struct Slicer {
  float clock1 = 0.0f, clock2 = 0.0f, threshold = 0.0f;
  float sps, lock_rate, rollover;
  int byte = 0, bit_count = 0, sync = 0;
  int slot = 0;  // the ring index
  int d0, d1, d2, d3;  // the demap
  float* ring;  // the lane's ring row (16-byte aligned)

  // One sample at time t: x, its ring value v = |x| * 2 / 3, pos = x > 0,
  // cross the zero crossing.  Every update is a select.
  __device__ __forceinline__ void step(int t, float x, float v, int pos,
                                       bool cross, Codes& codes, int* orow,
                                       int ob) {
    clock1 = clock1 + 1.0f;
    const bool roll1 = clock1 > rollover;
    const float rewound1 = clock1 - sps;
    clock1 = roll1 ? rewound1 : clock1;
    const int next = (slot + 1) & (kDepth - 1);
    slot = roll1 ? next : slot;
    ring[roll1 ? slot : kDepth] = v;
    const int shifted = ((sync << 1) & 0xFFFF) + pos;
    sync = roll1 ? shifted : sync;
    // & and |, not && and ||: the compiler makes branches of those
    const bool hit = roll1 & ((sync == 0x5555) | (sync == 0xCCCC));
    const float4 lo = *reinterpret_cast<const float4*>(ring);
    const float4 hi = *reinterpret_cast<const float4*>(ring + 4);
    const float sum =
        lo.x + lo.y + lo.z + lo.w + hi.x + hi.y + hi.z + hi.w;
    // * 0.125f is / 8 exactly (a power of two)
    threshold = select_f32(hit, sum * 0.125f, threshold);
    clock2 = (hit ? clock1 : clock2) + 1.0f;
    const bool roll2 = clock2 > rollover;
    const float rewound2 = clock2 - sps;
    clock2 = roll2 ? rewound2 : clock2;
    const int bits = pos ? (x >= threshold ? d3 : d2)
                         : (x <= -threshold ? d0 : d1);
    const int shifted_byte = ((byte << 2) & 0xFF) + bits;
    byte = roll2 ? shifted_byte : byte;
    bit_count = roll2 ? bit_count + 2 : bit_count;
    // bit_count only reaches 8 on a decision and resets there
    const bool emit = bit_count >= 8;
    bit_count = emit ? 0 : bit_count;
    const float locked = clock1 * lock_rate;
    clock1 = cross ? locked : clock1;
    codes.add(t, emit, byte, orow, ob);
  }
};

// Warp 0 is the lanes, warp 1 the copy warp (it starts its lane's bulk
// copies and packs its words), warps 2.. the value warps.
__global__ void __launch_bounds__(kThreads, 1)
    four_level_slice_kernel(const float* __restrict__ x, int in_stride,
                            const float* __restrict__ params,
                            int* __restrict__ out, int d0, int d1, int d2,
                            int d3, int L, int T, int window) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bars[kStages];
  __shared__ __align__(16) float rings[kLanes * kRingRow];
  // [stage][lane][kStride] input tiles, [2][lane][kStride] values,
  // [2][lane][kWordRow] words, then the [lane][kCodeRow] window codes
  float* values = smem + kStages * kTileFloats;
  unsigned* words = reinterpret_cast<unsigned*>(values + 2 * kTileFloats);
  const int tid = threadIdx.x;
  const int warp = tid / kLanes;
  const int r = tid % kLanes;  // the lane row this thread serves
  const int lane0 = blockIdx.x * kLanes;
  const int lane = lane0 + r;
  const bool active = lane < L;
  const int n_active = min(kLanes, L - lane0);
  const float* row = x + static_cast<size_t>(active ? lane : 0) * in_stride;
  if (tid < kStages) pymodem::mbar_init(&bars[tid]);
  if (warp == 0) {
    for (int d = 0; d < kDepth; ++d) rings[r * kRingRow + d] = 0.0f;
  }
  __syncthreads();

  Slicer s;
  s.sps = active ? params[lane] : 0.0f;
  s.lock_rate = active ? params[L + lane] : 0.0f;
  s.rollover = s.sps / 2.0f - 0.5f;
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
  auto tile_row = [&](int k) {
    return smem + (k % kStages) * kTileFloats + r * kStride;
  };

  // copy warp: tile k to stage k % kStages by one bulk copy a lane,
  // completing on the stage's barrier
  auto fetch = [&](int k) {
    const unsigned bytes = 4u * pymodem::padded4(tile_n(k));
    uint64_t* bar = &bars[k % kStages];
    if (r == 0) pymodem::mbar_expect(bar, bytes * n_active);
    if (active) pymodem::bulk_load(tile_row(k), row + k * kTile, bytes, bar);
  };
  // copy warp: lane r's words of tile k
  auto pack = [&](int k) {
    pymodem::mbar_wait(&bars[k % kStages], (k / kStages) & 1);
    const float* xr = tile_row(k);
    unsigned* w = words + ((k & 1) * kLanes + r) * kWordRow;
    for (int c0 = 0; c0 < tile_n(k); c0 += 32) {
      const pymodem::Signs sg = pymodem::signs32<true>(xr + c0);
      w[2 * (c0 >> 5)] = sg.gt;
      w[2 * (c0 >> 5) + 1] = crossings.next(sg);
    }
  };
  // value warp g: |x| * 2 / 3 over its 32 columns of lane r's tile k (the
  // scan's op order, each rounded)
  auto form_values = [&](int k, int g) {
    pymodem::mbar_wait(&bars[k % kStages], (k / kStages) & 1);
    const float* xr = tile_row(k);
    float* vr = values + (k & 1) * kTileFloats + r * kStride;
    const int end = min(32 * (g + 1), tile_n(k));
    for (int c = 32 * g; c < end; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(xr + c);
      *reinterpret_cast<float4*>(vr + c) = make_float4(
          fabsf(a.x) * 2.0f / 3.0f, fabsf(a.y) * 2.0f / 3.0f,
          fabsf(a.z) * 2.0f / 3.0f, fabsf(a.w) * 2.0f / 3.0f);
    }
  };
  // lane warp: tile k, four steps a float4 of x and of the values
  auto run = [&](int k) {
    pymodem::mbar_wait(&bars[k % kStages], (k / kStages) & 1);
    const float* xr = tile_row(k);
    const float* vr = values + (k & 1) * kTileFloats + r * kStride;
    const unsigned* w = words + ((k & 1) * kLanes + r) * kWordRow;
    const int n = tile_n(k);
    for (int c0 = 0; c0 < n; c0 += 32) {
      const unsigned pos = w[2 * (c0 >> 5)];
      const unsigned cross = w[2 * (c0 >> 5) + 1];
      const int tc = k * kTile + c0;
      if (n - c0 >= 32) {
#pragma unroll
        for (int q = 0; q < 32; q += 4) {
          const float4 a = *reinterpret_cast<const float4*>(xr + c0 + q);
          const float4 v = *reinterpret_cast<const float4*>(vr + c0 + q);
          s.step(tc + q, a.x, v.x, (pos >> q) & 1u, (cross >> q) & 1u, codes,
                 orow, cb.ob);
          s.step(tc + q + 1, a.y, v.y, (pos >> (q + 1)) & 1u,
                 (cross >> (q + 1)) & 1u, codes, orow, cb.ob);
          s.step(tc + q + 2, a.z, v.z, (pos >> (q + 2)) & 1u,
                 (cross >> (q + 2)) & 1u, codes, orow, cb.ob);
          s.step(tc + q + 3, a.w, v.w, (pos >> (q + 3)) & 1u,
                 (cross >> (q + 3)) & 1u, codes, orow, cb.ob);
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

// Input rows ``in_stride`` floats apart, 16-byte aligned with a stride
// that is a multiple of 4 and >= T (lane_tiles.cuh; ops/slicers.py
// four_level_slice_lanes pads other rows).
extern "C" int four_level_slice_lanes(const float* x, int in_stride,
                                      const float* params, int* out, int d0,
                                      int d1, int d2, int d3, int L, int T,
                                      int window, void* stream) {
  if (!pymodem::rows_ok(x, in_stride, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the tile stages, two tiles of values and of words, the window codes
  const size_t smem =
      sizeof(float) * ((kStages + 2) * kTileFloats +
                       kLanes * (2 * kWordRow + kCodeRow));
  cudaError_t err = cudaFuncSetAttribute(
      four_level_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0) {
    four_level_slice_kernel<<<blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        x, in_stride, params, out, d0, d1, d2, d3, L, T, window);
  }
  return static_cast<int>(cudaGetLastError());
}
