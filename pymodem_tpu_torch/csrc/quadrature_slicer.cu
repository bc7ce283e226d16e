// K7: the quadrature (IQ) symbol-timing slicer over (chain x block) lanes.
//
// Replaces the Pallas TPU kernel pymodem_tpu/ops/pallas_slicers.py
// _quad_kernel (quadrature_slice_lanes_pallas), itself the lane form of
// the scan pymodem_tpu/ops/slicers.py quadrature_slice (reference
// slicer.py:193-242).
//
// Per sample: the phase clock advances by 1; at a decision (clock crossed
// sps/2 - 0.5, then rewound by sps) the state register becomes
// ((state << 2) & state_mask) | (I >= 0) << 1 | (Q >= 0) and the working
// byte takes demap[state], bps bits at a time; a zero crossing on either
// rail scales the clock by lock_rate.  Emissions are K1's encoding
// (binary_slicer.cu): 0x100 | byte per sample, or one
// (pos << 16) | 0x100 | byte per window.
//
// What bounds it on an H100: each lane is one strictly sequential
// recurrence, and the lane count (~950 on the QPSK banks) sets the
// parallelism, so the run time is T times the per-step time of one warp.
// The only float dependency from step to step is the clock (add, compare,
// subtract, multiply); 8 bytes in per sample, 4 out per window.
//
// Design (lane_tiles.cuh, slicer_words.cuh, shared with K1 and K8): a
// block serves 32 lanes with one lane thread and one copy thread each, and
// walks time in tiles of 128 samples.  The copy warp brings each tile of I
// and Q into shared memory two tiles ahead (one bulk copy a lane and rail;
// three stages), and one tile ahead packs each lane's samples into bit
// words: per 32 samples the sign bits (x >= 0) of both rails and the
// zero-crossing flags, with the twin's own predicates.  The lane thread
// then carries only the clock, the state register, the byte, the bit count
// and the window's code, each updated by selects (no divergent branch), the
// demap packed two bits an entry into one register.  Each window's code
// goes to a shared buffer that the block stores to device memory in
// coalesced runs when it fills.  Compare/select/shift only, in the JAX op
// order, so the output equals the plain twin (ops/slicers.py
// quadrature_slice) bitwise.

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
constexpr int kTileFloats = kLanes * kStride;  // one rail of a stage
// a lane's words of a tile: (I >= 0, Q >= 0, crossing) per 32 samples,
// rows padded to an odd count so the lanes' reads hit distinct banks
constexpr int kWordRow = 3 * (kTile / 32) + 1;

// bit b of the rails' sign words as the state register's new bits
__device__ __forceinline__ int bits_at(unsigned pi, unsigned pq, int b) {
  return static_cast<int>(((pi >> b) & 1u) << 1 | ((pq >> b) & 1u));
}

struct Slicer {
  float clock = 0.0f;
  float sps, lock_rate, rollover;
  int byte = 0, bit_count = 0, state = 0;
  int state_mask, bps;
  unsigned demap;  // entry s (0-3) in bits 2s, 2s + 1

  // One sample at time t: bits = (I >= 0) << 1 | (Q >= 0), cross the zero
  // crossing.  Every update is a select, so the warp never diverges and
  // the compiler can overlap one step's byte work with the next step's
  // clock.
  __device__ __forceinline__ void step(int t, int bits, bool cross,
                                       Codes& codes, int* orow, int ob) {
    clock = clock + 1.0f;
    const bool decide = clock >= rollover;
    const float rewound = clock - sps;
    clock = decide ? rewound : clock;
    const int next = ((state << 2) & state_mask) | bits;
    state = decide ? next : state;
    const int shifted =
        (byte << bps) | static_cast<int>((demap >> (2 * state)) & 3u);
    byte = decide ? shifted : byte;
    bit_count = decide ? bit_count + bps : bit_count;
    // bit_count only reaches 8 on a decision and resets there
    const bool emit = bit_count >= 8;
    bit_count = emit ? 0 : bit_count;
    byte = emit ? (byte & 0xFF) : byte;
    const float locked = clock * lock_rate;
    clock = cross ? locked : clock;
    codes.add(t, emit, byte, orow, ob);
  }
};

// Threads [0, kLanes) are the lanes; threads [kLanes, 2 kLanes) the copy
// warp.  Copy thread r starts lane r's bulk copies and packs lane r's sign
// and crossing words one tile ahead, so the lanes run the clock and
// nothing else.
__global__ void __launch_bounds__(2 * kLanes, 1)
    quadrature_slice_kernel(const float* __restrict__ i_in,
                            const float* __restrict__ q_in, int in_stride,
                            const float* __restrict__ params,
                            int* __restrict__ out, unsigned demap, int L,
                            int T, int window, int state_mask, int bps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ const float* i_rows[kLanes];
  __shared__ const float* q_rows[kLanes];
  __shared__ uint64_t bars[kStages];
  // [stage][rail][lane][kStride] input tiles, [2][lane][kWordRow] words,
  // then the [lane][kCodeRow] window codes
  unsigned* words =
      reinterpret_cast<unsigned*>(smem + 2 * kStages * kTileFloats);
  const int tid = threadIdx.x;
  const bool copier = tid >= kLanes;
  const int r = copier ? tid - kLanes : tid;  // the lane row this thread serves
  const int lane0 = blockIdx.x * kLanes;
  const int lane = lane0 + r;
  const bool active = lane < L;
  const int n_active = min(kLanes, L - lane0);
  if (!copier) {
    i_rows[r] = i_in + static_cast<size_t>(active ? lane : 0) * in_stride;
    q_rows[r] = q_in + static_cast<size_t>(active ? lane : 0) * in_stride;
  }
  if (tid < kStages) pymodem::mbar_init(&bars[tid]);
  __syncthreads();

  Slicer s;
  s.sps = active ? params[lane] : 0.0f;
  s.lock_rate = active ? params[L + lane] : 0.0f;
  s.rollover = s.sps / 2.0f - 0.5f;
  s.state_mask = state_mask;
  s.bps = bps;
  s.demap = demap;
  Codes codes = pymodem::codes_for(window);
  pymodem::CodeBuffer cb = pymodem::code_buffer(
      reinterpret_cast<int*>(words + 2 * kLanes * kWordRow), window, T);
  int* orow = cb.row(r);
  pymodem::Crossings ci, cq;

  // tile k goes to stage k % kStages by one bulk copy a lane and rail from
  // the copy warp, completing on the stage's barrier
  auto fetch = [&](int k) {
    const int t0 = k * kTile;
    const unsigned bytes = 4u * pymodem::padded4(min(kTile, T - t0));
    const int st = k % kStages;
    float* dst = smem + 2 * st * kTileFloats;
    if (tid == kLanes) pymodem::mbar_expect(&bars[st], 2u * bytes * n_active);
    if (copier && active) {
      pymodem::bulk_load(dst + r * kStride, i_rows[r] + t0, bytes,
                         &bars[st]);
      pymodem::bulk_load(dst + kTileFloats + r * kStride, q_rows[r] + t0,
                         bytes, &bars[st]);
    }
  };
  // copy thread r: lane r's words of tile k (a crossing on either rail)
  auto pack = [&](int k) {
    const int st = k % kStages;
    pymodem::mbar_wait(&bars[st], (k / kStages) & 1);
    const float* xi = smem + 2 * st * kTileFloats + r * kStride;
    const float* xq = xi + kTileFloats;
    unsigned* w = words + ((k & 1) * kLanes + r) * kWordRow;
    const int n = min(kTile, T - k * kTile);
    for (int c0 = 0; c0 < n; c0 += 32) {
      const pymodem::Signs si = pymodem::signs32<false>(xi + c0);
      const pymodem::Signs sq = pymodem::signs32<false>(xq + c0);
      w[3 * (c0 >> 5)] = si.ge;
      w[3 * (c0 >> 5) + 1] = sq.ge;
      w[3 * (c0 >> 5) + 2] = ci.next(si) | cq.next(sq);
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
        const unsigned pi = w[3 * (c0 >> 5)];
        const unsigned pq = w[3 * (c0 >> 5) + 1];
        const unsigned cross = w[3 * (c0 >> 5) + 2];
        const int tc = t0 + c0;
        if (n - c0 >= 32) {
#pragma unroll
          for (int b = 0; b < 32; ++b) {
            s.step(tc + b, bits_at(pi, pq, b), (cross >> b) & 1u, codes,
                   orow, cb.ob);
          }
        } else {
          for (int b = 0; b < n - c0; ++b) {
            s.step(tc + b, bits_at(pi, pq, b), (cross >> b) & 1u, codes,
                   orow, cb.ob);
          }
        }
      }
    }
    cb.after_tile(k == n_tiles - 1, t0 + n, !copier && active, codes, r,
                  out, lane0, n_active);
  }
}

}  // namespace

// I and Q rows ``in_stride`` floats apart, both 16-byte aligned with a
// stride that is a multiple of 4 and >= T (lane_tiles.cuh; ops/slicers.py
// quadrature_slice_lanes copies other rails into rows of one such stride).
extern "C" int quadrature_slice_lanes(const float* i_in, const float* q_in,
                                      int in_stride, const float* params,
                                      int* out, unsigned demap, int L, int T,
                                      int window, int state_mask, int bps,
                                      void* stream) {
  if (!pymodem::rows_ok(i_in, in_stride, T) ||
      !pymodem::rows_ok(q_in, in_stride, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the I and Q tile stages, two tiles of words and the window codes
  const size_t smem =
      sizeof(float) * (2 * kStages * kTileFloats +
                       kLanes * (2 * kWordRow + kCodeRow));
  cudaError_t err = cudaFuncSetAttribute(
      quadrature_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0) {
    quadrature_slice_kernel<<<blocks, 2 * kLanes, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        i_in, q_in, in_stride, params, out, demap, L, T, window, state_mask,
        bps);
  }
  return static_cast<int>(cudaGetLastError());
}
