// K16: the quadrature (IQ) symbol-timing slicer at float64 over
// (chain x block) lanes.
//
// Replaces the lax.scan pymodem_tpu/ops/slicers.py quadrature_slice
// (reference slicer.py:193-242) on float64 input, which the JAX package
// runs in its float64 parity mode (its Pallas kernel, which K7 replaces,
// runs float32 only).  The plain twin is ops/slicers.py quadrature_slice
// on float64 tensors; the emissions are K7's (slicer_words.cuh).
//
// Per sample, in the twin's order: the phase clock advances by 1; at a
// decision (clock reached sps/2 - 0.5, then rewound by sps) the state
// register becomes ((state << 2) & state_mask) | (I >= 0) << 1 | (Q >= 0),
// the working byte takes demap[state], bps bits at a time, and the bit
// count grows by bps; a byte completes when the count reaches 8 (the count
// resets and the byte keeps its low 8 bits); a zero crossing on either
// rail scales the clock by lock_rate.
//
// What bounds it on an H100: each lane is one sequential recurrence whose
// only float dependency is the f64 clock (add, compare, subtract,
// multiply), and the lanes (944 on the 8-chain PSK banks, one on the
// executor) are the parallelism, so the run time is T times one step's
// latency; 16 bytes in a sample, 4 out a window.  One thread a lane took
// 95.3 ns a step at one lane and 141.7 ns on bank lanes, whose two rows a
// warp read 8 samples at a time, one exposed memory round trip a chunk.
//
// Design (lane_tiles_f64.cuh, slicer_words.cuh; K7's at f64, as K10 is
// K1's): a block serves 32 lanes with one lane thread and one copy thread
// each, and walks time in tiles of 128 samples.  The copy warp brings each
// lane's I and Q tiles into shared memory two tiles ahead (one bulk copy a
// lane and rail; three stages of two rails of 32 rows of 130 doubles,
// 199,680 B), and one tile ahead packs them into bit words: per 32 samples
// the sign bits (x >= 0) of both rails and the OR of their zero-crossing
// flags, with the twin's own predicates on the doubles (a negative
// subnormal is < 0, a NaN crosses nothing and becomes the last sample).
// The lane thread carries only the f64 clock, the state register, the
// byte, the bit count and the window's code, each updated by selects (no
// divergent branch), the demap packed two bits an entry into one register,
// and leaves each window's code in a shared buffer that the block stores
// in coalesced runs.  With the two tiles of words (3,328 B) and the code
// buffer (16,512 B), 219,520 B of dynamic shared memory a block.
// Compare/select/shift and the clock's f64 operations in the twin's order,
// so the output equals the plain twin bitwise.

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
constexpr int kRail = kLanes * kStride;  // doubles of one rail of a stage
// a lane's words of a tile: (I >= 0, Q >= 0, crossing) per 32 samples,
// rows padded to an odd count so the lanes' reads hit distinct banks
constexpr int kWordRow = 3 * (kTile / 32) + 1;
// dynamic shared memory: the tile stages of both rails, two tiles of words
// and the window codes
constexpr int kSmemBytes =
    8 * 2 * kStages * kRail + 4 * kLanes * (2 * kWordRow + kCodeRow);

// bit b of the rails' sign words as the state register's new bits
__device__ __forceinline__ int bits_at(unsigned pi, unsigned pq, int b) {
  return static_cast<int>(((pi >> b) & 1u) << 1 | ((pq >> b) & 1u));
}

struct Slicer {
  double clock = 0.0;
  double sps, lock_rate, rollover;
  int byte = 0, bit_count = 0, state = 0;
  int state_mask, bps;
  unsigned demap;  // entry s (0-3) in bits 2s, 2s + 1

  // One sample at time t: bits = (I >= 0) << 1 | (Q >= 0), cross the zero
  // crossing on either rail.
  __device__ __forceinline__ void step(int t, int bits, bool cross,
                                       Codes& codes, int* orow, int ob) {
    clock = clock + 1.0;
    const bool decide = clock >= rollover;
    const double rewound = clock - sps;
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
    const double locked = clock * lock_rate;
    clock = cross ? locked : clock;
    codes.add(t, emit, byte, orow, ob);
  }
};

// Threads [0, kLanes) are the lanes; threads [kLanes, 2 kLanes) the copy
// warp.  Copy thread r starts lane r's bulk copies and packs lane r's sign
// and crossing words one tile ahead.
__global__ void __launch_bounds__(2 * kLanes, 1)
    quadrature_slice_f64_kernel(const double* __restrict__ i_in,
                                const double* __restrict__ q_in,
                                int in_stride,
                                const double* __restrict__ params,
                                int* __restrict__ out, unsigned demap, int L,
                                int T, int window, int state_mask, int bps) {
  extern __shared__ __align__(16) double smem[];
  __shared__ uint64_t bars[kStages];
  // [stage][rail][lane][kStride] input tiles, [2][lane][kWordRow] words,
  // then the [lane][kCodeRow] window codes
  unsigned* words = reinterpret_cast<unsigned*>(smem + 2 * kStages * kRail);
  const int tid = threadIdx.x;
  const bool copier = tid >= kLanes;
  const int r = copier ? tid - kLanes : tid;  // the lane row this thread serves
  const int lane0 = blockIdx.x * kLanes;
  const int lane = lane0 + r;
  const bool active = lane < L;
  const int n_active = min(kLanes, L - lane0);
  const size_t row = static_cast<size_t>(active ? lane : 0) * in_stride;
  if (tid < kStages) pymodem::mbar_init(&bars[tid]);
  __syncthreads();

  Slicer s;
  s.sps = active ? params[lane] : 0.0;
  s.lock_rate = active ? params[L + lane] : 0.0;
  s.rollover = s.sps / 2.0 - 0.5;
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
    const unsigned bytes = pymodem::f64::tile_bytes(min(kTile, T - t0));
    const int st = k % kStages;
    double* dst = smem + 2 * st * kRail + r * kStride;
    if (tid == kLanes) pymodem::mbar_expect(&bars[st], 2u * bytes * n_active);
    if (copier && active) {
      pymodem::bulk_load(dst, i_in + row + t0, bytes, &bars[st]);
      pymodem::bulk_load(dst + kRail, q_in + row + t0, bytes, &bars[st]);
    }
  };
  // copy thread r: lane r's words of tile k (a crossing on either rail)
  auto pack = [&](int k) {
    const int st = k % kStages;
    pymodem::mbar_wait(&bars[st], (k / kStages) & 1);
    const double* xi = smem + 2 * st * kRail + r * kStride;
    const double* xq = xi + kRail;
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

// I and Q rows ``in_stride`` doubles apart, both 16-byte aligned with a
// stride that is a multiple of 2 and >= T (lane_tiles_f64.cuh;
// ops/slicers.py quadrature_slice_f64_lanes copies other rails into rows
// of one such stride); params (2, L) rows (sps, lock_rate); demap entry s
// (0-3) in bits 2s, 2s + 1; out (L, ceil(T / window)) int32.
extern "C" int quadrature_slice_f64_lanes(const double* i_in,
                                          const double* q_in, int in_stride,
                                          const double* params, int* out,
                                          unsigned demap, int L, int T,
                                          int window, int state_mask, int bps,
                                          void* stream) {
  if (!pymodem::f64::rows_ok(i_in, in_stride, T) ||
      !pymodem::f64::rows_ok(q_in, in_stride, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      quadrature_slice_f64_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0 && T > 0) {
    quadrature_slice_f64_kernel<<<blocks, 2 * kLanes, kSmemBytes,
                                  static_cast<cudaStream_t>(stream)>>>(
        i_in, q_in, in_stride, params, out, demap, L, T, window, state_mask,
        bps);
  }
  return static_cast<int>(cudaGetLastError());
}

// K16's dynamic shared memory a block, bytes
extern "C" int quadrature_slice_f64_smem_bytes() { return kSmemBytes; }
