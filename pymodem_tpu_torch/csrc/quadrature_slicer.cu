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
// Design (lane_tiles.cuh): a block serves 32 lanes with one lane thread
// and one copy thread each, and walks time in tiles of 128 samples.  The
// copy warp brings each tile of I and Q into shared memory two tiles ahead
// (one bulk copy a lane and rail; three stages), and one tile ahead packs
// each
// lane's samples into bit words: per 32 samples the sign bits (x >= 0) of
// both rails and the zero-crossing flags, with the twin's own predicates
// ((last < 0 && x >= 0) || (last >= 0 && x < 0), so a NaN sample crosses
// nothing, and last = 0 before the first sample).  The lane thread then
// carries only the clock, the state register, the byte, the bit count and
// the window's code, each updated by selects (no divergent branch), the
// demap packed two bits an entry into one register.  Each window's code
// goes to a shared buffer that the block stores to device memory in
// coalesced runs when it fills.  Compare/select/shift only, in the JAX op
// order, so the output equals the plain twin (ops/slicers.py
// quadrature_slice) bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tiles.cuh"

namespace {

using pymodem::kLanes;
using pymodem::kStride;
using pymodem::kTile;

constexpr int kStages = 3;  // raw tiles: two in flight, one being packed
constexpr int kTileFloats = kLanes * kStride;  // one rail of a stage
// a lane's words of a tile: (I >= 0, Q >= 0, crossing) per 32 samples,
// rows padded to an odd count so the lanes' reads hit distinct banks
constexpr int kWordRow = 3 * (kTile / 32) + 1;
constexpr int kCodeRow = kTile + 1;  // a lane's window codes

// bit j of the result: element j of the float4 is >= 0 (< 0); NaN is
// neither
__device__ __forceinline__ unsigned ge0(float4 a) {
  return static_cast<unsigned>(a.x >= 0.0f) |
         static_cast<unsigned>(a.y >= 0.0f) << 1 |
         static_cast<unsigned>(a.z >= 0.0f) << 2 |
         static_cast<unsigned>(a.w >= 0.0f) << 3;
}
__device__ __forceinline__ unsigned lt0(float4 a) {
  return static_cast<unsigned>(a.x < 0.0f) |
         static_cast<unsigned>(a.y < 0.0f) << 1 |
         static_cast<unsigned>(a.z < 0.0f) << 2 |
         static_cast<unsigned>(a.w < 0.0f) << 3;
}

// bit b of the rails' sign words as the state register's new bits
__device__ __forceinline__ int bits_at(unsigned pi, unsigned pq, int b) {
  return static_cast<int>(((pi >> b) & 1u) << 1 | ((pq >> b) & 1u));
}

struct Slicer {
  float clock = 0.0f;
  float sps, lock_rate, rollover;
  int byte = 0, bit_count = 0, state = 0, acc = 0;
  int state_mask, bps, wm, wshift;
  unsigned demap;  // entry s (0-3) in bits 2s, 2s + 1

  // One sample at time t: bits = (I >= 0) << 1 | (Q >= 0), cross the zero
  // crossing; a finished window's code goes to orow[window - ob].  Every
  // update is a select, so the warp never diverges and the compiler can
  // overlap one step's byte work with the next step's clock.
  __device__ __forceinline__ void step(int t, int bits, bool cross,
                                       int* orow, int ob) {
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
    const int pos = t & wm;
    acc |= emit ? ((pos << 16) | 0x100 | (byte & 0xFF)) : 0;
    bit_count = emit ? 0 : bit_count;
    byte = emit ? (byte & 0xFF) : byte;
    const float locked = clock * lock_rate;
    clock = cross ? locked : clock;
    const bool done = pos == wm;
    if (done) orow[(t >> wshift) - ob] = acc;
    acc = done ? 0 : acc;
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
  int* obuf = reinterpret_cast<int*>(words + 2 * kLanes * kWordRow);
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
  s.wm = window - 1;
  s.wshift = __ffs(window) - 1;
  s.demap = demap;
  const int n_out = (T + s.wm) >> s.wshift;
  const int per_tile = max(kTile >> s.wshift, 1);  // codes a tile finishes
  int* orow = obuf + r * kCodeRow;
  int ob = 0;  // first window held in obuf
  // the previous sample's predicates, last = 0 before the first
  unsigned carry_pi = 1, carry_ni = 0, carry_pq = 1, carry_nq = 0;

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
  // copy thread r: lane r's words of tile k (its samples in place), with
  // the twin's predicates ((last < 0 && x >= 0) || (last >= 0 && x < 0)
  // on either rail; past the tile's end: unused)
  auto pack = [&](int k) {
    const int st = k % kStages;
    pymodem::mbar_wait(&bars[st], (k / kStages) & 1);
    const float* xi = smem + 2 * st * kTileFloats + r * kStride;
    const float* xq = xi + kTileFloats;
    unsigned* w = words + ((k & 1) * kLanes + r) * kWordRow;
    const int n = min(kTile, T - k * kTile);
    for (int c0 = 0; c0 < n; c0 += 32) {
      unsigned pi = 0, ni = 0, pq = 0, nq = 0;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const float4 a = *reinterpret_cast<const float4*>(xi + c0 + 4 * v);
        const float4 b = *reinterpret_cast<const float4*>(xq + c0 + 4 * v);
        pi |= ge0(a) << (4 * v);
        ni |= lt0(a) << (4 * v);
        pq |= ge0(b) << (4 * v);
        nq |= lt0(b) << (4 * v);
      }
      w[3 * (c0 >> 5)] = pi;
      w[3 * (c0 >> 5) + 1] = pq;
      w[3 * (c0 >> 5) + 2] = (((ni << 1) | carry_ni) & pi) |
                             (((pi << 1) | carry_pi) & ni) |
                             (((nq << 1) | carry_nq) & pq) |
                             (((pq << 1) | carry_pq) & nq);
      carry_pi = pi >> 31;
      carry_ni = ni >> 31;
      carry_pq = pq >> 31;
      carry_nq = nq >> 31;
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
            s.step(tc + b, bits_at(pi, pq, b), (cross >> b) & 1u, orow, ob);
          }
        } else {
          for (int b = 0; b < n - c0; ++b) {
            s.step(tc + b, bits_at(pi, pq, b), (cross >> b) & 1u, orow, ob);
          }
        }
      }
    }
    // store the finished codes when the buffer could not take another tile
    const bool last = k == n_tiles - 1;
    const int done = last ? n_out : (t0 + n) >> s.wshift;
    if (last || done - ob + per_tile > kTile) {
      if (last && !copier && active && (T & s.wm) != 0) {
        orow[n_out - 1 - ob] = s.acc;
      }
      __syncthreads();
      const int cnt = done - ob;
      for (int row = tid >> 5; row < n_active; row += blockDim.x >> 5) {
        int* dst = out + static_cast<size_t>(lane0 + row) * n_out + ob;
        const int* src = obuf + row * kCodeRow;
        for (int c = tid & 31; c < cnt; c += 32) dst[c] = src[c];
      }
      ob = done;
    }
  }
}

}  // namespace

// Input rows ``in_stride`` floats apart, 16-byte aligned with a stride
// that is a multiple of 4 and >= T (lane_tiles.cuh; ops/slicers.py
// quadrature_slice_lanes pads other rows).
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
