// The pieces that the staged symbol-timing slicers K1, K7, K8, K10, K12 and
// K16 (binary_slicer.cu, quadrature_slicer.cu, four_level_slicer.cu,
// binary_slicer_f64.cu, four_level_slicer_f64.cu, quadrature_slicer_f64.cu)
// share on top of lane_tiles.cuh: the bit words their copy warps pack one
// tile ahead of the lanes, and the window codes the lanes leave in a shared
// buffer for the block to store in coalesced runs.
//
// Bit words: per 32 samples of a rail, bit b of a word is a predicate of
// sample b, formed as the plain twins (ops/slicers.py) form it: x >= 0,
// x < 0, x > 0, and the zero crossing
// (last < 0 && x >= 0) || (last >= 0 && x < 0), with last = 0 before a
// row's first sample.  A NaN sample is none of >= 0, < 0 and > 0, so it
// crosses nothing and decides 0; -0.0 is >= 0 and not > 0.
//
// Window codes (the emission encoding of ops/slicers.py): with a window of
// w samples (a power of two <= 256), each window's single emission as
// (pos << 16) | 0x100 | byte, 0 for none; at w == 1 the dense
// 0x100 | byte stream.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tiles.cuh"

namespace pymodem {

// bit j of the result: element j of the float4 is >= 0 (< 0, > 0)
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
__device__ __forceinline__ unsigned gt0(float4 a) {
  return static_cast<unsigned>(a.x > 0.0f) |
         static_cast<unsigned>(a.y > 0.0f) << 1 |
         static_cast<unsigned>(a.z > 0.0f) << 2 |
         static_cast<unsigned>(a.w > 0.0f) << 3;
}

// the same over a double2 (bits 0 and 1), for the float64 slicers K10, K12
// and K16: the predicates on the doubles themselves, so a negative subnormal
// is < 0
__device__ __forceinline__ unsigned ge0(double2 a) {
  return static_cast<unsigned>(a.x >= 0.0) |
         static_cast<unsigned>(a.y >= 0.0) << 1;
}
__device__ __forceinline__ unsigned lt0(double2 a) {
  return static_cast<unsigned>(a.x < 0.0) |
         static_cast<unsigned>(a.y < 0.0) << 1;
}
__device__ __forceinline__ unsigned gt0(double2 a) {
  return static_cast<unsigned>(a.x > 0.0) |
         static_cast<unsigned>(a.y > 0.0) << 1;
}

// the sign words of 32 samples
struct Signs {
  unsigned ge = 0, lt = 0, gt = 0;
};

// Signs of the 32 samples at x (16-byte aligned shared memory); the x > 0
// word only with kGt.  Past the end of a tile the bits are never read.
template <bool kGt>
__device__ __forceinline__ Signs signs32(const float* x) {
  Signs s;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const float4 a = *reinterpret_cast<const float4*>(x + 4 * v);
    s.ge |= ge0(a) << (4 * v);
    s.lt |= lt0(a) << (4 * v);
    if (kGt) s.gt |= gt0(a) << (4 * v);
  }
  return s;
}

// Signs of the 32 doubles at x (16-byte aligned shared memory).
template <bool kGt>
__device__ __forceinline__ Signs signs32(const double* x) {
  Signs s;
#pragma unroll
  for (int v = 0; v < 16; ++v) {
    const double2 a = *reinterpret_cast<const double2*>(x + 2 * v);
    s.ge |= ge0(a) << (2 * v);
    s.lt |= lt0(a) << (2 * v);
    if (kGt) s.gt |= gt0(a) << (2 * v);
  }
  return s;
}

// A rail's zero-crossing words, 32 samples at a time in time order: the
// previous sample's predicates carry from word to word.
struct Crossings {
  unsigned ge = 1, lt = 0;  // last = 0 before the first sample

  __device__ __forceinline__ unsigned next(const Signs& s) {
    const unsigned cross =
        (((s.lt << 1) | lt) & s.ge) | (((s.ge << 1) | ge) & s.lt);
    ge = s.ge >> 31;
    lt = s.lt >> 31;
    return cross;
  }
};

constexpr int kCodeRow = kTile + 1;  // a lane's row of the code buffer

// A lane's window codes (``codes_for``): ``add`` takes each sample's
// emission in time order and leaves each finished window's code in the
// lane's buffer row at (window - ob), ob the first window the buffer
// holds.  Selects and a predicated store, no branch.
struct Codes {
  int acc;
  int wm, wshift;

  __device__ __forceinline__ void add(int t, bool emit, int byte, int* orow,
                                      int ob) {
    const int pos = t & wm;
    acc |= emit ? ((pos << 16) | 0x100 | byte) : 0;
    const bool done = pos == wm;
    if (done) orow[(t >> wshift) - ob] = acc;
    acc = done ? 0 : acc;
  }
};

__device__ __forceinline__ Codes codes_for(int window) {
  Codes c;
  c.acc = 0;
  c.wm = window - 1;
  c.wshift = __ffs(window) - 1;
  return c;
}

// The block's code buffer (``code_buffer``): kLanes rows of kCodeRow ints
// in shared memory, stored to the (L, n_out) output in coalesced runs
// whenever it could not take another tile's codes, and after the last
// tile.
struct CodeBuffer {
  int* buf;
  int n_out, wshift;
  int per_tile;  // codes a tile of kTile finishes, at least 1 (K12's
                 // 64-sample tiles finish no more)
  int ob;        // first window the buffer holds

  __device__ int* row(int r) const { return buf + r * kCodeRow; }

  // Every thread of the block, after the lanes ran the tile that ends at
  // sample t_end (``last``: the row's last tile).  A lane thread (``lane``)
  // adds the code of an unfinished last window (T % window != 0) from
  // ``codes``; then the block stores the finished codes if it must.
  __device__ __forceinline__ void after_tile(bool last, int t_end, bool lane,
                                             const Codes& codes, int r,
                                             int* out, int lane0,
                                             int n_active) {
    const int done = last ? n_out : t_end >> wshift;
    if (!last && done - ob + per_tile <= kTile) return;
    if (last && lane && (t_end & codes.wm) != 0) {
      row(r)[n_out - 1 - ob] = codes.acc;
    }
    __syncthreads();
    const int cnt = done - ob;
    for (int rr = threadIdx.x >> 5; rr < n_active;
         rr += blockDim.x >> 5) {
      int* dst = out + static_cast<size_t>(lane0 + rr) * n_out + ob;
      const int* src = row(rr);
      for (int c = threadIdx.x & 31; c < cnt; c += 32) dst[c] = src[c];
    }
    ob = done;
  }
};

__device__ __forceinline__ CodeBuffer code_buffer(int* buf, int window,
                                                  int T) {
  CodeBuffer cb;
  cb.buf = buf;
  cb.n_out = (T + window - 1) / window;
  cb.wshift = __ffs(window) - 1;
  cb.per_tile = max(kTile >> cb.wshift, 1);
  cb.ob = 0;
  return cb;
}

}  // namespace pymodem
