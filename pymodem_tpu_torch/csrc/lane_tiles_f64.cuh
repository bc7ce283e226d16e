// Staged double tiles for the float64 lane kernels K10-K16
// (binary_slicer_f64.cu, coherent_loop_f64.cu for K11 and K13,
// four_level_slicer_f64.cu, iq_loop_f64.cu for K14 and K15,
// quadrature_slicer_f64.cu):
// lane_tiles.cuh's stage barriers and bulk copies (TMA) at 8 bytes a
// sample.
//
// Layout: a shared tile of n samples (n a multiple of 16) holds one row of
// n + 2 doubles per lane.  A thread reading a double2 of its own row then
// hits 8 distinct 16-byte bank groups in each quarter warp (row r starts
// at group (n / 2 + 1) r, and n / 2 + 1 is odd), so the per-lane reads of
// the recurrences are free of bank conflicts.
//
// Copies: a bulk copy moves a multiple of 16 bytes between 16-byte-aligned
// addresses, so rows start 16-byte aligned, a multiple of 2 doubles apart
// (``stride`` >= T, checked by ``rows_ok``), and a tile of n samples moves
// ``padded2(n)`` of them: the last tile of a row whose T is odd reaches
// into the row's padding (the wrappers pad such rows, _ext.lane_rows; the
// two-rail K15 and K16 take both rails at one stride, _ext.lane_rows_pair).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tiles.cuh"

namespace pymodem {
namespace f64 {

// doubles after each lane row of a shared tile
constexpr int kRowPad = 2;

__host__ __device__ constexpr int row_stride(int tile) {
  return tile + kRowPad;
}

__host__ __device__ inline int padded2(int n) { return (n + 1) & ~1; }

// the bytes a bulk copy of n samples moves
__host__ __device__ inline unsigned tile_bytes(int n) {
  return 8u * static_cast<unsigned>(padded2(n));
}

// Whether rows ``stride`` doubles apart from ``base`` can hold T samples
// moved by bulk copies: 16-byte aligned, stride a multiple of 2, >= T.
inline bool rows_ok(const void* base, int stride, int T) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && stride % 2 == 0 &&
         stride >= T;
}

}  // namespace f64
}  // namespace pymodem
