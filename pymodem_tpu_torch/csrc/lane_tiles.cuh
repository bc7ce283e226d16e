// Staged lane tiles for the lane kernels K1-K8 (the slicers K1, K7 and
// K8 add slicer_words.cuh): a block serves kLanes lanes and walks
// time in tiles of kTile samples, bringing each lane's next tile of its
// input rows into shared memory while the lanes work on the current one,
// and writing (L, T) outputs back from a shared tile.
//
// Layout: a shared tile holds one row of kTile + 4 floats per lane.  A
// thread reading a float4 of its own row then hits 8 distinct 16-byte bank
// groups in each quarter warp (row r starts at group 33 r), so the per-lane
// reads of the recurrence are free of bank conflicts.
//
// Copies: one cp.async.bulk (TMA) per lane row and tile, started by a
// second warp beside the lane warp (the "copy warp"), loads completing on
// a stage's mbarrier.  On an H100, starting a tile's copies stalls the
// warp that starts them for microseconds, so the lane warp starts none.
// A bulk copy moves a multiple of 16 bytes between 16-byte-aligned
// addresses, so rows start 16-byte aligned, a multiple of 4 floats apart
// (``stride`` >= T, checked by ``rows_ok``), and a tile of n samples moves
// ``padded4(n)`` of them: the last tile of a row whose T is not a multiple
// of 4 reaches into the row's padding (the wrappers pad such rows).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pymodem {

// lanes (and copy threads) a block.  The kernels declare
// __launch_bounds__(threads, 1): without the 1 (one resident block an SM
// suffices), ptxas budgets registers for many resident blocks and gives
// K7 48 registers where it takes 72, ~20% slower on an H100.
constexpr int kLanes = 32;
constexpr int kTile = 128;   // samples a tile
constexpr int kStride = kTile + 4;  // floats a lane row of a shared tile

__host__ __device__ inline int padded4(int n) { return (n + 3) & ~3; }

// Whether rows ``stride`` floats apart from ``base`` can hold T samples
// moved by bulk copies: 16-byte aligned, stride a multiple of 4, >= T.
inline bool rows_ok(const void* base, int stride, int T) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && stride % 4 == 0 &&
         stride >= T;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// a stage's barrier: one arrival (mbar_expect) a phase; the caller
// synchronises the block before the first use
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects ``bytes`` of bulk copies in this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// the copies take float rows (K1-K8) and double rows (lane_tiles_f64.cuh)
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          gmem),
      "r"(smem_addr(smem)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk store groups still read
// shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// make this thread's generic shared-memory writes visible to bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace pymodem
