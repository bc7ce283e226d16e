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
// clock 1 by lock_rate.  Emissions are K1's encoding (binary_slicer.cu):
// 0x100 | byte per sample, or one (pos << 16) | 0x100 | byte per window.
//
// What bounds it on an H100: like K1 and K7, each lane is one strictly
// sequential recurrence (~35 dependent compare/select/add operations per
// sample; the ring mean only on a sync hit), so the lane count sets the
// parallelism (~1200-1900 lanes on the 4FSK bank, 10-15 blocks of 128
// threads on 132 SMs) and the run time is T times the per-step latency;
// 4 bytes in per sample, 4 out per window.
//
// Design: one thread per lane, every carry in registers for the whole T.
// The ring is eight registers: a fully unrolled loop writes slot r through
// a select on ring_index == r, so no index is dynamic and nothing spills
// to local memory.  The ring is summed only on a sync hit, in the scan's
// order r0 + r1 + ... + r7.  The bank-uniform demap is four kernel
// arguments, picked by selects.  Built with -fmad=false and without fast
// math: |x| * 2 then / 3 is an IEEE-rounded divide, as in the scan, so the
// output equals the plain twin (ops/slicers.py four_level_slice) bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDepth = 8;

__global__ void four_level_slice_kernel(const float* __restrict__ x,
                                        const float* __restrict__ params,
                                        int* __restrict__ out, int d0, int d1,
                                        int d2, int d3, int L, int T,
                                        int window) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const float sps = params[lane];
  const float lock_rate = params[L + lane];
  const float rollover = sps / 2.0f - 0.5f;
  const float* xl = x + static_cast<size_t>(lane) * T;
  const int n_out = (T + window - 1) / window;
  int* ol = out + static_cast<size_t>(lane) * n_out;

  float clock1 = 0.0f;
  float clock2 = 0.0f;
  float last = 0.0f;
  float threshold = 0.0f;
  float ring[kDepth];
#pragma unroll
  for (int r = 0; r < kDepth; ++r) ring[r] = 0.0f;
  int byte = 0;
  int bit_count = 0;
  int sync = 0;
  int ring_index = 0;
  int acc = 0;
  for (int t = 0; t < T; ++t) {
    const float xv = xl[t];
    clock1 = clock1 + 1.0f;
    const bool roll1 = clock1 > rollover;
    bool sync_hit = false;
    if (roll1) {
      clock1 = clock1 - sps;
      ring_index = ring_index + 1 >= kDepth ? 0 : ring_index + 1;
      const float v = fabsf(xv) * 2.0f / 3.0f;
#pragma unroll
      for (int r = 0; r < kDepth; ++r) ring[r] = ring_index == r ? v : ring[r];
      sync = ((sync << 1) & 0xFFFF) + (xv > 0.0f ? 1 : 0);
      sync_hit = sync == 0x5555 || sync == 0xCCCC;
    }
    if (sync_hit) {
      float sum = ring[0];
#pragma unroll
      for (int r = 1; r < kDepth; ++r) sum = sum + ring[r];
      threshold = sum / static_cast<float>(kDepth);
      clock2 = clock1;
    }
    clock2 = clock2 + 1.0f;
    const bool roll2 = clock2 > rollover;
    if (roll2) {
      clock2 = clock2 - sps;
      const int symbol = xv > 0.0f ? (xv >= threshold ? 3 : 2)
                                   : (xv <= -threshold ? 0 : 1);
      const int bits = symbol == 0 ? d0
                       : symbol == 1 ? d1
                       : symbol == 2 ? d2
                                     : d3;
      byte = ((byte << 2) & 0xFF) + bits;
      bit_count += 2;
    }
    const bool emit = roll2 && bit_count >= 8;
    if (emit) bit_count = 0;
    const bool crossing =
        (last < 0.0f && xv >= 0.0f) || (last >= 0.0f && xv < 0.0f);
    if (crossing) clock1 = clock1 * lock_rate;
    last = xv;
    if (window == 1) {
      ol[t] = emit ? (0x100 | byte) : 0;
    } else {
      // at most one emission per window (safe_compact_window)
      const int pos = t & (window - 1);
      const int enc = emit ? ((pos << 16) | 0x100 | byte) : 0;
      acc = pos == 0 ? enc : (acc | enc);
      if (pos == window - 1 || t == T - 1) ol[t / window] = acc;
    }
  }
}

}  // namespace

extern "C" int four_level_slice_lanes(const float* x, const float* params,
                                      int* out, int d0, int d1, int d2,
                                      int d3, int L, int T, int window,
                                      void* stream) {
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  if (blocks > 0) {
    four_level_slice_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        x, params, out, d0, d1, d2, d3, L, T, window);
  }
  return static_cast<int>(cudaGetLastError());
}
