// K9: the AX.25/HDLC bit deframer over (chain x block) rows.
//
// Replaces the lax.scan over bits of pymodem_tpu/codecs/ax25_device.py
// (_ax25_flat, :79-125 the step, :128 the scan) and the compaction of its
// per-bit outputs (:132-161); the JAX package has no Pallas kernel for it.
// The plain twin is codecs/ax25_device.py ax25_deframe.
//
// Per bit, MSB first within each byte (reference ax25.py:25-93): a 1 ORs
// 0x80 into the working register, counts the run of ones and the bit;
// more than six ones abort (bit and byte counters reset); a 0 after fewer
// than five ones is a data bit, after five a stuffed zero (dropped), after
// six a flag, which closes the packet when at least min_len bytes were
// collected and the flag lands byte-aligned (bit_index == 7).  Every 8
// data bits complete a byte; the byte counter resets past max_len.
//
// Outputs, per row, exactly what the JAX package's vectorized compaction
// forms from the scan's per-bit arrays: the completed bytes in order
// (``stream``, 0 where unfilled) with the number of flags before each
// (``stream_seg``, 2^30 where unfilled) and their count; the first
// max_packets closing flags as (bit index, flags before it, bytes
// completed before it), zeros in unused slots; and the count of all
// closing flags (the caller's ``dropped`` is its excess over max_packets).
//
// What bounds it on an H100: each row is one strictly sequential bit
// recurrence of ~20 integer operations a bit, and the rows are few (chains
// x blocks: ~1700 on chip_smoke's AX.25 sweep), so the run time is the bit
// count of a row times the per-bit latency of one thread; bytes moved (1 in
// per 8 bits, 8 out per completed byte) are far below the memory rate.
//
// Design: one thread per row, 32 rows a block so the rows spread over as
// many SMs as possible.  The FSM state lives in registers and is updated by
// selects, in the JAX step's order, so the warp does not diverge on the bit
// values; only the rare stores (a completed byte, a closing flag) are
// predicated.  The rows' unfilled tails are then written by the whole
// block, a row at a time, in coalesced runs.  Integer arithmetic only, so
// the outputs equal the twin's bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;  // rows (threads) a block
constexpr int kSegFill = 1 << 30;

__global__ void __launch_bounds__(kRows)
ax25_deframe_kernel(const uint8_t* __restrict__ data,
                    const int* __restrict__ counts, int n_rows, int K,
                    int max_packets, int min_len, int max_len,
                    int* __restrict__ stream, int* __restrict__ stream_seg,
                    int* __restrict__ n_stream, int* __restrict__ close_bit,
                    int* __restrict__ close_seg, int* __restrict__ close_end,
                    int* __restrict__ n_close) {
  __shared__ int filled[kRows];
  const int r = blockIdx.x * kRows + threadIdx.x;
  const bool live = r < n_rows;
  int done_bytes = 0;
  if (live) {
    const uint8_t* row = data + static_cast<size_t>(r) * K;
    int* s_out = stream + static_cast<size_t>(r) * K;
    int* g_out = stream_seg + static_cast<size_t>(r) * K;
    int* cb = close_bit + static_cast<size_t>(r) * max_packets;
    int* cs = close_seg + static_cast<size_t>(r) * max_packets;
    int* ce = close_end + static_cast<size_t>(r) * max_packets;
    // bytes past the row's K slots are not in the row (JAX: bits past
    // min(count, K) * 8 are not alive)
    const int n = min(max(counts[r], 0), K);
    int working = 0, ones = 0, bit_index = 0, byte_index = 0;
    int seg = 0, closes = 0;
    for (int i = 0; i < n; ++i) {
      const int value = __ldg(row + i);
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        const bool one = (value >> k) & 1;
        // '1' branch (ax25.py:33-53)
        const int w1 = working | 0x80;
        const int ones1 = ones + 1;
        const bool abort = ones1 > 6;
        int b1 = abort ? 0 : bit_index + 1;
        const bool done1 = b1 == 8;
        b1 = done1 ? 0 : b1;
        int y1 = (abort ? 0 : byte_index) + (done1 ? 1 : 0);
        y1 = y1 > max_len ? 0 : y1;
        // '0' branch (ax25.py:54-92)
        const bool dz = ones < 5;  // a data zero
        const bool flag = ones == 6;
        int b0 = dz ? bit_index + 1 : bit_index;
        const bool done0 = dz && b0 == 8;
        b0 = done0 ? 0 : b0;
        int y0 = byte_index + (done0 ? 1 : 0);
        y0 = y0 > max_len ? 0 : y0;
        const bool close =
            !one && flag && byte_index >= min_len && bit_index == 7;
        b0 = flag ? 0 : b0;
        y0 = flag ? 0 : y0;
        const int w0 = dz ? working >> 1 : working;
        if (one ? done1 : done0) {
          s_out[done_bytes] = (one ? w1 : working) & 0xFF;
          g_out[done_bytes] = seg;
          ++done_bytes;
        }
        if (close) {
          if (closes < max_packets) {
            cb[closes] = 8 * i + 7 - k;
            cs[closes] = seg;
            ce[closes] = done_bytes;
          }
          ++closes;
        }
        seg += (!one && flag) ? 1 : 0;
        working = one ? w1 >> 1 : w0;
        ones = one ? ones1 : 0;
        bit_index = one ? b1 : b0;
        byte_index = one ? y1 : y0;
      }
    }
    for (int p = min(closes, max_packets); p < max_packets; ++p) {
      cb[p] = 0;
      cs[p] = 0;
      ce[p] = 0;
    }
    n_stream[r] = done_bytes;
    n_close[r] = closes;
  }
  filled[threadIdx.x] = live ? done_bytes : K;
  __syncthreads();
  // the unfilled tails, one row at a time across the block's threads
  const int first = blockIdx.x * kRows;
  for (int rr = 0; rr < kRows && first + rr < n_rows; ++rr) {
    int* s_out = stream + static_cast<size_t>(first + rr) * K;
    int* g_out = stream_seg + static_cast<size_t>(first + rr) * K;
    for (int j = filled[rr] + threadIdx.x; j < K; j += kRows) {
      s_out[j] = 0;
      g_out[j] = kSegFill;
    }
  }
}

}  // namespace

extern "C" int ax25_deframe_rows(const uint8_t* data, const int* counts,
                                 int* stream, int* stream_seg, int* n_stream,
                                 int* close_bit, int* close_seg,
                                 int* close_end, int* n_close, int n_rows,
                                 int K, int max_packets, int min_len,
                                 int max_len, void* cuda_stream) {
  const int blocks = (n_rows + kRows - 1) / kRows;
  if (blocks > 0) {
    ax25_deframe_kernel<<<blocks, kRows, 0,
                          static_cast<cudaStream_t>(cuda_stream)>>>(
        data, counts, n_rows, K, max_packets, min_len, max_len, stream,
        stream_seg, n_stream, close_bit, close_seg, close_end, n_close);
  }
  return static_cast<int>(cudaGetLastError());
}
