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
// The FSM as scans.  Let r be the run of ones just before a bit (the row
// starts after zeros).  Each live bit is then one of: a data bit (a 1
// with r <= 5, a 0 with r < 5), an abort (a 1 with r >= 6), a stuffed
// zero (r = 5), a flag (a 0 with r = 6), or nothing (a 0 with r >= 7).
// Aborts and flags reset the counters; between resets, with n the data
// bits since the last one, bit_index = n mod 8 and byte_index =
// floor(n / 8) mod (max_len + 1); a byte completes at every 8th data bit,
// and its value is the last 8 data bits (the newest in bit 7): the
// working register shifts on data bits and aborts only, and none of those
// 8 is an abort.  A flag closes when n before it is 7 mod 8 and
// floor(n / 8) mod (max_len + 1) >= min_len.  Bits past
// min(max(count, 0), K) bytes are dead.
//
// What bounds it on an H100: the bytes, 1 in and 8 out a byte of the row
// (stream and stream_seg are written whole), 12.5 MB on chip_smoke's AX.25
// sweep (920 rows of 1568 bytes), 3.7 us at the card's memory rate.  One
// thread a row walking its bits in turn (~20 dependent operations a bit,
// 29 blocks) took 0.70 ms.
//
// Design: a block of kWarpsPerRow warps a row, which it walks in tiles of
// 16 bytes a thread (four 32-bit words; rows are K bytes apart, K may be
// odd, so each word is two aligned loads and a funnel shift).  A thread
// classifies its 128 bits a word at a time with shifts and masks (r >= k
// is the AND of the bit stream shifted by 1..k, the 7 bits before a word
// from the word before it), and counts them: its data bits after its last
// reset, whether it has one, and its flags.  The block scans those (warp
// shuffles, one pass through shared memory, the tile before as carry) to
// give each thread the exact n and the flag count at its first bit.  Then
// a prefix count of data bits mod 8 within each word, bit-sliced (three
// words of bit planes, five shift-and-add steps, resets as segment heads),
// marks the completing bits and the flags at n = 7 mod 8; each such flag
// takes its exact n by popcounts for the byte_index test.  A second block
// scan of completed bytes and closing flags places them: a byte's value
// comes from the 16 bits ending at it, its stuffed zeros taken out (at
// most 3), into a shared tile buffer that the block stores in a coalesced
// run; a closing flag below max_packets is stored where it lies.  The
// unfilled tails are stored by the whole block.  Integer arithmetic only,
// so the outputs equal the twin's bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSegFill = 1 << 30;
// four warps a row: the fastest of 1, 2, 4 and 8 at the AX.25 sweep's
// 920 rows of 1568 bytes (tools/design_sweep.py; PERF.md)
constexpr int kWarpsPerRow = 4;
constexpr int kWords = 4;            // words of a row a thread takes a tile
constexpr int kChunk = 4 * kWords;   // bytes of a row a thread takes a tile

// bits above bit q (q in 0..31)
__device__ __forceinline__ unsigned above(int q) { return (~0u << q) << 1; }

// The row's bytes [o, o + 4) as a word in bit-stream order (bit q is the
// q-th bit on the wire: byte o's MSB first); bytes before the row or at or
// past n read as 0.  Reads only aligned words that hold a byte of the row
// below n.
__device__ __forceinline__ unsigned stream_word(const uint8_t* row, int o,
                                                int n) {
  if (o < 0 || o >= n) return 0u;
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + o);
  const unsigned* p = reinterpret_cast<const unsigned*>(a & ~uintptr_t{3});
  const int sh = static_cast<int>(a & 3);
  const unsigned lo = __ldg(p);
  const unsigned hi = (sh != 0 && o - sh + 4 < n) ? __ldg(p + 1) : 0u;
  unsigned w = __funnelshift_r(lo, hi, 8 * sh);
  if (n - o < 4) w &= (1u << (8 * (n - o))) - 1u;
  return __brev(__byte_perm(w, 0, 0x0123));
}

// the live bits of the word at row offset o
__device__ __forceinline__ unsigned live_bits(int o, int n) {
  return o >= n || o < 0 ? 0u
         : n - o >= 4    ? ~0u
                         : (1u << (8 * (n - o))) - 1u;
}

// The classes of the live bits of word s (stream order) after the word pw.
struct Classes {
  unsigned data, reset, flag, stuffed;
};

__device__ __forceinline__ Classes classify(unsigned s, unsigned pw,
                                            unsigned live) {
  const uint64_t z = (static_cast<uint64_t>(s) << 32) | pw;
  // ge[k]: bit q has a run of at least k ones before it
  unsigned g = ~0u, g5 = 0, g6 = 0;
#pragma unroll
  for (int j = 1; j <= 6; ++j) {
    g &= static_cast<unsigned>(z >> (32 - j));
    if (j == 5) g5 = g;
  }
  g6 = g;
  const unsigned g7 = g6 & static_cast<unsigned>(z >> 25);
  const unsigned one = s & live, zero = ~s & live;
  Classes c;
  c.data = (one & ~g6) | (zero & ~g5);
  c.flag = zero & g6 & ~g7;
  c.reset = (one & g6) | c.flag;
  c.stuffed = zero & g5 & ~g6;
  return c;
}

// data bits after the word's last reset (all of them without one)
__device__ __forceinline__ int after_reset(const Classes& c) {
  return __popc(c.reset ? c.data & above(31 - __clz(c.reset)) : c.data);
}

// 3-bit adds on bit planes: (p0, p1, p2) += (a0, a1, a2) mod 8, bit by bit
__device__ __forceinline__ void add3(unsigned& p0, unsigned& p1,
                                     unsigned& p2, unsigned a0, unsigned a1,
                                     unsigned a2) {
  const unsigned c0 = p0 & a0;
  p0 ^= a0;
  const unsigned t1 = p1 ^ a1;
  const unsigned c1 = (p1 & a1) | (t1 & c0);
  p1 = t1 ^ c0;
  p2 ^= a2 ^ c1;
}

// Bit planes of n mod 8 at every bit of a word whose first bit starts with
// n0 data bits since the last reset: n counts the data bits since the last
// reset at or before the bit, the bit itself included (a reset is a
// segment head of count 0).
struct Mod8 {
  unsigned p0, p1, p2;
};

__device__ __forceinline__ Mod8 counts_mod8(const Classes& c, int n0) {
  unsigned p0 = c.data, p1 = 0, p2 = 0, head = c.reset;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const unsigned take = ~head;
    add3(p0, p1, p2, (p0 << s) & take, (p1 << s) & take, (p2 << s) & take);
    head |= head << s;
  }
  const unsigned m = ~head;  // no reset at or before the bit: add n0
  add3(p0, p1, p2, n0 & 1 ? m : 0u, n0 & 2 ? m : 0u, n0 & 4 ? m : 0u);
  return {p0, p1, p2};
}

// The byte completed at bit q of word cur (after word prev; st_cur and
// st_prev their stuffed zeros): the 16 bits ending at q, stuffed zeros
// taken out from the newest down, keep the last 8 data bits in bits 8-15.
__device__ __forceinline__ int byte_at(unsigned cur, unsigned prev,
                                       unsigned st_cur, unsigned st_prev,
                                       int q) {
  const int sh = 17 + q;
  unsigned w = static_cast<unsigned>(
      ((static_cast<uint64_t>(cur) << 32) | prev) >> sh) & 0xFFFFu;
  unsigned st = static_cast<unsigned>(
      ((static_cast<uint64_t>(st_cur) << 32) | st_prev) >> sh) & 0xFFFFu;
  while (st) {
    const int b = 31 - __clz(st);
    const unsigned below = (1u << b) - 1u;
    w = (w & above(b)) | ((w & below) << 1);
    st = (st & below) << 1;
  }
  return static_cast<int>(w >> 8);
}

// Block-wide exclusive scans with a carry from the tile before.  ``part``
// holds the warps' totals.  Segmented data counts: (h, c) a reset seen and
// the data bits after the last one (all without one).
struct SegCount {
  int h, c, f;  // f: flags, summed
};

__device__ __forceinline__ SegCount join(SegCount a, SegCount b) {
  return {a.h | b.h, b.h ? b.c : a.c + b.c, a.f + b.f};
}

// Returns the thread's exclusive prefix and sets ``total`` to the block's
// inclusive total, both after ``carry``.
__device__ __forceinline__ SegCount scan_counts(SegCount v, SegCount carry,
                                                SegCount* part,
                                                SegCount& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  SegCount inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    SegCount u;
    u.h = __shfl_up_sync(~0u, inc.h, d);
    u.c = __shfl_up_sync(~0u, inc.c, d);
    u.f = __shfl_up_sync(~0u, inc.f, d);
    if (lane >= d) inc = join(u, inc);
  }
  SegCount exc;
  exc.h = __shfl_up_sync(~0u, inc.h, 1);
  exc.c = __shfl_up_sync(~0u, inc.c, 1);
  exc.f = __shfl_up_sync(~0u, inc.f, 1);
  if (lane == 0) exc = {0, 0, 0};
  if (lane == 31) part[warp] = inc;
  __syncthreads();
  SegCount pre = carry;
  for (int w = 0; w < warp; ++w) pre = join(pre, part[w]);
  total = pre;
  for (int w = warp; w < kWarpsPerRow; ++w) total = join(total, part[w]);
  __syncthreads();  // part is free again
  return join(pre, exc);
}

// the same for two plain sums (completed bytes, closing flags)
__device__ __forceinline__ int2 scan_sums(int2 v, int2 carry, int2* part,
                                          int2& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int ux = __shfl_up_sync(~0u, inc.x, d);
    const int uy = __shfl_up_sync(~0u, inc.y, d);
    if (lane >= d) {
      inc.x += ux;
      inc.y += uy;
    }
  }
  if (lane == 31) part[warp] = inc;
  __syncthreads();
  int2 pre = carry;
  for (int w = 0; w < warp; ++w) {
    pre.x += part[w].x;
    pre.y += part[w].y;
  }
  total = pre;
  for (int w = warp; w < kWarpsPerRow; ++w) {
    total.x += part[w].x;
    total.y += part[w].y;
  }
  __syncthreads();
  return make_int2(pre.x + inc.x - v.x, pre.y + inc.y - v.y);
}

__global__ void __launch_bounds__(32 * kWarpsPerRow)
    ax25_deframe_kernel(const uint8_t* __restrict__ data,
                        const int* __restrict__ counts, int K,
                        int max_packets, int min_len, int max_len,
                        int* __restrict__ stream,
                        int* __restrict__ stream_seg,
                        int* __restrict__ n_stream,
                        int* __restrict__ close_bit,
                        int* __restrict__ close_seg,
                        int* __restrict__ close_end,
                        int* __restrict__ n_close) {
  constexpr int kThreads = 32 * kWarpsPerRow;
  constexpr int kTileBytes = kThreads * kChunk;
  // a tile completes at most one byte per byte of the row
  __shared__ int out_byte[kTileBytes];
  __shared__ int out_seg[kTileBytes];
  __shared__ SegCount part1[kWarpsPerRow];
  __shared__ int2 part2[kWarpsPerRow];
  const int tid = threadIdx.x;
  const size_t r = blockIdx.x;
  const uint8_t* row = data + r * K;
  int* s_out = stream + r * K;
  int* g_out = stream_seg + r * K;
  int* cb = close_bit + r * max_packets;
  int* cs = close_seg + r * max_packets;
  int* ce = close_end + r * max_packets;
  // bytes past the row's K slots are not in the row (JAX: bits past
  // min(count, K) * 8 are not alive)
  const int n = min(max(counts[r], 0), K);
  SegCount carry{0, 0, 0};  // n and flags before the tile
  int2 placed{0, 0};        // bytes completed and flags closed before it
  for (int base = 0; base < n; base += kTileBytes) {
    const int o = base + tid * kChunk;
    unsigned s[kWords + 1];  // the word before the thread's, then its own
#pragma unroll
    for (int j = 0; j <= kWords; ++j) {
      s[j] = stream_word(row, o + 4 * (j - 1), n);
    }
    // the word before's stuffed zeros from bit 7 up (byte_at reads 17 up)
    const unsigned st_before =
        classify(s[0], 0u, live_bits(o - 4, n)).stuffed;
    Classes cl[kWords];
    SegCount mine{0, 0, 0};
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      cl[j] = classify(s[j + 1], s[j], live_bits(o + 4 * j, n));
      mine = join(mine, SegCount{cl[j].reset != 0, after_reset(cl[j]),
                                 __popc(cl[j].flag)});
    }
    SegCount tile_total;
    const SegCount first = scan_counts(mine, carry, part1, tile_total);
    // completing bits and closing flags, word by word from the exact n
    unsigned done[kWords], closing[kWords];
    int nw = first.c;
    int2 mine2{0, 0};
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const Mod8 m = counts_mod8(cl[j], nw);
      done[j] = cl[j].data & ~(m.p0 | m.p1 | m.p2);
      // n before the bit: the count at the bit before, nw at bit 0
      const unsigned b0 = m.p0 << 1 | (nw & 1);
      const unsigned b1 = m.p1 << 1 | (nw >> 1 & 1);
      const unsigned b2 = m.p2 << 1 | (nw >> 2 & 1);
      unsigned cand = cl[j].flag & b0 & b1 & b2;
      closing[j] = 0;
      while (cand) {
        const int q = __ffs(cand) - 1;
        cand &= cand - 1;
        const unsigned low = (1u << q) - 1u;
        const unsigned rb = cl[j].reset & low;
        const int nb =
            rb ? __popc(cl[j].data & low & above(31 - __clz(rb)))
               : nw + __popc(cl[j].data & low);
        // byte_index (0 for ever when max_len < 0)
        const int bi = max_len >= 0 ? (nb >> 3) % (max_len + 1) : 0;
        if (bi >= min_len) closing[j] |= 1u << q;
      }
      mine2.x += __popc(done[j]);
      mine2.y += __popc(closing[j]);
      nw = cl[j].reset ? after_reset(cl[j]) : nw + __popc(cl[j].data);
    }
    int2 tile_placed;
    const int2 at = scan_sums(mine2, placed, part2, tile_placed);
    int d = at.x, k = at.y, seg = first.f;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const unsigned st_prev = j ? cl[j - 1].stuffed : st_before;
      for (unsigned m = done[j] | closing[j]; m; m &= m - 1) {
        const int q = __ffs(m) - 1;
        const int seg_q = seg + __popc(cl[j].flag & ((1u << q) - 1u));
        if (done[j] >> q & 1) {
          out_byte[d - placed.x] =
              byte_at(s[j + 1], s[j], cl[j].stuffed, st_prev, q);
          out_seg[d - placed.x] = seg_q;
          ++d;
        } else {
          if (k < max_packets) {
            cb[k] = 8 * (o + 4 * j) + q;
            cs[k] = seg_q;
            ce[k] = d;
          }
          ++k;
        }
      }
      seg += __popc(cl[j].flag);
    }
    __syncthreads();
    for (int i = tid; i < tile_placed.x - placed.x; i += kThreads) {
      s_out[placed.x + i] = out_byte[i];
      g_out[placed.x + i] = out_seg[i];
    }
    __syncthreads();  // the buffer is free for the next tile
    carry = tile_total;
    placed = tile_placed;
  }
  // the unfilled tails
  for (int i = placed.x + tid; i < K; i += kThreads) {
    s_out[i] = 0;
    g_out[i] = kSegFill;
  }
  for (int p = min(placed.y, max_packets) + tid; p < max_packets;
       p += kThreads) {
    cb[p] = 0;
    cs[p] = 0;
    ce[p] = 0;
  }
  if (tid == 0) {
    n_stream[r] = placed.x;
    n_close[r] = placed.y;
  }
}

}  // namespace

extern "C" int ax25_deframe_rows(const uint8_t* data, const int* counts,
                                 int* stream, int* stream_seg, int* n_stream,
                                 int* close_bit, int* close_seg,
                                 int* close_end, int* n_close, int n_rows,
                                 int K, int max_packets, int min_len,
                                 int max_len, void* cuda_stream) {
  if (n_rows > 0) {
    ax25_deframe_kernel<<<n_rows, 32 * kWarpsPerRow, 0,
                          static_cast<cudaStream_t>(cuda_stream)>>>(
        data, counts, K, max_packets, min_len, max_len, stream, stream_seg,
        n_stream, close_bit, close_seg, close_end, n_close);
  }
  return static_cast<int>(cudaGetLastError());
}
