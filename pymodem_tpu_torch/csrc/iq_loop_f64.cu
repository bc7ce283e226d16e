// K14 and K15: the float64 QPSK Costas loop with its branch IIRs (K14,
// the AGC fused or not) and the MPSK loop on the analytic signal (K15),
// over (chain x block) lanes.
//
// Replaces the lax.scans that the JAX package runs in its float64 parity
// mode (its Pallas kernel _iq_loop_kernel, which K5 and K6 replace, runs
// float32 only): pymodem_tpu/dsp/agc.py agc_apply then
// pymodem_tpu/dsp/loops.py qpsk_costas (reference psk.py:437-467), and
// pymodem_tpu/dsp/loops.py mpsk_loop with its f64 table detector
// _pd_lookup (reference psk.py:734-747, phase_detector.py:124-149).  The
// plain twins are dsp/loops.py qpsk_costas and mpsk_loop on float64
// tensors.
//
// Per sample, in the twins' order (dsp/loops.py module docstring):
//
//   K14: x = AGC(x) (17 rows only); NCO;
//        c = (bb0 * x cos[idx] + bb0 * c_in_prev) + ba1 * c_prev, and s
//        likewise on x sin[idx]; e = c * sgn(s) - s * sgn(c), sgn(v) =
//        v >= 0 ? 1 : -1 (NaN takes -1); loop IIR and PI; control =
//        prop + integral; outputs (s, c).
//   K15: NCO; re' = (re * cos) - (im * (-sin)), im' = (cos * im) +
//        (re * (-sin)); r = int(floor(re' * g/2)), i likewise, each
//        clamped to +-(g-1) in the twin's order and folded into the first
//        quadrant (a, b); e = table[a * g + b], the reference's int32
//        qpsk_error_table as a double; loop IIR and PI; control =
//        rint(prop + integral) (half to even, as torch.round and
//        jnp.round); outputs (re', im').
//
// What bounds it on an H100: each lane is one sequential recurrence of
// ~50 (K14) and ~45 (K15) dependent f64 operations a step, with one or two
// shared-memory gathers, and the lanes (944 on the 8-chain PSK banks, one
// on the executor) are the parallelism, so the run time is T times one
// step's latency; 16 (K14) or 32 (K15) bytes a sample move.  One thread a
// lane, reading its rows straight from global memory 8 samples at a time
// (one exposed memory round trip a chunk), K15 took 265.5 ns a step at one
// lane and 300.8 ns on bank lanes.
//
// Both stage their rows in shared memory (lane_tiles_f64.cuh), a block of
// 32 lanes walking time in tiles of 64 samples; lane l reads input row
// row_of_lane[l] (a pre-shared bank's B shared rows) as double2s and
// writes its two outputs in place for the copy warp to store, one bulk
// copy a lane and rail.  The NCO's four wraps are selects side by side
// (Loop::nco_select), and its sine and cosine one shared double2 a step.
//
// K14 (K5's loop, with K11's split of the AGC): with the AGC fused (17
// rows) a block has a lane warp, a copy warp and kGainWarps gain warps over
// five stages of two rails (168,960 B).  While the lanes run the loop over
// tile k - 2, the gain warp forms Agc::gain, target * x / env, of tile
// k - 1 in place over its input, and copy thread l runs lane l's
// Agc::follow over tile k, writing the envelopes into the stage's second
// rail; the copy warp also stores tile k - 3 and loads tile k + 1.  So the
// follower and the divide leave the lane's chain, which is the NCO, the
// table read, the two branch IIRs, the sign detector, Loop::filter and PI.
// The lanes write I (the sine branch) in place over the gained input and
// Q (the cosine branch) over the envelopes, which the gain warp used up a
// step earlier.  Without the AGC (12 rows) the copy warp only copies, so
// K15's layout serves: a lane warp and a copy warp over three stages of
// two rails (101,376 B), the lanes running tile k while the copy warp
// stores tile k - 1 and loads tile k + 1.  One kernel, templated on the
// form.
//
// K15 (K6's design at f64): a block serves 32 lanes with a lane warp and a
// copy warp over three stages of two rails (101,376 B): while the lanes run
// tile k, the copy warp stores tile k - 1 and loads tile k + 1 of both
// rails (the copy warp only copies, so K6's three stages cover it;
// 64-sample tiles leave room for three detector tables as doubles).  Off
// the lane's dependency chain: the NCO's wraps; its sine and cosine as one
// (cos, -sin) double2 (negating is exact); the detector table's
// int-to-double conversion, by a table staged as doubles (exact) when the
// bank's tables fit beside the tiles (dsp/loops.py mpsk_f64_tables_staged
// says when, in the same bytes), else read as int32 through the read-only
// cache; and floor then int, as one rounding-down conversion.
//
// Built with -fmad=false and without fast math, in the twins' op order, so
// the outputs equal the plain twins (dsp/loops.py qpsk_costas, mpsk_loop)
// bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tiles_f64.cuh"
#include "lanes_f64.cuh"

namespace {

using namespace pymodem::f64;

constexpr int kTile = 64;  // samples a tile
constexpr int kStride = row_stride(kTile);  // doubles a lane row of a rail
// K15: tile k + 1 loads while tile k runs and tile k - 1 stores
constexpr int kStages = 3;
constexpr int kRail = kLanes * kStride;  // doubles of one rail of a stage
constexpr size_t kTileBytes = 8 * 2 * kStages * kRail;  // both rails

constexpr int kLoopRows = 10;    // K14: PLL_PARAMS
constexpr int kBranchRows = 12;  // then branch_b0, branch_a1; then the AGC's
constexpr int kGainWarps = 1;    // K14 (17 rows): warps forming the quotients

// K14's geometry in each form.  With the AGC (17 rows) tile k + 1 loads
// while tile k follows, k - 1 gains, k - 2 runs the loop and k - 3 stores;
// without it (12 rows) tile k + 1 loads while tile k runs and k - 1 stores.
template <bool kAgc>
struct QpskForm {
  static constexpr int kLag = kAgc ? 2 : 0;  // the lanes run tile k - kLag
  static constexpr int kStages = kLag + 3;
  static constexpr int kThreads = (2 + (kAgc ? kGainWarps : 0)) * kLanes;
  static constexpr int kSmemBytes = 8 * 2 * kStages * kRail;  // both rails
};

__device__ __forceinline__ double sgn(double v) {
  return v >= 0.0 ? 1.0 : -1.0;
}

// K14: warp 0 is the lanes, warp 1 the copy warp (it starts its lane's
// bulk copies and, with the AGC, runs its lane's envelope follower), warps
// 2 and up the gain warps: gain warp g forms the quotients of the tile's
// double2 columns c with c % kGainWarps == g.
template <bool kAgc>
__global__ void __launch_bounds__(QpskForm<kAgc>::kThreads, 1)
    qpsk_costas_f64_kernel(const double* __restrict__ x, int in_stride,
                           const int* __restrict__ row_of_lane, int n_rows,
                           const double* __restrict__ params,
                           const double* __restrict__ sine,
                           const double* __restrict__ cosine,
                           double* __restrict__ out_i,
                           double* __restrict__ out_q, int out_stride, int L,
                           int T) {
  using Form = QpskForm<kAgc>;
  // [stage][rail][lane][kStride] tiles (rail 0: the input, gained in place
  // with the AGC, then I in place; rail 1: the envelopes with the AGC,
  // then Q)
  extern __shared__ __align__(16) double smem[];
  __shared__ uint64_t bars[Form::kStages];
  __shared__ double2 tab[kTableSize];  // the NCO's (cos, sin)
  const int tid = threadIdx.x;
  const int warp = tid / kLanes;
  const int r = tid % kLanes;  // the lane row this thread serves
  const int lane0 = blockIdx.x * kLanes;
  const int lane = lane0 + r;
  const bool active = lane < L;
  const int n_active = min(kLanes, L - lane0);
  for (int k = tid; k < kTableSize; k += Form::kThreads) {
    tab[k] = make_double2(cosine[k], sine[k]);
  }
  if (tid < Form::kStages) pymodem::mbar_init(&bars[tid]);
  __syncthreads();

  const int pl = active ? lane : 0;
  // the clamp only keeps a mismatched call inside the rows
  const double* row =
      x + static_cast<size_t>(min(max(row_of_lane[pl], 0), n_rows - 1)) *
              in_stride;
  const double* p = params + pl;
  Loop loop(p, L);
  const double bb0 = p[kLoopRows * L], ba1 = p[(kLoopRows + 1) * L];
  // the AGC's rows follow the branch IIR's; unread without kAgc
  Agc agc(p + (kAgc ? kBranchRows * L : 0), L);
  double cos_x = 0.0, cos_y = 0.0, sin_x = 0.0, sin_y = 0.0;
  auto tile_n = [&](int k) { return min(kTile, T - k * kTile); };
  auto row_at = [&](int k) {
    return smem + 2 * (k % Form::kStages) * kRail + r * kStride;
  };

  // copy warp: tile k to rail 0 of its stage by one bulk copy a lane,
  // completing on the stage's barrier
  auto fetch = [&](int k) {
    const unsigned bytes = tile_bytes(tile_n(k));
    uint64_t* bar = &bars[k % Form::kStages];
    if (r == 0) pymodem::mbar_expect(bar, bytes * n_active);
    if (active) pymodem::bulk_load(row_at(k), row + k * kTile, bytes, bar);
  };
  // copy warp: I and Q of tile k to the (L, T) outputs
  auto store = [&](int k) {
    if (active) {
      const size_t o = static_cast<size_t>(lane) * out_stride + k * kTile;
      const unsigned bytes = tile_bytes(tile_n(k));
      pymodem::bulk_store(out_i + o, row_at(k), bytes);
      pymodem::bulk_store(out_q + o, row_at(k) + kRail, bytes);
    }
    pymodem::bulk_commit();
  };
  // copy warp (AGC): the envelopes of tile k into rail 1, two steps at a
  // time; past T (the last tile of a row whose T is odd) the step makes
  // only an output in the rows' padding
  auto follow = [&](int k) {
    pymodem::mbar_wait(&bars[k % Form::kStages],
                       (k / Form::kStages) & 1);
    double* xr = row_at(k);
    agc.follow_tile(xr, xr + kRail, tile_n(k));
  };
  // gain warp g (AGC): target * x / env over its columns of tile k, in
  // place
  auto gain = [&](int k, int g) {
    // long passed: orders the bulk load before these reads
    pymodem::mbar_wait(&bars[k % Form::kStages],
                       (k / Form::kStages) & 1);
    double* xr = row_at(k);
    agc.gain_tile(xr, xr + kRail, tile_n(k), 2 * g, 2 * kGainWarps);
    // ordered before the bulk copies that later refill the stage
    pymodem::fence_proxy_async();
  };
  // lane warp: the loop on one sample xs; returns I (sin_out) and leaves
  // Q (cos_out) in q
  auto step = [&](double xs, double& q) {
    const double2 cs = tab[loop.nco_select()];
    const double i_mixer = xs * cs.x;
    const double cos_out = (bb0 * i_mixer + bb0 * cos_x) + ba1 * cos_y;
    const double q_mixer = xs * cs.y;
    const double sin_out = (bb0 * q_mixer + bb0 * sin_x) + ba1 * sin_y;
    const double e = (cos_out * sgn(sin_out)) - (sin_out * sgn(cos_out));
    const double prop = loop.filter(e);
    loop.control = prop + loop.integral;
    cos_x = i_mixer;
    cos_y = cos_out;
    sin_x = q_mixer;
    sin_y = sin_out;
    q = cos_out;
    return sin_out;
  };
  // lane warp: the loop over tile k, I in place over rail 0, Q into rail 1
  auto run = [&](int k) {
    // (long passed with the AGC, whose warps waited before the lanes)
    pymodem::mbar_wait(&bars[k % Form::kStages],
                       (k / Form::kStages) & 1);
    double* xr = row_at(k);
    double* qr = xr + kRail;
    const int n = tile_n(k);
#pragma unroll 2
    for (int c = 0; c < n; c += 2) {
      double2 a = *reinterpret_cast<const double2*>(xr + c);
      double2 q;
      a.x = step(a.x, q.x);
      a.y = step(a.y, q.y);
      *reinterpret_cast<double2*>(xr + c) = a;
      *reinterpret_cast<double2*>(qr + c) = q;
    }
    // the bulk stores read what these generic stores wrote
    pymodem::fence_proxy_async();
  };

  const int n_tiles = (T + kTile - 1) / kTile;
  if (warp == 1 && n_tiles > 0) fetch(0);
  for (int k = 0; k < n_tiles + Form::kLag + 1; ++k) {
    // the lanes are done with tile k - kLag - 1 (with the AGC: the
    // follower with k - 1, the gains with k - 2)
    __syncthreads();
    if (warp == 1) {
      // store tile k - kLag - 1, then load tile k + 1 into the stage of
      // tile k - kLag - 2 once its store has read it, then follow tile k
      if (k > Form::kLag) store(k - Form::kLag - 1);
      pymodem::bulk_wait_read<1>();
      if (k + 1 < n_tiles) fetch(k + 1);
      if (kAgc && active && k < n_tiles) follow(k);
    } else if (warp >= 2) {
      if (active && k >= 1 && k <= n_tiles) gain(k - 1, warp - 2);
    } else if (active && k >= Form::kLag && k < n_tiles + Form::kLag) {
      run(k - Form::kLag);
    }
  }
  if (warp == 1) pymodem::bulk_wait_all();
}

template <bool kAgc>
int launch_qpsk(const double* x, int in_stride, const int* row_of_lane,
                int R, const double* params, const double* sine,
                const double* cosine, double* out_i, double* out_q,
                int out_stride, int L, int T, cudaStream_t stream) {
  using Form = QpskForm<kAgc>;
  cudaError_t err = cudaFuncSetAttribute(
      qpsk_costas_f64_kernel<kAgc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Form::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0 && T > 0) {
    qpsk_costas_f64_kernel<kAgc>
        <<<blocks, Form::kThreads, Form::kSmemBytes, stream>>>(
            x, in_stride, row_of_lane, R, params, sine, cosine, out_i, out_q,
            out_stride, L, T);
  }
  return static_cast<int>(cudaGetLastError());
}

// K15: warp 0 is the lanes, warp 1 the copy warp (it starts its lane's
// bulk loads and stores, so the lanes never wait on a copy's start).
template <bool kPdShared>
__global__ void __launch_bounds__(2 * kLanes, 1)
    mpsk_loop_f64_kernel(const double* __restrict__ re,
                         const double* __restrict__ im, int in_stride,
                         const int* __restrict__ row_of_lane, int n_rows,
                         const double* __restrict__ params,
                         const double* __restrict__ sine,
                         const double* __restrict__ cosine,
                         const int* __restrict__ pd_tables,
                         const int* __restrict__ pd_index,
                         double* __restrict__ out_re,
                         double* __restrict__ out_im, int out_stride, int L,
                         int T, int g, int n_tables) {
  // [stage][rail][lane][kStride] tiles (rail 0 re, then re'; rail 1 im,
  // then im'), the (cos, -sin) table, then the detector tables as doubles
  // when they are staged
  extern __shared__ __align__(16) double smem[];
  __shared__ uint64_t bars[kStages];
  double2* sc = reinterpret_cast<double2*>(smem + 2 * kStages * kRail);
  double* pd_shared = reinterpret_cast<double*>(sc + kTableSize);
  const int tid = threadIdx.x;
  const bool copier = tid >= kLanes;
  const int r = copier ? tid - kLanes : tid;  // the lane row this thread serves
  const int lane0 = blockIdx.x * kLanes;
  const int lane = lane0 + r;
  const bool active = lane < L;
  const int n_active = min(kLanes, L - lane0);
  const int gg = g * g;
  for (int k = tid; k < kTableSize; k += 2 * kLanes) {
    sc[k] = make_double2(cosine[k], -sine[k]);
  }
  if (kPdShared) {
    // int32 to double is exact
    for (int k = tid; k < n_tables * gg; k += 2 * kLanes) {
      pd_shared[k] = static_cast<double>(pd_tables[k]);
    }
  }
  if (tid < kStages) pymodem::mbar_init(&bars[tid]);
  __syncthreads();

  const int pl = active ? lane : 0;
  // the clamps only keep a mismatched call inside the rows and tables
  const size_t row =
      static_cast<size_t>(min(max(row_of_lane[pl], 0), n_rows - 1)) *
      in_stride;
  Loop loop(params + pl, L);
  // row 11 is the lane's granularity (row 10, pd_gain, built its table);
  // int() of it as the twin's .to(int32), kept within the tables' g so a
  // mismatched call reads inside its table
  const double gf = params[11 * L + pl];
  const int gi = min(max(static_cast<int>(gf), 0), g);
  const double half = gf * 0.5;
  const int which = min(max(pd_index[pl], 0), n_tables - 1);
  const double* table_d = pd_shared + static_cast<size_t>(which) * gg;
  const int* table_i = pd_tables + static_cast<size_t>(which) * gg;

  // one sample: (re, im) rotated by the NCO into (o_re, o_im), then the
  // detector and the loop update
  auto step = [&](double a_re, double a_im, double& o_re, double& o_im) {
    const double2 cs = sc[loop.nco_select()];
    o_re = (a_re * cs.x) - (a_im * cs.y);
    o_im = (cs.x * a_im) + (a_re * cs.y);
    // quantise (floor, then int: one rounding-down conversion, which
    // saturates out of range and takes NaN to 0 as the twin's floor then
    // .to(int32) does on the card), clamp to +-(g-1) (r >= g and r <= -g
    // are r > g-1 and r < -(g-1)), fold into the first quadrant
    const int qr = max(min(__double2int_rd(o_re * half), gi - 1), -(gi - 1));
    const int qi = max(min(__double2int_rd(o_im * half), gi - 1), -(gi - 1));
    const bool rn = qr >= 0, in = qi >= 0;
    const int a = rn ? (in ? qr : -qi) : (in ? qi : -qr);
    const int b = rn ? (in ? qi : qr) : (in ? -qr : -qi);
    const int flat = a * gi + b;
    const double e = kPdShared ? table_d[flat]
                               : static_cast<double>(__ldg(table_i + flat));
    const double prop = loop.filter(e);
    loop.control = rint(prop + loop.integral);
  };
  auto tile_n = [&](int k) { return min(kTile, T - k * kTile); };
  auto rail_at = [&](int k, int rail) {
    return smem + (2 * (k % kStages) + rail) * kRail + r * kStride;
  };
  // copy warp: tile k of both rails into its stage by one bulk copy a lane
  // and rail, completing on the stage's barrier
  auto fetch = [&](int k) {
    const unsigned bytes = tile_bytes(tile_n(k));
    uint64_t* bar = &bars[k % kStages];
    if (r == 0) pymodem::mbar_expect(bar, 2u * bytes * n_active);
    if (active) {
      pymodem::bulk_load(rail_at(k, 0), re + row + k * kTile, bytes, bar);
      pymodem::bulk_load(rail_at(k, 1), im + row + k * kTile, bytes, bar);
    }
  };
  // copy warp: tile k (re', im' in place in its stage) to the outputs
  auto store = [&](int k) {
    if (active) {
      const size_t o = static_cast<size_t>(lane) * out_stride + k * kTile;
      const unsigned bytes = tile_bytes(tile_n(k));
      pymodem::bulk_store(out_re + o, rail_at(k, 0), bytes);
      pymodem::bulk_store(out_im + o, rail_at(k, 1), bytes);
    }
    pymodem::bulk_commit();
  };
  // lane warp: the loop over tile k, two samples a double2, the outputs in
  // place; past T (the last tile of a row whose T is odd) the step makes
  // only an output in the rows' padding
  auto run = [&](int k) {
    pymodem::mbar_wait(&bars[k % kStages], (k / kStages) & 1);
    double* xr = rail_at(k, 0);
    double* xi = rail_at(k, 1);
    const int n = tile_n(k);
#pragma unroll 2
    for (int c = 0; c < n; c += 2) {
      double2 a = *reinterpret_cast<const double2*>(xr + c);
      double2 b = *reinterpret_cast<const double2*>(xi + c);
      step(a.x, b.x, a.x, b.x);
      step(a.y, b.y, a.y, b.y);
      *reinterpret_cast<double2*>(xr + c) = a;
      *reinterpret_cast<double2*>(xi + c) = b;
    }
    // the bulk store reads what these generic stores wrote
    pymodem::fence_proxy_async();
  };

  const int n_tiles = (T + kTile - 1) / kTile;
  if (copier && n_tiles > 0) fetch(0);
  for (int k = 0; k < n_tiles; ++k) {
    __syncthreads();  // the lanes are done with tile k - 1
    if (copier) {
      // store tile k - 1, then load tile k + 1 into the stage of tile
      // k - 2 once its store has read it
      if (k > 0) store(k - 1);
      pymodem::bulk_wait_read<1>();
      if (k + 1 < n_tiles) fetch(k + 1);
    } else if (active) {
      run(k);
    }
  }
  __syncthreads();
  if (copier) {
    if (n_tiles > 0) store(n_tiles - 1);
    pymodem::bulk_wait_all();
  }
}

// K15's dynamic shared memory for ``pd_entries`` staged detector-table
// entries (0: read through the read-only cache)
size_t mpsk_smem_bytes(int pd_entries) {
  return kTileBytes + sizeof(double2) * kTableSize +
         sizeof(double) * static_cast<size_t>(pd_entries);
}

template <bool kPdShared>
int launch_mpsk(const double* re, const double* im, int in_stride,
                const int* row_of_lane, int R, const double* params,
                const double* sine, const double* cosine,
                const int* pd_tables, const int* pd_index, double* out_re,
                double* out_im, int out_stride, int L, int T, int g,
                int n_tables, cudaStream_t stream) {
  const size_t smem = mpsk_smem_bytes(kPdShared ? n_tables * g * g : 0);
  cudaError_t err = cudaFuncSetAttribute(
      mpsk_loop_f64_kernel<kPdShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks > 0 && T > 0) {
    mpsk_loop_f64_kernel<kPdShared><<<blocks, 2 * kLanes, smem, stream>>>(
        re, im, in_stride, row_of_lane, R, params, sine, cosine, pd_tables,
        pd_index, out_re, out_im, out_stride, L, T, g, n_tables);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K14.  L lanes on (R, T) input rows ``in_stride`` doubles apart (lane l
// on row row_of_lane[l] < R); params (17, L) with the AGC fused (agc = 1)
// or (12, L) without (PLL_PARAMS, BRANCH_PARAMS, AGC_PARAMS); the two
// (256,) tables; out_i, out_q (L, T) rows ``out_stride`` apart; rows
// 16-byte aligned with strides that are multiples of 2 and >= T
// (lane_tiles_f64.cuh; dsp/loops.py pads other rows).
extern "C" int qpsk_costas_f64_lanes(const double* x, int in_stride,
                                     const int* row_of_lane, int R,
                                     const double* params, const double* sine,
                                     const double* cosine, double* out_i,
                                     double* out_q, int out_stride, int L,
                                     int T, int agc, void* stream) {
  if ((R < 1 && L > 0) || !rows_ok(x, in_stride, T) ||
      !rows_ok(out_i, out_stride, T) || !rows_ok(out_q, out_stride, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return agc ? launch_qpsk<true>(x, in_stride, row_of_lane, R, params, sine,
                                 cosine, out_i, out_q, out_stride, L, T, s)
             : launch_qpsk<false>(x, in_stride, row_of_lane, R, params,
                                  sine, cosine, out_i, out_q, out_stride, L,
                                  T, s);
}

// K14's dynamic shared memory a block, bytes, with the AGC fused (agc = 1)
// or without
extern "C" int qpsk_costas_f64_smem_bytes(int agc) {
  return agc ? QpskForm<true>::kSmemBytes : QpskForm<false>::kSmemBytes;
}

// K15.  re, im rows ``in_stride`` doubles apart, both 16-byte aligned
// with a stride that is a multiple of 2 and >= T (lane_tiles_f64.cuh;
// dsp/loops.py mpsk_loop_f64_lanes copies other rails into rows of one
// such stride), lane l on row row_of_lane[l] < R; params (12, L),
// PLL_PARAMS then pd_gain, pd_granularity; the two (256,) tables;
// pd_tables (n_tables, g*g) int32, lane l's table pd_index[l] < n_tables,
// staged in shared memory as doubles (pd_shared = 1) or read through the
// read-only cache (0); out_re, out_im (L, T) rows ``out_stride`` apart,
// aligned as the inputs.
extern "C" int mpsk_loop_f64_lanes(const double* re, const double* im,
                                   int in_stride, const int* row_of_lane,
                                   int R, const double* params,
                                   const double* sine, const double* cosine,
                                   const int* pd_tables, const int* pd_index,
                                   double* out_re, double* out_im,
                                   int out_stride, int L, int T, int g,
                                   int n_tables, int pd_shared,
                                   void* stream) {
  if ((R < 1 && L > 0) || g < 1 || n_tables < 1 ||
      !rows_ok(re, in_stride, T) || !rows_ok(im, in_stride, T) ||
      !rows_ok(out_re, out_stride, T) || !rows_ok(out_im, out_stride, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pd_shared
             ? launch_mpsk<true>(re, im, in_stride, row_of_lane, R, params,
                                 sine, cosine, pd_tables, pd_index, out_re,
                                 out_im, out_stride, L, T, g, n_tables, s)
             : launch_mpsk<false>(re, im, in_stride, row_of_lane, R, params,
                                  sine, cosine, pd_tables, pd_index, out_re,
                                  out_im, out_stride, L, T, g, n_tables, s);
}

// K15's dynamic shared memory a block without detector tables, bytes (8
// more an entry when they are staged)
extern "C" int mpsk_loop_f64_smem_bytes() {
  return static_cast<int>(mpsk_smem_bytes(0));
}
