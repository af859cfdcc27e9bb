// Finish bundle of a launch, hand-written for Hopper (sm_90a).
//
// Computes ratatosk_tpu_torch/correct/finish.py:finish_bundle, bit for bit:
// the banded edit DP of the raw target (rows) against the winning path
// (columns), the open-region acceptance gates, the partial-path trims, the
// 11 int32 decision scalars and the 2-bit-packed winner. The reference
// computes it in plain JAX (ratatosk_tpu/correct/finish.py: a lax.scan
// over every target row of the bucket); no Pallas kernel is replaced. It
// runs on the "auto" route after the fused beam kernel, on the same stream.
//
// One warp per region walks the target rows 0..max(tgt_len, best_end) (no
// row past it is read: best_end <= tgt_len in every batch the engine
// launches). A row of the band is bit-parallel (Myers / Hyyro): the
// differences between neighbouring columns, +1 / -1 as two bit-vectors
// Pv / Mv over the band's columns 1..W-1, K 32-bit words a lane (32K
// columns a lane; K = 1 up to W = 1024, up to 8 for W = 8192), and each
// lane's DP value at the column below its first bit. A row update is the
// edit recurrence over all columns at once: the addition (Eq & Pv) + Pv
// carries across lanes through two ballots and one integer add (a
// carry-lookahead over the lanes), the shift by one column through one
// shuffle. Eq holds the path columns that match the row's IUPAC mask: the
// path's codes are two bit-planes in shared memory, funnel-shifted to the
// window and mapped through the mask's four bits; the next row's Eq is
// loaded while this one runs.
//
// The band is the reference's exactly (_banded_prefix_scan): the window
// [ws(i), ws(i) + W) with ws from _window_start (clamped at both ends; it
// moves by 0 or 1 a row), cells outside it read as BIG. Inside the band
// every value is finite, so an outside cell never wins a minimum and BIG
// and the min(e, BIG) clamp never bind (values stay below NT + L < 2^20):
//   - a row whose window stays: column 0 of the band gets only the cell
//     above (+1, as the full DP's column 0, which is i when ws = 0);
//   - a row whose window moves: the vectors shift down one column, the
//     top column's missing cell above reads as its left neighbour's + 1
//     (never the minimum: a forced +1 difference at column W), and column
//     0's vertical difference is min(sub - d1, 1), d1 the old row's
//     difference at its column 1.
// Columns past best_len never reach columns <= best_len (the recurrence
// reads only columns to the left and above).
//
// Per row the decisions need dmin[i], the least value over columns <=
// best_len, for the first argmax of i - 2*dmin[i] over i <= tgt_len; each
// lane takes its words' least prefix sum from a table of the least prefix
// sum of each (Pv byte, Mv byte) pair (int8, 64 KiB, in shared memory), one
// redux.sync takes the warp's. The max-tie end column is needed only at
// three rows (the argmax, tgt_len, best_end): a copy of each one's vectors
// is kept (selects, no branch in the row loop), and the end columns are
// found at the end, a lane scanning its own bits. The quality gates come from the exact integer sums
// of the clipped qualities (below 2^24, so equal to PyTorch's float32
// cumsum); the float32 divisions and comparisons keep PyTorch's order
// (built with -fmad=false).
//
// What bounds it: the chain of up to NT+1 dependent rows of a region, one
// warp's row update each (two shuffles, two ballots and some twenty
// integer instructions on the chain); bytes and operations are far below
// the card's rates: latency-bound. Regions run in parallel, four warps a
// block.
//
// Plain C interface (bound with ctypes from ratatosk_tpu_torch/ops/
// finish_kernel.py); the launcher never synchronises and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 8;             // 32-bit words a lane
constexpr int kMaxW = 32 * 32 * kMaxK;
constexpr int kWarps = 4;
constexpr int kTable = 1 << 16;      // (Pv byte, Mv byte) -> least prefix sum

// pointer table (ops/finish_kernel.py:PTRS)
enum {
  P_TGT_MASKS, P_TGT_LEN, P_TGT_QUAL, P_BEST_SEQ, P_BEST_LEN, P_BEST_DIST,
  P_BEST_END, P_SECOND_DIST, P_COMPLETED, P_SCALARS, P_SEQ_PACKED,
  P_MINPRE, P_COUNT
};
// int table (ops/finish_kernel.py:INTS)
enum { I_R, I_NT, I_L, I_W, I_QV_MAX, I_MIN_K, I_COUNT };

struct Args {
  const uint8_t* tgt_masks;
  const int* tgt_len;
  const int* tgt_qual;
  const uint8_t* best_seq;
  const int* best_len;
  const int* best_dist;
  const int* best_end;
  const int* second_dist;
  const uint8_t* completed;
  int* scalars;
  int* seq_packed;
  const int8_t* minpre;
  float min_score_open;
  int R, NT, L, W, qv_max, min_k;
  int nbw;        // words of one bit-plane of the path's codes
  int warp_ints;  // shared ints of one warp: 2 bit-planes, then the masks
};

__device__ __forceinline__ int window_start(int i, int seq_len, int l1,
                                            int W) {
  if (W >= l1) return 0;
  const int hi = max(seq_len + 1 - W, 0);
  return min(hi, max(i - W / 2, 0));
}

// mean certified quality of a target prefix against qv_max, floored at
// min_score_open (engine.gate_for); qsum is exact
__device__ __forceinline__ float gate(const Args& a, int qsum, int i) {
  const float qmean = (float)qsum / fmaxf((float)i, 1.0f);
  return fmaxf(a.min_score_open, qmean / fmaxf((float)a.qv_max, 1.0f));
}

// One row's band: the K words of this lane (columns 32K*lane + 1 ..
// 32K*(lane+1)) and the DP value at column 32K*lane.
template <int K>
struct Band {
  uint32_t p[K], m[K];
  int base;
};

// bitwise m ? x : y
__device__ __forceinline__ uint32_t pick(uint32_t m, uint32_t x, uint32_t y) {
  return (m & x) | (~m & y);
}

// The match words of row i for this lane (columns ws+1+32K*lane ..), and
// whether band column 0 (path column ws) matches, for the row's mask
// `amask`: the path's codes are two bit-planes (q0: bit 0 of column j's
// code, q1: bit 1), funnel-shifted to the window; a column matches when
// bit `code` of the mask is set.
template <int K>
__device__ __forceinline__ void match_words(const uint32_t* q0,
                                            const uint32_t* q1, int nbw,
                                            int amask, int ws, int lane,
                                            uint32_t (&eq)[K], bool& m0) {
  const uint32_t a0 = 0u - (amask & 1u), a1 = 0u - ((amask >> 1) & 1u);
  const uint32_t a2 = 0u - ((amask >> 2) & 1u), a3 = 0u - ((amask >> 3) & 1u);
  const int start = ws + 1 + 32 * K * lane;
  const int wd = start >> 5, sh = start & 31;
  uint32_t lo0 = wd < nbw ? q0[wd] : 0u, lo1 = wd < nbw ? q1[wd] : 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool in = wd + k + 1 < nbw;
    const uint32_t hi0 = in ? q0[wd + k + 1] : 0u;
    const uint32_t hi1 = in ? q1[wd + k + 1] : 0u;
    const uint32_t b0 = __funnelshift_r(lo0, hi0, sh);
    const uint32_t b1 = __funnelshift_r(lo1, hi1, sh);
    eq[k] = pick(b1, pick(b0, a3, a2), pick(b0, a1, a0));
    lo0 = hi0;
    lo1 = hi1;
  }
  const int code = (int)((q0[ws >> 5] >> (ws & 31)) & 1u) |
                   (int)(((q1[ws >> 5] >> (ws & 31)) & 1u) << 1);
  m0 = ((amask >> code) & 1) != 0;
}

// One row update of the band (the edit recurrence over every column): the
// window moved (adv) or not; eq the row's match words, m0 whether band
// column 0 matches (read only when the window moved). wbit / wlane / wword:
// where column W's bit lies.
template <int K>
__device__ __forceinline__ void row_update(Band<K>& bd, const uint32_t (&eq0)[K],
                                           bool m0, bool adv, int lane,
                                           int wlane, int wword,
                                           uint32_t wbit) {
  // When the window moved (adv): column W's difference is +1 (the cell
  // above the new top column is outside the band), then everything moves
  // down one column. Column W lies outside the band otherwise, so it is
  // set every row, and the move is a select: no branch.
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t f = (lane == wlane && k == wword) ? wbit : 0u;
    bd.p[k] |= f;
    bd.m[k] &= ~f;
  }
  const int d1 = (int)(bd.p[0] & 1u) - (int)(bd.m[0] & 1u);
  const uint32_t up = __shfl_down_sync(
      kFull, (bd.p[0] & 1u) | ((bd.m[0] & 1u) << 1), 1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t np = k + 1 < K ? bd.p[k + 1] : (up & 1u);
    const uint32_t nm = k + 1 < K ? bd.m[k + 1] : (up >> 1);
    bd.p[k] = adv ? (bd.p[k] >> 1) | (np << 31) : bd.p[k];
    bd.m[k] = adv ? (bd.m[k] >> 1) | (nm << 31) : bd.m[k];
  }
  bd.base += adv ? d1 : 0;  // this lane's base column moves up by one
  // column 0's vertical difference (lane 0's)
  const int hin = adv ? min((m0 ? 0 : 1) - d1, 1) : 1;
  uint32_t eq[K], xv[K], s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    eq[k] = eq0[k];
    xv[k] = eq[k] | bd.m[k];
  }
  if (lane == 0 && hin < 0) eq[0] |= 1u;
  // (eq & pv) + pv over the whole band: within the lane a carry chain,
  // across the lanes a carry-lookahead from two ballots and one add
  uint32_t c = 0, all = kFull;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned long long t =
        (unsigned long long)(eq[k] & bd.p[k]) + bd.p[k] + c;
    s[k] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
    all &= s[k];
  }
  const uint32_t g = __ballot_sync(kFull, c != 0);
  const uint32_t pr = __ballot_sync(kFull, all == kFull);
  const uint32_t gp = g | pr;
  uint32_t cin = (((gp + g) ^ gp ^ g) >> lane) & 1u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s[k] += cin;
    cin = cin && s[k] == 0;
  }
  uint32_t ph[K], mh[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t xh = (s[k] ^ bd.p[k]) | eq[k];
    ph[k] = bd.m[k] | ~(xh | bd.p[k]);
    mh[k] = bd.p[k] & xh;
  }
  // the horizontal differences move up one column; lane 0's column 0 gets
  // hin, every other lane the top column of the lane below
  uint32_t tin = __shfl_up_sync(
      kFull, (ph[K - 1] >> 31) | ((mh[K - 1] >> 31) << 1), 1);
  if (lane == 0) tin = hin > 0 ? 1u : (hin < 0 ? 2u : 0u);
  bd.base += (int)(tin & 1u) - (int)(tin >> 1);
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const uint32_t pin = k ? ph[k - 1] >> 31 : (tin & 1u);
    const uint32_t min_ = k ? mh[k - 1] >> 31 : (tin >> 1);
    const uint32_t php = (ph[k] << 1) | pin;
    const uint32_t mhp = (mh[k] << 1) | min_;
    bd.p[k] = mhp | ~(xv[k] | php);
    bd.m[k] = php & xv[k];
  }
}

// The row's least value over band columns 0..cmax (cmax = min(W-1,
// best_len - ws): columns <= best_len), warp-reduced.
template <int K>
__device__ __forceinline__ int row_min(const Band<K>& bd, int cmax, int lane,
                                       const int8_t* tab) {
  int lim = cmax - 32 * K * lane;  // this lane's valid bits
  lim = min(max(lim, 0), 32 * K);
  // past the last valid bit the masked words add 0: the prefix sums repeat
  // the last valid value. A byte's least prefix sum is its table entry
  // plus the sum of the bytes before it (popcounts, side by side)
  int best = 0, run = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int nb = min(max(lim - 32 * k, 0), 32);
    const uint32_t mask = nb >= 32 ? kFull : ((1u << nb) - 1u);
    const uint32_t p = bd.p[k] & mask, m = bd.m[k] & mask;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t idx = __byte_perm(p, m, t | ((4 + t) << 4)) & 0xffffu;
      const uint32_t below = (1u << (8 * t)) - 1u;
      best = min(best, run + __popc(p & below) - __popc(m & below) +
                           (int)tab[idx]);
    }
    if (K > 1) run += __popc(p) - __popc(m);
  }
  // a lane without a valid column (its base column is past cmax) offers
  // nothing
  return __reduce_min_sync(
      kFull, (lane == 0 || lim > 0) ? bd.base + best : (1 << 30));
}

// The last band column <= cmax whose value is dmin (-1 if none), warp-wide.
template <int K>
__device__ __forceinline__ int end_col(const Band<K>& bd, int cmax, int dmin,
                                       int lane) {
  const int c0 = 32 * K * lane;
  int lim = min(max(cmax - c0, 0), 32 * K);
  int last = ((lane == 0 || lim > 0) && bd.base == dmin) ? c0 : -1;
  int v = bd.base;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    for (int b = 0; b < 32; ++b) {
      if (32 * k + b >= lim) break;
      v += (int)((bd.p[k] >> b) & 1u) - (int)((bd.m[k] >> b) & 1u);
      if (v == dmin) last = c0 + 32 * k + b + 1;
    }
  }
  return __reduce_max_sync(kFull, last);
}

// A row kept for its end column: its band, window start and minimum.
// Bitwise selects keep the row loop free of branches.
template <int K>
struct Snap {
  Band<K> bd;
  int ws, dmin;

  __device__ __forceinline__ void take(const Band<K>& b, int w, int d,
                                       bool on) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      bd.p[k] = on ? b.p[k] : bd.p[k];
      bd.m[k] = on ? b.m[k] : bd.m[k];
    }
    bd.base = on ? b.base : bd.base;
    ws = on ? w : ws;
    dmin = on ? d : dmin;
  }

  // the row's max-tie end column (absolute)
  __device__ __forceinline__ int end_column(int blen, int W, int lane) const {
    return ws + end_col<K>(bd, min(W - 1, blen - ws), dmin, lane);
  }
};

template <int K>
__global__ void __launch_bounds__(32 * kWarps) finish_kernel(const Args a) {
  extern __shared__ uint4 fsm4[];
  int8_t* tab = (int8_t*)fsm4;
  // the least-prefix-sum table, copied by the whole block
#pragma unroll 8
  for (int x = threadIdx.x; x < kTable / 16; x += blockDim.x)
    fsm4[x] = __ldg((const uint4*)a.minpre + x);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= a.R) return;  // the whole warp: no block barrier follows
  const int L = a.L, l1 = L + 1, W = a.W, NT = a.NT, nbw = a.nbw;
  uint32_t* q0 = (uint32_t*)(tab + kTable) + (size_t)warp * a.warp_ints;
  uint32_t* q1 = q0 + nbw;
  uint8_t* tm = (uint8_t*)(q1 + nbw);
  const uint8_t* seq = a.best_seq + (size_t)r * L;
  // the path's codes (clamped at 3) as two bit-planes: bit j of q0 / q1 is
  // bit 0 / 1 of path column j's code (1..L; column 0's is never read), a
  // warp's 32 columns a ballot
#pragma unroll 4
  for (int wd = 0; wd < nbw; ++wd) {
    const int j = 32 * wd + lane;
    const int c = (j >= 1 && j <= L) ? min((int)seq[j - 1], 3) : 0;
    const uint32_t b0 = __ballot_sync(kFull, c & 1);
    const uint32_t b1 = __ballot_sync(kFull, c >> 1);
    if (lane == 0) {
      q0[wd] = b0;
      q1[wd] = b1;
    }
  }
  const int n = a.tgt_len[r], blen = a.best_len[r];
  const int end = min(max(a.best_end[r], 0), NT);
  const int last = min(max(n, end), NT);
  const uint8_t* tg = a.tgt_masks + (size_t)r * NT;
#pragma unroll 4
  for (int x = lane; x < last; x += 32) tm[x] = tg[x];
  __syncwarp();

  // where column W's bit lies (bit W-1 of the band)
  const int wlane = (W - 1) / (32 * K), wword = ((W - 1) / 32) % K;
  const uint32_t wbit = 1u << ((W - 1) & 31);

  // row 0: E[0][j] = j at window 0
  Band<K> bd;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bd.p[k] = kFull;
    bd.m[k] = 0u;
  }
  bd.base = 32 * K * lane;
  int ws = window_start(0, blen, l1, W);
  // the rows whose end columns the decisions read, kept as they were: the
  // first argmax of i - 2*dmin[i] over i <= tgt_len, tgt_len, best_end
  Snap<K> s_ib{bd, ws, 0}, s_n = s_ib, s_e = s_ib;
  int best_p = 0, ibest = 0;
  // row r's minimum, the argmax test and the copies (row 0 is better)
  auto consume = [&](int r, const Band<K>& b, int w) {
    const int dmin = row_min<K>(b, min(W - 1, blen - w), lane, tab);
    const bool better = r <= n && (r == 0 || r - 2 * dmin > best_p);
    best_p = better ? r - 2 * dmin : best_p;
    ibest = better ? r : ibest;
    s_ib.take(b, w, dmin, better);
    s_n.take(b, w, dmin, r == n);
    s_e.take(b, w, dmin, r == end);
  };
  // the next row's inputs, loaded a row ahead (past the last row: loaded,
  // not used)
  uint32_t eqn[K];
  bool m0n;
  int wsn = window_start(1, blen, l1, W);
  match_words<K>(q0, q1, nbw, tm[0], wsn, lane, eqn, m0n);
  // No branch in the loop, and each iteration updates row i and consumes
  // row i-1: the compiler overlaps the minimum with the next row's chain.
  Band<K> prev = bd;
  int ws_prev = ws;
  for (int i = 1; i <= last; ++i) {
    uint32_t eq[K];
#pragma unroll
    for (int k = 0; k < K; ++k) eq[k] = eqn[k];
    const bool m0 = m0n;
    const bool adv = wsn - ws == 1;
    ws = wsn;
    wsn = window_start(i + 1, blen, l1, W);
    match_words<K>(q0, q1, nbw, tm[min(i, last - 1)], wsn, lane, eqn,
                   m0n);
    row_update<K>(bd, eq, m0, adv, lane, wlane, wword, wbit);
    consume(i - 1, prev, ws_prev);
    prev = bd;
    ws_prev = ws;
  }
  consume(last, prev, ws_prev);
  const int endc_ib = s_ib.end_column(blen, W, lane);
  const int endc_n = s_n.end_column(blen, W, lane);
  const int endc_e = s_e.end_column(blen, W, lane);
  const int dmin_ib = s_ib.dmin, dmin_n = s_n.dmin, dmin_e = s_e.dmin;

  // exact prefix sums of the clipped qualities at n and at ibest
  const int* q = a.tgt_qual + (size_t)r * NT;
  int qs_n = 0, qs_ib = 0;
  for (int x = lane; x < max(n, ibest); x += 32) {
    const int v = min(q[x], a.qv_max);
    if (x < n) qs_n += v;
    if (x < ibest) qs_ib += v;
  }
  qs_n = __reduce_add_sync(kFull, qs_n);
  qs_ib = __reduce_add_sync(kFull, qs_ib);

  if (lane == 0) {
    const float s1_full = 1.0f - (float)dmin_n / (float)max(n, 1);
    const bool accept_full = s1_full >= gate(a, qs_n, n);
    const int istar = accept_full ? n : ibest;
    const int dm = accept_full ? dmin_n : dmin_ib;
    const int jend = accept_full ? endc_n : endc_ib;
    const int qs = accept_full ? qs_n : qs_ib;
    const float s1_open = 1.0f - (float)dm / (float)max(istar, 1);
    bool ok = blen > 0 &&
              (accept_full || (istar >= a.min_k && s1_open >= gate(a, qs, istar)));
    ok = ok && jend > 0;
    int* out = a.scalars + (size_t)r * 11;
    out[0] = blen;
    out[1] = a.best_dist[r];
    out[2] = a.best_end[r];
    out[3] = a.second_dist[r];
    out[4] = a.completed[r] != 0;
    out[5] = istar;
    out[6] = jend;
    out[7] = (int)(s1_open * 1000000.0f);
    out[8] = ok;
    out[9] = dmin_e;
    out[10] = endc_e;
  }
  // 16 codes per int32 word, code t at bits 2t (the low 32 bits of the sum)
  const int nw = (L + 15) / 16;
  for (int wd = lane; wd < nw; wd += 32) {
    unsigned long long v = 0;
    for (int t = 0; t < 16; ++t) {
      const int j = 16 * wd + t;
      if (j < L) v += (unsigned long long)seq[j] << (2 * t);
    }
    a.seq_packed[(size_t)r * nw + wd] = (int)(unsigned)v;
  }
}

template <int K>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      finish_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  finish_kernel<K><<<(a.R + kWarps - 1) / kWarps, 32 * kWarps, smem,
                     stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int finish_bundle_max_width() { return kMaxW; }

extern "C" int finish_bundle_launch(const void* const* ptrs, int n_ptrs,
                                    const long long* ints, int n_ints,
                                    float min_score_open, int device,
                                    void* stream) {
  if (n_ptrs != P_COUNT || n_ints != I_COUNT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.tgt_masks = (const uint8_t*)ptrs[P_TGT_MASKS];
  a.tgt_len = (const int*)ptrs[P_TGT_LEN];
  a.tgt_qual = (const int*)ptrs[P_TGT_QUAL];
  a.best_seq = (const uint8_t*)ptrs[P_BEST_SEQ];
  a.best_len = (const int*)ptrs[P_BEST_LEN];
  a.best_dist = (const int*)ptrs[P_BEST_DIST];
  a.best_end = (const int*)ptrs[P_BEST_END];
  a.second_dist = (const int*)ptrs[P_SECOND_DIST];
  a.completed = (const uint8_t*)ptrs[P_COMPLETED];
  a.scalars = (int*)ptrs[P_SCALARS];
  a.seq_packed = (int*)ptrs[P_SEQ_PACKED];
  a.minpre = (const int8_t*)ptrs[P_MINPRE];
  a.min_score_open = min_score_open;
  a.R = (int)ints[I_R];
  a.NT = (int)ints[I_NT];
  a.L = (int)ints[I_L];
  const int w = (int)ints[I_W];
  a.qv_max = (int)ints[I_QV_MAX];
  a.min_k = (int)ints[I_MIN_K];
  // the full path row when w is 0 or covers it, else a w-wide band
  a.W = (w <= 0 || w >= a.L + 1) ? a.L + 1 : w;
  a.nbw = a.L / 32 + 2;
  a.warp_ints = 2 * a.nbw + (a.NT + 3) / 4;
  const size_t smem = kTable + (size_t)kWarps * a.warp_ints * 4;
  if (a.R < 1 || a.NT < 1 || a.L < 1 || a.W > kMaxW ||
      smem > 227 * 1024 || ((uintptr_t)a.minpre & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // K = ceil(W / 1024) words a lane, rounded up to an instantiated count
  const int k = (a.W + 1023) / 1024;
  if (k <= 1) return launch<1>(a, smem, s);
  if (k <= 2) return launch<2>(a, smem, s);
  if (k <= 4) return launch<4>(a, smem, s);
  return launch<8>(a, smem, s);
}
