// Fused beam search over the unitig graph, hand-written for Hopper (sm_90a).
//
// Replaces, on the "auto" route of ratatosk_tpu_torch/correct/beam.py, the
// Pallas TPU kernel ratatosk_tpu/ops/sprint_pallas.py (sprint_rows /
// _kernel) together with the plain JAX around it in
// ratatosk_tpu/correct/beam.py:beam_search: the branch step (_beam_step),
// the all-frozen while_loop and the winner reconstruction. It computes the
// same BeamResult, bit for bit, as the plain PyTorch version
// (correct/beam.py with impl="torch").
//
// One block per region. A step is the sprint substeps (up to smax-1
// deterministic mid-unitig bases: masked row updates of the E-transformed
// banded edit DP) and the branch step: every entry's <= 4 successors from
// the successor table, their DP stats without the prefix-min scan, the
// completion scoreboard, the float32 score, the top-B rank selection, the
// 512-bin int8 color-signature filter of the winners, the history record
// and the winners' rebuilt rows. After the last step the block picks the
// winner (the selectMostContiguous tie-break) and walks the backpointer
// history back to its path.
//
// The step count T is launch-wide: the reference steps every region while
// any region of the launch has a live, unfrozen entry, and a region that
// froze early can still re-rank its entries and extend its history in the
// steps after (ratatosk_tpu/correct/beam.py:693-744). So two launches on one
// stream: phase 1 runs each region to its own all-frozen step f_r (at most
// lmax), saves its state to global scratch and raises t_launch to f_r with
// atomicMax; phase 2 reloads the state, runs the steps f_r..T-1, picks and
// reconstructs. No host sync between them.
//
// What bounds it: a chain of T dependent steps per region, each a handful
// of warp-synchronous row passes over W <= 512 columns and ~10 block
// barriers, on kilobytes of state per region. The bytes (inputs once,
// outputs once) and the integer operations are far too few to load the
// card: it is latency-bound. What the design does about it: every step's
// state stays on chip (shared memory: the entries, the candidates, the
// target window, the region's color signatures; the band rows too wherever
// 2*B*W ints fit, else they go to an L2-resident global double buffer), a
// warp owns an entry and keeps its row in registers (C = ceil(W/32)
// consecutive columns per lane) from the sprint through the candidates'
// stats, and prefix minima are an in-lane running min plus a 5-step
// __shfl_up_sync scan. The history is written once per step and read back
// in chunks of 32 steps during the reconstruction.
//
// Float32 scores are compared exactly against PyTorch: the library is built
// with -fmad=false (no contraction into FMAs), `/` stays IEEE, every
// literal is float32, and the operations keep PyTorch's order.
//
// Plain C interface (bound with ctypes from ratatosk_tpu_torch/ops/
// beam_kernel.py): a table of pointers, a table of sizes; the launcher
// enqueues one phase on the given stream, never synchronises, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kInf = 1 << 28;
constexpr float kNeg = -1e9f;
constexpr float kCapC = 16.f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxB = 128;
constexpr int kMaxW = 16 * 32;
constexpr int kRegionInts = 32;
constexpr int kHistChunk = 32;
constexpr int kExtPad = 16;
constexpr size_t kSmemRowsLimit = 200 * 1024;

// pointer table (ops/beam_kernel.py:PTRS)
enum {
  P_USEQ, P_UTBL, P_COLOR_SIG, P_TGT_MASKS, P_TGT_LEN, P_START_TIP,
  P_START_OFF, P_END_TIP, P_END_OFF, P_COLORS_SIG, P_COLORS_WSIG,
  P_MAX_PLEN, P_END_CYCLIC, P_STATE, P_ROWS, P_HIST, P_T_LAUNCH, P_F_STEPS,
  P_BEST_SEQ, P_BEST_LEN, P_BEST_DIST, P_BEST_END, P_SECOND_DIST,
  P_COMPLETED, P_N_DONE, P_COUNT
};
// int table (ops/beam_kernel.py:INTS)
enum {
  I_R, I_NT, I_B, I_W, I_LMAX, I_K, I_MIN_COV, I_SMAX, I_N_USEQ, I_N_UTBL,
  I_N_SIG, I_H, I_STATE_WORDS, I_COUNT
};
// region scalars in shared memory (all kRegionInts are saved between the
// phases; G_M.. are per-step scratch)
enum {
  G_PCOUNT, G_CBEST, G_CSTEP, G_CCAND, G_CPLEN, G_CSECOND, G_CNUM, G_CSBITS,
  G_CSCNT, G_HALF, G_M, G_WS, G_WSN, G_DELTA, G_SHIFTS, G_MIN, G_EMIT,
  G_START, G_CUR, G_REM, G_WSALL  // G_WSALL..G_WSALL+8: window starts
};

struct Args {
  const uint8_t* useq;
  const int* utbl;
  const int8_t* color_sig;
  const uint8_t* tgt_masks;
  const int* tgt_len;
  const int* start_tip;
  const int* start_off;
  const int* end_tip;
  const int* end_off;
  const int8_t* colors_sig;
  const int8_t* colors_wsig;
  const int* max_plen;
  const uint8_t* end_cyclic;
  int* state;
  int* rows;
  int* hist;
  int* t_launch;
  int* f_steps;
  uint8_t* best_seq;
  int* best_len;
  int* best_dist;
  int* best_end;
  int* second_dist;
  uint8_t* completed;
  int* n_done;
  long long n_useq;
  int R, NT, B, W, lmax, k, min_cov, smax, n_utbl, n_sig, H, state_words;
  int rows_in_smem;
};

// shared-memory ints of one block: 11 entry arrays, 6 per-entry scratch
// arrays, 9 candidate arrays of 4B, the region scalars, the target window,
// the two color signatures (int8), and the rows when they fit
__host__ __device__ inline size_t smem_ints(int B, int W, int H, bool rows) {
  return (size_t)53 * B + kRegionInts + W + kExtPad + (2 * H + 15) / 16 * 4 +
         (rows ? (size_t)2 * B * W : 0);
}

__device__ __forceinline__ int window_start(int i, int tl, int nt1, int W) {
  if (W >= nt1) return 0;
  const int hi = max(tl + 1 - W, 0);
  return min(max(i - W / 2, 0), hi);
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int s = 16; s; s >>= 1) v = min(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int s = 16; s; s >>= 1) v = max(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int s = 16; s; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

// oriented base at offset o of a unitig (length ul, catalog offset uo,
// direction d), with the reference's clamps on the position and the
// catalog index
__device__ __forceinline__ int oriented_base(const uint8_t* useq,
                                             long long n_useq, int d, int ul,
                                             int uo, int o) {
  int pos = d == 0 ? o : ul - 1 - o;
  pos = min(max(pos, 0), max(ul - 1, 0));
  long long idx = (long long)uo + pos;
  idx = idx < 0 ? 0 : (idx > n_useq - 1 ? n_useq - 1 : idx);
  const int b = useq[idx];
  return d == 0 ? b : 3 - b;
}

// The row's neighbours across the lane boundary; beyond the band reads BIG.
template <int C>
__device__ __forceinline__ void lane_edges(const int (&row)[C], int lane,
                                           int& prv, int& nxt) {
  nxt = __shfl_down_sync(kFull, row[0], 1);
  prv = __shfl_up_sync(kFull, row[C - 1], 1);
  if (lane == 31) nxt = kBig;
  if (lane == 0) prv = kBig;
}

// One masked row update of the E-transformed banded DP (E[i][j] = j +
// min_{l<=j}(D[i][l] - l)): the previous row read at the new window
// (advanced by one column when `shift`), D = min(prev[c-1] + sub,
// prev[c] + 1) with sub = ((bm & mask) == 0) against the target masks
// ext[eo + c], column 0 of the full DP set to col0, D clamped at BIG, then
// the prefix-min scan. Pad columns (c >= W) stay BIG.
template <int C>
__device__ __forceinline__ void row_update(int (&row)[C], int lane, int W,
                                           bool shift, int bm,
                                           const int* ext, int eo, int ws_n,
                                           int col0) {
  int prv, nxt;
  lane_edges<C>(row, lane, prv, nxt);
  const int c0 = lane * C;
  int t[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = c0 + i;
    const int pj = shift ? ((i + 1 < C) ? row[i + 1] : nxt) : row[i];
    const int pjm1 = shift ? row[i] : ((i > 0) ? row[i - 1] : prv);
    const int mask = (c < W) ? ext[eo + c] : 0;
    int d = min(pjm1 + ((bm & mask) == 0 ? 1 : 0), pj + 1);
    const int col = ws_n + c;
    if (col == 0) d = col0;
    d = min(d, kBig);
    t[i] = d - col;
    if (i > 0) t[i] = min(t[i], t[i - 1]);
  }
  // inclusive warp scan of the lanes' tails, then the exclusive prefix of
  // the lanes below folds into each lane's columns
  int tot = t[C - 1];
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int v = __shfl_up_sync(kFull, tot, s);
    if (lane >= s) tot = min(tot, v);
  }
  int below = __shfl_up_sync(kFull, tot, 1);
  if (lane == 0) below = kInf;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = c0 + i;
    row[i] = (c < W) ? min(ws_n + c + min(t[i], below), kBig) : kBig;
  }
}

// (dist_pref, end_max, dist_nw) of one candidate from its D row before the
// scan (the reference's _band_dists_from_d): D built as in row_update from
// the row read at window ws_n.
template <int C>
__device__ __forceinline__ void cand_stats(const int (&row)[C], int prv,
                                           int nxt, int lane, int W,
                                           bool shift, int bm,
                                           const int* ext, int eo, int ws_n,
                                           int col0, int tl, int& dp,
                                           int& em, int& dn) {
  const int c0 = lane * C;
  int msk[C];
  int lmin = kBig, lnw = kBig;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = c0 + i;
    const int pj = shift ? ((i + 1 < C) ? row[i + 1] : nxt) : row[i];
    const int pjm1 = shift ? row[i] : ((i > 0) ? row[i - 1] : prv);
    const int mask = (c < W) ? ext[eo + c] : 0;
    int d = min(pjm1 + ((bm & mask) == 0 ? 1 : 0), pj + 1);
    const int col = ws_n + c;
    if (col == 0) d = col0;
    d = min(d, kBig);
    const bool valid = col <= tl;
    msk[i] = valid ? d : kBig;
    if (c < W) {
      lmin = min(lmin, msk[i]);
      if (valid) lnw = min(lnw, d - col);
    }
  }
  dp = warp_min(lmin);
  int lmax_col = -1;
#pragma unroll
  for (int i = 0; i < C; ++i)
    if (c0 + i < W && msk[i] == dp) lmax_col = ws_n + c0 + i;
  em = warp_max(lmax_col);
  const bool in_win = ws_n <= tl && tl <= ws_n + W - 1;
  dn = in_win ? min(warp_min(lnw) + tl, kBig) : kBig;
}

// (dist_pref, end_max, dist_nw) of a stored row at window ws (the
// reference's _band_dists), for entries that keep their row this step.
template <int C>
__device__ __forceinline__ void row_stats(const int (&row)[C], int lane,
                                          int W, int ws, int tl, int& dp,
                                          int& em, int& dn) {
  const int c0 = lane * C;
  int lmin = kBig, lnw = kBig;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = c0 + i;
    const int col = ws + c;
    if (c < W) {
      lmin = min(lmin, col <= tl ? row[i] : kBig);
      if (col == tl) lnw = min(lnw, row[i]);
    }
  }
  dp = warp_min(lmin);
  int lmax_col = -1;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int col = ws + c0 + i;
    if (c0 + i < W && (col <= tl ? row[i] : kBig) == dp) lmax_col = col;
  }
  em = warp_max(lmax_col);
  dn = warp_min(lnw);
}

__device__ __forceinline__ float entry_score(int eff, int denom, float ccsum,
                                             int nvis) {
  const float align = 1.0f - (float)eff / (float)max(denom, 1);
  const float color = ccsum / (float)max(nvis, 1);
  return 0.5f * fminf(fmaxf(align, -1.0f), 1.0f) + 0.5f * color;
}

template <int C>
__global__ void __launch_bounds__(512)
    beam_kernel(const Args a, const int phase) {
  extern __shared__ int sm[];
  const int r = blockIdx.x;
  const int B = a.B, W = a.W, H = a.H, lmax = a.lmax, smax = a.smax;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int C4 = 4 * B;

  // ---- shared memory ----
  int* e_tip = sm;  // the 11 entry arrays are saved between phases as is
  int* e_off = e_tip + B;
  int* e_plen = e_off + B;
  int* e_live = e_plen + B;
  int* e_cmin = e_live + B;
  int* e_frozen = e_cmin + B;
  int* e_compl = e_frozen + B;
  int* e_fdist = e_compl + B;
  int* e_fend = e_fdist + B;
  float* e_ccsum = (float*)(e_fend + B);
  int* e_nvis = e_fend + 2 * B;
  int* s_sbits = e_tip + 11 * B;
  int* s_scnt = s_sbits + B;
  int* s_sel = s_scnt + B;
  int* s_sh = s_sel + B;
  int* s_wsh = s_sh + B;
  int* s_pop = s_wsh + B;
  int* c_tip = s_pop + B;  // candidate q = 4 * entry + base
  int* c_off = c_tip + C4;
  int* c_plen = c_off + C4;
  int* c_flags = c_plen + C4;  // valid|emits<<1|frozen<<2|compl<<3|branch<<4|rescued<<5
  int* c_fdist = c_flags + C4;
  int* c_fend = c_fdist + C4;
  int* c_nvis = c_fend + C4;
  float* c_score = (float*)(c_nvis + C4);
  int* c_arrd = c_nvis + 2 * C4;
  int* hbuf = c_tip;  // reconstruction: kHistChunk * B <= 36 * B ints
  int* g = c_tip + 9 * C4;
  int* ext = g + kRegionInts;  // target window, then the columns shifted in
  int8_t* csig = (int8_t*)(ext + W + kExtPad);
  int8_t* wsig = csig + H;
  int* rows_sm = ext + W + kExtPad + (2 * H + 15) / 16 * 4;

  // ---- region constants and global scratch ----
  const int NT = a.NT, nt1 = NT + 1;
  const int tl = a.tgt_len[r];
  const int etip = a.end_tip[r], eoff = a.end_off[r];
  const int mplen = a.max_plen[r];
  const bool ecyc = a.end_cyclic[r] != 0;
  const uint8_t* tmask = a.tgt_masks + (size_t)r * NT;
  int* saved = a.state + (size_t)r * a.state_words;
  int* rows_g = a.rows + (size_t)r * 2 * B * W;
  int* hist = a.hist + (size_t)r * lmax * B;
  int* rows_base = a.rows_in_smem ? rows_sm : rows_g;
  const size_t BW = (size_t)B * W;

  for (int h = tid; h < H; h += nthreads) {
    csig[h] = a.colors_sig[(size_t)r * H + h];
    wsig[h] = a.colors_wsig[(size_t)r * H + h];
  }
  if (phase == 1) {
    for (int b = tid; b < B; b += nthreads) {
      e_tip[b] = b == 0 ? a.start_tip[r] : -1;
      e_off[b] = a.start_off[r];
      e_plen[b] = 0;
      e_live[b] = b == 0;
      e_cmin[b] = kBig;
      e_frozen[b] = 0;
      e_compl[b] = 0;
      e_fdist[b] = kBig;
      e_fend[b] = 0;
      e_ccsum[b] = 0.0f;
      e_nvis[b] = 0;
    }
    if (tid == 0) {
      g[G_PCOUNT] = 0;
      g[G_CBEST] = kBig;
      g[G_CSTEP] = 0;
      g[G_CCAND] = 0;
      g[G_CPLEN] = 0;
      g[G_CSECOND] = kBig;
      g[G_CNUM] = 0;
      g[G_CSBITS] = 0;
      g[G_CSCNT] = 0;
      g[G_HALF] = 0;
    }
    // target mask of column j is tgt_masks[j-1]; column 0 reads 0
    for (int c = tid; c < W; c += nthreads) ext[c] = c == 0 ? 0 : tmask[c - 1];
    // row 0 of every entry: E[0][j] = j
    for (size_t x = tid; x < BW; x += nthreads) rows_base[x] = (int)(x % W);
  } else {
    for (int x = tid; x < 11 * B; x += nthreads) sm[x] = saved[x];
    for (int x = tid; x < kRegionInts; x += nthreads)
      g[x] = saved[11 * B + x];
    for (int c = tid; c < W; c += nthreads)
      ext[c] = saved[11 * B + kRegionInts + c];
    __syncthreads();
    if (a.rows_in_smem) {
      const size_t h0 = (size_t)g[G_HALF] * BW;
      for (size_t x = tid; x < BW; x += nthreads)
        rows_sm[h0 + x] = rows_g[h0 + x];
    }
  }
  __syncthreads();
  // the region's color mass (exact: integer sums far below 2^24)
  float mass = 0.0f, wmass = 0.0f;
  {
    int m0 = 0, m1 = 0;
    for (int h = 0; h < H; ++h) {
      m0 += csig[h];
      m1 += wsig[h];
    }
    mass = (float)m0;
    wmass = (float)m1;
  }
  int half = g[G_HALF];

  int i = phase == 1 ? 0 : a.f_steps[r];
  const int i_stop = phase == 1 ? lmax : *(volatile int*)a.t_launch;
  for (; i < i_stop; ++i) {
    // ---- all-frozen exit (phase 1 only) and the sprint length ----
    if (tid == 0) {
      g[G_MIN] = kInf;
      g[G_EMIT] = 0;
    }
    __syncthreads();
    int any_active = 0;
    for (int b = tid; b < B; b += nthreads) {
      if (e_live[b] && !e_frozen[b]) {
        any_active = 1;
        const int tip = e_tip[b], off = e_off[b];
        const int uid = min(max(tip >> 1, 0), a.n_utbl - 1);
        const int ul = a.utbl[((size_t)uid * 2 + (tip & 1)) * 6 + 4];
        const bool on_end = etip >= 0 && tip == etip && off < eoff;
        const int s = min(min(ul - off + 1, on_end ? eoff - off : kInf),
                          mplen - e_plen[b]);
        atomicMin(&g[G_MIN], s);
      }
    }
    any_active = __syncthreads_or(any_active);
    if (phase == 1 && !any_active) break;
    if (tid == 0) {
      const int m = min(max(any_active ? g[G_MIN] - 1 : 0, 0), smax - 1);
      const int pc = g[G_PCOUNT];
      int* wsall = g + G_WSALL;
      for (int j = 0; j <= m; ++j) wsall[j] = window_start(pc + j, tl, nt1, W);
      int shifts = 0;
      for (int j = 0; j < m; ++j)
        if (wsall[j + 1] - wsall[j] == 1) {
          const int f = min(wsall[j + 1] + W - 1, nt1 - 1);
          ext[W + shifts++] = f == 0 ? 0 : tmask[f - 1];
        }
      const int ws = wsall[m];
      const int wsn = window_start(pc + m + 1, tl, nt1, W);
      if (wsn - ws == 1) {
        const int f = min(wsn + W - 1, nt1 - 1);
        ext[W + shifts] = f == 0 ? 0 : tmask[f - 1];
      }
      g[G_M] = m;
      g[G_WS] = ws;
      g[G_WSN] = wsn;
      g[G_DELTA] = wsn - ws;
      g[G_SHIFTS] = shifts;
    }
    __syncthreads();
    const int m = g[G_M], ws = g[G_WS], wsn = g[G_WSN], delta = g[G_DELTA];
    const int shifts = g[G_SHIFTS];
    const int eo = shifts + delta;  // the branch step's target window
    int* rows_cur = rows_base + (size_t)half * BW;
    int* rows_nxt = rows_base + (size_t)(half ^ 1) * BW;

    // ---- per entry (one warp each): sprint, then the 4 candidates ----
    for (int b = warp; b < B; b += nwarps) {
      const int tip = e_tip[b], off = e_off[b], plen = e_plen[b];
      const bool live = e_live[b] != 0, frozen = e_frozen[b] != 0;
      const bool compl_ = e_compl[b] != 0;
      const int fdist = e_fdist[b], fend = e_fend[b], nvis = e_nvis[b];
      const float ccsum = e_ccsum[b];
      const int uid = min(max(tip >> 1, 0), a.n_utbl - 1);
      const int d = tip & 1;
      const int* rc = a.utbl + ((size_t)uid * 2 + d) * 6;
      const int ul = rc[4], uo = rc[5];
      const bool active = live && !frozen;
      const int c0 = lane * C;
      int row[C];
      const int* src = rows_cur + (size_t)b * W;
#pragma unroll
      for (int x = 0; x < C; ++x) row[x] = (c0 + x < W) ? src[c0 + x] : kBig;
      int sbits = 0;
      if (active && m > 0) {
        int sh = 0;
        for (int j = 0; j < m; ++j) {
          const int ws_n = g[G_WSALL + j + 1];
          const bool adv = ws_n - g[G_WSALL + j] == 1;
          sh += adv;
          const int nb = oriented_base(a.useq, a.n_useq, d, ul, uo, off + j);
          sbits |= nb << (2 * j);
          row_update<C>(row, lane, W, adv, 1 << nb, ext, sh, ws_n,
                        plen + j + 1);
        }
        int* dst = rows_cur + (size_t)b * W;
#pragma unroll
        for (int x = 0; x < C; ++x)
          if (c0 + x < W) dst[c0 + x] = row[x];
      }
      if (lane == 0) {
        s_sbits[b] = active ? sbits : 0;
        s_scnt[b] = active ? m : 0;
      }
      const int off2 = off + (active ? m : 0);
      const int plen2 = plen + (active ? m : 0);

      // branch step (the reference's _beam_step) on the sprinted entry
      const bool at_bound = active && off2 >= ul;
      const bool mid = active && off2 < ul;
      const int nb = oriented_base(a.useq, a.n_useq, d, ul, uo, off2);
      int e[4];
      bool resc[4], any_ok = false;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int er = rc[c];
        e[c] = er >= 0 ? (er & ((1 << 30) - 1)) : er;
        resc[c] = er >= 0 && ((er >> 30) & 1);
        any_ok |= e[c] >= 0 && at_bound;
      }
      const bool no_succ = at_bound && !any_ok;
      const bool keep0 = (live && !active) || no_succ;
      int prv, nxt;
      lane_edges<C>(row, lane, prv, nxt);
      int dpk, emk, dnk;
      row_stats<C>(row, lane, W, ws, tl, dpk, emk, dnk);
#pragma unroll 1
      for (int c = 0; c < 4; ++c) {
        const bool keep = keep0 && c == 0;
        const bool valid =
            (at_bound ? (e[c] >= 0 && at_bound) : (mid && c == nb)) || keep;
        const bool emits = valid && !keep;
        const int ctip = keep ? tip : (at_bound ? e[c] : tip);
        const int coff = keep ? off2 : (at_bound ? a.k : off2 + 1);
        const int cpl = emits ? plen2 + 1 : plen2;
        const bool cbranch = at_bound && emits;
        const int cnv = cbranch ? nvis + 1 : nvis;
        const bool arrive =
            emits && etip >= 0 && ctip == etip && coff == eoff;
        const bool ccompl = compl_ || (arrive && !ecyc);
        const bool over = cpl >= mplen;
        const bool cfrozen = frozen || ccompl || over || (no_succ && keep);
        int dp, em, dn;
        cand_stats<C>(row, prv, nxt, lane, W, delta == 1, 1 << c, ext, eo,
                      wsn, cpl, tl, dp, em, dn);
        const int arrd = (arrive && valid) ? dn : kBig;
        if (!emits) {
          dp = dpk;
          em = emk;
          dn = dnk;
        }
        const bool newly = cfrozen && !frozen;
        const int cfd = newly ? (ccompl ? dn : dp) : fdist;
        const int cfe = newly ? (ccompl ? tl : em) : fend;
        const int eff = cfrozen ? cfd : dp;
        const float score =
            valid ? entry_score(eff, ccompl ? tl : max(cpl, 1), ccsum, cnv)
                  : kNeg;
        if (lane == c) {
          const int q = 4 * b + c;
          c_tip[q] = ctip;
          c_off[q] = coff;
          c_plen[q] = cpl;
          c_flags[q] = (int)valid | ((int)emits << 1) | ((int)cfrozen << 2) |
                       ((int)ccompl << 3) | ((int)cbranch << 4) |
                       ((int)(cbranch && resc[c]) << 5);
          c_fdist[q] = cfd;
          c_fend[q] = cfe;
          c_nvis[q] = cnv;
          c_score[q] = score;
          c_arrd[q] = arrd;
          if (emits) g[G_EMIT] = 1;
        }
      }
    }
    __syncthreads();

    // ---- completion scoreboard (warp 0) and top-B selection (all) ----
    if (warp == 0) {
      int m1 = 0x7fffffff, a1 = 0x7fffffff;
      for (int q = lane; q < C4; q += 32) {
        const int v = c_arrd[q];
        if (v < m1) {
          m1 = v;
          a1 = q;
        }
      }
#pragma unroll
      for (int s = 16; s; s >>= 1) {
        const int ov = __shfl_xor_sync(kFull, m1, s);
        const int oa = __shfl_xor_sync(kFull, a1, s);
        if (ov < m1 || (ov == m1 && oa < a1)) {
          m1 = ov;
          a1 = oa;
        }
      }
      int n_eq = 0, n_arr = 0, m2 = kBig;
      for (int q = lane; q < C4; q += 32) {
        const int v = c_arrd[q];
        n_eq += v == m1;
        n_arr += v < kBig;
        if (v > m1) m2 = min(m2, v);
      }
      n_eq = warp_sum(n_eq);
      n_arr = warp_sum(n_arr);
      m2 = warp_min(m2);
      if (lane == 0) {
        if (n_eq >= 2) m2 = m1;
        int v[4] = {g[G_CBEST], g[G_CSECOND], m1, m2};
        for (int x = 1; x < 4; ++x)
          for (int y = x; y > 0 && v[y] < v[y - 1]; --y) {
            const int t = v[y];
            v[y] = v[y - 1];
            v[y - 1] = t;
          }
        if (m1 < g[G_CBEST]) {
          g[G_CSTEP] = i;
          g[G_CCAND] = a1;
          g[G_CPLEN] = c_plen[a1];
          g[G_CSBITS] = s_sbits[a1 >> 2];
          g[G_CSCNT] = s_scnt[a1 >> 2];
        }
        g[G_CBEST] = v[0];
        g[G_CSECOND] = v[1];
        g[G_CNUM] += n_arr;
      }
    }
    // rank = candidates with a higher score, plus equal ones at a lower
    // index (a stable descending sort); the first B win
    for (int q = tid; q < C4; q += nthreads) {
      const float sq = c_score[q];
      int rank = 0;
      for (int p = 0; p < C4; ++p) {
        const float sp = c_score[p];
        rank += (sp > sq) || (sp == sq && p < q);
      }
      if (rank < B) s_sel[rank] = q;
    }
    __syncthreads();

    // ---- the winners' color signatures against the region's ----
    for (int kk = warp; kk < B; kk += nwarps) {
      const int ctip = c_tip[s_sel[kk]];
      const int uid = min(max(ctip >> 1, 0), a.n_sig - 1);
      const int8_t* sig = a.color_sig + (size_t)uid * H;
      int sh = 0, wsh = 0, pop = 0;
      for (int h = lane; h < H; h += 32) {
        const int s = sig[h];
        sh += s * csig[h];
        wsh += s * wsig[h];
        pop += s;
      }
      sh = warp_sum(sh);
      wsh = warp_sum(wsh);
      pop = warp_sum(pop);
      if (lane == 0) {
        s_sh[kk] = sh;
        s_wsh[kk] = wsh;
        s_pop[kk] = pop;
      }
    }
    __syncthreads();

    // ---- the new entries (thread k holds slot k) ----
    int n_tip = 0, n_off = 0, n_plen = 0, n_live = 0, n_cmin = 0, n_frozen = 0;
    int n_compl = 0, n_fdist = 0, n_fend = 0, n_nvis = 0;
    float n_ccsum = 0.0f;
    if (tid < B) {
      const int q = s_sel[tid], par = q >> 2, fl = c_flags[q];
      const bool emit = (fl >> 1) & 1, branch = (fl >> 4) & 1;
      const bool rescued = (fl >> 5) & 1;
      n_tip = c_tip[q];
      n_off = c_off[q];
      n_plen = c_plen[q];
      n_frozen = (fl >> 2) & 1;
      n_compl = (fl >> 3) & 1;
      n_fdist = c_fdist[q];
      n_fend = c_fend[q];
      n_nvis = c_nvis[q];
      n_ccsum = e_ccsum[par];
      bool live = (fl & 1) && c_score[q] > kNeg / 2;
      // collision-bias correction: the expected overlap of unrelated sets,
      // pop(u) * mass(region) / bins
      const float pop = (float)s_pop[tid];
      const float shared = (float)s_sh[tid] - pop * mass / (float)H;
      const float wshared =
          fmaxf((float)s_wsh[tid] - pop * wmass / (float)H, 0.0f);
      const float mc = (float)a.min_cov;
      live = live && (!branch || n_compl || rescued || shared >= mc);
      const float wsh_eff = rescued ? fmaxf(wshared, mc) : wshared;
      if (branch) n_ccsum = n_ccsum + fminf(wsh_eff, kCapC) / kCapC;
      const float sh_eff = rescued ? fmaxf(shared, mc) : shared;
      const float cm = (float)e_cmin[par];
      n_cmin = (int)(branch ? fminf(cm, sh_eff) : cm);
      n_live = live;
      // history: base(2) | emitted(1) | parent(7) | sprint count(3) |
      // sprint bases(14)
      hist[(size_t)i * B + tid] = (q & 3) | ((int)emit << 2) | (par << 3) |
                                  (s_scnt[par] << 10) | (s_sbits[par] << 13);
    }
    __syncthreads();
    if (tid < B) {
      e_tip[tid] = n_tip;
      e_off[tid] = n_off;
      e_plen[tid] = n_plen;
      e_live[tid] = n_live;
      e_cmin[tid] = n_cmin;
      e_frozen[tid] = n_frozen;
      e_compl[tid] = n_compl;
      e_fdist[tid] = n_fdist;
      e_fend[tid] = n_fend;
      e_ccsum[tid] = n_ccsum;
      e_nvis[tid] = n_nvis;
    }
    if (tid == 0) g[G_PCOUNT] += m + g[G_EMIT];

    // ---- the winners' rows: the parent's, advanced when it emitted ----
    for (int kk = warp; kk < B; kk += nwarps) {
      const int q = s_sel[kk];
      const int c0 = lane * C;
      int row[C];
      const int* src = rows_cur + (size_t)(q >> 2) * W;
#pragma unroll
      for (int x = 0; x < C; ++x) row[x] = (c0 + x < W) ? src[c0 + x] : kBig;
      if ((c_flags[q] >> 1) & 1)
        row_update<C>(row, lane, W, delta == 1, 1 << (q & 3), ext, eo, wsn,
                      c_plen[q]);
      int* dst = rows_nxt + (size_t)kk * W;
#pragma unroll
      for (int x = 0; x < C; ++x)
        if (c0 + x < W) dst[c0 + x] = row[x];
    }
    half ^= 1;
    __syncthreads();
    // the carried target window becomes the branch step's
    if (eo > 0) {
      for (int base = 0; base < W; base += nthreads) {
        const int c = base + tid;
        const int v = c < W ? ext[c + eo] : 0;
        __syncthreads();
        if (c < W) ext[c] = v;
        __syncthreads();
      }
    }
  }

  if (phase == 1) {
    if (tid == 0) {
      a.f_steps[r] = i;
      atomicMax(a.t_launch, i);
      g[G_HALF] = half;
    }
    __syncthreads();
    for (int x = tid; x < 11 * B; x += nthreads) saved[x] = sm[x];
    for (int x = tid; x < kRegionInts; x += nthreads)
      saved[11 * B + x] = g[x];
    for (int c = tid; c < W; c += nthreads)
      saved[11 * B + kRegionInts + c] = ext[c];
    if (a.rows_in_smem) {
      const size_t h0 = (size_t)half * BW;
      for (size_t x = tid; x < BW; x += nthreads)
        rows_g[h0 + x] = rows_sm[h0 + x];
    }
    return;
  }

  // ---- phase 2: the final pick after T = i_stop steps ----
  const int T = i_stop;
  for (int b = tid; b < B; b += nthreads)
    c_score[b] = e_live[b] ? entry_score(e_fdist[b],
                                         e_compl[b] ? tl : max(e_plen[b], 1),
                                         e_ccsum[b], e_nvis[b])
                           : kNeg;
  uint8_t* seq = a.best_seq + (size_t)r * lmax;
  for (int x = tid; x < lmax; x += nthreads) seq[x] = 0;
  __syncthreads();
  if (tid == 0) {
    const float* es = c_score;
    // stable descending order: o0 first, o1 second
    int o0 = 0;
    for (int b = 1; b < B; ++b)
      if (es[b] > es[o0]) o0 = b;
    int o1 = o0;
    if (B > 1) {
      o1 = -1;
      for (int b = 0; b < B; ++b)
        if (b != o0 && (o1 < 0 || es[b] > es[o1])) o1 = b;
    }
    // selectMostContiguous tie-break: among entries within float tolerance
    // of the best score, the highest weakest-link junction support wins
    const float thr = es[o0] - 1e-6f;
    int b0 = 0, best = 0;
    for (int b = 0; b < B; ++b) {
      const int v = (e_live[b] && es[b] >= thr) ? e_cmin[b] + 1 : 0;
      if (b == 0 || v > best) {
        best = v;
        b0 = b;
      }
    }
    const int b1 = o0 == b0 ? o1 : o0;
    const bool any_ok = e_live[b0] && e_fdist[b0] < kBig;
    const int second_fb = (e_live[b1] && b1 != b0) ? e_fdist[b1] : kBig;
    const bool has_c = g[G_CNUM] > 0;
    const int blen_fb = any_ok ? e_plen[b0] : 0;
    const int cplen = g[G_CPLEN], cscnt = g[G_CSCNT], csbits = g[G_CSBITS];
    a.best_len[r] = has_c ? cplen : blen_fb;
    a.best_dist[r] = has_c ? g[G_CBEST] : (any_ok ? e_fdist[b0] : kBig);
    a.best_end[r] = has_c ? tl : (any_ok ? e_fend[b0] : 0);
    a.second_dist[r] = has_c ? g[G_CSECOND] : second_fb;
    a.completed[r] = has_c;
    a.n_done[r] = g[G_CNUM];
    g[G_START] = has_c ? g[G_CSTEP] - 1 : T - 1;
    g[G_CUR] = has_c ? g[G_CCAND] >> 2 : b0;
    g[G_REM] = has_c ? cplen - 1 - cscnt : blen_fb;
    // the arrival's own base and its parent's sprint bases
    if (has_c && cplen > 0) seq[min(max(cplen - 1, 0), lmax - 1)] =
        g[G_CCAND] & 3;
    for (int jj = 0; jj < smax - 1; ++jj)
      if (has_c && jj < cscnt)
        seq[min(max(cplen - 1 - cscnt + jj, 0), lmax - 1)] =
            (csbits >> (2 * jj)) & 3;
  }
  __syncthreads();
  // walk the backpointers from the start step down to 0, 32 steps of
  // history at a time in shared memory
  const int start = min(g[G_START], lmax - 1);
  int cur = g[G_CUR], rem = g[G_REM];
  for (int hi = start; hi >= 0; hi -= kHistChunk) {
    const int lo = max(hi - kHistChunk + 1, 0);
    const int n = (hi - lo + 1) * B;
    for (int x = tid; x < n; x += nthreads) hbuf[x] = hist[(size_t)lo * B + x];
    __syncthreads();
    if (tid == 0) {
      for (int idx = hi; idx >= lo; --idx) {
        const int hsel =
            (cur >= 0 && cur < B) ? hbuf[(idx - lo) * B + cur] : 0;
        if (((hsel >> 2) & 1) && rem > 0) {
          if (rem - 1 < lmax) seq[rem - 1] = hsel & 3;
          --rem;
        }
        // sprint bases precede the branch base: written backward
        const int hscnt = (hsel >> 10) & 7, hsbits = (hsel >> 13) & 0x3FFF;
        for (int jj = 0; jj < smax - 1; ++jj) {
          if (jj < hscnt && rem > 0) {
            const int sh = max(2 * (hscnt - 1 - jj), 0);
            if (rem - 1 < lmax) seq[rem - 1] = (hsbits >> sh) & 3;
            --rem;
          }
        }
        cur = (hsel >> 3) & 127;
      }
    }
    __syncthreads();
  }
}

template <int C>
int launch(const Args& a, int phase, cudaStream_t stream) {
  const int nthreads = 32 * (a.B < 16 ? a.B : 16);
  const size_t smem = smem_ints(a.B, a.W, a.H, a.rows_in_smem) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      beam_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  beam_kernel<C><<<a.R, nthreads, smem, stream>>>(a, phase);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int beam_search_max_width() { return kMaxW; }

extern "C" int beam_search_launch(const void* const* ptrs, int n_ptrs,
                                  const long long* ints, int n_ints,
                                  int phase, int device, void* stream) {
  if (n_ptrs != P_COUNT || n_ints != I_COUNT || (phase != 1 && phase != 2))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.useq = (const uint8_t*)ptrs[P_USEQ];
  a.utbl = (const int*)ptrs[P_UTBL];
  a.color_sig = (const int8_t*)ptrs[P_COLOR_SIG];
  a.tgt_masks = (const uint8_t*)ptrs[P_TGT_MASKS];
  a.tgt_len = (const int*)ptrs[P_TGT_LEN];
  a.start_tip = (const int*)ptrs[P_START_TIP];
  a.start_off = (const int*)ptrs[P_START_OFF];
  a.end_tip = (const int*)ptrs[P_END_TIP];
  a.end_off = (const int*)ptrs[P_END_OFF];
  a.colors_sig = (const int8_t*)ptrs[P_COLORS_SIG];
  a.colors_wsig = (const int8_t*)ptrs[P_COLORS_WSIG];
  a.max_plen = (const int*)ptrs[P_MAX_PLEN];
  a.end_cyclic = (const uint8_t*)ptrs[P_END_CYCLIC];
  a.state = (int*)ptrs[P_STATE];
  a.rows = (int*)ptrs[P_ROWS];
  a.hist = (int*)ptrs[P_HIST];
  a.t_launch = (int*)ptrs[P_T_LAUNCH];
  a.f_steps = (int*)ptrs[P_F_STEPS];
  a.best_seq = (uint8_t*)ptrs[P_BEST_SEQ];
  a.best_len = (int*)ptrs[P_BEST_LEN];
  a.best_dist = (int*)ptrs[P_BEST_DIST];
  a.best_end = (int*)ptrs[P_BEST_END];
  a.second_dist = (int*)ptrs[P_SECOND_DIST];
  a.completed = (uint8_t*)ptrs[P_COMPLETED];
  a.n_done = (int*)ptrs[P_N_DONE];
  a.n_useq = ints[I_N_USEQ];
  a.R = (int)ints[I_R];
  a.NT = (int)ints[I_NT];
  a.B = (int)ints[I_B];
  a.W = (int)ints[I_W];
  a.lmax = (int)ints[I_LMAX];
  a.k = (int)ints[I_K];
  a.min_cov = (int)ints[I_MIN_COV];
  a.smax = (int)ints[I_SMAX];
  a.n_utbl = (int)ints[I_N_UTBL];
  a.n_sig = (int)ints[I_N_SIG];
  a.H = (int)ints[I_H];
  a.state_words = (int)ints[I_STATE_WORDS];
  if (a.R < 1 || a.NT < 1 || a.B < 1 || a.B > kMaxB || a.W < 1 ||
      a.W > kMaxW || a.W > a.NT + 1 || a.lmax < 1 || a.smax < 1 ||
      a.smax > 8 || a.n_utbl < 1 || a.n_sig < 1 || a.n_useq < 1 ||
      a.H < 1 || a.state_words < 11 * a.B + kRegionInts + a.W)
    return (int)cudaErrorInvalidValue;
  // the rows stay in shared memory when both buffers fit beside the rest
  a.rows_in_smem =
      smem_ints(a.B, a.W, a.H, true) * sizeof(int) <= kSmemRowsLimit;
  if (smem_ints(a.B, a.W, a.H, a.rows_in_smem) * sizeof(int) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // C = ceil(W/32) columns per lane, rounded up to an instantiated width
  const int c = (a.W + 31) / 32;
  if (c <= 2) return launch<2>(a, phase, s);
  if (c <= 4) return launch<4>(a, phase, s);
  if (c <= 6) return launch<6>(a, phase, s);
  if (c <= 9) return launch<9>(a, phase, s);
  if (c <= 11) return launch<11>(a, phase, s);
  if (c <= 13) return launch<13>(a, phase, s);
  return launch<16>(a, phase, s);
}
