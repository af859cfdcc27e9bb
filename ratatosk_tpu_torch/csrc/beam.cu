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
// A warp owns a region; a block holds 1-4 regions (enough blocks to cover
// the 132 SMs), and a step has no block barrier, only warp-synchronous
// code. A step is the sprint substeps (up to smax-1 deterministic
// mid-unitig bases: masked row updates of the E-transformed banded edit DP)
// and the branch step: each entry's <= 4 successors, their DP stats, the
// completion scoreboard, the float32 score, the top-B rank, the 512-bin
// int8 color-signature filter, the history record and the winners' rows.
// After the last step the warp picks the winner (the selectMostContiguous
// tie-break) and walks the backpointer history back to its path.
//
// Work only where the result reads it (correct/beam.py:
// beam_search_by_region says why each is exact):
// - only live, unfrozen ("active") entries sprint, load their records,
//   rows and bases, and get DP stats; their four candidates' stats come
//   from one pass over the row. A frozen live entry only scores its keep
//   candidate; a dead slot gets nothing;
// - only valid candidates are ranked, by (score descending, index q =
//   4*slot + base ascending): where the reference's stable sort over all
//   4B puts them. Slots past the valid count are dead and never read;
// - the color product (128 packed words with __dp4a, one warp sum) only
//   for a winner that branches, the row rebuild only for a winner that
//   stays live and unfrozen;
// - the launch-wide step count T (ratatosk_tpu/correct/beam.py:693-744):
//   steps past a region's own all-frozen step f_r only re-rank frozen
//   entries, and after step f_r that re-rank is the identity. So launch 1
//   runs each region to f_r, saves its entries and raises T with
//   atomicMax; launch 2 runs the one step f_r where T > f_r (no row work),
//   then picks and walks from min(T, f_r+1)-1. No host sync between them.
//
// What bounds it: the chain of steps of the region that runs longest, and
// the dependent latency of one step of one warp: the sprint's row passes
// (each a pass over C columns a lane, two edge shuffles and a 5-step
// __shfl_up_sync prefix-min scan), the candidates' pass and its
// reductions, the rank and the winners' bookkeeping in shared memory. The
// bytes and integer operations are far too few to load the card. What the
// design does about it: no block barrier and no idle warp (a block's
// regions run independently); warp reductions are single redux.sync
// instructions; the region's target-mask row and color signatures are
// copied into shared memory once, and the carried target window is an
// offset into that row, the window start ws(pcount) (the reference's
// carried window drifts from ws(pcount) only after a step in which nothing
// emits; from then on no entry is active, and only an emitting candidate
// reads the masks). Global loads leave the step's chain: at a unitig end
// lanes 0-3 load the four successors' records while the row is scanned,
// and the winner carries its record to its slot; the next <= 8 bases of up
// to four active entries come in one load, lane 8x+j holding base j of
// entry x. A lane owns C = ceil(W/32) consecutive columns of a row; the one
// active entry a region usually holds keeps its row in registers from step
// to step, and other rows go through an L2-resident global double buffer,
// each lane touching only its own columns. The history is written once
// per step and read back in chunks of 32 steps for the walk.
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
constexpr int kMaxW = 32 * 32;  // C <= 32: the stats keys hold a column in 10 bits
constexpr int kRegionInts = 32;
constexpr int kHistChunk = 32;
constexpr int kMaxRegionsPerBlock = 4;
constexpr int kSms = 132;
constexpr size_t kSmemLimit = 200 * 1024;

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
// region scalars (all kRegionInts are saved between the launches)
enum {
  G_PCOUNT, G_CBEST, G_CSTEP, G_CCAND, G_CPLEN, G_CSECOND, G_CNUM, G_CSBITS,
  G_CSCNT
};
// entry fields, B ints each, in the saved order
enum {
  E_TIP, E_OFF, E_PLEN, E_LIVE, E_CMIN, E_FROZEN, E_COMPL, E_FDIST, E_FEND,
  E_CCSUM, E_NVIS, E_COUNT
};
// per-slot scratch, B ints each: sprint bits and count, the successor
// record of an active entry (6: carried from the candidate it won with),
// the active list, the winners' candidate, the winners' color sums and new
// live / ccsum / cmin
enum {
  S_SBITS = E_COUNT, S_SCNT, S_REC, S_ACT = S_REC + 6, S_SEL, S_SH, S_WSH,
  S_POP, S_LIVE, S_CCSUM, S_CMIN, S_COUNT
};
// candidate fields, 4B ints each (valid candidates only, in any order);
// C_REC..C_REC+5: the successor record of an emitting candidate
enum {
  C_Q, C_TIP, C_OFF, C_PLEN, C_FLAGS, C_FDIST, C_FEND, C_NVIS, C_SCORE,
  C_ARRD, C_REC, C_COUNT = C_REC + 6
};
// candidate flags
enum { F_EMITS = 1, F_FROZEN = 2, F_COMPL = 4, F_BRANCH = 8, F_RESCUED = 16 };

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
  int region_ints, regions_per_block;
};

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// ints of one region's shared memory: entries, scalars, slot scratch and
// candidates, then the target-mask row (after 16 bytes whose last is
// column 0's mask) and the two color signatures as bytes, each 16-byte
// aligned
__host__ __device__ inline int ints_fixed(int B) {
  return round4(S_COUNT * B + 4 * B * C_COUNT + kRegionInts);
}
__host__ __device__ inline int ints_bytes(int n) { return (n + 15) / 16 * 4; }
__host__ __device__ inline int region_ints(int B, int NT, int H) {
  return ints_fixed(B) + ints_bytes(NT + 16) + 2 * ints_bytes(H);
}

__device__ __forceinline__ int window_start(int i, int tl, int nt1, int W) {
  if (W >= nt1) return 0;
  const int hi = max(tl + 1 - W, 0);
  return min(max(i - W / 2, 0), hi);
}

// warp reductions: one redux.sync each (sm_80 and later)
__device__ __forceinline__ int warp_min(int v) {
  return __reduce_min_sync(kFull, v);
}

__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(kFull, v);
}

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(kFull, v);
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

// the target mask of absolute column col: tm[col], tm[0] = 0 and tm[j] the
// region's mask j-1
__device__ __forceinline__ int col_mask(const uint8_t* tm, int col, int NT) {
  return tm[min(col, NT)];
}

// copy n bytes global -> shared with 16-byte loads where both are aligned
__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src,
                                          int n, int lane) {
  if (((uintptr_t)src & 15) == 0 && (n & 15) == 0) {
    const int4* s = (const int4*)src;
    int4* d = (int4*)dst;
    for (int x = lane; x < n / 16; x += 32) d[x] = __ldg(s + x);
  } else {
    for (int x = lane; x < n; x += 32) dst[x] = src[x];
  }
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
// min_{l<=j}(D[i][l] - l)) into out: the previous row read at the new
// window (advanced by one column when `shift`), D = min(prev[c-1] + sub,
// prev[c] + 1) with sub = 1 unless base b's bit is in the target mask of
// column ws_n + c, column 0 of the full DP set to col0, D clamped at BIG,
// then the prefix-min scan. Pad columns (c >= W) stay BIG.
template <int C>
__device__ __forceinline__ void row_update(const int (&row)[C], int (&out)[C],
                                           int lane, int W, bool shift, int b,
                                           const uint8_t* tm, int NT,
                                           int ws_n, int col0) {
  int prv, nxt;
  lane_edges<C>(row, lane, prv, nxt);
  const int c0 = lane * C;
  int t[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = c0 + i;
    const int pj = shift ? ((i + 1 < C) ? row[i + 1] : nxt) : row[i];
    const int pjm1 = shift ? row[i] : ((i > 0) ? row[i - 1] : prv);
    const int col = ws_n + c;
    const int mask = (c < W) ? col_mask(tm, col, NT) : 0;
    int d = min(pjm1 + (((mask >> b) & 1) ? 0 : 1), pj + 1);
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
    out[i] = (c < W) ? min(ws_n + c + min(t[i], below), kBig) : kBig;
  }
}

// (dist_pref, end_max, dist_nw) of the four candidates from their D rows
// before the scan (the reference's _band_dists_from_d), all from one pass
// over the row read at window ws_n, the four reductions side by side;
// dist_nw only for the bases in `nw` (warp-uniform: it is read only by an
// arrival). dist_pref and end_max come from one minimum of the key
// (masked D << 10 | 1023 - c): the least D, and among its columns the
// last.
template <int C>
__device__ __forceinline__ void cand_stats(const int (&row)[C], int lane,
                                           int W, bool shift,
                                           unsigned nw, const uint8_t* tm,
                                           int NT, int ws_n, int col0, int tl,
                                           int (&dp)[4], int (&em)[4],
                                           int (&dn)[4]) {
  int prv, nxt;
  lane_edges<C>(row, lane, prv, nxt);
  const int c0 = lane * C;
  int key[4], lnw[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    key[b] = 0x7fffffff;
    lnw[b] = kBig;
  }
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = c0 + i;
    if (c < W) {
      const int pj = shift ? ((i + 1 < C) ? row[i + 1] : nxt) : row[i];
      const int pjm1 = shift ? row[i] : ((i > 0) ? row[i - 1] : prv);
      const int col = ws_n + c;
      const int mask = col_mask(tm, col, NT);
      const bool valid = col <= tl;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int d = min(pjm1 + (((mask >> b) & 1) ? 0 : 1), pj + 1);
        if (col == 0) d = col0;
        d = min(d, kBig);
        key[b] = min(key[b], ((valid ? d : kBig) << 10) | (1023 - c));
        if (valid) lnw[b] = min(lnw[b], d - col);
      }
    }
  }
  const bool in_win = ws_n <= tl && tl <= ws_n + W - 1;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int kk = warp_min(key[b]);
    dp[b] = kk >> 10;
    em[b] = ws_n + 1023 - (kk & 1023);
  }
#pragma unroll
  for (int b = 0; b < 4; ++b)
    dn[b] = ((nw >> b) & 1) && in_win ? min(warp_min(lnw[b]) + tl, kBig)
                                      : kBig;
}

// (dist_pref, end_max) of a stored row at window ws (the reference's
// _band_dists), for an entry that keeps its row and freezes
template <int C>
__device__ __forceinline__ void row_stats(const int (&row)[C], int lane,
                                          int W, int ws, int tl, int& dp,
                                          int& em) {
  const int c0 = lane * C;
  int key = 0x7fffffff;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = c0 + i;
    if (c < W) key = min(key, ((ws + c <= tl ? row[i] : kBig) << 10) |
                                  (1023 - c));
  }
  key = warp_min(key);
  dp = key >> 10;
  em = ws + 1023 - (key & 1023);
}

__device__ __forceinline__ float entry_score(int eff, int denom, float ccsum,
                                             int nvis) {
  const float align = 1.0f - (float)eff / (float)max(denom, 1);
  const float color = ccsum / (float)max(nvis, 1);
  return 0.5f * fminf(fmaxf(align, -1.0f), 1.0f) + 0.5f * color;
}

template <int C>
__device__ __forceinline__ void load_row(int (&row)[C], const int* src,
                                         int lane, int W) {
  const int c0 = lane * C;
#pragma unroll
  for (int x = 0; x < C; ++x) row[x] = (c0 + x < W) ? src[c0 + x] : kBig;
}

template <int C>
__device__ __forceinline__ void store_row(const int (&row)[C], int* dst,
                                          int lane, int W) {
  const int c0 = lane * C;
#pragma unroll
  for (int x = 0; x < C; ++x)
    if (c0 + x < W) dst[c0 + x] = row[x];
}

// the 512-bin (H-bin) color dot products of a unitig's signature with the
// region's two signatures, and its popcount, summed over the warp: 16 bytes
// a lane at a time with __dp4a where the rows are 16-byte aligned
__device__ __forceinline__ void sig_dot(const int8_t* sig, const int8_t* csig,
                                        const int8_t* wsig, int H, int lane,
                                        int& sh, int& wsh, int& pop) {
  sh = wsh = pop = 0;
  if ((H & 15) == 0 && ((uintptr_t)sig & 15) == 0) {
    const int4* s4 = (const int4*)sig;
    const int4* c4 = (const int4*)csig;
    const int4* w4 = (const int4*)wsig;
    for (int w = lane; w < H / 16; w += 32) {
      const int4 s = __ldg(s4 + w), c = c4[w], v = w4[w];
      sh = __dp4a(s.x, c.x, sh);
      sh = __dp4a(s.y, c.y, sh);
      sh = __dp4a(s.z, c.z, sh);
      sh = __dp4a(s.w, c.w, sh);
      wsh = __dp4a(s.x, v.x, wsh);
      wsh = __dp4a(s.y, v.y, wsh);
      wsh = __dp4a(s.z, v.z, wsh);
      wsh = __dp4a(s.w, v.w, wsh);
      pop = __dp4a(s.x, 0x01010101, pop);
      pop = __dp4a(s.y, 0x01010101, pop);
      pop = __dp4a(s.z, 0x01010101, pop);
      pop = __dp4a(s.w, 0x01010101, pop);
    }
  } else {
    for (int h = lane; h < H; h += 32) {
      const int s = sig[h];
      sh += s * csig[h];
      wsh += s * wsig[h];
      pop += s;
    }
  }
  sh = warp_sum(sh);
  wsh = warp_sum(wsh);
  pop = warp_sum(pop);
}

__device__ __forceinline__ int pick4(const int (&v)[4], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
}

// One region's shared memory and constants (warp-uniform).
struct Region {
  int* e;       // entry fields and slot scratch, B ints each (E_*, S_*)
  int* cand;    // candidate fields, 4B ints each (C_*)
  int* g;       // region scalars (G_*)
  uint8_t* tm;  // target masks of columns 0..NT
  int8_t* csig;
  int8_t* wsig;
  int* rows;    // global [2, B, W]
  int* hist;    // global [lmax, B]
  int tl, etip, eoff, mplen;
  bool ecyc;
  float mass, wmass;
};

// The row of the one active entry a region usually holds stays in
// registers from step to step: `slot` is the entry whose current row they
// hold (-1: none), `dirty` whether global memory lacks it.
template <int C>
struct RowReg {
  int row[C];
  int slot;
  bool dirty;
  int half;
};

// Branch step i of one region (warp-synchronous): the sprint substeps and
// the branch step of its active entries, the keep candidates of its
// frozen live entries, the scoreboard, the rank, the winners. Returns
// false, doing nothing, when launch 1 finds no active entry.
template <int C>
__device__ __forceinline__ bool beam_step(const Args& a, Region& R, int i, int phase,
                          int lane, RowReg<C>& rr) {
  const int B = a.B, W = a.W, NT = a.NT, nt1 = NT + 1, tl = R.tl;
  const int C4 = 4 * B;
  int* e = R.e;
  int* g = R.g;
  float* eccsum = (float*)(e + E_CCSUM * B);
  int* s_act = e + S_ACT * B;
  int* s_rec = e + S_REC * B;
  int* s_sel = e + S_SEL * B;
  int* cq = R.cand + C_Q * C4;
  float* cs = (float*)(R.cand + C_SCORE * C4);
  const unsigned below = (1u << lane) - 1;
#define EF(f) (e + (f) * B)
#define CF(f) (R.cand + (f) * C4)

  // ---- the active entries and the sprint length ----
  int na = 0, smin = kInf;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    bool act = false;
    if (b < B && EF(E_LIVE)[b] && !EF(E_FROZEN)[b]) {
      act = true;
      const int tip = EF(E_TIP)[b], off = EF(E_OFF)[b];
      const bool on_end = R.etip >= 0 && tip == R.etip && off < R.eoff;
      smin = min(smin, min(min(s_rec[6 * b + 4] - off + 1,
                               on_end ? R.eoff - off : kInf),
                           R.mplen - EF(E_PLEN)[b]));
    }
    const unsigned bal = __ballot_sync(kFull, act);
    if (act) s_act[na + __popc(bal & below)] = b;
    na += __popc(bal);
  }
  if (phase == 1 && na == 0) return false;
  __syncwarp();
  // the bases at off .. off+7 of the first four active entries in one
  // load, lane 8x+j holding base j of active entry x
  int pfb = 0;
  if ((lane >> 3) < na) {
    const int b = s_act[lane >> 3];
    const int* rec = s_rec + 6 * b;
    pfb = oriented_base(a.useq, a.n_useq, EF(E_TIP)[b] & 1, rec[4], rec[5],
                        EF(E_OFF)[b] + (lane & 7));
  }
  smin = warp_min(smin);
  const int m = na ? min(max(smin - 1, 0), a.smax - 1) : 0;
  const int pc = g[G_PCOUNT];
  const int ws = window_start(pc + m, tl, nt1, W);
  const int wsn = window_start(pc + m + 1, tl, nt1, W);
  const bool shift = wsn - ws == 1;
  int nv = 0;  // valid candidates
  bool any_emit = false, any_arr = false;

  // ---- frozen live entries: their keep candidate, one lane each ----
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    const bool kp = b < B && EF(E_LIVE)[b] && EF(E_FROZEN)[b];
    const unsigned bal = __ballot_sync(kFull, kp);
    if (kp) {
      const int x = nv + __popc(bal & below);
      const int plen = EF(E_PLEN)[b], nvis = EF(E_NVIS)[b];
      const bool compl_ = EF(E_COMPL)[b] != 0;
      const int fdist = EF(E_FDIST)[b];
      EF(S_SBITS)[b] = 0;
      EF(S_SCNT)[b] = 0;
      CF(C_Q)[x] = 4 * b;
      CF(C_TIP)[x] = EF(E_TIP)[b];
      CF(C_OFF)[x] = EF(E_OFF)[b];
      CF(C_PLEN)[x] = plen;
      CF(C_FLAGS)[x] = F_FROZEN | (compl_ ? F_COMPL : 0);
      CF(C_FDIST)[x] = fdist;
      CF(C_FEND)[x] = EF(E_FEND)[b];
      CF(C_NVIS)[x] = nvis;
      cs[x] = entry_score(fdist, compl_ ? tl : max(plen, 1), eccsum[b], nvis);
      CF(C_ARRD)[x] = kBig;
    }
    nv += __popc(bal);
  }

  // ---- active entries, one at a time: sprint, then the branch step ----
  for (int x = 0; x < na; ++x) {
    const int b = s_act[x];
    const int tip = EF(E_TIP)[b], off = EF(E_OFF)[b], plen = EF(E_PLEN)[b];
    const int nvis = EF(E_NVIS)[b];
    const float ccsum = eccsum[b];
    const int* rec = s_rec + 6 * b;
    const int ul = rec[4], uo = rec[5], d = tip & 1;
    // the bases at off .. off+m, lane j holding base j
    const int base =
        x < 4 ? __shfl_sync(kFull, pfb, (8 * x + lane) & 31)
              : (lane <= m ? oriented_base(a.useq, a.n_useq, d, ul, uo,
                                           off + lane)
                           : 0);
    int* rows_cur = R.rows + (size_t)rr.half * B * W;
    if (b != rr.slot) {
      if (rr.dirty) store_row<C>(rr.row, rows_cur + (size_t)rr.slot * W,
                                 lane, W);
      load_row<C>(rr.row, rows_cur + (size_t)b * W, lane, W);
      rr.slot = b;
      rr.dirty = false;
    }
    int sbits = 0;
    for (int j = 0; j < m; ++j) {
      const int nb = __shfl_sync(kFull, base, j);
      sbits |= nb << (2 * j);
      const int wj = window_start(pc + j, tl, nt1, W);
      const int wj1 = window_start(pc + j + 1, tl, nt1, W);
      row_update<C>(rr.row, rr.row, lane, W, wj1 - wj == 1, nb, R.tm, NT,
                    wj1, plen + j + 1);
      rr.dirty = true;
    }
    if (lane == 0) {
      EF(S_SBITS)[b] = sbits;
      EF(S_SCNT)[b] = m;
    }
    const int off2 = off + m, plen2 = plen + m;
    const bool at_bound = off2 >= ul;
    const int nb = __shfl_sync(kFull, base, m);
    int e4[4];
    unsigned succ = 0, resc = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int er = rec[c];
      e4[c] = er >= 0 ? (er & ((1 << 30) - 1)) : er;
      if (er >= 0 && ((er >> 30) & 1)) resc |= 1u << c;
      if (e4[c] >= 0) succ |= 1u << c;
    }
    const bool no_succ = at_bound && succ == 0;
    // at a unitig end, the successors' records, lane c loading successor
    // c's; they land while the row is scanned
    int nrec[6];
#pragma unroll
    for (int y = 0; y < 6; ++y) nrec[y] = rec[y];
    if (at_bound && lane < 4 && ((succ >> lane) & 1)) {
      const int st = pick4(e4, lane);
      const int uid = min(max(st >> 1, 0), a.n_utbl - 1);
      const int* rc = a.utbl + ((size_t)uid * 2 + (st & 1)) * 6;
#pragma unroll
      for (int y = 0; y < 6; ++y) nrec[y] = rc[y];
    }
    const unsigned emit_bases = at_bound ? succ : 1u << nb;
    const int coff_e = at_bound ? a.k : off2 + 1;
    unsigned arr_bases = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ctip = at_bound ? e4[c] : tip;
      if (((emit_bases >> c) & 1) && R.etip >= 0 && ctip == R.etip &&
          coff_e == R.eoff)
        arr_bases |= 1u << c;
    }
    int dp[4], em[4], dn[4];
    cand_stats<C>(rr.row, lane, W, shift, arr_bases, R.tm, NT, wsn,
                  plen2 + 1, tl, dp, em, dn);
    int dpk = kBig, emk = 0;
    if (no_succ) row_stats<C>(rr.row, lane, W, ws, tl, dpk, emk);
    // candidate c on lane c: an emitting one, or the dead end's keep
    const bool keep = no_succ && lane == 0;
    const bool emits = lane < 4 && ((emit_bases >> lane) & 1);
    const unsigned bal = __ballot_sync(kFull, keep || emits);
    if (keep || emits) {
      const int y = nv + __popc(bal & below);
      const int c = lane;
      const int fdist = EF(E_FDIST)[b], fend = EF(E_FEND)[b];
      CF(C_Q)[y] = 4 * b + c;
      CF(C_ARRD)[y] = kBig;
      if (keep) {
        CF(C_TIP)[y] = tip;
        CF(C_OFF)[y] = off2;
        CF(C_PLEN)[y] = plen2;
        CF(C_FLAGS)[y] = F_FROZEN;
        CF(C_FDIST)[y] = dpk;
        CF(C_FEND)[y] = emk;
        CF(C_NVIS)[y] = nvis;
        cs[y] = entry_score(dpk, max(plen2, 1), ccsum, nvis);
      } else {
        const int ctip = at_bound ? e4[c] : tip, cpl = plen2 + 1;
        const bool arrive = (arr_bases >> c) & 1;
        const bool ccompl = arrive && !R.ecyc;
        const bool cfrozen = ccompl || cpl >= R.mplen;
        const int cdp = pick4(dp, c), cdn = pick4(dn, c);
        const int cfd = cfrozen ? (ccompl ? cdn : cdp) : fdist;
        const int cnv = at_bound ? nvis + 1 : nvis;
        CF(C_TIP)[y] = ctip;
        CF(C_OFF)[y] = coff_e;
        CF(C_PLEN)[y] = cpl;
        CF(C_FLAGS)[y] = F_EMITS | (cfrozen ? F_FROZEN : 0) |
                         (ccompl ? F_COMPL : 0) | (at_bound ? F_BRANCH : 0) |
                         (at_bound && ((resc >> c) & 1) ? F_RESCUED : 0);
        CF(C_FDIST)[y] = cfd;
        CF(C_FEND)[y] = cfrozen ? (ccompl ? tl : pick4(em, c)) : fend;
        CF(C_NVIS)[y] = cnv;
        cs[y] = entry_score(cfrozen ? cfd : cdp, ccompl ? tl : max(cpl, 1),
                            ccsum, cnv);
#pragma unroll
        for (int z = 0; z < 6; ++z) CF(C_REC + z)[y] = nrec[z];
        if (arrive) CF(C_ARRD)[y] = cdn;
      }
    }
    nv += __popc(bal);
    any_emit |= emit_bases != 0;
    any_arr |= arr_bases != 0;
  }
  __syncwarp();

  // ---- completion scoreboard (over the arrivals only) ----
  if (any_arr) {
    int key = 0x7fffffff, n_arr = 0;
    for (int x = lane; x < nv; x += 32) {
      const int v = CF(C_ARRD)[x];
      if (v < kBig) {
        key = min(key, (v << 9) | cq[x]);
        ++n_arr;
      }
    }
    key = warp_min(key);
    n_arr = warp_sum(n_arr);
    if (n_arr > 0) {
      const int m1 = key >> 9, a1 = key & 511;
      int n_eq = 0, m2 = kBig, cpl1 = -1;
      for (int x = lane; x < nv; x += 32) {
        const int v = CF(C_ARRD)[x];
        n_eq += v == m1;
        if (v > m1) m2 = min(m2, v);
        if (cq[x] == a1) cpl1 = CF(C_PLEN)[x];
      }
      n_eq = warp_sum(n_eq);
      m2 = warp_min(m2);
      cpl1 = warp_max(cpl1);
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
          g[G_CPLEN] = cpl1;
          g[G_CSBITS] = EF(S_SBITS)[a1 >> 2];
          g[G_CSCNT] = EF(S_SCNT)[a1 >> 2];
        }
        g[G_CBEST] = v[0];
        g[G_CSECOND] = v[1];
        g[G_CNUM] += n_arr;
      }
    }
  }

  // ---- rank of the valid candidates: (score desc, q asc), first B win ----
  for (int x = lane; x < nv; x += 32) {
    const float sx = cs[x];
    const int qx = cq[x];
    int rank = 0;
    for (int p = 0; p < nv; ++p) {
      const float sp = cs[p];
      rank += (sp > sx) || (sp == sx && cq[p] < qx);
    }
    if (rank < B) s_sel[rank] = x;
  }
  const int nw = min(nv, B);
  __syncwarp();

  // ---- the color products of the winners that branch ----
  for (int k = 0; k < nw; ++k) {
    const int x = s_sel[k];
    if (!(CF(C_FLAGS)[x] & F_BRANCH)) continue;
    const int uid = min(max(CF(C_TIP)[x] >> 1, 0), a.n_sig - 1);
    int sh, wsh, pop;
    sig_dot(a.color_sig + (size_t)uid * a.H, R.csig, R.wsig, a.H, lane, sh,
            wsh, pop);
    if (lane == 0) {
      EF(S_SH)[k] = sh;
      EF(S_WSH)[k] = wsh;
      EF(S_POP)[k] = pop;
    }
  }
  __syncwarp();

  // ---- the new entries (lane k holds slot k): the color filter and the
  // history, from the parents' fields; then the fields themselves ----
  int* hist = R.hist + (size_t)i * B;
  for (int k = lane; k < nw; k += 32) {
    const int x = s_sel[k], q = cq[x], par = q >> 2, fl = CF(C_FLAGS)[x];
    bool live = cs[x] > kNeg / 2;
    float n_ccsum = eccsum[par];
    const float cm = (float)EF(E_CMIN)[par];
    int n_cmin = (int)cm;
    if (fl & F_BRANCH) {
      const bool rescued = (fl & F_RESCUED) != 0;
      // collision-bias correction: the expected overlap of unrelated sets,
      // pop(u) * mass(region) / bins
      const float pop = (float)EF(S_POP)[k];
      const float shared = (float)EF(S_SH)[k] - pop * R.mass / (float)a.H;
      const float wshared =
          fmaxf((float)EF(S_WSH)[k] - pop * R.wmass / (float)a.H, 0.0f);
      const float mc = (float)a.min_cov;
      live = live && ((fl & F_COMPL) || rescued || shared >= mc);
      const float wsh_eff = rescued ? fmaxf(wshared, mc) : wshared;
      n_ccsum = n_ccsum + fminf(wsh_eff, kCapC) / kCapC;
      const float sh_eff = rescued ? fmaxf(shared, mc) : shared;
      n_cmin = (int)fminf(cm, sh_eff);
    }
    EF(S_LIVE)[k] = live;
    ((float*)EF(S_CCSUM))[k] = n_ccsum;
    EF(S_CMIN)[k] = n_cmin;
    // history: base(2) | emitted(1) | parent(7) | sprint count(3) |
    // sprint bases(14)
    hist[k] = (q & 3) | ((fl & F_EMITS) ? 4 : 0) | (par << 3) |
              (EF(S_SCNT)[par] << 10) | (EF(S_SBITS)[par] << 13);
  }
  __syncwarp();
  int n_rb = 0;  // winners that stay live and unfrozen: their rows
  for (int k0 = 0; k0 < B; k0 += 32) {
    const int k = k0 + lane;
    bool rb = false;
    if (k < nw) {
      const int x = s_sel[k], fl = CF(C_FLAGS)[x];
      const bool live = EF(S_LIVE)[k] != 0, frozen = (fl & F_FROZEN) != 0;
      EF(E_TIP)[k] = CF(C_TIP)[x];
      EF(E_OFF)[k] = CF(C_OFF)[x];
      EF(E_PLEN)[k] = CF(C_PLEN)[x];
      EF(E_LIVE)[k] = live;
      EF(E_CMIN)[k] = EF(S_CMIN)[k];
      EF(E_FROZEN)[k] = frozen;
      EF(E_COMPL)[k] = (fl & F_COMPL) != 0;
      EF(E_FDIST)[k] = CF(C_FDIST)[x];
      EF(E_FEND)[k] = CF(C_FEND)[x];
      EF(E_CCSUM)[k] = EF(S_CCSUM)[k];
      EF(E_NVIS)[k] = CF(C_NVIS)[x];
      rb = live && !frozen;
      if (rb) {
#pragma unroll
        for (int z = 0; z < 6; ++z) s_rec[6 * k + z] = CF(C_REC + z)[x];
      }
    } else if (k < B) {
      EF(E_LIVE)[k] = 0;
    }
    n_rb += __popc(__ballot_sync(kFull, rb));
  }
  if (lane == 0) g[G_PCOUNT] = pc + m + (any_emit ? 1 : 0);
  __syncwarp();

  // ---- the rebuilt rows: the parent's, advanced by the winner's base ----
  if (n_rb > 0) {
    const int* rows_cur = R.rows + (size_t)rr.half * B * W;
    int* rows_nxt = R.rows + (size_t)(rr.half ^ 1) * B * W;
    int nrow[C];
    int last = -1;
    for (int k = 0; k < nw; ++k) {
      if (!EF(E_LIVE)[k] || EF(E_FROZEN)[k]) continue;
      const int x = s_sel[k], q = cq[x], par = q >> 2;
      if (par == rr.slot) {
        row_update<C>(rr.row, nrow, lane, W, shift, q & 3, R.tm, NT, wsn,
                      CF(C_PLEN)[x]);
      } else {
        int prow[C];
        load_row<C>(prow, rows_cur + (size_t)par * W, lane, W);
        row_update<C>(prow, nrow, lane, W, shift, q & 3, R.tm, NT, wsn,
                      CF(C_PLEN)[x]);
      }
      if (n_rb > 1) store_row<C>(nrow, rows_nxt + (size_t)k * W, lane, W);
      last = k;
    }
    if (n_rb == 1) {
#pragma unroll
      for (int x = 0; x < C; ++x) rr.row[x] = nrow[x];
      rr.slot = last;
      rr.dirty = true;
    } else {
      rr.slot = -1;
      rr.dirty = false;
    }
  } else {
    rr.slot = -1;
    rr.dirty = false;
  }
  rr.half ^= 1;
#undef EF
#undef CF
  return true;
}

template <int C>
__global__ void __launch_bounds__(32 * kMaxRegionsPerBlock)
    beam_kernel(const Args a, const int phase) {
  extern __shared__ int4 sm4[];
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * a.regions_per_block + (threadIdx.x >> 5);
  if (r >= a.R) return;
  const int B = a.B, W = a.W, NT = a.NT, H = a.H, lmax = a.lmax;
  int* base = (int*)sm4 + (size_t)(threadIdx.x >> 5) * a.region_ints;
  Region R;
  R.e = base;
  R.cand = base + S_COUNT * B;
  R.g = R.cand + 4 * B * C_COUNT;
  R.tm = (uint8_t*)(base + ints_fixed(B)) + 15;
  R.csig = (int8_t*)(base + ints_fixed(B) + ints_bytes(NT + 16));
  R.wsig = R.csig + 4 * ints_bytes(H);
  R.rows = a.rows + (size_t)r * 2 * B * W;
  R.hist = a.hist + (size_t)r * lmax * B;
  R.tl = a.tgt_len[r];
  R.etip = a.end_tip[r];
  R.eoff = a.end_off[r];
  R.mplen = a.max_plen[r];
  R.ecyc = a.end_cyclic[r] != 0;
  R.mass = R.wmass = 0.0f;
  int* e = R.e;
  int* g = R.g;
  int* saved = a.state + (size_t)r * a.state_words;
  RowReg<C> rr;
  rr.half = 0;

  if (phase == 1) {
    for (int b = lane; b < B; b += 32) {
      e[E_TIP * B + b] = b == 0 ? a.start_tip[r] : -1;
      e[E_OFF * B + b] = a.start_off[r];
      e[E_PLEN * B + b] = 0;
      e[E_LIVE * B + b] = b == 0;
      e[E_CMIN * B + b] = kBig;
      e[E_FROZEN * B + b] = 0;
      e[E_COMPL * B + b] = 0;
      e[E_FDIST * B + b] = kBig;
      e[E_FEND * B + b] = 0;
      ((float*)e)[E_CCSUM * B + b] = 0.0f;
      e[E_NVIS * B + b] = 0;
    }
    if (lane < kRegionInts)
      g[lane] = (lane == G_CBEST || lane == G_CSECOND) ? kBig : 0;
    // slot 0's successor record
    if (lane < 6) {
      const int st = a.start_tip[r];
      const int uid = min(max(st >> 1, 0), a.n_utbl - 1);
      e[S_REC * B + lane] = a.utbl[((size_t)uid * 2 + (st & 1)) * 6 + lane];
    }
    if (lane == 0) R.tm[0] = 0;
    copy_bytes(R.tm + 1, a.tgt_masks + (size_t)r * NT, NT, lane);
    copy_bytes((uint8_t*)R.csig, (const uint8_t*)a.colors_sig + (size_t)r * H,
               H, lane);
    copy_bytes((uint8_t*)R.wsig, (const uint8_t*)a.colors_wsig + (size_t)r * H,
               H, lane);
    __syncwarp();
    // the region's color mass (exact: integer sums far below 2^24)
    int m0 = 0, m1 = 0;
    for (int h = lane; h < H; h += 32) {
      m0 += R.csig[h];
      m1 += R.wsig[h];
    }
    R.mass = (float)warp_sum(m0);
    R.wmass = (float)warp_sum(m1);
    // row 0 of slot 0 at window 0: E[0][j] = j
#pragma unroll
    for (int x = 0; x < C; ++x)
      rr.row[x] = lane * C + x < W ? lane * C + x : kBig;
    rr.slot = 0;
    rr.dirty = true;
    int i = 0;
    for (; i < lmax; ++i)
      if (!beam_step<C>(a, R, i, 1, lane, rr)) break;
    __syncwarp();
    for (int x = lane; x < E_COUNT * B; x += 32) saved[x] = e[x];
    if (lane < kRegionInts) saved[E_COUNT * B + lane] = g[lane];
    if (lane == 0) {
      a.f_steps[r] = i;
      atomicMax(a.t_launch, i);
    }
    return;
  }

  // ---- launch 2: at most one step more, then the pick ----
  for (int x = lane; x < E_COUNT * B; x += 32) e[x] = saved[x];
  if (lane < kRegionInts) g[lane] = saved[E_COUNT * B + lane];
  __syncwarp();
  const int f = a.f_steps[r];
  const int T = *(volatile int*)a.t_launch;
  rr.slot = -1;
  rr.dirty = false;
  if (f < T) beam_step<C>(a, R, f, 2, lane, rr);
  const int Tr = min(T, f + 1);
  const int tl = R.tl;
  float* es = (float*)R.cand;
  for (int b = lane; b < B; b += 32)
    es[b] = e[E_LIVE * B + b]
                ? entry_score(e[E_FDIST * B + b],
                              e[E_COMPL * B + b] ? tl
                                                 : max(e[E_PLEN * B + b], 1),
                              ((float*)e)[E_CCSUM * B + b],
                              e[E_NVIS * B + b])
                : kNeg;
  uint8_t* seq = a.best_seq + (size_t)r * lmax;
  for (int x = lane; x < lmax; x += 32) seq[x] = 0;
  __syncwarp();
  int start = 0, cur = 0, rem = 0;
  if (lane == 0) {
    const int* e_live = e + E_LIVE * B;
    const int* e_fdist = e + E_FDIST * B;
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
      const int v = (e_live[b] && es[b] >= thr) ? e[E_CMIN * B + b] + 1 : 0;
      if (b == 0 || v > best) {
        best = v;
        b0 = b;
      }
    }
    const int b1 = o0 == b0 ? o1 : o0;
    const bool any_ok = e_live[b0] && e_fdist[b0] < kBig;
    const int second_fb = (e_live[b1] && b1 != b0) ? e_fdist[b1] : kBig;
    const bool has_c = g[G_CNUM] > 0;
    const int blen_fb = any_ok ? e[E_PLEN * B + b0] : 0;
    const int cplen = g[G_CPLEN], cscnt = g[G_CSCNT], csbits = g[G_CSBITS];
    a.best_len[r] = has_c ? cplen : blen_fb;
    a.best_dist[r] = has_c ? g[G_CBEST] : (any_ok ? e_fdist[b0] : kBig);
    a.best_end[r] = has_c ? tl : (any_ok ? e[E_FEND * B + b0] : 0);
    a.second_dist[r] = has_c ? g[G_CSECOND] : second_fb;
    a.completed[r] = has_c;
    a.n_done[r] = g[G_CNUM];
    start = has_c ? g[G_CSTEP] - 1 : Tr - 1;
    cur = has_c ? g[G_CCAND] >> 2 : b0;
    rem = has_c ? cplen - 1 - cscnt : blen_fb;
    // the arrival's own base and its parent's sprint bases
    if (has_c && cplen > 0)
      seq[min(max(cplen - 1, 0), lmax - 1)] = g[G_CCAND] & 3;
    for (int jj = 0; jj < a.smax - 1; ++jj)
      if (has_c && jj < cscnt)
        seq[min(max(cplen - 1 - cscnt + jj, 0), lmax - 1)] =
            (csbits >> (2 * jj)) & 3;
  }
  start = min(__shfl_sync(kFull, start, 0), lmax - 1);
  // walk the backpointers from the start step down to 0, 32 steps of
  // history at a time in shared memory (the candidate area)
  int* hbuf = R.cand;
  for (int hi = start; hi >= 0; hi -= kHistChunk) {
    const int lo = max(hi - kHistChunk + 1, 0);
    const int n = (hi - lo + 1) * B;
    __syncwarp();
    for (int x = lane; x < n; x += 32) hbuf[x] = R.hist[(size_t)lo * B + x];
    __syncwarp();
    if (lane == 0) {
      for (int idx = hi; idx >= lo; --idx) {
        const int hsel =
            (cur >= 0 && cur < B) ? hbuf[(idx - lo) * B + cur] : 0;
        if (((hsel >> 2) & 1) && rem > 0) {
          if (rem - 1 < lmax) seq[rem - 1] = hsel & 3;
          --rem;
        }
        // sprint bases precede the branch base: written backward
        const int hscnt = (hsel >> 10) & 7, hsbits = (hsel >> 13) & 0x3FFF;
        for (int jj = 0; jj < a.smax - 1; ++jj) {
          if (jj < hscnt && rem > 0) {
            const int sh = max(2 * (hscnt - 1 - jj), 0);
            if (rem - 1 < lmax) seq[rem - 1] = (hsbits >> sh) & 3;
            --rem;
          }
        }
        cur = (hsel >> 3) & 127;
      }
    }
  }
}

template <int C>
int launch(const Args& a, int phase, cudaStream_t stream) {
  const int rpb = a.regions_per_block;
  const size_t smem = (size_t)rpb * a.region_ints * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      beam_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  beam_kernel<C><<<(a.R + rpb - 1) / rpb, 32 * rpb, smem, stream>>>(a, phase);
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
      a.H < 1 || a.state_words < E_COUNT * a.B + kRegionInts)
    return (int)cudaErrorInvalidValue;
  // one warp per region; enough regions per block to cover the SMs with
  // about one block each, as shared memory allows
  a.region_ints = region_ints(a.B, a.NT, a.H);
  const size_t region_bytes = (size_t)a.region_ints * sizeof(int);
  if (region_bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  int rpb = (a.R + kSms - 1) / kSms;
  rpb = rpb < kMaxRegionsPerBlock ? rpb : kMaxRegionsPerBlock;
  while (rpb > 1 && rpb * region_bytes > kSmemLimit) --rpb;
  a.regions_per_block = rpb;
  cudaStream_t s = (cudaStream_t)stream;
  // C = ceil(W/32) columns per lane, rounded up to an instantiated width
  const int c = (a.W + 31) / 32;
  if (c <= 2) return launch<2>(a, phase, s);
  if (c <= 4) return launch<4>(a, phase, s);
  if (c <= 6) return launch<6>(a, phase, s);
  if (c <= 9) return launch<9>(a, phase, s);
  if (c <= 11) return launch<11>(a, phase, s);
  if (c <= 13) return launch<13>(a, phase, s);
  if (c <= 16) return launch<16>(a, phase, s);
  if (c <= 24) return launch<24>(a, phase, s);
  return launch<32>(a, phase, s);
}
