// Sprint band update of the beam search, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ratatosk_tpu/ops/sprint_pallas.py
// (sprint_rows / _kernel). For every region r and beam entry b it runs up to
// m_reg[r] <= smax-1 row updates of the E-transformed banded edit DP
// (E[i][j] = j + min_{l<=j}(D[i][l] - l)). Substep j:
//   1. when the window start advances (wsall[r][j+1] - wsall[r][j] == 1), the
//      target-mask window slides left by one column and newcols[r][j] enters
//      at column W-1;
//   2. D[c] = min(prev[c-1] + sub, prev[c] + 1) with the previous row read at
//      the new window (shifted by the advance), sub = ((1<<base) & mask) == 0;
//   3. column 0 of the full DP (absolute column ws+c == 0) becomes plen+j+1,
//      and D clamps at BIG = 2^20;
//   4. E = col + cummin(D - col) along the band, clamped at BIG;
//   5. only live entries store the new row.
//
// What bounds it: by the roofline, the bytes. Every entry's row is read
// and written once (R*B*W*4 bytes each way: 16.8 MB at R=512, B=16,
// W=257), and a substep costs ~10 int32 operations a cell, fewer than the
// bytes allow at the engine's <= 7 substeps. On the card the substeps'
// instructions run nearly all on the 64-lane int32 path, so a launch
// whose entries advance is bound by them (PERF.md, section 6).
//
// What the design does about it:
// - a warp per (region, entry), kWarps to a block, no block barrier: at
//   R=128, B=16 that is 512 blocks for 132 SMs;
// - one round of loads: the row, with coalesced 4-byte accesses (lane l
//   takes columns l, l+32, ...), the scalars, and the substeps' window
//   starts, bases and new columns (a lane each, 32 substeps at a time,
//   shuffled to the warp; the advance flags are one ballot); an entry
//   that does not advance (live == 0 or m_reg == 0) stores the row
//   straight back, a copy;
// - an entry that advances, and the region's first entry, whose warp
//   writes the region's btgt', then load the window's masks; the row and
//   the masks reach the lanes through a per-warp shared buffer, from
//   which each lane takes its C = ceil(W/32) consecutive columns at an
//   odd stride (C, or C+1 for even C), so neither side has bank
//   conflicts;
// - the row and the masks stay in registers for all substeps: an advance
//   shifts the masks one column left (a shuffle across lanes) and the
//   shifted-in columns, staged in shared memory in order, feed the last
//   lane; the cells past column W-1 hold no row, and on an advance column
//   W-1 reads BIG beyond the band; the prefix-min is a sequential min
//   inside the lane, then a log2(32)-step __shfl_up_sync scan of the
//   lanes' tails;
// - integer-only, with wrapping adds, so it equals the plain version on
//   any int32 rows.
// Bands up to 32 columns a lane: W <= 1,024.
//
// Plain C interface (bound with ctypes from ratatosk_tpu_torch/ops/sprint.py):
// the launcher returns cudaGetLastError() and never synchronises.

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kInf = 1 << 28;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxC = 32;  // columns a lane: bands up to 1,024
constexpr int kWarps = 4;  // warps (entries) a block

// SM cycles by phase in a build with SPRINT_CLOCKS defined
// (scripts/kernel_compare.py --kernel sprint --split): lane 0 of a warp
// reads clock64() where a phase ends and adds the cycles since its last
// mark: 0 the loads' wait, the window (shifted-in columns) and btgt, for
// the warps that build them, 1 a copy's load wait, or the row and masks
// into registers, 2 substeps, 3 row store (a copy's store); [4] counts
// the warps' entries.
constexpr int kClkParts = 4;
#ifdef SPRINT_CLOCKS
__device__ unsigned long long sprint_clk[kClkParts + 1];
__device__ int sprint_clk_sink;
#define CLK_START                                                           \
  long long clk_t = clock64();                                              \
  int clk_sink = 0
// waits for a loaded value before the next mark (a load's wait falls on
// its first use)
#define CLK_USE(x) clk_sink ^= (x)
#define CLK_MARK(p)                                                         \
  do {                                                                      \
    const long long n_ = clock64();                                         \
    if ((threadIdx.x & 31) == 0)                                            \
      atomicAdd(&sprint_clk[p], (unsigned long long)(n_ - clk_t));          \
    clk_t = n_;                                                             \
  } while (0)
#define CLK_ENTRY                                                           \
  do {                                                                      \
    if (clk_sink == 0x7fffffff && clk_t == 0) sprint_clk_sink = 1;          \
    if ((threadIdx.x & 31) == 0) atomicAdd(&sprint_clk[kClkParts], 1ull);   \
  } while (0)
#else
#define CLK_START
#define CLK_MARK(p)
#define CLK_USE(x)
#define CLK_ENTRY
#endif

// int32 adds and subtractions that wrap, as PyTorch's do
__device__ __forceinline__ int add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// shared-buffer slot of band column c: lane l's C columns from l*P, P odd
template <int C>
__device__ __forceinline__ int slot(int c) {
  return (C & 1) ? c : c + c / C;
}

// d - col of one cell (ncol = -col): D = min(prev[c-1] + sub, prev[c] + 1),
// column 0 of the DP set to plj, clamped at BIG
template <bool kZero>
__device__ __forceinline__ int cell(int pjm1, int pj, int mask, int bm,
                                    int ncol, int plj) {
  const unsigned hit = min((unsigned)(bm & mask), 1u);
  int d = min((int)((unsigned)pjm1 + 1u - hit), add(pj, 1));
  if (kZero && ncol == 0) d = plj;
  return add(min(d, kBig), ncol);
}

// the cells' d - col, each min'd with the lane's cells before it; nbr is
// the neighbouring lane's edge column (BIG beyond the band)
template <int C, bool kAdv, bool kZero>
__device__ __forceinline__ void row_cells(const int (&row)[C],
                                          const int (&mk)[C], int nbr, int bm,
                                          int nbase, int plj, int last,
                                          int (&t)[C]) {
#pragma unroll
  for (int i = 0; i < C; ++i) {
    // on an advance column W-1 (the lane's cell `last`) reads BIG beyond
    // the band; the cells past it hold no row
    const int pj = kAdv ? (i == last ? kBig : i + 1 < C ? row[i + 1] : nbr)
                        : row[i];
    const int pjm1 = kAdv ? row[i] : (i > 0 ? row[i - 1] : nbr);
    const int v = cell<kZero>(pjm1, pj, mk[i], bm, sub(nbase, i), plj);
    t[i] = i > 0 ? min(v, t[i - 1]) : v;
  }
}

template <int C>
__global__ void __launch_bounds__(32 * kWarps)
    sprint_rows_kernel(const int* __restrict__ rwin,
                       const int* __restrict__ btgt,
                       const int* __restrict__ nb_all,
                       const int* __restrict__ newcols,
                       const int* __restrict__ wsall,
                       const int* __restrict__ m_reg,
                       const int* __restrict__ live,
                       const int* __restrict__ plen, int* __restrict__ rwin_out,
                       int* __restrict__ btgt_out, int R, int B, int W,
                       int S1) {
  constexpr int P = C | 1;
  // per warp: the row's buffer, the masks' buffer (32*P each), then the
  // region's shifted-in columns in order (S1)
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long e = (long long)blockIdx.x * kWarps + warp;
  if (e >= (long long)R * B) return;
  CLK_START;
  int* rowbuf = smem + warp * (64 * P + S1);
  int* maskbuf = rowbuf + 32 * P;
  int* ins = maskbuf + 32 * P;
  const int r = (int)(e / B);
  const bool first = e == (long long)r * B;
  const int* ws = wsall + (size_t)r * (S1 + 1);
  const int* nbe = nb_all + (size_t)e * S1;
  const int* ncr = newcols + (size_t)r * S1;
  const int* src = rwin + (size_t)e * W;
  int* dst = rwin_out + (size_t)e * W;
  const int* bt = btgt + (size_t)r * W;

  // in one round: the row (BIG past the band), the region's and the
  // entry's scalars, and substep `lane`'s window start, base and new column
  int v[C], u[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = k * 32 + lane;
    v[k] = c < W ? src[c] : kBig;
  }
  const int m = min(m_reg[r], S1);
  const int lv = live[e];
  const int pl = plen[e];
  int w0 = 0, w1 = 0, nb0 = 0, nc0 = 0;
  if (lane < S1) {
    w0 = ws[lane];
    w1 = ws[lane + 1];
    nb0 = nbe[lane];
    nc0 = ncr[lane];
  }
  const bool moves = m > 0 && lv != 0;

  if (!first && !moves) {
    // an entry that does not advance: a copy
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (k * 32 + lane < W) CLK_USE(v[k]);
    CLK_MARK(1);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = k * 32 + lane;
      if (c < W) dst[c] = v[k];
    }
    CLK_ENTRY;
    CLK_MARK(3);
    return;
  }

  // an entry that advances, or the region's first: the window's masks
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = k * 32 + lane;
    u[k] = c < W ? bt[c] : 0;
  }
  // the columns that the region's advances bring in, in order: ins[0..T)
  const unsigned adv0 =
      __ballot_sync(kFull, lane < m && sub(w1, w0) == 1);
  if ((adv0 >> lane) & 1u) ins[__popc(adv0 & ((1u << lane) - 1u))] = nc0;
  int T = __popc(adv0);
  for (int j0 = 32; j0 < m; j0 += 32) {
    const int j = j0 + lane;
    const bool a = j < m && sub(ws[j + 1], ws[j]) == 1;
    const unsigned bits = __ballot_sync(kFull, a);
    if (a) ins[T + __popc(bits & ((1u << lane) - 1u))] = ncr[j];
    T += __popc(bits);
  }
  __syncwarp();
  // the window past the band holds the columns that advances bring in,
  // then 0: an advance shifts them in
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = k * 32 + lane;
    if (c >= W) u[k] = c - W < T ? ins[c - W] : 0;
    maskbuf[slot<C>(c)] = u[k];
    rowbuf[slot<C>(c)] = v[k];
  }
  __syncwarp();
  if (first) {
    // the region's btgt': its window after all T advances
    int* bo = btgt_out + (size_t)r * W;
    for (int c = lane; c < W; c += 32) {
      const int x = c + T;
      bo[c] = x < 32 * C ? maskbuf[slot<C>(x)] : ins[x - W];
    }
  }
  CLK_MARK(0);
  if (!moves) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = k * 32 + lane;
      if (c < W) dst[c] = v[k];
    }
    CLK_ENTRY;
    CLK_MARK(3);
    return;
  }

  int row[C], mk[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    row[i] = rowbuf[lane * P + i];
    mk[i] = maskbuf[lane * P + i];
    CLK_USE(row[i]);
  }
  CLK_MARK(1);

  const int c0 = lane * C;
  const int nv = W - c0;           // this lane's cells inside the band
  const int lead = 32 * C - W;     // the last lane's feed: ins[s - 1 + lead]
  int s = 0;                       // advances so far
  for (int j0 = 0; j0 < m; j0 += 32) {
    int p_ws = w1, p_bm = 1 << nb0;
    unsigned advs = adv0;
    if (j0 > 0) {
      const int j = j0 + lane;
      bool a = false;
      if (j < m) {
        p_ws = ws[j + 1];
        a = sub(p_ws, ws[j]) == 1;
        p_bm = 1 << nbe[j];
      }
      advs = __ballot_sync(kFull, a);
    }
    const int n = min(32, m - j0);
    for (int jj = 0; jj < n; ++jj) {
      const int ws_n = __shfl_sync(kFull, p_ws, jj);
      const int bm = __shfl_sync(kFull, p_bm, jj);
      const int plj = add(pl, j0 + jj + 1);
      const int base = add(ws_n, c0);
      const int nbase = sub(0, base);
      // absolute column 0 in the band: only then the cells test for it
      const bool zero = ws_n <= 0 && ws_n > -32 * C;
      int t[C];
      if ((advs >> jj) & 1u) {
        ++s;
        int feed = __shfl_down_sync(kFull, mk[0], 1);
        if (lane == 31) {
          const int q = s - 1 + lead;
          feed = q < T ? ins[q] : 0;
        }
#pragma unroll
        for (int i = 0; i + 1 < C; ++i) mk[i] = mk[i + 1];
        mk[C - 1] = feed;
        int nxt = __shfl_down_sync(kFull, row[0], 1);
        if (lane == 31) nxt = kBig;
        if (zero)
          row_cells<C, true, true>(row, mk, nxt, bm, nbase, plj, nv - 1, t);
        else
          row_cells<C, true, false>(row, mk, nxt, bm, nbase, plj, nv - 1, t);
      } else {
        int prv = __shfl_up_sync(kFull, row[C - 1], 1);
        if (lane == 0) prv = kBig;
        if (zero)
          row_cells<C, false, true>(row, mk, prv, bm, nbase, plj, nv - 1, t);
        else
          row_cells<C, false, false>(row, mk, prv, bm, nbase, plj, nv - 1, t);
      }
      // inclusive warp scan of the lanes' tails, then the exclusive prefix
      // of the lanes below folds into each lane's cells
      int tot = t[C - 1];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1)
        // a lane below d gets its own value back
        tot = min(tot, __shfl_up_sync(kFull, tot, d));
      int below = __shfl_up_sync(kFull, tot, 1);
      if (lane == 0) below = kInf;
#pragma unroll
      for (int i = 0; i < C; ++i)
        row[i] = min(add(add(base, i), min(t[i], below)), kBig);
    }
  }
  CLK_MARK(2);

  __syncwarp();
#pragma unroll
  for (int i = 0; i < C; ++i) rowbuf[lane * P + i] = row[i];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = k * 32 + lane;
    if (c < W) dst[c] = rowbuf[slot<C>(c)];
  }
  CLK_ENTRY;
  CLK_MARK(3);
}

template <int C>
int launch(long long entries, int S1, cudaStream_t stream, const int* rwin,
           const int* btgt, const int* nb_all, const int* newcols,
           const int* wsall, const int* m_reg, const int* live,
           const int* plen, int* rwin_out, int* btgt_out, int R, int B,
           int W) {
  const size_t smem = (size_t)kWarps * (64 * (C | 1) + S1) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sprint_rows_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((entries + kWarps - 1) / kWarps));
  sprint_rows_kernel<C><<<grid, 32 * kWarps, smem, stream>>>(
      rwin, btgt, nb_all, newcols, wsall, m_reg, live, plen, rwin_out,
      btgt_out, R, B, W, S1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sprint_rows_max_width() { return kMaxC * 32; }

#ifdef SPRINT_CLOCKS
// The cycles by phase since the last read, then the entries ([5]), zeroed.
extern "C" int sprint_clock_read(unsigned long long* out) {
  static const unsigned long long zero[kClkParts + 1] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, sprint_clk, sizeof(zero));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(sprint_clk, zero, sizeof(zero));
  return (int)err;
}
#endif

extern "C" int sprint_rows_launch(const void* rwin, const void* btgt,
                                  const void* nb_all, const void* newcols,
                                  const void* wsall, const void* m_reg,
                                  const void* live, const void* plen,
                                  void* rwin_out, void* btgt_out, int R, int B,
                                  int W, int S1, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R < 0 || B < 1 || W < 1 || W > kMaxC * 32 || S1 < 1)
    return (int)cudaErrorInvalidValue;
  const long long entries = (long long)R * B;
  if (entries == 0) return (int)cudaSuccess;
  const int C = (W + 31) / 32;
  cudaStream_t s = (cudaStream_t)stream;
  const int* a0 = (const int*)rwin;
  const int* a1 = (const int*)btgt;
  const int* a2 = (const int*)nb_all;
  const int* a3 = (const int*)newcols;
  const int* a4 = (const int*)wsall;
  const int* a5 = (const int*)m_reg;
  const int* a6 = (const int*)live;
  const int* a7 = (const int*)plen;
  int* o0 = (int*)rwin_out;
  int* o1 = (int*)btgt_out;
#define RT_CASE(n)                                                         \
  case n:                                                                  \
    return launch<n>(entries, S1, s, a0, a1, a2, a3, a4, a5, a6, a7, o0,   \
                     o1, R, B, W);
  switch (C) {
    RT_CASE(1) RT_CASE(2) RT_CASE(3) RT_CASE(4) RT_CASE(5) RT_CASE(6)
    RT_CASE(7) RT_CASE(8) RT_CASE(9) RT_CASE(10) RT_CASE(11) RT_CASE(12)
    RT_CASE(13) RT_CASE(14) RT_CASE(15) RT_CASE(16) RT_CASE(17) RT_CASE(18)
    RT_CASE(19) RT_CASE(20) RT_CASE(21) RT_CASE(22) RT_CASE(23) RT_CASE(24)
    RT_CASE(25) RT_CASE(26) RT_CASE(27) RT_CASE(28) RT_CASE(29) RT_CASE(30)
    RT_CASE(31) RT_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_CASE
}
