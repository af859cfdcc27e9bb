// Batched edit distance (NW / SHW / HW, IUPAC masks), hand-written for
// Hopper (sm_90a).
//
// Computes ratatosk_tpu_torch/ops/align.py:edit_distance_ref, bit for bit:
// for each pair, the DP row E[a_len][0..N] of query a (rows) against target
// b (columns), its columns past b_len set to BIG, and from it the distance
// and the last and first tied end columns (NW: the value at column b_len,
// read as the reference's take_along_axis reads it). The reference computes it in plain JAX
// (ratatosk_tpu/ops/align.py:edit_distance: a lax.scan over the query's
// bases with one lax.cummin per row); no Pallas kernel is replaced.
//
// One warp per pair. A row is bit-parallel (Myers / Hyyro): the horizontal
// differences E[i][j] - E[i][j-1] of columns 1..N, +1 / -1, as two
// bit-vectors P / M, K 32-bit words a lane (lane l holds columns
// 32Kl+1 .. 32K(l+1); K the least of 1, 2, 3, 4, 6, 8, 12, 16 with 1024K
// >= N). A row update is the edit recurrence over all columns at once: the
// addition (Eq & P) + P carries across words within the lane and across
// lanes through two ballots and one integer add (a carry-lookahead over the
// lanes), the shift by one column through one shuffle, and column 0's
// vertical difference is +1 every row (E[i][0] = i in every mode). Row 0
// is P = all ones for NW and SHW (E[0][j] = j), P = M = 0 for HW.
//
// Eq, the columns whose target mask shares a bit with the row's query
// mask, is an OR of the target's bit-planes selected by the mask's bits.
// The low four planes (the IUPAC bits) stay in registers, built once per
// pair from coalesced loads and ballots; masks are arbitrary bytes, so the
// high four live in shared memory and are read only on a row whose query
// mask shares a high bit with some target mask (a branch that is uniform
// across the warp). The query's masks are loaded 32 rows at a time, one
// byte a lane, and broadcast with a shuffle.
//
// Only rows 1..a_len run: the captured row is the last one. A pair whose
// a_len lies outside [0, M] is never captured (BIG everywhere, as the
// reference's scan never reaches it). Then the warp writes the row,
// 32 consecutive columns per step (each lane's value from the owner lane's
// words by a popcount of the bits below it and an exclusive scan of the
// lanes' sums), and keeps the minimum and its last and first columns,
// reduced over the warp at the end.
//
// What bounds it: the chain of a_len dependent rows of a pair, one warp's
// row update each (two ballots, two shuffles and some thirty integer
// instructions per word on the chain); bytes (the masks in, the row out)
// and operations are far below the card's rates at the engine's shapes:
// latency-bound. Pairs run in parallel, four warps a block.
//
// Plain C interface (bound with ctypes from ratatosk_tpu_torch/ops/
// align_kernel.py); the launcher never synchronises and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kMaxK = 16;             // 32-bit words a lane
constexpr int kMaxN = 32 * 32 * kMaxK;
constexpr int kBig = 1 << 20;
enum { NW = 0, SHW = 1, HW = 2 };

// pointer table (ops/align_kernel.py:PTRS)
enum {
  P_A_MASKS, P_A_LEN, P_B_MASKS, P_B_LEN, P_DIST, P_END, P_END_MIN,
  P_LAST_ROW, P_COUNT
};
// int table (ops/align_kernel.py:INTS)
enum { I_B, I_M, I_N, I_MODE, I_COUNT };

struct Args {
  const uint8_t* a_masks;
  const int* a_len;
  const uint8_t* b_masks;
  const int* b_len;
  int* dist;
  int* end;
  int* end_min;
  int* last_row;
  int B, M, N, mode;
};

template <int K>
__global__ void __launch_bounds__(32 * kWarps) align_kernel(const Args a) {
  // the target's high bit-planes (mask bits 4-7): [warp][plane][word][lane]
  __shared__ uint32_t hi_planes[kWarps][4][K][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= a.B) return;  // the whole warp: no block barrier follows
  const int M = a.M, N = a.N;
  const int alen = a.a_len[r], blen = a.b_len[r];
  const bool captured = alen >= 0 && alen <= M;
  const uint8_t* am = a.a_masks + (size_t)r * M;
  const uint8_t* bm = a.b_masks + (size_t)r * N;

  // bit-planes: word k of lane o covers target bases 32(Ko+k) .. +31, i.e.
  // columns 32(Ko+k)+1 .. +32; one coalesced byte a lane, one ballot each
  uint32_t pl[4][K];
#pragma unroll
  for (int k = 0; k < K; ++k) pl[0][k] = pl[1][k] = pl[2][k] = pl[3][k] = 0u;
  uint32_t hib = 0;
  for (int o = 0; o < 32 && 32 * K * o < N; ++o) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int x = 32 * (K * o + k) + lane;
      if (32 * (K * o + k) >= N) break;  // uniform across the warp
      const uint32_t v = x < N ? (uint32_t)bm[x] : 0u;
      hib |= v;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t w = __ballot_sync(kFull, (v >> q) & 1u);
        if (lane == o) pl[q][k] = w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t w = __ballot_sync(kFull, (v >> (4 + q)) & 1u);
        if (lane == o) hi_planes[warp][q][k][lane] = w;
      }
    }
  }
  hib = __reduce_or_sync(kFull, hib) & 0xf0u;
  __syncwarp();

  uint32_t P[K], Mv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    P[k] = a.mode == HW ? 0u : kFull;
    Mv[k] = 0u;
  }

  const int rows = captured ? alen : 0;
  uint32_t qcur = 0, qnxt = 0;
  if (rows > 0) {
    qcur = lane < rows ? (uint32_t)am[lane] : 0u;
    qnxt = 32 + lane < rows ? (uint32_t)am[32 + lane] : 0u;
  }
  for (int i = 0; i < rows; ++i) {
    const int t = i & 31;
    const uint32_t amask = __shfl_sync(kFull, qcur, t);
    if (t == 31) {
      qcur = qnxt;
      const int x = i + 33 + lane;
      qnxt = x < rows ? (uint32_t)am[x] : 0u;
    }
    const uint32_t m0 = 0u - (amask & 1u), m1 = 0u - ((amask >> 1) & 1u);
    const uint32_t m2 = 0u - ((amask >> 2) & 1u), m3 = 0u - ((amask >> 3) & 1u);
    uint32_t eq[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      eq[k] = (m0 & pl[0][k]) | (m1 & pl[1][k]) | (m2 & pl[2][k]) |
              (m3 & pl[3][k]);
    if (amask & hib) {  // uniform across the warp
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if ((amask >> (4 + q)) & 1u) {
#pragma unroll
          for (int k = 0; k < K; ++k) eq[k] |= hi_planes[warp][q][k][lane];
        }
      }
    }
    uint32_t xv[K], s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) xv[k] = eq[k] | Mv[k];
    // (eq & P) + P over all columns: within the lane a carry chain, across
    // the lanes a carry-lookahead from two ballots and one add
    uint32_t c = 0, all = kFull;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned long long tt =
          (unsigned long long)(eq[k] & P[k]) + P[k] + c;
      s[k] = (uint32_t)tt;
      c = (uint32_t)(tt >> 32);
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
    // the vertical differences of the new row, columns 1..
    uint32_t ph[K], mh[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t xh = (s[k] ^ P[k]) | eq[k];
      ph[k] = Mv[k] | ~(xh | P[k]);
      mh[k] = P[k] & xh;
    }
    // they move up one column; lane 0's column 0 gets +1 (E[i][0] = i),
    // every other lane the top column of the lane below
    uint32_t tin = __shfl_up_sync(
        kFull, (ph[K - 1] >> 31) | ((mh[K - 1] >> 31) << 1), 1);
    if (lane == 0) tin = 1u;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const uint32_t pin = k ? ph[k - 1] >> 31 : (tin & 1u);
      const uint32_t min_ = k ? mh[k - 1] >> 31 : (tin >> 1);
      const uint32_t php = (ph[k] << 1) | pin;
      const uint32_t mhp = (mh[k] << 1) | min_;
      P[k] = mhp | ~(xv[k] | php);
      Mv[k] = php & xv[k];
    }
  }

  // the row's values: column 0 is a_len; each word's base is a_len plus
  // the differences of every column below it (an exclusive scan over the
  // lanes, then over the lane's words). Columns past N add junk only to
  // columns past N.
  int wb[K];
  int tot = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    wb[k] = tot;
    tot += __popc(P[k]) - __popc(Mv[k]);
  }
  int incl = tot;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const int lbase = alen + incl - tot;
#pragma unroll
  for (int k = 0; k < K; ++k) wb[k] += lbase;

  int* out = a.last_row + (size_t)r * (N + 1);
  // the column NW reads, as the reference's take_along_axis reads it: a
  // negative b_len counts from the row's end once; outside the row, INT_MIN
  const int jc = blen < 0 ? blen + N + 1 : blen;
  const bool jc_in = jc >= 0 && jc <= N;
  // this lane's least masked value, its last and first columns, and the
  // value at column jc
  int best = kBig, jmax = -1, jmin = kBig, nwv = kBig;
  if (lane == 0) {
    const int m = (captured && blen >= 0) ? alen : kBig;
    out[0] = m;
    best = m;
    jmax = jmin = 0;
    if (captured && jc == 0) nwv = alen;
  }
  const uint32_t below = (2u << lane) - 1u;  // bits 0..lane
  for (int o = 0; o < 32 && 32 * K * o < N; ++o) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c0 = 32 * (K * o + k);
      if (c0 >= N) break;  // uniform across the warp
      const uint32_t p = __shfl_sync(kFull, P[k], o);
      const uint32_t mm = __shfl_sync(kFull, Mv[k], o);
      const int base = __shfl_sync(kFull, wb[k], o);
      const int j = c0 + 1 + lane;
      if (j <= N) {
        const int val = base + __popc(p & below) - __popc(mm & below);
        const int m = (captured && j <= blen) ? val : kBig;
        out[j] = m;
        if (captured && j == jc) nwv = val;
        if (m < best) {
          best = m;
          jmin = j;
          jmax = j;
        } else if (m == best) {
          jmax = j;
        }
      }
    }
  }
  const int d = __reduce_min_sync(kFull, best);
  const int emax = __reduce_max_sync(kFull, best == d ? jmax : -1);
  const int emin = __reduce_min_sync(kFull, best == d ? jmin : kBig);
  const int nw = __reduce_min_sync(kFull, nwv);
  if (lane == 0) {
    if (a.mode == NW) {
      a.dist[r] = jc_in ? nw : (int)0x80000000u;
      a.end[r] = blen;
      a.end_min[r] = blen;
    } else {
      a.dist[r] = d;
      a.end[r] = emax;
      a.end_min[r] = emin;
    }
  }
}

template <int K>
cudaError_t launch_k(const Args& a, cudaStream_t st) {
  const int grid = (a.B + kWarps - 1) / kWarps;
  align_kernel<K><<<grid, 32 * kWarps, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int edit_distance_max_width() { return kMaxN; }

// One launch of the batch (ops/align_kernel.py:edit_distance_kernel); the
// outputs are the caller's.
extern "C" int edit_distance_launch(const void* const* ptrs, int n_ptrs,
                                    const long long* ints, int n_ints,
                                    int device, void* stream) {
  if (n_ptrs != P_COUNT || n_ints != I_COUNT)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.a_masks = (const uint8_t*)ptrs[P_A_MASKS];
  a.a_len = (const int*)ptrs[P_A_LEN];
  a.b_masks = (const uint8_t*)ptrs[P_B_MASKS];
  a.b_len = (const int*)ptrs[P_B_LEN];
  a.dist = (int*)ptrs[P_DIST];
  a.end = (int*)ptrs[P_END];
  a.end_min = (int*)ptrs[P_END_MIN];
  a.last_row = (int*)ptrs[P_LAST_ROW];
  // values stay below BIG: at most M + N
  if (ints[I_B] < 0 || ints[I_B] >= (1ll << 31) || ints[I_M] < 0 ||
      ints[I_N] < 0 || ints[I_N] > kMaxN || ints[I_M] + ints[I_N] >= kBig ||
      ints[I_MODE] < NW || ints[I_MODE] > HW)
    return (int)cudaErrorInvalidValue;
  a.B = (int)ints[I_B];
  a.M = (int)ints[I_M];
  a.N = (int)ints[I_N];
  a.mode = (int)ints[I_MODE];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.B == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int words = (a.N + 1023) / 1024;  // lane words needed
  if (words <= 1) return (int)launch_k<1>(a, st);
  if (words <= 2) return (int)launch_k<2>(a, st);
  if (words <= 3) return (int)launch_k<3>(a, st);
  if (words <= 4) return (int)launch_k<4>(a, st);
  if (words <= 6) return (int)launch_k<6>(a, st);
  if (words <= 8) return (int)launch_k<8>(a, st);
  if (words <= 12) return (int)launch_k<12>(a, st);
  return (int)launch_k<16>(a, st);
}
