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
// One warp per region runs the DP row by row, each lane holding
// C = ceil(W/32) consecutive columns in registers, with a 5-step
// __shfl_up_sync prefix-min scan per row. It stops at the region's last
// needed row, max(tgt_len, best_end) (best_end <= tgt_len in every batch the
// engine launches, so rows past tgt_len are never read). The decisions read
// the per-prefix minima dmin[i] and their max-tie end columns endcol[i] only
// at tgt_len, at best_end and at the first argmax of i - 2*dmin[i] over
// i <= tgt_len, so the warp keeps those three and nothing per row. The
// quality gates come from the exact integer sums of the clipped qualities
// (below 2^24, so equal to PyTorch's float32 cumsum); the float32 divisions
// and comparisons keep PyTorch's order (built with -fmad=false).
//
// What bounds it: a chain of up to NT+1 dependent row updates per region,
// a few dozen warp instructions each; bytes and operations are far below
// the card's rates: latency-bound. Regions run in parallel, four warps per
// block, the path's column masks in shared memory and the target masks
// fetched 32 rows at a time.
//
// Plain C interface (bound with ctypes from ratatosk_tpu_torch/ops/
// finish_kernel.py); the launcher never synchronises and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kInf = 1 << 28;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxW = 16 * 32;
constexpr int kWarps = 4;

// pointer table (ops/finish_kernel.py:PTRS)
enum {
  P_TGT_MASKS, P_TGT_LEN, P_TGT_QUAL, P_BEST_SEQ, P_BEST_LEN, P_BEST_DIST,
  P_BEST_END, P_SECOND_DIST, P_COMPLETED, P_SCALARS, P_SEQ_PACKED, P_COUNT
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
  float min_score_open;
  int R, NT, L, W, qv_max, min_k, stride;
};

__device__ __forceinline__ int window_start(int i, int seq_len, int l1,
                                            int W) {
  if (W >= l1) return 0;
  const int hi = max(seq_len + 1 - W, 0);
  return min(hi, max(i - W / 2, 0));
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

// mean certified quality of a target prefix against qv_max, floored at
// min_score_open (engine.gate_for); qsum is exact
__device__ __forceinline__ float gate(const Args& a, int qsum, int i) {
  const float qmean = (float)qsum / fmaxf((float)i, 1.0f);
  return fmaxf(a.min_score_open, qmean / fmaxf((float)a.qv_max, 1.0f));
}

template <int C>
__global__ void __launch_bounds__(32 * kWarps) finish_kernel(const Args a) {
  extern __shared__ uint8_t fsm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= a.R) return;  // the whole warp: no block barrier follows
  const int L = a.L, l1 = L + 1, W = a.W, NT = a.NT;
  const uint8_t* seq = a.best_seq + (size_t)r * L;
  // column j of the DP compares against the path's base j-1; column 0: 0
  uint8_t* seqm = fsm + (size_t)warp * a.stride;
  for (int j = lane; j < l1; j += 32)
    seqm[j] = j == 0 ? 0 : (uint8_t)(1 << min((int)seq[j - 1], 3));
  __syncwarp();

  const int n = a.tgt_len[r], blen = a.best_len[r];
  const int end = min(max(a.best_end[r], 0), NT);
  const int last = min(max(n, end), NT);
  const uint8_t* tm = a.tgt_masks + (size_t)r * NT;
  const int c0 = lane * C;

  int ws = window_start(0, blen, l1, W);
  int row[C];
#pragma unroll
  for (int x = 0; x < C; ++x) row[x] = (c0 + x < W) ? ws + c0 + x : kBig;

  int best_p = 0, ibest = 0, dmin_ib = 0, endc_ib = 0;
  int dmin_n = 0, endc_n = 0, dmin_e = 0, endc_e = 0;
  int mk = 0;
  for (int i = 0; i <= last; ++i) {
    if (i > 0) {
      if ((i - 1) % 32 == 0) mk = tm[min(i - 1 + lane, NT - 1)];
      const int amask = __shfl_sync(kFull, mk, (i - 1) % 32);
      const int ws_n = window_start(i, blen, l1, W);
      const bool adv = ws_n - ws == 1;
      int nxt = __shfl_down_sync(kFull, row[0], 1);
      int prv = __shfl_up_sync(kFull, row[C - 1], 1);
      if (lane == 31) nxt = kBig;
      if (lane == 0) prv = kBig;
      int t[C];
#pragma unroll
      for (int x = 0; x < C; ++x) {
        const int c = c0 + x;
        const int pj = adv ? ((x + 1 < C) ? row[x + 1] : nxt) : row[x];
        const int pjm1 = adv ? row[x] : ((x > 0) ? row[x - 1] : prv);
        const int col = ws_n + c;
        const int mask = (c < W) ? seqm[min(col, L)] : 0;
        int d = min(pjm1 + ((amask & mask) == 0 ? 1 : 0), pj + 1);
        if (col == 0) d = i;
        t[x] = d - col;
        if (x > 0) t[x] = min(t[x], t[x - 1]);
      }
      int tot = t[C - 1];
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int v = __shfl_up_sync(kFull, tot, s);
        if (lane >= s) tot = min(tot, v);
      }
      int below = __shfl_up_sync(kFull, tot, 1);
      if (lane == 0) below = kInf;
#pragma unroll
      for (int x = 0; x < C; ++x) {
        const int c = c0 + x;
        row[x] = (c < W) ? min(ws_n + c + min(t[x], below), kBig) : kBig;
      }
      ws = ws_n;
    }
    // per-prefix minimum over path columns <= best_len, and its max tie
    int lmin = kBig;
#pragma unroll
    for (int x = 0; x < C; ++x)
      if (c0 + x < W) lmin = min(lmin, ws + c0 + x <= blen ? row[x] : kBig);
    const int dmin = warp_min(lmin);
    const bool better = i <= n && (i == 0 || i - 2 * dmin > best_p);
    if (better || i == n || i == end) {
      int lcol = -1;
#pragma unroll
      for (int x = 0; x < C; ++x) {
        const int col = ws + c0 + x;
        if (c0 + x < W && (col <= blen ? row[x] : kBig) == dmin) lcol = col;
      }
      const int endc = warp_max(lcol);
      if (better) {
        best_p = i - 2 * dmin;
        ibest = i;
        dmin_ib = dmin;
        endc_ib = endc;
      }
      if (i == n) {
        dmin_n = dmin;
        endc_n = endc;
      }
      if (i == end) {
        dmin_e = dmin;
        endc_e = endc;
      }
    }
  }

  // exact prefix sums of the clipped qualities at n and at ibest
  const int* q = a.tgt_qual + (size_t)r * NT;
  int qs_n = 0, qs_ib = 0;
  for (int x = lane; x < max(n, ibest); x += 32) {
    const int v = min(q[x], a.qv_max);
    if (x < n) qs_n += v;
    if (x < ibest) qs_ib += v;
  }
  qs_n = warp_sum(qs_n);
  qs_ib = warp_sum(qs_ib);

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

template <int C>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * a.stride;
  cudaError_t err = cudaFuncSetAttribute(
      finish_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  finish_kernel<C><<<(a.R + kWarps - 1) / kWarps, 32 * kWarps, smem,
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
  a.min_score_open = min_score_open;
  a.R = (int)ints[I_R];
  a.NT = (int)ints[I_NT];
  a.L = (int)ints[I_L];
  const int w = (int)ints[I_W];
  a.qv_max = (int)ints[I_QV_MAX];
  a.min_k = (int)ints[I_MIN_K];
  // the full path row when w is 0 or covers it, else a w-wide band
  a.W = (w <= 0 || w >= a.L + 1) ? a.L + 1 : w;
  a.stride = (a.L + 1 + 15) / 16 * 16;
  if (a.R < 1 || a.NT < 1 || a.L < 1 || a.W > kMaxW ||
      (size_t)kWarps * a.stride > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int c = (a.W + 31) / 32;
  if (c <= 2) return launch<2>(a, s);
  if (c <= 4) return launch<4>(a, s);
  if (c <= 6) return launch<6>(a, s);
  if (c <= 9) return launch<9>(a, s);
  if (c <= 11) return launch<11>(a, s);
  if (c <= 13) return launch<13>(a, s);
  return launch<16>(a, s);
}
