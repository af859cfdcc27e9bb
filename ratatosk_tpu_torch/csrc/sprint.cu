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
// What bounds it: the work is a chain of <= 7 dependent substeps, each a row
// update plus a prefix-min over W <= 352 columns, on R*B*W*4 bytes that are
// read and written once (under 12 MB at R=512, B=16, W=336). Far too little
// arithmetic and traffic to load the card: it is latency-bound.
//
// What the design does about it: one block per region and one warp per beam
// entry, so every substep is warp-synchronous. A lane keeps C = ceil(W/32)
// consecutive columns of its row in registers for all substeps; the prefix-
// min is a sequential min inside the lane followed by a log2(32)-step
// __shfl_up_sync scan over the lanes' tails. The row never leaves registers
// between substeps, and no substep needs a block barrier: the target window
// lives in shared memory as one extended array (the W starting masks
// followed by the columns that the region's shifts bring in, in order), and
// substep j reads it at the number of shifts made so far. Integer-only, so
// there is no FMA contraction to guard against.
//
// Plain C interface (bound with ctypes from ratatosk_tpu_torch/ops/sprint.py):
// the launcher returns cudaGetLastError() and never synchronises.

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kInf = 1 << 28;
constexpr unsigned kFull = 0xffffffffu;

template <int C>
__global__ void sprint_rows_kernel(const int* __restrict__ rwin,
                                   const int* __restrict__ btgt,
                                   const int* __restrict__ nb_all,
                                   const int* __restrict__ newcols,
                                   const int* __restrict__ wsall,
                                   const int* __restrict__ m_reg,
                                   const int* __restrict__ live,
                                   const int* __restrict__ plen,
                                   int* __restrict__ rwin_out,
                                   int* __restrict__ btgt_out,
                                   int B, int W, int S1) {
  extern __shared__ int ext[];  // [W + S1]: window masks, then shifted-in cols
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int nthreads = 32 * blockDim.y;
  const int* ws = wsall + (size_t)r * (S1 + 1);
  const int m = min(m_reg[r], S1);

  for (int c = tid; c < W; c += nthreads) ext[c] = btgt[(size_t)r * W + c];
  if (tid == 0) {
    int t = 0;
    for (int j = 0; j < m; ++j)
      if (ws[j + 1] - ws[j] == 1) ext[W + t++] = newcols[(size_t)r * S1 + j];
  }
  __syncthreads();

  const int c0 = lane * C;
  for (int b = warp; b < B; b += blockDim.y) {
    const size_t rb = (size_t)r * B + b;
    const int* src = rwin + rb * W;
    int row[C];
#pragma unroll
    for (int i = 0; i < C; ++i) row[i] = (c0 + i < W) ? src[c0 + i] : kBig;

    if (live[rb] != 0) {
      const int pl = plen[rb];
      int shifts = 0;
      for (int j = 0; j < m; ++j) {
        const int ws_n = ws[j + 1];
        const bool adv = ws_n - ws[j] == 1;
        shifts += adv;
        const int bm = 1 << nb_all[rb * S1 + j];
        // neighbours across the lane boundary; beyond the band reads BIG
        int nxt = __shfl_down_sync(kFull, row[0], 1);
        int prv = __shfl_up_sync(kFull, row[C - 1], 1);
        if (lane == 31) nxt = kBig;
        if (lane == 0) prv = kBig;
        int t[C];
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int c = c0 + i;
          int pj, pjm1;
          if (adv) {
            pj = (i + 1 < C) ? row[i + 1] : nxt;
            pjm1 = row[i];
          } else {
            pj = row[i];
            pjm1 = (i > 0) ? row[i - 1] : prv;
          }
          const int mask = (c < W) ? ext[shifts + c] : 0;
          int d = min(pjm1 + ((bm & mask) == 0 ? 1 : 0), pj + 1);
          const int col = ws_n + c;
          if (col == 0) d = pl + j + 1;
          d = min(d, kBig);
          t[i] = d - col;
          if (i > 0) t[i] = min(t[i], t[i - 1]);
        }
        // inclusive warp scan of the lanes' tails, then the exclusive
        // prefix of the lanes below folds into each lane's columns
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
          // pad columns stay BIG: column W-1 reads BIG from beyond the band
          row[i] = (c < W) ? min(ws_n + c + min(t[i], below), kBig) : kBig;
        }
      }
    }

    int* dst = rwin_out + rb * W;
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (c0 + i < W) dst[c0 + i] = row[i];
  }

  int shifts = 0;
  for (int j = 0; j < m; ++j) shifts += (ws[j + 1] - ws[j] == 1);
  for (int c = tid; c < W; c += nthreads)
    btgt_out[(size_t)r * W + c] = ext[shifts + c];
}

template <int C>
void launch(dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
            const int* rwin, const int* btgt, const int* nb_all,
            const int* newcols, const int* wsall, const int* m_reg,
            const int* live, const int* plen, int* rwin_out, int* btgt_out,
            int B, int W, int S1) {
  sprint_rows_kernel<C><<<grid, block, smem, stream>>>(
      rwin, btgt, nb_all, newcols, wsall, m_reg, live, plen, rwin_out,
      btgt_out, B, W, S1);
}

}  // namespace

extern "C" int sprint_rows_max_width() { return 16 * 32; }

extern "C" int sprint_rows_launch(const void* rwin, const void* btgt,
                                  const void* nb_all, const void* newcols,
                                  const void* wsall, const void* m_reg,
                                  const void* live, const void* plen,
                                  void* rwin_out, void* btgt_out, int R, int B,
                                  int W, int S1, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int C = (W + 31) / 32;
  const dim3 grid(R);
  const dim3 block(32, B < 32 ? B : 32);
  const size_t smem = (size_t)(W + S1) * sizeof(int);
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
    launch<n>(grid, block, smem, s, a0, a1, a2, a3, a4, a5, a6, a7, o0, o1, \
              B, W, S1);                                                   \
    break;
  switch (C) {
    RT_CASE(1) RT_CASE(2) RT_CASE(3) RT_CASE(4) RT_CASE(5) RT_CASE(6)
    RT_CASE(7) RT_CASE(8) RT_CASE(9) RT_CASE(10) RT_CASE(11) RT_CASE(12)
    RT_CASE(13) RT_CASE(14) RT_CASE(15) RT_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_CASE
  return (int)cudaGetLastError();
}
