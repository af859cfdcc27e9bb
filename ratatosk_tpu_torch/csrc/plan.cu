// Device planner of a read batch, hand-written for Hopper (sm_90a): the
// anchor runs and the 1-edit seed probe.
//
// Computes ratatosk_tpu_torch/ops/plan_device.py:_runs_kernel and
// _probe_kernel, tensor for tensor. The reference computes both in plain
// JAX (ratatosk_tpu/ops/plan_device.py: `_runs_kernel` :90-110 and
// `_probe_kernel` :193-315, each one jitted XLA program, the edit positions
// a lax.scan); no Pallas kernel is replaced. The port's plain versions run
// them as a few thousand small PyTorch launches a batch.
//
// The index is the two-orientation hash directory of ops/hash_index.py:
// the key table (uint32 words, 2 or 4 a key, hash order), the bucket
// directory dir0 on the top `bits` bits of the key's hash h (FNV-1a over
// the words [lo0, lo1, hi0, hi1], then lowbias32), rowflag and upa. A probe
// reads dir0[b] and dir0[b + 1] and compares the bucket's rows in order,
// stopping at the first match or the bucket's end. The plain version
// compares dmax rows from dir0[b] (into the next buckets); both give the
// same slot, because the table holds each key once (k is odd, so no key is
// its own reverse complement) and a key equal to the query has the query's
// hash, so it lies in the query's bucket. Three hash passes must not be
// mixed up: the directory takes h's top bits, the prefilter bitmap
// lowbias32(h)'s top bits, the half bitmap lowbias32 of the hash of the
// h-window's single word.
//
// Work follows the batch, not its pad tier. The planner pads every batch's
// concat with bases >= 4 to a tier L (2^21 at the production batch size);
// a batch of 16 reads fills 3% of it. Nothing past the extent E (1 + the
// last index of a base < 4) can hit, qualify or seed: a k-window there
// holds a base >= 4. So each call runs two CUDA kernels (the probe a third):
//   *_prep   grid-stride over the codes with 16-byte loads: each block's
//            share of the extent (no host sync, no atomics); zeroes the
//            look-back words and counters; fills every output entry with
//            the value the plain version gives past n (runs: P and the
//            record of window P - 1, a miss record unless the last window
//            is valid; probe: L, -1, 0, -1), which the tile pass then
//            overwrites below n;
//   *_tiles  persistent blocks take tiles of positions in order (an atomic
//            counter) up to the walk's end: the runs to the last window that
//            can be valid, min(P, E - k + 1); the probe to min(L, E + nes),
//            past which no position is skipped by an exact hit. The allowed
//            positions past the walked tiles are counted in closed form from
//            the span starts (on-stride positions of each span; the last
//            span runs to L). A tile loads its bases with a halo once,
//            packs them into 2-bit words and an invalid-base mask in shared
//            memory; a window is then a funnel shift of three words and its
//            validity a count of leading zeros. Each in-order compaction
//            (the runs' starts and ends, each (kind, side)'s first qcap
//            qualifying positions) is one decoupled look-back scan over
//            the tiles, a warp per scan;
//   probe_out places each tile's seeds, which the tile pass wrote in order
//            to a segment of hcap entries taken with an atomic counter, at
//            the sum of the seed counts of the tiles before it, and
//            computes n, `of` and stats. (A look-back
//            in the tile pass would wait there for every older tile's
//            enumeration: the convoy took ~45% of the tile pass's SM cycles
//            on a k=63 batch.)
// The probe's tile pass fuses what were eight kernels: the exact k-window
// probes of the tile and of its nes halo on both sides (recomputed where a
// neighbour tile owns them), the near-exact skip, on_stride (a binary
// search of the span starts), the h-window half-bitmap tests of the
// positions that need them, each (kind, side)'s qualification and ranks,
// the enumeration of the listed positions' 1-edit variants, and the seeds.
// The variants of a tile are enumerated from a shared-memory list grouped
// by (kind, side): a thread takes one (position, edit position) unit at a
// time (SUB: 3 variants, INS: 4, DEL: 4 edit positions of 1) and issues
// its bitmap words' loads together before it tests any; a survivor
// (1-3%) is queued in shared memory with its key, and after the tests the
// whole block probes the queue in the table, several keys a thread in
// flight (a survivor probed where it was found stalled its warp for a
// chain of dependent reads in most iterations). A hit enters the
// position's placement identity min / max in shared memory ((row*3 + kind)
// << 1 | fw). Survivors are counted per (kind, side, p) in shared memory
// and added to global counters once a tile; their sum is the total.
//
// There is no survivor buffer: integer min and max do not depend on the
// order, so the result is deterministic. The overflow flag is what the
// plain version computes: any (kind, side) with more than qcap qualifying
// positions, any (kind, side, p) step with more than scap survivors, more
// than tcap survivors in all, or more than hcap seeds. The survivors are
// counted over the listed positions only (the plain version enumerates the
// first qcap). On a batch that overflows, the plain version drops
// survivors and the host plans the batch again: there only `of` and
// stats[0:3] are the same.
//
// What bounds it: random 32-byte sectors. The prefilter bitmap is 2^30 bits
// (128 MB) once the index holds 2^22 keys and the key table outgrows the
// 50 MB L2, so each bitmap test, directory read and key row is a sector
// from device memory; the arithmetic (hashing, shifts) is a few dozen
// integer operations a variant. The design keeps several of a thread's
// random reads in flight (four windows' directory pairs and rows, four
// variants' bitmap words) so that latency does not set the pace, and spends
// nothing on the pad tier but the prep's 2 MB read and the outputs' fill.
// chip_smoke.py counts the bound from what the batch needs: per probed key
// the directory pair and the sectors its bucket's rows span up to the
// match, per hit its rowflag (and upa) entry, per enumerated variant one
// bitmap word.
//
// Plain C interface (bound with ctypes from ratatosk_tpu_torch/ops/
// plan_kernel.py); the launchers never synchronise and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;            // probe positions a tile
constexpr int kRunsTile = 1022;        // runs windows a tile (+ 2 halo records)
constexpr int kPer = 4;                // runs windows a thread
constexpr int kQPer = kTile / kThreads;  // probe positions a thread
constexpr int kPrepMax = 264;          // prep blocks at most
constexpr int kMaxSides = 6;
constexpr int kMaxP = 64;              // edit positions: p < k + 1 <= 64
constexpr int kMaxNes = 4096;
constexpr int kRx = 5;                 // probe windows in flight a thread
constexpr int kRr = 4;                 // runs windows in flight a thread
constexpr int32_t kBig = 0x7FFFFFFF;
constexpr int kSub = 0, kDel = 1, kIns = 2;
constexpr unsigned long long kAgg = 1ull << 62, kPre = 2ull << 62,
                             kVal = (1ull << 62) - 1;

// SM cycles by phase of the two tile passes, summed over their blocks, in
// a build with PLAN_CLOCKS defined (scripts/kernel_compare.py --split):
// thread 0 of a block reads clock64() where a phase begins, after a
// barrier, and adds the cycles since the last mark to the phase that ends.
// [0] the probe's tiles: 0 extent, 1 bases loaded, 2 exact windows, 3
// allowed positions, 4 half tests, 5 qualifying ranks and look-back, 6
// listing, 7 variants tested, 8 survivors probed, 9 seeds, look-back,
// outputs, the last tile's finish and taking the next tile; [1] the
// runs': 0 extent, 1 bases loaded, 2 records, 3 starts and ends,
// look-back, outputs and taking the next tile.
constexpr int kClkPhases = 10;
#ifdef PLAN_CLOCKS
__device__ unsigned long long plan_clk[2][kClkPhases];
__device__ void phase_mark(int kern, int i) {
  __shared__ unsigned long long t_last;
  __shared__ int i_last;
  if (threadIdx.x != 0) return;
  const unsigned long long now = clock64();
  if (i > 0) atomicAdd(&plan_clk[kern][i_last], now - t_last);
  t_last = now;
  i_last = i;
}
#define PHASE(kern, i) phase_mark(kern, i)
#else
#define PHASE(kern, i)
#endif

// ---- words, hashes, bitmaps ----

struct U128 {
  uint64_t hi, lo;
};

__device__ __forceinline__ uint64_t shr64(uint64_t x, int s) {
  return s >= 64 ? 0ull : x >> s;
}
__device__ __forceinline__ uint64_t shl64(uint64_t x, int s) {
  return s >= 64 ? 0ull : x << s;
}
// (hi, lo) >> s and << s for s in [0, 128] (ops/u128.py:shr128, shl128)
__device__ __forceinline__ U128 shr128(U128 v, int s) {
  if (s >= 64) return {0ull, shr64(v.hi, s - 64)};
  return {shr64(v.hi, s), shr64(v.lo, s) | shl64(v.hi, 64 - s)};
}
__device__ __forceinline__ U128 shl128(U128 v, int s) {
  if (s >= 64) return {shl64(v.lo, s - 64), 0ull};
  return {shl64(v.hi, s) | shr64(v.lo, 64 - s), shl64(v.lo, s)};
}
// the low n bits, n in [0, 128]
__device__ __forceinline__ U128 mask128(int n) {
  if (n >= 64) return {n >= 128 ? ~0ull : shl64(1ull, n - 64) - 1ull, ~0ull};
  return {0ull, shl64(1ull, n) - 1ull};
}
__device__ __forceinline__ U128 or3(U128 a, U128 b, U128 c) {
  return {a.hi | b.hi | c.hi, a.lo | b.lo | c.lo};
}
__device__ __forceinline__ U128 and2(U128 a, U128 b) {
  return {a.hi & b.hi, a.lo & b.lo};
}

// base p (leftmost = 0) of an m-base window (ops/u128.py:get_base)
__device__ __forceinline__ int get_base(U128 v, int m, int p) {
  return (int)(shr128(v, 2 * (m - 1) - 2 * p).lo & 3ull);
}
// base p of an m-base window set to b
__device__ __forceinline__ U128 set_base(U128 v, int m, int p, int b) {
  const int s = 2 * (m - 1) - 2 * p;
  const U128 mk = shl128({0ull, 3ull}, s), bb = shl128({0ull, (uint64_t)b}, s);
  return {(v.hi & ~mk.hi) | bb.hi, (v.lo & ~mk.lo) | bb.lo};
}
// base p of an m-base window dropped: an (m-1)-base window
__device__ __forceinline__ U128 drop_base(U128 v, int m, int p) {
  const int s = 2 * (m - 1) - 2 * p;
  const U128 up = shl128(shr128(v, 2 * m - 2 * p), s);
  return or3(up, and2(v, mask128(s)), {0ull, 0ull});
}
// base b inserted before index p of an m-base window: m+1 bases
__device__ __forceinline__ U128 insert_base(U128 v, int m, int p, int b) {
  const int s = 2 * m - 2 * p;
  const U128 up = shl128(shr128(v, s), s + 2);
  return or3(up, shl128({0ull, (uint64_t)b}, s), and2(v, mask128(s)));
}

__device__ __forceinline__ uint32_t lowbias32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h ^ (h >> 16);
}
__device__ __forceinline__ uint32_t fnv(uint32_t h, uint32_t w) {
  return (h ^ w) * 0x01000193u;
}
// hash_index.hash_words over [lo0, lo1] or [lo0, lo1, hi0, hi1]
__device__ __forceinline__ uint32_t hash_key(U128 v, bool two) {
  uint32_t h = fnv(fnv(0x811C9DC5u, (uint32_t)v.lo), (uint32_t)(v.lo >> 32));
  if (two) h = fnv(fnv(h, (uint32_t)v.hi), (uint32_t)(v.hi >> 32));
  return lowbias32(h);
}
// hash_index.prefilter_test's bit: lowbias32(h) >> (32 - bits)
__device__ __forceinline__ uint32_t bitmap_bit(int bits, uint32_t h) {
  return lowbias32(h) >> (32 - bits);
}

// The m-base window at pos read from device memory (pos + m <= the array's
// end), bases big-endian as in ops/kmers.py; false when a base >= 4 lies in
// it. Only for the one window a block reads alone (the runs' fill record).
__device__ __forceinline__ bool pack(const uint8_t* codes, long long pos,
                                     int m, U128& v) {
  v = {0ull, 0ull};
  bool ok = true;
  for (int j = 0; j < m; ++j) {
    const uint8_t c = codes[pos + j];
    ok = ok && c < 4;
    v.hi = (v.hi << 2) | (v.lo >> 62);
    v.lo = (v.lo << 2) | (uint64_t)(c & 3);
  }
  return ok;
}

// ---- a tile's bases in shared memory ----

// floor(x / 16) * 16 for any sign
__device__ __forceinline__ long long floor16(long long x) {
  return x >= 0 ? x & ~15ll : -((-x + 15) & ~15ll);
}

// Bases g .. g + 32 * nwords of the codes into 2-bit words pw (32 bases a
// word, the first base in the top bits) and an invalid mask mk (a bit a
// base, the first base in bit 31; bases >= 4 and positions outside [0, L)
// are invalid). g is a multiple of 16; two threads build a word, each from
// one 16-byte load. Every thread of the block calls it; ends with a
// barrier.
__device__ void load_bases(const uint8_t* codes, long long L, bool aligned,
                           long long g, int nwords, uint64_t* pw,
                           uint32_t* mk) {
  const int nu = 2 * nwords;
  for (int u0 = 0; u0 < nu; u0 += kThreads) {
    const int u = u0 + (int)threadIdx.x;
    uint32_t p = 0, m = 0;
    if (u < nu) {
      const long long a = g + 16ll * u;
      uint8_t c[16];
      if (aligned && a >= 0 && a + 16 <= L) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes + a));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 16; ++j) c[j] = (uint8_t)(w[j >> 2] >> (8 * (j & 3)));
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          c[j] = (a + j >= 0 && a + j < L) ? codes[a + j] : (uint8_t)4;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        p = (p << 2) | (c[j] & 3u);
        m = (m << 1) | (c[j] >= 4 ? 1u : 0u);
      }
    }
    const uint32_t p1 = __shfl_down_sync(kFull, p, 1);
    const uint32_t m1 = __shfl_down_sync(kFull, m, 1);
    if (u < nu && (u & 1) == 0) {
      pw[u >> 1] = ((uint64_t)p << 32) | p1;
      mk[u >> 1] = (m << 16) | m1;
    }
  }
  __syncthreads();
}

// the m-base window (m in [1, 64]) at local base q
__device__ __forceinline__ U128 window(const uint64_t* pw, int q, int m) {
  const int w = q >> 5, r = 2 * (q & 31);
  const uint64_t a = pw[w], b = pw[w + 1], c = pw[w + 2];
  const uint64_t top = r ? (a << r) | (b >> (64 - r)) : a;
  const uint64_t nxt = r ? (b << r) | (c >> (64 - r)) : b;
  return shr128({top, nxt}, 128 - 2 * m);
}

// valid bases from local base q on, at most 64
__device__ __forceinline__ int valid_run(const uint32_t* mk, int q) {
  const int w = q >> 5, r = q & 31;
  uint64_t x = ((uint64_t)mk[w] << 32) | mk[w + 1];
  if (r) x = (x << r) | (mk[w + 2] >> (32 - r));
  return __clzll((long long)x);
}

__device__ __forceinline__ bool bit_at(const uint32_t* b, int i) {
  return (b[i >> 5] >> (i & 31)) & 1u;
}
// any bit set in [lo, hi]
__device__ __forceinline__ bool any_bit(const uint32_t* b, int lo, int hi) {
  for (int w = lo >> 5; w <= (hi >> 5); ++w) {
    uint32_t x = b[w];
    if (w == (lo >> 5)) x &= ~0u << (lo & 31);
    if (w == (hi >> 5) && (hi & 31) != 31) x &= (2u << (hi & 31)) - 1u;
    if (x) return true;
  }
  return false;
}

// ---- the hash directory ----

struct Index {
  const uint32_t* key_tbl;  // [nn, nw] (the int32 tensor's bits)
  const int64_t* dir0;      // [1 << bits] bucket starts
  const int32_t* rowflag;   // [nn] (row << 1) | is_fw
  long long nn;
  int nw, bits, dmax;
};

// key row d equals v (its words read together: one sector)
__device__ __forceinline__ bool row_is(const Index& ix, long long d, U128 v) {
  const uint32_t* r = ix.key_tbl + d * ix.nw;
  const uint32_t w0 = __ldg(r), w1 = __ldg(r + 1);
  const uint32_t w2 = ix.nw == 4 ? __ldg(r + 2) : (uint32_t)v.hi;
  const uint32_t w3 = ix.nw == 4 ? __ldg(r + 3) : (uint32_t)(v.hi >> 32);
  return w0 == (uint32_t)v.lo && w1 == (uint32_t)(v.lo >> 32) &&
         w2 == (uint32_t)v.hi && w3 == (uint32_t)(v.hi >> 32);
}

// Slot of the key v with hash h in the table, or -1.
__device__ __forceinline__ long long find_slot(const Index& ix, U128 v,
                                               uint32_t h) {
  const uint32_t b = h >> (32 - ix.bits);
  long long d = __ldg(ix.dir0 + b);
  long long end = (b + 1u < (1u << ix.bits)) ? __ldg(ix.dir0 + b + 1) : ix.nn;
  if (end > d + ix.dmax) end = d + ix.dmax;
  for (; d < end; ++d)
    if (row_is(ix, d, v)) return d;
  return -1;
}

// The slots of R keys (ok[c]: key c is probed, else -1), their directory
// pairs and then their rows read side by side, so that a thread keeps R
// random reads in flight.
template <int R>
__device__ __forceinline__ void find_slots(const Index& ix, const U128* v,
                                           const bool* ok, long long* slot) {
  long long d[R], end[R];
#pragma unroll
  for (int c = 0; c < R; ++c) {
    slot[c] = -1;
    d[c] = end[c] = 0;
    if (ok[c]) {
      const uint32_t b = hash_key(v[c], ix.nw == 4) >> (32 - ix.bits);
      d[c] = __ldg(ix.dir0 + b);
      end[c] = (b + 1u < (1u << ix.bits)) ? __ldg(ix.dir0 + b + 1) : ix.nn;
    }
  }
#pragma unroll
  for (int c = 0; c < R; ++c)
    if (end[c] > d[c] + ix.dmax) end[c] = d[c] + ix.dmax;
  for (int r = 0;; ++r) {
    bool more = false;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      if (slot[c] < 0 && d[c] + r < end[c]) {
        if (row_is(ix, d[c] + r, v[c])) slot[c] = d[c] + r;
        else more = more || d[c] + r + 1 < end[c];
      }
    }
    if (!more) break;
  }
}

// ---- scans ----

// Exclusive prefix sum of v over the block's threads in thread order, and
// the block's total (64-bit; packed fields do not carry when each field's
// block total fits it). Every thread of the block calls it.
__device__ uint64_t block_scan(uint64_t v, uint64_t& total, uint64_t* wsum) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint64_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  uint64_t before = 0, tot = 0;
#pragma unroll
  for (int j = 0; j < kWarps; ++j) {
    const uint64_t s = wsum[j];
    before += j < w ? s : 0ull;
    tot += s;
  }
  total = tot;
  __syncthreads();
  return before + x - v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// the sum of v over the block (every thread of the block calls it)
__device__ long long block_sum(long long v, long long* wsum) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
  for (int j = 0; j < kWarps; ++j) v += wsum[j];
  __syncthreads();
  return v;
}

// Decoupled look-back over tiles taken in order: publishes tile t's count
// agg in st[t] (flag in the top two bits: 1 its own count, 2 the inclusive
// prefix) and returns the sum of the counts of tiles 0..t-1. One whole warp
// calls it; its lanes read 32 predecessors at once.
__device__ long long lookback(unsigned long long* st, int t, long long agg) {
  const int lane = threadIdx.x & 31;
  if (lane == 0)
    atomicExch(st + t, (t == 0 ? kPre : kAgg) | (unsigned long long)agg);
  long long excl = 0;
  for (int j = t - 1; j >= 0; j -= 32) {
    const int p = j - lane;
    unsigned long long w = kPre;           // before tile 0: a prefix of 0
    if (p >= 0) {
      do {
        w = *(volatile unsigned long long*)(st + p);
      } while ((w >> 62) == 0);
    }
    const unsigned pre = __ballot_sync(kFull, (w >> 62) == 2);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    excl += warp_sum(lane <= stop ? (long long)(w & kVal) : 0ll);
    if (pre) break;
  }
  if (lane == 0 && t > 0)
    atomicExch(st + t, kPre | (unsigned long long)(excl + agg));
  return excl;
}

// Each prep block's share of the extent: 1 + the last index of a base < 4
// among the 16-byte chunks it reads (0: none).
__device__ void extent_part(const uint8_t* codes, long long L, bool aligned,
                            int32_t* ext) {
  __shared__ int32_t wmax[kWarps];
  int best = 0;
  const long long nch = (L + 15) / 16;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < nch; c += (long long)gridDim.x * blockDim.x) {
    const long long a = 16 * c;
    if (aligned && a + 16 <= L) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes + a));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (((w[j >> 2] >> (8 * (j & 3))) & 0xFCu) == 0) best = (int)(a + j + 1);
    } else {
      for (int j = 0; j < 16 && a + j < L; ++j)
        if (codes[a + j] < 4) best = (int)(a + j + 1);
    }
  }
  best = (int)__reduce_max_sync(kFull, (unsigned)best);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 1; j < kWarps; ++j) best = max(best, wmax[j]);
    ext[blockIdx.x] = best;
  }
}

// The extent from the prep blocks' shares (every thread of the block calls
// it).
__device__ long long read_extent(const int32_t* ext, int nprep) {
  __shared__ int32_t wmax[kWarps];
  int best = 0;
  for (int j = threadIdx.x; j < nprep; j += blockDim.x)
    best = max(best, *(volatile const int32_t*)(ext + j));
  best = (int)__reduce_max_sync(kFull, (unsigned)best);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = best;
  __syncthreads();
  best = 0;
  for (int j = 0; j < kWarps; ++j) best = max(best, wmax[j]);
  __syncthreads();
  return best;
}

// the next tile of the block (every thread), or -1 past ntiles
__device__ int next_tile(unsigned long long* ctr, int ntiles) {
  __shared__ int t;
  __syncthreads();
  if (threadIdx.x == 0) t = (int)atomicAdd(ctr, 1ull);
  __syncthreads();
  return t < ntiles ? t : -1;
}

__device__ __forceinline__ void zero_words(unsigned long long* p, long long n) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (long long)gridDim.x * blockDim.x)
    p[j] = 0ull;
}

// ---- runs ----

enum {
  R_CODES, R_KEY_TBL, R_DIR0, R_ROWFLAG, R_UPA, R_NK, R_SCRATCH, R_SIDX,
  R_EIDX, R_OUID, R_ODIR, R_OO, R_N, R_COUNT
};
enum { RI_L, RI_K, RI_RCAP, RI_NN, RI_NW, RI_BITS, RI_DMAX, RI_SCRATCH,
       RI_COUNT };

struct RunsArgs {
  Index ix;
  const uint8_t* codes;
  const int32_t* upa;       // [nn, 2] (unitig id, pos << 1 | strand)
  const int64_t* nk;
  // scratch: [0] the next tile, then the starts' and the ends' look-back
  // words [maxtiles] each, then the prep blocks' extents (int32)
  unsigned long long* ctr;
  unsigned long long *sstat, *estat;
  int32_t* ext;
  int64_t *sidx, *eidx, *ouid, *odir, *oo, *n;
  long long L, P;
  int k, rcap, nprep, maxtiles;
  bool aligned;
};

// words of a runs tile's bases: records of kRunsTile + 2 windows from a
// base up to 15 before the first
__host__ __device__ inline int runs_words(int k) {
  return (kRunsTile + 2 + k + 16) / 32 + 3;
}

// a window's record: unitig id (-1: miss), direction, oriented offset
struct Rec {
  int32_t uid;
  int8_t dirn;
  int64_t o;
};

// The records of R probed windows (slot -1: a miss, which reads row 0's
// flag as the plain version's clamped gather does): every window's rowflag
// and upa entries read side by side, then the nk entries of those that
// run in reverse.
template <int R>
__device__ __forceinline__ void records_of(const RunsArgs& a,
                                           const long long* slot, Rec* rec) {
  int32_t rf[R], uid[R], ps[R];
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const bool hit = slot[c] >= 0;
    rf[c] = __ldg(a.ix.rowflag + (hit ? slot[c] : 0));
    uid[c] = hit ? __ldg(a.upa + 2 * slot[c]) : -1;
    ps[c] = hit ? __ldg(a.upa + 2 * slot[c] + 1) : 0;
  }
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const int64_t pos = ps[c] >> 1;
    const int dirn = ((rf[c] & 1) == ((ps[c] & 1) == 1)) ? 0 : 1;
    rec[c] = {uid[c], (int8_t)dirn,
              dirn == 0 ? pos
                        : __ldg(a.nk + (uid[c] >= 0 ? uid[c] : 0)) - 1 - pos};
  }
}

__global__ void __launch_bounds__(kThreads) runs_prep(const RunsArgs a) {
  __shared__ Rec last;
  extent_part(a.codes, a.L, a.aligned, a.ext);
  zero_words(a.ctr, 1 + 2ll * a.maxtiles);
  if (threadIdx.x == 0) {
    U128 v;
    long long slot = -1;
    if (pack(a.codes, a.P - 1, a.k, v))
      slot = find_slot(a.ix, v, hash_key(v, a.ix.nw == 4));
    records_of<1>(a, &slot, &last);
  }
  __syncthreads();
  // every entry as past the runs: P and the record of window P - 1
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < a.rcap; j += (long long)gridDim.x * blockDim.x) {
    a.sidx[j] = a.P;
    a.eidx[j] = a.P;
    a.ouid[j] = last.uid;
    a.odir[j] = last.dirn;
    a.oo[j] = last.o;
  }
}

__global__ void __launch_bounds__(kThreads) runs_tiles(const RunsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t wsum[kWarps];
  __shared__ long long pre[2];
  __shared__ int32_t ruid[kRunsTile + 2];
  __shared__ int8_t rdir[kRunsTile + 2];
  __shared__ int64_t ro[kRunsTile + 2];
  const int nwords = runs_words(a.k);
  uint64_t* pw = reinterpret_cast<uint64_t*>(smem);
  uint32_t* mk = reinterpret_cast<uint32_t*>(pw + nwords);
  PHASE(1, 0);
  const long long E = read_extent(a.ext, a.nprep);
  const long long walk = min(a.P, max(E - a.k + 1, 0ll));
  const int ntiles = max(1, (int)((walk + kRunsTile - 1) / kRunsTile));
  for (int t; (t = next_tile(a.ctr, ntiles)) >= 0;) {
    const long long t0 = (long long)t * kRunsTile;
    const int tn = (int)min((long long)kRunsTile, a.P - t0);
    // records of windows t0 - 1 .. t0 + tn, from bases g on
    const long long g = floor16(t0 - 1);
    PHASE(1, 1);
    load_bases(a.codes, a.L, a.aligned, g, nwords, pw, mk);
    PHASE(1, 2);
    const int off = (int)(t0 - 1 - g);
    for (int r0 = 0; r0 < tn + 2; r0 += kRr * kThreads) {
      U128 v[kRr];
      bool ok[kRr];
      long long slot[kRr];
#pragma unroll
      for (int c = 0; c < kRr; ++c) {
        const int x = r0 + c * kThreads + threadIdx.x;
        const long long i = t0 - 1 + x;
        ok[c] = x < tn + 2 && i >= 0 && i < a.P &&
                valid_run(mk, off + x) >= a.k;
        v[c] = ok[c] ? window(pw, off + x, a.k) : U128{0ull, 0ull};
      }
      find_slots<kRr>(a.ix, v, ok, slot);
      Rec rc[kRr];
      records_of<kRr>(a, slot, rc);
#pragma unroll
      for (int c = 0; c < kRr; ++c) {
        const int x = r0 + c * kThreads + threadIdx.x;
        if (x < tn + 2) {
          ruid[x] = rc[c].uid;
          rdir[x] = rc[c].dirn;
          ro[x] = rc[c].o;
        }
      }
    }
    __syncthreads();
    PHASE(1, 3);
    // starts and ends of my positions (record x + 1 is window t0 + x)
    auto chained = [&](int x) {   // record x + 1 continues the run of x
      return ruid[x] >= 0 && ruid[x + 1] >= 0 && ruid[x] == ruid[x + 1] &&
             rdir[x] == rdir[x + 1] && ro[x + 1] == ro[x] + 1;
    };
    unsigned sm = 0, em = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int x = kPer * threadIdx.x + j;
      if (x < tn && ruid[x + 1] >= 0) {
        sm |= (unsigned)!chained(x) << j;
        em |= (unsigned)!chained(x + 1) << j;
      }
    }
    uint64_t tot;
    const uint64_t ex = block_scan(__popc(sm) | ((uint64_t)__popc(em) << 32),
                                   tot, wsum);
    const int w = threadIdx.x >> 5;
    if (w < 2) {
      const long long p = lookback(w == 0 ? a.sstat : a.estat, t,
                                   (long long)(w == 0 ? tot & 0xffffffffu
                                                      : tot >> 32));
      if ((threadIdx.x & 31) == 0) pre[w] = p;
    }
    __syncthreads();
    long long rs = pre[0] + (long long)(ex & 0xffffffffu);
    long long re = pre[1] + (long long)(ex >> 32);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int x = kPer * threadIdx.x + j;
      const long long i = t0 + x;
      if ((sm >> j) & 1u) {
        if (rs < a.rcap) {
          a.sidx[rs] = i;
          a.ouid[rs] = ruid[x + 1];
          a.odir[rs] = rdir[x + 1];
          a.oo[rs] = ro[x + 1];
        }
        ++rs;
      }
      if ((em >> j) & 1u) {
        if (re < a.rcap) a.eidx[re] = i;
        ++re;
      }
    }
    if (t == ntiles - 1 && threadIdx.x == 0)
      *a.n = pre[0] + (long long)(tot & 0xffffffffu);
  }
  PHASE(1, kClkPhases);
}

// ---- probe ----

enum {
  Q_CODES, Q_STARTS, Q_KEY_TBL, Q_DIR0, Q_ROWFLAG, Q_PF, Q_HF, Q_SCRATCH,
  Q_SEEDS, Q_SEL, Q_OEX_ROW, Q_OEX_FW, Q_OVARID, Q_N, Q_OF, Q_STATS, Q_COUNT
};
enum {
  QI_L, QI_K, QI_STRIDE, QI_NES, QI_SUBS, QI_INDELS, QI_PF_BITS, QI_HF_BITS,
  QI_QCAP, QI_SCAP, QI_TCAP, QI_HCAP, QI_NN, QI_NW, QI_BITS, QI_DMAX,
  QI_NSTARTS, QI_SCRATCH, QI_COUNT
};

// one pigeonhole side of one kind: the m-window, the edit positions
// [p_lo, p_hi), whether the side's flag is the h-suffix's half hit, and
// the edit positions a unit of enumeration takes (DEL: 4 of 1 variant)
struct Side {
  int kind, m, p_lo, p_hi, suffix, pp;
};

struct ProbeArgs {
  Index ix;
  const uint8_t* codes;
  const int64_t* starts;    // [nstarts] span starts, ascending
  const uint32_t* pf;       // prefilter bitmap
  const uint32_t* hf;       // half bitmap
  // scratch: [0] the next tile, [2] allowed positions, [3] seed entries
  // taken, [4, 4 + kMaxSides) qualifying counts, [12, 12 + kMaxSides *
  // kMaxP) survivors per step, then each tile's seed segment and count
  // ((at << 32) | count) [maxtiles], each side's look-back words
  // [maxtiles], the prep blocks' extents (int32)
  unsigned long long* ctr;
  long long* tot;
  unsigned long long* step_cnt;
  long long* seedcnt;
  unsigned long long* qstat;
  int32_t* ext;
  int4* seeds;              // [hcap] each tile's seeds, in order, in a
                            // segment taken with an atomic counter
  int64_t *sel, *oex_row, *oex_fw, *ovarid, *n, *stats;
  bool* of;
  long long L, P, nstarts;
  int k, h, stride, nes, pf_bits, hf_bits, qcap, scap, tcap, hcap;
  int nsides, nprep, maxtiles;
  bool aligned;
  Side side[kMaxSides];
};

// The tile pass's dynamic shared memory (byte offsets), from nes and k.
// The 1-edit variant c of the m-window v for an edit of `kind` at p: SUB
// base c at p, INS base c before p, DEL the base at p + c dropped.
__device__ __forceinline__ U128 variant(int kind, U128 v, int k, int p,
                                        int c) {
  return kind == kSub   ? set_base(v, k, p, c)
         : kind == kIns ? insert_base(v, k - 1, p, c)
                        : drop_base(v, k + 1, p + c);
}

// A prefilter survivor queued for the table: its key, its position in the
// tile, its kind.
struct Surv {
  U128 key;
  int32_t x, kind;
};
constexpr int kQueue = 1024;   // survivors a tile queues (more: probed at once)

// Enter the placement identity of the table's slot for a variant of `kind`
// at tile position x: ((row * 3 + kind) << 1) | fw, its min and its max.
__device__ __forceinline__ void place(const Index& ix, long long slot,
                                      int kind, int x, int32_t* smin,
                                      int32_t* smax) {
  const int32_t rf = __ldg(ix.rowflag + slot);
  const int32_t id = (((rf >> 1) * 3 + kind) << 1) | (rf & 1);
  atomicMin(&smin[x], id);
  atomicMax(&smax[x], id);
}

struct ProbeSmem {
  int surv, pw, mk, exb, hhb, needb, bytes, nwords, n_ex, n_h;
};
__host__ __device__ inline ProbeSmem probe_smem(int nes, int k) {
  ProbeSmem s;
  s.nwords = (kTile + 2 * nes + k + 18) / 32 + 3;
  s.n_ex = (kTile + 2 * nes + kRx * kThreads - 1) / (kRx * kThreads) * kRx *
           kWarps;     // words of the exact bits: whole rounds of ballots
  s.n_h = (kTile + k + 2 + kRx * kThreads - 1) / (kRx * kThreads) * kRx *
          kWarps;
  s.surv = 0;
  s.pw = s.surv + (int)sizeof(Surv) * kQueue;
  s.mk = s.pw + 8 * s.nwords;
  s.exb = s.mk + 4 * s.nwords;
  s.hhb = s.exb + 4 * s.n_ex;
  s.needb = s.hhb + 4 * s.n_h;
  s.bytes = s.needb + 4 * s.n_h;
  return s;
}

constexpr int kScratchHead = 12 + kMaxSides * kMaxP;   // words before seedcnt

__global__ void __launch_bounds__(kThreads) probe_prep(const ProbeArgs a) {
  extent_part(a.codes, a.L, a.aligned, a.ext);
  zero_words(a.ctr, kScratchHead + (long long)(1 + a.nsides) * a.maxtiles);
  // every entry as past the seeds: L and the values at L - 1 (no window
  // there: row -1, fw 0, no placement)
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < a.hcap; j += (long long)gridDim.x * blockDim.x) {
    a.sel[j] = a.L;
    a.oex_row[j] = -1;
    a.oex_fw[j] = 0;
    a.ovarid[j] = -1;
  }
}

// the span start of position i: the last start <= i (0 before the first)
__device__ __forceinline__ long long span_of(const ProbeArgs& a, long long i,
                                             long long& j) {
  long long lo = 0, hi = a.nstarts;      // first start > i
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(a.starts + mid) <= i) lo = mid + 1;
    else hi = mid;
  }
  j = lo - 1;
  return j >= 0 ? __ldg(a.starts + j) : 0;
}

// positions i in [lo, hi) with (i - s) % stride == 0, for lo >= s
__device__ __forceinline__ long long on_stride_count(long long lo, long long hi,
                                                     long long s, int stride) {
  const long long first = s + (lo - s + stride - 1) / stride * stride;
  return first < hi ? (hi - 1 - first) / stride + 1 : 0;
}

// After the tile pass: the allowed positions past the walked tiles,
// [X, L), in closed form (no skip there, so every on-stride position of a
// span; the last span runs to L), then n, `of` and stats.
__device__ void probe_finish(const ProbeArgs& a, int ntiles, long long n) {
  __shared__ long long wsum[kWarps];
  const long long X = min(a.L, (long long)ntiles * kTile);
  long long cnt = 0;
  if (X < a.L) {
    if (a.stride <= 1) {
      if (threadIdx.x == 0) cnt = a.L - X;
    } else {
      long long j0;
      span_of(a, X, j0);
      for (long long j = j0 + threadIdx.x; j < a.nstarts; j += blockDim.x) {
        const long long s = j >= 0 ? a.starts[j] : 0;
        const long long hi = j + 1 < a.nstarts ? a.starts[j + 1] : a.L;
        cnt += on_stride_count(max(X, s), min(hi, a.L), s, a.stride);
      }
    }
  }
  cnt = block_sum(cnt, wsum);
  // the survivors of each (kind, side, p) step, a thread each
  long long c = 0;
  int over = 0;
  for (int j = threadIdx.x; j < a.nsides * kMaxP; j += blockDim.x) {
    const Side S = a.side[j / kMaxP];
    const int p = j % kMaxP;
    if (p >= S.p_lo && p < S.p_hi) {
      const unsigned long long cj = a.step_cnt[j];
      c += (long long)cj;
      over |= cj > (unsigned long long)a.scap;
    }
  }
  over = __syncthreads_or(over);
  const unsigned long long surv = (unsigned long long)block_sum(c, wsum);
  if (threadIdx.x != 0) return;
  const long long allowed = (long long)a.ctr[2] + cnt;
  bool of = n > a.hcap || over;
  long long nq_max = 0;
  for (int s = 0; s < a.nsides; ++s) {
    const long long tq = a.tot[s];
    of = of || tq > a.qcap;
    nq_max = tq > nq_max ? tq : nq_max;
  }
  of = of || surv > (unsigned long long)a.tcap;
  *a.n = n;
  *a.of = of;
  a.stats[0] = allowed;
  a.stats[1] = nq_max;
  a.stats[2] = surv < (unsigned long long)a.tcap ? (long long)surv : a.tcap;
  a.stats[3] = n;
}

__global__ void __launch_bounds__(kThreads) probe_tiles(const ProbeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t wsum[kWarps];
  __shared__ int32_t exrow[kTile], smin[kTile], smax[kTile];
  __shared__ int8_t exfw[kTile];
  __shared__ uint16_t items[kMaxSides * kTile];
  __shared__ uint32_t scnt[kMaxSides * kMaxP];
  __shared__ long long qpre[kMaxSides + 1];
  __shared__ int listed[kMaxSides], item_off[kMaxSides + 1],
      unit_off[kMaxSides + 1], units[kMaxSides];
  __shared__ int nsurv;
  __shared__ long long seg_at;
  const ProbeSmem lay = probe_smem(a.nes, a.k);
  Surv* surv = reinterpret_cast<Surv*>(smem + lay.surv);
  uint64_t* pw = reinterpret_cast<uint64_t*>(smem + lay.pw);
  uint32_t* mk = reinterpret_cast<uint32_t*>(smem + lay.mk);
  uint32_t* exb = reinterpret_cast<uint32_t*>(smem + lay.exb);
  uint32_t* hhb = reinterpret_cast<uint32_t*>(smem + lay.hhb);
  uint32_t* needb = reinterpret_cast<uint32_t*>(smem + lay.needb);
  const bool two = a.ix.nw == 4;
  const int k = a.k, h = a.h, nes = a.nes, lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5;
  PHASE(0, 0);
  const long long E = read_extent(a.ext, a.nprep);
  const int32_t row0_flag = __ldg(a.ix.rowflag);
  const long long walk = min(a.L, E + nes);
  const int ntiles = max(1, (int)((walk + kTile - 1) / kTile));
  for (int t; (t = next_tile(a.ctr, ntiles)) >= 0;) {
    const long long t0 = (long long)t * kTile;
    const int tn = (int)min((long long)kTile, a.L - t0);
    const long long g = floor16(t0 - nes);
    PHASE(0, 1);
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      smin[j] = kBig;
      smax[j] = -kBig;
    }
    for (int j = threadIdx.x; j < a.nsides * kMaxP; j += kThreads) scnt[j] = 0;
    for (int j = threadIdx.x; j < lay.n_h; j += kThreads) needb[j] = 0;
    if (threadIdx.x == 0) nsurv = 0;
    load_bases(a.codes, a.L, a.aligned, g, lay.nwords, pw, mk);
    const int off = (int)(t0 - g);           // local base of position t0
    PHASE(0, 2);

    // exact k-windows of the tile and its nes halo: position t0 - nes + x
    const int nex = tn + 2 * nes;
    for (int r0 = 0; r0 < nex; r0 += kRx * kThreads) {
      U128 v[kRx];
      bool ok[kRx];
      long long slot[kRx];
#pragma unroll
      for (int c = 0; c < kRx; ++c) {
        const int x = r0 + c * kThreads + threadIdx.x;
        const long long i = t0 - nes + x;
        ok[c] = x < nex && i >= 0 && i < a.P &&
                valid_run(mk, off - nes + x) >= k;
        v[c] = ok[c] ? window(pw, off - nes + x, k) : U128{0ull, 0ull};
      }
      find_slots<kRx>(a.ix, v, ok, slot);
      int32_t rf[kRx];
#pragma unroll
      for (int c = 0; c < kRx; ++c)   // the hits' flags read side by side
        rf[c] = slot[c] >= 0 ? __ldg(a.ix.rowflag + slot[c]) : 0;
#pragma unroll
      for (int c = 0; c < kRx; ++c) {
        const int x = r0 + c * kThreads + threadIdx.x;
        const unsigned b = __ballot_sync(kFull, slot[c] >= 0);
        if (lane == 0) exb[(r0 + c * kThreads) / 32 + warp] = b;
        const int xi = x - nes;
        if (x < nex && xi >= 0 && xi < tn) {
          // a miss reads row 0's flag (the plain version's clamped
          // gather); past the last window: row -1, fw 0
          const int32_t f = slot[c] >= 0 ? rf[c]
                            : t0 + xi < a.P ? row0_flag : 0;
          exrow[xi] = slot[c] >= 0 ? f >> 1 : -1;
          exfw[xi] = (int8_t)(f & 1);
        }
      }
    }
    __syncthreads();
    PHASE(0, 3);

    // allowed positions (near-exact skip, on_stride), their valid-base runs,
    // and which h-windows they need
    unsigned allowed = 0;
    int run[kQPer];
    {
      long long j;
      long long s = span_of(a, t0 + kQPer * threadIdx.x, j);
#pragma unroll
      for (int q = 0; q < kQPer; ++q) {
        const int x = kQPer * threadIdx.x + q;
        const long long i = t0 + x;
        while (j + 1 < a.nstarts && __ldg(a.starts + j + 1) <= i)
          s = __ldg(a.starts + ++j);
        run[q] = 0;
        if (x >= tn) continue;
        const bool skip = nes > 0 && any_bit(exb, x, x + 2 * nes);
        const bool on = a.stride <= 1 || (i - s) % a.stride == 0;
        if (skip || !on) continue;
        allowed |= 1u << q;
        run[q] = valid_run(mk, off + x);
        for (int sd = 0; sd < a.nsides; sd += 2) {
          const int m = a.side[sd].m;
          if (run[q] < m) continue;
          atomicOr(&needb[x >> 5], 1u << (x & 31));
          const int y = x + m - h;
          atomicOr(&needb[y >> 5], 1u << (y & 31));
        }
      }
    }
    __syncthreads();
    PHASE(0, 4);
    // the half-bitmap tests of the needed h-windows (position t0 + x)
    const int nh = tn + k + 2;
    for (int r0 = 0; r0 < nh; r0 += kRx * kThreads) {
      uint32_t word[kRx], bit[kRx];
      bool ok[kRx];
#pragma unroll
      for (int c = 0; c < kRx; ++c) {
        const int x = r0 + c * kThreads + threadIdx.x;
        ok[c] = x < nh && bit_at(needb, x) && valid_run(mk, off + x) >= h;
        word[c] = 0;
        if (ok[c]) {
          bit[c] = bitmap_bit(a.hf_bits, hash_key(window(pw, off + x, h),
                                                  false));
          word[c] = __ldg(a.hf + (bit[c] >> 5));
        }
      }
#pragma unroll
      for (int c = 0; c < kRx; ++c) {
        const unsigned b = __ballot_sync(
            kFull, ok[c] && ((word[c] >> (bit[c] & 31)) & 1u));
        if (lane == 0) hhb[(r0 + c * kThreads) / 32 + warp] = b;
      }
    }
    __syncthreads();
    PHASE(0, 5);

    // each (kind, side)'s qualifying positions: counts, ranks, look-back
    unsigned qm[kQPer];
    uint64_t pa = 0, pb = 0;
#pragma unroll
    for (int q = 0; q < kQPer; ++q) {
      const int x = kQPer * threadIdx.x + q;
      qm[q] = 0;
      if (!((allowed >> q) & 1u)) continue;
      for (int sd = 0; sd < a.nsides; ++sd) {
        const Side S = a.side[sd];
        if (run[q] >= S.m && bit_at(hhb, S.suffix ? x + S.m - h : x))
          qm[q] |= 1u << sd;
      }
      for (int sd = 0; sd < a.nsides; ++sd) {
        const uint64_t one = (qm[q] >> sd) & 1u;
        if (sd < 4) pa += one << (16 * sd);
        else pb += one << (16 * (sd - 4));
      }
    }
    pb += (uint64_t)__popc(allowed) << 32;
    uint64_t ta, tb;
    const uint64_t ea = block_scan(pa, ta, wsum);
    const uint64_t eb = block_scan(pb, tb, wsum);
    auto field = [](uint64_t a4, uint64_t b4, int sd) {
      return (long long)((sd < 4 ? a4 >> (16 * sd) : b4 >> (16 * (sd - 4))) &
                         0xffffu);
    };
    if (warp < a.nsides) {
      const long long p = lookback(a.qstat + (long long)warp * a.maxtiles, t,
                                   field(ta, tb, warp));
      if (lane == 0) qpre[warp] = p;
    }
    if (threadIdx.x == 0 && (tb >> 32))
      atomicAdd(a.ctr + 2, (unsigned long long)(tb >> 32));
    __syncthreads();
    PHASE(0, 6);
    if (threadIdx.x == 0) {
      item_off[0] = unit_off[0] = 0;
      for (int sd = 0; sd < a.nsides; ++sd) {
        const long long room = max(0ll, (long long)a.qcap - qpre[sd]);
        listed[sd] = (int)min(room, field(ta, tb, sd));
        const Side S = a.side[sd];
        units[sd] = (S.p_hi - S.p_lo + S.pp - 1) / S.pp;
        item_off[sd + 1] = item_off[sd] + listed[sd];
        unit_off[sd + 1] = unit_off[sd] + listed[sd] * units[sd];
      }
    }
    __syncthreads();
    // the listed positions: each side's first qcap overall, in order
    for (int sd = 0; sd < a.nsides; ++sd) {
      int r = (int)field(ea, eb, sd);
#pragma unroll
      for (int q = 0; q < kQPer; ++q) {
        if ((qm[q] >> sd) & 1u) {
          if (r < listed[sd])
            items[item_off[sd] + r] = (uint16_t)(kQPer * threadIdx.x + q);
          ++r;
        }
      }
    }
    __syncthreads();

    // the 1-edit variants of the listed positions: each unit's bitmap words
    // read together; the survivors queued for the table
    PHASE(0, 7);
    const int nunits = unit_off[a.nsides];
    for (int u = threadIdx.x; u < nunits; u += kThreads) {
      // the unit's variants (SUB base c at p, not the window's own; DEL
      // edit position p + c; INS base c before p): their bitmap words read
      // together, the keys rebuilt for the survivors only
      int sd = 0;
      while (u >= unit_off[sd + 1]) ++sd;
      const Side S = a.side[sd];
      const int li = (u - unit_off[sd]) / units[sd];
      const int sub = u - unit_off[sd] - li * units[sd];
      const int x = items[item_off[sd] + li];
      const U128 v = window(pw, off + x, S.m);
      const int p = S.p_lo + (S.kind == kDel ? 4 * sub : sub);
      const int orig = S.kind == kSub ? get_base(v, k, p) : -1;
      uint32_t bit[4], word[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        word[c] = bit[c] = 0;
        const bool use = S.kind == kSub ? c != orig
                                        : (S.kind == kIns || p + c < S.p_hi);
        if (use) {
          bit[c] = bitmap_bit(a.pf_bits,
                              hash_key(variant(S.kind, v, k, p, c), two));
          word[c] = __ldg(a.pf + (bit[c] >> 5));
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!((word[c] >> (bit[c] & 31)) & 1u)) continue;
        const U128 key = variant(S.kind, v, k, p, c);
        atomicAdd(&scnt[sd * kMaxP + (S.kind == kDel ? p + c : p)], 1u);
        const int j = atomicAdd(&nsurv, 1);
        if (j < kQueue) {
          surv[j] = {key, x, S.kind};
        } else {        // a full queue: probe it here
          long long slot;
          const bool yes = true;
          find_slots<1>(a.ix, &key, &yes, &slot);
          if (slot >= 0) place(a.ix, slot, S.kind, x, smin, smax);
        }
      }
    }
    __syncthreads();
    PHASE(0, 8);
    for (int j = threadIdx.x; j < a.nsides * kMaxP; j += kThreads)
      if (scnt[j]) atomicAdd(a.step_cnt + j, (unsigned long long)scnt[j]);
    // the survivors probed in the table, kRx a thread in flight
    const int nq = min(nsurv, kQueue);
    for (int j0 = 0; j0 < nq; j0 += kRx * kThreads) {
      U128 v[kRx];
      bool ok[kRx];
      long long slot[kRx];
#pragma unroll
      for (int c = 0; c < kRx; ++c) {
        const int j = j0 + c * kThreads + threadIdx.x;
        ok[c] = j < nq;
        v[c] = ok[c] ? surv[j].key : U128{0ull, 0ull};
      }
      find_slots<kRx>(a.ix, v, ok, slot);
#pragma unroll
      for (int c = 0; c < kRx; ++c) {
        const int j = j0 + c * kThreads + threadIdx.x;
        if (slot[c] >= 0) place(a.ix, slot[c], surv[j].kind, surv[j].x, smin,
                                smax);
      }
    }
    __syncthreads();
    PHASE(0, 9);

    // the seeds: an exact hit or exactly one distinct 1-edit placement,
    // in order into the tile's segment (probe_out places them)
    unsigned seed = 0;
#pragma unroll
    for (int q = 0; q < kQPer; ++q) {
      const int x = kQPer * threadIdx.x + q;
      if (x < tn && (exrow[x] >= 0 || (smin[x] != kBig && smin[x] == smax[x])))
        seed |= 1u << q;
    }
    uint64_t ts;
    int r = (int)block_scan(__popc(seed), ts, wsum);
    if (threadIdx.x == 0) {
      // the tile's segment, where the seeds of all tiles fit in hcap
      // entries (else n > hcap: `of`, and the host plans the batch)
      seg_at = (long long)atomicAdd(a.ctr + 3, (unsigned long long)ts);
      a.seedcnt[t] = (seg_at << 32) | (long long)ts;
      if (t == ntiles - 1)
        for (int sd = 0; sd < a.nsides; ++sd)
          a.tot[sd] = qpre[sd] + field(ta, tb, sd);
    }
    __syncthreads();
    if (seg_at + (long long)ts <= a.hcap) {
#pragma unroll
      for (int q = 0; q < kQPer; ++q) {
        if (!((seed >> q) & 1u)) continue;
        const int x = kQPer * threadIdx.x + q;
        const bool var = smin[x] != kBig && smin[x] == smax[x];
        a.seeds[seg_at + r++] =
            make_int4(x, exrow[x], var ? smin[x] : -1, exfw[x]);
      }
    }
  }
  PHASE(0, kClkPhases);
}

// The seeds of the walked tiles placed in order (each tile's offset the sum
// of the seed counts before it) to the first hcap entries; block 0 also
// computes n, `of` and stats.
__global__ void __launch_bounds__(kThreads) probe_out(const ProbeArgs a) {
  __shared__ long long wsum[kWarps];
  const long long E = read_extent(a.ext, a.nprep);
  const int ntiles =
      max(1, (int)((min(a.L, E + a.nes) + kTile - 1) / kTile));
  constexpr long long kCnt = 0xffffffffll;
  if (blockIdx.x == 0) {
    long long n = 0;
    for (int j = threadIdx.x; j < ntiles; j += kThreads)
      n += a.seedcnt[j] & kCnt;
    probe_finish(a, ntiles, block_sum(n, wsum));
    __syncthreads();
  }
  for (int b = blockIdx.x; b < ntiles; b += gridDim.x) {
    long long pre = 0;
    for (int j = threadIdx.x; j < b; j += kThreads) pre += a.seedcnt[j] & kCnt;
    pre = block_sum(pre, wsum);
    const long long cnt = a.seedcnt[b] & kCnt, at = a.seedcnt[b] >> 32;
    if (pre + cnt > a.hcap) continue;   // n > hcap: `of` (the host plans)
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const long long r = pre + j;
      const int4 v = a.seeds[at + j];
      a.sel[r] = (long long)b * kTile + v.x;
      a.oex_row[r] = v.y;
      a.oex_fw[r] = v.w;
      a.ovarid[r] = v.z;
    }
  }
}

Index index_of(const void* const* ptrs, int key_tbl, int dir0, int rowflag,
               const long long* ints, int nn, int nw, int bits, int dmax) {
  Index ix;
  ix.key_tbl = (const uint32_t*)ptrs[key_tbl];
  ix.dir0 = (const int64_t*)ptrs[dir0];
  ix.rowflag = (const int32_t*)ptrs[rowflag];
  ix.nn = ints[nn];
  ix.nw = (int)ints[nw];
  ix.bits = (int)ints[bits];
  ix.dmax = (int)ints[dmax];
  return ix;
}

bool index_ok(const Index& ix) {
  return ix.nn >= 1 && (ix.nw == 2 || ix.nw == 4) && ix.bits >= 1 &&
         ix.bits <= 31 && ix.dmax >= 1;
}

// CUDA kernels that the calling thread's last launcher call enqueued
thread_local int kernels_enqueued = 0;

int prep_blocks(long long L) {
  return (int)min((long long)kPrepMax,
                  max(1ll, (L + 16ll * kThreads - 1) / (16ll * kThreads)));
}

// persistent blocks of a tile kernel: as many as fit on the card at once,
// at most one a tile
template <typename K>
int resident_blocks(K kernel, int smem_bytes, int device, int maxtiles) {
  int sms = 0, per = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads,
                                                smem_bytes);
  return max(1, min(maxtiles, max(per, 1) * max(sms, 1)));
}

}  // namespace

// CUDA kernels that the calling thread's last plan_*_launch enqueued.
extern "C" int plan_kernels_enqueued() { return kernels_enqueued; }

#ifdef PLAN_CLOCKS
// The cycles by phase since the last read ([2][kClkPhases]), then zeroed.
extern "C" int plan_clock_read(unsigned long long* out) {
  static const unsigned long long zero[2][kClkPhases] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, plan_clk, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(plan_clk, zero, sizeof(zero));
  return (int)err;
}
#endif

// The runs of a batch (ops/plan_device.py:_runs_kernel); the outputs and the
// scratch are the caller's (ops/plan_kernel.py:RUNS_PTRS, RUNS_INTS).
extern "C" int plan_runs_launch(const void* const* ptrs, int n_ptrs,
                                const long long* ints, int n_ints,
                                int device, void* stream) {
  if (n_ptrs != R_COUNT || n_ints != RI_COUNT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  RunsArgs a;
  a.ix = index_of(ptrs, R_KEY_TBL, R_DIR0, R_ROWFLAG, ints, RI_NN, RI_NW,
                  RI_BITS, RI_DMAX);
  a.codes = (const uint8_t*)ptrs[R_CODES];
  a.upa = (const int32_t*)ptrs[R_UPA];
  a.nk = (const int64_t*)ptrs[R_NK];
  a.sidx = (int64_t*)ptrs[R_SIDX];
  a.eidx = (int64_t*)ptrs[R_EIDX];
  a.ouid = (int64_t*)ptrs[R_OUID];
  a.odir = (int64_t*)ptrs[R_ODIR];
  a.oo = (int64_t*)ptrs[R_OO];
  a.n = (int64_t*)ptrs[R_N];
  a.L = ints[RI_L];
  a.k = (int)ints[RI_K];
  a.rcap = (int)ints[RI_RCAP];
  a.P = a.L - a.k + 1;
  if (!index_ok(a.ix) || a.k < 1 || a.k > 64 || a.P < 1 || a.rcap < 1 ||
      a.L >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  a.nprep = prep_blocks(a.L);
  a.maxtiles = (int)((a.P + kRunsTile - 1) / kRunsTile);
  unsigned long long* scratch = (unsigned long long*)ptrs[R_SCRATCH];
  if (ints[RI_SCRATCH] < 1 + 2ll * a.maxtiles + (a.nprep + 1) / 2)
    return (int)cudaErrorInvalidValue;
  a.ctr = scratch;
  a.sstat = scratch + 1;
  a.estat = a.sstat + a.maxtiles;
  a.ext = (int32_t*)(a.estat + a.maxtiles);
  a.aligned = ((uintptr_t)a.codes & 15) == 0;
  const int smem = 12 * runs_words(a.k);
  cudaStream_t st = (cudaStream_t)stream;
  runs_prep<<<a.nprep, kThreads, 0, st>>>(a);
  const int grid = resident_blocks(runs_tiles, smem, device, a.maxtiles);
  runs_tiles<<<grid, kThreads, smem, st>>>(a);
  kernels_enqueued = 2;
  return (int)cudaGetLastError();
}

// The 1-edit seed probe of a batch (ops/plan_device.py:_probe_kernel, with
// the span starts in place of a start per position); the outputs and the
// scratch are the caller's (ops/plan_kernel.py:PROBE_PTRS, PROBE_INTS).
extern "C" int plan_probe_launch(const void* const* ptrs, int n_ptrs,
                                 const long long* ints, int n_ints,
                                 int device, void* stream) {
  if (n_ptrs != Q_COUNT || n_ints != QI_COUNT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ProbeArgs a;
  a.ix = index_of(ptrs, Q_KEY_TBL, Q_DIR0, Q_ROWFLAG, ints, QI_NN, QI_NW,
                  QI_BITS, QI_DMAX);
  a.codes = (const uint8_t*)ptrs[Q_CODES];
  a.starts = (const int64_t*)ptrs[Q_STARTS];
  a.pf = (const uint32_t*)ptrs[Q_PF];
  a.hf = (const uint32_t*)ptrs[Q_HF];
  a.sel = (int64_t*)ptrs[Q_SEL];
  a.oex_row = (int64_t*)ptrs[Q_OEX_ROW];
  a.oex_fw = (int64_t*)ptrs[Q_OEX_FW];
  a.ovarid = (int64_t*)ptrs[Q_OVARID];
  a.n = (int64_t*)ptrs[Q_N];
  a.of = (bool*)ptrs[Q_OF];
  a.stats = (int64_t*)ptrs[Q_STATS];
  a.L = ints[QI_L];
  a.k = (int)ints[QI_K];
  a.h = (a.k - 1) / 2;
  a.P = a.L - a.k + 1;
  a.stride = (int)ints[QI_STRIDE];
  a.nes = (int)ints[QI_NES];
  a.pf_bits = (int)ints[QI_PF_BITS];
  a.hf_bits = (int)ints[QI_HF_BITS];
  a.qcap = (int)ints[QI_QCAP];
  a.scap = (int)ints[QI_SCAP];
  a.tcap = (int)ints[QI_TCAP];
  a.hcap = (int)ints[QI_HCAP];
  a.nstarts = ints[QI_NSTARTS];
  // the kinds and their two pigeonhole sides, as the plain version: the
  // prefix-intact positions scan the tail edit range [max(p0, h), k), the
  // suffix-intact ones the head range [p0, suf_max]
  const int h = a.h, k = a.k;
  a.nsides = 0;
  const int kinds[3][2] = {{kSub, k}, {kDel, k + 1}, {kIns, k - 1}};
  for (int t = 0; t < 3; ++t) {
    if (t == 0 ? !ints[QI_SUBS] : !ints[QI_INDELS]) continue;
    const int kind = kinds[t][0], m = kinds[t][1];
    const int p0 = kind == kSub ? 0 : 1;
    const int suf_max = kind == kDel ? k - h : k - 1 - h;
    const int pp = kind == kDel ? 4 : 1;
    a.side[a.nsides++] = {kind, m, p0 > h ? p0 : h, k, 0, pp};
    a.side[a.nsides++] = {kind, m, p0, suf_max + 1, 1, pp};
  }
  if (!index_ok(a.ix) || k < 3 || k > 63 || a.P < 1 || a.h < 1 ||
      a.stride < 1 || a.nes < 0 || a.nes > kMaxNes || a.pf_bits < 1 ||
      a.pf_bits > 31 || a.hf_bits < 1 || a.hf_bits > 31 || a.qcap < 1 ||
      a.scap < 0 || a.tcap < 0 || a.hcap < 1 || a.nstarts < 0 ||
      a.L >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  a.nprep = prep_blocks(a.L);
  a.maxtiles = (int)((a.L + kTile - 1) / kTile);
  unsigned long long* scratch = (unsigned long long*)ptrs[Q_SCRATCH];
  const long long head = kScratchHead + (long long)(1 + a.nsides) * a.maxtiles;
  if (ints[QI_SCRATCH] < head + (a.nprep + 1) / 2)
    return (int)cudaErrorInvalidValue;
  a.ctr = scratch;
  a.tot = (long long*)(scratch + 4);
  a.step_cnt = scratch + 12;
  a.seedcnt = (long long*)(scratch + kScratchHead);
  a.qstat = scratch + kScratchHead + a.maxtiles;
  a.seeds = (int4*)ptrs[Q_SEEDS];
  a.ext = (int32_t*)(scratch + head);
  a.aligned = ((uintptr_t)a.codes & 15) == 0;
  const int smem = probe_smem(a.nes, a.k).bytes;
  err = cudaFuncSetAttribute(probe_tiles,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  probe_prep<<<a.nprep, kThreads, 0, st>>>(a);
  const int grid = resident_blocks(probe_tiles, smem, device, a.maxtiles);
  probe_tiles<<<grid, kThreads, smem, st>>>(a);
  const int grid_out = resident_blocks(probe_out, 0, device, a.maxtiles);
  probe_out<<<grid_out, kThreads, 0, st>>>(a);
  kernels_enqueued = 3;
  return (int)cudaGetLastError();
}
