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
// runs (plan_runs_launch), four kernels on the stream:
//   runs_probe   a thread per window position: pack the k-window (a base
//                >= 4 in it: no hit), probe, write (uid, direction, o);
//   runs_count   a thread per position: start / end flags from the
//                neighbours' records, each block's counts;
//   scan_blocks  one block: exclusive offsets of the block counts;
//   runs_scatter a thread per position: writes starts and ends in order to
//                rcap entries (an in-block scan gives the rank), fills the
//                rest with P and the record at P - 1, as the plain
//                version's clamp(sidx, max=P-1) gather does.
// probe (plan_probe_launch), eight kernels:
//   probe_exact  a thread per position: the exact k-window probe (row, fw;
//                a miss reads rowflag[0]'s flag, as the plain version's
//                clamped gather), the h-window half-bitmap hit, and the
//                min / max identity slots set to +-0x7FFFFFFF;
//   probe_qual   a thread per position: the near-exact skip (the exact
//                flags of the 2*nes + 1 neighbours), on_stride, allowed,
//                and for each (kind, side) whether the position qualifies;
//                each block's counts;
//   scan_blocks  offsets per (kind, side);
//   probe_qlist  writes the first qcap qualifying positions of each
//                (kind, side) in order, as the plain version's compaction;
//   probe_enum   a thread per listed (position, kind, side): every edit
//                position p of the side and every variant (SUB: the 3
//                bases other than the window's, DEL: 1, INS: 4) is built
//                by 128-bit surgery in two uint64 words (the shifts of
//                ops/u128.py, 0 at shifts >= 64), hashed, tested against
//                the prefilter bitmap and, when it passes, probed in the
//                table directly; a hit atomicMin / atomicMax-es the packed
//                identity ((row*3 + kind) << 1) | fw at its position;
//   probe_out_count, scan_blocks, probe_out_scatter: positions with an
//                exact hit or exactly one distinct 1-edit placement
//                (min == max), compacted in order to hcap entries (filled
//                with L and the values at L - 1), then n, `of` and stats.
// There is no survivor buffer: integer min and max do not depend on the
// order, so the result is deterministic. The overflow flag is what the
// plain version computes: any (kind, side) with more than qcap qualifying
// positions, any (kind, side, p) step with more than scap survivors, more
// than tcap survivors in all, or more than hcap seeds. The survivors are
// counted over the listed positions only (the plain version enumerates the
// first qcap), one counter per (kind, side, p), each warp adding its sum;
// their sum is the total. On a batch that overflows, the plain version drops
// survivors and the host plans the batch again: there only `of` and
// stats[0:3] are the same.
//
// Thread mapping of probe_enum: after the compaction every thread of a warp
// holds a qualifying position of the same (kind, side), so all lanes run
// the same edit positions and variants; only the probe of a prefilter
// survivor (1-3% of the variants) diverges. A thread per position without
// the compaction would leave 75-90% of the lanes idle (the half filter
// qualifies 10-25% of the allowed positions), a warp per position 15 of
// its 32 lanes (a side has 16-17 edit positions).
//
// What bounds it: random 32-byte sectors. The prefilter bitmap is 2^30 bits
// (128 MB) once the index holds 2^22 keys and the key table outgrows the
// 50 MB L2, so each bitmap test, directory read and key row is a sector
// from device memory; the arithmetic (hashing, shifts) is a few dozen
// integer operations a variant. chip_smoke.py counts the bound from what
// the batch needs: per probed key the directory pair and the sectors its
// bucket's rows span up to the match, per hit its rowflag (and upa) entry,
// per enumerated variant one bitmap word.
//
// Plain C interface (bound with ctypes from ratatosk_tpu_torch/ops/
// plan_kernel.py); the launchers never synchronise and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kMaxSides = 6;
constexpr int kMaxP = 64;              // edit positions: p < k + 1 <= 64
constexpr int32_t kBig = 0x7FFFFFFF;
constexpr int kSub = 0, kDel = 1, kIns = 2;

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
// hash_index.prefilter_test: bit lowbias32(h) >> (32 - bits) of the bitmap
__device__ __forceinline__ bool bitmap_has(const uint32_t* tbl, int bits,
                                           uint32_t h) {
  const uint32_t i = lowbias32(h) >> (32 - bits);
  return (tbl[i >> 5] >> (i & 31)) & 1u;
}

// The m-base window at pos (pos + m <= the array's end), bases big-endian
// as in ops/kmers.py; false when a base >= 4 lies in it.
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

// ---- the hash directory ----

struct Index {
  const uint32_t* key_tbl;  // [nn, nw] (the int32 tensor's bits)
  const int64_t* dir0;      // [1 << bits] bucket starts
  const int32_t* rowflag;   // [nn] (row << 1) | is_fw
  long long nn;
  int nw, bits, dmax;
};

// Slot of the key v with hash h in the table, or -1.
__device__ __forceinline__ long long find_slot(const Index& ix, U128 v,
                                               uint32_t h) {
  const uint32_t b = h >> (32 - ix.bits);
  long long d = ix.dir0[b];
  long long end = (b + 1u < (1u << ix.bits)) ? ix.dir0[b + 1] : ix.nn;
  if (end > d + ix.dmax) end = d + ix.dmax;
  const uint32_t q0 = (uint32_t)v.lo, q1 = (uint32_t)(v.lo >> 32);
  const uint32_t q2 = (uint32_t)v.hi, q3 = (uint32_t)(v.hi >> 32);
  for (; d < end; ++d) {
    const uint32_t* r = ix.key_tbl + d * ix.nw;
    if (r[0] == q0 && r[1] == q1 && (ix.nw == 2 || (r[2] == q2 && r[3] == q3)))
      return d;
  }
  return -1;
}

// ---- block scans ----

// Exclusive prefix sum of v over the block's threads in thread order, and
// the block's total; every thread of the block must call it.
__device__ int32_t block_scan(int32_t v, int32_t& total) {
  __shared__ int32_t wsum[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int32_t x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  if (w == 0) {
    int32_t t = lane < nw ? wsum[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t += y;
    }
    wsum[lane] = t;
  }
  __syncthreads();
  const int32_t before = w > 0 ? wsum[w - 1] : 0;
  total = wsum[nw - 1];
  __syncthreads();
  return before + x - v;
}

// One block per segment: off[j] = the sum of cnt[0..j) of the segment's
// nblk block counts, tot[segment] = their sum.
__global__ void __launch_bounds__(kScanThreads)
scan_blocks(const int32_t* cnt, int32_t* off, int32_t* tot, int nblk) {
  const int32_t* c = cnt + (long long)blockIdx.x * nblk;
  int32_t* o = off + (long long)blockIdx.x * nblk;
  const int per = (nblk + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, nblk), hi = min(lo + per, nblk);
  int32_t s = 0;
  for (int j = lo; j < hi; ++j) s += c[j];
  int32_t total;
  int32_t e = block_scan(s, total);
  for (int j = lo; j < hi; ++j) {
    o[j] = e;
    e += c[j];
  }
  if (threadIdx.x == 0) tot[blockIdx.x] = total;
}

// warp sum added to a 64-bit counter (every lane of the warp calls it)
__device__ __forceinline__ void warp_count(unsigned long long* ctr, int v) {
  const unsigned s = __reduce_add_sync(kFull, (unsigned)v);
  if ((threadIdx.x & 31) == 0 && s) atomicAdd(ctr, (unsigned long long)s);
}

// ---- runs ----

enum {
  R_CODES, R_KEY_TBL, R_DIR0, R_ROWFLAG, R_UPA, R_NK, R_UID, R_DIRN, R_O,
  R_BCNT, R_BOFF, R_TOT, R_SIDX, R_EIDX, R_OUID, R_ODIR, R_OO, R_N, R_COUNT
};
enum { RI_L, RI_K, RI_RCAP, RI_NN, RI_NW, RI_BITS, RI_DMAX, RI_COUNT };

struct RunsArgs {
  Index ix;
  const uint8_t* codes;
  const int32_t* upa;       // [nn, 2] (unitig id, pos << 1 | strand)
  const int64_t* nk;
  int32_t* uid;             // [P] per window: unitig id (-1: miss)
  int8_t* dirn;             //     direction
  int64_t* o;               //     oriented offset
  int32_t* bcnt;            // [2, nblk] starts, ends per block
  int32_t* boff;
  int32_t* tot;             // [2]
  int64_t *sidx, *eidx, *ouid, *odir, *oo, *n;
  long long L, P;
  int k, rcap, nblk;
};

__global__ void __launch_bounds__(kThreads) runs_probe(const RunsArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.P) {
    U128 v;
    long long slot = -1;
    if (pack(a.codes, i, a.k, v))
      slot = find_slot(a.ix, v, hash_key(v, a.ix.nw == 4));
    // a miss reads row 0's flag, as the plain version's clamped gather
    const int32_t rf = a.ix.rowflag[slot >= 0 ? slot : 0];
    int32_t uid = -1;
    int64_t pos = 0;
    int strand = 0;
    if (slot >= 0) {
      uid = a.upa[2 * slot];
      pos = a.upa[2 * slot + 1] >> 1;
      strand = a.upa[2 * slot + 1] & 1;
    }
    const int is_fw = rf & 1;
    const int dirn = (is_fw == (strand == 1)) ? 0 : 1;
    a.uid[i] = uid;
    a.dirn[i] = (int8_t)dirn;
    a.o[i] = dirn == 0 ? pos : a.nk[uid >= 0 ? uid : 0] - 1 - pos;
  }
}

// the window at i + 1 continues the run of the window at i
__device__ __forceinline__ bool chained(const RunsArgs& a, long long i) {
  return a.uid[i] >= 0 && a.uid[i + 1] >= 0 && a.uid[i] == a.uid[i + 1] &&
         a.dirn[i] == a.dirn[i + 1] && a.o[i + 1] == a.o[i] + 1;
}

__device__ __forceinline__ void run_flags(const RunsArgs& a, long long i,
                                          int& s, int& e) {
  s = e = 0;
  if (i < a.P && a.uid[i] >= 0) {
    s = !(i > 0 && chained(a, i - 1));
    e = !(i + 1 < a.P && chained(a, i));
  }
}

__global__ void __launch_bounds__(kThreads) runs_count(const RunsArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int s, e;
  run_flags(a, i, s, e);
  int32_t ts, te;
  block_scan(s, ts);
  block_scan(e, te);
  if (threadIdx.x == 0) {
    a.bcnt[blockIdx.x] = ts;
    a.bcnt[a.nblk + blockIdx.x] = te;
  }
}

__global__ void __launch_bounds__(kThreads) runs_scatter(const RunsArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int s, e;
  run_flags(a, i, s, e);
  int32_t ts, te;
  const long long rs = a.boff[blockIdx.x] + block_scan(s, ts);
  const long long re = a.boff[a.nblk + blockIdx.x] + block_scan(e, te);
  if (s && rs < a.rcap) {
    a.sidx[rs] = i;
    a.ouid[rs] = a.uid[i];
    a.odir[rs] = a.dirn[i];
    a.oo[rs] = a.o[i];
  }
  if (e && re < a.rcap) a.eidx[re] = i;
  // entries past the runs: P, and the record of window P - 1
  const long long ns = a.tot[0], ne = a.tot[1], last = a.P - 1;
  for (long long j = i; j < a.rcap; j += (long long)gridDim.x * blockDim.x) {
    if (j >= ns) {
      a.sidx[j] = a.P;
      a.ouid[j] = a.uid[last];
      a.odir[j] = a.dirn[last];
      a.oo[j] = a.o[last];
    }
    if (j >= ne) a.eidx[j] = a.P;
  }
  if (i == 0) *a.n = ns;
}

// ---- probe ----

enum {
  Q_CODES, Q_SSTART, Q_KEY_TBL, Q_DIR0, Q_ROWFLAG, Q_PF, Q_HF, Q_EX_ROW,
  Q_EX_FW, Q_HHIT, Q_QMASK, Q_BCNT, Q_BOFF, Q_TOT, Q_QLIST, Q_COUNTS,
  Q_MINID, Q_MAXID, Q_SEL, Q_OEX_ROW, Q_OEX_FW, Q_OVARID, Q_N, Q_OF, Q_STATS,
  Q_COUNT
};
enum {
  QI_L, QI_K, QI_STRIDE, QI_NES, QI_SUBS, QI_INDELS, QI_PF_BITS, QI_HF_BITS,
  QI_QCAP, QI_SCAP, QI_TCAP, QI_HCAP, QI_NN, QI_NW, QI_BITS, QI_DMAX,
  QI_COUNT
};

// one pigeonhole side of one kind: the m-window, the edit positions
// [p_lo, p_hi), and whether the side's flag is the h-suffix's half hit
struct Side {
  int kind, m, p_lo, p_hi, suffix;
};

struct ProbeArgs {
  Index ix;
  const uint8_t* codes;
  const int64_t* sstart;
  const uint32_t* pf;       // prefilter bitmap
  const uint32_t* hf;       // half bitmap
  int32_t* ex_row;          // [L] exact row (-1: none)
  int8_t* ex_fw;            // [L]
  uint8_t* hhit;            // [L] the h-window at the position is a half
  uint8_t* qmask;           // [L] bit s: qualifies for side s
  int32_t* bcnt;            // [nsides + 1, nblk]
  int32_t* boff;
  int32_t* tot;             // [nsides + 1]: qualifying counts, then seeds
  int32_t* qlist;           // [nsides, qcap]
  unsigned long long* step_cnt;   // [nsides, kMaxP] survivors per step
  unsigned long long* n_allowed;  // [1] allowed positions
  int32_t *minid, *maxid;   // [L]
  int64_t *sel, *oex_row, *oex_fw, *ovarid, *n, *stats;
  bool* of;
  long long L, P;
  int k, h, stride, nes, pf_bits, hf_bits, qcap, scap, tcap, hcap, nblk;
  int nsides;
  Side side[kMaxSides];
};

__global__ void __launch_bounds__(kThreads) probe_exact(const ProbeArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.L) {
    a.minid[i] = kBig;
    a.maxid[i] = -kBig;
    int32_t row = -1;
    int8_t fw = 0;
    if (i < a.P) {
      U128 v;
      long long slot = -1;
      if (pack(a.codes, i, a.k, v))
        slot = find_slot(a.ix, v, hash_key(v, a.ix.nw == 4));
      const int32_t rf = a.ix.rowflag[slot >= 0 ? slot : 0];
      row = slot >= 0 ? rf >> 1 : -1;
      fw = (int8_t)(rf & 1);
    }
    a.ex_row[i] = row;
    a.ex_fw[i] = fw;
    // the h-window's half hit (h <= 31 bases: one word)
    uint8_t hit = 0;
    U128 hv;
    if (i < a.L - a.h + 1 && pack(a.codes, i, a.h, hv))
      hit = bitmap_has(a.hf, a.hf_bits, hash_key(hv, false));
    a.hhit[i] = hit;
  }
}

__global__ void __launch_bounds__(kThreads) probe_qual(const ProbeArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int allowed = 0;
  unsigned mask = 0;
  if (i < a.L) {
    bool skip = false;
    if (a.nes > 0) {
      const long long lo = i - a.nes > 0 ? i - a.nes : 0;
      const long long hi = i + a.nes + 1 < a.L ? i + a.nes + 1 : a.L;
      for (long long j = lo; j < hi && !skip; ++j) skip = a.ex_row[j] >= 0;
    }
    const bool on_stride = a.stride <= 1 || (i - a.sstart[i]) % a.stride == 0;
    allowed = !skip && on_stride;
    if (allowed) {
      // bases < 4 from i on, up to the widest window (k + 1)
      int run = 0;
      while (run < a.k + 1 && i + run < a.L && a.codes[i + run] < 4) ++run;
      for (int s = 0; s < a.nsides; ++s) {
        const Side sd = a.side[s];
        long long f = sd.suffix ? i + sd.m - a.h : i;
        if (f > a.L - 1) f = a.L - 1;
        if (run >= sd.m && a.hhit[f]) mask |= 1u << s;
      }
    }
    a.qmask[i] = (uint8_t)mask;
  }
  int32_t t;
  block_scan(allowed, t);
  if (threadIdx.x == 0 && t) atomicAdd(a.n_allowed, (unsigned long long)t);
  for (int s = 0; s < a.nsides; ++s) {
    block_scan((mask >> s) & 1u, t);
    if (threadIdx.x == 0) a.bcnt[(long long)s * a.nblk + blockIdx.x] = t;
  }
}

__global__ void __launch_bounds__(kThreads) probe_qlist(const ProbeArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned mask = i < a.L ? a.qmask[i] : 0u;
  for (int s = 0; s < a.nsides; ++s) {
    const int q = (mask >> s) & 1u;
    int32_t t;
    const long long r = a.boff[(long long)s * a.nblk + blockIdx.x] +
                        block_scan(q, t);
    if (q && r < a.qcap) a.qlist[(long long)s * a.qcap + r] = (int32_t)i;
  }
}

// Test one 1-edit variant of the window at pos: the prefilter bitmap, then
// the table; a hit enters the placement identity's min and max.
__device__ __forceinline__ void try_variant(const ProbeArgs& a, U128 v,
                                            int kind, long long pos,
                                            int& surv) {
  const uint32_t h = hash_key(v, a.ix.nw == 4);
  if (!bitmap_has(a.pf, a.pf_bits, h)) return;
  surv += 1;
  const long long slot = find_slot(a.ix, v, h);
  if (slot < 0) return;
  const int32_t rf = a.ix.rowflag[slot];
  const int32_t id = (((rf >> 1) * 3 + kind) << 1) | (rf & 1);
  atomicMin(&a.minid[pos], id);
  atomicMax(&a.maxid[pos], id);
}

__global__ void __launch_bounds__(kThreads) probe_enum(const ProbeArgs a) {
  const int s = blockIdx.y;
  const Side sd = a.side[s];
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nq = a.tot[s] < a.qcap ? a.tot[s] : a.qcap;
  const bool live = j < nq;
  long long pos = 0;
  U128 v = {0ull, 0ull};
  if (live) {
    pos = a.qlist[(long long)s * a.qcap + j];
    pack(a.codes, pos, sd.m, v);
  }
  for (int p = sd.p_lo; p < sd.p_hi; ++p) {
    int sp = 0;
    if (live) {
      if (sd.kind == kSub) {
        const int orig = get_base(v, a.k, p);
        for (int b = 0; b < 4; ++b)
          if (b != orig)
            try_variant(a, set_base(v, a.k, p, b), kSub, pos, sp);
      } else if (sd.kind == kDel) {
        try_variant(a, drop_base(v, a.k + 1, p), kDel, pos, sp);
      } else {
        for (int b = 0; b < 4; ++b)
          try_variant(a, insert_base(v, a.k - 1, p, b), kIns, pos, sp);
      }
    }
    warp_count(&a.step_cnt[s * kMaxP + p], sp);
  }
}

__device__ __forceinline__ bool var_ok(const ProbeArgs& a, long long i) {
  return a.minid[i] != kBig && a.minid[i] == a.maxid[i];
}

__device__ __forceinline__ int seed_at(const ProbeArgs& a, long long i) {
  return i < a.L && (a.ex_row[i] >= 0 || var_ok(a, i));
}

__global__ void __launch_bounds__(kThreads)
probe_out_count(const ProbeArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int32_t t;
  block_scan(seed_at(a, i), t);
  if (threadIdx.x == 0) a.bcnt[(long long)a.nsides * a.nblk + blockIdx.x] = t;
}

__global__ void __launch_bounds__(kThreads)
probe_out_scatter(const ProbeArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = seed_at(a, i);
  int32_t t;
  const long long r = a.boff[(long long)a.nsides * a.nblk + blockIdx.x] +
                      block_scan(q, t);
  if (q && r < a.hcap) {
    a.sel[r] = i;
    a.oex_row[r] = a.ex_row[i];
    a.oex_fw[r] = a.ex_fw[i];
    a.ovarid[r] = var_ok(a, i) ? a.minid[i] : -1;
  }
  // entries past the seeds: L, and the values at L - 1
  const long long n = a.tot[a.nsides], last = a.L - 1;
  for (long long e = i; e < a.hcap; e += (long long)gridDim.x * blockDim.x) {
    if (e >= n) {
      a.sel[e] = a.L;
      a.oex_row[e] = a.ex_row[last];
      a.oex_fw[e] = a.ex_fw[last];
      a.ovarid[e] = var_ok(a, last) ? a.minid[last] : -1;
    }
  }
  if (i == 0) {
    bool of = n > a.hcap;
    long long nq_max = 0;
    unsigned long long surv = 0;
    for (int s = 0; s < a.nsides; ++s) {
      of = of || a.tot[s] > a.qcap;
      nq_max = a.tot[s] > nq_max ? a.tot[s] : nq_max;
      for (int p = a.side[s].p_lo; p < a.side[s].p_hi; ++p) {
        const unsigned long long c = a.step_cnt[s * kMaxP + p];
        of = of || c > (unsigned long long)a.scap;
        surv += c;
      }
    }
    of = of || surv > (unsigned long long)a.tcap;
    *a.n = n;
    *a.of = of;
    a.stats[0] = (long long)*a.n_allowed;
    a.stats[1] = nq_max;
    a.stats[2] = surv < (unsigned long long)a.tcap ? (long long)surv : a.tcap;
    a.stats[3] = n;
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

}  // namespace

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
  a.uid = (int32_t*)ptrs[R_UID];
  a.dirn = (int8_t*)ptrs[R_DIRN];
  a.o = (int64_t*)ptrs[R_O];
  a.bcnt = (int32_t*)ptrs[R_BCNT];
  a.boff = (int32_t*)ptrs[R_BOFF];
  a.tot = (int32_t*)ptrs[R_TOT];
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
  a.nblk = (int)((a.P + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  runs_probe<<<a.nblk, kThreads, 0, st>>>(a);
  runs_count<<<a.nblk, kThreads, 0, st>>>(a);
  scan_blocks<<<2, kScanThreads, 0, st>>>(a.bcnt, a.boff, a.tot, a.nblk);
  runs_scatter<<<a.nblk, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// The 1-edit seed probe of a batch (ops/plan_device.py:_probe_kernel); the
// outputs and the scratch are the caller's (ops/plan_kernel.py:PROBE_PTRS,
// PROBE_INTS). counts ([nsides * kMaxP] survivors per step, then the
// allowed positions) must be zero.
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
  a.sstart = (const int64_t*)ptrs[Q_SSTART];
  a.pf = (const uint32_t*)ptrs[Q_PF];
  a.hf = (const uint32_t*)ptrs[Q_HF];
  a.ex_row = (int32_t*)ptrs[Q_EX_ROW];
  a.ex_fw = (int8_t*)ptrs[Q_EX_FW];
  a.hhit = (uint8_t*)ptrs[Q_HHIT];
  a.qmask = (uint8_t*)ptrs[Q_QMASK];
  a.bcnt = (int32_t*)ptrs[Q_BCNT];
  a.boff = (int32_t*)ptrs[Q_BOFF];
  a.tot = (int32_t*)ptrs[Q_TOT];
  a.qlist = (int32_t*)ptrs[Q_QLIST];
  a.step_cnt = (unsigned long long*)ptrs[Q_COUNTS];
  a.minid = (int32_t*)ptrs[Q_MINID];
  a.maxid = (int32_t*)ptrs[Q_MAXID];
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
    a.side[a.nsides++] = {kind, m, p0 > h ? p0 : h, k, 0};
    a.side[a.nsides++] = {kind, m, p0, suf_max + 1, 1};
  }
  a.n_allowed = a.step_cnt + a.nsides * kMaxP;
  if (!index_ok(a.ix) || k < 3 || k > 63 || a.P < 1 || a.h < 1 ||
      a.stride < 1 || a.nes < 0 || a.pf_bits < 1 || a.pf_bits > 31 ||
      a.hf_bits < 1 || a.hf_bits > 31 || a.qcap < 1 || a.scap < 0 ||
      a.tcap < 0 || a.hcap < 1 || a.L >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  a.nblk = (int)((a.L + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  probe_exact<<<a.nblk, kThreads, 0, st>>>(a);
  probe_qual<<<a.nblk, kThreads, 0, st>>>(a);
  if (a.nsides > 0) {
    scan_blocks<<<a.nsides, kScanThreads, 0, st>>>(a.bcnt, a.boff, a.tot,
                                                   a.nblk);
    probe_qlist<<<a.nblk, kThreads, 0, st>>>(a);
    const dim3 grid((unsigned)((a.qcap + kThreads - 1) / kThreads),
                    (unsigned)a.nsides);
    probe_enum<<<grid, kThreads, 0, st>>>(a);
  }
  probe_out_count<<<a.nblk, kThreads, 0, st>>>(a);
  const long long seg = (long long)a.nsides * a.nblk;
  scan_blocks<<<1, kScanThreads, 0, st>>>(a.bcnt + seg, a.boff + seg,
                                          a.tot + a.nsides, a.nblk);
  probe_out_scatter<<<a.nblk, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
