// B4: inclusive segmented scan (running min, max and count, reset at each
// flag) with a carry across blocks, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/segment_scan.py:
// segmented_scan (pallas_call at :98; wrapper repro/kernels/ops.py:79).
//
// Semantics, which the Pallas kernel fixes and the plain version in
// kernels/segment_scan.py repeats: row i's output is the (min, max, count)
// of the run that begins at the last flag at or before i.  Where that run
// began before the start of i's `block`-row block (or no flag precedes i),
// the min is also clamped with `lo` and the max with `hi`: the Pallas kernel
// shifts in +-2e9 fills at each block edge.  lo = INT_MAX, hi = INT_MIN
// makes the scan exact.
//
// Since min and max are exact, that is the exact segmented scan with the
// clamp applied at the output: row i's inclusive aggregate (f, mn, mx, cnt)
// over rows 0..i, where f says a flag was seen, gives the run's first row
// i - cnt + 1, and the clamp applies where !f or that row lies before
// i's block start.  So `block` needs no alignment to the tiles.
//
// What bounded the first design (0.181 ms at 9.6M rows on an H100, 26 % of
// its bound): three launches (reduce, a single 1,024-thread block folding the
// block aggregates serially, then the scan again), flags and values read
// twice, one row a thread with 4-byte loads and two __syncthreads a 256 rows.
//
// This design: one launch, Merrill & Garland's single-pass scan with
// decoupled look-back, as B2b does (csrc/filter_compact.cu).  A block claims
// its tile of kTileRows rows from an atomic tile counter (so it only ever
// waits on tiles of blocks already running); each thread takes kItems
// consecutive rows.  Values arrive as coalesced 16-byte loads, turned from
// striped into blocked order through a per-warp shared buffer (XOR-swizzled:
// no bank conflict either way), and flags as 16 bits of one word.  The
// thread folds its rows in registers, the block scans the thread aggregates
// with warp shuffles, publishes its tile's aggregate and then its inclusive
// prefix, and one warp looks back over the predecessors, 32 tiles at a time,
// until it meets an inclusive prefix.  A published aggregate is three 64-bit
// words, each carrying its own valid bit: relaxed stores and loads suffice,
// where a release/acquire pair compiled to a GPU-wide fence per publish and
// an invalidation of the whole L1 per poll.  Each thread then rescans its
// rows from its carry-in and writes min, max and count back through the
// buffer as coalesced 16-byte stores.  Every row is read once and written
// once.
//
// The operator on (flag, min, max, count) is
//   (f1, a1) + (f2, a2) = (f1 | f2, f2 ? a2 : a1 o a2),
// associative but not commutative, so every fold keeps row order.
//
// Bound: bytes.  Per row: 1/8 B of packed flags and 4 B of values in,
// 12 B out: 16 1/8 B.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                       // rows a thread
constexpr int kTileRows = kThreads * kItems;     // SCAN_TILE in segment_scan.py
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = kItems / 4;              // int4 chunks a thread
constexpr int kWarpChunks = 32 * kChunks;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kValid = 1ull << 32;

struct Agg {
  int f, mn, mx, cnt;
};

__device__ __forceinline__ Agg identity() { return {0, INT_MAX, INT_MIN, 0}; }

// a precedes b
__device__ __forceinline__ Agg combine(const Agg& a, const Agg& b) {
  if (b.f) return b;
  return {a.f, min(a.mn, b.mn), max(a.mx, b.mx), a.cnt + b.cnt};
}

__device__ __forceinline__ Agg shfl_up(const Agg& x, int off) {
  return {__shfl_up_sync(kFull, x.f, off), __shfl_up_sync(kFull, x.mn, off),
          __shfl_up_sync(kFull, x.mx, off), __shfl_up_sync(kFull, x.cnt, off)};
}

__device__ __forceinline__ Agg shfl_down(const Agg& x, int off) {
  return {__shfl_down_sync(kFull, x.f, off), __shfl_down_sync(kFull, x.mn, off),
          __shfl_down_sync(kFull, x.mx, off), __shfl_down_sync(kFull, x.cnt, off)};
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A published aggregate is three 64-bit words, each (1 << 32 | payload):
// min, max, and flag << 31 | count (a count fits 31 bits: n <= INT_MAX).
// Every word carries its own valid bit and is written once per launch, so a
// reader that sees it valid sees its payload: no fence orders anything.
__device__ __forceinline__ void publish(unsigned long long* w, const Agg& a) {
  store_word(w, kValid | (uint32_t)a.mn);
  store_word(w + 1, kValid | (uint32_t)a.mx);
  store_word(w + 2, kValid | ((uint32_t)a.f << 31) | (uint32_t)a.cnt);
}

// the aggregate of three published words
__device__ __forceinline__ Agg unpack(unsigned long long w0, unsigned long long w1,
                                      unsigned long long w2) {
  return {(int)((uint32_t)w2 >> 31), (int)(uint32_t)w0, (int)(uint32_t)w1,
          (int)((uint32_t)w2 & 0x7fffffffu)};
}

// Position in a warp's shared buffer of int4 chunk c (chunk q of lane l is
// c = kChunks * l + q): an XOR swizzle that keeps both the blocked access
// (lane l, chunk q) and the striped one (lane, chunk lane + 32 k)
// free of bank conflicts.
__device__ __forceinline__ int swizzle(int c) {
  const int l = c / kChunks, q = c % kChunks;
  return kChunks * l + (q ^ ((l / (8 / kChunks)) & (kChunks - 1)));
}

// this lane's kItems rows (blocked) to a whole warp's rows in memory
// (striped, coalesced 16-byte stores), through the warp's buffer
__device__ __forceinline__ void store_rows(int4* buf, const int (&x)[kItems], int* out,
                                           int lane) {
#pragma unroll
  for (int q = 0; q < kChunks; ++q)
    buf[swizzle(kChunks * lane + q)] =
        make_int4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  __syncwarp();
  int4* dst = reinterpret_cast<int4*>(out);
#pragma unroll
  for (int k = 0; k < kChunks; ++k) dst[lane + 32 * k] = buf[swizzle(lane + 32 * k)];
  __syncwarp();
}

// 3 blocks an SM: 80 registers, no spill (without the bound ptxas took 88,
// and 2 blocks fit)
__global__ void __launch_bounds__(kThreads, 3)
    seg_scan_kernel(const uint32_t* __restrict__ words, const int* __restrict__ vals,
                    long long n, long long block, int lo, int hi, int* __restrict__ ws,
                    int* __restrict__ out_min, int* __restrict__ out_max,
                    int* __restrict__ out_cnt, int vec16) {
  __shared__ int4 xbuf[kWarps][kWarpChunks];
  __shared__ Agg warp_tot[kWarps];
  __shared__ Agg s_prefix;
  __shared__ int s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  // the workspace: the tile counter (16 bytes), then 3 words a tile of
  // aggregates, then 3 words a tile of inclusive prefixes
  unsigned long long* aggregate = reinterpret_cast<unsigned long long*>(ws) + 2;
  unsigned long long* inclusive = aggregate + 3 * n_tiles;
  if (tid == 0) s_tile = atomicAdd(ws, 1);
  __syncthreads();
  const long long tile = s_tile;
  const long long warp_row0 = tile * kTileRows + (long long)warp * 32 * kItems;
  const long long row0 = warp_row0 + (long long)kItems * lane;
  const bool whole = warp_row0 + 32 * kItems <= n;   // the warp's rows lie in [0, n)
  int4* buf = xbuf[warp];

  // this thread's rows: values and flag bits (bits past n cleared)
  int v[kItems];
  unsigned bits = 0;
  if (row0 < n) {
    const unsigned w = __ldg(words + (row0 >> 5)) >> (row0 & 31);
    const long long left = n - row0;
    bits = left >= kItems ? (w & ((1u << kItems) - 1u)) : (w & ((1u << left) - 1u));
  }
  if (whole && vec16) {
    const int4* src = reinterpret_cast<const int4*>(vals + warp_row0);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) buf[swizzle(lane + 32 * k)] = __ldg(src + lane + 32 * k);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int4 x = buf[swizzle(kChunks * lane + q)];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = row0 + j < n ? __ldg(vals + row0 + j) : 0;
  }

  // the thread's aggregate: the rows from its last flag on
  Agg mine = identity();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (row0 + j < n) mine = combine(mine, {(int)((bits >> j) & 1u), v[j], v[j], 1});
  }

  // exclusive scan of the thread aggregates over the tile
  Agg incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Agg o = shfl_up(incl, off);
    if (lane >= off) incl = combine(o, incl);
  }
  Agg excl = shfl_up(incl, 1);
  if (lane == 0) excl = identity();
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    Agg t = lane < kWarps ? warp_tot[lane] : identity();
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const Agg o = shfl_up(t, off);
      if (lane >= off) t = combine(o, t);
    }
    if (lane < kWarps) warp_tot[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  if (warp > 0) excl = combine(warp_tot[warp - 1], excl);
  const Agg tile_agg = warp_tot[kWarps - 1];

  // decoupled look-back: the aggregate of every row before the tile
  if (warp == 0) {
    Agg prefix = identity();
    if (tile > 0) {
      if (lane == 0) publish(aggregate + 3 * tile, tile_agg);
      long long top = tile - 1;  // lane j looks at tile top - j
      while (true) {
        const long long idx = top - lane;
        bool inc = true;         // before tile 0: an empty inclusive prefix
        Agg a = identity();
        if (idx >= 0) {
          const unsigned long long* pi = inclusive + 3 * idx;
          const unsigned long long* pa = aggregate + 3 * idx;
          while (true) {  // all six words in flight at once
            const unsigned long long i0 = load_word(pi), i1 = load_word(pi + 1),
                                     i2 = load_word(pi + 2), a0 = load_word(pa),
                                     a1 = load_word(pa + 1), a2 = load_word(pa + 2);
            if (i0 & i1 & i2 & kValid) {
              a = unpack(i0, i1, i2);
              break;
            }
            if (a0 & a1 & a2 & kValid) {
              a = unpack(a0, a1, a2);
              inc = false;
              break;
            }
          }
        }
        const unsigned incs = __ballot_sync(kFull, inc);
        const int stop = incs ? __ffs(incs) - 1 : 31;  // nearest inclusive prefix
        if (lane > stop) a = identity();
        // fold the window in row order: a higher lane is an earlier tile
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const Agg o = shfl_down(a, off);
          if (lane + off < 32) a = combine(o, a);
        }
        a = {__shfl_sync(kFull, a.f, 0), __shfl_sync(kFull, a.mn, 0),
             __shfl_sync(kFull, a.mx, 0), __shfl_sync(kFull, a.cnt, 0)};
        prefix = combine(a, prefix);
        if (incs) break;
        top -= 32;
      }
    }
    if (lane == 0) {
      publish(inclusive + 3 * tile, combine(prefix, tile_agg));
      s_prefix = prefix;
    }
  }
  __syncthreads();

  // rescan this thread's rows from its carry-in and clamp
  Agg x = combine(s_prefix, excl);
  // the current row's block [blk_start, blk_end): one division a thread
  // (32-bit: n <= INT_MAX), then each row steps over at most one block edge
  const unsigned blk = (unsigned)min(block, n);
  unsigned blk_start = (unsigned)row0 / blk * blk;
  unsigned blk_end = blk_start + blk;
  int mn[kItems], mx[kItems], cnt[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned i = (unsigned)row0 + j;
    if (i >= blk_end) {
      blk_start = blk_end;
      blk_end += blk;
    }
    x = combine(x, {(int)((bits >> j) & 1u), v[j], v[j], 1});
    // the run's first row, i - cnt + 1, before i's block start (or no flag
    // yet): the Pallas kernel's fills reach row i
    const bool crossed = !x.f || i + 1 - (unsigned)x.cnt < blk_start;
    mn[j] = crossed ? min(x.mn, lo) : x.mn;
    mx[j] = crossed ? max(x.mx, hi) : x.mx;
    cnt[j] = x.cnt;
  }
  if (whole) {
    store_rows(buf, mn, out_min + warp_row0, lane);
    store_rows(buf, mx, out_max + warp_row0, lane);
    store_rows(buf, cnt, out_cnt + warp_row0, lane);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (row0 + j < n) {
        out_min[row0 + j] = mn[j];
        out_max[row0 + j] = mx[j];
        out_cnt[row0 + j] = cnt[j];
      }
    }
  }
}

}  // namespace

// words: ceil(n/32) packed flags; ws: a zeroed int32 workspace of
// 4 + 12 x tiles words (tiles of kTileRows rows), 16-byte aligned; the
// outputs: fresh 16-byte aligned tensors; vec16: vals is 16-byte aligned.
extern "C" int repro_segmented_scan(const uint32_t* words, const int* vals, long long n,
                                    long long block, int lo, int hi, int* ws, int* out_min,
                                    int* out_max, int* out_cnt, int vec16, void* stream) {
  if (n <= 0) return 0;
  if (block <= 0 || n > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  seg_scan_kernel<<<(unsigned)n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      words, vals, n, block, lo, hi, ws, out_min, out_max, out_cnt, vec16);
  return (int)cudaGetLastError();
}
