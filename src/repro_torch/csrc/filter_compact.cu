// B2: order-preserving stream compaction of a whole table by a packed
// keep-mask, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/filter_compact.py:
// filter_compact_bits_blocks (pallas_call at :94) together with the XLA
// stitch in repro/kernels/ops.py:filter_compact (:44-75), which the reference
// runs once per column (repro/study/executor.py:112).
//
// Design: two passes.  repro_word_popcount writes __popc of every keep word;
// the wrapper turns those into inclusive offsets with torch.cumsum (the stand
// in for the reference's cross-block XLA stitch).  repro_compact_scatter then
// sends every kept row i to  incl[i>>5] - popc(word) + popc(word & lanemask_lt)
// for ALL of the table's columns in one launch (up to COMPACT_MAX_COLS column
// pointers per launch), and zeroes every slot at or past the total count, so
// slots past the count hold 0 exactly as the reference's ops.filter_compact.
// Columns are moved as 32-bit patterns: int32 and float32 alike.
//
// Bound: bytes.  Per row: read 4 B per column and 1/8 B of keep-mask, write
// 4 B per column: 8 B x columns + 1/8 B.  The word counts and offsets add
// 8 B per 32 rows.
//
// B2b, compaction by a (n,) bool row mask: replaces the Pallas TPU kernel
// repro/kernels/filter_compact.py:filter_compact_blocks (pallas_call at
// :136) with the same stitch (repro/kernels/ops.py:66-75).  Design: one
// pass, Merrill & Garland's single-pass scan with decoupled look-back
// (repro_mask_compact).  A block claims its tile of 4,096 rows from an
// atomic tile counter, so it only ever waits on tiles of blocks already
// running (claiming by blockIdx could deadlock).  Each thread reads 16 mask
// bytes as one uint4 and its 16 values of a column as four uint4; the block
// counts and scans the kept rows by warp shuffles, publishes its aggregate
// and then its inclusive prefix in one 64-bit (flag, count) status word per
// tile (release stores, acquire loads), and one warp looks back over the
// predecessors' words, 32 at a time, until it meets an inclusive prefix.
// The kept rows of each column are packed in order in shared memory and
// written to [prefix, prefix + count) in coalesced runs; the last tile
// writes the total.  A second launch zeroes [total, n) of every column,
// reading the total on the device.  The status words and the counter are one
// zeroed workspace of 8 B per tile.  Bound: bytes, per row 1 B of mask + 8 B
// x columns.
#include <cuda_runtime.h>
#include <stdint.h>

#define COMPACT_MAX_COLS 32

constexpr unsigned kFullMask = 0xffffffffu;

struct CompactArgs {
  const uint32_t* in[COMPACT_MAX_COLS];
  uint32_t* out[COMPACT_MAX_COLS];
  int32_t n_cols;
};

__global__ void word_popcount_kernel(const uint32_t* __restrict__ words, long long n_words,
                                     int* __restrict__ out) {
  long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w < n_words) out[w] = __popc(words[w]);
}

__global__ void compact_scatter_kernel(const CompactArgs args,
                                       const uint32_t* __restrict__ words,
                                       const int* __restrict__ incl, long long n,
                                       long long n_words) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long w = i >> 5;
  unsigned lane = (unsigned)(i & 31);
  uint32_t word = words[w];
  long long total = incl[n_words - 1];
  if ((word >> lane) & 1u) {
    long long dst = (long long)incl[w] - __popc(word) + __popc(word & ((1u << lane) - 1u));
    for (int c = 0; c < args.n_cols; ++c) args.out[c][dst] = args.in[c][i];
  }
  if (i >= total) {
    for (int c = 0; c < args.n_cols; ++c) args.out[c][i] = 0u;
  }
}

constexpr int kTileThreads = 256;
constexpr int kItems = 16;                       // rows a thread
constexpr int kTileRows = kItems * kTileThreads;
constexpr unsigned long long kAggregate = 1ull << 32, kInclusive = 2ull << 32;

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// bit b of the result: byte b of x is not 0
__device__ __forceinline__ unsigned nonzero_bytes(uint32_t x) {
  return ((x & 0xffu) ? 1u : 0u) | ((x & 0xff00u) ? 2u : 0u) | ((x & 0xff0000u) ? 4u : 0u) |
         ((x & 0xff000000u) ? 8u : 0u);
}

// this thread's kItems values of one column, rows row0 ...
__device__ __forceinline__ void load_items(const uint32_t* col, long long row0, long long n,
                                           int vec16, uint32_t (&v)[kItems]) {
  if (vec16 && row0 + kItems <= n) {
    const uint4* p = reinterpret_cast<const uint4*>(col + row0);
#pragma unroll
    for (int i = 0; i < kItems / 4; ++i) {
      const uint4 x = __ldg(p + i);
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = row0 + j < n ? col[row0 + j] : 0u;
  }
}

__global__ void __launch_bounds__(kTileThreads)
    mask_compact_kernel(const CompactArgs args, const uint8_t* __restrict__ mask, long long n,
                        int* __restrict__ count, unsigned long long* __restrict__ ws,
                        int vec16) {
  __shared__ uint32_t buf[kTileRows];
  __shared__ int warp_incl[kTileThreads / 32];
  __shared__ long long s_tile;
  __shared__ int s_prefix;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = (long long)atomicAdd(ws, 1ull);
  __syncthreads();
  const long long tile = s_tile;
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  const long long row0 = tile * kTileRows + (long long)kItems * tid;

  // the mask and the first column's values, both in flight at once (the
  // values stay in flight through the scan and the look-back)
  unsigned bits = 0;
  uint32_t vals[kItems];
  if (vec16 && row0 + kItems <= n) {
    const uint4 m = __ldg(reinterpret_cast<const uint4*>(mask + row0));
    load_items(args.in[0], row0, n, vec16, vals);
    bits = nonzero_bytes(m.x) | nonzero_bytes(m.y) << 4 | nonzero_bytes(m.z) << 8 |
           nonzero_bytes(m.w) << 12;
  } else {
    load_items(args.in[0], row0, n, vec16, vals);
    for (int j = 0; j < kItems; ++j)
      if (row0 + j < n && mask[row0 + j]) bits |= 1u << j;
  }

  // exclusive offset of this thread's kept rows within the tile
  const int c = __popc(bits);
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kTileThreads / 32 ? warp_incl[lane] : 0;
#pragma unroll
    for (int off = 1; off < kTileThreads / 32; off <<= 1) {
      const int y = __shfl_up_sync(kFullMask, t, off);
      if (lane >= off) t += y;
    }
    if (lane < kTileThreads / 32) warp_incl[lane] = t;
  }
  __syncthreads();
  const int excl = incl - c + (warp ? warp_incl[warp - 1] : 0);
  const int agg = warp_incl[kTileThreads / 32 - 1];

  // decoupled look-back: the kept rows of every earlier tile
  if (warp == 0) {
    unsigned long long* status = ws + 1;
    int prefix = 0;
    if (tile > 0) {
      if (lane == 0) store_status(status + tile, kAggregate | (unsigned)agg);
      long long base = tile - 1;
      while (true) {
        const long long idx = base - lane;
        unsigned long long st = kInclusive;  // before tile 0: a prefix of 0
        if (idx >= 0) {
          do {
            st = load_status(status + idx);
          } while ((st >> 32) == 0);
        }
        const unsigned inc = __ballot_sync(kFullMask, (st >> 32) == 2);
        int v = (int)(unsigned)st;
        if (inc) v = lane <= __ffs(inc) - 1 ? v : 0;  // up to the nearest prefix
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
        prefix += v;
        if (inc) break;
        base -= 32;
      }
    }
    if (lane == 0) {
      store_status(status + tile, kInclusive | (unsigned)(prefix + agg));
      s_prefix = prefix;
      if (tile == n_tiles - 1) *count = prefix + agg;
    }
  }
  __syncthreads();
  const long long prefix = s_prefix;

  for (int col = 0; col < args.n_cols; ++col) {
    if (col > 0) load_items(args.in[col], row0, n, vec16, vals);
    int pos = excl;
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if ((bits >> j) & 1u) buf[pos++] = vals[j];
    __syncthreads();
    uint32_t* out = args.out[col] + prefix;
    for (int i = tid; i < agg; i += kTileThreads) out[i] = buf[i];
    __syncthreads();
  }
}

// zeroes [*count, n) of every output column, 4 slots a thread (one 16-byte
// store where the 4 are inside the range and the column is aligned)
__global__ void fill_tail_kernel(const CompactArgs args, const int* __restrict__ count,
                                 long long n) {
  const long long total = *count;
  const long long step = 4LL * gridDim.x * blockDim.x;
  for (long long j = (total & ~3LL) + 4LL * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
       j < n; j += step) {
    for (int c = 0; c < args.n_cols; ++c) {
      uint32_t* out = args.out[c];
      if (j >= total && j + 4 <= n && (reinterpret_cast<uintptr_t>(out) & 15u) == 0) {
        *reinterpret_cast<uint4*>(out + j) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        for (long long e = j; e < j + 4; ++e)
          if (e >= total && e < n) out[e] = 0u;
      }
    }
  }
}

// ws: (1 + ceil(n / kTileRows)) zeroed 64-bit words (the tile counter, then one
// status word per tile); count: the kept rows, written on the device.
// vec16: the mask and every input column are 16-byte aligned.
extern "C" int repro_mask_compact(const CompactArgs* args, const uint8_t* mask, long long n,
                                  int* count, unsigned long long* ws, int vec16, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || args->n_cols <= 0 || args->n_cols > COMPACT_MAX_COLS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned tiles = (unsigned)((n + kTileRows - 1) / kTileRows);
  mask_compact_kernel<<<tiles, kTileThreads, 0, st>>>(*args, mask, n, count, ws, vec16);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const long long want = (n + 1023) / 1024;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  fill_tail_kernel<<<blocks, 256, 0, st>>>(*args, count, n);
  return (int)cudaGetLastError();
}

extern "C" int repro_word_popcount(const uint32_t* words, long long n_words, int* out,
                                   void* stream) {
  const int threads = 256;
  unsigned blocks = (unsigned)((n_words + threads - 1) / threads);
  word_popcount_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(words, n_words, out);
  return (int)cudaGetLastError();
}

extern "C" int repro_compact_scatter(const CompactArgs* args, const uint32_t* words,
                                     const int* incl, long long n, long long n_words,
                                     void* stream) {
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  compact_scatter_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *args, words, incl, n, n_words);
  return (int)cudaGetLastError();
}
