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
// Design: three launches, a reduce-then-scan.
//   1. one CUDA block per scan block: the block's aggregate, from a tiled
//      block-wide scan (warp shuffles, then a scan of the warp totals);
//   2. one CUDA block of 1024 threads: the exclusive scan of the block
//      aggregates (each thread folds a contiguous chunk), which gives each
//      scan block its carry-in;
//   3. one CUDA block per scan block: the same tiled scan again, with the
//      carry folded into the rows whose run began in an earlier block.
// The operator on (flag, min, max, count) is
//   (f1, a1) + (f2, a2) = (f1 | f2, f2 ? a2 : a1 o a2),
// associative but not commutative, so every fold keeps row order.
//
// Bound: bytes.  Per row: 1/8 B of packed flags and 4 B of values in,
// 12 B out.  A few million rows take tens of microseconds at 3.35 TB/s, so
// the three launches bound it in practice.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTileThreads = 256;   // threads per block of passes 1 and 3
constexpr int kCarryThreads = 1024; // threads of pass 2
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ Agg from_int4(int4 v) { return {v.x, v.y, v.z, v.w}; }
__device__ __forceinline__ int4 to_int4(const Agg& a) {
  return make_int4(a.f, a.mn, a.mx, a.cnt);
}

// Inclusive scan over the CUDA block (THREADS threads) in thread order;
// `total` receives the whole block's aggregate.  `warp_tot` is shared
// scratch of THREADS / 32 entries.
template <int THREADS>
__device__ Agg block_scan(Agg x, Agg* warp_tot, Agg* total) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Agg o = shfl_up(x, off);
    if (lane >= off) x = combine(o, x);
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    Agg t = lane < kWarps ? warp_tot[lane] : identity();
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      Agg o = shfl_up(t, off);
      if (lane >= off) t = combine(o, t);
    }
    if (lane < kWarps) warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) x = combine(warp_tot[warp - 1], x);
  *total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return x;
}

__device__ __forceinline__ Agg load_row(const uint32_t* __restrict__ words,
                                        const int* __restrict__ vals, long long i,
                                        long long end) {
  if (i >= end) return identity();
  int v = vals[i];
  int f = (int)((words[i >> 5] >> (i & 31)) & 1u);
  return {f, v, v, 1};
}

// Pass 1: each scan block's aggregate, clamped as the carry chain sees it.
__global__ void seg_scan_reduce(const uint32_t* __restrict__ words,
                                const int* __restrict__ vals, long long n,
                                long long block, int lo, int hi,
                                int4* __restrict__ agg) {
  __shared__ Agg warp_tot[kTileThreads / 32];
  const long long s = (long long)blockIdx.x * block;
  const long long e = min(s + block, n);
  Agg acc = identity();
  for (long long t = s; t < e; t += kTileThreads) {
    Agg tot;
    block_scan<kTileThreads>(load_row(words, vals, t + threadIdx.x, e), warp_tot,
                             &tot);
    acc = combine(acc, tot);
  }
  if (threadIdx.x == 0) {
    // a block without a flag passes its rows on through the +-fill clamp
    if (!acc.f) acc = {0, min(acc.mn, lo), max(acc.mx, hi), acc.cnt};
    agg[blockIdx.x] = to_int4(acc);
  }
}

// Pass 2: carry[b] = init + agg[0] + ... + agg[b-1], init = (0, lo, hi, 0).
__global__ void seg_scan_carry(const int4* __restrict__ agg,
                               int4* __restrict__ carry, long long nb, int lo,
                               int hi) {
  __shared__ Agg warp_tot[kCarryThreads / 32];
  __shared__ Agg incl[kCarryThreads];
  const long long per = (nb + kCarryThreads - 1) / kCarryThreads;
  const long long b0 = min((long long)threadIdx.x * per, nb);
  const long long b1 = min(b0 + per, nb);
  Agg t = identity();
  for (long long b = b0; b < b1; ++b) t = combine(t, from_int4(agg[b]));
  Agg tot;
  incl[threadIdx.x] = block_scan<kCarryThreads>(t, warp_tot, &tot);
  __syncthreads();
  Agg run = {0, lo, hi, 0};
  if (threadIdx.x > 0) run = combine(run, incl[threadIdx.x - 1]);
  for (long long b = b0; b < b1; ++b) {
    carry[b] = to_int4(run);
    run = combine(run, from_int4(agg[b]));
  }
}

// Pass 3: the in-block scan with the carry folded into the open prefix.
__global__ void seg_scan_apply(const uint32_t* __restrict__ words,
                               const int* __restrict__ vals, long long n,
                               long long block, int lo, int hi,
                               const int4* __restrict__ carry,
                               int* __restrict__ out_min, int* __restrict__ out_max,
                               int* __restrict__ out_cnt) {
  __shared__ Agg warp_tot[kTileThreads / 32];
  const long long s = (long long)blockIdx.x * block;
  const long long e = min(s + block, n);
  const Agg c = from_int4(carry[blockIdx.x]);
  const int cmn = min(c.mn, lo), cmx = max(c.mx, hi);
  Agg acc = identity();
  for (long long t = s; t < e; t += kTileThreads) {
    const long long i = t + threadIdx.x;
    Agg tot;
    Agg x = block_scan<kTileThreads>(load_row(words, vals, i, e), warp_tot, &tot);
    x = combine(acc, x);
    acc = combine(acc, tot);
    if (i < e) {
      if (x.f) {
        out_min[i] = x.mn;
        out_max[i] = x.mx;
        out_cnt[i] = x.cnt;
      } else {
        out_min[i] = min(x.mn, cmn);
        out_max[i] = max(x.mx, cmx);
        out_cnt[i] = x.cnt + c.cnt;
      }
    }
  }
}

}  // namespace

// words: ceil(n/32) packed flags; scratch: 8 * ceil(n/block) int32, 16-byte
// aligned.  Returns the first launch error (0 when all three launched).
extern "C" int repro_segmented_scan(const uint32_t* words, const int* vals,
                                    long long n, long long block, int lo, int hi,
                                    int* scratch, int* out_min, int* out_max,
                                    int* out_cnt, void* stream) {
  if (n <= 0) return 0;
  if (block <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long nb = (n + block - 1) / block;
  int4* agg = reinterpret_cast<int4*>(scratch);
  int4* carry = agg + nb;
  seg_scan_reduce<<<(unsigned)nb, kTileThreads, 0, st>>>(words, vals, n, block, lo,
                                                         hi, agg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seg_scan_carry<<<1, kCarryThreads, 0, st>>>(agg, carry, nb, lo, hi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seg_scan_apply<<<(unsigned)nb, kTileThreads, 0, st>>>(words, vals, n, block, lo,
                                                        hi, carry, out_min, out_max,
                                                        out_cnt);
  return (int)cudaGetLastError();
}
