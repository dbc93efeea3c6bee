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
// :136) with the same stitch (repro/kernels/ops.py:66-75).  Design:
// repro_mask_ballot reads the byte mask, one warp ballot per 32 rows, and
// writes each word's bits and __popc; the wrapper's torch.cumsum and
// repro_compact_scatter then run exactly as for B2.  Bound: bytes, per row
// 1 B of mask + 8 B x columns.
#include <cuda_runtime.h>
#include <stdint.h>

#define COMPACT_MAX_COLS 32

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

__global__ void mask_ballot_kernel(const uint8_t* __restrict__ mask, long long n,
                                   long long n_words, uint32_t* __restrict__ words,
                                   int* __restrict__ per_word) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if ((i >> 5) >= n_words) return;  // whole warps leave together
  const unsigned bits = __ballot_sync(0xffffffffu, i < n && mask[i] != 0);
  if ((threadIdx.x & 31) == 0) {
    words[i >> 5] = bits;
    per_word[i >> 5] = __popc(bits);
  }
}

extern "C" int repro_mask_ballot(const uint8_t* mask, long long n, long long n_words,
                                 uint32_t* words, int* per_word, void* stream) {
  const int threads = 256;
  unsigned blocks = (unsigned)((n_words * 32 + threads - 1) / threads);
  mask_ballot_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(mask, n, n_words, words,
                                                                   per_word);
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
