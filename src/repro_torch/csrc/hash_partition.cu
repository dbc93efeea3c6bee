// B5: the shuffle's plan for sm_90a — per row a destination shard
// dest = hash(key) % n_dest and the row's rank among the rows of its block
// bound for the same destination, plus one histogram row per block.
//
// Replaces the Pallas TPU kernel repro/kernels/hash_partition.py:
// hash_partition_plan (pallas_call at :55), whose rank is an exclusive cumsum
// over a (block x n_dest) one-hot matrix in VMEM (a TPU layout).
//
// Design: one thread per row, `block` rows per thread block (a multiple of
// 32, at most 1024, a runtime argument).  The hash is the reference's,
// ((k * 0x9E3779B1) ^ (>> 16)) in uint32.  Validity comes straight from the
// table's packed words (1 bit a row).  __match_any_sync on dest gives each
// lane the lanes of its warp with the same destination; the rank within the
// warp is __popc(peers & lanemask_lt), and the lowest such lane writes the
// group's size into a per-warp histogram in shared memory (n_warps x n_dest
// ints).  One thread per destination then turns the warp column into an
// exclusive scan across warps and writes the block's histogram row; each
// valid row's rank is its warp's offset plus its rank in the warp.  Invalid
// rows (and rows past n) get dest = n_dest and rank 0 and are counted
// nowhere.  The wrapper raises above the n_dest that 48 KB of shared memory
// holds.
//
// Bound: bytes.  Per row: read 4 B of key and 1/8 B of validity, write 4 B
// of dest and 4 B of rank; per block write 4 B x n_dest of histogram.
#include <cuda_runtime.h>
#include <stdint.h>

#define HP_MUL 0x9E3779B1u

__global__ void hash_partition_kernel(const uint32_t* __restrict__ keys,
                                      const uint32_t* __restrict__ words, long long n,
                                      int n_dest, int* __restrict__ dest_out,
                                      int* __restrict__ rank_out, int* __restrict__ hist) {
  extern __shared__ int counts[];  // [n_warps][n_dest]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int i = tid; i < n_warps * n_dest; i += blockDim.x) counts[i] = 0;

  const long long row = (long long)blockIdx.x * blockDim.x + tid;
  bool valid = false;
  int d = n_dest;
  if (row < n) {
    valid = (words[row >> 5] >> (unsigned)(row & 31)) & 1u;
    if (valid) {
      uint32_t h = keys[row] * HP_MUL;
      h ^= h >> 16;
      d = (int)(h % (uint32_t)n_dest);
    }
  }
  __syncthreads();

  const unsigned peers = __match_any_sync(0xffffffffu, d);
  const int in_warp = __popc(peers & ((1u << lane) - 1u));
  if (valid && in_warp == 0) counts[warp * n_dest + d] = __popc(peers);
  __syncthreads();

  for (int j = tid; j < n_dest; j += blockDim.x) {
    int run = 0;
    for (int w = 0; w < n_warps; ++w) {
      const int c = counts[w * n_dest + j];
      counts[w * n_dest + j] = run;
      run += c;
    }
    hist[(long long)blockIdx.x * n_dest + j] = run;
  }
  __syncthreads();

  if (row < n) {
    dest_out[row] = d;
    rank_out[row] = valid ? counts[warp * n_dest + d] + in_warp : 0;
  }
}

extern "C" int repro_hash_partition(const uint32_t* keys, const uint32_t* words, long long n,
                                    int n_dest, int block, int* dest, int* rank, int* hist,
                                    void* stream) {
  const unsigned blocks = (unsigned)((n + block - 1) / block);
  const size_t smem = (size_t)(block / 32) * n_dest * sizeof(int);
  hash_partition_kernel<<<blocks, block, smem, (cudaStream_t)stream>>>(keys, words, n, n_dest,
                                                                       dest, rank, hist);
  return (int)cudaGetLastError();
}
