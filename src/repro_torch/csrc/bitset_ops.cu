// B3: cohort bitset algebra fused with the popcount, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/bitset_ops.py:
// bitset_op_popcount (pallas_call at :63; wrapper repro/kernels/ops.py:91).
//
// Design: one thread per four words, read as one uint4 where the three
// pointers are 16-byte aligned (scalar loads on the ragged tail or otherwise),
// the op (and / or / andnot / xor), __popc, a warp-shuffle reduction, a
// shared-memory sum per block and one int32 atomicAdd per block.  Integer
// atomics make the count deterministic.
//
// Bound: bytes.  Per word: read 4 B of a and 4 B of b, write 4 B: 12 B.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t apply_op(uint32_t a, uint32_t b, int op) {
  switch (op) {
    case 0: return a & b;
    case 1: return a | b;
    case 2: return a & ~b;
    default: return a ^ b;
  }
}

__global__ void bitset_op_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, long long n, int op, int vec,
                                 int* __restrict__ count) {
  __shared__ int block_count;
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();

  long long base = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  int pc = 0;
  if (vec && base + 4 <= n) {
    uint4 va = *reinterpret_cast<const uint4*>(a + base);
    uint4 vb = *reinterpret_cast<const uint4*>(b + base);
    uint4 r;
    r.x = apply_op(va.x, vb.x, op);
    r.y = apply_op(va.y, vb.y, op);
    r.z = apply_op(va.z, vb.z, op);
    r.w = apply_op(va.w, vb.w, op);
    *reinterpret_cast<uint4*>(out + base) = r;
    pc = __popc(r.x) + __popc(r.y) + __popc(r.z) + __popc(r.w);
  } else {
    for (long long k = base; k < base + 4 && k < n; ++k) {
      uint32_t r = apply_op(a[k], b[k], op);
      out[k] = r;
      pc += __popc(r);
    }
  }
  for (int off = 16; off > 0; off >>= 1) pc += __shfl_down_sync(0xffffffffu, pc, off);
  if ((threadIdx.x & 31) == 0 && pc) atomicAdd(&block_count, pc);
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(count, block_count);
}

extern "C" int repro_bitset_op(const uint32_t* a, const uint32_t* b, uint32_t* out,
                               long long n, int op, int* count, void* stream) {
  const int threads = 256;
  long long n_threads = (n + 3) / 4;
  unsigned blocks = (unsigned)((n_threads + threads - 1) / threads);
  int vec = ((((uintptr_t)a) | ((uintptr_t)b) | ((uintptr_t)out)) & 15u) == 0;
  bitset_op_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a, b, out, n, op, vec, count);
  return (int)cudaGetLastError();
}
