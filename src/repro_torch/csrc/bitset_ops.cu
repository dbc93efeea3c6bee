// B3: cohort bitset algebra fused with the popcount, for sm_90a: one launch
// evaluates a whole cohort expression.
//
// Replaces the Pallas TPU kernel repro/kernels/bitset_ops.py:
// bitset_op_popcount (pallas_call at :63; wrapper repro/kernels/ops.py:91),
// which the reference's executor calls once per cohort_op node and whose
// count it recounts (repro/study/executor.py:290, :301).
//
// A program is up to MAX_OPS ops (and / or / andnot / xor) over up to
// MAX_LEAVES leaf word vectors and the results of earlier ops.  Each op's
// words and each op's population count are written; the counts vector is
// written outright (no memset before the launch, nothing accumulates into
// memory the call did not write).
//
// Bound: bytes.  Per word: 4 B of each leaf read, 4 B of each op's result
// written.  At the cohort universes of the studies (62,500 words) that is
// below what any launch costs, so what counts there is launches: one per
// expression, where an op used to take a memset, the kernel and a recount.
//
// Design: a persistent, cooperative grid (at most what is co-resident, and
// at least one block an SM where there is a warp's work for it) walks the
// words grid-stride, 16 bytes a thread where every pointer is 16-byte
// aligned and one word otherwise (and on the tail).  Per item, a thread
// evaluates the program from its registers: leaves are loaded where an op
// reads them (a leaf read twice hits L1), results stay in registers and are
// picked by a select over the earlier ops.  The kernel is instantiated per
// program length and walks the ops by template recursion, so every index
// into the result and count arrays is a constant and they stay in
// registers (with loops over the ops, nvcc turned the selects back into an
// indexed array: stack frames of up to 160 bytes, 96 registers).  Blocks
// of 256 threads (at 2,062,500 words 0.0193 ms against 0.0220 with 128;
// tools/b3_probe.py on an H100 80GB HBM3 at 700 W).  The program and the
// pointers are one by-value __grid_constant__ parameter, read as uniform
// constants.  Counts:
// per-thread int32 sums, a warp shuffle and a shared-memory sum per block,
// one partial per (block, op) written outright, a grid-wide barrier, then
// block 0 sums the partials.  Integer sums in any order are exact, so the
// counts are deterministic.  The partials are this call's own scratch (the
// wrapper allocates them with the counts): nothing outlives a call, so
// launches on different streams never share state.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int MAX_LEAVES = 8;
constexpr int MAX_OPS = 8;
constexpr int THREADS = 256;

// Mirrored by kernels/bitset_ops.py:_ExprArgs (field for field).  Outside
// the anonymous namespace: the exported entry takes it.
struct ExprArgs {
  const uint32_t* leaves[MAX_LEAVES];
  uint32_t* outs[MAX_OPS];
  int* counts;      // n_ops
  int* partials;    // grid * n_ops
  long long n;      // words per vector
  int n_ops;
  int vec;          // every leaf and output 16-byte aligned
  signed char op[MAX_OPS];   // 0 and, 1 or, 2 andnot, 3 xor
  signed char a[MAX_OPS];    // operand: leaf k < MAX_LEAVES, else result
  signed char b[MAX_OPS];    //   of op k - MAX_LEAVES (an earlier op)
};

namespace {

__device__ __forceinline__ uint32_t apply(uint32_t x, uint32_t y, int op) {
  switch (op) {
    case 0: return x & y;
    case 1: return x | y;
    case 2: return x & ~y;
    default: return x ^ y;
  }
}

__device__ __forceinline__ uint4 apply(uint4 x, uint4 y, int op) {
  return make_uint4(apply(x.x, y.x, op), apply(x.y, y.y, op),
                    apply(x.z, y.z, op), apply(x.w, y.w, op));
}

__device__ __forceinline__ int popc(uint32_t x) { return __popc(x); }
__device__ __forceinline__ int popc(uint4 x) {
  return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}

__device__ __forceinline__ void load(const uint32_t* p, long long i,
                                     uint32_t& v) {
  v = __ldg(p + i);
}
__device__ __forceinline__ void load(const uint32_t* p, long long i, uint4& v) {
  v = __ldg(reinterpret_cast<const uint4*>(p) + i);
}
__device__ __forceinline__ void store(uint32_t* p, long long i, uint32_t v) {
  p[i] = v;
}
__device__ __forceinline__ void store(uint32_t* p, long long i, uint4 v) {
  reinterpret_cast<uint4*>(p)[i] = v;
}

// the result of op `idx` among ops 0..J-1: a chain of selects whose indices
// are template constants
template <int S, int J, typename V, int N>
__device__ __forceinline__ V pick(const V (&r)[N], int idx, V x) {
  if constexpr (S < J) {
    x = idx == S ? r[S] : x;
    return pick<S + 1, J>(r, idx, x);
  } else {
    return x;
  }
}

// operand k of op J on item i: a leaf from memory, or an earlier result
template <int J, typename V, int N>
__device__ __forceinline__ V operand(const ExprArgs& P, int k, long long i,
                                     const V (&r)[N]) {
  V x;
  if (k < MAX_LEAVES) {
    load(P.leaves[k], i, x);
    return x;
  }
  return pick<0, J>(r, k - MAX_LEAVES, r[0]);
}

// ops J..N-1 of the program on item i (a uint4 of 4 words, or one word)
template <int J, typename V, int N>
__device__ __forceinline__ void eval_ops(const ExprArgs& P, long long i,
                                         V (&r)[N], int (&pc)[N]) {
  if constexpr (J < N) {
    V x = operand<J>(P, P.a[J], i, r);
    V y = operand<J>(P, P.b[J], i, r);
    r[J] = apply(x, y, P.op[J]);
    store(P.outs[J], i, r[J]);
    pc[J] += popc(r[J]);
    eval_ops<J + 1>(P, i, r, pc);
  }
}

template <typename V, int N>
__device__ __forceinline__ void eval_item(const ExprArgs& P, long long i,
                                          int (&pc)[N]) {
  V r[N] = {};
  eval_ops<0>(P, i, r, pc);
}

// one instantiation per program length N (1..MAX_OPS)
template <int N>
__global__ void __launch_bounds__(THREADS)
bitset_expr_kernel(const __grid_constant__ ExprArgs P) {
  __shared__ int red[THREADS / 32][N];
  int pc[N] = {};

  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n_vec = P.vec ? P.n / 4 : 0;
  for (long long q = tid; q < n_vec; q += stride)
    eval_item<uint4, N>(P, q, pc);
  for (long long w = 4 * n_vec + tid; w < P.n; w += stride)
    eval_item<uint32_t, N>(P, w, pc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    int v = pc[j];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red[w][threadIdx.x];
    P.partials[(long long)blockIdx.x * N + threadIdx.x] = s;
  }

  cg::this_grid().sync();   // every block's partials are visible past here

  if (blockIdx.x != 0) return;
  for (int j = warp; j < N; j += THREADS / 32) {
    int s = 0;
    for (int blk = lane; blk < (int)gridDim.x; blk += 32)
      s += P.partials[(long long)blk * N + j];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) P.counts[j] = s;
  }
}

const void* const KERNELS[MAX_OPS] = {
    (const void*)bitset_expr_kernel<1>, (const void*)bitset_expr_kernel<2>,
    (const void*)bitset_expr_kernel<3>, (const void*)bitset_expr_kernel<4>,
    (const void*)bitset_expr_kernel<5>, (const void*)bitset_expr_kernel<6>,
    (const void*)bitset_expr_kernel<7>, (const void*)bitset_expr_kernel<8>};

}  // namespace

// The card's limits for the grid of the n_ops-op kernel: SMs and
// co-resident blocks an SM.
extern "C" int repro_bitset_expr_limits(int n_ops, int* sm_count,
                                        int* blocks_per_sm) {
  if (n_ops < 1 || n_ops > MAX_OPS) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, KERNELS[n_ops - 1], THREADS, 0);
  return (int)e;
}

// One cooperative launch of ``grid`` blocks (at most sm_count x
// blocks_per_sm, else the launch is refused and its error returned).
extern "C" int repro_bitset_expr(const ExprArgs* args, int grid, void* stream) {
  if (args->n_ops < 1 || args->n_ops > MAX_OPS)
    return (int)cudaErrorInvalidValue;
  ExprArgs P = *args;
  void* kargs[] = {&P};
  cudaError_t e = cudaLaunchCooperativeKernel(
      KERNELS[P.n_ops - 1], dim3(grid), dim3(THREADS), kargs, 0,
      (cudaStream_t)stream);
  cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}
