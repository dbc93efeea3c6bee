// B1: fused Expr predicate -> packed validity bitset, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/predicate.py:
// predicate_bitset_blocks (pallas_call at :396; codegen compile_predicate,
// body _make_kernel, hoisting _stage_hoisted).
//
// Design: a bytecode interpreter.  The host (repro_torch/kernels/predicate.py)
// compiles a serialized Expr tree once into a short typed register program
// (opcodes typed by jnp's promotion rules) and caches it on the param tree.
// The program, the column pointers, the sorted isin whitelists and the
// hoisted literal values all arrive as one by-value kernel argument, so a
// single build serves every Expr and every literal value: nothing is compiled
// while a study runs.  One thread evaluates one row: it loads only the
// columns the program reads, runs the program in registers, ANDs the row's
// validity bit, and __ballot_sync packs 32 consecutive rows into one word
// (lane = row % 32 is exactly the core.bitset layout).  The count is a
// per-block shared-memory sum plus one int32 atomicAdd per block, which is
// deterministic because it is an integer.  isin/hisin is a binary search over
// the sorted whitelist in global memory; a NaN probe is a non-member.
//
// Bound: bytes.  Per row it must read 4 B for every referenced column plus
// 1/8 B of validity and write 1/8 B of result words: 4 B x columns + 1/4 B.
// The interpreter loop keeps its registers in local memory (dynamically
// indexed), which costs instructions, not DRAM bytes; making it fast is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define PRED_MAX_COLS 16
#define PRED_MAX_TABLES 8
#define PRED_MAX_LITS 16
#define PRED_MAX_INSTR 96
#define PRED_NREG 16

#define NULL_INT (-2147483647)

// opcodes: keep in sync with repro_torch/kernels/predicate.py (OPCODES)
enum {
  OP_LOAD = 0,       // r[d] = cols[imm][row]
  OP_CONST = 1,      // r[d] = imm (32-bit pattern)
  OP_LIT = 2,        // r[d] = lits[imm]
  OP_CVT_I32_F32 = 3,
  OP_ADD_I32 = 4, OP_SUB_I32 = 5, OP_MUL_I32 = 6,
  OP_FLOORDIV_I32 = 7, OP_MOD_I32 = 8,
  OP_ADD_F32 = 9, OP_SUB_F32 = 10, OP_MUL_F32 = 11,
  OP_FLOORDIV_F32 = 12, OP_MOD_F32 = 13,
  OP_CMP_EQ_I32 = 14, OP_CMP_NE_I32 = 15, OP_CMP_LT_I32 = 16,
  OP_CMP_LE_I32 = 17, OP_CMP_GT_I32 = 18, OP_CMP_GE_I32 = 19,
  OP_CMP_EQ_F32 = 20, OP_CMP_NE_F32 = 21, OP_CMP_LT_F32 = 22,
  OP_CMP_LE_F32 = 23, OP_CMP_GT_F32 = 24, OP_CMP_GE_F32 = 25,
  OP_AND = 26, OP_OR = 27, OP_NOT = 28,
  OP_ISNULL_I32 = 29, OP_ISNULL_F32 = 30,
  OP_ISIN_I32 = 31, OP_ISIN_F32 = 32,
};

struct Instr {
  uint8_t op, dst, a, b;
  int32_t imm;
};

struct PredArgs {
  const uint32_t* cols[PRED_MAX_COLS];
  const uint32_t* tables[PRED_MAX_TABLES];
  int32_t table_len[PRED_MAX_TABLES];
  uint32_t lits[PRED_MAX_LITS];
  Instr prog[PRED_MAX_INSTR];
  int32_t n_instr;
  int32_t result;
};

__device__ __forceinline__ float u2f(uint32_t u) { return __uint_as_float(u); }
__device__ __forceinline__ uint32_t f2u(float f) { return __float_as_uint(f); }

// jnp.floor_divide on int32 (XLA: x / 0 == -1, x % 0 == x, INT_MIN / -1 wraps)
__device__ __forceinline__ int32_t floordiv_i32(int32_t x, int32_t y) {
  int32_t q, r;
  if (y == 0) {
    q = -1; r = x;
  } else if (x == INT32_MIN && y == -1) {
    q = INT32_MIN; r = 0;
  } else {
    q = x / y; r = x % y;
  }
  int sx = (x > 0) - (x < 0), sy = (y > 0) - (y < 0);
  return (sx != sy && r != 0) ? (int32_t)((uint32_t)q - 1u) : q;
}

// jnp.remainder on int32 (a zero divisor is replaced by one)
__device__ __forceinline__ int32_t mod_i32(int32_t x, int32_t y) {
  if (y == 0) y = 1;
  int32_t t = (x == INT32_MIN && y == -1) ? 0 : x % y;
  bool plus = ((t < 0) != (y < 0)) && t != 0;
  return plus ? (int32_t)((uint32_t)t + (uint32_t)y) : t;
}

// lax.sign on float32: -1, +1, the zero itself, NaN for NaN
__device__ __forceinline__ float sign_f32(float v) {
  if (v != v) return v;
  if (v > 0.f) return 1.f;
  if (v < 0.f) return -1.f;
  return v;
}

// lax.round (half away from zero)
__device__ __forceinline__ float round_away(float d) {
  float t = truncf(d);
  float frac = __fsub_rn(d, t);
  if (fabsf(frac) >= 0.5f) t = __fadd_rn(t, d > 0.f ? 1.f : -1.f);
  return t;
}

// jnp's float divmod (_float_divmod): the quotient is rounded, the modulus
// takes the divisor's sign
__device__ __forceinline__ float floordiv_f32(float x, float y) {
  float mod = fmodf(x, y);
  float div = __fdiv_rn(__fsub_rn(x, mod), y);
  bool ind = (mod != 0.f) && (sign_f32(y) != sign_f32(mod));
  if (ind) div = __fsub_rn(div, 1.f);
  return round_away(div);
}

__device__ __forceinline__ float mod_f32(float x, float y) {
  float t = fmodf(x, y);
  bool plus = ((t < 0.f) != (y < 0.f)) && (t != 0.f);
  return plus ? __fadd_rn(t, y) : t;
}

// lower bound in a sorted table; member iff the slot holds x
__device__ __forceinline__ bool member_i32(const int32_t* t, int n, int32_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (t[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo < n && t[lo] == x;
}

__device__ __forceinline__ bool member_f32(const float* t, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (t[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo < n && t[lo] == x;   // NaN probe: never equal
}

__global__ void predicate_kernel(const PredArgs args, const uint32_t* __restrict__ valid,
                                 long long n, long long n_words,
                                 uint32_t* __restrict__ words, int* __restrict__ count) {
  __shared__ int block_count;
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();

  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool bit = false;
  if (row < n) {
    uint32_t r[PRED_NREG] = {0};
    for (int pc = 0; pc < args.n_instr; ++pc) {
      const Instr in = args.prog[pc];
      uint32_t a = r[in.a], b = r[in.b], out = 0;
      switch (in.op) {
        case OP_LOAD: out = args.cols[in.imm][row]; break;
        case OP_CONST: out = (uint32_t)in.imm; break;
        case OP_LIT: out = args.lits[in.imm]; break;
        case OP_CVT_I32_F32: out = f2u(__int2float_rn((int32_t)a)); break;
        case OP_ADD_I32: out = a + b; break;
        case OP_SUB_I32: out = a - b; break;
        case OP_MUL_I32: out = a * b; break;
        case OP_FLOORDIV_I32: out = (uint32_t)floordiv_i32((int32_t)a, (int32_t)b); break;
        case OP_MOD_I32: out = (uint32_t)mod_i32((int32_t)a, (int32_t)b); break;
        case OP_ADD_F32: out = f2u(__fadd_rn(u2f(a), u2f(b))); break;
        case OP_SUB_F32: out = f2u(__fsub_rn(u2f(a), u2f(b))); break;
        case OP_MUL_F32: out = f2u(__fmul_rn(u2f(a), u2f(b))); break;
        case OP_FLOORDIV_F32: out = f2u(floordiv_f32(u2f(a), u2f(b))); break;
        case OP_MOD_F32: out = f2u(mod_f32(u2f(a), u2f(b))); break;
        case OP_CMP_EQ_I32: out = (int32_t)a == (int32_t)b; break;
        case OP_CMP_NE_I32: out = (int32_t)a != (int32_t)b; break;
        case OP_CMP_LT_I32: out = (int32_t)a < (int32_t)b; break;
        case OP_CMP_LE_I32: out = (int32_t)a <= (int32_t)b; break;
        case OP_CMP_GT_I32: out = (int32_t)a > (int32_t)b; break;
        case OP_CMP_GE_I32: out = (int32_t)a >= (int32_t)b; break;
        case OP_CMP_EQ_F32: out = u2f(a) == u2f(b); break;
        case OP_CMP_NE_F32: out = u2f(a) != u2f(b); break;
        case OP_CMP_LT_F32: out = u2f(a) < u2f(b); break;
        case OP_CMP_LE_F32: out = u2f(a) <= u2f(b); break;
        case OP_CMP_GT_F32: out = u2f(a) > u2f(b); break;
        case OP_CMP_GE_F32: out = u2f(a) >= u2f(b); break;
        case OP_AND: out = a & b; break;
        case OP_OR: out = a | b; break;
        case OP_NOT: out = a ^ 1u; break;
        case OP_ISNULL_I32: out = (int32_t)a == NULL_INT; break;
        case OP_ISNULL_F32: out = u2f(a) != u2f(a); break;
        case OP_ISIN_I32:
          out = member_i32((const int32_t*)args.tables[in.imm], args.table_len[in.imm], (int32_t)a);
          break;
        case OP_ISIN_F32:
          out = member_f32((const float*)args.tables[in.imm], args.table_len[in.imm], u2f(a));
          break;
        default: break;
      }
      r[in.dst] = out;
    }
    bit = (r[args.result] != 0u) && ((valid[row >> 5] >> (row & 31)) & 1u);
  }
  // every thread of the warp reaches the ballot (no early return above)
  unsigned word = __ballot_sync(0xffffffffu, bit);
  if ((threadIdx.x & 31) == 0) {
    long long w = row >> 5;
    if (w < n_words) {
      words[w] = word;
      atomicAdd(&block_count, __popc(word));
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(count, block_count);
}

extern "C" int repro_predicate_bitset(const PredArgs* args, const uint32_t* valid,
                                      long long n, uint32_t* words, int* count,
                                      void* stream) {
  const int threads = 256;
  long long n_words = (n + 31) / 32;
  long long n_threads = n_words * 32;
  unsigned blocks = (unsigned)((n_threads + threads - 1) / threads);
  predicate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *args, valid, n, n_words, words, count);
  return (int)cudaGetLastError();
}
