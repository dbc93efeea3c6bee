// B1: fused Expr predicate -> packed validity bitset, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/predicate.py:
// predicate_bitset_blocks (pallas_call at :396; codegen compile_predicate,
// body _make_kernel, hoisting _stage_hoisted).
//
// Design: a bytecode interpreter, so that one build serves every Expr and
// every hoisted literal value and nothing is compiled while a study runs.
// The host (repro_torch/kernels/predicate.py) compiles a serialized Expr tree
// once into a short typed register program (opcodes typed by jnp's promotion
// rules), then schedules it for this kernel (schedule_program, on its
// dataflow): an operand that a CONST or hoisted literal produced rides in the
// instruction as a uniform value, a NOT folds into the boolean op before it,
// a LOAD into the instruction that reads it next, an operand the previous
// instruction produced stays in registers, and only a value read later than
// that goes through a slot of a register file in shared memory.
//
// What bounded the first design (one thread a row, the whole program per
// row; 0.755 ms for a 3-instruction program over 48M rows on an H100, 12x its
// byte bound): a dynamically indexed register array in local memory, the
// switch dispatched once per row and instruction, one 4-byte load in flight
// per thread, whitelists searched in global memory, and 187,500 blocks each
// ending in an atomicAdd on one address.
//
// This design (plan_predicate_launch sizes it):
//   * persistent grid: SMs x resident blocks per SM (the occupancy the
//     launcher reads for this shared-memory size); each block walks tiles
//     grid-stride, sums its count in registers, and issues ONE global
//     atomicAdd at the end (an integer sum, so the count is deterministic);
//     while it runs a tile it asks L2 for its next tile's columns and
//     validity words (one bulk prefetch a column);
//   * the program, column pointers, literals and table descriptors are
//     staged once per block from the __grid_constant__ argument into shared
//     memory, and the hot loop reads them at warp-uniform indices;
//   * a tile is R x kThreads rows, row = tile + r * kThreads + tid (R = 16,
//     or 8 where the register file would not fit at 16): every warp access
//     is a coalesced 128 bytes and the ballot still packs lane = row % 32
//     (the core.bitset layout).  The instruction loop is outermost, so
//     dispatch costs once per instruction per tile; a LOAD issues its R
//     loads before any is used; a tile inside [0, n) tests no row against n;
//   * the register file in shared memory is reg[slot][R][kThreads] (each
//     thread reads back only what it wrote: no barrier, no bank conflict),
//     sized by the program's own slot count;
//   * isin/hisin whitelists (sorted, tail-padded with their own max) of at
//     most MAX_ISIN_VALUES entries are staged in shared memory: an int one
//     spanning at most 32 x kBitmapWords values becomes a bitmap (one load a
//     probe), any other is searched there by a branchless lower bound whose
//     trip count depends only on its length (warp-uniform); a longer one is
//     searched in global memory; a NaN probe is a non-member.
//
// Bound: bytes.  Per row it must read 4 B for every referenced column plus
// 1/8 B of validity and write 1/8 B of result words: 4 B x columns + 1/4 B.
#include <cuda_runtime.h>
#include <stdint.h>

#define PRED_MAX_COLS 16
#define PRED_MAX_TABLES 8
#define PRED_MAX_LITS 16
#define PRED_MAX_INSTR 96

#define NULL_INT (-2147483647)

namespace {

constexpr int kThreads = 256;             // PRED_THREADS in predicate.py
// rows a thread per tile (PRED_ROWS): 16, or 8 where a program's register
// file would not fit in shared memory at 16
constexpr int kWideRows = 16, kNarrowRows = 8;
constexpr unsigned kFull = 0xffffffffu;

// Instr.flags (predicate.py: _A_SMEM, _B_SMEM, _STORE, _A_UNI, _B_UNI,
// _UNI_LIT, _NEG, _A_LOAD)
constexpr int kASmem = 1, kBSmem = 2, kStore = 4, kAUni = 8, kBUni = 16, kUniLit = 32,
              kNeg = 64, kALoad = 128;

}  // namespace

// opcodes: keep in sync with repro_torch/kernels/predicate.py (OPCODES)
enum {
  OP_LOAD = 0,       // out = cols[imm][row]
  OP_CONST = 1,      // out = imm (32-bit pattern)
  OP_LIT = 2,        // out = lits[imm]
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

// a, b and dst are register-file slots (read where flags has kASmem /
// kBSmem, written where it has kStore); an operand with kAUni / kBUni is the
// uniform value imm (lits[imm] with kUniLit); operand a with kALoad is
// column col's rows; every other operand is the previous instruction's
// result.  16 bytes: one shared-memory load.
struct Instr {
  uint8_t op, dst, a, b;
  int32_t imm;
  int32_t flags;
  int32_t col;
};

// mirrored by _PredArgs in predicate.py; its size is a multiple of 16 bytes
struct PredArgs {
  const uint32_t* cols[PRED_MAX_COLS];
  const uint32_t* tables[PRED_MAX_TABLES];
  int32_t table_len[PRED_MAX_TABLES];
  int32_t table_off[PRED_MAX_TABLES];   // word offset in shared memory, or -1
  int32_t bitmap_off[PRED_MAX_TABLES];  // int whitelists: a bitmap's offset, or -1
  uint32_t lits[PRED_MAX_LITS];
  Instr prog[PRED_MAX_INSTR];
  int32_t n_instr;
  int32_t n_slots;                       // register-file slots
  int32_t table_words;                   // whitelist words staged in shared memory
  int32_t n_cols;                        // columns the program loads
};
static_assert(sizeof(PredArgs) % 16 == 0, "PredArgs is staged as 16-byte words");

__device__ __forceinline__ float u2f(uint32_t u) { return __uint_as_float(u); }
__device__ __forceinline__ uint32_t f2u(float f) { return __float_as_uint(f); }

// XLA flushes float32 denormals on the inputs and results of arithmetic and
// on the inputs of comparisons (DAZ and FTZ): a denormal becomes a zero of
// its sign.  Done here by hand at each such load and result, not with
// -ftz=true, so that fmodf stays exact (XLA's rem does not flush) and no
// other kernel of the library changes.
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < 1.17549435e-38f ? copysignf(0.f, v) : v;
}
__device__ __forceinline__ float fz(uint32_t u) { return ftz(u2f(u)); }

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
// takes the divisor's sign; XLA's rem flushes its divisor only, every later
// step flushes
__device__ __forceinline__ float floordiv_f32(float x, float y) {
  y = ftz(y);
  const float mod = ftz(fmodf(x, y));
  x = ftz(x);
  float div = ftz(__fdiv_rn(ftz(__fsub_rn(x, mod)), y));
  bool ind = (mod != 0.f) && (sign_f32(y) != sign_f32(mod));
  if (ind) div = ftz(__fsub_rn(div, 1.f));
  return round_away(div);
}

// jnp.remainder: XLA's rem is an exact fmod of the raw dividend by the
// flushed divisor, returned unflushed where no sum follows
__device__ __forceinline__ float mod_f32(float x, float y) {
  const float yz = ftz(y), t = fmodf(x, yz), tz = ftz(t);
  bool plus = ((tz < 0.f) != (yz < 0.f)) && (tz != 0.f);
  return plus ? ftz(__fadd_rn(tz, yz)) : t;
}

// A small-span int whitelist becomes a bitmap over [lo, lo + span) of at
// most kBitmapWords words (BITMAP_WORDS in predicate.py), built per block.
constexpr int kBitmapWords = 1024;

// a 32-bit load from shared memory (the pointer points there)
__device__ __forceinline__ uint32_t lds(const uint32_t* p) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"((uint32_t)__cvta_generic_to_shared(p)));
  return v;
}

// a 32-bit register pattern as a whitelist probe or entry of type T (a
// float flushed)
template <typename T>
__device__ __forceinline__ T probe(uint32_t x);
template <>
__device__ __forceinline__ int32_t probe<int32_t>(uint32_t x) { return (int32_t)x; }
template <>
__device__ __forceinline__ float probe<float>(uint32_t x) { return fz(x); }

// entry i of a table of T in shared memory (SHARED) or global memory
template <typename T, bool SHARED>
__device__ __forceinline__ T entry(const T* t, int i) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(t) + i;
  const uint32_t u = SHARED ? lds(p) : __ldg(p);
  return probe<T>(u);
}

// Membership of R probes in a sorted table of `len` entries: one
// branchless lower bound per probe, all R interleaved (the trip count
// depends on len alone); a member iff its lower-bound slot holds it.  T's
// `<` and `==` are the table's type's: a NaN probe is never equal.
template <int R, typename T, bool SHARED>
__device__ __forceinline__ void members(const T* t, int len, const uint32_t (&x)[R],
                                        uint32_t (&out)[R]) {
  T v[R];
  int base[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = probe<T>(x[r]);
    base[r] = 0;
  }
  for (int n = len; n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int r = 0; r < R; ++r)
      base[r] = entry<T, SHARED>(t, base[r] + half) < v[r] ? base[r] + half : base[r];
    n -= half;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int lb = base[r] + (len > 0 && entry<T, SHARED>(t, base[r]) < v[r] ? 1 : 0);
    out[r] = lb < len && entry<T, SHARED>(t, lb < len ? lb : 0) == v[r];
  }
}

// Membership of R int probes in the bitmap of [lo, lo + span)
template <int R>
__device__ __forceinline__ void bitmap_members(const uint32_t* bm, uint32_t lo, uint32_t span,
                                               const uint32_t (&x)[R], uint32_t (&out)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t d = x[r] - lo;
    const bool in = d < span;
    out[r] = in && ((lds(bm + (in ? d >> 5 : 0)) >> (d & 31)) & 1u);
  }
}

// L2 prefetch of the 16-byte aligned inside of [p, p + bytes): one bulk
// request, no registers, no completion to wait for
__device__ __forceinline__ void prefetch_l2(const void* p, long long bytes) {
  const uintptr_t a = ((uintptr_t)p + 15) & ~(uintptr_t)15;
  const uintptr_t e = ((uintptr_t)p + bytes) & ~(uintptr_t)15;
  if (e > a)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(a), "r"((uint32_t)(e - a))
                 : "memory");
}

// the rows [lo, hi) of every column the program loads, and their validity
// words: one thread a column
__device__ __forceinline__ void prefetch_rows(const PredArgs& s, const uint32_t* valid,
                                              long long lo, long long hi) {
  const int tid = threadIdx.x;
  if (tid < s.n_cols) prefetch_l2(s.cols[tid] + lo, 4 * (hi - lo));
  if (tid == kThreads - 1) prefetch_l2(valid + (lo >> 5), 4 * (((hi + 31) >> 5) - (lo >> 5)));
}

// One tile of R x kThreads rows: the program, instruction by instruction
// over all R rows of this thread, then the words.  FULL: the tile lies inside
// [0, n), so no row is tested against n.  Returns the set bits this
// thread's lane 0 counted.
template <int R, bool FULL>
__device__ __forceinline__ int run_tile(const PredArgs& s, const uint32_t* s_tab,
                                        const uint32_t* bm_lo, const uint32_t* bm_span,
                                        uint32_t* s_reg, int n_instr,
                                        const uint32_t* __restrict__ valid, long long n,
                                        long long tile, uint32_t* __restrict__ words) {
  constexpr int kTile = kThreads * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = tile * kTile + tid;
  const long long n_words = (n + 31) >> 5;
  // this warp's validity word of each of the R row groups
  const uint32_t* vrow = valid + tile * (kTile / 32) + warp;
  uint32_t vw[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long w = tile * (kTile / 32) + r * (kThreads / 32) + warp;
    vw[r] = FULL || w < n_words ? __ldg(vrow + r * (kThreads / 32)) : 0u;
  }
  uint32_t prev[R];
#pragma unroll
  for (int r = 0; r < R; ++r) prev[r] = 0u;
  for (int pc = 0; pc < n_instr; ++pc) {
    const Instr in = s.prog[pc];
    const int flags = in.flags;
    uint32_t x[R], y[R], out[R];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = y[r] = prev[r];
    if (flags & (kAUni | kBUni)) {
      const uint32_t u = flags & kUniLit ? s.lits[in.imm] : (uint32_t)in.imm;
      if (flags & kAUni) {
#pragma unroll
        for (int r = 0; r < R; ++r) x[r] = u;
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) y[r] = u;
      }
    }
    if (flags & kALoad) {
      const uint32_t* __restrict__ c = s.cols[in.col] + base;
#pragma unroll
      for (int r = 0; r < R; ++r)
        x[r] = FULL || base + r * kThreads < n ? __ldg(c + r * kThreads) : 0u;
    }
    if (flags & kASmem) {
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = s_reg[(in.a * R + r) * kThreads + tid];
    }
    if (flags & kBSmem) {
#pragma unroll
      for (int r = 0; r < R; ++r) y[r] = s_reg[(in.b * R + r) * kThreads + tid];
    }
#define PRED_EACH(expr)                               \
  _Pragma("unroll") for (int r = 0; r < R; ++r) { \
    const uint32_t a = x[r], b = y[r];                \
    (void)a;                                          \
    (void)b;                                          \
    out[r] = (expr);                                  \
  }
    switch (in.op) {
      case OP_LOAD: {
        const uint32_t* __restrict__ c = s.cols[in.imm] + base;
#pragma unroll
        for (int r = 0; r < R; ++r)
          out[r] = FULL || base + r * kThreads < n ? __ldg(c + r * kThreads) : 0u;
        break;
      }
      case OP_CONST: PRED_EACH((uint32_t)in.imm); break;
      case OP_LIT: {
        const uint32_t v = s.lits[in.imm];
        PRED_EACH(v);
        break;
      }
      case OP_CVT_I32_F32: PRED_EACH(f2u(__int2float_rn((int32_t)a))); break;
      case OP_ADD_I32: PRED_EACH(a + b); break;
      case OP_SUB_I32: PRED_EACH(a - b); break;
      case OP_MUL_I32: PRED_EACH(a * b); break;
      case OP_FLOORDIV_I32: PRED_EACH((uint32_t)floordiv_i32((int32_t)a, (int32_t)b)); break;
      case OP_MOD_I32: PRED_EACH((uint32_t)mod_i32((int32_t)a, (int32_t)b)); break;
      case OP_ADD_F32: PRED_EACH(f2u(ftz(__fadd_rn(fz(a), fz(b))))); break;
      case OP_SUB_F32: PRED_EACH(f2u(ftz(__fsub_rn(fz(a), fz(b))))); break;
      case OP_MUL_F32: PRED_EACH(f2u(ftz(__fmul_rn(fz(a), fz(b))))); break;
      case OP_FLOORDIV_F32: PRED_EACH(f2u(floordiv_f32(u2f(a), u2f(b)))); break;
      case OP_MOD_F32: PRED_EACH(f2u(mod_f32(u2f(a), u2f(b)))); break;
      case OP_CMP_EQ_I32: PRED_EACH((int32_t)a == (int32_t)b); break;
      case OP_CMP_NE_I32: PRED_EACH((int32_t)a != (int32_t)b); break;
      case OP_CMP_LT_I32: PRED_EACH((int32_t)a < (int32_t)b); break;
      case OP_CMP_LE_I32: PRED_EACH((int32_t)a <= (int32_t)b); break;
      case OP_CMP_GT_I32: PRED_EACH((int32_t)a > (int32_t)b); break;
      case OP_CMP_GE_I32: PRED_EACH((int32_t)a >= (int32_t)b); break;
      case OP_CMP_EQ_F32: PRED_EACH(fz(a) == fz(b)); break;
      case OP_CMP_NE_F32: PRED_EACH(fz(a) != fz(b)); break;
      case OP_CMP_LT_F32: PRED_EACH(fz(a) < fz(b)); break;
      case OP_CMP_LE_F32: PRED_EACH(fz(a) <= fz(b)); break;
      case OP_CMP_GT_F32: PRED_EACH(fz(a) > fz(b)); break;
      case OP_CMP_GE_F32: PRED_EACH(fz(a) >= fz(b)); break;
      case OP_AND: PRED_EACH(a & b); break;
      case OP_OR: PRED_EACH(a | b); break;
      case OP_NOT: PRED_EACH(a ^ 1u); break;
      case OP_ISNULL_I32: PRED_EACH((int32_t)a == NULL_INT); break;
      case OP_ISNULL_F32: PRED_EACH(u2f(a) != u2f(a)); break;
      case OP_ISIN_I32:
      case OP_ISIN_F32: {
        const int k = in.imm, len = s.table_len[k], off = s.table_off[k];
        const bool f32 = in.op == OP_ISIN_F32;
        if (!f32 && bm_span[k]) {
          bitmap_members<R>(s_tab + s.bitmap_off[k], bm_lo[k], bm_span[k], x, out);
        } else if (off >= 0) {
          if (f32)
            members<R, float, true>(reinterpret_cast<const float*>(s_tab + off), len, x, out);
          else
            members<R, int32_t, true>(reinterpret_cast<const int32_t*>(s_tab + off), len, x,
                                      out);
        } else {
          const uint32_t* g = s.tables[k];
          if (f32) members<R, float, false>(reinterpret_cast<const float*>(g), len, x, out);
          else members<R, int32_t, false>(reinterpret_cast<const int32_t*>(g), len, x, out);
        }
        break;
      }
      default: PRED_EACH(0u); break;
    }
#undef PRED_EACH
    if (flags & kNeg) {
#pragma unroll
      for (int r = 0; r < R; ++r) out[r] ^= 1u;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) prev[r] = out[r];
    if (flags & kStore) {
#pragma unroll
      for (int r = 0; r < R; ++r) s_reg[(in.dst * R + r) * kThreads + tid] = out[r];
    }
  }
  // the last instruction's result is the program's (the host checks it):
  // pack 32 rows a word, AND the validity word, lane r stores word r
  uint32_t mine = 0u;
  int counted = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool bit = prev[r] != 0u && (FULL || base + r * kThreads < n);
    const uint32_t word = __ballot_sync(kFull, bit) & vw[r];
    if (lane == 0) counted += __popc(word);
    if (lane == r) mine = word;
  }
  if (lane < R) {
    const long long w = tile * (kTile / 32) + lane * (kThreads / 32) + warp;
    if (FULL || w < n_words) words[w] = mine;
  }
  return counted;
}

// 3 blocks an SM: the 16-row kernel gets 80 registers and no spill (without
// the bound ptxas capped it at 64 registers and spilled)
template <int R>
__global__ void __launch_bounds__(kThreads, 3)
    predicate_kernel(const __grid_constant__ PredArgs args, const uint32_t* __restrict__ valid,
                     long long n, uint32_t* __restrict__ words, int* __restrict__ count) {
  extern __shared__ uint4 smem[];
  __shared__ int block_count;
  __shared__ uint32_t bm_lo[PRED_MAX_TABLES], bm_span[PRED_MAX_TABLES];
  const int tid = threadIdx.x, lane = tid & 31;

  // stage the argument (program, pointers, literals) once per block
  {
    const uint4* src = reinterpret_cast<const uint4*>(&args);
    for (int i = tid; i < (int)(sizeof(PredArgs) / 16); i += kThreads) smem[i] = src[i];
    if (tid == 0) block_count = 0;
  }
  __syncthreads();
  const PredArgs& s = *reinterpret_cast<const PredArgs*>(smem);
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(smem + sizeof(PredArgs) / 16);
  uint32_t* s_reg = s_tab + ((s.table_words + 3) & ~3);
  bool bitmaps = false;
  for (int k = 0; k < PRED_MAX_TABLES; ++k) {
    const int off = s.table_off[k];
    if (off < 0) continue;
    const uint32_t* t = s.tables[k];
    for (int i = tid; i < s.table_len[k]; i += kThreads) s_tab[off + i] = __ldg(t + i);
    bitmaps |= s.bitmap_off[k] >= 0;
  }
  if (tid < PRED_MAX_TABLES) bm_span[tid] = 0u;
  __syncthreads();
  if (bitmaps) {
    // a sorted int whitelist spanning at most 32 x kBitmapWords values (its
    // first and last entries are its min and max) becomes a bitmap
    for (int k = 0; k < PRED_MAX_TABLES; ++k) {
      const int bo = s.bitmap_off[k], len = s.table_len[k];
      if (bo < 0 || len <= 0) continue;
      const int32_t lo = (int32_t)s_tab[s.table_off[k]];
      const long long span = (long long)(int32_t)s_tab[s.table_off[k] + len - 1] - lo + 1;
      if (span > 32LL * kBitmapWords) continue;
      for (int i = tid; i < kBitmapWords; i += kThreads) s_tab[bo + i] = 0u;
      __syncthreads();
      for (int i = tid; i < len; i += kThreads) {
        const uint32_t d = s_tab[s.table_off[k] + i] - (uint32_t)lo;
        atomicOr(&s_tab[bo + (d >> 5)], 1u << (d & 31));
      }
      if (tid == 0) {
        bm_lo[k] = (uint32_t)lo;
        bm_span[k] = (uint32_t)span;
      }
      __syncthreads();
    }
  }

  const int n_instr = s.n_instr;
  constexpr int kTile = kThreads * R;
  const long long n_tiles = (n + kTile - 1) / kTile;
  int my_count = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // ask L2 for the next tile while this one runs
    const long long next = tile + gridDim.x;
    if (next < n_tiles)
      prefetch_rows(s, valid, next * kTile, min((next + 1) * kTile, n));
    if ((tile + 1) * kTile <= n)
      my_count +=
          run_tile<R, true>(s, s_tab, bm_lo, bm_span, s_reg, n_instr, valid, n, tile, words);
    else
      my_count +=
          run_tile<R, false>(s, s_tab, bm_lo, bm_span, s_reg, n_instr, valid, n, tile, words);
  }
  if (lane == 0 && my_count) atomicAdd(&block_count, my_count);
  __syncthreads();
  if (tid == 0 && block_count) atomicAdd(count, block_count);
}

// Blocks of the R-row kernel that fit on one SM with `smem_bytes` of
// dynamic shared memory, and the card's SM count; raises the kernel's
// dynamic shared-memory limit to the card's first.
template <int R>
int occupancy(int smem_bytes, int* blocks_per_sm, int* sm_count) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(predicate_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - 1024);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, predicate_kernel<R>,
                                                        kThreads, smem_bytes);
  return (int)err;
}

extern "C" int repro_predicate_occupancy(int rows, int smem_bytes, int* blocks_per_sm,
                                         int* sm_count) {
  if (rows == kWideRows) return occupancy<kWideRows>(smem_bytes, blocks_per_sm, sm_count);
  if (rows == kNarrowRows) return occupancy<kNarrowRows>(smem_bytes, blocks_per_sm, sm_count);
  return (int)cudaErrorInvalidValue;
}

// rows, grid and smem_bytes come from plan_predicate_launch; the program's
// slots, flags and whitelist offsets are in args
extern "C" int repro_predicate_bitset(const PredArgs* args, const uint32_t* valid, long long n,
                                      int rows, int grid, int smem_bytes, uint32_t* words,
                                      int* count, void* stream) {
  if (n <= 0 || grid <= 0 || args->n_instr <= 0 || args->n_instr > PRED_MAX_INSTR)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows == kWideRows)
    predicate_kernel<kWideRows><<<grid, kThreads, smem_bytes, st>>>(*args, valid, n, words, count);
  else if (rows == kNarrowRows)
    predicate_kernel<kNarrowRows><<<grid, kThreads, smem_bytes, st>>>(*args, valid, n, words,
                                                                      count);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
