// Building blocks of B6's fp32 kernels on the CUDA cores (no tensor cores,
// no TF32: the fp32 gates hold them against full fp32 products and sums),
// csrc/swa_attention.cu (the forward, flash_f32) and csrc/swa_backward.cu
// (bwd_dq, bwd_dkdv): their tile plans, the cp.async loads of their tiles
// and their register-blocked products.
//
// A block is 128 threads, 16 row groups (rg = tid / 8) by 8 key (or column)
// groups (kg = tid % 8); a warp holds 4 row groups by the 8 key groups.
// A score tile of TM x KN a thread covers BM = 16 TM query rows by BN = 8 KN
// keys; thread (rg, kg) owns rows rg * 4 + 64 h + e (h < TM / 4, e < 4) and
// keys kg * 4 + 32 h + e (h < KN / 4).  Operands of a score product are
// stored d-major (T[d][row], rows of a d in a line of BM + 4 or BN + 4
// floats), so each d step reads a thread's rows and keys as 16-byte loads
// that a warp takes in one pass (4 or 8 consecutive float4s), and a TM x KN
// micro-tile does TM KN FMAs for TM + KN floats read (2.67 at 8 x 4 and
// 4 x 8).  Lines of 4 (mod 32) floats keep the transposing loads free of bank
// conflicts.  The tiles are as large as two blocks an SM allow: in fp32,
// shared memory bounds them more than registers do.
//
// Every definition sits in an anonymous namespace: each file that includes
// this header gets its own copy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32Threads = 128;  // 16 row groups x 8 key groups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = -1e30f;  // log2-domain score of a hidden key
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may take (sm_90)
constexpr int kSmemPerSM = 233472; // an SM's shared memory, 1 KB of it reserved a block

// Blocks an SM holds with `bytes` of shared memory each (at most 2: a
// third would cap the registers at 168 a thread): the occupancy each kernel
// asks of ptxas (__launch_bounds__), so that its registers leave room for as
// many blocks as its tiles do.
constexpr int blocks_per_sm(size_t bytes) {
  return kSmemPerSM / (int)(bytes + 1024) < 2 ? kSmemPerSM / (int)(bytes + 1024) : 2;
}

// Tile plans.  BM query rows by BN keys per score tile.  Each kernel asks
// ptxas for as many blocks an SM as its shared memory allows
// (__launch_bounds__(128, BLOCKS)), and takes a two-stage cp.async ring of
// the tiles it walks unless the second stage would cost a block an SM: then
// the two or three blocks on an SM overlap one block's copies with another's
// products instead.  kernels/swa_attention.py repeats the tile sizes
// (f32_forward_tiles, f32_backward_tiles) and reads them back through
// repro_flash_f32_tiles.
template <int FLOATS1, int FLOATS2>  // shared floats with one stage, with two
struct Stages {
  static constexpr int STAGES =
      blocks_per_sm(sizeof(float) * FLOATS2) >= blocks_per_sm(sizeof(float) * FLOATS1) ? 2 : 1;
  static constexpr int FLOATS = STAGES == 2 ? FLOATS2 : FLOATS1;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
  static constexpr int BLOCKS = blocks_per_sm(BYTES);
};

// The forward: one block per BM rows; Q resident d-major, K d-major and V
// key-major streamed in BN-key tiles; P goes through shared memory
// (Ps[key][row]) from the score product to the P V product.  8 x 4
// micro-tiles up to D = 96 (128 rows by 32 keys: two blocks an SM), 4 x 4
// above.
template <int D>
struct FwdCfg {
  static constexpr int TM = D >= 128 ? 4 : 8, KN = 4;
  static constexpr int BM = 16 * TM, BN = 8 * KN, LQ = BM + 4, LK = BN + 4;
  static constexpr int fixed = D * LQ + BN * LQ, stage = D * LK + BN * D;
  using St = Stages<fixed + stage, fixed + 2 * stage>;
  static constexpr int STAGES = St::STAGES, BLOCKS = St::BLOCKS;
  static constexpr size_t BYTES = St::BYTES;
  static constexpr int Q = 0, P = Q + D * LQ, K = P + BN * LQ, V = K + STAGES * D * LK;
  static_assert(BYTES <= kMaxSmem, "flash_f32 tiles exceed shared memory");
};

// The dq launch: one block per BM rows; Q and dout resident d-major, K and
// V d-major streamed in BN-key tiles; dS in Ss[key][row]; each row's
// log2-domain LSE and Delta in Ls, Ds.  4 x 8 micro-tiles up to D = 80 (64
// rows by 64 keys), 4 x 4 above.
template <int D>
struct DqCfg {
  static constexpr int TM = 4, KN = D >= 96 ? 4 : 8;
  static constexpr int BM = 16 * TM, BN = 8 * KN, LQ = BM + 4, LK = BN + 4;
  static constexpr int fixed = 2 * D * LQ + BN * LQ + 2 * BM, stage = 2 * D * LK;
  using St = Stages<fixed + stage, fixed + 2 * stage>;
  static constexpr int STAGES = St::STAGES, BLOCKS = St::BLOCKS;
  static constexpr size_t BYTES = St::BYTES;
  static constexpr int Q = 0, G = Q + D * LQ, S = G + D * LQ, L = S + BN * LQ, DL = L + BM;
  static constexpr int K = DL + BM, V = K + STAGES * D * LK;
  static_assert(BYTES <= kMaxSmem, "bwd_dq tiles exceed shared memory");
};

// The dkdv launch: one block per BN keys; K and V resident d-major, Q and
// dout d-major streamed in BM-row tiles with their rows' LSE and Delta; P,
// then dS, in PSs[row][key].  dK, dV: thread (rg, kg) owns its KN keys by
// the D / 16 columns rg + 16 c.  4 x 8 micro-tiles up to D = 96 (64 keys by
// 64-row tiles), 4 x 4 above.
template <int D>
struct KvCfg {
  static constexpr int TM = 4, KN = D >= 128 ? 4 : 8;
  static constexpr int BM = 16 * TM, BN = 8 * KN, LQ = BM + 4, LK = BN + 4;
  static constexpr int fixed = 2 * D * LK + BM * LK, stage = 2 * D * LQ + 2 * BM;
  using St = Stages<fixed + stage, fixed + 2 * stage>;
  static constexpr int STAGES = St::STAGES, BLOCKS = St::BLOCKS;
  static constexpr size_t BYTES = St::BYTES;
  static constexpr int K = 0, V = K + D * LK, P = V + D * LK, Q = P + BM * LK;
  static constexpr int G = Q + STAGES * D * LQ, L = G + STAGES * D * LQ, DL = L + STAGES * BM;
  static_assert(BYTES <= kMaxSmem, "bwd_dkdv tiles exceed shared memory");
};

// Row r of a KV head's rows (position r / group of head kvh * group + r %
// group): its offset past the batch in a (B, H, S, D) tensor with strides
// (sh, ss), and its index in the (B, Hq, Sq) log-sum-exp.
__device__ __forceinline__ long long row_offset(long long r, int kvh, int group, long long sh,
                                                long long ss) {
  return ((long long)kvh * group + r % group) * sh + (r / group) * ss;
}
__device__ __forceinline__ long long lse_offset(long long r, int b, int kvh, int Hkv, int group,
                                                long long Sq) {
  return (((long long)b * Hkv + kvh) * group + r % group) * Sq + r / group;
}

// ---------------------------------------------------------------------------
// cp.async: 4-byte copies (any fp32 stride), zero-filled when !pred
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp4(float* dst, const float* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0));
}
// 16-byte copies (16-byte aligned rows), zero-filled when !pred
__device__ __forceinline__ void cp16(float* dst, const float* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ROWS rows (keys or query rows) of D floats into T[d][row] (lines of LD
// floats): rows at or past `valid` are zero-filled, row r starts at
// base + off(r).  Warp w copies the row quads w + 4 m, a pass at a time 8 d
// by 4 rows (lanes d-fastest: 32-byte global sectors, and with LD = 4 mod 32
// the 32 stores hit 32 banks); off() runs once per row.
template <int D, int ROWS, int LD, typename Off>
__device__ __forceinline__ void load_dmajor(float* T, const float* base, int valid, Off off) {
  static_assert(ROWS % 16 == 0 && D % 8 == 0 && LD % 32 == 4, "load_dmajor tiling");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dd = lane & 7, rr = lane >> 3;
#pragma unroll
  for (int m = 0; m < ROWS / 16; ++m) {
    const int row = 4 * (warp + 4 * m) + rr;
    const bool ok = row < valid;
    const float* src = base + (ok ? off(row) : 0) + dd;
    float* dst = T + dd * LD + row;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) cp4(dst + 8 * c * LD, src + 8 * c, ok);
  }
}

// ROWS rows of D floats into T[row][d] (key-major), as load_dmajor; a warp
// a row, in 16-byte copies when every row is 16-byte aligned (vec16).
template <int D, int ROWS, typename Off>
__device__ __forceinline__ void load_rowmajor(float* T, const float* base, int valid, bool vec16,
                                              Off off) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int row = warp; row < ROWS; row += 4) {
    const bool ok = row < valid;
    const float* src = base + (ok ? off(row) : 0);
    if (vec16) {
#pragma unroll
      for (int d = 4 * lane; d < D; d += 128) cp16(T + row * D + d, src + d, ok);
    } else {
#pragma unroll
      for (int d = lane; d < D; d += 32) cp4(T + row * D + d, src + d, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// register-blocked products
// ---------------------------------------------------------------------------
// The N floats a thread owns of line `p` (N of 4 or 8: 4 at p[0..3], and
// 4 more at p[STRIDE..] when N is 8), as 16-byte loads.
template <int N, int STRIDE>
__device__ __forceinline__ void load_owned(float (&x)[N], const float* p) {
#pragma unroll
  for (int h = 0; h < N / 4; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(p + STRIDE * h);
    x[4 * h] = v.x, x[4 * h + 1] = v.y, x[4 * h + 2] = v.z, x[4 * h + 3] = v.w;
  }
}

// acc[i][j] += sum_d A[d][row i] B[d][key j]: the thread's TM rows and KN
// keys of two d-major tiles (lines LA, LB).
template <int D, int TM, int KN, int LA, int LB>
__device__ __forceinline__ void score_product(float (&acc)[TM][KN], const float* A,
                                              const float* B, int rg, int kg) {
  const float* a = A + 4 * rg;
  const float* b = B + 4 * kg;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[TM], y[KN];
    load_owned<TM, 64>(x, a + d * LA);
    load_owned<KN, 32>(y, b + d * LB);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

template <int TM, int KN>
__device__ __forceinline__ void zero(float (&acc)[TM][KN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < KN; ++j) acc[i][j] = 0.f;
}

// A row's visible keys [lo, hi] as ints (empty: lo > hi): position qpos,
// masks of the call.  kv_len bounds both ends, so they fit an int.
__device__ __forceinline__ void row_keys(long long qpos, int causal, int window, int kv_len,
                                         int* lo, int* hi) {
  long long l = window > 0 ? qpos - window + 1 : 0;
  long long h = causal ? qpos : (long long)kv_len - 1;
  l = l < 0 ? 0 : (l > kv_len ? kv_len : l);
  h = h >= kv_len ? kv_len - 1 : (h < -1 ? -1 : h);
  *lo = (int)l;
  *hi = (int)h;
}

// Max and sum over the 8 key groups of a row group (lanes xor 1, 2, 4).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace
