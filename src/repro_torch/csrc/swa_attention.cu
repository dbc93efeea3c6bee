// B6: flash attention forward with GQA, causal and sliding-window masks, a
// decode offset and KV-length masking, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/swa_attention.py:
// flash_swa_attention (pallas_call at :137; wrapper repro/kernels/ops.py:117).
//
// Semantics, which the Pallas kernel fixes and the plain version in
// kernels/swa_attention.py repeats: q is (B, Hq, Sq, D), k and v are
// (B, Hkv, Skv, D), each given by element strides for its b, h and s axes
// (unit stride on d), so the model's (B, S, H, D) tensors and KV caches go in
// without a copy.  Query row i of head h sits at position q_offset + i and
// reads KV head h / (Hq / Hkv); key j is visible when j < kv_len, j <= qpos
// (causal) and j > qpos - window (window > 0).  Scores are scaled by D**-0.5,
// the softmax and both sums run in fp32, the output is in the input type,
// and a row with no visible key is 0.  q_offset and kv_len are runtime
// arguments (static in Pallas), so one build serves every decode step.
//
// Design: one CUDA block per (batch, KV head, tile of query rows).  The rows
// of a tile are (query position, head of the KV head's group) pairs,
// position-major, so the whole GQA group shares each staged KV tile: in
// decode (Sq = 1) h2o-danube's four query heads of a KV head are one block
// and each KV byte is read once per group.  The block loops over KV tiles in
// shared memory from the first key any of its rows can see (window) to the
// last (causal, kv_len) and skips the rest, as the Pallas kernel's cull does;
// the loop takes the place of the Pallas grid's sequential KV axis.  Each row
// keeps its running max, sum and output in registers (online softmax).
//   bf16: 4 warps of 16 rows (a 64-row tile), 64-key tiles; both products
//   are mma.sync m16n8k16 with fp32 accumulation: Q fragments in registers,
//   the K tile row-major in shared memory (rows padded by 8 elements, so the
//   fragment loads hit distinct banks), P re-packed from the score
//   accumulators as the A operand, V read from shared memory as the B
//   operand.  P is rounded to bf16 for the second product, as FlashAttention
//   does; the running sum uses the fp32 P.
//   fp32: full fp32 on the CUDA cores, no TF32: 4 warps of 4 rows (a 16-row
//   tile), 32-key tiles; lane j scores key j, the warp reduces max and sum
//   with shuffles, and each lane accumulates output columns d = lane + 32 i.
//
// Bound: operations in prefill, bytes in decode.  4 D flops per visible
// (query, key) pair and query head: h2o-danube's prefill at B = 2, S = 8,192,
// window 4,096 needs 0.52 ms at 989 TFLOP/s.  Decode reads each visible K/V
// row once: a full 4,096-slot ring at 4 slots is 42 MB, 0.013 ms at
// 3.35 TB/s.  This first version is simple: no TMA, no wgmma, no warp
// specialisation, the next tile's loads are not overlapped with the current
// tile's products, and decode does not split the KV axis across blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // score of a hidden key (never exponentiated)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  long long q_offset;
  long long rows;  // group * Sq rows per (batch, KV head)
  int Hkv, group, causal, window, kv_len;
  float scale;       // D ** -0.5
  float scale_log2;  // D ** -0.5 * log2(e), for exp2f
};

__device__ __forceinline__ bool visible(int key, long long qpos, const Args& a) {
  if (key >= a.kv_len) return false;
  if (a.causal && key > qpos) return false;
  if (a.window > 0 && (long long)key <= qpos - a.window) return false;
  return true;
}

// Keys [*begin, *end) that any of the rows [r0, r1) can see; empty when
// *end <= *begin.
__device__ __forceinline__ void key_range(const Args& a, long long r0, long long r1,
                                          long long* begin, long long* end) {
  const long long q_lo = a.q_offset + r0 / a.group;
  const long long q_hi = a.q_offset + (r1 - 1) / a.group;
  long long b = 0;
  if (a.window > 0) b = max(0LL, q_lo - a.window + 1);
  long long e = a.kv_len;
  if (a.causal) e = min(e, q_hi + 1);
  *begin = b;
  *end = e;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, fp32 accumulation
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bits(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bf16(const Args a) {
  constexpr int BM = 64, BK = 64;
  constexpr int KS = D + 8;  // row stride of the staged tiles, in elements
  constexpr int KK = D / 16, NT = BK / 8, ND = D / 8, CH = D / 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * KS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK * KS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const long long r0 = (long long)blockIdx.x * BM;
  const long long r1 = min(r0 + BM, a.rows);
  const bool warp_active = r0 + warp * 16 < a.rows;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o);
  const __nv_bfloat16* kbase =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.skb + kvh * a.skh;
  const __nv_bfloat16* vbase =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.svb + kvh * a.svh;

  // this thread's two rows: g and g + 8 of its warp's 16
  bool rvalid[2];
  long long qpos[2];
  const __nv_bfloat16* qrow[2];
  __nv_bfloat16* orow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long r = r0 + warp * 16 + g + 8 * i;
    rvalid[i] = r < a.rows;
    const long long rr = rvalid[i] ? r : r0;  // a hidden row reads row r0
    const long long qi = rr / a.group;
    const long long head = (long long)kvh * a.group + rr % a.group;
    qpos[i] = a.q_offset + qi;
    qrow[i] = q + b * a.sqb + head * a.sqh + qi * a.sqs;
    orow[i] = o + b * a.sob + head * a.soh + qi * a.sos;
  }

  uint32_t qf[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const int d = kk * 16 + t4 * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(qrow[0] + d);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(qrow[1] + d);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(qrow[0] + d + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(qrow[1] + d + 8);
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  long long kb, ke;
  key_range(a, r0, r1, &kb, &ke);
  const int t_begin = (int)(kb / BK);
  const int t_end = ke > kb ? (int)((ke + BK - 1) / BK) : t_begin;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < BK * CH; c += kThreads) {
      const int row = c / CH, col = (c % CH) * 8;
      const int key = k0 + row;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (key < a.kv_len) {
        kx = *reinterpret_cast<const uint4*>(kbase + (long long)key * a.sks + col);
        vx = *reinterpret_cast<const uint4*>(vbase + (long long)key * a.svs + col);
      }
      *reinterpret_cast<uint4*>(&Ks[row * KS + col]) = kx;
      *reinterpret_cast<uint4*>(&Vs[row * KS + col]) = vx;
    }
    __syncthreads();
    if (!warp_active) continue;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kp = &Ks[(nt * 8 + g) * KS + kk * 16 + t4 * 2];
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // mask, scale (log2 domain) and the row maxima over the quad
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const int key = k0 + nt * 8 + t4 * 2 + (c & 1);
        const float x = visible(key, qpos[i], a) ? s[nt][c] * a.scale_log2 : kMasked;
        s[nt][c] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float mnew[2], alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      mnew[i] = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - mnew[i]);
      m[i] = mnew[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const float p = s[nt][c] == kMasked ? 0.f : exp2f(s[nt][c] - mnew[i]);
        s[nt][c] = p;
        ls[i] += p;
      }
    }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // O += P V: the score accumulators of key tiles 2j and 2j+1 are the A
    // fragment of the j-th 16-key step
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int key = j * 16 + t4 * 2;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int col = nd * 8 + g;
        const uint32_t b0 = pack_bits(Vs[key * KS + col], Vs[(key + 1) * KS + col]);
        const uint32_t b1 =
            pack_bits(Vs[(key + 8) * KS + col], Vs[(key + 9) * KS + col]);
        mma_bf16(acc[nd], pa, b0, b1);
      }
    }
  }

  if (!warp_active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + t4 * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!rvalid[i]) continue;
      const float x0 = l[i] > 0.f ? acc[nd][2 * i] / l[i] : 0.f;
      const float x1 = l[i] > 0.f ? acc[nd][2 * i + 1] / l[i] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow[i] + col) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_f32(const Args a) {
  constexpr int BM = 16, BK = 32, RPW = 4, DV = (D + 31) / 32;
  __shared__ float Qs[BM][D];
  __shared__ float Ks[BK][D + 1];  // +1: lane j reads row j without conflicts
  __shared__ float Vs[BK][D];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const long long r0 = (long long)blockIdx.x * BM;
  const long long r1 = min(r0 + BM, a.rows);
  const float* q = static_cast<const float*>(a.q);
  float* o = static_cast<float*>(a.o);
  const float* kbase = static_cast<const float*>(a.k) + b * a.skb + kvh * a.skh;
  const float* vbase = static_cast<const float*>(a.v) + b * a.svb + kvh * a.svh;

  for (int c = tid; c < BM * D; c += kThreads) {
    const int rr = c / D, d = c % D;
    const long long r = r0 + rr;
    float x = 0.f;
    if (r < a.rows) {
      const long long head = (long long)kvh * a.group + r % a.group;
      x = q[b * a.sqb + head * a.sqh + (r / a.group) * a.sqs + d];
    }
    Qs[rr][d] = x;
  }

  bool rvalid[RPW];
  long long qpos[RPW];
  float m[RPW], l[RPW], acc[RPW][DV];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const long long r = r0 + warp * RPW + i;
    rvalid[i] = r < a.rows;
    qpos[i] = a.q_offset + (rvalid[i] ? r / a.group : 0);
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DV; ++j) acc[i][j] = 0.f;
  }

  long long kb, ke;
  key_range(a, r0, r1, &kb, &ke);
  const int t_begin = (int)(kb / BK);
  const int t_end = ke > kb ? (int)((ke + BK - 1) / BK) : t_begin;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // Qs is written / the previous tile is consumed
    for (int c = tid; c < BK * D; c += kThreads) {
      const int row = c / D, d = c % D;
      const int key = k0 + row;
      float kx = 0.f, vx = 0.f;
      if (key < a.kv_len) {
        kx = kbase[(long long)key * a.sks + d];
        vx = vbase[(long long)key * a.svs + d];
      }
      Ks[row][d] = kx;
      Vs[row][d] = vx;
    }
    __syncthreads();
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (!rvalid[i]) continue;  // uniform across the warp
      const float* qr = Qs[warp * RPW + i];
      float sc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) sc = fmaf(qr[d], Ks[lane][d], sc);
      const bool vis = visible(key, qpos[i], a);
      const float x = vis ? sc * a.scale : kMasked;
      const float mnew = fmaxf(m[i], warp_max(x));
      const float p = vis ? expf(x - mnew) : 0.f;
      const float alpha = expf(m[i] - mnew);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = mnew;
#pragma unroll
      for (int j = 0; j < DV; ++j) acc[i][j] *= alpha;
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int jj = 0; jj < DV; ++jj) {
          const int d = lane + 32 * jj;
          if (d < D) acc[i][jj] = fmaf(pj, Vs[j][d], acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (!rvalid[i]) continue;
    const long long r = r0 + warp * RPW + i;
    const long long head = (long long)kvh * a.group + r % a.group;
    float* orow = o + b * a.sob + head * a.soh + (r / a.group) * a.sos;
#pragma unroll
    for (int jj = 0; jj < DV; ++jj) {
      const int d = lane + 32 * jj;
      if (d < D) orow[d] = l[i] > 0.f ? acc[i][jj] / l[i] : 0.f;
    }
  }
}

template <int D>
int launch(const Args& a, int n_bh, int is_bf16, cudaStream_t st) {
  if (is_bf16) {
    const dim3 grid((unsigned)((a.rows + 63) / 64), (unsigned)n_bh);
    flash_bf16<D><<<grid, kThreads, 0, st>>>(a);
  } else {
    const dim3 grid((unsigned)((a.rows + 15) / 16), (unsigned)n_bh);
    flash_f32<D><<<grid, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: element strides (b, h, s) each, unit stride on d; bf16 operands
// 16-byte aligned at every row.  Returns the launch error (0 when launched).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long sqb,
    long long sqh, long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, long long sob, long long soh,
    long long sos, int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
    int window, long long q_offset, int kv_len, int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || kv_len < 0 || kv_len > Skv || window < 0 ||
      (long long)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.sqb = sqb; a.sqh = sqh; a.sqs = sqs;
  a.skb = skb; a.skh = skh; a.sks = sks;
  a.svb = svb; a.svh = svh; a.svs = svs;
  a.sob = sob; a.soh = soh; a.sos = sos;
  a.q_offset = q_offset;
  a.Hkv = Hkv;
  a.group = Hq / Hkv;
  a.rows = (long long)a.group * Sq;
  a.causal = causal;
  a.window = window;
  a.kv_len = kv_len;
  const double scale = 1.0 / sqrt((double)D);
  a.scale = (float)scale;
  a.scale_log2 = (float)(scale * 1.4426950408889634);
  cudaStream_t st = (cudaStream_t)stream;
  const int n_bh = B * Hkv;
  switch (D) {
    case 16: return launch<16>(a, n_bh, is_bf16, st);
    case 32: return launch<32>(a, n_bh, is_bf16, st);
    case 64: return launch<64>(a, n_bh, is_bf16, st);
    case 80: return launch<80>(a, n_bh, is_bf16, st);
    case 128: return launch<128>(a, n_bh, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
