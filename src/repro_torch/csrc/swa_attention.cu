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
// Given an lse buffer (the training forward's), both kernels also write each
// row's log-sum-exp of the scaled scores, natural log, 0 for a row with no
// visible key: the backward (csrc/swa_backward*.cu) reads it.
//
// Routes.  bf16 prefill runs csrc/swa_prefill.cu (TMA, wgmma, warp
// specialisation; repro_flash_prefill_bf16); calls with group * Sq <= 16 rows
// per KV head never reach this file (csrc/swa_decode.cu).  This file holds
// the fp32 kernel and the one C entry point.
//
// Design (fp32): one CUDA block per (batch, KV head, tile of 16 query rows).
// The rows of a tile are (query position, head of the KV head's group)
// pairs, position-major, so the whole GQA group shares each staged KV tile.
// The block loops over 32-key tiles in dynamic shared memory from the first
// key any of its rows can see (window) to the last (causal, kv_len) and
// skips the rest, as the Pallas kernel's cull does; the loop takes the place
// of the Pallas grid's sequential KV axis.  Full fp32 on the CUDA cores, no
// TF32 (the 2e-5 gate is against fp32): 4 warps of 4 rows; lane j scores
// key j, the warp reduces max and sum with shuffles, and each lane
// accumulates output columns d = lane + 32 i (an online softmax per row).
// The tiles take 16 D + 32 (2 D + 1) floats, 81 KB at D = 256, past the
// 48 KB of static shared memory.
//
// Bound: operations, 4 D flops per visible (query, key) pair and query
// head, at the 67 TFLOP/s of fp32 outside the tensor cores.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // score of a hidden key (never exponentiated)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kBM = 16, kBK = 32;  // query rows and keys a tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  long long q_offset;
  long long rows;  // group * Sq rows per (batch, KV head)
  int Hkv, group, causal, window, kv_len;
  float scale;  // D ** -0.5
  float* lse;   // (B, Hq, Sq) fp32, each row's log-sum-exp; null: not kept
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
constexpr size_t f32_smem() {  // Qs[kBM][D], Ks[kBK][D + 1], Vs[kBK][D]
  return sizeof(float) * (kBM * D + kBK * (D + 1) + kBK * D);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_f32(const Args a) {
  constexpr int BM = kBM, BK = kBK, RPW = 4, DV = (D + 31) / 32;
  extern __shared__ float smem[];
  float(*Qs)[D] = reinterpret_cast<float(*)[D]>(smem);
  // Ks rows padded by one: lane j reads row j without bank conflicts
  float(*Ks)[D + 1] = reinterpret_cast<float(*)[D + 1]>(smem + BM * D);
  float(*Vs)[D] = reinterpret_cast<float(*)[D]>(smem + BM * D + BK * (D + 1));

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
    // the row's log-sum-exp for the backward, 0 for a row with no visible key
    if (a.lse != nullptr && lane == 0)
      a.lse[((long long)b * a.Hkv * a.group + head) * (a.rows / a.group) + r / a.group] =
          l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
#pragma unroll
    for (int jj = 0; jj < DV; ++jj) {
      const int d = lane + 32 * jj;
      if (d < D) orow[d] = l[i] > 0.f ? acc[i][jj] / l[i] : 0.f;
    }
  }
}

template <int D>
int launch_f32(const Args& a, int n_bh, cudaStream_t st) {
  constexpr size_t bytes = f32_smem<D>();
  static const cudaError_t attr =
      bytes > 48 * 1024 ? cudaFuncSetAttribute(flash_f32<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bytes)
                        : cudaSuccess;
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((a.rows + kBM - 1) / kBM), (unsigned)n_bh);
  flash_f32<D><<<grid, kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_flash_prefill_bf16(const void* q, const void* k, const void* v, void* o,
                                        long long sqb, long long sqh, long long sqs,
                                        long long skb, long long skh, long long sks,
                                        long long svb, long long svh, long long svs,
                                        long long sob, long long soh, long long sos, int B,
                                        int Hq, int Hkv, int Sq, int D, int causal,
                                        int window, long long q_offset, int kv_len,
                                        float* lse, void* stream);

// q, k, v, o: element strides (b, h, s) each, unit stride on d; bf16 operands
// 16-byte aligned with strides that are multiples of 8 elements (TMA).  lse:
// null, or (B, Hq, Sq) fp32 that receives each row's log-sum-exp (natural
// log; 0 for a row with no visible key) for the backward.  Returns the
// launch error (0 when launched).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long sqb,
    long long sqh, long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, long long sob, long long soh,
    long long sos, int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
    int window, long long q_offset, int kv_len, int is_bf16, float* lse, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || kv_len < 0 || kv_len > Skv || window < 0 ||
      (long long)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return repro_flash_prefill_bf16(q, k, v, o, sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob,
                                    soh, sos, B, Hq, Hkv, Sq, D, causal, window, q_offset,
                                    kv_len, lse, stream);
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
  a.scale = (float)(1.0 / sqrt((double)D));
  a.lse = lse;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_bh = B * Hkv;
  switch (D) {
    case 16: return launch_f32<16>(a, n_bh, st);
    case 32: return launch_f32<32>(a, n_bh, st);
    case 64: return launch_f32<64>(a, n_bh, st);
    case 80: return launch_f32<80>(a, n_bh, st);
    case 96: return launch_f32<96>(a, n_bh, st);
    case 128: return launch_f32<128>(a, n_bh, st);
    case 240: return launch_f32<240>(a, n_bh, st);
    case 256: return launch_f32<256>(a, n_bh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
