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
// Design (fp32, flash_f32): one block of 128 threads per (batch, KV head,
// tile of BM query rows).  The rows of a tile are (query position, head of
// the KV head's group) pairs, position-major, so the whole GQA group shares
// each staged K/V tile.  The block walks the BN-key tiles from the first key
// any of its rows can see (window) to the last (causal, kv_len), as the
// Pallas kernel's cull does; the loop takes the place of the Pallas grid's
// sequential KV axis.  Full fp32 on the CUDA cores, no TF32 (the 2e-5 gate is
// against fp32).  csrc/simt_f32.cuh holds the tiles and products:
//   - Q stays in shared memory d-major; K (d-major) and V (key-major, in
//     16-byte copies where its rows are 16-byte aligned) tiles come through
//     a two-stage cp.async ring, the next tile's copies in flight while the
//     block computes on the current one (one stage at D = 96, where a second
//     would cost a block an SM: the other block covers the copies).
//   - S = Q K^T: each thread a TM x KN register micro-tile, 8 x 4 up to
//     D = 96 (32 FMAs for three 16-byte loads a d step).
//   - An online softmax a row, in the log2 domain (ex2.approx of the
//     scores scaled by D**-0.5 log2 e): the row's max over its 8 key groups
//     by shuffles, each thread's share of the row's sum kept apart until
//     the end.  P goes to shared memory, key-major.
//   - O += P V: each thread TM rows by D / 8 columns, reading P's rows and
//     V's columns as 16- or 8-byte loads (80 FMAs for 18 floats at D = 80).
//   - Tiles of class kFullTile (hopper.cuh's tile_class) evaluate no mask;
//     only kEdge tiles (the causal diagonal, the window's edge, kv_len) do.
// Tiles (FwdCfg): BM = 128 rows by BN = 32 keys up to D = 96 (100 KB of
// shared memory at D = 80, two blocks an SM, 205 registers), 64 by 32 from
// D = 128 on (O's registers; one block an SM above 128).
//
// Bound: operations, 4 D flops per visible (query, key) pair and query
// head, at the 67 TFLOP/s of fp32 outside the tensor cores.  At danube's
// training shape (2 x 32 x 8,192 x 80, window 4,096) it reaches about half
// of it (PERF.md); the first design (16-row blocks, a key a lane, scalar
// shared loads) reached an eighth.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "simt_f32.cuh"

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  long long q_offset;
  long long rows;  // group * Sq rows per (batch, KV head)
  int Hkv, group, causal, window, kv_len;
  int vec16;         // v's rows 16-byte aligned: 16-byte copies
  float scale_log2;  // D ** -0.5 * log2(e)
  float* lse;        // (B, Hq, Sq) fp32, each row's log-sum-exp; null: not kept
};

template <int D>
__global__ void __launch_bounds__(kF32Threads, FwdCfg<D>::BLOCKS) flash_f32(const Args a) {
  using C = FwdCfg<D>;
  constexpr int TM = C::TM, KN = C::KN, BM = C::BM, BN = C::BN;
  constexpr int NC = D / 8, VW = NC % 4 == 0 ? 4 : 2;  // O columns a thread, vector width
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem + C::Q;
  float* Ps = smem + C::P;

  const int tid = threadIdx.x, rg = tid >> 3, kg = tid & 7;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const long long r0 = (long long)blockIdx.x * BM;
  const long long r1 = min(r0 + BM, a.rows);
  const float* kbase = static_cast<const float*>(a.k) + b * a.skb + kvh * a.skh;
  const float* vbase = static_cast<const float*>(a.v) + b * a.svb + kvh * a.svh;

  load_dmajor<D, BM, C::LQ>(Qt, static_cast<const float*>(a.q) + b * a.sqb, (int)(r1 - r0),
                            [&](int l) { return row_offset(r0 + l, kvh, a.group, a.sqh, a.sqs); });
  cp_commit();

  const long long qlo = a.q_offset + r0 / a.group, qhi = a.q_offset + (r1 - 1) / a.group;
  long long kb, ke;
  visible_keys(a.causal, a.window, a.kv_len, qlo, qhi, &kb, &ke);
  const int t_begin = (int)(kb / BN);
  const int t_end = ke > kb ? (int)((ke + BN - 1) / BN) : t_begin;
  auto stage = [&](int t) {  // keys [t BN, t BN + BN) into ring slot t % STAGES
    const int k0 = t * BN, n = min(BN, a.kv_len - k0), slot = t % C::STAGES;
    load_dmajor<D, BN, C::LK>(smem + C::K + slot * D * C::LK, kbase, n,
                              [&](int j) { return (long long)(k0 + j) * a.sks; });
    load_rowmajor<D, BN>(smem + C::V + slot * BN * D, vbase, n, a.vec16,
                         [&](int j) { return (long long)(k0 + j) * a.svs; });
  };
  if (C::STAGES > 1 && t_begin < t_end) stage(t_begin);
  cp_commit();

  float o[TM][NC], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    if (C::STAGES == 1) {
      __syncthreads();  // the previous tile is consumed
      stage(t);
      cp_commit();
    }
    cp_wait<0>();
    __syncthreads();  // tile t (and Q) landed; tile t - 1's slot and Ps are free
    if (C::STAGES > 1 && t + 1 < t_end) stage(t + 1);
    cp_commit();
    const int slot = t % C::STAGES;
    const float* Kt = smem + C::K + slot * D * C::LK;
    const float* Vk = smem + C::V + slot * BN * D;
    const int k0 = t * BN;
    const bool edge = tile_class(a.causal, a.window, a.kv_len, qlo, qhi, k0, BN) != kFullTile;

    float s[TM][KN];
    zero(s);
    score_product<D, TM, KN, C::LQ, C::LK>(s, Qt, Kt, rg, kg);

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      int lo = 0, hi = 0;
      if (edge) {
        const long long r = r0 + 4 * rg + 64 * (i / 4) + i % 4;
        if (r < a.rows)
          row_keys(a.q_offset + r / a.group, a.causal, a.window, a.kv_len, &lo, &hi);
        else
          lo = 1, hi = 0;
      }
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int key = k0 + 4 * kg + 32 * (j / 4) + j % 4;
        float x = s[i][j] * a.scale_log2;
        if (edge && (key < lo || key > hi)) x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float mnew = fmaxf(m[i], group_max(mx));
      const float alpha = ex2(m[i] - mnew);  // 1 while the row has seen no key
      m[i] = mnew;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const float p = edge && s[i][j] == kMasked ? 0.f : ex2(s[i][j] - mnew);
        s[i][j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + sum;  // this thread's share of the row's sum
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
    }
    // P to shared memory, key-major: Ps[key][row]
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int h = 0; h < TM / 4; ++h)
        *reinterpret_cast<float4*>(Ps + (4 * kg + 32 * (j / 4) + j % 4) * C::LQ + 4 * rg +
                                   64 * h) =
            make_float4(s[4 * h][j], s[4 * h + 1][j], s[4 * h + 2][j], s[4 * h + 3][j]);
    __syncthreads();

    // O += P V: rows as above, columns VW * kg + 8 VW c' + e
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float p[TM];
      load_owned<TM, 64>(p, Ps + j * C::LQ + 4 * rg);
      const float* vrow = Vk + j * D + VW * kg;
#pragma unroll
      for (int c = 0; c < NC / VW; ++c) {
        float v[VW];
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vrow + 32 * c);
          v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(vrow + 16 * c);
          v[0] = x.x, v[1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e) o[i][VW * c + e] = fmaf(p[i], v[e], o[i][VW * c + e]);
      }
    }
  }

  float* out = static_cast<float*>(a.o) + b * a.sob;
  const long long Sq = a.rows / a.group;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float sum = group_sum(l[i]);
    const long long r = r0 + 4 * rg + 64 * (i / 4) + i % 4;
    if (r >= a.rows) continue;
    float* orow = out + row_offset(r, kvh, a.group, a.soh, a.sos);
#pragma unroll
    for (int c = 0; c < NC / VW; ++c)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        orow[VW * kg + 8 * VW * c + e] = sum > 0.f ? o[i][VW * c + e] / sum : 0.f;
    // the row's log-sum-exp for the backward, 0 for a row with no visible key
    if (a.lse != nullptr && kg == 0)
      a.lse[lse_offset(r, b, kvh, a.Hkv, a.group, Sq)] =
          sum > 0.f ? (m[i] + log2f(sum)) * kLn2 : 0.f;
  }
}

template <int D>
int launch_f32(const Args& a, int n_bh, cudaStream_t st) {
  constexpr size_t bytes = FwdCfg<D>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((a.rows + FwdCfg<D>::BM - 1) / FwdCfg<D>::BM), (unsigned)n_bh);
  flash_f32<D><<<grid, kF32Threads, bytes, st>>>(a);
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
  a.scale_log2 = (float)(1.0 / sqrt((double)D) * 1.4426950408889634);
  a.vec16 = (uintptr_t)v % 16 == 0 && svb % 4 == 0 && svh % 4 == 0 && svs % 4 == 0;
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
