// B6 backward on the CUDA cores: dQ, dK and dV of the flash attention forward
// (GQA, causal and sliding-window masks, a query offset and KV-length
// masking), for sm_90a, in fp32 (no TF32: the fp32 gate is 2e-5); bf16 runs
// csrc/swa_backward_bf16.cu on the tensor cores.
//
// Replaces no Pallas kernel: the reference differentiates its XLA
// formulation (repro/models/layers.py:130 sdpa, and _sdpa_chunked's
// checkpointed scan), while the port's cuda engine runs B6 on every
// attention call, so training under that engine needs B6's gradient on the
// card.  kernels/swa_attention.py wraps this file in a torch.autograd.Function
// (FlashAttention) beside its plain version,
// flash_swa_attention_backward_plain.
//
// Semantics: the function B6's forward computes (csrc/swa_attention.cu's
// header).  q, dq are (B, Hq, Sq, D), k, v, dk, dv (B, Hkv, Skv, D), o and dout
// (B, Hq, Sq, D), each given by element strides for its b, h and s axes (unit
// stride on d).  Query row i of head h sits at position q_offset + i and reads
// KV head h / (Hq / Hkv); key j is visible when j < kv_len, j <= qpos (causal)
// and j > qpos - window (window > 0).  With s = D**-0.5 q.k, P = softmax over
// the visible keys, Delta_i = sum_d dout_i o_i:
//   dV_j = sum_i P_ij dout_i, dS_ij = P_ij (dout_i . v_j - Delta_i),
//   dQ_i = s' sum_j dS_ij k_j, dK_j = s' sum_i dS_ij q_i   (s' = D**-0.5),
// with dK and dV summed over the KV head's group of query heads.  Every
// product and sum is fp32.  A row with no visible key, and a key no row
// sees (at or past kv_len included), gets zero gradient.
//
// Each row's log-sum-exp (LSE) comes from the forward, which writes it when
// it is given a buffer (kernels/swa_attention.py:FlashAttention does):
// (B, Hq, Sq) fp32, natural log, 0 for a row with no visible key.
//
// Design: two launches, deterministic and free of atomics; fp32 on the CUDA
// cores, 256 threads a block as a 16 x 16 grid (tx, ty).
//   1. bwd_dq, one block per (batch, KV head, tile of BM rows).  Rows are
//      (query position, head of the KV head's group) pairs, position-major, so
//      the group shares every staged K/V tile (the forward's order).  It reads
//      the tile's q and dout rows into shared memory, computes Delta, then
//      walks the key tiles any of its rows can see (the forward's cull) for
//      P = exp(s - LSE), dS and dQ += dS K.  It writes the rows' Delta (fp32)
//      to a workspace for the second launch.
//   2. bwd_dkdv, one block per (batch, KV head, tile of BN keys).  It keeps
//      the tile's K and V in shared memory and dK, dV in registers, and walks
//      the row tiles (every head of the group) whose positions can see a key
//      of the tile: P = exp(s - LSE) and dS from the LSE and Delta, then
//      dV += P^T dout and dK += dS^T q through shared memory.
//   Score tiles: thread (tx, ty) takes rows ty + 16 m and keys tx + 16 c;
//   products into D columns: rows (or keys) ty + 16 m and columns tx + 16 e.
//   Shared rows are padded to D + 1 (odd) floats, so 16 lanes reading 16 rows
//   hit 16 banks.  BM = BN = 64 up to D = 128, 32 above (shared memory: at
//   most 166 KB, D = 128's bwd_dkdv).
//
// Bound: operations.  10 D flops a visible (query, key) pair and query head
// (q.k, dout.v, P^T dout, dS^T q, dS k); this kernel spends 14 D (the dK/dV
// launch recomputes q.k and dout.v), on the CUDA cores' 67 TFLOP/s.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // 16 x 16
constexpr unsigned kFull = 0xffffffffu;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;  // (B, Hq, Sq): each row's log-sum-exp (the forward's), 0 with no key
  float* delta;      // (B * Hkv, rows): sum_d dout o
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  long long sdob, sdoh, sdos, sdqb, sdqh, sdqs, sdkb, sdkh, sdks, sdvb, sdvh, sdvs;
  long long q_offset;
  long long rows;  // group * Sq rows per (batch, KV head)
  int Hkv, group, Sq, Skv, causal, window, kv_len;
  float scale;  // D ** -0.5
};

// Index of row r's log-sum-exp: position r / group of head kvh * group + r %
// group, in the forward's (B, Hq, Sq) layout.
__device__ __forceinline__ long long lse_index(const BwdArgs& a, long long r, int b, int kvh) {
  return ((long long)(b * a.Hkv + kvh) * a.group + r % a.group) * a.Sq + r / a.group;
}

__device__ __forceinline__ bool visible(long long key, long long qpos, const BwdArgs& a) {
  if (key >= a.kv_len) return false;
  if (a.causal && key > qpos) return false;
  if (a.window > 0 && key <= qpos - a.window) return false;
  return true;
}

// Offset of row r's first element in a (B, H, S, D) tensor with strides
// (sb, sh, ss): position r / group of head kvh * group + r % group.
__device__ __forceinline__ long long row_off(long long r, int b, int kvh, int group, long long sb,
                                             long long sh, long long ss) {
  return b * sb + ((long long)kvh * group + r % group) * sh + (r / group) * ss;
}

// ROWS rows from r0 (those below rend; the rest 0) into dst[ROWS][D + 1].
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float (*dst)[D + 1], const float* base, long long r0,
                                          long long rend, int b, int kvh, int group, long long sb,
                                          long long sh, long long ss) {
  for (int c = threadIdx.x; c < ROWS * D; c += kThreads) {
    const int rr = c / D, d = c % D;
    const long long r = r0 + rr;
    dst[rr][d] = r < rend ? base[row_off(r, b, kvh, group, sb, sh, ss) + d] : 0.f;
  }
}

// KEYS keys from k0 (those below kv_len; the rest 0) of one KV head.
template <int D, int KEYS>
__device__ __forceinline__ void load_keys(float (*dst)[D + 1], const float* head, long long k0,
                                          int kv_len, long long ss) {
  for (int c = threadIdx.x; c < KEYS * D; c += kThreads) {
    const int kk = c / D, d = c % D;
    const long long key = k0 + kk;
    dst[kk][d] = key < kv_len ? head[key * ss + d] : 0.f;
  }
}

// Sum over the 16 lanes of one ty (a half warp).
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int D, int BM, int BN>
struct Smem {
  static constexpr int P = D + 1;
  // bwd_dq: Qs, dOs [BM][P]; Ks, Vs [BN][P]; dSs [BM][BN + 1]
  static constexpr size_t dq = sizeof(float) * (2 * BM * P + 2 * BN * P + BM * (BN + 1));
  // bwd_dkdv: Ks, Vs [BN][P]; Qs, dOs [BM][P]; Ps, dSs [BM][BN + 1]; lse, delta [BM]
  static constexpr size_t dkdv =
      sizeof(float) * (2 * BN * P + 2 * BM * P + 2 * BM * (BN + 1) + 2 * BM);
};

template <int D, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1) bwd_dq(const BwdArgs a) {
  constexpr int MI = BM / 16, NJ = BN / 16, DE = D / 16, P = D + 1;
  extern __shared__ float smem[];
  float(*Qs)[P] = reinterpret_cast<float(*)[P]>(smem);
  float(*dOs)[P] = reinterpret_cast<float(*)[P]>(smem + BM * P);
  float(*Ks)[P] = reinterpret_cast<float(*)[P]>(smem + 2 * BM * P);
  float(*Vs)[P] = reinterpret_cast<float(*)[P]>(smem + 2 * BM * P + BN * P);
  float(*dSs)[BN + 1] = reinterpret_cast<float(*)[BN + 1]>(smem + 2 * BM * P + 2 * BN * P);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const long long r0 = (long long)blockIdx.x * BM;
  const long long r1 = min(r0 + BM, a.rows);
  const float* q = static_cast<const float*>(a.q);
  const float* o = static_cast<const float*>(a.o);
  const float* dout = static_cast<const float*>(a.dout);
  const float* khead = static_cast<const float*>(a.k) + b * a.skb + kvh * a.skh;
  const float* vhead = static_cast<const float*>(a.v) + b * a.svb + kvh * a.svh;

  load_rows<D, BM>(Qs, q, r0, r1, b, kvh, a.group, a.sqb, a.sqh, a.sqs);
  load_rows<D, BM>(dOs, dout, r0, r1, b, kvh, a.group, a.sdob, a.sdoh, a.sdos);
  __syncthreads();

  bool rv[MI];
  long long qpos[MI];
  float delta[MI], lse[MI];
  float* delta_out = a.delta + (long long)blockIdx.y * a.rows;
#pragma unroll
  for (int m = 0; m < MI; ++m) {
    const long long r = r0 + ty + 16 * m;
    rv[m] = r < r1;
    qpos[m] = a.q_offset + (rv[m] ? r / a.group : 0);
    lse[m] = rv[m] ? a.lse[lse_index(a, r, b, kvh)] : 0.f;
    float s = 0.f;
    if (rv[m]) {
      const float* orow = o + row_off(r, b, kvh, a.group, a.sob, a.soh, a.sos);
#pragma unroll
      for (int e = 0; e < DE; ++e) s = fmaf(dOs[ty + 16 * m][tx + 16 * e], orow[tx + 16 * e], s);
    }
    delta[m] = half_sum(s);
    if (tx == 0 && rv[m]) delta_out[r] = delta[m];
  }

  // keys [kb, ke) that some row of the tile can see (the forward's cull)
  const long long q_lo = a.q_offset + r0 / a.group;
  const long long q_hi = a.q_offset + (r1 - 1) / a.group;
  const long long kb = a.window > 0 ? max(0LL, q_lo - a.window + 1) : 0;
  const long long ke = a.causal ? min((long long)a.kv_len, q_hi + 1) : (long long)a.kv_len;
  const long long t_begin = kb / BN;
  const long long t_end = ke > kb ? (ke + BN - 1) / BN : t_begin;

  // dS = P (dout.v - Delta), dQ += dS K
  float acc[MI][DE];
#pragma unroll
  for (int m = 0; m < MI; ++m)
#pragma unroll
    for (int e = 0; e < DE; ++e) acc[m][e] = 0.f;
  for (long long t = t_begin; t < t_end; ++t) {
    const long long k0 = t * BN;
    __syncthreads();
    load_keys<D, BN>(Ks, khead, k0, a.kv_len, a.sks);
    load_keys<D, BN>(Vs, vhead, k0, a.kv_len, a.svs);
    __syncthreads();
    float s[MI][NJ], dp[MI][NJ];
#pragma unroll
    for (int m = 0; m < MI; ++m)
#pragma unroll
      for (int c = 0; c < NJ; ++c) s[m][c] = 0.f, dp[m][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[MI], gv[MI], kv[NJ], vv[NJ];
#pragma unroll
      for (int m = 0; m < MI; ++m) qv[m] = Qs[ty + 16 * m][d], gv[m] = dOs[ty + 16 * m][d];
#pragma unroll
      for (int c = 0; c < NJ; ++c) kv[c] = Ks[tx + 16 * c][d], vv[c] = Vs[tx + 16 * c][d];
#pragma unroll
      for (int m = 0; m < MI; ++m)
#pragma unroll
        for (int c = 0; c < NJ; ++c) {
          s[m][c] = fmaf(qv[m], kv[c], s[m][c]);
          dp[m][c] = fmaf(gv[m], vv[c], dp[m][c]);
        }
    }
#pragma unroll
    for (int m = 0; m < MI; ++m)
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        const bool vis = rv[m] && visible(k0 + tx + 16 * c, qpos[m], a);
        const float p = vis ? expf(s[m][c] * a.scale - lse[m]) : 0.f;
        dSs[ty + 16 * m][tx + 16 * c] = p * (dp[m][c] - delta[m]);
      }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float kd[DE];
#pragma unroll
      for (int e = 0; e < DE; ++e) kd[e] = Ks[j][tx + 16 * e];
#pragma unroll
      for (int m = 0; m < MI; ++m) {
        const float ds = dSs[ty + 16 * m][j];
#pragma unroll
        for (int e = 0; e < DE; ++e) acc[m][e] = fmaf(ds, kd[e], acc[m][e]);
      }
    }
  }
  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int m = 0; m < MI; ++m) {
    if (!rv[m]) continue;
    float* row = dq + row_off(r0 + ty + 16 * m, b, kvh, a.group, a.sdqb, a.sdqh, a.sdqs);
#pragma unroll
    for (int e = 0; e < DE; ++e) row[tx + 16 * e] = acc[m][e] * a.scale;
  }
}

template <int D, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1) bwd_dkdv(const BwdArgs a) {
  constexpr int MI = BM / 16, NJ = BN / 16, DE = D / 16, P = D + 1;
  extern __shared__ float smem[];
  float(*Ks)[P] = reinterpret_cast<float(*)[P]>(smem);
  float(*Vs)[P] = reinterpret_cast<float(*)[P]>(smem + BN * P);
  float(*Qs)[P] = reinterpret_cast<float(*)[P]>(smem + 2 * BN * P);
  float(*dOs)[P] = reinterpret_cast<float(*)[P]>(smem + 2 * BN * P + BM * P);
  float(*Ps)[BN + 1] = reinterpret_cast<float(*)[BN + 1]>(smem + 2 * BN * P + 2 * BM * P);
  float(*dSs)[BN + 1] =
      reinterpret_cast<float(*)[BN + 1]>(smem + 2 * BN * P + 2 * BM * P + BM * (BN + 1));
  float* Ls = smem + 2 * BN * P + 2 * BM * P + 2 * BM * (BN + 1);
  float* Ds = Ls + BM;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const long long k0 = (long long)blockIdx.x * BN;
  const float* q = static_cast<const float*>(a.q);
  const float* dout = static_cast<const float*>(a.dout);
  const float* delta_in = a.delta + (long long)blockIdx.y * a.rows;

  load_keys<D, BN>(Ks, static_cast<const float*>(a.k) + b * a.skb + kvh * a.skh, k0, a.kv_len,
                      a.sks);
  load_keys<D, BN>(Vs, static_cast<const float*>(a.v) + b * a.svb + kvh * a.svh, k0, a.kv_len,
                      a.svs);

  // rows whose positions can see a key of [k0, k_last]
  const long long k_last = min(k0 + BN, (long long)a.kv_len) - 1;
  long long r_begin = 0, r_end = 0;
  if (k_last >= k0) {
    const long long p_lo = a.causal ? max(0LL, k0 - a.q_offset) : 0;
    const long long p_hi = a.window > 0 ? min((long long)a.Sq - 1, k_last + a.window - 1 - a.q_offset)
                                        : (long long)a.Sq - 1;
    if (p_hi >= p_lo) r_begin = p_lo * a.group, r_end = (p_hi + 1) * a.group;
  }

  float acc_k[NJ][DE], acc_v[NJ][DE];
#pragma unroll
  for (int c = 0; c < NJ; ++c)
#pragma unroll
    for (int e = 0; e < DE; ++e) acc_k[c][e] = 0.f, acc_v[c][e] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += BM) {
    const long long r1 = min(r0 + BM, r_end);
    __syncthreads();
    load_rows<D, BM>(Qs, q, r0, r1, b, kvh, a.group, a.sqb, a.sqh, a.sqs);
    load_rows<D, BM>(dOs, dout, r0, r1, b, kvh, a.group, a.sdob, a.sdoh, a.sdos);
    for (int i = threadIdx.x; i < BM; i += kThreads) {
      const bool ok = r0 + i < r1;
      Ls[i] = ok ? a.lse[lse_index(a, r0 + i, b, kvh)] : 0.f;
      Ds[i] = ok ? delta_in[r0 + i] : 0.f;
    }
    __syncthreads();
    float s[MI][NJ], dp[MI][NJ];
#pragma unroll
    for (int m = 0; m < MI; ++m)
#pragma unroll
      for (int c = 0; c < NJ; ++c) s[m][c] = 0.f, dp[m][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[MI], gv[MI], kv[NJ], vv[NJ];
#pragma unroll
      for (int m = 0; m < MI; ++m) qv[m] = Qs[ty + 16 * m][d], gv[m] = dOs[ty + 16 * m][d];
#pragma unroll
      for (int c = 0; c < NJ; ++c) kv[c] = Ks[tx + 16 * c][d], vv[c] = Vs[tx + 16 * c][d];
#pragma unroll
      for (int m = 0; m < MI; ++m)
#pragma unroll
        for (int c = 0; c < NJ; ++c) {
          s[m][c] = fmaf(qv[m], kv[c], s[m][c]);
          dp[m][c] = fmaf(gv[m], vv[c], dp[m][c]);
        }
    }
#pragma unroll
    for (int m = 0; m < MI; ++m) {
      const int i = ty + 16 * m;
      const long long r = r0 + i;
      const bool rv = r < r1;
      const long long qpos = a.q_offset + (rv ? r / a.group : 0);
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        const bool vis = rv && visible(k0 + tx + 16 * c, qpos, a);
        const float p = vis ? expf(s[m][c] * a.scale - Ls[i]) : 0.f;
        Ps[i][tx + 16 * c] = p;
        dSs[i][tx + 16 * c] = p * (dp[m][c] - Ds[i]);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < BM; ++i) {
      float pj[NJ], dsj[NJ];
#pragma unroll
      for (int c = 0; c < NJ; ++c) pj[c] = Ps[i][ty + 16 * c], dsj[c] = dSs[i][ty + 16 * c];
#pragma unroll
      for (int e = 0; e < DE; ++e) {
        const float g = dOs[i][tx + 16 * e], qv = Qs[i][tx + 16 * e];
#pragma unroll
        for (int c = 0; c < NJ; ++c) {
          acc_v[c][e] = fmaf(pj[c], g, acc_v[c][e]);
          acc_k[c][e] = fmaf(dsj[c], qv, acc_k[c][e]);
        }
      }
    }
  }
  float* dk = static_cast<float*>(a.dk) + b * a.sdkb + kvh * a.sdkh;
  float* dv = static_cast<float*>(a.dv) + b * a.sdvb + kvh * a.sdvh;
#pragma unroll
  for (int c = 0; c < NJ; ++c) {
    const long long key = k0 + ty + 16 * c;
    if (key >= a.Skv) continue;
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      dk[key * a.sdks + tx + 16 * e] = acc_k[c][e] * a.scale;
      dv[key * a.sdvs + tx + 16 * e] = acc_v[c][e];
    }
  }
}

template <int D>
int launch_bwd(const BwdArgs& a, int n_bh, cudaStream_t st) {
  constexpr int BM = D > 128 ? 32 : 64, BN = BM;
  using S = Smem<D, BM, BN>;
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      bwd_dq<D, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::dq);
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      bwd_dkdv<D, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::dkdv);
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  if (a.rows > 0) {
    const dim3 grid((unsigned)((a.rows + BM - 1) / BM), (unsigned)n_bh);
    bwd_dq<D, BM, BN><<<grid, kThreads, S::dq, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.Skv > 0) {
    const dim3 grid((unsigned)((a.Skv + BN - 1) / BN), (unsigned)n_bh);
    bwd_dkdv<D, BM, BN><<<grid, kThreads, S::dkdv, st>>>(a);
  }
  return (int)cudaGetLastError();
}

int dispatch(const BwdArgs& a, int D, int n_bh, cudaStream_t st) {
  switch (D) {
    case 16: return launch_bwd<16>(a, n_bh, st);
    case 32: return launch_bwd<32>(a, n_bh, st);
    case 64: return launch_bwd<64>(a, n_bh, st);
    case 80: return launch_bwd<80>(a, n_bh, st);
    case 96: return launch_bwd<96>(a, n_bh, st);
    case 128: return launch_bwd<128>(a, n_bh, st);
    case 240: return launch_bwd<240>(a, n_bh, st);
    case 256: return launch_bwd<256>(a, n_bh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: element strides (b, h, s) each, unit stride
// on d; lse: the forward's (B, Hq, Sq) fp32 log-sum-exp; delta: an fp32
// workspace of B * Hkv * (Hq / Hkv) * Sq floats; every operand fp32.  Writes
// every element of dq, dk and dv.  Returns the launch error (0 when
// launched).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
    void* dk, void* dv, const void* lse, void* delta, long long sqb, long long sqh, long long sqs,
    long long skb, long long skh, long long sks, long long svb, long long svh, long long svs,
    long long sob, long long soh, long long sos, long long sdob, long long sdoh, long long sdos,
    long long sdqb, long long sdqh, long long sdqs, long long sdkb, long long sdkh, long long sdks,
    long long sdvb, long long sdvh, long long sdvs, int B, int Hq, int Hkv, int Sq, int Skv, int D,
    int causal, int window, long long q_offset, int kv_len, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || kv_len < 0 || kv_len > Skv || window < 0 || Sq < 0 ||
      (long long)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.sqb = sqb; a.sqh = sqh; a.sqs = sqs;
  a.skb = skb; a.skh = skh; a.sks = sks;
  a.svb = svb; a.svh = svh; a.svs = svs;
  a.sob = sob; a.soh = soh; a.sos = sos;
  a.sdob = sdob; a.sdoh = sdoh; a.sdos = sdos;
  a.sdqb = sdqb; a.sdqh = sdqh; a.sdqs = sdqs;
  a.sdkb = sdkb; a.sdkh = sdkh; a.sdks = sdks;
  a.sdvb = sdvb; a.sdvh = sdvh; a.sdvs = sdvs;
  a.q_offset = q_offset;
  a.Hkv = Hkv;
  a.group = Hq / Hkv;
  a.rows = (long long)a.group * Sq;
  a.Sq = Sq;
  a.Skv = Skv;
  a.causal = causal;
  a.window = window;
  a.kv_len = kv_len;
  a.scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = (cudaStream_t)stream;
  const int n_bh = B * Hkv;
  return dispatch(a, D, n_bh, st);
}
