// The kernels of B6's fp32 backward (bwd_dq, bwd_dkdv) and their launcher,
// templated on the head dim; csrc/swa_backward.cu says their design.  Two
// files instantiate them, so that nvcc compiles the head dims in parallel:
// csrc/swa_backward.cu (D <= 80, and the C entry points) and
// csrc/swa_backward_wide.cu (D >= 96).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "simt_f32.cuh"

namespace {

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
  float scale;       // D ** -0.5
  float scale_log2;  // D ** -0.5 * log2(e)
};

template <int D>
__global__ void __launch_bounds__(kF32Threads, DqCfg<D>::BLOCKS) bwd_dq(const BwdArgs a) {
  using C = DqCfg<D>;
  constexpr int TM = C::TM, KN = C::KN, BM = C::BM, BN = C::BN, NC = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem + C::Q;
  float* Gt = smem + C::G;
  float* Ss = smem + C::S;
  float* Ls = smem + C::L;
  float* Ds = smem + C::DL;

  const int tid = threadIdx.x, rg = tid >> 3, kg = tid & 7;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const long long r0 = (long long)blockIdx.x * BM;
  const long long r1 = min(r0 + BM, a.rows);
  const int nr = (int)(r1 - r0);
  const float* kbase = static_cast<const float*>(a.k) + b * a.skb + kvh * a.skh;
  const float* vbase = static_cast<const float*>(a.v) + b * a.svb + kvh * a.svh;

  load_dmajor<D, BM, C::LQ>(Qt, static_cast<const float*>(a.q) + b * a.sqb, nr,
                            [&](int l) { return row_offset(r0 + l, kvh, a.group, a.sqh, a.sqs); });
  load_dmajor<D, BM, C::LQ>(Gt, static_cast<const float*>(a.dout) + b * a.sdob, nr,
                            [&](int l) {
                              return row_offset(r0 + l, kvh, a.group, a.sdoh, a.sdos);
                            });
  cp_commit();

  // keys [kb, ke) that some row of the tile can see (the forward's cull)
  const long long qlo = a.q_offset + r0 / a.group, qhi = a.q_offset + (r1 - 1) / a.group;
  long long kb, ke;
  visible_keys(a.causal, a.window, a.kv_len, qlo, qhi, &kb, &ke);
  const int t_begin = (int)(kb / BN);
  const int t_end = ke > kb ? (int)((ke + BN - 1) / BN) : t_begin;
  auto stage = [&](int t) {  // keys [t BN, t BN + BN) into ring slot t % STAGES
    const int k0 = t * BN, n = min(BN, a.kv_len - k0), slot = t % C::STAGES;
    load_dmajor<D, BN, C::LK>(smem + C::K + slot * D * C::LK, kbase, n,
                              [&](int j) { return (long long)(k0 + j) * a.sks; });
    load_dmajor<D, BN, C::LK>(smem + C::V + slot * D * C::LK, vbase, n,
                              [&](int j) { return (long long)(k0 + j) * a.svs; });
  };
  if (C::STAGES > 1 && t_begin < t_end) stage(t_begin);
  cp_commit();

  // each row's Delta = sum_d dout o (a warp a row) and log2-domain LSE
  {
    const float* o = static_cast<const float*>(a.o) + b * a.sob;
    const float* g = static_cast<const float*>(a.dout) + b * a.sdob;
    float* delta_out = a.delta + (long long)blockIdx.y * a.rows;
    for (int l = warp; l < BM; l += 4) {
      const long long r = r0 + l;
      float x = 0.f;
      if (r < r1) {
        const float* orow = o + row_offset(r, kvh, a.group, a.soh, a.sos);
        const float* grow = g + row_offset(r, kvh, a.group, a.sdoh, a.sdos);
        for (int d = lane; d < D; d += 32) x = fmaf(grow[d], orow[d], x);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
      if (lane == 0) {
        Ds[l] = x;
        Ls[l] = r < r1 ? a.lse[lse_offset(r, b, kvh, a.Hkv, a.group, a.Sq)] * kLog2e : 0.f;
        if (r < r1) delta_out[r] = x;
      }
    }
  }

  float acc[TM][NC];
  zero(acc);
  for (int t = t_begin; t < t_end; ++t) {
    if (C::STAGES == 1) {
      __syncthreads();  // the previous tile is consumed
      stage(t);
      cp_commit();
    }
    cp_wait<0>();
    __syncthreads();  // tile t (and q, dout, Ls, Ds) landed; the other slot and Ss are free
    if (C::STAGES > 1 && t + 1 < t_end) stage(t + 1);
    cp_commit();
    const int slot = t % C::STAGES, k0 = t * BN;
    const float* Kt = smem + C::K + slot * D * C::LK;
    const float* Vt = smem + C::V + slot * D * C::LK;
    const bool edge = nr < BM ||
                      tile_class(a.causal, a.window, a.kv_len, qlo, qhi, k0, BN) != kFullTile;

    // P = exp2(s scale log2 e - LSE log2 e) over the visible keys
    float p[TM][KN];
    zero(p);
    score_product<D, TM, KN, C::LQ, C::LK>(p, Qt, Kt, rg, kg);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int l = 4 * rg + 64 * (i / 4) + i % 4;
      int lo = 0, hi = 0;
      if (edge) {
        if (l < nr)
          row_keys(a.q_offset + (r0 + l) / a.group, a.causal, a.window, a.kv_len, &lo, &hi);
        else
          lo = 1, hi = 0;
      }
      const float lse = Ls[l];
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int key = k0 + 4 * kg + 32 * (j / 4) + j % 4;
        const bool vis = !edge || (key >= lo && key <= hi);
        p[i][j] = vis ? ex2(fmaf(p[i][j], a.scale_log2, -lse)) : 0.f;
      }
    }
    // dP = dout V^T; dS = P (dP - Delta) into Ss[key][row]
    float dp[TM][KN];
    zero(dp);
    score_product<D, TM, KN, C::LQ, C::LK>(dp, Gt, Vt, rg, kg);
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 d4 = *reinterpret_cast<const float4*>(Ds + 4 * rg + 64 * h);
        *reinterpret_cast<float4*>(Ss + (4 * kg + 32 * (j / 4) + j % 4) * C::LQ + 4 * rg +
                                   64 * h) =
            make_float4(p[4 * h][j] * (dp[4 * h][j] - d4.x),
                        p[4 * h + 1][j] * (dp[4 * h + 1][j] - d4.y),
                        p[4 * h + 2][j] * (dp[4 * h + 2][j] - d4.z),
                        p[4 * h + 3][j] * (dp[4 * h + 3][j] - d4.w));
      }
    __syncthreads();

    // dQ += dS K: rows as above, columns kg + 8 c; four keys a step, each
    // column's four as one 16-byte load of K's d-major line
#pragma unroll 4
    for (int j = 0; j < BN; j += 4) {
      float ds[4][TM];
#pragma unroll
      for (int u = 0; u < 4; ++u) load_owned<TM, 64>(ds[u], Ss + (j + u) * C::LQ + 4 * rg);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(Kt + (kg + 8 * c) * C::LK + j);
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[i][c] = fmaf(ds[u][i], kv[u], acc[i][c]);
      }
    }
  }
  float* dq = static_cast<float*>(a.dq) + b * a.sdqb;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int l = 4 * rg + 64 * (i / 4) + i % 4;
    if (l >= nr) continue;
    float* row = dq + row_offset(r0 + l, kvh, a.group, a.sdqh, a.sdqs);
#pragma unroll
    for (int c = 0; c < NC; ++c) row[kg + 8 * c] = acc[i][c] * a.scale;
  }
}

// The thread's f(i, j, x[i][j]) into T[row][key] (lines of KN * 8 + 4):
// rows 4 rg + i, keys 4 kg + 32 h + e, as 16-byte stores.
template <int TM, int KN, typename F>
__device__ __forceinline__ void store_rows(float* T, const float (&x)[TM][KN], int rg, int kg,
                                           F f) {
  constexpr int LK = 8 * KN + 4;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int h = 0; h < KN / 4; ++h)
      *reinterpret_cast<float4*>(T + (4 * rg + i) * LK + 4 * kg + 32 * h) =
          make_float4(f(i, 4 * h, x[i][4 * h]), f(i, 4 * h + 1, x[i][4 * h + 1]),
                      f(i, 4 * h + 2, x[i][4 * h + 2]), f(i, 4 * h + 3, x[i][4 * h + 3]));
}

// acc[j][c] += sum_l W[l][key j] X[column rg + 16 c][l] over the BM rows of
// a tile: W row-major (lines LW), X d-major (lines LX); four rows a step,
// each column's four as one 16-byte load of X's line.
template <int D, int BM, int KN, int LW, int LX>
__device__ __forceinline__ void rank1_rows(float (&acc)[KN][D / 16], const float* W,
                                           const float* X, int rg, int kg) {
#pragma unroll 4
  for (int l = 0; l < BM; l += 4) {
    float w[4][KN];
#pragma unroll
    for (int u = 0; u < 4; ++u) load_owned<KN, 32>(w[u], W + (l + u) * LW + 4 * kg);
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float4 x4 = *reinterpret_cast<const float4*>(X + (rg + 16 * c) * LX + l);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < KN; ++j) acc[j][c] = fmaf(w[u][j], x[u], acc[j][c]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, KvCfg<D>::BLOCKS) bwd_dkdv(const BwdArgs a) {
  using C = KvCfg<D>;
  constexpr int TM = C::TM, KN = C::KN, BM = C::BM, BN = C::BN, NC = D / 16;
  extern __shared__ __align__(16) float smem[];
  const float* Kt = smem + C::K;
  const float* Vt = smem + C::V;
  float* PSs = smem + C::P;

  const int tid = threadIdx.x, rg = tid >> 3, kg = tid & 7;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const int k0 = blockIdx.x * BN;
  const float* q = static_cast<const float*>(a.q) + b * a.sqb;
  const float* dout = static_cast<const float*>(a.dout) + b * a.sdob;
  const float* delta_in = a.delta + (long long)blockIdx.y * a.rows;

  const int nk = max(0, min(BN, a.kv_len - k0));
  load_dmajor<D, BN, C::LK>(smem + C::K, static_cast<const float*>(a.k) + b * a.skb + kvh * a.skh,
                            nk, [&](int j) { return (long long)(k0 + j) * a.sks; });
  load_dmajor<D, BN, C::LK>(smem + C::V, static_cast<const float*>(a.v) + b * a.svb + kvh * a.svh,
                            nk, [&](int j) { return (long long)(k0 + j) * a.svs; });
  cp_commit();

  // rows whose positions can see a key of [k0, k_last]
  const long long k_last = min(k0 + BN, a.kv_len) - 1;
  long long r_begin = 0, r_end = 0;
  if (k_last >= k0) {
    const long long p_lo = a.causal ? max(0LL, k0 - a.q_offset) : 0;
    const long long p_hi = a.window > 0
                               ? min((long long)a.Sq - 1, k_last + a.window - 1 - a.q_offset)
                               : (long long)a.Sq - 1;
    if (p_hi >= p_lo) r_begin = p_lo * a.group, r_end = (p_hi + 1) * a.group;
  }
  const int n_tiles = (int)((r_end - r_begin + BM - 1) / BM);
  auto stage = [&](int it) {  // rows [r_begin + it BM, +BM) into ring slot it % STAGES
    const long long rs = r_begin + (long long)it * BM;
    const int n = (int)min((long long)BM, r_end - rs), slot = it % C::STAGES;
    load_dmajor<D, BM, C::LQ>(smem + C::Q + slot * D * C::LQ, q, n,
                              [&](int l) {
                                return row_offset(rs + l, kvh, a.group, a.sqh, a.sqs);
                              });
    load_dmajor<D, BM, C::LQ>(smem + C::G + slot * D * C::LQ, dout, n, [&](int l) {
      return row_offset(rs + l, kvh, a.group, a.sdoh, a.sdos);
    });
    if (threadIdx.x < BM) {
      const int l = threadIdx.x;
      const bool ok = l < n;
      const long long li = ok ? lse_offset(rs + l, b, kvh, a.Hkv, a.group, a.Sq) : 0;
      cp4(smem + C::L + slot * BM + l, a.lse + li, ok);
      cp4(smem + C::DL + slot * BM + l, delta_in + (ok ? rs + l : 0), ok);
    }
  };
  if (C::STAGES > 1 && n_tiles > 0) stage(0);
  cp_commit();

  float dk[KN][NC], dv[KN][NC];
  zero(dk);
  zero(dv);
  for (int it = 0; it < n_tiles; ++it) {
    if (C::STAGES == 1) {
      __syncthreads();  // the previous tile is consumed
      stage(it);
      cp_commit();
    }
    cp_wait<0>();
    __syncthreads();  // row tile it (and K, V) landed; the other slot and PSs are free
    if (C::STAGES > 1 && it + 1 < n_tiles) stage(it + 1);
    cp_commit();
    const int slot = it % C::STAGES;
    const float* Qt = smem + C::Q + slot * D * C::LQ;
    const float* Gt = smem + C::G + slot * D * C::LQ;
    const float* Ls = smem + C::L + slot * BM;
    const float* Ds = smem + C::DL + slot * BM;
    const long long rs = r_begin + (long long)it * BM;
    const int nr = (int)min((long long)BM, r_end - rs);
    const long long qlo = a.q_offset + rs / a.group, qhi = a.q_offset + (rs + nr - 1) / a.group;
    const bool edge = nr < BM ||
                      tile_class(a.causal, a.window, a.kv_len, qlo, qhi, k0, BN) != kFullTile;

    // P = exp2(s scale log2 e - LSE log2 e) over the visible keys, and dP =
    // dout V^T, in registers
    float p[TM][KN], dp[TM][KN];
    zero(p);
    score_product<D, TM, KN, C::LQ, C::LK>(p, Qt, Kt, rg, kg);
    zero(dp);
    score_product<D, TM, KN, C::LQ, C::LK>(dp, Gt, Vt, rg, kg);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int l = 4 * rg + i;
      int lo = 0, hi = 0;
      if (edge) {
        if (l < nr)
          row_keys(a.q_offset + (rs + l) / a.group, a.causal, a.window, a.kv_len, &lo, &hi);
        else
          lo = 1, hi = 0;
      }
      const float lse = Ls[l] * kLog2e;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int key = k0 + 4 * kg + 32 * (j / 4) + j % 4;
        const bool vis = !edge || (key >= lo && key <= hi);
        p[i][j] = vis ? ex2(fmaf(p[i][j], a.scale_log2, -lse)) : 0.f;
      }
    }
    // dV += P^T dout, then dK += dS^T q, through PSs[row][key] in turn: the
    // thread's KN keys by columns rg + 16 c
    store_rows<TM, KN>(PSs, p, rg, kg, [&](int, int, float x) { return x; });
    __syncthreads();
    rank1_rows<D, BM, KN, C::LK, C::LQ>(dv, PSs, Gt, rg, kg);
    __syncthreads();  // P is read: PSs takes dS
    store_rows<TM, KN>(PSs, p, rg, kg,
                       [&](int i, int j, float x) { return x * (dp[i][j] - Ds[4 * rg + i]); });
    __syncthreads();
    rank1_rows<D, BM, KN, C::LK, C::LQ>(dk, PSs, Qt, rg, kg);
  }
  float* dkp = static_cast<float*>(a.dk) + b * a.sdkb + kvh * a.sdkh;
  float* dvp = static_cast<float*>(a.dv) + b * a.sdvb + kvh * a.sdvh;
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    const long long key = k0 + 4 * kg + 32 * (j / 4) + j % 4;
    if (key >= a.Skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkp[key * a.sdks + rg + 16 * c] = dk[j][c] * a.scale;
      dvp[key * a.sdvs + rg + 16 * c] = dv[j][c];
    }
  }
}

template <int D>
int launch_bwd(const BwdArgs& a, int n_bh, cudaStream_t st) {
  using Q = DqCfg<D>;
  using K = KvCfg<D>;
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Q::BYTES);
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::BYTES);
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  if (a.rows > 0) {
    const dim3 grid((unsigned)((a.rows + Q::BM - 1) / Q::BM), (unsigned)n_bh);
    bwd_dq<D><<<grid, kF32Threads, Q::BYTES, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.Skv > 0) {
    const dim3 grid((unsigned)((a.Skv + K::BN - 1) / K::BN), (unsigned)n_bh);
    bwd_dkdv<D><<<grid, kF32Threads, K::BYTES, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace
