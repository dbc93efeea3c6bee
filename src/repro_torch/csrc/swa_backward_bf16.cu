// B6 backward, bf16 on the tensor cores: dQ, dK and dV of the flash attention
// forward (GQA, causal and sliding-window masks, a query offset and KV-length
// masking), written for Hopper (sm_90a) with TMA, mbarriers, warp
// specialisation and wgmma, at every head dim of B6 (16 to 256).
//
// Replaces no Pallas kernel: the reference differentiates its XLA attention
// (repro/models/layers.py:130 sdpa), while the port's cuda engine runs B6 on
// every attention call, so training under that engine needs B6's gradient on
// the card.  kernels/swa_attention.py:flash_swa_attention_backward sends bf16
// calls here and fp32 calls to csrc/swa_backward.cu (CUDA cores: TF32 would
// break the fp32 gate of 2e-5).
//
// Semantics: csrc/swa_backward.cu's.  q, dq and dout are (B, Hq, Sq, D), k, v,
// dk and dv (B, Hkv, Skv, D), each given by element strides for its b, h and s
// axes (unit stride on d), so the model's transposed (B, S, H, D) views go in
// without a copy.  With s = D**-0.5 q.k, P = softmax over the visible keys and
// Delta_i = sum_d dout_i o_i: dV_j = sum_i P_ij dout_i, dS_ij = P_ij (dout_i.v_j
// - Delta_i), dQ_i = D**-0.5 sum_j dS_ij k_j, dK_j = D**-0.5 sum_i dS_ij q_i,
// dK and dV summed over the KV head's group.  Products take bf16 operands and
// sum in fp32; P and dS are rounded to bf16 as the A operands of the second
// products (the forward rounds P for P V the same way); gradients are bf16.
// A row with no visible key, and a key that no row sees (at or past kv_len
// included), get zero gradient.
//
// The log-sum-exp: each row's P is exp2(s log2(e) / sqrt(D) - LSE log2(e)) from
// the LSE that the training forward wrote (csrc/swa_prefill.cu, (B, Hq, Sq)
// fp32, natural log, 0 for a row with no visible key, whose scores are all
// masked, so that its P is 0).  No pass recomputes it.
//
// Design: FlashAttention-2's split into two launches, deterministic, no
// atomics (a rerun gives the same bits).  Both are warp-specialised like the
// forward: one producer warp issues TMA loads into mbarrier rings in dynamic
// shared memory, two consumer warpgroups run wgmma (setmaxnreg: 24 and 240
// registers a thread).  Tiles are csrc/hopper.cuh's 16-element, 32-byte
// swizzled boxes (head dims 80 and 96 are not multiples of 64), read K-major
// or MN-major (transposed) by the same descriptors as the forward.
//   1. bwd_dq_wgmma, one block per (tile of 128 query rows, query head,
//      batch); each consumer warpgroup takes 64 rows.  The producer loads the
//      block's Q and dout tiles once and the K and V tiles of its key range
//      (64 keys a tile in 3 stages; 32 keys in 2 stages above D = 128) into
//      a ring.  A consumer computes Delta of its rows from o and dout in
//      global memory (and writes it to the fp32 workspace for launch 2),
//      then per key tile: S = Q K^T and dP = dout V^T with wgmma SS (two
//      commit groups: P = exp2(...) of S runs while dP is on the tensor
//      cores), dS = P (dP - Delta) rounded into bf16 A fragments, and dQ +=
//      dS K with wgmma RS, K read MN-major as the forward reads V.  dQ stays
//      in registers (D / 2 a thread).
//   2. bwd_dkdv_wgmma, one block per (tile of 128 keys, KV head, batch);
//      each consumer warpgroup takes 64 keys and keeps their dK and dV in
//      registers (D / 2 + D / 2 a thread).  Above D = 128 that would be
//      240-256 accumulators a thread: a block takes 64 keys and the
//      warpgroups split d by boxes (8 and 7 of 240's 15, 8 and 8 of 256's),
//      each computing the whole S^T and dP^T (dkdv then spends 12 D a pair,
//      not 8 D).  The producer loads the K and V tiles once and streams the
//      Q and dout tiles (BM rows: 64, 32 from D = 128) of every head of the
//      group whose positions can see a key of the block
//      (csrc/swa_backward.cu's row range) through a 3-stage ring.  Per row
//      tile: S^T = K Q^T and dP^T = V dout^T with wgmma SS (keys as M), P^T
//      and dS^T into bf16 A fragments from the rows' LSE and Delta (copied
//      to shared memory by the warpgroup), then dV += P^T dout and dK +=
//      dS^T Q with wgmma RS, dout and Q read MN-major.  No score tile passes
//      through shared memory.
//   Masks only on edge tiles: hopper.cuh's tile_class (the forward's
//   arithmetic) sorts each (rows, key tile) pair; on an edge tile each row
//   (dq) or key (dkdv) sees one interval of columns, two compares a score.
//   kernels/swa_attention.py:backward_dq_tiles / backward_dkdv_tiles repeat
//   the walks and classes for the CPU tests.
//
// Bound: operations.  10 D flops a visible (query, key) pair and query head
// (q.k, dout.v, P^T dout, dS^T q, dS k): 1.30 ms at h2o-danube-1.8b's training
// shape (2 x 8,192 tokens, 32 heads of 80, window 4,096) at 989 TFLOP/s.  This
// design spends 14 D (dq 6 D: q.k, dout.v, dS k; dkdv 8 D: q.k, dout.v, P^T
// dout, dS^T q), 1.82 ms at peak.
// Left out: a persistent scheduler, TMA stores, and issuing the next tile's
// first products behind this tile's second ones (FA3's intra-warpgroup
// pipelining): tried, ptxas serialized every wgmma of both launches (C7515,
// "non wgmma instructions defining accumulator registers") and danube's
// backward took 4.97 ms against this version's 4.07 (H100 80GB HBM3; PERF.md).
#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kRows = 128;     // dq: query rows a block (two warpgroups of 64)
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct BwdCfg {
  static constexpr int KB = D / kBox;          // k-steps along d
  static constexpr bool split_d = D > 128;     // dkdv: the warpgroups split d
  // dq: keys a tile (32 above D = 128, where dQ takes 120-128 registers)
  static constexpr int BN = split_d ? 32 : 64;
  static constexpr int NS_DQ = split_d ? 2 : 3;  // dq ring stages (227 KB)
  // dkdv: keys a block, two warpgroups of 64 keys each, or both on the same
  // 64 keys, each with half of d's boxes (dK and dV of 64 keys at D = 256
  // would take 256 accumulators a thread)
  static constexpr int KEYS = split_d ? 64 : 128;
  static constexpr int KB0 = split_d ? 8 : KB;  // d boxes of warpgroup 0
  static_assert(KB0 <= KB, "warpgroup 0 takes at most every box of d");
  // dkdv: query rows a tile; from D = 128 on, dK and dV take 128
  // accumulators a thread, and S^T and dP^T of 64 rows 64 more
  static constexpr int BM = D > 96 ? 32 : 64;
  static constexpr int NS = 3;                 // dkdv ring stages
  static constexpr uint32_t rows_bytes = kRows * D * 2;  // dq: Q or dout
  static constexpr uint32_t kv_bytes = BN * D * 2;       // dq: K or V of a stage
  static constexpr size_t dq_smem =
      1024 + 2ull * rows_bytes + 2ull * NS_DQ * kv_bytes + (2 * NS_DQ + 1) * sizeof(uint64_t);
  static constexpr uint32_t keys_bytes = KEYS * D * 2;   // dkdv: K or V
  static constexpr uint32_t tile_bytes = BM * D * 2;     // dkdv: Q or dout of a stage
  // per consumer warpgroup, two buffers (alternate tiles) of the LSE and Delta
  static constexpr uint32_t ld_floats = 2 * 2 * 2 * BM;
  static constexpr size_t dkdv_smem = 1024 + 2ull * keys_bytes + 2ull * NS * tile_bytes +
                                      ld_floats * sizeof(float) +
                                      (2 * NS + 1) * sizeof(uint64_t);
};

struct BwdArgs {
  const __nv_bfloat16* o;
  long long sob, soh, sos;
  const __nv_bfloat16* dout;
  long long sdob, sdoh, sdos;
  __nv_bfloat16* dq;
  long long sdqb, sdqh, sdqs;
  __nv_bfloat16* dk;
  long long sdkb, sdkh, sdks;
  __nv_bfloat16* dv;
  long long sdvb, sdvh, sdvs;
  const float* lse;  // (B, Hq, Sq): the forward's natural log-sum-exp, 0 with no key
  float* delta;      // (B, Hq, Sq): sum_d dout o, written by launch 1
  long long q_offset;
  int Hq, Sq, Skv, group, causal, window, kv_len;
  float scale;       // D ** -0.5
  float scale_log2;  // D ** -0.5 * log2(e)
};

// One consumer warpgroup's 128 threads meet at named barrier 1 + c.
__device__ __forceinline__ void wg_bar_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

// The warpgroup index, broadcast so that the compiler knows it is
// warp-uniform (else it treats every branch on it as divergent and
// serializes the wgmma behind it).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(kFull, (int)threadIdx.x / 128, 0);
}

// ---------------------------------------------------------------------------
// launch 1: dQ and Delta
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const BwdArgs a) {
  using C = BwdCfg<D>;
  constexpr int BN = C::BN, KB = C::KB, NS = C::NS_DQ;
  constexpr int kv_elems = C::kv_bytes / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(base + C::rows_bytes);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(base + 2 * C::rows_bytes);
  __nv_bfloat16* Vs = Ks + NS * kv_elems;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + 2 * C::rows_bytes + 2 * NS * C::kv_bytes);
  uint64_t* full = bars;        // [NS]: the stage's K and V landed
  uint64_t* empty = bars + NS;  // [NS]: every consumer warp is done with them
  uint64_t* rbar = bars + 2 * NS;  // Q and dout landed

  const int qt = gridDim.x - 1 - blockIdx.x;  // last query tile first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.group;
  const int q0 = qt * kRows;
  const long long qlo = a.q_offset + q0;
  const long long qhi = a.q_offset + min(q0 + kRows, a.Sq) - 1;
  long long kb, ke;
  visible_keys(a.causal, a.window, a.kv_len, qlo, qhi, &kb, &ke);
  const int t_begin = (int)(kb / BN);
  const int n_tiles = ke > kb ? (int)((ke + BN - 1) / BN) - t_begin : 0;

  const int wg = warpgroup();
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(rbar, 2 * C::rows_bytes);
#pragma unroll 1
      for (int j = 0; j < KB; ++j) {
        tma_load(Qs + j * kRows * kBox, &tq, rbar, j * kBox, q0, h, b);
        tma_load(dOs + j * kRows * kBox, &tdo, rbar, j * kBox, q0, h, b);
      }
#pragma unroll 1
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS, k0 = (t_begin + i) * BN, parity = ((i / NS) & 1) ^ 1;
        mbar_wait(&empty[s], parity);
        mbar_expect_tx(&full[s], 2 * C::kv_bytes);
#pragma unroll 1
        for (int j = 0; j < KB; ++j) {
          tma_load(Ks + s * kv_elems + j * BN * kBox, &tk, &full[s], j * kBox, k0, kvh, b);
          tma_load(Vs + s * kv_elems + j * BN * kBox, &tv, &full[s], j * kBox, k0, kvh, b);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;  // 64-row half of the tile
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
    const int r0 = c * 64 + warp * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8
    const long long qpos[2] = {qlo + r0, qlo + r0 + 8};

    // Delta = sum_d dout o and the log2-domain LSE of the two rows; the quad
    // of lanes that shares a row splits d
    float delta[2], lse2[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int qi = q0 + r0 + 8 * i2;
      float sum = 0.f;
      if (qi < a.Sq) {
        const __nv_bfloat16* orow = a.o + b * a.sob + h * a.soh + qi * a.sos;
        const __nv_bfloat16* grow = a.dout + b * a.sdob + h * a.sdoh + qi * a.sdos;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(orow + 8 * n + 2 * t4));
          const float2 y = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(grow + 8 * n + 2 * t4));
          sum = fmaf(x.x, y.x, sum);
          sum = fmaf(x.y, y.y, sum);
        }
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      delta[i2] = sum;
      const long long idx = ((long long)b * a.Hq + h) * a.Sq + qi;
      lse2[i2] = qi < a.Sq ? a.lse[idx] * kLog2e : 0.f;
      if (t4 == 0 && qi < a.Sq) a.delta[idx] = sum;
    }

    float dq[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;
    float sc[BN / 2], dp[BN / 2];  // S then P then dS; dP
    uint32_t fa[BN / 16][4];       // dS as bf16 A fragments
    const __nv_bfloat16* qa = Qs + c * 64 * kBox;   // this half's rows of box 0
    const __nv_bfloat16* ga = dOs + c * 64 * kBox;

    mbar_wait(rbar, 0);
#pragma unroll 1
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % NS;
      const __nv_bfloat16* kst = Ks + s * kv_elems;
      const __nv_bfloat16* vst = Vs + s * kv_elems;
      mbar_wait(&full[s], (i / NS) & 1);
      wg_fence();
#pragma unroll
      for (int j = 0; j < KB; ++j)
        wgmma_ss(sc, sw32_desc(qa + j * kRows * kBox, 16, 256),
                 sw32_desc(kst + j * BN * kBox, 16, 256), j);
      wg_commit();
#pragma unroll
      for (int j = 0; j < KB; ++j)
        wgmma_ss(dp, sw32_desc(ga + j * kRows * kBox, 16, 256),
                 sw32_desc(vst + j * BN * kBox, 16, 256), j);
      wg_commit();
      wg_wait<1>();  // S is done; dP may still run
      fence_regs(sc);
      const int k0 = (t_begin + i) * BN;
      if (tile_class(a.causal, a.window, a.kv_len, qlo, qhi, k0, BN) == kEdge) {
        // row i2 sees the tile's columns [lo, hi] (relative to k0, clamped
        // to [-1, BN]): j < kv_len, j <= qpos (causal), j > qpos - window
        int lo[2], hi[2];
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          long long hh = (long long)a.kv_len - 1, ll = 0;
          if (a.causal) hh = min(hh, qpos[i2]);
          if (a.window > 0) ll = max(ll, qpos[i2] - a.window + 1);
          lo[i2] = (int)max(-1LL, min((long long)BN, ll - k0));
          hi[i2] = (int)max(-1LL, min((long long)BN, hh - k0));
        }
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          const int col = 8 * (e >> 2) + 2 * t4 + (e & 1);
          const int i2 = (e >> 1) & 1;
          if (col < lo[i2] || col > hi[i2]) sc[e] = -INFINITY;
        }
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int i2 = (e >> 1) & 1;
        sc[e] = ex2(fmaf(sc[e], a.scale_log2, -lse2[i2]));  // P; a masked score gives 0
      }
      wg_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) sc[e] *= dp[e] - delta[(e >> 1) & 1];  // dS
      pack_p<BN>(sc, fa);
      fence_regs(dq);
      wg_fence();
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        wgmma_rs(dq, fa[j], sw32_desc(kst + j * 16 * kBox, BN * kBox * 2, 256));
      wg_commit();
      wg_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with K and V
    }

#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int qi = q0 + r0 + 8 * i2;
      if (qi >= a.Sq) continue;
      __nv_bfloat16* row = a.dq + b * a.sdqb + h * a.sdqh + qi * a.sdqs;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int e = 4 * n + 2 * i2;
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + 2 * t4) =
            __floats2bfloat162_rn(dq[e] * a.scale, dq[e + 1] * a.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch 2: dK and dV
// ---------------------------------------------------------------------------

// Row positions [*p_lo, *p_hi] (0 <= p < Sq) that see a key of [k0, k0 +
// keys); empty when *p_hi < *p_lo (csrc/swa_backward.cu's row range).
__device__ __forceinline__ void visible_rows(const BwdArgs& a, long long k0, int keys,
                                             long long* p_lo, long long* p_hi) {
  const long long k_last = min(k0 + keys, (long long)a.kv_len) - 1;
  *p_lo = 0;
  *p_hi = -1;
  if (k_last < k0) return;
  *p_lo = a.causal ? max(0LL, k0 - a.q_offset) : 0;
  *p_hi = a.window > 0 ? min((long long)a.Sq - 1, k_last + a.window - 1 - a.q_offset)
                       : (long long)a.Sq - 1;
}

// One consumer warpgroup of the dkdv launch: the 64 keys from k0 and the DN
// columns of d from box b0 of their dK and dV, over the block's n row tiles.
template <int D, int DN>
__device__ __forceinline__ void dkdv_consumer(const BwdArgs& a, const __nv_bfloat16* Ks,
                                              const __nv_bfloat16* Vs, const __nv_bfloat16* Qs,
                                              const __nv_bfloat16* dOs, float* ld,
                                              uint64_t* full, uint64_t* empty, uint64_t* kvbar,
                                              int c, long long k0, int b0, int kvh, int b,
                                              int n, int n_rt, int rt_begin) {
  using C = BwdCfg<D>;
  constexpr int BM = C::BM, KB = C::KB, NS = C::NS, KEYS = C::KEYS;
  constexpr int tile_elems = C::tile_bytes / 2;
  const int tid = threadIdx.x - 128 * (c + 1);
  const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const long long key[2] = {k0 + warp * 16 + (lane >> 2), k0 + warp * 16 + (lane >> 2) + 8};

  float dk[DN / 2], dv[DN / 2];
#pragma unroll
  for (int e = 0; e < DN / 2; ++e) dk[e] = 0.f, dv[e] = 0.f;
  float st[BM / 2], dpt[BM / 2];  // S^T then P^T; dP^T then dS^T
  uint32_t pf[BM / 16][4], df[BM / 16][4];  // P^T and dS^T as bf16 A fragments
  const long long kofs = k0 - blockIdx.x * (long long)KEYS;   // this half's first key
  const __nv_bfloat16* ka = Ks + kofs * kBox;  // box 0 of its keys
  const __nv_bfloat16* va = Vs + kofs * kBox;

  mbar_wait(kvbar, 0);
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int s = i % NS;
    const int hh = kvh * a.group + i / n_rt, p0 = (rt_begin + i % n_rt) * BM;
    const __nv_bfloat16* qst = Qs + s * tile_elems;
    const __nv_bfloat16* gst = dOs + s * tile_elems;
    // this warpgroup's copy of the tile's LSE (log2 domain) and Delta:
    // thread t < BM loads row t's LSE, BM <= t < 2 BM row t - BM's Delta
    float* ldt = ld + (i & 1) * 2 * BM;
    if (tid < 2 * BM) {
      const int p = p0 + (tid % BM);
      const long long idx = ((long long)b * a.Hq + hh) * a.Sq + p;
      ldt[tid] = p < a.Sq ? (tid < BM ? a.lse[idx] * kLog2e : a.delta[idx]) : 0.f;
    }
    mbar_wait(&full[s], (i / NS) & 1);
    wg_fence();
#pragma unroll
    for (int j = 0; j < KB; ++j)
      wgmma_ss(st, sw32_desc(ka + j * KEYS * kBox, 16, 256),
               sw32_desc(qst + j * BM * kBox, 16, 256), j);
    wg_commit();
#pragma unroll
    for (int j = 0; j < KB; ++j)
      wgmma_ss(dpt, sw32_desc(va + j * KEYS * kBox, 16, 256),
               sw32_desc(gst + j * BM * kBox, 16, 256), j);
    wg_commit();
    wg_bar_sync(c);  // the LSE and Delta copy is complete
    wg_wait<1>();    // S^T is done; dP^T may still run
    fence_regs(st);
    // edge tiles: rows past Sq, the causal diagonal, the window's edge,
    // keys at or past kv_len (a tile past every row is masked whole)
    const long long qlo = a.q_offset + p0;
    const long long qhi = a.q_offset + min(p0 + BM, a.Sq) - 1;
    if (p0 + BM > a.Sq ||
        tile_class(a.causal, a.window, a.kv_len, qlo, qhi, k0, 64) != kFullTile) {
      // key i2 is seen by the tile's columns (rows p0 + col) [lo, hi],
      // clamped to [-1, BM]: p < Sq, qpos >= key (causal), qpos < key +
      // window (window > 0), and none when key >= kv_len
      int lo[2], hi[2];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        long long ll = a.causal ? key[i2] - qlo : 0;
        long long hh2 = (long long)a.Sq - 1 - p0;
        if (a.window > 0) hh2 = min(hh2, key[i2] + a.window - 1 - qlo);
        if (key[i2] >= a.kv_len) hh2 = -1;
        lo[i2] = (int)max(-1LL, min((long long)BM, ll));
        hi[i2] = (int)max(-1LL, min((long long)BM, hh2));
      }
#pragma unroll
      for (int e = 0; e < BM / 2; ++e) {
        const int col = 8 * (e >> 2) + 2 * t4 + (e & 1);
        const int i2 = (e >> 1) & 1;
        if (col < lo[i2] || col > hi[i2]) st[e] = -INFINITY;
      }
    }
#pragma unroll
    for (int nn = 0; nn < BM / 8; ++nn) {
      const float2 L = *reinterpret_cast<const float2*>(ldt + 8 * nn + 2 * t4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 4 * nn + q;
        st[e] = ex2(fmaf(st[e], a.scale_log2, -((q & 1) ? L.y : L.x)));  // P^T
      }
    }
    pack_p<BM>(st, pf);
    wg_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int nn = 0; nn < BM / 8; ++nn) {
      const float2 Dl = *reinterpret_cast<const float2*>(ldt + BM + 8 * nn + 2 * t4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 4 * nn + q;
        dpt[e] = st[e] * (dpt[e] - ((q & 1) ? Dl.y : Dl.x));  // dS^T
      }
    }
    pack_p<BM>(dpt, df);
    fence_regs(dv);
    fence_regs(dk);
    wg_fence();
    // this warpgroup's columns of d start at box b0 of the dout and Q tiles
#pragma unroll
    for (int j = 0; j < BM / 16; ++j)
      wgmma_rs(dv, pf[j], sw32_desc(gst + (b0 * BM + j * 16) * kBox, BM * kBox * 2, 256));
#pragma unroll
    for (int j = 0; j < BM / 16; ++j)
      wgmma_rs(dk, df[j], sw32_desc(qst + (b0 * BM + j * 16) * kBox, BM * kBox * 2, 256));
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with Q and dout
  }

#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    if (key[i2] >= a.Skv) continue;
    __nv_bfloat16* krow = a.dk + b * a.sdkb + kvh * a.sdkh + key[i2] * a.sdks + b0 * kBox;
    __nv_bfloat16* vrow = a.dv + b * a.sdvb + kvh * a.sdvh + key[i2] * a.sdvs + b0 * kBox;
#pragma unroll
    for (int nn = 0; nn < DN / 8; ++nn) {
      const int e = 4 * nn + 2 * i2;
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * nn + 2 * t4) =
          __floats2bfloat162_rn(dk[e] * a.scale, dk[e + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * nn + 2 * t4) =
          __floats2bfloat162_rn(dv[e], dv[e + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const BwdArgs a) {
  using C = BwdCfg<D>;
  constexpr int BM = C::BM, KB = C::KB, NS = C::NS, KEYS = C::KEYS;
  constexpr int tile_elems = C::tile_bytes / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(base + C::keys_bytes);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(base + 2 * C::keys_bytes);
  __nv_bfloat16* dOs = Qs + NS * tile_elems;
  float* LD = reinterpret_cast<float*>(base + 2 * C::keys_bytes + 2 * NS * C::tile_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(LD + C::ld_floats);
  uint64_t* full = bars;           // [NS]: the stage's Q and dout landed
  uint64_t* empty = bars + NS;     // [NS]: every consumer warp is done with them
  uint64_t* kvbar = bars + 2 * NS;  // K and V landed

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int K0 = blockIdx.x * KEYS;
  long long p_lo, p_hi;
  visible_rows(a, K0, KEYS, &p_lo, &p_hi);
  const int rt_begin = (int)(p_lo / BM);
  const int n_rt = p_hi >= p_lo ? (int)(p_hi / BM) - rt_begin + 1 : 0;
  const int n = a.group * n_rt;  // row tiles: every head of the group

  const int wg = warpgroup();
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kvbar, 2 * C::keys_bytes);
#pragma unroll 1
      for (int j = 0; j < KB; ++j) {
        tma_load(Ks + j * KEYS * kBox, &tk, kvbar, j * kBox, K0, kvh, b);
        tma_load(Vs + j * KEYS * kBox, &tv, kvbar, j * kBox, K0, kvh, b);
      }
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const int s = i % NS, parity = ((i / NS) & 1) ^ 1;
        const int hh = kvh * a.group + i / n_rt, p0 = (rt_begin + i % n_rt) * BM;
        mbar_wait(&empty[s], parity);
        mbar_expect_tx(&full[s], 2 * C::tile_bytes);
#pragma unroll 1
        for (int j = 0; j < KB; ++j) {
          tma_load(Qs + s * tile_elems + j * BM * kBox, &tq, &full[s], j * kBox, p0, hh, b);
          tma_load(dOs + s * tile_elems + j * BM * kBox, &tdo, &full[s], j * kBox, p0, hh, b);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    float* ld = LD + c * (2 * 2 * BM);  // [tile parity][LSE (log2), Delta][BM]
    if constexpr (!C::split_d) {  // 64 keys each, all of d
      dkdv_consumer<D, D>(a, Ks, Vs, Qs, dOs, ld, full, empty, kvbar, c, K0 + 64 * c, 0, kvh, b,
                          n, n_rt, rt_begin);
    } else if (c == 0) {  // the same 64 keys, boxes [0, KB0) and [KB0, KB) of d
      dkdv_consumer<D, 16 * C::KB0>(a, Ks, Vs, Qs, dOs, ld, full, empty, kvbar, 0, K0, 0, kvh, b,
                                    n, n_rt, rt_begin);
    } else {
      dkdv_consumer<D, D - 16 * C::KB0>(a, Ks, Vs, Qs, dOs, ld, full, empty, kvbar, 1, K0,
                                        C::KB0, kvh, b, n, n_rt, rt_begin);
    }
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and the launches
// ---------------------------------------------------------------------------
struct Operand {  // pointer and (b, h, s) element strides
  const void* p;
  long long sb, sh, ss;
};

template <int D>
int launch(const Operand& q, const Operand& k, const Operand& v, const Operand& g,
           const BwdArgs& a, int B, int Hkv, cudaStream_t st) {
  using C = BwdCfg<D>;
  // launch 1 reads 128-row Q/dout boxes and 64-key K/V boxes; launch 2
  // 128-key K/V boxes and BM-row Q/dout boxes
  CUtensorMap q1, g1, k1, v1, q2, g2, k2, v2;
  if (!make_map(&q1, q.p, B, a.Hq, a.Sq, D, q.sb, q.sh, q.ss, kRows) ||
      !make_map(&g1, g.p, B, a.Hq, a.Sq, D, g.sb, g.sh, g.ss, kRows) ||
      !make_map(&k1, k.p, B, Hkv, a.kv_len, D, k.sb, k.sh, k.ss, C::BN) ||
      !make_map(&v1, v.p, B, Hkv, a.kv_len, D, v.sb, v.sh, v.ss, C::BN) ||
      !make_map(&q2, q.p, B, a.Hq, a.Sq, D, q.sb, q.sh, q.ss, C::BM) ||
      !make_map(&g2, g.p, B, a.Hq, a.Sq, D, g.sb, g.sh, g.ss, C::BM) ||
      !make_map(&k2, k.p, B, Hkv, a.kv_len, D, k.sb, k.sh, k.ss, C::KEYS) ||
      !make_map(&v2, v.p, B, Hkv, a.kv_len, D, v.sb, v.sh, v.ss, C::KEYS))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::dq_smem);
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::dkdv_smem);
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  const dim3 grid_dq((unsigned)((a.Sq + kRows - 1) / kRows), (unsigned)a.Hq, (unsigned)B);
  bwd_dq_wgmma<D><<<grid_dq, kThreads, C::dq_smem, st>>>(q1, g1, k1, v1, a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((unsigned)((a.Skv + C::KEYS - 1) / C::KEYS), (unsigned)Hkv, (unsigned)B);
  bwd_dkdv_wgmma<D><<<grid_kv, kThreads, C::dkdv_smem, st>>>(q2, g2, k2, v2, a);
  return (int)cudaGetLastError();
}

}  // namespace

// The tile plan that kernels/swa_attention.py's Python twins repeat, so that
// a check on the card can hold them to it: tiles[0..3] = query rows of a dq
// block, keys of a dq tile, keys of a dkdv block, query rows of a dkdv tile.
extern "C" int repro_flash_attention_bwd_bf16_tiles(int D, int* tiles) {
  switch (D) {
#define REPRO_BWD_TILES(d)                                                \
  case d:                                                                 \
    tiles[0] = kRows; tiles[1] = BwdCfg<d>::BN; tiles[2] = BwdCfg<d>::KEYS; \
    tiles[3] = BwdCfg<d>::BM;                                             \
    return 0;
    REPRO_BWD_TILES(16) REPRO_BWD_TILES(32) REPRO_BWD_TILES(64) REPRO_BWD_TILES(80)
    REPRO_BWD_TILES(96) REPRO_BWD_TILES(128) REPRO_BWD_TILES(240) REPRO_BWD_TILES(256)
#undef REPRO_BWD_TILES
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k, v, o, dout, dq, dk, dv: bf16, element strides (b, h, s) each, unit
// stride on d; q, k, v and dout 16-byte aligned with strides that are
// multiples of 8 elements (TMA's rule), o 4-byte aligned with even strides.
// lse: the forward's (B, Hq, Sq) fp32 log-sum-exp; delta: an fp32 workspace of
// B * Hq * Sq floats.  Sq >= 1 and Skv >= 1.  Writes every element of dq, dk
// and dv.  Returns the launch error (0 when launched); an encoding failure of
// a tensor map is cudaErrorInvalidValue.
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
    void* dk, void* dv, const void* lse, void* delta, long long sqb, long long sqh, long long sqs,
    long long skb, long long skh, long long sks, long long svb, long long svh, long long svs,
    long long sob, long long soh, long long sos, long long sdob, long long sdoh, long long sdos,
    long long sdqb, long long sdqh, long long sdqs, long long sdkb, long long sdkh, long long sdks,
    long long sdvb, long long sdvh, long long sdvs, int B, int Hq, int Hkv, int Sq, int Skv, int D,
    int causal, int window, long long q_offset, int kv_len, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || kv_len < 0 || kv_len > Skv || window < 0 || Sq <= 0 ||
      Skv <= 0 || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.sob = sob; a.soh = soh; a.sos = sos;
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.sdob = sdob; a.sdoh = sdoh; a.sdos = sdos;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.sdqb = sdqb; a.sdqh = sdqh; a.sdqs = sdqs;
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.sdkb = sdkb; a.sdkh = sdkh; a.sdks = sdks;
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.sdvb = sdvb; a.sdvh = sdvh; a.sdvs = sdvs;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.q_offset = q_offset;
  a.Hq = Hq;
  a.Sq = Sq;
  a.Skv = Skv;
  a.group = Hq / Hkv;
  a.causal = causal;
  a.window = window;
  a.kv_len = kv_len;
  a.scale = (float)(1.0 / sqrt((double)D));
  a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const Operand oq{q, sqb, sqh, sqs}, ok{k, skb, skh, sks}, ov{v, svb, svh, svs},
      og{dout, sdob, sdoh, sdos};
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(oq, ok, ov, og, a, B, Hkv, st);
    case 32: return launch<32>(oq, ok, ov, og, a, B, Hkv, st);
    case 64: return launch<64>(oq, ok, ov, og, a, B, Hkv, st);
    case 80: return launch<80>(oq, ok, ov, og, a, B, Hkv, st);
    case 96: return launch<96>(oq, ok, ov, og, a, B, Hkv, st);
    case 128: return launch<128>(oq, ok, ov, og, a, B, Hkv, st);
    case 240: return launch<240>(oq, ok, ov, og, a, B, Hkv, st);
    case 256: return launch<256>(oq, ok, ov, og, a, B, Hkv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
