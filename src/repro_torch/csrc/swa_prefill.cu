// B6, bf16 prefill: flash attention forward with GQA, causal and
// sliding-window masks, a query offset and KV-length masking, written for
// Hopper (sm_90a) with TMA, mbarriers, warp specialisation and wgmma.
//
// Replaces the Pallas TPU kernel repro/kernels/swa_attention.py:
// flash_swa_attention (:98, pallas_call at :137) on every bf16 call that
// does not take the decode route (group * Sq > 16 rows per KV head; see
// csrc/swa_decode.cu).  The semantics are that kernel's, as the header of
// csrc/swa_attention.cu states them: element strides for the b, h and s
// axes (unit stride on d), query row i at position q_offset + i reading KV
// head h / (Hq / Hkv), key j visible when j < kv_len, j <= qpos (causal) and
// j > qpos - window (window > 0), scores scaled by D**-0.5, softmax and sums
// in fp32, P rounded to bf16 for P V, the output in q's type and strides, a
// row with no visible key exactly 0.  Given an lse buffer (B, Hq, Sq, fp32,
// the training forward's), it also writes each row's log-sum-exp of the
// scaled scores in natural log, (m + log2 l) ln 2 from the epilogue's row
// maximum m (log2 domain) and sum l, and 0 for a row with no visible key;
// csrc/swa_backward_bf16.cu reads it.  Serving passes none.
//
// Bound: operations.  4 D flops per visible (query, key) pair and query
// head: h2o-danube-1.8b's prefill at B = 2, S = 8,192, window 4,096 (32 heads
// of 80) is 0.52 ms at 989 TFLOP/s; gemma3-12b's global layer at S = 4,096
// (16 heads of 240, causal) 0.13 ms.
//
// What held the earlier mma.sync kernel back: every thread copied K/V tiles
// through registers into shared memory and then waited at __syncthreads
// for the copy before any product, so no load overlapped a product; each
// warp fetched its own fragments with scalar shared-memory loads; the
// m16n8k16 tensor-core instruction reaches a fraction of Hopper's rate; and
// masks were evaluated on every tile.
//
// Design.  One block of three warpgroups per (tile of 128 query rows, query
// head, batch); query tiles are walked last first, so the long causal rows
// start early.
//   * Producer (warpgroup 0; one thread issues, the other warps retire):
//     TMA (cp.async.bulk.tensor) loads the block's Q tile once, then the K
//     and V tiles of the visible key range into two rings in dynamic shared
//     memory (3 stages up to D = 128, 2 above), each stage with a "full"
//     mbarrier (the TMA transaction count) and an "empty" one (the consumer
//     warps' arrivals).  K and V have rings of their own because K is free
//     as soon as S is done and V only after P V.  The tensor maps are 4-D
//     over (d, s, h, b) with the call's strides, so the model's (B, S, H, D)
//     views load without a copy; their s extent is Sq for Q and kv_len for
//     K/V, so rows past them arrive as zeros (a key past kv_len never meets
//     an uninitialised cache slot).  Every box is 16 elements (32 bytes) of
//     d by the tile's rows with the 32-byte swizzle: it fits every head dim
//     that is a multiple of 16 (80, 96 and 240 are not multiples of 64, which
//     the 128-byte swizzle wants) without padding d, and an 8-row wgmma core
//     matrix reads it without bank conflicts.  setmaxnreg gives the
//     producer 24 registers and each consumer thread 240.
//   * Two consumer warpgroups, 64 query rows each.  Per key tile:
//     S = Q K^T with wgmma.mma_async m64nBNk16 (Q and K K-major in shared
//     memory), fp32 accumulators in registers; the online softmax in the
//     log2 domain (one FFMA and one ex2.approx a score); O += P V with
//     wgmma m64nDk16, P from registers (the score accumulators re-packed to
//     bf16 A fragments) and V read MN-major (transposed) from shared
//     memory.  BN = 128 keys a tile up to D = 128, 64 at D = 240/256, where
//     O alone takes 120-128 registers a thread.  Iteration i issues S of
//     tile i and P V of tile i - 1 together and runs tile i's softmax while
//     the tensor cores do P V (FA3's intra-warpgroup overlap).  Up to
//     D = 128 the two warpgroups also take turns at the tensor cores
//     through two named barriers (FA3's ping-pong), so that one's softmax
//     runs under the other's products.
//   * Masks only where they cut.  prefill_tile_class sorts each (query
//     tile, key tile) pair into skipped (outside the loop's key range),
//     full (every row sees every key: no mask arithmetic) or edge (the
//     causal diagonal, the window's lower edge or kv_len), where each row's
//     visible columns are one interval and a score takes two compares;
//     kernels/swa_attention.py:prefill_tile_class repeats the arithmetic
//     so that the CPU tests can check it against the dense mask.
//   * GQA: one query head a block; the group's heads read the same K/V
//     tiles from L2.  Packing the group's heads into one block's rows
//     would not cut the traffic at prefill sizes: a block's key range is
//     the window (or the causal prefix), not its query rows.
// The PTX helpers (mbarriers, TMA, wgmma), the tensor maps and the tile
// classes are csrc/hopper.cuh's, shared with csrc/swa_backward_bf16.cu.
// Left out: a persistent tile scheduler, a TMA store of O, the 128-byte
// swizzle where D is a multiple of 64, clusters with TMA multicast.
#include "hopper.cuh"

namespace {

constexpr float kMasked = -1e30f;  // running max of a row that saw no key yet (finite)
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBM = 128;           // query rows a block: two consumer warpgroups of 64
constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups

struct PrefillArgs {
  __nv_bfloat16* o;
  long long sob, soh, sos;
  long long q_offset;
  int Sq, Hkv, group, causal, window, kv_len;
  float scale_log2;  // D ** -0.5 * log2(e), for ex2
  float* lse;        // (B, Hq, Sq) fp32, each row's natural log-sum-exp; null: not kept
};

// Keys [*begin, *end) that the rows at positions [qlo, qhi] can see; empty
// when *end <= *begin (csrc/swa_attention.cu's key_range).
__device__ __forceinline__ void key_range(const PrefillArgs& a, long long qlo, long long qhi,
                                          long long* begin, long long* end) {
  visible_keys(a.causal, a.window, a.kv_len, qlo, qhi, begin, end);
}

// The class of the pair (rows at positions [qlo, qhi], keys [k0, k0 + bn)).
// kernels/swa_attention.py:prefill_tile_class repeats this arithmetic.
__device__ __forceinline__ int prefill_tile_class(const PrefillArgs& a, long long qlo,
                                                  long long qhi, long long k0, int bn) {
  return tile_class(a.causal, a.window, a.kv_len, qlo, qhi, k0, bn);
}

// Named barriers 1 and 2 order the two consumer warpgroups' turns at the
// tensor cores (0 is __syncthreads); each counts both warpgroups' 256 threads.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int D>
struct PrefillCfg {
  static constexpr int BN = D > 128 ? 64 : 128;        // keys a tile
  static constexpr int KB = D / kBox;                  // boxes (k-steps) along d
  // three K/V stages where they fit in 227 KB beside Q, else two
  static constexpr int stages = D > 128 ? 2 : 3;
  // the consumers take turns at the tensor cores (ping-pong) up to
  // D = 128, where it saves 0.5-6 % (H100, danube's prefill shape at D = 80
  // and 128); at D = 240, where the products outweigh the softmax, it
  // gained nothing (+1.7 % on gemma3's global shape, -1 % on its local)
  static constexpr bool ping_pong = D <= 128;
  static constexpr uint32_t q_bytes = kBM * D * 2;
  static constexpr uint32_t kv_bytes = BN * D * 2;     // one of K, V in one stage
  static constexpr size_t smem =
      1024 + q_bytes + 2ull * stages * kv_bytes + (4 * stages + 1) * sizeof(uint64_t);
};

// One consumer warpgroup's online softmax over a BN-key tile of raw scores
// `sc` (64 rows x BN keys, two rows a thread): masks (edge tiles only), the
// row maxima over the quad, p = 2^(s * scale_log2 - m) in place, the row
// sums; returns the rescale factors of the two rows in alpha.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge, int k0, int t4,
                                             const long long (&qpos)[2],
                                             const PrefillArgs& a) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (edge) {
    // row i2 sees the tile's columns [lo, hi]: j < kv_len, j <= qpos
    // (causal), j > qpos - window (window > 0), relative to k0 and clamped
    // to [-1, BN], so that each score takes two 32-bit compares
    int lo[2], hi[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      long long h = (long long)a.kv_len - 1, l = 0;
      if (a.causal) h = min(h, qpos[i2]);
      if (a.window > 0) l = max(l, qpos[i2] - a.window + 1);
      lo[i2] = (int)max(-1LL, min((long long)BN, l - k0));
      hi[i2] = (int)max(-1LL, min((long long)BN, h - k0));
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int col = 8 * (e >> 2) + 2 * t4 + (e & 1);
      const int i2 = (e >> 1) & 1;
      if (col < lo[i2] || col > hi[i2]) sc[e] = -INFINITY;
      mx[i2] = fmaxf(mx[i2], sc[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
  }
  float ms[2];  // the new maxima, negated, in the log2 domain
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(kFull, mx[i2], 1));
    mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(kFull, mx[i2], 2));
    // m stays finite (kMasked) while a row has seen no key: 2^(-inf - m) = 0
    const float mnew = fmaxf(m[i2], mx[i2] * a.scale_log2);
    alpha[i2] = ex2(m[i2] - mnew);
    m[i2] = mnew;
    ms[i2] = -mnew;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    const int i2 = (e >> 1) & 1;
    sc[e] = ex2(fmaf(sc[e], a.scale_log2, ms[i2]));
    ls[i2] += sc[e];
  }
  l[0] = l[0] * alpha[0] + ls[0];
  l[1] = l[1] * alpha[1] + ls[1];
}

// S = Q K^T of one tile (K at kst), 64 rows x BN keys: KB k-steps of 16,
// issued asynchronously as one committed group.
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[PrefillCfg<D>::BN / 2],
                                        const __nv_bfloat16* qa, const __nv_bfloat16* kst) {
  constexpr int BN = PrefillCfg<D>::BN;
#pragma unroll
  for (int j = 0; j < PrefillCfg<D>::KB; ++j)
    wgmma_ss(sc, sw32_desc(qa + j * kBM * kBox, 16, 256), sw32_desc(kst + j * BN * kBox, 16, 256),
             j);
  wg_commit();
}


// O += P V of one tile (V at vst): BN / 16 k-steps, one committed group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[PrefillCfg<D>::BN / 16][4],
                                         const __nv_bfloat16* vst) {
  constexpr int BN = PrefillCfg<D>::BN;
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wgmma_rs(o, pa[j], sw32_desc(vst + j * 16 * kBox, BN * kBox * 2, 256));
  wg_commit();
}

// Consumer c's turn at the tensor cores (ping-pong): wait for it, then hand
// the next turn to the other warpgroup (consumer 1 keeps its last).
template <bool kOn>
__device__ __forceinline__ void turn_begin(int c) {
  if (kOn) bar_sync(1 + c);
}
template <bool kOn>
__device__ __forceinline__ void turn_end(int c, bool last) {
  if (kOn && !(last && c == 1)) bar_arrive(2 - c);
}

__device__ __forceinline__ bool is_edge(const PrefillArgs& a, long long qlo, long long qhi,
                                        int tile, int bn) {
  return prefill_tile_class(a, qlo, qhi, (long long)tile * bn, bn) == kEdge;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const PrefillArgs a) {
  using C = PrefillCfg<D>;
  constexpr int BN = C::BN, KB = C::KB, NS = C::stages;
  extern __shared__ unsigned char smem_raw[];
  // every buffer on a 1,024-byte boundary (the swizzle's pattern repeats
  // every 256 bytes; TMA wants 128)
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(base + C::q_bytes);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(base + C::q_bytes + NS * C::kv_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + C::q_bytes + 2 * NS * C::kv_bytes);
  // K and V have rings of their own: K is free once S is done, V once P V is
  uint64_t* full_k = bars;            // [NS]: the K tile landed
  uint64_t* full_v = bars + NS;       // [NS]: the V tile landed
  uint64_t* empty_k = bars + 2 * NS;  // [NS]: both consumers are done with K
  uint64_t* empty_v = bars + 3 * NS;  // [NS]: ... with V
  uint64_t* qbar = bars + 4 * NS;

  const int qt = gridDim.x - 1 - blockIdx.x;  // last query tile first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.group;
  const int q0 = qt * kBM;
  const long long qlo = a.q_offset + q0;
  const long long qhi = a.q_offset + min(q0 + kBM, a.Sq) - 1;
  long long kb, ke;
  key_range(a, qlo, qhi, &kb, &ke);
  const int t_begin = (int)(kb / BN);
  const int n_tiles = ke > kb ? (int)((ke + BN - 1) / BN) - t_begin : 0;

  // the warpgroup index, broadcast so that the compiler knows it is
  // warp-uniform (else it treats every branch on it as divergent and
  // serializes the wgmma behind it)
  const int wg = __shfl_sync(kFull, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);  // one arrival per consumer warp
      mbar_init(&empty_v[s], 8);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, C::q_bytes);
#pragma unroll 1
      for (int j = 0; j < KB; ++j) tma_load(Qs + j * kBM * kBox, &tq, qbar, j * kBox, q0, h, b);
#pragma unroll 1
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS, k0 = (t_begin + i) * BN, parity = ((i / NS) & 1) ^ 1;
        __nv_bfloat16* kd = Ks + s * (C::kv_bytes / 2);
        __nv_bfloat16* vd = Vs + s * (C::kv_bytes / 2);
        mbar_wait(&empty_k[s], parity);
        mbar_expect_tx(&full_k[s], C::kv_bytes);
#pragma unroll 1
        for (int j = 0; j < KB; ++j)
          tma_load(kd + j * BN * kBox, &tk, &full_k[s], j * kBox, k0, kvh, b);
        mbar_wait(&empty_v[s], parity);
        mbar_expect_tx(&full_v[s], C::kv_bytes);
#pragma unroll 1
        for (int j = 0; j < KB; ++j)
          tma_load(vd + j * BN * kBox, &tv, &full_v[s], j * kBox, k0, kvh, b);
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;                       // 64-row half of the tile
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
    const int r0 = c * 64 + warp * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8
    const long long qpos[2] = {qlo + r0, qlo + r0 + 8};
    const __nv_bfloat16* qa = Qs + c * 64 * kBox;     // this half's rows of box 0

    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, alpha[2];
    float sc[BN / 2];            // scores, then probabilities, of the newest tile
    uint32_t pa[BN / 16][4];     // P of the tile whose P V is next, bf16 A fragments

    // Ping-pong (C::ping_pong): the warpgroups take turns issuing their
    // products (consumer 0 first), so that one's softmax runs while the
    // other's products do.  Each warpgroup has n_tiles + 1 turns; consumer
    // 1 opens consumer 0's first and does not hand back after its last, so
    // both barriers end balanced.
    if (C::ping_pong && c == 1 && n_tiles > 0) bar_arrive(1);

    mbar_wait(qbar, 0);
    if (n_tiles > 0) {
      // tile 0: S, then its softmax
      mbar_wait(&full_k[0], 0);
      turn_begin<C::ping_pong>(c);
      wg_fence();
      issue_s<D>(sc, qa, Ks);
      turn_end<C::ping_pong>(c, false);
      wg_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(&empty_k[0]);
      softmax_tile<BN>(sc, m, l, alpha, is_edge(a, qlo, qhi, t_begin, BN), t_begin * BN, t4,
                       qpos, a);
      pack_p<BN>(sc, pa);
      // Tiles 1 .. n - 1: S of tile i and P V of tile i - 1 issued back to
      // back; the softmax of tile i runs while the tensor cores do P V.
#pragma unroll 1
      for (int i = 1; i < n_tiles; ++i) {
        mbar_wait(&full_k[i % NS], (i / NS) & 1);
        mbar_wait(&full_v[(i - 1) % NS], ((i - 1) / NS) & 1);
        fence_regs(o);
        turn_begin<C::ping_pong>(c);
        wg_fence();
        issue_s<D>(sc, qa, Ks + (i % NS) * (C::kv_bytes / 2));
        issue_pv<D>(o, pa, Vs + ((i - 1) % NS) * (C::kv_bytes / 2));
        turn_end<C::ping_pong>(c, false);
        wg_wait<1>();  // S of tile i is done; P V may still run
        fence_regs(sc);
        if (lane == 0) mbar_arrive(&empty_k[i % NS]);
        softmax_tile<BN>(sc, m, l, alpha, is_edge(a, qlo, qhi, t_begin + i, BN),
                         (t_begin + i) * BN, t4, qpos, a);
        wg_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(&empty_v[(i - 1) % NS]);  // this warp is done with V
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
        pack_p<BN>(sc, pa);
      }
      // P V of the last tile
      const int last = n_tiles - 1;
      mbar_wait(&full_v[last % NS], (last / NS) & 1);
      fence_regs(o);
      turn_begin<C::ping_pong>(c);
      wg_fence();
      issue_pv<D>(o, pa, Vs + (last % NS) * (C::kv_bytes / 2));
      turn_end<C::ping_pong>(c, true);
      wg_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty_v[last % NS]);
    }

#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      l[i2] += __shfl_xor_sync(kFull, l[i2], 1);
      l[i2] += __shfl_xor_sync(kFull, l[i2], 2);
      // the row's log-sum-exp for the backward, 0 for a row with no visible key
      const int qi = q0 + r0 + 8 * i2;
      if (a.lse != nullptr && t4 == 0 && qi < a.Sq)
        a.lse[((long long)b * gridDim.y + h) * a.Sq + qi] =
            l[i2] > 0.f ? (m[i2] + log2f(l[i2])) * kLn2 : 0.f;
      l[i2] = l[i2] > 0.f ? 1.f / l[i2] : 0.f;  // a row with no visible key is 0
    }
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int qi = q0 + r0 + 8 * i2;
      if (qi >= a.Sq) continue;
      __nv_bfloat16* orow = a.o + b * a.sob + h * a.soh + qi * a.sos;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int e = 4 * n + 2 * i2;
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t4) =
            __floats2bfloat162_rn(o[e] * l[i2], o[e + 1] * l[i2]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host: the launch
// ---------------------------------------------------------------------------
// q, k, v: (pointer, b, h, s element strides) of the call.
struct Operand {
  const void* p;
  long long sb, sh, ss;
};

template <int D>
int launch(const Operand& q, const Operand& k, const Operand& v, const PrefillArgs& a, int B,
           int Hq, cudaStream_t st) {
  using C = PrefillCfg<D>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q.p, B, Hq, a.Sq, D, q.sb, q.sh, q.ss, kBM) ||
      !make_map(&tk, k.p, B, a.Hkv, a.kv_len, D, k.sb, k.sh, k.ss, C::BN) ||
      !make_map(&tv, v.p, B, a.Hkv, a.kv_len, D, v.sb, v.sh, v.ss, C::BN))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((a.Sq + kBM - 1) / kBM), (unsigned)Hq, (unsigned)B);
  flash_wgmma<D><<<grid, kThreads, C::smem, st>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 prefill route of repro_flash_attention (csrc/swa_attention.cu),
// which has checked the shapes.  q, k, v: 16-byte aligned, element strides
// multiples of 8 on every axis longer than 1 (TMA's 16-byte rule).
// lse: null, or (B, Hq, Sq) fp32 for each row's log-sum-exp (the backward's).
// Returns the launch error (0 when launched); an encoding failure of a
// tensor map is cudaErrorInvalidValue.
extern "C" int repro_flash_prefill_bf16(const void* q, const void* k, const void* v, void* o,
                                        long long sqb, long long sqh, long long sqs,
                                        long long skb, long long skh, long long sks,
                                        long long svb, long long svh, long long svs,
                                        long long sob, long long soh, long long sos, int B,
                                        int Hq, int Hkv, int Sq, int D, int causal,
                                        int window, long long q_offset, int kv_len,
                                        float* lse, void* stream) {
  if (B > 65535 || Hq > 65535) return (int)cudaErrorInvalidValue;
  PrefillArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.sob = sob; a.soh = soh; a.sos = sos;
  a.q_offset = q_offset;
  a.Sq = Sq;
  a.Hkv = Hkv;
  a.group = Hq / Hkv;
  a.causal = causal;
  a.window = window;
  a.kv_len = kv_len;
  a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  a.lse = lse;
  const Operand oq{q, sqb, sqh, sqs}, ok{k, skb, skh, sks}, ov{v, svb, svh, svs};
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(oq, ok, ov, a, B, Hq, st);
    case 32: return launch<32>(oq, ok, ov, a, B, Hq, st);
    case 64: return launch<64>(oq, ok, ov, a, B, Hq, st);
    case 80: return launch<80>(oq, ok, ov, a, B, Hq, st);
    case 96: return launch<96>(oq, ok, ov, a, B, Hq, st);
    case 128: return launch<128>(oq, ok, ov, a, B, Hq, st);
    case 240: return launch<240>(oq, ok, ov, a, B, Hq, st);
    case 256: return launch<256>(oq, ok, ov, a, B, Hq, st);
    default: return (int)cudaErrorInvalidValue;
  }
}