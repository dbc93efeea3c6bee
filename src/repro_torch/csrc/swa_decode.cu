// B6, decode route: split-KV flash-decoding with GQA, causal and
// sliding-window masks, a decode offset and KV-length masking, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/swa_attention.py:
// flash_swa_attention (:98, pallas_call at :137) for decode calls, those
// whose group * Sq <= 16 rows per KV head; prefill runs csrc/swa_prefill.cu
// (bf16) and csrc/swa_attention.cu (fp32).  The semantics are that kernel's (see its header
// and kernels/swa_attention.py): element strides for the b, h and s axes
// (unit stride on d), query row i at position q_offset + i reading KV head
// h / (Hq / Hkv), key j visible when j < kv_len, j <= qpos (causal) and
// j > qpos - window (window > 0), scores scaled by D**-0.5, softmax and sums
// in fp32, the output in q's type and q's strides, a row with no visible key
// 0.
//
// Bound: bytes.  A decode step reads each visible K/V row once and does
// 4 D flops per (query row, key): h2o-danube-1.8b's batcher over a full
// 4,096-slot ring (4 slots, 8 KV heads of 80, bf16) moves 42 MB, 0.0125 ms
// at 3.35 TB/s, against 0.1 ms of fp32 CUDA-core work and far less on the
// tensor cores.  What matters is how many bytes are in flight.
//
// Design.  The host (kernels/swa_attention.py:plan_decode_splits) cuts the
// visible key range [begin, end) into `splits` chunks of a multiple of 64
// keys, starting at begin rounded down to 64, so that B * Hkv * splits blocks
// fill the card (PR 13's kernel launched B * Hkv = 32 blocks on 132 SMs).
//   repro_flash_decode launches
//   1. the split kernel, one block of 4 warps per (split, batch, KV head).
//      The group's <= 16 query rows, (position, head of group) pairs
//      position-major, share every staged key.  K/V tiles of the chunk
//      stream through a STAGES-deep cp.async ring in shared memory (keys at
//      or past kv_len are zero-filled, never read), so the next tiles' loads
//      are in flight while the current one is multiplied.  Each warp takes
//      its own quarter of every tile and keeps an online softmax (running
//      max, sum, unnormalised output) per row; at the end the four warps are
//      merged through shared memory and the block writes one fp32 partial
//      per row: max (log2 domain, -inf when the row saw no key of the
//      chunk), sum, and o[D].
//        bf16: 64-key tiles, 16 keys a warp; both products are mma.sync
//        m16n8k16 with fp32 accumulation, the rows padded to 16 (one m-tile
//        holds the whole group): a 16 x 16 score tile is 2 D / 16 mma, the
//        tensor cores keep the per-byte work far below the load time, where
//        the CUDA cores would spend ~8 shared-memory loads a key and row.
//        P is rounded to bf16 for P V (as the prefill kernel and
//        FlashAttention do); the sums use the fp32 P.
//        fp32: 32-key tiles, 8 keys a warp, full fp32 on the CUDA cores (no
//        TF32): lane (row group, key) scores four rows, each lane then owns
//        output columns d = lane + 32 i of every row.
//   2. the combine kernel, one warp per (batch, head, query row): rescales
//      each split's partial by exp2(m_s - max m), sums, divides by the
//      rescaled sum and writes q's type.  A split with m = -inf adds
//      nothing; a row whose sums are all 0 (or an empty plan, splits = 0,
//      where no split kernel runs) comes out exactly 0.  Given an lse
//      buffer ((B, Hq, Sq) fp32), it also writes the row's natural
//      log-sum-exp, (max m + log2 sum) * ln 2, which it already holds, and 0
//      for a row with no visible key (the prefill kernel's convention): a
//      sequence-sharded decode combines the ranks' partial rows with it,
//      and asks for the output in fp32 (out_f32), so that the ranks'
//      merge rounds once, as one rank's combine does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // score of a hidden key (never exponentiated)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;      // 4 warps
constexpr int kWarps = 4;
constexpr int kRows = 16;          // query rows per KV head on this route
constexpr int kStages = 3;         // depth of the cp.async ring
constexpr float kLn2 = 0.6931471805599453f;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  float* part;  // (B, Hkv, splits, rows, D + 2): m, l, o[D]
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs;
  long long q_offset;
  int Hkv, group, rows, causal, window, kv_len;
  int start, chunk, key_end, splits;
  int vec16;         // K/V rows 16-byte aligned: 16-byte copies, else 4-byte
  float scale_log2;  // D ** -0.5 * log2(e)
};

__device__ __forceinline__ bool visible(int key, long long qpos, const DecodeArgs& a) {
  if (key >= a.kv_len) return false;
  if (a.causal && key > qpos) return false;
  if (a.window > 0 && (long long)key <= qpos - a.window) return false;
  return true;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage keys [k0, k0 + BK) of this (batch, KV head) into Ks/Vs (row stride
// KS elements); keys at or past kv_len are zero-filled.
template <typename T, int D, int BK, int KS>
__device__ __forceinline__ void load_tile(const DecodeArgs& a, const T* kbase, const T* vbase,
                                          int k0, T* Ks, T* Vs) {
  if (a.vec16) {
    constexpr int CH = D * (int)sizeof(T) / 16, E = 16 / (int)sizeof(T);
    for (int c = threadIdx.x; c < BK * CH; c += kThreads) {
      const int row = c / CH, col = (c % CH) * E, key = k0 + row;
      const bool ok = key < a.kv_len;
      const long long kk = ok ? key : 0;
      cp_async16(Ks + row * KS + col, kbase + kk * a.sks + col, ok);
      cp_async16(Vs + row * KS + col, vbase + kk * a.svs + col, ok);
    }
  } else {  // fp32 rows that are only 4-byte aligned
    constexpr int CH = D * (int)sizeof(T) / 4;
    for (int c = threadIdx.x; c < BK * CH; c += kThreads) {
      const int row = c / CH, col = c % CH, key = k0 + row;
      const bool ok = key < a.kv_len;
      const long long kk = ok ? key : 0;
      cp_async4(Ks + row * KS + col, kbase + kk * a.sks + col, ok);
      cp_async4(Vs + row * KS + col, vbase + kk * a.svs + col, ok);
    }
  }
}

// The split's keys: [kb, ke), tiles of BK.
__device__ __forceinline__ void split_keys(const DecodeArgs& a, int* kb, int* ke) {
  *kb = a.start + blockIdx.x * a.chunk;
  *ke = min(*kb + a.chunk, a.key_end);
}

// Merge the four warps' states (Ms, Ls, Os in shared memory) and write this
// block's partial rows.
template <int D>
__device__ __forceinline__ void write_partial(const DecodeArgs& a, const float (*Ms)[kRows],
                                              const float (*Ls)[kRows], const float* Os) {
  float* part = a.part + ((long long)blockIdx.y * a.splits + blockIdx.x) * a.rows * (D + 2);
  for (int i = threadIdx.x; i < a.rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (Ls[w][r] > 0.f) M = fmaxf(M, Ms[w][r]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (Ls[w][r] > 0.f) {
        const float s = exp2f(Ms[w][r] - M);
        o += s * Os[(w * kRows + r) * D + d];
        l += s * Ls[w][r];
      }
    }
    float* row = part + (long long)r * (D + 2);
    row[2 + d] = o;
    if (d == 0) {
      row[0] = l > 0.f ? M : -INFINITY;
      row[1] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, fp32 accumulation
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bits(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int D>
struct Bf16Cfg {
  static constexpr int BK = 64;      // keys per stage, 16 a warp
  static constexpr int KS = D + 8;   // staged row stride (conflict-free fragments)
  // Above D = 128 the Q fragments (D / 4 registers) stay in shared memory,
  // read again for every tile, so that o (D / 2 registers) and the scores
  // fit without spilling: at D = 256 the ring is 198 KB and Q 8 KB.
  static constexpr bool q_smem = D > 128;
  static constexpr size_t stage_bytes = 2ull * BK * KS * sizeof(__nv_bfloat16);
  static constexpr size_t q_bytes = q_smem ? (size_t)kRows * KS * sizeof(__nv_bfloat16) : 0;
  static constexpr size_t smem = kStages * stage_bytes + q_bytes;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads) decode_bf16(const DecodeArgs a) {
  using C = Bf16Cfg<D>;
  constexpr int BK = C::BK, KS = C::KS, KK = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ float Ms[kWarps][kRows], Ls[kWarps][kRows];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* kbase =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.skb + kvh * a.skh;
  const __nv_bfloat16* vbase =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.svb + kvh * a.svh;

  int kb, ke;
  split_keys(a, &kb, &ke);
  const int ntiles = (ke - kb + BK - 1) / BK;
  // the ring's prologue first, so the loads start before anything else
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) {
      __nv_bfloat16* Ks = stage + s * 2 * BK * KS;
      load_tile<__nv_bfloat16, D, BK, KS>(a, kbase, vbase, kb + s * BK, Ks, Ks + BK * KS);
    }
    cp_commit();
  }

  // this thread's rows g and g + 8; a padding row (>= rows) reads row 0
  long long qpos[2];
  uint32_t qf[C::q_smem ? 1 : KK][4];
  __nv_bfloat16* Qs = stage + kStages * 2 * BK * KS;  // [kRows][KS] when C::q_smem
  {
    const __nv_bfloat16* qrow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int r = g + 8 * i;
      if (r >= a.rows) r = 0;
      const int qi = r / a.group, head = kvh * a.group + r % a.group;
      qpos[i] = a.q_offset + qi;
      qrow[i] = q + b * a.sqb + head * a.sqh + qi * a.sqs;
    }
    if constexpr (C::q_smem) {
      for (int c = tid; c < kRows * (D / 8); c += kThreads) {
        const int r = c / (D / 8), col = (c % (D / 8)) * 8;
        const int rr = r < a.rows ? r : 0;
        const int qi = rr / a.group, head = kvh * a.group + rr % a.group;
        *reinterpret_cast<uint4*>(&Qs[r * KS + col]) = *reinterpret_cast<const uint4*>(
            q + b * a.sqb + head * a.sqh + qi * a.sqs + col);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const int d = kk * 16 + t4 * 2;
        qf[kk][0] = ld32(qrow[0] + d);
        qf[kk][1] = ld32(qrow[1] + d);
        qf[kk][2] = ld32(qrow[0] + d + 8);
        qf[kk][3] = ld32(qrow[1] + d + 8);
      }
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<kStages - 2>();
    __syncthreads();  // tile t has landed; tile t - 1's stage is free
    {
      const int tn = t + kStages - 1;
      if (tn < ntiles) {
        __nv_bfloat16* Ks = stage + (tn % kStages) * 2 * BK * KS;
        load_tile<__nv_bfloat16, D, BK, KS>(a, kbase, vbase, kb + tn * BK, Ks,
                                            Ks + BK * KS);
      }
      cp_commit();
    }
    const __nv_bfloat16* Ks = stage + (t % kStages) * 2 * BK * KS;
    const __nv_bfloat16* Vs = Ks + BK * KS;
    const int kw = warp * 16;            // this warp's keys in the tile
    const int k0 = kb + t * BK + kw;     // their first position

    // S = Q K^T: 16 rows x 16 keys
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t qa[4];
      if constexpr (C::q_smem) {
        const __nv_bfloat16* qp = &Qs[g * KS + kk * 16 + t4 * 2];
        qa[0] = ld32(qp);
        qa[1] = ld32(qp + 8 * KS);
        qa[2] = ld32(qp + 8);
        qa[3] = ld32(qp + 8 * KS + 8);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) qa[x] = qf[kk][x];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const __nv_bfloat16* kp = &Ks[(kw + nt * 8 + g) * KS + kk * 16 + t4 * 2];
        mma_bf16(s[nt], qa, ld32(kp), ld32(kp + 8));
      }
    }
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const int key = k0 + nt * 8 + t4 * 2 + (c & 1);
        const float x = (key < ke && visible(key, qpos[i], a)) ? s[nt][c] * a.scale_log2
                                                                : kMasked;
        s[nt][c] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float mnew = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - mnew);
      m[i] = mnew;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const float p = s[nt][c] == kMasked ? 0.f : exp2f(s[nt][c] - m[i]);
        s[nt][c] = p;
        ls[i] += p;
      }
    }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];

    // O += P V over the warp's 16 keys (one k-step)
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
    const int key = kw + t4 * 2;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
      const int col = nd * 8 + g;
      const uint32_t b0 = pack_bits(Vs[key * KS + col], Vs[(key + 1) * KS + col]);
      const uint32_t b1 = pack_bits(Vs[(key + 8) * KS + col], Vs[(key + 9) * KS + col]);
      mma_bf16(acc[nd], pa, b0, b1);
    }
  }

  cp_wait<0>();
  __syncthreads();  // every stage consumed: the ring's memory holds Os now
  float* Os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    if (t4 == 0) {
      Ms[warp][g + 8 * i] = m[i];
      Ls[warp][g + 8 * i] = l[i];
    }
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = g + 8 * (c >> 1), d = nd * 8 + t4 * 2 + (c & 1);
      Os[(warp * kRows + r) * D + d] = acc[nd][c];
    }
  }
  __syncthreads();
  write_partial<D>(a, Ms, Ls, Os);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
template <int D>
struct F32Cfg {
  static constexpr int BK = 32;      // keys per stage, 8 a warp
  static constexpr int KS = D + 4;   // staged row stride: an odd multiple of 16 bytes
  static constexpr size_t q_bytes = (size_t)kRows * KS * sizeof(float);
  static constexpr size_t stage_bytes = 2ull * BK * KS * sizeof(float);
  static constexpr size_t smem = q_bytes + kStages * stage_bytes;
};

template <int D>
__global__ void __launch_bounds__(kThreads) decode_f32(const DecodeArgs a) {
  using C = F32Cfg<D>;
  constexpr int BK = C::BK, KS = C::KS;
  constexpr int KPW = BK / kWarps;   // keys a warp: lane = (row group, key)
  constexpr int RG = 32 / KPW;       // row groups: rows rg + RG i
  constexpr int RPL = kRows / RG;    // rows a lane scores
  constexpr int DV = (D + 31) / 32;  // output columns a lane owns
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* stage = reinterpret_cast<float*>(smem + C::q_bytes);
  __shared__ float Ms[kWarps][kRows], Ls[kWarps][kRows];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = lane % KPW, rg = lane / KPW;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const float* q = static_cast<const float*>(a.q);
  const float* kbase = static_cast<const float*>(a.k) + b * a.skb + kvh * a.skh;
  const float* vbase = static_cast<const float*>(a.v) + b * a.svb + kvh * a.svh;

  int kb, ke;
  split_keys(a, &kb, &ke);
  const int ntiles = (ke - kb + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) {
      float* Ks = stage + s * 2 * BK * KS;
      load_tile<float, D, BK, KS>(a, kbase, vbase, kb + s * BK, Ks, Ks + BK * KS);
    }
    cp_commit();
  }
  for (int c = tid; c < kRows * D; c += kThreads) {
    const int r = c / D, d = c % D;
    float x = 0.f;
    if (r < a.rows) {
      const int head = kvh * a.group + r % a.group;
      x = q[b * a.sqb + head * a.sqh + (long long)(r / a.group) * a.sqs + d];
    }
    Qs[r * KS + d] = x;
  }
  long long qpos[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int r = rg + RG * i;
    qpos[i] = a.q_offset + (r < a.rows ? r / a.group : 0);
  }

  float m[RPL], l[RPL], acc[RPL][RG][DV];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
      for (int c = 0; c < DV; ++c) acc[i][g][c] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<kStages - 2>();
    __syncthreads();  // tile t has landed (and Qs is written); tile t - 1 is free
    {
      const int tn = t + kStages - 1;
      if (tn < ntiles) {
        float* Ks = stage + (tn % kStages) * 2 * BK * KS;
        load_tile<float, D, BK, KS>(a, kbase, vbase, kb + tn * BK, Ks, Ks + BK * KS);
      }
      cp_commit();
    }
    const float* Ks = stage + (t % kStages) * 2 * BK * KS;
    const float* Vs = Ks + BK * KS;
    const int kl = warp * KPW + j;  // this lane's key in the tile
    const int key = kb + t * BK + kl;

    float s[RPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(&Ks[kl * KS + d]);
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const float4 q4 = *reinterpret_cast<const float4*>(&Qs[(rg + RG * i) * KS + d]);
        s[i] = fmaf(q4.x, k4.x, s[i]);
        s[i] = fmaf(q4.y, k4.y, s[i]);
        s[i] = fmaf(q4.z, k4.z, s[i]);
        s[i] = fmaf(q4.w, k4.w, s[i]);
      }
    }
    float p[RPL], alpha[RPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const bool vis = key < ke && visible(key, qpos[i], a);
      const float x = vis ? s[i] * a.scale_log2 : kMasked;
      float mx = x;
#pragma unroll
      for (int off = 1; off < KPW; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float mnew = fmaxf(m[i], mx);
      alpha[i] = exp2f(m[i] - mnew);
      p[i] = vis ? exp2f(x - mnew) : 0.f;
      float ps = p[i];
#pragma unroll
      for (int off = 1; off < KPW; off <<= 1) ps += __shfl_xor_sync(kFull, ps, off);
      l[i] = l[i] * alpha[i] + ps;
      m[i] = mnew;
    }
    // rescale, then O += P V over the warp's KPW keys; row rg' + RG i's
    // values live in the lanes of row group rg'
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        const float al = __shfl_sync(kFull, alpha[i], g * KPW);
#pragma unroll
        for (int c = 0; c < DV; ++c) acc[i][g][c] *= al;
      }
    }
#pragma unroll
    for (int jj = 0; jj < KPW; ++jj) {
      float vv[DV];
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? Vs[(warp * KPW + jj) * KS + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
#pragma unroll
        for (int g = 0; g < RG; ++g) {
          const float pj = __shfl_sync(kFull, p[i], g * KPW + jj);
#pragma unroll
          for (int c = 0; c < DV; ++c) acc[i][g][c] = fmaf(pj, vv[c], acc[i][g][c]);
        }
      }
    }
  }

  cp_wait<0>();
  __syncthreads();
  float* Os = stage;  // the ring's memory (Qs stays where it is)
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    if (j == 0) {
      Ms[warp][rg + RG * i] = m[i];
      Ls[warp][rg + RG * i] = l[i];
    }
#pragma unroll
    for (int g = 0; g < RG; ++g) {
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        const int d = lane + 32 * c;
        if (d < D) Os[(warp * kRows + g + RG * i) * D + d] = acc[i][g][c];
      }
    }
  }
  __syncthreads();
  write_partial<D>(a, Ms, Ls, Os);
}

// ---------------------------------------------------------------------------
// combine: one warp per (batch, head, query row)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_combine(const float* __restrict__ part, T* __restrict__ o, float* __restrict__ lse,
                   long long sob, long long soh, long long sos, int B, int Hq, int Hkv, int Sq,
                   int splits) {
  constexpr int DV = (D + 31) / 32;
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)B * Hq * Sq) return;
  const int qi = (int)(w % Sq), h = (int)((w / Sq) % Hq), b = (int)(w / ((long long)Sq * Hq));
  const int group = Hq / Hkv, kvh = h / group, rows = group * Sq;
  const int r = qi * group + h % group;
  const float* p = part + (((long long)b * Hkv + kvh) * splits * rows + r) * (D + 2);
  const long long step = (long long)rows * (D + 2);  // from one split to the next
  // 32 splits a round: lane j reads split s0 + j's max and sum, all lanes
  // then add the round's outputs (loads independent of the weights, so they
  // are all in flight at once), rescaled online from round to round
  float M = -INFINITY, den = 0.f, out[DV];
#pragma unroll
  for (int c = 0; c < DV; ++c) out[c] = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 32) {
    const int s = s0 + lane;
    const float ms = s < splits ? p[s * step] : -INFINITY;
    const float ls = s < splits ? p[s * step + 1] : 0.f;
    float mr = ms;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mr = fmaxf(mr, __shfl_xor_sync(kFull, mr, off));
    const float mn = fmaxf(M, mr);
    if (mn == -INFINITY) continue;  // uniform: no split so far saw a key
    // a split with no visible key (m = -inf) adds nothing
    const float wt = ms == -INFINITY ? 0.f : exp2f(ms - mn);
    const float old = M == -INFINITY ? 0.f : exp2f(M - mn);
    float dl = wt * ls;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dl += __shfl_xor_sync(kFull, dl, off);
    den = den * old + dl;
#pragma unroll
    for (int c = 0; c < DV; ++c) out[c] *= old;
    const int cnt = min(32, splits - s0);
    const float* ps = p + s0 * step + 2;
#pragma unroll 8
    for (int j = 0; j < cnt; ++j) {
      const float w = __shfl_sync(kFull, wt, j);
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        const int d = lane + 32 * c;
        if (d < D) out[c] = fmaf(w, ps[j * step + d], out[c]);
      }
    }
    M = mn;
  }
  T* orow = o + b * sob + h * soh + qi * sos;
  // w is the row's index in (B, Hq, Sq)
  if (lse != nullptr && lane == 0) lse[w] = den > 0.f ? (M + log2f(den)) * kLn2 : 0.f;
#pragma unroll
  for (int c = 0; c < DV; ++c) {
    const int d = lane + 32 * c;
    if (d < D) {
      const float x = den > 0.f ? out[c] / den : 0.f;
      if constexpr (sizeof(T) == 2)
        orow[d] = __float2bfloat16_rn(x);
      else
        orow[d] = x;
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int D>
int launch(const DecodeArgs& a, int n_bh, int is_bf16, int out_f32, void* o, float* lse,
           long long sob, long long soh, long long sos, int B, int Hq, int Sq,
           cudaStream_t st) {
  if (a.splits > 0) {
    const dim3 grid((unsigned)a.splits, (unsigned)n_bh);
    if (is_bf16) {
      static const int attr = set_smem(decode_bf16<D>, Bf16Cfg<D>::smem);
      if (attr) return attr;
      decode_bf16<D><<<grid, kThreads, Bf16Cfg<D>::smem, st>>>(a);
    } else {
      static const int attr = set_smem(decode_f32<D>, F32Cfg<D>::smem);
      if (attr) return attr;
      decode_f32<D><<<grid, kThreads, F32Cfg<D>::smem, st>>>(a);
    }
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const long long warps = (long long)B * Hq * Sq;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  if (is_bf16 && !out_f32)
    decode_combine<__nv_bfloat16, D><<<blocks, kThreads, 0, st>>>(
        a.part, static_cast<__nv_bfloat16*>(o), lse, sob, soh, sos, B, Hq, a.Hkv, Sq, a.splits);
  else
    decode_combine<float, D><<<blocks, kThreads, 0, st>>>(
        a.part, static_cast<float*>(o), lse, sob, soh, sos, B, Hq, a.Hkv, Sq, a.splits);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: element strides (b, h, s) each, unit stride on d; bf16 rows
// 16-byte aligned.  start, chunk, splits, key_end: the host's split plan
// (splits = 0: no visible key, the output is zeroed).  part: fp32 workspace
// of B * Hkv * splits * (Hq / Hkv) * Sq * (D + 2).  lse: (B, Hq, Sq) fp32,
// each row's natural log-sum-exp (0 where it sees no key), or null.  vec16:
// K/V rows are 16-byte aligned.  out_f32: o is fp32 (else q's type).
// Returns the first launch error (0 when both launched).
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v, void* o,
                                  long long sqb, long long sqh, long long sqs, long long skb,
                                  long long skh, long long sks, long long svb, long long svh,
                                  long long svs, long long sob, long long soh, long long sos,
                                  int B, int Hq, int Hkv, int Sq, int D, int causal, int window,
                                  long long q_offset, int kv_len, int start, int chunk,
                                  int splits, int key_end, void* part, float* lse, int vec16,
                                  int is_bf16, int out_f32, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || (Hq / Hkv) * Sq > kRows || kv_len < 0 || window < 0 ||
      splits < 0 || (splits > 0 && (chunk <= 0 || chunk % 64 != 0)) ||
      (long long)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.part = static_cast<float*>(part);
  a.sqb = sqb; a.sqh = sqh; a.sqs = sqs;
  a.skb = skb; a.skh = skh; a.sks = sks;
  a.svb = svb; a.svh = svh; a.svs = svs;
  a.q_offset = q_offset;
  a.Hkv = Hkv;
  a.group = Hq / Hkv;
  a.rows = a.group * Sq;
  a.causal = causal;
  a.window = window;
  a.kv_len = kv_len;
  a.start = start;
  a.chunk = chunk;
  a.splits = splits;
  a.key_end = key_end;
  a.vec16 = is_bf16 ? 1 : vec16;
  a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  cudaStream_t st = (cudaStream_t)stream;
  const int n_bh = B * Hkv;
  switch (D) {
    case 16: return launch<16>(a, n_bh, is_bf16, out_f32, o, lse, sob, soh, sos, B, Hq, Sq, st);
    case 32: return launch<32>(a, n_bh, is_bf16, out_f32, o, lse, sob, soh, sos, B, Hq, Sq, st);
    case 64: return launch<64>(a, n_bh, is_bf16, out_f32, o, lse, sob, soh, sos, B, Hq, Sq, st);
    case 80: return launch<80>(a, n_bh, is_bf16, out_f32, o, lse, sob, soh, sos, B, Hq, Sq, st);
    case 96: return launch<96>(a, n_bh, is_bf16, out_f32, o, lse, sob, soh, sos, B, Hq, Sq, st);
    case 128: return launch<128>(a, n_bh, is_bf16, out_f32, o, lse, sob, soh, sos, B, Hq, Sq, st);
    case 240: return launch<240>(a, n_bh, is_bf16, out_f32, o, lse, sob, soh, sos, B, Hq, Sq, st);
    case 256: return launch<256>(a, n_bh, is_bf16, out_f32, o, lse, sob, soh, sos, B, Hq, Sq, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
