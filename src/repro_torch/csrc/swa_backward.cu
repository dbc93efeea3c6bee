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
// Design: two launches, deterministic and free of atomics (two calls on the
// same inputs give the same bits); fp32 on the CUDA cores, 128 threads a
// block, with csrc/simt_f32.cuh's tiles, cp.async loads and register-blocked
// products (the forward's, csrc/swa_attention.cu).  Scores and
// probabilities in the log2 domain: P = ex2(s D**-0.5 log2 e - LSE log2 e).
//   1. bwd_dq, one block per (batch, KV head, tile of BM rows).  Rows are
//      (query position, head of the KV head's group) pairs, position-major, so
//      the group shares every staged K/V tile (the forward's order).  q and
//      dout stay in shared memory d-major; it computes each row's Delta (and
//      writes it, fp32, to a workspace for the second launch), then walks the
//      BN-key tiles any of its rows can see (the forward's cull), K and V
//      d-major: S = q K^T and dP = dout V^T as TM x KN register micro-tiles,
//      dS = P (dP - Delta) to shared memory key-major, then dQ += dS K with
//      each thread's TM rows by D / 8 columns in registers.
//   2. bwd_dkdv, one block per (batch, KV head, tile of BN keys).  K and V
//      stay in shared memory d-major, dK and dV in registers (a thread: its
//      KN keys by D / 16 columns); it walks the BM-row tiles (every head of
//      the group) whose positions can see a key of the tile, q and dout
//      d-major with the rows' LSE and Delta: S and dP again (the recompute)
//      in registers, then P and dS in turn through one shared buffer
//      (row-major) for dV += P^T dout and dK += dS^T q.
//   Tiles of class kFullTile (hopper.cuh's tile_class) evaluate no mask.
//   Tiles (DqCfg, KvCfg in simt_f32.cuh): 4 x 8 micro-tiles up to D = 80
//   (dq) and 96 (dkdv), 4 x 4 above; dq 64 rows by 64 keys, dkdv 64 keys by
//   64-row tiles.  Two blocks an SM where shared memory allows (D <= 128
//   for dq, D <= 80 for dkdv): there one stage of the walked tiles (105 KB
//   at D = 80), the other block's products covering a block's copies; a
//   two-stage cp.async ring wherever the second stage fits and costs no
//   block (D <= 32, and dkdv's D = 96 and 128).  No spill at any head dim
//   (PERF.md).
//
// Files: the kernels and their launcher are csrc/swa_backward.cuh; this file
// instantiates head dims up to 80 and holds the C entry points,
// csrc/swa_backward_wide.cu the rest, so that nvcc builds both in parallel.
//
// Bound: operations.  10 D flops a visible (query, key) pair and query head
// (q.k, dout.v, P^T dout, dS^T q, dS k); this kernel spends 14 D (the dK/dV
// launch recomputes q.k and dout.v, 40 % over the bound), on the CUDA
// cores' 67 TFLOP/s.
#include "swa_backward.cuh"

// Head dims 96 and up (csrc/swa_backward_wide.cu): `args` is this file's
// BwdArgs (the same definition, from swa_backward.cuh).
extern "C" int repro_flash_attention_bwd_wide(const void* args, int D, int n_bh, void* stream);

namespace {

// The tile plan at head dim D (out[6]): (query rows of a dq block, keys of a
// dq tile, keys of a dkdv block, query rows of a dkdv tile, query rows of a
// forward block, keys of a forward tile).
template <int D>
void tiles(int* out) {
  out[0] = DqCfg<D>::BM, out[1] = DqCfg<D>::BN, out[2] = KvCfg<D>::BN, out[3] = KvCfg<D>::BM;
  out[4] = FwdCfg<D>::BM, out[5] = FwdCfg<D>::BN;
}

int dispatch(const BwdArgs& a, int D, int n_bh, cudaStream_t st) {
  switch (D) {
    case 16: return launch_bwd<16>(a, n_bh, st);
    case 32: return launch_bwd<32>(a, n_bh, st);
    case 64: return launch_bwd<64>(a, n_bh, st);
    case 80: return launch_bwd<80>(a, n_bh, st);
    default: return repro_flash_attention_bwd_wide(&a, D, n_bh, st);
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
  a.scale_log2 = (float)(1.0 / sqrt((double)D) * 1.4426950408889634);
  cudaStream_t st = (cudaStream_t)stream;
  const int n_bh = B * Hkv;
  return dispatch(a, D, n_bh, st);
}

// The fp32 kernels' tile plan at head dim D into out[6] (tiles() above);
// kernels/swa_attention.py's f32_kernel_tiles holds its Python twins to it.
// Returns cudaErrorInvalidValue for a head dim without an instantiation.
extern "C" int repro_flash_f32_tiles(int D, int* out) {
  switch (D) {
    case 16: tiles<16>(out); return 0;
    case 32: tiles<32>(out); return 0;
    case 64: tiles<64>(out); return 0;
    case 80: tiles<80>(out); return 0;
    case 96: tiles<96>(out); return 0;
    case 128: tiles<128>(out); return 0;
    case 240: tiles<240>(out); return 0;
    case 256: tiles<256>(out); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}
