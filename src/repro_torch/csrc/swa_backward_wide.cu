// B6's fp32 backward at head dims 96, 128, 240 and 256: the kernels of
// csrc/swa_backward.cuh instantiated apart from csrc/swa_backward.cu's (which
// calls this entry), so that nvcc compiles the two halves in parallel.
#include "swa_backward.cuh"

// args: a BwdArgs, as csrc/swa_backward.cu fills it.  Returns the launch error
// (cudaErrorInvalidValue for a head dim without an instantiation).
extern "C" int repro_flash_attention_bwd_wide(const void* args, int D, int n_bh, void* stream) {
  const BwdArgs& a = *static_cast<const BwdArgs*>(args);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 96: return launch_bwd<96>(a, n_bh, st);
    case 128: return launch_bwd<128>(a, n_bh, st);
    case 240: return launch_bwd<240>(a, n_bh, st);
    case 256: return launch_bwd<256>(a, n_bh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
