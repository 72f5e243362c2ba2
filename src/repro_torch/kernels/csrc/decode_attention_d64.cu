// decode_attention: the head dim 64 instantiations (decode_attention.cuh).
#include "decode_attention.cuh"

namespace repro_da {

cudaError_t launch_d64(bool bf16, const Args& a) {
  return bf16 ? by_tile<__nv_bfloat16, 64>(a) : by_tile<float, 64>(a);
}

}  // namespace repro_da
