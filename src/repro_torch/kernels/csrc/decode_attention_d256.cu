// decode_attention: the head dim 256 instantiations (decode_attention.cuh).
#include "decode_attention.cuh"

namespace repro_da {

cudaError_t launch_d256(bool bf16, const Args& a) {
  return bf16 ? by_tile<__nv_bfloat16, 256>(a) : by_tile<float, 256>(a);
}

}  // namespace repro_da
