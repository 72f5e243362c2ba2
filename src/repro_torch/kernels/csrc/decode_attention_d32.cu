// decode_attention: the head dim 32 instantiations (decode_attention.cuh),
// the smoke configurations' head dim.
#include "decode_attention.cuh"

namespace repro_da {

cudaError_t launch_d32(bool bf16, const Args& a) {
  return bf16 ? by_tile<__nv_bfloat16, 32>(a) : by_tile<float, 32>(a);
}

}  // namespace repro_da
