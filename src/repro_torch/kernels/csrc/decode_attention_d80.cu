// decode_attention: the head dim 80 instantiations (decode_attention.cuh),
// the hybrid's shared attention block (zamba2-2.7b: 2,560 / 32 heads).
// The template's lane group, tile and position groups follow from D:
// two lanes a position in bfloat16 and four in float32, tiles of 144 and
// 288 bfloat16 positions (72 and 144 in float32), six position groups.
#include "decode_attention.cuh"

namespace repro_da {

cudaError_t launch_d80(bool bf16, const Args& a) {
  return bf16 ? by_tile<__nv_bfloat16, 80>(a) : by_tile<float, 80>(a);
}

}  // namespace repro_da
