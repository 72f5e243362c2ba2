// decode_attention: the C entry and the head dim 128 instantiations (the
// LM's). The kernel is in decode_attention.cuh.
#include "decode_attention.cuh"

namespace repro_da {

cudaError_t launch_d128(bool bf16, const Args& a) {
  return bf16 ? by_tile<__nv_bfloat16, 128>(a) : by_tile<float, 128>(a);
}

}  // namespace repro_da

// q: (B, H, D), k/v: (B, S, G, D), out: (B, H, D), all float32 (bf16 = 0)
// or bfloat16 (bf16 = 1), contiguous and 16-byte aligned; n = number of
// valid cache positions, 0 <= n <= S; D in {32, 64, 128, 256}, H / G <= 16.
// The first n positions are cut into splits ranges of chunk positions
// (the last one shorter or empty), walked in tiles of tile_bytes of K and
// of V (kSmallTile or kLargeTile); part: float32 scratch of
// B * H * splits * (2 + D) when splits > 1. Enqueues the partial kernel
// and, for more than one split, the combine; returns the first error.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                void* out, void* part, int B, int H, int G,
                                int S, int D, int n, int splits, int chunk,
                                int tile_bytes, int bf16, float scale,
                                void* stream) {
  using namespace repro_da;
  if (splits < 1 || chunk < 1 || static_cast<long long>(splits) * chunk < n ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && G > 0) {
    const Args a{q, k, v, out, static_cast<float*>(part), B, H, G, S, n,
                 splits, chunk, tile_bytes, scale,
                 static_cast<cudaStream_t>(stream)};
    cudaError_t e = cudaErrorInvalidValue;
    switch (D) {
      case 32: e = launch_d32(bf16 != 0, a); break;
      case 64: e = launch_d64(bf16 != 0, a); break;
      case 128: e = launch_d128(bf16 != 0, a); break;
      case 256: e = launch_d256(bf16 != 0, a); break;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
