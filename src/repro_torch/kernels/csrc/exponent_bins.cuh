// The exponent-bin function of the magnitude histograms, shared by
// maghist.cu (per-row histograms) and maghist_blocks.cu (per-4096-block
// histograms), so both kernels bin every value the same way.
#pragma once

#include <cuda_runtime.h>

namespace exphist {

constexpr int kBins = 64;
constexpr int kOffset = 40;      // exponent -40 .. +23 covered
constexpr int kBlockD = 4096;    // elements of one row per block

// bin = clip(e - 127 + 40, 0, 63) with e the biased exponent of |x|;
// NaN -> 0, +/-inf -> 63 (e = 255 clips), zeros and denormals -> 0.
__device__ __forceinline__ int exponent_bin(float x) {
  const int e = (__float_as_int(fabsf(x)) >> 23) & 0xFF;
  const int b = min(max(e - 127 + kOffset, 0), kBins - 1);
  return x != x ? 0 : b;   // NaN
}

}  // namespace exphist
