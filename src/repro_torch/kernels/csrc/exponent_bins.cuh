// The exponent-bin function of the magnitude histograms, shared by
// maghist.cu (the report's counting pass), report.cu (its second pass) and
// maghist_blocks.cu (per-4096-block histograms), so every kernel bins every
// value the same way.
#pragma once

#include <cuda_runtime.h>

namespace exphist {

constexpr int kBins = 64;
constexpr int kOffset = 40;      // exponent -40 .. +23 covered
constexpr int kBlockD = 4096;    // elements of one row per block
constexpr int kSubBits = 2;      // the report's counts: quarter binades
constexpr int kFine = kBins << kSubBits;   // 256 fine bins
constexpr int kSlots = kFine + 1;          // then NaN

// bin = clip(e - 127 + 40, 0, 63) with e the biased exponent of |x|;
// NaN -> 0, +/-inf -> 63 (e = 255 clips), zeros and denormals -> 0.
__device__ __forceinline__ int exponent_bin(float x) {
  const int e = (__float_as_int(fabsf(x)) >> 23) & 0xFF;
  const int b = min(max(e - 127 + kOffset, 0), kBins - 1);
  return x != x ? 0 : b;   // NaN
}

// The report's count slot: NaN goes to kFine; a non-NaN value to its fine
// bin, bin * 4 + the top two mantissa bits, or bin * 4 alone in the two
// edge bins, whose values span many exponents. Fine bins are ordered as
// the values are, and the four of bin b sum to bin b (slot 0 holds the
// zeros, denormals and tiny values, and no NaN).
__device__ __forceinline__ int report_slot(float x) {
  if (x != x) return kFine;
  const int b = exponent_bin(x);
  const int sub = b == 0 || b == kBins - 1
                      ? 0
                      : (__float_as_int(fabsf(x)) >> (23 - kSubBits)) &
                            ((1 << kSubBits) - 1);
  return (b << kSubBits) | sub;
}

}  // namespace exphist
