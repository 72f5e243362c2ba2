// A block-wide bitonic sort of 64-bit keys in shared memory, shared by
// report.cu (the candidate report's final rank) and segmented_topk.cu (each
// member's lanes ranked at once).
//
// Bound on the H100: shared-memory bandwidth and barriers. A stage of the
// plain network reads and writes every key once and ends in a barrier, so
// a sort of 4,096 keys moves 78 times 64 KB through shared memory. Here a
// thread holds 8 consecutive keys in registers: the stages of distance 1-4
// run in registers, those of distance 8-128 swap keys with the partner
// lane by warp shuffles, and only distances of 256 and up go through
// shared memory, up to three stages a pass (each thread taking a strided
// group of 8 into registers). 4,096 keys take 10 round trips and 10
// barriers instead of 78; 256 or fewer keys take one. Keys sit at padded
// positions (spad: one empty slot after every 16) so that the strided
// groups do not fall on the same banks; callers read and write the buffer
// through spad.
#pragma once

#include <cuda_runtime.h>

namespace bitonic {

constexpr int kE = 8;         // keys a thread holds
constexpr int kLogE = 3;
constexpr int kWarpKeys = 32 * kE;

// The padded position of key i; a buffer of n keys spans spad(n) slots.
__device__ __forceinline__ int spad(int i) { return i + (i >> 4); }

__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

__device__ __forceinline__ void cas(unsigned long long& u,
                                    unsigned long long& v, bool up) {
  if ((u > v) == up) {
    const unsigned long long t = u;
    u = v;
    v = t;
  }
}

// Stages of distance < 8 of merge size `size` on one thread's keys, which
// sit at positions base + q.
__device__ __forceinline__ void local_stages(unsigned long long* x, int base,
                                             int seg, int size) {
#pragma unroll
  for (int bit = kLogE - 1; bit >= 0; --bit) {
    if ((1 << bit) >= size) continue;
#pragma unroll
    for (int q = 0; q < kE; ++q)
      if (!(q & (1 << bit)))
        cas(x[q], x[q | (1 << bit)],
            ((base + q) & (seg - 1) & size) == 0);
  }
}

// Merge sizes s0..s1 (stages of distance below 256, the first size from
// distance jtop down) on groups of 8 consecutive keys, one group a thread,
// partners in other lanes reached by shuffles.
__device__ __forceinline__ void warp_run(unsigned long long* a, int n,
                                         int seg, int s0, int s1, int jtop) {
  const int groups = n / kE;
  for (int g0 = 0; g0 < groups; g0 += blockDim.x) {
    if (g0 + static_cast<int>(threadIdx.x & ~31u) >= groups) continue;
    const int g = g0 + threadIdx.x;   // a warp is idle or whole but the last
    const bool on = g < groups;
    const int base = g * kE;
    unsigned long long x[kE];
#pragma unroll
    for (int q = 0; q < kE; ++q) x[q] = on ? a[spad(base + q)] : 0ull;
    for (int size = s0; size <= s1; size <<= 1) {
      const bool up = (base & (seg - 1) & size) == 0;
      for (int j = min(size >> 1, jtop); j >= kE; j >>= 1) {
        const int lm = j / kE;   // the partner lane is lane ^ lm
        const bool keep_min = ((g & lm) == 0) == up;
#pragma unroll
        for (int q = 0; q < kE; ++q) {
          const unsigned long long o =
              __shfl_xor_sync(0xffffffffu, x[q], lm);
          x[q] = keep_min == (o < x[q]) ? o : x[q];
        }
      }
      local_stages(x, base, seg, size);
    }
#pragma unroll
    for (int q = 0; q < kE; ++q)
      if (on) a[spad(base + q)] = x[q];
  }
  __syncthreads();
}

// The stages of merge size `size` with distances hi down to lo = hi >>
// (c - 1), on groups of 2^c keys at positions base + q * lo.
__device__ __forceinline__ void smem_pass(unsigned long long* a, int n,
                                          int seg, int size, int hi, int c) {
  const int lo = hi >> (c - 1), lb = ilog2(lo), m = 1 << c;
  for (int g = threadIdx.x; g < (n >> c); g += blockDim.x) {
    const int base = ((g >> lb) << (lb + c)) | (g & (lo - 1));
    const bool up = (base & (seg - 1) & size) == 0;
    unsigned long long x[kE];
#pragma unroll
    for (int q = 0; q < kE; ++q)
      if (q < m) x[q] = a[spad(base + q * lo)];
#pragma unroll
    for (int bit = kLogE - 1; bit >= 0; --bit) {
      if (bit >= c) continue;
#pragma unroll
      for (int q = 0; q < kE; ++q)
        if (q < m && !(q & (1 << bit))) cas(x[q], x[q | (1 << bit)], up);
    }
#pragma unroll
    for (int q = 0; q < kE; ++q)
      if (q < m) a[spad(base + q * lo)] = x[q];
  }
  __syncthreads();
}

// Sorts each of the n / seg segments of a (n, seg powers of two, seg <= n)
// ascending; every thread of the block calls it after a barrier.
__device__ inline void sort(unsigned long long* a, int n, int seg) {
  if (seg < 2) return;
  if (n < kE) {   // a few keys: one thread
    if (threadIdx.x == 0)
      for (int size = 2; size <= seg; size <<= 1)
        for (int j = size >> 1; j > 0; j >>= 1)
          for (int i = 0; i < n; ++i)
            if (!(i & j))
              cas(a[spad(i)], a[spad(i | j)], (i & (seg - 1) & size) == 0);
    __syncthreads();
    return;
  }
  warp_run(a, n, seg, 2, min(seg, kWarpKeys), kWarpKeys / 2);
  for (int size = 2 * kWarpKeys; size <= seg; size <<= 1) {
    for (int hi = size >> 1; hi >= kWarpKeys;) {
      const int c = min(kLogE, ilog2(hi / kWarpKeys) + 1);
      smem_pass(a, n, seg, size, hi, c);
      hi >>= c;
    }
    warp_run(a, n, seg, size, size, kWarpKeys / 2);
  }
}

}  // namespace bitonic
