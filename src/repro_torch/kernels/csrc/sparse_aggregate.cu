// sparse_aggregate: the parameter server's sum of the clients' sparse
// uploads into a dense (d,) float32 gradient, fused with the hit-based
// age lane (new_age = 0 where any upload hit, else age + 1).
//
// Replaces the Pallas kernel repro/kernels/sparse_aggregate.py::
// sparse_aggregate (_kernel), which turns the scatter into a one-hot
// matmul per (d-block, NK-tile) on the TPU's matrix unit.
//
// Bound on the H100: bytes. The function reads NK (index, value) pairs
// and the (d,) age vector and writes (d,) sums and ages: 8 NK + 12 d
// bytes, 0.14 us at fig3 (NK 100, d 39,760) and 9 us at the CIFAR CNN's
// d = 2,515,338, at 3.35 TB/s.
//
// Determinism: no float atomics, whose order varies from run to run.
// Every coordinate's sum starts at 0.0 and adds its uploads in upload
// order, so the result equals numpy.add.at in float32, run after run.
// Indices outside [0, d) drop.
//
// Design: O(NK * ceil(d / kRange) + d) work, one launch. A block owns a
// range of coordinates, with their sums and hit flags in shared memory,
// about kStreamBlocks blocks of up to kRange coordinates. It stages all
// the uploads into shared memory a tile at a time, in upload order, and
// one warp applies each tile's 32-upload slices in order, keeping those
// in its range: __match_any_sync groups the lanes of a slice that hit one
// coordinate, and the lowest lane of each group adds the group's values
// in lane order. All threads then write the block's sums and ages once,
// coalesced. Every block reads every upload, which is cheap at the
// paper's NK (100 at fig3, 1,000 at the CIFAR CNN's round) and costs
// each block a pass over all of them at a much larger NK: 1.09 ms on an
// H100 at 250,000 uploads into d = 2,515,338, where an order-preserving
// bucketing of the uploads by block would be the fix.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRange = 8192;         // coordinates a block owns at most
constexpr int kTile = 512;           // uploads staged at a time
constexpr int kStreamBlocks = 256;   // blocks the launch aims at

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Block b owns coordinates [b * range, (b + 1) * range), range <= kRange.
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const int* __restrict__ idx, const float* __restrict__ vals,
                  int nk, int range, const int* __restrict__ age,
                  float* __restrict__ out, int* __restrict__ new_age, int d) {
  __shared__ float sum[kRange];
  __shared__ __align__(4) unsigned char hit[kRange];
  __shared__ int t_idx[kTile];
  __shared__ float t_val[kTile];
  const int base = blockIdx.x * range;
  const int tid = threadIdx.x, lane = tid % 32;
  for (int i = tid; i < range; i += kThreads) sum[i] = 0.0f;
  for (int i = tid; i < range / 4; i += kThreads)
    reinterpret_cast<unsigned*>(hit)[i] = 0u;
  for (int w0 = 0; w0 < nk; w0 += kTile) {
    const int cnt = min(kTile, nk - w0);
    __syncthreads();   // the previous tile applied
    for (int i = tid; i < cnt; i += kThreads) {
      t_idx[i] = idx[w0 + i];
      t_val[i] = vals[w0 + i];
    }
    __syncthreads();
    if (tid < 32) {
      for (int s0 = 0; s0 < cnt; s0 += 32) {
        const int q = s0 + lane;
        int j = -1;
        if (q < cnt) {
          const int x = t_idx[q];
          if (x >= base && x < base + range && x < d) j = x - base;
        }
        if (__ballot_sync(0xffffffffu, j >= 0) == 0) continue;
        const unsigned group = __match_any_sync(0xffffffffu, j);
        if (j >= 0 && (group & lanes_below()) == 0) {
          float acc = sum[j];
          for (unsigned m = group; m; m &= m - 1)
            acc += t_val[s0 + __ffs(m) - 1];
          sum[j] = acc;
          hit[j] = 1;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  const int n = min(range, d - base);
  for (int i = tid; i < n; i += kThreads) {
    out[base + i] = sum[i];
    new_age[base + i] = hit[i] ? 0 : age[base + i] + 1;
  }
}

}  // namespace

// idx: (nk,) int32, vals: (nk,) float32, age: (d,) int32;
// out: (d,) float32, new_age: (d,) int32.
extern "C" int sparse_aggregate(const void* idx, const void* vals,
                                const void* age, void* out, void* new_age,
                                int nk, int d, void* stream) {
  if (d > 0) {
    // about kStreamBlocks blocks of a multiple of kThreads coordinates
    const int want = (d + kStreamBlocks - 1) / kStreamBlocks;
    const int range = min(kRange, (want + kThreads - 1) / kThreads * kThreads);
    accumulate_kernel<<<(d + range - 1) / range, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(idx), static_cast<const float*>(vals), nk,
        range, static_cast<const int*>(age), static_cast<float*>(out),
        static_cast<int*>(new_age), d);
  }
  return static_cast<int>(cudaGetLastError());
}
