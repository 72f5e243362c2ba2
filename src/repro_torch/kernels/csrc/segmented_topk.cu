// segmented_age_topk: the rAge-k selection. For every cluster, members
// s = 0..S-1 in order each pick the k highest-age lanes of their r
// candidates; a candidate already taken by an earlier valid member of the
// same cluster is masked to age -1 first.
//
// Replaces the Pallas kernel repro/kernels/segmented_topk.py::
// segmented_age_topk (_kernel), one program per cluster with a fori_loop
// over members and k first-occurrence argmax passes over a lane-padded
// (S, R) tile.
//
// Bound on the H100: latency. At fig3 (C <= 10, S <= 2, r = 75, k = 10)
// the kernel reads under 13 KB; what costs is the chain of S*k dependent
// argmax steps inside a cluster. Design: one block per cluster (clusters
// are independent) and one thread per candidate lane, looping over lanes
// when r exceeds the block; lanes >= r never exist, so no padding is
// read. The member's ages and candidates and the cluster's taken buffer
// (S*k int32, -1 = empty) sit in shared memory. Each pick is a block
// argmax, ties to the lower lane (first occurrence, as argmax and the
// stable lax.top_k give), by warp shuffles and one pass over the per-warp
// winners; the picked lane becomes NEG. A member's picks enter the taken
// buffer only when valid[c, s] is set.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kNeg = -2147483647;   // -(2^31) + 1, never selected

__device__ __forceinline__ bool better(int v, int l, int bv, int bl) {
  return v > bv || (v == bv && l < bl);
}

__global__ void __launch_bounds__(kThreads)
segmented_age_topk_kernel(const int* __restrict__ cand,
                          const int* __restrict__ age,
                          const int* __restrict__ valid,
                          int* __restrict__ out, int S, int R, int k,
                          int disjoint) {
  extern __shared__ int smem[];
  int* a = smem;               // (R,) working ages of the member
  int* c = a + R;              // (R,) its candidate indices
  int* taken = c + R;          // (S*k,) picks of earlier valid members
  int* sel = taken + S * k;    // (k,) this member's picks
  __shared__ int warp_v[kWarps], warp_l[kWarps];

  const int cl = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < S * k; i += blockDim.x) taken[i] = -1;
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const long long row = static_cast<long long>(cl) * S + s;
    for (int l = tid; l < R; l += blockDim.x) {
      const int cv = cand[row * R + l];
      int av = age[row * R + l];
      if (disjoint) {
        for (int q = 0; q < S * k; ++q)
          if (taken[q] == cv) { av = -1; break; }
      }
      c[l] = cv;
      a[l] = av;
    }
    __syncthreads();

    for (int j = 0; j < k; ++j) {
      int bv = INT_MIN, bl = INT_MAX;
      for (int l = tid; l < R; l += blockDim.x)
        if (better(a[l], l, bv, bl)) { bv = a[l]; bl = l; }
      for (int off = 16; off > 0; off >>= 1) {
        const int ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int ol = __shfl_down_sync(0xffffffffu, bl, off);
        if (better(ov, ol, bv, bl)) { bv = ov; bl = ol; }
      }
      if (lane == 0) { warp_v[warp] = bv; warp_l[warp] = bl; }
      __syncthreads();
      if (tid == 0) {
        for (int w = 1; w < kWarps; ++w)
          if (better(warp_v[w], warp_l[w], bv, bl)) {
            bv = warp_v[w];
            bl = warp_l[w];
          }
        sel[j] = c[bl];
        out[row * k + j] = c[bl];
        a[bl] = kNeg;
      }
      __syncthreads();
    }

    if (disjoint && valid[row]) {
      for (int j = tid; j < k; j += blockDim.x) taken[s * k + j] = sel[j];
    }
    __syncthreads();
  }
}

}  // namespace

// cand/age: (C, S, R) int32, valid: (C, S) int32, out: (C, S, k) int32.
// Needs 1 <= k <= R.
extern "C" int segmented_age_topk(const void* cand, const void* age,
                                  const void* valid, void* out, int C, int S,
                                  int R, int k, int disjoint, void* stream) {
  if (C > 0 && S > 0) {
    const size_t smem = sizeof(int) * (2 * static_cast<size_t>(R) + S * k + k);
    segmented_age_topk_kernel<<<C, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cand), static_cast<const int*>(age),
        static_cast<const int*>(valid), static_cast<int*>(out), S, R, k,
        disjoint);
  }
  return static_cast<int>(cudaGetLastError());
}
