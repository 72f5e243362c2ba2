// sparse_aggregate: the parameter server's sum of the clients' sparse
// uploads into a dense (d,) float32 gradient, fused with the hit-based
// age lane (new_age = 0 where any upload hit, else age + 1).
//
// Replaces the Pallas kernel repro/kernels/sparse_aggregate.py::
// sparse_aggregate (_kernel), which turns the scatter into a one-hot
// matmul per (d-block, NK-tile) on the TPU's matrix unit.
//
// Bound on the H100: bytes, then latency. The function reads NK (index,
// value) pairs and the (d,) age vector and writes (d,) sums and ages; at
// fig3 (NK = 100, d = 39,760) that is 0.48 MB, about 0.14 us at 3.35 TB/s,
// so one launch is latency-bound. Design: no float atomics, whose order
// varies from run to run. One block owns a range of coordinates, one
// thread each; the block walks the NK uploads in upload order, a tile at a
// time through shared memory, and each thread adds the values whose index
// is its own coordinate. The sum order is therefore the upload order, and
// repeated runs are bitwise equal. Indices outside [0, d) match no thread
// and drop. The cost is O(NK) per coordinate, fine at fig3's NK; a large
// NK wants a sort and a segmented sum instead.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // coordinates per block == upload tile

__global__ void __launch_bounds__(kThreads)
sparse_aggregate_kernel(const int* __restrict__ idx,
                        const float* __restrict__ vals,
                        const int* __restrict__ age,
                        float* __restrict__ out, int* __restrict__ new_age,
                        int nk, int d) {
  __shared__ int s_idx[kThreads];
  __shared__ float s_val[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.0f;
  bool hit = false;
  for (int t0 = 0; t0 < nk; t0 += kThreads) {
    const int n = min(kThreads, nk - t0);
    if (threadIdx.x < n) {
      s_idx[threadIdx.x] = idx[t0 + threadIdx.x];
      s_val[threadIdx.x] = vals[t0 + threadIdx.x];
    }
    __syncthreads();
    for (int q = 0; q < n; ++q) {
      if (s_idx[q] == i) {
        acc += s_val[q];
        hit = true;
      }
    }
    __syncthreads();
  }
  if (i < d) {
    out[i] = acc;
    new_age[i] = hit ? 0 : age[i] + 1;
  }
}

}  // namespace

// idx: (nk,) int32, vals: (nk,) float32, age: (d,) int32;
// out: (d,) float32, new_age: (d,) int32.
extern "C" int sparse_aggregate(const void* idx, const void* vals,
                                const void* age, void* out, void* new_age,
                                int nk, int d, void* stream) {
  if (d > 0) {
    sparse_aggregate_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(idx), static_cast<const float*>(vals),
        static_cast<const int*>(age), static_cast<float*>(out),
        static_cast<int*>(new_age), nk, d);
  }
  return static_cast<int>(cudaGetLastError());
}
