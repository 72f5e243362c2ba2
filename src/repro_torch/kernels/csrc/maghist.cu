// maghist_batch: per-row 64-bin histograms of |g| by the float32 exponent
// field, the first pass of the threshold top-r candidate report.
//
// Replaces the Pallas kernel repro/kernels/maghist.py::maghist_batch
// (_batch_kernel / _hist_block / exponent_bins), which walks an (N, d / 4096)
// grid in order and carries each row's histogram across its d-blocks.
//
// Bound on the H100: bytes. The pass reads N*d floats once and writes
// N*64 ints; at the fig3 shape (10 x 39,760) that is 1.6 MB, about 0.5 us
// at 3.35 TB/s, so one launch is latency-bound. Design: blocks run in no
// order here, so nothing carries between them. One block per (row,
// d-chunk) reads its chunk in coalesced strides, counts into a 64-entry
// shared-memory histogram with shared integer atomics, and adds the
// non-zero bins into the (N, 64) output with global integer atomics.
// Integer sums do not depend on order, so the result is deterministic.
// The ragged tail of d is masked by the loop bound, not padded. The
// output must be zeroed by the caller.
#include "exponent_bins.cuh"

namespace {

using exphist::exponent_bin;
using exphist::kBins;
constexpr int kThreads = 256;
constexpr int kChunk = exphist::kBlockD;

__global__ void __launch_bounds__(kThreads)
maghist_batch_kernel(const float* __restrict__ g, int* __restrict__ hist,
                     int d) {
  __shared__ int h[kBins];
  const int row = blockIdx.y;
  for (int t = threadIdx.x; t < kBins; t += blockDim.x) h[t] = 0;
  __syncthreads();
  const float* rowp = g + static_cast<long long>(row) * d;
  const long long start = static_cast<long long>(blockIdx.x) * kChunk;
  const long long end = min(start + kChunk, static_cast<long long>(d));
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x)
    atomicAdd(&h[exponent_bin(rowp[i])], 1);
  __syncthreads();
  for (int t = threadIdx.x; t < kBins; t += blockDim.x)
    if (h[t]) atomicAdd(&hist[row * kBins + t], h[t]);
}

}  // namespace

// g: (n, d) float32, hist: (n, 64) int32 zeroed.
extern "C" int maghist_batch(const void* g, void* hist, int n, int d,
                             void* stream) {
  if (n > 0 && d > 0) {
    const dim3 grid((d + kChunk - 1) / kChunk, n);
    maghist_batch_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<int*>(hist), d);
  }
  return static_cast<int>(cudaGetLastError());
}
