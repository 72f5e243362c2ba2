// maghist: per-(row, 4096-block) 64-bin histograms of |g| by the float32
// exponent field, the first pass of the single-vector threshold top-r
// report (ops.threshold_topk) that rTop-k and CAFe take of every client.
//
// Replaces the Pallas kernel repro/kernels/maghist.py::maghist (_kernel /
// _hist_block), one program per 4096-block of one zero-padded vector, each
// writing its block's own 64 counts. The reference runs it once per client
// under vmap; here all N rows go in one launch.
//
// Bound on the H100: bytes. The pass reads N*d floats once and writes
// N*ceil(d/4096)*64 ints; at the fig3 shape (10 x 39,760) that is 1.6 MB,
// about 0.5 us at 3.35 TB/s, so one launch is latency-bound. Design: one
// block per (row, 4096-block). No two blocks share an output row, so
// there are no global atomics and no memset, and the output does not
// depend on the order blocks run in. Each warp counts into its own
// 64-entry shared-memory sub-histogram (fig3 gradients crowd into a few
// exponents, so one shared histogram would serialise the block's atomics
// on those bins); the sub-histograms are summed per bin at the end. The
// ragged tail of the last block counts as zeros in bin 0, which is what
// the reference's call on the zero-padded vector returns.
#include "exponent_bins.cuh"

namespace {

using exphist::exponent_bin;
using exphist::kBins;
using exphist::kBlockD;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
maghist_blocks_kernel(const float* __restrict__ g, int* __restrict__ hist,
                      int d) {
  __shared__ int h[kWarps * kBins];
  int* mine = h + (threadIdx.x / 32) * kBins;
  for (int t = threadIdx.x; t < kWarps * kBins; t += blockDim.x) h[t] = 0;
  __syncthreads();
  const long long row = blockIdx.y;
  const float* rowp = g + row * d;
  const long long start = static_cast<long long>(blockIdx.x) * kBlockD;
  const long long end = min(start + kBlockD, static_cast<long long>(d));
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x)
    atomicAdd(&mine[exponent_bin(rowp[i])], 1);
  __syncthreads();
  if (threadIdx.x < kBins) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += h[w * kBins + threadIdx.x];
    if (threadIdx.x == 0) s += static_cast<int>(start + kBlockD - end);
    hist[(row * gridDim.x + blockIdx.x) * kBins + threadIdx.x] = s;
  }
}

}  // namespace

// g: (n, d) float32, hist: (n, ceil(d / 4096), 64) int32, written whole.
extern "C" int maghist(const void* g, void* hist, int n, int d,
                       void* stream) {
  if (n > 0 && d > 0) {
    const dim3 grid((d + kBlockD - 1) / kBlockD, n);
    maghist_blocks_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<int*>(hist), d);
  }
  return static_cast<int>(cudaGetLastError());
}
