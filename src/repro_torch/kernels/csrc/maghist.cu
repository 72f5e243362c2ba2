// maghist_batch: the histogram pass of the rAge-k candidate report, per-row
// 64-bin histograms of |g| by the float32 exponent field.
//
// Replaces the Pallas kernel repro/kernels/maghist.py::maghist_batch
// (_batch_kernel / _hist_block / exponent_bins), which walks an (N, d / 4096)
// grid in order and carries each row's histogram across its d-blocks.
//
// Bound on the H100: bytes. The pass reads N*d floats once; at the fig3
// shape (10 x 39,760) that is 1.6 MB, about 0.5 us at 3.35 TB/s, so a launch
// there is latency; at the CIFAR report (6 x 2,515,338) it is 60 MB, 18 us.
// Design: blocks run in no order here, so nothing carries between them.
// Grid (P, N): block (p, row) owns the contiguous range [p*L, (p+1)*L) of its
// row (L a multiple of 4096 that the host picks so that P <= 64), reads it
// eight loads deep per thread, counts it into per-warp shared
// sub-histograms, and writes its own 257 counts: its non-NaN values by fine
// bin (the exponent bin and the top two mantissa bits, report_slot in
// exponent_bins.cuh), then its NaN count. No two blocks share an output
// slot, so there are no global atomics and no memset, and a row's
// histogram is a fixed-order sum of its blocks' counts. The report's second
// pass (report.cu) takes the counts as they are; block 0 of each row also
// zeroes that pass's per-row hand-off counter, since the second pass runs
// after this kernel on the same stream. Given an (N, 64) output, the C entry
// enqueues a second small kernel that sums the counts into the row
// histogram (four fine bins a bin, NaN back in bin 0): the contract of
// maghist_batch alone.
#include "exponent_bins.cuh"

namespace {

using exphist::kBins;
using exphist::kFine;
using exphist::kSlots;
using exphist::kSubBits;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;

__global__ void __launch_bounds__(kThreads)
block_counts_kernel(const float* __restrict__ g, int* __restrict__ counts,
                    int* __restrict__ ctr, int d, int chunk) {
  __shared__ int h[kWarps * kSlots];
  int* mine = h + (threadIdx.x / 32) * kSlots;
  for (int t = threadIdx.x; t < kWarps * kSlots; t += kThreads) h[t] = 0;
  __syncthreads();
  const long long row = blockIdx.y;
  const float* rowp = g + row * d;
  const long long start = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = min(start + chunk, static_cast<long long>(d));
  for (long long i0 = start + threadIdx.x; i0 < end;
       i0 += kThreads * kItems) {
    float v[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const long long i = i0 + u * kThreads;
      v[u] = i < end ? __ldg(rowp + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u)
      if (i0 + u * kThreads < end)
        atomicAdd(&mine[exphist::report_slot(v[u])], 1);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kSlots; t += kThreads) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += h[w * kSlots + t];
    counts[(row * gridDim.x + blockIdx.x) * kSlots + t] = s;
  }
  if (ctr != nullptr && blockIdx.x == 0 && threadIdx.x == 0) ctr[row] = 0;
}

// One block of kBins threads per row: bin t summed over its fine bins and
// the row's blocks in block order, NaN counted in bin 0.
__global__ void __launch_bounds__(kBins)
row_sum_kernel(const int* __restrict__ counts, int* __restrict__ hist,
               int parts) {
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const int* c = counts + row * parts * kSlots;
  int s = 0;
  for (int p = 0; p < parts; ++p) {
    for (int f = 0; f < (1 << kSubBits); ++f)
      s += c[p * kSlots + (t << kSubBits) + f];
    s += t == 0 ? c[p * kSlots + kFine] : 0;
  }
  hist[row * kBins + t] = s;
}

}  // namespace

// g: (n, d) float32; counts: (n, ceil(d / chunk), 257) int32, written whole;
// ctr: (n,) int32 set to 0, or null; hist: (n, 64) int32 row histograms, or
// null for the report, which reads the counts.
extern "C" int maghist_batch(const void* g, void* counts, void* ctr,
                             void* hist, int n, int d, int chunk,
                             void* stream) {
  if (n > 0 && d > 0) {
    const int parts = (d + chunk - 1) / chunk;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    block_counts_kernel<<<dim3(parts, n), kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<int*>(counts),
        static_cast<int*>(ctr), d, chunk);
    if (hist != nullptr)
      row_sum_kernel<<<n, kBins, 0, st>>>(static_cast<const int*>(counts),
                                          static_cast<int*>(hist), parts);
  }
  return static_cast<int>(cudaGetLastError());
}
