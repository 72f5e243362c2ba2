// A sort of 64-bit keys in device memory, segment by segment, for lists
// longer than one block's shared memory holds: shared by report.cu (the
// candidate report's gathered pairs past 8,192) and segmented_topk.cu
// (every member's lanes ranked at once, where one block cannot hold a
// cluster).
//
// Bound on the H100: bytes and latency. A pass reads and writes every key
// once; the report's largest use (a few rows of 32,768 keys) is under a
// megabyte a pass, so each pass is a launch or two of latency.
//
// Design. Runs of at most kRun keys (a segment, or a kRun piece of one)
// are sorted in shared memory by bitonic.cuh, several short segments to a
// block so that a block sorts at least 1,024 keys. Then merge passes
// double the sorted runs until they span the segment: every key's place is
// its index in its run plus its rank in the partner run, found by a binary
// search (keys below it for the left run, keys at or below it for the
// right), so equal keys keep their order, every place is taken once, and
// the result is the same run to run. No atomics.
#pragma once

#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace gsort {
namespace {

constexpr int kRun = 8192;        // keys one block sorts in shared memory
constexpr int kMinSpan = 1024;    // keys a block of the run pass sorts
constexpr int kRunThreads = 1024; // a run block: 8 keys a thread at kRun
constexpr int kThreads = 256;     // a merge block: one key a thread
constexpr unsigned long long kPadKey = ~0ull;

// Block b sorts keys [b * span, (b + 1) * span) of a as segments of run
// keys each, in shared memory; places at or past n read as pads and are not
// written back.
__global__ void __launch_bounds__(kRunThreads)
run_kernel(unsigned long long* __restrict__ a, long long n, int span,
           int run) {
  extern __shared__ unsigned long long buf[];
  const long long base = static_cast<long long>(blockIdx.x) * span;
  for (int i = threadIdx.x; i < span; i += kRunThreads)
    buf[bitonic::spad(i)] = base + i < n ? a[base + i] : kPadKey;
  __syncthreads();
  bitonic::sort(buf, span, run);
  for (int i = threadIdx.x; i < span; i += kRunThreads)
    if (base + i < n) a[base + i] = buf[bitonic::spad(i)];
}

// One merge pass: the sorted runs of width keys, paired within their
// segment (width < segment, both powers of two), merged from src into dst.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const unsigned long long* __restrict__ src,
             unsigned long long* __restrict__ dst, long long n, int width) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const long long pair = i & ~(2LL * width - 1);
  const int j = static_cast<int>(i - pair);
  const bool left = j < width;
  const unsigned long long key = src[i];
  const unsigned long long* other = src + pair + (left ? width : 0);
  int lo = 0, hi = width;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const unsigned long long o = other[mid];
    if (left ? o < key : o <= key) lo = mid + 1; else hi = mid;
  }
  dst[pair + (left ? j : j - width) + lo] = key;
}

// Sorts each segment of seg keys (a power of two) of a[0, n) ascending; n
// is a multiple of seg and tmp holds n keys. *out is set to the buffer
// that holds the result (a, or tmp after an odd number of merge passes).
// Returns the first launch error.
inline cudaError_t sort_segments(unsigned long long* a,
                                 unsigned long long* tmp, long long n,
                                 int seg, cudaStream_t stream,
                                 unsigned long long** out) {
  *out = a;
  if (n <= 0) return cudaSuccess;
  const int run = seg < kRun ? seg : kRun;
  const int span = run < kMinSpan ? kMinSpan : run;
  const size_t smem = sizeof(unsigned long long) * (span + span / 16);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        run_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  run_kernel<<<static_cast<unsigned>((n + span - 1) / span), kRunThreads,
               smem, stream>>>(a, n, span, run);
  cudaError_t err = cudaGetLastError();
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  for (int width = run; width < seg && err == cudaSuccess; width *= 2) {
    unsigned long long* dst = *out == a ? tmp : a;
    merge_kernel<<<blocks, kThreads, 0, stream>>>(*out, dst, n, width);
    *out = dst;
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace
}  // namespace gsort
