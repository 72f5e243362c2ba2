// segmented_age_topk: the rAge-k selection. For every cluster, members
// s = 0..S-1 in order each pick the k highest-age lanes of their R
// candidates, ties to the lower lane; a candidate already taken by an
// earlier valid member of the same cluster is masked to age -1 first.
//
// Replaces the Pallas kernel repro/kernels/segmented_topk.py::
// segmented_age_topk (_kernel), one program per cluster with a fori_loop
// over members and k first-occurrence argmax passes over a lane-padded
// (S, R) tile.
//
// Bound on the H100: latency. At fig3 (C <= 10, S <= 2, R = 75, k = 10) the
// kernel reads under 13 KB; at CIFAR (C x S = 6, R = 2,500, k = 100) 120
// KB. What costs is the order: member s sees the picks of members < s.
// Design: only that walk is serial. One block per cluster (clusters are
// independent), its threads a power of two up to 1,024.
// 1. Rank: every member's R lanes are sorted at once, all S members in
//    parallel, by the 64-bit key (age descending, lane ascending) in one
//    bitonic network over S shared-memory segments of a power of two each
//    (bitonic.cuh; lanes past R pad the segment with the largest key).
//    This is the order the argmax chain picks in when no lane is masked.
// 2. Walk the members in order. Member s takes the first k lanes of its
//    ranked list whose candidate is not taken (masked ages are -1 and
//    every other age is >= 0, so the untaken lanes keep their order and
//    come first); a block-wide ballot count gives each untaken lane its
//    place, a chunk of the list at a time. If fewer than k remain, the
//    taken lanes follow in lane order, since they all carry age -1. A
//    member costs a few barriers, whatever k is.
// 3. The taken set is an open-addressing hash of candidate indices in
//    shared memory (at most S*k entries, at most half full): a lookup is
//    O(1) expected, and a member's picks enter it only when valid[c, s] is
//    set. A candidate of -1 always counts as taken, as the reference's
//    buffer of -1 fillers makes it.
#include <climits>
#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

using bitonic::spad;
constexpr int kEmpty = INT_MIN;           // a free hash slot
constexpr unsigned long long kPadKey = ~0ull;

// Ascending order of the key: age descending, then lane ascending.
__device__ __forceinline__ unsigned long long rank_key(int age, int lane) {
  const unsigned a = ~(static_cast<unsigned>(age) ^ 0x80000000u);
  return (static_cast<unsigned long long>(a) << 32) |
         static_cast<unsigned>(lane);
}

__device__ __forceinline__ unsigned mix(int x) {   // murmur3's finalizer
  unsigned h = static_cast<unsigned>(x);
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ bool is_taken(const int* tab, int mask, int x) {
  if (x == -1) return true;
  for (unsigned h = mix(x) & mask;; h = (h + 1) & mask) {
    const int v = tab[h];
    if (v == x) return true;
    if (v == kEmpty) return false;
  }
}

__device__ void insert(int* tab, int mask, int x) {
  for (unsigned h = mix(x) & mask;; h = (h + 1) & mask) {
    const int prev = atomicCAS(&tab[h], kEmpty, x);
    if (prev == kEmpty || prev == x) return;
  }
}

// The number of set flags before this thread in thread order, and the
// block's total. Every thread calls it; it holds two barriers.
__device__ int block_rank(bool flag, int* warp_n, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_n[warp] = __popc(m);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < warps; ++w) {
    const int c = warp_n[w];
    before += w < warp ? c : 0;
    all += c;
  }
  __syncthreads();
  *total = all;
  return before + __popc(m & ((1u << lane) - 1u));
}

// Member s's picks from the list `lane_at(j)`, j < n, in list order: the
// entries whose flag `want(lane)` is set, until k are found in all.
template <class LaneAt, class Want>
__device__ void take_in_order(int n, int k, LaneAt lane_at, Want want,
                              const int* cs, int* sel, int* found,
                              int* warp_n) {
  for (int base = 0; base < n; base += blockDim.x) {
    const int have = *found;   // read by every thread after a barrier
    if (have >= k) break;
    const int j = base + threadIdx.x;
    const int lane = j < n ? lane_at(j) : 0;
    const bool f = j < n && want(lane);
    int total;
    const int o = block_rank(f, warp_n, &total);
    if (f && have + o < k) sel[have + o] = cs[lane];
    __syncthreads();
    if (threadIdx.x == 0) *found = have + total;
    __syncthreads();
  }
}

// Cand is int or long long (indices below 2^31), so that the wrapper
// passes the engine's int64 candidates on without a conversion launch.
template <class Cand>
__global__ void __launch_bounds__(1024)
segmented_age_topk_kernel(const Cand* __restrict__ cand,
                          const int* __restrict__ age,
                          const bool* __restrict__ valid,
                          int* __restrict__ out, int S, int R, int Rp,
                          int k, int disjoint, int hash) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* key = smem;   // (S, Rp) ranked keys, at spad
  int* cnd = reinterpret_cast<int*>(key + spad(S * Rp));  // (S, R) lanes
  int* tab = cnd + S * R;                             // (hash,) taken set
  int* sel = tab + hash;                              // (k,) member's picks
  __shared__ int warp_n[32];
  __shared__ int found;

  const int tid = threadIdx.x, nt = blockDim.x;
  const long long cl = blockIdx.x;
  const Cand* cg = cand + cl * S * R;
  const int* ag = age + cl * S * R;
  for (int i = tid; i < S * Rp; i += nt) {
    const int s = i / Rp, l = i - s * Rp;
    key[spad(i)] = l < R ? rank_key(ag[s * R + l], l) : kPadKey;
  }
  for (int i = tid; i < S * R; i += nt) cnd[i] = static_cast<int>(cg[i]);
  for (int i = tid; i < hash; i += nt) tab[i] = kEmpty;
  __syncthreads();

  // 1. rank every member's lanes at once: a bitonic network per segment
  bitonic::sort(key, S * Rp, Rp);

  // 2. walk the members in order
  const int mask = hash - 1;
  for (int s = 0; s < S; ++s) {
    const int* cs = cnd + s * R;
    if (tid == 0) found = 0;
    __syncthreads();
    take_in_order(
        R, k,
        [&](int j) {
          return static_cast<int>(key[spad(s * Rp + j)] & 0xFFFFFFFFull);
        },
        [&](int lane) { return !(disjoint && is_taken(tab, mask, cs[lane])); },
        cs, sel, &found, warp_n);
    if (found < k)   // the taken lanes, all at age -1, in lane order
      take_in_order(
          R, k, [](int j) { return j; },
          [&](int lane) { return is_taken(tab, mask, cs[lane]); }, cs, sel,
          &found, warp_n);
    const long long row = cl * S + s;
    for (int j = tid; j < k; j += nt) out[row * k + j] = sel[j];
    if (disjoint && valid[row])
      for (int j = tid; j < k; j += nt) insert(tab, mask, sel[j]);
    __syncthreads();
  }
}


template <class Cand>
int launch(const void* cand, const void* age, const void* valid, void* out,
           int C, int S, int R, int k, int disjoint, int Rp, int hash,
           int threads, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(S) * Rp;
  const size_t smem = sizeof(unsigned long long) * (n + n / 16) +
                      sizeof(int) * (static_cast<size_t>(S) * R + hash + k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segmented_age_topk_kernel<Cand>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  segmented_age_topk_kernel<Cand><<<C, threads, smem, stream>>>(
      static_cast<const Cand*>(cand), static_cast<const int*>(age),
      static_cast<const bool*>(valid), static_cast<int*>(out), S, R, Rp, k,
      disjoint, hash);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cand: (C, S, R) int32, or int64 when cand64; age: (C, S, R) int32;
// valid: (C, S) bool; out: (C, S, k) int32. Needs 1 <= k <= R, Rp the
// power of two >= R, hash a power of two >= 2*S*k, threads a power of two
// in [32, 1024], and 8*spad(S*Rp) + 4*(S*R + hash + k) bytes of shared
// memory (spad(n) = n + n / 16).
extern "C" int segmented_age_topk(const void* cand, const void* age,
                                  const void* valid, void* out, int C, int S,
                                  int R, int k, int disjoint, int cand64,
                                  int Rp, int hash, int threads,
                                  void* stream) {
  if (C <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cand64 ? launch<long long>(cand, age, valid, out, C, S, R, k,
                                    disjoint, Rp, hash, threads, st)
                : launch<int>(cand, age, valid, out, C, S, R, k, disjoint,
                              Rp, hash, threads, st);
}
