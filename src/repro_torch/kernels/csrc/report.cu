// threshold_topk_batch: the second pass of the rAge-k candidate report. For
// every row of G (N, d), the stable top-r of where(isnan, -1, |g|): the
// indices of the r largest magnitudes, ties to the lower index, NaN lanes
// last in index order. The first pass (maghist.cu) wrote each block's 257
// counts; this pass computes the threshold from them, compacts the
// survivors and ranks them, with no full-row sort.
//
// Replaces, with maghist.cu, the Pallas kernel
// repro/kernels/maghist.py::maghist_batch and the XLA epilogue of
// repro/kernels/ops.py::threshold_topk_batch (threshold_from_hist_batch,
// then lax.top_k of the masked row).
//
// Bound on the H100: bytes. The report must read N*d floats once (the
// first pass) and this pass reads them again; at the CIFAR report (6 x
// 2,515,338) that is 60 MB a read, 18 us at 3.35 TB/s; at fig3 (10 x
// 39,760) the row is in L2 and a launch is latency.
//
// Design. Grid (P, N) over the first pass's ranges, 256 threads, at most
// 64 registers so that four blocks share an SM; the blocks take the ranges
// in the reverse of the first pass's order, so that the second read finds
// in L2 what the first read last.
// 1. Every block sums its row's block counts (P <= 64 rows of 257 ints,
//    read from L2) and finds the threshold bin b among the fine bins (a
//    quarter binade, exponent_bins.cuh::report_slot, whose sums are the 64
//    exponent bins): the largest fine bin whose count from the top is >= r,
//    b = 0 (tau = 0, every non-NaN value) when there is none. The
//    survivors are the non-NaN values of fine bins >= b: all A = (count
//    above bin b) < r of the bins above go into the report, and the top
//    m = r - A of bin b's n2 values. A quarter binade holds a quarter or
//    less of a binade's values, so fewer survivors reach the last block.
// 2. Compaction, in index order, with no atomics deciding the order: the
//    counts of the blocks before this one give its write offsets into a
//    per-row buffer of (|g| bits, index) pairs laid out [the A values above
//    b | the n2 values of bin b | the NaN lanes]. Each warp owns a
//    contiguous eighth of the block's range and streams it 16 loads deep
//    with no barrier, sorting each element into the three by comparing its
//    bits with bin b's key range: one ballot a row of 32 shows most rows
//    keep nothing; the warp counts the kept ones and notes the rows that
//    hold them (at most 192, else it reads all its rows again). One block
//    scan of the warps' counts gives each warp its offsets; it then reads
//    again only its noted rows and writes their kept elements, ballots
//    giving the order within a row. NaN lanes are kept only when A + n2 < r
//    (b = 0 and fewer than r non-NaN values), and only the first r - A - n2
//    of them. When A + n2 exceeds the sort buffer, each block also counts
//    its bin-b values by the first radix digit below the bin (256 digits)
//    and writes the counts out.
// 3. Hand-off: each block fences its writes and counts itself in on the
//    row's counter (zeroed by the first pass); the last block of the row
//    goes on alone.
// 4. Refine (radix select): the blocks' digit counts, summed, give the
//    digit that holds bin b's m-th largest key (the 8 bits below the fine
//    bin, or below the sign bit in the two edge bins, whose values span
//    many exponents); while A + (gathered values of bin b) still exceed the
//    sort buffer (a power of two >= 1.5 r, at most 8,192 pairs), a pass
//    over bin b's keys counts the next 8 bits inside the chosen range. If
//    the range shrinks to one key held by too many lanes, the keys above it
//    and then its first holders in buffer order, which is index order, are
//    taken (an ordered pass that stops once it has them). The result stays
//    exact at any survivor count. These passes read 16 keys a thread ahead
//    and count or place them with one shared atomic per distinct digit or
//    per warp.
// 5. The gathered pairs (at most the buffer) are sorted in shared memory
//    (bitonic.cuh: 8 keys a thread in registers) by the 64-bit key (|g|
//    bits descending, index ascending), past 256 pairs as two runs of
//    powers of two merged by rank; the first r indices are the report, then
//    the NaN lanes.
#include <algorithm>
#include <cstdint>

#include "bitonic.cuh"
#include "exponent_bins.cuh"

namespace {

using bitonic::spad;
using exphist::kBins;
using exphist::kFine;
using exphist::kOffset;
using exphist::kSlots;
using exphist::kSubBits;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;       // rows of 32 a warp reads ahead
constexpr int kListRows = 192;  // rows a warp notes for the write pass
constexpr int kTailItems = 16;  // keys a thread of the last block reads ahead
constexpr int kDigits = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPadKey = ~0ull;

// Ascending order of the key: |g| bits descending, then index ascending.
__device__ __forceinline__ unsigned long long sort_key(unsigned key,
                                                       int idx) {
  return (static_cast<unsigned long long>(0x7FFFFFFFu - key) << 32) |
         static_cast<unsigned>(idx);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// 0 for an element outside the range or below bin b, 1 above bin b, 2 in
// bin b (keys [lo, hi)), 3 a NaN lane that the report may need.
__device__ __forceinline__ int category(float x, bool in, unsigned lo,
                                        unsigned hi, bool keep_nan) {
  const unsigned key = __float_as_uint(fabsf(x));
  if (!in) return 0;
  if (key > 0x7F800000u) return keep_nan ? 3 : 0;   // NaN
  return key >= hi ? 1 : key >= lo ? 2 : 0;
}

// h[digit] += 1 for every lane of the warp with `valid`, one shared atomic
// for each distinct digit. Every lane of the warp calls it.
__device__ __forceinline__ void count_digit(int* h, int digit, bool valid) {
  const unsigned act = __ballot_sync(kFull, valid);
  if (!valid) return;
  const unsigned peers = __match_any_sync(act, digit);
  if (lane_id() == __ffs(peers) - 1) atomicAdd(&h[digit], __popc(peers));
}

// The first of `n` places for this lane among *got's next places, one
// shared atomic a warp. Every lane of the warp calls it.
__device__ __forceinline__ int claim(int* got, int n) {
  int incl = n;   // the lanes' counts up to this lane
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane_id() >= off) incl += o;
  }
  int base = 0;
  if (lane_id() == 31 && incl) base = atomicAdd(got, incl);
  return __shfl_sync(kFull, base, 31) + incl - n;
}

// The number of set flags before this thread in thread order, and the
// block's total. Every thread calls it; it holds two barriers.
__device__ int block_rank(bool flag, int* warp_n, int* total) {
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(kFull, flag);
  if (lane == 0) warp_n[warp] = __popc(m);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_n[w];
    before += w < warp ? c : 0;
    all += c;
  }
  __syncthreads();
  *total = all;
  return before + __popc(m & ((1u << lane) - 1u));
}

// Warp 0: the largest slot D in [first, n) of h (n a multiple of 32) whose
// count from the top, h[D] + ... + h[n - 1], reaches `need`, and that count
// less h[D]; or first - 1 and the count of [first, n) if there is none.
__device__ void pick_top(const int* h, int n, int first, int need,
                         int* slot, int* cum) {
  if (threadIdx.x >= 32) return;
  const int lane = lane_id(), per = n >> 5;
  int s = 0;
  for (int u = 0; u < per; ++u)
    s += lane * per + u >= first ? h[lane * per + u] : 0;
  int suf = s;   // the lanes' sums from this lane up
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_down_sync(kFull, suf, off);
    if (lane + off < 32) suf += o;
  }
  const unsigned ok = __ballot_sync(kFull, suf >= need && s > 0);
  if (!ok) {
    if (lane == 0) {
      *slot = first - 1;
      *cum = suf;
    }
  } else if (lane == 31 - __clz(ok)) {
    int c = suf - s, dg = lane * per + per - 1;
    for (; dg > lane * per; --dg) {
      if (c + h[dg] >= need) break;
      c += h[dg];
    }
    *slot = dg;
    *cum = c;
  }
}

__global__ void __launch_bounds__(kThreads, 4)
report_kernel(const float* __restrict__ g, const int* __restrict__ counts,
              int* __restrict__ ctr, int* __restrict__ dcounts,
              unsigned* __restrict__ skey, int* __restrict__ sidx,
              int* __restrict__ out, int d, int chunk, int r, int sort_cap) {
  extern __shared__ unsigned long long dyn[];   // the last block's sort
  __shared__ int rh[kSlots];
  __shared__ int warp_n[3][kWarps], warp_c[3][kWarps];
  __shared__ int digit_h[kDigits];
  __shared__ int row_list[kWarps][kListRows];
  __shared__ int s_b, s_above, s_last, s_cum, s_digit, s_got, s_eq;

  const int parts = gridDim.x, tid = threadIdx.x;
  const int p = parts - 1 - blockIdx.x;   // the first pass's last first
  const int lane = tid & 31, warp = tid >> 5;
  const long long row = gridDim.y - 1 - blockIdx.y;
  const int* rc = counts + row * parts * kSlots;   // the row's block counts

  // 1. the row histogram and the threshold bin
  for (int i = tid; i < kDigits; i += kThreads) digit_h[i] = 0;
  for (int t = tid; t < kSlots; t += kThreads) {
    int s = 0;
#pragma unroll 16
    for (int q = 0; q < parts; ++q) s += rc[q * kSlots + t];
    rh[t] = s;
  }
  __syncthreads();
  pick_top(rh, kFine, 1, r, &s_b, &s_above);   // fine bin 0 means tau = 0
  __syncthreads();
  const int b = s_b, above = s_above, n2 = rh[b];
  const int nan_need = max(0, r - above - n2);
  const bool refine = above + n2 > sort_cap;
  const int bin = b >> kSubBits;
  const bool edge = bin == 0 || bin == kBins - 1;   // many exponents
  const int shift0 = edge ? 31 : 23 - kSubBits;     // bits below bin b
  const int s1 = shift0 - 8;                        // the first digit's
  const unsigned prefix0 =
      edge ? 0u
           : static_cast<unsigned>(bin - kOffset + 127) << 23 |
                 static_cast<unsigned>(b & ((1 << kSubBits) - 1)) << shift0;
  // bin b's keys: [lo_key, hi_key)
  const unsigned lo_key =
      bin == kBins - 1 ? static_cast<unsigned>(kBins - 1 - kOffset + 127) << 23
                       : prefix0;
  const unsigned hi_key =
      bin == 0 ? static_cast<unsigned>(1 - kOffset + 127) << 23
      : edge   ? 0xFFFFFFFFu
               : prefix0 + (1u << shift0);

  // 2. this block's offsets from the counts of the blocks before it, then
  // the compaction of its range in index order
  int oa = 0, ot = 0, on = 0;   // lane l sums fine bins 8l .. 8l + 7
#pragma unroll 4
  for (int q = warp; q < p; q += kWarps) {
    const int* c = rc + q * kSlots;
    for (int u = 0; u < kFine / 32; ++u) {
      const int f = lane * (kFine / 32) + u;
      oa += f > b ? c[f] : 0;
    }
    ot += lane == 0 ? c[b] : 0;
    on += lane == 0 ? c[kFine] : 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    oa += __shfl_down_sync(kFull, oa, off);
  const float* rowp = g + row * d;
  unsigned* rk = skey + row * d;
  int* ri = sidx + row * d;
  const int nan_base = above + n2;
  const bool keep_nan = nan_need > 0;
  const unsigned lt = (1u << lane) - 1u;
  // warp w owns rows of 32 elements [ws, we) of the block's range
  const long long start = static_cast<long long>(p) * chunk;
  const long long end = min(start + chunk, static_cast<long long>(d));
  const long long wlen = (end - start + 32 * kWarps - 1) / (32 * kWarps) * 32;
  const long long ws = min(start + warp * wlen, end);
  const long long we = min(ws + wlen, end);
  int* rows = row_list[warp];
  int nrows = 0;   // rows holding an element to keep, in order
  int ca = 0, ct = 0, cn = 0;
#define REPORT_CAT(i, x) category(x, (i) < we, lo_key, hi_key, keep_nan)
  for (long long i0 = ws; i0 < we; i0 += 32 * kRows) {
    float v[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long i = i0 + u * 32 + lane;
      v[u] = i < we ? __ldg(rowp + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int cat = REPORT_CAT(i0 + u * 32 + lane, v[u]);
      if (__ballot_sync(kFull, cat != 0)) {   // rare: most rows keep none
        if (lane == 0 && nrows < kListRows)
          rows[nrows] = static_cast<int>((i0 - ws) / 32) + u;
        ++nrows;
        ca += __popc(__ballot_sync(kFull, cat == 1));
        ct += __popc(__ballot_sync(kFull, cat == 2));
        cn += __popc(__ballot_sync(kFull, cat == 3));
        if (refine && cat == 2)   // few lanes: a plain shared atomic
          atomicAdd(&digit_h[(__float_as_uint(fabsf(v[u])) >> s1) & 0xFF],
                    1);
      }
    }
  }
  if (lane == 0) {
    warp_n[0][warp] = oa;   // the blocks before this one
    warp_n[1][warp] = ot;
    warp_n[2][warp] = on;
    warp_c[0][warp] = ca;   // this warp's rows
    warp_c[1][warp] = ct;
    warp_c[2][warp] = cn;
  }
  __syncthreads();
  int xa = 0, xt = above, xn = 0;
  for (int w = 0; w < kWarps; ++w) {
    xa += warp_n[0][w] + (w < warp ? warp_c[0][w] : 0);
    xt += warp_n[1][w] + (w < warp ? warp_c[1][w] : 0);
    xn += warp_n[2][w] + (w < warp ? warp_c[2][w] : 0);
  }
  // write the kept elements, reading again only the rows that hold them
  // (all of the warp's rows if they overflowed the list)
  const bool listed = nrows <= kListRows;
  const int nr = listed ? nrows : static_cast<int>((we - ws + 31) / 32);
  for (int j = 0; j < nr; ++j) {
    const long long i = ws + 32LL * (listed ? rows[j] : j) + lane;
    const float x = i < we ? __ldg(rowp + i) : 0.0f;
    const int cat = REPORT_CAT(i, x);
    const unsigned ma = __ballot_sync(kFull, cat == 1);
    const unsigned mt = __ballot_sync(kFull, cat == 2);
    const unsigned mn = __ballot_sync(kFull, cat == 3);
    const unsigned key = __float_as_uint(fabsf(x));
    if (cat == 1) {
      const int pos = xa + __popc(ma & lt);
      rk[pos] = key;
      ri[pos] = static_cast<int>(i);
    } else if (cat == 2) {
      const int pos = xt + __popc(mt & lt);
      rk[pos] = key;
      ri[pos] = static_cast<int>(i);
    } else if (cat == 3) {
      const int rank = xn + __popc(mn & lt);
      if (rank < nan_need) ri[nan_base + rank] = static_cast<int>(i);
    }
    xa += __popc(ma);
    xt += __popc(mt);
    xn += __popc(mn);
  }
#undef REPORT_CAT
  if (refine) {
    __syncthreads();
    for (int i = tid; i < kDigits; i += kThreads)
      dcounts[(row * parts + p) * kDigits + i] = digit_h[i];
  }

  // 3. hand-off: the last block of the row to finish goes on
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&ctr[row], 1) == parts - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // 4. refine the range of bin b's keys that holds the m-th largest until
  // what is gathered fits the sort buffer
  const unsigned* tk = rk + above;
  const int* ti = ri + above;
  const int m = r - above;
  int shift = shift0;
  unsigned prefix = prefix0;
  int c_gt = 0, n_r = n2;   // keys above the range; keys inside it
  if (refine) {   // the first digit: the sum of every block's counts
    for (int i = tid; i < kDigits; i += kThreads) {
      int s = 0;
      for (int q = 0; q < parts; ++q)
        s += __ldcg(dcounts + (row * parts + q) * kDigits + i);
      digit_h[i] = s;
    }
  }
  for (int level = 0; above + c_gt + n_r > sort_cap && shift > 0; ++level) {
    const int w = min(8, shift), s = shift - w;
    const unsigned dm = (1u << w) - 1u;
    if (level > 0) {   // count the next digit inside the range
      for (int i = tid; i < kDigits; i += kThreads) digit_h[i] = 0;
      __syncthreads();
      for (int i0 = 0; i0 < n2; i0 += kThreads * kTailItems) {
        unsigned k[kTailItems];
#pragma unroll
        for (int u = 0; u < kTailItems; ++u) {
          const int i = i0 + u * kThreads + tid;
          k[u] = i < n2 ? __ldcg(tk + i) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kTailItems; ++u)
          count_digit(digit_h, (k[u] >> s) & dm,
                      i0 + u * kThreads + tid < n2 &&
                          (k[u] >> shift) == (prefix >> shift));
      }
    }
    __syncthreads();
    pick_top(digit_h, 1 << w, 0, m - c_gt, &s_digit, &s_cum);
    __syncthreads();
    c_gt += s_cum;
    n_r = digit_h[s_digit];
    prefix |= static_cast<unsigned>(s_digit) << s;
    shift = s;
    __syncthreads();   // digit_h is cleared by the next level
  }

  // gather: every value above bin b, then bin b's values above the range,
  // then those inside it (all, or their first holders when one key remains)
  unsigned long long* buf = dyn;
  for (int i = tid; i < above; i += kThreads)
    buf[spad(i)] = sort_key(__ldcg(rk + i), __ldcg(ri + i));
  if (tid == 0) {
    s_got = 0;
    s_eq = 0;
  }
  __syncthreads();
  const bool fits = above + c_gt + n_r <= sort_cap;
  // fits: the keys at or above the range; else (shift is 0): above it
  const int lo_shift = fits ? shift : 0;
  const unsigned lo = fits ? prefix >> shift : prefix + 1;
  for (int i0 = 0; i0 < n2; i0 += kThreads * kTailItems) {
    unsigned k[kTailItems];
#pragma unroll
    for (int u = 0; u < kTailItems; ++u) {
      const int i = i0 + u * kThreads + tid;
      k[u] = i < n2 ? __ldcg(tk + i) : 0u;
    }
    unsigned take = 0;   // bit u: item u goes
#pragma unroll
    for (int u = 0; u < kTailItems; ++u)
      if (i0 + u * kThreads + tid < n2 && (k[u] >> lo_shift) >= lo)
        take |= 1u << u;
    int pos = above + claim(&s_got, __popc(take));
#pragma unroll
    for (int u = 0; u < kTailItems; ++u)
      if ((take >> u) & 1u)
        buf[spad(pos++)] = sort_key(k[u], __ldcg(ti + i0 + u * kThreads + tid));
  }
  int count = r;
  __syncthreads();
  if (fits) {
    count = above + s_got;
  } else {
    const int q = m - c_gt;   // the first holders of the key `prefix`
    for (int i0 = 0; i0 < n2; i0 += kThreads) {
      const int have = s_eq;   // read by every thread after a barrier
      if (have >= q) break;
      const int i = i0 + tid;
      const bool eq = i < n2 && __ldcg(tk + i) == prefix;
      int tot;
      const int o = block_rank(eq, warp_n[0], &tot);
      if (eq && have + o < q)
        buf[spad(above + c_gt + have + o)] =
            sort_key(prefix, __ldcg(ti + i));
      __syncthreads();
      if (tid == 0) s_eq = have + tot;
      __syncthreads();
    }
  }

  // 5. sort the gathered pairs; the first r are the report. Past 256 pairs
  // (one warp's sort, bitonic.cuh) the largest power of two P <= count and
  // the rest (padded to a power of two Q) sort as two runs, merged by each
  // pair's rank in the other run: 2,512 pairs sort as 2,048 + 512, not
  // 4,096.
  int* o = out + row * r;
  int P = 1;
  while (2 * P <= count) P *= 2;
  const int rest = count - P;
  int Q = 1;
  while (Q < rest) Q <<= 1;
  if (count <= bitonic::kWarpKeys || rest == 0) {
    const int sp = rest ? 2 * P : P;
    for (int i = count + tid; i < sp; i += kThreads) buf[spad(i)] = kPadKey;
    __syncthreads();
    bitonic::sort(buf, sp, sp);
    for (int j = tid; j < min(r, count); j += kThreads)
      o[j] = static_cast<int>(buf[spad(j)] & 0xFFFFFFFFull);
  } else {
    for (int i = count + tid; i < P + Q; i += kThreads)
      buf[spad(i)] = kPadKey;
    __syncthreads();
    bitonic::sort(buf, P, P);
    bitonic::sort(buf + spad(P), Q, Q);   // spad(P + j) = spad(P) + spad(j)
    for (int i = tid; i < count; i += kThreads) {
      const unsigned long long key = buf[spad(i)];
      const bool first = i < P;
      int lo = first ? P : 0, hi = first ? count : P;   // the other run
      const int own = first ? i : i - P, base = lo;
      while (lo < hi) {   // the other run's keys below this one
        const int mid = (lo + hi) >> 1;
        if (buf[spad(mid)] < key) lo = mid + 1; else hi = mid;
      }
      const int pos = own + lo - base;
      if (pos < r) o[pos] = static_cast<int>(key & 0xFFFFFFFFull);
    }
  }
  for (int j = count + tid; j < r; j += kThreads)
    o[j] = __ldcg(ri + nan_base + (j - count));
}

}  // namespace

// g: (n, d) float32; counts: (n, ceil(d / chunk), 257) int32 and ctr: (n,)
// int32 zeroed, both from maghist_batch on the same stream; dcounts: (n,
// ceil(d / chunk), 256) int32, skey, sidx: (n, d) int32 scratch; out: (n,
// r) int32. Needs 1 <= r <= d, r <= 8192, a power-of-two sort_cap in
// [r, 8192], chunk a multiple of 4096 with ceil(d / chunk) <= 64.
extern "C" int threshold_topk_batch(const void* g, const void* counts,
                                    void* ctr, void* dcounts, void* skey,
                                    void* sidx, void* out, int n, int d,
                                    int chunk, int r, int sort_cap,
                                    void* stream) {
  if (n > 0 && d > 0) {
    const int parts = (d + chunk - 1) / chunk;
    const size_t smem =
        sizeof(unsigned long long) * (sort_cap + sort_cap / 16);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          report_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    report_kernel<<<dim3(parts, n), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<const int*>(counts),
        static_cast<int*>(ctr), static_cast<int*>(dcounts),
        static_cast<unsigned*>(skey), static_cast<int*>(sidx),
        static_cast<int*>(out), d, chunk, r, sort_cap);
  }
  return static_cast<int>(cudaGetLastError());
}
