// decode_attention: one new query token per head attending to the first
// n positions of a (B, S, G, D) KV cache with grouped-query heads
// (rep = H / G query heads share one KV head), scale D^-1/2, online
// softmax in float32. The decode-step attention of every layer of the LM.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::
// decode_attention (_kernel), whose sequential TPU grid carries the
// running max, sum and accumulator of the online softmax in VMEM scratch
// from one 512-position block to the next, one kv group at a time.
//
// Bound on the H100: bytes. The call reads each valid K and V row once
// (at B 8, G 8, D 128, 32,768 positions in bfloat16 that is 1.07 GB,
// 0.32 ms at 3.35 TB/s) and does 4 float operations per K or V element
// for each of the rep query rows, far below the card's compute.
//
// Design: a split-KV decode with a fixed-order combine. One block (256
// threads) of the partial kernel per (split, kv group, batch row) walks
// one contiguous range of the cache: the split's share, cut on the host
// (kernels/decode_attention.py::choose_splits) so that B * G * splits
// blocks cover the SMs, every split at least one tile long. One block per
// (batch row, kv group) alone, 64 blocks at internlm2's B 8, G 8, left
// half of the 132 SMs idle at a long cache and 130 of them at B x G = 2.
// A block holds the group's rep query rows, pre-scaled, and walks its
// range in tiles of K and of V staged through shared memory by cp.async
// two tiles deep. The tile is one of two sizes, chosen on the host with
// the splits: 48 KB (192 positions at D 128 in bfloat16, one block an
// SM) where those blocks fill the SMs or one tile holds the cache, else
// 24 KB (96 positions, two blocks an SM, one block's barriers hidden
// behind the other's work) for twice the splits of a short cache with
// few (batch row, kv group) pairs; the small one also where the large
// one's scores overflow shared memory (D 32 in bfloat16 past 8 query rows a
// kv head). Per tile, three phases between barriers:
// (1) scores: a group of eight lanes takes one position (each lane
//     16-byte chunks of the row, neighbouring lanes on neighbouring
//     chunks), a warp four positions at a time, the query rows in
//     registers; a three-step reduction inside the group; each warp keeps
//     each row's max over its positions. A row of fewer than eight chunks
//     (D 32 in bfloat16: four) takes a group of that many lanes, and a
//     warp then scores more positions at a time;
// (2) softmax: the row max over the warps' maxes folds into the running
//     max (the TPU kernel's guards: m_safe = 0 while the max is -inf,
//     alpha = 0 while the previous max is -inf); every warp exponentiates
//     a share of the scores and sums its share;
// (3) p @ v: each thread owns two columns of every row over a fixed
//     group of the tile's positions and adds p * v in position order.
// The running sum adds the warps' shares in warp order, and at the end the
// position groups' partial outputs are added in group order. With one
// split the block writes acc / max(l, 1e-30) itself; with more, it writes
// its unnormalised float32 state (running max m, sum l, acc[rep][D]) to
// the wrapper's scratch, and the combine kernel, one block per (head,
// batch row), folds the splits in split order: M = max m_s, w_s =
// exp(m_s - M) (0 where m_s = -inf), o = sum w_s acc_s / max(sum w_s l_s,
// 1e-30). A split that starts at or past n reads nothing and writes
// m = -inf, l = 0, acc = 0. No atomics anywhere, so the result is the
// same run to run. Positions at or past n are never read, which is the
// TPU kernel's mask (p = 0 there); n = 0 gives zeros.
//
// The kernel templates and the launcher live here; each head dim's
// instantiations are compiled in a source of their own
// (decode_attention_d32.cu, decode_attention_d64.cu, decode_attention.cu
// for D 128, decode_attention_d256.cu), so the parallel nvcc runs overlap
// them.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace repro_da {


constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// bytes of K (and of V) in a tile: two blocks an SM, or one
constexpr int kSmallTile = 24576;
constexpr int kLargeTile = 49152;
constexpr int kStages = 2;          // tiles in the cp.async ring

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one 16-byte chunk of a row as floats
__device__ __forceinline__ void chunk_f32(const float* p, float* out) {
  const float4 c = *reinterpret_cast<const float4*>(p);
  out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
}
__device__ __forceinline__ void chunk_f32(const __nv_bfloat16* p, float* out) {
  const uint4 c = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// REP: the power of two >= rep that sizes the register arrays; TB: the
// tile's bytes.
template <typename T, int D, int REP, int TB>
struct Cfg {
  static constexpr int kMinBlocks = TB == kSmallTile ? 2 : 1;  // an SM
  static constexpr int kTile = TB / (D * int(sizeof(T)));  // positions
  static constexpr int kEPC = 16 / int(sizeof(T));        // elements a chunk
  static constexpr int kRowChunks = D / kEPC;             // chunks a row
  // lanes that score one position: 8, or a row's chunks where it has fewer
  // (4 at D 32 in bfloat16), so that every lane holds at least one chunk
  static constexpr int kGroup = kRowChunks < 8 ? kRowChunks : 8;
  static constexpr int kCPL = kRowChunks / kGroup;        // chunks a lane
  static constexpr int kGE = kCPL * kEPC;                 // elements a lane
  static constexpr int kUnroll = 32 / kGE > 0 ? (32 / kGE < 4 ? 32 / kGE : 4) : 1;
  static constexpr int kRowBlock = REP < (32 / kGE > 0 ? 32 / kGE : 1)
                                       ? REP : (32 / kGE > 0 ? 32 / kGE : 1);
  static constexpr int kStep = (32 / kGroup) * kUnroll;  // positions a warp step
  static constexpr int kWPR = REP < kWarps ? kWarps / REP : 1;  // warps a row
  static constexpr int kPairs = D / 2;                    // columns of p @ v
  static constexpr int kPG = kThreads / kPairs;           // position groups
  static constexpr int kChunk = kTile / kPG;              // a group's positions
  static constexpr size_t kSmem =
      2 * kStages * TB +
      4 * (REP * kTile + REP * D + kWarps * REP + REP * kWPR + 4 * REP);
};

// part: (B, H, splits, 2 + D) float32, each row m, l, acc[D]; nullptr
// when there is one split and the block writes out itself.
template <typename T, int D, int REP, int TB>
__global__ void __launch_bounds__(kThreads, (Cfg<T, D, REP, TB>::kMinBlocks))
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ part, int H, int G, int S, int n,
                        int chunk, float scale) {
  using C = Cfg<T, D, REP, TB>;
  constexpr int TS = C::kTile;
  constexpr int kGroup = C::kGroup;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kv_s = reinterpret_cast<T*>(smem);           // [kStages][K|V][TS][D]
  float* p_s = reinterpret_cast<float*>(smem + 2 * kStages * TB);
  float* q_s = p_s + REP * TS;                    // [REP][D], scaled
  float* wmax_s = q_s + REP * D;                  // [kWarps][REP] tile maxes
  float* wsum_s = wmax_s + kWarps * REP;          // [REP][kWPR] tile sums
  float* m_s = wsum_s + REP * C::kWPR;            // [2][REP] running max
  float* l_s = m_s + 2 * REP;                     // [REP] running sum
  float* a_s = l_s + REP;                         // [REP] this tile's rescale

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int rep = H / G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / kGroup, gl = lane % kGroup;
  // this split's positions [p_beg, p_beg + n_split) of the first n
  const int p_beg = min(n, split * chunk);
  const int n_split = min(chunk, n - p_beg);
  // row r's (m, l, acc[D]) in part
  auto part_row = [&](int r) {
    return part + ((static_cast<size_t>(b) * H + static_cast<size_t>(g) * rep + r) *
                       splits + split) * (2 + D);
  };
  if (part != nullptr && n_split == 0) {   // an empty split reads nothing
    for (int i = tid; i < rep * (2 + D); i += kThreads) {
      const int r = i / (2 + D), c = i % (2 + D);
      part_row(r)[c] = c == 0 ? -CUDART_INF_F : 0.f;
    }
    return;
  }
  const size_t pos_stride = static_cast<size_t>(G) * D;
  const T* kb = k + ((static_cast<size_t>(b) * S + p_beg) * G + g) * D;
  const T* vb = v + ((static_cast<size_t>(b) * S + p_beg) * G + g) * D;
  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(g) * rep) * D;

  for (int i = tid; i < rep * D; i += kThreads) q_s[i] = to_f32(qb[i]) * scale;
  for (int i = tid; i < REP * TS; i += kThreads) p_s[i] = 0.f;  // rows >= rep stay 0
  if (tid < REP) {
    m_s[tid] = -CUDART_INF_F;
    l_s[tid] = 0.f;
    a_s[tid] = 0.f;
  }

  const int ntiles = (n_split + TS - 1) / TS;
  auto load = [&](int t) {
    if (t < ntiles) {
      const int p0 = t * TS, cnt = min(TS, n_split - p0);
      char* dk = reinterpret_cast<char*>(kv_s + static_cast<size_t>(t % kStages) * 2 * TS * D);
      char* dv = dk + TS * D * sizeof(T);
      for (int i = tid; i < cnt * C::kRowChunks; i += kThreads) {
        const int r = i / C::kRowChunks, c = i % C::kRowChunks;
        const size_t src = (static_cast<size_t>(p0 + r) * pos_stride) * sizeof(T) + c * 16;
        const size_t dst = static_cast<size_t>(r) * D * sizeof(T) + c * 16;
        cp_async16(dk + dst, reinterpret_cast<const char*>(kb) + src);
        cp_async16(dv + dst, reinterpret_cast<const char*>(vb) + src);
      }
    }
    cp_async_commit();   // an empty group keeps the wait count uniform
  };
  for (int t = 0; t < kStages - 1; ++t) load(t);
  __syncthreads();

  const int c2 = (tid % C::kPairs) * 2, pg = tid / C::kPairs;
  float acc[REP][2];
#pragma unroll
  for (int j = 0; j < REP; ++j) acc[j][0] = acc[j][1] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    load(t + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* ks = kv_s + static_cast<size_t>(t % kStages) * 2 * TS * D;
    const T* vs = ks + TS * D;
    const int cnt = min(TS, n_split - t * TS);
    const float* m_prev_s = m_s + (t & 1) * REP;
    float* m_next_s = m_s + ((t + 1) & 1) * REP;

    // (1) scores. Lane gl of a group holds chunks gl, gl + kGroup, ... of a
    // row.
    for (int r0 = 0; r0 < rep; r0 += C::kRowBlock) {
      float qr[C::kRowBlock][C::kGE];
#pragma unroll
      for (int j = 0; j < C::kRowBlock; ++j)
#pragma unroll
        for (int e = 0; e < C::kGE; ++e) {
          const int col = (gl + kGroup * (e / C::kEPC)) * C::kEPC + e % C::kEPC;
          qr[j][e] = r0 + j < rep ? q_s[(r0 + j) * D + col] : 0.f;
        }
      float mrun[C::kRowBlock];
#pragma unroll
      for (int j = 0; j < C::kRowBlock; ++j) mrun[j] = -CUDART_INF_F;
      for (int s0 = warp * C::kStep; s0 < cnt; s0 += kWarps * C::kStep) {
        float kf[C::kUnroll][C::kGE];
#pragma unroll
        for (int u = 0; u < C::kUnroll; ++u) {
          const int s = s0 + u * (32 / kGroup) + grp;
#pragma unroll
          for (int cc = 0; cc < C::kCPL; ++cc) {
            if (s < cnt)
              chunk_f32(ks + s * D + (gl + kGroup * cc) * C::kEPC, &kf[u][cc * C::kEPC]);
            else
#pragma unroll
              for (int i = 0; i < C::kEPC; ++i) kf[u][cc * C::kEPC + i] = 0.f;
          }
        }
        float part[C::kRowBlock][C::kUnroll];
#pragma unroll
        for (int j = 0; j < C::kRowBlock; ++j)
#pragma unroll
          for (int u = 0; u < C::kUnroll; ++u) {
            part[j][u] = 0.f;
#pragma unroll
            for (int e = 0; e < C::kGE; ++e)
              part[j][u] = fmaf(qr[j][e], kf[u][e], part[j][u]);
          }
#pragma unroll
        for (int o = kGroup / 2; o > 0; o >>= 1)
#pragma unroll
          for (int j = 0; j < C::kRowBlock; ++j)
#pragma unroll
            for (int u = 0; u < C::kUnroll; ++u)
              part[j][u] += __shfl_xor_sync(0xffffffffu, part[j][u], o);
#pragma unroll
        for (int u = 0; u < C::kUnroll; ++u) {
          const int s = s0 + u * (32 / kGroup) + grp;
          if (s < cnt) {
#pragma unroll
            for (int j = 0; j < C::kRowBlock; ++j) {
              mrun[j] = fmaxf(mrun[j], part[j][u]);
              if (gl == j % kGroup && r0 + j < rep) p_s[(r0 + j) * TS + s] = part[j][u];
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < C::kRowBlock; ++j) {
        float m = mrun[j];
#pragma unroll
        for (int o = 16; o >= kGroup; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        if (lane == 0 && r0 + j < rep) wmax_s[warp * REP + r0 + j] = m;
      }
    }
    __syncthreads();

    // (2) softmax: kWPR warps per row, each a share of its positions
    for (int r = warp / C::kWPR; r < rep; r += kWarps / C::kWPR) {
      const int sub = warp % C::kWPR;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wmax_s[w * REP + r]);
      const float m_prev = m_prev_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      float* pr = p_s + r * TS;
      float sum = 0.f;
      for (int s = sub * 32 + lane; s < cnt; s += C::kWPR * 32) {
        const float p = expf(pr[s] - m_safe);
        pr[s] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        wsum_s[r * C::kWPR + sub] = sum;
        if (sub == 0) {
          m_next_s[r] = m_new;
          a_s[r] = isinf(m_prev) ? 0.f : expf(m_prev - m_safe);
        }
      }
    }
    __syncthreads();

    // (3) p @ v: thread (pg, c2) owns columns c2, c2 + 1 of every row over
    // its group's kChunk positions of the tile
    float alpha[REP];
#pragma unroll
    for (int j = 0; j < REP; ++j) {
      alpha[j] = a_s[j];
      acc[j][0] *= alpha[j];
      acc[j][1] *= alpha[j];
    }
    if (tid < rep) {
      float sum = 0.f;
      for (int h = 0; h < C::kWPR; ++h) sum += wsum_s[tid * C::kWPR + h];
      l_s[tid] = l_s[tid] * a_s[tid] + sum;
    }
    const int s_beg = pg * C::kChunk;
    const int s_end = min(cnt, s_beg + C::kChunk);
    int s = s_beg;
    for (; s + 4 <= s_end; s += 4) {
      float2 vf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) vf[i] = load2(vs + (s + i) * D + c2);
#pragma unroll
      for (int j = 0; j < REP; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(p_s + j * TS + s);
        const float pp[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[j][0] = fmaf(pp[i], vf[i].x, acc[j][0]);
          acc[j][1] = fmaf(pp[i], vf[i].y, acc[j][1]);
        }
      }
    }
    for (; s < s_end; ++s) {
      const float2 vf = load2(vs + s * D + c2);
#pragma unroll
      for (int j = 0; j < REP; ++j) {
        const float p = p_s[j * TS + s];
        acc[j][0] = fmaf(p, vf.x, acc[j][0]);
        acc[j][1] = fmaf(p, vf.y, acc[j][1]);
      }
    }
    __syncthreads();   // the next tile's load reuses this stage and p_s
  }
  cp_async_wait<0>();
  __syncthreads();

  // the position groups' partial sums, added in group order (fixed)
  float* red = reinterpret_cast<float*>(smem);    // [kPG][REP][D]
#pragma unroll
  for (int j = 0; j < REP; ++j) {
    red[(pg * REP + j) * D + c2] = acc[j][0];
    red[(pg * REP + j) * D + c2 + 1] = acc[j][1];
  }
  __syncthreads();
  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float sum = 0.f;
#pragma unroll
    for (int h = 0; h < C::kPG; ++h) sum += red[(h * REP + r) * D + c];
    if (part == nullptr)
      out[(static_cast<size_t>(b) * H + static_cast<size_t>(g) * rep + r) * D + c] =
          from_f32<T>(sum / fmaxf(l_s[r], 1e-30f));
    else
      part_row(r)[2 + c] = sum;
  }
  if (part != nullptr && tid < rep) {
    part_row(tid)[0] = m_s[(ntiles & 1) * REP + tid];   // the last tile's m_next
    part_row(tid)[1] = l_s[tid];
  }
}

// One block of D threads per (head, batch row): the splits' states folded
// in split order, thread c owning column c.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_attention_combine(const float* __restrict__ part, T* __restrict__ out,
                         int H, int splits) {
  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const float* row = part + (static_cast<size_t>(b) * H + h) * splits * (2 + D);
  float m = -CUDART_INF_F;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, row[s * (2 + D)]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* st = row + s * (2 + D);
    const float w = isinf(st[0]) ? 0.f : expf(st[0] - m);
    num += w * st[2 + c];
    den += w * st[1];
  }
  out[(static_cast<size_t>(b) * H + h) * D + c] = from_f32<T>(num / fmaxf(den, 1e-30f));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* part;   // (B, H, splits, 2 + D) scratch when splits > 1
  int B, H, G, S, n, splits, chunk, tile_bytes;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int REP, int TB>
cudaError_t launch(const Args& a) {
  auto kern = decode_attention_kernel<T, D, REP, TB>;
  constexpr size_t smem = Cfg<T, D, REP, TB>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  float* part = a.splits > 1 ? a.part : nullptr;
  kern<<<dim3(a.splits, a.G, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), part, a.H, a.G,
      a.S, a.n, a.chunk, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || part == nullptr) return e;
  decode_attention_combine<T, D><<<dim3(a.H, a.B), D, 0, a.stream>>>(
      part, static_cast<T*>(a.out), a.H, a.splits);
  return cudaGetLastError();
}

template <typename T, int D, int TB>
cudaError_t by_rep(const Args& a) {
  const int rep = a.H / a.G;
  if (rep <= 1) return launch<T, D, 1, TB>(a);
  if (rep <= 2) return launch<T, D, 2, TB>(a);
  if (rep <= 4) return launch<T, D, 4, TB>(a);
  if (rep <= 8) return launch<T, D, 8, TB>(a);
  if (rep <= 16) return launch<T, D, 16, TB>(a);
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t by_tile(const Args& a) {
  if (a.tile_bytes == kSmallTile) return by_rep<T, D, kSmallTile>(a);
  if (a.tile_bytes == kLargeTile) return by_rep<T, D, kLargeTile>(a);
  return cudaErrorInvalidValue;
}

// one head dim's launcher for both dtypes, each defined in its own source
cudaError_t launch_d32(bool bf16, const Args& a);
cudaError_t launch_d64(bool bf16, const Args& a);
cudaError_t launch_d128(bool bf16, const Args& a);
cudaError_t launch_d256(bool bf16, const Args& a);

}  // namespace repro_da
