// swa_decode_attention: single-token GQA decode attention over a KV cache,
//
//   out[b, h*G + g] = sum_{s < cache_len} softmax_s(q[b, h*G + g] . k[b, s, h]
//                                                  / sqrt(D)) * v[b, s, h]
//
// for q (B, Hq, D), caches (B, S, Hkv, D) read in place (row-major,
// contiguous), G = Hq / Hkv query heads per KV head.  It replaces the
// Pallas TPU kernel swa_decode_attention (src/repro/kernels/
// swa_decode_attention.py:55, body _kernel at :24), which runs one grid
// cell per (b, kv-head), streams the whole (S, D) cache of that head
// through VMEM in 512-row chunks with the safe-softmax (m, l, acc)
// recursion, and needs the cache transposed to (B, Hkv, S, D) first.
//
// What bounds it on the card: bytes.  It must read the valid rows of both
// caches once, 2 * B * cache_len * Hkv * D * sizeof(T) bytes (67.1 MB at
// B = 8, cache_len 4096, Hkv 4, D 128 in bf16: 20 us at 3.35 TB/s), and
// does 4 * B * Hq * cache_len * D operations (0.81 GFLOP there: 12 us at
// 67 TFLOP/s on the f32 CUDA cores), so operations come within a factor
// of two of the bytes.
//
// Design.  At B = 8 there are only B * Hkv = 32 (b, kv-head) cells for
// 132 SMs, so the valid rows [0, cache_len) of each cell are split into
// n_split contiguous ranges (flash-decoding; the wrapper picks n_split so
// that a few hundred blocks are in flight), one block of 4 warps each.
// Rows at or past cache_len are never read: the TPU kernel masks them to
// -1e30, and exp(-1e30 - m) is 0 in f32 once one row is valid, so
// skipping them gives the same function.  A block stages its G x D
// queries in shared memory as f32 and walks its range in tiles of 32
// rows:
//   1. all threads copy the tile's K and V rows (D * sizeof(T) bytes each,
//      contiguous in the cache) into shared memory with 16-byte loads,
//      neighbouring threads on neighbouring addresses; K rows are padded
//      by 16 bytes so that step 2 reads them without bank conflicts.  The
//      next tile's loads are issued into registers before steps 2-3 of
//      this one, so their latency overlaps the arithmetic;
//   2. lane t of warp w scores row t against heads g = w, w + 4, ...
//      (f32 FMAs, q broadcast from shared memory), then the warp takes the
//      tile's max and sum of each head by shuffles and updates that
//      head's running (m, l); p = exp(s - m) (stored p[g][t]) and the
//      rescale exp(m_old - m_new) go to shared memory;
//   3. thread (d, g0) rescales and accumulates acc[g][d] += p[t][g] *
//      v[t][d] over the tile, in f32 registers, for heads g = g0 + j *
//      (128 / D).
// G is padded to a power of two at compile time (zero queries for the
// padding), so steps 2 and 3 carry no per-head branch, which would keep
// the heads' FMA chains from interleaving.
// Each block writes its unnormalised (m, l, acc) to a scratch buffer; a
// second, small launch (one block per (b, head), one thread per d) merges
// the splits, divides by l (clamped at 1e-30, as the TPU kernel does) and
// casts to q's dtype.  Both launches are one call of the wrapper.
// In this form steps 2 and 3 (f32 FMAs fed from shared memory), not the
// bytes, set the time at a full cache (PERF.md).  Tensor cores (G padded
// to 16 for mma / wgmma), TMA and a deeper pipeline across tiles are
// later work.

#include "common.cuh"

namespace {

using plane::from_f32;
using plane::to_f32;
using plane::Vec;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // rows per tile: one per lane in step 2
constexpr int kGMax = 16;   // query heads per KV head (llama3-405b's G)
constexpr float kNegInf = -1e30f;
constexpr int kMaxSplits = 12288;   // the combine's weights: 48 KB

template <typename T, int D, int GP>
struct Tiles {
  static constexpr int kVec = 16 / sizeof(T);   // elements per 16 bytes
  static constexpr int kChunks = D / kVec;      // 16-byte chunks per row
  float q[GP][D];
  T k[kTile][D + kVec];                         // + 16 bytes: no conflicts
  T v[kTile][D];
  alignas(16) float p[GP][kTile];               // p[g][t]
  float corr[GP];
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// GP: G padded to a power of two.  Heads G..GP-1 have zero queries; their
// scores, (m, l) and acc are computed and never written, so the inner
// loops carry no per-head branch and their FMA chains interleave.
template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads)
    swa_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ part_acc,
                     float* __restrict__ part_m, float* __restrict__ part_l,
                     int S, int Hkv, int G, int cache_len,
                     int rows_per_split, float scale) {
  using Tl = Tiles<T, D, GP>;
  constexpr int kHeadsPerWarp = (GP + kWarps - 1) / kWarps;
  constexpr int kGStep = kThreads / D;          // threads sharing a column
  constexpr int kAcc = (GP + kGStep - 1) / kGStep;
  constexpr int kPer = kTile * Tl::kChunks / kThreads;   // chunks a thread
  static_assert(kPer * kThreads == kTile * Tl::kChunks, "tile split");
  __shared__ __align__(16) Tl sm;

  const int cell = blockIdx.x;                  // b * Hkv + h
  const int split = blockIdx.y;
  const int b = cell / Hkv, h = cell % Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = split * rows_per_split;
  const int r1 = min(r0 + rows_per_split, cache_len);
  // warps (step 2) and threads (step 3) past the padded heads idle; both
  // conditions are uniform across a warp
  const bool scores = warp < GP;
  const int d = tid % D, g0 = tid / D;
  const bool accumulates = g0 < GP;

  const T* qc = q + (size_t)cell * G * D;       // heads h*G .. h*G + G - 1
  for (int i = tid; i < GP * D; i += kThreads)
    sm.q[i / D][i % D] = i < G * D ? to_f32(qc[i]) : 0.0f;

  float m[kHeadsPerWarp], l[kHeadsPerWarp], acc[kAcc];
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    m[j] = kNegInf;
    l[j] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;

  // 1. each thread copies kPer 16-byte chunks of K and of V per tile; the
  // next tile's chunks are loaded into registers while this one computes
  Vec<T> kreg[kPer], vreg[kPer];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kThreads;
      const int t = c / Tl::kChunks, e = (c % Tl::kChunks) * Tl::kVec;
      if (t0 + t < r1) {
        const size_t off = ((size_t)(b * S + t0 + t) * Hkv + h) * D + e;
        kreg[i] = *reinterpret_cast<const Vec<T>*>(k + off);
        vreg[i] = *reinterpret_cast<const Vec<T>*>(v + off);
      } else {   // past the split: zeros, so p = 0 meets v = 0
#pragma unroll
        for (int u = 0; u < Tl::kVec; ++u) {
          kreg[i].v[u] = from_f32<T>(0.0f);
          vreg[i].v[u] = from_f32<T>(0.0f);
        }
      }
    }
  };
  fetch(r0);
  for (int t0 = r0; t0 < r1; t0 += kTile) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kThreads;
      const int t = c / Tl::kChunks, e = (c % Tl::kChunks) * Tl::kVec;
      *reinterpret_cast<Vec<T>*>(&sm.k[t][e]) = kreg[i];
      *reinterpret_cast<Vec<T>*>(&sm.v[t][e]) = vreg[i];
    }
    __syncthreads();
    if (t0 + kTile < r1) fetch(t0 + kTile);

    // 2. scores of row `lane` for this warp's heads; running (m, l)
    if (scores) {
      float sc[kHeadsPerWarp];
#pragma unroll
      for (int j = 0; j < kHeadsPerWarp; ++j) sc[j] = 0.0f;
#pragma unroll 4
      for (int e = 0; e < D; e += Tl::kVec) {
        const Vec<T> kv = *reinterpret_cast<const Vec<T>*>(&sm.k[lane][e]);
        float kf[Tl::kVec];
#pragma unroll
        for (int i = 0; i < Tl::kVec; ++i) kf[i] = to_f32(kv.v[i]);
#pragma unroll
        for (int j = 0; j < kHeadsPerWarp; ++j) {
          const float4* qv =
              reinterpret_cast<const float4*>(&sm.q[warp + j * kWarps][e]);
#pragma unroll
          for (int i = 0; i < Tl::kVec / 4; ++i) {
            const float4 q4 = qv[i];   // the same address in every lane
            sc[j] = fmaf(q4.x, kf[4 * i], sc[j]);
            sc[j] = fmaf(q4.y, kf[4 * i + 1], sc[j]);
            sc[j] = fmaf(q4.z, kf[4 * i + 2], sc[j]);
            sc[j] = fmaf(q4.w, kf[4 * i + 3], sc[j]);
          }
        }
      }
      const bool valid = t0 + lane < r1;
#pragma unroll
      for (int j = 0; j < kHeadsPerWarp; ++j) {
        const int g = warp + j * kWarps;
        const float s = valid ? sc[j] * scale : kNegInf;
        const float m_new = fmaxf(m[j], warp_max(s));
        const float p = expf(s - m_new);
        const float corr = expf(m[j] - m_new);
        l[j] = l[j] * corr + warp_sum(p);
        m[j] = m_new;
        sm.p[g][lane] = p;
        if (lane == 0) sm.corr[g] = corr;
      }
    }
    __syncthreads();

    // 3. acc[g][d] = acc[g][d] * corr[g] + sum_t p[t][g] * v[t][d]
    if (accumulates) {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) acc[j] *= sm.corr[g0 + j * kGStep];
#pragma unroll 2
      for (int t = 0; t < kTile; t += 4) {
        float vf[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vf[u] = to_f32(sm.v[t + u][d]);
#pragma unroll
        for (int j = 0; j < kAcc; ++j) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(&sm.p[g0 + j * kGStep][t]);
          acc[j] = fmaf(p4.x, vf[0], acc[j]);
          acc[j] = fmaf(p4.y, vf[1], acc[j]);
          acc[j] = fmaf(p4.z, vf[2], acc[j]);
          acc[j] = fmaf(p4.w, vf[3], acc[j]);
        }
      }
    }
    __syncthreads();
  }

  const size_t base = ((size_t)cell * gridDim.y + split) * G;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int g = g0 + j * kGStep;
    if (accumulates && g < G) part_acc[(base + g) * D + d] = acc[j];
  }
  if (scores && lane == 0) {
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int g = warp + j * kWarps;
      if (g < G) {
        part_m[base + g] = m[j];
        part_l[base + g] = l[j];
      }
    }
  }
}

// Max and sum over a block of D threads (D / 32 warps); `red` holds one
// float per warp.
template <int NW>
__device__ __forceinline__ float block_max(float x, float* red) {
  x = warp_max(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

template <int NW>
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) r += red[i];
  __syncthreads();
  return r;
}

// One block per (b, head), one thread per d: merge the splits' partial
// (m, l, acc) and normalise.  The splits' weights exp(m_i - M) are
// computed once, into shared memory; the acc loads are issued eight
// splits at a time, so their latency overlaps.
template <typename T, int D>
__global__ void __launch_bounds__(D)
    swa_combine_kernel(const float* __restrict__ part_acc,
                       const float* __restrict__ part_m,
                       const float* __restrict__ part_l, T* __restrict__ out,
                       int G, int n_split) {
  extern __shared__ float w[];                  // (n_split,) weights
  __shared__ float red[D / 32];
  const int cg = blockIdx.x;                    // cell * G + g
  const int g = cg % G, cell = cg / G;
  const int tid = threadIdx.x;
  const size_t first = (size_t)cell * n_split * G + g;
  float M = kNegInf;
  for (int sp = tid; sp < n_split; sp += D)
    M = fmaxf(M, part_m[first + (size_t)sp * G]);
  M = block_max<D / 32>(M, red);
  float L = 0.0f;
  for (int sp = tid; sp < n_split; sp += D) {
    const size_t i = first + (size_t)sp * G;
    w[sp] = expf(part_m[i] - M);
    L = fmaf(part_l[i], w[sp], L);
  }
  L = block_sum<D / 32>(L, red);                // also publishes w
  const float* acc = part_acc + first * D + tid;
  const size_t step = (size_t)G * D;            // one split further
  float A = 0.0f;
  int sp = 0;
  for (; sp + 8 <= n_split; sp += 8) {
    float a[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] = acc[(sp + u) * step];
#pragma unroll
    for (int u = 0; u < 8; ++u) A = fmaf(a[u], w[sp + u], A);
  }
  for (; sp < n_split; ++sp) A = fmaf(acc[sp * step], w[sp], A);
  out[(size_t)cg * D + tid] = from_f32<T>(A / fmaxf(L, 1e-30f));
}

template <typename T, int D, int GP>
cudaError_t split(const void* q, const void* k, const void* v,
                  float* part_acc, float* part_m, float* part_l, int cells,
                  int S, int Hkv, int G, int cache_len, int rows_per_split,
                  int n_split, float scale, cudaStream_t stream) {
  swa_split_kernel<T, D, GP><<<dim3(cells, n_split), kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, part_acc, part_m, part_l, S,
      Hkv, G, cache_len, rows_per_split, scale);
  return cudaGetLastError();
}

template <typename T, int D>
int run(const void* q, const void* k, const void* v, void* out,
        float* scratch, int B, int S, int Hkv, int G, int cache_len,
        int rows_per_split, int n_split, float scale, cudaStream_t stream) {
  const int cells = B * Hkv;
  float* part_acc = scratch;
  float* part_m = part_acc + (size_t)cells * n_split * G * D;
  float* part_l = part_m + (size_t)cells * n_split * G;
  using Split = cudaError_t (*)(const void*, const void*, const void*,
                                float*, float*, float*, int, int, int, int,
                                int, int, int, float, cudaStream_t);
  const Split fn = G <= 1   ? split<T, D, 1>     // G padded to a power of 2
                   : G <= 2 ? split<T, D, 2>
                   : G <= 4 ? split<T, D, 4>
                   : G <= 8 ? split<T, D, 8>
                            : split<T, D, 16>;
  const cudaError_t e = fn(q, k, v, part_acc, part_m, part_l, cells, S, Hkv,
                           G, cache_len, rows_per_split, n_split, scale,
                           stream);
  if (e != cudaSuccess) return (int)e;
  swa_combine_kernel<T, D>
      <<<cells * G, D, n_split * sizeof(float), stream>>>(
          part_acc, part_m, part_l, (T*)out, G, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           void* scratch, int B, int S, int Hkv, int G, int D,
           int cache_len, int rows_per_split, int n_split, float scale,
           void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > kGMax || cache_len < 1 ||
      cache_len > S || rows_per_split < 1 || n_split < 1 ||
      n_split > kMaxSplits ||
      (long long)rows_per_split * (n_split - 1) >= cache_len)
    return (int)cudaErrorInvalidValue;
  float* f = (float*)scratch;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return run<T, 32>(q, k, v, out, f, B, S, Hkv, G, cache_len,
                        rows_per_split, n_split, scale, s);
    case 64:
      return run<T, 64>(q, k, v, out, f, B, S, Hkv, G, cache_len,
                        rows_per_split, n_split, scale, s);
    case 128:
      return run<T, 128>(q, k, v, out, f, B, S, Hkv, G, cache_len,
                         rows_per_split, n_split, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Hkv * G, D), k and v (B, S, Hkv, D), out (B, Hkv * G, D): one
// dtype, contiguous, 16-byte aligned.  scratch: B * Hkv * n_split * G *
// (D + 2) floats.  Split i covers rows [i * rows_per_split,
// min((i + 1) * rows_per_split, cache_len)); every split must hold a row.
// scale = 1/sqrt(D) in f32.  Returns the CUDA error code of the launches
// (0 = launched).
int swa_decode_attention_f32(const void* q, const void* k, const void* v,
                             void* out, void* scratch, int B, int S, int Hkv,
                             int G, int D, int cache_len, int rows_per_split,
                             int n_split, float scale, void* stream) {
  return launch<float>(q, k, v, out, scratch, B, S, Hkv, G, D, cache_len,
                       rows_per_split, n_split, scale, stream);
}

int swa_decode_attention_bf16(const void* q, const void* k, const void* v,
                              void* out, void* scratch, int B, int S,
                              int Hkv, int G, int D, int cache_len,
                              int rows_per_split, int n_split, float scale,
                              void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, scratch, B, S, Hkv, G, D,
                               cache_len, rows_per_split, n_split, scale,
                               stream);
}

const char* swa_decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
