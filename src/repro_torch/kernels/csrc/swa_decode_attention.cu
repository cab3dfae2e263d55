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
// B = 8, cache_len 4096, Hkv 4, D 128 in bf16: 20 us at 3.35 TB/s); its
// 4 * B * Hq * cache_len * D operations (0.81 GFLOP there) take 0.8 us at
// the dense bf16 tensor rate.
//
// Design.  At B = 8 there are only B * Hkv = 32 (b, kv-head) cells for
// 132 SMs, so the valid rows [0, cache_len) of each cell are split into
// n_split contiguous ranges (flash-decoding; the wrapper sizes them so
// that the blocks fill one wave), one block of 4 warps each.  Rows at or
// past cache_len are never read: the TPU kernel masks them to -1e30, and
// exp(-1e30 - m) is 0 in f32 once one row is valid, so skipping them
// gives the same function.
//
// bfloat16 (the serving dtype), swa_mma_kernel: the split's rows stream
// through a 2-stage ring of 64-row K and V tiles in shared memory, filled
// by 16-byte cp.async copies (rows padded by 16 bytes, so that ldmatrix
// reads them without bank conflicts) while the block computes on the
// other tile; both tiles are in flight from the start, and three blocks
// share an SM.  Warp w owns rows 16w .. 16w + 15
// of every tile and keeps its own (m, l, acc[16 x D]) in registers:
//   - scores S = Q K^T with mma.sync.m16n8k16 (bf16 in, f32 accumulate),
//     the G query heads padded to 16 rows of zeros, Q read from shared
//     memory by ldmatrix.  bf16 x bf16 products are exact in f32, so only
//     the summation order differs from the plain version;
//   - the online softmax per head on the score fragments (a quad of lanes
//     holds a head's row);
//   - P V with mma, P split into three bf16 terms (p = hi + mid + lo, the
//     rest below 2^-24 p), each multiplied by the V fragments (ldmatrix
//     .trans) into the same f32 accumulator: P keeps f32 precision, as in
//     the TPU kernel, which multiplies f32 p by f32 v.  One bf16 cast of P
//     errs by up to 2^-9 p, two terms by 2^-18 p; both fall outside the
//     tolerance the plain version is held to (tests/test_torch_swa_decode
//     .py emulates all three).
// The four warps merge their (m, l, acc) through shared memory at the end
// of the split.  float32 (off the serving path), swa_fma_kernel: f32 FMAs
// fed from shared memory in 32-row tiles (a TF32 mma would break its
// 8-ulp tolerance); G is padded to a power of two at compile time, so its
// inner loops carry no per-head branch.
//
// One launch.  Every split block writes its unnormalised (m, l, acc) to a
// scratch buffer and takes a ticket (__threadfence, then an atomic
// add) for its group of up to 8 splits; the last block of a group stages the
// group's partials into shared memory with cp.async, in one round trip, and
// merges them.  With one group that is the output; else the merged group
// partial goes back to the scratch buffer, a ticket per cell counts the groups,
// and the last group's block merges the group partials the same way.  A block
// that merges resets the ticket it took for the next call on the stream.

#include "common.cuh"

namespace {

using plane::from_f32;
using plane::to_f32;
using plane::Vec;

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // rows per tile of the f32 kernel: one a lane
constexpr int kTileM = 64;  // rows per tile of the mma kernel: 16 a warp
constexpr int kStages = 2;  // tiles in the mma kernel's ring
constexpr int kGMax = 16;   // query heads per KV head (llama3-405b's G)
constexpr float kNegInf = -1e30f;
constexpr int kGroup = 8;   // partials merged at once
constexpr int kMaxSplits = kGroup * kGroup;   // two levels of groups
constexpr int kTicketStride = 1 + kGroup;     // a cell's and its groups'

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously, through L2 only;
// zeros instead when !full (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// out[0..3] = A / L (L clamped at 1e-30, as the TPU kernel does), cast
__device__ __forceinline__ void store_out(float* o, float4 A, float L) {
  L = fmaxf(L, 1e-30f);
  *reinterpret_cast<float4*>(o) =
      make_float4(A.x / L, A.y / L, A.z / L, A.w / L);
}

__device__ __forceinline__ void store_out(bf16* o, float4 A, float L) {
  L = fmaxf(L, 1e-30f);
  __nv_bfloat162 lo = __floats2bfloat162_rn(A.x / L, A.y / L);
  __nv_bfloat162 hi = __floats2bfloat162_rn(A.z / L, A.w / L);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(o) = u;
}

// ---- the splits' merge --------------------------------------------------

// A partial result: m[G], l[G] and acc[G][D]; in a block's shared memory
// (`bp`) with G = kGMax rows, in the scratch buffer with the cell's G.
template <int D>
constexpr int kPartFloats = 2 * kGMax + kGMax * D;
// shared memory a merge stages a group's partials in
template <int D>
constexpr size_t kStageBytes = (size_t)kGroup * kPartFloats<D> * 4;

// Merge the K <= kGroup partials at slots s0 .. s0 + K - 1 of a cell
// (acc at `acc`, m and l at `pm`, `pl`, slot-major): stage them in `stage`
// with cp.async, then per output M = max_i m_i, L = sum_i l_i w_i and
// acc = sum_i acc_i w_i with w_i = exp(m_i - M).  Writes out = acc / L
// when `out` is given, else the merged partial to slot `dst`.
template <typename T, int D>
__device__ __forceinline__ void merge_group(
    const float* acc, const float* pm, const float* pl, int s0, int K,
    int G, float* stage, T* out, float* dacc, float* dm, float* dl) {
  __shared__ float head_m[kGMax], head_l[kGMax], w[kGroup][kGMax];
  const int tid = threadIdx.x;
  const int n4 = G * D / 4;                      // float4s of a partial
  const float4* src = reinterpret_cast<const float4*>(acc) + (size_t)s0 * n4;
  for (int i = tid; i < K * n4; i += kThreads)
    cp_async16(stage + 4 * i, src + i, true);
  cp_async_commit();
  float* sm_m = stage + K * G * D;
  float* sm_l = sm_m + K * G;
  for (int i = tid; i < K * G; i += kThreads) {
    sm_m[i] = __ldcg(pm + (size_t)s0 * G + i);
    sm_l[i] = __ldcg(pl + (size_t)s0 * G + i);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid < G) {
    float M = kNegInf, L = 0.0f;
    for (int i = 0; i < K; ++i) M = fmaxf(M, sm_m[i * G + tid]);
    for (int i = 0; i < K; ++i) {
      w[i][tid] = expf(sm_m[i * G + tid] - M);
      L = fmaf(sm_l[i * G + tid], w[i][tid], L);
    }
    head_m[tid] = M;
    head_l[tid] = L;
  }
  __syncthreads();
  for (int e4 = tid; e4 < n4; e4 += kThreads) {
    const int g = e4 * 4 / D;
    float4 A = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = 0; i < K; ++i) {
      const float4 a = reinterpret_cast<const float4*>(stage)[i * n4 + e4];
      const float wi = w[i][g];
      A.x = fmaf(a.x, wi, A.x);
      A.y = fmaf(a.y, wi, A.y);
      A.z = fmaf(a.z, wi, A.z);
      A.w = fmaf(a.w, wi, A.w);
    }
    if (out != nullptr)
      store_out(out + e4 * 4, A, head_l[g]);
    else
      reinterpret_cast<float4*>(dacc)[e4] = A;
  }
  if (out == nullptr && tid < G) {
    dm[tid] = head_m[tid];
    dl[tid] = head_l[tid];
  }
}

// Take ticket `t` of `count`: true for the block that takes the last one,
// which also resets it.  Every thread's writes before it are visible to
// that block after it.
__device__ __forceinline__ bool last_ticket(unsigned* t, int count) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(t, 1u) == (unsigned)count - 1;
    if (last) *t = 0;   // every block has taken its ticket
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Called by every thread of a split block once its partial (m, l, acc)
// sits in `bp`; `stage` is the block's shared memory, free from here on
// (bp may lie in it).  The splits merge through the scratch buffer and
// tickets: slots 0 .. n_split - 1 of the cell's scratch hold the splits' partials,
// n_split .. n_split + groups - 1 the groups'.
template <typename T, int D>
__device__ __forceinline__ void finish_cell(
    const float* bp, float* stage, float* __restrict__ part_acc,
    float* __restrict__ part_m, float* __restrict__ part_l,
    unsigned* __restrict__ tickets, T* __restrict__ out, int cell, int G) {
  const int tid = threadIdx.x;
  const int n_split = gridDim.y, split = blockIdx.y;
  const int groups = (n_split + kGroup - 1) / kGroup;
  const int slots = n_split + (groups > 1 ? groups : 0);
  const int n4 = G * D / 4;
  float* acc = part_acc + (size_t)cell * slots * G * D;
  float* pm = part_m + (size_t)cell * slots * G;
  float* pl = part_l + (size_t)cell * slots * G;
  T* o = out + (size_t)cell * G * D;
  unsigned* tk = tickets + (size_t)cell * kTicketStride;
  __syncthreads();            // the partial is complete in `bp`
  for (int e4 = tid; e4 < n4; e4 += kThreads)
    reinterpret_cast<float4*>(acc)[(size_t)split * n4 + e4] =
        reinterpret_cast<const float4*>(bp + 2 * kGMax)[e4];
  if (tid < G) {
    pm[(size_t)split * G + tid] = bp[tid];
    pl[(size_t)split * G + tid] = bp[kGMax + tid];
  }
  const int grp = split / kGroup, s0 = grp * kGroup;
  const int K = min(kGroup, n_split - s0);
  if (!last_ticket(tk + 1 + grp, K)) return;
  if (groups == 1) {
    merge_group<T, D>(acc, pm, pl, 0, K, G, stage, o, nullptr, nullptr,
                      nullptr);
    return;
  }
  const size_t dst = (size_t)n_split + grp;
  merge_group<T, D>(acc, pm, pl, s0, K, G, stage, (T*)nullptr,
                    acc + dst * G * D, pm + dst * G, pl + dst * G);
  if (!last_ticket(tk, groups)) return;
  __syncthreads();            // the stage is free again
  merge_group<T, D>(acc, pm, pl, n_split, groups, G, stage, o, nullptr,
                    nullptr, nullptr);
}

// ---- float32: f32 FMAs on the CUDA cores -------------------------------

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

// GP: G padded to a power of two.  Heads G..GP-1 have zero queries; their
// scores, (m, l) and acc are computed and never written, so the inner
// loops carry no per-head branch and their FMA chains interleave.
template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads)
    swa_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, float* __restrict__ part_acc,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   unsigned* __restrict__ tickets, T* __restrict__ out,
                   int S, int Hkv, int G, int cache_len,
                   int rows_per_split, float scale) {
  using Tl = Tiles<T, D, GP>;
  constexpr int kHeadsPerWarp = (GP + kWarps - 1) / kWarps;
  constexpr int kGStep = kThreads / D;          // threads sharing a column
  constexpr int kAcc = (GP + kGStep - 1) / kGStep;
  constexpr int kPer = kTile * Tl::kChunks / kThreads;   // chunks a thread
  static_assert(kPer * kThreads == kTile * Tl::kChunks, "tile split");
  extern __shared__ __align__(16) unsigned char smem[];
  Tl& sm = *reinterpret_cast<Tl*>(smem);

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

  // the block's partial, into the K tile's storage (free after the loop)
  float* bp = reinterpret_cast<float*>(&sm.k[0][0]);
  static_assert(sizeof(sm.k) >= kPartFloats<D> * sizeof(float),
                "the partial fits the K tile");
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int g = g0 + j * kGStep;
    if (accumulates && g < G) bp[2 * kGMax + g * D + d] = acc[j];
  }
  if (scores && lane == 0) {
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int g = warp + j * kWarps;
      if (g < G) {
        bp[g] = m[j];
        bp[kGMax + g] = l[j];
      }
    }
  }
  finish_cell<T, D>(bp, reinterpret_cast<float*>(smem), part_acc, part_m,
                    part_l, tickets, out, cell, G);
}

// ---- bfloat16: mma.sync on the tensor cores ----------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// x and y as three bf16 pairs hi + mid + lo (each the rest of the last
// rounded to nearest): the sum holds x and y to within 2^-24 relative
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(x, y);
  const float2 h =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&hi));
  const float rx = x - h.x, ry = y - h.y;
  mid = pack_bf16(rx, ry);
  const float2 m =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&mid));
  lo = pack_bf16(rx - m.x, ry - m.y);
}

template <int D>
struct Ring {
  static constexpr int kRow = D + 8;                // + 16 bytes a row
  static constexpr int kStage = 2 * kTileM * kRow;  // K tile, then V tile
  static constexpr int kQ = kGMax * kRow;           // Q, 16 padded rows
  static constexpr size_t kRingBytes = (size_t)(kStages * kStage + kQ) * 2;
  // the warps' merge at the end reuses the ring: m, l, acc per warp, then
  // the block's partial; then the splits' merge stages partials in it
  static constexpr int kAccRow = D + 8;
  static constexpr size_t kMergeBytes =
      ((size_t)kWarps * kGMax * (2 + kAccRow) + kPartFloats<D>) *
      sizeof(float);
  static constexpr size_t kBytes = kRingBytes > kMergeBytes
                                       ? (kRingBytes > kStageBytes<D>
                                              ? kRingBytes
                                              : kStageBytes<D>)
                                       : (kMergeBytes > kStageBytes<D>
                                              ? kMergeBytes
                                              : kStageBytes<D>);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 3)
    swa_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, float* __restrict__ part_acc,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   unsigned* __restrict__ tickets, T* __restrict__ out,
                   int S, int Hkv, int G, int cache_len, int rows_per_split,
                   float scale) {
  static_assert(sizeof(T) == 2, "the mma kernel takes bf16");
  using Rg = Ring<D>;
  constexpr int kChunks = D / 8;               // 16-byte chunks per row
  constexpr int kLoads = kTileM * kChunks / kThreads;
  constexpr int KS = D / 16;                   // k-steps of Q K^T
  constexpr int NT = D / 8;                    // n-tiles of P V
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* qs = ring + kStages * Rg::kStage;         // [kGMax][kRow]

  const int cell = blockIdx.x;                 // b * Hkv + h
  const int split = blockIdx.y;
  const int b = cell / Hkv, h = cell % Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = split * rows_per_split;
  const int r1 = min(r0 + rows_per_split, cache_len);
  const int n_tiles = (r1 - r0 + kTileM - 1) / kTileM;

  // tile i of the split into ring slot i % kStages; rows past r1 as zeros
  auto load_tile = [&](int i) {
    T* ks = ring + (i % kStages) * Rg::kStage;
    T* vs = ks + kTileM * Rg::kRow;
    const int t0 = r0 + i * kTileM;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int c = tid + u * kThreads;
      const int t = c / kChunks, e = (c % kChunks) * 8;
      const bool ok = t0 + t < r1;
      const size_t off =
          ((size_t)(b * S + (ok ? t0 + t : r0)) * Hkv + h) * D + e;
      cp_async16(ks + t * Rg::kRow + e, k + off, ok);
      cp_async16(vs + t * Rg::kRow + e, v + off, ok);
    }
  };
  // Q (heads h*G .. h*G + G - 1), zero rows for the padding heads
  {
    const T* qc = q + (size_t)cell * G * D;
    for (int c = tid; c < kGMax * kChunks; c += kThreads) {
      const int g = c / kChunks, e = (c % kChunks) * 8;
      cp_async16(qs + g * Rg::kRow + e, qc + (g < G ? g : 0) * D + e, g < G);
    }
  }
  load_tile(0);               // every split holds a row
  cp_async_commit();          // group 0: Q and tile 0
  if (n_tiles > 1) load_tile(1);
  cp_async_commit();          // group 1: tile 1 (or nothing)

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  // ldmatrix row addresses: lane gives row lane % 8 of matrix lane / 8
  const int lr = lane % 8, lm = lane / 8;
  const int g0 = lane / 4, cq = 2 * (lane % 4);

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();   // every group but the newest: tile i landed
    __syncthreads();
    const T* ks = ring + (i % kStages) * Rg::kStage + warp * 16 * Rg::kRow;
    const T* vs = ks + kTileM * Rg::kRow;

    // scores of the warp's 16 rows: two n-tiles of 8 rows, the even and
    // odd k-steps in separate accumulators (two independent mma chains)
    float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    float s2[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], kb[4];
      // Q as the A fragment: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
      ldsm_x4(qa, qs + (lr + (lm % 2) * 8) * Rg::kRow + kk * 16 +
                      (lm / 2) * 8);
      ldsm_x4(kb, ks + (lr + (lm / 2) * 8) * Rg::kRow + kk * 16 +
                      (lm % 2) * 8);
      float(&c0)[4] = kk % 2 ? s2[0] : sc[0];
      float(&c1)[4] = kk % 2 ? s2[1] : sc[1];
      mma_bf16(c0, qa, kb[0], kb[1]);
      mma_bf16(c1, qa, kb[2], kb[3]);
    }
    // online softmax: sc[j][e] is head g0 + 8 (e / 2), row 8 j + cq + e % 2
    const int tb = r0 + i * kTileM + warp * 16;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = tb + 8 * j + cq + (e & 1) < r1;
        sc[j][e] = valid ? (sc[j][e] + s2[j][e]) * scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], sc[j][e]);
      }
    float corr[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = tb + 8 * j + cq + (e & 1) < r1;
        sc[j][e] = valid ? expf(sc[j][e] - m[e / 2]) : 0.0f;
        ls[e / 2] += sc[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ls[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // P as A fragments (the score fragments' layout), in three terms
    uint32_t pa[3][4];
    split3(sc[0][0], sc[0][1], pa[0][0], pa[1][0], pa[2][0]);
    split3(sc[0][2], sc[0][3], pa[0][1], pa[1][1], pa[2][1]);
    split3(sc[1][0], sc[1][1], pa[0][2], pa[1][2], pa[2][2]);
    split3(sc[1][2], sc[1][3], pa[0][3], pa[1][3], pa[2][3]);
    // acc += P V over the warp's 16 rows, two n-tiles of D per ldmatrix
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, vs + (lr + (lm % 2) * 8) * Rg::kRow + n2 * 16 +
                            (lm / 2) * 8);
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        mma_bf16(acc[2 * n2], pa[term], vb[0], vb[1]);
        mma_bf16(acc[2 * n2 + 1], pa[term], vb[2], vb[3]);
      }
    }
    __syncthreads();   // every warp is done with tile i's slot
    if (i + 2 < n_tiles) load_tile(i + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the warps merge through it

  // merge the four warps: per head M = max_w m_w, acc = sum_w acc_w
  // exp(m_w - M), L likewise
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* wm = reinterpret_cast<float*>(smem);       // [kWarps][kGMax]
  float* wl = wm + kWarps * kGMax;                  // [kWarps][kGMax]
  float* wacc = wl + kWarps * kGMax;                // [kWarps][kGMax][kAccRow]
  if (lane % 4 == 0) {
    wm[warp * kGMax + g0] = m[0];
    wm[warp * kGMax + g0 + 8] = m[1];
    wl[warp * kGMax + g0] = l[0];
    wl[warp * kGMax + g0 + 8] = l[1];
  }
  __syncthreads();
  float w[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = g0 + 8 * r;
    float M = wm[g];
#pragma unroll
    for (int u = 1; u < kWarps; ++u) M = fmaxf(M, wm[u * kGMax + g]);
    w[r] = expf(m[r] - M);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float* row0 = wacc + (warp * kGMax + g0) * Rg::kAccRow + 8 * n + cq;
    float* row1 = row0 + 8 * Rg::kAccRow;
    *reinterpret_cast<float2*>(row0) =
        make_float2(acc[n][0] * w[0], acc[n][1] * w[0]);
    *reinterpret_cast<float2*>(row1) =
        make_float2(acc[n][2] * w[1], acc[n][3] * w[1]);
  }
  __syncthreads();
  float* bp = wacc + kWarps * kGMax * Rg::kAccRow;   // the block's partial
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float A = 0.0f;
#pragma unroll
    for (int u = 0; u < kWarps; ++u)
      A += wacc[(u * kGMax + g) * Rg::kAccRow + d];
    bp[2 * kGMax + e] = A;
  }
  if (tid < G) {
    float M = wm[tid];
#pragma unroll
    for (int u = 1; u < kWarps; ++u) M = fmaxf(M, wm[u * kGMax + tid]);
    float L = 0.0f;
#pragma unroll
    for (int u = 0; u < kWarps; ++u)
      L = fmaf(wl[u * kGMax + tid], expf(wm[u * kGMax + tid] - M), L);
    bp[tid] = M;
    bp[kGMax + tid] = L;
  }
  finish_cell<T, D>(bp, reinterpret_cast<float*>(smem), part_acc, part_m,
                    part_l, tickets, out, cell, G);
}

// ---- host -----------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* out;
  float *part_acc, *part_m, *part_l;
  unsigned* tickets;
  int cells, n_split, S, Hkv, G, cache_len, rows_per_split;
  float scale;
  cudaStream_t stream;
};

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, float*, float*, float*,
                        unsigned*, T*, int, int, int, int, int, float);

// The launch: a block per (cell, split).
template <typename T>
cudaError_t launch_kernel(Kernel<T> kernel, size_t smem, const Args& a) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.cells, a.n_split), kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.part_acc, a.part_m,
      a.part_l, a.tickets, (T*)a.out, a.S, a.Hkv, a.G, a.cache_len,
      a.rows_per_split, a.scale);
  return cudaGetLastError();
}

template <int D, int GP>
cudaError_t run_fma(const Args& a) {
  using Tl = Tiles<float, D, GP>;
  const size_t smem =
      sizeof(Tl) > kStageBytes<D> ? sizeof(Tl) : kStageBytes<D>;
  return launch_kernel<float>(swa_fma_kernel<float, D, GP>, smem, a);
}

template <int D>
cudaError_t run_mma(const Args& a) {
  return launch_kernel<bf16>(swa_mma_kernel<bf16, D>, Ring<D>::kBytes, a);
}

template <int D>
cudaError_t run_f32(const Args& a) {
  return a.G <= 1   ? run_fma<D, 1>(a)   // G padded to a power of 2
         : a.G <= 2 ? run_fma<D, 2>(a)
         : a.G <= 4 ? run_fma<D, 4>(a)
         : a.G <= 8 ? run_fma<D, 8>(a)
                    : run_fma<D, 16>(a);
}

template <bool kBf16>
int launch(const void* q, const void* k, const void* v, void* out,
           void* scratch, void* tickets, int B, int S, int Hkv, int G, int D,
           int cache_len, int rows_per_split, int n_split, float scale,
           void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > kGMax || cache_len < 1 ||
      cache_len > S || rows_per_split < 1 || n_split < 1 ||
      n_split > kMaxSplits || rows_per_split % kTileM ||
      (long long)rows_per_split * (n_split - 1) >= cache_len ||
      (long long)rows_per_split * n_split < cache_len)
    return (int)cudaErrorInvalidValue;
  const int groups = (n_split + kGroup - 1) / kGroup;
  const size_t slots = (size_t)B * Hkv * (n_split + (groups > 1 ? groups : 0));
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.cells = B * Hkv;
  a.part_acc = (float*)scratch;
  a.part_m = a.part_acc + slots * G * D;
  a.part_l = a.part_m + slots * G;
  a.tickets = (unsigned*)tickets;
  a.n_split = n_split;
  a.S = S;
  a.Hkv = Hkv;
  a.G = G;
  a.cache_len = cache_len;
  a.rows_per_split = rows_per_split;
  a.scale = scale;
  a.stream = (cudaStream_t)stream;
  cudaError_t e;
  switch (D) {
    case 32:
      e = kBf16 ? run_mma<32>(a) : run_f32<32>(a);
      break;
    case 64:
      e = kBf16 ? run_mma<64>(a) : run_f32<64>(a);
      break;
    case 128:
      e = kBf16 ? run_mma<128>(a) : run_f32<128>(a);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return (int)e;
}

}  // namespace

extern "C" {

// q (B, Hkv * G, D), k and v (B, S, Hkv, D), out (B, Hkv * G, D): one
// dtype, contiguous, 16-byte aligned.  Split i covers rows [i *
// rows_per_split, min((i + 1) * rows_per_split, cache_len));
// rows_per_split is a multiple of 64, every split holds a row and n_split
// <= 64.  scratch: B * Hkv * (n_split + groups) * G * (D + 2) floats,
// groups = ceil(n_split / 8) when it is above 1, else 0.  tickets: B *
// Hkv * 9 unsigned ints, zero before the call and zero again after it;
// calls that may run at once need their own.  scale = 1/sqrt(D) in f32.
// Returns the CUDA error code of the launch (0 = launched).
int swa_decode_attention_f32(const void* q, const void* k, const void* v,
                             void* out, void* scratch, void* tickets, int B,
                             int S, int Hkv, int G, int D, int cache_len,
                             int rows_per_split, int n_split, float scale,
                             void* stream) {
  return launch<false>(q, k, v, out, scratch, tickets, B, S, Hkv, G, D,
                       cache_len, rows_per_split, n_split, scale, stream);
}

int swa_decode_attention_bf16(const void* q, const void* k, const void* v,
                              void* out, void* scratch, void* tickets, int B,
                              int S, int Hkv, int G, int D, int cache_len,
                              int rows_per_split, int n_split, float scale,
                              void* stream) {
  return launch<true>(q, k, v, out, scratch, tickets, B, S, Hkv, G, D,
                      cache_len, rows_per_split, n_split, scale, stream);
}

const char* swa_decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
