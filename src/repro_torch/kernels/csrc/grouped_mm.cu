// grouped_mm: the drop-free MoE's expert products over segments of
// (token, choice) pairs sorted by expert (models/moe.dropless_forward,
// wrapper kernels/grouped_mm.py).  It replaces no TPU kernel: the JAX
// package's MoE is capacity dispatch by dense one-hot products, which drops
// pairs past a capacity; this is the drop-free path's product.
//
//   grouped_mm:    out[r, :] = a[rows[r], :] @ w[e]    for r in segment e
//                  (a[r, :] without rows); rows past offsets[E] untouched
//   grouped_wgrad: dw[e] = a[rows[seg e], :]^T @ g[seg e, :]
//
// offsets (E + 1,) int64 lie on the device and are never read on the
// host: each block loads them and finds its own tile.  All in float32 with
// IEEE products (FMAs, no TF32), as every LM cell runs.
//
// What bounds it on the card: operations.  At the Nemotron-H cell's shapes
// (about 6,200 pairs over 16 experts, 2,688 <-> 1,856) a product is 2·P·K·N
// = 62 GFLOP against 0.35 GB of operands, 180 operations a byte, far above
// the f32 FMA rate's ridge (67 TFLOP/s over 3.35 TB/s = 20).  So the design
// is the register-tiled SIMT product: a 256-thread block owns a 128 x 128
// output tile, each thread an 8 x 8 piece of it in registers (64 FMAs for
// 4 shared-memory float4 reads a depth step); depth comes in slices of 8
// through two shared-memory stages, the next slice's global loads in
// registers while the current one is multiplied.  A's slice is stored
// transposed (depth-major), padded by 4 so the transposed stores meet no
// bank conflict.  Tiles never straddle two experts: grouped_mm's grid has
// one row of blocks per 128-pair tile of any segment (an upper bound of
// P / 128 + E rows, the surplus blocks exit at once), so a heavily loaded
// expert spreads over as many blocks as its pairs need.  grouped_wgrad has
// one block per (K, N) tile of each expert, looping over its segment.
// Summation order is fixed (depth in order, one accumulator an output), so
// a result does not change from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output rows of a block's tile
constexpr int BN = 128;       // output columns
constexpr int BK = 8;         // depth a step
constexpr int THREADS = 256;
constexpr int PAD = 4;        // A's transposed rows: no bank conflicts

struct Tiles {
  float a[2][BK][BM + PAD];   // As[k][m]
  float b[2][BK][BN];         // Bs[k][n]
};

// the thread's 8 x 8 sums over one depth slice of the shared tiles: rows
// ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise with tx
__device__ __forceinline__ void slice_fma(const float (&As)[BK][BM + PAD],
                                          const float (&Bs)[BK][BN],
                                          float (&acc)[8][8], int ty,
                                          int tx) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// four consecutive floats from p, those at or past `left` as zero (VEC:
// the caller guarantees all four or none, and 16-byte alignment)
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int64_t left) {
  if (VEC) {
    return left > 0 ? __ldg(reinterpret_cast<const float4*>(p))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 v;
  v.x = left > 0 ? __ldg(p) : 0.f;
  v.y = left > 1 ? __ldg(p + 1) : 0.f;
  v.z = left > 2 ? __ldg(p + 2) : 0.f;
  v.w = left > 3 ? __ldg(p + 3) : 0.f;
  return v;
}

// the thread's 8 x 8 piece of a tile into out's rows row0 + {..} (< rows)
// and columns col0 + {..} (< cols), row stride ld
template <bool VEC>
__device__ __forceinline__ void store_tile(float* out, int64_t ld,
                                           int64_t row0, int64_t rows,
                                           int64_t col0, int64_t cols,
                                           const float (&acc)[8][8], int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= rows) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t c = col0 + half * 64 + tx * 4;
      float* p = out + r * ld + c;
      const float* v = &acc[i][half * 4];
      if (VEC) {
        if (c < cols) *reinterpret_cast<float4*>(p) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < cols) p[j] = v[j];
      }
    }
  }
}

template <bool GATHER, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
grouped_mm_kernel(const float* __restrict__ a,
                  const int64_t* __restrict__ rows,
                  const float* __restrict__ w, float* __restrict__ out,
                  const int64_t* __restrict__ offsets,
                  unsigned long long* __restrict__ written, int E, int K,
                  int N, int64_t lda, int64_t sw0, int64_t ldw) {
  // this block's tile: the blockIdx.y-th 128-pair tile over the segments
  int64_t t = blockIdx.y, m0 = -1, m_end = 0;
  int e = 0;
  for (; e < E; ++e) {
    const int64_t s = offsets[e], end = offsets[e + 1];
    const int64_t tiles = (end - s + BM - 1) / BM;
    if (t < tiles) {
      m0 = s + t * BM;
      m_end = end;
      break;
    }
    t -= tiles;
  }
  if (m0 < 0) return;
  const int64_t n0 = (int64_t)blockIdx.x * BN;

  __shared__ __align__(16) Tiles sm;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // A loads: row lm of the tile, depth lk .. lk + 3 of the slice
  const int lm = tid >> 1, lk = (tid & 1) * 4;
  const int64_t pm = m0 + lm;
  const float* arow = nullptr;
  if (pm < m_end) arow = a + (GATHER ? rows[pm] : pm) * lda;
  // B loads: depth bk of the slice, columns bn .. bn + 3
  const int bk = tid >> 5, bn = (tid & 31) * 4;
  const float* wcol = w + (int64_t)e * sw0 + n0 + bn;
  const int64_t ncols = N - (n0 + bn);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto load = [&](int k0, float4& ra, float4& rb) {
    ra = arow ? load4<VEC>(arow + k0 + lk, K - (k0 + lk))
              : make_float4(0.f, 0.f, 0.f, 0.f);
    rb = k0 + bk < K ? load4<VEC>(wcol + (int64_t)(k0 + bk) * ldw, ncols)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto stash = [&](int stage, const float4& ra, const float4& rb) {
    sm.a[stage][lk + 0][lm] = ra.x;
    sm.a[stage][lk + 1][lm] = ra.y;
    sm.a[stage][lk + 2][lm] = ra.z;
    sm.a[stage][lk + 3][lm] = ra.w;
    *reinterpret_cast<float4*>(&sm.b[stage][bk][bn]) = rb;
  };

  float4 ra, rb;
  load(0, ra, rb);
  stash(0, ra, rb);
  __syncthreads();
  const int steps = (K + BK - 1) / BK;
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < steps;
    if (more) load((s + 1) * BK, ra, rb);
    slice_fma(sm.a[cur], sm.b[cur], acc, ty, tx);
    if (more) stash(cur ^ 1, ra, rb);
    __syncthreads();
  }
  store_tile<VEC>(out, N, m0, m_end, n0, N, acc, ty, tx);
  if (written != nullptr && blockIdx.x == 0 && tid == 0) {
    const int64_t n = m_end - m0 < BM ? m_end - m0 : BM;
    atomicAdd(written, (unsigned long long)n);
  }
}

template <bool GATHER, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
grouped_wgrad_kernel(const float* __restrict__ a,
                     const int64_t* __restrict__ rows,
                     const float* __restrict__ g, float* __restrict__ dw,
                     const int64_t* __restrict__ offsets, int K, int N,
                     int64_t lda, int64_t ldg) {
  const int e = blockIdx.y;
  const int n_tiles = (N + BN - 1) / BN;
  const int64_t m0 = (int64_t)(blockIdx.x / n_tiles) * BM;   // along K
  const int64_t n0 = (int64_t)(blockIdx.x % n_tiles) * BN;
  const int64_t start = offsets[e], end = offsets[e + 1];

  __shared__ __align__(16) Tiles sm;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // both loads: pair r0 + lr of the slice; A's K columns m0 + lc .. + 3,
  // g's N columns n0 + lc .. + 3
  const int lr = tid >> 5, lc = (tid & 31) * 4;
  const int64_t kcols = K - (m0 + lc), ncols = N - (n0 + lc);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto load = [&](int64_t r0, float4& ra, float4& rb) {
    const int64_t r = r0 + lr;
    if (r < end) {
      const int64_t src = GATHER ? rows[r] : r;
      ra = load4<VEC>(a + src * lda + m0 + lc, kcols);
      rb = load4<VEC>(g + r * ldg + n0 + lc, ncols);
    } else {
      ra = rb = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stash = [&](int stage, const float4& ra, const float4& rb) {
    *reinterpret_cast<float4*>(&sm.a[stage][lr][lc]) = ra;
    *reinterpret_cast<float4*>(&sm.b[stage][lr][lc]) = rb;
  };

  const int64_t steps = (end - start + BK - 1) / BK;
  if (steps > 0) {
    float4 ra, rb;
    load(start, ra, rb);
    stash(0, ra, rb);
    __syncthreads();
    for (int64_t s = 0; s < steps; ++s) {
      const int cur = s & 1;
      const bool more = s + 1 < steps;
      if (more) load(start + (s + 1) * BK, ra, rb);
      slice_fma(sm.a[cur], sm.b[cur], acc, ty, tx);
      if (more) stash(cur ^ 1, ra, rb);
      __syncthreads();
    }
  }
  store_tile<VEC>(dw + (int64_t)e * K * N, N, m0, K, n0, N, acc, ty, tx);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// out (P, N) contiguous, zeroed by the caller; a (., K) rows of stride lda
// (unit stride along K); w (E, K, N) of strides (sw0, ldw, 1); rows (P,)
// int64 or null (no gather); offsets (E + 1,) int64; written: null, or a
// counter that gains the number of output rows written.  Returns the CUDA
// error code of the launch (0 = launched).
int grouped_mm_f32(const float* a, const int64_t* rows, const float* w,
                   float* out, const int64_t* offsets,
                   unsigned long long* written, int E, int K, int N,
                   int64_t P, int64_t lda, int64_t sw0, int64_t ldw,
                   void* stream) {
  const int64_t row_tiles = (P + BM - 1) / BM + E;
  if (row_tiles > 65535 || E < 1) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (unsigned)row_tiles);
  const bool vec = K % 4 == 0 && N % 4 == 0 && lda % 4 == 0 &&
                   sw0 % 4 == 0 && ldw % 4 == 0 && aligned16(a) &&
                   aligned16(w) && aligned16(out);
  cudaStream_t st = (cudaStream_t)stream;
#define GMM_LAUNCH(G, V)                                                    \
  grouped_mm_kernel<G, V><<<grid, THREADS, 0, st>>>(                        \
      a, rows, w, out, offsets, written, E, K, N, lda, sw0, ldw)
  if (rows != nullptr) {
    if (vec) GMM_LAUNCH(true, true); else GMM_LAUNCH(true, false);
  } else {
    if (vec) GMM_LAUNCH(false, true); else GMM_LAUNCH(false, false);
  }
#undef GMM_LAUNCH
  return (int)cudaGetLastError();
}

// dw (E, K, N) contiguous, every element written (zeros for an empty
// segment); a (., K) rows of stride lda (unit stride along K); g (P, N)
// rows of stride ldg (unit stride along N); rows, offsets as above.
int grouped_wgrad_f32(const float* a, const int64_t* rows, const float* g,
                      float* dw, const int64_t* offsets, int E, int K,
                      int N, int64_t lda, int64_t ldg, void* stream) {
  const int64_t tiles = (int64_t)((K + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (E < 1 || E > 65535 || tiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, E);
  const bool vec = K % 4 == 0 && N % 4 == 0 && lda % 4 == 0 &&
                   ldg % 4 == 0 && aligned16(a) && aligned16(g) &&
                   aligned16(dw);
  cudaStream_t st = (cudaStream_t)stream;
#define GWG_LAUNCH(G, V)                                                    \
  grouped_wgrad_kernel<G, V><<<grid, THREADS, 0, st>>>(                     \
      a, rows, g, dw, offsets, K, N, lda, ldg)
  if (rows != nullptr) {
    if (vec) GWG_LAUNCH(true, true); else GWG_LAUNCH(true, false);
  } else {
    if (vec) GWG_LAUNCH(false, true); else GWG_LAUNCH(false, false);
  }
#undef GWG_LAUNCH
  return (int)cudaGetLastError();
}

const char* grouped_mm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
