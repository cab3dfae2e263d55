// robust_aggregate: the byzantine-robust eq.-11 update at the floating
// aggregation DC,
//
//   x' = x - theta_eta * reduce_i(d_i)
//
// on an (R, 1024) plane x and an (n, R, 1024) stack d, where reduce is the
// coordinate-wise k-trimmed mean or median over the DPU axis (unweighted).
// It replaces the Pallas TPU kernel robust_aggregate_2d
// (src/repro/kernels/robust_aggregate.py:52, body _kernel at :43).
//
// What bounds it on the card: bytes, or the sorting network's min/max
// operations when n is large.  It reads every d_i once, x once and writes
// x' once (4 * R * 1024 * (n + 2) bytes in f32); the sort takes two
// operations per compare-exchange of the network, 191 compare-exchanges
// per coordinate at NMAX = 32.  The TPU kernel loads the whole
// (n, rows, 1024) block into VMEM and sorts it there, because the reduce
// needs every DPU's value of a coordinate at once.  Nothing is reused
// across coordinates, so on Hopper no block is staged at all: one thread
// owns one coordinate of the flat R * 1024 plane, loads its n values
// (neighbouring threads read neighbouring addresses of every d_i), sorts
// them in registers with a fully unrolled network (robust_sort.cuh),
// reduces, and writes one value.  NMAX is a compile-time size (8, 16, 32
// or 64, the smallest that holds n), so the register array never spills.
//
// Above 64 DPUs a register network no longer fits, and the kernel takes a
// second path, a per-coordinate rank selection.  One block of 8 warps
// takes a tile of 32 coordinates (one per lane).  Each value's place in
// torch.sort's order becomes an unsigned key (NaN above +inf, -0 tying
// +0); the n x 32 keys of the tile are staged in dynamic shared memory, or
// read through L1/L2 when they outgrow it.  Every thread ranks its values
// against all n of its coordinate, stably (rank = #{j : (key_j, j) <
// (key_i, i)}), which costs n^2 compares per coordinate: operations, not
// bytes, bound this path.  The elements of rank lo and hi - 1 mark the
// ends of the averaged range; one warp then sums, per coordinate and in
// index order, the values between them.  A median position is a single
// element, so the median stays bitwise equal to the plain version; the
// trimmed mean sums in index order instead of sorted order.
//
// Rounding: the reduce sums in ascending sorted order and divides, as the
// plain version's mean does; the update is __fmul_rn then __fsub_rn, so
// nvcc cannot contract it into an FMA.  The median is therefore bitwise
// equal to the plain version in f32; the trimmed mean differs only by the
// summation order of torch's sum.

#include "common.cuh"
#include "robust_sort.cuh"

namespace {

using plane::from_f32;
using plane::to_f32;

constexpr int kThreads = 256;

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads)
    robust_aggregate_kernel(const T* __restrict__ x, const T* __restrict__ d,
                            T* __restrict__ out, int64_t plane_elems, int n,
                            int lo, int hi, float theta_eta) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       c < plane_elems; c += stride) {
    float v[NMAX];
#pragma unroll
    for (int i = 0; i < NMAX; ++i)
      v[i] = i < n ? to_f32(d[(int64_t)i * plane_elems + c]) : 0.0f;
    const float red = robust::reduce<NMAX>(v, n, lo, hi);
    out[c] = from_f32<T>(
        __fsub_rn(to_f32(x[c]), __fmul_rn(theta_eta, red)));
  }
}

template <typename T, int NMAX>
int run(const void* x, const void* d, void* out, int64_t plane_elems, int n,
        int lo, int hi, float theta_eta, void* stream) {
  const int64_t blocks = plane::grid_blocks(plane_elems, kThreads, 8);
  robust_aggregate_kernel<T, NMAX>
      <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)x, (const T*)d, (T*)out, plane_elems, n, lo, hi,
          theta_eta);
  return (int)cudaGetLastError();
}

// ---- n > 64: per-coordinate rank selection --------------------------

constexpr int kTile = 32;          // coordinates per block, one per lane
constexpr int kRankThreads = 256;  // 8 warps rank the tile's values
constexpr int kPer = 4;            // values a thread ranks per pass

// A value's place in torch.sort's order as an unsigned key: ascending for
// the non-NaN values (-0 ties +0), every NaN above +inf.
__device__ __forceinline__ uint32_t order_key(float v) {
  if (isnan(v)) return 0xffffffffu;
  const uint32_t b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The stable sort's order: by key, equal keys by DPU index.
__device__ __forceinline__ bool before(uint32_t ka, int a, uint32_t kb,
                                       int b) {
  return ka < kb || (ka == kb && a < b);
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kRankThreads)
    robust_rank_kernel(const T* __restrict__ x, const T* __restrict__ d,
                       T* __restrict__ out, int64_t plane_elems, int n,
                       int lo, int hi, float theta_eta) {
  extern __shared__ uint32_t keys_s[];  // (n, kTile) when kStaged
  __shared__ int first_s[kTile], last_s[kTile];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t c0 = (int64_t)blockIdx.x * kTile;
  const int64_t c = c0 + lane;
  if (kStaged) {
    for (int t = threadIdx.x; t < n * kTile; t += blockDim.x)
      keys_s[t] = order_key(
          to_f32(d[(int64_t)(t / kTile) * plane_elems + c0 + t % kTile]));
    __syncthreads();
  }
  auto key = [&](int j) -> uint32_t {
    return kStaged ? keys_s[j * kTile + lane]
                   : order_key(to_f32(d[(int64_t)j * plane_elems + c]));
  };
  // Rank every value of the coordinate; record the DPUs of rank lo and
  // hi - 1 (the ranks are a permutation of 0..n-1, so each is found once).
  for (int i0 = warp * kPer; i0 < n; i0 += (kRankThreads / 32) * kPer) {
    uint32_t ki[kPer];
    int rank[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      ki[p] = i0 + p < n ? key(i0 + p) : 0u;
      rank[p] = 0;
    }
    for (int j = 0; j < n; ++j) {
      const uint32_t kj = key(j);
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        rank[p] += before(kj, j, ki[p], i0 + p) ? 1 : 0;
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (i0 + p >= n) continue;
      if (rank[p] == lo) first_s[lane] = i0 + p;
      if (rank[p] == hi - 1) last_s[lane] = i0 + p;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  // Sum, in DPU order, the values from rank lo to rank hi - 1.
  const int first = first_s[lane];
  const int last = last_s[lane];
  const uint32_t k_first = key(first);
  const uint32_t k_last = key(last);
  float sum = 0.0f;
  bool any = false;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const float v = to_f32(d[(int64_t)i * plane_elems + c]);
    const uint32_t k = order_key(v);
    if (!before(k, i, k_first, first) && !before(k_last, last, k, i)) {
      sum = any ? sum + v : v;
      any = true;
    }
  }
  const float red = sum / (float)(hi - lo);
  out[c] = from_f32<T>(__fsub_rn(to_f32(x[c]), __fmul_rn(theta_eta, red)));
}

template <typename T>
int run_rank(const void* x, const void* d, void* out, int64_t plane_elems,
             int n, int lo, int hi, float theta_eta, void* stream) {
  const int64_t blocks = plane_elems / kTile;  // plane_elems % 8192 == 0
  const size_t staged = (size_t)n * kTile * sizeof(uint32_t);
  int dev = 0, smem_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_optin,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (staged + 2 * kTile * sizeof(int) <= (size_t)smem_optin) {
    const cudaError_t e = cudaFuncSetAttribute(
        robust_rank_kernel<T, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)staged);
    if (e != cudaSuccess) return (int)e;
    robust_rank_kernel<T, true>
        <<<(unsigned)blocks, kRankThreads, staged, (cudaStream_t)stream>>>(
            (const T*)x, (const T*)d, (T*)out, plane_elems, n, lo, hi,
            theta_eta);
  } else {
    robust_rank_kernel<T, false>
        <<<(unsigned)blocks, kRankThreads, 0, (cudaStream_t)stream>>>(
            (const T*)x, (const T*)d, (T*)out, plane_elems, n, lo, hi,
            theta_eta);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* d, void* out, int64_t plane_elems,
           int n, int lo, int hi, float theta_eta, void* stream) {
  if (n < 1 || !(0 <= lo && lo < hi && hi <= n))
    return (int)cudaErrorInvalidValue;
  if (n <= 8)
    return run<T, 8>(x, d, out, plane_elems, n, lo, hi, theta_eta, stream);
  if (n <= 16)
    return run<T, 16>(x, d, out, plane_elems, n, lo, hi, theta_eta, stream);
  if (n <= 32)
    return run<T, 32>(x, d, out, plane_elems, n, lo, hi, theta_eta, stream);
  if (n <= 64)
    return run<T, 64>(x, d, out, plane_elems, n, lo, hi, theta_eta, stream);
  return run_rank<T>(x, d, out, plane_elems, n, lo, hi, theta_eta, stream);
}

}  // namespace

extern "C" {

// plane_elems = R * 1024; x, d, out contiguous.  The reduce averages the
// sorted positions [lo, hi) of each coordinate's n values: [k, n - k) for
// the k-trimmed mean, the middle one or two for the median.  n >= 1.
// Returns the CUDA error code of the launch (0 = launched).
int robust_aggregate_f32(const void* x, const void* d, void* out,
                         int64_t plane_elems, int n, int lo, int hi,
                         float theta_eta, void* stream) {
  return launch<float>(x, d, out, plane_elems, n, lo, hi, theta_eta,
                       stream);
}

int robust_aggregate_bf16(const void* x, const void* d, void* out,
                          int64_t plane_elems, int n, int lo, int hi,
                          float theta_eta, void* stream) {
  return launch<__nv_bfloat16>(x, d, out, plane_elems, n, lo, hi, theta_eta,
                               stream);
}

const char* robust_aggregate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
