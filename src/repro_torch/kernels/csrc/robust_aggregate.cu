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
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// plane_elems = R * 1024; x, d, out contiguous.  The reduce averages the
// sorted positions [lo, hi) of each coordinate's n values: [k, n - k) for
// the k-trimmed mean, the middle one or two for the median.  1 <= n <= 64.
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
