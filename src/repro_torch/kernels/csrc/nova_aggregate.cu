// nova_aggregate: the eq.-11 update at the floating aggregation DC,
//
//   x' = x - theta_eta * sum_i w_i d_i        (w already normalized)
//
// on an (R, 1024) plane x and an (n, R, 1024) stack d.  It replaces the
// Pallas TPU kernel nova_aggregate_2d (src/repro/kernels/nova_aggregate.py:85,
// bodies _kernel at :58 and _kernel_acc at :67).
//
// What bounds it on the card: bytes.  It reads every d_i once, x once, and
// writes x' once, for two operations per element of d.  The TPU kernel
// _kernel_acc carries an f32 VMEM sum across *sequential* grid steps along
// n; blocks on Hopper run in no order, so that carried sum cannot exist.
// Instead each thread owns one 16-byte vector of the plane (4 f32 or 8 bf16
// elements) and loops over the n DPUs itself, keeping the f32 sums in
// registers: each d_i is read exactly once and no partial sum ever goes to
// device memory.  The weights are loaded into shared memory once per block.
// Neighbouring threads read neighbouring addresses of each d_i.

#include "common.cuh"

namespace {

using plane::Vec;
using plane::from_f32;
using plane::to_f32;

template <typename T>
__global__ void nova_aggregate_kernel(const Vec<T>* __restrict__ x,
                                      const Vec<T>* __restrict__ d,
                                      const float* __restrict__ w,
                                      Vec<T>* __restrict__ out,
                                      int64_t plane_vec, int n,
                                      float theta_eta) {
  extern __shared__ float w_s[];
  for (int j = threadIdx.x; j < n; j += blockDim.x) w_s[j] = w[j];
  __syncthreads();
  constexpr int kW = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < plane_vec; i += stride) {
    float sum[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) sum[k] = 0.0f;
    for (int j = 0; j < n; ++j) {
      const Vec<T> dv = d[(int64_t)j * plane_vec + i];
      const float wj = w_s[j];
#pragma unroll
      for (int k = 0; k < kW; ++k) sum[k] += wj * to_f32(dv.v[k]);
    }
    const Vec<T> xv = x[i];
    Vec<T> o;
#pragma unroll
    for (int k = 0; k < kW; ++k)
      o.v[k] = from_f32<T>(to_f32(xv.v[k]) - theta_eta * sum[k]);
    out[i] = o;
  }
}

template <typename T>
int launch(const void* x, const void* d, const void* w, void* out,
           int64_t plane_elems, int n, float theta_eta, void* stream) {
  constexpr int kW = 16 / sizeof(T);
  constexpr int kThreads = 128;
  const int64_t plane_vec = plane_elems / kW;
  const int64_t blocks = plane::grid_blocks(plane_vec, kThreads, 16);
  nova_aggregate_kernel<T><<<(unsigned)blocks, kThreads, n * sizeof(float),
                             (cudaStream_t)stream>>>(
      (const Vec<T>*)x, (const Vec<T>*)d, (const float*)w, (Vec<T>*)out,
      plane_vec, n, theta_eta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// plane_elems = R * 1024; x, d, out 16-byte aligned and contiguous; w is
// (n,) f32.  Returns the CUDA error code of the launch (0 = launched).
int nova_aggregate_f32(const void* x, const void* d, const void* w, void* out,
                       int64_t plane_elems, int n, float theta_eta,
                       void* stream) {
  return launch<float>(x, d, w, out, plane_elems, n, theta_eta, stream);
}

int nova_aggregate_bf16(const void* x, const void* d, const void* w,
                        void* out, int64_t plane_elems, int n,
                        float theta_eta, void* stream) {
  return launch<__nv_bfloat16>(x, d, w, out, plane_elems, n, theta_eta,
                               stream);
}

const char* nova_aggregate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
