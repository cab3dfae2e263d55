// nova_aggregate: the eq.-11 update at the floating aggregation DC,
//
//   x'_j = x_j - theta_eta * sum_i w_i d_i      (w already normalized)
//
// on an (n, R, 1024) stack d and `replicas` planes x_j of shape (R, 1024),
// stored one after the other.  One kernel serves both Pallas TPU kernels
// of src/repro/kernels/nova_aggregate.py:
//
// * replicas = 1: one (R, 1024) plane x, replacing nova_aggregate_2d (:85,
//   bodies _kernel at :58 and _kernel_acc at :67);
// * replicas = n: the mesh round's (n, R, 1024) stack of per-DPU replicas
//   of the global model, every row receiving the same update, replacing
//   nova_aggregate_stacked_2d (:156, bodies _kernel_stacked at :130 and
//   _kernel_stacked_acc at :139).
//
// What bounds it on the card: bytes.  It reads every d_i once and every x_j
// once and writes every x'_j once (4 * (n + 2 * replicas) * R * 1024 bytes
// in f32), for two operations per element of d and two per element of x.
// The TPU kernels carry an f32 VMEM sum across *sequential* grid steps
// along n; blocks on Hopper run in no order, so that carried sum cannot
// exist.  Instead each thread owns one 16-byte vector of the plane (4 f32
// or 8 bf16 elements): it loops over the n d_i with f32 sums in registers,
// so each d_i is read once and no partial sum goes to device memory, then
// loops over the replicas, reading x_j and writing x'_j.  Every row gets
// the same sum, so row j of a stacked update equals the one-plane update
// of x_j bit for bit.  At R = 176 there are only 45,056 vectors, one per
// thread, so a thread must keep several loads in flight for the card to
// see enough bytes in the air: it issues eight d_i loads before their
// FMAs (the sum keeps its DPU order), and the replica loop is unrolled by
// four.  Neighbouring threads read neighbouring addresses.  The weights
// are loaded into shared memory once per block.

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
                                      int64_t plane_vec, int n, int replicas,
                                      float theta_eta) {
  extern __shared__ float w_s[];
  for (int j = threadIdx.x; j < n; j += blockDim.x) w_s[j] = w[j];
  __syncthreads();
  constexpr int kW = 16 / sizeof(T);
  constexpr int kBatch = 8;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < plane_vec; i += stride) {
    float sum[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) sum[k] = 0.0f;
    // kBatch loads of d in flight, then their FMAs in DPU order
    int j = 0;
    for (; j + kBatch <= n; j += kBatch) {
      Vec<T> dv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        dv[u] = d[(int64_t)(j + u) * plane_vec + i];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float wj = w_s[j + u];
#pragma unroll
        for (int k = 0; k < kW; ++k) sum[k] += wj * to_f32(dv[u].v[k]);
      }
    }
    for (; j < n; ++j) {
      const Vec<T> dv = d[(int64_t)j * plane_vec + i];
      const float wj = w_s[j];
#pragma unroll
      for (int k = 0; k < kW; ++k) sum[k] += wj * to_f32(dv.v[k]);
    }
#pragma unroll 4
    for (int r = 0; r < replicas; ++r) {
      const int64_t at = (int64_t)r * plane_vec + i;
      const Vec<T> xv = x[at];
      Vec<T> o;
#pragma unroll
      for (int k = 0; k < kW; ++k)
        o.v[k] = from_f32<T>(to_f32(xv.v[k]) - theta_eta * sum[k]);
      out[at] = o;
    }
  }
}

template <typename T>
int launch(const void* x, const void* d, const void* w, void* out,
           int64_t plane_elems, int n, int replicas, float theta_eta,
           void* stream) {
  constexpr int kW = 16 / sizeof(T);
  constexpr int kThreads = 128;
  const int64_t plane_vec = plane_elems / kW;
  const int64_t blocks = plane::grid_blocks(plane_vec, kThreads, 16);
  nova_aggregate_kernel<T><<<(unsigned)blocks, kThreads, n * sizeof(float),
                             (cudaStream_t)stream>>>(
      (const Vec<T>*)x, (const Vec<T>*)d, (const float*)w, (Vec<T>*)out,
      plane_vec, n, replicas, theta_eta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// plane_elems = R * 1024; x and out are (replicas, R, 1024), d is
// (n, R, 1024), all 16-byte aligned and contiguous; w is (n,) f32.
// Returns the CUDA error code of the launch (0 = launched).
int nova_aggregate_f32(const void* x, const void* d, const void* w, void* out,
                       int64_t plane_elems, int n, int replicas,
                       float theta_eta, void* stream) {
  return launch<float>(x, d, w, out, plane_elems, n, replicas, theta_eta,
                       stream);
}

int nova_aggregate_bf16(const void* x, const void* d, const void* w,
                        void* out, int64_t plane_elems, int n, int replicas,
                        float theta_eta, void* stream) {
  return launch<__nv_bfloat16>(x, d, w, out, plane_elems, n, replicas,
                               theta_eta, stream);
}

const char* nova_aggregate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
