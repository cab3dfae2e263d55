// fedprox_update: the FedProx proximal step on one parameter plane,
//
//   x' = x - eta * (g + mu * (x - anchor))
//
// on (R, 1024) planes of one dtype, f32 or bf16; the math runs in f32 and
// the result is cast back (the fedprox_plane_bf16 contract of the JAX
// package).  It replaces the Pallas TPU kernel fedprox_update_2d
// (src/repro/kernels/fedprox_update.py:95, body _kernel at :83), reached
// through the plane op fedprox_plane and the tree op fedprox_update.
//
// What bounds it on the card: bytes, and at the planes it runs on, launch
// latency.  It reads x, g and the anchor and writes x' (16 * R * 1024
// bytes in f32: 2.9 MB at R = 176, under a microsecond at 3.35 TB/s), for
// five operations per element.  As in fedprox_accum.cu, every thread
// handles one 16-byte vector of each operand per iteration (4 f32 or 8
// bf16 elements), neighbouring threads on neighbouring addresses, in a
// grid-stride loop.  The TPU kernel's row/lane tiles for VMEM have no
// counterpart: no element is used twice.

#include "common.cuh"

namespace {

using plane::Vec;
using plane::from_f32;
using plane::to_f32;

template <typename T>
__global__ void fedprox_update_kernel(const Vec<T>* __restrict__ x,
                                      const Vec<T>* __restrict__ g,
                                      const Vec<T>* __restrict__ anchor,
                                      Vec<T>* __restrict__ out, int64_t n_vec,
                                      float eta, float mu) {
  constexpr int kW = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const Vec<T> xv = x[i];
    const Vec<T> gv = g[i];
    const Vec<T> av = anchor[i];
    Vec<T> o;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const float xf = to_f32(xv.v[k]);
      o.v[k] = from_f32<T>(
          xf - eta * (to_f32(gv.v[k]) + mu * (xf - to_f32(av.v[k]))));
    }
    out[i] = o;
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* anchor, void* out,
           int64_t n_elems, float eta, float mu, void* stream) {
  constexpr int kW = 16 / sizeof(T);
  constexpr int kThreads = 256;
  const int64_t n_vec = n_elems / kW;
  const int64_t blocks = plane::grid_blocks(n_vec, kThreads, 8);
  fedprox_update_kernel<T><<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const Vec<T>*)x, (const Vec<T>*)g, (const Vec<T>*)anchor,
      (Vec<T>*)out, n_vec, eta, mu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// n_elems = R * 1024; x, g, anchor, out 16-byte aligned and contiguous.
// Returns the CUDA error code of the launch (0 = launched).
int fedprox_update_f32(const void* x, const void* g, const void* anchor,
                       void* out, int64_t n_elems, float eta, float mu,
                       void* stream) {
  return launch<float>(x, g, anchor, out, n_elems, eta, mu, stream);
}

int fedprox_update_bf16(const void* x, const void* g, const void* anchor,
                        void* out, int64_t n_elems, float eta, float mu,
                        void* stream) {
  return launch<__nv_bfloat16>(x, g, anchor, out, n_elems, eta, mu, stream);
}

const char* fedprox_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
