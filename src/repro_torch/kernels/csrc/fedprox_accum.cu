// fedprox_accum: the batched FedProx step plus the eq.-10 accumulation, for
// every DPU of a group in one launch.  It replaces the Pallas TPU kernel
// fedprox_accum_2d (src/repro/kernels/fedprox_update.py:135, body
// _accum_kernel at :119):
//
//   x'   = x   - active[g] * eta * (grad + mu * (x - anchor))
//   acc' = acc + active[g] * coef[g] * grad
//
// on (G, R, 1024) planes, the anchor (R, 1024) shared by the group or
// (G, R, 1024) per DPU.  Math in f32; outputs in the input dtype.
//
// What bounds it on the card: bytes.  Per element it reads x, grad, acc
// and the anchor and writes x' and acc', for about seven operations: far
// below the ratio of operations to bytes at which an H100 stops being
// memory-bound.  So the design only moves those bytes at full rate: every
// thread handles one 16-byte vector of each operand per iteration (4 f32 or
// 8 bf16 elements, one 128-bit access), neighbouring threads on
// neighbouring addresses, in a grid-stride loop sized to fill every SM.
// A plane holds R * 1024 elements, a multiple of 8192, so a vector never
// straddles two DPUs and the per-DPU scalars are read once per vector.
// The TPU kernel's row/lane tiles for VMEM have no counterpart here: no
// element is used twice, so nothing is staged in shared memory.

#include "common.cuh"

namespace {

using plane::Vec;
using plane::from_f32;
using plane::to_f32;

template <typename T>
__global__ void fedprox_accum_kernel(
    const Vec<T>* __restrict__ x, const Vec<T>* __restrict__ g,
    const Vec<T>* __restrict__ anchor, const Vec<T>* __restrict__ acc,
    const float* __restrict__ coef, const float* __restrict__ active,
    Vec<T>* __restrict__ x_out, Vec<T>* __restrict__ acc_out,
    int64_t n_vec, int64_t plane_vec, int anchor_batched, float eta,
    float mu) {
  constexpr int kW = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const int64_t dpu = i / plane_vec;
    const float act = active[dpu];
    const float step = act * eta;        // (active * eta), as the reference
    const float ak = act * coef[dpu];    // (active * a_k), as the reference
    const Vec<T> xv = x[i];
    const Vec<T> gv = g[i];
    const Vec<T> cv = acc[i];
    const Vec<T> av = anchor[anchor_batched ? i : i - dpu * plane_vec];
    Vec<T> xo, co;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const float xf = to_f32(xv.v[k]);
      const float gf = to_f32(gv.v[k]);
      xo.v[k] = from_f32<T>(xf - step * (gf + mu * (xf - to_f32(av.v[k]))));
      co.v[k] = from_f32<T>(to_f32(cv.v[k]) + ak * gf);
    }
    x_out[i] = xo;
    acc_out[i] = co;
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* anchor, const void* acc,
           const void* coef, const void* active, void* x_out, void* acc_out,
           int64_t n_elems, int64_t plane_elems, int anchor_batched,
           float eta, float mu, void* stream) {
  constexpr int kW = 16 / sizeof(T);
  constexpr int kThreads = 256;
  const int64_t n_vec = n_elems / kW;
  const int64_t blocks = plane::grid_blocks(n_vec, kThreads, 8);
  fedprox_accum_kernel<T><<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const Vec<T>*)x, (const Vec<T>*)g, (const Vec<T>*)anchor,
      (const Vec<T>*)acc, (const float*)coef, (const float*)active,
      (Vec<T>*)x_out, (Vec<T>*)acc_out, n_vec, plane_elems / kW,
      anchor_batched, eta, mu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// n_elems = G * R * 1024, plane_elems = R * 1024; every pointer 16-byte
// aligned and contiguous; coef/active are (G,) f32.  Returns the CUDA
// error code of the launch (0 = launched).
int fedprox_accum_f32(const void* x, const void* g, const void* anchor,
                      const void* acc, const void* coef, const void* active,
                      void* x_out, void* acc_out, int64_t n_elems,
                      int64_t plane_elems, int anchor_batched, float eta,
                      float mu, void* stream) {
  return launch<float>(x, g, anchor, acc, coef, active, x_out, acc_out,
                       n_elems, plane_elems, anchor_batched, eta, mu, stream);
}

int fedprox_accum_bf16(const void* x, const void* g, const void* anchor,
                       const void* acc, const void* coef, const void* active,
                       void* x_out, void* acc_out, int64_t n_elems,
                       int64_t plane_elems, int anchor_batched, float eta,
                       float mu, void* stream) {
  return launch<__nv_bfloat16>(x, g, anchor, acc, coef, active, x_out,
                               acc_out, n_elems, plane_elems, anchor_batched,
                               eta, mu, stream);
}

const char* fedprox_accum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
