// nova_aggregate: the eq.-11 update at the floating aggregation DC,
//
//   x'_r = x_r - theta_eta * sum_i w_i d_i      (w already normalized)
//
// on an (n, R, 1024) stack d and `replicas` planes x_r of shape (R, 1024),
// stored one after the other.  One kernel serves both Pallas TPU kernels
// of src/repro/kernels/nova_aggregate.py:
//
// * replicas = 1: one (R, 1024) plane x, replacing nova_aggregate_2d (:85,
//   bodies _kernel at :58 and _kernel_acc at :67);
// * replicas = n: the mesh round's (n, R, 1024) stack of per-DPU replicas
//   of the global model, every replica receiving the same update,
//   replacing nova_aggregate_stacked_2d (:156, bodies _kernel_stacked at
//   :130 and _kernel_stacked_acc at :139).
//
// What bounds it on the card: bytes.  It reads every d_i and every x_r
// once and writes every x'_r once (4 * (n + 2 * replicas) * R * 1024 bytes
// in f32) for two operations per element read.  The TPU kernels carry an
// f32 VMEM sum across sequential grid steps along n; blocks on Hopper run
// in no order, so a loop inside the block walks the DPUs instead.
//
// The design is a ring of tiles in shared memory fed by bulk copies.  A
// tile is one contiguous span of tile_elems elements (a row of 1024 or a
// half or quarter of one) at the same offset in every d_i and every x_r:
// 16-byte aligned, a multiple of 16 bytes, so a 1-D bulk copy
// (cp.async.bulk, no tensor map) moves it and reports its bytes to an
// mbarrier.  The grid is one persistent wave; each block walks the tiles
// with a stride.  Per tile it needs n + replicas copies: d_0 .. d_{n-1},
// then x_0 .. x_{replicas-1}.
//
// * One elected thread of the last warp is the producer.  Copy k goes to
//   stage k % S of the ring: it waits on the stage's empty barrier (not on
//   the first round), arms the stage's full barrier with the copy's bytes
//   (expect_tx) and issues the copy.  It runs up to S copies ahead of the
//   consumers and across tile boundaries, so the next tile's loads are in
//   flight while this tile is summed and stored; with n + replicas > S the
//   ring wraps inside a tile.
// * Every other thread is a consumer owning one 16-byte vector of the tile
//   (4 f32 or 8 bf16 elements), so a block has tile_elems / 4 or / 8
//   consumers, a whole number of warps.  For each copy it waits on the
//   stage's full barrier with the parity of the ring's round, reads its
//   vector, and its warp arrives once on the empty barrier (arrival count:
//   the consumer warps).  Over d_0 .. d_{n-1} it forms sum = fmaf(w_j,
//   d_j, sum) in DPU order from 0.0f; for each x_r it writes x_r -
//   theta_eta * sum with one 16-byte store.  Every replica gets the same
//   sum, so replica r of a stacked update equals the one-plane update of
//   x_r bit for bit, and no bit depends on S, the tile size or the grid.
//
// The weights pass through shared memory in chunks of at most kChunk (16
// KB), so any n fits: the consumers load a chunk when their DPU loop
// reaches it, between two named barriers of the consumer threads alone
// (the producer never waits on them).  Up to kChunk DPUs that happens once
// a block.  The launch plan (tile, S, blocks, shared bytes) is computed by
// the wrapper (nova_aggregate.py, launch_plan), which the CPU tests check;
// the layout below must match its shared-memory count.

#include <atomic>

#include "common.cuh"

namespace {

using plane::Vec;
using plane::from_f32;
using plane::to_f32;

constexpr int kChunk = 4096;   // weights staged in shared memory at once
constexpr int kWarp = 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::
                   "r"(smem_addr(bar)) : "memory");
}

// the producer's arrival on a full barrier, arming it with `bytes`
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// bytes contiguous bytes from global src to shared dst, reported to bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a barrier of the consumer threads alone (named barrier 1)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

__host__ __device__ constexpr int64_t align128(int64_t b) {
  return (b + 127) / 128 * 128;
}

// The dynamic shared memory: 2 * stages barriers (full, then empty), the
// weight chunk, the ring.  launch_plan in nova_aggregate.py counts alike.
__host__ __device__ inline int64_t weights_offset(int stages) {
  return align128(16 * (int64_t)stages);
}
__host__ __device__ inline int64_t ring_offset(int stages, int n) {
  const int64_t chunk = n < kChunk ? n : kChunk;
  return align128(weights_offset(stages) + 4 * chunk);
}

template <typename T>
__global__ void nova_aggregate_kernel(const T* __restrict__ x,
                                      const T* __restrict__ d,
                                      const float* __restrict__ w,
                                      T* __restrict__ out,
                                      int64_t plane_elems, int n,
                                      int replicas, float theta_eta,
                                      int tile_elems, int stages) {
  constexpr int kW = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  float* w_s = reinterpret_cast<float*>(smem + weights_offset(stages));
  unsigned char* ring = smem + ring_offset(stages, n);

  const int consumers = tile_elems / kW;   // one vector each
  const uint32_t tile_bytes = (uint32_t)tile_elems * sizeof(T);
  const int64_t tiles = plane_elems / tile_elems;
  for (int s = threadIdx.x; s < stages; s += blockDim.x) {
    bar_init(&full[s], 1);
    bar_init(&empty[s], consumers / kWarp);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x >= consumers) {          // the producer warp
    if (threadIdx.x != consumers) return;
    int s = 0;
    uint32_t phase = 0;
    bool first = true;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int64_t at = t * tile_elems;
      for (int c = 0; c < n + replicas; ++c) {
        if (!first) bar_wait(&empty[s], phase ^ 1);
        const T* src = c < n ? d + (int64_t)c * plane_elems + at
                             : x + (int64_t)(c - n) * plane_elems + at;
        bar_expect(&full[s], tile_bytes);
        bulk_load(ring + (int64_t)s * tile_bytes, src, tile_bytes, &full[s]);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
          first = false;
        }
      }
    }
    return;
  }

  const int v = threadIdx.x;               // this consumer's vector
  const bool signals = (v % kWarp) == 0;
  int s = 0;
  uint32_t phase = 0;
  int loaded = -1;                         // first DPU of the staged chunk
  // the vector of copy (stage s), then the warp's release of the stage
  auto take = [&]() {
    bar_wait(&full[s], phase);
    const Vec<T> got =
        reinterpret_cast<const Vec<T>*>(ring + (int64_t)s * tile_bytes)[v];
    __syncwarp();
    if (signals) bar_arrive(&empty[s]);
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
    return got;
  };
  Vec<T>* outv = reinterpret_cast<Vec<T>*>(out);
  const int64_t plane_vec = plane_elems / kW;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    float sum[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) sum[k] = 0.0f;
    for (int j = 0; j < n; ++j) {
      if (j % kChunk == 0 && j != loaded) {
        consumers_sync(consumers);         // the last chunk is read
        for (int i = v; i < min(kChunk, n - j); i += consumers)
          w_s[i] = w[j + i];
        consumers_sync(consumers);
        loaded = j;
      }
      const Vec<T> dv = take();
      const float wj = w_s[j % kChunk];
#pragma unroll
      for (int k = 0; k < kW; ++k)
        sum[k] = fmaf(wj, to_f32(dv.v[k]), sum[k]);
    }
    const int64_t at = t * (tile_elems / kW) + v;
    for (int r = 0; r < replicas; ++r) {
      const Vec<T> xv = take();
      Vec<T> o;
#pragma unroll
      for (int k = 0; k < kW; ++k)
        o.v[k] = from_f32<T>(to_f32(xv.v[k]) - theta_eta * sum[k]);
      outv[(int64_t)r * plane_vec + at] = o;
    }
  }
}

template <typename T>
int launch(const void* x, const void* d, const void* w, void* out,
           int64_t plane_elems, int n, int replicas, float theta_eta,
           int tile_elems, int stages, int blocks, int smem_bytes,
           void* stream) {
  constexpr int kW = 16 / sizeof(T);
  // the wrapper's plan must match this layout and the kernel's limits
  if (tile_elems % (kWarp * kW) || plane_elems % tile_elems || stages < 1 ||
      blocks < 1 || blocks > plane_elems / tile_elems ||
      smem_bytes != ring_offset(stages, n) +
                        (int64_t)stages * tile_elems * sizeof(T))
    return (int)cudaErrorInvalidValue;
  auto kernel = nova_aggregate_kernel<T>;
  // raise the kernel's dynamic shared-memory cap once per device
  static std::atomic<int> cap[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem_bytes > cap[dev].load()) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    cap[dev].store(smem_bytes);
  }
  const int threads = tile_elems / kW + kWarp;
  kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)d, (const float*)w, (T*)out, plane_elems, n,
      replicas, theta_eta, tile_elems, stages);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// plane_elems = R * 1024; x and out are (replicas, R, 1024), d is
// (n, R, 1024), all 16-byte aligned and contiguous; w is (n,) f32.  The
// plan (tile_elems, stages, blocks, smem_bytes) is launch_plan's.
// Returns the CUDA error code of the launch (0 = launched).
int nova_aggregate_f32(const void* x, const void* d, const void* w, void* out,
                       int64_t plane_elems, int n, int replicas,
                       float theta_eta, int tile_elems, int stages,
                       int blocks, int smem_bytes, void* stream) {
  return launch<float>(x, d, w, out, plane_elems, n, replicas, theta_eta,
                       tile_elems, stages, blocks, smem_bytes, stream);
}

int nova_aggregate_bf16(const void* x, const void* d, const void* w,
                        void* out, int64_t plane_elems, int n, int replicas,
                        float theta_eta, int tile_elems, int stages,
                        int blocks, int smem_bytes, void* stream) {
  return launch<__nv_bfloat16>(x, d, w, out, plane_elems, n, replicas,
                               theta_eta, tile_elems, stages, blocks,
                               smem_bytes, stream);
}

const char* nova_aggregate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
