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
// What bounds it on the card: bytes.  It reads every d_i once, x once and
// writes x' once (4 * R * 1024 * (n + 2) bytes in f32).  The TPU kernel
// loads the whole (n, rows, 1024) block into VMEM and sorts it there,
// because the reduce needs every DPU's value of a coordinate at once.
//
// Up to network_max DPUs (at most 64; the wrapper passes the crossover
// measured on the card): nothing is reused across coordinates, so no
// block is staged at all.  One thread owns one coordinate of the flat R *
// 1024 plane, loads its n values (neighbouring threads read neighbouring
// addresses of every d_i), sorts them in registers with a fully unrolled
// Batcher network (robust_sort.cuh; two operations per compare-exchange,
// 191 of them at NMAX = 32), reduces, and writes one value.  NMAX is a
// compile-time size (8, 16, 32 or 64, the smallest that holds n), so the
// register array never spills.
//
// Above it, a radix select.  One block of 16 warps takes a tile of 16
// coordinates.  Each value's place in torch.sort's order becomes an
// unsigned key (NaN above +inf, -0 tying +0).  The tile's n x 16 keys are
// staged once in dynamic shared memory (17 words a DPU, so that a warp
// reads a coordinate's column without bank conflicts), counting their top
// 8-bit digit into a 256-bin histogram per coordinate as they land; above
// about 2,850 DPUs they outgrow it and every pass re-reads device memory.
// Each digit pass picks, per coordinate, the bin that holds rank lo and
// the one that holds rank hi - 1 (one warp per coordinate: chunk totals by
// __reduce_add_sync, a shuffle scan of the chosen 32-bin chunk), then
// counts the next digit of the keys in those bins; the two targets share
// one histogram until their prefixes part.  A thread counts one
// coordinate's values and a warp covers two DPUs of 16 coordinates, so at
// most two lanes add to one bin however many DPUs send equal values.  The
// passes stop once both targets of every coordinate sit in bins of at
// most 64 keys (one or two passes for random stacks of 1,000, one for
// 65), or at
// the last digit (two for bf16, whose keys end in 16 bits the sign
// decides).  The warp then gathers each target's bin with ballots and
// ranks it in the stable order (key, then DPU index); a larger bin (ties
// past the last digit: one key value) needs only the rank-th of its DPUs,
// found with ballots in DPU order.  A median is one element (two for even
// n) and is read directly; a trimmed mean sums, per coordinate in DPU
// order, the values from one boundary (key, DPU) to the other, in 32 runs
// of DPUs added in order.  About 2n operations per coordinate beside the
// passes' counts, so bytes bound this path too.  Small stacks (n <= 512)
// launch with three blocks per SM, larger ones with two (their staged
// keys take most of the shared memory).
//
// Rounding: the network's reduce sums in ascending sorted order and
// divides, as the plain version's mean does; the update is __fmul_rn then
// __fsub_rn, so nvcc cannot contract it into an FMA.  A median takes the
// same element(s) as the plain version's stable sort, so it stays bitwise
// equal in f32, -0 and +0 included: the network, which is not stable,
// gives each zero at a target position the sign of the stable order's
// zero there (robust_sort.cuh), and the select ranks by (key, DPU).  A
// trimmed mean of two or more values sums from +0, as torch.mean does, so
// an all-zero kept set gives +0 in both; otherwise it differs only by the
// summation order.

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
                            int lo, int hi, bool from_zero,
                            float theta_eta) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       c < plane_elems; c += stride) {
    float v[NMAX];
#pragma unroll
    for (int i = 0; i < NMAX; ++i)
      v[i] = i < n ? to_f32(d[(int64_t)i * plane_elems + c]) : 0.0f;
    const float red = robust::reduce<NMAX>(v, n, lo, hi, from_zero);
    out[c] = from_f32<T>(
        __fsub_rn(to_f32(x[c]), __fmul_rn(theta_eta, red)));
  }
}

template <typename T, int NMAX>
int run(const void* x, const void* d, void* out, int64_t plane_elems, int n,
        int lo, int hi, bool from_zero, float theta_eta, void* stream) {
  const int64_t blocks = plane::grid_blocks(plane_elems, kThreads, 8);
  robust_aggregate_kernel<T, NMAX>
      <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)x, (const T*)d, (T*)out, plane_elems, n, lo, hi,
          from_zero, theta_eta);
  return (int)cudaGetLastError();
}

// ---- above the network: per-coordinate radix select ----------------

constexpr int kTile = 16;           // coordinates per block
constexpr int kSelThreads = 512;    // 16 warps
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kRuns = kSelThreads / kTile;   // DPU runs per coordinate
constexpr int kBatch = 8;           // keys a thread loads at once
constexpr int kKeyStride = kTile + 1;    // a warp reads a column: no conflict
constexpr int kGather = 64;         // bins this small are gathered, not split
constexpr int kSmallStack = 512;    // up to here three blocks share an SM
constexpr int kBins = 256;          // one 8-bit digit
constexpr int kHistStride = kBins + 1;   // one digit, other banks
// two histogram sets (one per target once their prefixes part)
constexpr size_t kHistBytes = 2 * kTile * kHistStride * sizeof(uint32_t);
static_assert(kSelWarps == kTile, "warp w picks the digits of coordinate w");
static_assert(kSelWarps * 4 * kGather <= 2 * kTile * kHistStride,
              "the gathered bins fit the histograms' space");

// A value's place in torch.sort's order as an unsigned key: ascending for
// the non-NaN values, every NaN above +inf.  -0 becomes 0x7fffffff, which
// no other value takes and which the comparisons read as +0's key
// (0x80000000), so -0 ties +0 and the key still decodes to the value.
__device__ __forceinline__ uint32_t order_key(float v) {
  if (isnan(v)) return 0xffffffffu;
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The key as the comparisons read it (-0 as +0).
__device__ __forceinline__ uint32_t tie_zero(uint32_t k) {
  return k == 0x7fffffffu ? 0x80000000u : k;
}

// The value of a key (a NaN for NaN's key).
__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Of a 256-bin histogram whose 32-bin chunks hold tot[0..7] keys: the
// chunk that holds rank `rank`, and the keys in the chunks before it.
__device__ __forceinline__ void find_chunk(const uint32_t (&tot)[8],
                                           uint32_t rank, int& chunk,
                                           uint32_t& before) {
  uint32_t run = 0;
  chunk = -1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (chunk < 0 && rank < run + tot[i]) {
      chunk = i;
      before = run;
    }
    run += tot[i];
  }
}

// Lane l's count of bin l of the chunk from cnt (lane l holds bins l, l +
// 32, ...), and its inclusive prefix sum over the lanes.
__device__ __forceinline__ uint32_t chunk_scan(const uint32_t (&cnt)[8],
                                               int chunk, uint32_t& x) {
  const int lane = threadIdx.x % 32;
  x = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i == chunk) x = cnt[i];
  uint32_t incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  return incl;
}

// The bin that holds rank r of its chunk (x and incl from chunk_scan): its
// digit, the rank within it, and the keys it holds.  One warp; every lane
// gets the result.
__device__ __forceinline__ void pick_bin(int chunk, uint32_t r, uint32_t x,
                                         uint32_t incl, uint32_t& digit,
                                         uint32_t& rest, uint32_t& size) {
  const int src =
      __ffs(__ballot_sync(0xffffffffu, incl - x <= r && r < incl)) - 1;
  digit = 32 * chunk + src;
  rest = r - __shfl_sync(0xffffffffu, incl - x, src);
  size = __shfl_sync(0xffffffffu, x, src);
}

// The stable sort's order: by key, equal keys by DPU index.
__device__ __forceinline__ bool before(uint32_t ka, int a, uint32_t kb,
                                       int b) {
  return ka < kb || (ka == kb && a < b);
}

// kStaged: the order keys of the tile's n x 16 values sit in dynamic
// shared memory, else every pass reads the values from device memory.
// kBlocks: the blocks that share an SM (registers allowing); three suit
// small stacks, whose passes are short, two large ones.
template <typename T, bool kStaged, int kBlocks>
__global__ void __launch_bounds__(kSelThreads, kBlocks)
    robust_select_kernel(const T* __restrict__ x, const T* __restrict__ d,
                         T* __restrict__ out, int64_t plane_elems, int n,
                         int lo, int hi, bool from_zero,
                         float theta_eta) {
  // bf16 keys end in 16 bits that the sign alone decides: two digits
  // tell them apart
  constexpr int kLow = sizeof(T) == 2 ? 16 : 0;
  constexpr uint32_t kKeyMask = 0xffffffffu << kLow;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* hist = smem;                                    // [2][16][257]
  uint32_t* keys = smem + 2 * kTile * kHistStride;         // [n][17]
  __shared__ uint32_t prefix_s[2][kTile];   // key bits chosen so far
  __shared__ uint32_t rank_s[2][kTile];     // rank among those keys
  __shared__ uint32_t bkey_s[2][kTile];     // the boundaries (key, DPU)
  __shared__ int bidx_s[2][kTile];
  __shared__ float psum_s[kRuns][kTile];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = tid % kTile;       // this thread's coordinate
  const int run = tid / kTile;     // and its run of DPUs
  const int64_t c0 = (int64_t)blockIdx.x * kTile;
  for (int i = tid; i < 2 * kTile * kHistStride; i += kSelThreads)
    hist[i] = 0;
  if (tid < kTile) {
    prefix_s[0][tid] = prefix_s[1][tid] = 0;
    rank_s[0][tid] = lo;
    rank_s[1][tid] = hi - 1;
  }
  __syncthreads();
  if (kStaged) {
    // stage the keys and count their top digit (the first pass's count).
    // A warp loads 16-byte vectors of kRowsPerWarp consecutive DPUs,
    // stores their keys, then re-reads them two DPUs of 16 coordinates at
    // a time for the counts, so at most two of its lanes add to one bin
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kRowVecs = kTile / kVec;          // vectors per DPU row
    constexpr int kRowsPerWarp = 32 / kRowVecs;
    constexpr int kStep = kSelWarps * kRowsPerWarp;
    const int e = (lane % kRowVecs) * kVec;
    auto load = [&](int j0) {   // this lane's vector of row group j0
      plane::Vec<T> r;
      const int j = j0 + lane / kRowVecs;
      if (j < n)
        r = *reinterpret_cast<const plane::Vec<T>*>(
            d + (int64_t)j * plane_elems + c0 + e);
      return r;
    };
    plane::Vec<T> next = load(warp * kRowsPerWarp);
    for (int j0 = warp * kRowsPerWarp; j0 < n; j0 += kStep) {
      const plane::Vec<T> r = next;
      if (j0 + kStep < n) next = load(j0 + kStep);   // one group ahead
      const int j = j0 + lane / kRowVecs;
      if (j < n) {
#pragma unroll
        for (int u = 0; u < kVec; ++u)
          keys[j * kKeyStride + e + u] = order_key(to_f32(r.v[u]));
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; q += 2) {
        const int jq = j0 + q + lane / kTile;
        if (jq < n && n > kGather)   // else no digit pass runs
          atomicAdd(hist + (lane % kTile) * kHistStride +
                        (tie_zero(keys[jq * kKeyStride + lane % kTile]) >>
                         24),
                    1u);
      }
    }
  }
  __syncthreads();
  // the order key of value j of coordinate cc, -0 read as +0
  auto key = [&](int j, int cc) -> uint32_t {
    return tie_zero(kStaged ? keys[j * kKeyStride + cc]
                            : order_key(to_f32(
                                  d[(int64_t)j * plane_elems + c0 + cc])));
  };

  // 1. digit passes from the top: thread (run, c) counts DPUs run, run +
  // 32, ... of coordinate c into c's histogram of the keys that match a
  // target's prefix; then warp w picks, for coordinate w, the digit of
  // each target and zeroes the bins it read for the next pass.  The
  // passes stop once both targets of every coordinate sit in bins of at
  // most kGather keys, or at the last digit.
  // With n <= kGather every key is gathered at once (no digit decided).
  int shift = 32;
  uint32_t size0 = n, size1 = n;   // the keys in the targets' bins (warp w)
  for (shift = n > kGather ? 24 : 32; shift < 32; shift -= 8) {
    if (!kStaged || shift != 24) {   // staging counted the top digit
      const uint32_t hmask = shift == 24 ? 0u : 0xffffffffu << (shift + 8);
      const uint32_t p0 = prefix_s[0][c], p1 = prefix_s[1][c];
      uint32_t* h = hist + c * kHistStride;
      // eight keys loaded ahead of their increments: the keys and the
      // histograms share one shared array, so a load after an increment
      // would wait for it
      for (int j0 = run; j0 < n; j0 += kBatch * kRuns) {
        uint32_t kb[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = j0 + u * kRuns;
          kb[u] = j < n ? key(j, c) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const uint32_t k = kb[u];
          // target 1's histogram only once the prefixes part
          const int set = j0 + u * kRuns >= n ? -1
                          : (k & hmask) == p0 ? 0
                          : (k & hmask) == p1 ? kTile * kHistStride
                                              : -1;
          if (set >= 0) atomicAdd(h + set + ((k >> shift) & 0xffu), 1u);
        }
      }
      __syncthreads();
    }
    {
      // lane l holds bins l, l + 32, ...; tot[i] sums chunk i's 32 bins.
      // The targets share one histogram until their prefixes part, and
      // one scan while their ranks fall in one chunk of it
      const uint32_t p0 = prefix_s[0][warp], p1 = prefix_s[1][warp];
      uint32_t* h0 = hist + warp * kHistStride;
      uint32_t* h1 = hist + (kTile + warp) * kHistStride;
      uint32_t cnt[8], tot[8], dg0, dg1, rest0, rest1, x0, x1, in0, in1, b0,
          b1;
      int ch0, ch1;
      const uint32_t r0 = rank_s[0][warp], r1 = rank_s[1][warp];
#pragma unroll
      for (int i = 0; i < 8; ++i) cnt[i] = h0[lane + 32 * i];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        tot[i] = __reduce_add_sync(0xffffffffu, cnt[i]);
      find_chunk(tot, r0, ch0, b0);
      in0 = chunk_scan(cnt, ch0, x0);
      pick_bin(ch0, r0 - b0, x0, in0, dg0, rest0, size0);
      if (p0 != p1) {   // target 1 has its own histogram once they part
#pragma unroll
        for (int i = 0; i < 8; ++i) cnt[i] = h1[lane + 32 * i];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          tot[i] = __reduce_add_sync(0xffffffffu, cnt[i]);
      }
      find_chunk(tot, r1, ch1, b1);
      if (p0 != p1 || ch1 != ch0) {
        in1 = chunk_scan(cnt, ch1, x1);
      } else {
        in1 = in0;
        x1 = x0;
      }
      pick_bin(ch1, r1 - b1, x1, in1, dg1, rest1, size1);
#pragma unroll
      for (int i = 0; i < 8; ++i) {   // zero for the next pass
        h0[lane + 32 * i] = 0;
        h1[lane + 32 * i] = 0;
      }
      if (lane == 0) {
        prefix_s[0][warp] = p0 | (dg0 << shift);
        prefix_s[1][warp] = p1 | (dg1 << shift);
        rank_s[0][warp] = rest0;
        rank_s[1][warp] = rest1;
      }
    }
    if (__syncthreads_and(size0 <= kGather && size1 <= kGather) ||
        shift == kLow)
      break;
  }

  // 2. the boundaries of coordinate w, by warp w: target t is the key of
  // rank rank_t, in the stable order, among the keys whose decided bits
  // equal prefix_t.  A bin of at most kGather keys is gathered with
  // ballots (into the histograms' space, free now) and ranked there; a
  // larger one (ties past the last digit: one key value) needs only the
  // rank_t-th of its DPUs, found with ballots in DPU order
  {
    const uint32_t dmask = shift == 32 ? 0u : 0xffffffffu << shift;
    uint32_t* gkey = hist + warp * 4 * kGather;    // [2][kGather]
    int* gidx = reinterpret_cast<int*>(gkey + 2 * kGather);
    const uint32_t pre[2] = {prefix_s[0][warp], prefix_s[1][warp]};
    const uint32_t rest[2] = {rank_s[0][warp], rank_s[1][warp]};
    const uint32_t size[2] = {size0, size1};
    uint32_t bk = 0;
    int bi = 0;
    // the gathered bins' keys, in DPU order, both targets in one scan (one
    // list while they share a prefix)
    const bool g0 = size[0] <= kGather;
    const bool g1 = size[1] <= kGather && pre[1] != pre[0];
    if (g0 || g1) {
      uint32_t f0 = 0, f1 = 0;
      for (int j0 = 0; j0 < n && ((g0 && f0 < size[0]) || (g1 && f1 < size[1]));
           j0 += 32) {
        const int j = j0 + lane;
        const uint32_t k = j < n ? key(j, warp) : 0u;
        const bool m0 = g0 && j < n && (k & dmask) == pre[0];
        const bool m1 = g1 && j < n && (k & dmask) == pre[1];
        const uint32_t bal0 = __ballot_sync(0xffffffffu, m0);
        const uint32_t bal1 = __ballot_sync(0xffffffffu, m1);
        const uint32_t below = (1u << lane) - 1u;
        if (m0) {
          gkey[f0 + __popc(bal0 & below)] = k & kKeyMask;
          gidx[f0 + __popc(bal0 & below)] = j;
        }
        if (m1) {
          gkey[kGather + f1 + __popc(bal1 & below)] = k & kKeyMask;
          gidx[kGather + f1 + __popc(bal1 & below)] = j;
        }
        f0 += __popc(bal0);
        f1 += __popc(bal1);
      }
      __syncwarp();
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t == 1 && pre[1] == pre[0] && rest[1] == rest[0]) {
        // the median of an odd n: one boundary
      } else if (size[t] <= kGather) {
        const int lt = t == 1 && pre[1] == pre[0] ? 0 : t;
        const uint32_t* lk = gkey + lt * kGather;
        const int* lj = gidx + lt * kGather;
        // the one of rank rest[t] among them
        bool mine = false;
        for (uint32_t i = lane; i < size[t]; i += 32) {
          uint32_t r = 0;
          for (uint32_t q = 0; q < size[t]; ++q)
            r += before(lk[q], lj[q], lk[i], lj[i]);
          if (r == rest[t]) {
            mine = true;
            bk = lk[i];
            bi = lj[i];
          }
        }
        const int src = __ffs(__ballot_sync(0xffffffffu, mine)) - 1;
        bk = __shfl_sync(0xffffffffu, bk, src);
        bi = __shfl_sync(0xffffffffu, bi, src);
      } else {
        uint32_t need = rest[t];
        for (int j0 = 0; j0 < n; j0 += 32) {
          const int j = j0 + lane;
          const bool m = j < n && (key(j, warp) & dmask) == pre[t];
          uint32_t bal = __ballot_sync(0xffffffffu, m);
          const uint32_t cnt = __popc(bal);
          if (need < cnt) {
            for (uint32_t q = 0; q < need; ++q) bal &= bal - 1;
            bi = j0 + __ffs(bal) - 1;
            break;
          }
          need -= cnt;
        }
        bk = pre[t] & kKeyMask;
      }
      if (lane == 0) {
        bkey_s[t][warp] = bk;
        bidx_s[t][warp] = bi;
      }
    }
  }
  __syncthreads();

  // the raw key (-0 kept) of value j of this thread's coordinate
  auto raw_key = [&](int j) -> uint32_t {
    return kStaged ? keys[j * kKeyStride + c]
                   : order_key(to_f32(d[(int64_t)j * plane_elems + c0 + c]));
  };
  const int64_t e = c0 + c;
  if (hi - lo <= 2) {
    // the median (or a trimmed mean of one or two): the boundary values,
    // in sorted order; a mean's sum starts at +0 (``from_zero``)
    if (tid >= kTile) return;
    float red = key_value(raw_key(bidx_s[0][c]));
    if (from_zero) red = 0.0f + red;
    if (hi - lo == 2) red = (red + key_value(raw_key(bidx_s[1][c]))) / 2.0f;
    out[e] = from_f32<T>(__fsub_rn(to_f32(x[e]), __fmul_rn(theta_eta, red)));
    return;
  }

  // 3. sum, per coordinate in DPU order, the values from (key, DPU) of
  // rank lo to that of rank hi - 1: thread (run, c) sums its run of DPUs,
  // and the 32 runs' sums are added in order, every sum from +0 (only a
  // trimmed mean of three or more values comes here)
  // (key, DPU) as one number: the stable order is its order
  const uint64_t first = (uint64_t)bkey_s[0][c] << 32 | (uint32_t)bidx_s[0][c];
  const uint64_t last = (uint64_t)bkey_s[1][c] << 32 | (uint32_t)bidx_s[1][c];
  const int j_begin = (int)((int64_t)n * run / kRuns);
  const int j_end = (int)((int64_t)n * (run + 1) / kRuns);
  float sum = 0.0f;
#pragma unroll 4
  for (int j = j_begin; j < j_end; ++j) {
    const uint32_t raw = raw_key(j);
    const uint64_t kj =
        (uint64_t)(tie_zero(raw) & kKeyMask) << 32 | (uint32_t)j;
    if (first <= kj && kj <= last) sum += key_value(raw);
  }
  psum_s[run][c] = sum;
  __syncthreads();
  if (tid >= kTile) return;
  sum = 0.0f;
#pragma unroll 8
  for (int r = 0; r < kRuns; ++r) sum += psum_s[r][c];
  const float red = sum / (float)(hi - lo);
  out[e] = from_f32<T>(__fsub_rn(to_f32(x[e]), __fmul_rn(theta_eta, red)));
}

template <typename T, int kBlocks>
int run_select(const void* x, const void* d, void* out, int64_t plane_elems,
               int n, int lo, int hi, bool from_zero, float theta_eta,
               void* stream) {
  const int64_t blocks = plane_elems / kTile;  // plane_elems % 8192 == 0
  const size_t staged =
      kHistBytes + (size_t)n * kKeyStride * sizeof(uint32_t);
  int dev = 0, smem_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_optin,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // the kernel's static shared arrays take their part of the budget
  cudaFuncAttributes attr;
  cudaError_t e =
      cudaFuncGetAttributes(&attr, robust_select_kernel<T, true, kBlocks>);
  if (e != cudaSuccess) return (int)e;
  const bool fits = staged + attr.sharedSizeBytes <= (size_t)smem_optin;
  const size_t bytes = fits ? staged : kHistBytes;
  auto kernel = fits ? robust_select_kernel<T, true, kBlocks>
                     : robust_select_kernel<T, false, kBlocks>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, kSelThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)d, (T*)out, plane_elems, n, lo, hi, from_zero,
      theta_eta);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* d, void* out, int64_t plane_elems,
           int n, int lo, int hi, int median, float theta_eta,
           int network_max, void* stream) {
  if (n < 1 || !(0 <= lo && lo < hi && hi <= n))
    return (int)cudaErrorInvalidValue;
  // a trimmed mean of two or more values sums from +0 (torch.mean's
  // reduction, so a kept set of zeros gives +0); a median, or a trimmed
  // mean of one value, is read (its zero keeps its sign)
  const bool z = !median && hi - lo >= 2;
  if (n > network_max || n > 64)
    return n <= kSmallStack
               ? run_select<T, 3>(x, d, out, plane_elems, n, lo, hi, z,
                                  theta_eta, stream)
               : run_select<T, 2>(x, d, out, plane_elems, n, lo, hi, z,
                                  theta_eta, stream);
  if (n <= 8)
    return run<T, 8>(x, d, out, plane_elems, n, lo, hi, z, theta_eta,
                     stream);
  if (n <= 16)
    return run<T, 16>(x, d, out, plane_elems, n, lo, hi, z, theta_eta,
                      stream);
  if (n <= 32)
    return run<T, 32>(x, d, out, plane_elems, n, lo, hi, z, theta_eta,
                      stream);
  return run<T, 64>(x, d, out, plane_elems, n, lo, hi, z, theta_eta, stream);
}

}  // namespace

extern "C" {

// plane_elems = R * 1024; x, d, out contiguous.  The reduce averages the
// sorted positions [lo, hi) of each coordinate's n values: [k, n - k) for
// the k-trimmed mean, the middle one or two for the median (``median``
// nonzero).  n >= 1.
// Stacks of at most network_max DPUs (and at most 64) take the register
// network, larger ones the radix select.  Returns the CUDA error code of
// the launch (0 = launched).
int robust_aggregate_f32(const void* x, const void* d, void* out,
                         int64_t plane_elems, int n, int lo, int hi,
                         int median, float theta_eta, int network_max,
                         void* stream) {
  return launch<float>(x, d, out, plane_elems, n, lo, hi, median, theta_eta,
                       network_max, stream);
}

int robust_aggregate_bf16(const void* x, const void* d, void* out,
                          int64_t plane_elems, int n, int lo, int hi,
                          int median, float theta_eta, int network_max,
                          void* stream) {
  return launch<__nv_bfloat16>(x, d, out, plane_elems, n, lo, hi, median,
                               theta_eta, network_max, stream);
}

const char* robust_aggregate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
