// The per-coordinate robust reduce of the robust_aggregate kernel: sort a
// thread's n values (n <= NMAX, NMAX a compile-time power of two) with
// Batcher's odd-even merge network, fully unrolled so the values stay in
// registers, then average a contiguous range of sorted positions.
//
// Ordering follows torch.sort and jnp.sort: NaN sorts above +inf.  fminf
// and fmaxf drop NaN, so NaNs never enter the network: each is counted
// and replaced by +inf, as are the pad slots n..NMAX-1.  The extra +infs
// all sort to the top, so sorted positions below n - nan_count hold the
// real non-NaN values in order, and the positions from there to n - 1
// are the NaNs.
//
// Runtime n, lo and hi select by predicate over the unrolled positions;
// no array is ever indexed by a runtime value, which would move it to
// local memory.
#pragma once

#include <math.h>

namespace robust {

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

__device__ __forceinline__ void cas(float& a, float& b) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// Batcher's odd-even merge of v[LO, LO + N) whose two halves are sorted,
// on the subsequence of stride R (call with R = 1).
template <int LO, int N, int R>
struct Merge {
  static __device__ __forceinline__ void run(float* v) {
    constexpr int M = 2 * R;
    if constexpr (M < N) {
      Merge<LO, N, M>::run(v);        // even subsequence
      Merge<LO + R, N, M>::run(v);    // odd subsequence
#pragma unroll
      for (int i = LO + R; i + R < LO + N; i += M) cas(v[i], v[i + R]);
    } else {
      cas(v[LO], v[LO + R]);
    }
  }
};

// Batcher's odd-even merge sort of v[LO, LO + N), N a power of two.
template <int LO, int N>
struct Sort {
  static __device__ __forceinline__ void run(float* v) {
    if constexpr (N > 1) {
      Sort<LO, N / 2>::run(v);
      Sort<LO + N / 2, N / 2>::run(v);
      Merge<LO, N, 1>::run(v);
    }
  }
};

// Sorts v[0, n) in place (slots n..NMAX-1 are overwritten) and returns
// the mean of sorted positions [lo, hi), summed in ascending order in f32
// and divided by hi - lo.  0 <= lo < hi <= n.
template <int NMAX>
__device__ __forceinline__ float reduce(float (&v)[NMAX], int n, int lo,
                                        int hi) {
  int nan_count = 0;
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    const bool pad = i >= n;
    const bool is_nan = !pad && isnan(v[i]);
    nan_count += is_nan ? 1 : 0;
    if (pad || is_nan) v[i] = pos_inf();
  }
  Sort<0, NMAX>::run(v);
  const int first_nan = n - nan_count;
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    const float vi = i >= first_nan ? quiet_nan() : v[i];
    if (i == lo) {
      sum = vi;
    } else if (i > lo && i < hi) {
      sum += vi;
    }
  }
  return sum / (float)(hi - lo);
}

}  // namespace robust
