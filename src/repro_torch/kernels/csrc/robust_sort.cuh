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
// Zeros.  fminf/fmaxf order -0 and +0 as they please, and Batcher's
// network is not stable, so the zero the network leaves at a sorted
// position is not the one the stable order (value, then DPU index) puts
// there.  That matters only where a value is read rather than summed from
// +0 (a median, or a trimmed mean of one value): there the reduce records,
// before the sort, which DPUs hold a zero and which of those a -0 (one bit
// per DPU) and counts the negatives c.  The zeros fill sorted positions
// [c, c + zeros), and a zero read at position p takes the sign of the
// (p - c)-th zero in DPU order: the stable order's.  A trimmed mean of
// two or more values sums from +0, as torch.mean does, so its zeros'
// signs never show and it keeps no record.
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

// Bit masks with one bit per DPU slot of a network of NMAX values.
template <int NMAX>
struct MaskOf {
  using type = unsigned int;
};
template <>
struct MaskOf<64> {
  using type = unsigned long long;
};

// The position of the (r+1)-th set bit of m (r counts from 0), by halving
// with population counts: six steps, no loop.
__device__ __forceinline__ int nth_set_bit(unsigned long long m, int r) {
  int pos = 0;
#pragma unroll
  for (int w = 32; w >= 1; w >>= 1) {
    const unsigned long long low = m & ((1ull << w) - 1ull);
    const int c = __popcll(low);
    if (r >= c) {
      r -= c;
      m >>= w;
      pos += w;
    } else {
      m = low;
    }
  }
  return pos;
}

// Sorts v[0, n) in place (slots n..NMAX-1 are overwritten) and returns
// the mean of sorted positions [lo, hi) of the stable order, divided by
// hi - lo.  0 <= lo < hi <= n.  ``from_zero``: a mean (two or more
// values), summed in ascending order from +0 as torch.mean's reduction
// does, so a sum of zeros is +0; otherwise (hi - lo <= 2) the values at
// lo and lo + 1 are read, each zero with the stable order's sign, and
// added (-0 + -0 is -0).
template <int NMAX>
__device__ __forceinline__ float reduce(float (&v)[NMAX], int n, int lo,
                                        int hi, bool from_zero) {
  using Mask = typename MaskOf<NMAX>::type;
  int nan_count = 0, neg_count = 0;
  Mask zeros = 0, neg_zeros = 0;       // bit i: DPU i sent a zero, a -0
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    const bool pad = i >= n;
    const bool is_nan = !pad && isnan(v[i]);
    nan_count += is_nan ? 1 : 0;
    if (!from_zero && !pad) {
      neg_count += v[i] < 0.0f ? 1 : 0;
      if (v[i] == 0.0f) {
        zeros |= (Mask)1 << i;
        if (__float_as_uint(v[i]) >> 31) neg_zeros |= (Mask)1 << i;
      }
    }
    if (pad || is_nan) v[i] = pos_inf();
  }
  Sort<0, NMAX>::run(v);
  const int first_nan = n - nan_count;
  if (from_zero) {
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      const float vi = i >= first_nan ? quiet_nan() : v[i];
      if (i >= lo && i < hi) sum += vi;
    }
    return sum / (float)(hi - lo);
  }
  float t[2] = {0.0f, 0.0f};            // the values at lo and lo + 1
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    const float vi = i >= first_nan ? quiet_nan() : v[i];
    if (i == lo) t[0] = vi;
    if (i == lo + 1) t[1] = vi;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (t[j] == 0.0f) {                 // the (lo + j - c)-th zero's sign
      const int at = nth_set_bit(zeros, lo + j - neg_count);
      t[j] = ((unsigned long long)neg_zeros >> at) & 1ull ? -0.0f : 0.0f;
    }
  }
  const float sum = hi - lo == 2 ? t[0] + t[1] : t[0];
  return sum / (float)(hi - lo);
}

}  // namespace robust
