// The real transforms' pieces of the in-place walk (inplace.cuh), shared
// by fft_r2c.cu, fft_r2c_pair.cu and (through dct_walk.cuh) the R2R
// kernels, built for sm_90a: the untangle of an even-length real line (n =
// 2m points read as m complex pairs z[j] = x[2j] + i x[2j+1]; the
// reference's even-n decomposition, vkFFT_Plan_R2C.h:30, appendR2C_write
// vkFFT_R2C.h:450) as the walk runs it, each bin read where the walk's
// passes left it:
//     E[k] = (Z[k] + conj Z[m-k]) / 2,   O[k] = -i (Z[k] - conj Z[m-k]) / 2,
//     X[k] = E[k] + w^k O[k],   X[m-k] = conj(E[k] - w^k O[k]),
// w = e^{-2 pi i / n}; a "packed" row holds the real X[0] and X[m] as
// (X[0], X[m]) in slot 0.
#pragma once

#include "inplace.cuh"

namespace vkfft {
namespace walk {

// A value the compiler must take as new where it is used: each phase of
// the inverse builds its own map, so no predicate of the map's divisors
// lives from the read into the passes (held, one spilled).
__device__ __forceinline__ int fresh(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// w_n^k = e^{-2 pi i k / n} from the untangle's two root tables.
__device__ __forceinline__ float2 root(const float2* ulo, int k) {
  return cmul(ulo[kTwLo + (k >> 6)], ulo[k & (kTwLo - 1)]);
}

// Packed X -> Z on the block's nl lines of m points, point k of line q at
// position(q * m + k, mp), one thread a pair (k, m - k), times `scale`
// (the inverse untangle; slot 0 holds the real X[0] and X[m]).
// Ends on a barrier.
__device__ void untangle_inverse(float2* home, int nl, int m, const Map& mp,
                                 const float2* ulo, float scale) {
  const int per = m / 2 + 1;
  const Div dper = make_div(per);
  const float h = 0.5f * scale;
  for (int t = threadIdx.x; t < nl * per; t += blockDim.x) {
    const int q = quot(t, dper);
    const int k = t - q * per;
    const int at = position(q * m + k, mp);
    if (k == 0) {
      const float2 v = home[at];
      home[at] = make_float2(h * (v.x + v.y), h * (v.x - v.y));
    } else if (2 * k == m) {
      const float2 v = home[at];
      home[at] = make_float2(scale * v.x, -scale * v.y);
    } else {
      const int bt = position(q * m + m - k, mp);
      const float2 a = home[at], b = home[bt];
      const float2 E = make_float2(h * (a.x + b.x), h * (a.y - b.y));
      const float2 D = make_float2(h * (a.x - b.x), h * (a.y + b.y));
      const float2 wk = root(ulo, k);
      // O = conj(w^k) D;  Z[k] = E + i O,  Z[m-k] = conj(E) + i conj(O)
      const float2 O = cmul(make_float2(wk.x, -wk.y), D);
      home[at] = make_float2(E.x - O.y, E.y + O.x);
      home[bt] = make_float2(E.x + O.y, O.x - E.y);
    }
  }
  __syncthreads();
}

// Bin c (0 <= c <= m) of line q's half spectrum from Z[k], Z[m - k], k =
// min(c, m - c), at their places at(q, k) (the forward untangle,
// read where it is stored): E = (Z[k] + conj Z[m-k]) / 2, O = -i (Z[k] -
// conj Z[m-k]) / 2, X[k] = E + w^k O, X[m-k] = conj(E - w^k O).  The real
// bins: (X[0], 0) and (X[m], 0), or packed (X[0], X[m]) at c = 0.
template <class At>
__device__ __forceinline__ float2 half_bin_at(const float2* home, const At& at,
                                              const float2* ulo, int m, int q,
                                              int c, bool packed) {
  const int k = min(c, m - c);
  const float2 a = home[at(q, k)];
  const float2 b = home[at(q, k == 0 ? 0 : m - k)];
  if (k == 0)
    return packed ? make_float2(a.x + a.y, a.x - a.y)
                  : make_float2(c == 0 ? a.x + a.y : a.x - a.y, 0.f);
  const float2 E = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
  const float2 wO = cmul(root(ulo, k),
                         make_float2(0.5f * (a.y + b.y), 0.5f * (b.x - a.x)));
  return c == k ? make_float2(E.x + wO.x, E.y + wO.y)
                : make_float2(E.x - wO.x, wO.y - E.y);
}

// Point k of line q at position(q * m + k, mp).
struct LineAt {
  const Map& mp;
  int m;
  __device__ __forceinline__ int operator()(int q, int k) const {
    return position(q * m + k, mp);
  }
};

__device__ __forceinline__ float2 half_bin(const float2* home, const Map& mp,
                                           const float2* ulo, int m, int q,
                                           int c, bool packed) {
  return half_bin_at(home, LineAt{mp, m}, ulo, m, q, c, packed);
}

}  // namespace walk
}  // namespace vkfft
