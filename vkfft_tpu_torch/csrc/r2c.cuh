// Real-transform pieces of the Stockham kernels (r2r.cuh's, fft_dct1.cu's
// untangle), built for sm_90a on top of stockham.cuh; the in-place walk's
// kernels take real_walk.cuh's form of the same untangle.
//
// An even-length real line x of n = 2m points is read as m complex values
// z[j] = x[2j] + i x[2j+1] (one float2 per pair, straight from memory), runs
// the m-point stages, and is untangled into its half spectrum (the
// reference's even-n decomposition, vkFFT_Plan_R2C.h:30, appendR2C_write
// vkFFT_R2C.h:450):
//     E[k] = (Z[k] + conj Z[m-k]) / 2,   O[k] = -i (Z[k] - conj Z[m-k]) / 2,
//     X[k] = E[k] + w^k O[k],   X[m-k] = conj(E[k] - w^k O[k]),
// with w = e^{-2 pi i / n}.  One thread takes the pair (k, m-k), so the
// untangle runs in place in shared memory: the reversal Z[m-k] is a free
// index here, where the TPU kernel has to run a second pipeline for it.
//
// In shared memory a spectrum row is "packed": m float2, bins 1..m-1 in
// place and slot 0 holding (X[0], X[m]), the two bins that are real.  The
// inverse runs the same steps backwards from that layout; it reads only
// the real parts of X[0] and X[m], so the imaginary parts a caller stores
// there are ignored, as numpy's irfft ignores them.
#pragma once

#include "stockham.cuh"

namespace vkfft {

// Z -> packed X on `lines` rows of m float2 at row stride m (forward), or
// packed X -> Z (inverse).  w[k] = e^{-2 pi i k / n} for k <= m/2.
template <bool INVERSE>
__device__ void untangle(float2* s, int lines, int m, const float2* w) {
  const int per = m / 2 + 1;   // pairs (k, m-k) with k = 0..m/2
  const int total = lines * per;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int q = t / per;
    const int k = t - q * per;
    float2* row = s + q * m;
    if (k == 0) {
      const float2 v = row[0];
      row[0] = INVERSE ? make_float2(0.5f * (v.x + v.y), 0.5f * (v.x - v.y))
                       : make_float2(v.x + v.y, v.x - v.y);
    } else if (2 * k == m) {
      const float2 v = row[k];
      row[k] = make_float2(v.x, -v.y);
    } else {
      const float2 a = row[k], b = row[m - k];
      const float2 E = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
      const float2 D = make_float2(0.5f * (a.x - b.x), 0.5f * (a.y + b.y));
      const float2 wk = __ldg(&w[k]);
      if (INVERSE) {
        // O = conj(w^k) D;  Z[k] = E + i O,  Z[m-k] = conj(E) + i conj(O)
        const float2 O = cmul(make_float2(wk.x, -wk.y), D);
        row[k] = make_float2(E.x - O.y, E.y + O.x);
        row[m - k] = make_float2(E.x + O.y, O.x - E.y);
      } else {
        // O = -i D;  X[k] = E + w^k O,  X[m-k] = conj(E - w^k O)
        const float2 wO = cmul(wk, make_float2(D.y, -D.x));
        row[k] = cadd(E, wO);
        row[m - k] = make_float2(E.x - wO.x, wO.y - E.y);
      }
    }
  }
}

}  // namespace vkfft
