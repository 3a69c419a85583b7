// Two-factor inverse DFT of one line in shared memory, for fft_conv_inv.cu
// (replaces vkfft_tpu/ops/pallas_engine.py:4421 _conv_inv_kernel), built
// for sm_90a; fft_twofactor.cu (:897 _fft_kernel_v2) shares its plan
// checks and runs the same DFT on one copy of the line, in place.
//
// A line of n = n1 * n2 <= 16384 points is the (n2, n1) row-major matrix
// A[j2][j1] = x[j2*n1 + j1].  With output index k = k1*n2 + k2:
//     X[k1*n2 + k2] = sum_j1 w_n1^(j1*k1) w_n^(j1*k2) sum_j2 w_n2^(j2*k2) A[j2][j1]
// so the forward runs the n2-point DFT down every column, multiplies the
// twiddle w_n^(k2*j1), and runs the n1-point DFT along every row, which
// leaves X in the "swapped" digit order [k2][k1] (position k2*n1 + k1);
// the natural order is its transpose, written by the store.  The inverse
// mirrors it: rows (k1 -> j1), the conjugate twiddle, columns (k2 -> j2).
// This is the JAX package's v2 contract (pallas_engine.py:830-852); the
// factors are chosen by the host (cuda_kernels.twofactor_split) and each is
// a Stockham run of stockham.cuh, with any prime up to 127.
//
// Shared memory: the whole line ("home", n float2, 128 KB at n = 16384)
// plus two scratch tiles of S = min(n, kTileMax) points.  A column pass
// runs T1 = S/n2 columns at a time in the scratch tiles (strided layout);
// a row pass runs T2 = S/n1 rows at a time, ping-ponging between their
// place in home and one scratch tile.  Device memory sees one read and one
// write of the line; the twiddle (with the caller's scale folded in) is a
// host table in fp64 cast to fp32, read through the read-only cache.
#pragma once

#include "stockham.cuh"

namespace vkfft {

constexpr int kTileMax = 4096;
constexpr int kTwoFactorMaxN = 16384;

// A factor's plan: a Stockham plan, or the empty plan of a length-1 factor
// (n = 1, no stages) that a prime line length leaves.
inline bool subplan_from_ints(const int* v, Plan* p) {
  if (v[0] == 1 && v[1] == 0) {
    p->n = 1;
    p->n_stages = 0;
    p->inverse = v[2];
    return true;
  }
  return plan_from_ints(v, p);
}

// Checks the two plans of a launch; returns the scratch tile size S, or 0.
inline int twofactor_tile(const Plan& p1, const Plan& p2) {
  const int n = p1.n * p2.n;
  if (n < 2 || n > kTwoFactorMaxN || p1.n < p2.n || p1.inverse != p2.inverse)
    return 0;
  const int s = n < kTileMax ? n : kTileMax;
  return p1.n <= s ? s : 0;
}

inline size_t twofactor_smem(int n, int s) {
  return (size_t)(n + 2 * s) * sizeof(float2);
}

__device__ __forceinline__ float2 ld2(const float* re, const float* im,
                                      long long g) {
  return make_float2(re[g], im[g]);
}

// Inverse of the line at `base`: in swapped order (SWAPPED) or natural
// order, times `spec` (swapped order, when not null) on the read; out in
// natural order plus the constant `dc` on the write.
template <bool SWAPPED>
__device__ void twofactor_inverse(const float* xr, const float* xi, float* yr,
                                  float* yi, long long base, const Plan& p1,
                                  const Plan& p2, const float2* t1,
                                  const float2* t2, const float2* tw,
                                  const float2* spec, float2 dc, int s,
                                  float2* home, float2* s0, float2* s1) {
  const int n1 = p1.n, n2 = p2.n, n = n1 * n2;
  // home[k2*n1 + k1] = X[k1*n2 + k2]
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    int idx = t;
    if (!SWAPPED) {
      const int k1 = t / n2;
      idx = (t - k1 * n2) * n1 + k1;
    }
    float2 v = ld2(xr, xi, base + t);
    if (spec != nullptr) v = cmul(v, __ldg(&spec[idx]));
    home[idx] = v;
  }
  __syncthreads();
  const int T2 = min(n2, s / n1);
  for (int r0 = 0; r0 < n2; r0 += T2) {
    const int rows = min(T2, n2 - r0);
    float2* row = home + r0 * n1;
    const float2* res = run_stages<false>(row, s0, rows, n1, 1, p1, t1);
    for (int t = threadIdx.x; t < rows * n1; t += blockDim.x)
      row[t] = cmul(res[t], __ldg(&tw[r0 * n1 + t]));
    __syncthreads();
  }
  const int T1 = min(n1, s / n2);
  for (int c0 = 0; c0 < n1; c0 += T1) {
    const int w = min(T1, n1 - c0);
    for (int t = threadIdx.x; t < n2 * T1; t += blockDim.x) {
      const int k2 = t / T1;
      const int c = t - k2 * T1;
      s0[t] = c < w ? home[k2 * n1 + c0 + c] : make_float2(0.f, 0.f);
    }
    __syncthreads();
    const float2* res = run_stages<true>(s0, s1, T1, 1, T1, p2, t2);
    for (int t = threadIdx.x; t < n2 * w; t += blockDim.x) {
      const int j2 = t / w;
      const int c = t - j2 * w;
      const float2 v = cadd(res[j2 * T1 + c], dc);
      const long long g = base + (long long)j2 * n1 + c0 + c;
      yr[g] = v.x;
      yi[g] = v.y;
    }
    __syncthreads();
  }
}

}  // namespace vkfft
