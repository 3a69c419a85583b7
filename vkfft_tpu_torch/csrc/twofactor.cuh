// The two-factor DFT's contract and plan checks, shared by the kernels of
// the in-place walk (inplace.cuh: fft_twofactor.cu, fft_conv_inv.cu,
// fft_lines.cu, fft_conv.cu and the kernels on two_factor_passes), built
// for sm_90a.
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
// factors are chosen by the host (cuda_kernels.twofactor_split and the
// walk kernels' layout rules), each a Stockham run of stockham.cuh's
// recurrence with any prime up to 127, or the empty run of a length-1
// factor.
#pragma once

#include "stockham.cuh"

namespace vkfft {

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

}  // namespace vkfft
