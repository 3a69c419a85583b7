// The Stockham plan, the complex helpers and the butterflies under the
// port's in-place walk (inplace.cuh), built for sm_90a; fft_dd.cu runs the
// same recurrence on a plan of its own.
//
// Stage recurrence (self-sorting, natural order in and out; the same one
// the JAX package runs, vkfft_tpu/ops/jnp_engine.py): with L the product of
// the radices already done and M the remaining length, a radix-r stage with
// Mp = M / r maps
//     A'[(i*L + l)*Mp + m] = w_M^(i*m) * sum_j w_r^(i*j) * A[l*r*Mp + j*Mp + m]
// for i, j < r, l < L, m < Mp: a butterfly (l, m) is r reads, an r-point
// DFT (Dft<R> below, or a prime's sum over its roots) and r twiddled
// writes.
//
// All constants come from one host table, computed in fp64 and cast to
// the planes' type (no __sinf/__cosf): per stage an (r, Mp) twiddle block
// at tw_off, with the caller's scale folded into stage 0, and for radices
// other than 2/4/8 the r roots w_r^k at dft_off.
//
// The helpers and butterflies take a complex type C, float2 (fp32) or
// double2 (fp64): one source, an instantiation each, every literal and
// fma of the real type Real<C>.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vkfft {

constexpr int kMaxStages = 16;
constexpr int kMaxN = 8192;
// Largest dynamic shared memory a block may opt into on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;

struct Plan {
  int n;
  int n_stages;
  int inverse;
  int radix[kMaxStages];
  int tw_off[kMaxStages];
  int dft_off[kMaxStages];
};

// The host passes the plan as ints: n, n_stages, inverse, then kMaxStages
// slots each of radix, tw_off and dft_off.  Returns false when it is not a
// plan of a length the kernels take.
inline bool plan_from_ints(const int* v, Plan* p) {
  p->n = v[0];
  p->n_stages = v[1];
  p->inverse = v[2];
  if (p->n < 2 || p->n > kMaxN || p->n_stages < 1 || p->n_stages > kMaxStages)
    return false;
  long long prod = 1;
  for (int s = 0; s < kMaxStages; ++s) {
    p->radix[s] = v[3 + s];
    p->tw_off[s] = v[3 + kMaxStages + s];
    p->dft_off[s] = v[3 + 2 * kMaxStages + s];
    if (s < p->n_stages) {
      if (p->radix[s] < 2 || p->tw_off[s] < 0) return false;
      bool table_dft = !(p->radix[s] == 2 || p->radix[s] == 4 || p->radix[s] == 8);
      if (table_dft && p->dft_off[s] < 0) return false;
      prod *= p->radix[s];
    }
  }
  return prod == p->n;
}

// The complex types of the walk and their real parts.
template <class C>
struct Cx;
template <>
struct Cx<float2> {
  using R = float;
};
template <>
struct Cx<double2> {
  using R = double;
};
template <class C>
using Real = typename Cx<C>::R;

// (x, y) as a C.
template <class C>
__device__ __forceinline__ C cx(Real<C> x, Real<C> y);
template <>
__device__ __forceinline__ float2 cx<float2>(float x, float y) {
  return make_float2(x, y);
}
template <>
__device__ __forceinline__ double2 cx<double2>(double x, double y) {
  return make_double2(x, y);
}

// a * b + c, one rounding.
__device__ __forceinline__ float madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return fma(a, b, c);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// a * (-i) for the forward transform, a * (+i) for the inverse.
__device__ __forceinline__ float2 rot(float2 a, int inverse) {
  return inverse ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 rot(double2 a, int inverse) {
  return inverse ? make_double2(-a.y, a.x) : make_double2(a.y, -a.x);
}

template <int R>
struct Dft;

template <>
struct Dft<2> {
  template <class C>
  __device__ __forceinline__ static void run(C (&v)[2], int, const C*) {
    C a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  }
};

template <>
struct Dft<4> {
  template <class C>
  __device__ __forceinline__ static void run(C (&v)[4], int inverse, const C*) {
    C t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    C t2 = cadd(v[1], v[3]), t3 = rot(csub(v[1], v[3]), inverse);
    v[0] = cadd(t0, t2);
    v[1] = cadd(t1, t3);
    v[2] = csub(t0, t2);
    v[3] = csub(t1, t3);
  }
};

template <>
struct Dft<8> {
  // Radix-2 split into two 4-point DFTs: X[k] = E[k] + w8^k O[k],
  // X[k+4] = E[k] - w8^k O[k].
  template <class C>
  __device__ __forceinline__ static void run(C (&v)[8], int inverse, const C*) {
    C e[4] = {v[0], v[2], v[4], v[6]};
    C o[4] = {v[1], v[3], v[5], v[7]};
    Dft<4>::run(e, inverse, (const C*)nullptr);
    Dft<4>::run(o, inverse, (const C*)nullptr);
    const Real<C> c = Real<C>(0.70710678118654752440);
    const Real<C> s = inverse ? c : -c;
    o[1] = cmul(o[1], cx<C>(c, s));
    o[2] = rot(o[2], inverse);
    o[3] = cmul(o[3], cx<C>(-c, s));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = cadd(e[k], o[k]);
      v[k + 4] = csub(e[k], o[k]);
    }
  }
};

// Small odd radices: the r-point DFT unrolled, roots w_r^k from the table.
template <int R>
struct Dft {
  template <class C>
  __device__ __forceinline__ static void run(C (&v)[R], int, const C* w) {
    C wk[R];
#pragma unroll
    for (int k = 0; k < R; ++k) wk[k] = __ldg(&w[k]);
    C out[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      C acc = v[0];
#pragma unroll
      for (int j = 1; j < R; ++j) {
        C t = wk[(i * j) % R];
        acc.x = madd(v[j].x, t.x, madd(-v[j].y, t.y, acc.x));
        acc.y = madd(v[j].x, t.y, madd(v[j].y, t.x, acc.y));
      }
      out[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = out[i];
  }
};

}  // namespace vkfft
