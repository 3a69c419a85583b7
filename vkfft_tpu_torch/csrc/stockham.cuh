// Shared-memory Stockham FFT stages of the port's kernels (run_stages and
// the tile copies under fft_conv_pair.cu's 2-D mode; the plan, the
// butterflies and the tables also under the in-place walk of inplace.cuh
// and fft_dd.cu), built for sm_90a.
//
// A block holds `lines` complex sequences of length n in shared memory as
// float2 (re, im).  Element k of sequence q sits at smem[q*qs + k*es]:
//   lines:       one sequence per image line,  qs = n, es = 1
//   strided:     one sequence per column,      qs = 1, es = ts
// Each stage reads one buffer and writes the other (ping-pong), so a block
// needs 2 * lines * n * 8 bytes of shared memory.
//
// Stage recurrence (self-sorting, natural order in and out; the same one
// the JAX package runs, vkfft_tpu/ops/jnp_engine.py): with L the product of
// the radices already done and M the remaining length, a radix-r stage with
// Mp = M / r maps
//     A'[(i*L + l)*Mp + m] = w_M^(i*m) * sum_j w_r^(i*j) * A[l*r*Mp + j*Mp + m]
// for i, j < r, l < L, m < Mp.  For radices 2..8 one thread computes one
// butterfly (l, m): r reads, an r-point DFT in registers, r twiddled
// writes; for larger primes one thread computes one output i of it.
//
// All constants come from one host table, computed in fp64 and cast to
// fp32 (no __sinf/__cosf): per stage an (r, Mp) twiddle block at tw_off,
// with the caller's scale folded into stage 0, and for radices other than
// 2/4/8 the r roots w_r^k at dft_off.
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

template <int R>
struct Dft;

template <>
struct Dft<2> {
  __device__ __forceinline__ static void run(float2 (&v)[2], int, const float2*) {
    float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  }
};

template <>
struct Dft<4> {
  __device__ __forceinline__ static void run(float2 (&v)[4], int inverse, const float2*) {
    float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    float2 t2 = cadd(v[1], v[3]), t3 = rot(csub(v[1], v[3]), inverse);
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
  __device__ __forceinline__ static void run(float2 (&v)[8], int inverse, const float2*) {
    float2 e[4] = {v[0], v[2], v[4], v[6]};
    float2 o[4] = {v[1], v[3], v[5], v[7]};
    Dft<4>::run(e, inverse, nullptr);
    Dft<4>::run(o, inverse, nullptr);
    const float c = 0.70710678118654752440f;
    const float s = inverse ? c : -c;
    o[1] = cmul(o[1], make_float2(c, s));
    o[2] = rot(o[2], inverse);
    o[3] = cmul(o[3], make_float2(-c, s));
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
  __device__ __forceinline__ static void run(float2 (&v)[R], int, const float2* w) {
    float2 wk[R];
#pragma unroll
    for (int k = 0; k < R; ++k) wk[k] = __ldg(&w[k]);
    float2 out[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float2 acc = v[0];
#pragma unroll
      for (int j = 1; j < R; ++j) {
        float2 t = wk[(i * j) % R];
        acc.x = fmaf(v[j].x, t.x, fmaf(-v[j].y, t.y, acc.x));
        acc.y = fmaf(v[j].x, t.y, fmaf(v[j].y, t.x, acc.y));
      }
      out[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = out[i];
  }
};

// Butterfly b of `lines * L * Mp` -> (q, l, m).  SEQ_FAST puts the sequence
// index fastest, so neighbouring threads touch neighbouring columns of the
// strided layout; otherwise m is fastest (neighbouring elements of a line).
template <bool SEQ_FAST>
__device__ __forceinline__ void split_index(int b, int lines, int L, int Mp,
                                            int& q, int& l, int& m) {
  if (SEQ_FAST) {
    q = b % lines;
    int t = b / lines;
    m = t % Mp;
    l = t / Mp;
  } else {
    m = b % Mp;
    int t = b / Mp;
    l = t % L;
    q = t / L;
  }
}

template <int R, bool SEQ_FAST>
__device__ void stage_fixed(const float2* src, float2* dst, int lines, int qs,
                            int es, int L, int Mp, const float2* tw,
                            const float2* w, int inverse) {
  const int total = lines * L * Mp;
  const int in_step = Mp * es;
  const int out_step = L * Mp * es;
  for (int b = threadIdx.x; b < total; b += blockDim.x) {
    int q, l, m;
    split_index<SEQ_FAST>(b, lines, L, Mp, q, l, m);
    const float2* s = src + q * qs + (l * R * Mp + m) * es;
    float2 v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = s[j * in_step];
    Dft<R>::run(v, inverse, w);
    float2* d = dst + q * qs + (l * Mp + m) * es;
#pragma unroll
    for (int i = 0; i < R; ++i) d[i * out_step] = cmul(v[i], __ldg(&tw[i * Mp + m]));
  }
}

// Any other radix (the primes 11..127): each output is an r-term sum read
// straight from shared memory, O(r^2) work per butterfly.  One thread
// takes one output i of one butterfly, the butterfly index fastest, so a
// stage of few butterflies (a prime factor that is a whole line, or most
// of it) still spreads over the block.
template <bool SEQ_FAST>
__device__ void stage_generic(const float2* src, float2* dst, int lines, int qs,
                              int es, int R, int L, int Mp, const float2* tw,
                              const float2* w) {
  const int total = lines * L * Mp;
  const int in_step = Mp * es;
  const int out_step = L * Mp * es;
  for (int t = threadIdx.x; t < total * R; t += blockDim.x) {
    const int i = t / total;
    const int b = t - i * total;
    int q, l, m;
    split_index<SEQ_FAST>(b, lines, L, Mp, q, l, m);
    const float2* s = src + q * qs + (l * R * Mp + m) * es;
    float2 acc = s[0];
    int k = 0;
    for (int j = 1; j < R; ++j) {
      k += i;
      if (k >= R) k -= R;
      const float2 x = s[j * in_step];
      const float2 c = __ldg(&w[k]);
      acc.x = fmaf(x.x, c.x, fmaf(-x.y, c.y, acc.x));
      acc.y = fmaf(x.x, c.y, fmaf(x.y, c.x, acc.y));
    }
    dst[q * qs + (l * Mp + m) * es + i * out_step] =
        cmul(acc, __ldg(&tw[i * Mp + m]));
  }
}

// Device memory <-> shared memory for a tile of `rows` runs of `width`
// points, run k starting at float offset base + k * stride of both planes,
// of which the first `valid` points are real: smem[k * width + c] holds
// point c of run k (load_tile zero-fills c >= valid).  When every offset
// is a multiple of 4 floats and the planes are 16-byte aligned, each
// thread moves float4s (4 points of each plane per access) and the loop is
// unrolled, so more reads are in flight per thread; otherwise it moves
// single floats.  Every thread of the block must call them.
__device__ __forceinline__ bool vec4_ok(const float* a, const float* b,
                                        long long base, long long stride,
                                        int width, int valid) {
  return ((width | valid) & 3) == 0 && ((base | stride) & 3) == 0 &&
         (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
}

__device__ __forceinline__ void load_tile(const float* xr, const float* xi,
                                          long long base, long long stride,
                                          int rows, int width, int valid,
                                          float2* smem) {
  if (vec4_ok(xr, xi, base, stride, width, valid)) {
    const int w4 = width >> 2;
    const int total = rows * w4;
#pragma unroll 4
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int k = t / w4;
      const int c = (t - k * w4) << 2;
      float4 r = make_float4(0.f, 0.f, 0.f, 0.f), i = r;
      if (c < valid) {
        const long long g = base + k * stride + c;
        r = *reinterpret_cast<const float4*>(xr + g);
        i = *reinterpret_cast<const float4*>(xi + g);
      }
      float2* d = smem + k * width + c;
      d[0] = make_float2(r.x, i.x);
      d[1] = make_float2(r.y, i.y);
      d[2] = make_float2(r.z, i.z);
      d[3] = make_float2(r.w, i.w);
    }
    return;
  }
  const int total = rows * width;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int k = t / width;
    const int c = t - k * width;
    float2 v = make_float2(0.f, 0.f);
    if (c < valid) {
      const long long g = base + k * stride + c;
      v = make_float2(xr[g], xi[g]);
    }
    smem[t] = v;
  }
}

__device__ __forceinline__ void store_tile(const float2* smem, float* yr,
                                           float* yi, long long base,
                                           long long stride, int rows,
                                           int width, int valid) {
  if (vec4_ok(yr, yi, base, stride, width, valid)) {
    const int w4 = width >> 2;
    const int total = rows * w4;
#pragma unroll 4
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int k = t / w4;
      const int c = (t - k * w4) << 2;
      if (c < valid) {
        const float2* s = smem + k * width + c;
        const long long g = base + k * stride + c;
        *reinterpret_cast<float4*>(yr + g) = make_float4(s[0].x, s[1].x, s[2].x, s[3].x);
        *reinterpret_cast<float4*>(yi + g) = make_float4(s[0].y, s[1].y, s[2].y, s[3].y);
      }
    }
    return;
  }
  const int total = rows * width;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int k = t / width;
    const int c = t - k * width;
    if (c < valid) {
      const long long g = base + k * stride + c;
      yr[g] = smem[t].x;
      yi[g] = smem[t].y;
    }
  }
}

// Runs every stage of the plan; the data starts in `a`, `b` is scratch of
// the same size.  Returns the buffer that holds the result.  Every thread
// of the block must call it.
template <bool SEQ_FAST>
__device__ float2* run_stages(float2* a, float2* b, int lines, int qs, int es,
                              const Plan& p, const float2* table) {
  int L = 1, M = p.n;
  for (int s = 0; s < p.n_stages; ++s) {
    const int r = p.radix[s];
    const int Mp = M / r;
    const float2* tw = table + p.tw_off[s];
    const float2* w = table + (p.dft_off[s] >= 0 ? p.dft_off[s] : 0);
    switch (r) {
      case 2: stage_fixed<2, SEQ_FAST>(a, b, lines, qs, es, L, Mp, tw, w, p.inverse); break;
      case 3: stage_fixed<3, SEQ_FAST>(a, b, lines, qs, es, L, Mp, tw, w, p.inverse); break;
      case 4: stage_fixed<4, SEQ_FAST>(a, b, lines, qs, es, L, Mp, tw, w, p.inverse); break;
      case 5: stage_fixed<5, SEQ_FAST>(a, b, lines, qs, es, L, Mp, tw, w, p.inverse); break;
      case 7: stage_fixed<7, SEQ_FAST>(a, b, lines, qs, es, L, Mp, tw, w, p.inverse); break;
      case 8: stage_fixed<8, SEQ_FAST>(a, b, lines, qs, es, L, Mp, tw, w, p.inverse); break;
      default: stage_generic<SEQ_FAST>(a, b, lines, qs, es, r, L, Mp, tw, w); break;
    }
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
    L *= r;
    M = Mp;
  }
  return a;
}

}  // namespace vkfft
