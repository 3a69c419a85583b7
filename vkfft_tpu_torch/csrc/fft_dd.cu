// fft_dd: the double-double ("fp64" tier) C2C FFT of quad planes (re.hi,
// re.lo, im.hi, im.lo, four fp32 planes of one shape), natural order in
// and out, forward or inverse.  Three C entries:
//   vk_fft_dd_lines    replaces vkfft_tpu/precision/dd_kernel.py:166
//                      _dd_fft_kernel: each line of (B, n) planes;
//   vk_fft_dd_strided  replaces vkfft_tpu/precision/dd_kernel.py:259
//                      _dd_strided_kernel: the middle axis of (P, n, S)
//                      planes, S contiguous, no transpose;
//   vk_dd_pointwise    (x * t + c) * scale, for the few dd points no DFT
//                      pass carries (Rader's X0).
// The DFT entries carry the tier's dd products, which the JAX package runs
// as XLA ops between its kernels: y = (DFT(x * pre) * post + add) * scale,
// with pre/post tables of (L, 4) quads read at each point's flat position
// modulo L (the four-step twiddle, the Bluestein chirps and spectra,
// Rader's spectrum), a per-line quad `add` (Rader's x0, lines only) and a
// dd scale (the inverse's 1/N).
//
// Arithmetic: dd.cuh, whose EFTs use __fadd_rn/__fsub_rn/__fmul_rn and an
// explicit fma in two_prod because nvcc contracts plain operators into
// fmas by default (see the note there).  This source must not be built
// with --use_fast_math or -ftz=true.
//
// Bound: bytes at the main path's lengths, by a small margin.  A pass reads
// and writes each point once, 32 B of planes; its work is about 5 n log2 n
// dd operations of about 11 fp32 operations each (dd.cuh), ~1.4 fp32
// operations a byte at n = 1024, under the card's fp32 ridge of 20.  The
// work this kernel does is not far from that nominal count: radices 2, 4
// and 8 run as butterflies (w8 as one real dd product per component, ±i as
// swaps), odd primes 3..13 in the symmetric form (sums and differences of
// x_j and x_{r-j}, then (r-1)^2/2 real dd products), and each stage's
// twiddle as one complex dd product per point: at radix 8 about 8.3 dd
// additions and 4 dd products a point a stage, 126 fp32 operations, against
// 15 nominal dd operations (165).  The TPU kernel's full r x r dd DFT does
// about 2.5x more.
//
// Design (the shared-memory Stockham of stockham.cuh, with 16 B points):
// a block holds max(1, 2048/n) whole lines, or a tile of min(32,
// max(1, 2048/n)) neighbouring columns across all n rows of one p, as
// float4 quads in two buffers (64 KB; 128 KB at n = 4096, the cap) and runs
// every stage there, so device memory sees one read and one write of each
// point and the tables.  Lines are read and written as four coalesced
// plane streams; a strided tile reads each row as four runs of its
// columns.  A block reads all its input before it writes.  The JAX
// kernel's 128 lines in lanes and its VMEM cap of 2048 are the TPU's and
// are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dd.cuh"

namespace {

using vkdd::dd;
using vkdd::ddc;

constexpr int kMaxStages = 16;
constexpr int kMaxN = 4096;
constexpr int kBlockPoints = 2048;
constexpr int kMaxTile = 32;
constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 232448;

struct Plan {
  int n;
  int n_stages;
  int inverse;
  int radix[kMaxStages];
  int tw_off[kMaxStages];   // the stage's (r, Mp) twiddle block
  int dft_off[kMaxStages];  // the r roots w_r^k of an odd radix, else -1
};

bool radix_ok(int r) {
  return r == 2 || r == 3 || r == 4 || r == 5 || r == 7 || r == 8 ||
         r == 11 || r == 13;
}

// The host passes the plan of the fp32 kernels (stockham.cuh's Plan, from
// cuda_kernels.stage_tables) as ints: n, n_stages, inverse, then
// kMaxStages slots each of radix, tw_off and dft_off; its table's values
// arrive split into quads.
bool plan_from_ints(const int* v, Plan* p) {
  p->n = v[0];
  p->n_stages = v[1];
  p->inverse = v[2];
  if (p->n < 2 || p->n > kMaxN || p->n_stages < 1 ||
      p->n_stages > kMaxStages)
    return false;
  int M = p->n;
  for (int s = 0; s < kMaxStages; ++s) {
    p->radix[s] = v[3 + s];
    p->tw_off[s] = v[3 + kMaxStages + s];
    p->dft_off[s] = v[3 + 2 * kMaxStages + s];
    if (s < p->n_stages) {
      const int r = p->radix[s];
      const bool odd = r % 2 == 1;
      if (!radix_ok(r) || M % r != 0 || p->tw_off[s] < 0 ||
          (odd && p->dft_off[s] < 0))
        return false;
      M /= r;
    }
  }
  return M == 1;
}

struct In4 {
  const float *rh, *rl, *ih, *il;
};
struct Out4 {
  float *rh, *rl, *ih, *il;
};

// The dd options of a pass; a null table is no factor.
struct Opts {
  const float4* pre;
  long long pre_len;
  const float4* post;
  long long post_len;
  const float4* add;  // one quad per line (lines only)
  dd scale;
  int scaled;
};

__device__ __forceinline__ ddc load(const In4& x, long long g) {
  return {{x.rh[g], x.rl[g]}, {x.ih[g], x.il[g]}};
}
__device__ __forceinline__ void store(const Out4& y, long long g, ddc v) {
  y.rh[g] = v.re.hi;
  y.rl[g] = v.re.lo;
  y.ih[g] = v.im.hi;
  y.il[g] = v.im.lo;
}

// ---------------------------------------------------------------------------
// The r-point dd DFTs; `emit(i, X_i)` takes output i.
// ---------------------------------------------------------------------------

template <class Emit>
__device__ __forceinline__ void dft2(ddc (&v)[2], Emit& emit) {
  emit(0, vkdd::cadd(v[0], v[1]));
  emit(1, vkdd::csub(v[0], v[1]));
}

// In place: v[k] <- X_k of the 4 points v[0..3].
__device__ __forceinline__ void dft4(ddc& a, ddc& b, ddc& c, ddc& d,
                                     int inverse) {
  const ddc t0 = vkdd::cadd(a, c), t1 = vkdd::csub(a, c);
  const ddc t2 = vkdd::cadd(b, d), t3 = vkdd::rot(vkdd::csub(b, d), inverse);
  a = vkdd::cadd(t0, t2);
  b = vkdd::cadd(t1, t3);
  c = vkdd::csub(t0, t2);
  d = vkdd::csub(t1, t3);
}

// o * w8, w8 = c (1 -+ i) (forward / inverse): one real product a part.
__device__ __forceinline__ ddc mul_w8(ddc o, dd c, int inverse) {
  if (!inverse)
    return {vkdd::mul(vkdd::add(o.re, o.im), c),
            vkdd::mul(vkdd::sub(o.im, o.re), c)};
  return {vkdd::mul(vkdd::sub(o.re, o.im), c),
          vkdd::mul(vkdd::add(o.im, o.re), c)};
}

template <class Emit>
__device__ __forceinline__ void dft8(ddc (&v)[8], int inverse, Emit& emit) {
  // Two 4-point DFTs: X[k] = E[k] + w8^k O[k], X[k+4] = E[k] - w8^k O[k].
  dft4(v[0], v[2], v[4], v[6], inverse);
  dft4(v[1], v[3], v[5], v[7], inverse);
  // cos(pi/4) in fp64, split exactly into hi + lo
  const dd c = {0x1.6a09e6p-1f, 0x1.9fcef4p-27f};
  const ddc o[4] = {v[1], mul_w8(v[3], c, inverse), vkdd::rot(v[5], inverse),
                    vkdd::rot(mul_w8(v[7], c, inverse), inverse)};
  const ddc e[4] = {v[0], v[2], v[4], v[6]};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    emit(k, vkdd::cadd(e[k], o[k]));
    emit(k + 4, vkdd::csub(e[k], o[k]));
  }
}

// Odd r: s_j = x_j + x_{r-j}, d_j = x_j - x_{r-j} (j <= h = (r-1)/2), then
// X_i = A + iB and X_{r-i} = A - iB with A = x_0 + sum_j s_j cos_ij and B =
// sum_j d_j sin_ij, the roots w_r^k already signed for the direction.
template <int R, class Emit>
__device__ __forceinline__ void dft_odd(ddc (&v)[R], const float4* roots,
                                        Emit& emit) {
  constexpr int H = (R - 1) / 2;
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    const ddc a = v[j], b = v[R - j];
    v[j] = vkdd::cadd(a, b);
    v[R - j] = vkdd::csub(a, b);
  }
  ddc y0 = v[0];
#pragma unroll
  for (int j = 1; j <= H; ++j) y0 = vkdd::cadd(y0, v[j]);
  emit(0, y0);
#pragma unroll
  for (int i = 1; i <= H; ++i) {
    ddc A = v[0], B;
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const float4 w = roots[(i * j) % R];
      A = vkdd::cadd(A, vkdd::rmul(v[j], dd{w.x, w.y}));
      const ddc t = vkdd::rmul(v[R - j], dd{w.z, w.w});
      B = j == 1 ? t : vkdd::cadd(B, t);
    }
    emit(i, ddc{vkdd::sub(A.re, B.im), vkdd::add(A.im, B.re)});
    emit(R - i, ddc{vkdd::add(A.re, B.im), vkdd::sub(A.im, B.re)});
  }
}

// ---------------------------------------------------------------------------
// Stockham stages in shared memory (the recurrence of stockham.cuh):
//   A'[(i*L + l)*Mp + m] = w_M^(i*m) * sum_j w_r^(i*j) A[(l*r + j)*Mp + m]
// Sequence q's element k sits at q*qs + k*es: lines qs = n, es = 1; a
// strided tile qs = 1, es = ts (columns fastest across threads).
// ---------------------------------------------------------------------------

template <int R, bool kColFast>
__device__ void stage(const float4* __restrict__ src, float4* __restrict__ dst,
                      int lines, int qs, int es, int L, int Mp,
                      const float4* __restrict__ tw,
                      const float4* __restrict__ roots, int inverse) {
  const int per_line = L * Mp;
  const int total = lines * per_line;
  for (int bt = threadIdx.x; bt < total; bt += blockDim.x) {
    int q, rem;
    if (kColFast) {
      q = bt % lines;
      rem = bt / lines;
    } else {
      q = bt / per_line;
      rem = bt - q * per_line;
    }
    const int l = rem / Mp, m = rem - l * Mp;
    const float4* in = src + q * qs;
    float4* out = dst + q * qs;
    ddc v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = vkdd::from4(in[((l * R + j) * Mp + m) * es]);
    auto emit = [&](int i, ddc y) {
      if (tw != nullptr && i > 0) y = vkdd::cmul(y, vkdd::from4(tw[i * Mp + m]));
      out[((i * L + l) * Mp + m) * es] = vkdd::to4(y);
    };
    if constexpr (R == 2) {
      dft2(v, emit);
    } else if constexpr (R == 4) {
      dft4(v[0], v[1], v[2], v[3], inverse);
#pragma unroll
      for (int i = 0; i < 4; ++i) emit(i, v[i]);
    } else if constexpr (R == 8) {
      dft8(v, inverse, emit);
    } else {
      dft_odd<R>(v, roots, emit);
    }
  }
}

// Runs every stage over buffers a and b; returns the one holding the result.
template <bool kColFast>
__device__ const float4* run_stages(float4* a, float4* b, int lines, int qs,
                                    int es, const Plan& p,
                                    const float4* __restrict__ table) {
  float4* src = a;
  float4* dst = b;
  int L = 1, M = p.n;
  for (int s = 0; s < p.n_stages; ++s) {
    const int r = p.radix[s];
    const int Mp = M / r;
    // a stage's twiddles are all 1 where Mp == 1
    const float4* tw = Mp > 1 ? table + p.tw_off[s] : nullptr;
    const float4* roots = p.dft_off[s] >= 0 ? table + p.dft_off[s] : nullptr;
#define VKDD_STAGE(R)                                                     \
  case R:                                                                 \
    stage<R, kColFast>(src, dst, lines, qs, es, L, Mp, tw, roots, p.inverse); \
    break;
    switch (r) {
      VKDD_STAGE(2)
      VKDD_STAGE(3)
      VKDD_STAGE(4)
      VKDD_STAGE(5)
      VKDD_STAGE(7)
      VKDD_STAGE(8)
      VKDD_STAGE(11)
      VKDD_STAGE(13)
    }
#undef VKDD_STAGE
    __syncthreads();
    float4* t = src;
    src = dst;
    dst = t;
    L *= r;
    M = Mp;
  }
  return src;
}

__device__ __forceinline__ ddc epilogue(ddc v, long long g, long long line,
                                        const Opts& o) {
  if (o.post != nullptr) v = vkdd::cmul(v, vkdd::from4(o.post[g % o.post_len]));
  if (o.add != nullptr) v = vkdd::cadd(v, vkdd::from4(o.add[line]));
  if (o.scaled) v = vkdd::rmul(v, o.scale);
  return v;
}

__device__ __forceinline__ ddc prologue(ddc v, long long g, const Opts& o) {
  if (o.pre != nullptr) v = vkdd::cmul(v, vkdd::from4(o.pre[g % o.pre_len]));
  return v;
}

__global__ void __launch_bounds__(kThreads)
dd_lines_kernel(In4 x, Out4 y, long long batch, int lpb, Plan p,
                const float4* __restrict__ table, Opts o) {
  extern __shared__ float4 smem[];
  const int n = p.n;
  const long long line0 = (long long)blockIdx.x * lpb;
  const int lines = (int)min((long long)lpb, batch - line0);
  const long long base = line0 * n;
  const int count = lines * n;
  float4* a = smem;
  float4* b = smem + lpb * n;
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    a[i] = vkdd::to4(prologue(load(x, base + i), base + i, o));
  __syncthreads();
  const float4* res = run_stages<false>(a, b, lines, n, 1, p, table);
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    store(y, base + i,
          epilogue(vkdd::from4(res[i]), base + i, line0 + i / n, o));
}

__global__ void __launch_bounds__(kThreads)
dd_strided_kernel(In4 x, Out4 y, long long S, int ts, long long tiles, Plan p,
                  const float4* __restrict__ table, Opts o) {
  extern __shared__ float4 smem[];
  const int n = p.n;
  const long long blk = blockIdx.x;
  const long long pi = blk / tiles;
  const long long s0 = (blk - pi * tiles) * ts;
  const int cols = (int)min((long long)ts, S - s0);
  const long long base = pi * (long long)n * S + s0;
  float4* a = smem;
  float4* b = smem + n * ts;
  for (int i = threadIdx.x; i < n * ts; i += blockDim.x) {
    const int k = i / ts, c = i - k * ts;
    ddc v = {{0.f, 0.f}, {0.f, 0.f}};
    if (c < cols) {
      const long long g = base + (long long)k * S + c;
      v = prologue(load(x, g), g, o);
    }
    a[i] = vkdd::to4(v);
  }
  __syncthreads();
  const float4* res = run_stages<true>(a, b, ts, 1, ts, p, table);
  for (int i = threadIdx.x; i < n * ts; i += blockDim.x) {
    const int k = i / ts, c = i - k * ts;
    if (c < cols) {
      const long long g = base + (long long)k * S + c;
      store(y, g, epilogue(vkdd::from4(res[i]), g, 0, o));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dd_pointwise_kernel(In4 x, Out4 y, long long rows, long long cols, Opts o) {
  const long long total = rows * cols;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < total; g += (long long)gridDim.x * blockDim.x)
    store(y, g, epilogue(load(x, g), g, g / cols, o));
}

int make_opts(const float* pre, long long pre_len, const float* post,
              long long post_len, const float* add, float scale_hi,
              float scale_lo, Opts* o) {
  if ((pre != nullptr && pre_len < 1) || (post != nullptr && post_len < 1))
    return (int)cudaErrorInvalidValue;
  o->pre = reinterpret_cast<const float4*>(pre);
  o->pre_len = pre_len;
  o->post = reinterpret_cast<const float4*>(post);
  o->post_len = post_len;
  o->add = reinterpret_cast<const float4*>(add);
  o->scale = dd{scale_hi, scale_lo};
  o->scaled = !(scale_hi == 1.0f && scale_lo == 0.0f);
  return 0;
}

template <class Kernel>
int smem_opt_in(Kernel kernel, size_t smem) {
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() after the
// launch (0 on success).  Planes: the four input planes, then the four
// output planes.  `plan` is the int form of Plan, `table` its (L, 4)
// quads; pre/post are (len, 4) quad tables or null, `add` (batch, 4) quads
// or null; the scale is the dd pair (scale_hi, scale_lo).
int vk_fft_dd_lines(const float* xrh, const float* xrl, const float* xih,
                    const float* xil, float* yrh, float* yrl, float* yih,
                    float* yil, long long batch, const int* plan,
                    const float* table, const float* pre, long long pre_len,
                    const float* post, long long post_len, const float* add,
                    float scale_hi, float scale_lo, void* stream) {
  Plan p;
  Opts o;
  if (batch < 1 || !plan_from_ints(plan, &p)) return (int)cudaErrorInvalidValue;
  int err = make_opts(pre, pre_len, post, post_len, add, scale_hi, scale_lo, &o);
  if (err) return err;
  const int lpb = p.n >= kBlockPoints ? 1 : kBlockPoints / p.n;
  const size_t smem = 2 * (size_t)lpb * p.n * sizeof(float4);
  if ((err = smem_opt_in(dd_lines_kernel, smem))) return err;
  const long long blocks = (batch + lpb - 1) / lpb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dd_lines_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      In4{xrh, xrl, xih, xil}, Out4{yrh, yrl, yih, yil}, batch, lpb, p,
      reinterpret_cast<const float4*>(table), o);
  return (int)cudaGetLastError();
}

int vk_fft_dd_strided(const float* xrh, const float* xrl, const float* xih,
                      const float* xil, float* yrh, float* yrl, float* yih,
                      float* yil, long long P, long long S, const int* plan,
                      const float* table, const float* pre, long long pre_len,
                      const float* post, long long post_len, float scale_hi,
                      float scale_lo, void* stream) {
  Plan p;
  Opts o;
  if (P < 1 || S < 1 || !plan_from_ints(plan, &p)) return (int)cudaErrorInvalidValue;
  int err = make_opts(pre, pre_len, post, post_len, nullptr, scale_hi,
                      scale_lo, &o);
  if (err) return err;
  int ts = kBlockPoints / p.n;
  if (ts > kMaxTile) ts = kMaxTile;
  if (ts < 1) ts = 1;
  if (ts > S) ts = (int)S;
  const size_t smem = 2 * (size_t)ts * p.n * sizeof(float4);
  if ((err = smem_opt_in(dd_strided_kernel, smem))) return err;
  const long long tiles = (S + ts - 1) / ts;
  const long long blocks = P * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dd_strided_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      In4{xrh, xrl, xih, xil}, Out4{yrh, yrl, yih, yil}, S, ts, tiles, p,
      reinterpret_cast<const float4*>(table), o);
  return (int)cudaGetLastError();
}

int vk_dd_pointwise(const float* xrh, const float* xrl, const float* xih,
                    const float* xil, float* yrh, float* yrl, float* yih,
                    float* yil, long long rows, long long cols,
                    const float* table, long long table_len, const float* add,
                    float scale_hi, float scale_lo, void* stream) {
  Opts o;
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  int err = make_opts(nullptr, 0, table, table_len, add, scale_hi, scale_lo, &o);
  if (err) return err;
  const long long total = rows * cols;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  dd_pointwise_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      In4{xrh, xrl, xih, xil}, Out4{yrh, yrl, yih, yil}, rows, cols, o);
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
