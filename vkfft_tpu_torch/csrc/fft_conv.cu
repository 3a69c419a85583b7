// fft_conv: circular convolution of each line of contiguous fp32 re/im
// planes with a fixed kernel given by its spectrum, in one launch: the
// forward stages, a per-frequency multiply, the inverse stages.  Replaces
// vkfft_tpu/ops/pallas_engine.py:4579 _conv_v3_kernel in all its modes:
//   scalar   (B, m) lines, one m-point spectrum (Rader's cyclic convolution
//            of p-1 points; conv_fused_v3);
//   rows     (B, m) lines, a (rows, m) spectrum, line j multiplied by row
//            j % rows (the last-axis pass of an N-D convolution;
//            conv_fused_v3_rows, whose TPU table is the (m, rows) transpose);
//   matrix   (B, mm, m) planes, mm = 2 or 3, an (mm, mm, m) spectrum:
//            out[o] = IFFT(sum_i K[o, i] FFT(x_i)) (conv_fused_v3_matrix);
//   Bluestein (B, n) lines, n < m: the read multiplies by the chirp and
//            leaves [n, m) zero, the write keeps the first n points times
//            the chirp (bluestein_fused_v3).
// Two flags act on the multiply of the first three modes: kConjData
// negates Im of each forward spectrum before it (conjugate_convolution ==
// 2; a conjugated kernel, == 1, is conjugated in the host table), kXpow
// divides the product Y by |Y| after the sum over i, in the TPU kernel's own
// form Y * rsqrt(|Y|^2 + 1e-30) (pallas_engine.py:4665).  The spectrum is
// then unscaled (a scale cancels in Y/|Y|) and the caller's 1/n rides the
// inverse stage table instead; otherwise the host folds it into the
// spectrum.
//
// Bound: bytes.  Each point of the planes is read once and written once
// (16 B), the spectrum once a launch; the two m-point FFTs a line are
// ~10 m log2 m flops, under the card's fp32 rate for those bytes at m <=
// 8192.  Design: a block holds lpb lines in shared memory
// (two buffers of lpb * m float2) and runs every stage there
// (stockham.cuh): floor(2048/m) lines (at least one) in the scalar, rows
// and Bluestein modes, and in the matrix mode whole batch items of mm
// lines, so one thread can read the mm forward spectra of a frequency,
// mix them and write the mm products over them before the inverse stages
// start; the gate for that mode is 2 * mm * m * 8 B within a block's
// 227 KB (host: conv_matrix_supports).  The spectrum (fp64 on the host,
// cast to fp32), the chirp and the stage tables are read through the
// read-only cache; the rows table (2 MiB at 512 x 512) stays in the 50 MB
// L2 across blocks.  The pad never exists in device memory.  A block
// reads all its lines before it writes any, so the output may alias the
// input.
#include "stockham.cuh"

namespace {

using vkfft::Plan;
using vkfft::cmul;

constexpr int kConjData = 1;
constexpr int kXpow = 2;

int lines_per_block(int m, int mm) {
  const int items = mm * m >= 2048 ? 1 : 2048 / (mm * m);
  return items * mm;
}

__device__ __forceinline__ float2 xpow_scale(float2 y) {
  const float s = rsqrtf(fmaf(y.x, y.x, fmaf(y.y, y.y, 1e-30f)));
  return make_float2(y.x * s, y.y * s);
}

// The per-frequency multiply over the forward spectra in f: `lines` lines
// of m points, the first of them line `line0` of the launch.  MM == 1:
// line q times row (line0 + q) % rows of the spectrum; MM > 1: each item of
// MM lines mixed by the (MM, MM, m) matrix.  In place.
template <int MM>
__device__ void multiply(float2* f, int lines, int m, long long line0,
                         int rows, const float2* spec, int flags) {
  const int items = lines / MM;
  const bool conj = flags & kConjData, xpow = flags & kXpow;
  for (int t = threadIdx.x; t < items * m; t += blockDim.x) {
    const int it = t / m;
    const int k = t - it * m;
    float2 x[MM];
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      x[i] = f[(it * MM + i) * m + k];
      if (conj) x[i].y = -x[i].y;
    }
    const float2* row = spec;
    if (MM == 1 && rows > 1) row += (long long)((line0 + it) % rows) * m;
#pragma unroll
    for (int o = 0; o < MM; ++o) {
      float2 y = make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < MM; ++i)
        y = vkfft::cadd(y, cmul(x[i], __ldg(&row[(o * MM + i) * m + k])));
      f[(it * MM + o) * m + k] = xpow ? xpow_scale(y) : y;
    }
  }
}

__global__ void __launch_bounds__(512)
fft_conv_kernel(const float* xr, const float* xi, float* yr, float* yi,
                long long batch, int n, int lpb, int mm, int rows, int flags,
                Plan pf, Plan pi, const float2* tf, const float2* ti,
                const float2* spec, const float2* chirp) {
  extern __shared__ __align__(16) float2 smem[];
  const int m = pf.n;
  const long long line0 = (long long)blockIdx.x * lpb;
  const int lines = (int)min((long long)lpb, batch - line0);
  const long long base = line0 * n;
  float2* a = smem;
  float2* b = smem + lpb * m;
  vkfft::load_tile(xr, xi, base, n, lines, m, n, a);   // [n, m) zero
  __syncthreads();
  if (chirp != nullptr) {
    for (int t = threadIdx.x; t < lines * n; t += blockDim.x) {
      const int q = t / n;
      const int k = t - q * n;
      a[q * m + k] = cmul(a[q * m + k], __ldg(&chirp[k]));
    }
    __syncthreads();
  }
  float2* f = vkfft::run_stages<false>(a, b, lines, m, 1, pf, tf);
  switch (mm) {
    case 2: multiply<2>(f, lines, m, line0, rows, spec, flags); break;
    case 3: multiply<3>(f, lines, m, line0, rows, spec, flags); break;
    default: multiply<1>(f, lines, m, line0, rows, spec, flags); break;
  }
  __syncthreads();
  float2* r = vkfft::run_stages<false>(f, f == a ? b : a, lines, m, 1, pi, ti);
  if (chirp != nullptr) {
    for (int t = threadIdx.x; t < lines * n; t += blockDim.x) {
      const int q = t / n;
      const int k = t - q * n;
      r[q * m + k] = cmul(r[q * m + k], __ldg(&chirp[k]));
    }
    __syncthreads();
  }
  vkfft::store_tile(r, yr, yi, base, n, lines, m, n);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  `lines` lines of n points (matrix mode: lines = B * mm, item
// b's mm coordinate lines consecutive); `mm` 1, 2 or 3; `rows` the rows of
// the spectrum (1: one shared row); `flags` kConjData | kXpow.
// `plan_f`/`plan_i` are the int forms of the forward and the inverse plan
// of length m (any scale folded into the inverse table), `table_f`/
// `table_i` their stage tables, `spectrum` the rows * m (matrix: mm * mm *
// m) table and `chirp` the n-point chirp (null but in the Bluestein mode,
// where mm = rows = 1, flags = 0 and n < m; elsewhere n must equal m), all
// as interleaved fp32 pairs.
int vk_fft_conv(const float* xr, const float* xi, float* yr, float* yi,
                long long lines, int n, int mm, int rows, int flags,
                const int* plan_f, const int* plan_i, const float* table_f,
                const float* table_i, const float* spectrum, const float* chirp,
                void* stream) {
  Plan pf, pi;
  if (lines < 1 || !vkfft::plan_from_ints(plan_f, &pf) ||
      !vkfft::plan_from_ints(plan_i, &pi) || pf.n != pi.n || pf.inverse ||
      !pi.inverse || spectrum == nullptr)
    return (int)cudaErrorInvalidValue;
  const int m = pf.n;
  if (mm < 1 || mm > 3 || rows < 1 || (flags & ~(kConjData | kXpow)) ||
      lines % mm || (mm > 1 && rows != 1))
    return (int)cudaErrorInvalidValue;
  if (chirp == nullptr ? n != m
                       : (n < 1 || n >= m || mm != 1 || rows != 1 || flags))
    return (int)cudaErrorInvalidValue;
  const int lpb = lines_per_block(m, mm);
  const size_t smem = 2 * (size_t)lpb * m * sizeof(float2);
  if (smem > (size_t)vkfft::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fft_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (lines + lpb - 1) / lpb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int threads = lpb * m > 2048 ? 512 : 256;
  fft_conv_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, lines, n, lpb, mm, rows, flags, pf, pi,
      reinterpret_cast<const float2*>(table_f),
      reinterpret_cast<const float2*>(table_i),
      reinterpret_cast<const float2*>(spectrum),
      reinterpret_cast<const float2*>(chirp));
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
