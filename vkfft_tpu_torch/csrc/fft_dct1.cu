// fft_dct1: batched DCT-I / DST-I of contiguous real (B, n) fp32 lines,
// unnormalized (scipy's norm=None), times `scale`.
// Replaces vkfft_tpu/ops/pallas_engine.py:2958 _dct1_kernel (its host side:
// _build_dct1_call, dct1_lines, dst1_lines).
//
// Bound: bytes.  A line moves 4n bytes in and 4n out and does the flops of
// an M-point complex FFT, M = n - 1 (DCT-I) or n + 1 (DST-I), plus the
// untangle.  Design: DCT-I is the real FFT of the even extension
// e = [x_0 .. x_{n-1}, x_{n-2} .. x_1] of N = 2M points, DCT1[k] = Re E[k];
// DST-I that of the odd extension e = [0, x_0 .. x_{n-1}, 0, -x_{n-1} ..
// -x_0], DST1[k] = -Im E[k+1] (the reference's appendDCTI_read,
// vkFFT_R2R.h:1339).  The TPU kernel keeps the extension virtual by running
// the zero-padded line through full 2M-point pipelines and correcting the
// x_0 and x_{n-1} terms afterwards.  Here the extension is built from the
// staged line as it is read into shared memory, z[j] = e[2j] + i e[2j+1],
// and the real FFT of N points runs as M complex points and r2c.cuh's
// in-place untangle, with `scale` folded into the stage-0 twiddles; no
// correction term is needed.
#include "r2r.cuh"

namespace {

using vkfft::Plan;

// e[i] of the extension of staged line `s` of n points, N = 2M.
__device__ __forceinline__ float extension(const float* s, int i, int M,
                                           int dst) {
  const int N = 2 * M;
  if (!dst) return i <= M ? s[i] : s[N - i];
  if (i == 0 || i == M) return 0.f;
  return i < M ? s[i - 1] : -s[N - 1 - i];
}

__global__ void __launch_bounds__(512)
dct1_kernel(const float* x, float* y, long long batch, int lpb, int dst,
            Plan p, const float2* table, int post_off) {
  extern __shared__ __align__(16) float2 smem[];
  const int M = p.n;
  const int n = dst ? M - 1 : M + 1;
  const long long line0 = (long long)blockIdx.x * lpb;
  const int lines = (int)min((long long)lpb, batch - line0);
  float2* a = smem;
  float2* b = smem + lpb * M;
  float* xs = reinterpret_cast<float*>(b);
  vkfft::load_floats(x, line0 * n, lines * n, xs);
  __syncthreads();
  for (int t = threadIdx.x; t < lines * M; t += blockDim.x) {
    const int q = t / M;
    const int j = t - q * M;
    const float* s = xs + q * n;
    a[t] = make_float2(extension(s, 2 * j, M, dst),
                       extension(s, 2 * j + 1, M, dst));
  }
  __syncthreads();
  float2* res = vkfft::run_stages<false>(a, b, lines, M, 1, p, table);
  vkfft::untangle<false>(res, lines, M, table + post_off);
  __syncthreads();
  // packed rows: slot 0 holds (E[0], E[M]), slot k the bin k
  float* ys = reinterpret_cast<float*>(res == a ? b : a);
  for (int t = threadIdx.x; t < lines * n; t += blockDim.x) {
    const int q = t / n;
    const int k = t - q * n;
    const float2* row = res + q * M;
    float v;
    if (dst) {
      v = -row[k + 1].y;
    } else {
      v = k == 0 ? row[0].x : (k == M ? row[0].y : row[k].x);
    }
    ys[t] = v;
  }
  __syncthreads();
  vkfft::store_floats(ys, y, line0 * n, lines * n);
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() after the launch (0 on
// success).  `plan` is the int form of the M-point forward vkfft::Plan
// (M = n - 1, or n + 1 with `dst`) with `scale` in its stage 0, `table` the
// device table of its stages followed, at float2 offset `post_off`, by the
// untangle's w^k = e^{-2 pi i k / 2M} for k <= M/2.  x and y are real
// (batch, n) lines.
int vk_fft_dct1(const float* x, float* y, long long batch, int dst,
                const int* plan, const float* table, int post_off,
                void* stream) {
  Plan p;
  if (!vkfft::plan_from_ints(plan, &p) || p.inverse != 0)
    return (int)cudaErrorInvalidValue;
  int lpb;
  size_t smem;
  long long blocks;
  int err = vkfft::r2r_prepare(dct1_kernel, batch, p.n, &lpb, &smem, &blocks);
  if (err) return err;
  const int threads = lpb * p.n > 2048 ? 512 : 256;
  dct1_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      x, y, batch, lpb, dst, p, reinterpret_cast<const float2*>(table),
      post_off);
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
