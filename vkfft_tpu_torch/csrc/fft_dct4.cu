// fft_dct4: batched DCT-IV / DST-IV of contiguous real (B, n) fp32 lines, any
// n, unnormalized (scipy's norm=None), times `scale`.
// Replaces vkfft_tpu/ops/pallas_engine.py:3080 _dct4_kernel (its host side:
// _build_dct4_call, dct4_lines, dst4_lines).
//
// Bound: bytes for even n (4n bytes in and out a line, the flops of an
// n/2-point complex FFT); odd n does the work of a 2n-point complex FFT a
// line, four times as much.  Design: the TPU kernel runs every n as one
// complex 2n-point zero-padded pipeline, because Mosaic cannot shuffle.
// Here even n takes the reference's n/2 trick (appendDCTIV_even_read /
// _write, vkFFT_R2R.h:2318/2946; the derivation is in
// vkfft_tpu/transforms/r2r.py _dct4_even): m = n/2,
//   w[j] = (x[2j] + i x[n-1-2j]) pre[j],   pre[j] = e^{-i pi (4j+1)/4n},
//   W = FFT_m(w),
//   y[2t] = Re(postE[t] W[t]),  y[2t+1] = Re(postO[t] W[m-1-t]),
//   postE[t] = 2 scale e^{-i pi t/n},  postO[t] = 2 scale e^{+i pi (t+1)/n};
// the interleave and the reversal are shared-memory indices.  Odd n takes
// the TPU kernel's form (vkFFT_R2R.h:3261 for the odd path):
//   c[j] = x[j] e^{-i pi j/2n} zero-extended to 2n, Z = FFT_2n(c),
//   y[k] = Re(post[k] Z[k]),  post[k] = 2 scale e^{-i pi (2k+1)/4n}.
// DST-IV = reverse(DCT-IV((-1)^j x)): the signs ride the read, the
// reversal the write.
#include "r2r.cuh"

namespace {

using vkfft::Plan;

__global__ void __launch_bounds__(512)
dct4_even_kernel(const float* x, float* y, long long batch, int lpb, int dst,
                 Plan p, const float2* table, int pre_off, int post_off) {
  extern __shared__ __align__(16) float2 smem[];
  const int m = p.n;
  const int n = 2 * m;
  const long long line0 = (long long)blockIdx.x * lpb;
  const int lines = (int)min((long long)lpb, batch - line0);
  float2* a = smem;
  float2* b = smem + lpb * m;
  float* xs = reinterpret_cast<float*>(b);
  vkfft::load_floats(x, line0 * n, lines * n, xs);
  __syncthreads();
  const float2* pre = table + pre_off;
  // n is even, so x[2j] keeps its sign under DST-IV and x[n-1-2j] flips
  const float odd_sign = dst ? -1.f : 1.f;
  for (int t = threadIdx.x; t < lines * m; t += blockDim.x) {
    const int q = t / m;
    const int j = t - q * m;
    const float* s = xs + q * n;
    a[t] = vkfft::cmul(make_float2(s[2 * j], odd_sign * s[n - 1 - 2 * j]),
                       __ldg(&pre[j]));
  }
  __syncthreads();
  const float2* res = vkfft::run_stages<false>(a, b, lines, m, 1, p, table);
  float* ys = reinterpret_cast<float*>(res == a ? b : a);
  const float2* post_e = table + post_off;
  const float2* post_o = post_e + m;
  for (int t = threadIdx.x; t < lines * m; t += blockDim.x) {
    const int q = t / m;
    const int u = t - q * m;
    const float2* row = res + q * m;
    const float ye = vkfft::re_mul(__ldg(&post_e[u]), row[u]);
    const float yo = vkfft::re_mul(__ldg(&post_o[u]), row[m - 1 - u]);
    float* out = ys + q * n;
    if (dst) {
      out[n - 1 - 2 * u] = ye;
      out[n - 2 - 2 * u] = yo;
    } else {
      out[2 * u] = ye;
      out[2 * u + 1] = yo;
    }
  }
  __syncthreads();
  vkfft::store_floats(ys, y, line0 * n, lines * n);
}

__global__ void __launch_bounds__(512)
dct4_odd_kernel(const float* x, float* y, long long batch, int lpb, int dst,
                Plan p, const float2* table, int pre_off, int post_off) {
  extern __shared__ __align__(16) float2 smem[];
  const int N = p.n;
  const int n = N / 2;
  const long long line0 = (long long)blockIdx.x * lpb;
  const int lines = (int)min((long long)lpb, batch - line0);
  float2* a = smem;
  float2* b = smem + lpb * N;
  float* xs = reinterpret_cast<float*>(b);
  vkfft::load_floats(x, line0 * n, lines * n, xs);
  __syncthreads();
  const float2* pre = table + pre_off;
  for (int t = threadIdx.x; t < lines * N; t += blockDim.x) {
    const int q = t / N;
    const int j = t - q * N;
    float2 v = make_float2(0.f, 0.f);
    if (j < n) {
      const float s = (dst ? vkfft::alt_sign(j) : 1.f) * xs[q * n + j];
      const float2 r = __ldg(&pre[j]);
      v = make_float2(s * r.x, s * r.y);
    }
    a[t] = v;
  }
  __syncthreads();
  const float2* res = vkfft::run_stages<false>(a, b, lines, N, 1, p, table);
  float* ys = reinterpret_cast<float*>(res == a ? b : a);
  const float2* post = table + post_off;
  for (int t = threadIdx.x; t < lines * n; t += blockDim.x) {
    const int q = t / n;
    const int k = t - q * n;
    ys[q * n + (dst ? n - 1 - k : k)] =
        vkfft::re_mul(__ldg(&post[k]), res[q * N + k]);
  }
  __syncthreads();
  vkfft::store_floats(ys, y, line0 * n, lines * n);
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() after the launch (0 on
// success).  `plan` is the int form of the forward vkfft::Plan of n/2
// points (n even) or 2n points (n odd), `table` the device table of its
// stages followed by pre[] at float2 offset `pre_off` and the
// post-rotations at `post_off` (even n: postE then postO, n/2 each; odd n:
// post, n), with `scale` in the post-rotations.  x and y are real (batch, n)
// lines.
int vk_fft_dct4(const float* x, float* y, long long batch, int n, int dst,
                const int* plan, const float* table, int pre_off, int post_off,
                void* stream) {
  Plan p;
  if (!vkfft::plan_from_ints(plan, &p) || p.inverse != 0)
    return (int)cudaErrorInvalidValue;
  const bool even = n % 2 == 0;
  if (even ? p.n * 2 != n : p.n != 2 * n) return (int)cudaErrorInvalidValue;
  const auto kernel = even ? dct4_even_kernel : dct4_odd_kernel;
  int lpb;
  size_t smem;
  long long blocks;
  int err = vkfft::r2r_prepare(kernel, batch, 1, p.n, &lpb, &smem, &blocks);
  if (err) return err;
  const int threads = lpb * p.n > 2048 ? 512 : 256;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      x, y, batch, lpb, dst, p, reinterpret_cast<const float2*>(table),
      pre_off, post_off);
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
