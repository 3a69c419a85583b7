// fft_twofactor: batched C2C FFT of contiguous (B, n) fp32 re/im planes,
// n = n1 * n2 <= 16384, as the two-factor DFT of twofactor.cuh: forward
// from natural order to natural or swapped digit order, inverse from
// either order to natural order, the scale folded into the twiddle.
// Replaces vkfft_tpu/ops/pallas_engine.py:897 _fft_kernel_v2 (plain fp32
// form: no row elision).
//
// Bound: bytes.  Each point is read once and written once (16 B of
// planes); the ~5 n log2 n flops of the factors' stages (O(r^2) a point
// for a prime factor above 7) stay under the card's fp32 rate for those
// bytes except at the largest prime factors.  Design: one block a line,
// held whole in shared memory (n * 8 B, at most 128 KB) between the column
// and the row pass, so the line crosses device memory once each way; the
// swapped order (the natural result of the row pass) needs no transpose,
// which is what a Rader or Bluestein convolution through fft_conv_inv
// uses.  A block reads all of its line before it writes, so the output
// may alias the input.
#include "twofactor.cuh"

namespace {

using vkfft::Plan;

__global__ void __launch_bounds__(512)
fft_twofactor_kernel(const float* xr, const float* xi, float* yr, float* yi,
                     Plan p1, Plan p2, const float2* t1, const float2* t2,
                     const float2* tw, int swapped, int s) {
  extern __shared__ __align__(16) float2 smem[];
  const int n = p1.n * p2.n;
  const long long base = (long long)blockIdx.x * n;
  float2* home = smem;
  float2* s0 = smem + n;
  float2* s1 = s0 + s;
  if (!p1.inverse) {
    if (swapped)
      vkfft::twofactor_forward<true>(xr, xi, yr, yi, base, p1, p2, t1, t2, tw,
                                     s, home, s0, s1);
    else
      vkfft::twofactor_forward<false>(xr, xi, yr, yi, base, p1, p2, t1, t2, tw,
                                      s, home, s0, s1);
  } else {
    const float2 zero = make_float2(0.f, 0.f);
    if (swapped)
      vkfft::twofactor_inverse<true>(xr, xi, yr, yi, base, p1, p2, t1, t2, tw,
                                     nullptr, zero, s, home, s0, s1);
    else
      vkfft::twofactor_inverse<false>(xr, xi, yr, yi, base, p1, p2, t1, t2, tw,
                                      nullptr, zero, s, home, s0, s1);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  `plan1`/`plan2` are the int forms of the n1- and n2-point
// plans (both forward or both inverse; `plan2` may be the empty plan of a
// length-1 factor), `table1`/`table2` their stage tables and `twiddle` the
// (n2, n1) table w_n^(+-k2*j1) * scale, all as interleaved fp32 pairs.
int vk_fft_twofactor(const float* xr, const float* xi, float* yr, float* yi,
                     long long batch, const int* plan1, const int* plan2,
                     const float* table1, const float* table2,
                     const float* twiddle, int swapped, void* stream) {
  Plan p1, p2;
  if (batch < 1 || batch > 0x7fffffffLL || !vkfft::plan_from_ints(plan1, &p1) ||
      !vkfft::subplan_from_ints(plan2, &p2))
    return (int)cudaErrorInvalidValue;
  const int s = vkfft::twofactor_tile(p1, p2);
  if (s == 0) return (int)cudaErrorInvalidValue;
  const int n = p1.n * p2.n;
  const size_t smem = vkfft::twofactor_smem(n, s);
  if (smem > (size_t)vkfft::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fft_twofactor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = n >= 4096 ? 512 : 256;
  fft_twofactor_kernel<<<(unsigned)batch, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, p1, p2, reinterpret_cast<const float2*>(table1),
      reinterpret_cast<const float2*>(table2),
      reinterpret_cast<const float2*>(twiddle), swapped, s);
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
