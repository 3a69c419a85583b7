// fft_conv_inv: natural-order (B, n) fp32 re/im planes from a spectrum in
// fft_twofactor's swapped digit order: the spectrum times a table in the
// same order, the two-factor inverse of twofactor.cuh, and a per-line
// constant added in the store (the Rader x0 term).  Replaces
// vkfft_tpu/ops/pallas_engine.py:4421 _conv_inv_kernel (has_dc is a
// non-null dc).
//
// Bound: bytes, as fft_twofactor (16 B a point read and written; the
// table, n * 8 B, is read by every line through the read-only cache and
// stays in L2).  Design: the multiply rides the read of the line into
// shared memory and the constant the write, so a circular convolution is
// one fft_twofactor forward (swapped) and this kernel, with no spectrum
// pass and no reorder in device memory.  A block reads all of its line
// before it writes, so the output may alias the input.
#include "twofactor.cuh"

namespace {

using vkfft::Plan;

__global__ void __launch_bounds__(512)
fft_conv_inv_kernel(const float* xr, const float* xi, float* yr, float* yi,
                    Plan p1, Plan p2, const float2* t1, const float2* t2,
                    const float2* tw, const float2* spec, const float* dcr,
                    const float* dci, int s) {
  extern __shared__ __align__(16) float2 smem[];
  const int n = p1.n * p2.n;
  const long long line = blockIdx.x;
  const long long base = line * n;
  float2* home = smem;
  float2* s0 = smem + n;
  float2* s1 = s0 + s;
  const float2 dc = dcr != nullptr ? make_float2(dcr[line], dci[line])
                                   : make_float2(0.f, 0.f);
  vkfft::twofactor_inverse<true>(xr, xi, yr, yi, base, p1, p2, t1, t2, tw, spec,
                                 dc, s, home, s0, s1);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  Plans and tables as for vk_fft_twofactor (both inverse; a
// scale rides the twiddle or `spectrum`, an (n) table of fp32 pairs in
// swapped order); `dc_re`/`dc_im` hold one value a line, added after the
// scale, or are both null.
int vk_fft_conv_inv(const float* xr, const float* xi, float* yr, float* yi,
                    long long batch, const int* plan1, const int* plan2,
                    const float* table1, const float* table2,
                    const float* twiddle, const float* spectrum,
                    const float* dc_re, const float* dc_im, void* stream) {
  Plan p1, p2;
  if (batch < 1 || batch > 0x7fffffffLL || !vkfft::plan_from_ints(plan1, &p1) ||
      !vkfft::subplan_from_ints(plan2, &p2) || !p1.inverse ||
      spectrum == nullptr || (dc_re == nullptr) != (dc_im == nullptr))
    return (int)cudaErrorInvalidValue;
  const int s = vkfft::twofactor_tile(p1, p2);
  if (s == 0) return (int)cudaErrorInvalidValue;
  const int n = p1.n * p2.n;
  const size_t smem = vkfft::twofactor_smem(n, s);
  if (smem > (size_t)vkfft::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fft_conv_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = n >= 4096 ? 512 : 256;
  fft_conv_inv_kernel<<<(unsigned)batch, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, p1, p2, reinterpret_cast<const float2*>(table1),
      reinterpret_cast<const float2*>(table2),
      reinterpret_cast<const float2*>(twiddle),
      reinterpret_cast<const float2*>(spectrum), dc_re, dc_im, s);
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
