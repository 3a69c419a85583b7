// fft_conv: circular convolution of each line of contiguous (B, m) fp32
// re/im planes with a fixed kernel given by its spectrum, in one launch:
// the forward stages, a per-frequency multiply, the inverse stages.  In
// Bluestein mode the planes are (B, n), n < m: the read multiplies by the
// chirp and leaves [n, m) zero, the write keeps the first n points times
// the chirp.  Replaces vkfft_tpu/ops/pallas_engine.py:4579 _conv_v3_kernel
// in its scalar-table mode (Rader's cyclic convolution of p-1 points,
// conv_fused_v3) and its Bluestein mode (bluestein_fused_v3); the rows,
// matrix, conjugate and cross-power modes are not ported yet.
//
// Bound: bytes.  Each point of the (B, n) planes is read once and written
// once (16 B); the two m-point FFTs a line are ~10 m log2 m flops, under
// the card's fp32 rate for those bytes at m <= 8192.  Design: as
// fft_lines, a block holds floor(2048/m) lines (at least one) in shared
// memory (two buffers of m float2, 128 KB at m = 8192) and runs every
// stage there (stockham.cuh); the spectrum (with 1/m and the caller's
// scale folded in on the host), the chirp and the stage tables are fp64
// host tables cast to fp32, read through the read-only cache.  The pad
// never exists in device memory.  A block reads all its lines before it
// writes, so the output may alias the input.
#include "stockham.cuh"

namespace {

using vkfft::Plan;

int lines_per_block(int m) { return m >= 2048 ? 1 : 2048 / m; }

__global__ void __launch_bounds__(512)
fft_conv_kernel(const float* xr, const float* xi, float* yr, float* yi,
                long long batch, int n, int lpb, Plan pf, Plan pi,
                const float2* tf, const float2* ti, const float2* spec,
                const float2* chirp) {
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
      a[q * m + k] = vkfft::cmul(a[q * m + k], __ldg(&chirp[k]));
    }
    __syncthreads();
  }
  float2* f = vkfft::run_stages<false>(a, b, lines, m, 1, pf, tf);
  for (int t = threadIdx.x; t < lines * m; t += blockDim.x)
    f[t] = vkfft::cmul(f[t], __ldg(&spec[t % m]));
  __syncthreads();
  float2* r = vkfft::run_stages<false>(f, f == a ? b : a, lines, m, 1, pi, ti);
  if (chirp != nullptr) {
    for (int t = threadIdx.x; t < lines * n; t += blockDim.x) {
      const int q = t / n;
      const int k = t - q * n;
      r[q * m + k] = vkfft::cmul(r[q * m + k], __ldg(&chirp[k]));
    }
    __syncthreads();
  }
  vkfft::store_tile(r, yr, yi, base, n, lines, m, n);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  `plan_f`/`plan_i` are the int forms of the forward and the
// inverse plan of length m, `table_f`/`table_i` their stage tables,
// `spectrum` the m-point table and `chirp` the n-point chirp (null in the
// scalar mode, where n must equal m), all as interleaved fp32 pairs.
int vk_fft_conv(const float* xr, const float* xi, float* yr, float* yi,
                long long batch, int n, const int* plan_f, const int* plan_i,
                const float* table_f, const float* table_i,
                const float* spectrum, const float* chirp, void* stream) {
  Plan pf, pi;
  if (batch < 1 || !vkfft::plan_from_ints(plan_f, &pf) ||
      !vkfft::plan_from_ints(plan_i, &pi) || pf.n != pi.n || pf.inverse ||
      !pi.inverse || spectrum == nullptr)
    return (int)cudaErrorInvalidValue;
  const int m = pf.n;
  if (chirp == nullptr ? n != m : (n < 1 || n >= m))
    return (int)cudaErrorInvalidValue;
  const int lpb = lines_per_block(m);
  const size_t smem = 2 * (size_t)lpb * m * sizeof(float2);
  if (smem > (size_t)vkfft::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fft_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (batch + lpb - 1) / lpb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int threads = lpb * m > 2048 ? 512 : 256;
  fft_conv_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, batch, n, lpb, pf, pi, reinterpret_cast<const float2*>(table_f),
      reinterpret_cast<const float2*>(table_i),
      reinterpret_cast<const float2*>(spectrum),
      reinterpret_cast<const float2*>(chirp));
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
