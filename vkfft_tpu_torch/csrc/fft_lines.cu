// fft_lines: batched C2C FFT of contiguous (B, n) fp32 re/im planes,
// natural order in and out, forward or inverse, scale folded into the
// stage-0 twiddles.  Replaces vkfft_tpu/ops/pallas_engine.py:1563
// _fft_kernel_v3 (plain fp32 form: no zero-pad windows, no tl layout).
//
// Bound: bytes.  Each point is read once and written once (16 B of planes);
// at n <= 8192 the FFT's ~5 n log2 n flops are far below the card's fp32
// rate for those bytes.  Design: a block loads whole lines with coalesced
// plane reads, runs every stage in shared memory (stockham.cuh), and writes
// the lines back, so device memory sees one read and one write per point;
// where n is a multiple of 4 each thread moves float4s (stockham.cuh).
// Small n packs several lines into a block so that its threads have
// butterflies to do.  A block reads all its lines before it writes any, so
// the output may alias the input (in-place passes of an N-D walk).
#include "stockham.cuh"

namespace {

using vkfft::Plan;

// Lines per block: about 2048 points of state, at least one line.
int lines_per_block(int n) { return n >= 2048 ? 1 : 2048 / n; }

__global__ void __launch_bounds__(512)
fft_lines_kernel(const float* xr, const float* xi, float* yr, float* yi,
                 long long batch, int lpb, Plan p, const float2* table) {
  extern __shared__ float2 smem[];
  const int n = p.n;
  const long long line0 = (long long)blockIdx.x * lpb;
  const int lines = (int)min((long long)lpb, batch - line0);
  const long long base = line0 * n;
  float2* a = smem;
  float2* b = smem + lpb * n;
  vkfft::load_tile(xr, xi, base, n, lines, n, n, a);
  __syncthreads();
  const float2* res = vkfft::run_stages<false>(a, b, lines, n, 1, p, table);
  vkfft::store_tile(res, yr, yi, base, n, lines, n, n);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  `plan` is the int form of vkfft::Plan, `table` the device
// twiddle table as interleaved (re, im) fp32 pairs.
int vk_fft_lines(const float* xr, const float* xi, float* yr, float* yi,
                 long long batch, const int* plan, const float* table,
                 void* stream) {
  Plan p;
  if (batch < 1 || !vkfft::plan_from_ints(plan, &p)) return (int)cudaErrorInvalidValue;
  const int lpb = lines_per_block(p.n);
  const size_t smem = 2 * (size_t)lpb * p.n * sizeof(float2);
  if (smem > (size_t)vkfft::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fft_lines_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (batch + lpb - 1) / lpb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int threads = lpb * p.n > 2048 ? 512 : 256;
  fft_lines_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, batch, lpb, p, reinterpret_cast<const float2*>(table));
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
