// fft_r2c: batched real-to-complex FFT of contiguous real (B, n) fp32 lines,
// n even, into their half spectrum, and the complex-to-real inverse.
// Replaces vkfft_tpu/ops/pallas_engine.py:2461 _r2c_kernel and :2507
// _c2r_kernel (their host side: _build_r2c_call, rfft_lines_planar,
// irfft_lines_planar, rfft_lines_packed, irfft_lines_packed).
//
// Layouts of the spectrum planes: numpy's, (B, n/2+1) with Im(DC) and
// Im(Nyquist) stored as 0; or packed, (B, n/2) with the real Nyquist bin in
// Im(bin 0), whose rows keep the float4 moves of stockham.cuh.  The inverse
// output is scaled by (n/2) * scale, with scale folded into the stage-0
// twiddles: scale = 2/n gives numpy's irfft.
//
// Bound: bytes.  A line moves 4n bytes of real data and 8(n/2+1) (packed:
// 4n) bytes of spectrum, read once and written once, and does the flops of
// an n/2-point complex FFT plus an O(n) untangle.  Design: the TPU kernel
// runs two full n-point pipelines on [z | conj z], since Mosaic cannot
// shuffle (pallas_engine.py:2440-2457).  Here a block reads its lines as
// float2 pairs z[j] = x[2j] + i x[2j+1] (one contiguous run, float4 moves),
// runs the n/2-point stages in shared memory (stockham.cuh), untangles in
// place (r2c.cuh: the reversal Z[m-k] is a shared-memory index), and writes
// the spectrum; the inverse runs the same steps backwards.  Numpy-layout
// rows of n/2+1 are not 16-byte aligned, so their planes move as single
// floats, still coalesced: a block's rows are one contiguous run.
#include "r2c.cuh"

namespace {

using vkfft::Plan;

// Lines per block: about 2048 complex points of state, at least one line.
int lines_per_block(int m) { return m >= 2048 ? 1 : 2048 / m; }

__global__ void __launch_bounds__(512)
r2c_kernel(const float* x, float* yr, float* yi, long long batch, int lpb,
           int packed, Plan p, const float2* table, int post_off) {
  extern __shared__ __align__(16) float2 smem[];
  const int m = p.n;
  const long long line0 = (long long)blockIdx.x * lpb;
  const int lines = (int)min((long long)lpb, batch - line0);
  float2* a = smem;
  float2* b = smem + lpb * m;
  vkfft::load_run(x, line0 * 2 * m, lines * m, a);
  __syncthreads();
  float2* res = vkfft::run_stages<false>(a, b, lines, m, 1, p, table);
  vkfft::untangle<false>(res, lines, m, table + post_off);
  __syncthreads();
  if (packed) {
    vkfft::store_tile(res, yr, yi, line0 * m, m, lines, m, m);
    return;
  }
  // numpy layout: slot 0 of a packed row expands to bins 0 and m
  const int h = m + 1;
  const long long base = line0 * h;
  for (int t = threadIdx.x; t < lines * h; t += blockDim.x) {
    const int q = t / h;
    const int c = t - q * h;
    const float2 v = res[q * m + (c == m ? 0 : c)];
    yr[base + t] = c == 0 ? v.x : (c == m ? v.y : v.x);
    yi[base + t] = (c == 0 || c == m) ? 0.f : v.y;
  }
}

__global__ void __launch_bounds__(512)
c2r_kernel(const float* xr, const float* xi, float* y, long long batch,
           int lpb, int packed, Plan p, const float2* table, int post_off) {
  extern __shared__ __align__(16) float2 smem[];
  const int m = p.n;
  const long long line0 = (long long)blockIdx.x * lpb;
  const int lines = (int)min((long long)lpb, batch - line0);
  float2* a = smem;
  float2* b = smem + lpb * m;
  if (packed) {
    vkfft::load_tile(xr, xi, line0 * m, m, lines, m, m, a);
  } else {
    // numpy layout into packed rows: Re(bin 0) and Re(bin m) share slot 0;
    // their imaginary parts are not read
    const int h = m + 1;
    const long long base = line0 * h;
    for (int t = threadIdx.x; t < lines * h; t += blockDim.x) {
      const int q = t / h;
      const int c = t - q * h;
      float2* row = a + q * m;
      if (c == 0) {
        row[0].x = xr[base + t];
      } else if (c == m) {
        row[0].y = xr[base + t];
      } else {
        row[c] = make_float2(xr[base + t], xi[base + t]);
      }
    }
  }
  __syncthreads();
  vkfft::untangle<true>(a, lines, m, table + post_off);
  __syncthreads();
  const float2* res = vkfft::run_stages<false>(a, b, lines, m, 1, p, table);
  vkfft::store_run(res, y, line0 * 2 * m, lines * m);
}

// Shared checks and launch geometry of both directions.
template <typename K>
int prepare(K kernel, long long batch, const int* plan, Plan* p, int* lpb,
            size_t* smem, long long* blocks) {
  if (batch < 1 || !vkfft::plan_from_ints(plan, p)) return (int)cudaErrorInvalidValue;
  *lpb = lines_per_block(p->n);
  *smem = 2 * (size_t)(*lpb) * p->n * sizeof(float2);
  if (*smem > (size_t)vkfft::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (*smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (e != cudaSuccess) return (int)e;
  }
  *blocks = (batch + *lpb - 1) / *lpb;
  if (*blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() after the launch (0 on
// success).  `plan` is the int form of the n/2-point vkfft::Plan, `table`
// the device table of its stages followed, at float2 offset `post_off`, by
// w^k = e^{-2 pi i k / n} for k <= n/4.  x and y are real (batch, n) lines.
int vk_fft_r2c(const float* x, float* yr, float* yi, long long batch, int packed,
               const int* plan, const float* table, int post_off, void* stream) {
  Plan p;
  int lpb;
  size_t smem;
  long long blocks;
  int err = prepare(r2c_kernel, batch, plan, &p, &lpb, &smem, &blocks);
  if (err) return err;
  const int threads = lpb * p.n > 2048 ? 512 : 256;
  r2c_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      x, yr, yi, batch, lpb, packed, p, reinterpret_cast<const float2*>(table),
      post_off);
  return (int)cudaGetLastError();
}

int vk_fft_c2r(const float* xr, const float* xi, float* y, long long batch,
               int packed, const int* plan, const float* table, int post_off,
               void* stream) {
  Plan p;
  int lpb;
  size_t smem;
  long long blocks;
  int err = prepare(c2r_kernel, batch, plan, &p, &lpb, &smem, &blocks);
  if (err) return err;
  const int threads = lpb * p.n > 2048 ? 512 : 256;
  c2r_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, y, batch, lpb, packed, p, reinterpret_cast<const float2*>(table),
      post_off);
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
