// fft_dct23: batched DCT-II / DST-II and DCT-III / DST-III of contiguous real
// (B, n) fp32 lines, unnormalized (scipy's norm=None), times `scale`.
// Replaces vkfft_tpu/ops/pallas_engine.py:2745 _dct2_kernel and :2789
// _dct3_kernel (their host side: _build_dct_call, dct2_lines, dct3_lines,
// dst2_lines, dst3_lines).
//
// Bound: bytes.  A line moves 4n bytes in and 4n out and does the flops of
// half an n-point complex FFT plus O(n) rotations.  Design: the TPU kernels
// run 2n-point zero-padded pipelines (DCT-II two of them for a pair of
// lines, DCT-III one per line) because Mosaic cannot permute.  Here the
// reference's own form (Makhoul; vkFFT_R2R.h:1541 appendDCTII_read_III_write,
// :1731 appendDCTII_write_III_read) runs at any n, even or odd, with two
// real lines riding one n-point complex pipeline:
//   DCT-II:  v[j] = x[2j], v[n-1-j] = x[2j+1] (the permutation is the
//            read from the staged lines), z = v_a + i v_b, Z = FFT_n(z),
//            V_a = (Z[k] + conj Z[n-k]) / 2, V_b = (Z[k] - conj Z[n-k]) / 2i,
//            y[k] = Re(rot[k] V[k]),  rot[k] = 2 scale e^{-i pi k / 2n};
//   DCT-III: its inverse: U[k] = rot3[k] (c[k] - i c[n-k]) (c[n] = 0),
//            rot3[k] = scale e^{+i pi k / 2n}, Z = U_a + i U_b, the
//            unnormalized inverse FFT_n gives z = v_a + i v_b (each V is
//            Hermitian), and y[2j] = v[j], y[2j+1] = v[n-1-j] on the store.
// DST-II = reverse(DCT-II((-1)^j x)) and DST-III = (-1)^k DCT-III(reverse
// x): the signs and the reversal ride the read and the write.
#include "r2r.cuh"

namespace {

using vkfft::Plan;

__global__ void __launch_bounds__(512)
dct2_kernel(const float* x, float* y, long long batch, int ppb, int dst,
            Plan p, const float2* table, int rot_off) {
  extern __shared__ __align__(16) float2 smem[];
  const int n = p.n;
  const long long line0 = (long long)blockIdx.x * 2 * ppb;
  const int lines = (int)min((long long)(2 * ppb), batch - line0);
  const int pairs = (lines + 1) / 2;
  float2* a = smem;
  float2* b = smem + ppb * n;
  float* xs = reinterpret_cast<float*>(b);
  vkfft::load_floats(x, line0 * n, lines * n, xs);
  __syncthreads();
  const int half = (n + 1) / 2;
  for (int t = threadIdx.x; t < pairs * n; t += blockDim.x) {
    const int q = t / n;
    const int j = t - q * n;
    const int src = j < half ? 2 * j : 2 * (n - 1 - j) + 1;
    const float sg = dst ? vkfft::alt_sign(src) : 1.f;
    const float* la = xs + 2 * q * n;
    const float vb = 2 * q + 1 < lines ? la[n + src] : 0.f;
    a[t] = make_float2(sg * la[src], sg * vb);
  }
  __syncthreads();
  const float2* res = vkfft::run_stages<false>(a, b, pairs, n, 1, p, table);
  float* ys = reinterpret_cast<float*>(res == a ? b : a);
  const float2* rot = table + rot_off;
  for (int t = threadIdx.x; t < pairs * n; t += blockDim.x) {
    const int q = t / n;
    const int k = t - q * n;
    const float2 Z = res[t];
    const float2 Zc = res[q * n + (k == 0 ? 0 : n - k)];
    const float2 Va = make_float2(0.5f * (Z.x + Zc.x), 0.5f * (Z.y - Zc.y));
    const float2 Vb = make_float2(0.5f * (Z.y + Zc.y), 0.5f * (Zc.x - Z.x));
    const float2 r = __ldg(&rot[k]);
    const int o = 2 * q * n + (dst ? n - 1 - k : k);
    ys[o] = vkfft::re_mul(r, Va);
    if (2 * q + 1 < lines) ys[o + n] = vkfft::re_mul(r, Vb);
  }
  __syncthreads();
  vkfft::store_floats(ys, y, line0 * n, lines * n);
}

__global__ void __launch_bounds__(512)
dct3_kernel(const float* x, float* y, long long batch, int ppb, int dst,
            Plan p, const float2* table, int rot_off) {
  extern __shared__ __align__(16) float2 smem[];
  const int n = p.n;
  const long long line0 = (long long)blockIdx.x * 2 * ppb;
  const int lines = (int)min((long long)(2 * ppb), batch - line0);
  const int pairs = (lines + 1) / 2;
  float2* a = smem;
  float2* b = smem + ppb * n;
  float* xs = reinterpret_cast<float*>(b);
  vkfft::load_floats(x, line0 * n, lines * n, xs);
  __syncthreads();
  const float2* rot = table + rot_off;
  for (int t = threadIdx.x; t < pairs * n; t += blockDim.x) {
    const int q = t / n;
    const int k = t - q * n;
    const float* la = xs + 2 * q * n;
    const bool has_b = 2 * q + 1 < lines;
    // c[k] and c[n-k] of both lines (c[n] = 0); DST-III reads x reversed
    const int ik = dst ? n - 1 - k : k;
    const int ir = dst ? k - 1 : n - k;
    const float ca = la[ik], cb = has_b ? la[n + ik] : 0.f;
    const float ra = k ? la[ir] : 0.f;
    const float rb = (k && has_b) ? la[n + ir] : 0.f;
    a[t] = vkfft::cmul(__ldg(&rot[k]), make_float2(ca + rb, cb - ra));
  }
  __syncthreads();
  const float2* res = vkfft::run_stages<false>(a, b, pairs, n, 1, p, table);
  float* ys = reinterpret_cast<float*>(res == a ? b : a);
  for (int t = threadIdx.x; t < pairs * n; t += blockDim.x) {
    const int q = t / n;
    const int o = t - q * n;
    const float2 v = res[q * n + ((o & 1) ? n - 1 - (o >> 1) : (o >> 1))];
    const float sg = dst ? vkfft::alt_sign(o) : 1.f;
    ys[2 * q * n + o] = sg * v.x;
    if (2 * q + 1 < lines) ys[2 * q * n + n + o] = sg * v.y;
  }
  __syncthreads();
  vkfft::store_floats(ys, y, line0 * n, lines * n);
}

template <typename K>
int launch(K kernel, const float* x, float* y, long long batch, int dst,
           const int* plan, const float* table, int rot_off, int inverse,
           void* stream) {
  Plan p;
  if (!vkfft::plan_from_ints(plan, &p) || p.inverse != inverse)
    return (int)cudaErrorInvalidValue;
  int ppb;
  size_t smem;
  long long blocks;
  int err = vkfft::r2r_prepare(kernel, batch, 2, p.n, &ppb, &smem, &blocks);
  if (err) return err;
  const int threads = ppb * p.n > 2048 ? 512 : 256;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      x, y, batch, ppb, dst, p, reinterpret_cast<const float2*>(table), rot_off);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() after the launch (0 on
// success).  `plan` is the int form of the n-point vkfft::Plan (forward for
// type II, inverse for type III), `table` the device table of its stages
// followed, at float2 offset `rot_off`, by the n rotations (type II: 2 scale
// e^{-i pi k/2n}; type III: scale e^{+i pi k/2n}).  x and y are real
// (batch, n) lines.
int vk_fft_dct2(const float* x, float* y, long long batch, int dst,
                const int* plan, const float* table, int rot_off, void* stream) {
  return launch(dct2_kernel, x, y, batch, dst, plan, table, rot_off, 0, stream);
}

int vk_fft_dct3(const float* x, float* y, long long batch, int dst,
                const int* plan, const float* table, int rot_off, void* stream) {
  return launch(dct3_kernel, x, y, batch, dst, plan, table, rot_off, 1, stream);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
