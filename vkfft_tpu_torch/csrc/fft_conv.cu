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
// form Y * rsqrt(|Y|^2 + 1e-30) (pallas_engine.py:4665).  The caller's
// scale rides the inverse twiddle's table.
//
// Bound: bytes.  Each point of the planes is read once and written once
// (16 B), the spectrum once a launch; the two m-point FFTs a line are
// ~10 m log2 m flops, under the card's fp32 rate for those bytes at m <=
// 8192.  Design: the walk of inplace.cuh, as fft_lines runs it, twice on
// one copy.  A block holds `lines` lines (cuda_kernels.conv_layout, the
// one layout rule, which the C entry checks: short lines share a block up
// to 8192 points, a thread for about 16 of them in one pass or 32 in two
// factors; in the matrix mode whole items of mm lines) once each as the
// (n2, n1) matrix at the odd pitch n1 | 1, beside the forward and inverse
// stage tables of both factors and the two twiddles' tables.  The read
// goes by cp.async, each float straight to its place (Bluestein: one
// sweep then multiplies the chirp and zeroes [n, m), so the pad never
// exists in device memory).  The forward runs the column pass (its
// twiddle on the last stage) and the row pass, which leaves bin k1 * n2 +
// k2 at [k2][k1] (natural order in one pass, n2 = 1); one sweep multiplies
// each bin by the caller's natural-order table at its natural index (no
// table is permuted on the host; the matrix mode mixes the mm lines of
// each item there); the inverse runs the mirrored passes (rows, the
// conjugate twiddle with the scale, columns) back to natural order in
// place, and the store takes the first n points (times the chirp).  The spectrum, the chirp
// and the rows table (2 MiB at 512 x 512) are read through the read-only
// cache and stay in the 50 MB L2 across blocks.  A block reads all its
// lines before it writes any, so the output may alias the input.
//
// Half storage (fft_conv_f16_kernel, fft_conv_bf16_kernel; C entries
// vk_fft_conv_f16, vk_fft_conv_bf16): the fp32 kernel's body, layout,
// bound and every mode on __half or __nv_bfloat16 planes, 8 B a point of
// device memory where fp32 moves 16; the spectrum, chirp and stage tables,
// shared memory and every stage stay fp32.  cp.async has no 2-byte copy,
// so the lines come in through registers (inplace.cuh's load_lines: four
// halves a plane in one 8-byte load), widened, and go out narrowed once,
// to nearest even, after the chirp (store_lines).
//
// Bluestein's read window (fft_conv_zp_kernel and its half twins; C
// entries vk_fft_conv_zp, vk_fft_conv_zp_f16, vk_fft_conv_zp_bf16):
// _conv_v3_kernel's blu_in.  A declared-zero input tail [keep, n) of each
// line is never read: the read takes the first `keep` points of each line
// at the line pitch n (inplace.cuh's load_prefix; the pitch and the read
// bound are two numbers), the chirp sweep zeroes [keep, m), and the
// write keeps all n points.  Every stage reads all of its inputs: a
// first stage pruned to the live rows spilled and saved nothing (PERF.md
// section 6).  The same body (conv_block<St, true>), so the unwindowed
// kernels compile as before.
#include "inplace.cuh"
#include "twofactor.cuh"

namespace {

using vkfft::Plan;
using vkfft::cmul;
using namespace vkfft::walk;

constexpr int kThreads = 512;  // most threads a block
constexpr int kMinBlocks = 2;  // blocks an SM the register budget keeps
constexpr int kConjData = 1;
constexpr int kXpow = 2;

// A launch's geometry, every count and divisor from the host: the device
// line's points n, the first factor n1 and the spectrum's rows; m = n1 *
// n2, lines a block (whole items of mm lines), the pitch n1 | 1, the flags
// and the stage tables' points of the n1 and n2 runs (the same for both
// directions).
struct Geo {
  Div dn, d1, drows;
  int m, lines, mm, pitch, flags, len1, len2;
};

__device__ __forceinline__ float2 xpow_scale(float2 y) {
  const float s = rsqrtf(fmaf(y.x, y.x, fmaf(y.y, y.y, 1e-30f)));
  return make_float2(y.x * s, y.y * s);
}

// The multiply over the forward spectra of the block's nl lines, in
// place, bin K of a line at `at`'s place (K = k1 * n2 + k2 at [k2][k1]),
// the data first conjugated (kConjData) and the product divided by its
// modulus (kXpow): MM = 1, line q (the block's first line0) times row
// (line0 + q) % rows of the spectrum; MM > 1, each item of MM lines mixed
// by the (MM, MM, m) matrix.  One sweep after the forward passes: as the
// hook of their last stage, the spectrum's loads, batched by the
// compiler across a round's outputs, made the stages spill.
template <int MM>
__device__ void multiply(float2* home, const Map& at, int nl, int m,
                         long long line0, Div drows, const float2* spec,
                         int flags) {
  const bool conj = flags & kConjData, xpow = flags & kXpow;
  const int S = at.S;
  const int r0 = (int)(line0 % (long long)drows.d);
  for (int t = threadIdx.x; t < nl / MM * m; t += blockDim.x) {
    const int it = quot(t, at.dn);
    const int K = t - it * m;
    const int pos = it * MM * S + position(K, at);
    const float2* row = spec;
    if (MM == 1) {
      const int r = r0 + it;
      row += (r - quot(r, drows) * (int)drows.d) * m;
    }
    float2 x[MM];
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      x[i] = home[pos + i * S];
      if (conj) x[i].y = -x[i].y;
    }
#pragma unroll
    for (int o = 0; o < MM; ++o) {
      float2 y = make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < MM; ++i)
        y = vkfft::cadd(y, cmul(x[i], __ldg(&row[(o * MM + i) * m + K])));
      home[pos + o * S] = xpow ? xpow_scale(y) : y;
    }
  }
}

// A stored point times the chirp at its index (none when chirp is null).
struct ChirpOut {
  const float2* chirp;
  __device__ __forceinline__ float2 operator()(float2 v, int, int t) const {
    return chirp == nullptr ? v : cmul(v, __ldg(&chirp[t]));
  }
};

// The block body on planes of storage type St (float, or a half type on
// the same fp32 walk).  With kWindow, Bluestein's read window: the first
// `keep` points of each line read, the rest zeros.
template <class St, bool kWindow = false>
__device__ __forceinline__ void conv_block(
    float2* smem, const St* xr, const St* xi, St* yr, St* yi,
    long long batch, const Geo& geo, const Plan& pf1, const Plan& pf2,
    const Plan& pi1, const Plan& pi2, const float2* tf1, const float2* tf2,
    const float2* ti1, const float2* ti2, const float2* twf,
    const float2* twi, const float2* spec, const float2* chirp,
    int keep = 0) {
  const int n1 = pf1.n, n2 = pf2.n, m = geo.m, n = (int)geo.dn.d;
  const int P = geo.pitch, S = n2 * P;
  const int nl = block_lines(geo.lines, batch);
  float2* home = smem;
  // after the lines the forward set of tables (n1 and n2 stages, the
  // twiddle), then the inverse set
  const int ntw = rotation_points(m);
  const int set = geo.len1 + geo.len2 + ntw;
  float2* tab = home + geo.lines * S;
  load_tables(tab, tf1, tf2, twf, geo.len1, geo.len2, ntw);
  load_tables(tab + set, ti1, ti2, twi, geo.len1, geo.len2, ntw);
  // point j < n of a line at (j / n1) * P + j % n1, on the read and on
  // the store
  if constexpr (kWindow)
    load_prefix(xr, xi, block_line0(geo.lines) * n, nl, keep,
                Map{geo.dn, geo.d1, S, P, 1}, home);
  else if constexpr (kNarrow<St>)
    load_lines(xr, xi, block_line0(geo.lines) * n, nl * n,
               Map{geo.dn, geo.d1, S, P, 1}, home);
  else
    load_lines_async(xr, xi, block_line0(geo.lines) * n, nl * n,
                     Map{geo.dn, geo.d1, S, P, 1}, home);
  __syncthreads();
  if (chirp != nullptr) {
    const Div dm = make_div(m);
    const int live = kWindow ? keep : n;
    for (int u = threadIdx.x; u < nl * m; u += blockDim.x) {
      const int line = quot(u, dm);
      const int j = u - line * m;
      const int r = quot(j, geo.d1);
      const int at = line * S + r * P + j - r * n1;
      home[at] = j < live ? cmul(home[at], __ldg(&chirp[j]))
                          : make_float2(0.f, 0.f);
    }
    __syncthreads();
  }
  // the forward column pass (the twiddle on its last stage), row pass,
  // the multiply, the inverse row pass (the conjugate twiddle and the scale
  // on its last stage), column pass; one call site of run_pass keeps one
  // copy of each stage
  for (int k = 0; k < 4; ++k) {
    if (k == 2) {
      const Map at = make_map(m, S, true, n1, n2, P);
      const long long line0 = block_line0(geo.lines);
      if (geo.mm == 1)
        multiply<1>(home, at, nl, m, line0, geo.drows, spec, geo.flags);
      else if (geo.mm == 2)
        multiply<2>(home, at, nl, m, line0, geo.drows, spec, geo.flags);
      else
        multiply<3>(home, at, nl, m, line0, geo.drows, spec, geo.flags);
      __syncthreads();
    }
    const bool row = k == 1 || k == 2;
    const Pass g = row ? Pass{nl * n2, S, P, 1, make_div(n2)}
                       : Pass{nl * n1, S, 1, P, geo.d1};
    const float2* tables = tab + (k < 2 ? 0 : set);
    const float2* tlo = tables + geo.len1 + geo.len2;
    run_pass(home, g, k == 0 ? pf2 : k == 1 ? pf1 : k == 2 ? pi1 : pi2,
             tables + (row ? 0 : geo.len1),
             InterTwiddle{k == 0 || k == 2 ? tlo : nullptr, tlo + kTwLo});
  }
  store_lines(home, Map{geo.dn, geo.d1, n2 * P, P, 1}, yr, yi,
              block_line0(geo.lines) * n, block_lines(geo.lines, batch) * n,
              ChirpOut{chirp});
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_conv_kernel(const float* xr, const float* xi, float* yr, float* yi,
                long long batch, Geo geo, Plan pf1, Plan pf2, Plan pi1,
                Plan pi2, const float2* tf1, const float2* tf2,
                const float2* ti1, const float2* ti2, const float2* twf,
                const float2* twi, const float2* spec, const float2* chirp) {
  extern __shared__ __align__(16) float2 smem[];
  conv_block(smem, xr, xi, yr, yi, batch, geo, pf1, pf2, pi1, pi2, tf1, tf2,
             ti1, ti2, twf, twi, spec, chirp);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_conv_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                    __half* yi, long long batch, Geo geo, Plan pf1, Plan pf2,
                    Plan pi1, Plan pi2, const float2* tf1, const float2* tf2,
                    const float2* ti1, const float2* ti2, const float2* twf,
                    const float2* twi, const float2* spec,
                    const float2* chirp) {
  extern __shared__ __align__(16) float2 smem[];
  conv_block(smem, xr, xi, yr, yi, batch, geo, pf1, pf2, pi1, pi2, tf1, tf2,
             ti1, ti2, twf, twi, spec, chirp);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_conv_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                     __nv_bfloat16* yr, __nv_bfloat16* yi, long long batch,
                     Geo geo, Plan pf1, Plan pf2, Plan pi1, Plan pi2,
                     const float2* tf1, const float2* tf2, const float2* ti1,
                     const float2* ti2, const float2* twf, const float2* twi,
                     const float2* spec, const float2* chirp) {
  extern __shared__ __align__(16) float2 smem[];
  conv_block(smem, xr, xi, yr, yi, batch, geo, pf1, pf2, pi1, pi2, tf1, tf2,
             ti1, ti2, twf, twi, spec, chirp);
}

// Bluestein's read window: conv_block<St, true>, the first `keep` points
// of each line read.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_conv_zp_kernel(const float* xr, const float* xi, float* yr, float* yi,
                   long long batch, Geo geo, Plan pf1, Plan pf2, Plan pi1,
                   Plan pi2, const float2* tf1, const float2* tf2,
                   const float2* ti1, const float2* ti2, const float2* twf,
                   const float2* twi, const float2* spec, const float2* chirp,
                   int keep) {
  extern __shared__ __align__(16) float2 smem[];
  conv_block<float, true>(smem, xr, xi, yr, yi, batch, geo, pf1, pf2, pi1,
                          pi2, tf1, tf2, ti1, ti2, twf, twi, spec, chirp,
                          keep);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_conv_zp_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                       __half* yi, long long batch, Geo geo, Plan pf1,
                       Plan pf2, Plan pi1, Plan pi2, const float2* tf1,
                       const float2* tf2, const float2* ti1,
                       const float2* ti2, const float2* twf,
                       const float2* twi, const float2* spec,
                       const float2* chirp, int keep) {
  extern __shared__ __align__(16) float2 smem[];
  conv_block<__half, true>(smem, xr, xi, yr, yi, batch, geo, pf1, pf2, pi1,
                           pi2, tf1, tf2, ti1, ti2, twf, twi, spec, chirp,
                           keep);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_conv_zp_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                        __nv_bfloat16* yr, __nv_bfloat16* yi,
                        long long batch, Geo geo, Plan pf1, Plan pf2,
                        Plan pi1, Plan pi2, const float2* tf1,
                        const float2* tf2, const float2* ti1,
                        const float2* ti2, const float2* twf,
                        const float2* twi, const float2* spec,
                        const float2* chirp, int keep) {
  extern __shared__ __align__(16) float2 smem[];
  conv_block<__nv_bfloat16, true>(smem, xr, xi, yr, yi, batch, geo, pf1, pf2,
                                  pi1, pi2, tf1, tf2, ti1, ti2, twf, twi,
                                  spec, chirp, keep);
}

// The checks and the launch of `kernel` on planes of storage type St, as
// vk_fft_conv describes them; with kWindow, the windowed `kernel` reading
// the first `in_keep` points of each line (1 <= in_keep <= n, 0 for all
// n; the Bluestein mode only).
template <bool kWindow = false, class St, typename K>
int launch(K kernel, const St* xr, const St* xi, St* yr, St* yi,
           long long lines, int n, int mm, int rows, int flags,
           const int* plan_f1, const int* plan_f2, const int* plan_i1,
           const int* plan_i2, const float* table_f1, const float* table_f2,
           const float* table_i1, const float* table_i2,
           const float* twiddle_f, const float* twiddle_i,
           const float* spectrum, const float* chirp, int threads, int per,
           int smem, void* stream, int in_keep = 0) {
  Plan pf1, pf2, pi1, pi2;
  if (lines < 1 || !vkfft::plan_from_ints(plan_f1, &pf1) ||
      !vkfft::subplan_from_ints(plan_f2, &pf2) ||
      !vkfft::plan_from_ints(plan_i1, &pi1) ||
      !vkfft::subplan_from_ints(plan_i2, &pi2) || spectrum == nullptr ||
      twiddle_f == nullptr || twiddle_i == nullptr)
    return (int)cudaErrorInvalidValue;
  if (pf1.n != pi1.n || pf2.n != pi2.n || pf1.inverse || pf2.inverse ||
      !pi1.inverse || !pi2.inverse || pf1.n < pf2.n)
    return (int)cudaErrorInvalidValue;
  const int m = pf1.n * pf2.n;
  if (m < 2 || m > vkfft::kMaxN || mm < 1 || mm > 3 || rows < 1 ||
      (flags & ~(kConjData | kXpow)) || lines % mm || (mm > 1 && rows != 1))
    return (int)cudaErrorInvalidValue;
  if (chirp == nullptr ? n != m
                       : (n < 1 || n >= m || mm != 1 || rows != 1 || flags))
    return (int)cudaErrorInvalidValue;
  const Geo geo{make_div(n), make_div(pf1.n), make_div(rows), m, per, mm,
                pf1.n | 1, flags, table_len(pf1), table_len(pf2)};
  const size_t need =
      sizeof(float2) * ((size_t)per * pf2.n * (pf1.n | 1) +
                        2 * (geo.len1 + geo.len2 + rotation_points(m)));
  if (table_len(pi1) != geo.len1 || table_len(pi2) != geo.len2 ||
      threads < 32 || threads > kThreads || threads % 32 != 0 || per < 1 ||
      per % mm || (long long)per * m > vkfft::kTwoFactorMaxN ||
      !rounds_fit(pf1, threads) || !rounds_fit(pf2, threads) ||
      !rounds_fit(pi1, threads) || !rounds_fit(pi2, threads) || smem < 0 ||
      (size_t)smem != need || smem > vkfft::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (lines + per - 1) / per;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (kWindow && (chirp == nullptr || in_keep < 0 || in_keep > n))
    return (int)cudaErrorInvalidValue;
  const int err = smem_opt_in(kernel, smem);
  if (err) return err;
  const auto tab = [](const float* t) {
    return reinterpret_cast<const float2*>(t);
  };
  if constexpr (kWindow)
    kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
        xr, xi, yr, yi, lines, geo, pf1, pf2, pi1, pi2, tab(table_f1),
        tab(table_f2), tab(table_i1), tab(table_i2), tab(twiddle_f),
        tab(twiddle_i), tab(spectrum), tab(chirp), in_keep ? in_keep : n);
  else
    kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
        xr, xi, yr, yi, lines, geo, pf1, pf2, pi1, pi2, tab(table_f1),
        tab(table_f2), tab(table_i1), tab(table_i2), tab(twiddle_f),
        tab(twiddle_i), tab(spectrum), tab(chirp));
  return (int)cudaGetLastError();
}

template <typename K>
int occupancy(K kernel, int threads, int smem, int* blocks) {
  if (threads < 32 || threads > kThreads || smem < 0 ||
      smem > vkfft::kMaxSmemBytes || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  const int err = smem_opt_in(kernel, smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            threads, smem);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  `lines` lines of n points (matrix mode: lines = B * mm, item
// b's mm coordinate lines consecutive); `mm` 1, 2 or 3; `rows` the rows of
// the spectrum (1: one shared row); `flags` kConjData | kXpow.  Plans (int
// form) and stage tables (no scale) of the forward n1 and n2 and the
// inverse n1 and n2 runs of m = n1 * n2 (n2 the empty plan of length 1 for
// one pass), `twiddle_f`/`twiddle_i` the forward and the inverse twiddle's
// two tables (64 points w_m^(-+b), then ceil(m / 64) points scale *
// w_m^(-+64 a), the caller's scale in the inverse's), `spectrum` the rows
// * m (matrix: mm * mm * m) table in natural order and `chirp` the n-point
// chirp (null but in the Bluestein mode, where mm = rows = 1, flags = 0
// and n < m; elsewhere n must equal m), all as interleaved fp32 pairs.
// The layout (cuda_kernels.conv_layout): `threads` a block (a multiple of
// 32 up to 512, enough for a whole sequence of every stage in a round),
// `per` lines a block (a multiple of mm) and the dynamic shared bytes,
// which must be exactly what the layout needs and at most 227 KB; any
// other layout is refused (cudaErrorInvalidValue).
int vk_fft_conv(const float* xr, const float* xi, float* yr, float* yi,
                long long lines, int n, int mm, int rows, int flags,
                const int* plan_f1, const int* plan_f2, const int* plan_i1,
                const int* plan_i2, const float* table_f1,
                const float* table_f2, const float* table_i1,
                const float* table_i2, const float* twiddle_f,
                const float* twiddle_i, const float* spectrum,
                const float* chirp, int threads, int per, int smem,
                void* stream) {
  return launch(fft_conv_kernel, xr, xi, yr, yi, lines, n, mm, rows, flags,
                plan_f1, plan_f2, plan_i1, plan_i2, table_f1, table_f2,
                table_i1, table_i2, twiddle_f, twiddle_i, spectrum, chirp,
                threads, per, smem, stream);
}

// vk_fft_conv on fp16 / bf16 planes (the tables, spectrum and chirp fp32,
// as vk_fft_conv's).
int vk_fft_conv_f16(const __half* xr, const __half* xi, __half* yr,
                    __half* yi, long long lines, int n, int mm, int rows,
                    int flags, const int* plan_f1, const int* plan_f2,
                    const int* plan_i1, const int* plan_i2,
                    const float* table_f1, const float* table_f2,
                    const float* table_i1, const float* table_i2,
                    const float* twiddle_f, const float* twiddle_i,
                    const float* spectrum, const float* chirp, int threads,
                    int per, int smem, void* stream) {
  return launch(fft_conv_f16_kernel, xr, xi, yr, yi, lines, n, mm, rows,
                flags, plan_f1, plan_f2, plan_i1, plan_i2, table_f1, table_f2,
                table_i1, table_i2, twiddle_f, twiddle_i, spectrum, chirp,
                threads, per, smem, stream);
}

int vk_fft_conv_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                     __nv_bfloat16* yr, __nv_bfloat16* yi, long long lines,
                     int n, int mm, int rows, int flags, const int* plan_f1,
                     const int* plan_f2, const int* plan_i1,
                     const int* plan_i2, const float* table_f1,
                     const float* table_f2, const float* table_i1,
                     const float* table_i2, const float* twiddle_f,
                     const float* twiddle_i, const float* spectrum,
                     const float* chirp, int threads, int per, int smem,
                     void* stream) {
  return launch(fft_conv_bf16_kernel, xr, xi, yr, yi, lines, n, mm, rows,
                flags, plan_f1, plan_f2, plan_i1, plan_i2, table_f1, table_f2,
                table_i1, table_i2, twiddle_f, twiddle_i, spectrum, chirp,
                threads, per, smem, stream);
}

// vk_fft_conv's Bluestein mode under Bluestein's read window (fp32, fp16
// and bf16 planes): the first `in_keep` points of each line are read at
// the line pitch n and the rest are declared zero, never read (1 <=
// in_keep <= n; 0 for all n); every n points of a line are written.  The
// other modes are refused.
int vk_fft_conv_zp(const float* xr, const float* xi, float* yr, float* yi,
                   long long lines, int n, int mm, int rows, int flags,
                   const int* plan_f1, const int* plan_f2, const int* plan_i1,
                   const int* plan_i2, const float* table_f1,
                   const float* table_f2, const float* table_i1,
                   const float* table_i2, const float* twiddle_f,
                   const float* twiddle_i, const float* spectrum,
                   const float* chirp, int threads, int per, int smem,
                   int in_keep, void* stream) {
  return launch<true>(fft_conv_zp_kernel, xr, xi, yr, yi, lines, n, mm, rows,
                      flags, plan_f1, plan_f2, plan_i1, plan_i2, table_f1,
                      table_f2, table_i1, table_i2, twiddle_f, twiddle_i,
                      spectrum, chirp, threads, per, smem, stream, in_keep);
}

int vk_fft_conv_zp_f16(const __half* xr, const __half* xi, __half* yr,
                       __half* yi, long long lines, int n, int mm, int rows,
                       int flags, const int* plan_f1, const int* plan_f2,
                       const int* plan_i1, const int* plan_i2,
                       const float* table_f1, const float* table_f2,
                       const float* table_i1, const float* table_i2,
                       const float* twiddle_f, const float* twiddle_i,
                       const float* spectrum, const float* chirp, int threads,
                       int per, int smem, int in_keep, void* stream) {
  return launch<true>(fft_conv_zp_f16_kernel, xr, xi, yr, yi, lines, n, mm,
                      rows, flags, plan_f1, plan_f2, plan_i1, plan_i2,
                      table_f1, table_f2, table_i1, table_i2, twiddle_f,
                      twiddle_i, spectrum, chirp, threads, per, smem, stream,
                      in_keep);
}

int vk_fft_conv_zp_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                        __nv_bfloat16* yr, __nv_bfloat16* yi, long long lines,
                        int n, int mm, int rows, int flags,
                        const int* plan_f1, const int* plan_f2,
                        const int* plan_i1, const int* plan_i2,
                        const float* table_f1, const float* table_f2,
                        const float* table_i1, const float* table_i2,
                        const float* twiddle_f, const float* twiddle_i,
                        const float* spectrum, const float* chirp,
                        int threads, int per, int smem, int in_keep,
                        void* stream) {
  return launch<true>(fft_conv_zp_bf16_kernel, xr, xi, yr, yi, lines, n, mm,
                      rows, flags, plan_f1, plan_f2, plan_i1, plan_i2,
                      table_f1, table_f2, table_i1, table_i2, twiddle_f,
                      twiddle_i, spectrum, chirp, threads, per, smem, stream,
                      in_keep);
}

// Resident blocks an SM of the kernel at `threads` a block and `smem`
// dynamic shared bytes, into *blocks.
int vk_fft_conv_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_conv_kernel, threads, smem, blocks);
}

int vk_fft_conv_f16_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_conv_f16_kernel, threads, smem, blocks);
}

int vk_fft_conv_bf16_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_conv_bf16_kernel, threads, smem, blocks);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
