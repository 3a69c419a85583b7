// fft_dct4: batched DCT-IV / DST-IV of contiguous real (B, n) fp32 lines, any
// n, unnormalized (scipy's norm=None), times `scale`.
// Replaces vkfft_tpu/ops/pallas_engine.py:3080 _dct4_kernel (its host side:
// _build_dct4_call, dct4_lines, dst4_lines).
//
// Bound: bytes (4n bytes in and out a line, the flops of an n/2-point
// complex FFT a line).  The TPU kernel runs every n as one complex
// 2n-point zero-padded pipeline, because Mosaic cannot shuffle.  Here even
// n takes the reference's n/2 trick (appendDCTIV_even_read / _write,
// vkFFT_R2R.h:2318/2946; the derivation is in vkfft_tpu/transforms/r2r.py
// _dct4_even): m = n/2,
//   w[j] = (x[2j] + i x[n-1-2j]) pre[j],   pre[j] = e^{-i pi (4j+1)/4n},
//   W = FFT_m(w),
//   y[2t] = Re(post[t] W[t]),  y[2t+1] = Re(conj(post[t+1]) W[m-1-t]),
//   post[k] = 2 scale e^{-i pi k/n}.
// Odd n is a real DFT of the same n points (S. C. Chan and K. L. Ho, "Fast
// algorithms for computing the discrete cosine transform", IEEE Trans.
// Circuits Syst. II 39 (3), 1992; the form of FFTW's reodft11e-r2hc-odd.c,
// which rests on the 8 x n prime-factor split of the 8n-point DFT behind
// DCT-IV): the line permuted with signs,
//   buf[i] = +-x[pi(i)],  m = n/2 + 4i mod 4n:  x[m] (m < n),
//   -x[2n-1-m] (m < 2n), -x[m-2n] (m < 3n), x[4n-1-m],
// then X = DFT_n(buf), and each bin X[k] = c + i s gives two outputs with
// signs (re11_outputs), times sqrt 2: a quarter of the 2n-point form's
// work, and two real lines ride one complex n-point pipeline as in
// fft_dct23 (X_a[k] = (Z[k] + conj Z[n-k]) / 2, X_b[k] = (Z[k] - conj
// Z[n-k]) / 2i).
// DST-IV = reverse(DCT-IV((-1)^j x)): the signs ride the read, the
// reversal the write.
//
// Design: the in-place walk (dct_walk.cuh, inplace.cuh's
// two_factor_passes) with the layout rule cuda_kernels.dct4_layout (the
// pipelines of n/2 points, a line each, or of n points, two lines each, a
// block; one pass or two factors; checked exactly by the C entry).  Even
// n reads each line as n/2 float2 pairs (x[2s], x[2s+1]) by cp.async,
// straight to point s, and a sweep in place builds w[s] and w[m-1-s] from
// the pair of points (s, m-1-s) that holds their four floats; its write
// takes W[t] and W[m-1-t] once for the four outputs they feed, two float2
// stores.  Odd n copies float j of both lines of a pipeline by cp.async
// straight to its point of the permutation (a negated float through a
// register), one thread the two; its write takes a
// pair of bins Z[k], Z[n-k] once for the four outputs of X_a[k] and
// X_b[k].  The rotations come from tables in shared memory, the one at
// m-k (m-1-j) from the one at k (j).
#include "dct_walk.cuh"

namespace {

using vkfft::Plan;
using vkfft::cmul;
using namespace vkfft::walk;

// (-x) where `neg`, else x.
__device__ __forceinline__ float signed_by(float x, int neg) {
  return neg ? -x : x;
}

__global__ void __launch_bounds__(kRealThreads, kRealMinBlocks)
dct4_even_kernel(const float* x, float* y, long long batch, int dst, Plan p1,
                 Plan p2, const float2* t1, const float2* t2, const float2* tw,
                 Geo g) {
  extern __shared__ __align__(16) float2 smem[];
  load_tables(stage_tables_at(smem, g), t1, t2, tw, g.len1, g.len2, g.ntw);
  load_pairs_async(reinterpret_cast<const float2*>(x),
                   block_line0(g.lines) * (int)g.dp.d,
                   block_lines(g.lines, batch) * (int)g.dp.d, in_map(g), smem);
  __syncthreads();
  {
    // one thread a pair of points (s, m-1-s) (Geo.dper = (m+1)/2 of them):
    // A = (x[2s], x[2s+1]), B = (x[n-2-2s], x[n-1-2s]); w[s] = (A.x + i
    // B.y) pre[s], w[m-1-s] = (B.x + i A.y) pre[m-1-s].  n is even, so
    // DST-IV's sign (-1)^j flips the odd floats, the imaginary parts.
    // pre[m-1-j] = C conj(pre[j]), C = e^{-i pi (n-1)/2n} = pre[m-1] pre[0]
    const int m = g.dp.d;
    const float2* pre = twiddles_at(smem, g) + g.rot1;
    const float2 c = cmul(root(pre, m - 1), root(pre, 0));
    for (int t = threadIdx.x; t < block_lines(g.lines, batch) * (int)g.dper.d;
         t += blockDim.x) {
      const int q = quot(t, g.dper);
      const int j = t - q * (int)g.dper.d;
      const int at = position(q * m + j, in_map(g));
      const int bt = position(q * m + m - 1 - j, in_map(g));
      const float2 a = smem[at], b = smem[bt];
      const float2 r = root(pre, j);
      const float2 wa = cmul(make_float2(a.x, signed_by(b.y, dst)), r);
      const float2 wb = cmul(make_float2(b.x, signed_by(a.y, dst)),
                             cmul(c, make_float2(r.x, -r.y)));
      smem[at] = wa;
      if (at != bt) smem[bt] = wb;
    }
  }
  __syncthreads();
  dct_passes(smem, g, p1, p2, block_lines(g.lines, batch), true);
  {
    // one thread a pair (t, m-1-t): y[2t] = Re(post[t] W[t]), y[2t+1] =
    // Re(conj(post[t+1]) W[m-1-t]), and the same for m-1-t; DST-IV stores
    // (y[2t+1], y[2t]) at n-2-2t
    const int n = g.dl.d, m = g.dp.d;
    const float2* post = twiddles_at(smem, g) + g.rot2;
    float* y0 = y + block_line0(g.lines) * n;
    for (int t = threadIdx.x; t < block_lines(g.lines, batch) * (int)g.dper.d;
         t += blockDim.x) {
      const int q = quot(t, g.dper);
      const int j = t - q * (int)g.dper.d;
      const int jb = m - 1 - j;
      const float2 a = smem[position(q * m + j, out_map(g))];
      const float2 b = smem[position(q * m + jb, out_map(g))];
      float2* yq = reinterpret_cast<float2*>(y0 + (long long)q * n);
      const float2 r = root(post, j), r1 = root(post, j + 1);
      const float2 ya = make_float2(re_mul(r, a), r1.x * b.x + r1.y * b.y);
      yq[dst ? m - 1 - j : j] = dst ? make_float2(ya.y, ya.x) : ya;
      if (jb != j) {
        // post[m-k] = -i conj(post[k]): post[jb] from post[j+1], post[jb+1]
        // from post[j]
        const float2 s = make_float2(-r1.y, -r1.x);
        const float2 s1 = make_float2(-r.y, -r.x);
        const float2 yb = make_float2(re_mul(s, b), s1.x * a.x + s1.y * a.y);
        yq[dst ? j : jb] = dst ? make_float2(yb.y, yb.x) : yb;
      }
    }
  }
}

// Where float j of an odd-n line goes in odd_kernel's permutation (the
// inverse of buf[i] = +-x[pi(i)]): point i, negated where `neg`.
__device__ __forceinline__ int re11_point(int j, int n, int& neg) {
  const int n2 = n >> 1;
  const int d = j - n2;
  if ((d & 1) == 0) {
    neg = (d & 3) != 0;
    return neg ? (j + 2 * n - n2) >> 2 : (d < 0 ? d + 4 * n : d) >> 2;
  }
  const int e = 2 * n - 1 - j - n2;
  neg = (e & 3) == 0;
  return neg ? e >> 2 : (4 * n - 1 - j - n2) >> 2;
}

// (-1)^e v.
__device__ __forceinline__ float parity(float v, int e) {
  return (e & 1) ? -v : v;
}

// The two outputs (p0, v0), (p1, v1) of bin k of the permuted line's DFT,
// X[k] = c + i s, k <= n/2, before the factor sqrt 2 (FFTW's
// reodft11e-r2hc-odd.c post-processing, one bin at a time): bin 0 gives
// output n/2 alone (p1 = p0), an odd bin k = 2i + 1 outputs i and n-1-i,
// an even bin k = 2i + 2 outputs n/2-1-i and n/2+1+i.
__device__ __forceinline__ void re11_outputs(int k, int n, float c, float s,
                                             int& p0, float& v0, int& p1,
                                             float& v1) {
  const int n2 = n >> 1;
  if (k == 0) {
    p0 = p1 = n2;
    v0 = v1 = parity(c, (n2 + 1) >> 1);
  } else if (k & 1) {
    const int i = k >> 1;
    p0 = i;
    v0 = parity(c, (i + 1) >> 1) + parity(s, i >> 1);
    p1 = n - 1 - i;
    v1 = parity(c, (n - i) >> 1) - parity(s, (n - 1 - i) >> 1);
  } else {
    const int i = (k >> 1) - 1;
    p0 = n2 - 1 - i;
    v0 = parity(c, (n2 - i) >> 1) - parity(s, (n2 - 1 - i) >> 1);
    p1 = n2 + 1 + i;
    v1 = parity(c, (n2 + i + 2) >> 1) + parity(s, (n2 + 1 + i) >> 1);
  }
}

__global__ void __launch_bounds__(kRealThreads, kRealMinBlocks)
dct4_odd_kernel(const float* x, float* y, long long batch, int dst, Plan p1,
                Plan p2, const float2* t1, const float2* t2, const float2* tw,
                Geo g) {
  extern __shared__ __align__(16) float2 smem[];
  const int per = 2 * g.lines;
  load_tables(stage_tables_at(smem, g), t1, t2, tw, g.len1, g.len2, g.ntw);
  {
    // one thread float j of both lines of a pipeline: to point
    // re11_point(j), line a's the real part and line b's the imaginary
    // one (a missing b line's 0); DST-IV's (-1)^j rides the permutation's
    // sign, a negated float through a register
    const int n = g.dl.d;
    const int nl = block_lines(per, batch);
    const float* x0 = x + block_line0(per) * n;
    for (int t = threadIdx.x; t < ((nl + 1) >> 1) * n; t += blockDim.x) {
      const int q = quot(t, g.dl);
      const int j = t - q * n;
      int neg;
      const int i = re11_point(j, n, neg);
      neg ^= dst & j & 1;
      float* d =
          reinterpret_cast<float*>(smem + position(q * n + i, in_map(g)));
      const float* xa = x0 + (long long)(2 * q) * n + j;
      if (neg)
        d[0] = -xa[0];
      else
        cp_async4(d, xa);
      if (2 * q + 1 >= nl)
        d[1] = 0.f;
      else if (neg)
        d[1] = -xa[n];
      else
        cp_async4(d + 1, xa + n);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();
  dct_passes(smem, g, p1, p2, (block_lines(per, batch) + 1) >> 1, true);
  {
    // one thread a pair of bins (k, n-k) of a pipeline (Geo.dper = n/2 + 1
    // of them): 2 X_a[k] = (A.x + B.x, A.y - B.y), 2 X_b[k] = (A.y + B.y,
    // B.x - A.x) for A = Z[k], B = Z[n-k]; the factor sqrt 2 scale / 2 is
    // the twiddle's last point
    const int n = g.dl.d;
    const int nl = block_lines(per, batch);
    const float f = twiddles_at(smem, g)[g.rot1].x;
    float* y0 = y + block_line0(per) * n;
    for (int t = threadIdx.x; t < ((nl + 1) >> 1) * (int)g.dper.d;
         t += blockDim.x) {
      const int q = quot(t, g.dper);
      const int k = t - q * (int)g.dper.d;
      const float2 a = smem[position(q * n + k, out_map(g))];
      const float2 b = smem[position(q * n + (k ? n - k : 0), out_map(g))];
      float* ya = y0 + (long long)(2 * q) * n;
      int p0, p1;
      float v0, v1;
      re11_outputs(k, n, a.x + b.x, a.y - b.y, p0, v0, p1, v1);
      ya[dst ? n - 1 - p0 : p0] = f * v0;
      ya[dst ? n - 1 - p1 : p1] = f * v1;
      if (2 * q + 1 < nl) {
        re11_outputs(k, n, a.y + b.y, b.x - a.x, p0, v0, p1, v1);
        ya[n + (dst ? n - 1 - p0 : p0)] = f * v0;
        ya[n + (dst ? n - 1 - p1 : p1)] = f * v1;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() after the launch (0 on
// success).  x and y are real (batch, n) lines, both 8-byte aligned for
// even n.  `plan1`/`plan2` are the int forms of the forward n1- and n2-point
// plans of the pipeline, n1 * n2 = n/2 points (n even) or n (n odd; `plan2`
// the empty plan of length 1 for one pass), `table1`/`table2` their stage
// tables (no scale) and `twiddle` the inter-factor twiddle's two tables of
// the pipeline's points, then (even n) the pre-rotation's table and the
// post-rotation's with 2 `scale`, or (odd n) one point (sqrt 2 scale / 2,
// 0) (cuda_kernels.dct4_twiddle), all as interleaved fp32 pairs.  The
// layout (cuda_kernels.dct4_layout): `threads` a block (a multiple of 32 up
// to 512, enough for a whole sequence of every stage in a round), `lines`
// pipelines a block (lines * points <= 16384) and the dynamic shared
// bytes, exactly what the layout needs and at most 227 KB; any other
// layout is refused (cudaErrorInvalidValue).
int vk_fft_dct4(const float* x, float* y, long long batch, int n, int dst,
                const int* plan1, const int* plan2, const float* table1,
                const float* table2, const float* twiddle, int threads,
                int lines, int smem, void* stream) {
  if (n < 4 || (dst != 0 && dst != 1)) return (int)cudaErrorInvalidValue;
  const bool even = n % 2 == 0;
  // even: pipelines of n/2 points, a line each, read as float2 pairs;
  // odd: of n points, two lines each
  if (even && (((uintptr_t)x | (uintptr_t)y) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const int points = even ? n / 2 : n;
  // twiddle points: the inter-factor twiddle, then pre and post (even n)
  // or the output factor (odd n)
  const int rot1 = rotation_points(points);
  const int rot2 = even ? rot1 + rotation_points(n / 2) : 0;
  const int ntw = even ? rot2 + rotation_points(n / 2 + 1) : rot1 + 1;
  const auto kernel = even ? dct4_even_kernel : dct4_odd_kernel;
  Plan p1, p2;
  long long blocks;
  const int err = walk_prepare(kernel, batch, plan1, plan2, points, 0,
                               threads, lines, smem, ntw,
                               even ? lines : 2 * lines, &p1, &p2, &blocks);
  if (err) return err;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      x, y, batch, dst, p1, p2, reinterpret_cast<const float2*>(table1),
      reinterpret_cast<const float2*>(table2),
      reinterpret_cast<const float2*>(twiddle),
      make_geo(n, p1, p2, even ? (points + 1) / 2 : n / 2 + 1, lines, ntw,
               rot1, rot2));
  return (int)cudaGetLastError();
}

// Resident blocks an SM of the even-n (odd = 0) or odd-n kernel at
// `threads` a block and `smem` dynamic shared bytes, into *blocks.
int vk_fft_dct4_occupancy(int odd, int threads, int smem, int* blocks) {
  return odd ? walk_occupancy(dct4_odd_kernel, threads, smem, blocks)
             : walk_occupancy(dct4_even_kernel, threads, smem, blocks);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
