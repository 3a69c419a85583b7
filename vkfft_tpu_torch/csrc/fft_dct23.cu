// fft_dct23: batched DCT-II / DST-II and DCT-III / DST-III of contiguous real
// (B, n) fp32 lines, unnormalized (scipy's norm=None), times `scale`.
// Replaces vkfft_tpu/ops/pallas_engine.py:2745 _dct2_kernel and :2789
// _dct3_kernel (their host side: _build_dct_call, dct2_lines, dct3_lines,
// dst2_lines, dst3_lines).
//
// Bound: bytes.  A line moves 4n bytes in and 4n out and does the flops of
// half an n-point complex FFT plus O(n) rotations.  The TPU kernels run
// 2n-point zero-padded pipelines (DCT-II two of them for a pair of lines,
// DCT-III one per line) because Mosaic cannot permute.  Here the
// reference's own form (Makhoul; vkFFT_R2R.h:1541 appendDCTII_read_III_write,
// :1731 appendDCTII_write_III_read) runs at any n, even or odd, two real
// lines riding one n-point complex pipeline:
//   DCT-II:  v[j] = x[2j], v[n-1-j] = x[2j+1], z = v_a + i v_b, Z = FFT_n(z),
//            y_a[k] = Re(rot[k] (Z[k] + conj Z[n-k])),
//            y_b[k] = Re(rot[k] (-i) (Z[k] - conj Z[n-k])),
//            rot[k] = scale e^{-i pi k / 2n};
//   DCT-III: its inverse: U[k] = rot3[k] (c[k] - i c[n-k]) (c[n] = 0),
//            rot3[k] = scale e^{+i pi k / 2n}, Z = U_a + i U_b, the
//            unnormalized inverse FFT_n gives z = v_a + i v_b (each V is
//            Hermitian), and y[2j] = v[j], y[2j+1] = v[n-1-j].
// DST-II = reverse(DCT-II((-1)^j x)) and DST-III = (-1)^k DCT-III(reverse
// x): the signs and the reversal ride the read and the write.
//
// Design: the in-place walk (dct_walk.cuh, inplace.cuh's
// two_factor_passes) with the layout rule cuda_kernels.dct23_layout (the
// pipelines of n points a block, one pass or two factors, checked exactly
// by the C entry).  The read takes a pair of floats (2s, 2s+1) of both
// lines of a pipeline a thread and copies its four floats by cp.async
// straight to their points, in Makhoul's order (DCT-II) or natural or
// reversed order (DCT-III); DCT-III's pair combine then runs in place,
// one thread a pair (k, n-k).  DCT-II's write takes a pair of bins Z[k],
// Z[n-k] once for its four outputs, DCT-III's a pair of points for its
// four; the rotations come from two tables in shared memory, the one at
// n-k from the one at k.  The last pipeline of a block with an odd count
// of lines has a zero b line, whose outputs are not stored.
#include "dct_walk.cuh"

namespace {

using vkfft::Plan;
using vkfft::cmul;
using namespace vkfft::walk;

// The read of the block's nl real lines at x0, one thread a pair of
// floats (2s, 2s + 1), s < ceil(n / 2) (Geo.dh), of both lines of a
// pipeline: four cp.async copies straight to their points, line a's
// floats to the real parts and line b's to the imaginary ones (a missing b
// line and the float n of an odd line are not read; a missing b line's
// parts are 0).  DCT-II takes Makhoul's order, x[2s] to point s and
// x[2s+1] to point n - 1 - s (DST-II negates the odd floats, through a
// register); DCT-III the natural order, points 2s and 2s + 1 (DST-III, the
// line reversed: n - 1 - 2s and n - 2 - 2s).
__device__ __forceinline__ void load_quads(const float* x0, int nl, int dst,
                                           bool type3, const Geo& g,
                                           float2* home) {
  const int n = g.dl.d, h = g.dh.d;
  for (int t = threadIdx.x; t < ((nl + 1) >> 1) * h; t += blockDim.x) {
    const int q = quot(t, g.dh);
    const int s = t - q * h;
    const int e0 = type3 ? (dst ? n - 1 - 2 * s : 2 * s) : s;
    const int e1 = type3 ? (dst ? n - 2 - 2 * s : 2 * s + 1) : n - 1 - s;
    float* d0 =
        reinterpret_cast<float*>(home + position(q * n + e0, in_map(g)));
    float* d1 =
        reinterpret_cast<float*>(home + position(q * n + e1, in_map(g)));
    const float* xa = x0 + (long long)(2 * q) * n + 2 * s;
    const bool odd = 2 * s + 1 < n, has_b = 2 * q + 1 < nl;
    const bool neg = dst && !type3;
    cp_async4(d0, xa);
    if (has_b)
      cp_async4(d0 + 1, xa + n);
    else
      d0[1] = 0.f;
    if (odd) {
      if (neg)
        d1[0] = -xa[1];
      else
        cp_async4(d1, xa + 1);
      if (!has_b)
        d1[1] = 0.f;
      else if (neg)
        d1[1] = -xa[n + 1];
      else
        cp_async4(d1 + 1, xa + n + 1);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// DCT-III's pair combine in place on the block's np pipelines, one thread
// a pair (k, n - k): with A = (c_a[k], c_b[k]) and B = (c_a[n-k],
// c_b[n-k]) at their points, U[k] = rot3[k] (A.x + B.y, A.y - B.x) and
// U[n-k] = rot3[n-k] (B.x + A.y, B.y - A.x); at k = 0, B = c[n] = 0 and
// only U[0] is stored, at k = n/2 both are the same point and value.
// Ends on a barrier.
__device__ __forceinline__ void combine_dct3(float2* home, int np,
                                             const Geo& g, const float2* rot) {
  const int n = g.dl.d;
  for (int t = threadIdx.x; t < np * (int)g.dper.d; t += blockDim.x) {
    const int q = quot(t, g.dper);
    const int k = t - q * (int)g.dper.d;
    const int kb = k ? n - k : 0;
    const int at = position(q * n + k, in_map(g));
    const int bt = position(q * n + kb, in_map(g));
    const float2 a = home[at];
    const float2 b = k ? home[bt] : make_float2(0.f, 0.f);
    // rot3[n-k] = i conj(rot3[k]) (k > 0)
    const float2 r = root(rot, k);
    const float2 ua = cmul(r, make_float2(a.x + b.y, a.y - b.x));
    const float2 ub =
        cmul(make_float2(r.y, r.x), make_float2(b.x + a.y, b.y - a.x));
    home[at] = ua;
    if (k) home[bt] = ub;
  }
  __syncthreads();
}

// DCT-II's write, one thread a pair of bins (k, n - k) of a pipeline
// (Geo.dper = n/2 + 1 of them): A = Z[k], B = Z[n-k] give the four
// outputs y_a[k] = Re(rot[k] (A + conj B)), y_b[k] = Re(rot[k] (-i)(A -
// conj B)) and, swapping A and B, y_a[n-k], y_b[n-k] (k = 0: one bin;
// 2k = n: one output a line).  DST-II stores output k at n - 1 - k.
__device__ __forceinline__ void write_dct2(const float2* home, int np,
                                           int nl, int dst, const Geo& g,
                                           const float2* rot, float* y0) {
  const int n = g.dl.d;
  for (int t = threadIdx.x; t < np * (int)g.dper.d; t += blockDim.x) {
    const int q = quot(t, g.dper);
    const int k = t - q * (int)g.dper.d;
    const int kb = k ? n - k : 0;
    const float2 a = home[position(q * n + k, out_map(g))];
    const float2 b = home[position(q * n + kb, out_map(g))];
    // rot[n-k] = -i conj(rot[k]) (k > 0)
    const float2 rk = root(rot, k), rb = make_float2(-rk.y, -rk.x);
    float* ya = y0 + (long long)(2 * q) * n;
    float* yb = ya + n;
    const int ok = dst ? n - 1 - k : k;
    const int ob = dst ? n - 1 - kb : kb;
    const bool has_b = 2 * q + 1 < nl, pair = k != 0 && 2 * k != n;
    ya[ok] = re_mul(rk, make_float2(a.x + b.x, a.y - b.y));
    if (pair) ya[ob] = re_mul(rb, make_float2(b.x + a.x, b.y - a.y));
    if (has_b) {
      yb[ok] = re_mul(rk, make_float2(a.y + b.y, b.x - a.x));
      if (pair) yb[ob] = re_mul(rb, make_float2(b.y + a.y, a.x - b.x));
    }
  }
}

// DCT-III's write, one thread a pair of outputs (2j, 2j + 1) of a
// pipeline's two lines, j < (n + 1) / 2: y[2j] = v[j], y[2j+1] = v[n-1-j]
// (re for the a line, im for the b line); DST-III negates the odd
// outputs.
__device__ __forceinline__ void write_dct3(const float2* home, int np,
                                           int nl, int dst, const Geo& g,
                                           float* y0) {
  const int n = g.dl.d;
  for (int t = threadIdx.x; t < np * (int)g.dper.d; t += blockDim.x) {
    const int q = quot(t, g.dper);
    const int j = t - q * (int)g.dper.d;
    const float2 v = home[position(q * n + j, out_map(g))];
    const float2 w = home[position(q * n + n - 1 - j, out_map(g))];
    const float s = dst ? -1.f : 1.f;
    float* ya = y0 + (long long)(2 * q) * n + 2 * j;
    const bool has_b = 2 * q + 1 < nl;
    if (2 * j < n) {
      ya[0] = v.x;
      if (has_b) ya[n] = v.y;
    }
    if (2 * j + 1 < n) {
      ya[1] = s * w.x;
      if (has_b) ya[n + 1] = s * w.y;
    }
  }
}

__global__ void __launch_bounds__(kRealThreads, kRealMinBlocks)
dct2_kernel(const float* x, float* y, long long batch, int dst, Plan p1,
            Plan p2, const float2* t1, const float2* t2, const float2* tw,
            Geo g) {
  extern __shared__ __align__(16) float2 smem[];
  const int per = 2 * g.lines;
  load_tables(stage_tables_at(smem, g), t1, t2, tw, g.len1, g.len2, g.ntw);
  load_quads(x + block_line0(per) * (int)g.dl.d, block_lines(per, batch), dst,
             false, g, smem);
  __syncthreads();
  dct_passes(smem, g, p1, p2, (block_lines(per, batch) + 1) >> 1, true);
  write_dct2(smem, (block_lines(per, batch) + 1) >> 1, block_lines(per, batch),
             dst, g, twiddles_at(smem, g) + g.rot1,
             y + block_line0(per) * (int)g.dl.d);
}

__global__ void __launch_bounds__(kRealThreads, kRealMinBlocks)
dct3_kernel(const float* x, float* y, long long batch, int dst, Plan p1,
            Plan p2, const float2* t1, const float2* t2, const float2* tw,
            Geo g) {
  extern __shared__ __align__(16) float2 smem[];
  const int per = 2 * g.lines;
  load_tables(stage_tables_at(smem, g), t1, t2, tw, g.len1, g.len2, g.ntw);
  load_quads(x + block_line0(per) * (int)g.dl.d, block_lines(per, batch), dst,
             true, g, smem);
  __syncthreads();
  combine_dct3(smem, (block_lines(per, batch) + 1) >> 1, g,
               twiddles_at(smem, g) + g.rot1);
  // the passes in the forward's order (the inverse by its plans and
  // conjugate twiddle alone): natural order in, [k2][k1] out
  dct_passes(smem, g, p1, p2, (block_lines(per, batch) + 1) >> 1, false);
  write_dct3(smem, (block_lines(per, batch) + 1) >> 1, block_lines(per, batch),
             dst, g, y + block_line0(per) * (int)g.dl.d);
}

template <typename K>
int launch(K kernel, const float* x, float* y, long long batch, int dst,
           const int* plan1, const int* plan2, const float* table1,
           const float* table2, const float* twiddle, int threads, int lines,
           int smem, int inverse, void* stream) {
  Plan p1, p2;
  long long blocks;
  if (dst != 0 && dst != 1) return (int)cudaErrorInvalidValue;
  const int n = plan1[0] * plan2[0];
  if (n < 4) return (int)cudaErrorInvalidValue;
  // twiddle points: the inter-factor twiddle of n points, the rotations
  const int ntw = 2 * rotation_points(n);
  const int err = walk_prepare(kernel, batch, plan1, plan2, n, inverse,
                               threads, lines, smem, ntw, 2 * lines, &p1, &p2,
                               &blocks);
  if (err) return err;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      x, y, batch, dst, p1, p2, reinterpret_cast<const float2*>(table1),
      reinterpret_cast<const float2*>(table2),
      reinterpret_cast<const float2*>(twiddle),
      make_geo(n, p1, p2, n / 2 + 1, lines, ntw, rotation_points(n), 0));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() after the launch (0 on
// success).  x and y are real (batch, n) lines.  `plan1`/`plan2` are the
// int forms of the n1- and n2-point plans of n = n1 * n2 (forward for type
// II, inverse for type III; `plan2` the empty plan of length 1 for one
// pass), `table1`/`table2` their stage tables (no scale) and `twiddle` the
// inter-factor twiddle's two tables (64 points w_n^(+-b), ceil(n / 64)
// points w_n^(+-64 a)) followed by the rotation table (64 points
// e^(-+i pi b / 2n), ceil(n / 64) points scale e^(-+i pi 64 a / 2n)), all
// as interleaved fp32 pairs.  The layout (cuda_kernels.dct23_layout):
// `threads` a block (a multiple of 32 up to 512, enough for a whole
// sequence of every stage in a round), `lines` pipelines of two real lines
// a block (lines * n <= 16384) and the dynamic shared bytes, exactly what
// the layout needs and at most 227 KB; any other layout is refused
// (cudaErrorInvalidValue).
int vk_fft_dct2(const float* x, float* y, long long batch, int dst,
                const int* plan1, const int* plan2, const float* table1,
                const float* table2, const float* twiddle, int threads,
                int lines, int smem, void* stream) {
  return launch(dct2_kernel, x, y, batch, dst, plan1, plan2, table1, table2,
                twiddle, threads, lines, smem, 0, stream);
}

int vk_fft_dct3(const float* x, float* y, long long batch, int dst,
                const int* plan1, const int* plan2, const float* table1,
                const float* table2, const float* twiddle, int threads,
                int lines, int smem, void* stream) {
  return launch(dct3_kernel, x, y, batch, dst, plan1, plan2, table1, table2,
                twiddle, threads, lines, smem, 1, stream);
}

// Resident blocks an SM of the type II (type3 = 0) or type III kernel at
// `threads` a block and `smem` dynamic shared bytes, into *blocks.
int vk_fft_dct23_occupancy(int type3, int threads, int smem, int* blocks) {
  return type3 ? walk_occupancy(dct3_kernel, threads, smem, blocks)
               : walk_occupancy(dct2_kernel, threads, smem, blocks);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
