// fft_dct1: batched DCT-I / DST-I of contiguous real (B, n) fp32 lines,
// unnormalized (scipy's norm=None), times `scale`.
// Replaces vkfft_tpu/ops/pallas_engine.py:2958 _dct1_kernel (its host side:
// _build_dct1_call, dct1_lines, dst1_lines).
//
// Bound: bytes.  A line moves 4n bytes in and 4n out and does the flops of
// an M-point complex FFT, M = n - 1 (DCT-I) or n + 1 (DST-I), plus the
// untangle.  DCT-I is the real FFT of the even extension
// e = [x_0 .. x_{n-1}, x_{n-2} .. x_1] of N = 2M points, DCT1[k] = Re E[k];
// DST-I that of the odd extension e = [0, x_0 .. x_{n-1}, 0, -x_{n-1} ..
// -x_0], DST1[k] = -Im E[k+1] (the reference's appendDCTI_read,
// vkFFT_R2R.h:1339).  The TPU kernel keeps the extension virtual by running
// the zero-padded line through full 2M-point pipelines and correcting the
// x_0 and x_{n-1} terms afterwards.
//
// Design: the in-place walk (dct_walk.cuh, inplace.cuh's
// two_factor_passes) with the layout rule cuda_kernels.dct1_layout
// (fft_r2c's block on the M complex points z[j] = e[2j] + i e[2j+1] of
// each line: 2048 points a block, 16 a thread, one pass from 4 lines, else
// two factors; checked exactly by the C entry).  A block's real lines are
// one contiguous run of floats; a thread takes float x_i and copies it by
// cp.async straight to the point its extension index feeds and, where
// the extension holds it twice, to its mirror N - i as well (DST-I's
// negated mirror through a register; its two zeros stored).  The M-point
// DFT runs in place with the scale in its twiddle's table, and the write
// takes each pair of bins Z[k], Z[M-k] once for the two real outputs of
// X[k] and X[M-k] (fft_r2c's untangle, real_walk.cuh's formulas, w^k from
// two root tables in shared memory).  A block reads all its lines before
// it writes any.
#include "dct_walk.cuh"

namespace {

using vkfft::Plan;
using namespace vkfft::walk;

// The read of the block's nl real lines at x0, one thread a float x_i:
// extension index e = i (DCT-I) or i + 1 (DST-I), point e / 2 of its
// line's pipeline, the real part for even e; where 0 < e < M the mirror
// N - e holds x_i too (DST-I: -x_i).  DST-I's e[0] and e[M] are zeros.
// Returns when this thread's copies have landed.
__device__ __forceinline__ void load_extension(const float* x0, int nl,
                                               int dst, const Geo& g,
                                               float2* home) {
  const int n = g.dl.d, M = g.dp.d;
  for (int t = threadIdx.x; t < nl * n; t += blockDim.x) {
    const int q = quot(t, g.dl);
    const int e = t - q * n + dst;
    float* d0 = reinterpret_cast<float*>(
                    home + position(q * M + (e >> 1), in_map(g))) + (e & 1);
    cp_async4(d0, x0 + t);
    if (e > 0 && e < M) {
      const int m = 2 * M - e;
      float* d1 = reinterpret_cast<float*>(
                      home + position(q * M + (m >> 1), in_map(g))) + (m & 1);
      if (dst)
        *d1 = -x0[t];
      else
        cp_async4(d1, x0 + t);
    }
  }
  if (dst) {
    for (int q = threadIdx.x; q < nl; q += blockDim.x) {
      reinterpret_cast<float*>(home + position(q * M, in_map(g)))[0] = 0.f;
      reinterpret_cast<float*>(
          home + position(q * M + (M >> 1), in_map(g)))[M & 1] = 0.f;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The write, one thread a pair of bins (k, M - k), k <= M / 2 (Geo.dper):
// A = Z[k], B = Z[M-k] give X[k] = E + w^k O and X[M-k] = conj(E - w^k O)
// (E = (A + conj B) / 2, O = -i (A - conj B) / 2), and at k = 0 X[0] =
// A.x + A.y, X[M] = A.x - A.y.  DCT-I stores Re X[k] at k and Re X[M-k]
// at M - k; DST-I -Im X[k] at k - 1 and -Im X[M-k] at M - k - 1.
__device__ __forceinline__ void write_dct1(const float2* home, int nl,
                                           int dst, const Geo& g,
                                           const float2* ulo, float* y0) {
  const int n = g.dl.d, M = g.dp.d;
  for (int t = threadIdx.x; t < nl * (int)g.dper.d; t += blockDim.x) {
    const int q = quot(t, g.dper);
    const int k = t - q * (int)g.dper.d;
    const float2 a = home[position(q * M + k, out_map(g))];
    const float2 b = home[position(q * M + (k ? M - k : 0), out_map(g))];
    float* y = y0 + (long long)q * n;
    if (k == 0) {
      if (!dst) {
        y[0] = a.x + a.y;
        y[M] = a.x - a.y;
      }
      continue;
    }
    const float2 w = root(ulo, k);
    const float ex = 0.5f * (a.x + b.x), ey = 0.5f * (a.y - b.y);
    const float ox = 0.5f * (a.y + b.y), oy = 0.5f * (b.x - a.x);
    const float wr = w.x * ox - w.y * oy, wi = w.x * oy + w.y * ox;
    const bool pair = 2 * k != M;
    if (dst) {
      y[k - 1] = -(ey + wi);
      if (pair) y[M - k - 1] = ey - wi;
    } else {
      y[k] = ex + wr;
      if (pair) y[M - k] = ex - wr;
    }
  }
}

__global__ void __launch_bounds__(kRealThreads, kRealMinBlocks)
dct1_kernel(const float* x, float* y, long long batch, int dst, Plan p1,
            Plan p2, const float2* t1, const float2* t2, const float2* tw,
            Geo g) {
  extern __shared__ __align__(16) float2 smem[];
  load_tables(stage_tables_at(smem, g), t1, t2, tw, g.len1, g.len2, g.ntw);
  load_extension(x + block_line0(g.lines) * (int)g.dl.d,
                 block_lines(g.lines, batch), dst, g, smem);
  __syncthreads();
  dct_passes(smem, g, p1, p2, block_lines(g.lines, batch), true);
  write_dct1(smem, block_lines(g.lines, batch), dst, g,
             twiddles_at(smem, g) + g.rot1,
             y + block_line0(g.lines) * (int)g.dl.d);
}

// Twiddle points: the M-point inter-factor twiddle's two tables, then the
// untangle's w_2M^k, k <= M / 2 (64 + M / 128 + 1).
int twiddle_points(int M) {
  return rotation_points(M) + kTwLo + (M / 2) / kTwLo + 1;
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() after the launch (0 on
// success).  x and y are real (batch, n) lines.  `plan1`/`plan2` are the
// int forms of the forward n1- and n2-point plans of M = n1 * n2 = n - 1
// (DCT-I) or n + 1 (`dst`: DST-I) (`plan2` the empty plan of length 1 for
// one pass), `table1`/`table2` their stage tables (no scale) and `twiddle`
// the inter-factor twiddle's two tables (64 points w_M^b, ceil(M / 64)
// points scale * w_M^(64 a)) followed by the untangle's (64 points
// w_2M^b, M / 128 + 1 points w_2M^(64 a)), all as interleaved fp32 pairs.
// The layout (cuda_kernels.dct1_layout): `threads` a block (a multiple of
// 32 up to 512, enough for a whole sequence of every stage in a round),
// `lines` a block (lines * M <= 16384) and the dynamic shared bytes,
// exactly what the layout needs and at most 227 KB; any other layout is
// refused (cudaErrorInvalidValue).
int vk_fft_dct1(const float* x, float* y, long long batch, int dst,
                const int* plan1, const int* plan2, const float* table1,
                const float* table2, const float* twiddle, int threads,
                int lines, int smem, void* stream) {
  if (dst != 0 && dst != 1) return (int)cudaErrorInvalidValue;
  const int M = plan1[0] * plan2[0];
  if (M < 2 || M > vkfft::kMaxN) return (int)cudaErrorInvalidValue;
  Plan p1, p2;
  long long blocks;
  const int ntw = twiddle_points(M);
  const int err = walk_prepare(dct1_kernel, batch, plan1, plan2, M, 0,
                               threads, lines, smem, ntw, lines, &p1, &p2,
                               &blocks);
  if (err) return err;
  dct1_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      x, y, batch, dst, p1, p2, reinterpret_cast<const float2*>(table1),
      reinterpret_cast<const float2*>(table2),
      reinterpret_cast<const float2*>(twiddle),
      make_geo(dst ? M - 1 : M + 1, p1, p2, M / 2 + 1, lines, ntw,
               rotation_points(M), 0));
  return (int)cudaGetLastError();
}

// Resident blocks an SM of the kernel at `threads` a block and `smem`
// dynamic shared bytes, into *blocks.
int vk_fft_dct1_occupancy(int threads, int smem, int* blocks) {
  return walk_occupancy(dct1_kernel, threads, smem, blocks);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
