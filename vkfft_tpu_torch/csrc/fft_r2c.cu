// fft_r2c: batched real-to-complex FFT of contiguous real (B, n) fp32 lines,
// n even, into their half spectrum, and the complex-to-real inverse.
// Replaces vkfft_tpu/ops/pallas_engine.py:2461 _r2c_kernel and :2507
// _c2r_kernel (their host side: _build_r2c_call, rfft_lines_planar,
// irfft_lines_planar, rfft_lines_packed, irfft_lines_packed).
//
// Layouts of the spectrum planes: numpy's, (B, n/2+1) with Im(DC) and
// Im(Nyquist) stored as 0; or packed, (B, n/2) with the real Nyquist bin in
// Im(bin 0).  The inverse output is scaled by (n/2) * scale, the scale in
// its untangle: scale = 2/n gives numpy's irfft.
//
// Bound: bytes.  A line moves 4n bytes of real data and 8(n/2+1) (packed:
// 4n) bytes of spectrum, read once and written once, and does the flops of
// an m = n/2-point complex FFT plus an O(n) untangle.  The TPU kernel runs
// two full n-point pipelines on [z | conj z], since Mosaic cannot shuffle
// (pallas_engine.py:2440-2457).  Design: fft_lines' block on the in-place
// walk of inplace.cuh (two_factor_passes), with its layout rule
// (cuda_kernels.r2c_layout: lines_split and the block of fft_lines at m,
// checked exactly by the C entry): a block holds its lines once in shared
// memory beside the stage tables and the twiddles' root tables.  The
// forward reads each line as m float2 pairs z[j] = x[2j] + i x[2j+1],
// straight to their places by cp.async (8 bytes a point), runs the m-point
// stages in place, then untangles as it writes (real_walk.cuh's formulas; each
// bin reads Z[k] and Z[m-k] through the layout's position map, w^k from
// two root tables): the block's rows are one contiguous run of each plane,
// written as float4s from its first 16-byte boundary (numpy rows of n/2+1
// bins are not aligned) with scalar head and tail.  The inverse reads the
// bins by cp.async, untangles in place before the first stage (the scale
// there), runs the passes in the forward's order and writes z as float2
// pairs.  A block reads all its lines before it writes.
#include "inplace.cuh"
#include "real_walk.cuh"
#include "twofactor.cuh"

namespace {

using vkfft::Plan;
using vkfft::cmul;
using namespace vkfft::walk;

// Points of the twiddles' tables after the stage tables: the inter-factor
// twiddle of the m-point DFT (64 + ceil(m / 64)) and the untangle's w_n^k,
// k <= m / 2 (64 + m / 128 + 1).
__host__ __device__ __forceinline__ int twiddle_points(int m) {
  return rotation_points(m) + kTwLo + (m / 2) / kTwLo + 1;
}

// The block's stage tables and twiddles, copied into shared memory after
// its lines; returns where the untangle's low root table starts.
__device__ __forceinline__ const float2* copy_tables(
    float2* s1, const float2* t1, const float2* t2, const float2* tw,
    int len1, int len2, int m) {
  const int ntab = len1 + len2 + twiddle_points(m);
  for (int t = threadIdx.x; t < ntab; t += blockDim.x)
    s1[t] = t < len1 ? __ldg(&t1[t])
                     : t < len1 + len2 ? __ldg(&t2[t - len1])
                                       : __ldg(&tw[t - len1 - len2]);
  return s1 + len1 + len2 + kTwLo + (m + kTwLo - 1) / kTwLo;
}

// The block's first line, blockIdx.x read afresh where it is used, so the
// line's index and the block's count of lines are found again, not held
// in registers through the passes (held, they spilled).
__device__ __forceinline__ long long first_line(int lines) {
  unsigned b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return (long long)b * lines;
}

__device__ __forceinline__ int block_lines(int lines, long long batch) {
  return (int)min((long long)lines, batch - first_line(lines));
}

// Value t of the block's spectrum run: bin t % w of line t / w (w = m,
// packed, or m + 1).
__device__ __forceinline__ float2 run_bin(const float2* home, const Map& mp,
                                          const float2* ulo, int m, Div dw,
                                          int t, bool packed) {
  const int q = quot(t, dw);
  return half_bin(home, mp, ulo, m, q, t - q * (int)dw.d, packed);
}

// The forward's untangle and write in one sweep: the block's spectrum
// rows, one contiguous run of `count` floats of each plane at float
// offset g0 (rows of m + 1 bins are not 16-byte aligned), float4s from
// the first 16-byte boundary and single floats before and after; a
// thread's four bins read in an order rotated by its lane, as store_lines.
__device__ void store_spectrum(const float2* home, const Map& mp,
                               const float2* ulo, int m, bool packed,
                               float* yr, float* yi, long long g0, int count) {
  const Span sp = span_of(g0, count, aligned16(yr, yi));
  const int rot = (threadIdx.x >> 2) & 3;
  const Div dw = make_div(packed ? m : m + 1);
  float* r0 = yr + g0;
  float* i0 = yi + g0;
#pragma unroll 2
  for (int f = threadIdx.x; f < sp.n4; f += blockDim.x) {
    const int u = sp.head + 4 * f;
    float2 v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      v[c] = run_bin(home, mp, ulo, m, dw, u + ((c + rot) & 3), packed);
    rotate(v, (4 - rot) & 3);
    *reinterpret_cast<float4*>(r0 + u) = make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
    *reinterpret_cast<float4*>(i0 + u) = make_float4(v[0].y, v[1].y, v[2].y, v[3].y);
  }
  for (int k = threadIdx.x; k < sp.rest; k += blockDim.x) {
    const int u = k < sp.head ? k : sp.tail0 + k - sp.head;
    const float2 v = run_bin(home, mp, ulo, m, dw, u, packed);
    r0[u] = v.x;
    i0[u] = v.y;
  }
}

// The inverse's read of numpy-layout rows by cp.async, each float straight
// to its place: Re X[m] into Im of slot 0; Im X[0] and Im X[m] not read.
__device__ void load_numpy_async(const float* xr, const float* xi,
                                 long long g0, int count, int m, const Map& mp,
                                 float2* home) {
  const Div dh = make_div(m + 1);
  const float* r0 = xr + g0;
  const float* i0 = xi + g0;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int q = quot(t, dh);
    const int c = t - q * (m + 1);
    float* d = reinterpret_cast<float*>(home + position(q * m + (c == m ? 0 : c), mp));
    cp_async4(d + (c == m), r0 + t);
    if (c != 0 && c != m) cp_async4(d + 1, i0 + t);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kRealThreads, kRealMinBlocks)
r2c_kernel(const float* x, float* yr, float* yi, long long batch, int packed,
           Plan p1, Plan p2, const float2* t1, const float2* t2,
           const float2* tw, int lines, int pitch, int len1, int len2) {
  extern __shared__ __align__(16) float2 smem[];
  const int n1 = p1.n, n2 = p2.n, m = n1 * n2;
  const int S = n2 * pitch;
  float2* home = smem;
  float2* s1 = home + lines * S;
  copy_tables(s1, t1, t2, tw, len1, len2, m);
  load_pairs_async(reinterpret_cast<const float2*>(x), first_line(lines) * m,
                   block_lines(lines, batch) * m,
                   make_map(m, S, false, n1, n2, pitch), home);
  __syncthreads();
  two_factor_passes(home, block_lines(lines, batch), p1, p2, s1, s1 + len1,
                    s1 + len1 + len2, s1 + len1 + len2 + kTwLo, pitch);
  const int w = packed ? m : m + 1;
  store_spectrum(home, make_map(m, S, true, n1, n2, pitch),
                 smem + lines * S + len1 + len2 + kTwLo + (m + kTwLo - 1) / kTwLo,
                 m, packed != 0, yr, yi, first_line(lines) * w,
                 block_lines(lines, batch) * w);
}

__global__ void __launch_bounds__(kRealThreads, kRealMinBlocks)
c2r_kernel(const float* xr, const float* xi, float* y, long long batch,
           int packed, Plan p1, Plan p2, const float2* t1, const float2* t2,
           const float2* tw, float scale, int lines, int pitch, int len1,
           int len2) {
  extern __shared__ __align__(16) float2 smem[];
  const int n1 = p1.n, n2 = p2.n, m = n1 * n2;
  const int S = n2 * pitch;
  float2* home = smem;
  float2* s1 = home + lines * S;
  const float2* ulo = copy_tables(s1, t1, t2, tw, len1, len2, m);
  // the spectrum in natural order, the passes in the forward's order (the
  // inverse by its plans and conjugate twiddle alone), z in the factors'
  // transposed order: r2c_kernel's maps, mirrored
  const int w = packed ? m : m + 1;
  if (packed)
    load_lines_async(xr, xi, first_line(lines) * w,
                     block_lines(lines, batch) * w,
                     make_map(fresh(m), S, false, fresh(n1), n2, pitch), home);
  else
    load_numpy_async(xr, xi, first_line(lines) * w,
                     block_lines(lines, batch) * w, m,
                     make_map(fresh(m), S, false, fresh(n1), n2, pitch), home);
  __syncthreads();
  untangle_inverse(home, block_lines(lines, batch), m,
                   make_map(fresh(m), S, false, fresh(n1), n2, pitch), ulo,
                   scale);
  two_factor_passes(home, block_lines(lines, batch), p1, p2, s1, s1 + len1,
                    s1 + len1 + len2, s1 + len1 + len2 + kTwLo, pitch, false);
  store_pairs(home, make_map(m, S, true, n1, n2, pitch),
              reinterpret_cast<float2*>(y), first_line(lines) * m,
              block_lines(lines, batch) * m);
}

// The checks of a launch: the plans of m = n1 * n2 (inverse for c2r), the
// layout of cuda_kernels.r2c_layout exactly, the real side 8-byte aligned.
template <typename K>
int prepare(K kernel, long long batch, int packed, const int* plan1,
            const int* plan2, int inverse, int threads, int lines, int smem,
            const void* real, Plan* p1, Plan* p2, long long* blocks) {
  if ((packed != 0 && packed != 1) || ((uintptr_t)real & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const int m = plan1[0] * plan2[0];
  return walk_prepare(kernel, batch, plan1, plan2, m, inverse, threads, lines,
                      smem, twiddle_points(m), lines, p1, p2, blocks);
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() after the launch (0 on
// success).  x is real (batch, n) lines, 8-byte aligned, and yr/yi the
// spectrum planes, (batch, n/2+1) or, with `packed`, (batch, n/2).
// `plan1`/`plan2` are the int forms of the n1- and n2-point plans of m =
// n/2 = n1 * n2 (forward; `plan2` the empty plan of length 1 for one
// pass), `table1`/`table2` their stage tables (no scale) and `twiddle` the
// twiddles' tables: 64 points w_m^b, ceil(m / 64) points w_m^(64 a), 64
// points w_n^b and m / 128 + 1 points w_n^(64 a), all as interleaved
// fp32 pairs.  The layout (cuda_kernels.r2c_layout): `threads` a block (a
// multiple of 32 up to 512, enough for a whole sequence of every stage in
// a round), `lines` a block (lines * m <= 16384) and the dynamic shared
// bytes, exactly what the layout needs and at most 227 KB; any other
// layout is refused (cudaErrorInvalidValue).
int vk_fft_r2c(const float* x, float* yr, float* yi, long long batch,
               int packed, const int* plan1, const int* plan2,
               const float* table1, const float* table2, const float* twiddle,
               int threads, int lines, int smem, void* stream) {
  Plan p1, p2;
  long long blocks;
  const int err = prepare(r2c_kernel, batch, packed, plan1, plan2, 0, threads,
                          lines, smem, x, &p1, &p2, &blocks);
  if (err) return err;
  r2c_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      x, yr, yi, batch, packed, p1, p2, reinterpret_cast<const float2*>(table1),
      reinterpret_cast<const float2*>(table2),
      reinterpret_cast<const float2*>(twiddle), lines, p1.n | 1,
      table_len(p1), table_len(p2));
  return (int)cudaGetLastError();
}

// The inverse: xr/xi the spectrum planes as above, y the real (batch, n)
// output, 8-byte aligned, scaled by (n/2) * scale (in the untangle); the
// plans and the inter-factor twiddle inverse.
int vk_fft_c2r(const float* xr, const float* xi, float* y, long long batch,
               int packed, const int* plan1, const int* plan2,
               const float* table1, const float* table2, const float* twiddle,
               float scale, int threads, int lines, int smem, void* stream) {
  Plan p1, p2;
  long long blocks;
  const int err = prepare(c2r_kernel, batch, packed, plan1, plan2, 1, threads,
                          lines, smem, y, &p1, &p2, &blocks);
  if (err) return err;
  c2r_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, y, batch, packed, p1, p2, reinterpret_cast<const float2*>(table1),
      reinterpret_cast<const float2*>(table2),
      reinterpret_cast<const float2*>(twiddle), scale, lines, p1.n | 1,
      table_len(p1), table_len(p2));
  return (int)cudaGetLastError();
}

// Resident blocks an SM of the forward (inverse = 0) or inverse kernel at
// `threads` a block and `smem` dynamic shared bytes, into *blocks.
int vk_fft_r2c_occupancy(int inverse, int threads, int smem, int* blocks) {
  return inverse ? walk_occupancy(c2r_kernel, threads, smem, blocks)
                 : walk_occupancy(r2c_kernel, threads, smem, blocks);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
