// fft_strided: C2C FFT along the middle dim of (P, n, S) fp32 re/im planes,
// S contiguous, natural order in and out, times a scale (in the twiddle's
// table).  Replaces vkfft_tpu/ops/pallas_engine.py:3489 _strided_kernel_v3
// (plain form: no factor tables, no in/out keeps), and :4001 _outer_kernel
// through the (P, n, R*nz) view.
//
// Bound: bytes, one read and one write of each point (16 B of planes).
// Design: fft_pair.cu's column pass fed from device memory, on the in-place
// walk of inplace.cuh.  A block holds a tile of ts neighbouring columns of
// one plane across all n rows once in shared memory, point (j, c) at j *
// ts + c, so each row of the tile is one run of ts contiguous floats per
// plane in device memory, read by cp.async straight to its places (every
// read of the tile before any write: the output may alias the input).
// The stages run down the columns, the column index fastest across
// threads (a sequence one column apart, its points ts apart), with the
// stage tables (radix 16, walk_radices) and the twiddle's two root tables
// in shared memory.  An axis whose stages do not fit a round of the
// block's threads, or that leaves too few columns a block, runs as two
// factors n = n1 * n2 (a column pass of n2-point DFTs, the twiddle w_n^(j1
// k2) on its last stage, a row pass of n1-point DFTs, the points then in
// the factors' transposed order, which the write follows); in one pass
// the twiddle's table carries the scale alone.  The rows go back as
// float4s where every run is 16-byte aligned, else as single floats; the
// ragged last tile of S is masked; consecutive blocks take tiles spread
// over the rows (tile_of).  cuda_kernels.strided_layout is the one
// layout rule (the C entry refuses any other): the columns a block, the
// threads and the exact shared bytes.  Offsets are 64-bit and the grid is
// 1-D over P * tiles, so P = 1 with a large S (the x axis of a cube) and a
// large P both fit.
//
// fp64 (fft_strided_f64_kernel, C entry vk_fft_strided_f64): the same body
// on double planes and tables, a point 16 B of shared memory, so a tile
// holds half the columns beside its tables (strided_layout at 16 B a
// point), and a double2 four registers: at most kThreads64 threads a
// block, the bound leaving each 128 registers, on the fp64 walk (one
// generic item a round, no radix 16: inplace.cuh's kItems, kRadix16).
//
// Half storage (fft_strided_f16_kernel, fft_strided_bf16_kernel; C entries
// vk_fft_strided_f16, vk_fft_strided_bf16): the fp32 kernel's body, layout
// and bounds on __half or __nv_bfloat16 planes, 8 B a point of device
// memory where fp32 moves 16; tables, tile and stages stay fp32.  cp.async
// has no 2-byte copy, so the tile's rows come in through registers
// (load_columns: four halves a plane in one 8-byte load where every run is
// 8-byte aligned, else single halves), each widened to float, and go out
// narrowed once, to nearest even (store_columns).
//
// Zero-pad windows (fft_strided_zp_kernel and its fp64 and half twins; C
// entries vk_fft_strided_zp, vk_fft_strided_zp_f64, vk_fft_strided_zp_f16,
// vk_fft_strided_zp_bf16; ColWindow): the tile reads only the rows below
// its kept prefix, from planes and rows at pitches of their own (a corner
// of wider planes: columns in runs of cw at a pitch cs), holds zeros in
// the other rows, and writes only the rows below its output keep, into
// (P, out_keep, S) planes.  The same body (strided_block<true>), so the
// unwindowed kernels compile as before.
#include "inplace.cuh"
#include "twofactor.cuh"

namespace {

using vkfft::Plan;
using vkfft::Real;
using vkfft::cmul;
using vkfft::cx;
using namespace vkfft::walk;

// Most threads a block; the bound holds the kernel to 64 registers.
constexpr int kThreads = 1024;
constexpr int kThreads64 = 512;  // ... of the fp64 kernel: 128 registers

// The twiddle of the column pass's last stage: output k of sequence q
// (column q % ts of row j1 = q / ts of the factors' matrix) times w_n^(j1
// k) * scale from the twiddle's two tables; in one pass q < ts, so the
// scale alone.  Off when lo is null.
template <class C>
struct ColumnTwiddle {
  const C* lo;
  const C* hi;
  Div dts;
  __device__ __forceinline__ bool on() const { return lo != nullptr; }
  __device__ __forceinline__ ColumnTwiddle off() const {
    return {nullptr, hi, dts};
  }
  __device__ __forceinline__ C operator()(C v, int q, int k) const {
    return cmul(v, inter_twiddle(quot(q, dts) * k, lo, hi));
  }
};

// The block's tile: `cols` columns (of ts) of the n rows at real offset
// g0 of the planes, row j at g0 + j * S, to point (j, c) at j * ts + c, by
// cp.async, each real straight to its place; returns when this thread's
// copies have landed.
template <class C>
__device__ void load_columns_async(const Real<C>* xr, const Real<C>* xi,
                                   long long g0, long long S, int n, int ts,
                                   int cols, C* tile) {
  const Div dc = make_div(cols);
  for (int u = threadIdx.x; u < n * cols; u += blockDim.x) {
    const int j = quot(u, dc);
    const int c = u - j * cols;
    const long long g = g0 + j * S + c;
    Real<C>* d = reinterpret_cast<Real<C>*>(tile + j * ts + c);
    cp_async_real(d, xr + g);
    cp_async_real(d + 1, xi + g);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// load_columns_async through registers, for planes whose reals no
// cp.async copy takes (halves): four reals a plane at once (load4) where
// every run is aligned to four (a thread's four points written in an order
// rotated by its lane), else single reals, each widened to float.
template <class C, class St>
__device__ void load_columns(const St* xr, const St* xi, long long g0,
                             long long S, int n, int ts, int cols, C* tile) {
  const int T = blockDim.x;
  if (cols == ts && (ts & 3) == 0 && (S & 3) == 0 && (g0 & 3) == 0 &&
      group_aligned(xr, xi)) {
    const int c4 = ts >> 2;
    const Div dc = make_div(c4);
    const int rot = (threadIdx.x >> 2) & 3;
#pragma unroll 2
    for (int f = threadIdx.x; f < n * c4; f += T) {
      const int j = quot(f, dc);
      const int c = 4 * (f - j * c4);
      const long long g = g0 + j * S + c;
      const float4 r = load4(xr + g);
      const float4 i = load4(xi + g);
      C v[4] = {cx<C>(r.x, i.x), cx<C>(r.y, i.y), cx<C>(r.z, i.z),
                cx<C>(r.w, i.w)};
      rotate(v, rot);
      C* d = tile + j * ts + c;
#pragma unroll
      for (int q = 0; q < 4; ++q) d[(q + rot) & 3] = v[q];
    }
    return;
  }
  const Div dc = make_div(cols);
  for (int u = threadIdx.x; u < n * cols; u += T) {
    const int j = quot(u, dc);
    const int c = u - j * cols;
    const long long g = g0 + j * S + c;
    tile[j * ts + c] = cx<C>(widen(xr[g]), widen(xi[g]));
  }
}

// The tile back to device memory: row k (at yout(k) * ts in the tile) to
// real offset g0 + k * S, `cols` points, four reals a plane at once
// (store4) where every run is aligned to four (16 bytes of floats, 8 of
// halves; a thread's four points read in an order rotated by its lane),
// else single reals, narrowed to the planes' storage type.
template <class C, class St>
__device__ void store_columns(const C* tile, RowPerm yout, St* yr, St* yi,
                              long long g0, long long S, int n, int ts,
                              int cols) {
  const int T = blockDim.x;
  if (cols == ts && (ts & 3) == 0 && (S & 3) == 0 && (g0 & 3) == 0 &&
      group_aligned(yr, yi)) {
    const int c4 = ts >> 2;
    const Div dc = make_div(c4);
    const int rot = (threadIdx.x >> 2) & 3;
#pragma unroll 2
    for (int f = threadIdx.x; f < n * c4; f += T) {
      const int k = quot(f, dc);
      const int c = 4 * (f - k * c4);
      const C* s = tile + yout(k) * ts + c;
      C v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = s[(q + rot) & 3];
      rotate(v, (4 - rot) & 3);
      const long long g = g0 + k * S + c;
      store4(yr + g, v[0].x, v[1].x, v[2].x, v[3].x);
      store4(yi + g, v[0].y, v[1].y, v[2].y, v[3].y);
    }
    return;
  }
  const Div dc = make_div(cols);
  for (int u = threadIdx.x; u < n * cols; u += T) {
    const int k = quot(u, dc);
    const int c = u - k * cols;
    const C v = tile[yout(k) * ts + c];
    const long long g = g0 + k * S + c;
    put(yr[g], v.x);
    put(yi[g], v.y);
  }
}

// A zero-pad window on a strided pass (the reference's in_keep / out_keep
// of _strided_kernel_v3 and _outer_kernel): the input's rows j < in_keep
// are read, row j of plane p at real offset p * in_plane + j * in_row and
// its column s at (s / cw) * cs + s % cw (a corner of wider planes: runs
// of cw columns cs apart; cw = 0: one run, s at s); the other rows are
// declared zero, never read.  The output's rows k < out_keep are written,
// (P, out_keep, S) planes.
struct ColWindow {
  long long in_plane, in_row, cs;
  int cw, in_keep, out_keep;
};

// The tile of plane pi from column s0 under a window, point by point (the
// corner's runs break a row's run of ts columns): a row past the kept
// prefix is zeros written to shared memory, never read.
template <class C, class St>
__device__ void load_columns_window(const St* xr, const St* xi, long long pi,
                                    long long s0, int n, int ts, int cols,
                                    const ColWindow& w, C* tile) {
  long long base = pi * w.in_plane;
  int r0 = 0;   // s0's place in its run
  if (w.cw) {
    const long long g = s0 / w.cw;
    base += g * w.cs;
    r0 = (int)(s0 - g * w.cw);
  } else {
    base += s0;
  }
  const Div dc = make_div(cols), dw = make_div(w.cw ? w.cw : 1);
  for (int u = threadIdx.x; u < n * cols; u += blockDim.x) {
    const int j = quot(u, dc);
    const int c = u - j * cols;
    C* d = tile + j * ts + c;
    if (j >= w.in_keep) {
      *d = cx<C>(Real<C>(0), Real<C>(0));
      continue;
    }
    long long g = base + j * w.in_row;
    if (w.cw) {
      const int r = r0 + c;
      const int q = quot(r, dw);
      g += q * w.cs + (r - q * w.cw);
    } else {
      g += c;
    }
    if constexpr (kNarrow<St>) {
      *d = cx<C>(widen(xr[g]), widen(xi[g]));
    } else {
      Real<C>* r = reinterpret_cast<Real<C>*>(d);
      cp_async_real(r, xr + g);
      cp_async_real(r + 1, xi + g);
    }
  }
  if constexpr (!kNarrow<St>) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tile of block b: where kSpread divides a plane's tiles, consecutive
// blocks take tiles a kSpread-th of the plane's rows apart, so the blocks
// in flight at once cover kSpread parts of every row rather than one
// narrow window of it: with neighbouring tiles for neighbouring blocks the
// time followed where the planes lay in physical memory (at 1 x 256 x
// 33024 it changed by up to half from one allocation to the next;
// PERF.md §6).
constexpr int kSpread = 4;

__device__ __forceinline__ long long tile_of(long long b, long long tiles) {
  if (tiles % kSpread != 0) return b;
  const long long p = b / tiles;
  const long long t = b - p * tiles;
  return p * tiles + (t % kSpread) * (tiles / kSpread) + t / kSpread;
}

// The block body on points of type C and planes of storage type St; with
// kWindow, under the window w.
template <bool kWindow = false, class C, class St>
__device__ __forceinline__ void strided_block(
    C* smem, const St* xr, const St* xi, St* yr, St* yi, long long S,
    long long tiles, const Plan& p1, const Plan& p2, const C* t1, const C* t2,
    const C* tw, int ts, int len1, int len2,
    const ColWindow& w = ColWindow{}) {
  const int n = p1.n * p2.n;
  C* s1 = smem + n * ts;
  const int ntab = len1 + len2 + kTwLo + (n + kTwLo - 1) / kTwLo;
  for (int t = threadIdx.x; t < ntab; t += blockDim.x)
    s1[t] = t < len1 ? __ldg(&t1[t])
                     : t < len1 + len2 ? __ldg(&t2[t - len1])
                                       : __ldg(&tw[t - len1 - len2]);
  const long long bt = tile_of(blockIdx.x, tiles);
  const long long pi = bt / tiles;
  const long long s0 = (bt - pi * tiles) * ts;
  if constexpr (kWindow)
    load_columns_window(xr, xi, pi, s0, n, ts,
                        (int)min((long long)ts, S - s0), w, smem);
  else if constexpr (kNarrow<St>)
    load_columns(xr, xi, pi * n * S + s0, S, n, ts,
                 (int)min((long long)ts, S - s0), smem);
  else
    load_columns_async(xr, xi, pi * n * S + s0, S, n, ts,
                       (int)min((long long)ts, S - s0), smem);
  __syncthreads();
  // the column pass (n2-point DFTs, the twiddle on its last stage), then
  // the row pass (n1-point; the scale on its last stage when n2 = 1); one
  // call site of run_pass keeps one copy of each stage
  const C* tlo = s1 + len1 + len2;
  for (int k = 0; k < 2; ++k) {
    const bool row = k == 1;
    const int n1 = p1.n, n2 = p2.n;
    // column pass: sequence q = j1 * ts + c at q, points n1 * ts apart;
    // row pass: q = k2 * ts + c at k2 * n1 * ts + c, points ts apart
    const Pass g = row ? Pass{n2 * ts, n1 * ts, 1, ts, make_div(ts)}
                       : Pass{n1 * ts, 0, 1, n1 * ts, make_div(n1 * ts)};
    // With n2 = 1 the twiddle is the scale alone, skipped when it is 1.
    const bool twiddled = n2 > 1 || tlo[kTwLo].x != Real<C>(1) ||
                          tlo[kTwLo].y != Real<C>(0);
    const bool fuse = twiddled && row == (n2 == 1);
    run_pass(smem, g, row ? p1 : p2, row ? s1 : s1 + len1,
             ColumnTwiddle<C>{fuse ? tlo : nullptr, tlo + kTwLo,
                              make_div(ts)});
  }
  const long long bu = tile_of(blockIdx.x, tiles);
  const long long pj = bu / tiles;
  const long long sj = (bu - pj * tiles) * ts;
  if constexpr (kWindow)
    store_columns(smem, RowPerm{make_div(p2.n), p1.n}, yr, yi,
                  pj * w.out_keep * S + sj, S, w.out_keep, ts,
                  (int)min((long long)ts, S - sj));
  else
    store_columns(smem, RowPerm{make_div(p2.n), p1.n}, yr, yi,
                  pj * n * S + sj, S, n, ts, (int)min((long long)ts, S - sj));
}

__global__ void __launch_bounds__(kThreads, 1)
fft_strided_kernel(const float* xr, const float* xi, float* yr, float* yi,
                   long long S, long long tiles, Plan p1, Plan p2,
                   const float2* t1, const float2* t2, const float2* tw,
                   int ts, int len1, int len2) {
  extern __shared__ __align__(16) float2 smem[];
  strided_block(smem, xr, xi, yr, yi, S, tiles, p1, p2, t1, t2, tw, ts, len1,
                len2);
}

__global__ void __launch_bounds__(kThreads64, 1)
fft_strided_f64_kernel(const double* xr, const double* xi, double* yr,
                       double* yi, long long S, long long tiles, Plan p1,
                       Plan p2, const double2* t1, const double2* t2,
                       const double2* tw, int ts, int len1, int len2) {
  extern __shared__ __align__(16) double2 smem64[];
  strided_block(smem64, xr, xi, yr, yi, S, tiles, p1, p2, t1, t2, tw, ts,
                len1, len2);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_strided_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                       __half* yi, long long S, long long tiles, Plan p1,
                       Plan p2, const float2* t1, const float2* t2,
                       const float2* tw, int ts, int len1, int len2) {
  extern __shared__ __align__(16) float2 smem[];
  strided_block(smem, xr, xi, yr, yi, S, tiles, p1, p2, t1, t2, tw, ts, len1,
                len2);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_strided_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                        __nv_bfloat16* yr, __nv_bfloat16* yi, long long S,
                        long long tiles, Plan p1, Plan p2, const float2* t1,
                        const float2* t2, const float2* tw, int ts, int len1,
                        int len2) {
  extern __shared__ __align__(16) float2 smem[];
  strided_block(smem, xr, xi, yr, yi, S, tiles, p1, p2, t1, t2, tw, ts, len1,
                len2);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_strided_zp_kernel(const float* xr, const float* xi, float* yr, float* yi,
                      long long S, long long tiles, Plan p1, Plan p2,
                      const float2* t1, const float2* t2, const float2* tw,
                      int ts, int len1, int len2, ColWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  strided_block<true>(smem, xr, xi, yr, yi, S, tiles, p1, p2, t1, t2, tw, ts,
                      len1, len2, w);
}

__global__ void __launch_bounds__(kThreads64, 1)
fft_strided_zp_f64_kernel(const double* xr, const double* xi, double* yr,
                          double* yi, long long S, long long tiles, Plan p1,
                          Plan p2, const double2* t1, const double2* t2,
                          const double2* tw, int ts, int len1, int len2,
                          ColWindow w) {
  extern __shared__ __align__(16) double2 smem64[];
  strided_block<true>(smem64, xr, xi, yr, yi, S, tiles, p1, p2, t1, t2, tw,
                      ts, len1, len2, w);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_strided_zp_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                          __half* yi, long long S, long long tiles, Plan p1,
                          Plan p2, const float2* t1, const float2* t2,
                          const float2* tw, int ts, int len1, int len2,
                          ColWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  strided_block<true>(smem, xr, xi, yr, yi, S, tiles, p1, p2, t1, t2, tw, ts,
                      len1, len2, w);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_strided_zp_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                           __nv_bfloat16* yr, __nv_bfloat16* yi, long long S,
                           long long tiles, Plan p1, Plan p2,
                           const float2* t1, const float2* t2,
                           const float2* tw, int ts, int len1, int len2,
                           ColWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  strided_block<true>(smem, xr, xi, yr, yi, S, tiles, p1, p2, t1, t2, tw, ts,
                      len1, len2, w);
}

template <typename K>
int smem_opt_in(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The checks and the launch at points of type C on planes of storage type
// St (the layout of cuda_kernels.strided_layout, at most `max_threads` a
// block).
// With `window` (6 ints: in_plane, in_row, cs, cw, in_keep, out_keep),
// the windowed kernel under that ColWindow; a window that is not one is
// refused: keeps of 1..n rows, runs of at most 2^15 columns that divide
// S.
template <class C, bool kWindow = false, class St, typename K>
int launch(K kernel, int max_threads, const St* xr, const St* xi, St* yr,
           St* yi, long long P, long long S,
           const int* plan1, const int* plan2, const Real<C>* table1,
           const Real<C>* table2, const Real<C>* twiddle, int ts, int threads,
           int smem, void* stream, const long long* window = nullptr) {
  Plan p1, p2;
  if (P < 1 || S < 1 || !vkfft::plan_from_ints(plan1, &p1) ||
      !vkfft::subplan_from_ints(plan2, &p2) || twiddle == nullptr)
    return (int)cudaErrorInvalidValue;
  const int n = p1.n * p2.n;
  const int len1 = table_len(p1), len2 = table_len(p2);
  if (n > vkfft::kMaxN || p1.n < p2.n || p2.inverse != p1.inverse ||
      ts < 1 || ts > S || threads < 32 || threads > max_threads ||
      threads % 32 != 0 || !rounds_fit<C>(p1, threads) ||
      !rounds_fit<C>(p2, threads) || smem < 0 ||
      (size_t)smem != sizeof(C) * ((size_t)n * ts + len1 + len2 + kTwLo +
                                   (n + kTwLo - 1) / kTwLo) ||
      smem > vkfft::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (S + ts - 1) / ts;
  if (P * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ColWindow w{};
  if (kWindow) {
    if (window == nullptr) return (int)cudaErrorInvalidValue;
    w = {window[0], window[1], window[2], (int)window[3], (int)window[4],
         (int)window[5]};
    if (window[0] < 0 || window[1] < 0 || window[2] < 0 || window[3] < 0 ||
        window[3] > 32768 || (window[3] && S % window[3]) ||
        window[4] < 1 || window[4] > n || window[5] < 1 || window[5] > n)
      return (int)cudaErrorInvalidValue;
  }
  const int err = smem_opt_in(kernel, smem);
  if (err) return err;
  if constexpr (kWindow)
    kernel<<<(unsigned)(P * tiles), threads, smem, (cudaStream_t)stream>>>(
        xr, xi, yr, yi, S, tiles, p1, p2, reinterpret_cast<const C*>(table1),
        reinterpret_cast<const C*>(table2),
        reinterpret_cast<const C*>(twiddle), ts, len1, len2, w);
  else
    kernel<<<(unsigned)(P * tiles), threads, smem, (cudaStream_t)stream>>>(
        xr, xi, yr, yi, S, tiles, p1, p2, reinterpret_cast<const C*>(table1),
        reinterpret_cast<const C*>(table2),
        reinterpret_cast<const C*>(twiddle), ts, len1, len2);
  return (int)cudaGetLastError();
}

template <typename K>
int occupancy(K kernel, int max_threads, int threads, int smem, int* blocks) {
  if (threads < 32 || threads > max_threads || smem < 0 ||
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
// success).  (P, n, S) planes; plans (int form) of the two factors of n =
// n1 * n2 (the second the empty plan of length 1 for one pass), their
// stage tables (no scale) and the inter-factor twiddle as two tables, 64
// points w_n^b then ceil(n / 64) points scale * w_n^(64 a), all as
// interleaved fp32 pairs.  The layout (cuda_kernels.strided_layout): `ts`
// columns a block (1 <= ts <= S), `threads` a block (a multiple of 32 up
// to 1024, enough for a whole sequence of every stage in a round) and the
// dynamic shared bytes, exactly; any other layout is refused
// (cudaErrorInvalidValue).
int vk_fft_strided(const float* xr, const float* xi, float* yr, float* yi,
                   long long P, long long S, const int* plan1,
                   const int* plan2, const float* table1, const float* table2,
                   const float* twiddle, int ts, int threads, int smem,
                   void* stream) {
  return launch<float2>(fft_strided_kernel, kThreads, xr, xi, yr, yi, P, S,
                        plan1, plan2, table1, table2, twiddle, ts, threads,
                        smem, stream);
}

// vk_fft_strided on fp64 planes and tables (interleaved fp64 pairs), at
// most 512 threads a block.
int vk_fft_strided_f64(const double* xr, const double* xi, double* yr,
                       double* yi, long long P, long long S, const int* plan1,
                       const int* plan2, const double* table1,
                       const double* table2, const double* twiddle, int ts,
                       int threads, int smem, void* stream) {
  return launch<double2>(fft_strided_f64_kernel, kThreads64, xr, xi, yr, yi,
                         P, S, plan1, plan2, table1, table2, twiddle, ts,
                         threads, smem, stream);
}

// Resident blocks an SM of the kernel at `threads` a block and `smem`
// dynamic shared bytes, into *blocks.
// vk_fft_strided on fp16 / bf16 planes (the tables fp32, as
// vk_fft_strided's).
int vk_fft_strided_f16(const __half* xr, const __half* xi, __half* yr,
                       __half* yi, long long P, long long S, const int* plan1,
                       const int* plan2, const float* table1,
                       const float* table2, const float* twiddle, int ts,
                       int threads, int smem, void* stream) {
  return launch<float2>(fft_strided_f16_kernel, kThreads, xr, xi, yr, yi, P,
                        S, plan1, plan2, table1, table2, twiddle, ts, threads,
                        smem, stream);
}

int vk_fft_strided_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                        __nv_bfloat16* yr, __nv_bfloat16* yi, long long P,
                        long long S, const int* plan1, const int* plan2,
                        const float* table1, const float* table2,
                        const float* twiddle, int ts, int threads, int smem,
                        void* stream) {
  return launch<float2>(fft_strided_bf16_kernel, kThreads, xr, xi, yr, yi, P,
                        S, plan1, plan2, table1, table2, twiddle, ts, threads,
                        smem, stream);
}

// vk_fft_strided under a zero-pad window: `window` points to the 6 ints
// of ColWindow (in_plane, in_row, cs, cw, in_keep, out_keep); the output
// is (P, out_keep, S) planes.  A window that is not one is refused.
int vk_fft_strided_zp(const float* xr, const float* xi, float* yr, float* yi,
                      long long P, long long S, const int* plan1,
                      const int* plan2, const float* table1,
                      const float* table2, const float* twiddle, int ts,
                      int threads, int smem, const long long* window,
                      void* stream) {
  return launch<float2, true>(fft_strided_zp_kernel, kThreads, xr, xi, yr, yi, P, S,
                        plan1, plan2, table1, table2, twiddle, ts, threads,
                        smem, stream, window);
}

int vk_fft_strided_zp_f64(const double* xr, const double* xi, double* yr,
                          double* yi, long long P, long long S,
                          const int* plan1, const int* plan2,
                          const double* table1, const double* table2,
                          const double* twiddle, int ts, int threads,
                          int smem, const long long* window, void* stream) {
  return launch<double2, true>(fft_strided_zp_f64_kernel, kThreads64, xr, xi, yr,
                         yi, P, S, plan1, plan2, table1, table2, twiddle, ts,
                         threads, smem, stream, window);
}

int vk_fft_strided_zp_f16(const __half* xr, const __half* xi, __half* yr,
                          __half* yi, long long P, long long S,
                          const int* plan1, const int* plan2,
                          const float* table1, const float* table2,
                          const float* twiddle, int ts, int threads,
                          int smem, const long long* window, void* stream) {
  return launch<float2, true>(fft_strided_zp_f16_kernel, kThreads, xr, xi, yr, yi,
                        P, S, plan1, plan2, table1, table2, twiddle, ts,
                        threads, smem, stream, window);
}

int vk_fft_strided_zp_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                           __nv_bfloat16* yr, __nv_bfloat16* yi, long long P,
                           long long S, const int* plan1, const int* plan2,
                           const float* table1, const float* table2,
                           const float* twiddle, int ts, int threads,
                           int smem, const long long* window, void* stream) {
  return launch<float2, true>(fft_strided_zp_bf16_kernel, kThreads, xr, xi, yr, yi,
                        P, S, plan1, plan2, table1, table2, twiddle, ts,
                        threads, smem, stream, window);
}

int vk_fft_strided_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_strided_kernel, kThreads, threads, smem, blocks);
}

int vk_fft_strided_f64_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_strided_f64_kernel, kThreads64, threads, smem, blocks);
}

int vk_fft_strided_f16_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_strided_f16_kernel, kThreads, threads, smem, blocks);
}

int vk_fft_strided_bf16_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_strided_bf16_kernel, kThreads, threads, smem, blocks);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
