// fft_lines: batched C2C FFT of contiguous (B, n) fp32 re/im planes, n <=
// 8192 with primes <= 64, natural order in and out, forward or inverse,
// times a scale.  Replaces vkfft_tpu/ops/pallas_engine.py:1563
// _fft_kernel_v3 (the fp32 form and, in the windowed entries below, its
// zero-pad windows in_nonzero, in_window, out_keep, out_fill and
// out_zero_window; in the tl entries, its tl layout).
//
// Bound: bytes.  Each point is read once and written once (16 B of
// planes); at n <= 8192 the FFT's ~5 n log2 n flops are far below the
// card's fp32 rate for those bytes.  Design: a block holds its lines once
// each in shared memory and runs their stages in place on the walk of
// inplace.cuh (two_factor_block, the body fft_twofactor runs), with the
// stage tables and the twiddle's two root tables (the scale in them) in
// shared memory, so device memory sees one read and one write a point.
// A line is one pass of n-point stages (the second factor 1) wherever
// every stage's sequences fit one round of the block's threads, else the
// two factors of cuda_kernels.twofactor_split (a column pass, the
// twiddle, a row pass): a round holds whole sequences, and a line's last
// stage is one sequence of n / r butterflies.  A block reads, computes
// and writes in turn, so what an SM keeps loading is what its blocks hold:
// the layout (cuda_kernels.lines_layout, checked by the C entry) gives a
// thread about 32 points, for small blocks many to an SM, and the read
// goes by cp.async, each float straight to its place with every copy of
// the block in flight (PERF.md: both measured against the alternatives).
// Lines shorter than 2048 points share a block.  A block reads all its
// lines before it writes any, so the output may alias the input (in-place
// passes of an N-D walk, the long tier).
//
// fp64 (fft_lines_f64_kernel, C entry vk_fft_lines_f64): the same body on
// double planes and tables, a point 16 B of shared memory and a double2
// four registers.  The layout rule is the same in points (every layout of
// it has at most kThreads64 threads), the bound (kThreads64, 2) leaves 128
// registers a thread, and the fp64 walk holds one generic item a round
// and has no radix-16 stage (its plans are stage_radices'): with either it
// spilled at 128 registers (PERF.md §6).
//
// Half storage (fft_lines_f16_kernel, fft_lines_bf16_kernel; C entries
// vk_fft_lines_f16, vk_fft_lines_bf16): the fp32 kernel's body, layout and
// bounds on __half or __nv_bfloat16 planes, 8 B a point of device memory
// where fp32 moves 16.  The stage tables, the twiddle, shared memory and
// every stage stay fp32; cp.async has no 2-byte copy, so the read goes
// through registers (inplace.cuh's load_lines: four halves a plane in one
// 8-byte load, widened), and the write narrows each value once, rounding
// to nearest even.
//
// Zero-pad windows (fft_lines_zp_kernel and its fp64 and half twins; C
// entries vk_fft_lines_zp, vk_fft_lines_zp_f64, vk_fft_lines_zp_f16,
// vk_fft_lines_zp_bf16): the same passes on the same layout, between a
// read that skips the declared-zero points of each line (a prefix past a
// kept head, or an interior window; the lines may be a corner of wider
// planes, inplace.cuh's LineWindow) and a write of compact lines, cropped
// to a kept prefix or whole with zeros written over a declared-zero
// range.  The window's bytes are what it saves, so the read and the write
// go point by point (a window's edge falls anywhere in a four-point
// group).  Kernels of their own: the unwindowed kernels compile as before.
//
// Kept intermediate order (fft_lines_tl_kernel and its half twins; C
// entries vk_fft_lines_tl, vk_fft_lines_tl_f16, vk_fft_lines_tl_bf16): the
// keep_intermediate_order form.  The forward leaves a two-factor line in
// its factors' swapped digit order, X[k1 * n2 + k2] at k2 * n1 + k1 (the
// row-major store of the walk's matrix, no transposed shared-memory read),
// and the inverse reads that order (no transposed write); a line of one
// pass is in natural order both ways.  fp32 and the half planes; the same
// body (two_factor_block with `swapped`) in kernels of their own, so the
// natural ones compile as before.  The flag goes in through fresh_int: as
// a constant the compiler specialized the maps and spilled 16 B (the
// runtime flag, as fft_twofactor's, spills none).
#include "inplace.cuh"
#include "twofactor.cuh"

namespace {

using vkfft::Plan;
using namespace vkfft::walk;

constexpr int kThreads = 512;  // most threads a block
constexpr int kMinBlocks = 2;  // blocks an SM the register budget keeps
constexpr int kThreads64 = 256;  // ... of the fp64 kernel

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_lines_kernel(const float* xr, const float* xi, float* yr, float* yi,
                 long long batch, Plan p1, Plan p2, const float2* t1,
                 const float2* t2, const float2* tw, int lines, int pitch,
                 int len1, int len2) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block(smem, xr, xi, yr, yi, batch, p1, p2, t1, t2, tw, 0, lines,
                   pitch, len1, len2, true);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_lines_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                     __half* yi, long long batch, Plan p1, Plan p2,
                     const float2* t1, const float2* t2, const float2* tw,
                     int lines, int pitch, int len1, int len2) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block(smem, xr, xi, yr, yi, batch, p1, p2, t1, t2, tw, 0, lines,
                   pitch, len1, len2);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_lines_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                      __nv_bfloat16* yr, __nv_bfloat16* yi, long long batch,
                      Plan p1, Plan p2, const float2* t1, const float2* t2,
                      const float2* tw, int lines, int pitch, int len1,
                      int len2) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block(smem, xr, xi, yr, yi, batch, p1, p2, t1, t2, tw, 0, lines,
                   pitch, len1, len2);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_lines_tl_kernel(const float* xr, const float* xi, float* yr, float* yi,
                    long long batch, Plan p1, Plan p2, const float2* t1,
                    const float2* t2, const float2* tw, int lines, int pitch,
                    int len1, int len2) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block(smem, xr, xi, yr, yi, batch, p1, p2, t1, t2, tw,
                   fresh_int(1), lines, pitch, len1, len2, true);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_lines_tl_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                        __half* yi, long long batch, Plan p1, Plan p2,
                        const float2* t1, const float2* t2, const float2* tw,
                        int lines, int pitch, int len1, int len2) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block(smem, xr, xi, yr, yi, batch, p1, p2, t1, t2, tw,
                   fresh_int(1), lines, pitch, len1, len2);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_lines_tl_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                         __nv_bfloat16* yr, __nv_bfloat16* yi,
                         long long batch, Plan p1, Plan p2, const float2* t1,
                         const float2* t2, const float2* tw, int lines,
                         int pitch, int len1, int len2) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block(smem, xr, xi, yr, yi, batch, p1, p2, t1, t2, tw,
                   fresh_int(1), lines, pitch, len1, len2);
}

__global__ void __launch_bounds__(kThreads64, 2)
fft_lines_f64_kernel(const double* xr, const double* xi, double* yr,
                     double* yi, long long batch, Plan p1, Plan p2,
                     const double2* t1, const double2* t2, const double2* tw,
                     int lines, int pitch, int len1, int len2) {
  extern __shared__ __align__(16) double2 smem64[];
  two_factor_block(smem64, xr, xi, yr, yi, batch, p1, p2, t1, t2, tw, 0,
                   lines, pitch, len1, len2, true);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_lines_zp_kernel(const float* xr, const float* xi, float* yr, float* yi,
                    Plan p1, Plan p2, const float2* t1, const float2* t2,
                    const float2* tw, int lines, int pitch, int len1,
                    int len2, LineWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block_window(smem, xr, xi, yr, yi, p1, p2, t1, t2, tw, lines,
                          pitch, len1, len2, w);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_lines_zp_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                        __half* yi, Plan p1, Plan p2, const float2* t1,
                        const float2* t2, const float2* tw, int lines,
                        int pitch, int len1, int len2, LineWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block_window(smem, xr, xi, yr, yi, p1, p2, t1, t2, tw, lines,
                          pitch, len1, len2, w);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_lines_zp_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                         __nv_bfloat16* yr, __nv_bfloat16* yi, Plan p1,
                         Plan p2, const float2* t1, const float2* t2,
                         const float2* tw, int lines, int pitch, int len1,
                         int len2, LineWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block_window(smem, xr, xi, yr, yi, p1, p2, t1, t2, tw, lines,
                          pitch, len1, len2, w);
}

__global__ void __launch_bounds__(kThreads64, 2)
fft_lines_zp_f64_kernel(const double* xr, const double* xi, double* yr,
                        double* yi, Plan p1, Plan p2, const double2* t1,
                        const double2* t2, const double2* tw, int lines,
                        int pitch, int len1, int len2, LineWindow w) {
  extern __shared__ __align__(16) double2 smem64[];
  two_factor_block_window(smem64, xr, xi, yr, yi, p1, p2, t1, t2, tw, lines,
                          pitch, len1, len2, w);
}

template <typename K>
int smem_opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// The checks of a launch at points of type C (the layout of
// cuda_kernels.lines_layout, at most `max_threads` a block), the plans
// into p1, p2 and the blocks into *blocks.
template <class C>
int prepare(long long batch, const int* plan1, const int* plan2, int threads,
            int lines, int smem, int max_threads, Plan* p1, Plan* p2,
            long long* blocks) {
  if (batch < 1 || !vkfft::plan_from_ints(plan1, p1) ||
      !vkfft::subplan_from_ints(plan2, p2))
    return (int)cudaErrorInvalidValue;
  const int n = p1->n * p2->n;
  if (n < 2 || n > vkfft::kMaxN || p1->n < p2->n ||
      p1->inverse != p2->inverse || threads < 32 || threads > max_threads ||
      threads % 32 != 0 || lines < 1 ||
      (long long)lines * n > vkfft::kTwoFactorMaxN ||
      !rounds_fit<C>(*p1, threads) || !rounds_fit<C>(*p2, threads) ||
      smem < 0 ||
      (size_t)smem != two_factor_smem<C>(*p1, *p2, lines) ||
      smem > vkfft::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  *blocks = (batch + lines - 1) / lines;
  if (*blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return 0;
}

// The checks and the launch of `kernel` on planes of storage type St,
// points of type C (tables of C's real).
template <class C, class St, typename K>
int launch(K kernel, int max_threads, const St* xr, const St* xi, St* yr,
           St* yi, long long batch, const int* plan1, const int* plan2,
           const vkfft::Real<C>* table1, const vkfft::Real<C>* table2,
           const vkfft::Real<C>* twiddle, int threads, int lines, int smem,
           void* stream) {
  Plan p1, p2;
  long long blocks;
  int err = prepare<C>(batch, plan1, plan2, threads, lines, smem, max_threads,
                       &p1, &p2, &blocks);
  if (err) return err;
  err = smem_opt_in(kernel, smem);
  if (err) return err;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, batch, p1, p2, reinterpret_cast<const C*>(table1),
      reinterpret_cast<const C*>(table2), reinterpret_cast<const C*>(twiddle),
      lines, p1.n | 1, table_len(p1), table_len(p2));
  return (int)cudaGetLastError();
}

// launch under a window (the 11 ints of inplace.cuh's window_from_ints):
// `batch` output lines, ceil(d2 / lines) blocks a group of d2.
template <class C, class St, typename K>
int launch_window(K kernel, int max_threads, const St* xr, const St* xi,
                  St* yr, St* yi, long long batch, const int* plan1,
                  const int* plan2, const vkfft::Real<C>* table1,
                  const vkfft::Real<C>* table2, const vkfft::Real<C>* twiddle,
                  int threads, int lines, int smem, const long long* window,
                  void* stream) {
  Plan p1, p2;
  long long blocks;
  LineWindow w;
  int err = prepare<C>(batch, plan1, plan2, threads, lines, smem, max_threads,
                       &p1, &p2, &blocks);
  if (err) return err;
  if (!window_from_ints(window, p1.n * p2.n, batch, &w))
    return (int)cudaErrorInvalidValue;
  blocks = batch / w.d2 * ((w.d2 + lines - 1) / lines);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  err = smem_opt_in(kernel, smem);
  if (err) return err;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, p1, p2, reinterpret_cast<const C*>(table1),
      reinterpret_cast<const C*>(table2), reinterpret_cast<const C*>(twiddle),
      lines, p1.n | 1, table_len(p1), table_len(p2), w);
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
// success).  `plan1`/`plan2` are the int forms of the n1- and n2-point
// plans of n = n1 * n2 (both forward or both inverse; `plan2` the empty
// plan of length 1 for one pass), `table1`/`table2` their stage tables (no
// scale) and `twiddle` the twiddle's two tables, 64 points w_n^(+-b) then
// ceil(n / 64) points scale * w_n^(+-64 a), all as interleaved fp32 pairs.
// The layout (cuda_kernels.lines_layout): `threads` a block (a multiple of
// 32 up to 512, enough for a whole sequence of every stage in a round),
// `lines` a block (lines * n <= 16384) and the dynamic shared bytes, which
// must be exactly what the layout needs and at most 227 KB; any other
// layout is refused (cudaErrorInvalidValue).
int vk_fft_lines(const float* xr, const float* xi, float* yr, float* yi,
                 long long batch, const int* plan1, const int* plan2,
                 const float* table1, const float* table2,
                 const float* twiddle, int threads, int lines, int smem,
                 void* stream) {
  return launch<float2>(fft_lines_kernel, kThreads, xr, xi, yr, yi, batch,
                        plan1, plan2, table1, table2, twiddle, threads, lines,
                        smem, stream);
}

// vk_fft_lines on fp64 planes and tables (interleaved fp64 pairs), at
// most 256 threads a block.
int vk_fft_lines_f64(const double* xr, const double* xi, double* yr,
                     double* yi, long long batch, const int* plan1,
                     const int* plan2, const double* table1,
                     const double* table2, const double* twiddle, int threads,
                     int lines, int smem, void* stream) {
  return launch<double2>(fft_lines_f64_kernel, kThreads64, xr, xi, yr, yi,
                         batch, plan1, plan2, table1, table2, twiddle,
                         threads, lines, smem, stream);
}

// vk_fft_lines on fp16 / bf16 planes (the tables fp32, as vk_fft_lines's).
int vk_fft_lines_f16(const __half* xr, const __half* xi, __half* yr,
                     __half* yi, long long batch, const int* plan1,
                     const int* plan2, const float* table1,
                     const float* table2, const float* twiddle, int threads,
                     int lines, int smem, void* stream) {
  return launch<float2>(fft_lines_f16_kernel, kThreads, xr, xi, yr, yi, batch,
                        plan1, plan2, table1, table2, twiddle, threads, lines,
                        smem, stream);
}

int vk_fft_lines_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                      __nv_bfloat16* yr, __nv_bfloat16* yi, long long batch,
                      const int* plan1, const int* plan2, const float* table1,
                      const float* table2, const float* twiddle, int threads,
                      int lines, int smem, void* stream) {
  return launch<float2>(fft_lines_bf16_kernel, kThreads, xr, xi, yr, yi,
                        batch, plan1, plan2, table1, table2, twiddle, threads,
                        lines, smem, stream);
}

// vk_fft_lines in the kept intermediate order (the tl form): the forward
// writes each two-factor line in its factors' swapped digit order and the
// inverse reads that order; arguments and layout as vk_fft_lines's, on
// fp32, fp16 or bf16 planes.
int vk_fft_lines_tl(const float* xr, const float* xi, float* yr, float* yi,
                    long long batch, const int* plan1, const int* plan2,
                    const float* table1, const float* table2,
                    const float* twiddle, int threads, int lines, int smem,
                    void* stream) {
  return launch<float2>(fft_lines_tl_kernel, kThreads, xr, xi, yr, yi, batch,
                        plan1, plan2, table1, table2, twiddle, threads, lines,
                        smem, stream);
}

int vk_fft_lines_tl_f16(const __half* xr, const __half* xi, __half* yr,
                        __half* yi, long long batch, const int* plan1,
                        const int* plan2, const float* table1,
                        const float* table2, const float* twiddle,
                        int threads, int lines, int smem, void* stream) {
  return launch<float2>(fft_lines_tl_f16_kernel, kThreads, xr, xi, yr, yi,
                        batch, plan1, plan2, table1, table2, twiddle, threads,
                        lines, smem, stream);
}

int vk_fft_lines_tl_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                         __nv_bfloat16* yr, __nv_bfloat16* yi,
                         long long batch, const int* plan1, const int* plan2,
                         const float* table1, const float* table2,
                         const float* twiddle, int threads, int lines,
                         int smem, void* stream) {
  return launch<float2>(fft_lines_tl_bf16_kernel, kThreads, xr, xi, yr, yi,
                        batch, plan1, plan2, table1, table2, twiddle, threads,
                        lines, smem, stream);
}

// vk_fft_lines under a zero-pad window: `window` points to the 11 ints
// of inplace.cuh's LineWindow (s0, s1, d1, d2, s2, len, z0, z1, out, o0,
// o1); `batch` is the count of output lines, written compact at `out`
// points a line.  A window that is not one is refused.
int vk_fft_lines_zp(const float* xr, const float* xi, float* yr, float* yi,
                    long long batch, const int* plan1, const int* plan2,
                    const float* table1, const float* table2,
                    const float* twiddle, int threads, int lines, int smem,
                    const long long* window, void* stream) {
  return launch_window<float2>(fft_lines_zp_kernel, kThreads, xr, xi, yr, yi,
                               batch, plan1, plan2, table1, table2, twiddle,
                               threads, lines, smem, window, stream);
}

int vk_fft_lines_zp_f64(const double* xr, const double* xi, double* yr,
                        double* yi, long long batch, const int* plan1,
                        const int* plan2, const double* table1,
                        const double* table2, const double* twiddle,
                        int threads, int lines, int smem,
                        const long long* window, void* stream) {
  return launch_window<double2>(fft_lines_zp_f64_kernel, kThreads64, xr, xi,
                                yr, yi, batch, plan1, plan2, table1, table2,
                                twiddle, threads, lines, smem, window, stream);
}

int vk_fft_lines_zp_f16(const __half* xr, const __half* xi, __half* yr,
                        __half* yi, long long batch, const int* plan1,
                        const int* plan2, const float* table1,
                        const float* table2, const float* twiddle,
                        int threads, int lines, int smem,
                        const long long* window, void* stream) {
  return launch_window<float2>(fft_lines_zp_f16_kernel, kThreads, xr, xi, yr,
                               yi, batch, plan1, plan2, table1, table2,
                               twiddle, threads, lines, smem, window, stream);
}

int vk_fft_lines_zp_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                         __nv_bfloat16* yr, __nv_bfloat16* yi,
                         long long batch, const int* plan1, const int* plan2,
                         const float* table1, const float* table2,
                         const float* twiddle, int threads, int lines,
                         int smem, const long long* window, void* stream) {
  return launch_window<float2>(fft_lines_zp_bf16_kernel, kThreads, xr, xi,
                               yr, yi, batch, plan1, plan2, table1, table2,
                               twiddle, threads, lines, smem, window, stream);
}

// Resident blocks an SM of the kernel at `threads` a block and `smem`
// dynamic shared bytes, into *blocks.
int vk_fft_lines_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_lines_kernel, kThreads, threads, smem, blocks);
}

int vk_fft_lines_f64_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_lines_f64_kernel, kThreads64, threads, smem, blocks);
}

int vk_fft_lines_f16_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_lines_f16_kernel, kThreads, threads, smem, blocks);
}

int vk_fft_lines_bf16_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_lines_bf16_kernel, kThreads, threads, smem, blocks);
}

int vk_fft_lines_tl_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_lines_tl_kernel, kThreads, threads, smem, blocks);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
