// fft_twofactor: batched C2C FFT of contiguous (B, n) fp32 re/im planes,
// n = n1 * n2 <= 16384, as the two-factor DFT of twofactor.cuh: forward
// from natural order to natural or swapped digit order, inverse from
// either order to natural order, times a scale.  Replaces
// vkfft_tpu/ops/pallas_engine.py:897 _fft_kernel_v2 (with its zero-pad
// options in_nonzero and out_keep in the windowed entries below) and,
// through cuda_kernels.twofactor_split, :152 _fft_kernel.
//
// What bounds it.  The floor is bytes: each point read once and written
// once, 16 B of planes.  The kernel reaches 30 % of it at 819 x 10240 on
// an H100 (PERF.md): the stage walk in shared memory bounds it, a
// barrier a round and the index work of each butterfly, at 64 registers
// a thread; at 7918 = 107 * 74 the O(r^2) generic stage of the prime 107
// does.  The old design kept one block an SM (the line plus two 4096-point
// scratch tiles), so loads, stages and stores ran in series; this one
// keeps the line once, with no scratch, for two blocks an SM.
//
// Shared memory.  A block holds `lines` lines (several when n < 2048,
// cuda_kernels.twofactor_layout) once each, as the (n2, n1) row-major
// matrix A[j2][j1] with an odd row pitch P = n1 | 1 in float2, beside the
// factors' stage tables and the inter-factor twiddle's two tables (w_n^e
// = hi[e >> 6] * lo[e & 63], the scale in hi), all copied in at the
// block's start: 66.2 KB at 7918, 84.4 KB at 10240, 133.8 KB at 16384.
// With the registers (64 a thread at 512 threads) that gives 2, 2 and 1
// resident blocks an SM (vk_fft_twofactor_occupancy on an H100).
//
// The passes run in place on the stage walk of inplace.cuh: the column
// pass (n1 sequences of n2 points, P apart) and the row pass (n2
// sequences of n1 points, contiguous), each in rounds held in registers.
// The inter-factor twiddle is the walk's hook (InterTwiddle), computed
// from its exponent k2 * j1 < n in the last stage of the column pass
// (forward; of the row pass when n2 = 1, where it is the scale) or of the
// row pass (inverse), on the outputs a thread already holds: the first row
// stage's read would take each input of a generic stage r times.
//
// Device memory is read and written contiguously (inplace.cuh's
// load_lines/store_lines); the natural-order forward store and the
// natural-order inverse load transpose through strided shared-memory
// accesses.  A block reads all of its lines before it writes, so the
// output may alias the input.
//
// Half storage (fft_twofactor_f16_kernel, fft_twofactor_bf16_kernel; C
// entries vk_fft_twofactor_f16, vk_fft_twofactor_bf16): the same body,
// layout and bounds on __half or __nv_bfloat16 planes, 8 B a point of
// device memory where fp32 moves 16; the tables, shared memory and every
// stage stay fp32, each value widened on the read and narrowed once, to
// nearest even, on the write (inplace.cuh's load_lines/store_lines).
//
// Zero-pad windows (fft_twofactor_zp_kernel and its half twins; C entries
// vk_fft_twofactor_zp, vk_fft_twofactor_zp_f16, vk_fft_twofactor_zp_bf16):
// fft_lines.cu's windowed body (inplace.cuh's two_factor_block_window) on
// this kernel's layout and bounds, natural order both ways: the declared-
// zero points of each line are never read, the output is cropped to a
// kept prefix or written whole with zeros over a declared-zero range.
// Kernels of their own, so the unwindowed ones compile as before.
#include "inplace.cuh"
#include "twofactor.cuh"

namespace {

using vkfft::Plan;
using namespace vkfft::walk;

constexpr int kThreads = 512;  // most threads a block
constexpr int kMinBlocks = 2;  // blocks an SM the register budget keeps

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_twofactor_kernel(const float* xr, const float* xi, float* yr, float* yi,
                     long long batch, Plan p1, Plan p2, const float2* t1,
                     const float2* t2, const float2* tw, int swapped,
                     int lines, int pitch, int len1, int len2) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block(smem, xr, xi, yr, yi, batch, p1, p2, t1, t2, tw, swapped,
                   lines, pitch, len1, len2);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_twofactor_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                         __half* yi, long long batch, Plan p1, Plan p2,
                         const float2* t1, const float2* t2, const float2* tw,
                         int swapped, int lines, int pitch, int len1,
                         int len2) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block(smem, xr, xi, yr, yi, batch, p1, p2, t1, t2, tw, swapped,
                   lines, pitch, len1, len2);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_twofactor_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                          __nv_bfloat16* yr, __nv_bfloat16* yi,
                          long long batch, Plan p1, Plan p2, const float2* t1,
                          const float2* t2, const float2* tw, int swapped,
                          int lines, int pitch, int len1, int len2) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block(smem, xr, xi, yr, yi, batch, p1, p2, t1, t2, tw, swapped,
                   lines, pitch, len1, len2);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_twofactor_zp_kernel(const float* xr, const float* xi, float* yr,
                        float* yi, Plan p1, Plan p2, const float2* t1,
                        const float2* t2, const float2* tw, int lines,
                        int pitch, int len1, int len2, LineWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block_window(smem, xr, xi, yr, yi, p1, p2, t1, t2, tw, lines,
                          pitch, len1, len2, w);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_twofactor_zp_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                            __half* yi, Plan p1, Plan p2, const float2* t1,
                            const float2* t2, const float2* tw, int lines,
                            int pitch, int len1, int len2, LineWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block_window(smem, xr, xi, yr, yi, p1, p2, t1, t2, tw, lines,
                          pitch, len1, len2, w);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_twofactor_zp_bf16_kernel(const __nv_bfloat16* xr,
                             const __nv_bfloat16* xi, __nv_bfloat16* yr,
                             __nv_bfloat16* yi, Plan p1, Plan p2,
                             const float2* t1, const float2* t2,
                             const float2* tw, int lines, int pitch, int len1,
                             int len2, LineWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  two_factor_block_window(smem, xr, xi, yr, yi, p1, p2, t1, t2, tw, lines,
                          pitch, len1, len2, w);
}

template <typename K>
int smem_opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// The checks of a launch (the layout of cuda_kernels.twofactor_layout),
// the plans into p1 and p2.
int prepare(long long batch, const int* plan1, const int* plan2, int threads,
            int lines, int smem, Plan* p1, Plan* p2) {
  if (batch < 1 || !vkfft::plan_from_ints(plan1, p1) ||
      !vkfft::subplan_from_ints(plan2, p2))
    return (int)cudaErrorInvalidValue;
  const int n = p1->n * p2->n;
  if (n < 2 || n > vkfft::kTwoFactorMaxN || p1->n < p2->n ||
      p1->inverse != p2->inverse || threads < 32 || threads > kThreads ||
      threads % 32 != 0 || lines < 1 ||
      (long long)lines * n > vkfft::kTwoFactorMaxN ||
      !rounds_fit(*p1, threads) || !rounds_fit(*p2, threads) || smem < 0 ||
      (size_t)smem != two_factor_smem(*p1, *p2, lines) ||
      smem > vkfft::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The checks and the launch of `kernel` on planes of storage type St
// (float, or a half type on the same fp32 walk).
template <class St, typename K>
int launch(K kernel, const St* xr, const St* xi, St* yr, St* yi,
           long long batch, const int* plan1, const int* plan2,
           const float* table1, const float* table2, const float* twiddle,
           int swapped, int threads, int lines, int smem, void* stream) {
  Plan p1, p2;
  int err = prepare(batch, plan1, plan2, threads, lines, smem, &p1, &p2);
  if (err) return err;
  const long long blocks = (batch + lines - 1) / lines;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  err = smem_opt_in(kernel, smem);
  if (err) return err;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, batch, p1, p2, reinterpret_cast<const float2*>(table1),
      reinterpret_cast<const float2*>(table2),
      reinterpret_cast<const float2*>(twiddle), swapped, lines, p1.n | 1,
      table_len(p1), table_len(p2));
  return (int)cudaGetLastError();
}

// launch under a window (the 11 ints of inplace.cuh's window_from_ints):
// `batch` output lines, ceil(d2 / lines) blocks a group of d2.
template <class St, typename K>
int launch_window(K kernel, const St* xr, const St* xi, St* yr, St* yi,
                  long long batch, const int* plan1, const int* plan2,
                  const float* table1, const float* table2,
                  const float* twiddle, int threads, int lines, int smem,
                  const long long* window, void* stream) {
  Plan p1, p2;
  LineWindow w;
  int err = prepare(batch, plan1, plan2, threads, lines, smem, &p1, &p2);
  if (err) return err;
  if (!window_from_ints(window, p1.n * p2.n, batch, &w))
    return (int)cudaErrorInvalidValue;
  const long long blocks = batch / w.d2 * ((w.d2 + lines - 1) / lines);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  err = smem_opt_in(kernel, smem);
  if (err) return err;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, p1, p2, reinterpret_cast<const float2*>(table1),
      reinterpret_cast<const float2*>(table2),
      reinterpret_cast<const float2*>(twiddle), lines, p1.n | 1,
      table_len(p1), table_len(p2), w);
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
// success).  `plan1`/`plan2` are the int forms of the n1- and n2-point
// plans (both forward or both inverse; `plan2` may be the empty plan of a
// length-1 factor), `table1`/`table2` their stage tables (no scale) and
// `twiddle` the inter-factor twiddle's tables, 64 points w_n^(+-b) then
// ceil(n / 64) points scale * w_n^(+-64 a), all as interleaved fp32 pairs.
// The layout (cuda_kernels.twofactor_layout): `threads` a block (a
// multiple of 32 up to 512, enough for a whole sequence of every stage in
// a round), `lines` a block (lines * n <= 16384) and the dynamic shared
// bytes, which must be exactly what the layout needs and at most 227 KB;
// any other layout is refused (cudaErrorInvalidValue).
int vk_fft_twofactor(const float* xr, const float* xi, float* yr, float* yi,
                     long long batch, const int* plan1, const int* plan2,
                     const float* table1, const float* table2,
                     const float* twiddle, int swapped, int threads, int lines,
                     int smem, void* stream) {
  return launch(fft_twofactor_kernel, xr, xi, yr, yi, batch, plan1, plan2,
                table1, table2, twiddle, swapped, threads, lines, smem,
                stream);
}

// vk_fft_twofactor on fp16 / bf16 planes (the tables fp32, as
// vk_fft_twofactor's).
int vk_fft_twofactor_f16(const __half* xr, const __half* xi, __half* yr,
                         __half* yi, long long batch, const int* plan1,
                         const int* plan2, const float* table1,
                         const float* table2, const float* twiddle,
                         int swapped, int threads, int lines, int smem,
                         void* stream) {
  return launch(fft_twofactor_f16_kernel, xr, xi, yr, yi, batch, plan1, plan2,
                table1, table2, twiddle, swapped, threads, lines, smem,
                stream);
}

int vk_fft_twofactor_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                          __nv_bfloat16* yr, __nv_bfloat16* yi,
                          long long batch, const int* plan1, const int* plan2,
                          const float* table1, const float* table2,
                          const float* twiddle, int swapped, int threads,
                          int lines, int smem, void* stream) {
  return launch(fft_twofactor_bf16_kernel, xr, xi, yr, yi, batch, plan1,
                plan2, table1, table2, twiddle, swapped, threads, lines, smem,
                stream);
}

// vk_fft_twofactor under a zero-pad window, natural order both ways (no
// `swapped`): `window` points to the 11 ints of inplace.cuh's LineWindow;
// `batch` is the count of output lines, written compact at `out` points a
// line.  A window that is not one is refused.
int vk_fft_twofactor_zp(const float* xr, const float* xi, float* yr,
                        float* yi, long long batch, const int* plan1,
                        const int* plan2, const float* table1,
                        const float* table2, const float* twiddle,
                        int threads, int lines, int smem,
                        const long long* window, void* stream) {
  return launch_window(fft_twofactor_zp_kernel, xr, xi, yr, yi, batch, plan1,
                       plan2, table1, table2, twiddle, threads, lines, smem,
                       window, stream);
}

int vk_fft_twofactor_zp_f16(const __half* xr, const __half* xi, __half* yr,
                            __half* yi, long long batch, const int* plan1,
                            const int* plan2, const float* table1,
                            const float* table2, const float* twiddle,
                            int threads, int lines, int smem,
                            const long long* window, void* stream) {
  return launch_window(fft_twofactor_zp_f16_kernel, xr, xi, yr, yi, batch,
                       plan1, plan2, table1, table2, twiddle, threads, lines,
                       smem, window, stream);
}

int vk_fft_twofactor_zp_bf16(const __nv_bfloat16* xr,
                             const __nv_bfloat16* xi, __nv_bfloat16* yr,
                             __nv_bfloat16* yi, long long batch,
                             const int* plan1, const int* plan2,
                             const float* table1, const float* table2,
                             const float* twiddle, int threads, int lines,
                             int smem, const long long* window,
                             void* stream) {
  return launch_window(fft_twofactor_zp_bf16_kernel, xr, xi, yr, yi, batch,
                       plan1, plan2, table1, table2, twiddle, threads, lines,
                       smem, window, stream);
}

// Resident blocks an SM of the kernel at `threads` a block and `smem`
// dynamic shared bytes, into *blocks.
int vk_fft_twofactor_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_twofactor_kernel, threads, smem, blocks);
}

int vk_fft_twofactor_f16_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_twofactor_f16_kernel, threads, smem, blocks);
}

int vk_fft_twofactor_bf16_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_twofactor_bf16_kernel, threads, smem, blocks);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
