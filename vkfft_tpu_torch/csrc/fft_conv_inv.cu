// fft_conv_inv: natural-order (B, n) fp32 re/im planes from a spectrum in
// fft_twofactor's swapped digit order: the spectrum times a table in the
// same order, the two-factor inverse of twofactor.cuh times a scale, and a
// per-line constant added in the store (the Rader x0 term).  Replaces
// vkfft_tpu/ops/pallas_engine.py:4421 _conv_inv_kernel (has_dc is a
// non-null dc).
//
// Bound: bytes, as fft_twofactor (16 B a point read and written; the
// table, n * 8 B, is read by every line through the read-only cache and
// stays in L2).  Design: the block of fft_twofactor on the in-place walk
// of inplace.cuh, at its layout (cuda_kernels.twofactor_layout, which the
// C entry checks): a block holds its lines once each as the (n2, n1)
// matrix at the odd pitch n1 | 1, beside the factors' stage tables and
// the twiddle's two tables (the scale in them), 66.2 KB at 7918 for two
// blocks an SM where the old design's line and two scratch tiles took
// 129 KB and one.  The read goes by cp.async straight into the swapped
// positions [k2][k1] (row k2, column k1), one sweep over shared memory
// multiplies the table, the mirrored passes (rows, the conjugate twiddle,
// columns) leave natural order A[j2][j1] in place, and the store adds the
// line's constant.  So a circular convolution is one fft_twofactor
// forward (swapped) and this kernel, with no spectrum pass and no reorder
// in device memory.  A block reads all of its lines before it writes, so
// the output may alias the input.
//
// Half storage (fft_conv_inv_f16_kernel, fft_conv_inv_bf16_kernel; C
// entries vk_fft_conv_inv_f16, vk_fft_conv_inv_bf16): the same body,
// layout and bound on __half or __nv_bfloat16 planes, 8 B a point of
// device memory where fp32 moves 16; the spectrum table, the per-line
// constants (one fp32 value a line), shared memory and every stage stay
// fp32.  The lines come in through registers (load_lines: no 2-byte
// cp.async), widened, and go out narrowed once, to nearest even, after the
// constant is added (store_lines).
#include "inplace.cuh"
#include "twofactor.cuh"

namespace {

using vkfft::Plan;
using vkfft::cmul;
using namespace vkfft::walk;

constexpr int kThreads = 512;  // most threads a block
constexpr int kMinBlocks = 2;  // blocks an SM the register budget keeps

// A stored point plus its line's constant (none when re is null).
struct AddLine {
  const float* re;
  const float* im;
  long long line0;
  __device__ __forceinline__ float2 operator()(float2 v, int line, int) const {
    if (re == nullptr) return v;
    return make_float2(v.x + __ldg(&re[line0 + line]),
                       v.y + __ldg(&im[line0 + line]));
  }
};

// The block body on planes of storage type St (float, or a half type on
// the same fp32 walk).
template <class St>
__device__ __forceinline__ void conv_inv_block(
    float2* smem, const St* xr, const St* xi, St* yr, St* yi,
    long long batch, const Plan& p1, const Plan& p2, const float2* t1,
    const float2* t2, const float2* tw, const float2* spec, const float* dcr,
    const float* dci, int lines, int pitch, int len1, int len2) {
  const int n1 = p1.n, n2 = p2.n, n = n1 * n2;
  const int S = n2 * pitch;
  const int nl = block_lines(lines, batch);
  float2* home = smem;
  float2* s1 = home + lines * S;
  load_tables(s1, t1, t2, tw, len1, len2, rotation_points(n));
  // swapped order in and natural order out: both row-major [r][c] at r * P
  // + c, position t = r * n1 + c of a line
  const Map mp = make_map(n, S, false, n1, n2, pitch);
  if constexpr (kNarrow<St>)
    load_lines(xr, xi, block_line0(lines) * n, nl * n, mp, home);
  else
    load_lines_async(xr, xi, block_line0(lines) * n, nl * n, mp, home);
  __syncthreads();
  for (int u = threadIdx.x; u < nl * n; u += blockDim.x) {
    const int at = position(u, mp);
    home[at] = cmul(home[at], __ldg(&spec[u - quot(u, mp.dn) * n]));
  }
  __syncthreads();
  const float2* tlo = s1 + len1 + len2;
  two_factor_passes(home, nl, p1, p2, s1, s1 + len1, tlo, tlo + kTwLo, pitch);
  const long long line0 = block_line0(lines);
  store_lines(home, mp, yr, yi, line0 * n, block_lines(lines, batch) * n,
              AddLine{dcr, dci, line0});
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_conv_inv_kernel(const float* xr, const float* xi, float* yr, float* yi,
                    long long batch, Plan p1, Plan p2, const float2* t1,
                    const float2* t2, const float2* tw, const float2* spec,
                    const float* dcr, const float* dci, int lines, int pitch,
                    int len1, int len2) {
  extern __shared__ __align__(16) float2 smem[];
  conv_inv_block(smem, xr, xi, yr, yi, batch, p1, p2, t1, t2, tw, spec, dcr,
                 dci, lines, pitch, len1, len2);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_conv_inv_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                        __half* yi, long long batch, Plan p1, Plan p2,
                        const float2* t1, const float2* t2, const float2* tw,
                        const float2* spec, const float* dcr,
                        const float* dci, int lines, int pitch, int len1,
                        int len2) {
  extern __shared__ __align__(16) float2 smem[];
  conv_inv_block(smem, xr, xi, yr, yi, batch, p1, p2, t1, t2, tw, spec, dcr,
                 dci, lines, pitch, len1, len2);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_conv_inv_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                         __nv_bfloat16* yr, __nv_bfloat16* yi,
                         long long batch, Plan p1, Plan p2, const float2* t1,
                         const float2* t2, const float2* tw,
                         const float2* spec, const float* dcr,
                         const float* dci, int lines, int pitch, int len1,
                         int len2) {
  extern __shared__ __align__(16) float2 smem[];
  conv_inv_block(smem, xr, xi, yr, yi, batch, p1, p2, t1, t2, tw, spec, dcr,
                 dci, lines, pitch, len1, len2);
}

// The checks and the launch of `kernel` on planes of storage type St, as
// vk_fft_conv_inv describes them.
template <class St, typename K>
int launch(K kernel, const St* xr, const St* xi, St* yr, St* yi,
           long long batch, const int* plan1, const int* plan2,
           const float* table1, const float* table2, const float* twiddle,
           const float* spectrum, const float* dc_re, const float* dc_im,
           int threads, int lines, int smem, void* stream) {
  Plan p1, p2;
  if (batch < 1 || !vkfft::plan_from_ints(plan1, &p1) ||
      !vkfft::subplan_from_ints(plan2, &p2) || !p1.inverse ||
      spectrum == nullptr || twiddle == nullptr ||
      (dc_re == nullptr) != (dc_im == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n = p1.n * p2.n;
  if (n < 2 || n > vkfft::kTwoFactorMaxN || p1.n < p2.n ||
      p1.inverse != p2.inverse || threads < 32 || threads > kThreads ||
      threads % 32 != 0 || lines < 1 ||
      (long long)lines * n > vkfft::kTwoFactorMaxN ||
      !rounds_fit(p1, threads) || !rounds_fit(p2, threads) || smem < 0 ||
      (size_t)smem != two_factor_smem(p1, p2, lines) ||
      smem > vkfft::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (batch + lines - 1) / lines;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int err = smem_opt_in(kernel, smem);
  if (err) return err;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, batch, p1, p2, reinterpret_cast<const float2*>(table1),
      reinterpret_cast<const float2*>(table2),
      reinterpret_cast<const float2*>(twiddle),
      reinterpret_cast<const float2*>(spectrum), dc_re, dc_im, lines,
      p1.n | 1, table_len(p1), table_len(p2));
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
// success).  Plans, tables and layout as for vk_fft_twofactor (both plans
// inverse; the scale rides `twiddle`'s high table, 64 points w_n^(-b) then
// ceil(n / 64) points scale * w_n^(-64 a)); `spectrum` an (n) table of
// fp32 pairs in swapped order; `dc_re`/`dc_im` one value a line, added
// after the scale, or both null.  The layout (cuda_kernels.twofactor_layout:
// `threads`, `lines` a block, the exact dynamic shared bytes) is checked
// as vk_fft_twofactor checks it; any other is refused
// (cudaErrorInvalidValue).
int vk_fft_conv_inv(const float* xr, const float* xi, float* yr, float* yi,
                    long long batch, const int* plan1, const int* plan2,
                    const float* table1, const float* table2,
                    const float* twiddle, const float* spectrum,
                    const float* dc_re, const float* dc_im, int threads,
                    int lines, int smem, void* stream) {
  return launch(fft_conv_inv_kernel, xr, xi, yr, yi, batch, plan1, plan2,
                table1, table2, twiddle, spectrum, dc_re, dc_im, threads,
                lines, smem, stream);
}

// vk_fft_conv_inv on fp16 / bf16 planes (the tables, the spectrum and the
// per-line constants fp32, as vk_fft_conv_inv's).
int vk_fft_conv_inv_f16(const __half* xr, const __half* xi, __half* yr,
                        __half* yi, long long batch, const int* plan1,
                        const int* plan2, const float* table1,
                        const float* table2, const float* twiddle,
                        const float* spectrum, const float* dc_re,
                        const float* dc_im, int threads, int lines, int smem,
                        void* stream) {
  return launch(fft_conv_inv_f16_kernel, xr, xi, yr, yi, batch, plan1, plan2,
                table1, table2, twiddle, spectrum, dc_re, dc_im, threads,
                lines, smem, stream);
}

int vk_fft_conv_inv_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                         __nv_bfloat16* yr, __nv_bfloat16* yi,
                         long long batch, const int* plan1, const int* plan2,
                         const float* table1, const float* table2,
                         const float* twiddle, const float* spectrum,
                         const float* dc_re, const float* dc_im, int threads,
                         int lines, int smem, void* stream) {
  return launch(fft_conv_inv_bf16_kernel, xr, xi, yr, yi, batch, plan1,
                plan2, table1, table2, twiddle, spectrum, dc_re, dc_im,
                threads, lines, smem, stream);
}

// Resident blocks an SM of the kernel at `threads` a block and `smem`
// dynamic shared bytes, into *blocks.
int vk_fft_conv_inv_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_conv_inv_kernel, threads, smem, blocks);
}

int vk_fft_conv_inv_f16_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_conv_inv_f16_kernel, threads, smem, blocks);
}

int vk_fft_conv_inv_bf16_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_conv_inv_bf16_kernel, threads, smem, blocks);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
