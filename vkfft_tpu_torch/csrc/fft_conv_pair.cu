// fft_conv_pair: Bluestein transform of each line of contiguous (B, n) fp32
// re/im planes through a padded length m = nc * ns <= 2^16, in one launch.
// Replaces vkfft_tpu/ops/pallas_engine.py:2205 _conv_pair_kernel in its
// Bluestein mode (_bluestein_pair_p, :522); the 2-D convolution mode is
// not ported yet.
//
// The padded line y[k] = x[k] a[k] (zero for k >= n) is the (nc, ns)
// row-major plane P[kc][ks] = y[kc*ns + ks].  With K = ks'*nc + kc':
//     Y[K] = sum_js w_ns^(js*ks') w_m^(js*kc') sum_jc w_nc^(jc*kc') P[jc][js]
// so the forward runs the nc stages down every column, the four-step
// twiddle w_m^(kc'*js), and the ns stages along every row, which leaves
// Y[ks'*nc + kc'] at [kc'][ks']; the spectrum table comes in that order,
// the inverse mirrors the forward (rows, conjugate twiddle, columns) back
// to natural order, and the write keeps k < n times the chirp.  These are
// the nine steps of the TPU kernel (chirp, nc stages, twiddle, ns stages,
// multiply, inverse ns stages, conjugate twiddle, inverse nc stages, crop
// and chirp).
//
// Bound: operations at the main path's m = 32768 (two m-point FFTs, about
// 10 m log2 m flops, for 16 n bytes of traffic a line).  Design: m = 32768
// points are 256 KB, more than one block's shared memory, so a
// thread-block cluster of C blocks (chosen by the host, as fft_pair's)
// holds the plane: block `rank` owns the column tile [rank*ns/C, ...) for
// the column stages and the row tile [rank*nc/C, ...) for the row stages,
// and the tiles move between blocks over distributed shared memory, as in
// fft_pair.cu.  Device memory sees one read and one write of the n-point
// line; the pad never exists there.  Every read of a line precedes the
// first cluster barrier and every write follows it, so the output may
// alias the input.
#include <cooperative_groups.h>

#include "stockham.cuh"

namespace cg = cooperative_groups;

namespace {

using vkfft::Plan;
using vkfft::cmul;

__device__ __forceinline__ float2 conjf2(float2 a) { return make_float2(a.x, -a.y); }

__global__ void __launch_bounds__(512)
fft_conv_pair_kernel(const float* xr, const float* xi, float* yr, float* yi,
                     int n, Plan pcf, Plan psf, Plan psi, Plan pci,
                     const float2* tcf, const float2* tsf, const float2* tsi,
                     const float2* tci, const float2* tw, const float2* spec,
                     const float2* chirp) {
  extern __shared__ __align__(16) float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int nc = pcf.n, ns = psf.n;
  const int rows = nc / C;       // row tile: rows [r0, r0 + rows), all ns columns
  const int cols = ns / C;       // column tile: columns [c0, c0 + cols), all nc rows
  const int count = nc * cols;   // == rows * ns
  const int r0 = rank * rows, c0 = rank * cols;
  const long long base = (long long)(blockIdx.x / C) * n;
  float2* a = smem;
  float2* b = smem + count;

  // 1. the column tile of the padded line, times the chirp
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int kc = t / cols;
    const int k = kc * ns + c0 + (t - kc * cols);
    float2 v = make_float2(0.f, 0.f);
    if (k < n) v = cmul(make_float2(xr[base + k], xi[base + k]), __ldg(&chirp[k]));
    a[t] = v;
  }
  __syncthreads();
  // 2-3. the nc stages down the columns, then the twiddle w_m^(kc*js)
  float2* f = vkfft::run_stages<true>(a, b, cols, 1, cols, pcf, tcf);
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int kc = t / cols;
    f[t] = cmul(f[t], __ldg(&tw[kc * ns + c0 + (t - kc * cols)]));
  }
  cluster.sync();   // every block's columns are done

  // gather the row tile out of every block's column tile
  float2* rt = f == a ? b : a;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int r = t / ns;
    const int js = t - r * ns;
    const int owner = js / cols;
    const float2* src = cluster.map_shared_rank(f, owner);
    rt[t] = src[(r0 + r) * cols + js - owner * cols];
  }
  cluster.sync();   // every gather is done: the column buffers are free

  // 4-7. the ns stages along the rows, the multiply, the inverse ns
  // stages and the conjugate twiddle
  float2* g = vkfft::run_stages<false>(rt, f, rows, ns, 1, psf, tsf);
  for (int t = threadIdx.x; t < count; t += blockDim.x)
    g[t] = cmul(g[t], __ldg(&spec[r0 * ns + t]));
  __syncthreads();
  float2* h = vkfft::run_stages<false>(g, g == rt ? f : rt, rows, ns, 1, psi, tsi);
  for (int t = threadIdx.x; t < count; t += blockDim.x)
    h[t] = cmul(h[t], conjf2(__ldg(&tw[r0 * ns + t])));
  cluster.sync();   // every block's rows are done

  // gather the column tile out of every block's row tile
  float2* ct = h == a ? b : a;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int kc = t / cols;
    const int owner = kc / rows;
    const float2* src = cluster.map_shared_rank(h, owner);
    ct[t] = src[(kc - owner * rows) * ns + c0 + (t - kc * cols)];
  }
  cluster.sync();   // every gather is done: the row buffers are free

  // 8-9. the inverse nc stages, then the crop and the chirp
  const float2* o = vkfft::run_stages<true>(ct, h, cols, 1, cols, pci, tci);
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int jc = t / cols;
    const int k = jc * ns + c0 + (t - jc * cols);
    if (k < n) {
      const float2 v = cmul(o[t], __ldg(&chirp[k]));
      yr[base + k] = v.x;
      yi[base + k] = v.y;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  Plans (int form) and stage tables of the nc forward, ns
// forward, ns inverse and nc inverse runs; `twiddle` the (nc, ns) table
// w_m^(kc*js); `spectrum` the (nc, ns) table [kc][ks] = FFT_m(b)[ks*nc +
// kc] * scale / m; `chirp` the n-point chirp, all as interleaved fp32
// pairs.  `cluster` blocks share each line and must divide nc and ns.
int vk_fft_conv_pair(const float* xr, const float* xi, float* yr, float* yi,
                     long long batch, int n, const int* plan_cf,
                     const int* plan_sf, const int* plan_si, const int* plan_ci,
                     const float* table_cf, const float* table_sf,
                     const float* table_si, const float* table_ci,
                     const float* twiddle, const float* spectrum,
                     const float* chirp, int cluster, void* stream) {
  Plan pcf, psf, psi, pci;
  if (batch < 1 || !vkfft::plan_from_ints(plan_cf, &pcf) ||
      !vkfft::plan_from_ints(plan_sf, &psf) || !vkfft::plan_from_ints(plan_si, &psi) ||
      !vkfft::plan_from_ints(plan_ci, &pci))
    return (int)cudaErrorInvalidValue;
  if (pcf.n != pci.n || psf.n != psi.n || pcf.inverse || psf.inverse ||
      !psi.inverse || !pci.inverse)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)pcf.n * psf.n;
  if (n < 1 || n >= m || m > (1 << 16) || twiddle == nullptr ||
      spectrum == nullptr || chirp == nullptr)
    return (int)cudaErrorInvalidValue;
  if (!(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
        cluster == 16) ||
      pcf.n % cluster || psf.n % cluster)
    return (int)cudaErrorInvalidValue;
  const int count = (int)(m / cluster);
  const size_t smem = 2 * (size_t)count * sizeof(float2);
  if (smem > (size_t)vkfft::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (batch * cluster > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fft_conv_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (cluster > 8) {   // above the portable cluster size
    cudaError_t e = cudaFuncSetAttribute(
        fft_conv_pair_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * cluster), 1, 1);
  cfg.blockDim = dim3(count > 2048 ? 512 : 256, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, fft_conv_pair_kernel, xr, xi, yr, yi, n, pcf, psf, psi, pci,
      reinterpret_cast<const float2*>(table_cf), reinterpret_cast<const float2*>(table_sf),
      reinterpret_cast<const float2*>(table_si), reinterpret_cast<const float2*>(table_ci),
      reinterpret_cast<const float2*>(twiddle), reinterpret_cast<const float2*>(spectrum),
      reinterpret_cast<const float2*>(chirp));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
