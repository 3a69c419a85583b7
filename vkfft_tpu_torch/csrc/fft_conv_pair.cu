// fft_conv_pair: two modes of one TPU kernel, each a plane held in the
// shared memory of a thread-block cluster, in one launch.  Replaces
// vkfft_tpu/ops/pallas_engine.py:2205 _conv_pair_kernel in both its modes:
//   Bluestein (fft_conv_pair_kernel; _bluestein_pair_p, :522): each line
//     of contiguous (B, n) fp32 re/im planes through a padded length
//     m = nc * ns <= 2^16;
//   2-D convolution (fft_conv2d_kernel; conv_fused_pair, :2392): each
//     (ny, nz) plane of contiguous (B, ny, nz) planes circularly convolved
//     with a fixed kernel given by its (hp, ny, nz) spectrum, plane b
//     multiplied by spectrum b % hp (hp = 1: one shared 2-D kernel; hp > 1:
//     the per-slice spectra of an N-D kernel after its outer axes).
//
// Bluestein mode.  The padded line y[k] = x[k] a[k] (zero for k >= n) is
// the (nc, ns) row-major plane P[kc][ks] = y[kc*ns + ks].  With K = ks'*nc + kc':
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
// Bound: operations at sample 7's m = 32768 (two m-point FFTs, about
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
//
// 2-D mode.  The same body without chirp or twiddle, in the other order:
// block `rank` reads the row tile [rank*ny/C, ...) of its plane (one
// contiguous run of device memory), runs the nz stages along its rows,
// gathers the column tile [rank*nz/C, ...) out of every block's row tile,
// runs the ny stages down its columns, multiplies by the spectrum in
// natural (ky, kz) order (Im negated first under kConjData; under kXpow
// divided by max(|Y|, 1e-30), the pair kernel's own form, :2288), runs
// the inverse ny stages (the caller's 1/(ny*nz) folded into their table),
// gathers the row tile back, runs the inverse nz stages and writes the row
// tile it read.  Bound: bytes, 16 B a point read and written once and
// the spectrum once a launch (16 MiB at hp = 32, (256, 256)): the two 2-D
// FFTs of a 256 x 256 plane are ~1.3 Mflop for 1 MB of traffic.  Each
// block writes only what it read, so the output may alias the input.
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

constexpr int kConjData = 1;
constexpr int kXpow = 2;

// Two blocks an SM: the bound holds the kernel to 64 registers without
// spills (87 without it, one 512-thread block an SM: 1.46x the time at
// 256 planes of 256 x 256 on an H100 80GB HBM3 at 700 W; PERF.md).
__global__ void __launch_bounds__(512, 2)
fft_conv2d_kernel(const float* xr, const float* xi, float* yr, float* yi,
                  int hp, int flags, Plan pzf, Plan pyf, Plan pyi, Plan pzi,
                  const float2* tzf, const float2* tyf, const float2* tyi,
                  const float2* tzi, const float2* spec) {
  extern __shared__ __align__(16) float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ny = pyf.n, nz = pzf.n;
  const int rows = ny / C;       // row tile: rows [r0, r0 + rows), all nz columns
  const int cols = nz / C;       // column tile: columns [c0, c0 + cols), all ny rows
  const int count = rows * nz;   // == ny * cols
  const int r0 = rank * rows, c0 = rank * cols;
  const long long plane = blockIdx.x / C;
  const long long base = plane * ny * nz + (long long)r0 * nz;
  float2* a = smem;
  float2* b = smem + count;

  // the row tile, then the nz stages along its rows
  vkfft::load_tile(xr, xi, base, nz, rows, nz, nz, a);
  __syncthreads();
  float2* f = vkfft::run_stages<false>(a, b, rows, nz, 1, pzf, tzf);
  cluster.sync();   // every block's rows are done

  // gather the column tile out of every block's row tile
  float2* ct = f == a ? b : a;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int ky = t / cols;
    const int owner = ky / rows;
    const float2* src = cluster.map_shared_rank(f, owner);
    ct[t] = src[(ky - owner * rows) * nz + c0 + (t - ky * cols)];
  }
  cluster.sync();   // every gather is done: the row buffers are free

  // the ny stages down the columns, the multiply, the inverse ny stages
  float2* g = vkfft::run_stages<true>(ct, f, cols, 1, cols, pyf, tyf);
  const float2* h_spec = spec + (plane % hp) * ny * nz;
  const bool conj = flags & kConjData, xpow = flags & kXpow;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int ky = t / cols;
    float2 x = g[t];
    if (conj) x.y = -x.y;
    float2 y = cmul(x, __ldg(&h_spec[ky * nz + c0 + (t - ky * cols)]));
    if (xpow) {
      const float s = 1.f / fmaxf(sqrtf(y.x * y.x + y.y * y.y), 1e-30f);
      y = make_float2(y.x * s, y.y * s);
    }
    g[t] = y;
  }
  __syncthreads();
  float2* h = vkfft::run_stages<true>(g, g == ct ? f : ct, cols, 1, cols, pyi, tyi);
  cluster.sync();   // every block's columns are done

  // gather the row tile back out of every block's column tile
  float2* rt = h == a ? b : a;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int r = t / nz;
    const int js = t - r * nz;
    const int owner = js / cols;
    const float2* src = cluster.map_shared_rank(h, owner);
    rt[t] = src[(r0 + r) * cols + js - owner * cols];
  }
  cluster.sync();   // every gather is done: the column buffers are free

  // the inverse nz stages, then the row tile back where it was read
  const float2* o = vkfft::run_stages<false>(rt, h, rows, nz, 1, pzi, tzi);
  vkfft::store_tile(o, yr, yi, base, nz, rows, nz, nz);
}

// Cluster launch of `kernel` over `batch` planes of `cluster` blocks each,
// with `smem` bytes of dynamic shared memory a block.
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, long long batch, int cluster, int count,
                   size_t smem, void* stream, Args... args) {
  if (smem > (size_t)vkfft::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (batch * cluster > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (cluster > 8) {   // above the portable cluster size
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool cluster_ok(int cluster, int a, int b) {
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
          cluster == 16) && a % cluster == 0 && b % cluster == 0;
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
  if (!cluster_ok(cluster, pcf.n, psf.n)) return (int)cudaErrorInvalidValue;
  const int count = (int)(m / cluster);
  return launch_cluster(
      fft_conv_pair_kernel, batch, cluster, count, 2 * (size_t)count * sizeof(float2),
      stream, xr, xi, yr, yi, n, pcf, psf, psi, pci,
      reinterpret_cast<const float2*>(table_cf), reinterpret_cast<const float2*>(table_sf),
      reinterpret_cast<const float2*>(table_si), reinterpret_cast<const float2*>(table_ci),
      reinterpret_cast<const float2*>(twiddle), reinterpret_cast<const float2*>(spectrum),
      reinterpret_cast<const float2*>(chirp));
}

// The 2-D mode; returns as vk_fft_conv_pair.  `batch` planes of (ny, nz)
// points; plans (int form) and stage tables of the nz forward, ny forward,
// ny inverse (the caller's scale in its table) and nz inverse runs;
// `spectrum` the (hp, ny, nz) table in natural order, interleaved fp32
// pairs, plane b multiplied by spectrum b % hp; `flags` kConjData |
// kXpow; `cluster` blocks share each plane and must divide ny and nz.
int vk_fft_conv2d(const float* xr, const float* xi, float* yr, float* yi,
                  long long batch, int hp, int flags, const int* plan_zf,
                  const int* plan_yf, const int* plan_yi, const int* plan_zi,
                  const float* table_zf, const float* table_yf,
                  const float* table_yi, const float* table_zi,
                  const float* spectrum, int cluster, void* stream) {
  Plan pzf, pyf, pyi, pzi;
  if (batch < 1 || hp < 1 || (flags & ~(kConjData | kXpow)) ||
      spectrum == nullptr || !vkfft::plan_from_ints(plan_zf, &pzf) ||
      !vkfft::plan_from_ints(plan_yf, &pyf) || !vkfft::plan_from_ints(plan_yi, &pyi) ||
      !vkfft::plan_from_ints(plan_zi, &pzi))
    return (int)cudaErrorInvalidValue;
  if (pzf.n != pzi.n || pyf.n != pyi.n || pzf.inverse || pyf.inverse ||
      !pyi.inverse || !pzi.inverse || !cluster_ok(cluster, pyf.n, pzf.n))
    return (int)cudaErrorInvalidValue;
  const int count = pyf.n / cluster * pzf.n;
  return launch_cluster(
      fft_conv2d_kernel, batch, cluster, count, 2 * (size_t)count * sizeof(float2),
      stream, xr, xi, yr, yi, hp, flags, pzf, pyf, pyi, pzi,
      reinterpret_cast<const float2*>(table_zf), reinterpret_cast<const float2*>(table_yf),
      reinterpret_cast<const float2*>(table_yi), reinterpret_cast<const float2*>(table_zi),
      reinterpret_cast<const float2*>(spectrum));
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
