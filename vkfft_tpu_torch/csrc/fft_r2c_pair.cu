// fft_r2c_pair: 2-D real-to-complex FFT of the two minor axes of real
// (B, ny, nz) fp32 planes, nz even, into their (B, ny, nz/2+1) half
// spectrum (numpy rfft2 values), and the complex-to-real inverse, each in
// one pass.  Replaces vkfft_tpu/ops/pallas_engine.py:3204 _r2c_pair_kernel
// and :3229 _c2r_pair_kernel (host side: _build_r2c_pair_call,
// rfft2_pair_planar, irfft2_pair_planar).  The inverse's output is scaled
// by ny * scale_y * (nz/2) * scale_z, both folded into stage-0 twiddles:
// scale_y = 1/ny, scale_z = 2/nz give numpy's irfft2.
//
// Bound: bytes, one read of the real plane (4 B a point) and one write of
// the half spectrum (8 B a bin), or the reverse, for both axes together.
// Design, from fft_pair.cu: a thread-block cluster of C blocks holds one
// plane.  Forward: block `rank` reads rows [rank*ny/C, (rank+1)*ny/C) as
// z = x[2j] + i x[2j+1] (contiguous float4 moves), runs the nz/2-point
// stages and untangles each row in place into the packed layout of
// r2c.cuh.  After a cluster barrier it gathers its ny x (nz/2)/C column
// tile over distributed shared memory; a second barrier frees the row
// buffers; it runs the y stages on its columns and writes them.  The m+1
// spectrum columns do not split over C blocks, but columns 0 and m are
// real after the row pass (the TPU kernel's own observation,
// pallas_engine.py:3188-3196): they ride one complex column, slot 0 of the
// packed rows, DC + i Nyquist, through the y stages, and rank 0 splits
// them by Hermitian symmetry, Y[k] = A[k] + i B[k] with
// A = (Y[k] + conj Y[-k])/2, B = (Y[k] - conj Y[-k])/(2i).  The inverse
// runs the same steps backwards; it first keeps only the Hermitian parts
// of the DC and Nyquist columns, which is what numpy's irfft2 reads of
// them.  Spectrum rows of m+1 floats are not 16-byte aligned, so the
// spectrum moves as single floats, in runs of (nz/2)/C per row.
#include <cooperative_groups.h>

#include "r2c.cuh"

namespace cg = cooperative_groups;

namespace {

using vkfft::Plan;

__global__ void __launch_bounds__(512)
r2c_pair_kernel(const float* x, float* yr, float* yi, Plan py, Plan pz,
                const float2* ty, const float2* tz, int post_off) {
  extern __shared__ __align__(16) float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ny = py.n, m = pz.n, h = m + 1;
  const int rows = ny / C;       // rows of the plane this block transforms
  const int cols = m / C;        // packed columns this block transforms
  const int count = rows * m;    // == ny * cols
  const long long plane = blockIdx.x / C;
  float2* a = smem;
  float2* b = smem + count;

  vkfft::load_run(x, plane * ny * 2 * m + (long long)rank * rows * 2 * m,
                  count, a);
  __syncthreads();
  float2* zres = vkfft::run_stages<false>(a, b, rows, m, 1, pz, tz);
  vkfft::untangle<false>(zres, rows, m, tz + post_off);
  float2* tile = zres == a ? b : a;
  cluster.sync();   // every block's rows are transformed and untangled

  const int c0 = rank * cols;
  if ((cols & 1) == 0) {
    const int hc = cols >> 1;
    const int total = ny * hc;
#pragma unroll 4
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int k = t / hc;
      const int c = (t - k * hc) << 1;
      const int owner = k / rows;
      const float2* src = cluster.map_shared_rank(zres, owner);
      *reinterpret_cast<float4*>(tile + k * cols + c) =
          *reinterpret_cast<const float4*>(src + (k - owner * rows) * m + c0 + c);
    }
  } else {
    for (int t = threadIdx.x; t < count; t += blockDim.x) {
      const int k = t / cols;
      const int c = t - k * cols;
      const int owner = k / rows;
      const float2* src = cluster.map_shared_rank(zres, owner);
      tile[t] = src[(k - owner * rows) * m + c0 + c];
    }
  }
  cluster.sync();   // every gather is done: the row buffers are free

  float2* res = vkfft::run_stages<true>(tile, zres, cols, 1, cols, py, ty);
  float2* nyq = res == tile ? zres : tile;
  if (rank == 0) {
    // column 0 holds FFT_y(DC) + i FFT_y(Nyquist): split it
    for (int k = threadIdx.x; k <= ny / 2; k += blockDim.x) {
      const int k2 = k == 0 ? 0 : ny - k;
      const float2 y1 = res[k * cols], y2 = res[k2 * cols];
      const float2 A = make_float2(0.5f * (y1.x + y2.x), 0.5f * (y1.y - y2.y));
      const float2 B = make_float2(0.5f * (y1.y + y2.y), -0.5f * (y1.x - y2.x));
      res[k * cols] = A;
      res[k2 * cols] = make_float2(A.x, -A.y);
      nyq[k] = B;
      nyq[k2] = make_float2(B.x, -B.y);
    }
    __syncthreads();
  }
  const long long obase = plane * ny * h;
  vkfft::store_tile(res, yr, yi, obase + c0, h, ny, cols, cols);
  if (rank == 0) {
    for (int k = threadIdx.x; k < ny; k += blockDim.x) {
      yr[obase + (long long)k * h + m] = nyq[k].x;
      yi[obase + (long long)k * h + m] = nyq[k].y;
    }
  }
}

__global__ void __launch_bounds__(512)
c2r_pair_kernel(const float* xr, const float* xi, float* y, Plan py, Plan pz,
                const float2* ty, const float2* tz, int post_off) {
  extern __shared__ __align__(16) float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ny = py.n, m = pz.n, h = m + 1;
  const int rows = ny / C;
  const int cols = m / C;
  const int count = rows * m;
  const long long plane = blockIdx.x / C;
  float2* a = smem;
  float2* b = smem + count;

  const int c0 = rank * cols;
  const long long ibase = plane * ny * h;
  vkfft::load_tile(xr, xi, ibase + c0, h, ny, cols, cols, a);
  if (rank == 0) {
    for (int k = threadIdx.x; k < ny; k += blockDim.x)
      b[k] = make_float2(xr[ibase + (long long)k * h + m],
                         xi[ibase + (long long)k * h + m]);
    __syncthreads();
    // column 0 := A + i B, A and B the Hermitian parts of the DC and
    // Nyquist columns, so that their y inverses come out real
    for (int k = threadIdx.x; k <= ny / 2; k += blockDim.x) {
      const int k2 = k == 0 ? 0 : ny - k;
      const float2 a1 = a[k * cols], a2 = a[k2 * cols];
      const float2 b1 = b[k], b2 = b[k2];
      const float2 A = make_float2(0.5f * (a1.x + a2.x), 0.5f * (a1.y - a2.y));
      const float2 B = make_float2(0.5f * (b1.x + b2.x), 0.5f * (b1.y - b2.y));
      a[k * cols] = make_float2(A.x - B.y, A.y + B.x);
      a[k2 * cols] = make_float2(A.x + B.y, B.x - A.y);
    }
  }
  __syncthreads();
  float2* res = vkfft::run_stages<true>(a, b, cols, 1, cols, py, ty);
  float2* rowbuf = res == a ? b : a;
  cluster.sync();   // every block's columns are transformed along y

  const int r0 = rank * rows;
  if ((cols & 1) == 0) {
    const int hm = m >> 1;
    const int total = rows * hm;
#pragma unroll 4
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int k = t / hm;
      const int c = (t - k * hm) << 1;
      const int owner = c / cols;
      const float2* src = cluster.map_shared_rank(res, owner);
      *reinterpret_cast<float4*>(rowbuf + k * m + c) =
          *reinterpret_cast<const float4*>(src + (r0 + k) * cols + c - owner * cols);
    }
  } else {
    for (int t = threadIdx.x; t < count; t += blockDim.x) {
      const int k = t / m;
      const int c = t - k * m;
      const int owner = c / cols;
      const float2* src = cluster.map_shared_rank(res, owner);
      rowbuf[t] = src[(r0 + k) * cols + c - owner * cols];
    }
  }
  cluster.sync();   // every gather is done: the column buffers are free

  vkfft::untangle<true>(rowbuf, rows, m, tz + post_off);
  __syncthreads();
  const float2* out = vkfft::run_stages<false>(rowbuf, res, rows, m, 1, pz, tz);
  vkfft::store_run(out, y, plane * ny * 2 * m + (long long)r0 * 2 * m, count);
}

// Shared checks and launch of both directions.
template <typename K>
int launch(K kernel, const float* p0, const float* p1, float* q0, float* q1,
           long long planes, const int* plan_y, const int* plan_z,
           const float* table_y, const float* table_z, int post_off,
           int cluster, void* stream, bool forward) {
  Plan py, pz;
  if (planes < 1 || !vkfft::plan_from_ints(plan_y, &py) ||
      !vkfft::plan_from_ints(plan_z, &pz))
    return (int)cudaErrorInvalidValue;
  if (!(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
        cluster == 16) ||
      py.n % cluster || pz.n % cluster)
    return (int)cudaErrorInvalidValue;
  const int count = py.n / cluster * pz.n;
  const size_t smem = 2 * (size_t)count * sizeof(float2);
  if (smem > (size_t)vkfft::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (planes * cluster > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
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
  cfg.gridDim = dim3((unsigned)(planes * cluster), 1, 1);
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
  const float2* ty = reinterpret_cast<const float2*>(table_y);
  const float2* tz = reinterpret_cast<const float2*>(table_z);
  cudaError_t e = forward
      ? cudaLaunchKernelEx(&cfg, r2c_pair_kernel, p0, q0, q1, py, pz, ty, tz, post_off)
      : cudaLaunchKernelEx(&cfg, c2r_pair_kernel, p0, p1, q0, py, pz, ty, tz, post_off);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() after the launch (0 on
// success).  `plan_y` is the ny-point plan and `table_y` its table;
// `plan_z` the nz/2-point plan and `table_z` its table followed, at float2
// offset `post_off`, by w^k = e^{-2 pi i k / nz} for k <= nz/4.  `cluster`
// blocks share each plane and must divide ny and nz/2.
int vk_fft_r2c_pair(const float* x, float* yr, float* yi, long long planes,
                    const int* plan_y, const int* plan_z, const float* table_y,
                    const float* table_z, int post_off, int cluster,
                    void* stream) {
  return launch(r2c_pair_kernel, x, nullptr, yr, yi, planes, plan_y, plan_z,
                table_y, table_z, post_off, cluster, stream, true);
}

int vk_fft_c2r_pair(const float* xr, const float* xi, float* y, long long planes,
                    const int* plan_y, const int* plan_z, const float* table_y,
                    const float* table_z, int post_off, int cluster,
                    void* stream) {
  return launch(c2r_pair_kernel, xr, xi, y, nullptr, planes, plan_y, plan_z,
                table_y, table_z, post_off, cluster, stream, false);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
