// fft_pair: 2-D C2C FFT of the two minor axes of (B, ny, nz) fp32 re/im
// planes in one pass, natural order in and out, scale folded into the
// y-axis stage-0 twiddles.  Replaces vkfft_tpu/ops/pallas_engine.py:1982
// _pair_kernel (plain fp32 form: no zero-pad windows, no tl layout).
//
// Bound: bytes, one read and one write of each point (16 B of planes) for
// both axes together, where two axis passes move twice that.
// Design: the TPU kernel holds a whole plane in VMEM; a 256 x 256 plane is
// 512 KB, more than one block's shared memory.  Here a thread-block
// cluster of C blocks (C = 1, 2, 4, 8 or 16, chosen by the caller: about
// 32 KB a block where 16 blocks suffice, 64 KB a block at 256 x 256, at
// most 128 KB) holds the plane in its blocks' shared memory together: block `rank` loads rows [rank*ny/C, (rank+1)*ny/C) with
// coalesced row reads and runs the z stages on them (stockham.cuh, lines
// layout).  After a cluster barrier each block gathers its ny x nz/C column
// tile out of all C blocks' shared memory over distributed shared memory,
// a second cluster barrier frees the row buffers, and the block runs the
// y stages on its tile (strided layout) and writes the tile back, nz/C
// contiguous floats per row and plane.  The plane crosses device memory
// once each way.  Every read of a plane precedes the first barrier and
// every write follows it, so the output may alias the input.
#include <cooperative_groups.h>

#include "stockham.cuh"

namespace cg = cooperative_groups;

namespace {

using vkfft::Plan;

__global__ void __launch_bounds__(512)
fft_pair_kernel(const float* xr, const float* xi, float* yr, float* yi, Plan py,
                Plan pz, const float2* ty, const float2* tz) {
  extern __shared__ __align__(16) float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ny = py.n, nz = pz.n;
  const int rows = ny / C;       // rows of the plane this block transforms
  const int cols = nz / C;       // columns of the plane this block transforms
  const int count = rows * nz;   // == ny * cols
  const long long base = (long long)(blockIdx.x / C) * ny * nz;
  float2* a = smem;
  float2* b = smem + count;

  const long long rbase = base + (long long)rank * rows * nz;
  vkfft::load_tile(xr, xi, rbase, nz, rows, nz, nz, a);
  __syncthreads();
  float2* zres = vkfft::run_stages<false>(a, b, rows, nz, 1, pz, tz);
  float2* tile = zres == a ? b : a;
  cluster.sync();   // every block's rows are transformed

  const int c0 = rank * cols;
  if ((cols & 1) == 0) {
    // two points (16 bytes) per read, unrolled: more reads in flight
    const int h = cols >> 1;
    const int total = ny * h;
#pragma unroll 4
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int k = t / h;
      const int c = (t - k * h) << 1;
      const int owner = k / rows;
      const float2* src = cluster.map_shared_rank(zres, owner);
      *reinterpret_cast<float4*>(tile + k * cols + c) =
          *reinterpret_cast<const float4*>(src + (k - owner * rows) * nz + c0 + c);
    }
  } else {
    for (int t = threadIdx.x; t < count; t += blockDim.x) {
      const int k = t / cols;
      const int c = t - k * cols;
      const int owner = k / rows;
      const float2* src = cluster.map_shared_rank(zres, owner);
      tile[t] = src[(k - owner * rows) * nz + c0 + c];
    }
  }
  cluster.sync();   // every gather is done: the row buffers are free

  const float2* res = vkfft::run_stages<true>(tile, zres, cols, 1, cols, py, ty);
  vkfft::store_tile(res, yr, yi, base + c0, nz, ny, cols, cols);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  `plan_y`/`plan_z` are the int forms of vkfft::Plan and
// `table_y`/`table_z` the device twiddle tables as interleaved (re, im)
// fp32 pairs, one per axis; `cluster` blocks share each plane and must
// divide ny and nz.
int vk_fft_pair(const float* xr, const float* xi, float* yr, float* yi,
                long long planes, const int* plan_y, const int* plan_z,
                const float* table_y, const float* table_z, int cluster,
                void* stream) {
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
        fft_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (cluster > 8) {   // above the portable cluster size
    cudaError_t e = cudaFuncSetAttribute(
        fft_pair_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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
  cudaError_t e = cudaLaunchKernelEx(&cfg, fft_pair_kernel, xr, xi, yr, yi, py, pz,
                                     reinterpret_cast<const float2*>(table_y),
                                     reinterpret_cast<const float2*>(table_z));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
