// Thread-block cluster pieces shared by fft_pair.cu, fft_r2c_pair.cu and
// fft_conv_pair.cu, built for sm_90a: distributed shared memory by 32-bit
// shared::cluster addresses, the block's plane and rank, a plane's tables,
// and the cluster launch.
//
// A plane held once over a cluster moves between its blocks' tiles in
// whole rounds: each thread holds at most kXchg points of an exchange in
// registers through a cluster barrier (one copy of the plane leaves no
// place to gather into).  Remote points go by 32-bit shared::cluster
// addresses (mapa): a generic 64-bit pointer a point held two registers
// more through the exchange's reads, and ptxas spilled.
#pragma once

#include <cuda_runtime.h>

#include "stockham.cuh"

namespace vkfft {
namespace cluster {

constexpr int kXchg = 16;   // most points a thread moves in an exchange

// Point i of block `rank`'s buffer as a shared::cluster address.
template <class C>
__device__ __forceinline__ unsigned remote(const C* buf, int i, int rank) {
  const unsigned local = (unsigned)__cvta_generic_to_shared(buf + i);
  unsigned a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(local), "r"(rank));
  return a;
}

__device__ __forceinline__ float2 ld_remote2(unsigned a) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_remote4(unsigned a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_remote2(unsigned a, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};"
               :: "r"(a), "f"(v.x), "f"(v.y) : "memory");
}

// One fp64 point (16 bytes) to a shared::cluster address.
__device__ __forceinline__ void st_remote2(unsigned a, double2 v) {
  asm volatile("st.shared::cluster.v2.f64 [%0], {%1, %2};"
               :: "r"(a), "d"(v.x), "d"(v.y) : "memory");
}

__device__ __forceinline__ void st_remote4(unsigned a, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// The block's plane and its rank in the cluster, read afresh where they
// are used (computed once, they lived through the passes).
__device__ __forceinline__ long long plane_index() {
  unsigned b, c;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(c));
  return (long long)(b / c);
}

__device__ __forceinline__ int block_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

// A plane kernel's tables into shared memory at `tab`, as its Geo places
// them: the stage tables of the factors z1, z2, y1, y2 (z1's at 0), then
// the z and the y twiddles (fft_r2c_pair.cu, fft_conv_pair.cu's 2-D mode).
template <class Geo>
__device__ __forceinline__ void copy_plane_tables(
    float2* tab, const Geo& geo, const float2* tz1, const float2* tz2,
    const float2* ty1, const float2* ty2, const float2* twz,
    const float2* twy) {
  for (int t = threadIdx.x; t < geo.ntab; t += blockDim.x) {
    const float2* src = t < geo.z2    ? tz1 + t
                        : t < geo.y1  ? tz2 + (t - geo.z2)
                        : t < geo.y2  ? ty1 + (t - geo.y1)
                        : t < geo.twz ? ty2 + (t - geo.y2)
                        : t < geo.twy ? twz + (t - geo.twz)
                                      : twy + (t - geo.twy);
    tab[t] = __ldg(src);
  }
}

// Whether `cluster` (1, 2, 4, 8 or 16 blocks) divides both a and b.
inline bool cluster_ok(int cluster, int a, int b) {
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
          cluster == 16) && a % cluster == 0 && b % cluster == 0;
}

// The attributes a launch of `kernel` at `smem` dynamic shared bytes and
// `cluster` blocks a cluster needs.
template <typename Kernel>
int cluster_attrs(Kernel kernel, int cluster, size_t smem) {
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
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
  return 0;
}

inline cudaLaunchConfig_t cluster_config(long long batch, int cluster,
                                         int threads, size_t smem,
                                         void* stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * cluster), 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Cluster launch of `kernel` over `batch` planes of `cluster` blocks of
// `threads` each, with `smem` bytes of dynamic shared memory a block.
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, long long batch, int cluster, int threads,
                   size_t smem, void* stream, Args... args) {
  if (batch * cluster > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int err = cluster_attrs(kernel, cluster, smem);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(batch, cluster, threads, smem, stream, attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Resident clusters on the card and blocks an SM of `kernel` at `cluster`
// blocks of `threads` with `smem` dynamic shared bytes.
template <typename Kernel>
int cluster_occupancy(Kernel kernel, int cluster, int threads, int smem,
                      int* clusters, int* blocks) {
  int err = cluster_attrs(kernel, cluster, (size_t)smem);
  if (err) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, (size_t)smem);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(1, cluster, threads, (size_t)smem, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace cluster
}  // namespace vkfft
