// The staged pieces of fft_dct1.cu, built for sm_90a on top of
// stockham.cuh and r2c.cuh (fft_dct23.cu and fft_dct4.cu run on the
// in-place walk: dct_walk.cuh).
//
// A block stages its lines of real (B, n) input in shared memory as floats
// (one contiguous run), builds the complex sequences of its transform from
// them (the DCT-I/DST-I extension: free shared-memory indexing here, where
// the TPU kernel runs zero-padded pipelines because Mosaic cannot
// shuffle), runs the Stockham stages, combines the spectrum into real
// outputs in the other buffer and writes them back as one contiguous run.
#pragma once

#include "r2c.cuh"

namespace vkfft {

// Lines a block: about 2048 complex points of state, at least one.
__host__ __device__ inline int r2r_lines_per_block(int points) {
  return points >= 2048 ? 1 : 2048 / points;
}

// count floats of device memory from offset `base` into smem, as float4s
// where count is a multiple of 4 and both ends are 16-byte aligned (odd n
// leaves a block's run unaligned; the scalar loop is still coalesced).
// Every thread of the block must call it.
__device__ __forceinline__ void load_floats(const float* x, long long base,
                                            int count, float* smem) {
  const float* src = x + base;
  if ((count & 3) == 0 && (((uintptr_t)src | (uintptr_t)smem) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(smem);
#pragma unroll 4
    for (int t = threadIdx.x; t < count / 4; t += blockDim.x) d4[t] = s4[t];
    return;
  }
  for (int t = threadIdx.x; t < count; t += blockDim.x) smem[t] = src[t];
}

__device__ __forceinline__ void store_floats(const float* smem, float* y,
                                             long long base, int count) {
  float* dst = y + base;
  if ((count & 3) == 0 && (((uintptr_t)dst | (uintptr_t)smem) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(smem);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (int t = threadIdx.x; t < count / 4; t += blockDim.x) d4[t] = s4[t];
    return;
  }
  for (int t = threadIdx.x; t < count; t += blockDim.x) dst[t] = smem[t];
}

// Host-side checks and launch geometry: `points` float2 of state a line,
// two buffers of `lpb` lines.
template <typename K>
int r2r_prepare(K kernel, long long batch, int points, int* lpb, size_t* smem,
                long long* blocks) {
  if (batch < 1) return (int)cudaErrorInvalidValue;
  *lpb = r2r_lines_per_block(points);
  *smem = 2 * (size_t)(*lpb) * points * sizeof(float2);
  if (*smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (*smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (e != cudaSuccess) return (int)e;
  }
  *blocks = (batch + *lpb - 1) / *lpb;
  if (*blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace vkfft
