// Real-to-real pieces shared by fft_dct23.cu, fft_dct1.cu and fft_dct4.cu,
// built for sm_90a on top of stockham.cuh and r2c.cuh.
//
// Every R2R kernel of the port has one shape: a block stages its lines of
// real (B, n) input in shared memory as floats (one contiguous run), builds
// the complex sequences of its transform from them (a permutation, a
// reversal, a virtual extension or a pre-rotation: free shared-memory
// indexing here, where the TPU kernels run zero-padded 2n-point pipelines
// because Mosaic cannot shuffle), runs the Stockham stages, combines the
// spectrum into real outputs in the other buffer and writes them back as
// one contiguous run.  The DST of each type is the DCT kernel with a flag
// that flips signs and reverses indices on the way in or out.
#pragma once

#include "r2c.cuh"

namespace vkfft {

// Lines (or pairs of lines) per block: about 2048 complex points of state,
// at least one.
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

// (-1)^j as a float.
__device__ __forceinline__ float alt_sign(int j) { return (j & 1) ? -1.f : 1.f; }

// Re(a * b).
__device__ __forceinline__ float re_mul(float2 a, float2 b) {
  return a.x * b.x - a.y * b.y;
}

// Shared host-side checks and launch geometry of the R2R kernels: `points`
// float2 of state per line (or pair), two buffers of `lpb` of them.
template <typename K>
int r2r_prepare(K kernel, long long batch, int units_per_block_of_lines,
                int points, int* lpb, size_t* smem, long long* blocks) {
  if (batch < 1) return (int)cudaErrorInvalidValue;
  *lpb = r2r_lines_per_block(points);
  *smem = 2 * (size_t)(*lpb) * points * sizeof(float2);
  if (*smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (*smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long per = (long long)(*lpb) * units_per_block_of_lines;
  *blocks = (batch + per - 1) / per;
  if (*blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace vkfft
