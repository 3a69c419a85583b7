// fft_strided: C2C FFT along the middle dim of (P, n, S) fp32 re/im planes,
// S contiguous, natural order in and out, scale folded into the stage-0
// twiddles.  Replaces vkfft_tpu/ops/pallas_engine.py:3489
// _strided_kernel_v3 (plain form: no factor tables, no in/out keeps).
//
// Bound: bytes, one read and one write of each point (16 B of planes).
// Design: a block takes a tile of ts neighbouring columns of one p across
// all n rows, so each row of the tile is a run of ts contiguous floats per
// plane in device memory, and transforms the ts columns in shared memory
// (stockham.cuh, column index fastest across threads).  Shared memory is
// 2 * n * ts * 8 bytes, so ts shrinks as n grows (32 at n <= 128, 16 at
// 256, 1 from 4096 up): a smaller ts means shorter contiguous runs per row
// and less of each 32-byte sector used per block; where ts, S and the
// tile's start are multiples of 4, each thread moves float4s
// (stockham.cuh).  The ragged last tile of
// S is masked; all offsets are 64-bit; the grid is 1-D over P * tiles, so
// P = 1 with a large S (the x axis of a cube) and a large P both fit.
// A block reads its whole tile before it writes, so output may alias input.
#include "stockham.cuh"

namespace {

using vkfft::Plan;

int tile_columns(int n, long long S) {
  int ts = 4096 / n;
  if (ts > 32) ts = 32;
  if (ts < 1) ts = 1;
  if (ts > S) ts = (int)S;
  return ts;
}

__global__ void __launch_bounds__(512)
fft_strided_kernel(const float* xr, const float* xi, float* yr, float* yi,
                   long long S, int ts, long long tiles, Plan p,
                   const float2* table) {
  extern __shared__ float2 smem[];
  const int n = p.n;
  const long long blk = blockIdx.x;
  const long long pi = blk / tiles;
  const long long s0 = (blk - pi * tiles) * ts;
  const int cols = (int)min((long long)ts, S - s0);
  const long long base = pi * (long long)n * S + s0;
  float2* a = smem;
  float2* b = smem + n * ts;
  vkfft::load_tile(xr, xi, base, S, n, ts, cols, a);
  __syncthreads();
  const float2* res = vkfft::run_stages<true>(a, b, ts, 1, ts, p, table);
  vkfft::store_tile(res, yr, yi, base, S, n, ts, cols);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  `plan` is the int form of vkfft::Plan, `table` the device
// twiddle table as interleaved (re, im) fp32 pairs, with the (P, n, S)
// extents.
int vk_fft_strided(const float* xr, const float* xi, float* yr, float* yi,
                   long long P, long long S, const int* plan,
                   const float* table, void* stream) {
  Plan p;
  if (P < 1 || S < 1 || !vkfft::plan_from_ints(plan, &p)) return (int)cudaErrorInvalidValue;
  const int ts = tile_columns(p.n, S);
  const size_t smem = 2 * (size_t)ts * p.n * sizeof(float2);
  if (smem > (size_t)vkfft::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fft_strided_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = (S + ts - 1) / ts;
  const long long blocks = P * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int threads = ts * p.n > 2048 ? 512 : 256;
  fft_strided_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, S, ts, tiles, p, reinterpret_cast<const float2*>(table));
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
