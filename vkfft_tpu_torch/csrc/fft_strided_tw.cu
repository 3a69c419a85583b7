// fft_strided_tw: the factor mode of the strided pass.  C2C FFT along the
// middle dim of (P, n, S) fp32 re/im planes, natural order in and out, with
// the input multiplied point by point by a `pre` factor on the read and the
// output by a `post` factor on the write, and the scale folded into the
// stage-0 twiddles.  Replaces vkfft_tpu/ops/pallas_engine.py:3439
// _strided_kernel (the two-factor strided kernel of the long tier with its
// n_pre/n_post factor products) and the factor-table option of :3489
// _strided_kernel_v3 (factors_pre/factors_post, in_keep/out_keep).
//
// Factors.  Each is exp(sign * 2 pi i * e / N) with an integer exponent e
// of the point (p, row, s):
//   kind 1, the four-step twiddle: e = (row * a + (p mod pm) * b) * (s / sd)
//     (two uploads: w_N^(kc*js), a = 1; three uploads, pass 1:
//     w_(NaNb)^(ka*jb) with jb = s / Ns, sd = Ns; pass 2:
//     w_N^((kb*Na + ka)*js), a = pm = Na, b = 1);
//   kind 2, the Bluestein chirp exp(-+ i pi j^2 / n): e = j^2 mod N, N = 2n,
//     j = row * S + s the point's index in its line (64-bit: j < 2^32).
// Neither is a table.  The kernel computes each factor from its exact
// 64-bit integer exponent: r = e / N in fp64 (e < 2^53), reduced to
// [-1/2, 1/2] in fp64, then sincospif(2 r) in fp32.  The fp32 argument
// carries an absolute error of at most 2^-26, so a factor is within about
// 1e-7 of its fp64 value at every N (an fp32 angle formed before the
// reduction loses digits once e passes 2^24); an O(n) table would be
// 512 MiB at n = 2^26 and a second read stream.  The cost is a few integer
// and fp64 operations and one fp32 sincospi a point and factor.
//
// Live lengths.  Plane p starts at p * in_len floats of the input and
// p * out_len of the output; a point of index j = row * S + s >= in_len is
// read as zero and one >= out_len is not written.  With in_len = out_len =
// n * S this is the (P, n, S) layout; the Bluestein passes read an (B, n)
// line as the first n points of an (nc, ns) plane and write only the first
// n points back, so no pad or crop exists in device memory.
//
// Interleave.  With d = in_pd (out_pd) > 1 the planes p = b * d + q are
// stored row by row interleaved, point (row, s) of plane p at
// b * d * n * S + row * d * S + q * S + s: the three-upload second pass
// writes (B, Nb, Na, Ns) from its (B * Na, Nb, Ns) planes, so the middle
// digits come out in natural order and the four-step reorder is the same
// transpose as two uploads' (and the inverse reads it back).
//
// Bound: bytes, one read and one write of each live point (16 B of
// planes).  Design as fft_strided.cu: a block takes a tile of ts
// neighbouring columns of one p across all n rows (ts = min(32, 4096/n)),
// so each row of the tile is a run of ts contiguous floats per plane, runs
// the Stockham stages of stockham.cuh in shared memory with the column
// index fastest across threads, and applies the factors as the tile is
// read and written (float4 moves where S, the tile, the live lengths and
// the planes' alignment allow).  The grid is 1-D over P * tiles, offsets
// are 64-bit, and a block reads its whole tile before it writes, so the
// output may alias the input when in_len = out_len.
#include "stockham.cuh"

namespace {

using vkfft::Plan;

struct Factor {
  int kind;          // 0: none, 1: four-step twiddle, 2: chirp
  float sign;        // -1: forward, +1: inverse
  long long N, a, pm, b, sd;
  double inv_n;      // 1 / N
};

int tile_columns(int n, long long S) {
  int ts = 4096 / n;
  if (ts > 32) ts = 32;
  if (ts < 1) ts = 1;
  if (ts > S) ts = (int)S;
  return ts;
}

// The factor of point (row, s) of plane p; `pterm` = (p mod pm) * b.
__device__ __forceinline__ float2 factor_at(const Factor& f, long long pterm,
                                            long long row, long long s,
                                            long long S) {
  unsigned long long e;
  if (f.kind == 1) {
    const long long col = f.sd == 1 ? s : s / f.sd;
    e = (unsigned long long)(row * f.a + pterm) * (unsigned long long)col;
  } else {
    const unsigned long long j = (unsigned long long)(row * S + s);
    e = (j * j) % (unsigned long long)f.N;
  }
  double r = (double)e * f.inv_n;
  r -= rint(r);
  float sn, cs;
  sincospif(2.0f * (float)r, &sn, &cs);
  return make_float2(cs, f.sign * sn);
}

__device__ __forceinline__ bool aligned16(const float* a, const float* b) {
  return (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
}

// Tile (n rows, ts columns from s0, `cols` of them inside S) of plane p
// into smem[row * ts + c], times the pre factor, zero where the column is
// past S or the point past the live length; planes interleaved by pd.
__device__ void load_factored(const float* xr, const float* xi, long long p,
                              long long len, long long pd, long long S,
                              long long s0, int n, int ts, int cols,
                              const Factor& f, float2* smem) {
  const long long base = (p / pd) * pd * len + (p % pd) * S;
  const long long rs = pd * S;
  const long long pterm = f.kind == 1 ? (p % f.pm) * f.b : 0;
  if ((((long long)ts | S | s0 | len) & 3) == 0 && aligned16(xr, xi)) {
    const int w4 = ts >> 2;
    const int total = n * w4;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int k = t / w4;
      const int c = (t - k * w4) << 2;
      const long long j = (long long)k * S + s0 + c;
      const long long g = base + (long long)k * rs + s0 + c;
      float2 v[4];
      if (c < cols && j < len) {
        const float4 r = *reinterpret_cast<const float4*>(xr + g);
        const float4 i = *reinterpret_cast<const float4*>(xi + g);
        v[0] = make_float2(r.x, i.x);
        v[1] = make_float2(r.y, i.y);
        v[2] = make_float2(r.z, i.z);
        v[3] = make_float2(r.w, i.w);
        if (f.kind) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[q] = vkfft::cmul(v[q], factor_at(f, pterm, k, s0 + c + q, S));
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = make_float2(0.f, 0.f);
      }
      float2* d = smem + k * ts + c;
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] = v[q];
    }
    return;
  }
  const int total = n * ts;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int k = t / ts;
    const int c = t - k * ts;
    const long long j = (long long)k * S + s0 + c;
    const long long g = base + (long long)k * rs + s0 + c;
    float2 v = make_float2(0.f, 0.f);
    if (c < cols && j < len) {
      v = make_float2(xr[g], xi[g]);
      if (f.kind) v = vkfft::cmul(v, factor_at(f, pterm, k, s0 + c, S));
    }
    smem[t] = v;
  }
}

// The mirror of load_factored: the tile times the post factor, written
// where the column is inside S and the point inside the live length.
__device__ void store_factored(const float2* smem, float* yr, float* yi,
                               long long p, long long len, long long pd,
                               long long S, long long s0, int n, int ts,
                               int cols, const Factor& f) {
  const long long base = (p / pd) * pd * len + (p % pd) * S;
  const long long rs = pd * S;
  const long long pterm = f.kind == 1 ? (p % f.pm) * f.b : 0;
  if ((((long long)ts | S | s0 | len) & 3) == 0 && aligned16(yr, yi)) {
    const int w4 = ts >> 2;
    const int total = n * w4;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int k = t / w4;
      const int c = (t - k * w4) << 2;
      const long long j = (long long)k * S + s0 + c;
      if (c < cols && j < len) {
        const long long g = base + (long long)k * rs + s0 + c;
        const float2* s = smem + k * ts + c;
        float2 v[4] = {s[0], s[1], s[2], s[3]};
        if (f.kind) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[q] = vkfft::cmul(v[q], factor_at(f, pterm, k, s0 + c + q, S));
        }
        *reinterpret_cast<float4*>(yr + g) =
            make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
        *reinterpret_cast<float4*>(yi + g) =
            make_float4(v[0].y, v[1].y, v[2].y, v[3].y);
      }
    }
    return;
  }
  const int total = n * ts;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int k = t / ts;
    const int c = t - k * ts;
    const long long j = (long long)k * S + s0 + c;
    if (c < cols && j < len) {
      const long long g = base + (long long)k * rs + s0 + c;
      float2 v = smem[t];
      if (f.kind) v = vkfft::cmul(v, factor_at(f, pterm, k, s0 + c, S));
      yr[g] = v.x;
      yi[g] = v.y;
    }
  }
}

__global__ void __launch_bounds__(512)
fft_strided_tw_kernel(const float* xr, const float* xi, float* yr, float* yi,
                      long long S, long long in_len, long long out_len,
                      long long in_pd, long long out_pd, int ts,
                      long long tiles, Plan p, const float2* table, Factor pre,
                      Factor post) {
  extern __shared__ float2 smem[];
  const int n = p.n;
  const long long blk = blockIdx.x;
  const long long pi = blk / tiles;
  const long long s0 = (blk - pi * tiles) * ts;
  const int cols = (int)min((long long)ts, S - s0);
  float2* a = smem;
  float2* b = smem + n * ts;
  load_factored(xr, xi, pi, in_len, in_pd, S, s0, n, ts, cols, pre, a);
  __syncthreads();
  const float2* res = vkfft::run_stages<true>(a, b, ts, 1, ts, p, table);
  store_factored(res, yr, yi, pi, out_len, out_pd, S, s0, n, ts, cols, post);
}

// Factor from its host form: kind, sign, N, a, pm, b, sd.
bool factor_from(const long long* v, Factor* f) {
  f->kind = (int)v[0];
  f->sign = v[1] < 0 ? -1.f : 1.f;
  f->N = v[2];
  f->a = v[3];
  f->pm = v[4];
  f->b = v[5];
  f->sd = v[6];
  if (f->kind == 0) {
    f->N = f->pm = f->sd = 1;
    f->inv_n = 1.0;
    return true;
  }
  if (f->kind != 1 && f->kind != 2) return false;
  if (f->N < 1 || f->pm < 1 || f->sd < 1 || f->a < 0 || f->b < 0) return false;
  f->inv_n = 1.0 / (double)f->N;
  return true;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  Arguments as for vk_fft_strided, with the live lengths (and
// per-plane strides) in_len and out_len, each at most n * S, `factors`
// the pre and the post factor as 7 long longs each (kind, sign, N, a, pm,
// b, sd), and the input's and the output's plane interleave in_pd and
// out_pd (1: none; more only for whole (n, S) planes, P a multiple).
int vk_fft_strided_tw(const float* xr, const float* xi, float* yr, float* yi,
                      long long P, long long S, long long in_len,
                      long long out_len, const int* plan, const float* table,
                      const long long* factors, int in_pd, int out_pd,
                      void* stream) {
  Plan p;
  Factor pre, post;
  if (P < 1 || S < 1 || !vkfft::plan_from_ints(plan, &p) ||
      !factor_from(factors, &pre) || !factor_from(factors + 7, &post))
    return (int)cudaErrorInvalidValue;
  const long long points = (long long)p.n * S;
  if (in_len < 1 || in_len > points || out_len < 1 || out_len > points)
    return (int)cudaErrorInvalidValue;
  if (in_pd < 1 || out_pd < 1 || P % in_pd || P % out_pd ||
      (in_pd > 1 && in_len != points) || (out_pd > 1 && out_len != points))
    return (int)cudaErrorInvalidValue;
  const int ts = tile_columns(p.n, S);
  const size_t smem = 2 * (size_t)ts * p.n * sizeof(float2);
  if (smem > (size_t)vkfft::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fft_strided_tw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = (S + ts - 1) / ts;
  const long long blocks = P * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int threads = ts * p.n > 2048 ? 512 : 256;
  fft_strided_tw_kernel<<<(unsigned)blocks, threads, smem,
                          (cudaStream_t)stream>>>(
      xr, xi, yr, yi, S, in_len, out_len, in_pd, out_pd, ts, tiles, p,
      reinterpret_cast<const float2*>(table), pre, post);
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
