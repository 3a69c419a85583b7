// fft_strided_tw: the factor mode of the strided pass.  C2C FFT along the
// middle dim of (P, n, S) fp32 re/im planes, natural order in and out, with
// the input multiplied point by point by a `pre` factor after the read and
// the output by a `post` factor on the write, times a scale (in the
// twiddle's table); or with the tile read from, or written to, the
// transposed (P, S, n) layout.  Replaces vkfft_tpu/ops/pallas_engine.py:3439
// _strided_kernel (the two-factor strided kernel of the long tier with its
// n_pre/n_post factor products) and the factor-table option of :3489
// _strided_kernel_v3 (factors_pre/factors_post, in_keep/out_keep).
//
// Factors.  Each is exp(sign * 2 pi i * e / N) with an integer exponent e
// of the point (p, row, s):
//   kind 1, the four-step twiddle: e = (row * a + (p mod pm) * b + s mod sm)
//     * (s / sd) (two uploads: w_N^(kc*js), a = 1; three uploads, pass 1:
//     w_(NaNb)^(ka*jb) with jb = s / Ns, sd = Ns; pass 2 on the natural
//     order's planes: w_N^((kb*Na + ka)*js), a = pm = Na, b = 1; pass 2 on
//     the folded order's columns s = js * Na + ka: a = sm = sd = Na);
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
// b * d * n * S + row * d * S + q * S + s: three uploads' last pass writes
// its (B * nb, ns, na) planes as (B, ns, nb, na), the natural order (and
// the inverse reads it back).
//
// Transposed modes (whole (n, S) planes, no interleave).  Mode 2 writes
// point (row, s) of plane p at (p * S + s) * n + row, each column of the
// tile one run of n floats: the long tier's first pass stores the four-step
// reorder, so no transpose pass is left (the reference's free reorder,
// pallas_engine.py:4242-4252).  Mode 1 reads that layout (the inverse).
//
// Bound: bytes, one read and one write of each live point (16 B of
// planes).  Design: fft_strided.cu's tile on the in-place walk of
// inplace.cuh, fed and drained through the layouts above.  A block holds
// a tile of ts neighbouring columns of one plane across all n rows once
// in shared memory, each column as a line of two_factor_passes (the (n2,
// n1) matrix at the odd pitch n1 | 1) and the lines a stride apart
// (tile_stride) that puts a warp reading a row (neighbouring columns) or
// a column (neighbouring rows) on distinct banks.  Each float is copied by
// cp.async straight from its row run (natural) or column run (mode 1) to
// its place; with a pre factor the points go through registers and the
// factor instead (as fast as a sweep after a cp.async read, which needs
// one more barrier: PERF.md §6); the post factor rides the store.  The
// stages run in one pass or two factors (n = n1 * n2, the twiddle w_n^(j1
// k2) and the scale on the column pass's last stage), radix 16 and the
// generic prime stage for primes up to 127, with the stage tables and the
// twiddle's two root tables in shared memory.  Rows and columns go to and
// from registers as float4s where every run is 16-byte aligned, four
// points' factors computed one after another (times_factors), else as
// single floats; the ragged last tile of S is masked; consecutive blocks
// take tiles spread over the rows (tile_of).
// cuda_kernels.strided_tw_layout is the one layout rule (the C entry
// refuses any other): the columns a block, the threads and the exact
// shared bytes.  The grid is 1-D over P * tiles, offsets are 64-bit, and a
// block reads its whole tile before it writes, so the output may alias the
// input in the natural modes with in_len = out_len and in_pd = out_pd.
//
// Half storage (fft_strided_tw_f16_kernel, fft_strided_tw_bf16_kernel; C
// entries vk_fft_strided_tw_f16, vk_fft_strided_tw_bf16): the fp32
// kernel's body, layout, bound and factors on __half or __nv_bfloat16
// planes, 8 B a point of device memory where fp32 moves 16; the tile,
// tables, factors and stages stay fp32.  cp.async has no 2-byte copy, so
// every read takes the register path of a pre factor (four halves a plane
// in one 8-byte load where the runs are aligned to four, else single
// halves), widened, with or without the factor; every write, the post
// factor and the transposed and interleaved layouts included, narrows
// once, to nearest even, after the fp32 product.
//
// Bluestein's read window (fft_strided_tw_zp_kernel and its half twins; C
// entries vk_fft_strided_tw_zp, vk_fft_strided_tw_zp_f16,
// vk_fft_strided_tw_zp_bf16): the in_keep of _strided_kernel's Bluestein
// pass (_bluestein_long_fused_p).  A read bound `in_keep` apart from the
// plane pitch in_len: a point j >= in_keep of a plane is read as zero,
// never read from device memory, and the output is written as in_len /
// out_len say.  Forward plans in the natural mode only (the long
// Bluestein's first pass).  The window's planes are never whole, so the
// reads take the single-real path, half planes one half at a time, and
// no group of four straddles the window's edge.  Every stage reads all
// of its inputs: a first stage pruned to the live rows spilled and saved
// nothing (PERF.md section 6).  The same body (strided_tw_block<St,
// true>), so the unwindowed kernels compile as before.
#include "inplace.cuh"
#include "twofactor.cuh"

namespace {

using vkfft::Plan;
using vkfft::cmul;
using namespace vkfft::walk;

// Most threads a block; the bound holds the kernel to 64 registers.
constexpr int kThreads = 1024;

// How the tile meets device memory: rows in and out, the columns read
// from (P, S, n), or written to it.
constexpr int kNatural = 0, kReadTransposed = 1, kStoreTransposed = 2;

struct Factor {
  int kind;          // 0: none, 1: four-step twiddle, 2: chirp
  float sign;        // -1: forward, +1: inverse
  long long N, a, pm, b, sd, sm;
  double inv_n;      // 1 / N
};

// A launch's geometry: the columns S and tiles of a plane, the live
// lengths, the interleaves, then the columns a block, the lines' stride in
// the tile, the mode and the stage tables' points.
struct Geo {
  long long S, tiles, in_len, out_len, in_pd, out_pd;
  int ts, stride, mode, len1, len2;
};

// Points between neighbouring lines of the tile: in one pass of fewer
// than 16 columns a power of two (ts = 8 at n = 512), n rounded up to 16
// / ts mod 16 where the tile still fits beside its `tables` points, so the
// ts columns of a half-warp's 16 threads, each 16 / ts points deep, fall
// on 16 distinct bank pairs (at the odd stride two met on each: 1.2x the
// time at 16 x 512 x 2048, PERF.md §6); else the (n2, n1) matrix at
// the pitch n1 | 1, made odd.
__host__ __device__ __forceinline__ int tile_stride(int n1, int n2, int ts,
                                                   int tables) {
  if (n2 == 1 && ts < 16 && 16 % ts == 0) {
    const int even = n1 + ((16 / ts - n1 % 16) + 16) % 16;
    if ((long long)ts * even + tables <= vkfft::kMaxSmemBytes / 8)
      return even;
  }
  return (n2 * (n1 | 1)) | 1;
}

// The factor of point (row, s) of plane p.
__device__ __forceinline__ float2 factor_at(const Factor& f, long long p,
                                            long long row, long long s,
                                            long long S) {
  unsigned long long e;
  if (f.kind == 1) {
    const unsigned long long u = (unsigned long long)s;
    const unsigned long long col =
        f.sd == 1 ? u : u / (unsigned long long)f.sd;
    unsigned long long base = (unsigned long long)row * f.a;
    if (f.pm > 1) base += (unsigned long long)(p % f.pm) * f.b;
    if (f.sm > 1) base += u % (unsigned long long)f.sm;
    e = base * col;
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

// v[i] times the factor of point (row + i * dr, s0 + i * ds) of plane p,
// i < 4, one factor after another: four at once held more than 64
// registers.
__device__ __forceinline__ void times_factors(float2 (&v)[4], const Factor& f,
                                              long long p, long long row,
                                              long long s0, long long S,
                                              int dr, int ds) {
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    const float2 t = cmul(v[0], factor_at(f, p, row + i * dr, s0 + i * ds, S));
    v[0] = v[1];
    v[1] = v[2];
    v[2] = v[3];
    v[3] = t;
  }
}

// blockIdx.x read afresh where it is used, so the tile's place is found
// again at the store, not held through the passes.
__device__ __forceinline__ long long fresh_block() {
  unsigned b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return b;
}

// The tile of block b: where kSpread divides a plane's tiles, consecutive
// blocks take tiles a kSpread-th of the plane's rows apart (fft_strided.cu:
// with neighbouring tiles for neighbouring blocks the time followed where
// the planes lay in physical memory).
constexpr int kSpread = 4;

__device__ __forceinline__ long long tile_of(long long b, long long tiles) {
  if (tiles % kSpread != 0) return b;
  const long long p = b / tiles;
  const long long t = b - p * tiles;
  return p * tiles + (t % kSpread) * (tiles / kSpread) + t / kSpread;
}

// The block's plane, first column and columns inside S.
struct Place {
  long long p, s0;
  int cols;
};

__device__ __forceinline__ Place place_of(const Geo& g) {
  const long long bt = tile_of(fresh_block(), g.tiles);
  const long long p = bt / g.tiles;
  const long long s0 = (bt - p * g.tiles) * g.ts;
  return {p, s0, (int)min((long long)g.ts, g.S - s0)};
}

// Point j of the tile's column c in shared memory: the column's line at c
// * S (Map.S), its point j at a * A + b * B, j = a * d + b.
__device__ __forceinline__ int tile_pos(int c, int j, const Map& mp) {
  const int a = quot(j, mp.dd);
  return c * mp.S + a * mp.A + (j - a * (int)mp.dd.d) * mp.B;
}

// A real of a plane as fp32: floats through the read-only cache, halves
// widened.
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
template <class St>
__device__ __forceinline__ float ld(const St* p) {
  return widen(*p);
}

// Four neighbouring reals of a plane, aligned to four, as fp32: one
// float4 through the read-only cache, or four halves in one 8-byte load.
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
template <class St>
__device__ __forceinline__ float4 ld4(const St* p) {
  return load4(p);
}

// The tile's columns from rows of plane p (interleaved by g.in_pd), point
// (j, c) straight to tile_pos(c, j): by cp.async, each float to its place,
// or with a pre factor or from half planes through registers (four
// columns at once where the plane is whole and every run aligned to
// four), times the factor; points past the live length (with kWindow,
// past the read bound `keep`) as zeros.  Returns when this thread's
// copies have landed.
template <bool kWindow = false, class St>
__device__ void load_rows(const St* xr, const St* xi, const Place& at,
                          const Geo& g, const Map& mp, const Factor& f,
                          float2* home, long long keep = 0) {
  const int n = mp.dn.d;
  const long long S = g.S, pd = g.in_pd, len = kWindow ? keep : g.in_len;
  const long long base =
      (at.p / pd) * pd * g.in_len + (at.p % pd) * S + at.s0;
  const long long rs = pd * S;
  const bool whole = len == n * S;
  if ((kNarrow<St> || f.kind) && whole && at.cols == g.ts &&
      ((g.ts | S | at.s0) & 3) == 0 && group_aligned(xr, xi)) {
    const int c4 = g.ts >> 2;
    const Div dc = make_div(c4);
    for (int q = threadIdx.x; q < n * c4; q += blockDim.x) {
      const int j = quot(q, dc);
      const int c = 4 * (q - j * c4);
      const long long gi = base + j * rs + c;
      const float4 r = ld4(xr + gi);
      const float4 i = ld4(xi + gi);
      float2 v[4] = {make_float2(r.x, i.x), make_float2(r.y, i.y),
                     make_float2(r.z, i.z), make_float2(r.w, i.w)};
      if (!kNarrow<St> || f.kind)
        times_factors(v, f, at.p, j, at.s0 + c, S, 0, 1);
#pragma unroll
      for (int k = 0; k < 4; ++k) home[tile_pos(c + k, j, mp)] = v[k];
    }
    return;
  }
  const Div dc = make_div(at.cols);
  for (int u = threadIdx.x; u < n * at.cols; u += blockDim.x) {
    const int j = quot(u, dc);
    const int c = u - j * at.cols;
    float2* d = home + tile_pos(c, j, mp);
    const bool live = whole || j * S + at.s0 + c < len;
    const long long gi = base + j * rs + c;
    if (f.kind) {
      float2 v = make_float2(0.f, 0.f);
      if (live)
        v = cmul(make_float2(ld(xr + gi), ld(xi + gi)),
                 factor_at(f, at.p, j, at.s0 + c, S));
      *d = v;
    } else if (live) {
      if constexpr (kNarrow<St>) {
        *d = make_float2(widen(xr[gi]), widen(xi[gi]));
      } else {
        cp_async4(reinterpret_cast<float*>(d), xr + gi);
        cp_async4(reinterpret_cast<float*>(d) + 1, xi + gi);
      }
    } else {
      *d = make_float2(0.f, 0.f);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Mode 1's read: the tile's columns, each one run of n reals from real
// offset g0 (column c at g0 + c * n), point (j, c) straight to tile_pos(c,
// j), by cp.async or with a pre factor or from half planes through
// registers (four rows at once where n and the runs are aligned to four).
// Returns when this thread's copies have landed.
template <class St>
__device__ void load_columns(const St* xr, const St* xi, long long g0,
                             const Place& at, long long S, const Map& mp,
                             const Factor& f, float2* home) {
  const int n = mp.dn.d;
  if ((kNarrow<St> || f.kind) && ((g0 | n) & 3) == 0 &&
      group_aligned(xr, xi)) {
    for (int u = 4 * threadIdx.x; u < n * at.cols; u += 4 * blockDim.x) {
      const int c = quot(u, mp.dn);
      const int j = u - c * n;
      const float4 r = ld4(xr + g0 + u);
      const float4 i = ld4(xi + g0 + u);
      float2 v[4] = {make_float2(r.x, i.x), make_float2(r.y, i.y),
                     make_float2(r.z, i.z), make_float2(r.w, i.w)};
      if (!kNarrow<St> || f.kind)
        times_factors(v, f, at.p, j, at.s0 + c, S, 1, 0);
      // the four stores in an order rotated by the lane: distinct banks
      int pos[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) pos[k] = tile_pos(c, j + k, mp);
      const int rot = (threadIdx.x >> 2) & 3;
      rotate(v, rot);
      rotate(pos, rot);
#pragma unroll
      for (int k = 0; k < 4; ++k) home[pos[k]] = v[k];
    }
    return;
  }
  for (int u = threadIdx.x; u < n * at.cols; u += blockDim.x) {
    const int c = quot(u, mp.dn);
    const int j = u - c * n;
    float2* d = home + tile_pos(c, j, mp);
    if (f.kind) {
      *d = cmul(make_float2(ld(xr + g0 + u), ld(xi + g0 + u)),
                factor_at(f, at.p, j, at.s0 + c, S));
    } else if constexpr (kNarrow<St>) {
      *d = make_float2(widen(xr[g0 + u]), widen(xi[g0 + u]));
    } else {
      cp_async4(reinterpret_cast<float*>(d), xr + g0 + u);
      cp_async4(reinterpret_cast<float*>(d) + 1, xi + g0 + u);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tile back to rows of plane p (interleaved by g.out_pd), times the
// post factor, where the point is inside the live length: four reals a
// plane at once (store4) where every run is aligned to four, else single
// reals, narrowed to the planes' storage type.
template <class St>
__device__ void store_rows(const float2* home, const Map& mp, St* yr, St* yi,
                           const Place& at, const Geo& g, const Factor& f) {
  const int n = mp.dn.d;
  const long long S = g.S, pd = g.out_pd, len = g.out_len;
  const long long base = (at.p / pd) * pd * len + (at.p % pd) * S + at.s0;
  const long long rs = pd * S;
  if (at.cols == g.ts && ((g.ts | S | at.s0 | len) & 3) == 0 &&
      group_aligned(yr, yi)) {
    const int c4 = g.ts >> 2;
    const Div dc = make_div(c4);
    for (int q = threadIdx.x; q < n * c4; q += blockDim.x) {
      const int k = quot(q, dc);
      const int c = 4 * (q - k * c4);
      if (k * S + at.s0 + c < len) {
        float2 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = home[tile_pos(c + i, k, mp)];
        if (f.kind) times_factors(v, f, at.p, k, at.s0 + c, S, 0, 1);
        const long long gi = base + k * rs + c;
        store4(yr + gi, v[0].x, v[1].x, v[2].x, v[3].x);
        store4(yi + gi, v[0].y, v[1].y, v[2].y, v[3].y);
      }
    }
    return;
  }
  const Div dc = make_div(at.cols);
  for (int u = threadIdx.x; u < n * at.cols; u += blockDim.x) {
    const int k = quot(u, dc);
    const int c = u - k * at.cols;
    if (k * S + at.s0 + c < len) {
      float2 v = home[tile_pos(c, k, mp)];
      if (f.kind) v = cmul(v, factor_at(f, at.p, k, at.s0 + c, S));
      const long long gi = base + k * rs + c;
      put(yr[gi], v.x);
      put(yi[gi], v.y);
    }
  }
}

// Mode 2's store with a post factor: point t of column c of the tile to
// real offset g0 + c * n + t, four rows a thread at once (store4) where n
// and the runs are aligned to four, else one point a thread, narrowed to
// the planes' storage type (store_lines takes the tile without one).
template <class St>
__device__ void store_columns_factored(const float2* home, const Map& mp,
                                       St* yr, St* yi, long long g0,
                                       const Place& at, long long S,
                                       const Factor& f) {
  const int n = mp.dn.d;
  if (((g0 | n) & 3) == 0 && group_aligned(yr, yi)) {
    for (int u = 4 * threadIdx.x; u < n * at.cols; u += 4 * blockDim.x) {
      const int c = quot(u, mp.dn);
      const int t = u - c * n;
      // the four reads in an order rotated by the lane: distinct banks
      int pos[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) pos[k] = tile_pos(c, t + k, mp);
      const int rot = (threadIdx.x >> 2) & 3;
      rotate(pos, rot);
      float2 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = home[pos[k]];
      rotate(v, (4 - rot) & 3);
      times_factors(v, f, at.p, t, at.s0 + c, S, 1, 0);
      store4(yr + g0 + u, v[0].x, v[1].x, v[2].x, v[3].x);
      store4(yi + g0 + u, v[0].y, v[1].y, v[2].y, v[3].y);
    }
    return;
  }
  for (int u = threadIdx.x; u < n * at.cols; u += blockDim.x) {
    const int c = quot(u, mp.dn);
    const float2 v = cmul(home[tile_pos(c, u - c * n, mp)],
                          factor_at(f, at.p, u - c * n, at.s0 + c, S));
    put(yr[g0 + u], v.x);
    put(yi[g0 + u], v.y);
  }
}

// The tile's two passes (inplace.cuh's two_factor_passes on its ts lines
// at the odd stride, every column of a ragged last tile too, whose unread
// columns are not stored): forward the column pass, the twiddle and the
// scale on its last stage (on the row pass's where n2 = 1), then the row
// pass; the inverse mirrored.  The factors, the flags and the tables are
// found again in each pass from the parameters, not held through it (held,
// two flags and the count of columns spilled).
__device__ __forceinline__ void tile_passes(float2* smem, const Geo& g,
                                            const Plan& p1, const Plan& p2) {
  for (int k = 0; k < 2; ++k) {
    const int n1 = fresh_int(p1.n), n2 = p2.n;
    const bool inverse = fresh_int(p1.inverse) != 0;
    const float2* s1 = smem + fresh_int(g.ts * g.stride);
    const float2* tlo = s1 + g.len1 + g.len2;
    // with n2 = 1 the twiddle is the scale alone, skipped when it is 1
    const bool twiddled =
        n2 > 1 || tlo[kTwLo].x != 1.f || tlo[kTwLo].y != 0.f;
    const bool row = (k == 0) == inverse;
    const Pass ps = row ? Pass{g.ts * n2, g.stride, n1 | 1, 1, make_div(n2)}
                        : Pass{g.ts * n1, g.stride, 1, n1 | 1, make_div(n1)};
    const bool fuse = twiddled && (inverse ? row : row == (n2 == 1));
    run_pass(smem, ps, row ? p1 : p2, row ? s1 : s1 + g.len1,
             InterTwiddle{fuse ? tlo : nullptr, tlo + kTwLo});
  }
}

// The block body on planes of storage type St; with kWindow, Bluestein's
// read window (a forward in the natural mode): the points j < keep of
// each plane read, the rest zeros.
template <class St, bool kWindow = false>
__device__ __forceinline__ void strided_tw_block(
    float2* smem, const St* xr, const St* xi, St* yr, St* yi, const Plan& p1,
    const Plan& p2, const float2* t1, const float2* t2, const float2* tw,
    const Geo& g, const Factor& pre, const Factor& post,
    long long keep = 0) {
  const int n1 = p1.n, n2 = p2.n, n = n1 * n2;
  const int pitch = n1 | 1;
  float2* s1 = smem + g.ts * g.stride;
  load_tables(s1, t1, t2, tw, g.len1, g.len2, rotation_points(n));
  // forward: natural order in (row-major), the spectrum's natural order
  // out (transposed); the inverse's passes run mirrored
  const bool inverse = p1.inverse != 0;
  {
    const Place at = place_of(g);
    const Map in = make_map(n, g.stride, inverse, n1, n2, pitch);
    if constexpr (kWindow)
      load_rows<true>(xr, xi, at, g, in, pre, smem, keep);
    else if (g.mode == kReadTransposed)
      load_columns(xr, xi, (at.p * g.S + at.s0) * n, at, g.S, in, pre, smem);
    else
      load_rows(xr, xi, at, g, in, pre, smem);
    __syncthreads();
  }
  tile_passes(smem, g, p1, p2);
  const Place at = place_of(g);
  const Map out = make_map(n, g.stride, !inverse, n1, n2, pitch);
  if (g.mode == kStoreTransposed && post.kind)
    store_columns_factored(smem, out, yr, yi, (at.p * g.S + at.s0) * n, at,
                           g.S, post);
  else if (g.mode == kStoreTransposed)
    store_lines(smem, out, yr, yi, (at.p * g.S + at.s0) * n, at.cols * n);
  else
    store_rows(smem, out, yr, yi, at, g, post);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_strided_tw_kernel(const float* xr, const float* xi, float* yr, float* yi,
                      Plan p1, Plan p2, const float2* t1, const float2* t2,
                      const float2* tw, Geo g, Factor pre, Factor post) {
  extern __shared__ __align__(16) float2 smem[];
  strided_tw_block(smem, xr, xi, yr, yi, p1, p2, t1, t2, tw, g, pre, post);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_strided_tw_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                          __half* yi, Plan p1, Plan p2, const float2* t1,
                          const float2* t2, const float2* tw, Geo g,
                          Factor pre, Factor post) {
  extern __shared__ __align__(16) float2 smem[];
  strided_tw_block(smem, xr, xi, yr, yi, p1, p2, t1, t2, tw, g, pre, post);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_strided_tw_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                           __nv_bfloat16* yr, __nv_bfloat16* yi, Plan p1,
                           Plan p2, const float2* t1, const float2* t2,
                           const float2* tw, Geo g, Factor pre, Factor post) {
  extern __shared__ __align__(16) float2 smem[];
  strided_tw_block(smem, xr, xi, yr, yi, p1, p2, t1, t2, tw, g, pre, post);
}

// Bluestein's read window: strided_tw_block<St, true>, the points j <
// keep of each plane read.
__global__ void __launch_bounds__(kThreads, 1)
fft_strided_tw_zp_kernel(const float* xr, const float* xi, float* yr,
                         float* yi, Plan p1, Plan p2, const float2* t1,
                         const float2* t2, const float2* tw, Geo g,
                         Factor pre, Factor post, long long keep) {
  extern __shared__ __align__(16) float2 smem[];
  strided_tw_block<float, true>(smem, xr, xi, yr, yi, p1, p2, t1, t2, tw, g,
                                pre, post, keep);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_strided_tw_zp_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                             __half* yi, Plan p1, Plan p2, const float2* t1,
                             const float2* t2, const float2* tw, Geo g,
                             Factor pre, Factor post, long long keep) {
  extern __shared__ __align__(16) float2 smem[];
  strided_tw_block<__half, true>(smem, xr, xi, yr, yi, p1, p2, t1, t2, tw, g,
                                 pre, post, keep);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_strided_tw_zp_bf16_kernel(const __nv_bfloat16* xr,
                              const __nv_bfloat16* xi, __nv_bfloat16* yr,
                              __nv_bfloat16* yi, Plan p1, Plan p2,
                              const float2* t1, const float2* t2,
                              const float2* tw, Geo g, Factor pre,
                              Factor post, long long keep) {
  extern __shared__ __align__(16) float2 smem[];
  strided_tw_block<__nv_bfloat16, true>(smem, xr, xi, yr, yi, p1, p2, t1, t2,
                                        tw, g, pre, post, keep);
}

// Factor from its host form: kind, sign, N, a, pm, b, sd, sm.
bool factor_from(const long long* v, Factor* f) {
  f->kind = (int)v[0];
  f->sign = v[1] < 0 ? -1.f : 1.f;
  f->N = v[2];
  f->a = v[3];
  f->pm = v[4];
  f->b = v[5];
  f->sd = v[6];
  f->sm = v[7];
  if (f->kind == 0) {
    f->N = f->pm = f->sd = f->sm = 1;
    f->inv_n = 1.0;
    return true;
  }
  if (f->kind != 1 && f->kind != 2) return false;
  if (f->N < 1 || f->pm < 1 || f->sd < 1 || f->sm < 1 || f->a < 0 ||
      f->b < 0)
    return false;
  f->inv_n = 1.0 / (double)f->N;
  return true;
}

// The checks and the launch of `kernel` on planes of storage type St
// (float, or a half type on the same fp32 walk), as vk_fft_strided_tw
// describes them; with kWindow, the windowed `kernel` reading the points
// j < in_keep of each plane (1 <= in_keep <= in_len, 0 for all in_len; a
// forward in the natural mode without interleave).
template <bool kWindow = false, class St, typename K>
int launch(K kernel, const St* xr, const St* xi, St* yr, St* yi, long long P,
           long long S, long long in_len, long long out_len, const int* plan1,
           const int* plan2, const float* table1, const float* table2,
           const float* twiddle, const long long* factors, int in_pd,
           int out_pd, int mode, int ts, int threads, int smem,
           void* stream, long long in_keep = 0) {
  Plan p1, p2;
  Factor pre, post;
  if (P < 1 || S < 1 || !vkfft::plan_from_ints(plan1, &p1) ||
      !vkfft::subplan_from_ints(plan2, &p2) || twiddle == nullptr ||
      !factor_from(factors, &pre) || !factor_from(factors + 8, &post))
    return (int)cudaErrorInvalidValue;
  const int n = p1.n * p2.n;
  const long long points = (long long)n * S;
  if (n > vkfft::kMaxN || p1.n < p2.n || p2.inverse != p1.inverse)
    return (int)cudaErrorInvalidValue;
  if (in_len < 1 || in_len > points || out_len < 1 || out_len > points)
    return (int)cudaErrorInvalidValue;
  if (in_pd < 1 || out_pd < 1 || P % in_pd || P % out_pd ||
      (in_pd > 1 && in_len != points) || (out_pd > 1 && out_len != points))
    return (int)cudaErrorInvalidValue;
  if (mode < kNatural || mode > kStoreTransposed ||
      (mode != kNatural && (in_len != points || out_len != points ||
                            in_pd != 1 || out_pd != 1)))
    return (int)cudaErrorInvalidValue;
  const int len1 = table_len(p1), len2 = table_len(p2);
  const int stride =
      tile_stride(p1.n, p2.n, ts, len1 + len2 + rotation_points(n));
  if (ts < 1 || ts > S || threads < 32 || threads > kThreads ||
      threads % 32 != 0 || !rounds_fit(p1, threads) ||
      !rounds_fit(p2, threads) || smem < 0 ||
      (size_t)smem != sizeof(float2) * ((size_t)ts * stride + len1 + len2 +
                                        rotation_points(n)) ||
      smem > vkfft::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (S + ts - 1) / ts;
  if (P * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (kWindow && (in_keep < 0 || in_keep > in_len || p1.inverse ||
                  mode != kNatural || in_pd != 1))
    return (int)cudaErrorInvalidValue;
  const int err = smem_opt_in(kernel, smem);
  if (err) return err;
  const Geo g{S, tiles, in_len, out_len, in_pd, out_pd, ts, stride, mode,
              len1, len2};
  if constexpr (kWindow)
    kernel<<<(unsigned)(P * tiles), threads, smem, (cudaStream_t)stream>>>(
        xr, xi, yr, yi, p1, p2, reinterpret_cast<const float2*>(table1),
        reinterpret_cast<const float2*>(table2),
        reinterpret_cast<const float2*>(twiddle), g, pre, post,
        in_keep ? in_keep : in_len);
  else
    kernel<<<(unsigned)(P * tiles), threads, smem, (cudaStream_t)stream>>>(
        xr, xi, yr, yi, p1, p2, reinterpret_cast<const float2*>(table1),
        reinterpret_cast<const float2*>(table2),
        reinterpret_cast<const float2*>(twiddle), g, pre, post);
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
// success).  (P, n, S) planes (mode 1: the input (P, S, n); mode 2: the
// output), the live lengths (and per-plane strides) in_len and out_len,
// each at most n * S; plans (int form) of the two factors of n = n1 * n2
// (the second the empty plan of length 1 for one pass), their stage
// tables (no scale) and the inter-factor twiddle as two tables, 64 points
// w_n^b then ceil(n / 64) points scale * w_n^(64 a), all as interleaved
// fp32 pairs; `factors` the pre and the post factor as 8 long longs each
// (kind, sign, N, a, pm, b, sd, sm); the input's and the output's plane
// interleave in_pd and out_pd (1: none; more only for whole (n, S)
// planes, P a multiple); the mode (0 natural, 1 the input transposed, 2
// the output transposed; 1 and 2 only for whole planes, no interleave).
// The layout (cuda_kernels.strided_tw_layout): `ts` columns a block (1 <=
// ts <= S), `threads` a block (a multiple of 32 up to 1024, enough for a
// whole sequence of every stage in a round) and the dynamic shared bytes,
// exactly; any other layout is refused (cudaErrorInvalidValue).
int vk_fft_strided_tw(const float* xr, const float* xi, float* yr, float* yi,
                      long long P, long long S, long long in_len,
                      long long out_len, const int* plan1, const int* plan2,
                      const float* table1, const float* table2,
                      const float* twiddle, const long long* factors,
                      int in_pd, int out_pd, int mode, int ts, int threads,
                      int smem, void* stream) {
  return launch(fft_strided_tw_kernel, xr, xi, yr, yi, P, S, in_len, out_len,
                plan1, plan2, table1, table2, twiddle, factors, in_pd, out_pd,
                mode, ts, threads, smem, stream);
}

// vk_fft_strided_tw on fp16 / bf16 planes (the tables and factors fp32,
// as vk_fft_strided_tw's).
int vk_fft_strided_tw_f16(const __half* xr, const __half* xi, __half* yr,
                          __half* yi, long long P, long long S,
                          long long in_len, long long out_len,
                          const int* plan1, const int* plan2,
                          const float* table1, const float* table2,
                          const float* twiddle, const long long* factors,
                          int in_pd, int out_pd, int mode, int ts,
                          int threads, int smem, void* stream) {
  return launch(fft_strided_tw_f16_kernel, xr, xi, yr, yi, P, S, in_len,
                out_len, plan1, plan2, table1, table2, twiddle, factors,
                in_pd, out_pd, mode, ts, threads, smem, stream);
}

int vk_fft_strided_tw_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                           __nv_bfloat16* yr, __nv_bfloat16* yi, long long P,
                           long long S, long long in_len, long long out_len,
                           const int* plan1, const int* plan2,
                           const float* table1, const float* table2,
                           const float* twiddle, const long long* factors,
                           int in_pd, int out_pd, int mode, int ts,
                           int threads, int smem, void* stream) {
  return launch(fft_strided_tw_bf16_kernel, xr, xi, yr, yi, P, S, in_len,
                out_len, plan1, plan2, table1, table2, twiddle, factors,
                in_pd, out_pd, mode, ts, threads, smem, stream);
}

// vk_fft_strided_tw under Bluestein's read window (fp32, fp16 and bf16
// planes): the points j < in_keep of each plane are read, at the plane
// pitch in_len, and the rest are declared zero, never read (1 <= in_keep
// <= in_len; 0 for all in_len); the output as vk_fft_strided_tw writes
// it.  Forward plans, the natural mode and no input interleave only.
int vk_fft_strided_tw_zp(const float* xr, const float* xi, float* yr,
                         float* yi, long long P, long long S,
                         long long in_len, long long out_len,
                         const int* plan1, const int* plan2,
                         const float* table1, const float* table2,
                         const float* twiddle, const long long* factors,
                         int in_pd, int out_pd, int mode, int ts, int threads,
                         int smem, long long in_keep, void* stream) {
  return launch<true>(fft_strided_tw_zp_kernel, xr, xi, yr, yi, P, S, in_len,
                      out_len, plan1, plan2, table1, table2, twiddle, factors,
                      in_pd, out_pd, mode, ts, threads, smem, stream,
                      in_keep);
}

int vk_fft_strided_tw_zp_f16(const __half* xr, const __half* xi, __half* yr,
                             __half* yi, long long P, long long S,
                             long long in_len, long long out_len,
                             const int* plan1, const int* plan2,
                             const float* table1, const float* table2,
                             const float* twiddle, const long long* factors,
                             int in_pd, int out_pd, int mode, int ts,
                             int threads, int smem, long long in_keep,
                             void* stream) {
  return launch<true>(fft_strided_tw_zp_f16_kernel, xr, xi, yr, yi, P, S,
                      in_len, out_len, plan1, plan2, table1, table2, twiddle,
                      factors, in_pd, out_pd, mode, ts, threads, smem, stream,
                      in_keep);
}

int vk_fft_strided_tw_zp_bf16(const __nv_bfloat16* xr,
                              const __nv_bfloat16* xi, __nv_bfloat16* yr,
                              __nv_bfloat16* yi, long long P, long long S,
                              long long in_len, long long out_len,
                              const int* plan1, const int* plan2,
                              const float* table1, const float* table2,
                              const float* twiddle, const long long* factors,
                              int in_pd, int out_pd, int mode, int ts,
                              int threads, int smem, long long in_keep,
                              void* stream) {
  return launch<true>(fft_strided_tw_zp_bf16_kernel, xr, xi, yr, yi, P, S,
                      in_len, out_len, plan1, plan2, table1, table2, twiddle,
                      factors, in_pd, out_pd, mode, ts, threads, smem, stream,
                      in_keep);
}

// Resident blocks an SM of the kernel at `threads` a block and `smem`
// dynamic shared bytes, into *blocks.
int vk_fft_strided_tw_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_strided_tw_kernel, threads, smem, blocks);
}

int vk_fft_strided_tw_f16_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_strided_tw_f16_kernel, threads, smem, blocks);
}

int vk_fft_strided_tw_bf16_occupancy(int threads, int smem, int* blocks) {
  return occupancy(fft_strided_tw_bf16_kernel, threads, smem, blocks);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
