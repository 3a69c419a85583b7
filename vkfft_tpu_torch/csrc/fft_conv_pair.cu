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
// Bound: bytes at sample 7's n = 10007 (16 n B of planes a line; the two
// m = 32768-point FFTs, ~10 m log2 m flops a line, take 0.07 ms at the
// card's fp32 rate for 838 lines against 0.04 ms of bytes, PERF.md).
// Design: the m-point plane (256 KB at 32768) is more than one block's
// shared memory, so a thread-block cluster of C blocks holds it once:
// block `rank` owns the column tile (all nc rows, columns [rank*ns/C,
// ...), row-major at pitch ns/C) for the column stages and the row tile
// (rows [rank*nc/C, ...), all ns columns, at the odd pitch ns | 1) for the
// row stages, in one buffer.  Each pass runs in place on the stage walk
// of inplace.cuh with the block's stage tables and the twiddle's two root
// tables in shared memory; the four-step twiddle (conjugated in the
// inverse) and the spectrum ride the walk's hook on the last stage of the
// pass before them, on outputs a thread holds.  The tiles move between
// the blocks in whole rounds over distributed shared memory: to the row
// tile each thread pulls its share of every owner's column tile into
// registers (two points an access where the column tile's width is even),
// the cluster meets, and it writes them locally; back to the column tile
// it reads its own row tile and pushes it to the owners after the
// cluster meets.  cuda_kernels.conv_pair_layout is the one layout rule
// (the C entry refuses any other): the plane's split, C, the threads (a
// thread moves at most kXchg points) and the exact shared bytes.  Device
// memory sees one read and one write of the n-point line; the pad never
// exists there.  Every read of a line precedes the first cluster barrier
// and every write follows the last, so the output may alias the input.
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

#include "cluster.cuh"
#include "inplace.cuh"
#include "stockham.cuh"

namespace cg = cooperative_groups;

namespace {

using vkfft::Plan;
using vkfft::cmul;

__device__ __forceinline__ float2 conjf2(float2 a) { return make_float2(a.x, -a.y); }

namespace walk = vkfft::walk;

using vkfft::cluster::kXchg;  // most points a thread moves in an exchange
using vkfft::cluster::cluster_ok;
using vkfft::cluster::ld_remote2;
using vkfft::cluster::ld_remote4;
using vkfft::cluster::launch_cluster;
using vkfft::cluster::remote;
using vkfft::cluster::st_remote2;
using vkfft::cluster::st_remote4;

constexpr int kPairThreads = 512;   // most threads a block
constexpr int kPairMinBlocks = 2;   // blocks an SM the register budget keeps

// The hook of the Bluestein mode's four passes: the four-step twiddle
// w_m^(row * k) (row = row0 + seq, the sequence's row or column in the
// plane) from its two root tables at `p` (w^b, then w^(64 a)), conjugated
// in the inverse, or the spectrum [row][k] at `p` in device memory.  The
// mode rides the low bits of `ns_mode`, so the hook holds four registers
// through a stage, as InterTwiddle does.
enum { kHookNone = 0, kHookTwiddle, kHookTwiddleConj, kHookSpectrum };

struct ConvHook {
  const float2* p;
  int row0, ns_mode;   // ns << 2 | mode
  __device__ __forceinline__ bool on() const { return (ns_mode & 3) != kHookNone; }
  __device__ __forceinline__ ConvHook off() const {
    return {p, row0, ns_mode & ~3};
  }
  __device__ __forceinline__ float2 operator()(float2 v, int seq, int k) const {
    const int row = row0 + seq, mode = ns_mode & 3;
    if (mode == kHookSpectrum) return cmul(v, __ldg(&p[row * (ns_mode >> 2) + k]));
    float2 w = walk::inter_twiddle(row * k, p, p + walk::kTwLo);
    if (mode == kHookTwiddleConj) w.y = -w.y;
    return cmul(v, w);
  }
};

// Column tile -> row tile: point (r, ks) of this block's row tile is
// point (r0 + r, ks % cols) of owner ks / cols's column tile.  Each thread
// pulls its points (pairs along ks when cols is even) into registers, the
// cluster meets (every pull is done), and it writes them at r * Pr + ks.
__device__ void pull_rows(cg::cluster_group& cluster, float2* buf, int ns,
                          int rows, int cols, int Pr, int r0) {
  const int T = blockDim.x;
  const int tile = rows * ns;
  cluster.sync();   // every block's columns are done
  if ((cols & 1) == 0) {
    const int half = tile >> 1;
    const walk::Div dns = walk::make_div(ns >> 1), dc = walk::make_div(cols >> 1);
    float4 v[kXchg / 2];
    int v0 = walk::fresh_tid();
#pragma unroll
    for (int j = 0; j < kXchg / 2; ++j, v0 += T) {
      const int p = min(v0, half - 1);
      const int r = walk::quot(p, dns);
      const int ks2 = p - r * (int)dns.d;        // pair index along the row
      const int owner = walk::quot(ks2, dc);
      v[j] = ld_remote4(remote(
          buf, 2 * (((r0 + r) * cols >> 1) + ks2 - owner * (int)dc.d), owner));
    }
    cluster.sync();   // every pull is done: the column tiles are free
    v0 = walk::fresh_tid();
#pragma unroll
    for (int j = 0; j < kXchg / 2; ++j, v0 += T) {
      const int p = min(v0, half - 1);
      const int r = walk::quot(p, dns);
      const int at = r * Pr + 2 * (p - r * (int)dns.d);
      if (v0 < half) {
        buf[at] = make_float2(v[j].x, v[j].y);
        buf[at + 1] = make_float2(v[j].z, v[j].w);
      }
    }
  } else {
    const walk::Div dns = walk::make_div(ns), dc = walk::make_div(cols);
    float2 v[kXchg];
    int u0 = walk::fresh_tid();
#pragma unroll
    for (int j = 0; j < kXchg; ++j, u0 += T) {
      const int u = min(u0, tile - 1);
      const int r = walk::quot(u, dns);
      const int ks = u - r * ns;
      const int owner = walk::quot(ks, dc);
      v[j] = ld_remote2(remote(buf, (r0 + r) * cols + ks - owner * cols, owner));
    }
    cluster.sync();   // every pull is done: the column tiles are free
    u0 = walk::fresh_tid();
#pragma unroll
    for (int j = 0; j < kXchg; ++j, u0 += T) {
      const int u = min(u0, tile - 1);
      const int r = walk::quot(u, dns);
      if (u0 < tile) buf[r * Pr + u - r * ns] = v[j];
    }
  }
  __syncthreads();
}

// Row tile -> column tile: this block's point (r, ks) goes to point (r0 +
// r, ks % cols) of owner ks / cols's column tile.  Each thread reads its
// points into registers, the cluster meets (every row tile is read), it
// pushes them (pairs when cols is even), and the cluster meets again.
__device__ void push_columns(cg::cluster_group& cluster, float2* buf, int ns,
                             int rows, int cols, int Pr, int r0) {
  const int T = blockDim.x;
  const int tile = rows * ns;
  if ((cols & 1) == 0) {
    const int half = tile >> 1;
    const walk::Div dns = walk::make_div(ns >> 1), dc = walk::make_div(cols >> 1);
    float4 v[kXchg / 2];
    int v0 = walk::fresh_tid();
#pragma unroll
    for (int j = 0; j < kXchg / 2; ++j, v0 += T) {
      const int p = min(v0, half - 1);
      const int r = walk::quot(p, dns);
      const int at = r * Pr + 2 * (p - r * (int)dns.d);
      const float2 a = buf[at], b = buf[at + 1];
      v[j] = make_float4(a.x, a.y, b.x, b.y);
    }
    cluster.sync();   // every row tile is read: the buffers are free
    v0 = walk::fresh_tid();
#pragma unroll
    for (int j = 0; j < kXchg / 2; ++j, v0 += T) {
      const int p = min(v0, half - 1);
      const int r = walk::quot(p, dns);
      const int ks2 = p - r * (int)dns.d;
      const int owner = walk::quot(ks2, dc);
      if (v0 < half)
        st_remote4(remote(buf, 2 * (((r0 + r) * cols >> 1) + ks2 -
                                    owner * (int)dc.d), owner), v[j]);
    }
  } else {
    const walk::Div dns = walk::make_div(ns), dc = walk::make_div(cols);
    float2 v[kXchg];
    int u0 = walk::fresh_tid();
#pragma unroll
    for (int j = 0; j < kXchg; ++j, u0 += T) {
      const int u = min(u0, tile - 1);
      const int r = walk::quot(u, dns);
      v[j] = buf[r * Pr + u - r * ns];
    }
    cluster.sync();   // every row tile is read: the buffers are free
    u0 = walk::fresh_tid();
#pragma unroll
    for (int j = 0; j < kXchg; ++j, u0 += T) {
      const int u = min(u0, tile - 1);
      const int r = walk::quot(u, dns);
      const int ks = u - r * ns;
      const int owner = walk::quot(ks, dc);
      if (u0 < tile)
        st_remote2(remote(buf, (r0 + r) * cols + ks - owner * cols, owner), v[j]);
    }
  }
  cluster.sync();   // every push has landed
}

// Stage-table lengths of the four plans, in points.
struct Lens {
  int cf, sf, si, ci;
};

__global__ void __launch_bounds__(kPairThreads, kPairMinBlocks)
fft_conv_pair_kernel(const float* xr, const float* xi, float* yr, float* yi,
                     int n, Plan pcf, Plan psf, Plan psi, Plan pci,
                     const float2* tcf, const float2* tsf, const float2* tsi,
                     const float2* tci, const float2* tw, const float2* spec,
                     const float2* chirp, Lens len) {
  extern __shared__ __align__(16) float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int nc = pcf.n, ns = psf.n, m = nc * ns;
  const int rows = nc / C, cols = ns / C, tile = nc * cols;
  const int Pr = ns | 1;
  const int r0 = rank * rows, c0 = rank * cols;
  const long long base = (long long)(blockIdx.x / C) * n;
  float2* buf = smem;
  // the tables after the tile: the four plans', then the twiddle's; their
  // places are found again where they are used, not held through a pass
  float2* tables = buf + rows * Pr;
  const int ntab = len.cf + len.sf + len.si + len.ci + walk::kTwLo +
                   (m + walk::kTwLo - 1) / walk::kTwLo;
  for (int t = threadIdx.x; t < ntab; t += blockDim.x) {
    int u = t;
    const float2* src = tcf;
    if (u >= len.cf) { u -= len.cf; src = tsf;
      if (u >= len.sf) { u -= len.sf; src = tsi;
        if (u >= len.si) { u -= len.si; src = tci;
          if (u >= len.ci) { u -= len.ci; src = tw; } } } }
    tables[t] = __ldg(&src[u]);
  }
  // 1. the column tile of the padded line, times the chirp
  const walk::Div dcols = walk::make_div(cols);
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const int kc = walk::quot(t, dcols);
    const int k = kc * ns + c0 + t - kc * cols;
    float2 v = make_float2(0.f, 0.f);
    if (k < n) v = cmul(make_float2(xr[base + k], xi[base + k]), __ldg(&chirp[k]));
    buf[t] = v;
  }
  __syncthreads();
  // 2-8. the nc stages down the columns (the twiddle w_m^(kc*js) on their
  // last), the ns stages along the rows (the spectrum on their last), the
  // inverse ns stages (the conjugate twiddle on their last), the inverse
  // nc stages; one call site of run_pass keeps one copy of each stage
  for (int k = 0; k < 4; ++k) {
    const bool col = k == 0 || k == 3;
    if (k == 1) pull_rows(cluster, buf, ns, rows, cols, Pr, r0);
    if (k == 3) push_columns(cluster, buf, ns, rows, cols, Pr, r0);
    const walk::Pass g = col ? walk::Pass{cols, 0, 1, cols, dcols}
                             : walk::Pass{rows, 0, Pr, 1, walk::make_div(rows)};
    const int mode = k == 0   ? kHookTwiddle
                     : k == 1 ? kHookSpectrum
                     : k == 2 ? kHookTwiddleConj
                              : kHookNone;
    const float2* tab = smem + rows * Pr + (k > 0 ? len.cf : 0) +
                        (k > 1 ? len.sf : 0) + (k > 2 ? len.si : 0);
    const float2* tlo = smem + rows * Pr + len.cf + len.sf + len.si + len.ci;
    const ConvHook h{k == 1 ? spec : tlo, col ? c0 : r0, ns << 2 | mode};
    walk::run_pass(buf, g, k == 0 ? pcf : k == 1 ? psf : k == 2 ? psi : pci,
                   tab, h);
  }
  // 9. the crop and the chirp
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const int jc = walk::quot(t, dcols);
    const int k = jc * ns + c0 + t - jc * cols;
    if (k < n) {
      const float2 v = cmul(buf[t], __ldg(&chirp[k]));
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

// Shared bytes of a Bluestein block: its tile at the row pitch ns | 1,
// the four stage tables and the twiddle's two root tables.
size_t pair_smem(int nc, int ns, int cluster, const Lens& len) {
  const int m = nc * ns;
  return sizeof(float2) *
         ((size_t)(nc / cluster) * (ns | 1) + len.cf + len.sf + len.si +
          len.ci + walk::kTwLo + (m + walk::kTwLo - 1) / walk::kTwLo);
}

// Whether (cluster, threads, smem) is the layout of an (nc, ns) plane
// (cuda_kernels.conv_pair_layout): every stage's round holds a whole
// sequence, a thread moves at most kXchg points of an exchange, and the
// shared bytes are exact.
bool pair_layout_ok(const Plan& pcf, const Plan& psf, const Plan& psi,
                    const Plan& pci, int cluster, int threads, int smem,
                    const Lens& len) {
  const int nc = pcf.n, ns = psf.n;
  return cluster_ok(cluster, nc, ns) && threads >= 32 &&
         threads <= kPairThreads && threads % 32 == 0 &&
         nc / cluster * ns <= kXchg * threads &&
         walk::rounds_fit(pcf, threads) && walk::rounds_fit(psf, threads) &&
         walk::rounds_fit(psi, threads) && walk::rounds_fit(pci, threads) &&
         smem >= 0 && (size_t)smem == pair_smem(nc, ns, cluster, len) &&
         smem <= vkfft::kMaxSmemBytes;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  Plans (int form) and stage tables (no scale) of the nc
// forward, ns forward, ns inverse and nc inverse runs; `twiddle` the
// four-step twiddle's two root tables, 64 points w_m^b then ceil(m / 64)
// points w_m^(64 a); `spectrum` the (nc, ns) table [kc][ks] = FFT_m(b)[ks*nc
// + kc] * scale / m; `chirp` the n-point chirp, all as interleaved fp32
// pairs.  The layout (cuda_kernels.conv_pair_layout): `cluster` blocks a
// line (1, 2, 4, 8 or 16, dividing nc and ns), `threads` a block and the
// dynamic shared bytes, exactly; any other layout is refused
// (cudaErrorInvalidValue).
int vk_fft_conv_pair(const float* xr, const float* xi, float* yr, float* yi,
                     long long batch, int n, const int* plan_cf,
                     const int* plan_sf, const int* plan_si, const int* plan_ci,
                     const float* table_cf, const float* table_sf,
                     const float* table_si, const float* table_ci,
                     const float* twiddle, const float* spectrum,
                     const float* chirp, int cluster, int threads, int smem,
                     void* stream) {
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
  const Lens len{walk::table_len(pcf), walk::table_len(psf),
                 walk::table_len(psi), walk::table_len(pci)};
  if (!pair_layout_ok(pcf, psf, psi, pci, cluster, threads, smem, len))
    return (int)cudaErrorInvalidValue;
  return launch_cluster(
      fft_conv_pair_kernel, batch, cluster, threads, (size_t)smem,
      stream, xr, xi, yr, yi, n, pcf, psf, psi, pci,
      reinterpret_cast<const float2*>(table_cf), reinterpret_cast<const float2*>(table_sf),
      reinterpret_cast<const float2*>(table_si), reinterpret_cast<const float2*>(table_ci),
      reinterpret_cast<const float2*>(twiddle), reinterpret_cast<const float2*>(spectrum),
      reinterpret_cast<const float2*>(chirp), len);
}

// Resident clusters on the card and blocks an SM of the Bluestein kernel
// at `cluster` blocks of `threads` with `smem` dynamic shared bytes, into
// *clusters and *blocks.
int vk_fft_conv_pair_occupancy(int cluster, int threads, int smem,
                               int* clusters, int* blocks) {
  if (!cluster_ok(cluster, cluster, cluster) || threads < 32 ||
      threads > kPairThreads || smem < 0 || clusters == nullptr ||
      blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  return vkfft::cluster::cluster_occupancy(fft_conv_pair_kernel, cluster,
                                           threads, smem, clusters, blocks);
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
      fft_conv2d_kernel, batch, cluster, count > 2048 ? 512 : 256,
      2 * (size_t)count * sizeof(float2),
      stream, xr, xi, yr, yi, hp, flags, pzf, pyf, pyi, pzi,
      reinterpret_cast<const float2*>(table_zf), reinterpret_cast<const float2*>(table_yf),
      reinterpret_cast<const float2*>(table_yi), reinterpret_cast<const float2*>(table_zi),
      reinterpret_cast<const float2*>(spectrum));
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
