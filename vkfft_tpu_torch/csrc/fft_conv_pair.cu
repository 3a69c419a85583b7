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
// 2-D mode.  Bound: bytes, 16 B a point read and written once and the
// spectrum once a launch (16 MiB at hp = 32, (256, 256)): the two 2-D FFTs
// of a 256 x 256 plane are ~1.3 Mflop for 1 MB of traffic.  Design:
// fft_pair.cu's plane, held once over a cluster of C blocks on the walk,
// there and back in one launch: block `rank` reads its row tile (rows
// [rank*ny/C, ...), one contiguous run of device memory) by cp.async
// straight to its places at the odd pitch n1z | 1, runs the nz stages
// along its rows, pushes the tile in whole rounds to the column tiles
// (columns [rank*nz/C, ...), all ny rows) by 32-bit shared::cluster
// addresses, runs the ny stages down its columns, multiplies in one sweep
// by the spectrum in natural (ky, kz) order (Im negated first under
// kConjData; under kXpow divided by max(|Y|, 1e-30), the pair kernel's
// own form, :2288; the caller's scale), runs the ny stages and pulls the
// row tile back out of the column tiles, runs the nz stages and writes the
// row tile it read by float4 stores.  The inverse is the forward DFT of
// the conjugated data (the sweep conjugates, the write conjugates back),
// so the block holds one stage table a factor and one twiddle an axis, the
// same shared bytes as fft_pair's block.  An axis whose stages do not fit
// a round of the block's threads runs as two factors, as in fft_pair.cu:
// the forward in its order (natural in, the factors' transposed order
// out), which the exchange and the sweep's natural index follow, and back
// mirrored (the row pass first: transposed order in, natural out).  The
// sweep, not a hook on the y axis's last stage: that stage's hook sees a
// sequence's index within its column, not the column, where the spectrum
// wants both.  cuda_kernels.conv2d_layout is the one layout rule (the C
// entry refuses any other): fft_pair's cluster, threads and exact shared
// bytes, with at most kOddXchg points a thread of an exchange where a
// column tile's width is odd.  The geometry comes from the host
// (PlaneGeo), read where it is used.  Each block writes only what it read, and every read of a plane
// precedes the first cluster barrier, so the output may alias the input.
//
// Half storage of the Bluestein mode (fft_conv_pair_f16_kernel,
// fft_conv_pair_bf16_kernel; C entries vk_fft_conv_pair_f16,
// vk_fft_conv_pair_bf16): the same body, layout, cluster and bound on
// __half or __nv_bfloat16 lines, 8 B a point of device memory where fp32
// moves 16.  Only the line's read (each real widened, then times the
// chirp) and its cropped write (times the chirp, then narrowed once, to
// nearest even) change; the plane, its float2 exchanges, the tables and
// every stage stay fp32.
//
// Half storage of the 2-D mode (fft_conv2d_f16_kernel,
// fft_conv2d_bf16_kernel; C entries vk_fft_conv2d_f16, vk_fft_conv2d_bf16):
// the same body (conv2d_block), bounds, layout and cluster on __half or
// __nv_bfloat16 planes, 8 B a point of device memory where fp32 moves 16.
// The row tile comes in through registers in groups of four halves (8
// bytes) a plane, each widened (cp.async has no 2-byte copy), and goes out
// by store_lines narrowed to nearest even, 8 bytes a plane at once; the
// stages, the cluster exchanges, the multiply, the spectrum and the tables
// stay fp32.
//
// Zero-pad windows of the 2-D mode (fft_conv2d_zp_kernel and its half
// twins; C entries vk_fft_conv2d_zp, vk_fft_conv2d_zp_f16,
// vk_fft_conv2d_zp_bf16; inplace.cuh's PairWindow): _conv_pair_kernel's
// in_keep / out_keep.  The row tile reads only the (ky, kz) corner of its
// plane, in place from full planes or from cropped ones at their pitches,
// point by point, and holds zeros elsewhere, so the exchanges move whole
// rows as unwindowed; the rows past ky skip the forward's z stages, the
// rows past oy the inverse's, and only the (oy, oz) corner is written, at
// the output's pitches.  The same body (conv2d_block<true>), so the
// unwindowed kernels compile as before.
//
// Bluestein's read window (fft_conv_pair_zp_kernel and its half twins; C
// entries vk_fft_conv_pair_zp, vk_fft_conv_pair_zp_f16,
// vk_fft_conv_pair_zp_bf16): _conv_pair_kernel's in_keep in its Bluestein
// form.  Step 1 reads the points k < keep of each line at the line pitch
// n (the pitch and the read bound are two numbers) and holds zeros past
// them; step 9 still writes k < n.  Every stage reads all of its inputs:
// a first stage pruned to the live rows saved nothing (PERF.md section
// 6).  The same body (conv_pair_block<St, true>), so the unwindowed
// kernels compile as before.
#include <cooperative_groups.h>

#include "cluster.cuh"
#include "inplace.cuh"

namespace cg = cooperative_groups;

namespace {

using vkfft::Plan;
using vkfft::cmul;

namespace walk = vkfft::walk;

using vkfft::cluster::kXchg;  // most points a thread moves in an exchange
using vkfft::cluster::block_rank;
using vkfft::cluster::cluster_ok;
using vkfft::cluster::copy_plane_tables;
using vkfft::cluster::ld_remote2;
using vkfft::cluster::ld_remote4;
using vkfft::cluster::launch_cluster;
using vkfft::cluster::plane_index;
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

// The Bluestein block body on lines of storage type St (float, or a half
// type on the same fp32 plane).  With kWindow, Bluestein's read window:
// the points k < keep of each line read, the rest zeros.
template <class St, bool kWindow = false>
__device__ __forceinline__ void conv_pair_block(
    float2* smem, const St* xr, const St* xi, St* yr, St* yi, int n,
    const Plan& pcf, const Plan& psf, const Plan& psi, const Plan& pci,
    const float2* tcf, const float2* tsf, const float2* tsi,
    const float2* tci, const float2* tw, const float2* spec,
    const float2* chirp, const Lens& len, int keep = 0) {
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
    if (k < (kWindow ? keep : n))
      v = cmul(make_float2(walk::widen(xr[base + k]), walk::widen(xi[base + k])),
               __ldg(&chirp[k]));
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
      walk::put(yr[base + k], v.x);
      walk::put(yi[base + k], v.y);
    }
  }
}

__global__ void __launch_bounds__(kPairThreads, kPairMinBlocks)
fft_conv_pair_kernel(const float* xr, const float* xi, float* yr, float* yi,
                     int n, Plan pcf, Plan psf, Plan psi, Plan pci,
                     const float2* tcf, const float2* tsf, const float2* tsi,
                     const float2* tci, const float2* tw, const float2* spec,
                     const float2* chirp, Lens len) {
  extern __shared__ __align__(16) float2 smem[];
  conv_pair_block(smem, xr, xi, yr, yi, n, pcf, psf, psi, pci, tcf, tsf, tsi,
                  tci, tw, spec, chirp, len);
}

__global__ void __launch_bounds__(kPairThreads, kPairMinBlocks)
fft_conv_pair_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                         __half* yi, int n, Plan pcf, Plan psf, Plan psi,
                         Plan pci, const float2* tcf, const float2* tsf,
                         const float2* tsi, const float2* tci,
                         const float2* tw, const float2* spec,
                         const float2* chirp, Lens len) {
  extern __shared__ __align__(16) float2 smem[];
  conv_pair_block(smem, xr, xi, yr, yi, n, pcf, psf, psi, pci, tcf, tsf, tsi,
                  tci, tw, spec, chirp, len);
}

__global__ void __launch_bounds__(kPairThreads, kPairMinBlocks)
fft_conv_pair_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                          __nv_bfloat16* yr, __nv_bfloat16* yi, int n,
                          Plan pcf, Plan psf, Plan psi, Plan pci,
                          const float2* tcf, const float2* tsf,
                          const float2* tsi, const float2* tci,
                          const float2* tw, const float2* spec,
                          const float2* chirp, Lens len) {
  extern __shared__ __align__(16) float2 smem[];
  conv_pair_block(smem, xr, xi, yr, yi, n, pcf, psf, psi, pci, tcf, tsf, tsi,
                  tci, tw, spec, chirp, len);
}

// Bluestein's read window: conv_pair_block<St, true>, the points k < keep
// of each line read.
__global__ void __launch_bounds__(kPairThreads, kPairMinBlocks)
fft_conv_pair_zp_kernel(const float* xr, const float* xi, float* yr,
                        float* yi, int n, Plan pcf, Plan psf, Plan psi,
                        Plan pci, const float2* tcf, const float2* tsf,
                        const float2* tsi, const float2* tci,
                        const float2* tw, const float2* spec,
                        const float2* chirp, Lens len, int keep) {
  extern __shared__ __align__(16) float2 smem[];
  conv_pair_block<float, true>(smem, xr, xi, yr, yi, n, pcf, psf, psi, pci,
                               tcf, tsf, tsi, tci, tw, spec, chirp, len,
                               keep);
}

__global__ void __launch_bounds__(kPairThreads, kPairMinBlocks)
fft_conv_pair_zp_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                            __half* yi, int n, Plan pcf, Plan psf, Plan psi,
                            Plan pci, const float2* tcf, const float2* tsf,
                            const float2* tsi, const float2* tci,
                            const float2* tw, const float2* spec,
                            const float2* chirp, Lens len, int keep) {
  extern __shared__ __align__(16) float2 smem[];
  conv_pair_block<__half, true>(smem, xr, xi, yr, yi, n, pcf, psf, psi, pci,
                                tcf, tsf, tsi, tci, tw, spec, chirp, len,
                                keep);
}

__global__ void __launch_bounds__(kPairThreads, kPairMinBlocks)
fft_conv_pair_zp_bf16_kernel(const __nv_bfloat16* xr,
                             const __nv_bfloat16* xi, __nv_bfloat16* yr,
                             __nv_bfloat16* yi, int n, Plan pcf, Plan psf,
                             Plan psi, Plan pci, const float2* tcf,
                             const float2* tsf, const float2* tsi,
                             const float2* tci, const float2* tw,
                             const float2* spec, const float2* chirp,
                             Lens len, int keep) {
  extern __shared__ __align__(16) float2 smem[];
  conv_pair_block<__nv_bfloat16, true>(smem, xr, xi, yr, yi, n, pcf, psf,
                                       psi, pci, tcf, tsf, tsi, tci, tw, spec,
                                       chirp, len, keep);
}

constexpr int kConjData = 1;
constexpr int kXpow = 2;

// The 2-D mode: fft_pair.cu's plane on the walk, there and back.
// Most threads a block; the bound holds the kernel to 64 registers, as
// fft_pair_kernel's does.
constexpr int kPlaneThreads = 1024;
// Most points a thread moves in an exchange of single points (a column
// tile of odd width): kXchg of them and their indices spilled.
constexpr int kOddXchg = kXchg / 2;

// Where a 2-D block's pieces sit, computed once by the host and read from
// the kernel's parameters where they are used (not held in registers
// through a pass or an exchange): the plane's ny and nz, the row tile's
// rows and the column tile's columns, a tile's points, the z factors'
// pitch n1z | 1 and a row's stride n2z * (n1z | 1), the points of the
// tile area (the tables after it: the four plans' stage tables, then the
// z and the y twiddles), each plan's table offset and each twiddle's, the
// exchanges' divisors and derived counts, and the multiply's spectra,
// flags and scale.
struct PlaneGeo {
  int ny, nz, rows, cols, tile, pz, sz, area;   // tile: rows * nz = ny * cols
  int nzh, ch, last, hlast;   // nz / 2, cols / 2, tile - 1, tile / 2 - 1
  int z2, y1, y2;   // the stage tables of z2, y1, y2 (z1's at 0)
  int twz, twy;     // the twiddles' tables
  int ntab;
  int hp, flags;
  float scale;
  walk::Div dnz, dhnz, dcols, dhcols;   // nz, nz / 2, cols, cols / 2
  walk::Div dz2, dy1;                   // the factors n2z, n1y
};

// Pass k of the 2-D mode's eight: the z axis along the row tile (row r at
// r * sz, point j2 * n1 + j1 at j2 * pz + j1), then the y axis down the
// column tile (column c at c, point j at j * cols), each as a column pass
// (the n2-point DFTs) and a row pass (the n1-point DFTs), in the forward's
// order (natural in, the factors' transposed order out, the twiddle on the
// column pass's last stage), then y and z again mirrored (the row pass
// first, the twiddle on its last stage: transposed order in, natural out).
// Every pass runs the forward plans: the inverse is the forward DFT of the
// conjugated data, conjugated again on the write.
// With kWindow, the z passes run `zrows` rows of the row tile (the others
// hold zeros, or rows the window does not write).
template <bool kWindow = false>
__device__ __forceinline__ void plane_pass(float2* smem, const PlaneGeo& geo,
                                           int k, const Plan& pz1,
                                           const Plan& pz2, const Plan& py1,
                                           const Plan& py2, int zrows = 0) {
  const bool y = k >= 2 && k < 6, mirrored = k >= 4;
  const bool row = ((k & 1) != 0) != mirrored;
  const int n1 = y ? py1.n : pz1.n, n2 = y ? py2.n : pz2.n;
  const int rows = kWindow ? zrows : geo.rows;
  const walk::Pass g =
      y ? (row ? walk::Pass{geo.cols * n2, 1, n1 * geo.cols, geo.cols,
                            walk::make_div(n2)}
               : walk::Pass{geo.cols * n1, 1, geo.cols, n1 * geo.cols,
                            walk::make_div(n1)})
        : (row ? walk::Pass{rows * n2, geo.sz, geo.pz, 1, walk::make_div(n2)}
               : walk::Pass{rows * n1, geo.sz, 1, geo.pz, walk::make_div(n1)});
  const float2* tlo = smem + geo.area + (y ? geo.twy : geo.twz);
  const bool fuse = n2 > 1 && row == mirrored;
  const int which = (y ? 2 : 0) + (row ? 0 : 1);
  walk::run_pass(
      smem, g, which == 0 ? pz1 : which == 1 ? pz2 : which == 2 ? py1 : py2,
      smem + geo.area + (which == 0   ? 0
                         : which == 1 ? geo.z2
                         : which == 2 ? geo.y1
                                      : geo.y2),
      walk::InterTwiddle{fuse ? tlo : nullptr, tlo + walk::kTwLo});
}

// Row tile -> column tiles: point kz of row r of this block's row tile, at
// zat(r, kz), goes to point (r0 + r, kz % cols) of owner kz / cols's
// column tile (pitch cols).  Each thread reads its points (pairs along kz
// when cols is even, else at most kOddXchg points) into registers, the
// cluster meets (every row tile is read), it stores them, and the cluster
// meets again.
__device__ void push_plane_columns(cg::cluster_group& cluster, float2* buf,
                                   const PlaneGeo& geo) {
  const int T = blockDim.x;
  const walk::RowAt zat{geo.dz2, geo.sz, geo.pz};
  if ((geo.cols & 1) == 0) {
    float4 v[kXchg / 2];
#pragma unroll
    for (int j = 0; j < kXchg / 2; ++j) {
      const int p = min(walk::fresh_tid() + j * T, geo.hlast);
      const int r = walk::quot(p, geo.dhnz);
      const int kz = 2 * (p - r * geo.nzh);
      const float2 a = buf[zat(r, kz)], b = buf[zat(r, kz + 1)];
      v[j] = make_float4(a.x, a.y, b.x, b.y);
    }
    cluster.sync();   // every row tile is read: the buffers are free
    const int r0 = block_rank() * geo.rows;
#pragma unroll
    for (int j = 0; j < kXchg / 2; ++j) {
      const int v0 = walk::fresh_tid() + j * T;
      const int p = min(v0, geo.hlast);
      const int r = walk::quot(p, geo.dhnz);
      const int k2 = p - r * geo.nzh;   // the pair's index along the row
      const int owner = walk::quot(k2, geo.dhcols);
      if (v0 <= geo.hlast)
        st_remote4(remote(buf, 2 * ((r0 + r) * geo.ch + k2 - owner * geo.ch),
                          owner), v[j]);
    }
  } else {
    float2 v[kOddXchg];
#pragma unroll
    for (int j = 0; j < kOddXchg; ++j) {
      const int u = min(walk::fresh_tid() + j * T, geo.last);
      const int r = walk::quot(u, geo.dnz);
      v[j] = buf[zat(r, u - r * geo.nz)];
    }
    cluster.sync();   // every row tile is read: the buffers are free
    const int r0 = block_rank() * geo.rows;
#pragma unroll
    for (int j = 0; j < kOddXchg; ++j) {
      const int u0 = walk::fresh_tid() + j * T;
      const int u = min(u0, geo.last);
      const int r = walk::quot(u, geo.dnz);
      const int kz = u - r * geo.nz;
      const int owner = walk::quot(kz, geo.dcols);
      if (u0 <= geo.last)
        st_remote2(remote(buf, (r0 + r) * geo.cols + kz - owner * geo.cols,
                          owner), v[j]);
    }
  }
  cluster.sync();   // every push has landed
}

// Column tiles -> row tile: point kz of row r of this block's row tile,
// at zat(r, kz), is point (r0 + r, kz % cols) of owner kz / cols's column
// tile.  The cluster meets (every block's columns are done), each thread
// pulls its points (pairs along kz when cols is even, else at most
// kOddXchg points) into registers, the cluster meets (every pull is done:
// the column tiles are free), and it writes them.
__device__ void pull_plane_rows(cg::cluster_group& cluster, float2* buf,
                                const PlaneGeo& geo) {
  const int T = blockDim.x;
  cluster.sync();   // every block's columns are done
  if ((geo.cols & 1) == 0) {
    const int r0 = block_rank() * geo.rows;
    float4 v[kXchg / 2];
#pragma unroll
    for (int j = 0; j < kXchg / 2; ++j) {
      const int p = min(walk::fresh_tid() + j * T, geo.hlast);
      const int r = walk::quot(p, geo.dhnz);
      const int k2 = p - r * geo.nzh;
      const int owner = walk::quot(k2, geo.dhcols);
      v[j] = ld_remote4(remote(
          buf, 2 * ((r0 + r) * geo.ch + k2 - owner * geo.ch), owner));
    }
    cluster.sync();   // every pull is done: the column tiles are free
    const walk::RowAt zat{geo.dz2, geo.sz, geo.pz};
#pragma unroll
    for (int j = 0; j < kXchg / 2; ++j) {
      const int v0 = walk::fresh_tid() + j * T;
      const int p = min(v0, geo.hlast);
      const int r = walk::quot(p, geo.dhnz);
      const int kz = 2 * (p - r * geo.nzh);
      if (v0 <= geo.hlast) {
        buf[zat(r, kz)] = make_float2(v[j].x, v[j].y);
        buf[zat(r, kz + 1)] = make_float2(v[j].z, v[j].w);
      }
    }
  } else {
    const int r0 = block_rank() * geo.rows;
    float2 v[kOddXchg];
#pragma unroll
    for (int j = 0; j < kOddXchg; ++j) {
      const int u = min(walk::fresh_tid() + j * T, geo.last);
      const int r = walk::quot(u, geo.dnz);
      const int kz = u - r * geo.nz;
      const int owner = walk::quot(kz, geo.dcols);
      v[j] = ld_remote2(
          remote(buf, (r0 + r) * geo.cols + kz - owner * geo.cols, owner));
    }
    cluster.sync();   // every pull is done: the column tiles are free
    const walk::RowAt zat{geo.dz2, geo.sz, geo.pz};
#pragma unroll
    for (int j = 0; j < kOddXchg; ++j) {
      const int u0 = walk::fresh_tid() + j * T;
      const int u = min(u0, geo.last);
      const int r = walk::quot(u, geo.dnz);
      if (u0 <= geo.last) buf[zat(r, u - r * geo.nz)] = v[j];
    }
  }
  __syncthreads();
}

// The multiply, one sweep over the column tile between the forward and
// the inverse passes: point c of the row at place q (ky = k1 * n2y + k2
// at q = k2 * n1y + k1) is Y(ky, c0 + c), conjugated under kConjData,
// times spectrum b % hp at (ky, c0 + c) in natural order, divided by
// max(|.|, 1e-30) under kXpow, times the scale, and conjugated for the
// inverse, which runs the forward stages.
__device__ void multiply_spectrum(float2* buf, const PlaneGeo& geo, int n2y,
                                  const float2* spec) {
  const float2* h = spec + (plane_index() % geo.hp) * geo.ny * geo.nz +
                    block_rank() * geo.cols;
  const int n1y = (int)geo.dy1.d;
#pragma unroll 4
  for (int u = threadIdx.x; u < geo.tile; u += blockDim.x) {
    const int q = walk::quot(u, geo.dcols);
    const int k2 = walk::quot(q, geo.dy1);
    const int ky = (q - k2 * n1y) * n2y + k2;
    float2 x = buf[u];
    if (geo.flags & kConjData) x.y = -x.y;
    float2 y = cmul(x, __ldg(h + ky * geo.nz + u - q * geo.cols));
    if (geo.flags & kXpow) {
      const float s = 1.f / fmaxf(sqrtf(y.x * y.x + y.y * y.y), 1e-30f);
      y = make_float2(y.x * s, y.y * s);
    }
    buf[u] = make_float2(geo.scale * y.x, -geo.scale * y.y);
  }
  __syncthreads();
}

// A point conjugated on its way out: the end of the inverse.
struct Conj {
  __device__ __forceinline__ float2 operator()(float2 v, int, int) const {
    return make_float2(v.x, -v.y);
  }
};

// The row tile under a window: rows r0 + r < w.oy, columns z < w.oz of
// plane b, at b * out_plane + (r0 + r) * out_row + z, conjugated (the end
// of the inverse), point by point, narrowed to the planes' storage type.
template <class St>
__device__ void store_rows_window(const float2* buf, const PlaneGeo& geo,
                                  const walk::Map& mp, St* yr, St* yi,
                                  const walk::PairWindow& w) {
  const int r0 = block_rank() * geo.rows;
  const int live = min(geo.rows, w.oy - r0);
  if (live <= 0) return;
  const walk::Div dz = walk::make_div(w.oz);
  const long long g0 = plane_index() * w.out_plane + (long long)r0 * w.out_row;
  for (int u = threadIdx.x; u < live * w.oz; u += blockDim.x) {
    const int r = walk::quot(u, dz);
    const int z = u - r * w.oz;
    const float2 v = buf[walk::position(r * geo.nz + z, mp)];
    const long long g = g0 + (long long)r * w.out_row + z;
    walk::put(yr[g], v.x);
    walk::put(yi[g], -v.y);
  }
}

// The 2-D block body on planes of storage type St (float, or a half type
// on the same fp32 plane: the row tile read through registers, as
// cp.async has no 2-byte copy, each real widened, and written by
// store_lines narrowed to nearest even).
template <bool kWindow = false, class St>
__device__ __forceinline__ void conv2d_block(
    float2* smem, const St* xr, const St* xi, St* yr, St* yi, const Plan& pz1,
    const Plan& pz2, const Plan& py1, const Plan& py2, const float2* tz1,
    const float2* tz2, const float2* ty1, const float2* ty2,
    const float2* twz, const float2* twy, const float2* spec,
    const PlaneGeo& geo, const walk::PairWindow& w = walk::PairWindow{}) {
  cg::cluster_group cluster = cg::this_cluster();
  copy_plane_tables(smem + geo.area, geo, tz1, tz2, ty1, ty2, twz, twy);
  // the row tile in natural order, one contiguous run (under a window, its
  // (ky, kz) corner point by point, zeros elsewhere)
  if constexpr (kWindow)
    walk::load_rows_window(
        xr, xi, plane_index() * w.in_plane, block_rank() * geo.rows,
        geo.rows, w,
        walk::make_map(geo.nz, geo.sz, false, pz1.n, pz2.n, geo.pz), smem);
  else if constexpr (walk::kNarrow<St>)
    walk::load_lines(
        xr, xi, (plane_index() * geo.ny + (long long)block_rank() * geo.rows) *
                    geo.nz,
        geo.tile, walk::make_map(geo.nz, geo.sz, false, pz1.n, pz2.n, geo.pz),
        smem);
  else
    walk::load_lines_async(
        xr, xi, (plane_index() * geo.ny + (long long)block_rank() * geo.rows) *
                    geo.nz,
        geo.tile, walk::make_map(geo.nz, geo.sz, false, pz1.n, pz2.n, geo.pz),
        smem);
  __syncthreads();
  // the z axis, the exchange, the y axis, the multiply, the y axis and the
  // z axis mirrored with the exchange back between them; one call site of
  // run_pass keeps one copy of each stage
#pragma unroll 1
  for (int k = 0; k < 8; ++k) {
    if (k == 2) push_plane_columns(cluster, smem, geo);
    if (k == 4) multiply_spectrum(smem, geo, py2.n, spec);
    if (k == 6) pull_plane_rows(cluster, smem, geo);
    if constexpr (kWindow) {
      // the z passes of the rows the window reads (forward) or writes
      // (inverse); the rest hold zeros or are never written
      const int edge = k < 2 ? w.ky : k >= 6 ? w.oy : geo.ny;
      plane_pass<true>(smem, geo, k, pz1, pz2, py1, py2,
                       min(geo.rows, max(0, edge - block_rank() * geo.rows)));
    } else {
      plane_pass(smem, geo, k, pz1, pz2, py1, py2);
    }
  }
  if constexpr (kWindow)
    store_rows_window(
        smem, geo, walk::make_map(geo.nz, geo.sz, false, pz1.n, pz2.n, geo.pz),
        yr, yi, w);
  else
    walk::store_lines(
        smem, walk::make_map(geo.nz, geo.sz, false, pz1.n, pz2.n, geo.pz),
        yr, yi,
        (plane_index() * geo.ny + (long long)block_rank() * geo.rows) *
            geo.nz,
        geo.tile, Conj{});
}

__global__ void __launch_bounds__(kPlaneThreads, 1)
fft_conv2d_kernel(const float* xr, const float* xi, float* yr, float* yi,
                  Plan pz1, Plan pz2, Plan py1, Plan py2, const float2* tz1,
                  const float2* tz2, const float2* ty1, const float2* ty2,
                  const float2* twz, const float2* twy, const float2* spec,
                  PlaneGeo geo) {
  extern __shared__ __align__(16) float2 smem[];
  conv2d_block(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2, ty1, ty2,
               twz, twy, spec, geo);
}

__global__ void __launch_bounds__(kPlaneThreads, 1)
fft_conv2d_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                      __half* yi, Plan pz1, Plan pz2, Plan py1, Plan py2,
                      const float2* tz1, const float2* tz2, const float2* ty1,
                      const float2* ty2, const float2* twz, const float2* twy,
                      const float2* spec, PlaneGeo geo) {
  extern __shared__ __align__(16) float2 smem[];
  conv2d_block(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2, ty1, ty2,
               twz, twy, spec, geo);
}

__global__ void __launch_bounds__(kPlaneThreads, 1)
fft_conv2d_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                       __nv_bfloat16* yr, __nv_bfloat16* yi, Plan pz1,
                       Plan pz2, Plan py1, Plan py2, const float2* tz1,
                       const float2* tz2, const float2* ty1,
                       const float2* ty2, const float2* twz,
                       const float2* twy, const float2* spec, PlaneGeo geo) {
  extern __shared__ __align__(16) float2 smem[];
  conv2d_block(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2, ty1, ty2,
               twz, twy, spec, geo);
}

__global__ void __launch_bounds__(kPlaneThreads, 1)
fft_conv2d_zp_kernel(const float* xr, const float* xi, float* yr, float* yi,
                     Plan pz1, Plan pz2, Plan py1, Plan py2,
                     const float2* tz1, const float2* tz2, const float2* ty1,
                     const float2* ty2, const float2* twz, const float2* twy,
                     const float2* spec, PlaneGeo geo, walk::PairWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  conv2d_block<true>(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2, ty1,
                     ty2, twz, twy, spec, geo, w);
}

__global__ void __launch_bounds__(kPlaneThreads, 1)
fft_conv2d_zp_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                         __half* yi, Plan pz1, Plan pz2, Plan py1, Plan py2,
                         const float2* tz1, const float2* tz2,
                         const float2* ty1, const float2* ty2,
                         const float2* twz, const float2* twy,
                         const float2* spec, PlaneGeo geo,
                         walk::PairWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  conv2d_block<true>(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2, ty1,
                     ty2, twz, twy, spec, geo, w);
}

__global__ void __launch_bounds__(kPlaneThreads, 1)
fft_conv2d_zp_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                          __nv_bfloat16* yr, __nv_bfloat16* yi, Plan pz1,
                          Plan pz2, Plan py1, Plan py2, const float2* tz1,
                          const float2* tz2, const float2* ty1,
                          const float2* ty2, const float2* twz,
                          const float2* twy, const float2* spec, PlaneGeo geo,
                          walk::PairWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  conv2d_block<true>(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2, ty1,
                     ty2, twz, twy, spec, geo, w);
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

// The checks and the cluster launch of the Bluestein `kernel` on lines of
// storage type St, as vk_fft_conv_pair describes them; with kWindow, the
// windowed `kernel` reading the points k < in_keep of each line (1 <=
// in_keep <= n; 0 for all n).
template <bool kWindow = false, class St, typename K>
int launch_pair(K kernel, const St* xr, const St* xi, St* yr, St* yi,
                long long batch, int n, const int* plan_cf,
                const int* plan_sf, const int* plan_si, const int* plan_ci,
                const float* table_cf, const float* table_sf,
                const float* table_si, const float* table_ci,
                const float* twiddle, const float* spectrum,
                const float* chirp, int cluster, int threads, int smem,
                void* stream, int in_keep = 0) {
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
  if constexpr (kWindow) {
    if (in_keep < 0 || in_keep > n) return (int)cudaErrorInvalidValue;
    return launch_cluster(
        kernel, batch, cluster, threads, (size_t)smem,
        stream, xr, xi, yr, yi, n, pcf, psf, psi, pci,
        reinterpret_cast<const float2*>(table_cf), reinterpret_cast<const float2*>(table_sf),
        reinterpret_cast<const float2*>(table_si), reinterpret_cast<const float2*>(table_ci),
        reinterpret_cast<const float2*>(twiddle), reinterpret_cast<const float2*>(spectrum),
        reinterpret_cast<const float2*>(chirp), len, in_keep ? in_keep : n);
  } else {
    return launch_cluster(
        kernel, batch, cluster, threads, (size_t)smem,
        stream, xr, xi, yr, yi, n, pcf, psf, psi, pci,
        reinterpret_cast<const float2*>(table_cf), reinterpret_cast<const float2*>(table_sf),
        reinterpret_cast<const float2*>(table_si), reinterpret_cast<const float2*>(table_ci),
        reinterpret_cast<const float2*>(twiddle), reinterpret_cast<const float2*>(spectrum),
        reinterpret_cast<const float2*>(chirp), len);
  }
}

// Resident clusters and blocks an SM of the Bluestein `kernel`.
template <typename K>
int pair_occupancy(K kernel, int cluster, int threads, int smem,
                   int* clusters, int* blocks) {
  if (!cluster_ok(cluster, cluster, cluster) || threads < 32 ||
      threads > kPairThreads || smem < 0 || clusters == nullptr ||
      blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  return vkfft::cluster::cluster_occupancy(kernel, cluster, threads, smem,
                                           clusters, blocks);
}

// The layout of the 2-D mode's plans (cuda_kernels.conv2d_layout, fft_pair's
// plane) as a PlaneGeo, or false when (cluster, threads, smem) is not it:
// every stage's round holds a whole sequence, a thread moves at most kXchg
// points of an exchange (kOddXchg where the column tile's width is odd),
// and the shared bytes are exact.
bool plane_layout_of(const Plan& pz1, const Plan& pz2, const Plan& py1,
                     const Plan& py2, int cluster, int threads, int smem,
                     PlaneGeo* geo) {
  const int nz = pz1.n * pz2.n, ny = py1.n * py2.n;
  if (!cluster_ok(cluster, ny, nz) || threads < 32 ||
      threads > kPlaneThreads || threads % 32 != 0 ||
      (long long)ny * nz / cluster >
          (long long)(nz / cluster % 2 ? kOddXchg : kXchg) * threads ||
      !walk::rounds_fit(pz1, threads) || !walk::rounds_fit(pz2, threads) ||
      !walk::rounds_fit(py1, threads) || !walk::rounds_fit(py2, threads) ||
      smem < 0)
    return false;
  geo->ny = ny;
  geo->nz = nz;
  geo->rows = ny / cluster;
  geo->cols = nz / cluster;
  geo->tile = geo->rows * nz;
  geo->pz = pz1.n | 1;
  geo->sz = pz2.n * geo->pz;
  // the row tile as the z factors' rows (the column tile, ny * nz / C
  // points, fits it)
  geo->area = geo->rows * geo->sz;
  geo->nzh = nz / 2;
  geo->ch = geo->cols / 2;
  geo->last = geo->tile - 1;
  geo->hlast = geo->tile / 2 - 1;
  geo->z2 = walk::table_len(pz1);
  geo->y1 = geo->z2 + walk::table_len(pz2);
  geo->y2 = geo->y1 + walk::table_len(py1);
  geo->twz = geo->y2 + walk::table_len(py2);
  geo->twy = geo->twz + walk::rotation_points(nz);
  geo->ntab = geo->twy + walk::rotation_points(ny);
  geo->dnz = walk::make_div(nz);
  geo->dhnz = walk::make_div(nz / 2 > 0 ? nz / 2 : 1);
  geo->dcols = walk::make_div(geo->cols);
  geo->dhcols = walk::make_div(geo->cols / 2 > 0 ? geo->cols / 2 : 1);
  geo->dz2 = walk::make_div(pz2.n);
  geo->dy1 = walk::make_div(py1.n);
  return (size_t)smem == sizeof(float2) * ((size_t)geo->area + geo->ntab) &&
         smem <= vkfft::kMaxSmemBytes;
}

// The checks and the cluster launch of the 2-D `kernel` on planes of
// storage type St, as vk_fft_conv2d describes them.
// With kWindow, the windowed `kernel` under the PairWindow of `window` (its
// 8 ints), refused where it is not one.
template <bool kWindow = false, class St, typename K>
int launch_conv2d(K kernel, const St* xr, const St* xi, St* yr, St* yi,
                  long long planes, int hp, int flags, float scale,
                  const int* plan_z1, const int* plan_z2, const int* plan_y1,
                  const int* plan_y2, const float* table_z1,
                  const float* table_z2, const float* table_y1,
                  const float* table_y2, const float* twiddle_z,
                  const float* twiddle_y, const float* spectrum, int cluster,
                  int threads, int smem, void* stream,
                  const long long* window = nullptr) {
  Plan pz1, pz2, py1, py2;
  if (planes < 1 || hp < 1 || (flags & ~(kConjData | kXpow)) ||
      spectrum == nullptr || twiddle_z == nullptr || twiddle_y == nullptr ||
      !vkfft::plan_from_ints(plan_z1, &pz1) ||
      !vkfft::subplan_from_ints(plan_z2, &pz2) ||
      !vkfft::plan_from_ints(plan_y1, &py1) ||
      !vkfft::subplan_from_ints(plan_y2, &py2))
    return (int)cudaErrorInvalidValue;
  PlaneGeo geo;
  if (pz1.n < pz2.n || py1.n < py2.n || pz1.inverse || pz2.inverse ||
      py1.inverse || py2.inverse ||
      !plane_layout_of(pz1, pz2, py1, py2, cluster, threads, smem, &geo))
    return (int)cudaErrorInvalidValue;
  geo.hp = hp;
  geo.flags = flags;
  geo.scale = scale;
  if constexpr (kWindow) {
    walk::PairWindow w;
    if (!walk::pair_window_from_ints(window, geo.ny, geo.nz, &w))
      return (int)cudaErrorInvalidValue;
    return launch_cluster(
        kernel, planes, cluster, threads, (size_t)smem, stream, xr, xi, yr,
        yi, pz1, pz2, py1, py2, reinterpret_cast<const float2*>(table_z1),
        reinterpret_cast<const float2*>(table_z2),
        reinterpret_cast<const float2*>(table_y1),
        reinterpret_cast<const float2*>(table_y2),
        reinterpret_cast<const float2*>(twiddle_z),
        reinterpret_cast<const float2*>(twiddle_y),
        reinterpret_cast<const float2*>(spectrum), geo, w);
  } else {
    return launch_cluster(
        kernel, planes, cluster, threads, (size_t)smem, stream, xr, xi, yr,
        yi, pz1, pz2, py1, py2, reinterpret_cast<const float2*>(table_z1),
        reinterpret_cast<const float2*>(table_z2),
        reinterpret_cast<const float2*>(table_y1),
        reinterpret_cast<const float2*>(table_y2),
        reinterpret_cast<const float2*>(twiddle_z),
        reinterpret_cast<const float2*>(twiddle_y),
        reinterpret_cast<const float2*>(spectrum), geo);
  }
}

// Resident clusters and blocks an SM of the 2-D `kernel`.
template <typename K>
int conv2d_occupancy(K kernel, int cluster, int threads, int smem,
                     int* clusters, int* blocks) {
  if (!cluster_ok(cluster, cluster, cluster) || threads < 32 ||
      threads > kPlaneThreads || smem < 0 || clusters == nullptr ||
      blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  return vkfft::cluster::cluster_occupancy(kernel, cluster, threads, smem,
                                           clusters, blocks);
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
  return launch_pair(fft_conv_pair_kernel, xr, xi, yr, yi, batch, n, plan_cf,
                     plan_sf, plan_si, plan_ci, table_cf, table_sf, table_si,
                     table_ci, twiddle, spectrum, chirp, cluster, threads,
                     smem, stream);
}

// vk_fft_conv_pair on fp16 / bf16 lines (the tables, spectrum and chirp
// fp32, as vk_fft_conv_pair's).
int vk_fft_conv_pair_f16(const __half* xr, const __half* xi, __half* yr,
                         __half* yi, long long batch, int n,
                         const int* plan_cf, const int* plan_sf,
                         const int* plan_si, const int* plan_ci,
                         const float* table_cf, const float* table_sf,
                         const float* table_si, const float* table_ci,
                         const float* twiddle, const float* spectrum,
                         const float* chirp, int cluster, int threads,
                         int smem, void* stream) {
  return launch_pair(fft_conv_pair_f16_kernel, xr, xi, yr, yi, batch, n,
                     plan_cf, plan_sf, plan_si, plan_ci, table_cf, table_sf,
                     table_si, table_ci, twiddle, spectrum, chirp, cluster,
                     threads, smem, stream);
}

int vk_fft_conv_pair_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                          __nv_bfloat16* yr, __nv_bfloat16* yi,
                          long long batch, int n, const int* plan_cf,
                          const int* plan_sf, const int* plan_si,
                          const int* plan_ci, const float* table_cf,
                          const float* table_sf, const float* table_si,
                          const float* table_ci, const float* twiddle,
                          const float* spectrum, const float* chirp,
                          int cluster, int threads, int smem, void* stream) {
  return launch_pair(fft_conv_pair_bf16_kernel, xr, xi, yr, yi, batch, n,
                     plan_cf, plan_sf, plan_si, plan_ci, table_cf, table_sf,
                     table_si, table_ci, twiddle, spectrum, chirp, cluster,
                     threads, smem, stream);
}

// vk_fft_conv_pair under Bluestein's read window (fp32, fp16 and bf16
// lines): the points k < in_keep of each line are read at the line pitch
// n and the rest are declared zero, never read (1 <= in_keep <= n; 0 for
// all n); every n points of a line are written.
int vk_fft_conv_pair_zp(const float* xr, const float* xi, float* yr,
                        float* yi, long long batch, int n, const int* plan_cf,
                        const int* plan_sf, const int* plan_si,
                        const int* plan_ci, const float* table_cf,
                        const float* table_sf, const float* table_si,
                        const float* table_ci, const float* twiddle,
                        const float* spectrum, const float* chirp,
                        int cluster, int threads, int smem, int in_keep,
                        void* stream) {
  return launch_pair<true>(fft_conv_pair_zp_kernel, xr, xi, yr, yi, batch, n,
                           plan_cf, plan_sf, plan_si, plan_ci, table_cf,
                           table_sf, table_si, table_ci, twiddle, spectrum,
                           chirp, cluster, threads, smem, stream, in_keep);
}

int vk_fft_conv_pair_zp_f16(const __half* xr, const __half* xi, __half* yr,
                            __half* yi, long long batch, int n,
                            const int* plan_cf, const int* plan_sf,
                            const int* plan_si, const int* plan_ci,
                            const float* table_cf, const float* table_sf,
                            const float* table_si, const float* table_ci,
                            const float* twiddle, const float* spectrum,
                            const float* chirp, int cluster, int threads,
                            int smem, int in_keep, void* stream) {
  return launch_pair<true>(fft_conv_pair_zp_f16_kernel, xr, xi, yr, yi,
                           batch, n, plan_cf, plan_sf, plan_si, plan_ci,
                           table_cf, table_sf, table_si, table_ci, twiddle,
                           spectrum, chirp, cluster, threads, smem, stream,
                           in_keep);
}

int vk_fft_conv_pair_zp_bf16(const __nv_bfloat16* xr,
                             const __nv_bfloat16* xi, __nv_bfloat16* yr,
                             __nv_bfloat16* yi, long long batch, int n,
                             const int* plan_cf, const int* plan_sf,
                             const int* plan_si, const int* plan_ci,
                             const float* table_cf, const float* table_sf,
                             const float* table_si, const float* table_ci,
                             const float* twiddle, const float* spectrum,
                             const float* chirp, int cluster, int threads,
                             int smem, int in_keep, void* stream) {
  return launch_pair<true>(fft_conv_pair_zp_bf16_kernel, xr, xi, yr, yi,
                           batch, n, plan_cf, plan_sf, plan_si, plan_ci,
                           table_cf, table_sf, table_si, table_ci, twiddle,
                           spectrum, chirp, cluster, threads, smem, stream,
                           in_keep);
}

// Resident clusters on the card and blocks an SM of the Bluestein kernel
// at `cluster` blocks of `threads` with `smem` dynamic shared bytes, into
// *clusters and *blocks.
int vk_fft_conv_pair_occupancy(int cluster, int threads, int smem,
                               int* clusters, int* blocks) {
  return pair_occupancy(fft_conv_pair_kernel, cluster, threads, smem,
                        clusters, blocks);
}

int vk_fft_conv_pair_f16_occupancy(int cluster, int threads, int smem,
                                   int* clusters, int* blocks) {
  return pair_occupancy(fft_conv_pair_f16_kernel, cluster, threads, smem,
                        clusters, blocks);
}

int vk_fft_conv_pair_bf16_occupancy(int cluster, int threads, int smem,
                                    int* clusters, int* blocks) {
  return pair_occupancy(fft_conv_pair_bf16_kernel, cluster, threads, smem,
                        clusters, blocks);
}

// The 2-D mode; returns as vk_fft_conv_pair.  `planes` (ny, nz) planes;
// plans (int form) of the two factors of each axis, nz = z1 * z2 and ny =
// y1 * y2 (all forward; the second the empty plan of length 1 for one
// pass), their stage tables (no scale), and each axis's inter-factor
// twiddle as two tables (64 points w_n^b, then ceil(n / 64) points w_n^(64
// a)); `spectrum` the (hp, ny, nz) table in natural order, plane b
// multiplied by spectrum b % hp; all as interleaved fp32 pairs; `flags`
// kConjData | kXpow; `scale` the inverse's.  The layout
// (cuda_kernels.conv2d_layout): `cluster` blocks a plane (1, 2, 4, 8 or
// 16, dividing ny and nz), `threads` a block and the dynamic shared
// bytes, exactly; any other layout is refused (cudaErrorInvalidValue).
int vk_fft_conv2d(const float* xr, const float* xi, float* yr, float* yi,
                  long long planes, int hp, int flags, float scale,
                  const int* plan_z1, const int* plan_z2, const int* plan_y1,
                  const int* plan_y2, const float* table_z1,
                  const float* table_z2, const float* table_y1,
                  const float* table_y2, const float* twiddle_z,
                  const float* twiddle_y, const float* spectrum, int cluster,
                  int threads, int smem, void* stream) {
  return launch_conv2d(fft_conv2d_kernel, xr, xi, yr, yi, planes, hp, flags,
                       scale, plan_z1, plan_z2, plan_y1, plan_y2, table_z1,
                       table_z2, table_y1, table_y2, twiddle_z, twiddle_y,
                       spectrum, cluster, threads, smem, stream);
}

// vk_fft_conv2d on fp16 / bf16 planes (the tables and the spectrum fp32,
// as vk_fft_conv2d's), at its layout.
int vk_fft_conv2d_f16(const __half* xr, const __half* xi, __half* yr,
                      __half* yi, long long planes, int hp, int flags,
                      float scale, const int* plan_z1, const int* plan_z2,
                      const int* plan_y1, const int* plan_y2,
                      const float* table_z1, const float* table_z2,
                      const float* table_y1, const float* table_y2,
                      const float* twiddle_z, const float* twiddle_y,
                      const float* spectrum, int cluster, int threads,
                      int smem, void* stream) {
  return launch_conv2d(fft_conv2d_f16_kernel, xr, xi, yr, yi, planes, hp,
                       flags, scale, plan_z1, plan_z2, plan_y1, plan_y2,
                       table_z1, table_z2, table_y1, table_y2, twiddle_z,
                       twiddle_y, spectrum, cluster, threads, smem, stream);
}

int vk_fft_conv2d_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                       __nv_bfloat16* yr, __nv_bfloat16* yi, long long planes,
                       int hp, int flags, float scale, const int* plan_z1,
                       const int* plan_z2, const int* plan_y1,
                       const int* plan_y2, const float* table_z1,
                       const float* table_z2, const float* table_y1,
                       const float* table_y2, const float* twiddle_z,
                       const float* twiddle_y, const float* spectrum,
                       int cluster, int threads, int smem, void* stream) {
  return launch_conv2d(fft_conv2d_bf16_kernel, xr, xi, yr, yi, planes, hp,
                       flags, scale, plan_z1, plan_z2, plan_y1, plan_y2,
                       table_z1, table_z2, table_y1, table_y2, twiddle_z,
                       twiddle_y, spectrum, cluster, threads, smem, stream);
}

// vk_fft_conv2d under a zero-pad window (fp32, fp16 and bf16 planes):
// `window` points to the 8 ints of inplace.cuh's PairWindow (in_plane,
// out_plane, in_row, out_row, ky, kz, oy, oz).  Only the (ky, kz) corner of
// each input plane is read (the rest is declared zero) and only the (oy,
// oz) corner of each output plane is written, each at its pitches: a
// corner of wider planes, or compact.  A window that is not one is
// refused.
int vk_fft_conv2d_zp(const float* xr, const float* xi, float* yr, float* yi,
                     long long planes, int hp, int flags, float scale,
                     const int* plan_z1, const int* plan_z2,
                     const int* plan_y1, const int* plan_y2,
                     const float* table_z1, const float* table_z2,
                     const float* table_y1, const float* table_y2,
                     const float* twiddle_z, const float* twiddle_y,
                     const float* spectrum, int cluster, int threads, int smem,
                     const long long* window, void* stream) {
  return launch_conv2d<true>(fft_conv2d_zp_kernel, xr, xi, yr, yi, planes, hp,
                             flags, scale, plan_z1, plan_z2, plan_y1, plan_y2,
                             table_z1, table_z2, table_y1, table_y2,
                             twiddle_z, twiddle_y, spectrum, cluster, threads,
                             smem, stream, window);
}

int vk_fft_conv2d_zp_f16(const __half* xr, const __half* xi, __half* yr,
                         __half* yi, long long planes, int hp, int flags,
                         float scale, const int* plan_z1, const int* plan_z2,
                         const int* plan_y1, const int* plan_y2,
                         const float* table_z1, const float* table_z2,
                         const float* table_y1, const float* table_y2,
                         const float* twiddle_z, const float* twiddle_y,
                         const float* spectrum, int cluster, int threads,
                         int smem, const long long* window, void* stream) {
  return launch_conv2d<true>(fft_conv2d_zp_f16_kernel, xr, xi, yr, yi, planes,
                             hp, flags, scale, plan_z1, plan_z2, plan_y1,
                             plan_y2, table_z1, table_z2, table_y1, table_y2,
                             twiddle_z, twiddle_y, spectrum, cluster, threads,
                             smem, stream, window);
}

int vk_fft_conv2d_zp_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                          __nv_bfloat16* yr, __nv_bfloat16* yi,
                          long long planes, int hp, int flags, float scale,
                          const int* plan_z1, const int* plan_z2,
                          const int* plan_y1, const int* plan_y2,
                          const float* table_z1, const float* table_z2,
                          const float* table_y1, const float* table_y2,
                          const float* twiddle_z, const float* twiddle_y,
                          const float* spectrum, int cluster, int threads,
                          int smem, const long long* window, void* stream) {
  return launch_conv2d<true>(fft_conv2d_zp_bf16_kernel, xr, xi, yr, yi,
                             planes, hp, flags, scale, plan_z1, plan_z2,
                             plan_y1, plan_y2, table_z1, table_z2, table_y1,
                             table_y2, twiddle_z, twiddle_y, spectrum,
                             cluster, threads, smem, stream, window);
}

// Resident clusters on the card and blocks an SM of the 2-D mode's kernel
// at `cluster` blocks of `threads` with `smem` dynamic shared bytes, into
// *clusters and *blocks.
int vk_fft_conv2d_occupancy(int cluster, int threads, int smem,
                            int* clusters, int* blocks) {
  return conv2d_occupancy(fft_conv2d_kernel, cluster, threads, smem,
                          clusters, blocks);
}

int vk_fft_conv2d_f16_occupancy(int cluster, int threads, int smem,
                                int* clusters, int* blocks) {
  return conv2d_occupancy(fft_conv2d_f16_kernel, cluster, threads, smem,
                          clusters, blocks);
}

int vk_fft_conv2d_bf16_occupancy(int cluster, int threads, int smem,
                                 int* clusters, int* blocks) {
  return conv2d_occupancy(fft_conv2d_bf16_kernel, cluster, threads, smem,
                          clusters, blocks);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
