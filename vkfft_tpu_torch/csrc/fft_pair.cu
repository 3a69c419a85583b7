// fft_pair: 2-D C2C FFT of the two minor axes of (B, ny, nz) fp32 re/im
// planes in one pass, natural order in and out, times a scale (in the y
// axis's twiddle table).  Replaces vkfft_tpu/ops/pallas_engine.py:1982
// _pair_kernel (the fp32 form; in the windowed entries below, its corner
// in_keep / out_keep windows; in the tl entries, its tl_in / tl_out
// layout, fft_pair_tl_planar).
//
// Bound: bytes, one read and one write of each point (16 B of planes) for
// both axes together, where two axis passes move twice that.
// Design: the TPU kernel holds a whole plane in VMEM; a 256 x 256 plane is
// 512 KB, more than one block's shared memory.  Here a thread-block
// cluster of C blocks holds the plane once, on the in-place walk of
// inplace.cuh (fft_conv_pair's Bluestein plane without chirp, twiddle or
// spectrum): block `rank` reads its row tile (rows [rank*ny/C, ...), one
// contiguous run of device memory) by cp.async straight to its places,
// runs the nz-point stages along its rows, exchanges the tiles with the
// other blocks in whole rounds by 32-bit shared::cluster addresses
// (cluster.cuh: each thread reads its points, the cluster meets, it
// stores them to their owners' column tiles), runs the ny-point stages
// down the columns of its column tile (columns [rank*nz/C, ...), all ny
// rows) and writes each row's nz/C points straight from the column tile
// (a second exchange back to the row tile, written as one contiguous run,
// measured 0.04-0.06 ms slower at 256 x 256 x 256; PERF.md).  An axis whose
// stages do not fit a round of the block's threads runs as two factors (a
// column pass, the twiddle, a row pass: two_factor_passes' forward order,
// in both directions, the inverse by its plans and conjugate twiddle
// alone), its points then in the factors' transposed order, which the
// exchange and the write follow.  The stage tables (radix 16,
// walk_radices) and the twiddles' root tables sit in shared memory; the
// block's geometry comes from the host in the parameters (Geo) and is read
// where it is used, so the walk's rounds keep their registers.
// cuda_kernels.pair_layout is the one layout rule (the C entry refuses any
// other): the cluster, the threads (a thread moves at most kXchg points of
// an exchange) and the exact shared bytes.  Every read of a plane precedes
// the first cluster barrier and every write follows the last, so the
// output may alias the input.
//
// fp64 (fft_pair_f64_kernel, C entry vk_fft_pair_f64): the same body on
// double planes and tables, a point 16 B of shared memory (pair_layout's
// rule in points, so 64 KB a block at 256 x 256 over a cluster of 16) and
// a double2 four registers.  A point is one 16-byte store of the exchange,
// so the fp64 kernel moves single points where fp32 packs pairs, each
// thread at most kXchg of them; its planes (pair_cluster at 32 B a point)
// have at most 4096 points a block, so at most kThreads64 threads, the
// bound leaving each 128 registers, on the fp64 walk (one generic item a
// round, no radix 16: inplace.cuh's kItems, kRadix16).
//
// Half storage (fft_pair_f16_kernel, fft_pair_bf16_kernel; C entries
// vk_fft_pair_f16, vk_fft_pair_bf16): the fp32 kernel's body, layout and
// bounds on __half or __nv_bfloat16 planes, 8 B a point of device memory
// where fp32 moves 16 (both axes together).  The tables, the tiles, the
// exchange of float2 points between the cluster's blocks and every stage
// stay fp32; the row tile comes in through registers (inplace.cuh's
// load_lines: cp.async has no 2-byte copy), each value widened, and the
// column tile goes out narrowed once, to nearest even (store_columns).
//
// Zero-pad windows (fft_pair_zp_kernel and its fp64 and half twins; C
// entries vk_fft_pair_zp, vk_fft_pair_zp_f64, vk_fft_pair_zp_f16,
// vk_fft_pair_zp_bf16; PairWindow): the row tile reads only the (ky, kz)
// corner of its plane, from cropped planes or from full ones (planes and
// rows at pitches of their own), and holds zeros elsewhere, so the
// exchange moves whole rows as it does unwindowed; the column tile writes
// only the (oy, oz) corner, into cropped planes or full ones.  Point by
// point (a corner's edge falls anywhere in a four-point group).  The rows
// of a row tile past ky hold zeros and skip the z stages.  The same body
// (pair_block<true>), so the unwindowed kernels compile as before.
//
// Kept intermediate order (fft_pair_tl_kernel and its half twins; C
// entries vk_fft_pair_tl, vk_fft_pair_tl_f16, vk_fft_pair_tl_bf16): the
// keep_intermediate_order form, the spectrum as the transposed (nz, ny)
// plane.  The forward writes each column tile as contiguous rows of the
// transposed plane, with no exchange back; the inverse reads its column
// tile contiguously from it, runs the ny stages first, pulls the row tiles
// back out of the column tiles (the reverse of the forward's exchange, as
// fft_conv_pair.cu's 2-D mode does) and runs the nz stages, writing whole
// rows.  An axis on two factors runs in the forward's order both ways, so
// the transposed plane holds each axis in natural order.  Kernels of
// their own (pair_block_tl), one a direction (fft_pair_tl_kernel<0> and
// <1>, picked by the C entry from the plans), so the natural ones compile
// as before.
#include <cooperative_groups.h>

#include "cluster.cuh"
#include "inplace.cuh"
#include "twofactor.cuh"

namespace cg = cooperative_groups;

namespace {

using vkfft::Plan;
using vkfft::Real;
using vkfft::cx;
using namespace vkfft::walk;
using vkfft::cluster::kXchg;
using vkfft::cluster::ld_remote2;
using vkfft::cluster::ld_remote4;
using vkfft::cluster::remote;
using vkfft::cluster::st_remote2;
using vkfft::cluster::st_remote4;

// Most threads a block; the bound holds the kernel to 64 registers, as
// (512, 2) does, and lets the largest tiles move in one exchange.
constexpr int kThreads = 1024;
constexpr int kThreads64 = 256;  // ... of the fp64 kernel, at 2 blocks an SM

// Whether the exchange packs two points into one 16-byte store (fp32).
template <class C>
constexpr bool kPacked = sizeof(C) == 8;

// Row tile -> column tiles: point (r, kz) of this block's row tile, at its
// place `zout`, goes to point (r0 + r, kz % cols) of owner kz / cols's
// column tile (pitch cols).  Each thread reads its points (pairs along kz
// when cols is even and a point is 8 bytes) into registers, the cluster
// meets (every row tile is read), it stores them, and the cluster meets
// again.
template <class C>
__device__ void push_columns(cg::cluster_group& cluster, C* buf, int nz,
                             int rows, int cols, const Map& zout, int r0) {
  const int T = blockDim.x;
  const int tile = rows * nz;
  if ((cols & 1) == 0 && kPacked<C>) {
    if constexpr (kPacked<C>) {
      const int half = tile >> 1;
      float4 v[kXchg / 2];
      int v0 = fresh_tid();
#pragma unroll
      for (int j = 0; j < kXchg / 2; ++j, v0 += T) {
        const int p = min(v0, half - 1);
        const float2 a = buf[position(2 * p, zout)];
        const float2 b = buf[position(2 * p + 1, zout)];
        v[j] = make_float4(a.x, a.y, b.x, b.y);
      }
      cluster.sync();   // every row tile is read: the buffers are free
      // the divisors made here, not held through the reads
      const Div dn = make_div(fresh_int(nz) >> 1), dc = make_div(cols >> 1);
      v0 = fresh_tid();
#pragma unroll
      for (int j = 0; j < kXchg / 2; ++j, v0 += T) {
        const int p = min(v0, half - 1);
        const int r = quot(p, dn);
        const int kz2 = p - r * (int)dn.d;
        const int owner = quot(kz2, dc);
        if (v0 < half)
          st_remote4(remote(buf, 2 * ((r0 + r) * (int)dc.d + kz2 -
                                      owner * (int)dc.d), owner), v[j]);
      }
    }
  } else {
    C v[kXchg];
    int u0 = fresh_tid();
#pragma unroll
    for (int j = 0; j < kXchg; ++j, u0 += T)
      v[j] = buf[position(min(u0, tile - 1), zout)];
    cluster.sync();   // every row tile is read: the buffers are free
    const Div dn = make_div(fresh_int(nz)), dc = make_div(cols);
    u0 = fresh_tid();
#pragma unroll
    for (int j = 0; j < kXchg; ++j, u0 += T) {
      const int u = min(u0, tile - 1);
      const int r = quot(u, dn);
      const int kz = u - r * nz;
      const int owner = quot(kz, dc);
      if (u0 < tile)
        st_remote2(remote(buf, (r0 + r) * cols + kz - owner * cols, owner),
                   v[j]);
    }
  }
  cluster.sync();   // every push has landed
}

// The column tile to device memory: row ky (at yout(ky) in the tile) to
// row ky of the plane from real offset g0 (its column c0), cols points,
// four reals a plane at once (store4) where every run is aligned to four
// (16 bytes of floats, 8 of halves; a thread's four points read in an
// order rotated by its lane), else single reals, narrowed to the planes'
// storage type.
template <class C, class St>
__device__ void store_columns(const C* buf, int ny, int cols, RowPerm yout,
                              St* yr, St* yi, long long g0, int nz) {
  const int T = blockDim.x;
  if ((cols & 3) == 0 && (g0 & 3) == 0 && group_aligned(yr, yi)) {
    const int c4 = cols >> 2;
    const Div dc = make_div(c4);
    const int rot = (threadIdx.x >> 2) & 3;
#pragma unroll 2
    for (int f = threadIdx.x; f < ny * c4; f += T) {
      const int ky = quot(f, dc);
      const int c = 4 * (f - ky * c4);
      const C* s = buf + yout(ky) * cols + c;
      C v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = s[(k + rot) & 3];
      rotate(v, (4 - rot) & 3);
      const long long g = g0 + (long long)ky * nz + c;
      store4(yr + g, v[0].x, v[1].x, v[2].x, v[3].x);
      store4(yi + g, v[0].y, v[1].y, v[2].y, v[3].y);
    }
    return;
  }
  const Div dc = make_div(cols);
  for (int u = threadIdx.x; u < ny * cols; u += T) {
    const int ky = quot(u, dc);
    const int c = u - ky * cols;
    const C v = buf[yout(ky) * cols + c];
    const long long g = g0 + (long long)ky * nz + c;
    put(yr[g], v.x);
    put(yi[g], v.y);
  }
}

// The column tile (columns c0.. of its plane, at yout(ky) * cols) under a
// window: rows ky < w.oy of the columns below w.oz, point by point.
template <class C, class St>
__device__ void store_columns_window(const C* buf, int cols, RowPerm yout,
                                     St* yr, St* yi, long long g0, int c0,
                                     const PairWindow& w) {
  const int live = min(cols, w.oz - c0);
  if (live <= 0) return;
  const Div dc = make_div(live);
  for (int u = threadIdx.x; u < w.oy * live; u += blockDim.x) {
    const int ky = quot(u, dc);
    const int c = u - ky * live;
    const C v = buf[yout(ky) * cols + c];
    const long long g = g0 + (long long)ky * w.out_row + c0 + c;
    put(yr[g], v.x);
    put(yi[g], v.y);
  }
}

// Where a block's pieces sit, computed once by the host and read from the
// kernel's parameters where they are used (not held in registers through
// a pass): the row tile's rows and the column tile's columns, the z
// factors' pitch n1z | 1 and a row's stride n2z * (n1z | 1), the points of
// the tile area (the tables after it: the four plans' stage tables, then
// the z and y twiddles), each plan's table offset and each twiddle's.
struct Geo {
  int rows, cols, pz, sz, area;
  int z2, y1, y2;   // the stage tables of z2, y1, y2 (z1's at 0)
  int twz, twy;     // the twiddles' tables
  int ntab;
};

// Where the block's plane starts, found again where it is used.
__device__ __forceinline__ long long plane_base(cg::cluster_group& cluster,
                                                int ny, int nz) {
  return (long long)(blockIdx.x / cluster.num_blocks()) * ny * nz;
}

// The block body on points of type C and planes of storage type St; with
// kWindow, under the window w.
template <bool kWindow = false, class C, class St>
__device__ __forceinline__ void pair_block(
    C* smem, const St* xr, const St* xi, St* yr, St* yi,
    const Plan& pz1, const Plan& pz2, const Plan& py1, const Plan& py2,
    const C* tz1, const C* tz2, const C* ty1, const C* ty2, const C* twz,
    const C* twy, const Geo& geo, const PairWindow& w = PairWindow{}) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nz = pz1.n * pz2.n, ny = py1.n * py2.n;
  C* tab = smem + geo.area;
  for (int t = threadIdx.x; t < geo.ntab; t += blockDim.x) {
    const C* src = t < geo.z2    ? tz1 + t
                   : t < geo.y1  ? tz2 + (t - geo.z2)
                   : t < geo.y2  ? ty1 + (t - geo.y1)
                   : t < geo.twz ? ty2 + (t - geo.y2)
                   : t < geo.twy ? twz + (t - geo.twz)
                                 : twy + (t - geo.twy);
    tab[t] = __ldg(src);
  }
  // the row tile in natural order
  if constexpr (kWindow)
    load_rows_window(xr, xi,
                     (long long)(blockIdx.x / cluster.num_blocks()) *
                         w.in_plane,
                     (int)cluster.block_rank() * geo.rows, geo.rows, w,
                     make_map(nz, geo.sz, false, pz1.n, pz2.n, geo.pz), smem);
  else if constexpr (kNarrow<St>)
    load_lines(xr, xi,
               plane_base(cluster, ny, nz) +
                   (long long)cluster.block_rank() * geo.rows * nz,
               geo.rows * nz,
               make_map(nz, geo.sz, false, pz1.n, pz2.n, geo.pz), smem);
  else
    load_lines_async(xr, xi,
                     plane_base(cluster, ny, nz) +
                         (long long)cluster.block_rank() * geo.rows * nz,
                     geo.rows * nz,
                     make_map(nz, geo.sz, false, pz1.n, pz2.n, geo.pz), smem);
  __syncthreads();
  // 1-4. the z axis along the rows, the exchange, the y axis down the
  // columns, each axis a column pass (the n2-point stages, the twiddle on
  // their last) and a row pass (n1 points) in both directions: natural
  // order in, the factors' transposed order out; one call site of
  // run_pass keeps one copy of each stage
  for (int k = 0; k < 4; ++k) {
    const bool y = k >= 2;
    if (k == 2)
      push_columns(cluster, smem, nz, geo.rows, geo.cols,
                   make_map(nz, geo.sz, true, pz1.n, pz2.n, geo.pz),
                   (int)cluster.block_rank() * geo.rows);
    const bool row = (k & 1) == 1;
    const int n1 = y ? py1.n : pz1.n, n2 = y ? py2.n : pz2.n;
    // under a window the row tile's rows past the kept corner hold zeros,
    // whose z stages are skipped
    const int zrows =
        kWindow ? min(geo.rows, max(0, w.ky - (int)cluster.block_rank() *
                                                 geo.rows))
                : geo.rows;
    // z: line r at r * sz, point j2 * n1 + j1 at j2 * pz + j1; y: column c
    // at c, point j at j * cols
    const Pass g =
        y ? (row ? Pass{geo.cols * n2, 1, n1 * geo.cols, geo.cols, make_div(n2)}
                 : Pass{geo.cols * n1, 1, geo.cols, n1 * geo.cols, make_div(n1)})
          : (row ? Pass{zrows * n2, geo.sz, geo.pz, 1, make_div(n2)}
                 : Pass{zrows * n1, geo.sz, 1, geo.pz, make_div(n1)});
    const C* tlo = smem + geo.area + (y ? geo.twy : geo.twz);
    // With n2 = 1 the twiddle is the scale alone, skipped when it is 1.
    const bool twiddled = n2 > 1 || tlo[kTwLo].x != Real<C>(1) ||
                          tlo[kTwLo].y != Real<C>(0);
    const bool fuse = twiddled && row == (n2 == 1);
    const int which = (y ? 2 : 0) + (row ? 0 : 1);
    run_pass(smem, g,
             which == 0 ? pz1 : which == 1 ? pz2 : which == 2 ? py1 : py2,
             smem + geo.area + (which == 0   ? 0
                                : which == 1 ? geo.z2
                                : which == 2 ? geo.y1
                                             : geo.y2),
             InterTwiddleT<C>{fuse ? tlo : nullptr, tlo + kTwLo});
  }
  if constexpr (kWindow)
    store_columns_window(smem, geo.cols, RowPerm{make_div(py2.n), py1.n}, yr,
                         yi,
                         (long long)(blockIdx.x / cluster.num_blocks()) *
                             w.out_plane,
                         (int)cluster.block_rank() * geo.cols, w);
  else
    store_columns(smem, ny, geo.cols, RowPerm{make_div(py2.n), py1.n}, yr,
                  yi,
                  plane_base(cluster, ny, nz) +
                      cluster.block_rank() * geo.cols,
                  nz);
}

// The kept intermediate order (the tl form): the transposed (nz, ny) plane
// holds the natural 2-D spectrum, Xt[kz][ky] = X[ky][kz].  A block's column
// tile (columns c0.. of its plane, all ny rows) is then the contiguous run
// of rows c0.. of the transposed plane, from real offset g0.  Each thread
// moves four neighbouring ky of one column (four reals a plane at once),
// the column fastest across threads: a warp's shared reads or writes at
// pitch cols fall on distinct banks, and its four-real runs fill whole
// 32-byte sectors of device memory.  Planes whose rows or offset are not
// aligned to four go point by point.
template <class C, class St>
__device__ void store_columns_tl(const C* buf, int ny, int cols, RowPerm yout,
                                 St* yr, St* yi, long long g0) {
  const int T = blockDim.x;
  if ((ny & 3) == 0 && (g0 & 3) == 0 && group_aligned(yr, yi)) {
    const Div dc = make_div(cols);
    for (int f = threadIdx.x; f < (ny >> 2) * cols; f += T) {
      const int kb = quot(f, dc);
      const int c = f - kb * cols;
      C v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = buf[yout(4 * kb + j) * cols + c];
      const long long g = g0 + (long long)c * ny + 4 * kb;
      store4(yr + g, v[0].x, v[1].x, v[2].x, v[3].x);
      store4(yi + g, v[0].y, v[1].y, v[2].y, v[3].y);
    }
    return;
  }
  const Div dn = make_div(ny);
  for (int u = threadIdx.x; u < ny * cols; u += T) {
    const int c = quot(u, dn);
    const C v = buf[yout(u - c * ny) * cols + c];
    put(yr[g0 + u], v.x);
    put(yi[g0 + u], v.y);
  }
}

// The column tile from rows c0.. of the transposed plane (real offset g0),
// natural order: point ky of column c at ky * cols + c.
template <class C, class St>
__device__ void load_columns_tl(const St* xr, const St* xi, long long g0,
                                int ny, int cols, C* buf) {
  const int T = blockDim.x;
  if ((ny & 3) == 0 && (g0 & 3) == 0 && group_aligned(xr, xi)) {
    const Div dc = make_div(cols);
    for (int f = threadIdx.x; f < (ny >> 2) * cols; f += T) {
      const int kb = quot(f, dc);
      const int c = f - kb * cols;
      const long long g = g0 + (long long)c * ny + 4 * kb;
      const auto r = load4(xr + g);
      const auto i = load4(xi + g);
      C* d = buf + 4 * kb * cols + c;
      d[0] = cx<C>(r.x, i.x);
      d[cols] = cx<C>(r.y, i.y);
      d[2 * cols] = cx<C>(r.z, i.z);
      d[3 * cols] = cx<C>(r.w, i.w);
    }
    return;
  }
  const Div dn = make_div(ny);
  for (int u = threadIdx.x; u < ny * cols; u += T) {
    const int c = quot(u, dn);
    buf[(u - c * ny) * cols + c] =
        cx<C>(widen(xr[g0 + u]), widen(xi[g0 + u]));
  }
}

// Column tiles -> row tile, the reverse of push_columns: point (r, kz) of
// this block's row tile, at its place `zin`, is point (yout(r0 + r), kz %
// cols) of owner kz / cols's column tile (the y axis in its factors'
// order).  The cluster meets (every block's column passes are done), each
// thread pulls its points (pairs along kz when cols is even) into
// registers, the cluster meets (the column tiles are free), and it writes
// them.  fp32 points (float2) only.
__device__ void pull_rows(cg::cluster_group& cluster, float2* buf, int nz,
                          int rows, int cols, const Map& zin, int r0,
                          RowPerm yout) {
  const int T = blockDim.x;
  const int tile = rows * nz;
  cluster.sync();   // every block's column passes are done
  if ((cols & 1) == 0) {
    const int half = tile >> 1;
    const Div dn = make_div(fresh_int(nz) >> 1), dc = make_div(cols >> 1);
    float4 v[kXchg / 2];
    int v0 = fresh_tid();
#pragma unroll
    for (int j = 0; j < kXchg / 2; ++j, v0 += T) {
      const int p = min(v0, half - 1);
      const int r = quot(p, dn);
      const int kz2 = p - r * (int)dn.d;
      const int owner = quot(kz2, dc);
      v[j] = ld_remote4(remote(
          buf, 2 * (yout(r0 + r) * (int)dc.d + kz2 - owner * (int)dc.d),
          owner));
    }
    cluster.sync();   // every pull is done: the column tiles are free
    v0 = fresh_tid();
#pragma unroll
    for (int j = 0; j < kXchg / 2; ++j, v0 += T) {
      if (v0 < half) {
        buf[position(2 * v0, zin)] = make_float2(v[j].x, v[j].y);
        buf[position(2 * v0 + 1, zin)] = make_float2(v[j].z, v[j].w);
      }
    }
  } else {
    const Div dn = make_div(fresh_int(nz)), dc = make_div(cols);
    float2 v[kXchg];
    int u0 = fresh_tid();
#pragma unroll
    for (int j = 0; j < kXchg; ++j, u0 += T) {
      const int u = min(u0, tile - 1);
      const int r = quot(u, dn);
      const int kz = u - r * nz;
      const int owner = quot(kz, dc);
      v[j] = ld_remote2(
          remote(buf, yout(r0 + r) * cols + kz - owner * cols, owner));
    }
    cluster.sync();   // every pull is done: the column tiles are free
    u0 = fresh_tid();
#pragma unroll
    for (int j = 0; j < kXchg; ++j, u0 += T)
      if (u0 < tile) buf[position(u0, zin)] = v[j];
  }
  __syncthreads();
}

// The tl block body on fp32 points and planes of storage type St.  The
// forward is pair_block's up to the write, which stores the column tile
// as rows of the transposed plane (store_columns_tl).  The inverse reads
// its column tile from the transposed plane (load_columns_tl), runs the y
// axis first, moves the columns back to row tiles (pull_rows), runs the z
// axis and writes its rows, one contiguous run.  Both directions run each
// axis in the forward's order (natural in, the factors' transposed order
// out; the inverse by its plans and conjugate twiddle), which the
// exchanges and the writes follow; the y axis's twiddle carries the
// scale.  Pass k runs axis kk: the forward z, z, y, y, the inverse y, y,
// z, z, at one call site of run_pass.  One kernel a direction (kInverse,
// which the plans must match): with both in one kernel the forward
// spilled 12 B too (ptxas, sm_90a).
template <int kInverse, class St>
__device__ __forceinline__ void pair_block_tl(
    float2* smem, const St* xr, const St* xi, St* yr, St* yi,
    const Plan& pz1, const Plan& pz2, const Plan& py1, const Plan& py2,
    const float2* tz1, const float2* tz2, const float2* ty1,
    const float2* ty2, const float2* twz, const float2* twy, const Geo& geo) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nz = pz1.n * pz2.n, ny = py1.n * py2.n;
  constexpr bool inverse = kInverse != 0;
  float2* tab = smem + geo.area;
  for (int t = threadIdx.x; t < geo.ntab; t += blockDim.x) {
    const float2* src = t < geo.z2    ? tz1 + t
                        : t < geo.y1  ? tz2 + (t - geo.z2)
                        : t < geo.y2  ? ty1 + (t - geo.y1)
                        : t < geo.twz ? ty2 + (t - geo.y2)
                        : t < geo.twy ? twz + (t - geo.twz)
                                      : twy + (t - geo.twy);
    tab[t] = __ldg(src);
  }
  if constexpr (inverse)
    load_columns_tl(xr, xi,
                    plane_base(cluster, ny, nz) +
                        (long long)cluster.block_rank() * geo.cols * ny,
                    ny, geo.cols, smem);
  else if constexpr (kNarrow<St>)
    load_lines(xr, xi,
               plane_base(cluster, ny, nz) +
                   (long long)cluster.block_rank() * geo.rows * nz,
               geo.rows * nz,
               make_map(nz, geo.sz, false, pz1.n, pz2.n, geo.pz), smem);
  else
    load_lines_async(xr, xi,
                     plane_base(cluster, ny, nz) +
                         (long long)cluster.block_rank() * geo.rows * nz,
                     geo.rows * nz,
                     make_map(nz, geo.sz, false, pz1.n, pz2.n, geo.pz), smem);
  __syncthreads();
  for (int k = 0; k < 4; ++k) {
    const int kk = inverse ? (k + 2) & 3 : k;
    const bool y = kk >= 2;
    if (k == 2) {
      if constexpr (inverse)
        pull_rows(cluster, smem, nz, geo.rows, geo.cols,
                  make_map(nz, geo.sz, false, pz1.n, pz2.n, geo.pz),
                  (int)cluster.block_rank() * geo.rows,
                  RowPerm{make_div(py2.n), py1.n});
      else
        push_columns(cluster, smem, nz, geo.rows, geo.cols,
                     make_map(nz, geo.sz, true, pz1.n, pz2.n, geo.pz),
                     (int)cluster.block_rank() * geo.rows);
    }
    const bool row = (kk & 1) == 1;
    const int n1 = y ? py1.n : pz1.n, n2 = y ? py2.n : pz2.n;
    const Pass g =
        y ? (row ? Pass{geo.cols * n2, 1, n1 * geo.cols, geo.cols, make_div(n2)}
                 : Pass{geo.cols * n1, 1, geo.cols, n1 * geo.cols, make_div(n1)})
          : (row ? Pass{geo.rows * n2, geo.sz, geo.pz, 1, make_div(n2)}
                 : Pass{geo.rows * n1, geo.sz, 1, geo.pz, make_div(n1)});
    const float2* tlo = smem + geo.area + (y ? geo.twy : geo.twz);
    // With n2 = 1 the twiddle is the scale alone, skipped when it is 1.
    const bool twiddled =
        n2 > 1 || tlo[kTwLo].x != 1.f || tlo[kTwLo].y != 0.f;
    const bool fuse = twiddled && row == (n2 == 1);
    const int which = (y ? 2 : 0) + (row ? 0 : 1);
    run_pass(smem, g,
             which == 0 ? pz1 : which == 1 ? pz2 : which == 2 ? py1 : py2,
             smem + geo.area + (which == 0   ? 0
                                : which == 1 ? geo.z2
                                : which == 2 ? geo.y1
                                             : geo.y2),
             InterTwiddleT<float2>{fuse ? tlo : nullptr, tlo + kTwLo});
  }
  if constexpr (inverse)
    store_lines(smem, make_map(nz, geo.sz, true, pz1.n, pz2.n, geo.pz), yr,
                yi,
                plane_base(cluster, ny, nz) +
                    (long long)cluster.block_rank() * geo.rows * nz,
                geo.rows * nz);
  else
    store_columns_tl(smem, ny, geo.cols, RowPerm{make_div(py2.n), py1.n}, yr,
                     yi,
                     plane_base(cluster, ny, nz) +
                         (long long)cluster.block_rank() * geo.cols * ny);
}

template <int kInverse>
__global__ void __launch_bounds__(kThreads, 1)
fft_pair_tl_kernel(const float* xr, const float* xi, float* yr, float* yi,
                   Plan pz1, Plan pz2, Plan py1, Plan py2, const float2* tz1,
                   const float2* tz2, const float2* ty1, const float2* ty2,
                   const float2* twz, const float2* twy, Geo geo) {
  extern __shared__ __align__(16) float2 smem[];
  pair_block_tl<kInverse>(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2,
                          ty1, ty2, twz, twy, geo);
}

template <int kInverse>
__global__ void __launch_bounds__(kThreads, 1)
fft_pair_tl_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                       __half* yi, Plan pz1, Plan pz2, Plan py1, Plan py2,
                       const float2* tz1, const float2* tz2,
                       const float2* ty1, const float2* ty2,
                       const float2* twz, const float2* twy, Geo geo) {
  extern __shared__ __align__(16) float2 smem[];
  pair_block_tl<kInverse>(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2,
                          ty1, ty2, twz, twy, geo);
}

template <int kInverse>
__global__ void __launch_bounds__(kThreads, 1)
fft_pair_tl_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                        __nv_bfloat16* yr, __nv_bfloat16* yi, Plan pz1,
                        Plan pz2, Plan py1, Plan py2, const float2* tz1,
                        const float2* tz2, const float2* ty1,
                        const float2* ty2, const float2* twz,
                        const float2* twy, Geo geo) {
  extern __shared__ __align__(16) float2 smem[];
  pair_block_tl<kInverse>(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2,
                          ty1, ty2, twz, twy, geo);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_pair_kernel(const float* xr, const float* xi, float* yr, float* yi,
                Plan pz1, Plan pz2, Plan py1, Plan py2, const float2* tz1,
                const float2* tz2, const float2* ty1, const float2* ty2,
                const float2* twz, const float2* twy, Geo geo) {
  extern __shared__ __align__(16) float2 smem[];
  pair_block(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2, ty1, ty2,
             twz, twy, geo);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_pair_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                    __half* yi, Plan pz1, Plan pz2, Plan py1, Plan py2,
                    const float2* tz1, const float2* tz2, const float2* ty1,
                    const float2* ty2, const float2* twz, const float2* twy,
                    Geo geo) {
  extern __shared__ __align__(16) float2 smem[];
  pair_block(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2, ty1, ty2,
             twz, twy, geo);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_pair_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                     __nv_bfloat16* yr, __nv_bfloat16* yi, Plan pz1,
                     Plan pz2, Plan py1, Plan py2, const float2* tz1,
                     const float2* tz2, const float2* ty1, const float2* ty2,
                     const float2* twz, const float2* twy, Geo geo) {
  extern __shared__ __align__(16) float2 smem[];
  pair_block(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2, ty1, ty2,
             twz, twy, geo);
}

__global__ void __launch_bounds__(kThreads64, 2)
fft_pair_f64_kernel(const double* xr, const double* xi, double* yr,
                    double* yi, Plan pz1, Plan pz2, Plan py1, Plan py2,
                    const double2* tz1, const double2* tz2,
                    const double2* ty1, const double2* ty2,
                    const double2* twz, const double2* twy, Geo geo) {
  extern __shared__ __align__(16) double2 smem64[];
  pair_block(smem64, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2, ty1, ty2,
             twz, twy, geo);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_pair_zp_kernel(const float* xr, const float* xi, float* yr, float* yi,
                   Plan pz1, Plan pz2, Plan py1, Plan py2, const float2* tz1,
                   const float2* tz2, const float2* ty1, const float2* ty2,
                   const float2* twz, const float2* twy, Geo geo,
                   PairWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  pair_block<true>(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2, ty1,
                   ty2, twz, twy, geo, w);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_pair_zp_f16_kernel(const __half* xr, const __half* xi, __half* yr,
                       __half* yi, Plan pz1, Plan pz2, Plan py1, Plan py2,
                       const float2* tz1, const float2* tz2,
                       const float2* ty1, const float2* ty2,
                       const float2* twz, const float2* twy, Geo geo,
                       PairWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  pair_block<true>(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2, ty1,
                   ty2, twz, twy, geo, w);
}

__global__ void __launch_bounds__(kThreads, 1)
fft_pair_zp_bf16_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                        __nv_bfloat16* yr, __nv_bfloat16* yi, Plan pz1,
                        Plan pz2, Plan py1, Plan py2, const float2* tz1,
                        const float2* tz2, const float2* ty1,
                        const float2* ty2, const float2* twz,
                        const float2* twy, Geo geo, PairWindow w) {
  extern __shared__ __align__(16) float2 smem[];
  pair_block<true>(smem, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2, ty1,
                   ty2, twz, twy, geo, w);
}

__global__ void __launch_bounds__(kThreads64, 2)
fft_pair_zp_f64_kernel(const double* xr, const double* xi, double* yr,
                       double* yi, Plan pz1, Plan pz2, Plan py1, Plan py2,
                       const double2* tz1, const double2* tz2,
                       const double2* ty1, const double2* ty2,
                       const double2* twz, const double2* twy, Geo geo,
                       PairWindow w) {
  extern __shared__ __align__(16) double2 smem64[];
  pair_block<true>(smem64, xr, xi, yr, yi, pz1, pz2, py1, py2, tz1, tz2, ty1,
                   ty2, twz, twy, geo, w);
}

// The layout of the plans (cuda_kernels.pair_layout) as a Geo, or false
// when (cluster, threads, smem) is not it: every stage's round holds a
// whole sequence, a thread moves at most kXchg points of an exchange, and
// the shared bytes are exact.
template <class C>
bool layout_of(const Plan& pz1, const Plan& pz2, const Plan& py1,
               const Plan& py2, int cluster, int threads, int max_threads,
               int smem, Geo* geo) {
  const int nz = pz1.n * pz2.n, ny = py1.n * py2.n;
  if (!vkfft::cluster::cluster_ok(cluster, ny, nz) || threads < 32 ||
      threads > max_threads || threads % 32 != 0 ||
      (long long)ny * nz / cluster > (long long)kXchg * threads ||
      !rounds_fit<C>(pz1, threads) || !rounds_fit<C>(pz2, threads) ||
      !rounds_fit<C>(py1, threads) || !rounds_fit<C>(py2, threads) ||
      smem < 0)
    return false;
  geo->rows = ny / cluster;
  geo->cols = nz / cluster;
  geo->pz = pz1.n | 1;
  geo->sz = pz2.n * geo->pz;
  // the row tile as the z factors' rows (the column tile, ny * nz / C
  // points, fits it)
  geo->area = geo->rows * geo->sz;
  geo->z2 = table_len(pz1);
  geo->y1 = geo->z2 + table_len(pz2);
  geo->y2 = geo->y1 + table_len(py1);
  geo->twz = geo->y2 + table_len(py2);
  geo->twy = geo->twz + kTwLo + (nz + kTwLo - 1) / kTwLo;
  geo->ntab = geo->twy + kTwLo + (ny + kTwLo - 1) / kTwLo;
  return (size_t)smem == sizeof(C) * ((size_t)geo->area + geo->ntab) &&
         smem <= vkfft::kMaxSmemBytes;
}

// The checks and the cluster launch at points of type C on planes of
// storage type St.
// With kWindow, the windowed kernel under the PairWindow of `window` (8
// ints: in_plane, out_plane, in_row, out_row, ky, kz, oy, oz), refused
// where it is not one: corners of 1..ny rows and 1..nz columns.
template <class C, bool kWindow = false, class St, typename K>
int launch(K kernel, int max_threads, const St* xr, const St* xi, St* yr,
           St* yi, long long planes, const int* plan_z1,
           const int* plan_z2, const int* plan_y1, const int* plan_y2,
           const Real<C>* table_z1, const Real<C>* table_z2,
           const Real<C>* table_y1, const Real<C>* table_y2,
           const Real<C>* twiddle_z, const Real<C>* twiddle_y, int cluster,
           int threads, int smem, void* stream,
           const long long* window = nullptr) {
  Plan pz1, pz2, py1, py2;
  if (planes < 1 || !vkfft::plan_from_ints(plan_z1, &pz1) ||
      !vkfft::subplan_from_ints(plan_z2, &pz2) ||
      !vkfft::plan_from_ints(plan_y1, &py1) ||
      !vkfft::subplan_from_ints(plan_y2, &py2) || twiddle_z == nullptr ||
      twiddle_y == nullptr)
    return (int)cudaErrorInvalidValue;
  Geo geo;
  if (pz1.n < pz2.n || py1.n < py2.n || pz2.inverse != pz1.inverse ||
      py1.inverse != pz1.inverse || py2.inverse != pz1.inverse ||
      !layout_of<C>(pz1, pz2, py1, py2, cluster, threads, max_threads, smem,
                    &geo))
    return (int)cudaErrorInvalidValue;
  if constexpr (kWindow) {
    PairWindow w;
    if (!pair_window_from_ints(window, py1.n * py2.n, pz1.n * pz2.n, &w))
      return (int)cudaErrorInvalidValue;
    return vkfft::cluster::launch_cluster(
        kernel, planes, cluster, threads, (size_t)smem, stream, xr, xi, yr,
        yi, pz1, pz2, py1, py2, reinterpret_cast<const C*>(table_z1),
        reinterpret_cast<const C*>(table_z2),
        reinterpret_cast<const C*>(table_y1),
        reinterpret_cast<const C*>(table_y2),
        reinterpret_cast<const C*>(twiddle_z),
        reinterpret_cast<const C*>(twiddle_y), geo, w);
  } else {
    return vkfft::cluster::launch_cluster(
        kernel, planes, cluster, threads, (size_t)smem, stream, xr, xi, yr,
        yi, pz1, pz2, py1, py2, reinterpret_cast<const C*>(table_z1),
        reinterpret_cast<const C*>(table_z2),
        reinterpret_cast<const C*>(table_y1),
        reinterpret_cast<const C*>(table_y2),
        reinterpret_cast<const C*>(twiddle_z),
        reinterpret_cast<const C*>(twiddle_y), geo);
  }
}

// Whether the int form of a plan is an inverse one (its third int; a
// plan the launch's checks refuse picks either kernel).
inline bool tl_inverse(const int* plan) { return plan != nullptr && plan[2]; }

template <typename K>
int occupancy(K kernel, int max_threads, int cluster, int threads, int smem,
              int* clusters, int* blocks) {
  if (!vkfft::cluster::cluster_ok(cluster, cluster, cluster) || threads < 32 ||
      threads > max_threads || smem < 0 || clusters == nullptr ||
      blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  return vkfft::cluster::cluster_occupancy(kernel, cluster, threads, smem,
                                           clusters, blocks);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  Plans (int form) of the two factors of each axis, nz = z1 *
// z2 and ny = y1 * y2 (all forward or all inverse; the second the empty
// plan of length 1 for one pass), their stage tables (no scale), and each
// axis's inter-factor twiddle as two tables, 64 points w_n^b then ceil(n /
// 64) points scale * w_n^(64 a) (the scale 1 on z), all as interleaved
// fp32 pairs.  The layout (cuda_kernels.pair_layout): `cluster` blocks a
// plane (1, 2, 4, 8 or 16, dividing ny and nz), `threads` a block and the
// dynamic shared bytes, exactly; any other layout is refused
// (cudaErrorInvalidValue).
int vk_fft_pair(const float* xr, const float* xi, float* yr, float* yi,
                long long planes, const int* plan_z1, const int* plan_z2,
                const int* plan_y1, const int* plan_y2, const float* table_z1,
                const float* table_z2, const float* table_y1,
                const float* table_y2, const float* twiddle_z,
                const float* twiddle_y, int cluster, int threads, int smem,
                void* stream) {
  return launch<float2>(fft_pair_kernel, kThreads, xr, xi, yr, yi, planes,
                        plan_z1, plan_z2, plan_y1, plan_y2, table_z1,
                        table_z2, table_y1, table_y2, twiddle_z, twiddle_y,
                        cluster, threads, smem, stream);
}

// vk_fft_pair on fp64 planes and tables (interleaved fp64 pairs), at most
// 256 threads a block.
int vk_fft_pair_f64(const double* xr, const double* xi, double* yr,
                    double* yi, long long planes, const int* plan_z1,
                    const int* plan_z2, const int* plan_y1,
                    const int* plan_y2, const double* table_z1,
                    const double* table_z2, const double* table_y1,
                    const double* table_y2, const double* twiddle_z,
                    const double* twiddle_y, int cluster, int threads,
                    int smem, void* stream) {
  return launch<double2>(fft_pair_f64_kernel, kThreads64, xr, xi, yr, yi,
                         planes, plan_z1, plan_z2, plan_y1, plan_y2, table_z1,
                         table_z2, table_y1, table_y2, twiddle_z, twiddle_y,
                         cluster, threads, smem, stream);
}

// vk_fft_pair on fp16 / bf16 planes (the tables fp32, as vk_fft_pair's).
int vk_fft_pair_f16(const __half* xr, const __half* xi, __half* yr,
                    __half* yi, long long planes, const int* plan_z1,
                    const int* plan_z2, const int* plan_y1,
                    const int* plan_y2, const float* table_z1,
                    const float* table_z2, const float* table_y1,
                    const float* table_y2, const float* twiddle_z,
                    const float* twiddle_y, int cluster, int threads,
                    int smem, void* stream) {
  return launch<float2>(fft_pair_f16_kernel, kThreads, xr, xi, yr, yi, planes,
                        plan_z1, plan_z2, plan_y1, plan_y2, table_z1,
                        table_z2, table_y1, table_y2, twiddle_z, twiddle_y,
                        cluster, threads, smem, stream);
}

int vk_fft_pair_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                     __nv_bfloat16* yr, __nv_bfloat16* yi, long long planes,
                     const int* plan_z1, const int* plan_z2,
                     const int* plan_y1, const int* plan_y2,
                     const float* table_z1, const float* table_z2,
                     const float* table_y1, const float* table_y2,
                     const float* twiddle_z, const float* twiddle_y,
                     int cluster, int threads, int smem, void* stream) {
  return launch<float2>(fft_pair_bf16_kernel, kThreads, xr, xi, yr, yi,
                        planes, plan_z1, plan_z2, plan_y1, plan_y2, table_z1,
                        table_z2, table_y1, table_y2, twiddle_z, twiddle_y,
                        cluster, threads, smem, stream);
}

// vk_fft_pair in the kept intermediate order (the tl form, fp32, fp16 and
// bf16 planes): the forward reads natural (B, ny, nz) planes and writes
// the transposed (B, nz, ny) planes of their spectrum; the inverse reads
// those and writes natural planes.  Arguments and layout as vk_fft_pair's.
int vk_fft_pair_tl(const float* xr, const float* xi, float* yr, float* yi,
                   long long planes, const int* plan_z1, const int* plan_z2,
                   const int* plan_y1, const int* plan_y2,
                   const float* table_z1, const float* table_z2,
                   const float* table_y1, const float* table_y2,
                   const float* twiddle_z, const float* twiddle_y,
                   int cluster, int threads, int smem, void* stream) {
  return launch<float2>(tl_inverse(plan_z1) ? fft_pair_tl_kernel<1>
                                            : fft_pair_tl_kernel<0>,
                        kThreads, xr, xi, yr, yi, planes, plan_z1, plan_z2,
                        plan_y1, plan_y2, table_z1, table_z2, table_y1,
                        table_y2, twiddle_z, twiddle_y, cluster, threads,
                        smem, stream);
}

int vk_fft_pair_tl_f16(const __half* xr, const __half* xi, __half* yr,
                       __half* yi, long long planes, const int* plan_z1,
                       const int* plan_z2, const int* plan_y1,
                       const int* plan_y2, const float* table_z1,
                       const float* table_z2, const float* table_y1,
                       const float* table_y2, const float* twiddle_z,
                       const float* twiddle_y, int cluster, int threads,
                       int smem, void* stream) {
  return launch<float2>(tl_inverse(plan_z1) ? fft_pair_tl_f16_kernel<1>
                                            : fft_pair_tl_f16_kernel<0>,
                        kThreads, xr, xi, yr, yi, planes, plan_z1, plan_z2,
                        plan_y1, plan_y2, table_z1, table_z2, table_y1,
                        table_y2, twiddle_z, twiddle_y, cluster, threads,
                        smem, stream);
}

int vk_fft_pair_tl_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                        __nv_bfloat16* yr, __nv_bfloat16* yi,
                        long long planes, const int* plan_z1,
                        const int* plan_z2, const int* plan_y1,
                        const int* plan_y2, const float* table_z1,
                        const float* table_z2, const float* table_y1,
                        const float* table_y2, const float* twiddle_z,
                        const float* twiddle_y, int cluster, int threads,
                        int smem, void* stream) {
  return launch<float2>(tl_inverse(plan_z1) ? fft_pair_tl_bf16_kernel<1>
                                            : fft_pair_tl_bf16_kernel<0>,
                        kThreads, xr, xi, yr, yi, planes, plan_z1, plan_z2,
                        plan_y1, plan_y2, table_z1, table_z2, table_y1,
                        table_y2, twiddle_z, twiddle_y, cluster, threads,
                        smem, stream);
}

// vk_fft_pair under a zero-pad window: `window` points to the 8 ints of
// PairWindow (in_plane, out_plane, in_row, out_row, ky, kz, oy, oz); the
// planes read and written are the windows' corners at those pitches.  A
// window that is not one is refused.
int vk_fft_pair_zp(const float* xr, const float* xi, float* yr, float* yi,
                   long long planes, const int* plan_z1, const int* plan_z2,
                   const int* plan_y1, const int* plan_y2,
                   const float* table_z1, const float* table_z2,
                   const float* table_y1, const float* table_y2,
                   const float* twiddle_z, const float* twiddle_y,
                   int cluster, int threads, int smem,
                   const long long* window, void* stream) {
  return launch<float2, true>(fft_pair_zp_kernel, kThreads, xr, xi, yr, yi,
                              planes, plan_z1, plan_z2, plan_y1, plan_y2,
                              table_z1, table_z2, table_y1, table_y2,
                              twiddle_z, twiddle_y, cluster, threads, smem,
                              stream, window);
}

int vk_fft_pair_zp_f64(const double* xr, const double* xi, double* yr,
                       double* yi, long long planes, const int* plan_z1,
                       const int* plan_z2, const int* plan_y1,
                       const int* plan_y2, const double* table_z1,
                       const double* table_z2, const double* table_y1,
                       const double* table_y2, const double* twiddle_z,
                       const double* twiddle_y, int cluster, int threads,
                       int smem, const long long* window, void* stream) {
  return launch<double2, true>(fft_pair_zp_f64_kernel, kThreads64, xr, xi, yr,
                               yi, planes, plan_z1, plan_z2, plan_y1,
                               plan_y2, table_z1, table_z2, table_y1,
                               table_y2, twiddle_z, twiddle_y, cluster,
                               threads, smem, stream, window);
}

int vk_fft_pair_zp_f16(const __half* xr, const __half* xi, __half* yr,
                       __half* yi, long long planes, const int* plan_z1,
                       const int* plan_z2, const int* plan_y1,
                       const int* plan_y2, const float* table_z1,
                       const float* table_z2, const float* table_y1,
                       const float* table_y2, const float* twiddle_z,
                       const float* twiddle_y, int cluster, int threads,
                       int smem, const long long* window, void* stream) {
  return launch<float2, true>(fft_pair_zp_f16_kernel, kThreads, xr, xi, yr,
                              yi, planes, plan_z1, plan_z2, plan_y1, plan_y2,
                              table_z1, table_z2, table_y1, table_y2,
                              twiddle_z, twiddle_y, cluster, threads, smem,
                              stream, window);
}

int vk_fft_pair_zp_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                        __nv_bfloat16* yr, __nv_bfloat16* yi,
                        long long planes, const int* plan_z1,
                        const int* plan_z2, const int* plan_y1,
                        const int* plan_y2, const float* table_z1,
                        const float* table_z2, const float* table_y1,
                        const float* table_y2, const float* twiddle_z,
                        const float* twiddle_y, int cluster, int threads,
                        int smem, const long long* window, void* stream) {
  return launch<float2, true>(fft_pair_zp_bf16_kernel, kThreads, xr, xi, yr,
                              yi, planes, plan_z1, plan_z2, plan_y1, plan_y2,
                              table_z1, table_z2, table_y1, table_y2,
                              twiddle_z, twiddle_y, cluster, threads, smem,
                              stream, window);
}

// Resident clusters on the card and blocks an SM of the kernel at
// `cluster` blocks of `threads` with `smem` dynamic shared bytes, into
// *clusters and *blocks.
int vk_fft_pair_occupancy(int cluster, int threads, int smem, int* clusters,
                          int* blocks) {
  return occupancy(fft_pair_kernel, kThreads, cluster, threads, smem,
                   clusters, blocks);
}

int vk_fft_pair_f64_occupancy(int cluster, int threads, int smem,
                              int* clusters, int* blocks) {
  return occupancy(fft_pair_f64_kernel, kThreads64, cluster, threads, smem,
                   clusters, blocks);
}

int vk_fft_pair_f16_occupancy(int cluster, int threads, int smem,
                              int* clusters, int* blocks) {
  return occupancy(fft_pair_f16_kernel, kThreads, cluster, threads, smem,
                   clusters, blocks);
}

int vk_fft_pair_bf16_occupancy(int cluster, int threads, int smem,
                               int* clusters, int* blocks) {
  return occupancy(fft_pair_bf16_kernel, kThreads, cluster, threads, smem,
                   clusters, blocks);
}

int vk_fft_pair_tl_occupancy(int cluster, int threads, int smem,
                             int* clusters, int* blocks) {
  return occupancy(fft_pair_tl_kernel<0>, kThreads, cluster, threads, smem,
                   clusters, blocks);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
