// fft_r2c_pair: 2-D real-to-complex FFT of the two minor axes of real
// (B, ny, nz) fp32 planes, nz even, into their (B, ny, nz/2+1) half
// spectrum (numpy rfft2 values), and the complex-to-real inverse, each in
// one pass.  Replaces vkfft_tpu/ops/pallas_engine.py:3204 _r2c_pair_kernel
// and :3229 _c2r_pair_kernel (host side: _build_r2c_pair_call,
// rfft2_pair_planar, irfft2_pair_planar).  The inverse's output is scaled
// by ny * scale_y * (nz/2) * scale_z, scale_y in the y axis's twiddle
// table and scale_z in the untangle: scale_y = 1/ny, scale_z = 2/nz give
// numpy's irfft2.
//
// Bound: bytes, one read of the real plane (4 B a point) and one write of
// the half spectrum (8 B a bin), or the reverse, for both axes together.
// Design: fft_pair.cu's plane, held once over a cluster of C blocks on
// the in-place walk of inplace.cuh, with fft_r2c.cu's real rows of m =
// nz/2 complex points.  Forward: block `rank` reads its row tile (rows
// [rank*ny/C, ...), one contiguous run of device memory) as z[j] = x[2j]
// + i x[2j+1] by cp.async straight to its places and runs the m-point
// stages along its rows.  Both bins of a pair (k, m-k) lie in its row
// tile, so the untangle rides the exchange: each thread computes its bins
// of the packed half spectrum (real_walk.cuh's half_bin_at; slot 0 holds
// the real X[0] and X[m]) into registers, the cluster meets, and it
// stores them to their owners' column tiles (columns [rank*m/C, ...), all
// ny rows) by 32-bit shared::cluster addresses (cluster.cuh).  The m+1
// spectrum columns do not split over C blocks, but columns 0 and m are
// real after the rows (the TPU kernel's own observation,
// pallas_engine.py:3188-3196): they ride one complex column, slot 0, DC +
// i Nyquist, through the ny-point stages down the columns, and rank 0
// splits them as it writes, by Hermitian symmetry: Y[k] = A[k] + i B[k]
// with A = (Y[k] + conj Y[-k])/2, B = (Y[k] - conj Y[-k])/(2i).  Each
// block writes its columns of every spectrum row straight from the column
// tile, as single floats (rows of m+1 bins are not 16-byte aligned).  The
// inverse runs the same steps backwards: it reads its column tile by
// cp.async, rank 0 forming column 0 from the Hermitian parts of the DC
// and Nyquist columns (what numpy's irfft2 reads of them) as it reads,
// runs the y stages, exchanges the column tiles back to row tiles,
// untangles there in place with scale_z (real_walk.cuh's
// untangle_inverse), runs the z stages and writes the real rows as float2
// pairs.  Each axis runs in the forward's order both ways (natural order
// in, the factors' transposed order out; the inverse by its plans and
// conjugate twiddle alone), as fft_pair.cu's, one pass where its stages
// fit a round of the threads, else two factors.  The stage tables (radix
// 16, walk_radices) and the twiddles' root tables sit in shared memory;
// the block's geometry comes from the host as scalars (Geo), read where
// it is used.  cuda_kernels.r2c_pair_layout is the one layout rule (the C
// entry refuses any other): the cluster, the threads (a thread moves at
// most kXchg points of an exchange) and the exact shared bytes.  Every
// read of a plane precedes the first cluster barrier and every write
// follows the last.  The forward kernel is built twice: without
// inplace.cuh's generic stage (the primes 11..61), for planes whose
// stages all have a butterfly of their own, and with it, where ptxas
// spills in the generic stage's loop.
#include <cooperative_groups.h>

#include "cluster.cuh"
#include "inplace.cuh"
#include "real_walk.cuh"
#include "twofactor.cuh"

namespace cg = cooperative_groups;

namespace {

using vkfft::Plan;
using namespace vkfft::walk;
using vkfft::cluster::block_rank;
using vkfft::cluster::copy_plane_tables;
using vkfft::cluster::kXchg;
using vkfft::cluster::plane_index;
using vkfft::cluster::remote;
using vkfft::cluster::st_remote2;
using vkfft::cluster::st_remote4;

// Most threads a block; the bound holds the kernels to 64 registers.
constexpr int kThreads = 1024;

// Where a block's pieces sit, computed once by the host and read from the
// kernel's parameters where they are used (not held in registers through
// a pass or an exchange): the plane's m = nz/2 and ny, the row tile's rows
// and the column tile's columns, a tile's points, the z factors' pitch n1z
// | 1 and a row's
// stride n2z * (n1z | 1), the points of the tile area (the tables after
// it: the four plans' stage tables, then the z twiddles, as
// cuda_kernels.r2c_twiddle lays them out, and the y twiddle), each plan's
// table offset, each twiddle's, the untangle's low root table, and the
// exchanges' divisors and derived counts (computed in the kernel, they were
// hoisted out of the pass loop and spilled).
struct Geo {
  int m, ny, rows, cols, tile, pz, sz, area;   // tile: rows * m = ny * cols
  int mh, ch, last, hlast;   // m / 2, cols / 2, tile - 1, tile / 2 - 1
  int z2, y1, y2;   // the stage tables of z2, y1, y2 (z1's at 0)
  int twz, twy;     // the twiddles' tables
  int ulo;          // the untangle's roots w_nz^k
  int ntab;
  Div dm, dhalf, dcols, dhcols, drows;   // m, m / 2, cols, cols / 2, rows
  Div dz1, dz2, dy2;                     // the factors n1z, n2z, n2y
};

// Pass `row` (the n1-point rows of an axis's factor matrix, else its
// n2-point columns) of axis y (down the column tile: column c at c, point
// j at j * cols) or z (along the row tile: row r at r * sz, point j2 * n1
// + j1 at j2 * pz + j1), the twiddle on the column pass's last stage (on
// the row pass's when n2 = 1, where it is the scale alone, skipped when
// it is 1): fft_pair.cu's passes.  Natural order in, the factors'
// transposed order out.  Without kGeneric, no generic stage.
template <bool kGeneric = true>
__device__ __forceinline__ void axis_pass(float2* smem, const Geo& geo,
                                          bool y, bool row, const Plan& pz1,
                                          const Plan& pz2, const Plan& py1,
                                          const Plan& py2) {
  const int n1 = y ? py1.n : pz1.n, n2 = y ? py2.n : pz2.n;
  const Pass g =
      y ? (row ? Pass{geo.cols * n2, 1, n1 * geo.cols, geo.cols, make_div(n2)}
               : Pass{geo.cols * n1, 1, geo.cols, n1 * geo.cols, make_div(n1)})
        : (row ? Pass{geo.rows * n2, geo.sz, geo.pz, 1, make_div(n2)}
               : Pass{geo.rows * n1, geo.sz, 1, geo.pz, make_div(n1)});
  const float2* tlo = smem + geo.area + (y ? geo.twy : geo.twz);
  const bool twiddled = n2 > 1 || tlo[kTwLo].x != 1.f || tlo[kTwLo].y != 0.f;
  const bool fuse = twiddled && row == (n2 == 1);
  const int which = (y ? 2 : 0) + (row ? 0 : 1);
  run_pass<kGeneric>(
      smem, g, which == 0 ? pz1 : which == 1 ? pz2 : which == 2 ? py1 : py2,
      smem + geo.area + (which == 0   ? 0
                         : which == 1 ? geo.z2
                         : which == 2 ? geo.y1
                                      : geo.y2),
      InterTwiddle{fuse ? tlo : nullptr, tlo + kTwLo});
}

// Row tile -> column tiles, untangled on the way: bin c < m of row r of
// the packed half spectrum, computed from Z[k] and Z[m-k] at their places
// zout(r, k) in this block's row tile (half_bin_at), goes to point (r0 +
// r, c % cols) of owner c / cols's column tile (pitch cols).  Each thread
// computes its bins (pairs along c when cols is even) into registers, the
// cluster meets (every row tile is read), it stores them, and the cluster
// meets again.  The geometry is read from the parameters where it is
// used, and each point's index from the thread's index read afresh, so
// the indices of a thread's points are not all held beside its points.
__device__ void push_bins(cg::cluster_group& cluster, float2* buf,
                          const Geo& geo, const RowAt& zout,
                          const float2* ulo) {
  const int T = blockDim.x;
  const int m = geo.m, cols = geo.cols;
  if ((cols & 1) == 0) {
    float4 v[kXchg / 2];
#pragma unroll
    for (int j = 0; j < kXchg / 2; ++j) {
      const int p = min(fresh_tid() + j * T, geo.hlast);
      const int r = quot(p, geo.dhalf);
      const int c = 2 * (p - r * geo.mh);
      const float2 a = half_bin_at(buf, zout, ulo, m, r, c, true);
      const float2 b = half_bin_at(buf, zout, ulo, m, r, c + 1, true);
      v[j] = make_float4(a.x, a.y, b.x, b.y);
    }
    cluster.sync();   // every row tile is read: the buffers are free
    const int r0 = block_rank() * geo.rows;
#pragma unroll
    for (int j = 0; j < kXchg / 2; ++j) {
      const int v0 = fresh_tid() + j * T;
      const int p = min(v0, geo.hlast);
      const int r = quot(p, geo.dhalf);
      const int c2 = p - r * geo.mh;
      const int owner = quot(c2, geo.dhcols);
      if (v0 <= geo.hlast)
        st_remote4(remote(buf, 2 * ((r0 + r) * geo.ch + c2 - owner * geo.ch),
                          owner), v[j]);
    }
  } else {
    float2 v[kXchg];
#pragma unroll
    for (int j = 0; j < kXchg; ++j) {
      const int u = min(fresh_tid() + j * T, geo.last);
      const int r = quot(u, geo.dm);
      v[j] = half_bin_at(buf, zout, ulo, m, r, u - r * m, true);
    }
    cluster.sync();   // every row tile is read: the buffers are free
    const int r0 = block_rank() * geo.rows;
#pragma unroll
    for (int j = 0; j < kXchg; ++j) {
      const int u0 = fresh_tid() + j * T;
      const int u = min(u0, geo.last);
      const int r = quot(u, geo.dm);
      const int c = u - r * m;
      const int owner = quot(c, geo.dcols);
      if (u0 <= geo.last)
        st_remote2(remote(buf, (r0 + r) * cols + c - owner * cols, owner),
                   v[j]);
    }
  }
  cluster.sync();   // every push has landed
}

// The column tile to the half spectrum: bin c0 + c of row ky, at yout(ky)
// * cols + c in the tile, to float offset g0 + ky * h + c of the planes
// (g0 the plane's start plus c0), single floats, a warp's threads on
// neighbouring bins.  Rank 0 (`first`) splits its column 0, FFT_y(DC) + i
// FFT_y(Nyquist), by Hermitian symmetry as it writes: A[ky] to column 0
// and B[ky] to column m = h - 1.
__device__ void store_bins(const float2* buf, int ny, int cols, int h,
                           RowPerm yout, float* yr, float* yi, long long g0,
                           bool first) {
  const Div dc = make_div(cols);
  const int count = ny * cols;
  for (int u = threadIdx.x; u < count + (first ? ny : 0); u += blockDim.x) {
    const bool nyquist = u >= count;
    const int ky = nyquist ? u - count : quot(u, dc);
    const int c = nyquist ? 0 : u - ky * cols;
    float2 v;
    if (first && c == 0) {
      const float2 y1 = buf[yout(ky) * cols];
      const float2 y2 = buf[yout(ky == 0 ? 0 : ny - ky) * cols];
      v = nyquist ? make_float2(0.5f * (y1.y + y2.y), 0.5f * (y2.x - y1.x))
                  : make_float2(0.5f * (y1.x + y2.x), 0.5f * (y1.y - y2.y));
    } else {
      v = buf[yout(ky) * cols + c];
    }
    const long long at = g0 + (long long)ky * h + (nyquist ? h - 1 : c);
    yr[at] = v.x;
    yi[at] = v.y;
  }
}

// The inverse's read of its column tile: bin c0 + c of row ky (float
// offset g0 + ky * h + c, g0 as for store_bins) to ky * cols + c by
// cp.async, each float straight to its place.  Rank 0 (`first`) forms its
// column 0 as A + i B from the Hermitian parts A, B of the DC and Nyquist
// columns, (X[k] + conj X[-k]) / 2, by plain loads, so that their y
// inverses come out real.  Returns when this thread's copies have landed.
__device__ void load_bins(const float* xr, const float* xi, long long g0,
                          int ny, int cols, int h, float2* tile, bool first) {
  const Div dc = make_div(cols);
  for (int u = threadIdx.x; u < ny * cols; u += blockDim.x) {
    const int ky = quot(u, dc);
    const int c = u - ky * cols;
    const long long at = g0 + (long long)ky * h + c;
    if (first && c == 0) {
      const long long bt = g0 + (long long)(ky == 0 ? 0 : ny - ky) * h;
      const float Ar = 0.5f * (__ldg(xr + at) + __ldg(xr + bt));
      const float Ai = 0.5f * (__ldg(xi + at) - __ldg(xi + bt));
      const float Br = 0.5f * (__ldg(xr + at + h - 1) + __ldg(xr + bt + h - 1));
      const float Bi = 0.5f * (__ldg(xi + at + h - 1) - __ldg(xi + bt + h - 1));
      tile[u] = make_float2(Ar - Bi, Ai + Br);
    } else {
      float* d = reinterpret_cast<float*>(tile + u);
      cp_async4(d, xr + at);
      cp_async4(d + 1, xi + at);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Column tiles -> row tiles: point (ky, c) of this block's column tile, at
// yout(ky) * cols + c, goes to bin j = c0 + c of row ky % rows of owner ky
// / rows's row tile, at its natural place there: row r at r * sz, bin j =
// a * n1z + b at a * pz + b = j + a * (pz - n1z).  Each thread reads its
// points into registers, the cluster meets (every column tile is read),
// it stores them, and the cluster meets again; indices as in push_bins.
__device__ void push_rows(cg::cluster_group& cluster, float2* buf,
                          const Geo& geo, const RowPerm& yout) {
  const int T = blockDim.x;
  const int cols = geo.cols;
  float2 v[kXchg];
#pragma unroll
  for (int j = 0; j < kXchg; ++j) {
    const int u = min(fresh_tid() + j * T, geo.last);
    const int ky = quot(u, geo.dcols);
    v[j] = buf[yout(ky) * cols + u - ky * cols];
  }
  cluster.sync();   // every column tile is read: the buffers are free
  const int c0 = block_rank() * cols;
#pragma unroll
  for (int j = 0; j < kXchg; ++j) {
    const int u0 = fresh_tid() + j * T;
    const int u = min(u0, geo.last);
    const int ky = quot(u, geo.dcols);
    const int owner = quot(ky, geo.drows);
    const int b = c0 + u - ky * cols;
    if (u0 <= geo.last)
      st_remote2(remote(buf,
                        (ky - owner * geo.rows) * geo.sz + b +
                            quot(b, geo.dz1) * (geo.pz - (int)geo.dz1.d),
                        owner),
                 v[j]);
  }
  cluster.sync();   // every push has landed
}

// Two instantiations: kGeneric 0 for planes whose stages all have a
// butterfly of their own (no spill), 1 with the generic stage.
template <int kGeneric>
__global__ void __launch_bounds__(kThreads, 1)
r2c_pair_kernel(const float* x, float* yr, float* yi, Plan pz1, Plan pz2,
                Plan py1, Plan py2, const float2* tz1, const float2* tz2,
                const float2* ty1, const float2* ty2, const float2* twz,
                const float2* twy, Geo geo) {
  extern __shared__ __align__(16) float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  copy_plane_tables(smem + geo.area, geo, tz1, tz2, ty1, ty2, twz, twy);
  // the row tile as complex pairs, natural order
  load_pairs_async(reinterpret_cast<const float2*>(x),
                   (plane_index() * geo.ny +
                    (long long)block_rank() * geo.rows) * geo.m,
                   geo.tile,
                   make_map(geo.m, geo.sz, false, pz1.n, pz2.n, geo.pz),
                   smem);
  __syncthreads();
  // the z axis along the rows, the untangle and exchange, the y axis down
  // the columns; one call site of run_pass keeps one copy of each stage
  for (int k = 0; k < 4; ++k) {
    // the exchange's values built afresh in its branch, not hoisted out
    // of the loop and held through the passes
    if (k == 2)
      push_bins(cluster, smem, geo, RowAt{geo.dz2, geo.sz, geo.pz},
                smem + geo.area + fresh(geo.ulo));
    axis_pass<kGeneric != 0>(smem, geo, k >= 2, (k & 1) == 1, pz1, pz2,
                             py1, py2);
  }
  store_bins(smem, geo.ny, geo.cols, geo.m + 1,
             RowPerm{geo.dy2, py1.n}, yr, yi,
             plane_index() * geo.ny * (geo.m + 1) +
                 block_rank() * geo.cols,
             block_rank() == 0);
}

__global__ void __launch_bounds__(kThreads, 1)
c2r_pair_kernel(const float* xr, const float* xi, float* y, Plan pz1,
                Plan pz2, Plan py1, Plan py2, const float2* tz1,
                const float2* tz2, const float2* ty1, const float2* ty2,
                const float2* twz, const float2* twy, float scale_z, Geo geo) {
  extern __shared__ __align__(16) float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  copy_plane_tables(smem + geo.area, geo, tz1, tz2, ty1, ty2, twz, twy);
  load_bins(xr, xi,
            plane_index() * geo.ny * (geo.m + 1) +
                block_rank() * geo.cols,
            geo.ny, geo.cols, geo.m + 1, smem, block_rank() == 0);
  __syncthreads();
  // the y axis down the columns, the exchange, the untangle, the z axis
  // along the rows; each phase builds its own maps (fresh)
  for (int k = 0; k < 4; ++k) {
    if (k == 2) {
      push_rows(cluster, smem, geo, RowPerm{geo.dy2, py1.n});
      untangle_inverse(smem, geo.rows, geo.m,
                       make_map(fresh(geo.m), geo.sz, false, fresh(pz1.n),
                                pz2.n, geo.pz),
                       smem + geo.area + fresh(geo.ulo), scale_z);
    }
    axis_pass(smem, geo, k < 2, (k & 1) == 1, pz1, pz2, py1, py2);
  }
  store_pairs(smem, make_map(geo.m, geo.sz, true, pz1.n, pz2.n, geo.pz),
              reinterpret_cast<float2*>(y),
              (plane_index() * geo.ny +
               (long long)block_rank() * geo.rows) * geo.m,
              geo.tile);
}

// The layout of the plans (cuda_kernels.r2c_pair_layout) as a Geo, or
// false when (cluster, threads, smem) is not it: every stage's round holds
// a whole sequence, a thread moves at most kXchg points of an exchange,
// and the shared bytes are exact.
bool layout_of(const Plan& pz1, const Plan& pz2, const Plan& py1,
               const Plan& py2, int cluster, int threads, int smem, Geo* geo) {
  const int m = pz1.n * pz2.n, ny = py1.n * py2.n;
  if (!vkfft::cluster::cluster_ok(cluster, ny, m) || threads < 32 ||
      threads > kThreads || threads % 32 != 0 ||
      (long long)ny * m / cluster > (long long)kXchg * threads ||
      !rounds_fit(pz1, threads) || !rounds_fit(pz2, threads) ||
      !rounds_fit(py1, threads) || !rounds_fit(py2, threads) || smem < 0)
    return false;
  geo->m = m;
  geo->ny = ny;
  geo->rows = ny / cluster;
  geo->cols = m / cluster;
  geo->tile = geo->rows * m;
  geo->mh = m / 2;
  geo->ch = geo->cols / 2;
  geo->last = geo->tile - 1;
  geo->hlast = geo->tile / 2 - 1;
  geo->pz = pz1.n | 1;
  geo->sz = pz2.n * geo->pz;
  // the row tile as the z factors' rows (the column tile, ny * m / C
  // points, fits it)
  geo->area = geo->rows * geo->sz;
  geo->z2 = table_len(pz1);
  geo->y1 = geo->z2 + table_len(pz2);
  geo->y2 = geo->y1 + table_len(py1);
  geo->twz = geo->y2 + table_len(py2);
  geo->ulo = geo->twz + kTwLo + (m + kTwLo - 1) / kTwLo;
  geo->twy = geo->ulo + kTwLo + (m / 2) / kTwLo + 1;
  geo->ntab = geo->twy + kTwLo + (ny + kTwLo - 1) / kTwLo;
  geo->dm = make_div(m);
  geo->dhalf = make_div(m / 2 > 0 ? m / 2 : 1);
  geo->dcols = make_div(geo->cols);
  geo->dhcols = make_div(geo->cols / 2 > 0 ? geo->cols / 2 : 1);
  geo->drows = make_div(geo->rows);
  geo->dz1 = make_div(pz1.n);
  geo->dz2 = make_div(pz2.n);
  geo->dy2 = make_div(py2.n);
  return (size_t)smem == sizeof(float2) * ((size_t)geo->area + geo->ntab) &&
         smem <= vkfft::kMaxSmemBytes;
}

// The checks of a launch: the plans (all forward, or all inverse), the
// layout, the real side 8-byte aligned.
int prepare(long long planes, const int* plan_z1, const int* plan_z2,
            const int* plan_y1, const int* plan_y2, const float* twiddle_z,
            const float* twiddle_y, int inverse, const void* real,
            int cluster, int threads, int smem, Plan* p, Geo* geo) {
  if (planes < 1 || ((uintptr_t)real & 7) != 0 ||
      !vkfft::plan_from_ints(plan_z1, &p[0]) ||
      !vkfft::subplan_from_ints(plan_z2, &p[1]) ||
      !vkfft::plan_from_ints(plan_y1, &p[2]) ||
      !vkfft::subplan_from_ints(plan_y2, &p[3]) || twiddle_z == nullptr ||
      twiddle_y == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 4; ++k)
    if (p[k].inverse != inverse) return (int)cudaErrorInvalidValue;
  if (p[0].n < p[1].n || p[2].n < p[3].n ||
      !layout_of(p[0], p[1], p[2], p[3], cluster, threads, smem, geo))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() after the launch (0 on
// success).  x is real (planes, ny, nz) data, 8-byte aligned, and yr/yi the
// (planes, ny, nz/2+1) spectrum planes.  Plans (int form) of the two
// factors of each axis, m = nz/2 = z1 * z2 and ny = y1 * y2 (all forward;
// the second the empty plan of length 1 for one pass), their stage tables
// (no scale), the z twiddles (cuda_kernels.r2c_twiddle(nz): the m-point
// inter-factor twiddle's two tables, then the untangle's roots w_nz^k as
// two tables) and the y axis's inter-factor twiddle as two tables (64
// points w_ny^b, then ceil(ny / 64) points w_ny^(64 a)), all as
// interleaved fp32 pairs.  The layout (cuda_kernels.r2c_pair_layout):
// `cluster` blocks a plane (1, 2, 4, 8 or 16, dividing ny and m), `threads`
// a block and the dynamic shared bytes, exactly; any other layout is
// refused (cudaErrorInvalidValue).  Plans whose stages all have a
// butterfly of their own run r2c_pair_kernel<0>, the others <1>.
int vk_fft_r2c_pair(const float* x, float* yr, float* yi, long long planes,
                    const int* plan_z1, const int* plan_z2, const int* plan_y1,
                    const int* plan_y2, const float* table_z1,
                    const float* table_z2, const float* table_y1,
                    const float* table_y2, const float* twiddle_z,
                    const float* twiddle_y, int cluster, int threads, int smem,
                    void* stream) {
  Plan p[4];
  Geo geo;
  const int err = prepare(planes, plan_z1, plan_z2, plan_y1, plan_y2,
                          twiddle_z, twiddle_y, 0, x, cluster, threads, smem,
                          p, &geo);
  if (err) return err;
  const bool generic = has_generic(p[0]) || has_generic(p[1]) ||
                       has_generic(p[2]) || has_generic(p[3]);
  return vkfft::cluster::launch_cluster(
      generic ? &r2c_pair_kernel<1> : &r2c_pair_kernel<0>, planes, cluster,
      threads, (size_t)smem, stream, x, yr, yi, p[0], p[1], p[2], p[3],
      reinterpret_cast<const float2*>(table_z1),
      reinterpret_cast<const float2*>(table_z2),
      reinterpret_cast<const float2*>(table_y1),
      reinterpret_cast<const float2*>(table_y2),
      reinterpret_cast<const float2*>(twiddle_z),
      reinterpret_cast<const float2*>(twiddle_y), geo);
}

// The inverse: xr/xi the (planes, ny, nz/2+1) spectrum planes, y the real
// (planes, ny, nz) output, 8-byte aligned, scaled by ny * scale_y * (nz/2)
// * scale_z: the plans and both inter-factor twiddles inverse, scale_y in
// the y twiddle's second table, scale_z applied in the untangle.
int vk_fft_c2r_pair(const float* xr, const float* xi, float* y,
                    long long planes, const int* plan_z1, const int* plan_z2,
                    const int* plan_y1, const int* plan_y2,
                    const float* table_z1, const float* table_z2,
                    const float* table_y1, const float* table_y2,
                    const float* twiddle_z, const float* twiddle_y,
                    float scale_z, int cluster, int threads, int smem,
                    void* stream) {
  Plan p[4];
  Geo geo;
  const int err = prepare(planes, plan_z1, plan_z2, plan_y1, plan_y2,
                          twiddle_z, twiddle_y, 1, y, cluster, threads, smem,
                          p, &geo);
  if (err) return err;
  return vkfft::cluster::launch_cluster(
      c2r_pair_kernel, planes, cluster, threads, (size_t)smem, stream, xr, xi,
      y, p[0], p[1], p[2], p[3], reinterpret_cast<const float2*>(table_z1),
      reinterpret_cast<const float2*>(table_z2),
      reinterpret_cast<const float2*>(table_y1),
      reinterpret_cast<const float2*>(table_y2),
      reinterpret_cast<const float2*>(twiddle_z),
      reinterpret_cast<const float2*>(twiddle_y), scale_z, geo);
}

// Resident clusters on the card and blocks an SM of the forward (inverse
// = 0; its instantiation with the generic stage where `generic`) or
// inverse kernel at `cluster` blocks of `threads` with `smem` dynamic
// shared bytes, into *clusters and *blocks.
int vk_fft_r2c_pair_occupancy(int inverse, int generic, int cluster,
                              int threads, int smem, int* clusters,
                              int* blocks) {
  if (!vkfft::cluster::cluster_ok(cluster, cluster, cluster) || threads < 32 ||
      threads > kThreads || smem < 0 || clusters == nullptr ||
      blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  return inverse ? vkfft::cluster::cluster_occupancy(
                       c2r_pair_kernel, cluster, threads, smem, clusters,
                       blocks)
                 : vkfft::cluster::cluster_occupancy(
                       generic ? &r2c_pair_kernel<1> : &r2c_pair_kernel<0>,
                       cluster, threads, smem, clusters, blocks);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
