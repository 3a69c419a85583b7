// The pieces of the real-to-real kernels on the in-place walk (inplace.cuh)
// that fft_dct23.cu, fft_dct1.cu and fft_dct4.cu share, built for sm_90a.
//
// A block holds its complex pipelines once in shared memory, each as the
// (n2, n1) matrix at the odd pitch n1 | 1 of two_factor_passes, beside the
// factors' stage tables, the inter-factor twiddle's two tables and the
// rotations' tables, all copied in first.  Its real lines are one
// contiguous run of floats, read by cp.async, each float (or pair of
// floats) straight to the point it feeds (the permutation and the
// reversal of each transform are the read's indices; a thread takes the
// floats of both lines of a pipeline that share their points); a sweep in
// place may then finish the points where they lie (a pre-rotation, a pair
// combine),
// the stages run in place, and the write takes each bin, or each pair of
// bins, the outputs need once and stores every output it feeds: the
// outputs' arithmetic, not the bytes, set these kernels' time (PERF.md,
// PR 14 run 4), so a bin is read once, not once an output.  Neighbouring
// threads take neighbouring bins, so each store of a warp is a contiguous
// run.  A block reads all its lines before it writes any.
//
// A rotation table holds value(e) = scale * w^(e + shift) for e < count as
// the walk's two tables: lo[b] = w^b for b < 64, then hi[a] = scale *
// w^(64 a + shift) (cuda_kernels._rotation_table), read as root(tab, e).
#pragma once

#include "inplace.cuh"
#include "real_walk.cuh"
#include "twofactor.cuh"

namespace vkfft {
namespace walk {

// A launch's geometry, every count and divisor computed by the host and
// read from the kernel's parameters where it is used (held in registers
// from the read through the passes, a divisor spilled): the real line's
// length and its pairs of floats (ceil(n / 2)), the pipeline's points
// and its factors n1 (row-major map) and n2 (transposed map), the
// kernel's units a pipeline in its build or write (pairs of points or
// bins); pipelines a block, the pitch n1 | 1, the stage tables' points,
// the twiddle points and where the rotation tables start among them.
struct Geo {
  Div dl, dh, dp, d1, d2, dper;
  int lines, pitch, len1, len2, ntw, rot1, rot2;
};

inline Geo make_geo(int n, const Plan& p1, const Plan& p2, int per,
                    int lines, int ntw, int rot1, int rot2) {
  return {make_div(n), make_div((n + 1) / 2), make_div(p1.n * p2.n),
          make_div(p1.n), make_div(p2.n), make_div(per), lines, p1.n | 1,
          table_len(p1), table_len(p2), ntw, rot1, rot2};
}

// The pipelines' places: natural order in (row-major (n2, n1) at pitch P),
// the spectrum's natural order out (transposed).
__device__ __forceinline__ Map in_map(const Geo& g) {
  return Map{g.dp, g.d1, (int)g.d2.d * g.pitch, g.pitch, 1};
}

__device__ __forceinline__ Map out_map(const Geo& g) {
  return Map{g.dp, g.d2, (int)g.d2.d * g.pitch, 1, g.pitch};
}

// Shared memory: the pipelines, then the stage tables, then the twiddles.
__device__ __forceinline__ float2* stage_tables_at(float2* smem, const Geo& g) {
  return smem + g.lines * (int)g.d2.d * g.pitch;
}

__device__ __forceinline__ float2* twiddles_at(float2* smem, const Geo& g) {
  return stage_tables_at(smem, g) + g.len1 + g.len2;
}

// Re(a * b).
__device__ __forceinline__ float re_mul(float2 a, float2 b) {
  return a.x * b.x - a.y * b.y;
}

// The DFT of the block's `nl` pipelines in place (two_factor_passes).
__device__ __forceinline__ void dct_passes(float2* smem, const Geo& g,
                                           const Plan& p1, const Plan& p2,
                                           int nl, bool mirrored) {
  const float2* s1 = stage_tables_at(smem, g);
  const float2* tw = twiddles_at(smem, g);
  two_factor_passes(smem, nl, p1, p2, s1, s1 + g.len1, tw, tw + kTwLo,
                    g.pitch, mirrored);
}

}  // namespace walk
}  // namespace vkfft
