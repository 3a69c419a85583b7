// fft_dd: the double-double ("fp64" tier) C2C FFT of quad planes (re.hi,
// re.lo, im.hi, im.lo, four fp32 planes of one shape), natural order in
// and out, forward or inverse.  Four C entries:
//   vk_fft_dd_lines      replaces vkfft_tpu/precision/dd_kernel.py:166
//                        _dd_fft_kernel: each line of (B, n) planes;
//   vk_fft_dd_strided    replaces vkfft_tpu/precision/dd_kernel.py:259
//                        _dd_strided_kernel: the middle axis of (P, n, S)
//                        planes, S contiguous, no transpose;
//   vk_dd_pointwise      (x * t + c) * scale, for the few dd points no DFT
//                        pass carries (Rader's X0);
//   vk_fft_dd_occupancy  resident blocks an SM of a DFT entry's kernel.
// The DFT entries carry the tier's dd products, which the JAX package runs
// as XLA ops between its kernels: y = (DFT(x * pre) * post + add) * scale,
// with pre/post tables of (L, 4) quads read at each point's flat position
// modulo L (the four-step twiddle, the Bluestein chirps and spectra,
// Rader's spectrum), a per-line quad `add` (Rader's x0, lines only) and a
// dd scale (the inverse's 1/N).
//
// Arithmetic: dd.cuh, whose EFTs use __fadd_rn/__fsub_rn/__fmul_rn and an
// explicit fma in two_prod because nvcc contracts plain operators into
// fmas by default (see the note there).  This source must not be built
// with --use_fast_math or -ftz=true.
//
// Two instantiations of each DFT entry, by the radices a plan may hold
// (the host picks one, precision/dd_kernel.py dd_variant, and the entry
// refuses a plan with a radix its instantiation lacks):
//   kPow2     radices 2, 4, 8: every power of two, so every length of the
//             main path (64, 256, 1024 and the four-step's 256); built
//             for three 256-thread blocks an SM: 80 registers, no spill;
//   kGeneral  radices 2, 3, 4, 5, 7, 8, 11, 13: every 13-smooth n; built
//             for two blocks: 128 registers, no spill.
// (ptxas for sm_90a; chip_smoke.py's toolchain phase prints both.)  With
// every radix in one kernel, each length paid for dft_odd<13> (13 dd
// points and its sums): 214-216 registers and one block an SM.
//
// Bound.  A pass reads and writes each point once, 32 B of planes: 0.0401
// ms for 2^22 points at 3.35 TB/s.  The other floor is issue: a dd add is
// 11 fp32 instructions (two_sum 6, two adds, quick_two_sum 3), a dd
// product 7 (a product, three fmas, quick_two_sum 3), each one issue slot
// of an SM's 128 fp32 lanes (132 SMs at 1.98 GHz: 33.5 T instructions/s),
// not the 2 flops of an fma that 67 TFLOP/s counts.  As compiled, a radix-8
// stage with its twiddle is one basic block of ~1044 instructions for 8
// points (130 a point, 966 of them fp32) and a radix-4 stage without one
// ~52 a point, so n = 256 (8, 8, 4) issues ~340 instructions a point with
// its reads and writes: ~0.043 ms for 2^22 points, n = 1024 (8, 8, 4, 4)
// ~0.054.  Both floors sit near each other; on an H100 the lines entry
// takes about twice the issue floor (0.089 ms at 16384 x 256), the rest
// being the barrier after each stage and the chains of dependent EFT adds.
//
// Design (the shared-memory Stockham of stockham.cuh, with 16 B points):
// a block holds max(1, 2048/n) whole lines, or a tile of ts neighbouring
// columns across all n rows of one p (ts the largest power of two <=
// min(32, 2048/n), and no wider than S rounded up to a power of two, so a
// thread keeps one column), as float4 quads in two buffers (64 KB; 128 KB
// at n = 4096, the cap) and runs every stage there, so device memory sees
// one read and one write of each point and the tables.  Lines are read and
// written as four coalesced plane streams; a tile reads each row as four
// runs of ts columns (32 B, one sector a plane, at n = 256).  A block
// reads all its input before it writes.  What the design does about its
// floors: three blocks an SM, so one block's reads and writes overlap
// another's stages; each thread issues all its reads of a round before its
// first store to shared memory; the stage's twiddle a template parameter
// (a runtime test per output split each butterfly into basic blocks the
// compiler could not interleave); index work off the fp32 pipe: each
// stage's L and Mp computed once on the host, shifts and masks in kPow2,
// table positions and lines advanced by 32-bit adds from one remainder a
// thread.  The JAX kernel's 128 lines in lanes and its VMEM cap of 2048
// are the TPU's and are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dd.cuh"

namespace {

using vkdd::dd;
using vkdd::ddc;

constexpr int kMaxStages = 16;
constexpr int kMaxN = 4096;
constexpr int kBlockPoints = 2048;
constexpr int kPerThread = 8;  // kBlockPoints / kThreads
constexpr int kMaxTile = 32;
constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 232448;
constexpr long long kMaxTableLen = 0x7fffffffLL;

// The instantiations (dd_kernel.DD_POW2, DD_GENERAL) and the DFT entries
// (dd_kernel.DD_LINES, DD_STRIDED) as the host numbers them.
constexpr int kPow2 = 0;
constexpr int kGeneral = 1;
constexpr int kLines = 0;
constexpr int kStrided = 1;

// Resident blocks an SM each instantiation is built for, which sets its
// register cap (3 blocks of 256 threads: 80 registers; 2: 128).  ptxas
// spills nothing at these.
template <int V>
constexpr int kMinBlocks = V == kPow2 ? 3 : 2;

struct Plan {
  int n;
  int n_stages;
  int inverse;
  int radix[kMaxStages];
  int tw_off[kMaxStages];   // the stage's (r, Mp) twiddle block
  int dft_off[kMaxStages];  // the r roots w_r^k of an odd radix, else -1
  int L[kMaxStages];        // the stage's L and Mp (stockham.cuh), set
  int Mp[kMaxStages];       // here so the stage loop carries only s
};

bool radix_ok(int variant, int r) {
  if (r == 2 || r == 4 || r == 8) return true;
  return variant == kGeneral &&
         (r == 3 || r == 5 || r == 7 || r == 11 || r == 13);
}

// The host passes the plan of the fp32 kernels (stockham.cuh's Plan, from
// cuda_kernels.stage_tables) as ints: n, n_stages, inverse, then
// kMaxStages slots each of radix, tw_off and dft_off; its table's values
// arrive split into quads.  A radix the variant's kernels lack refuses.
bool plan_from_ints(const int* v, int variant, Plan* p) {
  if (variant != kPow2 && variant != kGeneral) return false;
  p->n = v[0];
  p->n_stages = v[1];
  p->inverse = v[2];
  if (p->n < 2 || p->n > kMaxN || p->n_stages < 1 ||
      p->n_stages > kMaxStages)
    return false;
  int M = p->n;
  for (int s = 0; s < kMaxStages; ++s) {
    p->radix[s] = v[3 + s];
    p->tw_off[s] = v[3 + kMaxStages + s];
    p->dft_off[s] = v[3 + 2 * kMaxStages + s];
    p->L[s] = p->Mp[s] = 0;
    if (s < p->n_stages) {
      const int r = p->radix[s];
      const bool odd = r % 2 == 1;
      if (!radix_ok(variant, r) || M % r != 0 || p->tw_off[s] < 0 ||
          (odd && p->dft_off[s] < 0))
        return false;
      M /= r;
      p->L[s] = p->n / (r * M);
      p->Mp[s] = M;
    }
  }
  return M == 1;
}

struct In4 {
  const float *rh, *rl, *ih, *il;
};
struct Out4 {
  float *rh, *rl, *ih, *il;
};

// The dd options of a pass; a null table is no factor.
struct Opts {
  const float4* pre;
  unsigned pre_len;
  const float4* post;
  unsigned post_len;
  const float4* add;  // one quad per line (lines only)
  dd scale;
  int scaled;
};

__device__ __forceinline__ ddc load(const In4& x, long long g) {
  return {{x.rh[g], x.rl[g]}, {x.ih[g], x.il[g]}};
}
__device__ __forceinline__ void store(const Out4& y, long long g, ddc v) {
  y.rh[g] = v.re.hi;
  y.rl[g] = v.re.lo;
  y.ih[g] = v.im.hi;
  y.il[g] = v.im.lo;
}

// The position modulo a table's length of the points a thread visits, g0,
// g0 + step, g0 + 2 step, ...: one 64-bit remainder a thread, then a
// 32-bit add and compare a point (len < 2^31, so at + step cannot wrap).
struct Walk {
  unsigned at, step, len;
  __device__ __forceinline__ Walk(const float4* table, long long g0,
                                  long long step_, unsigned len_)
      : at(0), step(0), len(len_) {
    if (table != nullptr) {
      at = (unsigned)(g0 % len_);
      step = (unsigned)(step_ % len_);
    }
  }
  __device__ __forceinline__ void next() {
    at += step;
    if (at >= len) at -= len;
  }
};

// y = (y * post + add) * scale at one point.
__device__ __forceinline__ ddc finish(ddc v, const float4* post,
                                      const float4* add, const Opts& o) {
  if (post != nullptr) v = vkdd::cmul(v, vkdd::from4(__ldg(post)));
  if (add != nullptr) v = vkdd::cadd(v, vkdd::from4(__ldg(add)));
  if (o.scaled) v = vkdd::rmul(v, o.scale);
  return v;
}

// ---------------------------------------------------------------------------
// The r-point dd DFTs; `emit(i, X_i)` takes output i.
// ---------------------------------------------------------------------------

template <class Emit>
__device__ __forceinline__ void dft2(ddc (&v)[2], Emit& emit) {
  emit(0, vkdd::cadd(v[0], v[1]));
  emit(1, vkdd::csub(v[0], v[1]));
}

// In place: v[k] <- X_k of the 4 points v[0..3].
__device__ __forceinline__ void dft4(ddc& a, ddc& b, ddc& c, ddc& d,
                                     int inverse) {
  const ddc t0 = vkdd::cadd(a, c), t1 = vkdd::csub(a, c);
  const ddc t2 = vkdd::cadd(b, d), t3 = vkdd::rot(vkdd::csub(b, d), inverse);
  a = vkdd::cadd(t0, t2);
  b = vkdd::cadd(t1, t3);
  c = vkdd::csub(t0, t2);
  d = vkdd::csub(t1, t3);
}

// o * w8, w8 = c (1 -+ i) (forward / inverse): one real product a part,
// ((o.re + o.im) c, (o.im - o.re) c) forward, the signs of o.im and o.re
// flipped by a select for the inverse, so no branch splits the butterfly.
__device__ __forceinline__ ddc mul_w8(ddc o, dd c, int inverse) {
  const dd im = inverse ? vkdd::neg(o.im) : o.im;
  const dd re = inverse ? vkdd::neg(o.re) : o.re;
  return {vkdd::mul(vkdd::add(o.re, im), c), vkdd::mul(vkdd::sub(o.im, re), c)};
}

// Two 4-point DFTs in place, the odd half's w8^k in place, then X[k] =
// E[k] + w8^k O[k] and X[k+4] = E[k] - w8^k O[k] as each pair is emitted:
// no copy of the eight points is live beside them.
template <class Emit>
__device__ __forceinline__ void dft8(ddc (&v)[8], int inverse, Emit& emit) {
  dft4(v[0], v[2], v[4], v[6], inverse);
  dft4(v[1], v[3], v[5], v[7], inverse);
  // cos(pi/4) in fp64, split exactly into hi + lo
  const dd c = {0x1.6a09e6p-1f, 0x1.9fcef4p-27f};
  v[3] = mul_w8(v[3], c, inverse);
  v[5] = vkdd::rot(v[5], inverse);
  v[7] = vkdd::rot(mul_w8(v[7], c, inverse), inverse);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    emit(k, vkdd::cadd(v[2 * k], v[2 * k + 1]));
    emit(k + 4, vkdd::csub(v[2 * k], v[2 * k + 1]));
  }
}

// Odd r: s_j = x_j + x_{r-j}, d_j = x_j - x_{r-j} (j <= h = (r-1)/2), then
// X_i = A + iB and X_{r-i} = A - iB with A = x_0 + sum_j s_j cos_ij and B =
// sum_j d_j sin_ij, the roots w_r^k already signed for the direction.
template <int R, class Emit>
__device__ __forceinline__ void dft_odd(ddc (&v)[R], const float4* roots,
                                        Emit& emit) {
  constexpr int H = (R - 1) / 2;
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    const ddc a = v[j], b = v[R - j];
    v[j] = vkdd::cadd(a, b);
    v[R - j] = vkdd::csub(a, b);
  }
  ddc y0 = v[0];
#pragma unroll
  for (int j = 1; j <= H; ++j) y0 = vkdd::cadd(y0, v[j]);
  emit(0, y0);
#pragma unroll
  for (int i = 1; i <= H; ++i) {
    ddc A = v[0], B;
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const float4 w = __ldg(roots + (i * j) % R);
      A = vkdd::cadd(A, vkdd::rmul(v[j], dd{w.x, w.y}));
      const ddc t = vkdd::rmul(v[R - j], dd{w.z, w.w});
      B = j == 1 ? t : vkdd::cadd(B, t);
    }
    emit(i, ddc{vkdd::sub(A.re, B.im), vkdd::add(A.im, B.re)});
    emit(R - i, ddc{vkdd::add(A.re, B.im), vkdd::sub(A.im, B.re)});
  }
}

// ---------------------------------------------------------------------------
// Stockham stages in shared memory (the recurrence of stockham.cuh):
//   A'[(i*L + l)*Mp + m] = w_M^(i*m) * sum_j w_r^(i*j) A[(l*r + j)*Mp + m]
// Sequence q's element k sits at q*qs + k*es: lines qs = n, es = 1; a
// strided tile qs = 1, es = ts (columns fastest across threads, ts a power
// of two).  kPow2: L, Mp and L*Mp are powers of two.
// ---------------------------------------------------------------------------

template <bool kPow2>
__device__ __forceinline__ int divide(int a, int b, int log2_b) {
  if constexpr (kPow2) return a >> log2_b;
  return a / b;
}

__device__ __forceinline__ int log2_of(int pow2) { return __ffs(pow2) - 1; }

// The block's and the thread's index, read anew where the write loop
// begins: the compiler then keeps no 64-bit position from the read loop
// in registers through the stages (at three blocks an SM it spilled it).
__device__ __forceinline__ unsigned block_index() {
  unsigned v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int thread_index() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}

// kTw: the stage has twiddles (Mp > 1).  A template parameter, not a test
// in `emit`: a branch per output cuts a butterfly into basic blocks the
// compiler cannot interleave, and the EFT chains then run one at a time.
template <int R, bool kColFast, bool kPow2, bool kTw>
__device__ __forceinline__ void stage(const float4* __restrict__ src,
                                      float4* __restrict__ dst, int lines,
                                      int qs, int es, int L, int Mp,
                                      const float4* __restrict__ tw,
                                      const float4* __restrict__ roots,
                                      int inverse) {
  const int per_line = L * Mp;
  const int total = lines * per_line;
  const int lg_mp = kPow2 ? log2_of(Mp) : 0;
  const int lg_line = kPow2 ? log2_of(per_line) : 0;
  const int lg_lines = kColFast ? log2_of(lines) : 0;
  const int in_step = Mp * es, out_step = per_line * es;
  for (int bt = threadIdx.x; bt < total; bt += kThreads) {
    int q, rem;
    if constexpr (kColFast) {
      q = bt & (lines - 1);
      rem = bt >> lg_lines;
    } else {
      q = divide<kPow2>(bt, per_line, lg_line);
      rem = bt - q * per_line;
    }
    const int l = divide<kPow2>(rem, Mp, lg_mp), m = rem - l * Mp;
    const float4* in = src + q * qs + (l * R * Mp + m) * es;
    float4* out = dst + q * qs + (l * Mp + m) * es;
    ddc v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = vkdd::from4(in[j * in_step]);
    // the twiddle is read as its output is emitted, not ahead of the DFT
    auto emit = [&](int i, ddc y) {
      if (kTw && i > 0)
        y = vkdd::cmul(y, vkdd::from4(__ldg(tw + i * Mp + m)));
      out[i * out_step] = vkdd::to4(y);
    };
    if constexpr (R == 2) {
      dft2(v, emit);
    } else if constexpr (R == 4) {
      dft4(v[0], v[1], v[2], v[3], inverse);
#pragma unroll
      for (int i = 0; i < 4; ++i) emit(i, v[i]);
    } else if constexpr (R == 8) {
      dft8(v, inverse, emit);
    } else {
      dft_odd<R>(v, roots, emit);
    }
  }
}

// Runs every stage over buffers a and b (stage s reads a for even s);
// returns the one holding the result.  Only the variant's radices are
// instantiated.
template <int V, bool kColFast>
__device__ __forceinline__ const float4* run_stages(
    float4* a, float4* b, int lines, int qs, int es, const Plan& p,
    const float4* __restrict__ table) {
  constexpr bool kP2 = V == kPow2;
  for (int s = 0; s < p.n_stages; ++s) {
    const int r = p.radix[s], L = p.L[s], Mp = p.Mp[s];
    const float4* src = s & 1 ? b : a;
    float4* dst = s & 1 ? a : b;
    // a stage's twiddles are all 1 where Mp == 1
    const float4* tw = Mp > 1 ? table + p.tw_off[s] : nullptr;
    const float4* roots = p.dft_off[s] >= 0 ? table + p.dft_off[s] : nullptr;
#define VKDD_STAGE(R)                                                       \
  case R:                                                                   \
    if (tw != nullptr)                                                      \
      stage<R, kColFast, kP2, true>(src, dst, lines, qs, es, L, Mp, tw,     \
                                    roots, p.inverse);                      \
    else                                                                    \
      stage<R, kColFast, kP2, false>(src, dst, lines, qs, es, L, Mp, tw,    \
                                     roots, p.inverse);                     \
    break;
    if constexpr (kP2) {
      switch (r) {
        VKDD_STAGE(2)
        VKDD_STAGE(4)
        VKDD_STAGE(8)
      }
    } else {
      switch (r) {
        VKDD_STAGE(2)
        VKDD_STAGE(3)
        VKDD_STAGE(4)
        VKDD_STAGE(5)
        VKDD_STAGE(7)
        VKDD_STAGE(8)
        VKDD_STAGE(11)
        VKDD_STAGE(13)
      }
    }
#undef VKDD_STAGE
    __syncthreads();
  }
  return p.n_stages & 1 ? b : a;
}

// Block b holds lines [b*lpb, b*lpb + lines); point i of the block is flat
// position base + i, thread t visits i = t, t + kThreads, ...
template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks<V>)
dd_lines_kernel(In4 x, Out4 y, long long batch, int lpb, Plan p,
                const float4* __restrict__ table, Opts o) {
  extern __shared__ float4 smem[];
  const int n = p.n;
  const long long line0 = (long long)blockIdx.x * lpb;
  const int lines = (int)min((long long)lpb, batch - line0);
  const long long base = line0 * n;
  const int count = lines * n;
  const int t = threadIdx.x;
  float4* a = smem;
  float4* b = smem + lpb * n;
  Walk pre(o.pre, base + t, kThreads, o.pre_len);
  // a round's loads all issue before its first store to shared memory
  for (int r0 = t; r0 < count; r0 += kBlockPoints) {
    ddc v[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (r0 + j * kThreads < count) v[j] = load(x, base + r0 + j * kThreads);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = r0 + j * kThreads;
      if (i >= count) break;
      if (o.pre != nullptr) {
        v[j] = vkdd::cmul(v[j], vkdd::from4(__ldg(o.pre + pre.at)));
        pre.next();
      }
      a[i] = vkdd::to4(v[j]);
    }
  }
  __syncthreads();
  const float4* res = run_stages<V, false>(a, b, lines, n, 1, p, table);
  const int tx = thread_index();
  const long long lw = (long long)block_index() * lpb, bw = lw * n;
  Walk post(o.post, bw + tx, kThreads, o.post_len);
  // the line of point i, tx / n at first, then kThreads / n lines and
  // kThreads % n points on a step
  int line = tx / n, pos = tx - line * n;
  const int dl = kThreads / n, dp = kThreads - dl * n;
  for (int i = tx; i < count; i += kThreads) {
    const ddc v = finish(vkdd::from4(res[i]),
                         o.post != nullptr ? o.post + post.at : nullptr,
                         o.add != nullptr ? o.add + lw + line : nullptr,
                         o);
    store(y, bw + i, v);
    post.next();
    line += dl;
    pos += dp;
    if (pos >= n) {
      pos -= n;
      ++line;
    }
  }
}

// The flat position of thread t's first point in block b's tile, and
// whether its column exists: block b holds columns [s0, s0 + cols) of
// plane pi (b < 2^31 blocks, so a 32-bit split); tile point i = k*ts + c
// is (pi, k, s0 + c); thread t keeps c = t % ts and steps k by kThreads /
// ts (ts divides kThreads).
__device__ __forceinline__ long long tile_start(unsigned b, int t, int n,
                                                long long S, int ts,
                                                int lg_ts, long long tiles,
                                                bool* live) {
  const unsigned pi = b / (unsigned)tiles;
  const long long s0 = (long long)(b - pi * (unsigned)tiles) * ts;
  const int c = t & (ts - 1);
  *live = c < S - s0;
  return (long long)pi * n * S + s0 + (long long)(t >> lg_ts) * S + c;
}

// Block b transforms one tile (tile_start); a column past S is read as
// zeros and not written.
template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks<V>)
dd_strided_kernel(In4 x, Out4 y, long long S, int ts, int lg_ts,
                  long long tiles, Plan p, const float4* __restrict__ table,
                  Opts o) {
  extern __shared__ float4 smem[];
  const int n = p.n;
  const int count = n * ts;
  const long long dg = (long long)(kThreads >> lg_ts) * S;
  bool live;
  const long long g0 = tile_start(blockIdx.x, threadIdx.x, n, S, ts, lg_ts,
                                  tiles, &live);
  const int t = threadIdx.x;
  float4* a = smem;
  float4* b = smem + count;
  Walk pre(o.pre, g0, dg, o.pre_len);
  long long g = g0;
  // a round's loads all issue before its first store to shared memory
  for (int r0 = t; r0 < count; r0 += kBlockPoints) {
    ddc v[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      v[j] = {{0.f, 0.f}, {0.f, 0.f}};
      if (live && r0 + j * kThreads < count) v[j] = load(x, g + j * dg);
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = r0 + j * kThreads;
      if (i >= count) break;
      if (o.pre != nullptr) {
        if (live) v[j] = vkdd::cmul(v[j], vkdd::from4(__ldg(o.pre + pre.at)));
        pre.next();
      }
      a[i] = vkdd::to4(v[j]);
    }
    g += kPerThread * dg;
  }
  __syncthreads();
  const float4* res = run_stages<V, true>(a, b, ts, 1, ts, p, table);
  const int tx = thread_index();
  g = tile_start(block_index(), tx, n, S, ts, lg_ts, tiles, &live);
  Walk post(o.post, g, dg, o.post_len);
  for (int i = tx; i < count; i += kThreads) {
    if (live)
      store(y, g, finish(vkdd::from4(res[i]),
                         o.post != nullptr ? o.post + post.at : nullptr,
                         nullptr, o));
    post.next();
    g += dg;
  }
}

__global__ void __launch_bounds__(kThreads)
dd_pointwise_kernel(In4 x, Out4 y, long long rows, long long cols, Opts o) {
  const long long total = rows * cols;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < total; g += (long long)gridDim.x * blockDim.x)
    store(y, g, finish(load(x, g),
                       o.post != nullptr ? o.post + g % o.post_len : nullptr,
                       o.add != nullptr ? o.add + g / cols : nullptr, o));
}

int make_opts(const float* pre, long long pre_len, const float* post,
              long long post_len, const float* add, float scale_hi,
              float scale_lo, Opts* o) {
  if ((pre != nullptr && (pre_len < 1 || pre_len > kMaxTableLen)) ||
      (post != nullptr && (post_len < 1 || post_len > kMaxTableLen)))
    return (int)cudaErrorInvalidValue;
  o->pre = reinterpret_cast<const float4*>(pre);
  o->pre_len = (unsigned)pre_len;
  o->post = reinterpret_cast<const float4*>(post);
  o->post_len = (unsigned)post_len;
  o->add = reinterpret_cast<const float4*>(add);
  o->scale = dd{scale_hi, scale_lo};
  o->scaled = !(scale_hi == 1.0f && scale_lo == 0.0f);
  return 0;
}

template <class Kernel>
int smem_opt_in(Kernel kernel, size_t smem) {
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

// Lines a block of the lines entry holds.
int lines_per_block(int n) { return n >= kBlockPoints ? 1 : kBlockPoints / n; }

// Columns a strided tile holds: the largest power of two <= min(kMaxTile,
// kBlockPoints / n), no wider than S rounded up to a power of two.
int tile_columns(int n, long long S) {
  int ts = 1;
  while (2 * ts <= kMaxTile && 2 * ts * n <= kBlockPoints) ts *= 2;
  while (ts > 1 && (long long)(ts / 2) >= S) ts /= 2;
  return ts;
}

int log2_int(int pow2) {
  int k = 0;
  while ((1 << k) < pow2) ++k;
  return k;
}

template <int V>
int launch_lines(const In4& x, const Out4& y, long long batch, const Plan& p,
                 const float4* table, const Opts& o, cudaStream_t stream) {
  const int lpb = lines_per_block(p.n);
  const size_t smem = 2 * (size_t)lpb * p.n * sizeof(float4);
  int err = smem_opt_in(dd_lines_kernel<V>, smem);
  if (err) return err;
  const long long blocks = (batch + lpb - 1) / lpb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dd_lines_kernel<V><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, y, batch, lpb, p, table, o);
  return (int)cudaGetLastError();
}

template <int V>
int launch_strided(const In4& x, const Out4& y, long long P, long long S,
                   const Plan& p, const float4* table, const Opts& o,
                   cudaStream_t stream) {
  const int ts = tile_columns(p.n, S);
  const size_t smem = 2 * (size_t)ts * p.n * sizeof(float4);
  int err = smem_opt_in(dd_strided_kernel<V>, smem);
  if (err) return err;
  const long long tiles = (S + ts - 1) / ts;
  const long long blocks = P * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dd_strided_kernel<V><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, y, S, ts, log2_int(ts), tiles, p, table, o);
  return (int)cudaGetLastError();
}

template <class Kernel>
int occupancy(Kernel kernel, size_t smem, int* blocks) {
  int err = smem_opt_in(kernel, smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            kThreads, smem);
}

}  // namespace

extern "C" {

// Each DFT entry launches on `stream` and returns cudaGetLastError() after
// the launch (0 on success).  Planes: the four input planes, then the four
// output planes.  `plan` is the int form of Plan, `table` its (L, 4)
// quads; pre/post are (len, 4) quad tables (len < 2^31) or null, `add`
// (batch, 4) quads or null; the scale is the dd pair (scale_hi, scale_lo);
// `variant` is kPow2 or kGeneral, and a plan with a radix outside it
// refuses (cudaErrorInvalidValue).
int vk_fft_dd_lines(const float* xrh, const float* xrl, const float* xih,
                    const float* xil, float* yrh, float* yrl, float* yih,
                    float* yil, long long batch, const int* plan,
                    const float* table, const float* pre, long long pre_len,
                    const float* post, long long post_len, const float* add,
                    float scale_hi, float scale_lo, int variant,
                    void* stream) {
  Plan p;
  Opts o;
  if (batch < 1 || !plan_from_ints(plan, variant, &p))
    return (int)cudaErrorInvalidValue;
  int err = make_opts(pre, pre_len, post, post_len, add, scale_hi, scale_lo, &o);
  if (err) return err;
  const In4 x{xrh, xrl, xih, xil};
  const Out4 y{yrh, yrl, yih, yil};
  const float4* tab = reinterpret_cast<const float4*>(table);
  cudaStream_t s = (cudaStream_t)stream;
  return variant == kPow2 ? launch_lines<kPow2>(x, y, batch, p, tab, o, s)
                          : launch_lines<kGeneral>(x, y, batch, p, tab, o, s);
}

int vk_fft_dd_strided(const float* xrh, const float* xrl, const float* xih,
                      const float* xil, float* yrh, float* yrl, float* yih,
                      float* yil, long long P, long long S, const int* plan,
                      const float* table, const float* pre, long long pre_len,
                      const float* post, long long post_len, float scale_hi,
                      float scale_lo, int variant, void* stream) {
  Plan p;
  Opts o;
  if (P < 1 || S < 1 || !plan_from_ints(plan, variant, &p))
    return (int)cudaErrorInvalidValue;
  int err = make_opts(pre, pre_len, post, post_len, nullptr, scale_hi,
                      scale_lo, &o);
  if (err) return err;
  const In4 x{xrh, xrl, xih, xil};
  const Out4 y{yrh, yrl, yih, yil};
  const float4* tab = reinterpret_cast<const float4*>(table);
  cudaStream_t s = (cudaStream_t)stream;
  return variant == kPow2
             ? launch_strided<kPow2>(x, y, P, S, p, tab, o, s)
             : launch_strided<kGeneral>(x, y, P, S, p, tab, o, s);
}

// Resident blocks an SM of the kernel that `variant` and `entry` (kLines,
// kStrided) launch for length n at its widest block (a strided tile of
// S >= 32 columns), into *blocks.
int vk_fft_dd_occupancy(int variant, int entry, int n, int* blocks) {
  if ((variant != kPow2 && variant != kGeneral) ||
      (entry != kLines && entry != kStrided) || n < 2 || n > kMaxN ||
      blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  const int width = entry == kLines ? lines_per_block(n)
                                    : tile_columns(n, kMaxTile);
  const size_t smem = 2 * (size_t)width * n * sizeof(float4);
  if (entry == kLines)
    return variant == kPow2 ? occupancy(dd_lines_kernel<kPow2>, smem, blocks)
                            : occupancy(dd_lines_kernel<kGeneral>, smem, blocks);
  return variant == kPow2
             ? occupancy(dd_strided_kernel<kPow2>, smem, blocks)
             : occupancy(dd_strided_kernel<kGeneral>, smem, blocks);
}

int vk_dd_pointwise(const float* xrh, const float* xrl, const float* xih,
                    const float* xil, float* yrh, float* yrl, float* yih,
                    float* yil, long long rows, long long cols,
                    const float* table, long long table_len, const float* add,
                    float scale_hi, float scale_lo, void* stream) {
  Opts o;
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  int err = make_opts(nullptr, 0, table, table_len, add, scale_hi, scale_lo, &o);
  if (err) return err;
  const long long total = rows * cols;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  dd_pointwise_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      In4{xrh, xrl, xih, xil}, Out4{yrh, yrl, yih, yil}, rows, cols, o);
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
