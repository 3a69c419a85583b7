// The in-place stage walk of the port's fp32 kernels (fft_twofactor.cu,
// fft_lines.cu, fft_r2c.cu, fft_pair.cu, fft_r2c_pair.cu, fft_strided.cu,
// fft_strided_tw.cu, fft_conv_pair.cu (both modes), fft_dct23.cu,
// fft_dct1.cu, fft_dct4.cu, fft_conv.cu, fft_conv_inv.cu), of the fp64
// instantiations of fft_lines.cu, fft_strided.cu and fft_pair.cu and of
// the half-storage ones of those and fft_twofactor.cu, built for sm_90a.
// Every piece takes the complex type C of the points (float2 or double2,
// stockham.cuh's Cx) as a template argument, deduced from the buffers it
// is given: one source, two instantiations.  The copies between device
// memory and shared memory also take the storage real St of the planes,
// deduced from their pointers: C's own real, or a half type (__half,
// __nv_bfloat16) on the fp32 walk, widened to float on the read and
// narrowed with round-to-nearest-even on the write, every stage, table
// and shared point staying float2 (the storage tiers: half the bytes of
// device memory, fp32 arithmetic).
//
// A block holds its sequences once in shared memory.  A Stockham stage of
// radix r (stockham.cuh's recurrence) maps the points whose index is m mod
// Mp onto the same points, so the butterflies of one (sequence, m) group
// only exchange among themselves: a stage runs in rounds of whole
// sequences, each thread computing its butterflies of the round in
// registers (at most kPoints points, or kGenericItems groups of
// kGenericPairs output pairs of a generic prime stage), the block meeting
// at a barrier, and each thread writing its
// outputs back to their Stockham positions in the same buffer.  Rounds
// touch disjoint points, so a stage costs one barrier a round and one at
// its end, and no second copy.  A round's idle slots compute a clamped
// butterfly and only their store is predicated: values held across a
// divergent branch made ptxas spill.  The sequence index is fastest across
// threads, so a warp's accesses sit one float2 or one odd pitch apart, on
// distinct banks.
//
// A Pass names the sequences (where each starts, how far apart its points
// are); a Hook multiplies the outputs of a pass's last stage (Mp = 1) by a
// factor of the sequence's index within its line and the output's index,
// on the values a thread already holds: fft_twofactor's inter-factor
// twiddle, fft_conv_pair's four-step twiddle and spectrum.  The stage
// tables are stockham.cuh's, copied into shared memory by the caller; they
// carry no scale, so the twiddle of output 0 is 1.
//
// The copies between device memory and a block's lines (load_lines,
// store_lines) move four reals a plane at once where the planes are
// aligned to four of them (a float4, two double2, or 8 bytes of halves; a
// line's unaligned head and tail as single reals), through a Map from
// a point to its place in shared memory; a thread's four points go in an
// order rotated by its lane, so a warp's accesses fall on distinct banks.
// load_pairs_async and store_pairs move one interleaved array, a point's
// float2 each (fft_r2c's real lines read as complex pairs).  store_lines
// may pass each point through a functor of its line and index on the way
// out (fft_conv_inv's per-line constant, fft_conv's Bluestein chirp).
// two_factor_block is the whole body of a block of lines on the walk, as
// the two-factor DFT (a column pass, the twiddle, a row pass), which
// fft_twofactor and fft_lines share.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstring>

#include "stockham.cuh"
#include "twofactor.cuh"

namespace vkfft {
namespace walk {

constexpr int kPoints = 12;        // most points a thread holds in a round
constexpr int kGenericPairs = 4;   // output pairs of a generic stage's item
constexpr int kGenericItems = 2;   // ... items a thread holds in a round
constexpr int kTwLo = 64;          // a twiddle's low table: w^b, b < 64

// The fp64 walk (C = double2, a point four registers) holds one generic
// item a round and has no radix-16 stage (its plans are stage_radices',
// radix 8 at most): with either, its kernels spilled at 128 registers.
template <class C>
constexpr int kItems = sizeof(C) == 8 ? kGenericItems : 1;
template <class C>
constexpr bool kRadix16 = sizeof(C) == 8;

// u / d by one multiply-high, exact while u * d < 2^32.
struct Div {
  unsigned d, m;
};

__host__ __device__ __forceinline__ Div make_div(int d) {
  return {(unsigned)d, d == 1 ? 0u : 0xffffffffu / (unsigned)d + 1u};
}

__device__ __forceinline__ int quot(int u, Div v) {
  return v.d == 1 ? u : (int)__umulhi((unsigned)u, v.m);
}

// The sequences of a pass: sequence q starts at (q / per) * S + (q % per)
// * qs (a line, then its column or row) and its points are es apart.
struct Pass {
  int seqs, S, qs, es;
  Div per;
};

__device__ __forceinline__ int seq_base(const Pass& g, int q, int& lo) {
  const int hi = quot(q, g.per);
  lo = q - hi * (int)g.per.d;
  return hi * g.S + lo * g.qs;
}

// Butterfly b of a round of nq sequences -> (q, l, m), the sequence
// fastest, then m.
__device__ __forceinline__ void decode(int b, Div dq, Div dm, int& q, int& l,
                                       int& m) {
  const int t = quot(b, dq);
  q = b - t * (int)dq.d;
  l = quot(t, dm);
  m = t - l * (int)dm.d;
}

// threadIdx.x, read afresh where it is used: a thread's item indices
// tid + k * T are then formed in each round, not hoisted out of the round
// loop into registers held (and spilled) through the whole stage.
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// The block's first line for `per` lines a block, blockIdx.x read afresh
// where it is used, so it is not held through the passes.
__device__ __forceinline__ long long block_line0(int per) {
  unsigned b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return (long long)b * per;
}

// The block's count of lines, `per` a block.
__device__ __forceinline__ int block_lines(int per, long long batch) {
  return (int)min((long long)per, batch - block_line0(per));
}

// v through a move the compiler cannot see through: what is computed from
// it is computed again, not held.
__device__ __forceinline__ int fresh_int(int v) {
  int t;
  asm volatile("mov.b32 %0, %1;" : "=r"(t) : "r"(v));
  return t;
}

// w^e = hi[e >> 6] * lo[e & 63] from a twiddle's two tables.
template <class C>
__device__ __forceinline__ C inter_twiddle(int e, const C* lo, const C* hi) {
  return cmul(hi[e >> 6], lo[e & (kTwLo - 1)]);
}

// fft_twofactor's inter-factor twiddle: output k of sequence `seq` times
// w^(seq * k) from its two tables (the scale in `hi`); off when lo is null.
template <class C>
struct InterTwiddleT {
  const C* lo;
  const C* hi;
  __device__ __forceinline__ bool on() const { return lo != nullptr; }
  __device__ __forceinline__ InterTwiddleT off() const {
    return {nullptr, hi};
  }
  __device__ __forceinline__ C operator()(C v, int seq, int k) const {
    return cmul(v, inter_twiddle(seq * k, lo, hi));
  }
};
using InterTwiddle = InterTwiddleT<float2>;

// a * w_16^e (e < 16 known at compile time once unrolled), forward or
// inverse.
template <class C>
__device__ __forceinline__ C times_w16(C a, int e, int inverse) {
  using T = Real<C>;
  constexpr T c1 = T(0.92387953251128674);   // cos(pi / 8)
  constexpr T s1 = T(0.38268343236508978);   // sin(pi / 8)
  constexpr T r2 = T(0.70710678118654752);
  if (e == 0) return a;
  if (e == 4) return rot(a, inverse);
  // w_16^e = (x, -+y)
  const T x = e == 1 ? c1 : e == 2 ? r2 : e == 3 ? s1 : e == 6 ? -r2 : -c1;
  const T y = e == 1 ? s1 : e == 2 ? r2 : e == 3 ? c1 : e == 6 ? r2 : -s1;
  return cmul(a, cx<C>(x, inverse ? y : -y));
}

// The r-point DFT in registers; the odd radices read their roots w_r^k
// from shared memory.  Radix 16 runs as 4 x 4: X[k1 + 4 k2] = DFT4 over
// n2 of w_16^(n2 k1) DFT4 over n1 of x[4 n1 + n2].
template <int R, class C>
__device__ __forceinline__ void dft(C (&v)[R], int inverse, const C* w) {
  if constexpr (R == 2 || R == 4 || R == 8) {
    Dft<R>::run(v, inverse, (const C*)nullptr);
  } else if constexpr (R == 16) {
    C a[4][4];
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      C t[4] = {v[n2], v[4 + n2], v[8 + n2], v[12 + n2]};
      Dft<4>::run(t, inverse, (const C*)nullptr);
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1) a[n2][k1] = times_w16(t[k1], n2 * k1, inverse);
    }
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      C t[4] = {a[0][k1], a[1][k1], a[2][k1], a[3][k1]};
      Dft<4>::run(t, inverse, (const C*)nullptr);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) v[k1 + 4 * k2] = t[k2];
    }
  } else {
    C wk[R];
#pragma unroll
    for (int k = 0; k < R; ++k) wk[k] = w[k];
    C out[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      C acc = v[0];
#pragma unroll
      for (int j = 1; j < R; ++j) {
        const C t = wk[(i * j) % R];
        acc.x = madd(v[j].x, t.x, madd(-v[j].y, t.y, acc.x));
        acc.y = madd(v[j].x, t.y, madd(v[j].y, t.x, acc.y));
      }
      out[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = out[i];
  }
}

// Butterflies a thread holds in a round of a fixed radix-R stage.
__host__ __device__ constexpr int round_butterflies(int R) {
  return kPoints / R > 0 ? kPoints / R : 1;
}

// One radix-R stage (R = 2, 3, 4, 5, 7, 8, 16) of a pass, in place: one
// thread a butterfly, round_butterflies(R) of them a round, each finished in
// registers before the barrier, so only its values and its output
// address live across it.  When the hook is on, output i of butterfly l
// of sequence (hi, lo) goes through hook(v, lo, i * L + l) (the last
// stage: Mp = 1).
template <int R, class C, class Hook>
__device__ void stage_fixed(C* buf, const Pass& g, int L, int Mp,
                            const C* tw, const C* w, int inverse,
                            const Hook& hook) {
  constexpr int K = round_butterflies(R);
  const int T = blockDim.x;
  const int per_seq = L * Mp;
  const int Q = min(g.seqs, K * T / per_seq);
  const Div dm = make_div(Mp);
  const int jstep = Mp * g.es;
  const int istep = L * Mp * g.es;
  for (int q0 = 0; q0 < g.seqs; q0 += Q) {
    const int nq = min(Q, g.seqs - q0);
    const Div dq = make_div(nq);
    const int total = nq * per_seq;
    C v[K][R];
    int dst[K];
    int b = fresh_tid();
#pragma unroll
    for (int k = 0; k < K; ++k, b += T) {
      int q, l, m, lo;
      decode(min(b, total - 1), dq, dm, q, l, m);
      const int base = seq_base(g, q0 + q, lo);
      const C* s = buf + base + (l * R * Mp + m) * g.es;
#pragma unroll
      for (int j = 0; j < R; ++j) v[k][j] = s[j * jstep];
      dft<R>(v[k], inverse, w);
#pragma unroll
      for (int i = 1; i < R; ++i) v[k][i] = cmul(v[k][i], tw[i * Mp + m]);
      if (hook.on()) {
#pragma unroll
        for (int i = 0; i < R; ++i) v[k][i] = hook(v[k][i], lo, i * L + l);
      }
      dst[k] = base + (l * Mp + m) * g.es;
    }
    __syncthreads();
    b = fresh_tid();
#pragma unroll
    for (int k = 0; k < K; ++k, b += T) {
      if (b < total) {
#pragma unroll
        for (int i = 0; i < R; ++i) buf[dst[k] + i * istep] = v[k][i];
      }
    }
  }
  __syncthreads();
}

// Items of a generic radix-R stage a butterfly: groups of kGenericPairs
// of its (R + 1) / 2 output pairs (i, R - i), i <= H = (R - 1) / 2, the pair
// i = 0 standing for the output X_0 alone.
__host__ __device__ __forceinline__ int generic_groups(int R) {
  return (R / 2 + kGenericPairs) / kGenericPairs;
}

// Any other radix (the primes 11..127), in the symmetric form of
// fft_dd.cu's dft_odd: with s_j = x_j + x_{R-j} and d_j = x_j - x_{R-j}
// for j <= H, X_i = A + iB and X_{R-i} = A - iB, where A = x_0 + sum_j s_j
// Re w^(ij) and B = sum_j d_j Im w^(ij), the roots w already signed for
// the direction (w^0 = 1: X_0 = A).  A thread's item is kGenericPairs
// pairs i = i0 .. i0 + 3 of one butterfly (i0 a multiple of 4, at most H),
// computed from one read of each s_j and d_j: R reads for up to
// 2 kGenericPairs outputs, and a real times a complex value a term, where
// one output of a plain sum takes R reads and a complex product a term.
// A thread holds kGenericItems items a round; the group slowest across
// threads, so a warp's root reads are broadcasts.  A pair past H (i <= H +
// 3 < R, an index of the butterfly) is computed as any other and only its
// store is predicated; so is an idle slot's clamped item.  The item's
// indices are found again after its sums, not held through them.
template <class C, class Hook>
__device__ void stage_generic(C* buf, const Pass& g, int R, int L,
                              int Mp, const C* tw, const C* w,
                              const Hook& hook) {
  constexpr int G = kGenericPairs, K = kItems<C>;
  const int T = blockDim.x;
  const int H = R >> 1;
  const int groups = generic_groups(R);
  const int per_seq = L * Mp;
  const int Q = min(g.seqs, K * T / (per_seq * groups));
  const Div dm = make_div(Mp);
  const int jstep = Mp * g.es;
  for (int q0 = 0; q0 < g.seqs; q0 += Q) {
    const int nq = min(Q, g.seqs - q0);
    const Div dq = make_div(nq);
    const int nb = nq * per_seq;
    const Div db = make_div(nb);
    const int total = nb * groups;
    C lo_out[K][G], hi_out[K][G];   // X_i, X_{R-i}
#pragma unroll
    for (int k = 0; k < K; ++k) {
      C A[G], B[G];
      {
        const int oc = min(fresh_tid() + k * T, total - 1);
        const int grp = quot(oc, db);
        int q, l, m, lo;
        decode(oc - grp * nb, dq, dm, q, l, m);
        const C* s = buf + seq_base(g, q0 + q, lo) +
                     (l * R * Mp + m) * g.es;
        const C x0 = s[0];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          A[u] = x0;
          B[u] = cx<C>(Real<C>(0), Real<C>(0));
        }
        // i0 = grp * G in the high half, i0 * j mod R in the low: one
        // register through the sums
        int ie = grp * G << 16;
#pragma unroll 1
        for (int j = 1; 2 * j < R; ++j) {
          const C a = s[j * jstep], b = s[(R - j) * jstep];
          const C sj = cadd(a, b), dj = csub(a, b);
          ie += ie >> 16;
          if ((ie & 0xffff) >= R) ie -= R;
          int e = ie & 0xffff;   // (i0 + u) * j mod R
#pragma unroll
          for (int u = 0; u < G; ++u) {
            if (u) {
              e += j;
              if (e >= R) e -= R;
            }
            const C c = w[e];
            A[u].x = madd(sj.x, c.x, A[u].x);
            A[u].y = madd(sj.y, c.x, A[u].y);
            B[u].x = madd(dj.x, c.y, B[u].x);
            B[u].y = madd(dj.y, c.y, B[u].y);
          }
        }
      }
      const int qf = fresh_int(q0);
      const int nqf = min(Q, g.seqs - qf);
      const int nbf = nqf * per_seq;
      const Div dbf = make_div(nbf);
      const int oc = min(fresh_tid() + k * T, nbf * groups - 1);
      const int grp = quot(oc, dbf);
      int q, l, m, lo;
      decode(oc - grp * nbf, make_div(nqf), dm, q, l, m);
      seq_base(g, qf + q, lo);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int i = grp * G + u;
        const int ri = i ? R - i : 0;
        C x = cx<C>(A[u].x - B[u].y, A[u].y + B[u].x);
        C y = cx<C>(A[u].x + B[u].y, A[u].y - B[u].x);
        x = cmul(x, tw[i * Mp + m]);
        y = cmul(y, tw[ri * Mp + m]);
        if (hook.on()) {
          x = hook(x, lo, i * L + l);
          y = hook(y, lo, ri * L + l);
        }
        lo_out[k][u] = x;
        hi_out[k][u] = y;
      }
    }
    __syncthreads();
    // the outputs' positions are found again rather than held through the
    // barrier
    const int istep = L * Mp * g.es;
    const int qs = fresh_int(q0);
    const int nqs = min(Q, g.seqs - qs);
    const int nbs = nqs * per_seq;
    const Div dbs = make_div(nbs), dqs = make_div(nqs);
    const int tots = nbs * groups;
    int o = fresh_tid();
#pragma unroll
    for (int k = 0; k < K; ++k, o += T) {
      const int oc = min(o, tots - 1);
      const int grp = quot(oc, dbs);
      int q, l, m, lo;
      decode(oc - grp * nbs, dqs, dm, q, l, m);
      const int at = seq_base(g, qs + q, lo) + (l * Mp + m) * g.es;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int i = grp * G + u;
        if (o < tots && i <= H) {
          buf[at + i * istep] = lo_out[k][u];
          if (i) buf[at + (R - i) * istep] = hi_out[k][u];
        }
      }
    }
  }
  __syncthreads();
}

// Whether radix r has a butterfly of its own (stage_fixed).
inline bool fixed_radix(int r) {
  return r == 2 || r == 3 || r == 4 || r == 5 || r == 7 || r == 8 || r == 16;
}

// Whether a stage of plan p runs stage_generic.
inline bool has_generic(const Plan& p) {
  for (int s = 0; s < p.n_stages; ++s)
    if (!fixed_radix(p.radix[s])) return true;
  return false;
}

// Every stage of plan p over the sequences of g, its table `tab` in
// shared memory; `hook` rides the last stage's write.  Without kGeneric
// the generic stage is left out of the kernel (its caller refuses plans
// that need it, has_generic).
template <bool kGeneric = true, class C, class Hook>
__device__ void run_pass(C* buf, const Pass& g, const Plan& p, const C* tab,
                         const Hook& hook) {
  int L = 1, M = p.n;
  for (int s = 0; s < p.n_stages; ++s) {
    const int r = p.radix[s];
    const int Mp = M / r;
    const C* tw = tab + p.tw_off[s];
    const C* w = tab + (p.dft_off[s] >= 0 ? p.dft_off[s] : 0);
    const Hook h = s == p.n_stages - 1 ? hook : hook.off();
    switch (r) {
      case 2: stage_fixed<2>(buf, g, L, Mp, tw, w, p.inverse, h); break;
      case 3: stage_fixed<3>(buf, g, L, Mp, tw, w, p.inverse, h); break;
      case 4: stage_fixed<4>(buf, g, L, Mp, tw, w, p.inverse, h); break;
      case 5: stage_fixed<5>(buf, g, L, Mp, tw, w, p.inverse, h); break;
      case 7: stage_fixed<7>(buf, g, L, Mp, tw, w, p.inverse, h); break;
      case 8: stage_fixed<8>(buf, g, L, Mp, tw, w, p.inverse, h); break;
      case 16:
        if constexpr (kRadix16<C>)
          stage_fixed<16>(buf, g, L, Mp, tw, w, p.inverse, h);
        break;
      default:
        if constexpr (kGeneric) stage_generic(buf, g, r, L, Mp, tw, w, h);
        break;
    }
    L *= r;
    M = Mp;
  }
}

// Points of a plan's stage table (0 for the empty plan of a length-1
// factor).
inline int table_len(const Plan& p) {
  int len = 0, M = p.n;
  for (int s = 0; s < p.n_stages; ++s) {
    const int r = p.radix[s], Mp = M / r;
    const int end = p.dft_off[s] >= 0 ? p.dft_off[s] + r : p.tw_off[s] + r * Mp;
    if (end > len) len = end;
    M = Mp;
  }
  return len;
}

// Whether `threads` hold a whole sequence of every stage of p in a round
// of the walk on points of type C: its n / r butterflies of a fixed radix,
// or their generic_groups(r) items each of a generic one; and whether C's
// walk has every radix of p (the fp64 walk no radix 16).
template <class C = float2>
inline bool rounds_fit(const Plan& p, int threads) {
  for (int s = 0; s < p.n_stages; ++s) {
    const int r = p.radix[s];
    if (r == 16 && !kRadix16<C>) return false;
    if (fixed_radix(r) ? round_butterflies(r) * threads < p.n / r
              : kItems<C> * threads < p.n / r * generic_groups(r))
      return false;
  }
  return true;
}

// Where point u of the block's lines sits in shared memory: line u / n at
// line * S, its point t = a * d + b at a * A + b * B (row-major: d = n1, A
// = P, B = 1; transposed: d = n2, A = 1, B = P).
struct Map {
  Div dn, dd;
  int S, A, B;
};

__device__ __forceinline__ int position(int u, const Map& mp) {
  const int line = quot(u, mp.dn);
  const int t = u - line * (int)mp.dn.d;
  const int a = quot(t, mp.dd);
  return line * mp.S + a * mp.A + (t - a * (int)mp.dd.d) * mp.B;
}

__device__ __forceinline__ void positions(int u, const Map& mp,
                                          int (&pos)[4]) {
  const int n = (int)mp.dn.d, d = (int)mp.dd.d;
  const int line = quot(u, mp.dn);
  int t = u - line * n;
  int a = quot(t, mp.dd);
  int b = t - a * d;
  int base = line * mp.S;
  pos[0] = base + a * mp.A + b * mp.B;
#pragma unroll
  for (int c = 1; c < 4; ++c) {
    ++t;
    ++b;
    if (t == n) {
      t = a = b = 0;
      base += mp.S;
    } else if (b == d) {
      b = 0;
      ++a;
    }
    pos[c] = base + a * mp.A + b * mp.B;
  }
}

// x[c] <- x[(c + r) & 3].
template <class T>
__device__ __forceinline__ void rotate(T (&x)[4], int r) {
  if (r & 1) {
    const T t = x[0];
    x[0] = x[1];
    x[1] = x[2];
    x[2] = x[3];
    x[3] = t;
  }
  if (r & 2) {
    T t = x[0];
    x[0] = x[2];
    x[2] = t;
    t = x[1];
    x[1] = x[3];
    x[3] = t;
  }
}

template <class T>
__device__ __forceinline__ bool aligned16(const T* a, const T* b) {
  return (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
}

// A storage real of two bytes (__half, __nv_bfloat16): its planes go
// through registers, since cp.async has no 2-byte copy.
template <class St>
constexpr bool kNarrow = sizeof(St) == 2;

// A stored real as the walk's real: a float or double as it is, a half
// widened to float (exact).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// d <- v at d's storage type: a half rounded to nearest even, as torch's
// .to() and JAX's astype round.
__device__ __forceinline__ void put(float& d, float v) { d = v; }
__device__ __forceinline__ void put(double& d, double v) { d = v; }
__device__ __forceinline__ void put(__half& d, float v) {
  d = __float2half_rn(v);
}
__device__ __forceinline__ void put(__nv_bfloat16& d, float v) {
  d = __float2bfloat16_rn(v);
}

// Whether planes a and b start on a boundary of four reals, so that four
// reals at a multiple of four from them are one aligned load4 or store4:
// 16 bytes (floats; doubles as two double2), 8 of halves.
template <class St>
__device__ __forceinline__ bool group_aligned(const St* a, const St* b) {
  return (((uintptr_t)a | (uintptr_t)b) & (kNarrow<St> ? 7 : 15)) == 0;
}

// Four neighbouring reals of a plane, 16-byte aligned: one float4, or two
// double2 loads and stores.
struct Double4 {
  double x, y, z, w;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ Double4 load4(const double* p) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  return {a.x, a.y, b.x, b.y};
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(double* p, double a, double b,
                                       double c, double d) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}

// Four halves of a plane, 8-byte aligned: one 8-byte load or store, the
// halves widened in pairs or narrowed in pairs (round to nearest even).
__device__ __forceinline__ float2 widen2(__half2 h) {
  return __half22float2(h);
}
__device__ __forceinline__ float2 widen2(__nv_bfloat162 h) {
  return __bfloat1622float2(h);
}
__device__ __forceinline__ __half2 narrow2(float a, float b, const __half*) {
  return __floats2half2_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat162 narrow2(float a, float b,
                                                  const __nv_bfloat16*) {
  return __floats2bfloat162_rn(a, b);
}

template <class St>
__device__ __forceinline__ float4 load4_narrow(const St* p) {
  using H2 = decltype(narrow2(0.f, 0.f, p));
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  H2 a, b;
  memcpy(&a, &u.x, 4);
  memcpy(&b, &u.y, 4);
  const float2 lo = widen2(a), hi = widen2(b);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  return load4_narrow(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return load4_narrow(p);
}

template <class St>
__device__ __forceinline__ void store4_narrow(St* p, float a, float b,
                                              float c, float d) {
  const auto lo = narrow2(a, b, p), hi = narrow2(c, d, p);
  uint2 u;
  memcpy(&u.x, &lo, 4);
  memcpy(&u.y, &hi, 4);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(__half* p, float a, float b, float c,
                                       float d) {
  store4_narrow(p, a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  store4_narrow(p, a, b, c, d);
}

// The `count` points at real offset g0 of the planes, as a head of up to
// three single reals to a boundary of four (16 bytes of floats, 32 of
// doubles, 8 of halves), groups of four (load4, store4), and a tail.
struct Span {
  int head, n4, tail0, rest;
};

__device__ __forceinline__ Span span_of(long long g0, int count, bool vec) {
  Span s;
  s.head = vec ? (int)((4 - (g0 & 3)) & 3) : count;
  if (s.head > count) s.head = count;
  s.n4 = (count - s.head) >> 2;
  s.tail0 = s.head + 4 * s.n4;
  s.rest = s.head + count - s.tail0;
  return s;
}

// The `count` points at real offset g0 of planes xr, xi into their
// places `mp` in `home`, through registers (the only read of half planes,
// each widened to float).
template <class C, class St>
__device__ void load_lines(const St* xr, const St* xi, long long g0,
                           int count, const Map& mp, C* home) {
  const Span sp = span_of(g0, count, group_aligned(xr, xi));
  const int rot = (threadIdx.x >> 2) & 3;
  const St* r0 = xr + g0;
  const St* i0 = xi + g0;
#pragma unroll 2
  for (int f = threadIdx.x; f < sp.n4; f += blockDim.x) {
    const int u = sp.head + 4 * f;
    const auto r = load4(r0 + u);
    const auto i = load4(i0 + u);
    C v[4] = {cx<C>(r.x, i.x), cx<C>(r.y, i.y), cx<C>(r.z, i.z),
              cx<C>(r.w, i.w)};
    int pos[4];
    positions(u, mp, pos);
    rotate(v, rot);
    rotate(pos, rot);
#pragma unroll
    for (int c = 0; c < 4; ++c) home[pos[c]] = v[c];
  }
  for (int k = threadIdx.x; k < sp.rest; k += blockDim.x) {
    const int u = k < sp.head ? k : sp.tail0 + k - sp.head;
    home[position(u, mp)] = cx<C>(widen(r0[u]), widen(i0[u]));
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// One real by cp.async: a float (cp_async4) or a double (8 bytes).
__device__ __forceinline__ void cp_async_real(float* dst, const float* src) {
  cp_async4(dst, src);
}
__device__ __forceinline__ void cp_async_real(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

// load_lines by cp.async: each real copied from device memory straight
// to its place, every copy of the block in flight at once and none held
// in a register; returns when this thread's copies have landed (a barrier
// then shows them to the block).
template <class C>
__device__ void load_lines_async(const Real<C>* xr, const Real<C>* xi,
                                 long long g0, int count, const Map& mp,
                                 C* home) {
  const Real<C>* r0 = xr + g0;
  const Real<C>* i0 = xi + g0;
  for (int u = threadIdx.x; u < count; u += blockDim.x) {
    Real<C>* d = reinterpret_cast<Real<C>*>(home + position(u, mp));
    cp_async_real(d, r0 + u);
    cp_async_real(d + 1, i0 + u);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Bluestein's read window (fft_conv.cu's windowed entries): the first
// `keep` points of each of `nl` lines of n points from real offset g0 of
// the planes into their places `mp` in `home`; the points past `keep` are
// declared zero, never read, and not written here (the caller's chirp
// sweep writes their zeros).  fp32 planes by cp.async, each real straight
// to its place, returning when this thread's copies have landed; half
// planes through registers line by line (load_lines: 8-byte groups of
// four halves, single halves at a line's unaligned head and at a window
// edge inside a group).
template <class C, class St>
__device__ void load_prefix(const St* xr, const St* xi, long long g0, int nl,
                            int keep, const Map& mp, C* home) {
  const int n = (int)mp.dn.d;
  if constexpr (kNarrow<St>) {
    for (int line = 0; line < nl; ++line)
      load_lines(xr, xi, g0 + (long long)line * n, keep, mp,
                 home + line * mp.S);
  } else {
    const Div dk = make_div(keep);
    for (int u = threadIdx.x; u < nl * keep; u += blockDim.x) {
      const int line = quot(u, dk);
      const int t = u - line * keep;
      Real<C>* d =
          reinterpret_cast<Real<C>*>(home + position(line * n + t, mp));
      const long long gi = g0 + (long long)line * n + t;
      cp_async_real(d, xr + gi);
      cp_async_real(d + 1, xi + gi);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
}

// A zero-pad window on a plane pass (fft_pair.cu's windowed entries,
// fft_conv_pair.cu's windowed 2-D mode): the input's rows y < ky and columns
// z < kz of plane b (at real offset b * in_plane + y * in_row + z) are
// read and the rest of the plane is declared zero, never read; the
// output's rows y < oy and columns z < oz are written, at b * out_plane +
// y * out_row + z.
struct PairWindow {
  long long in_plane, out_plane;
  int in_row, out_row, ky, kz, oy, oz;
};

// A PairWindow from its 8 ints (in_plane, out_plane, in_row, out_row, ky,
// kz, oy, oz), or false where they are not one of an (ny, nz) plane:
// corners of 1..ny rows and 1..nz columns, pitches that fit an int.
inline bool pair_window_from_ints(const long long* v, int ny, int nz,
                                  PairWindow* w) {
  if (v == nullptr) return false;
  for (int k = 0; k < 8; ++k)
    if (v[k] < 0 || (k >= 2 && v[k] > 0x7fffffffLL)) return false;
  *w = PairWindow{v[0],      v[1],      (int)v[2], (int)v[3],
                  (int)v[4], (int)v[5], (int)v[6], (int)v[7]};
  return w->ky >= 1 && w->ky <= ny && w->kz >= 1 && w->kz <= nz &&
         w->oy >= 1 && w->oy <= ny && w->oz >= 1 && w->oz <= nz;
}

// The block's row tile (rows r0.. of its plane) under a window, point by
// point: a declared-zero point is a zero written to shared memory.
template <class C, class St>
__device__ void load_rows_window(const St* xr, const St* xi, long long g0,
                                 int r0, int rows, const PairWindow& w,
                                 const Map& mp, C* home) {
  const int nz = (int)mp.dn.d;
  for (int u = threadIdx.x; u < rows * nz; u += blockDim.x) {
    const int r = quot(u, mp.dn);
    const int z = u - r * nz;
    C* d = home + position(u, mp);
    if (r0 + r >= w.ky || z >= w.kz) {
      *d = cx<C>(Real<C>(0), Real<C>(0));
      continue;
    }
    const long long g = g0 + (long long)(r0 + r) * w.in_row + z;
    if constexpr (kNarrow<St>) {
      *d = cx<C>(widen(xr[g]), widen(xi[g]));
    } else {
      Real<C>* p = reinterpret_cast<Real<C>*>(d);
      cp_async_real(p, xr + g);
      cp_async_real(p + 1, xi + g);
    }
  }
  if constexpr (!kNarrow<St>) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

// The `count` points at point offset g0 of one interleaved (re, im) array
// into their places `mp` in `home` by cp.async, 8 bytes a point (the
// array 8-byte aligned); returns when this thread's copies have landed.
__device__ void load_pairs_async(const float2* x, long long g0, int count,
                                 const Map& mp, float2* home) {
  const float2* x0 = x + g0;
  for (int u = threadIdx.x; u < count; u += blockDim.x)
    cp_async8(home + position(u, mp), x0 + u);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The inverse of load_pairs_async: a warp stores 32 neighbouring points,
// one float2 a thread, from neighbouring places of the walk's rows.
__device__ void store_pairs(const float2* home, const Map& mp, float2* y,
                            long long g0, int count) {
  float2* y0 = y + g0;
  for (int u = threadIdx.x; u < count; u += blockDim.x)
    y0[u] = home[position(u, mp)];
}

// A stored point as it is.
struct AsIs {
  template <class C>
  __device__ __forceinline__ C operator()(C v, int, int) const {
    return v;
  }
};

// The inverse of load_lines; each point goes out as out(v, line, t), t
// its index within its line, narrowed to the planes' storage type.
template <class Out = AsIs, class C, class St>
__device__ void store_lines(const C* home, const Map& mp, St* yr, St* yi,
                            long long g0, int count, const Out& out = Out()) {
  const Span sp = span_of(g0, count, group_aligned(yr, yi));
  const int rot = (threadIdx.x >> 2) & 3;
  const int n = (int)mp.dn.d;
  St* r0 = yr + g0;
  St* i0 = yi + g0;
#pragma unroll 2
  for (int f = threadIdx.x; f < sp.n4; f += blockDim.x) {
    const int u = sp.head + 4 * f;
    int pos[4];
    positions(u, mp, pos);
    rotate(pos, rot);
    C v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = home[pos[c]];
    rotate(v, (4 - rot) & 3);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int line = quot(u + c, mp.dn);
      v[c] = out(v[c], line, u + c - line * n);
    }
    store4(r0 + u, v[0].x, v[1].x, v[2].x, v[3].x);
    store4(i0 + u, v[0].y, v[1].y, v[2].y, v[3].y);
  }
  for (int k = threadIdx.x; k < sp.rest; k += blockDim.x) {
    const int u = k < sp.head ? k : sp.tail0 + k - sp.head;
    const int line = quot(u, mp.dn);
    const C v = out(home[position(u, mp)], line, u - line * n);
    put(r0[u], v.x);
    put(i0[u], v.y);
  }
}

// The place of point ky of a sequence after an axis run in the forward's
// order (fft_pair.cu, fft_r2c_pair.cu): natural (n2 = 1) or the two
// factors' transposed order, ky = k1 * n2 + k2 at k2 * n1 + k1.
struct RowPerm {
  Div d2;
  int n1;
  __device__ __forceinline__ int operator()(int ky) const {
    const int q = quot(ky, d2);
    return (ky - q * (int)d2.d) * n1 + q;
  }
};

// Point k = k1 * n2z + k2 of row q of a plane's row tile after the z axis
// (fft_r2c_pair.cu, fft_conv_pair.cu's 2-D mode), in the factors'
// transposed order: at q * sz + k2 * pz + k1.
struct RowAt {
  Div d2;
  int sz, pz;
  __device__ __forceinline__ int operator()(int q, int k) const {
    const int k1 = quot(k, d2);
    return q * sz + k1 + (k - k1 * (int)d2.d) * pz;
  }
};

// Where the lines' points sit for a copy: the (n2, n1) row-major matrix
// of each line at pitch P (transposed: the natural order of its spectrum,
// point k1 * n2 + k2 at [k2][k1]).
__device__ __forceinline__ Map make_map(int n, int lines_stride, bool transposed,
                                        int n1, int n2, int P) {
  return transposed ? Map{make_div(n), make_div(n2), lines_stride, 1, P}
                    : Map{make_div(n), make_div(n1), lines_stride, P, 1};
}

// The two passes of the two-factor DFT of `nl` lines of n = n1 * n2
// points at `home`, each the (n2, n1) matrix at the odd pitch P = n1 | 1
// (a line every n2 * P points), the factors' stage tables at s1, s2 and
// the inter-factor twiddle's two tables at tlo, thi, all in shared memory:
// forward, the column pass (n2-point DFTs, the twiddle on its last stage;
// on the row pass's when n2 = 1, where it is the scale), then the row pass
// (n1-point DFTs), natural order [j2][j1] to [k2][k1] for X[k1 * n2 + k2];
// the inverse the other way round, unless `mirrored` is false: then the
// inverse too runs the forward's order (its plans and conjugate twiddle
// make it the inverse DFT), natural order in, [k2][k1] out.  Ends on a
// barrier.
template <class C>
__device__ __forceinline__ void two_factor_passes(
    C* home, int nl, const Plan& p1, const Plan& p2, const C* s1, const C* s2,
    const C* tlo, const C* thi, int pitch, bool mirrored = true) {
  const int n1 = p1.n, n2 = p2.n;
  const int S = n2 * pitch;
  const bool inverse = mirrored && p1.inverse != 0;
  // With n2 = 1 the twiddle is the scale alone, skipped when it is 1.
  const bool twiddled =
      n2 > 1 || thi[0].x != Real<C>(1) || thi[0].y != Real<C>(0);
  // One call site of run_pass keeps one copy of each stage in the kernel.
  for (int k = 0; k < 2; ++k) {
    const bool row = (k == 0) == inverse;
    const Pass g = row ? Pass{nl * n2, S, pitch, 1, make_div(n2)}
                       : Pass{nl * n1, S, 1, pitch, make_div(n1)};
    const bool fuse = twiddled && (inverse ? row : row == (n2 == 1));
    run_pass(home, g, row ? p1 : p2, row ? s1 : s2,
             InterTwiddleT<C>{fuse ? tlo : nullptr, thi});
  }
}

// Points of a twiddle's two tables over `count` exponents: kTwLo low
// points, then ceil(count / kTwLo) high ones.
__host__ __device__ constexpr int rotation_points(int count) {
  return kTwLo + (count + kTwLo - 1) / kTwLo;
}

// A block's stage tables and twiddles into shared memory at s1: len1 +
// len2 stage points, then ntw twiddle points.
template <class C>
__device__ __forceinline__ void load_tables(C* s1, const C* t1, const C* t2,
                                           const C* tw, int len1, int len2,
                                           int ntw) {
  const int ntab = len1 + len2 + ntw;
  for (int t = threadIdx.x; t < ntab; t += blockDim.x)
    s1[t] = t < len1 ? __ldg(&t1[t])
                     : t < len1 + len2 ? __ldg(&t2[t - len1])
                                       : __ldg(&tw[t - len1 - len2]);
}

// The two-factor DFT (twofactor.cuh's contract) of the `lines` lines of
// n = n1 * n2 points from line blockIdx.x * lines on, each held once in
// `smem` as the (n2, n1) row-major matrix A[j2][j1] at the odd pitch P =
// n1 | 1, beside the factors' stage tables (len1, len2 points, no scale)
// and the inter-factor twiddle's two tables, all copied in first.  The
// forward runs the column pass (n2-point DFTs, the twiddle on its last
// stage; on the row pass's when n2 = 1, where it is the scale), then the
// row pass (n1-point DFTs), from natural order to natural (store
// transposed) or swapped order; the inverse the other way round.  A block
// reads all of its lines before it writes, so the output may alias the
// input.  fft_twofactor and fft_lines run it, on planes of any storage
// type St (half planes read through registers whatever `async_load`
// says).
template <class C, class St>
__device__ __forceinline__ void two_factor_block(
    C* smem, const St* xr, const St* xi, St* yr, St* yi, long long batch,
    const Plan& p1, const Plan& p2, const C* t1, const C* t2, const C* tw,
    int swapped, int lines, int pitch, int len1, int len2,
    bool async_load = false) {
  const int n1 = p1.n, n2 = p2.n, n = n1 * n2;
  const int S = n2 * pitch;
  const int nl = block_lines(lines, batch);
  C* home = smem;
  C* s1 = home + lines * S;
  C* s2 = s1 + len1;
  C* tlo = s2 + len2;
  C* thi = tlo + kTwLo;
  load_tables(s1, t1, t2, tw, len1, len2, rotation_points(n));
  const bool inverse = p1.inverse != 0;
  const Map in = make_map(n, S, inverse && !swapped, n1, n2, pitch);
  // the block's first point found again where it is used, not held
  // through the passes
  if constexpr (kNarrow<St>) {
    load_lines(xr, xi, block_line0(lines) * n, nl * n, in, home);
  } else {
    if (async_load)
      load_lines_async(xr, xi, block_line0(lines) * n, nl * n, in, home);
    else
      load_lines(xr, xi, block_line0(lines) * n, nl * n, in, home);
  }
  __syncthreads();
  two_factor_passes(home, nl, p1, p2, s1, s2, tlo, thi, pitch);
  store_lines(home, make_map(n, S, !inverse && !swapped, n1, n2, pitch), yr,
              yi, block_line0(lines) * n, block_lines(lines, batch) * n);
}

// A zero-pad window on a block of lines (the reference's vkFFT_Zeropad.h
// read and write guards; the windowed entries of fft_lines and
// fft_twofactor).  The input lines are a view (d0, d1, d2) of lines:
// line (i0, i1, i2) starts at point i0 * s0 + i1 * s1 + i2 * s2 of the
// planes (a corner of wider planes, or one run of lines at pitch s2).  Of
// each line the points t < len outside [z0, z1) are read; the others are
// declared zero, never read, and held as zeros.  The output is compact,
// `out` points a line (a cropped prefix, or the whole line), and the
// points [o0, o1) of each are written as zeros, not as computed values.
struct LineWindow {
  long long s0, s1;
  int d1, d2, s2;
  int len, z0, z1;
  int out, o0, o1;
};

// Points [o0, o1) of each line stored as zeros (store_lines' functor).
struct ZeroRange {
  int o0, o1;
  template <class C>
  __device__ __forceinline__ C operator()(C v, int, int t) const {
    return t >= o0 && t < o1 ? cx<C>(Real<C>(0), Real<C>(0)) : v;
  }
};

// The block's lines under a window: a block takes up to `lines` lines of
// one group of d2 (ceil(d2 / lines) blocks a group).  Returns its count
// of lines, the input's first point into in0 and the output's into out0;
// blockIdx.x read afresh, so nothing is held through the passes.
__device__ __forceinline__ int window_lines(const LineWindow& w, int lines,
                                            long long& in0, long long& out0) {
  unsigned b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  const unsigned per = ((unsigned)w.d2 + lines - 1) / lines;
  const unsigned g = b / per;
  const int first = (int)(b - g * per) * lines;
  const unsigned i0 = g / (unsigned)w.d1;
  in0 = (long long)i0 * w.s0 + (long long)(g - i0 * w.d1) * w.s1 +
        (long long)first * w.s2;
  out0 = ((long long)g * w.d2 + first) * w.out;
  return min(lines, w.d2 - first);
}

// The `nl` lines of n points from point g0 of the planes (line pitch
// w.s2) into their places `mp` in `home`, point by point: a declared-zero
// point is a zero written to shared memory, never read; a kept one goes
// by cp.async straight to its place (fp32, fp64) or through registers,
// widened (halves).  A window's edges fall anywhere in a line, so the
// copy takes no four-point groups.
template <class C, class St>
__device__ void load_window(const St* xr, const St* xi, long long g0, int nl,
                            const LineWindow& w, const Map& mp, C* home) {
  const int n = (int)mp.dn.d;
  for (int u = threadIdx.x; u < nl * n; u += blockDim.x) {
    const int line = quot(u, mp.dn);
    const int t = u - line * n;
    C* d = home + position(u, mp);
    if (t >= w.len || (t >= w.z0 && t < w.z1)) {
      *d = cx<C>(Real<C>(0), Real<C>(0));
      continue;
    }
    const long long g = g0 + (long long)line * w.s2 + t;
    if constexpr (kNarrow<St>) {
      *d = cx<C>(widen(xr[g]), widen(xi[g]));
    } else {
      Real<C>* r = reinterpret_cast<Real<C>*>(d);
      cp_async_real(r, xr + g);
      cp_async_real(r + 1, xi + g);
    }
  }
  if constexpr (!kNarrow<St>) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// two_factor_block under a window (LineWindow), natural order both ways:
// the lines' kept points read (load_window), the same passes, and the
// compact output stored through store_lines at w.out points a line with
// zeros over [w.o0, w.o1).  A block reads all of its lines before it
// writes, so an output of the input's own layout (one run of whole lines)
// may alias it.
template <class C, class St>
__device__ __forceinline__ void two_factor_block_window(
    C* smem, const St* xr, const St* xi, St* yr, St* yi, const Plan& p1,
    const Plan& p2, const C* t1, const C* t2, const C* tw, int lines,
    int pitch, int len1, int len2, const LineWindow& w) {
  const int n1 = p1.n, n2 = p2.n, n = n1 * n2;
  const int S = n2 * pitch;
  C* home = smem;
  C* s1 = home + lines * S;
  C* s2 = s1 + len1;
  C* tlo = s2 + len2;
  C* thi = tlo + kTwLo;
  load_tables(s1, t1, t2, tw, len1, len2, rotation_points(n));
  const bool inverse = p1.inverse != 0;
  long long in0, out0;
  const int nl = window_lines(w, lines, in0, out0);
  load_window(xr, xi, in0, nl, w, make_map(n, S, inverse, n1, n2, pitch),
              home);
  __syncthreads();
  two_factor_passes(home, nl, p1, p2, s1, s2, tlo, thi, pitch);
  Map mp = make_map(n, S, !inverse, n1, n2, pitch);
  mp.dn = make_div(w.out);
  const int count = window_lines(w, lines, in0, out0) * w.out;
  store_lines(home, mp, yr, yi, out0, count, ZeroRange{w.o0, w.o1});
}

// A LineWindow from its 11 ints (s0, s1, d1, d2, s2, len, z0, z1, out,
// o0, o1) for lines of n points, `batch` of them in all, or false where
// it is not one: groups of d2 lines that divide the batch, a kept read
// inside the line, an output of 1..n points with its zeros inside it.
inline bool window_from_ints(const long long* v, int n, long long batch,
                             LineWindow* w) {
  if (v == nullptr) return false;
  for (int k = 2; k < 11; ++k)
    if (v[k] < 0 || v[k] > 0x7fffffffLL) return false;
  *w = {v[0], v[1], (int)v[2], (int)v[3], (int)v[4], (int)v[5],
        (int)v[6], (int)v[7], (int)v[8], (int)v[9], (int)v[10]};
  return v[0] >= 0 && v[1] >= 0 && w->d1 >= 1 && w->d2 >= 1 &&
         batch % ((long long)w->d1 * w->d2) == 0 && w->len >= 1 &&
         w->len <= n && w->s2 >= w->len && w->z0 <= w->z1 && w->z1 <= n &&
         w->out >= 1 && w->out <= n && w->o0 <= w->o1 && w->o1 <= w->out;
}

// Shared bytes of a block of `lines` lines of the plans' n1 * n2 points at
// the pitch n1 | 1, their stage tables and `ntw` twiddle points, a point a
// C.
template <class C = float2>
inline size_t walk_smem(const Plan& p1, const Plan& p2, int lines, int ntw) {
  return sizeof(C) * ((size_t)lines * p2.n * (p1.n | 1) + table_len(p1) +
                      table_len(p2) + ntw);
}

// Shared bytes of two_factor_block's `lines` lines and tables.
template <class C = float2>
inline size_t two_factor_smem(const Plan& p1, const Plan& p2, int lines) {
  return walk_smem<C>(p1, p2, lines, rotation_points(p1.n * p2.n));
}

// The real kernels on the walk (fft_r2c, fft_dct23, fft_dct4) share one
// launch contract.
constexpr int kRealThreads = 512;  // most threads a block
constexpr int kRealMinBlocks = 2;  // blocks an SM the register budget keeps

// Lets `kernel` take `smem` dynamic shared bytes past the 48 KB default.
template <typename K>
int smem_opt_in(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The checks of a real kernel's launch: the plans of its pipeline's
// `points` = n1 * n2 (n1 >= n2, both with the `inverse` flag), `threads` a
// multiple of 32 up to kRealThreads that hold a whole sequence of every
// stage in a round, `lines` pipelines a block (lines * points <=
// kTwoFactorMaxN) and `smem` exactly walk_smem's bytes with `ntw` twiddle
// points, at most 227 KB.  Then *blocks for `per` real lines a block, and
// the kernel opted in to its shared bytes.  The layout rules of
// cuda_kernels (r2c_layout, dct23_layout, dct4_layout) give these.
template <typename K>
int walk_prepare(K kernel, long long batch, const int* plan1, const int* plan2,
                 int points, int inverse, int threads, int lines, int smem,
                 int ntw, int per, Plan* p1, Plan* p2, long long* blocks) {
  if (batch < 1 || !plan_from_ints(plan1, p1) || !subplan_from_ints(plan2, p2))
    return (int)cudaErrorInvalidValue;
  if (p1->n * p2->n != points || points < 2 || points > kMaxN ||
      p1->n < p2->n || p1->inverse != inverse || p2->inverse != inverse ||
      threads < 32 || threads > kRealThreads || threads % 32 != 0 ||
      lines < 1 || (long long)lines * points > kTwoFactorMaxN ||
      !rounds_fit(*p1, threads) || !rounds_fit(*p2, threads) || smem < 0 ||
      (size_t)smem != walk_smem(*p1, *p2, lines, ntw) || smem > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  *blocks = (batch + per - 1) / per;
  if (*blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return smem_opt_in(kernel, smem);
}

// Resident blocks an SM of a real kernel at `threads` a block and `smem`
// dynamic shared bytes, into *blocks.
template <typename K>
int walk_occupancy(K kernel, int threads, int smem, int* blocks) {
  if (threads < 32 || threads > kRealThreads || smem < 0 ||
      smem > kMaxSmemBytes || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  const int err = smem_opt_in(kernel, smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            threads, smem);
}

}  // namespace walk
}  // namespace vkfft
