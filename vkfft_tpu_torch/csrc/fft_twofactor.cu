// fft_twofactor: batched C2C FFT of contiguous (B, n) fp32 re/im planes,
// n = n1 * n2 <= 16384, as the two-factor DFT of twofactor.cuh: forward
// from natural order to natural or swapped digit order, inverse from
// either order to natural order, times a scale.  Replaces
// vkfft_tpu/ops/pallas_engine.py:897 _fft_kernel_v2 (plain fp32 form: no
// row elision) and, through cuda_kernels.twofactor_split, :152 _fft_kernel.
//
// What bounds it.  The floor is bytes: each point read once and written
// once, 16 B of planes.  The kernel reaches 30 % of it at 819 x 10240 on
// an H100 (PERF.md): the stage walk in shared memory bounds it, a
// barrier a round and the index work of each butterfly, at 64 registers
// a thread; at 7918 = 107 * 74 the O(r^2) generic stage of the prime 107
// does.  The old design kept one block an SM (the line plus two 4096-point
// scratch tiles), so loads, stages and stores ran in series; this one
// keeps the line once, with no scratch, for two blocks an SM.
//
// Shared memory.  A block holds `lines` lines (several when n < 2048,
// cuda_kernels.twofactor_layout) once each, as the (n2, n1) row-major
// matrix A[j2][j1] with an odd row pitch P = n1 | 1 in float2, beside the
// factors' stage tables and the inter-factor twiddle's two tables (w_n^e
// = hi[e >> 6] * lo[e & 63], the scale in hi), all copied in at the
// block's start: 66.2 KB at 7918, 84.4 KB at 10240, 133.8 KB at 16384.
// With the registers (64 a thread at 512 threads) that gives 2, 2 and 1
// resident blocks an SM (vk_fft_twofactor_occupancy on an H100).
//
// Why the passes are in place.  A Stockham stage of radix r maps the
// points whose index is m mod Mp onto the same points, so the butterflies
// of one (sequence, m) group only exchange among themselves: a stage can
// run in rounds of whole sequences, each thread computing its butterflies
// of the round in registers (at most kPoints points, or kGenericPoints
// outputs of a generic prime stage), the block meeting at a barrier, and
// each thread writing its outputs back to their Stockham positions in the
// same buffer.  Rounds touch disjoint points, so a stage costs one barrier
// a round and one at its end, and the line needs no second copy.  A
// round's idle slots compute a clamped butterfly and only their store is
// predicated: values held across a divergent branch made ptxas spill.
// The column pass (n1 sequences of n2 points, P apart) and the row pass
// (n2 sequences of n1 points, contiguous) both put the sequence fastest
// across threads, so a warp's accesses sit one float2 or one odd pitch
// apart, on distinct banks.  The inter-factor twiddle is computed from its
// exponent k2 * j1 < n in the last stage of the column pass (forward; of
// the row pass when n2 = 1, where it is the scale) or of the row pass
// (inverse), on the outputs a thread already holds: the first row stage's
// read would take each input of a generic stage r times.
//
// Device memory is read and written contiguously, float4 per plane where
// the planes are 16-byte aligned (a line's unaligned head and tail as
// single floats); the natural-order forward store and the natural-order
// inverse load transpose through strided shared-memory accesses.  A
// thread's four points go in an order rotated by its lane, so a warp's
// accesses again fall on distinct banks.  A block reads all of its lines
// before it writes, so the output may alias the input.
#include "twofactor.cuh"

namespace {

using vkfft::Plan;
using vkfft::cmul;

constexpr int kThreads = 512;  // most threads a block
constexpr int kMinBlocks = 2;  // blocks an SM the register budget keeps
constexpr int kPoints = 12;    // most points a thread holds in a round
constexpr int kGenericPoints = 16;  // ... of a generic (prime) stage
constexpr int kTwLo = 64;      // the twiddle's low table: w_n^b, b < 64

// u / d by one multiply-high, exact while u * d < 2^32.
struct Div {
  unsigned d, m;
};

__device__ __forceinline__ Div make_div(int d) {
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

__device__ __forceinline__ float2 inter_twiddle(int e, const float2* lo,
                                                const float2* hi) {
  return cmul(hi[e >> 6], lo[e & (kTwLo - 1)]);
}

// The r-point DFT in registers; the odd radices read their roots w_r^k
// from shared memory.
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R], int inverse,
                                    const float2* w) {
  if constexpr (R == 2 || R == 4 || R == 8) {
    vkfft::Dft<R>::run(v, inverse, nullptr);
  } else {
    float2 wk[R];
#pragma unroll
    for (int k = 0; k < R; ++k) wk[k] = w[k];
    float2 out[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float2 acc = v[0];
#pragma unroll
      for (int j = 1; j < R; ++j) {
        const float2 t = wk[(i * j) % R];
        acc.x = fmaf(v[j].x, t.x, fmaf(-v[j].y, t.y, acc.x));
        acc.y = fmaf(v[j].x, t.y, fmaf(v[j].y, t.x, acc.y));
      }
      out[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = out[i];
  }
}

// One radix-R stage (R = 2, 3, 4, 5, 7, 8) of a pass, in place: one
// thread a butterfly, kPoints / R of them a round, each finished in
// registers before the barrier, so only its values and its output
// address live across it.  The factors' tables carry no scale, so the
// twiddle of output 0 is 1.  `flo`, when not null, multiplies output i of
// butterfly l of sequence (hi, lo) by the inter-factor twiddle of
// exponent lo * (i * L + l) (the last stage: Mp = 1).
template <int R>
__device__ void stage_fixed(float2* buf, const Pass& g, int L, int Mp,
                            const float2* tw, const float2* w, int inverse,
                            const float2* flo, const float2* fhi) {
  constexpr int K = kPoints / R;
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
    float2 v[K][R];
    int dst[K];
    int b = fresh_tid();
#pragma unroll
    for (int k = 0; k < K; ++k, b += T) {
      int q, l, m, lo;
      decode(min(b, total - 1), dq, dm, q, l, m);
      const int base = seq_base(g, q0 + q, lo);
      const float2* s = buf + base + (l * R * Mp + m) * g.es;
#pragma unroll
      for (int j = 0; j < R; ++j) v[k][j] = s[j * jstep];
      dft<R>(v[k], inverse, w);
#pragma unroll
      for (int i = 1; i < R; ++i) v[k][i] = cmul(v[k][i], tw[i * Mp + m]);
      if (flo != nullptr) {
#pragma unroll
        for (int i = 0; i < R; ++i)
          v[k][i] = cmul(v[k][i], inter_twiddle(lo * (i * L + l), flo, fhi));
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

// Any other radix (the primes 11..127): one thread an output, an R-term
// sum read from shared memory, kGenericPoints of them a round; the output
// index i slowest, so a warp shares its roots.
__device__ void stage_generic(float2* buf, const Pass& g, int R, int L,
                              int Mp, const float2* tw, const float2* w,
                              const float2* flo, const float2* fhi) {
  const int T = blockDim.x;
  const int per_seq = L * Mp;
  const int Q = min(g.seqs, kGenericPoints * T / (per_seq * R));
  const Div dm = make_div(Mp);
  const int jstep = Mp * g.es;
  for (int q0 = 0; q0 < g.seqs; q0 += Q) {
    const int nq = min(Q, g.seqs - q0);
    const Div dq = make_div(nq);
    const int nb = nq * per_seq;
    const Div db = make_div(nb);
    const int total = nb * R;
    float2 acc[kGenericPoints];
    int o = fresh_tid();
#pragma unroll
    for (int k = 0; k < kGenericPoints; ++k, o += T) {
      const int oc = min(o, total - 1);
      const int i = quot(oc, db);
      int q, l, m, lo;
      decode(oc - i * nb, dq, dm, q, l, m);
      const int base = seq_base(g, q0 + q, lo);
      const float2* s = buf + base + (l * R * Mp + m) * g.es;
      float2 a = s[0];
      int e = 0;
      for (int j = 1; j < R; ++j) {
        e += i;
        if (e >= R) e -= R;
        const float2 x = s[j * jstep];
        const float2 c = w[e];
        a.x = fmaf(x.x, c.x, fmaf(-x.y, c.y, a.x));
        a.y = fmaf(x.x, c.y, fmaf(x.y, c.x, a.y));
      }
      a = cmul(a, tw[i * Mp + m]);
      if (flo != nullptr)
        a = cmul(a, inter_twiddle(lo * (i * L + l), flo, fhi));
      acc[k] = a;
    }
    __syncthreads();
    // the outputs' positions are found again rather than held: 16
    // registers fewer through the barrier
    o = fresh_tid();
#pragma unroll
    for (int k = 0; k < kGenericPoints; ++k, o += T) {
      const int oc = min(o, total - 1);
      const int i = quot(oc, db);
      int q, l, m, lo;
      decode(oc - i * nb, dq, dm, q, l, m);
      const int at = seq_base(g, q0 + q, lo) + ((i * L + l) * Mp + m) * g.es;
      if (o < total) buf[at] = acc[k];
    }
  }
  __syncthreads();
}

// Every stage of plan p over the sequences of g; `flo`/`fhi` ride the last
// stage's write when `flo` is not null.
__device__ void run_pass(float2* buf, const Pass& g, const Plan& p,
                         const float2* tab, const float2* flo,
                         const float2* fhi) {
  int L = 1, M = p.n;
  for (int s = 0; s < p.n_stages; ++s) {
    const int r = p.radix[s];
    const int Mp = M / r;
    const float2* tw = tab + p.tw_off[s];
    const float2* w = tab + (p.dft_off[s] >= 0 ? p.dft_off[s] : 0);
    const float2* lo = s == p.n_stages - 1 ? flo : nullptr;
    switch (r) {
      case 2: stage_fixed<2>(buf, g, L, Mp, tw, w, p.inverse, lo, fhi); break;
      case 3: stage_fixed<3>(buf, g, L, Mp, tw, w, p.inverse, lo, fhi); break;
      case 4: stage_fixed<4>(buf, g, L, Mp, tw, w, p.inverse, lo, fhi); break;
      case 5: stage_fixed<5>(buf, g, L, Mp, tw, w, p.inverse, lo, fhi); break;
      case 7: stage_fixed<7>(buf, g, L, Mp, tw, w, p.inverse, lo, fhi); break;
      case 8: stage_fixed<8>(buf, g, L, Mp, tw, w, p.inverse, lo, fhi); break;
      default: stage_generic(buf, g, r, L, Mp, tw, w, lo, fhi); break;
    }
    L *= r;
    M = Mp;
  }
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

__device__ __forceinline__ bool aligned16(const float* a, const float* b) {
  return (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
}

// The `count` points at float offset g0 of the planes, as a head of up to
// three single floats to a 16-byte boundary, float4s, and a tail.
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

__device__ void load_lines(const float* xr, const float* xi, long long g0,
                           int count, const Map& mp, float2* home) {
  const Span sp = span_of(g0, count, aligned16(xr, xi));
  const int rot = (threadIdx.x >> 2) & 3;
  const float* r0 = xr + g0;
  const float* i0 = xi + g0;
#pragma unroll 2
  for (int f = threadIdx.x; f < sp.n4; f += blockDim.x) {
    const int u = sp.head + 4 * f;
    const float4 r = *reinterpret_cast<const float4*>(r0 + u);
    const float4 i = *reinterpret_cast<const float4*>(i0 + u);
    float2 v[4] = {make_float2(r.x, i.x), make_float2(r.y, i.y),
                   make_float2(r.z, i.z), make_float2(r.w, i.w)};
    int pos[4];
    positions(u, mp, pos);
    rotate(v, rot);
    rotate(pos, rot);
#pragma unroll
    for (int c = 0; c < 4; ++c) home[pos[c]] = v[c];
  }
  for (int k = threadIdx.x; k < sp.rest; k += blockDim.x) {
    const int u = k < sp.head ? k : sp.tail0 + k - sp.head;
    home[position(u, mp)] = make_float2(r0[u], i0[u]);
  }
}

__device__ void store_lines(const float2* home, const Map& mp, float* yr,
                            float* yi, long long g0, int count) {
  const Span sp = span_of(g0, count, aligned16(yr, yi));
  const int rot = (threadIdx.x >> 2) & 3;
  float* r0 = yr + g0;
  float* i0 = yi + g0;
#pragma unroll 2
  for (int f = threadIdx.x; f < sp.n4; f += blockDim.x) {
    const int u = sp.head + 4 * f;
    int pos[4];
    positions(u, mp, pos);
    rotate(pos, rot);
    float2 v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = home[pos[c]];
    rotate(v, (4 - rot) & 3);
    *reinterpret_cast<float4*>(r0 + u) = make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
    *reinterpret_cast<float4*>(i0 + u) = make_float4(v[0].y, v[1].y, v[2].y, v[3].y);
  }
  for (int k = threadIdx.x; k < sp.rest; k += blockDim.x) {
    const int u = k < sp.head ? k : sp.tail0 + k - sp.head;
    const float2 v = home[position(u, mp)];
    r0[u] = v.x;
    i0[u] = v.y;
  }
}

__device__ __forceinline__ Map make_map(int n, int lines_stride, bool transposed,
                                        int n1, int n2, int P) {
  return transposed ? Map{make_div(n), make_div(n2), lines_stride, 1, P}
                    : Map{make_div(n), make_div(n1), lines_stride, P, 1};
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_twofactor_kernel(const float* xr, const float* xi, float* yr, float* yi,
                     long long batch, Plan p1, Plan p2, const float2* t1,
                     const float2* t2, const float2* tw, int swapped,
                     int lines, int pitch, int len1, int len2) {
  extern __shared__ __align__(16) float2 smem[];
  const int n1 = p1.n, n2 = p2.n, n = n1 * n2;
  const int S = n2 * pitch;
  const long long line0 = (long long)blockIdx.x * lines;
  const int nl = (int)min((long long)lines, batch - line0);
  const long long g0 = line0 * n;
  float2* home = smem;
  float2* s1 = home + lines * S;
  float2* s2 = s1 + len1;
  float2* tlo = s2 + len2;
  float2* thi = tlo + kTwLo;
  const int ntab = len1 + len2 + kTwLo + (n + kTwLo - 1) / kTwLo;
  for (int t = threadIdx.x; t < ntab; t += blockDim.x)
    s1[t] = t < len1 ? __ldg(&t1[t])
                     : t < len1 + len2 ? __ldg(&t2[t - len1])
                                       : __ldg(&tw[t - len1 - len2]);
  const bool inverse = p1.inverse != 0;
  load_lines(xr, xi, g0, nl * n,
             make_map(n, S, inverse && !swapped, n1, n2, pitch), home);
  __syncthreads();
  // The forward runs the column pass (n2-point DFTs), then the row pass
  // (n1-point DFTs); the inverse the other way round.  One call site of
  // run_pass keeps one copy of each stage in the kernel.
  for (int k = 0; k < 2; ++k) {
    const bool row = (k == 0) == inverse;
    const Pass g = row ? Pass{nl * n2, S, pitch, 1, make_div(n2)}
                       : Pass{nl * n1, S, 1, pitch, make_div(n1)};
    const bool fuse = inverse ? row : row == (n2 == 1);
    run_pass(home, g, row ? p1 : p2, row ? s1 : s2, fuse ? tlo : nullptr,
             thi);
  }
  store_lines(home, make_map(n, S, !inverse && !swapped, n1, n2, pitch), yr,
              yi, g0, nl * n);
}

// Points of a plan's table (0 for the empty plan of a length-1 factor).
int table_len(const Plan& p) {
  int len = 0, M = p.n;
  for (int s = 0; s < p.n_stages; ++s) {
    const int r = p.radix[s], Mp = M / r;
    const int end = p.dft_off[s] >= 0 ? p.dft_off[s] + r : p.tw_off[s] + r * Mp;
    if (end > len) len = end;
    M = Mp;
  }
  return len;
}

// Whether `threads` hold a whole sequence of every stage of p in a round.
bool rounds_fit(const Plan& p, int threads) {
  for (int s = 0; s < p.n_stages; ++s) {
    const int r = p.radix[s];
    const bool fixed = r == 2 || r == 3 || r == 4 || r == 5 || r == 7 || r == 8;
    if (fixed ? (kPoints / r) * threads < p.n / r
              : kGenericPoints * threads < p.n)
      return false;
  }
  return true;
}

size_t smem_bytes(const Plan& p1, const Plan& p2, int lines) {
  const int n = p1.n * p2.n;
  return sizeof(float2) *
         ((size_t)lines * p2.n * (p1.n | 1) + table_len(p1) + table_len(p2) +
          kTwLo + (n + kTwLo - 1) / kTwLo);
}

int smem_opt_in(size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fft_twofactor_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  `plan1`/`plan2` are the int forms of the n1- and n2-point
// plans (both forward or both inverse; `plan2` may be the empty plan of a
// length-1 factor), `table1`/`table2` their stage tables (no scale) and
// `twiddle` the inter-factor twiddle's tables, 64 points w_n^(+-b) then
// ceil(n / 64) points scale * w_n^(+-64 a), all as interleaved fp32 pairs.
// The layout (cuda_kernels.twofactor_layout): `threads` a block (a
// multiple of 32 up to 512, enough for a whole sequence of every stage in
// a round), `lines` a block (lines * n <= 16384) and the dynamic shared
// bytes, which must be exactly what the layout needs and at most 227 KB;
// any other layout is refused (cudaErrorInvalidValue).
int vk_fft_twofactor(const float* xr, const float* xi, float* yr, float* yi,
                     long long batch, const int* plan1, const int* plan2,
                     const float* table1, const float* table2,
                     const float* twiddle, int swapped, int threads, int lines,
                     int smem, void* stream) {
  Plan p1, p2;
  if (batch < 1 || !vkfft::plan_from_ints(plan1, &p1) ||
      !vkfft::subplan_from_ints(plan2, &p2))
    return (int)cudaErrorInvalidValue;
  const int n = p1.n * p2.n;
  if (n < 2 || n > vkfft::kTwoFactorMaxN || p1.n < p2.n ||
      p1.inverse != p2.inverse || threads < 32 || threads > kThreads ||
      threads % 32 != 0 || lines < 1 || (long long)lines * n > vkfft::kTwoFactorMaxN ||
      !rounds_fit(p1, threads) || !rounds_fit(p2, threads) ||
      smem < 0 || (size_t)smem != smem_bytes(p1, p2, lines) ||
      smem > vkfft::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (batch + lines - 1) / lines;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int err = smem_opt_in(smem);
  if (err) return err;
  fft_twofactor_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, batch, p1, p2, reinterpret_cast<const float2*>(table1),
      reinterpret_cast<const float2*>(table2),
      reinterpret_cast<const float2*>(twiddle), swapped, lines, p1.n | 1,
      table_len(p1), table_len(p2));
  return (int)cudaGetLastError();
}

// Resident blocks an SM of the kernel at `threads` a block and `smem`
// dynamic shared bytes, into *blocks.
int vk_fft_twofactor_occupancy(int threads, int smem, int* blocks) {
  if (threads < 32 || threads > kThreads || smem < 0 ||
      smem > vkfft::kMaxSmemBytes || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  const int err = smem_opt_in(smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fft_twofactor_kernel, threads, smem);
}

const char* vk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
