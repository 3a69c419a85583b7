// Native planner core — C++ implementation of the hot host-side planning
// loops, mirroring the reference's C scheduler
// (vkFFT_PlanManagement/vkFFT_HostFunctions/vkFFT_Scheduler.h): trial
// factorization (ref :2289-2301), Rader prime scan / primitive-root search
// (ref :2324-2404), Bluestein smooth padded-size selection (ref :2406-2578),
// and radix grouping (ref axis-split search :2651-2888).
//
// A copy of the JAX package's vkfft_tpu/native/planner_core.cpp, exposed as
// a C ABI for ctypes: vkfft_tpu_torch/planner/native.py builds it at first
// use (c++ -O2 -fPIC -std=c++17 -shared, into vkfft_tpu_torch/_build/ under
// a name keyed by this source and the flags) and the Python planner calls
// it, falling back to the pure-Python implementations where no compiler
// exists.  Semantics are kept bit-identical to the Python versions — tests
// assert parity over a large size sweep (tests/test_torch_native.py).

#include <cstdint>
#include <algorithm>
#include <vector>

extern "C" {

// Factorize n into ascending primes.  Writes up to cap entries; returns the
// count (or -1 if cap exceeded).
int64_t vt_prime_factors(int64_t n, int64_t* out, int64_t cap) {
    if (n < 1) return -1;
    int64_t cnt = 0;
    auto push = [&](int64_t p) -> bool {
        if (cnt >= cap) return false;
        out[cnt++] = p;
        return true;
    };
    const int64_t small[6] = {2, 3, 5, 7, 11, 13};
    for (int64_t p : small)
        while (n % p == 0) {
            if (!push(p)) return -1;
            n /= p;
        }
    for (int64_t f = 17; f * f <= n; f += 2)
        while (n % f == 0) {
            if (!push(f)) return -1;
            n /= f;
        }
    if (n > 1 && !push(n)) return -1;
    return cnt;
}

int32_t vt_is_prime(int64_t n) {
    if (n < 2) return 0;
    if (n % 2 == 0) return n == 2;
    for (int64_t f = 3; f * f <= n; f += 2)
        if (n % f == 0) return 0;
    return 1;
}

// Smallest m >= n whose prime factors all lie in {2,3,5,7,11,13}
// (branch-and-bound over smooth candidates; reference consults vendor
// padding tables instead, vkFFT_InitializeApp.h:32-427).
int64_t vt_next_smooth(int64_t n) {
    if (n <= 1) return 1;
    // next power of two always works as the initial bound
    int64_t best = 1;
    while (best < n) best <<= 1;
    const int64_t primes[6] = {2, 3, 5, 7, 11, 13};
    struct Frame { int64_t value; int idx; };
    std::vector<Frame> stack;
    stack.push_back({1, 0});
    while (!stack.empty()) {
        Frame f = stack.back();
        stack.pop_back();
        if (f.value >= n) {
            if (f.value < best) best = f.value;
            continue;
        }
        if (f.idx >= 6) continue;
        for (int64_t v = f.value; v < best; v *= primes[f.idx]) {
            stack.push_back({v, f.idx + 1});
            if (v > best / primes[f.idx]) break;  // overflow guard
        }
    }
    return best;
}

// Group a prime multiset (ascending) into stage radices <= max_radix,
// mirroring the Python _group_radices greedy exactly.  Returns count.
int64_t vt_group_radices(const int64_t* primes, int64_t nprimes,
                         int64_t max_radix, int64_t* out, int64_t cap) {
    int64_t twos = 0;
    std::vector<int64_t> odds;
    for (int64_t i = 0; i < nprimes; ++i) {
        if (primes[i] == 2) ++twos;
        else odds.push_back(primes[i]);
    }
    std::sort(odds.rbegin(), odds.rend());
    std::vector<int64_t> radices;
    int64_t cur = 1;
    for (int64_t p : odds) {
        if (cur * p <= max_radix) cur *= p;
        else { radices.push_back(cur); cur = p; }
    }
    while (twos && cur * 2 <= max_radix) { cur *= 2; --twos; }
    if (cur > 1) radices.push_back(cur);

    int64_t four_bits = 0;
    while ((int64_t(1) << (four_bits + 1)) <= max_radix) ++four_bits;
    while (twos >= four_bits) {
        radices.push_back(int64_t(1) << four_bits);
        twos -= four_bits;
    }
    if (twos) {
        int64_t last = radices.empty() ? 0 : radices.back();
        if (twos == 1 && !radices.empty() && (last == 8 || last == 16)) {
            radices.pop_back();
            radices.push_back(last / 2);
            radices.push_back(4);
        } else {
            radices.push_back(int64_t(1) << twos);
        }
    }
    std::sort(radices.rbegin(), radices.rend());
    if ((int64_t)radices.size() > cap) return -1;
    for (size_t i = 0; i < radices.size(); ++i) out[i] = radices[i];
    return (int64_t)radices.size();
}

// Smallest primitive root mod prime p (Rader generator search,
// ref vkFFT_Scheduler.h:2324-2340).
static int64_t pow_mod(int64_t b, int64_t e, int64_t m) {
    __int128 r = 1, base = b % m;
    while (e) {
        if (e & 1) r = (r * base) % m;
        base = (base * base) % m;
        e >>= 1;
    }
    return (int64_t)r;
}

int64_t vt_primitive_root(int64_t p) {
    int64_t phi = p - 1, x = phi;
    int64_t factors[64];
    int64_t nf = 0;
    for (int64_t d = 2; d * d <= x; ++d)
        if (x % d == 0) {
            factors[nf++] = d;
            while (x % d == 0) x /= d;
        }
    if (x > 1) factors[nf++] = x;
    for (int64_t g = 2; g < p; ++g) {
        bool ok = true;
        for (int64_t i = 0; i < nf; ++i)
            if (pow_mod(g, phi / factors[i], p) == 1) { ok = false; break; }
        if (ok) return g;
    }
    return -1;
}

// Bluestein padded-size selection: pick the cheapest smooth M >= 2n-1 by the
// stage-MAC cost model m * (sum(radices(m)) + 4) / n (ref picks from vendor
// tables with the same bigger-but-faster logic, :2406-2578).
int64_t vt_bluestein_size(int64_t n, int64_t max_direct_prime,
                          int64_t group_radix) {
    int64_t lo = 2 * n - 1;
    // Long-conv regime (M beyond the 16384 single-kernel range): M = nc*ns
    // with nc a lane-tile multiple and ns in the v3 range (<= 8192), so the
    // Bluestein convolution runs the fused 3-kernel long path.  Mirrors
    // _bluestein_padded_size in planner/factorize.py bit-for-bit.
    if (lo > 16384) {
        int64_t best = -1;
        const int64_t ncs[4] = {128, 256, 512, 1024};
        for (int i = 0; i < 4; ++i) {
            int64_t ns = vt_next_smooth((lo + ncs[i] - 1) / ncs[i]);
            if (ns <= 8192) {
                int64_t m = ncs[i] * ns;
                if (best < 0 || m < best) best = m;
            }
        }
        // pow-2 M preferred within 1.7x (all-K=128-class conv stages;
        // e40 measured it 14% faster at 1.6x the data) — mirrors
        // _bluestein_padded_size bit-for-bit
        int64_t p2 = 1;
        while (p2 < lo) p2 <<= 1;
        if (best > 0 && p2 <= (best * 17) / 10 && (p2 / 128) <= 8192)
            return p2;
        if (best > 0) return best;
    }
    int64_t cands[8];
    int64_t nc = 0;
    int64_t c = vt_next_smooth(lo);
    cands[nc++] = c;
    int64_t p2 = 1;
    while (p2 < lo) p2 <<= 1;
    cands[nc++] = p2;
    for (int k = 0; k < 3; ++k) {
        c = vt_next_smooth(c + 1);
        cands[nc++] = c;
    }
    double best_cost = 0;
    int64_t best = -1;
    for (int64_t i = 0; i < nc; ++i) {
        int64_t m = cands[i];
        int64_t primes[64];
        int64_t np = vt_prime_factors(m, primes, 64);
        if (np < 0) continue;
        bool smooth = true;
        for (int64_t j = 0; j < np; ++j)
            if (primes[j] > max_direct_prime) { smooth = false; break; }
        if (!smooth) continue;
        // big primes stay standalone; small ones group
        int64_t small[64], big_sum = 0, ns = 0;
        for (int64_t j = 0; j < np; ++j) {
            if (primes[j] > group_radix) big_sum += primes[j];
            else small[ns++] = primes[j];
        }
        int64_t rad[64];
        int64_t nr = vt_group_radices(small, ns, group_radix, rad, 64);
        int64_t sum = big_sum;
        for (int64_t j = 0; j < nr; ++j) sum += rad[j];
        double cost = double(m) * double(sum + 4) / double(n);
        if (best < 0 || cost < best_cost) { best = m; best_cost = cost; }
    }
    return best;
}

// --- full decomposition cascade -------------------------------------------
// Mirrors decompose() in planner/factorize.py (reference decision cascade
// vkFFT_Scheduler.h:2289-2578): DIRECT (all primes <= max_direct_prime as
// dense DFT stages) -> RADER (prime n, smooth n-1) -> SPLIT (composite with
// a Rader-eligible big prime factor) -> BLUESTEIN (cost-model padded size).

// Stage radices for n when all primes <= max_direct_prime: primes in
// (group_radix, max_direct_prime] stay standalone (descending), the rest
// group greedily.  Returns false when n has a larger prime factor.
static bool smooth_radices(int64_t n, int64_t max_direct_prime,
                           int64_t group_radix, std::vector<int64_t>& out) {
    int64_t primes[64];
    int64_t np = vt_prime_factors(n, primes, 64);
    if (np < 0) return false;
    std::vector<int64_t> small, bigp;
    for (int64_t j = 0; j < np; ++j) {
        if (primes[j] > max_direct_prime) return false;
        if (primes[j] > group_radix) bigp.push_back(primes[j]);
        else small.push_back(primes[j]);
    }
    std::sort(bigp.rbegin(), bigp.rend());
    int64_t rad[64];
    int64_t dummy = 0;
    int64_t nr = vt_group_radices(small.empty() ? &dummy : small.data(),
                                  (int64_t)small.size(), group_radix, rad, 64);
    if (nr < 0) return false;
    out = bigp;
    for (int64_t j = 0; j < nr; ++j) out.push_back(rad[j]);
    return true;
}

// Decomposition decision for one 1-D length.  Output layout:
//   out[0] = algorithm (0 DIRECT, 1 RADER, 2 BLUESTEIN, 3 SPLIT)
//   out[1] = aux1 (RADER: prime; BLUESTEIN: padded size M; SPLIT: factor a)
//   out[2] = aux2 (SPLIT: factor b; else 0)
//   out[3] = number of stage radices, followed by the radices.
// Returns the total entries written, or -1 on error/overflow.
int64_t vt_decompose(int64_t n, int32_t allow_rader, int64_t max_direct_prime,
                     int64_t group_radix, int64_t rader_max_prime,
                     int64_t* out, int64_t cap) {
    if (n < 1 || cap < 4) return -1;
    auto emit = [&](int64_t algo, int64_t a1, int64_t a2,
                    const std::vector<int64_t>& rad) -> int64_t {
        if (4 + (int64_t)rad.size() > cap) return -1;
        out[0] = algo; out[1] = a1; out[2] = a2;
        out[3] = (int64_t)rad.size();
        for (size_t i = 0; i < rad.size(); ++i) out[4 + i] = rad[i];
        return 4 + (int64_t)rad.size();
    };
    std::vector<int64_t> rad;
    if (n == 1) return emit(0, 0, 0, rad);
    if (smooth_radices(n, max_direct_prime, group_radix, rad))
        return emit(0, 0, 0, rad);

    int64_t primes[64];
    int64_t np = vt_prime_factors(n, primes, 64);
    if (np < 0) return -1;
    const int64_t rader_min = max_direct_prime + 1;

    // prime n with smooth n-1 -> Rader at exact size
    if (allow_rader && np == 1 && n >= rader_min && n <= rader_max_prime) {
        std::vector<int64_t> r1;
        if (smooth_radices(n - 1, max_direct_prime, group_radix, r1))
            return emit(1, n, 0, r1);
    }

    // composite bearing a Rader-eligible big prime: one Cooley-Tukey split,
    // largest eligible prime first, provided the cofactor avoids Bluestein
    if (allow_rader && np > 1) {
        std::vector<int64_t> big;
        for (int64_t j = 0; j < np; ++j)
            if (primes[j] > max_direct_prime &&
                (big.empty() || big.back() != primes[j]))
                big.push_back(primes[j]);
        std::sort(big.rbegin(), big.rend());
        for (int64_t p : big) {
            if (p < rader_min || p > rader_max_prime) continue;
            std::vector<int64_t> pm1;
            if (!smooth_radices(p - 1, max_direct_prime, group_radix, pm1))
                continue;
            int64_t rest = n / p;
            std::vector<int64_t> tmp(cap);
            int64_t rc = vt_decompose(rest, allow_rader, max_direct_prime,
                                      group_radix, rader_max_prime,
                                      tmp.data(), cap);
            if (rc >= 4 && tmp[0] != 2) {
                std::vector<int64_t> none;
                return emit(3, p, rest, none);
            }
        }
    }

    int64_t m = vt_bluestein_size(n, max_direct_prime, group_radix);
    if (m < 0) return -1;
    std::vector<int64_t> rm;
    if (!smooth_radices(m, max_direct_prime, group_radix, rm)) return -1;
    return emit(2, m, 0, rm);
}

}  // extern "C"
