// Sums of the backward kernels' scene cotangents whose order does not
// matter (K2, K4 and K5): fixed point in two 64-bit digits.
//
// A float sum rounds after every add, so its bits depend on the order of its
// terms, and the order in which a kernel's threads reach a shared or global
// atomic, or which lanes of a warp arrive together at a shuffle tree, is the
// scheduler's. So every term a thread hands to its accumulator becomes an
// integer, q = rint(x * 2^F) (in double, round to nearest even), and every
// sum across threads is an integer sum: exact, so the same in any order and
// any grouping. A thread's own terms keep the program's order.
//
// The terms of one launch span ~40 binary orders (a 1920x1080 trace
// backward under cotangents of |g| <= 1 adds terms up to 2^28, at horizon
// pixels, beside a typical 2^-10), more than one int64 holds beside the
// count of its terms. So q is split into two digits, q = hi * 2^L + lo
// with lo in [-2^(L-1), 2^(L-1)), each digit summed in an int64 block of
// its own (in the block's shared memory, as the float block was, then the
// launch's global one). The hi digit is nonzero only for terms past
// 2^FIXED_HEAD |g| at the first scale, but those are common where a
// pixel's camera cotangent is large (a rotation moves a far textured floor
// by many pixel widths), so it sums in shared memory too rather than in
// global memory, where every warp's hi digits would queue on the camera
// row's few words (PERF.md §6). Each entry turns into a float once,
// (float)(((double)hi * 2^L + (double)lo) * 2^-F), added to the output
// block.
//
// The scale F and the lo digit's width L: a launch first takes L = 31 and F
// from the cotangent planes' largest finite |g| < 2^eG (first_scale): F =
// 30 - FIXED_HEAD - eG, a grid of 2^(eG - 30), so a term up to 2^FIXED_HEAD
// |g| stays in the lo digit and one up to 2^(32 + FIXED_HEAD) |g| fits q.
// The grid is that fine because an entry may sum thousands of terms each far
// below |g| (K4's glow distance under a standard-normal cotangent: ~1e-7
// against |g| ~ 3.5), which a grid of 2^(eG - 20) rounded to 0 (7% of that
// entry). The kernel counts its terms and the largest exponent among them
// as it adds (each thread a count and a largest exponent, summed and maxed
// over the launch: integers again, so the same on every run). Where they do
// not fit those digits (fits(): 2^32 terms or more, or a term's q past
// 2^62), the launch runs again with the split its counts give (retry_split):
// n = the bits of the count (count < 2^n: count_bits), L = min(31, 63 - n)
// and F such that q stays below 2^Q, Q = min(62, 126 - 2n). Then fewer than
// 2^n terms of lo digits below 2^(L-1) and of hi digits at most 2^(Q-L)
// sum within int64 in any order, for every n up to FIXED_SPLIT_BITS, so
// that second run fits by construction; under 2^32 terms it is the first
// run's split at a coarser F. A count past FIXED_SPLIT_BITS bits (2^62
// terms: at 10^12 terms a second, 53 days a launch), or a second run that
// does not fit, returns FIXED_OVERFLOW: never a wrapped sum. The retry's
// grid is 2^-Q of its largest term's bound (2^-58 at 2^34 terms, 2^-46 at
// 2^40: far finer than a float's 2^-24), coarser than the first run's
// 2^(eG - 30) only where that term passes 2^(Q - 30) |g|. A non-finite term
// (the record overflow's NaN poison, an inf) skips the integers: it is
// added straight to the output block in float, where NaN and inf come out
// the same in any order.
//
// Everything here is __host__ __device__, so the g++ host builds
// (trace_bwd_host.cpp, march_bwd_host.cpp, trace_retrace_host.cpp) sum the
// same integers with the same scale and split (host_fixed_sum), and the
// tests hold the arithmetic on the CPU. A host build with
// -DRT_FIXED_TERMS_SHIFT=S counts each term as 2^S terms when it chooses a
// split (a test's hook: at S = 22 a thousand terms take the split that 2^32
// take on the card); the card's builds never set it.
#pragma once

#include <limits.h>
#include <math.h>
#include <string.h>

#ifdef __CUDACC__
#define RT_FX __host__ __device__ inline
#else
#define RT_FX inline
#endif

namespace rt {

// The bits of the first run's lo digit (centred: [-2^30, 2^30)).
constexpr int FIXED_LO_BITS = 31;
// How far past the largest |g| a term may reach and stay in the lo digit
// at the first scale, in binary orders (the grid: 2^(eG - 30 - FIXED_HEAD)).
constexpr int FIXED_HEAD = 0;
// A term's q stays below 2^62, a bit inside int64.
constexpr int FIXED_Q_BITS = 62;
// The most bits of a count that some split holds (L = 63 - n >= 1).
constexpr int FIXED_SPLIT_BITS = 62;
// A launch's return code where its sums cannot be held (the wrappers name it
// by rt_error_string); above the CUDA runtime's codes.
constexpr int FIXED_OVERFLOW = 1001;
// The forced scale of a launch that takes first_scale's.
constexpr int FIXED_FREE = INT_MIN;

// What a launch counts as it adds: the largest finite |g| as float bits (a
// non-negative float orders as its bits), the nonzero finite terms, and the
// largest exponent field among them (exp_field).
struct FixedStats {
  unsigned long long count;
  unsigned gbits;
  int efield;
};

RT_FX unsigned f32_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  unsigned u;
  memcpy(&u, &x, sizeof(u));
  return u;
#endif
}

// |x|'s bits for finite x, else 0.
RT_FX unsigned finite_abs_bits(float x) {
  const unsigned a = f32_bits(x) & 0x7FFFFFFFu;
  return a < 0x7F800000u ? a : 0u;
}

// The biased exponent field of finite x, at least 1: |x| < 2^(exp_field - 126).
RT_FX int exp_field(float x) {
  const int e = static_cast<int>((f32_bits(x) >> 23) & 0xFFu);
  return e < 1 ? 1 : e;
}

// The least k with 2^k >= v (0 for v <= 1).
RT_FX int ceil_log2(unsigned long long v) {
  int k = 0;
  while (k < 64 && (1ull << k) < v) ++k;
  return k;
}

// The first run's scale, from the largest finite |g| (its bits).
RT_FX int first_scale(unsigned gbits) {
  const int eg = static_cast<int>((gbits >> 23) & 0xFFu);
  return FIXED_LO_BITS - 1 - FIXED_HEAD - ((eg < 1 ? 1 : eg) - 126);
}

#ifndef RT_FIXED_TERMS_SHIFT
#define RT_FIXED_TERMS_SHIFT 0
#endif

// The bits of ``count`` terms (count < 2^n; 0 for none), each term counted
// as 2^RT_FIXED_TERMS_SHIFT.
RT_FX int count_bits(unsigned long long count) {
  int k = 0;
  while (k < 64 && (count >> k) != 0) ++k;
  return count == 0 ? 0 : k + RT_FIXED_TERMS_SHIFT;
}

// log2 of ``count`` terms rounded up, counted as count_bits counts them.
RT_FX int terms_log2(unsigned long long count) {
  return count == 0 ? 0 : ceil_log2(count) + RT_FIXED_TERMS_SHIFT;
}

// Whether ``count`` terms below 2^(efield - 126) each are held at scale f
// with an L = ``lo_bits`` lo digit: each term's q below 2^62, and the sums
// of its digits within int64 in any order (count < 2^n: lo digits below
// 2^(L-1) and hi digits at most 2^(q-L) each). At L = 31 it is the bound the
// first run always had: fewer than 2^32 terms, q below 2^62.
RT_FX bool fits(unsigned long long count, int efield, int f, int lo_bits) {
  const int n = count_bits(count), q = (efield - 126) + f;
  return count == 0 || (q <= FIXED_Q_BITS && n + lo_bits <= 63 && n + q - lo_bits <= 63);
}

// The split of a second run of terms below 2^(efield - 126) each, whose
// count takes n bits (count_bits): *lo_bits = min(31, 63 - n) and *f such
// that q stays below 2^min(62, 126 - 2n), which fits() by construction.
// False (and nothing set) past FIXED_SPLIT_BITS.
RT_FX bool retry_split(int n, int efield, int* f, int* lo_bits) {
  if (n > FIXED_SPLIT_BITS) return false;
  const int q_bits = n <= 32 ? FIXED_Q_BITS : 126 - 2 * n;
  *lo_bits = n <= 32 ? FIXED_LO_BITS : 63 - n;
  *f = q_bits - (efield - 126);
  return true;
}

// rint(x * scale), scale a power of two (exact in double).
RT_FX long long to_fixed(float x, double scale) {
  const double y = static_cast<double>(x) * scale;
#ifdef __CUDA_ARCH__
  return __double2ll_rn(y);
#else
  return llrint(y);
#endif
}

// q's lo digit of ``lo_bits`` = L bits, in [-2^(L-1), 2^(L-1)); its hi
// digit is (q - lo) >> L.
RT_FX long long lo_digit(long long q, int lo_bits) {
  const long long half = 1ll << (lo_bits - 1);
  return ((q + half) & ((1ll << lo_bits) - 1)) - half;
}

RT_FX long long hi_digit(long long q, long long lo, int lo_bits) { return (q - lo) >> lo_bits; }

// The entry with digit sums (hi, lo) at scale f and an L = ``lo_bits`` lo
// digit as a float: each digit sum rounds to double (nearest even), the
// powers of two are exact, then one rounding to float.
RT_FX float from_fixed(long long hi, long long lo, int f, int lo_bits) {
  return static_cast<float>(
      (static_cast<double>(hi) * ldexp(1.0, lo_bits) + static_cast<double>(lo)) *
      ldexp(1.0, -f));
}

#ifdef __CUDA_ARCH__
using TermCount = unsigned;  // one thread's terms
#else
using TermCount = unsigned long long;  // a host loop's, the whole launch
#endif

// *at += v: on the card an int64 atomicAdd (shared or global memory).
RT_FX void add_digit(long long* at, long long v) {
#ifdef __CUDA_ARCH__
  atomicAdd(reinterpret_cast<unsigned long long*>(at), static_cast<unsigned long long>(v));
#else
  *at += v;
#endif
}

// The part of an accumulator that turns one thread's terms into integers and
// counts them at its launch's scale and split; ``poison`` is the float
// output block, which takes the non-finite terms, and ``hi`` the block of hi
// digits beside the accumulator's lo digits (the same memory: shared, or
// global).
struct FixedTerms {
  double scale;
  float* poison;
  long long* hi;
  int lo_bits;
  TermCount count = 0;
  int efield = 1;

  RT_FX FixedTerms(int f, int lo_width, float* out, long long* hi_block)
      : scale(ldexp(1.0, f)), poison(out), hi(hi_block), lo_bits(lo_width) {}

  // x at ``entry`` of the block as an integer (0 for 0 and for a
  // non-finite x, which goes to the float block).
  RT_FX long long take(int entry, float x) {
    if (x == 0.0f) return 0;
    if (finite_abs_bits(x) == 0u) {  // inf or NaN
#ifdef __CUDA_ARCH__
      atomicAdd(&poison[entry], x);
#else
      poison[entry] += x;
#endif
      return 0;
    }
    ++count;
    const int e = exp_field(x);
    efield = e > efield ? e : efield;
    return to_fixed(x, scale);
  }

  // q's digits at this launch's split.
  RT_FX long long lo_digit(long long q) const { return rt::lo_digit(q, lo_bits); }
  RT_FX long long hi_digit(long long q, long long lo) const {
    return rt::hi_digit(q, lo, lo_bits);
  }

  // Adds integer q at ``entry``: its lo digit to ``lo_block``, its hi
  // digit (if any) to the hi block.
  RT_FX void put(long long* lo_block, int entry, long long q) {
    const long long lo = lo_digit(q), h = hi_digit(q, lo);
    if (lo != 0) add_digit(&lo_block[entry], lo);
    if (h != 0) add_digit(&hi[entry], h);
  }
};

// How many values rt_fixed_stats gives (last_fixed).
constexpr int FIXED_STATS = 7;

// The last launch's scale, its counts, whether it ran twice and its split,
// for the libraries' rt_fixed_stats: [first scale, scale taken, runs, log2
// of the terms rounded up (terms_log2), largest term's exponent bound (|x| <
// 2^E), the cotangent planes' (|g| < 2^eG), the lo digit's width taken].
inline int* last_fixed() {
  static int last[FIXED_STATS] = {};
  return last;
}

inline void record_fixed(int first, int scale, int runs, const FixedStats& h, int lo_bits) {
  int* last = last_fixed();
  last[0] = first;
  last[1] = scale;
  last[2] = runs;
  last[3] = terms_log2(h.count);
  last[4] = h.efield - 126;
  last[5] = static_cast<int>((h.gbits >> 23) & 0xFFu) - 126;
  last[6] = lo_bits;
}

}  // namespace rt

#ifndef __CUDACC__
#include <algorithm>
#include <vector>

namespace rt {

// The largest finite |g| of three planes of ``pixels`` floats, as bits (a
// null plane has none).
inline unsigned planes_gbits(const float* g_r, const float* g_g, const float* g_b,
                             long long pixels) {
  unsigned gbits = 0;
  for (const float* g : {g_r, g_g, g_b})
    for (long long i = 0; g != nullptr && i < pixels; ++i)
      gbits = std::max(gbits, finite_abs_bits(g[i]));
  return gbits;
}

// The host builds' launch: ``run(lo, terms)`` runs the loop over the
// window's pixels with an accumulator on the int64 block of lo digits
// ``lo`` and ``terms`` (whose hi block is the launch's), and returns the
// accumulator's terms; then, as the kernels' launch does, the scale
// (first_scale of the planes' largest |g|, bits ``gbits``) and the 31-bit
// lo digit are checked against its counts (one more run at retry_split's
// where they do not fit) and each nonzero entry is added to ``out``
// (``entries`` floats); last_fixed records the launch. ``forced``: the
// scale to take instead of first_scale's (no retry: FIXED_OVERFLOW where it
// does not fit). Returns 0 or FIXED_OVERFLOW; ``*scale_out`` (if not null)
// the scale taken.
template <class Run>
int host_fixed_sum(float* out, int entries, unsigned gbits, Run&& run, int forced = FIXED_FREE,
                   int* scale_out = nullptr) {
  const int first = forced == FIXED_FREE ? first_scale(gbits) : forced;
  int f = first, lo_bits = FIXED_LO_BITS, runs = 0;
  std::vector<long long> lo(static_cast<size_t>(entries)), hi(static_cast<size_t>(entries));
  FixedStats h = {0, gbits, 1};
  for (;;) {
    std::fill(lo.begin(), lo.end(), 0ll);
    std::fill(hi.begin(), hi.end(), 0ll);
    const FixedTerms t = run(lo.data(), FixedTerms(f, lo_bits, out, hi.data()));
    ++runs;
    h.count = t.count;
    h.efield = t.efield;
    if (fits(t.count, t.efield, f, lo_bits)) break;
    if (runs > 1 || forced != FIXED_FREE ||
        !retry_split(count_bits(t.count), t.efield, &f, &lo_bits))
      return FIXED_OVERFLOW;
  }
  for (int k = 0; k < entries; ++k)
    if (lo[k] != 0 || hi[k] != 0) out[k] += from_fixed(hi[k], lo[k], f, lo_bits);
  if (scale_out != nullptr) *scale_out = f;
  record_fixed(first, f, runs, h, lo_bits);
  return 0;
}

}  // namespace rt
#endif
