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
// count of its terms. So q is split into two digits, q = hi * 2^31 + lo
// with lo in [-2^30, 2^30), each digit summed in an int64 block of its own
// (in the block's shared memory, as the float block was, then the launch's
// global one). The hi digit is nonzero only for terms past 2^FIXED_HEAD |g|,
// but those are common where a pixel's camera cotangent is large (a
// rotation moves a far textured floor by many pixel widths), so it sums in
// shared memory too rather than in global memory, where every warp's hi
// digits would queue on the camera row's few words (PERF.md §6).
// With at most 2^32 terms a launch (fits()) neither digit's partial sums,
// in any order, pass 2^63. Each entry turns into a float once,
// (float)(((double)hi * 2^31 + (double)lo) * 2^-F), added to the output
// block.
//
// The scale F: a launch first takes it from the cotangent planes' largest
// finite |g| < 2^eG (first_scale): F = 30 - FIXED_HEAD - eG, a grid of
// 2^(eG - 30), so a term up to 2^FIXED_HEAD |g| stays in the lo digit and
// one up to 2^(32 + FIXED_HEAD) |g| fits q. The grid is that fine because
// an entry may sum thousands of terms each far below |g| (K4's glow
// distance under a standard-normal cotangent: ~1e-7 against |g| ~ 3.5),
// which a grid of 2^(eG - 20) rounded to 0 (7% of that entry). The kernel counts its terms and
// the largest exponent among them as it adds (each thread a count and a
// largest exponent, summed and maxed over the launch: integers again, so the
// same on every run); where a term's q would not fit (fits()), the launch
// runs again at the coarser scale the counts give (retry_scale), which fits
// by construction. Past 2^32 terms, or were the second run not to fit, the
// launch returns FIXED_OVERFLOW: never a wrapped sum. A non-finite term
// (the record overflow's NaN poison, an inf) skips the integers: it is added
// straight to the output block in float, where NaN and inf come out the
// same in any order.
//
// Everything here is __host__ __device__, so the g++ host builds
// (trace_bwd_host.cpp, march_bwd_host.cpp, trace_retrace_host.cpp) sum the
// same integers with the same scale (host_fixed_sum), and the tests hold the
// arithmetic on the CPU.
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

// The bits of the lo digit (centred: [-2^30, 2^30)).
constexpr int FIXED_LO_BITS = 31;
// How far past the largest |g| a term may reach and stay in the lo digit
// at the first scale, in binary orders (the grid: 2^(eG - 30 - FIXED_HEAD)).
constexpr int FIXED_HEAD = 0;
// The most terms a launch may add (log2): each digit's sums stay in int64.
constexpr int FIXED_TERMS_BITS = 32;
// A term's q stays within 2^62, a bit inside int64.
constexpr int FIXED_Q_BITS = 62;
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

// Whether ``count`` terms below 2^(efield - 126) each are held at scale f:
// each term's q within 2^62, and few enough terms for either digit's sums.
RT_FX bool fits(unsigned long long count, int efield, int f) {
  return count == 0 ||
         (ceil_log2(count) <= FIXED_TERMS_BITS && (efield - 126) + f <= FIXED_Q_BITS);
}

// The finest scale at which terms below 2^(efield - 126) fit.
RT_FX int retry_scale(int efield) { return FIXED_Q_BITS - (efield - 126); }

// rint(x * scale), scale a power of two (exact in double).
RT_FX long long to_fixed(float x, double scale) {
  const double y = static_cast<double>(x) * scale;
#ifdef __CUDA_ARCH__
  return __double2ll_rn(y);
#else
  return llrint(y);
#endif
}

// q's lo digit, in [-2^30, 2^30); its hi digit is (q - lo) >> 31.
RT_FX long long lo_digit(long long q) {
  const long long half = 1ll << (FIXED_LO_BITS - 1);
  return ((q + half) & ((1ll << FIXED_LO_BITS) - 1)) - half;
}

RT_FX long long hi_digit(long long q, long long lo) { return (q - lo) >> FIXED_LO_BITS; }

// The entry with digit sums (hi, lo) at scale f as a float: each digit sum
// rounds to double (nearest even), the powers of two are exact, then one
// rounding to float.
RT_FX float from_fixed(long long hi, long long lo, int f) {
  return static_cast<float>(
      (static_cast<double>(hi) * ldexp(1.0, FIXED_LO_BITS) + static_cast<double>(lo)) *
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
// counts them; ``poison`` is the float output block, which takes the
// non-finite terms, and ``hi`` the block of hi digits beside the
// accumulator's lo digits (the same memory: shared, or global).
struct FixedTerms {
  double scale;
  float* poison;
  long long* hi;
  TermCount count = 0;
  int efield = 1;

  RT_FX FixedTerms(int f, float* out, long long* hi_block)
      : scale(ldexp(1.0, f)), poison(out), hi(hi_block) {}

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

  // Adds integer q at ``entry``: its lo digit to ``lo_block``, its hi
  // digit (if any) to the hi block.
  RT_FX void put(long long* lo_block, int entry, long long q) {
    const long long lo = lo_digit(q), h = hi_digit(q, lo);
    if (lo != 0) add_digit(&lo_block[entry], lo);
    if (h != 0) add_digit(&hi[entry], h);
  }
};

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
// (first_scale of the planes' largest |g|, bits ``gbits``) is checked
// against its counts (one more run at retry_scale where it does not fit)
// and each nonzero entry is added to ``out`` (``entries`` floats).
// ``forced``: the scale to take instead of first_scale's (no retry:
// FIXED_OVERFLOW where it does not fit). Returns 0 or FIXED_OVERFLOW;
// ``*scale_out`` (if not null) the scale taken.
template <class Run>
int host_fixed_sum(float* out, int entries, unsigned gbits, Run&& run, int forced = FIXED_FREE,
                   int* scale_out = nullptr) {
  int f = forced == FIXED_FREE ? first_scale(gbits) : forced;
  std::vector<long long> lo(static_cast<size_t>(entries)), hi(static_cast<size_t>(entries));
  for (int attempt = 0;; ++attempt) {
    std::fill(lo.begin(), lo.end(), 0ll);
    std::fill(hi.begin(), hi.end(), 0ll);
    const FixedTerms t = run(lo.data(), FixedTerms(f, out, hi.data()));
    if (fits(t.count, t.efield, f)) break;
    if (attempt > 0 || forced != FIXED_FREE || ceil_log2(t.count) > FIXED_TERMS_BITS)
      return FIXED_OVERFLOW;
    f = retry_scale(t.efield);
  }
  for (int k = 0; k < entries; ++k)
    if (lo[k] != 0 || hi[k] != 0) out[k] += from_fixed(hi[k], lo[k], f);
  if (scale_out != nullptr) *scale_out = f;
  return 0;
}

}  // namespace rt
#endif
