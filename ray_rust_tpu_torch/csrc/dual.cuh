// Forward-mode numbers for the re-trace gradient (K5, trace_retrace.cu):
// Dual<L> is one f32 value and L f32 tangents, the derivatives of the value
// by L seeded entries of the scene tables (a pixel's local entries,
// trace_body.cuh:object_entry).
//
// The value of every operation is the same f32 operation, on the same
// operands in the same order, as the float code it replaces, so a body
// instantiated with Dual<L> computes the float body's values bit for bit
// (under --fmad=false on the card, -ffp-contract=off on the host). The
// tangents follow the chain rule. Comparisons and is_finite read the value
// only: every branch, winner and integer decision of the trace is taken by
// value, as jax.vjp takes every jnp.where and argmin of the JAX kernel.
// Where a function has no slope the tangent is what torch's autograd gives
// the plain version: floorf 0, fabsf 0 at 0, sqrtf 0 at 0 (every sqrt of the
// body is guarded there), fminf/fmaxf pass the first operand's on ties.
//
// The operations are hidden friends, found by argument-dependent lookup, so
// an unqualified sqrtf(x) in the body takes the libm function for a float
// and the one here for a Dual. A build with -DRT_COUNT_OPS for the host adds
// the f32 operations each one takes (value and tangents) to
// rt::dual_op_count, for the kernel's roofline bound.
#pragma once

#include <math.h>

#include <type_traits>

#ifdef __CUDACC__
#define RT_DI __host__ __device__ __forceinline__
#else
#define RT_DI inline
#endif

#if defined(RT_COUNT_OPS) && !defined(__CUDA_ARCH__)
namespace rt {
inline thread_local unsigned long long dual_op_count = 0;
}
#define RT_DUAL_COUNT(k) (::rt::dual_op_count += static_cast<unsigned long long>(k))
#else
#define RT_DUAL_COUNT(k) ((void)0)
#endif

namespace rt {

template <int L>
struct Dual;

// A row of the f32 scene table read as Dual<L>: entry c carries tangent
// lane k0 + c (none when that lies outside [0, L)).
template <int L>
struct SeededRow {
  const float* p;
  int k0;
  RT_DI Dual<L> operator[](int c) const { return Dual<L>::seeded(p[c], k0 + c); }
};

template <int L>
struct Dual {
  float v;
  float d[L];

  Dual() = default;
  RT_DI Dual(float x) : v(x) {  // a constant
#pragma unroll
    for (int k = 0; k < L; ++k) d[k] = 0.0f;
  }
  // x with tangent 1 in lane k (no lane when k is outside [0, L))
  static RT_DI Dual seeded(float x, int k) {
    Dual r;
    r.v = x;
#pragma unroll
    for (int j = 0; j < L; ++j) r.d[j] = j == k ? 1.0f : 0.0f;
    return r;
  }
  // the row at p, its entry c seeded in lane k0 + c
  static RT_DI SeededRow<L> row(const float* p, int k0) { return SeededRow<L>{p, k0}; }
  // NaN in the value and every tangent: a pixel whose derivatives are lost
  static RT_DI Dual poison() {
    Dual r;
    r.v = nanf("");
#pragma unroll
    for (int k = 0; k < L; ++k) r.d[k] = r.v;
    return r;
  }

  friend RT_DI Dual stop(const Dual& a) { return Dual(a.v); }
  friend RT_DI float val(const Dual& a) { return a.v; }
  friend RT_DI bool is_finite(const Dual& a) { return ::fabsf(a.v) < INFINITY; }

  friend RT_DI Dual operator-(const Dual& a) {
    Dual r;
    r.v = -a.v;
#pragma unroll
    for (int k = 0; k < L; ++k) r.d[k] = -a.d[k];
    return r;
  }
  friend RT_DI Dual operator+(const Dual& a, const Dual& b) {
    RT_DUAL_COUNT(1 + L);
    Dual r;
    r.v = a.v + b.v;
#pragma unroll
    for (int k = 0; k < L; ++k) r.d[k] = a.d[k] + b.d[k];
    return r;
  }
  friend RT_DI Dual operator+(const Dual& a, float b) {
    RT_DUAL_COUNT(1);
    Dual r = a;
    r.v = a.v + b;
    return r;
  }
  friend RT_DI Dual operator+(float a, const Dual& b) {
    RT_DUAL_COUNT(1);
    Dual r = b;
    r.v = a + b.v;
    return r;
  }
  friend RT_DI Dual operator-(const Dual& a, const Dual& b) {
    RT_DUAL_COUNT(1 + L);
    Dual r;
    r.v = a.v - b.v;
#pragma unroll
    for (int k = 0; k < L; ++k) r.d[k] = a.d[k] - b.d[k];
    return r;
  }
  friend RT_DI Dual operator-(const Dual& a, float b) {
    RT_DUAL_COUNT(1);
    Dual r = a;
    r.v = a.v - b;
    return r;
  }
  friend RT_DI Dual operator-(float a, const Dual& b) {
    RT_DUAL_COUNT(1);
    Dual r = -b;
    r.v = a - b.v;
    return r;
  }
  friend RT_DI Dual operator*(const Dual& a, const Dual& b) {
    RT_DUAL_COUNT(1 + 3 * L);
    Dual r;
    r.v = a.v * b.v;
#pragma unroll
    for (int k = 0; k < L; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
    return r;
  }
  friend RT_DI Dual operator*(const Dual& a, float b) {
    RT_DUAL_COUNT(1 + L);
    Dual r;
    r.v = a.v * b;
#pragma unroll
    for (int k = 0; k < L; ++k) r.d[k] = a.d[k] * b;
    return r;
  }
  friend RT_DI Dual operator*(float a, const Dual& b) {
    RT_DUAL_COUNT(1 + L);
    Dual r;
    r.v = a * b.v;
#pragma unroll
    for (int k = 0; k < L; ++k) r.d[k] = a * b.d[k];
    return r;
  }
  friend RT_DI Dual operator/(const Dual& a, const Dual& b) {
    RT_DUAL_COUNT(1 + 3 * L);
    Dual r;
    r.v = a.v / b.v;
#pragma unroll
    for (int k = 0; k < L; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
    return r;
  }
  friend RT_DI Dual operator/(const Dual& a, float b) {
    RT_DUAL_COUNT(1 + L);
    Dual r;
    r.v = a.v / b;
#pragma unroll
    for (int k = 0; k < L; ++k) r.d[k] = a.d[k] / b;
    return r;
  }
  friend RT_DI Dual operator/(float a, const Dual& b) {
    RT_DUAL_COUNT(2 + 2 * L);
    Dual r;
    r.v = a / b.v;
    const float s = -r.v / b.v;
#pragma unroll
    for (int k = 0; k < L; ++k) r.d[k] = s * b.d[k];
    return r;
  }
  RT_DI Dual& operator+=(const Dual& b) { return *this = *this + b; }

  friend RT_DI bool operator<(const Dual& a, float b) { return a.v < b; }
  friend RT_DI bool operator>(const Dual& a, float b) { return a.v > b; }
  friend RT_DI bool operator>=(const Dual& a, float b) { return a.v >= b; }
  friend RT_DI bool operator==(const Dual& a, float b) { return a.v == b; }
  friend RT_DI bool operator!=(const Dual& a, float b) { return a.v != b; }

  friend RT_DI Dual sqrtf(const Dual& a) {
    RT_DUAL_COUNT(2 + L);
    Dual r;
    r.v = ::sqrtf(a.v);
    const float s = r.v > 0.0f ? 0.5f / r.v : 0.0f;
#pragma unroll
    for (int k = 0; k < L; ++k) r.d[k] = a.d[k] * s;
    return r;
  }
  friend RT_DI Dual fabsf(const Dual& a) {
    Dual r;
    r.v = ::fabsf(a.v);
    const float s = a.v > 0.0f ? 1.0f : (a.v < 0.0f ? -1.0f : 0.0f);
#pragma unroll
    for (int k = 0; k < L; ++k) r.d[k] = a.d[k] * s;
    return r;
  }
  friend RT_DI Dual floorf(const Dual& a) { return Dual(::floorf(a.v)); }
  // fmodf by a constant: slope 1 between its jumps
  friend RT_DI Dual fmodf(const Dual& a, float b) {
    RT_DUAL_COUNT(1);
    Dual r = a;
    r.v = ::fmodf(a.v, b);
    return r;
  }
  friend RT_DI Dual fminf(const Dual& a, const Dual& b) {
    Dual r = a.v <= b.v ? a : b;
    r.v = ::fminf(a.v, b.v);
    return r;
  }
  friend RT_DI Dual fmaxf(const Dual& a, const Dual& b) {
    Dual r = a.v >= b.v ? a : b;
    r.v = ::fmaxf(a.v, b.v);
    return r;
  }
  // a^b for a > 0 (the Phong power ri^pn, both from the tables)
  friend RT_DI Dual powf(const Dual& a, const Dual& b) {
    RT_DUAL_COUNT(5 + 4 * L);
    Dual r;
    r.v = ::powf(a.v, b.v);
    const float da = b.v * ::powf(a.v, b.v - 1.0f);
    const float db = r.v * ::logf(a.v);
#pragma unroll
    for (int k = 0; k < L; ++k) r.d[k] = a.d[k] * da + b.d[k] * db;
    return r;
  }
};

template <class T>
struct is_dual : std::false_type {};
template <int L>
struct is_dual<Dual<L>> : std::true_type {};
template <class T>
constexpr bool is_dual_v = is_dual<T>::value;

// The float side of val: the value itself.
RT_DI float val(float x) { return x; }

}  // namespace rt
