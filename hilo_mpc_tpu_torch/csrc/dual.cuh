// Forward-mode dual numbers for the model code that ops/codegen_cuda.py
// emits: Dual<T, D> carries a value and its derivative along D directions.
// One pass of the emitted integrator step over duals seeded with the unit
// vectors of (x, u) gives the next state F and its Jacobian [A | B]; that is
// the counterpart of dyn_lin_lane (hilo_mpc_tpu/ops/pallas_ip.py:266-271),
// which takes the same derivatives with jax.linearize inside the TPU kernel.
//
// Every function of the equation DSL's table (utils/parsing.py:_MATH_ENV) has
// a scalar overload for float and double (m_exp, m_log, ...) and a dual
// overload with its derivative rule. At non-smooth points the rules follow
// PyTorch's gradients, so the Jacobians agree with torch.func on the plain
// model functions:
//   abs      derivative sign(v): 0 at v = 0
//   sign     derivative 0 everywhere (also at 0)
//   floor    derivative 0;  ceil: derivative 0
//   fmin     a < b: da;  a > b: db;  a == b: (da + db) / 2   (torch.minimum)
//   fmax     a > b: da;  a < b: db;  a == b: (da + db) / 2   (torch.maximum)
//   sqrt     0.5 / sqrt(v): +inf at v = 0
//   pow      a^c (c constant): c a^(c-1) da; a^b (b dual) adds a^b log(a) db,
//            taken as 0 where a == 0 and b >= 0 (torch.pow)
// fmin and fmax propagate NaN as torch.minimum and torch.maximum do.
//
// Duals nest: Dual<Dual<T, D>, D> seeded with the unit vectors at both levels
// carries the value, the gradient and the Hessian of a scalar function, the
// counterpart of JAX's jvp of grad (forward over forward), and Dual<Dual<T,
// 1>, D> one Hessian column per pass (csrc/traced.cuh). Every rule is written
// in terms of T's own operations, so it holds at every level; the mixed
// operations take the plain scalar (scalar_t<T>: float or double) on the
// other side, and branches compare plain values (plain()). At a kink the
// nested rules follow PyTorch's double backward (the derivative of a masked
// rule is masked too).
//
// Everything is __host__ __device__: the same header compiles with nvcc for
// the card and with the host C++ compiler for the CPU tests.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define HM_HD __host__ __device__ __forceinline__
#else
#define HM_HD inline
#endif

namespace hm {

// ---- scalar functions, float and double -----------------------------------
#define HM_UNARY(name, ff, fd)                                 \
  HM_HD float name(float v) { return ff(v); }                  \
  HM_HD double name(double v) { return fd(v); }
HM_UNARY(m_exp, expf, exp)
HM_UNARY(m_log, logf, log)
HM_UNARY(m_log10, log10f, log10)
HM_UNARY(m_sqrt, sqrtf, sqrt)
HM_UNARY(m_sin, sinf, sin)
HM_UNARY(m_cos, cosf, cos)
HM_UNARY(m_tan, tanf, tan)
HM_UNARY(m_asin, asinf, asin)
HM_UNARY(m_acos, acosf, acos)
HM_UNARY(m_atan, atanf, atan)
HM_UNARY(m_sinh, sinhf, sinh)
HM_UNARY(m_cosh, coshf, cosh)
HM_UNARY(m_tanh, tanhf, tanh)
HM_UNARY(m_asinh, asinhf, asinh)
HM_UNARY(m_acosh, acoshf, acosh)
HM_UNARY(m_atanh, atanhf, atanh)
HM_UNARY(m_abs, fabsf, fabs)
HM_UNARY(m_floor, floorf, floor)
HM_UNARY(m_ceil, ceilf, ceil)
HM_UNARY(m_erf, erff, erf)
#undef HM_UNARY

#define HM_SCALAR(T, pw, at2)                                            \
  HM_HD T m_sign(T v) { return v != v ? v : T((v > T(0)) - (v < T(0))); } \
  HM_HD T m_atan2(T a, T b) { return at2(a, b); }                        \
  HM_HD T m_pow(T a, T b) { return pw(a, b); }                           \
  HM_HD T m_fmin(T a, T b) { return (a < b || a != a) ? a : b; }         \
  HM_HD T m_fmax(T a, T b) { return (a > b || a != a) ? a : b; }
HM_SCALAR(float, powf, atan2f)
HM_SCALAR(double, pow, atan2)
#undef HM_SCALAR
template <typename T> HM_HD T m_inf() { return T(INFINITY); }
// a * a, as torch.pow computes a ** 2
template <typename S> HM_HD S m_sq(const S& a) { return a * a; }

// ---- dual numbers ----------------------------------------------------------
template <typename T, int D>
struct Dual {
  T v;
  T d[D];
  HM_HD Dual() {}
  // a constant: the value x (a plain scalar, or a T), no derivative
  template <typename U>
  HM_HD explicit Dual(const U& x) : v(x) {
#pragma unroll
    for (int i = 0; i < D; ++i) d[i] = T(0);
  }
};

// the plain scalar type under (nested) duals: float or double
template <typename T> struct ScalarOf { using type = T; };
template <typename T, int D> struct ScalarOf<Dual<T, D>> {
  using type = typename ScalarOf<T>::type;
};
template <typename T> using scalar_t = typename ScalarOf<T>::type;

// the plain value of a scalar or a (nested) dual
HM_HD float plain(float v) { return v; }
HM_HD double plain(double v) { return v; }
template <typename T, int D> HM_HD scalar_t<T> plain(const Dual<T, D>& a) {
  return plain(a.v);
}

// f(a) with f(a.v) = val and f'(a.v) = der
template <typename T, int D>
HM_HD Dual<T, D> chain(const Dual<T, D>& a, T val, T der) {
  Dual<T, D> r;
  r.v = val;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = der * a.d[i];
  return r;
}

template <typename T, int D>
HM_HD Dual<T, D> operator-(const Dual<T, D>& a) {
  Dual<T, D> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = -a.d[i];
  return r;
}

template <typename T, int D>
HM_HD Dual<T, D> operator+(const Dual<T, D>& a, const Dual<T, D>& b) {
  Dual<T, D> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <typename T, int D>
HM_HD Dual<T, D> operator+(const Dual<T, D>& a, scalar_t<T> b) {
  Dual<T, D> r = a;
  r.v = a.v + b;
  return r;
}
template <typename T, int D>
HM_HD Dual<T, D> operator+(scalar_t<T> a, const Dual<T, D>& b) {
  Dual<T, D> r = b;
  r.v = a + b.v;
  return r;
}

template <typename T, int D>
HM_HD Dual<T, D> operator-(const Dual<T, D>& a, const Dual<T, D>& b) {
  Dual<T, D> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <typename T, int D>
HM_HD Dual<T, D> operator-(const Dual<T, D>& a, scalar_t<T> b) {
  Dual<T, D> r = a;
  r.v = a.v - b;
  return r;
}
template <typename T, int D>
HM_HD Dual<T, D> operator-(scalar_t<T> a, const Dual<T, D>& b) {
  Dual<T, D> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = -b.d[i];
  return r;
}

template <typename T, int D>
HM_HD Dual<T, D> operator*(const Dual<T, D>& a, const Dual<T, D>& b) {
  Dual<T, D> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <typename T, int D>
HM_HD Dual<T, D> operator*(const Dual<T, D>& a, scalar_t<T> b) {
  Dual<T, D> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <typename T, int D>
HM_HD Dual<T, D> operator*(scalar_t<T> a, const Dual<T, D>& b) {
  Dual<T, D> r;
  r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a * b.d[i];
  return r;
}

template <typename T, int D>
HM_HD Dual<T, D> operator/(const Dual<T, D>& a, const Dual<T, D>& b) {
  Dual<T, D> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  return r;
}
template <typename T, int D>
HM_HD Dual<T, D> operator/(const Dual<T, D>& a, scalar_t<T> b) {
  Dual<T, D> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] / b;
  return r;
}
template <typename T, int D>
HM_HD Dual<T, D> operator/(scalar_t<T> a, const Dual<T, D>& b) {
  Dual<T, D> r;
  r.v = a / b.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = -r.v * b.d[i] / b.v;
  return r;
}

// ---- the DSL's functions on duals ------------------------------------------
template <typename T, int D> HM_HD Dual<T, D> m_exp(const Dual<T, D>& a) {
  const T e = m_exp(a.v);
  return chain(a, e, e);
}
template <typename T, int D> HM_HD Dual<T, D> m_log(const Dual<T, D>& a) {
  return chain(a, m_log(a.v), T(1) / a.v);
}
template <typename T, int D> HM_HD Dual<T, D> m_log10(const Dual<T, D>& a) {
  return chain(a, m_log10(a.v), T(1) / (a.v * T(2.302585092994046)));
}
template <typename T, int D> HM_HD Dual<T, D> m_sqrt(const Dual<T, D>& a) {
  const T s = m_sqrt(a.v);
  return chain(a, s, T(0.5) / s);
}
template <typename T, int D> HM_HD Dual<T, D> m_sin(const Dual<T, D>& a) {
  return chain(a, m_sin(a.v), m_cos(a.v));
}
template <typename T, int D> HM_HD Dual<T, D> m_cos(const Dual<T, D>& a) {
  return chain(a, m_cos(a.v), -m_sin(a.v));
}
template <typename T, int D> HM_HD Dual<T, D> m_tan(const Dual<T, D>& a) {
  const T t = m_tan(a.v);
  return chain(a, t, T(1) + t * t);
}
template <typename T, int D> HM_HD Dual<T, D> m_asin(const Dual<T, D>& a) {
  return chain(a, m_asin(a.v), T(1) / m_sqrt(T(1) - a.v * a.v));
}
template <typename T, int D> HM_HD Dual<T, D> m_acos(const Dual<T, D>& a) {
  return chain(a, m_acos(a.v), -T(1) / m_sqrt(T(1) - a.v * a.v));
}
template <typename T, int D> HM_HD Dual<T, D> m_atan(const Dual<T, D>& a) {
  return chain(a, m_atan(a.v), T(1) / (T(1) + a.v * a.v));
}
template <typename T, int D> HM_HD Dual<T, D> m_sinh(const Dual<T, D>& a) {
  return chain(a, m_sinh(a.v), m_cosh(a.v));
}
template <typename T, int D> HM_HD Dual<T, D> m_cosh(const Dual<T, D>& a) {
  return chain(a, m_cosh(a.v), m_sinh(a.v));
}
template <typename T, int D> HM_HD Dual<T, D> m_tanh(const Dual<T, D>& a) {
  const T t = m_tanh(a.v);
  return chain(a, t, T(1) - t * t);
}
template <typename T, int D> HM_HD Dual<T, D> m_asinh(const Dual<T, D>& a) {
  return chain(a, m_asinh(a.v), T(1) / m_sqrt(a.v * a.v + T(1)));
}
template <typename T, int D> HM_HD Dual<T, D> m_acosh(const Dual<T, D>& a) {
  return chain(a, m_acosh(a.v), T(1) / m_sqrt(a.v * a.v - T(1)));
}
template <typename T, int D> HM_HD Dual<T, D> m_atanh(const Dual<T, D>& a) {
  return chain(a, m_atanh(a.v), T(1) / (T(1) - a.v * a.v));
}
template <typename T, int D> HM_HD Dual<T, D> m_abs(const Dual<T, D>& a) {
  return chain(a, m_abs(a.v), m_sign(a.v));
}
template <typename T, int D> HM_HD Dual<T, D> m_sign(const Dual<T, D>& a) {
  return chain(a, m_sign(a.v), T(0));
}
template <typename T, int D> HM_HD Dual<T, D> m_floor(const Dual<T, D>& a) {
  return chain(a, m_floor(a.v), T(0));
}
template <typename T, int D> HM_HD Dual<T, D> m_ceil(const Dual<T, D>& a) {
  return chain(a, m_ceil(a.v), T(0));
}
template <typename T, int D> HM_HD Dual<T, D> m_erf(const Dual<T, D>& a) {
  // 2 / sqrt(pi) exp(-v^2)
  return chain(a, m_erf(a.v), T(1.1283791670955126) * m_exp(-a.v * a.v));
}

template <typename T, int D>
HM_HD Dual<T, D> m_atan2(const Dual<T, D>& a, const Dual<T, D>& b) {
  Dual<T, D> r;
  r.v = m_atan2(a.v, b.v);
  const T den = a.v * a.v + b.v * b.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = (b.v * a.d[i] - a.v * b.d[i]) / den;
  return r;
}

// torch.minimum / torch.maximum: the tie splits the derivative in halves
template <typename T, int D>
HM_HD Dual<T, D> m_fmin(const Dual<T, D>& a, const Dual<T, D>& b) {
  if (plain(a) != plain(a)) return a;
  if (plain(b) != plain(b)) return b;
  if (plain(a) < plain(b)) return a;
  if (plain(b) < plain(a)) return b;
  Dual<T, D> r;
  r.v = a.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = T(0.5) * (a.d[i] + b.d[i]);
  return r;
}
template <typename T, int D>
HM_HD Dual<T, D> m_fmax(const Dual<T, D>& a, const Dual<T, D>& b) {
  if (plain(a) != plain(a)) return a;
  if (plain(b) != plain(b)) return b;
  if (plain(a) > plain(b)) return a;
  if (plain(b) > plain(a)) return b;
  Dual<T, D> r;
  r.v = a.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = T(0.5) * (a.d[i] + b.d[i]);
  return r;
}

template <typename T, int D>
HM_HD Dual<T, D> m_pow(const Dual<T, D>& a, scalar_t<T> c) {
  using C = scalar_t<T>;
  return chain(a, m_pow(a.v, c),
               c == C(0) ? T(0) : c * m_pow(a.v, c - C(1)));
}
template <typename T, int D>
HM_HD Dual<T, D> m_pow(const Dual<T, D>& a, const Dual<T, D>& b) {
  using C = scalar_t<T>;
  Dual<T, D> r;
  r.v = m_pow(a.v, b.v);
  const T da = plain(b) == C(0) ? T(0) : b.v * m_pow(a.v, b.v - C(1));
  const T db = (plain(a) == C(0) && plain(b) >= C(0)) ? T(0) : r.v * m_log(a.v);
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = da * a.d[i] + db * b.d[i];
  return r;
}
template <typename T, int D>
HM_HD Dual<T, D> m_pow(scalar_t<T> a, const Dual<T, D>& b) {
  using C = scalar_t<T>;
  const T v = m_pow(a, b.v);
  return chain(b, v, (a == C(0) && plain(b) >= C(0)) ? T(0) : v * m_log(a));
}

// the two-argument functions with one plain argument
#define HM_MIXED(name)                                                   \
  template <typename T, int D>                                           \
  HM_HD Dual<T, D> name(const Dual<T, D>& a, scalar_t<T> b) {            \
    return name(a, Dual<T, D>(b));                                       \
  }                                                                      \
  template <typename T, int D>                                           \
  HM_HD Dual<T, D> name(scalar_t<T> a, const Dual<T, D>& b) {            \
    return name(Dual<T, D>(a), b);                                       \
  }
HM_MIXED(m_atan2)
HM_MIXED(m_fmin)
HM_MIXED(m_fmax)
#undef HM_MIXED

}  // namespace hm
