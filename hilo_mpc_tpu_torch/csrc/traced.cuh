// The cost derivatives of a traced problem (ops/codegen_fx.py), by dual
// numbers through the emitted functions. Counterpart of cost_gh_lane and
// term_gh_lane (hilo_mpc_tpu/ops/pallas_ip.py:273-292), which take the
// gradient with jax.grad and the Hessian with the jvp of that gradient,
// column by column, inside the TPU kernel.
//
// The problem struct P emits its traced functions as templates over the
// plain type T and the active scalar type S:
//   P::fx_stage<T, S>(xs, us, th, prm) -> S    the stage cost l
//   P::fx_term<T, S>(xs, th, prm) -> S         the terminal cost lN
// of the solver-scaled (xs, us), the scaling, the h/dt factor and the theta
// unpack traced in. Here:
//   - the gradient is one pass over Dual<T, D> (D = NX + NU, or NX at the
//     terminal stage) seeded with the unit vectors;
//   - the Hessian is forward over forward: one pass over
//     Dual<Dual<T, D>, D> (the value, gradient and Hessian at once,
//     (D + 1)² numbers per scalar). It took fewer registers on an H100 than
//     D passes of one column each over Dual<Dual<T, 1>, D> (PERF.md §6).
// stage_hess writes Hxx (NX x NX), Huu (NU x NU) and, where P::CROSS, the
// cross block Hux = d²l/du dx (NU x NX), row-major, as csrc/whole_ip.cuh
// takes them.
#pragma once

#include <type_traits>

#include "dual.cuh"

namespace hm {

// z[i] = the i-th input as a dual seeded with the unit vector e_i
template <typename T, int D>
HM_HD void seed(const T* a, int n, int off, Dual<T, D>* z) {
  for (int i = 0; i < n; ++i) {
    z[i] = Dual<T, D>(a[i]);
    z[i].d[off + i] = T(1);
  }
}

// the gradient of l at (xs, us)
template <typename T, typename P>
HM_HD void traced_stage_grad(const T* xs, const T* us, const T* th, const T* prm,
                             T* gx, T* gu) {
  constexpr int NX = P::NX, NU = P::NU, D = NX + NU;
  Dual<T, D> x[NX], u[NU];
  seed<T, D>(xs, NX, 0, x);
  seed<T, D>(us, NU, NX, u);
  const Dual<T, D> c = P::template fx_stage<T, Dual<T, D>>(x, u, th, prm);
#pragma unroll
  for (int i = 0; i < NX; ++i) gx[i] = c.d[i];
#pragma unroll
  for (int j = 0; j < NU; ++j) gu[j] = c.d[NX + j];
}

template <typename T, typename P>
HM_HD void traced_term_grad(const T* xs, const T* th, const T* prm, T* gx) {
  constexpr int NX = P::NX;
  Dual<T, NX> x[NX];
  seed<T, NX>(xs, NX, 0, x);
  const Dual<T, NX> c = P::template fx_term<T, Dual<T, NX>>(x, th, prm);
#pragma unroll
  for (int i = 0; i < NX; ++i) gx[i] = c.d[i];
}

// z[i] for the Hessian: the value a[i] seeded with e_(off+i) in both the
// outer and the inner lanes
template <typename T, int D>
HM_HD void seed2(const T* a, int n, int off, Dual<Dual<T, D>, D>* z) {
  for (int i = 0; i < n; ++i) {
    z[i] = Dual<Dual<T, D>, D>(a[i]);
    z[i].d[off + i] = Dual<T, D>(T(1));
    z[i].v.d[off + i] = T(1);
  }
}

// H(a, b) = d²/dz_a dz_b of one of P's costs through `f`, z = (xs, us)
// (nu = 0 at the terminal stage), into put(a, b, value) for every pair
template <typename T, int D, typename F, typename Put>
HM_HD void traced_hessian(const T* xs, const T* us, int nx, const F& f,
                          const Put& put) {
  using Z = Dual<Dual<T, D>, D>;
  Z z[D];
  seed2<T, D>(xs, nx, 0, z);
  seed2<T, D>(us, D - nx, nx, z + nx);
  const Z c = f(z);
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) put(a, b, c.d[a].d[b]);
}

template <typename T, typename P>
HM_HD void traced_stage_hess(const T* xs, const T* us, const T* th, const T* prm,
                             T* Hxx, T* Huu, T* Hux) {
  constexpr int NX = P::NX, NU = P::NU, D = NX + NU;
  auto f = [&](const auto* z) {
    using Z = std::remove_const_t<std::remove_pointer_t<decltype(z)>>;
    return P::template fx_stage<T, Z>(z, z + NX, th, prm);
  };
  auto put = [&](int a, int b, T v) {
    if (a < NX && b < NX)
      Hxx[a * NX + b] = v;
    else if (a >= NX && b >= NX)
      Huu[(a - NX) * NU + (b - NX)] = v;
    else if (P::CROSS && a >= NX)
      Hux[(a - NX) * NX + b] = v;
  };
  traced_hessian<T, D>(xs, us, NX, f, put);
}

template <typename T, typename P>
HM_HD void traced_term_hess(const T* xs, const T* th, const T* prm, T* Hxx) {
  constexpr int NX = P::NX;
  auto f = [&](const auto* z) {
    using Z = std::remove_const_t<std::remove_pointer_t<decltype(z)>>;
    return P::template fx_term<T, Z>(z, th, prm);
  };
  auto put = [&](int a, int b, T v) { Hxx[a * NX + b] = v; };
  traced_hessian<T, NX>(xs, xs, NX, f, put);
}

}  // namespace hm
