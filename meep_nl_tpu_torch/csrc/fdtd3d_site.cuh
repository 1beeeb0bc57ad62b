// The per-site arithmetic of one 3D Yee step, shared by K1 (fdtd3d.cu),
// K2 (fdtd3d_t2.cu), K3/K4 (resident.cu) and K5 (fused.cu).
//
// The value functions (curl_delta, curl_value, nr_solve_n,
// pade, w_value, ade_value) take values and return values: every rounding
// of the step lives in them, in the plain version's operation order.  Each
// kernel feeds them from where it keeps its operands -- K1 and K2 from
// their shared-memory plane rings, K3/K4 from tiles staged in shared memory
// -- so all the kernels round alike.  The rest: the parameter blocks the
// wrappers build (ops/fdtd3d.py::build_params, which K5's wrapper calls
// too), the W-chain store `w_store` (K1).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXPOL 4
#define NCOMP 3

typedef long long i64;

// One D or B component's curl update.  Field order is mirrored by
// meep_nl_tpu_torch/ops/fdtd3d.py (_CurlP); every member is 8 bytes.
struct CurlP {
  void* f;
  void* fu;
  const void* gp;           // curl partners (null: absent)
  const void* gm;
  const void* kap;          // sigma chain along sig_ax (vectors of length S)
  const void* sig;
  const void* siginv;
  const void* kapu;         // sigma_u chain along sigu_ax
  const void* sigu;
  const void* siginvu;
  const void* alive[3];     // per-axis 0/1 dead-plane vectors (null: all 1)
  i64 ap, am;               // derivative axes of gp / gm
  i64 sig_ax, sig_lo, sig_hi, sig_n;      // -1: no chain; slab extents
  i64 sigu_ax, sigu_lo, sigu_hi, sigu_n;
  i64 slab;                 // 1: chains only on the slabs (plan.slab_opt)
};

struct PolC {
  void* p;                  // null: component not in this polarization
  void* pp;
  const void* sigma;
};

// One E or H component's update from D - P (or B).
struct EhP {
  void* f;
  void* fw;
  const void* d;            // the D/B component
  const void* u;            // chi1inv diagonal (null: identity)
  const void* kapw;
  const void* sigw;
  const void* nreps;        // chi2 Newton-Raphson (null: none)
  const void* nrchi2;
  const void* chi3;         // Kerr Pade (null: none)
  const void* chi2;
  const void* alive[3];
  PolC pol[MAXPOL];
  i64 w_ax, w_lo, w_hi, w_n, w_slab;      // W chain (-1: none)
  i64 dc1, dc2;             // partner indices into eh[] (-1: absent)
  i64 ax_own, ax_1, ax_2;
};

struct Params {
  CurlP curl[NCOMP];
  EhP eh[NCOMP];
  double pg1inv[MAXPOL], pg1[MAXPOL], p2md[MAXPOL], pw2[MAXPOL];
  double csgn;              // +Courant (D) or -Courant (B)
  i64 ncurl, neh, npol;
  i64 S0, S1, S2;
  i64 sgn;                  // +1 E family, -1 H family
  i64 nr_iters;
};

// dfl of step._curl: (+-Courant) * (diff g_plus - diff g_minus); hp / hm:
// the partner exists, dp / dm its difference
template <typename T>
__device__ __forceinline__ T curl_delta(bool hp, T dp, bool hm, T dm,
                                        T csgn) {
  T dfl = T(0);
  if (hp || hm) {
    T tot = hp ? (hm ? dp - dm : dp) : -dm;
    dfl = csgn * tot;
  }
  return dfl;
}

// the PML chains of step._curl_update around dfl, before the mask:
//   dfl -> [sigma chain: f or fu] -> [sigma_u chain: f].
// sig_ax: the sigma chain exists (it then feeds fu); sig_on / sigu_on: the
// site runs that chain (everywhere, or on its slabs with plan.slab_opt);
// kms = kap - sig and kmsu = kapu - sigu, rounded once as the plain
// version's (kap - sig); *fun receives the new fu where sigu_on
template <typename T>
__device__ __forceinline__ T curl_value(T f, T dfl, bool sig_ax, bool sig_on,
                                        T kms, T siginv, bool sigu_on,
                                        T kmsu, T siginvu, T fuo, T* fun) {
  T base = f + dfl;
  if (sig_on) base = (kms * f + dfl) * siginv;
  if (sigu_on) {
    *fun = sig_ax ? (kms * fuo + dfl) * siginv : fuo + dfl;
    base = siginvu * (kmsu * f + *fun - fuo);
  }
  return base;
}

// step._nr_solve: Newton on the zinc-blende chi2 system from the
// first-order perturbative seed, closed-form 3x3 solve, for N sites or
// components side by side (lane m: A_own[m], A_1[m], A_2[m], eps[m],
// chi2[m]; x[m] the solution's own component).  Each lane rounds as the
// plain version does; the lanes only interleave, so that their dependent
// chains overlap.
template <typename T, int N>
__device__ __forceinline__ void nr_solve_n(const T* A_own, const T* A_1,
                                           const T* A_2, const T* eps,
                                           const T* chi2, i64 iters, T* x) {
  T y[N], z[N], aa[N];
#pragma unroll
  for (int m = 0; m < N; ++m) {
    T ueff = T(1) / (eps[m] == T(0) ? T(1) : eps[m]);
    T sx = A_own[m] * ueff, sy = A_1[m] * ueff, sz = A_2[m] * ueff;
    T cu = chi2[m] * ueff;
    x[m] = sx - cu * sy * sz;
    y[m] = sy - cu * sx * sz;
    z[m] = sz - cu * sx * sy;
    aa[m] = eps[m] * eps[m];
  }
  for (i64 it = 0; it < iters; ++it) {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const T e = eps[m], c2 = chi2[m];
      T F1 = A_own[m] - (e * x[m] + c2 * y[m] * z[m]);
      T F2 = A_1[m] - (e * y[m] + c2 * x[m] * z[m]);
      T F3 = A_2[m] - (e * z[m] + c2 * x[m] * y[m]);
      T a = e, b = c2 * z[m], c = c2 * y[m], d = c2 * x[m];
      T b2 = b * b, cc = c * c, d2 = d * d;
      T det = a * (aa[m] - b2 - cc - d2) + T(2) * (b * c * d);
      if (fabs(det) < T(1e-30)) det = T(1e-30);
      T rdet = T(1) / det;
      T i00 = aa[m] - d2;
      T i01 = c * d - b * a;
      T i02 = b * d - c * a;
      T i11 = aa[m] - cc;
      T i12 = c * b - a * d;
      T i22 = aa[m] - b2;
      T dx = (i00 * F1 + i01 * F2 + i02 * F3) * rdet;
      T dy = (i01 * F1 + i11 * F2 + i12 * F3) * rdet;
      T dz = (i02 * F1 + i12 * F2 + i22 * F3) * rdet;
      x[m] = x[m] + dx;
      y[m] = y[m] + dy;
      z[m] = z[m] + dz;
    }
  }
}

// the same for one site and component; returns x (own)
template <typename T>
__device__ T nr_solve(T A_own, T A_1, T A_2, T eps, T chi2, i64 iters) {
  T x[1];
  nr_solve_n<T, 1>(&A_own, &A_1, &A_2, &eps, &chi2, iters, x);
  return x[0];
}

// one partner's term of the chi3 Pade's D^2 (step._eh_update): Dsqr +
// (sum4 / 4)^2, written as the plain version rounds it
template <typename T>
__device__ __forceinline__ T dsqr_add(T Dsqr, T g) {
  return Dsqr + T(0.0625) * (g * g);
}

// lin times the Kerr/chi2 Pade factor of step._nonlinear_u; gs = D - P,
// us = chi1inv (1 without u).  chi2 = chi3 = 0 gives the factor 1 exactly.
template <typename T>
__device__ __forceinline__ T pade(T lin, T gs, T Dsqr, T chi2, T chi3, T us) {
  T c2 = gs * chi2 * (us * us);
  T c3 = Dsqr * chi3 * (us * us * us);
  return lin * ((T(1) + c2 + T(2) * c3) / (T(1) + T(2) * c2 + T(3) * c3));
}

// what the W chain and the mask of one E (or H) component read at a site:
// kp = kapw + sigw, km = kapw - sigw, each rounded once as the plain
// version's
template <typename T>
struct WIn {
  T f, fw, kp, km, mask;
  bool on;                  // the site runs the chain (else E = lin)
};

// the W chain and the mask: the new E/H from lin (the new f_w is lin where
// w.on)
template <typename T>
__device__ __forceinline__ T w_value(T lin, const WIn<T>& w) {
  T fnew = lin;
  if (w.on) fnew = w.f + w.kp * lin - w.km * w.fw;
  return fnew * w.mask;
}

// the W chain, the mask, the stores into device memory at flat index n;
// returns the new E/H
template <typename T>
__device__ __forceinline__ T w_store(const EhP& e, i64 n, T lin,
                                     const WIn<T>& w) {
  T fnew = w_value<T>(lin, w);
  if (w.on) ((T*)e.fw)[n] = lin;
  ((T*)e.f)[n] = fnew;
  return fnew;
}

// whether an E-family parameter block needs the NL = true functions
inline bool has_nl(const Params& P) {
  for (int q = 0; q < P.neh; ++q)
    if (P.eh[q].chi3 || P.eh[q].nrchi2) return true;
  return false;
}

// the Lorentz/Drude ADE of polarization p (step._pol_update_lorentzian):
// the new P from the drive field W, sigma, the current P and the previous;
// sigma = 0 leaves a drive of zero
template <typename T>
__device__ __forceinline__ T ade_value(T pg1inv, T p2md, T pg1, T pw2, T W,
                                       T sigma, T pcur, T pprev) {
  T drive = sigma * W;
  return pg1inv * (pcur * p2md - pg1 * pprev + pw2 * drive);
}

template <typename T>
__device__ __forceinline__ T ade_value(const Params& P, int p, T W, T sigma,
                                       T pcur, T pprev) {
  return ade_value<T>(T(P.pg1inv[p]), T(P.p2md[p]), T(P.pg1[p]),
                      T(P.pw2[p]), W, sigma, pcur, pprev);
}

// one current source entry into D/B: f -= current * dt (step._apply_sources)
template <typename T>
__device__ __forceinline__ T source_amp(const T* are, const T* aim, i64 t,
                                        T wre, T wim, T dt) {
  return (wre * are[t] - wim * aim[t]) * dt;
}
