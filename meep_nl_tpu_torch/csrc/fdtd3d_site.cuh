// The per-site arithmetic of one 3D Yee step, shared by K1 (fdtd3d.cu, one
// launch per half step over the full-grid state) and K2 (fdtd3d_t2.cu,
// `depth` steps in one launch over a ring of x-planes): both kernels run
// these functions, so their stages round alike.
//
// Every function takes two flat indices of its site (i, j, k):
//   n   into the full-grid coefficient arrays, (i*S1 + j)*S2 + k;
//   fn  into the field arrays, (slot(i)*S1 + j)*S2 + k, where plane i of a
//       field array lives in slot i % R.  K1's field arrays are the full
//       grid (R = S0, RING = false, fn == n); K2's are rings of R planes
//       (RING = true), and only the x-neighbour reads need the slot rule.
// The per-axis coefficient vectors and the 0/1 alive vectors are indexed by
// the true coordinates.

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
  i64 R;                    // x-planes the field arrays hold (S0: full grid)
};

__device__ __forceinline__ i64 coord(i64 ax, i64 i, i64 j, i64 k) {
  return ax == 0 ? i : (ax == 1 ? j : k);
}

__device__ __forceinline__ i64 extent(const Params& P, i64 ax) {
  return ax == 0 ? P.S0 : (ax == 1 ? P.S1 : P.S2);
}

__device__ __forceinline__ i64 stride(const Params& P, i64 ax) {
  return ax == 0 ? P.S1 * P.S2 : (ax == 1 ? P.S2 : 1);
}

__device__ __forceinline__ bool in_slab(i64 c, i64 lo, i64 hi, i64 n) {
  return c < lo || (c >= n - hi && c < n);
}

// the slot of x-plane i in a field array of R planes
template <bool RING>
__device__ __forceinline__ i64 slot(i64 R, i64 i) {
  return RING ? (i64)((int)i % (int)R) : i;
}

// the product of the per-axis 0/1 vectors step.alive_vectors builds
template <typename T>
__device__ __forceinline__ T mask_of(const void* const alive[3], i64 i,
                                     i64 j, i64 k) {
  T m = T(1);
  if (alive[0]) m = m * ((const T*)alive[0])[i];
  if (alive[1]) m = m * ((const T*)alive[1])[j];
  if (alive[2]) m = m * ((const T*)alive[2])[k];
  return m;
}

// D: backward difference g - g[-1]; B: forward difference g[+1] - g;
// zero outside the storage (the PEC / not-owned convention of step._sh)
template <typename T, bool IS_D, bool RING>
__device__ __forceinline__ T diff(const T* g, const Params& P, i64 a,
                                  i64 fn, i64 i, i64 j, i64 k) {
  i64 c = coord(a, i, j, k);
  i64 st = stride(P, a);
  i64 up = fn + st, dn = fn - st;
  if (RING && a == 0) {
    i64 here = slot<RING>(P.R, i);
    up = fn + (slot<RING>(P.R, i + 1) - here) * st;
    dn = fn + (slot<RING>(P.R, i + P.R - 1) - here) * st;
  }
  if (IS_D) return g[fn] - (c > 0 ? g[dn] : T(0));
  return (c < extent(P, a) - 1 ? g[up] : T(0)) - g[fn];
}

template <typename T, bool IS_D, bool RING>
__device__ void curl_site(const CurlP& c, const Params& P, i64 fn, i64 i,
                          i64 j, i64 k) {
  T* F = (T*)c.f;
  T dfl = T(0);
  if (c.gp || c.gm) {
    T tot;
    if (c.gp)
      tot = diff<T, IS_D, RING>((const T*)c.gp, P, c.ap, fn, i, j, k);
    if (c.gm) {
      T t2 = diff<T, IS_D, RING>((const T*)c.gm, P, c.am, fn, i, j, k);
      tot = c.gp ? tot - t2 : -t2;
    }
    dfl = T(P.csgn) * tot;
  }
  T f = F[fn];
  T base = f + dfl;
  i64 cs = 0;
  const T* kap = (const T*)c.kap;
  const T* sig = (const T*)c.sig;
  const T* siginv = (const T*)c.siginv;
  if (c.sig_ax >= 0) {
    cs = coord(c.sig_ax, i, j, k);
    if (!c.slab || in_slab(cs, c.sig_lo, c.sig_hi, c.sig_n))
      base = ((kap[cs] - sig[cs]) * f + dfl) * siginv[cs];
  }
  if (c.sigu_ax >= 0) {
    i64 cu = coord(c.sigu_ax, i, j, k);
    if (!c.slab || in_slab(cu, c.sigu_lo, c.sigu_hi, c.sigu_n)) {
      T* FU = (T*)c.fu;
      const T* kapu = (const T*)c.kapu;
      const T* sigu = (const T*)c.sigu;
      const T* siginvu = (const T*)c.siginvu;
      T fuo = FU[fn];
      T fun = c.sig_ax >= 0 ? ((kap[cs] - sig[cs]) * fuo + dfl) * siginv[cs]
                            : fuo + dfl;
      base = siginvu[cu] * ((kapu[cu] - sigu[cu]) * f + fun - fuo);
      FU[fn] = fun;
    }
  }
  F[fn] = base * mask_of<T>(c.alive, i, j, k);
}

template <typename T>
__device__ __forceinline__ T dmp_at(const EhP& e, i64 npol, i64 fn) {
  T v = ((const T*)e.d)[fn];
  for (int p = 0; p < npol; ++p)
    if (e.pol[p].p) v = v - ((const T*)e.pol[p].p)[fn];
  return v;
}

// D - P of component e at (i,j,k) + da along axis a + db along axis b;
// zero where any shifted coordinate leaves the storage
template <typename T, bool RING>
__device__ T dmp_nb(const EhP& e, const Params& P, i64 i, i64 j, i64 k,
                    i64 a, i64 da, i64 b, i64 db) {
  i64 ci = i + (a == 0 ? da : 0) + (b == 0 ? db : 0);
  i64 cj = j + (a == 1 ? da : 0) + (b == 1 ? db : 0);
  i64 ck = k + (a == 2 ? da : 0) + (b == 2 ? db : 0);
  if (ci < 0 || ci >= P.S0 || cj < 0 || cj >= P.S1 || ck < 0 || ck >= P.S2)
    return T(0);
  return dmp_at<T>(e, P.npol,
                   (slot<RING>(P.R, ci) * P.S1 + cj) * P.S2 + ck);
}

// g + g_s + g_x + g_sx of step._sum4 / _avg4: g_s one site along the own
// axis (sign sgn), g_x one site back along the partner's axis
template <typename T, bool RING>
__device__ T sum4(const EhP& e, const Params& P, i64 i, i64 j, i64 k,
                  i64 own, i64 off) {
  i64 s = P.sgn;
  T g = dmp_nb<T, RING>(e, P, i, j, k, -1, 0, -1, 0);
  T gs = dmp_nb<T, RING>(e, P, i, j, k, own, s, -1, 0);
  T gx = dmp_nb<T, RING>(e, P, i, j, k, off, -s, -1, 0);
  T gsx = dmp_nb<T, RING>(e, P, i, j, k, own, s, off, -s);
  return g + gs + gx + gsx;
}

// step._nr_solve: Newton on the zinc-blende chi2 system from the
// first-order perturbative seed, closed-form 3x3 solve; returns x (own)
template <typename T>
__device__ T nr_solve(T A_own, T A_1, T A_2, T eps, T chi2, i64 iters) {
  T ueff = T(1) / (eps == T(0) ? T(1) : eps);
  T sx = A_own * ueff, sy = A_1 * ueff, sz = A_2 * ueff;
  T cu = chi2 * ueff;
  T x = sx - cu * sy * sz;
  T y = sy - cu * sx * sz;
  T z = sz - cu * sx * sy;
  T aa = eps * eps;
  for (i64 it = 0; it < iters; ++it) {
    T F1 = A_own - (eps * x + chi2 * y * z);
    T F2 = A_1 - (eps * y + chi2 * x * z);
    T F3 = A_2 - (eps * z + chi2 * x * y);
    T a = eps, b = chi2 * z, c = chi2 * y, d = chi2 * x;
    T b2 = b * b, c2 = c * c, d2 = d * d;
    T det = a * (aa - b2 - c2 - d2) + T(2) * (b * c * d);
    if (fabs(det) < T(1e-30)) det = T(1e-30);
    T rdet = T(1) / det;
    T i00 = aa - d2;
    T i01 = c * d - b * a;
    T i02 = b * d - c * a;
    T i11 = aa - c2;
    T i12 = c * b - a * d;
    T i22 = aa - b2;
    T dx = (i00 * F1 + i01 * F2 + i02 * F3) * rdet;
    T dy = (i01 * F1 + i11 * F2 + i12 * F3) * rdet;
    T dz = (i02 * F1 + i12 * F2 + i22 * F3) * rdet;
    x = x + dx;
    y = y + dy;
    z = z + dz;
  }
  return x;
}

// step._eh_update at one site, in three stages so that every load of the
// site's (up to three) components is issued before the first store: the
// field arrays are untyped pointers that may alias for all the compiler
// knows, so a store between two components' loads would serialise their
// trips to memory.  No component reads what another writes in this update
// (E/H and W are read and written at the own site only; the neighbour reads
// of the NR solve and the chi3 sum are of D - P), so the order is free and
// each value's arithmetic is that of step._eh_update.

// stage 1: lin, the W-chain input -- chi1inv (D - P) with the chi3 Pade
// factor and the chi2 Newton-Raphson solve; loads only.  NL = false compiles
// the chi3 and chi2-NR branches out, for plans (and for the H family) that
// have neither: their presence alone costs the kernel registers, and with
// them the occupancy of every site.
template <typename T, bool RING, bool NL>
__device__ T eh_lin(const Params& P, int q, i64 n, i64 fn, i64 i, i64 j,
                    i64 k) {
  const EhP& e = P.eh[q];
  T gs = dmp_at<T>(e, P.npol, fn);
  T us = e.u ? ((const T*)e.u)[n] : T(1);
  T lin = e.u ? gs * us : gs;
  if (NL && e.chi3) {
    T Dsqr = gs * gs;
    if (e.dc1 >= 0) {
      T g = sum4<T, RING>(P.eh[e.dc1], P, i, j, k, e.ax_own, e.ax_1);
      Dsqr = Dsqr + T(0.0625) * (g * g);
    }
    if (e.dc2 >= 0) {
      T g = sum4<T, RING>(P.eh[e.dc2], P, i, j, k, e.ax_own, e.ax_2);
      Dsqr = Dsqr + T(0.0625) * (g * g);
    }
    T c2 = gs * ((const T*)e.chi2)[n] * (us * us);
    T c3 = Dsqr * ((const T*)e.chi3)[n] * (us * us * us);
    lin = lin * ((T(1) + c2 + T(2) * c3) / (T(1) + T(2) * c2 + T(3) * c3));
  }
  if (NL && e.nrchi2) {
    T chi2 = ((const T*)e.nrchi2)[n];
    if (chi2 != T(0)) {
      T g1 = e.dc1 >= 0 ? T(0.25) * sum4<T, RING>(P.eh[e.dc1], P, i, j, k,
                                                  e.ax_own, e.ax_1)
                        : T(0);
      T g2 = e.dc2 >= 0 ? T(0.25) * sum4<T, RING>(P.eh[e.dc2], P, i, j, k,
                                                  e.ax_own, e.ax_2)
                        : T(0);
      lin = nr_solve<T>(gs, g1, g2, ((const T*)e.nreps)[n], chi2,
                        P.nr_iters);
    }
  }
  return lin;
}

// stage 2: what the W chain and the mask of one component read at the site
template <typename T>
struct WIn {
  T f, fw, kw, sw, mask;
  bool on;                  // the site runs the chain (else E = lin)
};

template <typename T>
__device__ __forceinline__ WIn<T> w_load(const EhP& e, i64 fn, i64 i, i64 j,
                                         i64 k) {
  WIn<T> w;
  w.on = false;
  w.f = w.fw = w.kw = w.sw = T(0);
  if (e.w_ax >= 0) {
    i64 cw = coord(e.w_ax, i, j, k);
    if (!e.w_slab || in_slab(cw, e.w_lo, e.w_hi, e.w_n)) {
      w.on = true;
      w.kw = ((const T*)e.kapw)[cw];
      w.sw = ((const T*)e.sigw)[cw];
      w.f = ((const T*)e.f)[fn];
      w.fw = ((const T*)e.fw)[fn];
    }
  }
  w.mask = mask_of<T>(e.alive, i, j, k);
  return w;
}

// stage 3: the W chain, the mask, the stores; returns the new E/H
template <typename T>
__device__ __forceinline__ T w_store(const EhP& e, i64 fn, T lin,
                                     const WIn<T>& w) {
  T fnew = lin;
  if (w.on) {
    fnew = w.f + (w.kw + w.sw) * lin - (w.kw - w.sw) * w.fw;
    ((T*)e.fw)[fn] = lin;
  }
  fnew = fnew * w.mask;
  ((T*)e.f)[fn] = fnew;
  return fnew;
}

// the whole E (or H) update of a site: lin and the new field per component
template <typename T, bool RING, bool NL>
__device__ __forceinline__ void eh_site(const Params& P, i64 n, i64 fn,
                                        i64 i, i64 j, i64 k, T* lin,
                                        T* fnew) {
  WIn<T> w[NCOMP];
#pragma unroll
  for (int q = 0; q < NCOMP; ++q)
    if (q < P.neh) lin[q] = eh_lin<T, RING, NL>(P, q, n, fn, i, j, k);
#pragma unroll
  for (int q = 0; q < NCOMP; ++q)
    if (q < P.neh) w[q] = w_load<T>(P.eh[q], fn, i, j, k);
#pragma unroll
  for (int q = 0; q < NCOMP; ++q)
    if (q < P.neh) fnew[q] = w_store<T>(P.eh[q], fn, lin[q], w[q]);
}

// whether an E-family parameter block needs the NL = true functions
inline bool has_nl(const Params& P) {
  for (int q = 0; q < P.neh; ++q)
    if (P.eh[q].chi3 || P.eh[q].nrchi2) return true;
  return false;
}

// Lorentz/Drude ADE from the new E (step._pol_update_lorentzian) at one
// site, after eh_site; the new P goes into the PP buffer, whose old value
// only this site reads (the caller swaps the roles).  Per polarization, the
// loads of every component before the stores, as in eh_site.
template <typename T>
__device__ void pol_site(const Params& P, i64 n, i64 fn, const T* lin,
                         const T* fnew) {
  for (int p = 0; p < P.npol; ++p) {
    T pnew[NCOMP];
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      if (q >= P.neh) continue;
      const PolC& pc = P.eh[q].pol[p];
      if (!pc.p) continue;
      T W = P.eh[q].w_ax >= 0 ? lin[q] : fnew[q];
      T drive = ((const T*)pc.sigma)[n] * W;
      T pcur = ((const T*)pc.p)[fn];
      T pprev = ((const T*)pc.pp)[fn];
      pnew[q] = T(P.pg1inv[p]) * (pcur * T(P.p2md[p]) - T(P.pg1[p]) * pprev +
                                  T(P.pw2[p]) * drive);
    }
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      if (q >= P.neh) continue;
      const PolC& pc = P.eh[q].pol[p];
      if (pc.p) ((T*)pc.pp)[fn] = pnew[q];
    }
  }
}

// one current source entry into D/B: f -= current * dt (step._apply_sources)
template <typename T>
__device__ __forceinline__ T source_amp(const T* are, const T* aim, i64 t,
                                        T wre, T wim, T dt) {
  return (wre * are[t] - wim * aim[t]) * dt;
}
