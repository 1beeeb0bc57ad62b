// K1 on Hopper: one full 3D Yee step of the port's state layout, written
// by hand for sm_90a and bound through a plain C interface (ctypes).
//
// Replaces the TPU kernel meep_nl_tpu/ops/pallas/fdtd3d.py::_build_call
// (Pallas body :846-1313, pallas_call :1343, driven by Fdtd3dKernel :1484).
// It computes exactly meep_nl_tpu_torch/stepper/step.py::make_step without
// the DTFT update (that stepper is this kernel's plain version):
//   B <- B - dt curl E through the uPML sigma/kappa chains (f_u aux);
//   H <- W chain (u * B);
//   D <- D + dt curl H through the chains;
//   point/volume current sources into B and D;
//   E <- chi1inv (D - sum P) with the chi3 Pade factor and the chi2
//        Newton-Raphson solve (3 fixed iterations) on the neighbour-averaged
//        partner (D - P) values, then the W chain;
//   the Lorentz/Drude ADE update of P from the new E.
//
// Launches per step: B half (curl B + H, all site-local), [B sources + H
// when the plan has H-family sources], D half (curl H), one per D source,
// E-from-D (+ the polarization update).  Every launch is one thread per
// storage site; a thread updates all (up to three) components of its site.
//
// Read-after-write hazards: the E launch reads neighbours' D - P, so the new
// P is written into the PP buffer (whose old value only this site reads) and
// the wrapper swaps the P/PP roles afterwards; E and W are read only at the
// thread's own site.  The curl launches read only the other family.
//
// What bounds it on the H100: device-memory bytes.  The state is the eager
// stepper's full-grid layout (E, H, D, B, and f_w for E when the plan has
// polarizations, full grids; f_u and the H f_w only on their PML slabs).
// Per interior cell and step of the flagship material that is about 96 B
// for E/H/D/B read+write, 24 B for the E W chain, 24 B for chi1inv and the
// NR epsilon, and 60 B more inside the material (P, PP, new P, sigma,
// chi2): ~150-200 B/cell against ~60-80 B for the TPU kernel's compact
// D/B-only layout.  Left on the table by this simple design: the compact
// layout (E/H recomputed as u*D outside the slabs), support-boxed material
// windows instead of full-grid sigma/chi2/P arrays, fusing the D and E
// halves with an x-marching plane carry, temporal blocking (K2), and
// caching neighbour planes in shared memory.

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

enum { MODE_B = 0, MODE_H = 1, MODE_BH = 2, MODE_D = 3, MODE_E = 4 };

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
template <typename T, bool IS_D>
__device__ __forceinline__ T diff(const T* g, const Params& P, i64 a,
                                  i64 idx, i64 i, i64 j, i64 k) {
  i64 c = coord(a, i, j, k);
  i64 st = stride(P, a);
  if (IS_D) return g[idx] - (c > 0 ? g[idx - st] : T(0));
  return (c < extent(P, a) - 1 ? g[idx + st] : T(0)) - g[idx];
}

template <typename T, bool IS_D>
__device__ void curl_site(const CurlP& c, const Params& P, i64 idx, i64 i,
                          i64 j, i64 k) {
  T* F = (T*)c.f;
  T dfl = T(0);
  if (c.gp || c.gm) {
    T tot;
    if (c.gp) tot = diff<T, IS_D>((const T*)c.gp, P, c.ap, idx, i, j, k);
    if (c.gm) {
      T t2 = diff<T, IS_D>((const T*)c.gm, P, c.am, idx, i, j, k);
      tot = c.gp ? tot - t2 : -t2;
    }
    dfl = T(P.csgn) * tot;
  }
  T f = F[idx];
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
      T fuo = FU[idx];
      T fun = c.sig_ax >= 0 ? ((kap[cs] - sig[cs]) * fuo + dfl) * siginv[cs]
                            : fuo + dfl;
      base = siginvu[cu] * ((kapu[cu] - sigu[cu]) * f + fun - fuo);
      FU[idx] = fun;
    }
  }
  F[idx] = base * mask_of<T>(c.alive, i, j, k);
}

template <typename T>
__device__ __forceinline__ T dmp_at(const EhP& e, i64 npol, i64 idx) {
  T v = ((const T*)e.d)[idx];
  for (int p = 0; p < npol; ++p)
    if (e.pol[p].p) v = v - ((const T*)e.pol[p].p)[idx];
  return v;
}

// D - P of component e at (i,j,k) + da along axis a + db along axis b;
// zero where any shifted coordinate leaves the storage
template <typename T>
__device__ T dmp_nb(const EhP& e, const Params& P, i64 i, i64 j, i64 k,
                    i64 a, i64 da, i64 b, i64 db) {
  i64 c[3] = {i, j, k};
  if (a >= 0) c[a] += da;
  if (b >= 0) c[b] += db;
  if (c[0] < 0 || c[0] >= P.S0 || c[1] < 0 || c[1] >= P.S1 || c[2] < 0 ||
      c[2] >= P.S2)
    return T(0);
  return dmp_at<T>(e, P.npol, (c[0] * P.S1 + c[1]) * P.S2 + c[2]);
}

// g + g_s + g_x + g_sx of step._sum4 / _avg4: g_s one site along the own
// axis (sign sgn), g_x one site back along the partner's axis
template <typename T>
__device__ T sum4(const EhP& e, const Params& P, i64 i, i64 j, i64 k,
                  i64 own, i64 off) {
  i64 s = P.sgn;
  T g = dmp_nb<T>(e, P, i, j, k, -1, 0, -1, 0);
  T gs = dmp_nb<T>(e, P, i, j, k, own, s, -1, 0);
  T gx = dmp_nb<T>(e, P, i, j, k, off, -s, -1, 0);
  T gsx = dmp_nb<T>(e, P, i, j, k, own, s, off, -s);
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

// step._eh_update at one site; returns lin (the W-chain input) and writes
// the new E/H (and W) in place
template <typename T>
__device__ void eh_site(const Params& P, int q, i64 idx, i64 i, i64 j, i64 k,
                        T* lin_out, T* fnew_out) {
  const EhP& e = P.eh[q];
  T gs = dmp_at<T>(e, P.npol, idx);
  T us = e.u ? ((const T*)e.u)[idx] : T(1);
  T lin = e.u ? gs * us : gs;
  if (e.chi3) {
    T Dsqr = gs * gs;
    if (e.dc1 >= 0) {
      T g = sum4<T>(P.eh[e.dc1], P, i, j, k, e.ax_own, e.ax_1);
      Dsqr = Dsqr + T(0.0625) * (g * g);
    }
    if (e.dc2 >= 0) {
      T g = sum4<T>(P.eh[e.dc2], P, i, j, k, e.ax_own, e.ax_2);
      Dsqr = Dsqr + T(0.0625) * (g * g);
    }
    T c2 = gs * ((const T*)e.chi2)[idx] * (us * us);
    T c3 = Dsqr * ((const T*)e.chi3)[idx] * (us * us * us);
    lin = lin * ((T(1) + c2 + T(2) * c3) / (T(1) + T(2) * c2 + T(3) * c3));
  }
  if (e.nrchi2) {
    T chi2 = ((const T*)e.nrchi2)[idx];
    if (chi2 != T(0)) {
      T g1 = e.dc1 >= 0
                 ? T(0.25) * sum4<T>(P.eh[e.dc1], P, i, j, k, e.ax_own, e.ax_1)
                 : T(0);
      T g2 = e.dc2 >= 0
                 ? T(0.25) * sum4<T>(P.eh[e.dc2], P, i, j, k, e.ax_own, e.ax_2)
                 : T(0);
      lin = nr_solve<T>(gs, g1, g2, ((const T*)e.nreps)[idx], chi2,
                        P.nr_iters);
    }
  }
  T* F = (T*)e.f;
  T fnew = lin;
  if (e.w_ax >= 0) {
    i64 cw = coord(e.w_ax, i, j, k);
    if (!e.w_slab || in_slab(cw, e.w_lo, e.w_hi, e.w_n)) {
      T* FW = (T*)e.fw;
      T kw = ((const T*)e.kapw)[cw];
      T sw = ((const T*)e.sigw)[cw];
      fnew = F[idx] + (kw + sw) * lin - (kw - sw) * FW[idx];
      FW[idx] = lin;
    }
  }
  fnew = fnew * mask_of<T>(e.alive, i, j, k);
  F[idx] = fnew;
  *lin_out = lin;
  *fnew_out = fnew;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(256)
k1_kernel(const __grid_constant__ Params P) {
  i64 n = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  i64 s12 = P.S1 * P.S2;
  if (n >= P.S0 * s12) return;
  i64 i = n / s12;
  i64 r = n - i * s12;
  i64 j = r / P.S2;
  i64 k = r - j * P.S2;
  if (MODE == MODE_B || MODE == MODE_BH) {
    for (int q = 0; q < P.ncurl; ++q) curl_site<T, false>(P.curl[q], P, n, i, j, k);
  }
  if (MODE == MODE_D) {
    for (int q = 0; q < P.ncurl; ++q) curl_site<T, true>(P.curl[q], P, n, i, j, k);
  }
  if (MODE == MODE_H || MODE == MODE_BH || MODE == MODE_E) {
    T lin[NCOMP], fnew[NCOMP];
    for (int q = 0; q < P.neh; ++q) eh_site<T>(P, q, n, i, j, k, &lin[q], &fnew[q]);
    if (MODE == MODE_E) {
      // Lorentz/Drude ADE from the new E (step._pol_update_lorentzian);
      // the new P goes into the PP buffer (the wrapper swaps the roles)
      for (int p = 0; p < P.npol; ++p) {
        for (int q = 0; q < P.neh; ++q) {
          const PolC& pc = P.eh[q].pol[p];
          if (!pc.p) continue;
          T W = P.eh[q].w_ax >= 0 ? lin[q] : fnew[q];
          T drive = ((const T*)pc.sigma)[n] * W;
          T pcur = ((const T*)pc.p)[n];
          T* PP = (T*)pc.pp;
          T pprev = PP[n];
          PP[n] = T(P.pg1inv[p]) * (pcur * T(P.p2md[p]) - T(P.pg1[p]) * pprev +
                                    T(P.pw2[p]) * drive);
        }
      }
    }
  }
}

template <typename T>
__global__ void source_kernel(T* f, const i64* off, const T* are,
                              const T* aim, i64 n, T wre, T wim, T dt) {
  i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  T A = (wre * are[t] - wim * aim[t]) * dt;
  atomicAdd(&f[off[t]], -A);
}

template <typename T>
static int launch(const Params* p, int mode, cudaStream_t s) {
  i64 nsite = p->S0 * p->S1 * p->S2;
  unsigned blocks = (unsigned)((nsite + 255) / 256);
  switch (mode) {
    case MODE_B: k1_kernel<T, MODE_B><<<blocks, 256, 0, s>>>(*p); break;
    case MODE_H: k1_kernel<T, MODE_H><<<blocks, 256, 0, s>>>(*p); break;
    case MODE_BH: k1_kernel<T, MODE_BH><<<blocks, 256, 0, s>>>(*p); break;
    case MODE_D: k1_kernel<T, MODE_D><<<blocks, 256, 0, s>>>(*p); break;
    case MODE_E: k1_kernel<T, MODE_E><<<blocks, 256, 0, s>>>(*p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" {

i64 mnt_k1_params_size(void) { return (i64)sizeof(Params); }

int mnt_k1_half(const Params* p, int mode, int fp64, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return fp64 ? launch<double>(p, mode, s) : launch<float>(p, mode, s);
}

int mnt_k1_source(void* f, const void* off, const void* are, const void* aim,
                  i64 n, double wre, double wim, double dt, int fp64,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned blocks = (unsigned)((n + 127) / 128);
  if (fp64)
    source_kernel<double><<<blocks, 128, 0, s>>>(
        (double*)f, (const i64*)off, (const double*)are, (const double*)aim,
        n, wre, wim, dt);
  else
    source_kernel<float><<<blocks, 128, 0, s>>>(
        (float*)f, (const i64*)off, (const float*)are, (const float*)aim, n,
        (float)wre, (float)wim, (float)dt);
  return (int)cudaGetLastError();
}

}  // extern "C"
