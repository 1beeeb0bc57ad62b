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

#include "fdtd3d_site.cuh"   // the per-site arithmetic, shared with K2

enum { MODE_B = 0, MODE_H = 1, MODE_BH = 2, MODE_D = 3, MODE_E = 4 };

template <typename T, int MODE, bool NL>
__global__ void __launch_bounds__(256)
k1_kernel(const __grid_constant__ Params P) {
  i64 n = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  i64 s12 = P.S1 * P.S2;
  if (n >= P.S0 * s12) return;
  i64 i = n / s12;
  i64 r = n - i * s12;
  i64 j = r / P.S2;
  i64 k = r - j * P.S2;
  // the state is the full grid: field index == coefficient index
  if (MODE == MODE_B || MODE == MODE_BH) {
    for (int q = 0; q < P.ncurl; ++q)
      curl_site<T, false, false>(P.curl[q], P, n, i, j, k);
  }
  if (MODE == MODE_D) {
    for (int q = 0; q < P.ncurl; ++q)
      curl_site<T, true, false>(P.curl[q], P, n, i, j, k);
  }
  if (MODE == MODE_H || MODE == MODE_BH || MODE == MODE_E) {
    T lin[NCOMP], fnew[NCOMP];
    eh_site<T, false, NL>(P, n, n, i, j, k, lin, fnew);
    // the new P goes into the PP buffer (the wrapper swaps the roles)
    if (MODE == MODE_E) pol_site<T>(P, n, n, lin, fnew);
  }
}

template <typename T>
__global__ void source_kernel(T* f, const i64* off, const T* are,
                              const T* aim, i64 n, T wre, T wim, T dt) {
  i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  atomicAdd(&f[off[t]], -source_amp<T>(are, aim, t, wre, wim, dt));
}

template <typename T>
static int launch(const Params* p, int mode, cudaStream_t s) {
  i64 nsite = p->S0 * p->S1 * p->S2;
  unsigned blocks = (unsigned)((nsite + 255) / 256);
  // only the E family may carry chi3 / chi2-NR coefficients
  if ((mode == MODE_H || mode == MODE_BH) && has_nl(*p))
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case MODE_B: k1_kernel<T, MODE_B, false><<<blocks, 256, 0, s>>>(*p); break;
    case MODE_H: k1_kernel<T, MODE_H, false><<<blocks, 256, 0, s>>>(*p); break;
    case MODE_BH: k1_kernel<T, MODE_BH, false><<<blocks, 256, 0, s>>>(*p); break;
    case MODE_D: k1_kernel<T, MODE_D, false><<<blocks, 256, 0, s>>>(*p); break;
    case MODE_E:
      // the nonlinear branches are compiled in only for plans that have them
      if (has_nl(*p)) k1_kernel<T, MODE_E, true><<<blocks, 256, 0, s>>>(*p);
      else k1_kernel<T, MODE_E, false><<<blocks, 256, 0, s>>>(*p);
      break;
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
