// K5 on Hopper: one fused half step (B then H, or D then E) of a 3D uPML
// plan with diagonal media, written by hand for sm_90a and bound through a
// plain C interface (ctypes).
//
// Replaces the TPU kernel meep_nl_tpu/ops/pallas/fused.py::build_half_step
// (:71; kernel body :174-296, pallas_call :302), the round-1 kernel that
// Simulation(use_pallas=True) steps through.  It computes what that body
// computes, site by site, and what ops/fused.py::half_step_ref (its plain
// version) computes, in the same operation order:
//   dfl  = (+-Courant) * (diff g_plus - diff g_minus), the g family's
//          neighbours at +-1 read straight from global memory, zero outside
//          the storage (the reference's make_shifted / shift_yz);
//   D/B  through the full-grid sigma chain (f_u aux) and sigma_u chain:
//          fu_new = ((kap - sig) fu + dfl) siginv     (or fu + dfl)
//          f_new  = siginvu ((kapu - sigu) f + fu_new - fu_old);
//   E/H  from the site's new D/B: lin = u D, then the W chain
//          e_new  = e + (kapw + sigw) lin - (kapw - sigw) fw_old, fw = lin;
//   the dead-plane masks (per-axis 0/1 vectors) on the new D/B and E/H.
// The chains run on every site, as the reference's do: outside the PML
// slabs they do not reduce to f + dfl in floating point, so f_u and f_w are
// read and written everywhere.
//
// One launch per half step; one thread per site in a grid-stride loop, z
// fastest.  In place is safe: a site reads its own f, f_u, e, f_w and only
// the other family's neighbours, which this half does not write.  Every
// load of a site comes before its first store (the arrays are untyped
// pointers that may alias for all the compiler knows).  Coefficients carry
// per-axis element strides (0 on broadcast axes), so the chain vectors
// ((S0,1,1), (1,S1,1), (1,1,S2)) and a full 3D u read alike.
//
// The source fix-up (fused.py::build_source_fixup :358) is a second, small
// launch per current source: the reference injects sources after the fused
// E/H update and carries dD through the linear E-from-D at the source sites.
//
// What bounds it on the H100: device-memory bytes.  With uPML on every face
// each component carries f_u and f_w, so a half step streams about 15
// arrays in and 12 out.  Left for later work: shared-memory neighbour
// planes with an x-march, and skipping f_u / f_w outside the slabs where
// the bits allow it.

#include <cuda_runtime.h>
#include <stdint.h>

#define NC 3

typedef long long i64;

// a coefficient array and its element strides (0 along broadcast axes)
struct Coef {
  const void* p;
  i64 s0, s1, s2;
};

// One D or B component's update.  Field order is mirrored by
// meep_nl_tpu_torch/ops/fused.py (_Curl); every member is 8 bytes.
struct K5Curl {
  void* f;
  void* fu;                 // sigma_u chain aux (null: no chain)
  const void* gp;           // curl partners (null: absent)
  const void* gm;
  const void* alive[3];     // per-axis 0/1 dead-plane vectors (null: all 1)
  Coef kap, sig, siginv;    // sigma chain (kap.p null: no chain)
  Coef kapu, sigu, siginvu;
  i64 ap, am;               // derivative axes of gp / gm
};

// One E or H component's update from its D or B component.
struct K5Eh {
  void* e;
  void* fw;                 // W chain aux (null: no chain)
  const void* alive[3];
  Coef u;                   // chi1inv diagonal (u.p null: identity)
  Coef kapw, sigw;
  i64 dq;                   // index of its D/B component in curl[]
};

struct K5Params {
  K5Curl curl[NC];
  K5Eh eh[NC];
  double csgn;              // +Courant (D half) or -Courant (B half)
  i64 ncurl, neh;
  i64 S0, S1, S2;
};

template <typename T>
__device__ __forceinline__ T at(const Coef& c, i64 i, i64 j, i64 k) {
  return ((const T*)c.p)[i * c.s0 + j * c.s1 + k * c.s2];
}

// the product of the per-axis 0/1 vectors step.alive_vectors builds
template <typename T>
__device__ __forceinline__ T mask_at(const void* const alive[3], i64 i,
                                     i64 j, i64 k) {
  T m = T(1);
  if (alive[0]) m = m * ((const T*)alive[0])[i];
  if (alive[1]) m = m * ((const T*)alive[1])[j];
  if (alive[2]) m = m * ((const T*)alive[2])[k];
  return m;
}

// D: backward difference g - g[-1]; B: forward difference g[+1] - g; zero
// outside the storage
template <typename T, bool IS_D>
__device__ __forceinline__ T diff(const T* g, const K5Params& P, i64 a,
                                  i64 n, i64 i, i64 j, i64 k) {
  i64 c = a == 0 ? i : (a == 1 ? j : k);
  i64 ext = a == 0 ? P.S0 : (a == 1 ? P.S1 : P.S2);
  i64 st = a == 0 ? P.S1 * P.S2 : (a == 1 ? P.S2 : 1);
  if (IS_D) return g[n] - (c > 0 ? g[n - st] : T(0));
  return (c < ext - 1 ? g[n + st] : T(0)) - g[n];
}

template <typename T, bool IS_D>
__global__ void __launch_bounds__(256)
k5_kernel(const __grid_constant__ K5Params P) {
  const i64 s12 = P.S1 * P.S2;
  const i64 N = P.S0 * s12;
  for (i64 n = (i64)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += (i64)gridDim.x * blockDim.x) {
    i64 i = n / s12;
    i64 r = n - i * s12;
    i64 j = r / P.S2;
    i64 k = r - j * P.S2;
    T fnew[NC], funew[NC], enew[NC], lin[NC];
    // stage 1: the curl and the chains of every D/B component (loads only)
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      if (q >= P.ncurl) continue;
      const K5Curl& c = P.curl[q];
      T dfl = T(0);
      if (c.gp || c.gm) {
        T tot;
        if (c.gp) tot = diff<T, IS_D>((const T*)c.gp, P, c.ap, n, i, j, k);
        if (c.gm) {
          T t2 = diff<T, IS_D>((const T*)c.gm, P, c.am, n, i, j, k);
          tot = c.gp ? tot - t2 : -t2;
        }
        dfl = T(P.csgn) * tot;
      }
      T fold = ((const T*)c.f)[n];
      T kap = T(0), sig = T(0), sinv = T(0);
      if (c.kap.p) {
        kap = at<T>(c.kap, i, j, k);
        sig = at<T>(c.sig, i, j, k);
        sinv = at<T>(c.siginv, i, j, k);
      }
      T fn_;
      if (c.fu) {
        T fuo = ((const T*)c.fu)[n];
        T fun = c.kap.p ? ((kap - sig) * fuo + dfl) * sinv : fuo + dfl;
        fn_ = at<T>(c.siginvu, i, j, k) *
              ((at<T>(c.kapu, i, j, k) - at<T>(c.sigu, i, j, k)) * fold +
               fun - fuo);
        funew[q] = fun;
      } else {
        fn_ = c.kap.p ? ((kap - sig) * fold + dfl) * sinv : fold + dfl;
      }
      fnew[q] = fn_ * mask_at<T>(c.alive, i, j, k);
    }
    // stage 2: E/H from the site's new D/B, the W chain (loads only)
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      if (q >= P.neh) continue;
      const K5Eh& e = P.eh[q];
      T d = fnew[e.dq];
      lin[q] = e.u.p ? d * at<T>(e.u, i, j, k) : d;
      T en;
      if (e.fw) {
        T kw = at<T>(e.kapw, i, j, k);
        T sw = at<T>(e.sigw, i, j, k);
        T eo = ((const T*)e.e)[n];
        T fwo = ((const T*)e.fw)[n];
        en = eo + (kw + sw) * lin[q] - (kw - sw) * fwo;
      } else {
        en = lin[q];
      }
      enew[q] = en * mask_at<T>(e.alive, i, j, k);
    }
    // stage 3: the stores
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      if (q >= P.ncurl) continue;
      ((T*)P.curl[q].f)[n] = fnew[q];
      if (P.curl[q].fu) ((T*)P.curl[q].fu)[n] = funew[q];
    }
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      if (q >= P.neh) continue;
      ((T*)P.eh[q].e)[n] = enew[q];
      if (P.eh[q].fw) ((T*)P.eh[q].fw)[n] = lin[q];
    }
  }
}

// One current source's fix-up after a half step (fused.py:381-395): at
// each source site t, dD = -J dt into D/B, dlin = u dD into f_w, and
// (kapw + sigw) dlin (or dlin) into E/H times the site's liveness.  The
// gathers of u, kapw and sigw use flat offsets the wrapper computed with
// the reference's index clamp.  Mirrored by ops/fused.py (_FixArgs).
struct FixArgs {
  void* d;
  void* e;
  void* fw;                 // null: the E/H component has no W chain
  const void* off;          // i64 flat storage offsets of the sites
  const void* are;
  const void* aim;
  const void* cnd;          // null: no conductivity factor
  const void* alive;        // per-site 0/1 (T)
  const void* u;            // null: identity
  const void* uoff;         // i64 offsets into u
  const void* kw;
  const void* kwoff;
  const void* sw;
  const void* swoff;
  i64 n;
  double wre, wim, dt;
};

template <typename T>
__global__ void k5_fixup_kernel(const __grid_constant__ FixArgs A) {
  for (i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x; t < A.n;
       t += (i64)gridDim.x * blockDim.x) {
    const i64 o = ((const i64*)A.off)[t];
    T dD = (-(T(A.wre) * ((const T*)A.are)[t] -
              T(A.wim) * ((const T*)A.aim)[t])) * T(A.dt);
    if (A.cnd) dD = dD * ((const T*)A.cnd)[t];
    atomicAdd((T*)A.d + o, dD);
    T dlin = A.u ? dD * ((const T*)A.u)[((const i64*)A.uoff)[t]] : dD;
    T am = ((const T*)A.alive)[t];
    if (A.fw) {
      T kw = ((const T*)A.kw)[((const i64*)A.kwoff)[t]];
      T sw = ((const T*)A.sw)[((const i64*)A.swoff)[t]];
      atomicAdd((T*)A.fw + o, dlin);
      atomicAdd((T*)A.e + o, (kw + sw) * dlin * am);
    } else {
      atomicAdd((T*)A.e + o, dlin * am);
    }
  }
}

static unsigned grid_for(i64 n, int threads) {
  i64 b = (n + threads - 1) / threads;
  return (unsigned)(b < 1 ? 1 : (b > 1048576 ? 1048576 : b));
}

template <typename T>
static int half(const K5Params* p, int is_d, cudaStream_t s) {
  void* args[] = {(void*)p};
  dim3 grid(grid_for(p->S0 * p->S1 * p->S2, 256)), block(256);
  cudaError_t rc = is_d
      ? cudaLaunchKernel(k5_kernel<T, true>, grid, block, args, 0, s)
      : cudaLaunchKernel(k5_kernel<T, false>, grid, block, args, 0, s);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

template <typename T>
static int fixup(const FixArgs* a, cudaStream_t s) {
  void* args[] = {(void*)a};
  cudaError_t rc = cudaLaunchKernel(k5_fixup_kernel<T>,
                                    dim3(grid_for(a->n, 128)), dim3(128),
                                    args, 0, s);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

extern "C" {

i64 mnt_k5_params_size(void) { return (i64)sizeof(K5Params); }

i64 mnt_k5_fixargs_size(void) { return (i64)sizeof(FixArgs); }

int mnt_k5_half(const K5Params* p, int is_d, int fp64, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return fp64 ? half<double>(p, is_d, s) : half<float>(p, is_d, s);
}

int mnt_k5_fixup(const FixArgs* a, int fp64, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return fp64 ? fixup<double>(a, s) : fixup<float>(a, s);
}

}  // extern "C"
