// K2 on Hopper: `depth` (2 or 3) consecutive 3D Yee steps in ONE launch and
// one pass over the grid, by temporal blocking along x, with the monitor
// planes of the intermediate steps written by the kernel itself.  Written
// by hand for sm_90a, bound through a plain C interface (ctypes).
//
// Replaces the TPU kernel meep_nl_tpu/ops/pallas/fdtd3d_t2.py::_build_call2
// (:182, kernel body :893, pallas_call :2047, driven by Fdtd3dT2Kernel
// :2084).  It computes `depth` applications of K1's step (fdtd3d.cu; the
// per-site arithmetic of both is fdtd3d_site.cuh), stage s with row s of the
// source table, plus the capture planes: E/H of chosen x-planes after a
// chosen stage, as state["f"][comp][x:x+1] would read there.  The Mosaic
// plan (lo/mid/disp/hi call segments, host-precomputed halos, cross-call
// packages, VMEM ping-pong) is not carried over.
//
// Design: a wavefront marching along x over a ring of x-planes.
//   * One cooperative launch (cudaLaunchCooperativeKernel); the grid is
//     co-resident and every block loops over sites, so grid.sync() orders
//     the phases.
//   * A ring of R x-planes per state array (scratch, R = O(depth + bx), far
//     below S0) holds the only copy of every intermediate stage.  LOAD
//     copies planes of the state into the ring, the stages update the ring
//     in place, STORE copies finished planes back.  The state arrays are
//     read once and written once per `depth` steps.
//   * The host (ops/fdtd3d_t2.py::schedule) turns the step into a list of
//     ops -- LOAD, per stage [B curl, B sources, H] or the fused [B curl +
//     H], D curl, D sources, E (+ polarization), then STORE -- and gives
//     each a phase and an x offset: at wavefront step w, an op works on the
//     planes [w*bx - off, w*bx - off + bx).  Offsets follow from the ops'
//     read and write sets (which planes of which arrays, at x-1, x, x+1),
//     so that whatever an op reads is complete and whatever it overwrites
//     is no longer needed.  The kernel below only executes that table.
//
// Where trouble was likely:
//  (a) in-place state: the stages never touch the state arrays.  Stage 1
//      reads ring planes that LOAD filled; STORE trails the last stage; a
//      ring slot is reloaded only after every reader of its plane has run
//      (R = largest offset + 1 + bx).
//  (b) order within a stage: B curl reads E at x+1, D curl reads H at x-1,
//      E reads D - P at x-1 and x+1 (the chi2/chi3 neighbour sums).  Each is
//      an op of its own, behind the op it reads from by the needed planes
//      and in a later phase (or a whole block later); phases end in
//      grid.sync().
//  (c) P/PP roles: the E op writes the new P over the PP array, so the
//      roles alternate per stage; the host hands stage s its Params with the
//      roles of that stage, and STORE writes the array that holds the
//      newest P into the state's p (after 3 stages: the other one).
//  (d) sources: an op per source and stage adds row s of the table
//      (B currents at t*dt, D at (t+1/2)*dt) at the source's sites whose
//      plane lies in the op's block, between the curl and the E/H op.
//  (e) edges: an op's block is clipped to [0, S0), so the first and last
//      wavefront steps run fewer ops; dead storage planes are masked by the
//      alive vectors as in K1.
//  (f) cooperative launch: the grid is min(wanted, occupancy x SM count)
//      blocks; a refused launch returns its cudaError to the wrapper, which
//      raises.
//  (g) fp64 plans run the same template.
//
// What bounds it on the H100: by its byte count, device memory (the state
// once in, once out per call).  In this first version it is far from that
// bound and slower per step than K1: every phase is a pass of one site per
// thread over a co-resident grid of a few hundred blocks (one kernel holds
// every op, so the heaviest op's registers set the occupancy of all), ended
// by a grid.sync(), and LOAD/STORE move every array through the ring once
// more.  Left on the table: stage 1 reading the state directly and the last
// stage writing it, a shared-memory ring over y-z tiles in place of the
// grid-wide barriers, the compact D/B layout, TMA plane loads.

#include <cooperative_groups.h>

#include "fdtd3d_site.cuh"

namespace cg = cooperative_groups;

#define MAXDEPTH 3
#define MAXOPS 48
#define MAXCOPY 64
#define MAXSRC 8
#define MAXCAP 48

enum {
  OP_LOAD = 0, OP_STORE = 1, OP_BC = 2, OP_BH = 3, OP_HH = 4, OP_DC = 5,
  OP_EE = 6, OP_SRC = 7
};

// Mirrored by meep_nl_tpu_torch/ops/fdtd3d_t2.py; every member is 8 bytes.
struct Op {
  i64 kind, stage, phase, off, arg;   // stage 0-based; arg: source index
};

struct CopyArr {
  void* state;
  void* ring;
  i64 ax, lo, hi, n;                  // copy only this slab (ax -1: all)
};

struct Src {
  void* f;                            // the D/B ring array it adds into
  const void* off;                    // full-grid flat offsets (int64)
  const void* are;
  const void* aim;
  i64 n;
  double wre[MAXDEPTH], wim[MAXDEPTH];
};

struct Cap {
  void* out;                          // one (S1, S2) plane
  i64 stage, fam, q, x;               // fam 0: H (pb), 1: E (pd); q: eh[]
};

struct K2Args {
  Params pb[MAXDEPTH], pd[MAXDEPTH];
  Op ops[MAXOPS];
  CopyArr load[MAXCOPY], store[MAXCOPY];
  Src src[MAXSRC];
  Cap cap[MAXCAP];
  double dt;
  i64 nops, nphase, nload, nstore, ncap, depth, bx, nwave, S0, S1, S2, R;
};

// a site of an op's block [lo, hi): its plane i, in-plane offset r = j*S2 + k,
// and its indices n (full grid) and fn (ring); 32-bit decode, a block has
// fewer than 2^31 sites
struct Site {
  i64 i, j, k, r, n, fn;
};

__device__ __forceinline__ Site site_of(const K2Args& A, i64 lo,
                                        unsigned it) {
  const unsigned s12 = (unsigned)(A.S1 * A.S2), S2 = (unsigned)A.S2;
  unsigned di = it / s12, r = it - di * s12;
  unsigned j = r / S2, k = r - j * S2;
  Site s;
  s.i = lo + di;
  s.j = j;
  s.k = k;
  s.r = r;
  s.n = s.i * s12 + r;
  s.fn = slot<true>(A.R, s.i) * s12 + r;
  return s;
}

// LOAD / STORE: the arrays in batches, every load of a batch issued before
// its stores
#define COPY_BATCH 8

template <typename T>
__device__ void copy_planes(const K2Args& A, bool load, i64 lo, i64 hi,
                            unsigned tid, unsigned nthr) {
  const CopyArr* arr = load ? A.load : A.store;
  const int narr = (int)(load ? A.nload : A.nstore);
  const unsigned nsite = (unsigned)((hi - lo) * A.S1 * A.S2);
  for (unsigned it = tid; it < nsite; it += nthr) {
    Site s = site_of(A, lo, it);
    for (int a0 = 0; a0 < narr; a0 += COPY_BATCH) {
      T v[COPY_BATCH];
      bool on[COPY_BATCH];
#pragma unroll
      for (int b = 0; b < COPY_BATCH; ++b) {
        on[b] = a0 + b < narr;
        if (!on[b]) continue;
        const CopyArr& c = arr[a0 + b];
        on[b] = c.ax < 0 ||
                in_slab(coord(c.ax, s.i, s.j, s.k), c.lo, c.hi, c.n);
        if (on[b])
          v[b] = load ? ((const T*)c.state)[s.n] : ((const T*)c.ring)[s.fn];
      }
#pragma unroll
      for (int b = 0; b < COPY_BATCH; ++b) {
        if (!on[b]) continue;
        const CopyArr& c = arr[a0 + b];
        if (load) ((T*)c.ring)[s.fn] = v[b];
        else ((T*)c.state)[s.n] = v[b];
      }
    }
  }
}

// the capture planes of component q (family `fam`) after stage `s`
template <typename T>
__device__ __forceinline__ void capture(const K2Args& A, i64 s, i64 fam,
                                        i64 q, i64 i, i64 r, T fnew) {
  for (i64 c = 0; c < A.ncap; ++c) {
    const Cap& cp = A.cap[c];
    if (cp.x == i && cp.q == q && cp.stage == s && cp.fam == fam)
      ((T*)cp.out)[r] = fnew;
  }
}

// E or H of every component at one site (+ the ADE for E), and its captures
template <typename T, bool NL>
__device__ __forceinline__ void eh_all(const K2Args& A, const Params& P,
                                       i64 s, i64 fam, const Site& x) {
  T lin[NCOMP], fnew[NCOMP];
  eh_site<T, true, NL>(P, x.n, x.fn, x.i, x.j, x.k, lin, fnew);
#pragma unroll
  for (int q = 0; q < NCOMP; ++q)
    if (q < P.neh) capture<T>(A, s, fam, q, x.i, x.r, fnew[q]);
  if (fam == 1) pol_site<T>(P, x.n, x.fn, lin, fnew);
}

template <typename T, bool NL>
__device__ void run_sites(const K2Args& A, const Op& op, i64 lo, i64 hi,
                          unsigned tid, unsigned nthr) {
  const i64 s = op.stage;
  const i64 kind = op.kind;
  const Params& PB = A.pb[s];
  const Params& PD = A.pd[s];
  const unsigned nsite = (unsigned)((hi - lo) * A.S1 * A.S2);
  for (unsigned it = tid; it < nsite; it += nthr) {
    Site x = site_of(A, lo, it);
    if (kind == OP_BC || kind == OP_BH)
      for (int q = 0; q < PB.ncurl; ++q)
        curl_site<T, false, true>(PB.curl[q], PB, x.fn, x.i, x.j, x.k);
    if (kind == OP_HH || kind == OP_BH) eh_all<T, false>(A, PB, s, 0, x);
    if (kind == OP_DC)
      for (int q = 0; q < PD.ncurl; ++q)
        curl_site<T, true, true>(PD.curl[q], PD, x.fn, x.i, x.j, x.k);
    if (kind == OP_EE) eh_all<T, NL>(A, PD, s, 1, x);
  }
}

template <typename T>
__device__ void run_source(const K2Args& A, const Op& op, i64 lo, i64 hi,
                           unsigned tid, unsigned nthr) {
  const Src& sc = A.src[op.arg];
  const i64 s12 = A.S1 * A.S2;
  const i64* off = (const i64*)sc.off;
  T wre = (T)sc.wre[op.stage], wim = (T)sc.wim[op.stage], dt = (T)A.dt;
  for (i64 t = tid; t < sc.n; t += nthr) {
    i64 i = off[t] / s12;
    if (i < lo || i >= hi) continue;
    i64 fn = slot<true>(A.R, i) * s12 + (off[t] - i * s12);
    atomicAdd(&((T*)sc.f)[fn],
              -source_amp<T>((const T*)sc.are, (const T*)sc.aim, t, wre, wim,
                             dt));
  }
}

// the argument block of the launch in flight (uploaded before each launch,
// in stream order: every K2 launch of a process goes to one stream)
__constant__ K2Args c_args;

// NL = false: the variant for plans without chi3 / chi2-NR coefficients, with
// those branches compiled out (fewer registers, a larger co-resident grid)
template <typename T, bool NL>
__global__ void __launch_bounds__(256, 2) k2_kernel() {
  cg::grid_group grid = cg::this_grid();
  // every site reads the argument block (op table, per-stage Params, copy
  // and capture tables), the same words in every thread of a warp: it lies
  // in constant memory
  const K2Args& A = c_args;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned nthr = gridDim.x * blockDim.x;
  for (i64 w = 0; w < A.nwave; ++w) {
    i64 o = 0;
    for (i64 ph = 0; ph < A.nphase; ++ph) {
      bool any = false;               // the same in every thread
      for (; o < A.nops && A.ops[o].phase == ph; ++o) {
        const Op& op = A.ops[o];
        i64 lo = w * A.bx - op.off, hi = lo + A.bx;
        if (lo < 0) lo = 0;
        if (hi > A.S0) hi = A.S0;
        if (lo >= hi) continue;
        any = true;
        if (op.kind == OP_LOAD || op.kind == OP_STORE)
          copy_planes<T>(A, op.kind == OP_LOAD, lo, hi, tid, nthr);
        else if (op.kind == OP_SRC)
          run_source<T>(A, op, lo, hi, tid, nthr);
        else
          run_sites<T, NL>(A, op, lo, hi, tid, nthr);
      }
      if (any) grid.sync();
    }
  }
}

static const void* kernel_of(int fp64, int nl) {
  if (fp64)
    return nl ? (const void*)k2_kernel<double, true>
              : (const void*)k2_kernel<double, false>;
  return nl ? (const void*)k2_kernel<float, true>
            : (const void*)k2_kernel<float, false>;
}

static int max_blocks(int fp64, int nl, int* out) {
  static int cached[2][2] = {{0, 0}, {0, 0}};
  if (!cached[fp64][nl]) {
    int dev = 0, sms = 0, per = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, kernel_of(fp64, nl), 256, 0);
    if (e != cudaSuccess) return (int)e;
    if (per < 1 || sms < 1) return (int)cudaErrorLaunchOutOfResources;
    cached[fp64][nl] = per * sms;
  }
  *out = cached[fp64][nl];
  return 0;
}

extern "C" {

i64 mnt_k2_args_size(void) { return (i64)sizeof(K2Args); }

// the largest co-resident grid (blocks of 256 threads) of the kernel
// variant (fp64, nl), or -cudaError
int mnt_k2_max_blocks(int fp64, int nl) {
  int blocks = 0;
  int rc = max_blocks(fp64 != 0, nl != 0, &blocks);
  return rc ? -rc : blocks;
}

// Copy the argument block into constant memory and launch the kernel
// cooperatively, both on `stream`, with at most `blocks` blocks; the variant
// without the nonlinear branches when no stage's E block carries chi3 /
// chi2-NR coefficients.  Returns the cudaError of the first call that
// failed, else 0.
int mnt_k2_launch(const K2Args* host, int blocks, int fp64, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int nl = 0;
  for (i64 d = 0; d < host->depth; ++d) {
    if (has_nl(host->pb[d])) return (int)cudaErrorInvalidValue;
    nl |= has_nl(host->pd[d]);
  }
  fp64 = fp64 != 0;
  int most = 0;
  int rc = max_blocks(fp64, nl, &most);
  if (rc) return rc;
  if (blocks < 1 || blocks > most) blocks = most;
  cudaError_t e = cudaMemcpyToSymbolAsync(c_args, host, sizeof(K2Args), 0,
                                          cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchCooperativeKernel(kernel_of(fp64, nl), dim3((unsigned)blocks),
                                  dim3(256), nullptr, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
