// K3 and K4 on Hopper: a whole chunk of Yee steps of a small grid (every 2D
// cell, small 3D cells) in ONE cooperative launch, the state kept in device
// memory between the steps, with the sources, the DTFT and (K4) the probe
// series inside the time loop.  Written by hand for sm_90a, bound through a
// plain C interface (ctypes).
//
// Replaces the TPU kernels meep_nl_tpu/ops/pallas/resident.py::
// ResidentKernel._runner (K3, :223, pallas_call :271) and _runner_probed
// (K4, :289, pallas_call :362).  Those trace the eager stepper into one
// Mosaic program whose fori_loop keeps the whole state in VMEM.  This
// kernel computes the same function: nsteps applications of
// meep_nl_tpu_torch/stepper/step.py::make_step over the resident plan
// (full-grid PML chains, dense pre-scattered sources, frequency-major DTFT
// accumulators; ops/resident.py::resident_plan), with the per-site
// arithmetic of K1 and K2 (fdtd3d_site.cuh) on the grid (S0, S1, S2), a 2D
// plan being (S0, S1, 1).  K4 is the same kernel with a probe table: after
// every step one thread per probe sums w * f over the probe's points in
// point order from 0.0f (resident.py:336-339) into its series.
//
// Design: the time loop runs inside the kernel.
//   * One cooperative launch (cudaLaunchCooperativeKernel) per chunk of at
//     most MAX_CHUNK steps; the grid is min(wanted, occupancy x SM count)
//     blocks of 256 threads, every block loops over sites (grid-stride), and
//     grid.sync() orders the phases.  A refused launch returns its cudaError
//     to the wrapper, which raises.
//   * The state stays in device memory; a 767^2 2D plan's working set (about
//     43 MiB with the dense source arrays) fits in the 50 MB L2.
//   * The argument block (two Params per family: the P/PP roles of even and
//     odd steps; the source tables) lives in per-launch device memory that
//     the wrapper fills, and every block copies it into shared memory once:
//     no site reads it from global memory, and no two kernel objects share
//     it.  The DTFT monitors and the probes are tables of any length in
//     per-launch device memory that the block points to; every block copies
//     them into shared memory too when they fit in TAB_WORDS (7 KB: 48
//     monitors and 16 probes, say), and reads larger ones where they are.
//   * Per-step inputs: the source currents (nsteps, nsrc, 2) and the DTFT
//     phase rows (nsteps, nfreq) of build_xs, uploaded once per launch, and
//     a per-step flag word saying which of them are nonzero.  A step whose
//     currents of a family are all zero skips that family's source phase
//     and one whose phase rows are all zero (decimation) skips the DTFT:
//     the plain version adds exact zeros there.
//
// Phases of one step, and the grid barriers between them (each cross-site
// read needs one):
//   1. B curl at every site (reads E at neighbours), then at the same site
//      H from B (+ the H-family ADE; site-local: the envelope has no
//      H-family chi2/chi3) -- fused, unless B sources are on this step:
//        | barrier: the B sources read and write B sites another thread
//        |   curled;
//      1b. B sources at their sites;
//        | barrier: H must see the sourced B;
//      1c. H from B.
//   | barrier: the D curl reads H at neighbours.
//   2. D curl at every site, then at the same site E from D (chi1inv (D - P),
//      the chi3 Pade factor, the chi2 Newton-Raphson solve, the W chain, the
//      E-family ADE) -- fused when E is site-local (no chi2/chi3 partner
//      sums) and no D source is on this step; else:
//        | barrier: the sources (or the neighbour sums of D - P) read D that
//        |   other threads curled;
//      2b. D sources at their sites (steps with D currents);
//        | barrier (after 2b): E reads the sourced D;
//      2c. E from D.  The new P is written into the PP buffer (the
//          neighbour sums read the old P), so P and PP swap roles every
//          step: even steps use pb[0]/pd[0], odd steps pb[1]/pd[1].
//   | barrier, on DTFT sample steps and in K4 on every step: the centred
//   |   DTFT average reads E/H at neighbours, the probes any site;
//   3. DTFT update over the monitors' region sites (the centred average
//      folded axis by axis, as step._region_values does), probe sums.
//   | barrier before the next step: its B curl reads E at neighbours, its H
//   |   overwrites the H that phase 3 reads.
// So a step takes 2 barriers (TM, source off, no sample) to 6 (sources of
// both families on, NL partner sums, a sample).
//
// Sources: the wrapper lists, per family, the sites where any source's
// dense amplitude arrays are nonzero, and at each site every source's
// (re, im) amplitude in source order; one thread per site applies them in
// that order as the plain version's f -= (w_re dre - w_im dim) dt does over
// the whole dense array (every other site gets exact zeros there).  Only
// f is touched: the envelope has no conductive component, whose f_u /
// f_cond the reference mirrors the delta into.
//
// What bounds it on the H100: counted per step and site, operations; the
// bytes a launch must move are the state in and out once per chunk.  In
// this first version every phase is a grid-stride pass of one site per
// thread ended by a grid-wide barrier, the same structure that makes K2
// slower than K1, and the state is read from L2 (or HBM past 50 MB) once
// or twice per step.  Left on the table: fewer barriers (the DTFT of E in
// the next step's B phase, the probes beside it), shared-memory tiles with
// halos across several steps, 32-bit index math in the site functions.

#include <cooperative_groups.h>

#include "fdtd3d_site.cuh"

namespace cg = cooperative_groups;

#define TAB_WORDS 896
#define STEP_BSRC 1
#define STEP_DSRC 2
#define STEP_DFT 4

// Mirrored by meep_nl_tpu_torch/ops/resident.py; every member is 8 bytes.
struct DftM {
  void* acc;            // (nfreq, 2, R) frequency-major accumulators
  const void* f;        // the field component the monitor reads
  const void* w;        // (R) weights of the region sites
  const void* phr;      // (nsteps, nfreq) phase rows
  const void* phi;
  i64 nfreq, R;         // frequencies, region sites
  i64 lo[3], n[3];      // region origin and extents per axis (n = 1: absent)
  i64 navg, avg[3];     // axes of the centred average, ascending
};

struct ProbeR {
  const void* f;        // the field component
  const void* off;      // (npts) int32 flat offsets
  const void* w;        // (npts) float weights
  void* out;            // (nsteps) float series
  i64 npts;
};

struct SrcFam {         // one family's sources, by site
  const void* slot_off;    // (nslot) int32 flat offset of the site
  const void* slot_q;      // (nslot) int32 index into Params.curl[]
  const void* slot_start;  // (nslot + 1) int32: the site's contributions
  const void* c_src;       // int32 source index (column of the currents)
  const void* c_re;        // float dense_re / dense_im at the site
  const void* c_im;
  i64 nslot;
};

struct ResArgs {
  Params pb[2], pd[2];  // [step parity]: the P/PP roles of that step
  SrcFam src[2];        // 0: B family, 1: D family
  const DftM* dft;      // (ndft) monitors
  const ProbeR* probe;  // (nprobe) probes
  const void* cur;      // (nsteps, nsrc, 2) float source currents
  const void* flags;    // (nsteps) int32 STEP_* bits
  double dt;
  i64 nsteps, nsrc, ndft, nprobe;
  i64 e_local;          // 1: E from D reads no neighbour (fusable)
};

// a site of the grid: plane i, row j, column k; 32-bit decode
struct Site {
  i64 n, i, j, k;
};

__device__ __forceinline__ Site site_of(unsigned n, unsigned s12,
                                        unsigned S2) {
  unsigned i = n / s12, r = n - i * s12;
  unsigned j = r / S2;
  Site s;
  s.n = n;
  s.i = i;
  s.j = j;
  s.k = r - j * S2;
  return s;
}

// E (fam 1) or H (fam 0) of every component at one site, and the ADE
template <bool NL>
__device__ __forceinline__ void eh_at(const Params& P, const Site& x) {
  float lin[NCOMP], fnew[NCOMP];
  eh_site<float, NL>(P, x.n, x.i, x.j, x.k, lin, fnew);
  pol_site<float>(P, x.n, lin, fnew);
}

// the family's sources at their sites, in source order per site
__device__ void sources_at(const ResArgs& A, const SrcFam& sf,
                           const Params& P, i64 s, unsigned tid,
                           unsigned nthr) {
  const float dt = (float)A.dt;
  const float* cur = (const float*)A.cur + s * A.nsrc * 2;
  const int* soff = (const int*)sf.slot_off;
  const int* sq = (const int*)sf.slot_q;
  const int* start = (const int*)sf.slot_start;
  const int* csrc = (const int*)sf.c_src;
  const float* cre = (const float*)sf.c_re;
  const float* cim = (const float*)sf.c_im;
  for (unsigned t = tid; t < (unsigned)sf.nslot; t += nthr) {
    float* f = (float*)P.curl[sq[t]].f;
    float v = f[soff[t]];
    for (int c = start[t]; c < start[t + 1]; ++c) {
      const float wre = cur[2 * csrc[c]], wim = cur[2 * csrc[c] + 1];
      v = v - (wre * cre[c] - wim * cim[c]) * dt;
    }
    f[soff[t]] = v;
  }
}

// the monitor's field value at region site (i, j, k): the centred average
// folded over its axes in order, 0.5 * (lower + upper) per axis, zero past
// the storage (step._region_values)
__device__ __forceinline__ float region_value(const DftM& d, const Params& P,
                                              i64 i, i64 j, i64 k) {
  const float* f = (const float*)d.f;
  float v[8];
  const int nc = 1 << d.navg;
  for (int c = 0; c < nc; ++c) {
    i64 ci = i, cj = j, ck = k;
    for (int b = 0; b < d.navg; ++b) {
      if (!((c >> b) & 1)) continue;
      if (d.avg[b] == 0) ++ci;
      else if (d.avg[b] == 1) ++cj;
      else ++ck;
    }
    v[c] = (ci < P.S0 && cj < P.S1 && ck < P.S2)
               ? f[(ci * P.S1 + cj) * P.S2 + ck]
               : 0.0f;
  }
  for (int m = 1; m <= d.navg; ++m)
    for (int c = 0; c < (nc >> m); ++c)
      v[c] = 0.5f * (v[2 * c] + v[2 * c + 1]);
  return v[0];
}

// phase 3: the DTFT update (acc += ph * w * fv, re and im rows) and the
// probe sums
template <bool PROBED>
__device__ void observe(const ResArgs& A, const Params& P, i64 s, bool dft,
                        unsigned tid, unsigned nthr) {
  if (dft) {
    for (int m = 0; m < A.ndft; ++m) {
      const DftM& d = A.dft[m];
      const float* phr = (const float*)d.phr + s * d.nfreq;
      const float* phi = (const float*)d.phi + s * d.nfreq;
      const unsigned n12 = (unsigned)(d.n[1] * d.n[2]);
      const unsigned n2 = (unsigned)d.n[2];
      for (unsigned r = tid; r < (unsigned)d.R; r += nthr) {
        unsigned a = r / n12, rem = r - a * n12;
        unsigned b = rem / n2, c = rem - b * n2;
        float fv = region_value(d, P, d.lo[0] + a, d.lo[1] + b, d.lo[2] + c);
        float cr = ((const float*)d.w)[r] * fv;
        float* acc = (float*)d.acc;
        for (int q = 0; q < d.nfreq; ++q) {
          float* re = acc + (2 * q) * d.R + r;
          float* im = re + d.R;
          *re = *re + phr[q] * cr;
          *im = *im + phi[q] * cr;
        }
      }
    }
  }
  if (PROBED) {
    for (unsigned p = tid; p < (unsigned)A.nprobe; p += nthr) {
      const ProbeR& pr = A.probe[p];
      const float* f = (const float*)pr.f;
      const int* off = (const int*)pr.off;
      const float* w = (const float*)pr.w;
      float v = 0.0f;
      for (int q = 0; q < pr.npts; ++q) v = v + f[off[q]] * w[q];
      ((float*)pr.out)[s] = v;
    }
  }
}

// NL: the E family carries chi3 / chi2-NR coefficients; PROBED: K4
template <bool NL, bool PROBED>
__global__ void __launch_bounds__(256) k3_kernel(const ResArgs* gA) {
  __shared__ ResArgs A;
  __shared__ i64 tabs[TAB_WORDS];
  {
    const i64* from = (const i64*)gA;
    i64* to = (i64*)&A;
    for (unsigned w = threadIdx.x; w < sizeof(ResArgs) / 8; w += blockDim.x)
      to[w] = from[w];
  }
  __syncthreads();
  {
    // the tables into shared memory when they fit; A then points there
    // (held in A, not in registers live across the step loop)
    const unsigned nd = (unsigned)A.ndft * (sizeof(DftM) / 8);
    const unsigned np = (unsigned)A.nprobe * (sizeof(ProbeR) / 8);
    if (nd + np <= TAB_WORDS) {
      for (unsigned w = threadIdx.x; w < nd; w += blockDim.x)
        tabs[w] = ((const i64*)A.dft)[w];
      for (unsigned w = threadIdx.x; w < np; w += blockDim.x)
        tabs[nd + w] = ((const i64*)A.probe)[w];
      __syncthreads();
      if (threadIdx.x == 0) {
        A.dft = (const DftM*)tabs;
        A.probe = (const ProbeR*)(tabs + nd);
      }
    }
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned nthr = gridDim.x * blockDim.x;
  const unsigned S2 = (unsigned)A.pb[0].S2;
  const unsigned s12 = (unsigned)A.pb[0].S1 * S2;
  const unsigned N = (unsigned)A.pb[0].S0 * s12;
  const int* flags = (const int*)A.flags;
  for (i64 s = 0; s < A.nsteps; ++s) {
    const Params& PB = A.pb[s & 1];
    const Params& PD = A.pd[s & 1];
    const int fl = flags[s];
    const bool bsrc = fl & STEP_BSRC, dsrc = fl & STEP_DSRC;
    // 1: B curl (+ H)
    for (unsigned n = tid; n < N; n += nthr) {
      Site x = site_of(n, s12, S2);
      for (int q = 0; q < PB.ncurl; ++q)
        curl_site<float, false>(PB.curl[q], PB, x.n, x.i, x.j, x.k);
      if (!bsrc) eh_at<false>(PB, x);
    }
    if (bsrc) {
      grid.sync();
      sources_at(A, A.src[0], PB, s, tid, nthr);
      grid.sync();
      for (unsigned n = tid; n < N; n += nthr) eh_at<false>(PB, site_of(n, s12, S2));
    }
    grid.sync();
    // 2: D curl (+ E)
    const bool fused = A.e_local && !dsrc;
    for (unsigned n = tid; n < N; n += nthr) {
      Site x = site_of(n, s12, S2);
      for (int q = 0; q < PD.ncurl; ++q)
        curl_site<float, true>(PD.curl[q], PD, x.n, x.i, x.j, x.k);
      if (fused) eh_at<NL>(PD, x);
    }
    if (!fused) {
      grid.sync();
      if (dsrc) {
        sources_at(A, A.src[1], PD, s, tid, nthr);
        grid.sync();
      }
      for (unsigned n = tid; n < N; n += nthr) eh_at<NL>(PD, site_of(n, s12, S2));
    }
    // 3: DTFT and probes
    const bool dft = fl & STEP_DFT;
    if (dft || PROBED) {
      grid.sync();
      observe<PROBED>(A, PD, s, dft, tid, nthr);
    }
    if (s + 1 < A.nsteps) grid.sync();
  }
}

static const void* kernel_of(int nl, int probed) {
  if (nl)
    return probed ? (const void*)k3_kernel<true, true>
                  : (const void*)k3_kernel<true, false>;
  return probed ? (const void*)k3_kernel<false, true>
                : (const void*)k3_kernel<false, false>;
}

static int max_blocks(int nl, int probed, int* out) {
  static int cached[2][2] = {{0, 0}, {0, 0}};
  if (!cached[nl][probed]) {
    int dev = 0, sms = 0, per = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, kernel_of(nl, probed), 256, 0);
    if (e != cudaSuccess) return (int)e;
    if (per < 1 || sms < 1) return (int)cudaErrorLaunchOutOfResources;
    cached[nl][probed] = per * sms;
  }
  *out = cached[nl][probed];
  return 0;
}

extern "C" {

i64 mnt_k3_args_size(void) { return (i64)sizeof(ResArgs); }

// the largest co-resident grid (blocks of 256 threads) of the variant
// (nl, probed), or -cudaError
int mnt_k3_max_blocks(int nl, int probed) {
  int blocks = 0;
  int rc = max_blocks(nl != 0, probed != 0, &blocks);
  return rc ? -rc : blocks;
}

// Launch the kernel cooperatively on `stream` over the argument block at
// device address `args` (`host` is the same block in host memory, read for
// the variant), with at most `blocks` blocks; the variant with the
// nonlinear branches when an E-family block carries chi3 / chi2-NR
// coefficients, the probed one (K4) when the block has probes.  Returns the
// cudaError of the first call that failed, else 0.
int mnt_k3_launch(const ResArgs* host, const void* args, int blocks,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  for (int par = 0; par < 2; ++par)
    if (has_nl(host->pb[par])) return (int)cudaErrorInvalidValue;
  const int nl = has_nl(host->pd[0]) ? 1 : 0;
  const int probed = host->nprobe > 0 ? 1 : 0;
  int most = 0;
  int rc = max_blocks(nl, probed, &most);
  if (rc) return rc;
  if (blocks < 1 || blocks > most) blocks = most;
  void* kargs[] = {(void*)&args};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel_of(nl, probed), dim3((unsigned)blocks), dim3(256), kargs, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
