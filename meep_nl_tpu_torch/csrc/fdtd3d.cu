// K1 on Hopper: one full 3D Yee step of the port's state layout, written
// by hand for sm_90a and bound through a plain C interface (ctypes).
//
// Replaces the TPU kernel meep_nl_tpu/ops/pallas/fdtd3d.py::_build_call
// (:554; Pallas body :846-1313, pallas_call :1343, driven by Fdtd3dKernel
// :1484).  It computes exactly meep_nl_tpu_torch/stepper/step.py::make_step
// without the DTFT update (ops/fdtd3d.py::step_ref, its plain version), in
// three launches per step:
//   K_B  B <- B - dt curl E through the uPML chains (f_u aux), the
//        H-family current sources, H <- W chain (u B);
//   K_D  D <- D + dt curl H through the chains, the E-family sources;
//   K_E  E <- chi1inv (D - sum P) with the chi3 Pade factor and the chi2
//        Newton-Raphson solve on the neighbour-averaged partner D - P, the
//        W chain, and the Lorentz/Drude ADE of P from the new E.
// The arithmetic is fdtd3d_site.cuh's value functions (curl_delta,
// curl_value, pade, nr_solve, w_value, ade_value), which K2 and K3/K4 run
// too, in the plain version's operation order and built without FMA
// contraction: the kernel agrees with step_ref bit for bit in fp32.
//
// What bounds it on the H100.  By its byte count, device memory:
// ops/fdtd3d.py::step_cost counts the step's own streams (each state array
// in and out once, but the old H only where its W chain runs, f_u and the
// slab-mode f_w on the PML slabs, the material windows and nreps on their
// support boxes): 0.1005 ms at the 128^3 flagship, 0.4892 ms at 255^3
// vacuum.  Each launch has its own floor (launch_cost): per site of the
// flagship about 15.7 values for K_B (E read, B in and out, H out, the
// slabs' f_u and W chain), 10.5 for K_D and 28.0 for K_E (D, u, E and f_w
// in and out, P, PP and the new P, sigma, nrchi2 and nreps on their box).
// Tensor cores do not apply (no matrix product), nor does TMA: a tensor map
// wants 16-byte global strides, and a storage row of 129 fp32 is 516
// bytes.  Hopper's asynchronous copies reach this kernel as 4- or 8-byte
// cp.async.  In practice the site work is bound by instructions and the
// dependency chain of one site per thread, not by the ring copies or the
// barriers: the launches reach about 40-75 % of their byte floors
// (PERF.md).
//
// Layout of work.  A block owns a (TY, TZ) tile of the y-z plane, k
// fastest (a warp reads one row of consecutive addresses), and marches
// along x over a chunk of `ch` planes; the wrapper picks ch so that there
// are several (tile, chunk) items for each SM.  What the stencil reads
// across threads lives in a ring of planes in dynamic shared memory:
//   K_B  the E planes i and i+1 with a +1 halo in y and z;
//   K_D  the H planes i-1 and i with a -1 halo (the fold ghost of a y or z
//        node mirror in the halo below plane 0, ring_issue);
//   K_E  D and each P of the planes i-1, i, i+1 with a +-1 halo, on the
//        planes of tiles that meet a nonlinear support box only.
// The next plane comes in by cp.async while this one computes; each thread
// copies its fixed ring positions (offsets worked out once per item).  What
// a site reads at its own position is loaded into registers a plane ahead
// (Own), so a plane's work waits for memory once.  The chain coefficients
// and alive factors along y and z are worked out once per item into the
// site's entries of a shared-memory table (Site), those along x a table of
// the chunk in shared memory.
// Read-after-write: K_B reads only E across sites and writes B, f_u, H and
// H's f_w; K_D reads only H across sites; K_E reads D - P across sites and
// writes E, f_w and PP (the new P goes to the PP buffer, the wrapper swaps
// the roles).  So halos are plain loads: no grid barrier.
//
// What the design does about the old kernel's costs:
//  1. flat one-thread-per-site indexing with 64-bit divisions: a thread's
//     j, k come from its block and lane, offsets are 32-bit (the wrapper
//     refuses a storage of 2^31 sites or more), and the fields the site
//     work reads are 32-bit copies (CurlC, EhC);
//  2. neighbour reads through the cache only: the ring serves the curl
//     partners and the chi2/chi3 four-site sums from shared memory;
//  3. per-site reloads of the chain vectors and alive vectors: loaded once
//     per item;
//  4. material coefficients read on the whole grid: nrchi2, chi2/chi3 and
//     each sigma are read only inside their support boxes (plan.
//     support_boxes).  Outside, the coefficient is zero and skipping it is
//     exact: sigma = 0 is passed as a value (the drive is the plain
//     version's zero), nrchi2 = 0 is the plain version's `where`, and the
//     Pade factor of chi2 = chi3 = 0 rounds to exactly 1;
//  5. one launch (with an atomicAdd) per current source: a site's sources
//     are added by the thread that owns it, from a per-(tile, plane) list
//     sorted by site and then in plan.sources order, after the masked curl
//     update and before H (or E) reads B (or D), as the plain version.
// The E launch runs the nonlinear code only on the planes of tiles that
// meet a box (a uniform per-block branch); one launch measured 10 % faster
// than a nonlinear launch over those tiles beside a linear one over the
// rest (PERF.md).  The three components' work is written without
// per-component branches, so their chains interleave, and each launch kind
// has its own register budget (min_blocks).  A plan with
// the standard uPML layout (PML on every axis: which partners, axes and
// chains each component has, u_ax1 ...) runs launches built with that
// layout as compile-time values (U); any other plan the general ones.  A
// plan with a y or z node mirror runs D launches built with the fold ghost
// (MIR), every other plan D launches built without it: built into every
// D launch, the ghost cost registers and spills (PERF.md).  A plan
// Bloch-periodic along x with a real phase ph (ops/periodicx.py) runs B
// and D launches built with the wrap (WRAP): the K_B ring's plane num is
// loaded as ph E(0), the K_D ring's plane -1 as (1 / ph) H(num - 1), where
// num is the live extent (step._sh).  Their chunks end at num, so those
// planes are loaded only where the last live plane reads forward or plane
// 0 backward; the dead planes num.. form chunks of their own, where K_D
// reads plane num - 1 as zero (the plain version's wrap fills the dead
// planes' neighbours with zeros) and K_B reads only dead planes, which the
// masks keep zero.  Complex fields stored as a real pair (a leading (re,
// im) channel axis; ops/periodicx.py's PairPeriodicXKernel) run the
// kernels built with the pair (PAIR): the channel is the grid's second
// dimension, channel 1 a storage's length past channel 0 in every state
// array (the coefficients are the channels' both), so one launch per
// sub-update steps both.  Where the B / D ring loads the wrapped plane, a
// complex phase ph = a + i b (A.wsc, A.wsci; 1 / ph for K_D) mixes the
// channels: channel 0 reads a own - b other, channel 1 b other + a own,
// other the partner channel's value (step._sh's rotation); channel 1's
// sources read the waveform rows swapped, (w_re, w_im) -> (w_im, -w_re),
// which gives Im(w amp).
//
// Left on the table: the compact D/B layout (E/H recomputed as u D outside
// the W slabs), P and PP stored on the dispersive box only, several steps
// per launch, specialising the site work further (the E launch's
// polarization and material structure, the layouts of partial PML).

// Host emulation: tile loads and site work are block-stride loops and the
// items a grid-stride loop, every cp.async has a plain-copy twin, and the
// launch goes through cudaLaunchKernel, so tests/cuda_stub runs this file
// as one thread of one block (tests/test_torch_fdtd3d_emul.py).

#include "fdtd3d_march.cuh"

// the y-z tile: TY rows (j) of TZ columns (k), one warp a row; another
// tile is a build option (-DK1_TY=.. -DK1_TZ=..), which the host emulation
// uses to put tile edges inside small grids
#ifndef K1_TY
#define K1_TY 8
#endif
#ifndef K1_TZ
#define K1_TZ 32
#endif
#define TY K1_TY
#define TZ K1_TZ
#define NT (TY * TZ)                  // sites of a tile plane
// sites a thread owns: one on the card; the host emulation runs one
// thread that owns them all
#ifdef MNT_CUDA_STUB
#define SPT NT
#else
#define SPT 1
#endif
#define NTHR (NT / SPT)               // threads per block
#define MAXRING (NCOMP * (1 + MAXPOL))
#define MAXSRC 32                     // waveforms passed by value
// the x vectors a block stages: kap sig siginv kapu sigu siginvu alive of
// each curl component, kapw sigw alive of each E/H component
#define NTAB_CURL (7 * NCOMP)
#define NTAB_EH (3 * NCOMP)

enum { K_B = 0, K_D = 1, K_E = 2 };

// Mirrored by meep_nl_tpu_torch/ops/fdtd3d.py (_K1Args).
struct K1Args {
  Params P;                           // the family's block (build_params)
  const void* ring[MAXRING];          // the arrays read across sites
  const void* src_ptr;                // int32 [tile * S0 + i] -> entries
  const void* src_key;                // int32 (local site << 2) | component
  const void* src_id;                 // int32 waveform index
  const void* src_amp;                // T (n, 2): amplitude re, im
  const void* wave_dev;               // double (nsrc, 2), or null: wave
  double wave[2 * MAXSRC];            // this step's waveforms (re, im)
  double dt;
  Box nl3[NCOMP], nlnr[NCOMP], pol[NCOMP][MAXPOL], nl;
  CurlC cc[NCOMP];
  EhC ec[NCOMP];
  int d_of[NCOMP];                    // K_B: curl index of H's B; K_E:
                                      // ring index of E's D
  int p_of[NCOMP][MAXPOL];            // K_E: ring index of each P (-1)
  int nring, S0, S1, S2, nty, ntz, ch, nch;
  // K_D: node mirrors (bit a - 1: a mirror plane at index 0 of axis a, 1 y
  // or 2 z) and, per ring array and axis, the fold ghost's row k0 and sign
  // (step.mirror_ghost): the halo row below plane 0 holds sign * g[k0]
  int mir;
  int mk0[MAXRING][2], msg[MAXRING][2];
  // K_B / K_D of an x-periodic plan (WRAP): the live extent along x (0:
  // no wrap) and the scale of the wrapped plane (K_B: ph, K_D: 1 / ph),
  // with its imaginary part (a real pair); wpair: a real pair's launch
  int wnum, wpair;
  double wsc, wsci;
};

#ifdef MNT_CUDA_STUB
#define K1_SMEM stub_dynamic_smem()
#else
extern __shared__ __align__(16) unsigned char k1_smem[];
#define K1_SMEM k1_smem
#endif

// ---- geometry -----------------------------------------------------------

// the plane ring of a launch kind: the halo below / above the tile in y and
// z, the slots, the positions a thread copies
template <int KIND>
struct Ring {
  static constexpr int LO = KIND == K_B ? 0 : 1;
  static constexpr int HI = KIND == K_D ? 0 : 1;
  static constexpr int NSLOT = KIND == K_E ? 4 : 3;
  static constexpr int RW = TZ + LO + HI;
  static constexpr int PW = RW * (TY + LO + HI);
  static constexpr int NPOS = (PW + NTHR - 1) / NTHR;
};

// the tiles and chunks that meet the union of the nonlinear boxes
struct Rect {
  int c0, c1, ty0, ty1, tz0, tz1;
};

__host__ __device__ inline Rect nl_rect(const K1Args& A) {
  Rect r = {0, 0, 0, 0, 0, 0};
  const Box& b = A.nl;
  if (b.lo[0] >= b.hi[0] || b.lo[1] >= b.hi[1] || b.lo[2] >= b.hi[2])
    return r;
  r.c0 = b.lo[0] / A.ch;
  r.c1 = (b.hi[0] - 1) / A.ch + 1;
  r.ty0 = b.lo[1] / TY;
  r.ty1 = (b.hi[1] - 1) / TY + 1;
  r.tz0 = b.lo[2] / TZ;
  r.tz1 = (b.hi[2] - 1) / TZ + 1;
  return r;
}

// a launch's (tile, chunk) items: K_E takes those that meet the nonlinear
// boxes first (the heaviest), then the others; the other kinds take them
// all in order.  Returns the count, and in *head how many of the first
// come from the boxes' rectangle.
template <int KIND, bool NL>
__host__ __device__ inline int item_count(const K1Args& A, int* head) {
  const Rect r = nl_rect(A);
  const int nr = (r.c1 - r.c0) * (r.ty1 - r.ty0) * (r.tz1 - r.tz0);
  *head = KIND == K_E && NL ? nr : 0;
  return *head + A.nch * A.nty * A.ntz;
}

template <int KIND>
__host__ __device__ inline int ntab() {
  return (KIND == K_E ? 0 : NTAB_CURL) + (KIND == K_D ? 0 : NTAB_EH);
}

// ---- what a site keeps along the march ------------------------------------

// the per-site factors that do not change along x: the chains along y or z
// (kms = kap - sig, rounded as the plain version's, and the slab rule),
// the alive factors of y and z.  The factors live in shared memory, one
// entry per site of the tile (NT apart): the W chain's kp, km (kapw +-
// sigw), me first (what K_E needs), then kms, siv, kmsu, sivu, mc; a site
// reads only its own entries.  Held in registers instead, they cost the
// curl launches registers and spills (PERF.md).
enum { F_KP = 0, F_KM = 1, F_ME = 2, F_KMS = 3, F_SIV = 4, F_KMSU = 5,
       F_SIVU = 6, F_MC = 7 };
template <int KIND>
__host__ __device__ constexpr int site_words() {
  return (KIND == K_E ? 3 : 8) * NCOMP * NT;
}

template <typename T>
struct Site {
  int jj, kk, j, k, n0;               // tile row and column, j * S2 + k
  bool ok;                            // inside the storage
  bool son[NCOMP], uon[NCOMP], won[NCOMP];
  T* v;                               // this site's entry of the factors
  __device__ __forceinline__ T& f(int field, int q) const {
    return v[(field * NCOMP + q) * NT];
  }
  __device__ __forceinline__ T& kms(int q) const { return f(F_KMS, q); }
  __device__ __forceinline__ T& siv(int q) const { return f(F_SIV, q); }
  __device__ __forceinline__ T& kmsu(int q) const { return f(F_KMSU, q); }
  __device__ __forceinline__ T& sivu(int q) const { return f(F_SIVU, q); }
  __device__ __forceinline__ T& mc(int q) const { return f(F_MC, q); }
  __device__ __forceinline__ T& kp(int q) const { return f(F_KP, q); }
  __device__ __forceinline__ T& km(int q) const { return f(F_KM, q); }
  __device__ __forceinline__ T& me(int q) const { return f(F_ME, q); }
};

template <typename T>
__device__ __forceinline__ T yz(const void* v, int ax, int j, int k) {
  return ((const T*)v)[ax == 1 ? j : k];
}

template <typename T>
__device__ __forceinline__ T alive_yz(const void* const alive[3], int j,
                                      int k) {
  T m = T(1);
  if (alive[1]) m = m * ((const T*)alive[1])[j];
  if (alive[2]) m = m * ((const T*)alive[2])[k];
  return m;
}

template <typename T, int KIND, bool U>
__device__ __forceinline__ void site_setup(const K1Args& A, Site<T>& s,
                                           T* sv, int t, int j0, int k0) {
  const Params& P = A.P;
  s.v = sv + t;
  s.jj = t / TZ;
  s.kk = t - s.jj * TZ;
  const int j = j0 + s.jj, k = k0 + s.kk;
  s.j = j;
  s.k = k;
  s.ok = j < A.S1 && k < A.S2;
  s.n0 = j * A.S2 + k;
  if (!s.ok) return;
  if (KIND != K_E) {
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      s.son[q] = s.uon[q] = false;
      s.kms(q) = s.siv(q) = s.kmsu(q) = s.sivu(q) = T(0);
      s.mc(q) = T(1);
      if (q >= P.ncurl) continue;
      const CurlP& c = P.curl[q];
      const CurlC& cc = A.cc[q];
      const int ax = U ? u_ax1(q) : cc.sax, axu = U ? u_ax2(q) : cc.uax;
      if (ax > 0) {
        s.kms(q) = yz<T>(c.kap, ax, j, k) - yz<T>(c.sig, ax, j, k);
        s.siv(q) = yz<T>(c.siginv, ax, j, k);
        s.son[q] = in_rule(ax == 1 ? j : k, cc.s_lo, cc.s_hi0, cc.s_n);
      }
      if (axu > 0) {
        s.kmsu(q) = yz<T>(c.kapu, axu, j, k) - yz<T>(c.sigu, axu, j, k);
        s.sivu(q) = yz<T>(c.siginvu, axu, j, k);
        s.uon[q] = in_rule(axu == 1 ? j : k, cc.u_lo, cc.u_hi0, cc.u_n);
      }
      s.mc(q) = alive_yz<T>(c.alive, j, k);
    }
  }
  if (KIND != K_D) {
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      s.won[q] = false;
      s.kp(q) = s.km(q) = T(0);
      s.me(q) = T(1);
      if (q >= P.neh) continue;
      const EhP& e = P.eh[q];
      const EhC& ec = A.ec[q];
      const int ax = U ? q : ec.wax;
      if (ax > 0) {
        const T kw = yz<T>(e.kapw, ax, j, k), sw = yz<T>(e.sigw, ax, j, k);
        s.kp(q) = kw + sw;
        s.km(q) = kw - sw;
        s.won[q] = in_rule(ax == 1 ? j : k, ec.w_lo, ec.w_hi0, ec.w_n);
      }
      s.me(q) = alive_yz<T>(e.alive, j, k);
    }
  }
}

// the chunk's x vectors in shared memory (L = ch entries each): curl
// components first (K_B, K_D), then E/H components (K_B, K_E); a vector
// along another axis is not staged, a null alive vector reads 1
template <typename T, int KIND>
__device__ __forceinline__ void load_tables(const K1Args& A, T* tab, int i0,
                                            int tid) {
  const Params& P = A.P;
  constexpr int NC = KIND == K_E ? 0 : NTAB_CURL;
  const int L = A.ch;
  for (int e = tid; e < ntab<KIND>() * L; e += NTHR) {
    const int d = e / L, l = e - d * L, i = i0 + l;
    const void* src = nullptr;
    if (d < NC) {
      const int q = d / 7, m = d - 7 * q;
      if (q < P.ncurl) {
        const CurlP& c = P.curl[q];
        if (m < 3 && A.cc[q].sax == 0)
          src = m == 0 ? c.kap : (m == 1 ? c.sig : c.siginv);
        else if (m >= 3 && m < 6 && A.cc[q].uax == 0)
          src = m == 3 ? c.kapu : (m == 4 ? c.sigu : c.siginvu);
        else if (m == 6)
          src = c.alive[0];
      }
    } else {
      const int q = (d - NC) / 3, m = d - NC - 3 * q;
      if (q < P.neh) {
        const EhP& h = P.eh[q];
        if (m < 2 && A.ec[q].wax == 0) src = m == 0 ? h.kapw : h.sigw;
        else if (m == 2) src = h.alive[0];
      }
    }
    const bool alive = d < NC ? (d % 7 == 6) : ((d - NC) % 3 == 2);
    tab[e] = (src && i < A.S0) ? ((const T*)src)[i] : T(alive ? 1 : 0);
  }
}

// a thread's ring positions: their offsets in a ring plane and in a
// storage plane, whether they lie inside the storage, and (K_D) whether
// they hold a mirror's fold ghost (0: no, 1 + a: the ghost of axis 1 + a)
template <int KIND>
struct RingPos {
  int o[Ring<KIND>::NPOS], g[Ring<KIND>::NPOS];
  bool ok[Ring<KIND>::NPOS];
  int gh[Ring<KIND>::NPOS];
};

template <int KIND, bool MIR>
__device__ __forceinline__ void ring_setup(const K1Args& A,
                                           RingPos<KIND>& rp, int tid,
                                           int j0, int k0) {
  typedef Ring<KIND> G;
#pragma unroll
  for (int u = 0; u < G::NPOS; ++u) {
    const int o = tid + u * NTHR;
    const int rj = o / G::RW, rk = o - rj * G::RW;
    const int j = j0 - G::LO + rj, k = k0 - G::LO + rk;
    rp.o[u] = o < G::PW ? o : -1;
    rp.ok[u] = o < G::PW && j >= 0 && j < A.S1 && k >= 0 && k < A.S2;
    rp.g[u] = j * A.S2 + k;
    if constexpr (MIR) {
      rp.gh[u] = 0;
      if ((A.mir & 1) && j == -1 && k >= 0 && k < A.S2) rp.gh[u] = 1;
      if ((A.mir & 2) && k == -1 && j >= 0 && j < A.S1) rp.gh[u] = 2;
    }
  }
}

// issue the copies of plane p of every ring array into its slot; sites
// outside the storage read zero (the plain version's zero fill), except
// the halo row below a mirror plane (K_D), which reads the fold ghost
// sign * g[k0] of the same plane, stored directly (the slot is read after
// the plane's barrier).  Only the tiles at a plane have such positions.
// WRAP: in a live chunk K_B's plane num is wsc * plane 0 and K_D's plane
// -1 is wsc * plane num - 1, stored directly; in a dead chunk (`dead`)
// K_D's plane num - 1 is zero.  PAIR: the arrays of channel `ch`, co
// elements on; the wrapped plane times the complex wsc + i wsci, whose
// product mixes in the partner channel
template <typename T, int KIND, bool MIR, bool WRAP, bool PAIR = false>
__device__ __forceinline__ void ring_issue(const K1Args& A,
                                           const RingPos<KIND>& rp, T* ring,
                                           int p, bool dead, int co = 0,
                                           int ch = 0) {
  typedef Ring<KIND> G;
  T* slot = ring + ((p + G::NSLOT) % G::NSLOT) * A.nring * G::PW;
  int q = p;
  bool wrapped = false, zero = false;
  if (WRAP) {
    if (KIND == K_B && !dead && p == A.wnum) q = 0, wrapped = true;
    if (KIND == K_D && !dead && p == -1) q = A.wnum - 1, wrapped = true;
    if (KIND == K_D && dead && p == A.wnum - 1) zero = true;
  }
  const bool pin = !zero && q >= 0 && q < A.S0;
  const int base = q * A.S1 * A.S2;
  for (int r = 0; r < A.nring; ++r) {
    const T* src = (const T*)A.ring[r] + base + (PAIR ? co : 0);
    T* dst = slot + r * G::PW;
#pragma unroll
    for (int u = 0; u < G::NPOS; ++u) {
      if (rp.o[u] < 0) continue;
      if (PAIR && WRAP && wrapped && rp.ok[u] && A.wsci != 0.0) {
        const int po = ch ? -A.S0 * A.S1 * A.S2 : A.S0 * A.S1 * A.S2;
        const T own = src[rp.g[u]], other = src[rp.g[u] + po];
        const T a = T(A.wsc), b = T(A.wsci);
        dst[rp.o[u]] = ch ? b * other + a * own : a * own - b * other;
      } else if (WRAP && wrapped && rp.ok[u]) {
        dst[rp.o[u]] = T(A.wsc) * src[rp.g[u]];
      } else if (pin && rp.ok[u]) {
        cp_async<T>(dst + rp.o[u], src + rp.g[u]);
      } else if (MIR && pin && rp.gh[u]) {
        const int a = rp.gh[u] - 1;
        dst[rp.o[u]] = T(A.msg[r][a]) *
                       src[rp.g[u] + (1 + A.mk0[r][a]) * (a ? 1 : A.S2)];
      } else {
        dst[rp.o[u]] = T(0);
      }
    }
  }
}

// ---- what a site reads at its own position --------------------------------

// The operands a site reads at its own position in one plane: loaded a plane
// ahead (the loads of plane i + 1 are in flight while plane i computes), so
// that a plane's site work waits for memory once, not once per array.
// K_B / K_D: f = the D/B component, fu its f_u, and (K_B) u, wf, ww the H
// component's u, f and f_w; K_E: f = D, p / pp each polarization's P and
// PP, sg its sigma, u, wf, ww E's u, f and f_w.  NP: the polarizations a
// site holds (a compile-time bound on P.npol).
template <typename T, int NP>
struct Own {
  T f[NCOMP], fu[NCOMP], u[NCOMP], wf[NCOMP], ww[NCOMP];
  T p[NCOMP][NP], pp[NCOMP][NP], sg[NCOMP][NP];
  bool uon[NCOMP], won[NCOMP];
  int sa, sb;                         // the site's source list range
};

// whether E/H component q (its W chain along wax) runs the chain at plane i
__device__ __forceinline__ bool w_on(const EhC& ec, int wax, bool won_yz,
                                     int i) {
  if (wax == 0) return in_rule(i, ec.w_lo, ec.w_hi0, ec.w_n);
  return wax > 0 && won_yz;
}

// co: a real pair's channel offset of the state arrays (the coefficients
// are the channels' both)
template <typename T, int KIND, int NP, bool U>
__device__ __forceinline__ void own_load(const K1Args& A, const Site<T>& s,
                                         int i, int tile, Own<T, NP>& o,
                                         int co = 0) {
  const Params& P = A.P;
  const int n = i * A.S1 * A.S2 + s.n0;
  const int ns = n + co;
  if (KIND != K_E) {
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      const CurlP& c = P.curl[q];
      const CurlC& cc = A.cc[q];
      const bool has = q < P.ncurl;
      const int uax = U ? u_ax2(q) : cc.uax;
      bool uon = false;
      if (has && uax == 0)
        uon = in_rule(i, cc.u_lo, cc.u_hi0, cc.u_n);
      else if (has && uax > 0)
        uon = s.uon[q];
      o.uon[q] = uon;
      o.f[q] = has ? ((const T*)c.f)[ns] : T(0);
      o.fu[q] = uon ? ((const T*)c.fu)[ns] : T(0);
    }
  }
  if (KIND != K_D) {
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      const EhP& e = P.eh[q];
      const EhC& ec = A.ec[q];
      const bool has = q < P.neh;
      const bool won = has && w_on(ec, U ? q : ec.wax, s.won[q], i);
      o.won[q] = won;
      o.u[q] = has && ec.has_u ? ((const T*)e.u)[n] : T(1);
      o.wf[q] = won ? ((const T*)e.f)[ns] : T(0);
      o.ww[q] = won ? ((const T*)e.fw)[ns] : T(0);
      if (KIND == K_E) {
        o.f[q] = has ? ((const T*)e.d)[ns] : T(0);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const PolC& pc = e.pol[p];
          const bool on = has && ((ec.pols >> p) & 1);
          o.p[q][p] = on ? ((const T*)pc.p)[ns] : T(0);
          o.pp[q][p] = on ? ((const T*)pc.pp)[ns] : T(0);
          o.sg[q][p] = on && in_box(A.pol[q][p], i, s.j, s.k)
                           ? ((const T*)pc.sigma)[n]
                           : T(0);
        }
      }
    }
  }
  o.sa = o.sb = 0;
  if (KIND != K_E && A.src_ptr) {
    o.sa = ((const int*)A.src_ptr)[tile * A.S0 + i];
    o.sb = ((const int*)A.src_ptr)[tile * A.S0 + i + 1];
  }
}

// ---- sources ------------------------------------------------------------

// the current sources of entries [a, b) (the site's tile plane) at site
// (jj, kk) into the new D/B values f[q]: f - current * dt per entry, in
// plan.sources order; im: a real pair's channel 1, the waveform rows
// swapped, (w_re, w_im) -> (w_im, -w_re)
template <typename T>
__device__ __forceinline__ void add_sources(const K1Args& A, int a, int b,
                                            int jj, int kk, T* f,
                                            bool im = false) {
  if (a == b) return;
  const int* key = (const int*)A.src_key;
  const int me = (jj * TZ + kk) << 2;
  int lo = a, hi = b;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((key[mid] & ~3) < me) lo = mid + 1;
    else hi = mid;
  }
  const T* amp = (const T*)A.src_amp;
  const double* wv = A.wave_dev ? (const double*)A.wave_dev : A.wave;
  for (int e = lo; e < b && (key[e] & ~3) == me; ++e) {
    const int s = ((const int*)A.src_id)[e];
    const T wre = im ? T(wv[2 * s + 1]) : T(wv[2 * s]);
    const T wim = im ? -T(wv[2 * s]) : T(wv[2 * s + 1]);
    const T add = -source_amp<T>(amp, amp + 1, 2 * e, wre, wim, T(A.dt));
    const int q = key[e] & 3;
#pragma unroll
    for (int qq = 0; qq < NCOMP; ++qq)
      if (qq == q) f[qq] = f[qq] + add;
  }
}

// ---- K_B and K_D: the curl half ------------------------------------------

// the difference of ring array r along axis ax at the site: K_D backward
// (g - g[-1]), K_B forward (g[+1] - g); `here` points at the site in the
// plane's slot, `xnb` at it in the x-neighbour plane's slot; r < 0: none.
// Written without branches, like the rest of the site work, so that the
// three components' dependency chains interleave.
template <typename T, int KIND>
__device__ __forceinline__ T ring_diff(const T* here, const T* xnb, int r,
                                       int ax) {
  typedef Ring<KIND> G;
  const int rr = (r < 0 ? 0 : r) * G::PW;
  const int st = (ax == 1 ? G::RW : 1) * (KIND == K_D ? -1 : 1);
  const T g = here[rr];
  const T nb = ax == 0 ? xnb[rr] : here[rr + st];
  const T d = KIND == K_D ? g - nb : nb - g;
  return r < 0 ? T(0) : d;
}

// the W chain's inputs of E/H component q at the site, and its mask
template <typename T, int NP, bool U>
__device__ __forceinline__ WIn<T> w_in(const EhC& ec, const Site<T>& s,
                                       const Own<T, NP>& o, const T* tq,
                                       int L, int xl, int q) {
  WIn<T> w;
  const bool x = (U ? q : ec.wax) == 0;
  const T kw = tq[xl], sw = tq[L + xl];
  w.on = o.won[q];
  w.kp = x ? kw + sw : s.kp(q);
  w.km = x ? kw - sw : s.km(q);
  w.f = o.wf[q];
  w.fw = o.ww[q];
  w.mask = tq[2 * L + xl] * s.me(q);
  return w;
}

// one site of a curl launch: the masked curl update of every D/B component
// with its sources, and for K_B the H update from the new B.  A component
// the plan lacks (q >= ncurl) computes on zeros and stores nothing.
template <typename T, int KIND, int NP, bool U>
__device__ __forceinline__ void curl_site_k1(const K1Args& A, const T* tab,
                                             const T* ring, const Site<T>& s,
                                             const Own<T, NP>& ow, int i,
                                             int xl, int sh, int sx,
                                             int co = 0, int ch = 0) {
  typedef Ring<KIND> G;
  const Params& P = A.P;
  const int L = A.ch;
  const int n = i * A.S1 * A.S2 + s.n0 + co;
  const int o = (s.jj + G::LO) * G::RW + s.kk + G::LO;
  const T* here = ring + sh * A.nring * G::PW + o;
  const T* xnb = ring + sx * A.nring * G::PW + o;
  const T csgn = T(P.csgn);
  T fnew[NCOMP], fun[NCOMP];
#pragma unroll
  for (int q = 0; q < NCOMP; ++q) {
    const CurlC& cc = A.cc[q];
    const int gp = U ? u_gp(q) : cc.gp, gm = U ? u_gm(q) : cc.gm;
    const int sax = U ? u_ax1(q) : cc.sax;
    const T dfl = curl_delta<T>(
        gp >= 0, ring_diff<T, KIND>(here, xnb, gp, U ? u_ax1(q) : cc.ap),
        gm >= 0, ring_diff<T, KIND>(here, xnb, gm, U ? u_ax2(q) : cc.am),
        csgn);
    const T* tq = tab + 7 * q * L;
    const bool xs = sax == 0, xu = (U ? u_ax2(q) : cc.uax) == 0;
    const bool sig_on = xs ? in_rule(i, cc.s_lo, cc.s_hi0, cc.s_n)
                           : s.son[q];
    const T kms = xs ? tq[xl] - tq[L + xl] : s.kms(q);
    const T siv = xs ? tq[2 * L + xl] : s.siv(q);
    const T kmsu = xu ? tq[3 * L + xl] - tq[4 * L + xl] : s.kmsu(q);
    const T sivu = xu ? tq[5 * L + xl] : s.sivu(q);
    fun[q] = T(0);
    fnew[q] = curl_value<T>(ow.f[q], dfl, sax >= 0, sig_on, kms, siv,
                            ow.uon[q], kmsu, sivu, ow.fu[q], &fun[q]) *
              (tq[6 * L + xl] * s.mc(q));
  }
  add_sources<T>(A, ow.sa, ow.sb, s.jj, s.kk, fnew, ch != 0);
  T lin[NCOMP];
  WIn<T> w[NCOMP];
  if (KIND == K_B) {
    // H from the new B
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      T gs = T(0);
#pragma unroll
      for (int qq = 0; qq < NCOMP; ++qq)
        if (qq == A.d_of[q]) gs = fnew[qq];
      lin[q] = A.ec[q].has_u ? gs * ow.u[q] : gs;
      w[q] = w_in<T, NP, U>(A.ec[q], s, ow, tab + (NTAB_CURL + 3 * q) * L,
                            L, xl, q);
    }
  }
#pragma unroll
  for (int q = 0; q < NCOMP; ++q) {
    if (q >= P.ncurl) continue;
    if (ow.uon[q]) ((T*)P.curl[q].fu)[n] = fun[q];
    ((T*)P.curl[q].f)[n] = fnew[q];
  }
  if (KIND == K_B) {
#pragma unroll
    for (int q = 0; q < NCOMP; ++q)
      if (q < P.neh) w_store<T>(P.eh[q], n, lin[q], w[q]);
  }
}

// ---- K_E: E from D - P, the W chain, the ADE -----------------------------

// D - P of E component qq at ring position o of slot `sl` (D, then each P in pole order)
template <typename T>
__device__ __forceinline__ T ring_dmp(const K1Args& A, const T* ring, int sl,
                                      int qq, int o) {
  typedef Ring<K_E> G;
  const T* base = ring + sl * A.nring * G::PW + o;
  T v = base[A.d_of[qq] * G::PW];
  for (int p = 0; p < A.P.npol; ++p)
    if (A.p_of[qq][p] >= 0) v = v - base[A.p_of[qq][p] * G::PW];
  return v;
}

// step._sum4 of E component qq's D - P around the site: g, g one site along
// `own` (sign +1, the E family), one site back along `off`, and both
template <typename T>
__device__ __forceinline__ T ring_sum4(const K1Args& A, const T* ring, int i,
                                       int o, int qq, int own, int off) {
  typedef Ring<K_E> G;
  const int s = (int)A.P.sgn;
  const int st_own = own == 0 ? 0 : (own == 1 ? G::RW : 1);
  const int st_off = off == 0 ? 0 : (off == 1 ? G::RW : 1);
  const int si = i % G::NSLOT;
  const int so = (i + (own == 0 ? s : 0) + G::NSLOT) % G::NSLOT;
  const int sf = (i - (off == 0 ? s : 0) + G::NSLOT) % G::NSLOT;
  const int ssf = (i + (own == 0 ? s : 0) - (off == 0 ? s : 0) + G::NSLOT) %
                  G::NSLOT;
  const T g = ring_dmp<T>(A, ring, si, qq, o);
  const T gs = ring_dmp<T>(A, ring, so, qq, o + s * st_own);
  const T gx = ring_dmp<T>(A, ring, sf, qq, o - s * st_off);
  const T gsx = ring_dmp<T>(A, ring, ssf, qq, o + s * st_own - s * st_off);
  return g + gs + gx + gsx;
}

template <typename T, bool NL, int NP, bool U>
__device__ __forceinline__ void e_site(const K1Args& A, const T* tab,
                                       const T* ring, const Site<T>& s,
                                       const Own<T, NP>& ow, bool nlp, int i,
                                       int xl, int co = 0) {
  typedef Ring<K_E> G;
  const Params& P = A.P;
  const int L = A.ch;
  const int n = i * A.S1 * A.S2 + s.n0;
  const int ns = n + co;
  const int o = (s.jj + 1) * G::RW + s.kk + 1;
  const int j = s.j, k = s.k;
  T lin[NCOMP], fnew[NCOMP];
  // lin: chi1inv (D - P), the Pade factor and the NR solve in their boxes
#pragma unroll
  for (int q = 0; q < NCOMP; ++q) {
    const EhP& e = P.eh[q];
    const EhC& ec = A.ec[q];
    T gs = ow.f[q];
#pragma unroll
    for (int p = 0; p < NP; ++p)
      if ((ec.pols >> p) & 1) gs = gs - ow.p[q][p];
    const T us = ow.u[q];
    T l = ec.has_u ? gs * us : gs;
    if (NL && nlp && q < P.neh) {
      if (e.chi3 && in_box(A.nl3[q], i, j, k)) {
        T Dsqr = gs * gs;
        if (e.dc1 >= 0)
          Dsqr = dsqr_add<T>(Dsqr, ring_sum4<T>(A, ring, i, o, (int)e.dc1,
                                                (int)e.ax_own, (int)e.ax_1));
        if (e.dc2 >= 0)
          Dsqr = dsqr_add<T>(Dsqr, ring_sum4<T>(A, ring, i, o, (int)e.dc2,
                                                (int)e.ax_own, (int)e.ax_2));
        l = pade<T>(l, gs, Dsqr, ((const T*)e.chi2)[n],
                    ((const T*)e.chi3)[n], us);
      }
      if (e.nrchi2 && in_box(A.nlnr[q], i, j, k)) {
        const T chi2 = ((const T*)e.nrchi2)[n];
        if (chi2 != T(0)) {
          const T g1 = e.dc1 >= 0
                           ? T(0.25) * ring_sum4<T>(A, ring, i, o, (int)e.dc1,
                                                    (int)e.ax_own,
                                                    (int)e.ax_1)
                           : T(0);
          const T g2 = e.dc2 >= 0
                           ? T(0.25) * ring_sum4<T>(A, ring, i, o, (int)e.dc2,
                                                    (int)e.ax_own,
                                                    (int)e.ax_2)
                           : T(0);
          l = nr_solve<T>(gs, g1, g2, ((const T*)e.nreps)[n], chi2,
                          P.nr_iters);
        }
      }
    }
    lin[q] = l;
  }
  // the W chain, the mask, the stores
  WIn<T> w[NCOMP];
#pragma unroll
  for (int q = 0; q < NCOMP; ++q) {
    w[q] = w_in<T, NP, U>(A.ec[q], s, ow, tab + 3 * q * L, L, xl, q);
    fnew[q] = w_value<T>(lin[q], w[q]);
  }
#pragma unroll
  for (int q = 0; q < NCOMP; ++q) {
    if (q >= P.neh) continue;
    if (w[q].on) ((T*)P.eh[q].fw)[ns] = lin[q];
    ((T*)P.eh[q].f)[ns] = fnew[q];
  }
  // the ADE into the PP buffers
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if (p >= P.npol) continue;
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      if (q >= P.neh || !((A.ec[q].pols >> p) & 1)) continue;
      const PolC& pc = P.eh[q].pol[p];
      const T W = (U || A.ec[q].wax >= 0) ? lin[q] : fnew[q];
      ((T*)pc.pp)[ns] =
          ade_value<T>(P, p, W, ow.sg[q][p], ow.p[q][p], ow.pp[q][p]);
    }
  }
}

// ---- the x-march of one item -----------------------------------------------

// K_B reads the ring planes i and i+1 (and brings in i+2), K_D the planes
// i-1 and i (brings in i+1); the own-site operands of plane i+1 are loaded
// after plane i's site work; PAIR: channel `ch` of a real pair, whose
// state arrays lie co elements on
template <typename T, int KIND, int NP, bool U, bool MIR, bool WRAP,
          bool PAIR = false>
__device__ __forceinline__ void march_curl(const K1Args& A, const T* tab,
                                           T* ring, const Site<T>* s,
                                           Own<T, NP>* ow,
                                           const RingPos<KIND>& rp, int tile,
                                           int i0, int i1, int co = 0,
                                           int ch = 0) {
  constexpr int AHEAD = KIND == K_B ? 2 : 1;
  const int last = KIND == K_B ? i1 : i1 - 1;     // the last plane read
  const bool dead = WRAP && i0 >= A.wnum;
  ring_issue<T, KIND, MIR, WRAP, PAIR>(A, rp, ring, i0 + AHEAD - 2, dead,
                                       co, ch);
  cp_commit();
  ring_issue<T, KIND, MIR, WRAP, PAIR>(A, rp, ring, i0 + AHEAD - 1, dead,
                                       co, ch);
  cp_commit();
#pragma unroll
  for (int m = 0; m < SPT; ++m)
    if (s[m].ok) own_load<T, KIND, NP, U>(A, s[m], i0, tile, ow[m], co);
  for (int i = i0; i < i1; ++i) {
    if (i + AHEAD <= last)
      ring_issue<T, KIND, MIR, WRAP, PAIR>(A, rp, ring, i + AHEAD, dead, co,
                                           ch);
    cp_commit();
    cp_wait1();
    __syncthreads();
    const int sh = i % 3;
    const int sx = (i + (KIND == K_B ? 1 : 2)) % 3;
#pragma unroll
    for (int m = 0; m < SPT; ++m)
      if (s[m].ok)
        curl_site_k1<T, KIND, NP, U>(A, tab, ring, s[m], ow[m], i, i - i0,
                                     sh, sx, co, ch);
    if (i + 1 < i1) {
#pragma unroll
      for (int m = 0; m < SPT; ++m)
        if (s[m].ok)
          own_load<T, KIND, NP, U>(A, s[m], i + 1, tile, ow[m], co);
    }
    __syncthreads();
  }
}

// the planes [xa, xb) of the item that meet the nonlinear boxes read the
// neighbours' D - P from the ring (planes i-1, i, i+1; bring in i+2)
template <typename T, bool NL, int NP, bool U>
__device__ __forceinline__ void march_e(const K1Args& A, const T* tab,
                                        T* ring, const Site<T>* s,
                                        Own<T, NP>* ow,
                                        const RingPos<K_E>& rp, int i0,
                                        int i1, int j0, int k0, int co = 0) {
  int xa = i1, xb = i1;
  const Box& b = A.nl;
  if (NL && b.lo[1] < j0 + TY && b.hi[1] > j0 && b.lo[2] < k0 + TZ &&
      b.hi[2] > k0) {
    xa = b.lo[0] > i0 ? b.lo[0] : i0;
    xb = b.hi[0] < i1 ? b.hi[0] : i1;
    if (xa >= xb) xa = xb = i1;
  }
  if (xa < xb) {
    for (int p = xa - 1; p <= xa + 1; ++p) {
      ring_issue<T, K_E, false, false>(A, rp, ring, p, false);
      cp_commit();
    }
  }
#pragma unroll
  for (int m = 0; m < SPT; ++m)
    if (s[m].ok) own_load<T, K_E, NP, U>(A, s[m], i0, 0, ow[m], co);
  __syncthreads();                              // the tables
  for (int i = i0; i < i1; ++i) {
    const bool nlp = i >= xa && i < xb;
    if (nlp) {
      if (i + 2 <= xb)
        ring_issue<T, K_E, false, false>(A, rp, ring, i + 2, false);
      cp_commit();
      cp_wait1();
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < SPT; ++m)
      if (s[m].ok) e_site<T, NL, NP, U>(A, tab, ring, s[m], ow[m], nlp, i,
                                        i - i0, co);
    if (i + 1 < i1) {
#pragma unroll
      for (int m = 0; m < SPT; ++m)
        if (s[m].ok) own_load<T, K_E, NP, U>(A, s[m], i + 1, 0, ow[m], co);
    }
    if (nlp) __syncthreads();
  }
}

// ---- the kernel ---------------------------------------------------------

// blocks an SM should hold, the register budget of __launch_bounds__, per
// launch kind: 3 for K_B and the nonlinear K_E, 4 for the linear K_E, 5
// for K_D (the fastest of the budgets measured on the H100, PERF.md)
template <int KIND, bool NL>
constexpr int min_blocks() {
  return KIND == K_B ? 3 : (KIND == K_D ? 5 : (NL ? 3 : 4));
}

// the x-planes [i0, i1) of chunk c: WRAP (K_B, K_D of an x-periodic plan)
// cuts the live planes [0, wnum) and the dead ones [wnum, S0) into chunks
// of their own
template <bool WRAP>
__device__ __forceinline__ void chunk_planes(const K1Args& A, int c,
                                             int* i0, int* i1) {
  int lo = 0, hi = A.S0, cc = c;
  if (WRAP) {
    const int nlive = (A.wnum + A.ch - 1) / A.ch;
    if (c < nlive) hi = A.wnum;
    else lo = A.wnum, cc = c - nlive;
  }
  *i0 = lo + cc * A.ch;
  *i1 = *i0 + A.ch < hi ? *i0 + A.ch : hi;
}

// NL (K_E only): the nonlinear code is compiled in, for plans with a
// nonlinear box; NP: the polarizations a site holds (K_E: 1 or MAXPOL);
// U: the plan has the standard uPML layout (u_ax1 ...); MIR (K_D): the
// node-mirror ghost; WRAP (K_B, K_D): the x Bloch wrap; PAIR: channel
// `pch` of a real pair (k1_pair_kernel)
template <typename T, int KIND, bool NL, int NP, bool U, bool MIR,
          bool WRAP, bool PAIR>
__device__ __forceinline__ void k1_body(const K1Args& A, int pch) {
  const int co = PAIR ? pch * A.S0 * A.S1 * A.S2 : 0;
  T* tab = (T*)K1_SMEM;
  T* sv = tab + ntab<KIND>() * A.ch;
  T* ring = sv + site_words<KIND>();
  const int tid = threadIdx.x;
  const Rect rc = nl_rect(A);
  const int rz = rc.tz1 - rc.tz0, ry = rc.ty1 - rc.ty0;
  int head;
  const int nitems = item_count<KIND, NL>(A, &head);
  Site<T> s[SPT];
  Own<T, NP> ow[SPT];
  RingPos<KIND> rp;
  for (int w = blockIdx.x; w < nitems; w += gridDim.x) {
    int tz, ty, c;
    if (w < head) {
      tz = rc.tz0 + w % rz;
      ty = rc.ty0 + (w / rz) % ry;
      c = rc.c0 + w / (rz * ry);
    } else {
      const int v = w - head;
      tz = v % A.ntz;
      ty = (v / A.ntz) % A.nty;
      c = v / (A.ntz * A.nty);
      if (KIND == K_E && c >= rc.c0 && c < rc.c1 && ty >= rc.ty0 &&
          ty < rc.ty1 && tz >= rc.tz0 && tz < rc.tz1)
        continue;
    }
    int i0, i1;
    chunk_planes<WRAP>(A, c, &i0, &i1);
    const int j0 = ty * TY, k0 = tz * TZ;
    __syncthreads();                  // the last item's readers are done
    load_tables<T, KIND>(A, tab, i0, tid);
#pragma unroll
    for (int m = 0; m < SPT; ++m)
      site_setup<T, KIND, U>(A, s[m], sv, tid + m * NTHR, j0, k0);
    ring_setup<KIND, MIR>(A, rp, tid, j0, k0);
    if constexpr (KIND == K_E)
      march_e<T, NL, NP, U>(A, tab, ring, s, ow, rp, i0, i1, j0, k0, co);
    else
      march_curl<T, KIND, NP, U, MIR, WRAP, PAIR>(
          A, tab, ring, s, ow, rp, ty * A.ntz + tz, i0, i1, co, pch);
  }
}

template <typename T, int KIND, bool NL, int NP, bool U, bool MIR,
          bool WRAP>
__global__ void __launch_bounds__(NTHR, (min_blocks<KIND, NL>()))
k1_kernel(const __grid_constant__ K1Args A) {
  k1_body<T, KIND, NL, NP, U, MIR, WRAP, false>(A, 0);
}

// a real pair's launch: the channel is blockIdx.y; K_B and K_D read across
// the x wrap (the pair drivers are x-periodic), nothing is nonlinear
template <typename T, int KIND, int NP, bool U>
__global__ void __launch_bounds__(NTHR, (min_blocks<KIND, false>()))
k1_pair_kernel(const __grid_constant__ K1Args A) {
  k1_body<T, KIND, false, NP, U, false, KIND != K_E, true>(A,
                                                           (int)blockIdx.y);
}

// dynamic shared memory of a launch: the x tables and the ring
template <typename T, int KIND, bool NL>
static size_t smem_bytes(const K1Args& A) {
  typedef Ring<KIND> G;
  const size_t ring = (KIND == K_E && !NL) ? 0 : G::NSLOT * A.nring * G::PW;
  return ((size_t)ntab<KIND>() * A.ch + site_words<KIND>() + ring) *
         sizeof(T);
}

template <typename T, int KIND, bool NL, int NP, bool U, bool MIR,
          bool WRAP>
static int launch_kind(const K1Args* a, cudaStream_t s) {
  const size_t smem = smem_bytes<T, KIND, NL>(*a);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        k1_kernel<T, KIND, NL, NP, U, MIR, WRAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  void* args[] = {(void*)a};
  int head;
  const unsigned grid = (unsigned)item_count<KIND, NL>(*a, &head);
  if (grid == 0) return 0;
  cudaError_t rc = cudaLaunchKernel(k1_kernel<T, KIND, NL, NP, U, MIR, WRAP>,
                                    dim3(grid), dim3(NTHR), args, smem, s);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// whether launch `kind` of A has the standard uPML layout (u_ax1 ...)
static bool upml_layout(const K1Args& A, int kind) {
  return (kind == K_E || upml_curl(A.cc, (int)A.P.ncurl)) &&
         (kind == K_D || upml_eh(A.ec, (int)A.P.neh));
}

// a real pair's launch (k1_pair_kernel): both channels, the grid's second
// dimension
template <typename T, int KIND, int NP, bool U>
static int launch_pair_kind(const K1Args* a, cudaStream_t s) {
  const size_t smem = smem_bytes<T, KIND, false>(*a);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        k1_pair_kernel<T, KIND, NP, U>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  void* args[] = {(void*)a};
  int head;
  const unsigned grid = (unsigned)item_count<KIND, false>(*a, &head);
  if (grid == 0) return 0;
  cudaError_t rc = cudaLaunchKernel(k1_pair_kernel<T, KIND, NP, U>,
                                    dim3(grid, 2), dim3(NTHR), args, smem, s);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

template <typename T, int KIND, int NP>
static int launch_pair(const K1Args* a, cudaStream_t s) {
  return upml_layout(*a, KIND) ? launch_pair_kind<T, KIND, NP, true>(a, s)
                               : launch_pair_kind<T, KIND, NP, false>(a, s);
}

template <typename T, int KIND, bool NL, int NP, bool MIR = false,
          bool WRAP = false>
static int launch_u(const K1Args* a, cudaStream_t s) {
  return upml_layout(*a, KIND)
             ? launch_kind<T, KIND, NL, NP, true, MIR, WRAP>(a, s)
             : launch_kind<T, KIND, NL, NP, false, MIR, WRAP>(a, s);
}

template <typename T>
static int launch(const K1Args* a, int kind, cudaStream_t s) {
  if (a->S0 < 1 || a->ch < 1 || a->nring > MAXRING || a->P.npol > MAXPOL)
    return (int)cudaErrorInvalidValue;
  // the wrap: B and D launches, a live extent inside the storage, no
  // mirror ghost beside it
  if (a->wnum && (kind == K_E || a->wnum < 1 || a->wnum >= a->S0 || a->mir))
    return (int)cudaErrorInvalidValue;
  const bool nl = has_nl(a->P);
  const bool one = a->P.npol <= 1;
  if (a->wpair) {
    // a real pair: linear, x-periodic (B and D wrap), no mirror ghost
    if (nl || a->mir || (kind != K_E && !a->wnum))
      return (int)cudaErrorInvalidValue;
    switch (kind) {
      case K_B:
        return launch_pair<T, K_B, 1>(a, s);
      case K_D:
        return launch_pair<T, K_D, 1>(a, s);
      case K_E:
        return one ? launch_pair<T, K_E, 1>(a, s)
                   : launch_pair<T, K_E, MAXPOL>(a, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (kind) {
    case K_B:
      // only the E family may carry chi3 / chi2-NR coefficients
      if (has_nl(a->P)) return (int)cudaErrorInvalidValue;
      return a->wnum ? launch_u<T, K_B, false, 1, false, true>(a, s)
                     : launch_u<T, K_B, false, 1>(a, s);
    case K_D:
      // the fold ghosts (MIR) only in the variants of mirrored plans: built
      // into every variant, they cost the launch registers and spills
      if (a->wnum) return launch_u<T, K_D, false, 1, false, true>(a, s);
      return a->mir ? launch_u<T, K_D, false, 1, true>(a, s)
                    : launch_u<T, K_D, false, 1, false>(a, s);
    case K_E:
      if (nl)
        return one ? launch_u<T, K_E, true, 1>(a, s)
                   : launch_u<T, K_E, true, MAXPOL>(a, s);
      return one ? launch_u<T, K_E, false, 1>(a, s)
                 : launch_u<T, K_E, false, MAXPOL>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

i64 mnt_k1_args_size(void) { return (i64)sizeof(K1Args); }

i64 mnt_k1_params_size(void) { return (i64)sizeof(Params); }

// the y-z tile this library was built with
void mnt_k1_tile(int* ty_tz) {
  ty_tz[0] = TY;
  ty_tz[1] = TZ;
}

// the launch's dynamic shared memory in bytes
i64 mnt_k1_smem(const K1Args* a, int kind, int fp64) {
  const bool nl = has_nl(a->P);
  if (kind == K_E)
    return fp64 ? (i64)(nl ? smem_bytes<double, K_E, true>(*a)
                           : smem_bytes<double, K_E, false>(*a))
                : (i64)(nl ? smem_bytes<float, K_E, true>(*a)
                           : smem_bytes<float, K_E, false>(*a));
  if (kind == K_B)
    return (i64)(fp64 ? smem_bytes<double, K_B, false>(*a)
                      : smem_bytes<float, K_B, false>(*a));
  return (i64)(fp64 ? smem_bytes<double, K_D, false>(*a)
                    : smem_bytes<float, K_D, false>(*a));
}

int mnt_k1_launch(const K1Args* a, int kind, int fp64, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return fp64 ? launch<double>(a, kind, s) : launch<float>(a, kind, s);
}

}  // extern "C"
