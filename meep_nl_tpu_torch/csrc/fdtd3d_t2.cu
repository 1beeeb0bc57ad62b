// K2 on Hopper: `depth` (2 or 3) consecutive 3D Yee steps per call in one
// ordinary launch per item class, with the monitor planes of the
// intermediate steps written by the kernel itself.  Written by hand for
// sm_90a, bound through a plain C interface (ctypes).
//
// Replaces the TPU kernel meep_nl_tpu/ops/pallas/fdtd3d_t2.py::_build_call2
// (:182, kernel body :893, pallas_call :2047, driven by Fdtd3dT2Kernel
// :2084).  It computes `depth` applications of K1's step (fdtd3d.cu; both
// run fdtd3d_site.cuh's value functions, built without FMA contraction),
// stage s with row s of the source table, plus the capture planes: E/H of
// chosen x-planes after a chosen stage, as state["f"][comp][x:x+1] reads.
//
// Design: barrier-free temporal blocking.  One block owns an item, an
// output box (a y-z tile x an x-chunk) that the wrapper lists; the items
// tile the storage.  The block computes all `depth` stages of its item,
// ordered by __syncthreads only; no two blocks exchange anything, and no
// launch is cooperative.
//   * Overlapped (trapezoid) items.  Along each axis stage s is computed
//     on the output grown by (depth - s) h, B/H h more below (D reads H at
//     -1) and h - 1 above, D h - 1 on both sides (ops/fdtd3d_t2.py::
//     regions).  h = 1 on linear items; h = 2 on nonlinear ones, whose
//     first stage meets a site with a nonzero chi2/chi3 coefficient (the
//     neighbour sums read D - P at +-1 in every axis), except on their
//     sides where no stage reaches such a site at its edge (side_widths).
//     The halo's stages are recomputed by design.
//   * An x-march.  At step t stage s updates B/H and D on plane
//     t - (s-1) h and E on the plane h - 1 behind it, so every plane a
//     stage reads across sites (E at x+1, H at x-1, D - P at x+-1) was
//     finished by the stage before it in this step or earlier.
//   * Intermediate stages on chip.  Every array lives, for the planes in
//     flight, in a ring of planes in shared memory, and a plane's slot
//     holds the newest stage computed there: a stage updates it in place
//     at the site's own position and reads the neighbours' values of the
//     stage before it.  A ring's plane covers the first stage's region of
//     its first writer (four kinds: E, B/H, D, E-family); the wrapper
//     sizes every ring (ops/fdtd3d_t2.py::march; tests/test_torch_
//     fdtd3d_t2.py replays every read of the march against it).  The y and
//     z coefficients of the chains and the alive factors are staged per
//     item in shared-memory rows.
//   * Out of place: the state is read once and written once per call.
//     Stage 1 reads the input state (its E planes by cp.async two planes
//     ahead, the other operands at the site), the last stage writes the
//     item's own sites into a second set of state tensors.  An item reads
//     only input tensors and writes only output ones, so overlapped items
//     cannot race whatever order the blocks run in (the host emulation
//     runs them in several orders).
//   * Sources and captures from per-plane lists of any length.
//   * Two item classes, each its own launch: the nonlinear items (few,
//     long: a tile's whole nonlinear x-range, cut to about fill the SMs
//     once) on a stream of higher priority that the wrapper forks from and
//     joins back to the caller's, the linear items on the caller's stream,
//     so that the linear blocks fill the SMs the nonlinear ones leave.
//
// Where trouble was likely, and what the design does:
//  (a) edges: the regions are clipped to the storage; sites outside it
//      read 0 across sites (the plain version's zero fill): the E ring's
//      loads write 0 there, the H and D - P rings are zeroed per item and
//      never written there, x-neighbours outside [0, S0) are tested.  The
//      alive masks are applied as in K1.  Chunks start at 0 and end at S0.
//  (b) slab-local chains (plan.slab_opt): f_u / f_w are read and written
//      only where their chain runs, the halo included, by K1's slab rule;
//      outside, the output tensor keeps what it held, which the wrapper
//      makes equal to the input (its pairing of the two state sets).
//  (c) P/PP roles: the rings keep P and PP of every stage explicitly (the
//      ADE writes the new P into P and the current one into PP), so the
//      last stage writes the newest P into the output's p.
//  (d) the nonlinear reach: D - P of a stage has its own ring, written
//      when D is, so E reads its neighbours' values before any of them
//      updates P; within a step a nonlinear E waits for D (a barrier).
//  (e) sources in the halo: the thread of every site adds its sources,
//      halo sites too (their intermediate stages must see them), from a
//      per-plane list sorted by site, then in plan.sources and entry order.
//  (f) captures: only the thread that computes a site of the item's own
//      output box writes it, never a halo copy.
//  (g) register pressure: each variant has its own budget (below); the
//      site work loads all its operands before its first store (the
//      arrays are untyped pointers that may alias).
//  (h) latency: a block runs one sub-update at a time between barriers,
//      often on fewer sites than it has threads, so a site's chain of
//      waits sets the pace.  Each sub-update therefore issues all of a
//      site's device-memory operands (the input state at stage 1, the
//      coefficients in their boxes at every stage) together before the
//      arithmetic that waits for them, and the NR solves of a site's three
//      E components run side by side (nr_solve_n), not one after another.
//
// What bounds it on the H100: by its byte count, device memory (the state
// once in, once out per call: ops/fdtd3d_t2.py::step_cost).  In practice
// the latency of the site work: the trapezoid recomputes 1.3-1.4x
// (linear, 16 x 16 tiles, depth 3) to ~3x (nonlinear, 8 x 8 tiles, h = 2)
// of the output's sites, and the phases between barriers are too small to
// hide their chains (PERF.md).
// Budget: 512 threads a block.  A nonlinear block, or a linear one that
// has its SM to itself, may take the SM's whole shared memory (at most 128
// registers a thread, MINB = 1); linear blocks run two an SM (64
// registers, MINB = 2, each with half the shared memory) when half holds
// the largest tile the whole would, or when the plan has nonlinear items
// (they hold an SM each, and the finer linear blocks fill the card around
// them more evenly); the wrapper takes the largest tile of at most
// K2_TY x K2_TZ that fits.  Variants: fp32 / fp64 (T), nonlinear or
// linear items (NL), the standard uPML layout as compile-time values or
// not (U), one pole or up to MAXPOL (NP), the linear register budget
// (MINB), the fold ghosts of a y or z node mirror or not (MIR), the x
// Bloch wrap or not (W).  PERF.md records tiles, shared memory and
// ptxas's registers and spills for the driven plans.
//
// The x Bloch wrap (W; ops/periodicx.py::PeriodicXT2Kernel: linear items,
// a real phase ph, live extent wn along x): the wrapper cuts the live
// planes [0, wn) and the dead ones [wn, S0) into items of their own.  A
// live item's region is not clipped along x: its halo planes p < 0 and
// p >= wn are images, read from storage plane p mod wn times 1 / ph
// (p < 0) or ph (p >= wn) wherever a stage reads the input state (E by
// plain scaled loads, the other arrays at the site), its coefficients at
// p mod wn without the phase, and no source or capture lands on an image
// (the envelope keeps the sources two planes clear of the wrap).  So the
// halo-in-time recompute runs across the wrap on chip, with no carry from
// the host: the reference's stage-1 plane-0 E save and its wrap carries
// (fdtd3d_t2.py:1627-1668, periodicx.py:447-505) are not needed.  A dead
// item is clipped to [wn, S0) and reads zero across x (step._sh fills a
// dead plane's x-neighbours with zeros).  The variant is built only for
// linear items without a mirror (the envelope); the others are built
// without it.

// Host emulation: the site loops are block-stride loops, every cp.async
// has a plain-copy twin, and tests/cuda_stub runs each block as one thread,
// the blocks one after another in a chosen order.

#include "fdtd3d_march.cuh"

// the largest output tile (rows j x columns k; the wrapper takes the
// largest of its halvings that fits, a square one first, as its halo is
// the smallest); another is a build option (-DK2_TY=.. -DK2_TZ=..), which
// the host emulation uses to put tile edges inside small grids
#ifndef K2_TY
#define K2_TY 16
#endif
#ifndef K2_TZ
#define K2_TZ 16
#endif
#ifdef MNT_CUDA_STUB
#define K2_NTHR 1
#define K2_SMEM stub_dynamic_smem()
#else
#define K2_NTHR 512
extern __shared__ __align__(16) unsigned char k2_smem[];
#define K2_SMEM k2_smem
#endif

// the rings of an item: E, H, D - P (nonlinear items), then the arrays
// read only at the site's own position
enum { R_E, R_H, R_M, R_B, R_FUB, R_FWH, R_D, R_FUD, R_FWE, R_P, R_PP,
       NROLE };
#define NQ (NCOMP * MAXPOL)            // P / PP: component * MAXPOL + pole
// A ring's plane covers the region its first writer updates in stage 1
// (ops/fdtd3d_t2.py::regions): the E ring the whole item region (the
// input's E), the H and B-family rings B/H's, the D-family and D - P rings
// D's, the E-family rings (f_w of E, P, PP) E's.
enum { G_E, G_B, G_D, G_F, NKIND };
__host__ __device__ constexpr int kind_of(int role) {
  return role == R_E ? G_E
         : (role == R_H || role == R_B || role == R_FUB || role == R_FWH)
             ? G_B
             : (role == R_M || role == R_D || role == R_FUD) ? G_D : G_F;
}

// The per-axis coefficients a site reads, staged per item in shared
// memory along y and z (the x ones, the same for a whole plane, are read
// from device memory): for each curl component of the B and the D family
// (slot = family * 3 + component) its chains' kap - sig and 1/sig along
// that axis and its alive factor; for each E/H component (slot = 0..2 H,
// 3..5 E) its W chain's kapw +- sigw and its alive factor.  A row holds
// one of these over the item's E-plane span of the axis.
enum { F_KMS, F_SIV, F_KMSU, F_SIVU, F_ALC, NF_CURL };
enum { F_KP = NF_CURL * 6, F_KM = F_KP + 6, F_ALE = F_KM + 6,
       NROW = F_ALE + 6 };

// One item class's shared-memory layout (mirrored by ops/fdtd3d_t2.py).
struct K2Class {
  int off[NROLE][NQ];                 // first element of a ring (-1: none)
  int ns[NROLE];                      // planes a ring holds
  int below[NKIND];                   // a kind's plane: sites below the
  int rz[NKIND];                      //   output tile in y and z, columns,
  int pw[NKIND];                      //   sites
  int tab, ly, lz;                    // the coefficient rows: first
                                      // element, lengths along y and z
  int words;                          // elements of all rings and rows
};

// Mirrored by meep_nl_tpu_torch/ops/fdtd3d_t2.py (_K2Args).
struct K2Args {
  Params pb, pd;                      // the families over the INPUT state
  void* out_b[NCOMP];                 // the output state
  void* out_fub[NCOMP];
  void* out_h[NCOMP];
  void* out_fwh[NCOMP];
  void* out_d[NCOMP];
  void* out_fud[NCOMP];
  void* out_e[NCOMP];
  void* out_fwe[NCOMP];
  void* out_p[NCOMP][MAXPOL];
  void* out_pp[NCOMP][MAXPOL];
  const void* items;                  // int32 (n, 8): i0 i1 j0 j1 k0 k1
                                      // wide - (linear items, then
                                      // nonlinear)
  const void* src_ptr[2];             // per family (B, D): int32 [S0 + 1]
  const void* src_key[2];             // int32 ((j*S2 + k) << 2) | comp
  const void* src_id[2];              // int32 plan.sources index
  const void* src_amp[2];             // T (n, 2): amplitude re, im
  const void* wave;                   // double (depth, nsrc, 2)
  const void* cap_ptr;                // int32 [(stage*2 + fam)*S0 + x] ->
  const void* cap_q;                  //   entries; int32 component
  void* cap_out;                      // T (ncap, S1, S2)
  double dt;
  Box nl3[NCOMP], nlnr[NCOMP], pol[NCOMP][MAXPOL];
  CurlC cb[NCOMP], cd[NCOMP];         // gp / gm: E (B) or H (D) component
  EhC eh[NCOMP], ee[NCOMP];           // H, E
  int hb_of[NCOMP];                   // B component of each H
  int ed_of[NCOMP];                   // D component of each E
  K2Class cls[2];                     // linear items, nonlinear items
  int nitems[2];                      // items of each class
  int pair;                           // linear blocks: two an SM (1) or one
  int depth, S0, S1, S2, nsrc;
  // node mirrors (bit a - 1: a mirror plane at index 0 of axis a, 1 y or
  // 2 z) and, per H component and axis, the fold ghost's row k0 and sign
  // (step.mirror_ghost)
  int mir;
  int mk0[NCOMP][2], msg[NCOMP][2];
  // the x Bloch wrap (W): the live extent along x (0: none), the phase
  // and its inverse
  int wn;
  double wph, wphi;
};

struct Item {
  int i0, i1, j0, j1, k0, k1;
  int wide;                           // nonlinear items: the sides that
                                      // grow by 2 (bit axis * 2 + above)
};

struct Span {
  int lo, hi;
};

// one item's rings: the base of the shared memory, the class layout and
// the item's output corner
template <typename T>
struct Rings {
  T* sm;
  const K2Class* C;
  int j0, k0;
  // the offset of plane p's slot in a ring of `role` (block-uniform:
  // worked out once per sub-update), and the slot of component c there
  __device__ __forceinline__ int plane(int role, int p) const {
    return (p % C->ns[role]) * C->pw[kind_of(role)];
  }
  // the same for the planes of a wrapped item, which may be negative
  template <bool W>
  __device__ __forceinline__ int planew(int role, int p) const {
    if (!W) return plane(role, p);
    const int ns = C->ns[role], m = p % ns;
    return (m < 0 ? m + ns : m) * C->pw[kind_of(role)];
  }
  __device__ __forceinline__ T* at(int role, int c, int pl) const {
    return sm + C->off[role][c] + pl;
  }
  __device__ __forceinline__ bool has(int role, int c) const {
    return C->off[role][c] >= 0;
  }
  // site (j, k) in a plane of kind g, and the step to the next row
  __device__ __forceinline__ int pos(int g, int j, int k) const {
    return (j - j0 + C->below[g]) * C->rz[g] + (k - k0 + C->below[g]);
  }
  __device__ __forceinline__ int row(int g) const { return C->rz[g]; }
  // the coefficient of row `r` along axis ax (1 y, 2 z) at site (j, k)
  __device__ __forceinline__ T coef(int ax, int r, int j, int k) const {
    const T* t = sm + C->tab;
    return ax == 1 ? t[r * C->ly + j - j0 + C->below[G_E]]
                   : t[(NROW * C->ly) + r * C->lz + k - k0 + C->below[G_E]];
  }
};

__device__ __forceinline__ int coord3(int ax, int i, int j, int k) {
  return ax == 0 ? i : (ax == 1 ? j : k);
}

// where plane p of item I lies in the storage (W: the x Bloch wrap): its
// storage plane px, whether it is an image across the wrap (virt: a live
// item's plane p < 0 or p >= wn) and the scale of the input's values
// there (1 / ph below, ph above, else 1); live: the item is a live one
// (its x-neighbours exist), not a dead one (they read zero)
template <typename T>
struct XAt {
  int px;
  bool virt, live;
  T sc;
};

template <typename T, bool W>
__device__ __forceinline__ XAt<T> x_at(const K2Args& A, const Item& I,
                                       int p) {
  XAt<T> x = {p, false, true, T(1)};
  if (W) {
    x.live = I.i1 <= A.wn;
    if (x.live && p < 0) {
      x.px = p + A.wn;
      x.virt = true;
      x.sc = T(A.wphi);
    } else if (x.live && p >= A.wn) {
      x.px = p - A.wn;
      x.virt = true;
      x.sc = T(A.wph);
    }
  }
  return x;
}

// the input state's value of array `a` at storage offset n (W: times the
// plane's scale)
template <typename T, bool W>
__device__ __forceinline__ T ldx(const void* a, int n, T sc) {
  const T v = ((const T*)a)[n];
  return W ? sc * v : v;
}

// ---- sources and captures --------------------------------------------

// the entries [a, b) of plane p in a per-plane list (none: a == b)
struct Range {
  int a, b;
};

__device__ __forceinline__ Range plane_range(const void* ptr, int key) {
  Range r = {0, 0};
  if (ptr) {
    r.a = ((const int*)ptr)[key];
    r.b = ((const int*)ptr)[key + 1];
  }
  return r;
}

// the current sources of family `fam` at site (j, k) of the plane whose
// entries are `sr` into the new D/B values f[q] at stage s: f - current *
// dt per entry, in the list's order
template <typename T>
__device__ __forceinline__ void add_sources(const K2Args& A, int fam, int s,
                                            Range sr, int j, int k, T* f) {
  const int a = sr.a, b = sr.b;
  if (a == b) return;
  const int* key = (const int*)A.src_key[fam];
  const int me = (j * A.S2 + k) << 2;
  int lo = a, hi = b;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((key[mid] & ~3) < me) lo = mid + 1;
    else hi = mid;
  }
  const T* amp = (const T*)A.src_amp[fam];
  const int* id = (const int*)A.src_id[fam];
  const double* wv = (const double*)A.wave + 2 * (s - 1) * A.nsrc;
  for (int e = lo; e < b && (key[e] & ~3) == me; ++e) {
    const int w = id[e];
    const T add = -source_amp<T>(amp, amp + 1, 2 * e, T(wv[2 * w]),
                                 T(wv[2 * w + 1]), T(A.dt));
    const int q = key[e] & 3;
#pragma unroll
    for (int qq = 0; qq < NCOMP; ++qq)
      if (qq == q) f[qq] = f[qq] + add;
  }
}

// the capture planes of component q (entries `cr` of the stage, family
// and plane) at output site (j, k)
template <typename T>
__device__ __forceinline__ void capture(const K2Args& A, Range cr, int q,
                                        int j, int k, T v) {
  const int* cq = (const int*)A.cap_q;
  for (int e = cr.a; e < cr.b; ++e)
    if (cq[e] == q)
      ((T*)A.cap_out)[(i64)e * A.S1 * A.S2 + j * A.S2 + k] = v;
}

// ---- the PML chains of a curl component ------------------------------

// The new D/B of curl component q (row slot `sl`) at site (i, j, k) from
// its old value f, dfl and (where the sigma_u chain runs) the old f_u:
// K1's curl update (fdtd3d.cu curl_site_k1) before the sources; uon: the
// sigma_u chain runs here, *fun its new f_u.  The coefficients along y and
// z come from the item's rows, those along x from device memory.
template <typename T, bool U>
__device__ __forceinline__ T chain(const Rings<T>& R, const CurlP& c,
                                   const CurlC& cc, int q, int sl, int i,
                                   int j, int k, T f, T dfl, bool uon, T fuo,
                                   T* fun) {
  const int sax = U ? u_ax1(q) : cc.sax, uax = U ? u_ax2(q) : cc.uax;
  T kms = T(0), siv = T(0), kmsu = T(0), sivu = T(0);
  bool son = false;
  if (sax == 0) {
    kms = ((const T*)c.kap)[i] - ((const T*)c.sig)[i];
    siv = ((const T*)c.siginv)[i];
  } else if (sax > 0) {
    kms = R.coef(sax, F_KMS * 6 + sl, j, k);
    siv = R.coef(sax, F_SIV * 6 + sl, j, k);
  }
  if (sax >= 0)
    son = in_rule(coord3(sax, i, j, k), cc.s_lo, cc.s_hi0, cc.s_n);
  if (uax == 0) {
    kmsu = ((const T*)c.kapu)[i] - ((const T*)c.sigu)[i];
    sivu = ((const T*)c.siginvu)[i];
  } else if (uax > 0) {
    kmsu = R.coef(uax, F_KMSU * 6 + sl, j, k);
    sivu = R.coef(uax, F_SIVU * 6 + sl, j, k);
  }
  *fun = T(0);
  const T ax = c.alive[0] ? ((const T*)c.alive[0])[i] : T(1);
  return curl_value<T>(f, dfl, sax >= 0, son, kms, siv, uon, kmsu, sivu, fuo,
                       fun) *
         (ax * R.coef(1, F_ALC * 6 + sl, j, k) *
          R.coef(2, F_ALC * 6 + sl, j, k));
}

template <bool U>
__device__ __forceinline__ bool u_on(const CurlC& cc, int q, int i, int j,
                                     int k) {
  const int uax = U ? u_ax2(q) : cc.uax;
  return uax >= 0 && in_rule(coord3(uax, i, j, k), cc.u_lo, cc.u_hi0,
                             cc.u_n);
}

// the W chain's inputs of E/H component q (row slot `sl`) at site
// (i, j, k), without the old field and f_w (the caller fills them where
// w.on); y and z coefficients from the item's rows
template <typename T, bool U>
__device__ __forceinline__ WIn<T> w_of(const Rings<T>& R, const EhP& e,
                                       const EhC& ec, int q, int sl, int i,
                                       int j, int k) {
  WIn<T> w;
  const int wax = U ? q : ec.wax;
  w.on = false;
  w.f = w.fw = w.kp = w.km = T(0);
  if (wax == 0) {
    const T kw = ((const T*)e.kapw)[i], sw = ((const T*)e.sigw)[i];
    w.kp = kw + sw;
    w.km = kw - sw;
  } else if (wax > 0) {
    w.kp = R.coef(wax, F_KP + sl, j, k);
    w.km = R.coef(wax, F_KM + sl, j, k);
  }
  if (wax >= 0) w.on = in_rule(coord3(wax, i, j, k), ec.w_lo, ec.w_hi0,
                               ec.w_n);
  const T ax = e.alive[0] ? ((const T*)e.alive[0])[i] : T(1);
  w.mask = ax * R.coef(1, F_ALE + sl, j, k) * R.coef(2, F_ALE + sl, j, k);
  return w;
}

// fill the item's coefficient rows (after the rings are zeroed): row r of
// axis ax at position t is the coefficient at coordinate (j0 or k0) -
// below + t; outside the storage 0 (no site there is computed)
template <typename T>
__device__ __forceinline__ void fill_rows(const K2Args& A,
                                          const Rings<T>& R, int tid) {
  const K2Class& C = *R.C;
  const int ly = C.ly, lz = C.lz, below = C.below[G_E];
  T* t = R.sm + C.tab;
  for (int e = tid; e < NROW * (ly + lz); e += K2_NTHR) {
    const bool z = e >= NROW * ly;
    const int L = z ? lz : ly, e2 = z ? e - NROW * ly : e;
    const int r = e2 / L, ax = z ? 2 : 1;
    const int c = (z ? R.k0 : R.j0) - below + (e2 - r * L);
    const bool in = c >= 0 && c < (z ? A.S2 : A.S1);
    T v = T(0);
    if (in && r < F_KP) {
      const int f = r / 6, sl = r - 6 * f, q = sl % 3;
      const Params& P = sl < 3 ? A.pb : A.pd;
      const CurlC& cc = sl < 3 ? A.cb[q] : A.cd[q];
      const CurlP& cp = P.curl[q];
      if (q < P.ncurl) {
        if (f == F_ALC)
          v = cp.alive[ax] ? ((const T*)cp.alive[ax])[c] : T(1);
        else if ((f == F_KMS || f == F_SIV) && cc.sax == ax)
          v = f == F_KMS ? ((const T*)cp.kap)[c] - ((const T*)cp.sig)[c]
                         : ((const T*)cp.siginv)[c];
        else if ((f == F_KMSU || f == F_SIVU) && cc.uax == ax)
          v = f == F_KMSU ? ((const T*)cp.kapu)[c] - ((const T*)cp.sigu)[c]
                          : ((const T*)cp.siginvu)[c];
      }
    } else if (in) {
      const int f = (r - F_KP) / 6, sl = r - F_KP - 6 * f, q = sl % 3;
      const Params& P = sl < 3 ? A.pb : A.pd;
      const EhC& ec = sl < 3 ? A.eh[q] : A.ee[q];
      const EhP& eh = P.eh[q];
      if (q < P.neh) {
        if (f == 2)
          v = eh.alive[ax] ? ((const T*)eh.alive[ax])[c] : T(1);
        else if (ec.wax == ax) {
          const T kw = ((const T*)eh.kapw)[c], sw = ((const T*)eh.sigw)[c];
          v = f == 0 ? kw + sw : kw - sw;
        }
      }
    }
    t[e] = v;
  }
}

// ---- the three sub-updates of a stage on one plane -------------------------

// B <- curl E with the chains and the B-family sources, H <- W(u B); stage
// s at plane p on the region (ys, zs)
template <typename T, bool U, bool W>
__device__ __forceinline__ void b_plane(const K2Args& A, const Rings<T>& R,
                                        const Item& I, int tid, int s, int p,
                                        Span ys, Span zs) {
  const Params& P = A.pb;
  const int S1 = A.S1, S2 = A.S2;
  const bool last = s == A.depth;
  const bool xo = p >= I.i0 && p < I.i1;
  const T csgn = T(P.csgn);
  const XAt<T> xa = x_at<T, W>(A, I, p);
  const int px = xa.px;
  const int pE = R.template planew<W>(R_E, p),
            pE1 = R.template planew<W>(R_E, p + 1);
  const int pH = R.template planew<W>(R_H, p),
            pB = R.template planew<W>(R_B, p);
  const Range none = {0, 0};
  const Range sr = W && xa.virt ? none : plane_range(A.src_ptr[0], p);
  const Range cr = W && xa.virt
                       ? none
                       : plane_range(A.cap_ptr, ((s - 1) * 2) * A.S0 + p);
  const int nz = zs.hi - zs.lo, cnt = (ys.hi - ys.lo) * nz;
  for (int r = tid; r < cnt; r += K2_NTHR) {
    const int j = ys.lo + r / nz, k = zs.lo + r % nz;
    const int n = (px * S1 + j) * S2 + k;
    const int oe = R.pos(G_E, j, k), o = R.pos(G_B, j, k);
    const bool own = last && xo && j >= I.j0 && j < I.j1 && k >= I.k0 &&
                     k < I.k1;
    // the site's operands at its own position, issued together before the
    // arithmetic (at stage 1 from the input state, a round trip each
    // otherwise): B and its f_u, H's u, old value and f_w; and loaded
    // before the first store (the arrays are untyped pointers that may
    // alias for all the compiler knows, so a store between two loads would
    // serialise their trips to memory)
    T fo[NCOMP], fuo[NCOMP], us[NCOMP];
    bool uon[NCOMP];
    WIn<T> w[NCOMP];
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      fo[q] = fuo[q] = T(0);
      uon[q] = false;
      if (!U && q >= P.ncurl) continue;
      const CurlP& c = P.curl[q];
      uon[q] = u_on<U>(A.cb[q], q, px, j, k);
      fo[q] = s == 1 ? ldx<T, W>(c.f, n, xa.sc) : R.at(R_B, q, pB)[o];
      if (uon[q])
        fuo[q] = s == 1 ? ldx<T, W>(c.fu, n, xa.sc) : R.at(R_FUB, q, pB)[o];
    }
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      us[q] = T(1);
      if (!U && q >= P.neh) continue;
      const EhP& e = P.eh[q];
      const EhC& ec = A.eh[q];
      if (ec.has_u) us[q] = ((const T*)e.u)[n];
      w[q] = w_of<T, U>(R, e, ec, q, q, px, j, k);
      if (w[q].on) {
        w[q].f = s == 1 ? ldx<T, W>(e.f, n, xa.sc) : R.at(R_H, q, pH)[o];
        w[q].fw =
            s == 1 ? ldx<T, W>(e.fw, n, xa.sc) : R.at(R_FWH, q, pB)[o];
      }
    }
    T f[NCOMP], fun[NCOMP];
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      f[q] = fun[q] = T(0);
      if (!U && q >= P.ncurl) continue;
      const CurlC& cc = A.cb[q];
      const CurlP& c = P.curl[q];
      // forward differences of the E partners of the stage before
      T dd[2];
      bool hv[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int g = m == 0 ? cc.gp : cc.gm;
        const int ax = U ? (m == 0 ? u_ax1(q) : u_ax2(q))
                         : (m == 0 ? cc.ap : cc.am);
        hv[m] = U || g >= 0;
        dd[m] = T(0);
        if (!hv[m]) continue;
        const T* here = R.at(R_E, g, pE);
        T nb;
        if (ax == 0)
          nb = (W ? xa.live : p + 1 < A.S0) ? R.at(R_E, g, pE1)[oe] : T(0);
        else nb = here[oe + (ax == 1 ? R.row(G_E) : 1)];
        dd[m] = nb - here[oe];
      }
      const T dfl = curl_delta<T>(hv[0], dd[0], hv[1], dd[1], csgn);
      f[q] = chain<T, U>(R, c, cc, q, q, px, j, k, fo[q], dfl, uon[q],
                         fuo[q], &fun[q]);
    }
    add_sources<T>(A, 0, s, sr, j, k, f);
    // H from the new B
    T lin[NCOMP], h[NCOMP];
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      lin[q] = h[q] = T(0);
      if (!U && q >= P.neh) continue;
      T gs = T(0);
#pragma unroll
      for (int qq = 0; qq < NCOMP; ++qq)
        if (qq == A.hb_of[q]) gs = f[qq];
      lin[q] = A.eh[q].has_u ? gs * us[q] : gs;
      h[q] = w_value<T>(lin[q], w[q]);
    }
    // the stores
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      if (!U && q >= P.ncurl) continue;
      R.at(R_B, q, pB)[o] = f[q];
      if (uon[q] && R.has(R_FUB, q)) R.at(R_FUB, q, pB)[o] = fun[q];
      if (own) {
        ((T*)A.out_b[q])[n] = f[q];
        if (uon[q]) ((T*)A.out_fub[q])[n] = fun[q];
      }
    }
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      if (!U && q >= P.neh) continue;
      R.at(R_H, q, pH)[o] = h[q];
      if (w[q].on && R.has(R_FWH, q)) R.at(R_FWH, q, pB)[o] = lin[q];
      if (own) {
        ((T*)A.out_h[q])[n] = h[q];
        if (w[q].on) ((T*)A.out_fwh[q])[n] = lin[q];
      }
      if (cr.a < cr.b && xo && j >= I.j0 && j < I.j1 && k >= I.k0 &&
          k < I.k1)
        capture<T>(A, cr, q, j, k, h[q]);
    }
  }
}

// The fold ghosts of a y or z node mirror for the D sub-update of a
// stage at plane p over the region (ys, zs): where the region starts at
// the plane, the H ring's row below it (j or k = -1, zero otherwise, as
// sites outside the storage are) gets sign * H[k0] of this stage, which
// b_plane has just written.  d_plane's backward difference then reads the
// ghost there, as the plain version's `mirror_ghost`.
template <typename T>
__device__ __forceinline__ void ghost_plane(const K2Args& A,
                                            const Rings<T>& R, int tid,
                                            int p, Span ys, Span zs) {
  const int pH = R.plane(R_H, p);
  for (int a = 0; a < 2; ++a) {
    if (!((A.mir >> a) & 1) || (a == 0 ? ys.lo : zs.lo) > 0) continue;
    const Span sp = a == 0 ? zs : ys;
    const int n = sp.hi - sp.lo, st = a == 0 ? R.row(G_B) : 1;
    for (int e = tid; e < A.pb.neh * n; e += K2_NTHR) {
      const int q = e / n, u = sp.lo + e % n;
      if (!R.has(R_H, q)) continue;
      T* h = R.at(R_H, q, pH);
      const int o = a == 0 ? R.pos(G_B, -1, u) : R.pos(G_B, u, -1);
      h[o] = T(A.msg[q][a]) * h[o + (1 + A.mk0[q][a]) * st];
    }
  }
}

// D <- curl H with the chains and the D-family sources; on nonlinear
// items also D - P (of the stage before) into its ring
template <typename T, bool NL, bool U, bool W>
__device__ __forceinline__ void d_plane(const K2Args& A, const Rings<T>& R,
                                        const Item& I, int tid, int s, int p,
                                        Span ys, Span zs) {
  const Params& P = A.pd;
  const int S1 = A.S1, S2 = A.S2;
  const bool last = s == A.depth;
  const bool xo = p >= I.i0 && p < I.i1;
  const T csgn = T(P.csgn);
  const XAt<T> xa = x_at<T, W>(A, I, p);
  const int px = xa.px;
  // (W: the plane below exists on a live item, across the wrap too)
  const int pH = R.template planew<W>(R_H, p),
            pH0 = (W ? xa.live : p > 0) ? R.template planew<W>(R_H, p - 1)
                                        : 0;
  const int pD = R.template planew<W>(R_D, p),
            pF = R.template planew<W>(R_P, p);
  const int pM = NL ? R.plane(R_M, p) : 0;
  const Range none = {0, 0};
  const Range sr = W && xa.virt ? none : plane_range(A.src_ptr[1], p);
  const int nz = zs.hi - zs.lo, cnt = (ys.hi - ys.lo) * nz;
  for (int r = tid; r < cnt; r += K2_NTHR) {
    const int j = ys.lo + r / nz, k = zs.lo + r % nz;
    const int n = (px * S1 + j) * S2 + k;
    const int ob = R.pos(G_B, j, k), o = R.pos(G_D, j, k);
    const bool own = last && xo && j >= I.j0 && j < I.j1 && k >= I.k0 &&
                     k < I.k1;
    // the site's operands at its own position, issued together before the
    // arithmetic and the first store (see b_plane): D and its f_u, and on
    // nonlinear items the P of every pole (of the stage before)
    T fo[NCOMP], fuo[NCOMP], pv[NCOMP][MAXPOL];
    bool uon[NCOMP];
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      fo[q] = fuo[q] = T(0);
      uon[q] = false;
      if (!U && q >= P.ncurl) continue;
      const CurlP& c = P.curl[q];
      uon[q] = u_on<U>(A.cd[q], q, px, j, k);
      fo[q] = s == 1 ? ldx<T, W>(c.f, n, xa.sc) : R.at(R_D, q, pD)[o];
      if (uon[q])
        fuo[q] = s == 1 ? ldx<T, W>(c.fu, n, xa.sc) : R.at(R_FUD, q, pD)[o];
    }
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
#pragma unroll
      for (int pi = 0; pi < MAXPOL; ++pi) {
        pv[q][pi] = T(0);
        if (!NL || (!U && q >= P.neh)) continue;
        if (pi < P.npol && ((A.ee[q].pols >> pi) & 1))
          pv[q][pi] = s == 1 ? ldx<T, W>(P.eh[q].pol[pi].p, n, xa.sc)
                             : R.at(R_P, q * MAXPOL + pi, pF)[R.pos(G_F, j,
                                                                    k)];
      }
    }
    T f[NCOMP], fun[NCOMP];
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      f[q] = fun[q] = T(0);
      if (!U && q >= P.ncurl) continue;
      const CurlC& cc = A.cd[q];
      const CurlP& c = P.curl[q];
      // backward differences of the H partners of this stage
      T dd[2];
      bool hv[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int g = m == 0 ? cc.gp : cc.gm;
        const int ax = U ? (m == 0 ? u_ax1(q) : u_ax2(q))
                         : (m == 0 ? cc.ap : cc.am);
        hv[m] = U || g >= 0;
        dd[m] = T(0);
        if (!hv[m]) continue;
        const T* here = R.at(R_H, g, pH);
        T nb;
        if (ax == 0)
          nb = (W ? xa.live : p > 0) ? R.at(R_H, g, pH0)[ob] : T(0);
        else nb = here[ob - (ax == 1 ? R.row(G_B) : 1)];
        dd[m] = here[ob] - nb;
      }
      const T dfl = curl_delta<T>(hv[0], dd[0], hv[1], dd[1], csgn);
      f[q] = chain<T, U>(R, c, cc, q, 3 + q, px, j, k, fo[q], dfl, uon[q],
                         fuo[q], &fun[q]);
    }
    add_sources<T>(A, 1, s, sr, j, k, f);
    // nonlinear items: D - P of every E component, D then each P in pole order
    T m[NCOMP];
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      m[q] = T(0);
      if (!NL || (!U && q >= P.neh)) continue;
#pragma unroll
      for (int qq = 0; qq < NCOMP; ++qq)
        if (qq == A.ed_of[q]) m[q] = f[qq];
#pragma unroll
      for (int pi = 0; pi < MAXPOL; ++pi)
        if (pi < P.npol && ((A.ee[q].pols >> pi) & 1))
          m[q] = m[q] - pv[q][pi];
    }
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      if (!U && q >= P.ncurl) continue;
      R.at(R_D, q, pD)[o] = f[q];
      if (uon[q] && R.has(R_FUD, q)) R.at(R_FUD, q, pD)[o] = fun[q];
      if (own) {
        ((T*)A.out_d[q])[n] = f[q];
        if (uon[q]) ((T*)A.out_fud[q])[n] = fun[q];
      }
    }
#pragma unroll
    for (int q = 0; q < NCOMP; ++q)
      if (NL && (U || q < P.neh)) R.at(R_M, q, pM)[o] = m[q];
  }
}

// step._sum4 of E component qq's D - P around site (p, o): g, g one site
// along `own` (+1, the E family), one site back along `off`, and both;
// pm: the offsets of planes p - 1, p, p + 1 in the D - P ring
template <typename T>
__device__ __forceinline__ T ring_sum4(const K2Args& A, const Rings<T>& R,
                                       int p, int pm0, int pm1, int pm2,
                                       int o, int qq, int own, int off) {
  const int so = own == 0 ? 0 : (own == 1 ? R.row(G_D) : 1);
  const int sf = off == 0 ? 0 : (off == 1 ? R.row(G_D) : 1);
  const int po = p + (own == 0 ? 1 : 0), pf = p - (off == 0 ? 1 : 0);
  const int pof = po - (off == 0 ? 1 : 0);
  const int lo = pm0, mid = pm1, hi = pm2;
  const T g = R.at(R_M, qq, mid)[o];
  const T gs = po < A.S0 ? R.at(R_M, qq, po > p ? hi : mid)[o + so] : T(0);
  const T gx = pf >= 0 ? R.at(R_M, qq, pf < p ? lo : mid)[o - sf] : T(0);
  const T gsx = (pof >= 0 && pof < A.S0)
                    ? R.at(R_M, qq, pof > p ? hi : (pof < p ? lo : mid))[
                          o + so - sf]
                    : T(0);
  return g + gs + gx + gsx;
}

// E <- chi1inv (D - P) with the chi3 Pade factor and the chi2 NR solve in
// their boxes (nonlinear items), the W chain, the mask, the ADE
template <typename T, bool NL, bool U, int NP, bool W>
__device__ __forceinline__ void e_plane(const K2Args& A, const Rings<T>& R,
                                        const Item& I, int tid, int s, int p,
                                        Span ys, Span zs) {
  const Params& P = A.pd;
  const int S1 = A.S1, S2 = A.S2;
  const bool last = s == A.depth;
  const bool xo = p >= I.i0 && p < I.i1;
  const XAt<T> xa = x_at<T, W>(A, I, p);
  const int px = xa.px;
  const int pE = R.template planew<W>(R_E, p),
            pD = R.template planew<W>(R_D, p);
  const int pF = R.template planew<W>(R_P, p);
  const int pm0 = NL && p > 0 ? R.plane(R_M, p - 1) : 0;
  const int pm1 = NL ? R.plane(R_M, p) : 0;
  const int pm2 = NL ? R.plane(R_M, p + 1) : 0;
  const Range none = {0, 0};
  const Range cr =
      W && xa.virt ? none
                   : plane_range(A.cap_ptr, ((s - 1) * 2 + 1) * A.S0 + p);
  const int nz = zs.hi - zs.lo, cnt = (ys.hi - ys.lo) * nz;
  for (int r = tid; r < cnt; r += K2_NTHR) {
    const int j = ys.lo + r / nz, k = zs.lo + r % nz;
    const int n = (px * S1 + j) * S2 + k;
    const int oe = R.pos(G_E, j, k), od = R.pos(G_D, j, k),
              o = R.pos(G_F, j, k);
    const bool mine = xo && j >= I.j0 && j < I.j1 && k >= I.k0 && k < I.k1;
    const bool own = last && mine;
    // the site's operands from device memory, issued together before the
    // arithmetic that waits for them (each would otherwise be a round trip
    // of its own): the coefficients in their boxes (chi1inv, chi2 / chi3,
    // the NR solve's chi2 and eps, each pole's sigma) and, at stage 1, the
    // input's P, PP and f_w; the rings' values of the stage before
    T us[NCOMP], x2[NCOMP], x3[NCOMP], nrc[NCOMP], nre[NCOMP];
    bool in3[NCOMP], innr[NCOMP];
    T pcur[NCOMP][NP], pp[NCOMP][NP], sg[NCOMP][NP];
    WIn<T> w[NCOMP];
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      us[q] = T(1);
      x2[q] = x3[q] = nrc[q] = nre[q] = T(0);
      in3[q] = innr[q] = false;
#pragma unroll
      for (int pi = 0; pi < NP; ++pi) pcur[q][pi] = pp[q][pi] = sg[q][pi] = T(0);
      if (!U && q >= P.neh) continue;
      const EhP& e = P.eh[q];
      const EhC& ec = A.ee[q];
      if (ec.has_u) us[q] = ((const T*)e.u)[n];
      if (NL) {
        in3[q] = e.chi3 && in_box(A.nl3[q], px, j, k);
        if (in3[q]) {
          x2[q] = ((const T*)e.chi2)[n];
          x3[q] = ((const T*)e.chi3)[n];
        }
        innr[q] = e.nrchi2 && in_box(A.nlnr[q], px, j, k);
        if (innr[q]) {
          nrc[q] = ((const T*)e.nrchi2)[n];
          nre[q] = ((const T*)e.nreps)[n];
        }
      }
#pragma unroll
      for (int pi = 0; pi < NP; ++pi) {
        if (pi >= P.npol || !((ec.pols >> pi) & 1)) continue;
        pcur[q][pi] = s == 1 ? ldx<T, W>(e.pol[pi].p, n, xa.sc)
                             : R.at(R_P, q * MAXPOL + pi, pF)[o];
        pp[q][pi] = s == 1 ? ldx<T, W>(e.pol[pi].pp, n, xa.sc)
                           : R.at(R_PP, q * MAXPOL + pi, pF)[o];
        if (in_box(A.pol[q][pi], px, j, k))
          sg[q][pi] = ((const T*)e.pol[pi].sigma)[n];
      }
      w[q] = w_of<T, U>(R, e, ec, q, 3 + q, px, j, k);
      if (w[q].on) {
        w[q].f = R.at(R_E, q, pE)[oe];
        w[q].fw =
            s == 1 ? ldx<T, W>(e.fw, n, xa.sc) : R.at(R_FWE, q, pF)[o];
      }
    }
    // lin: chi1inv (D - P), the Pade factor in the chi3 box; on nonlinear
    // items the NR solve of every component whose chi2 is nonzero, the
    // components side by side
    T lin[NCOMP], gsv[NCOMP], g1[NCOMP], g2[NCOMP];
    bool nr[NCOMP], any = false;
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      lin[q] = gsv[q] = g1[q] = g2[q] = T(0);
      nr[q] = false;
      if (!U && q >= P.neh) continue;
      const EhP& e = P.eh[q];
      const EhC& ec = A.ee[q];
      T gs = R.at(R_D, A.ed_of[q], pD)[od];
#pragma unroll
      for (int pi = 0; pi < NP; ++pi)
        if (pi < P.npol && ((ec.pols >> pi) & 1)) gs = gs - pcur[q][pi];
      T l = ec.has_u ? gs * us[q] : gs;
      if (NL) {
        // step._sum4 of partner qq's D - P, the partner's axis `off`
        auto sum4 = [&](int qq, int off) {
          return ring_sum4<T>(A, R, p, pm0, pm1, pm2, od, qq, (int)e.ax_own,
                              off);
        };
        if (in3[q]) {
          T Dsqr = gs * gs;
          if (e.dc1 >= 0)
            Dsqr = dsqr_add<T>(Dsqr, sum4((int)e.dc1, (int)e.ax_1));
          if (e.dc2 >= 0)
            Dsqr = dsqr_add<T>(Dsqr, sum4((int)e.dc2, (int)e.ax_2));
          l = pade<T>(l, gs, Dsqr, x2[q], x3[q], us[q]);
        }
        nr[q] = innr[q] && nrc[q] != T(0);
        if (nr[q]) {
          any = true;
          if (e.dc1 >= 0) g1[q] = T(0.25) * sum4((int)e.dc1, (int)e.ax_1);
          if (e.dc2 >= 0) g2[q] = T(0.25) * sum4((int)e.dc2, (int)e.ax_2);
        }
      }
      gsv[q] = gs;
      lin[q] = l;
    }
    if (NL && any) {
      T x[NCOMP];
      nr_solve_n<T, NCOMP>(gsv, g1, g2, nre, nrc, P.nr_iters, x);
#pragma unroll
      for (int q = 0; q < NCOMP; ++q)
        if (nr[q]) lin[q] = x[q];
    }
    // the new E (the W chain, the mask) and the ADE of each pole from the
    // drive W
    T fnew[NCOMP], pn[NCOMP][NP];
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      fnew[q] = T(0);
      if (!U && q >= P.neh) continue;
      fnew[q] = w_value<T>(lin[q], w[q]);
      const T Wd = (U || A.ee[q].wax >= 0) ? lin[q] : fnew[q];
#pragma unroll
      for (int pi = 0; pi < NP; ++pi)
        pn[q][pi] = ade_value<T>(P, pi, Wd, sg[q][pi], pcur[q][pi],
                                 pp[q][pi]);
    }
    // the stores
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      if (!U && q >= P.neh) continue;
      const EhC& ec = A.ee[q];
      R.at(R_E, q, pE)[oe] = fnew[q];
      if (w[q].on && R.has(R_FWE, q)) R.at(R_FWE, q, pF)[o] = lin[q];
      if (own) {
        ((T*)A.out_e[q])[n] = fnew[q];
        if (w[q].on) ((T*)A.out_fwe[q])[n] = lin[q];
      }
      if (mine && cr.a < cr.b) capture<T>(A, cr, q, j, k, fnew[q]);
#pragma unroll
      for (int pi = 0; pi < NP; ++pi) {
        if (pi >= P.npol || !((ec.pols >> pi) & 1)) continue;
        const int c = q * MAXPOL + pi;
        R.at(R_P, c, pF)[o] = pn[q][pi];
        R.at(R_PP, c, pF)[o] = pcur[q][pi];
        if (own) {
          ((T*)A.out_p[q][pi])[n] = pn[q][pi];
          ((T*)A.out_pp[q][pi])[n] = pcur[q][pi];
        }
      }
    }
  }
}

// ---- the x-march of one item -----------------------------------------

// bring plane p of the input's E (every component) into its ring slot;
// sites outside the storage read zero; `in`: p is one of the item's
// planes (W: an image across the wrap by plain loads times the plane's
// scale)
template <typename T, bool W>
__device__ __forceinline__ void e_issue(const K2Args& A, const Rings<T>& R,
                                        const Item& I, int tid, int p,
                                        int plo, int phi, bool in) {
  if (p < plo || p >= phi || !in) return;
  const XAt<T> xa = x_at<T, W>(A, I, p);
  const int rz = R.C->rz[G_E], pw = R.C->pw[G_E], below = R.C->below[G_E];
  const int base = xa.px * A.S1 * A.S2, pl = R.template planew<W>(R_E, p);
  for (int q = 0; q < A.pd.neh; ++q) {
    const T* src = (const T*)A.pd.eh[q].f + base;
    T* dst = R.at(R_E, q, pl);
    for (int o = tid; o < pw; o += K2_NTHR) {
      const int j = R.j0 - below + o / rz, k = R.k0 - below + o % rz;
      if (j >= 0 && j < A.S1 && k >= 0 && k < A.S2) {
        if (W && xa.virt)
          dst[o] = xa.sc * src[j * A.S2 + k];
        else
          cp_async<T>(dst + o, src + j * A.S2 + k);
      } else {
        dst[o] = T(0);
      }
    }
  }
}

__device__ __forceinline__ Span clip(int lo, int hi, int n) {
  Span s = {lo < 0 ? 0 : lo, hi > n ? n : hi};
  return s;
}

// NL: h = 2 (the neighbour sums of E reach D - P at +-1), else h = 1.  At
// step t stage s updates B/H and D on plane t - (s-1) h and E on the plane
// h - 1 behind.  Along each axis stage s covers the output grown by
// (depth - s) g, B/H from g below to g - 1 above that, D g - 1 on both
// sides, with g = h on every side of a linear item; a side of a nonlinear
// item grows by g = 1 where its bit in I.wide is clear: no stage's E
// region, so grown, holds a chi2/chi3 site in its edge layer there, so
// nothing reads D - P beyond it (ops/fdtd3d_t2.py::side_widths, regions,
// march_order).
template <typename T, bool NL, bool U, int NP, bool MIR, bool W>
__device__ __forceinline__ void march(const K2Args& A, const K2Class& C,
                                      const Item& I, T* sm, int tid) {
  constexpr int h = NL ? 2 : 1, n = h - 1, L = h;
  const int d = A.depth;
  int ga[3], gb[3];                   // growth below / above per axis
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    ga[ax] = NL && !((I.wide >> (2 * ax)) & 1) ? 1 : h;
    gb[ax] = NL && !((I.wide >> (2 * ax + 1)) & 1) ? 1 : h;
  }
  Rings<T> R;
  R.sm = sm;
  R.C = &C;
  R.j0 = I.j0;
  R.k0 = I.k0;
  for (int e = tid; e < C.tab; e += K2_NTHR) sm[e] = T(0);
  fill_rows<T>(A, R, tid);
  __syncthreads();
  const int plo = I.i0 - d * ga[0], phi = I.i1 + d * gb[0];
  const int t0 = plo, t1 = I.i1 + n + (d - 1) * L;
  // the x-planes the item may compute: the storage's; W: a live item's
  // region is not clipped (its planes outside [0, wn) are images across
  // the wrap), a dead item's is [wn, S0)
  const bool live = W && I.i1 <= A.wn;
  const auto inx = [&](int p) {
    return W ? live || (p >= A.wn && p < A.S0) : p >= 0 && p < A.S0;
  };
  e_issue<T, W>(A, R, I, tid, t0, plo, phi, inx(t0));
  cp_commit();
  e_issue<T, W>(A, R, I, tid, t0 + 1, plo, phi, inx(t0 + 1));
  cp_commit();
  for (int t = t0; t < t1; ++t) {
    e_issue<T, W>(A, R, I, tid, t + 2, plo, phi, inx(t + 2));
    cp_commit();
    cp_wait1();
    __syncthreads();
    for (int s = 1; s <= d; ++s) {
      const int e = d - s;
      const int b = t - (s - 1) * L;
      const int xlo = I.i0 - e * ga[0], xhi = I.i1 + e * gb[0];
      const int ylo = I.j0 - e * ga[1], yhi = I.j1 + e * gb[1];
      const int zlo = I.k0 - e * ga[2], zhi = I.k1 + e * gb[2];
      if (b >= xlo - ga[0] && b < xhi + gb[0] - 1 && inx(b)) {
        b_plane<T, U, W>(A, R, I, tid, s, b,
                      clip(ylo - ga[1], yhi + gb[1] - 1, A.S1),
                      clip(zlo - ga[2], zhi + gb[2] - 1, A.S2));
        __syncthreads();
      }
      if (b >= xlo - ga[0] + 1 && b < xhi + gb[0] - 1 && inx(b)) {
        const Span dys = clip(ylo - ga[1] + 1, yhi + gb[1] - 1, A.S1);
        const Span dzs = clip(zlo - ga[2] + 1, zhi + gb[2] - 1, A.S2);
        // a block-uniform test: only items whose region meets a plane
        if constexpr (MIR) {
          if ((dys.lo == 0 && (A.mir & 1)) || (dzs.lo == 0 && (A.mir & 2))) {
            ghost_plane<T>(A, R, tid, b, dys, dzs);
            __syncthreads();
          }
        }
        d_plane<T, NL, U, W>(A, R, I, tid, s, b, dys, dzs);
        // a linear E reads D only at its own site, which the same thread
        // updated (the D and E regions coincide)
        if (NL) __syncthreads();
      }
      const int pe = b - n;
      if (pe >= xlo && pe < xhi && inx(pe)) {
        e_plane<T, NL, U, NP, W>(A, R, I, tid, s, pe, clip(ylo, yhi, A.S1),
                              clip(zlo, zhi, A.S2));
        __syncthreads();
      }
    }
  }
}

// ---- the kernel ---------------------------------------------------------

// one block per item of class NL (0 linear, 1 nonlinear); NP: the poles a
// site holds (a compile-time bound on P.npol: 1 or MAXPOL); MINB: the
// blocks an SM should hold by their registers (2: at most 64 registers a
// thread; the linear class's variant when two blocks' rings fit an SM)
template <typename T, bool NL, bool U, int NP, int MINB, bool MIR, bool W>
__global__ void __launch_bounds__(K2_NTHR, MINB)
k2_kernel(const __grid_constant__ K2Args A) {
  T* sm = (T*)K2_SMEM;
  const int* it =
      (const int*)A.items + 8 * ((NL ? A.nitems[0] : 0) + blockIdx.x);
  const Item I = {it[0], it[1], it[2], it[3], it[4], it[5], it[6]};
  march<T, NL, U, NP, MIR, W>(A, A.cls[NL ? 1 : 0], I, sm, threadIdx.x);
}

// whether the plan has the standard uPML layout (u_ax1 ...) in both
// families
static bool upml_layout(const K2Args& A) {
  if (A.pb.ncurl != NCOMP || A.pd.ncurl != NCOMP || A.pb.neh != NCOMP ||
      A.pd.neh != NCOMP)
    return false;
  for (int q = 0; q < NCOMP; ++q) {
    for (const CurlC* c : {&A.cb[q], &A.cd[q]})
      if (c->gp < 0 || c->gm < 0 || c->ap != u_ax1(q) ||
          c->am != u_ax2(q) || c->sax != u_ax1(q) || c->uax != u_ax2(q))
        return false;
    if (A.eh[q].wax != q || A.ee[q].wax != q) return false;
  }
  return true;
}

template <typename T, bool NL, bool U, int NP, int MINB, bool MIR,
          bool W = false>
static int launch_m(const K2Args* a, cudaStream_t s) {
  const size_t smem = (size_t)a->cls[NL ? 1 : 0].words * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        k2_kernel<T, NL, U, NP, MINB, MIR, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  void* args[] = {(void*)a};
  cudaError_t rc = cudaLaunchKernel(k2_kernel<T, NL, U, NP, MINB, MIR, W>,
                                    dim3((unsigned)a->nitems[NL ? 1 : 0]),
                                    dim3(K2_NTHR), args, smem, s);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// the fold ghosts (MIR) only in the variants of mirrored plans: built into
// every variant, they cost the march registers (and spills) on every plan
template <typename T, bool NL, bool U, int NP, int MINB>
static int launch_v(const K2Args* a, cudaStream_t s) {
  return a->mir ? launch_m<T, NL, U, NP, MINB, true>(a, s)
                : launch_m<T, NL, U, NP, MINB, false>(a, s);
}

// Launch the variant of item class NL for the plan: the uPML layout as
// compile-time values or not, one pole or up to MAXPOL, and for linear
// items two blocks an SM or one (nonlinear items: one).
template <typename T, bool NL>
static int launch_c(const K2Args* a, cudaStream_t s) {
  const bool u = upml_layout(*a), one = a->pd.npol <= 1;
  if constexpr (NL) {
    if (u)
      return one ? launch_v<T, NL, true, 1, 1>(a, s)
                 : launch_v<T, NL, true, MAXPOL, 1>(a, s);
    return one ? launch_v<T, NL, false, 1, 1>(a, s)
               : launch_v<T, NL, false, MAXPOL, 1>(a, s);
  } else {
    const bool two = a->pair != 0;
    if (a->wn) {
      // the x Bloch wrap: linear items, at most one pole, no mirror
      if (u)
        return two ? launch_m<T, NL, true, 1, 2, false, true>(a, s)
                   : launch_m<T, NL, true, 1, 1, false, true>(a, s);
      return two ? launch_m<T, NL, false, 1, 2, false, true>(a, s)
                 : launch_m<T, NL, false, 1, 1, false, true>(a, s);
    }
    if (u) {
      if (one)
        return two ? launch_v<T, NL, true, 1, 2>(a, s)
                   : launch_v<T, NL, true, 1, 1>(a, s);
      return two ? launch_v<T, NL, true, MAXPOL, 2>(a, s)
                 : launch_v<T, NL, true, MAXPOL, 1>(a, s);
    }
    if (one)
      return two ? launch_v<T, NL, false, 1, 2>(a, s)
                 : launch_v<T, NL, false, 1, 1>(a, s);
    return two ? launch_v<T, NL, false, MAXPOL, 2>(a, s)
               : launch_v<T, NL, false, MAXPOL, 1>(a, s);
  }
}

extern "C" {

i64 mnt_k2_args_size(void) { return (i64)sizeof(K2Args); }

// the largest output tile this library was built with, and the threads of
// a block
void mnt_k2_tile(int* out) {
  out[0] = K2_TY;
  out[1] = K2_TZ;
  out[2] = K2_NTHR;
}

// the card's shared memory: a block's most (opt-in), an SM's, and what
// the card reserves of it per block, in bytes; or the cudaError
int mnt_k2_smem(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const cudaDeviceAttr attr[3] = {cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                  cudaDevAttrReservedSharedMemoryPerBlock};
  for (int i = 0; i < 3 && e == cudaSuccess; ++i)
    e = cudaDeviceGetAttribute(&out[i], attr[i], dev);
  return (int)e;
}

// Launch item class `nl` (0 linear, 1 nonlinear) on `stream`, with the
// uPML layout as compile-time values when the plan has it, the x Bloch
// wrap's variant for an x-periodic plan (linear items only); the wrapper
// puts the nonlinear class on a stream of higher priority, forked from and
// joined back to the caller's, so that its few long blocks take SMs first
// and the linear ones fill the rest.  Returns the cudaError, else 0.
int mnt_k2_launch(const K2Args* a, int nl, int fp64, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->depth < 2 || a->depth > 3 || a->pd.npol > MAXPOL || has_nl(a->pb) ||
      a->nitems[nl ? 1 : 0] == 0 ||
      (a->wn && (nl || a->mir || a->pd.npol > 1)))
    return (int)cudaErrorInvalidValue;
  return fp64 ? (nl ? launch_c<double, true>(a, s)
                    : launch_c<double, false>(a, s))
              : (nl ? launch_c<float, true>(a, s)
                    : launch_c<float, false>(a, s));
}

}  // extern "C"
