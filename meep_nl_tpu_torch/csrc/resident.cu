// K3 and K4 on Hopper: a whole chunk of Yee steps of a small grid (every 2D
// cell, small 3D cells) in ONE cooperative launch, with the sources, the
// DTFT and (K4) the probe series inside the time loop.  Written by hand for
// sm_90a, bound through a plain C interface (ctypes).
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
// plan being (S0, S1, 1).  K4 is the same kernel with probes: after every
// step one thread per probe sums w * f over the probe's points in point
// order from 0.0f (resident.py:336-339) into its series.
//
// Design: temporal blocking in shared-memory tiles, one grid barrier per
// pass of T steps.
//   * The grid is cut into tiles (rectangles in 2D, boxes in 3D; tile
//     extents, T and the halos come from ops/resident.py::tiling).  A pass
//     runs T steps (fewer in the chunk's last pass).  In a pass a block
//     stages its tile grown by a halo -- every array the step reads per
//     site: the state (f, f_u, f_w, P and PP) and the per-site
//     coefficients (chi1inv, the chi2/chi3 arrays, the ADE sigmas) -- in
//     shared memory, runs the pass's steps there with block barriers only,
//     then writes its tile's interior into the other of two state sets:
//     the kernel is out of place, so no block reads what another writes
//     within a pass.  One grid.sync() ends each pass.  The grid is
//     min(tiles, co-resident blocks); a block loops over tiles when there
//     are more.  A launch runs at most MAX_CHUNK steps; the wrapper hands
//     the input set over and returns the set the last pass wrote.
//   * The valid region shrinks as the steps go: the B curl reads E at +1,
//     the D curl H at -1, and E reads the neighbours' D - P at +-1 where it
//     has chi2/chi3 partner sums (e_local false).  So each step costs the
//     region c = 1 + (E reads neighbours) sites on every side, and the
//     staged box of a pass of Tp steps is the interior grown by Tp * c
//     below and Tp * c + e above, e = 1 on the axes along which a DTFT
//     monitor's centred average reads the next site.  In step r of the
//     pass (valid region grown by L = (Tp - r) c below, L + e above) the
//     B curl and H run on the region grown by (L, L + e - 1), the D curl on
//     (L - 1, L + e - 1), E and the ADE on (L - 1 - nl, L + e - 1 - nl),
//     all clipped to the grid, where the plain version's zero boundary is
//     exact.  No computed site reads past its staged box except across the
//     grid's edge.
//   * Each tile's parameter blocks become descriptors of its staged box
//     (build_fam): the per-site arrays, which the wrapper names by slot
//     tokens (slot + 1), as float offsets into the tile's shared memory,
//     the per-axis vectors (PML profiles, alive masks) at the box's origin,
//     the box's local strides.  A sub-update runs component by component,
//     the component's descriptor in registers, every site's arithmetic
//     through the value functions of fdtd3d_site.cuh (curl_value, pade,
//     nr_solve, w_value, ade_value) in the plain version's order; its
//     bound checks on the box's edge are the grid's, by the rule above.
//   * The P/PP roles swap every step (A.pb / A.pd by step parity), as in
//     the plain version; an odd step count hands the buffers back swapped.
//   * Sources: per family, the wrapper lists the sites where any source's
//     dense amplitude arrays are nonzero, each with every source's (re, im)
//     amplitude in source order, and per tile the sites in its staged box
//     (halo sites included); a block applies them, on the steps whose flags
//     say so, in source order per site as the plain version's f -= (w_re
//     dre - w_im dim) dt does over the whole dense array.  Only f is
//     touched.
//   * DTFT: the tile that owns a region site updates its accumulators on
//     each sample step (per site and frequency in the plain order).
//   * Probes (K4): the tile that owns a probe point writes w * f for each
//     step of the pass into a (T, points) buffer, double-buffered by pass
//     parity; after the pass's barrier (during the next pass) one thread
//     per probe and step sums the points in point order from 0.0f.
//   * The direct schedule, for plans where tiles give no temporal reuse
//     (tiling() finds only T = 1, no tile fits, or more than MAXSLOT
//     arrays): no staging and no second set.  The wrapper lays the state
//     arrays, the per-site coefficients and the per-axis vectors out in one
//     device buffer (A.base, the same offsets as a staged box that is the
//     whole grid), the whole grid is one tile whose sites the grid's
//     threads share, and the step's sub-updates run in place with a grid
//     barrier where a tile pass has a block barrier (2-7 a step).
//   * Fold ghosts: below a fold plane on whole sites the D curl's backward
//     difference reads a ghost instead of the zero fill.  A node mirror's
//     is sign * g[k0] on the partner's own column, inside any staged box
//     (gk / gs, every schedule).  A rotational fold's reads across the
//     grid -- C2: the partner flipped over the flip axis's live extent at
//     row k0; C4: the x<->y-swapped component, transposed -- so rotational
//     plans take the direct schedule, where every H value is visible when
//     the D curl runs, in its ROT variant (Tiling.direct = 2), whose D
//     curl reads gs * base[gsrc slot][site + goff + j * gmul] (j the
//     site's index along gax, zero where j >= glim); the other variants
//     are compiled without it.
//   * The Bloch wrap: on a periodic axis of live extent n (A.wn, real
//     phase ph = A.wph), the B curl's forward difference at plane n - 1
//     reads ph g(0), the D curl's backward difference at plane 0 reads
//     (1 / ph) g(n - 1), the centred DTFT's read past plane n - 1 is
//     ph times plane 0, and a dead plane's read across the axis is zero
//     (step._sh).  These reads cross the grid, so periodic plans take the
//     direct schedule in its WRAP variant (Tiling.direct = 3).
//   * Complex fields as a real pair (plan.real_pair): the direct schedule
//     in its PAIR variant (Tiling.direct = 4, linear plans only: pair
//     fields refuse chi2/chi3).  The buffer holds the single-channel
//     layout twice, channel 0 (re) at A.base and channel 1 (im) A.half
//     floats on, the coefficients and vectors copied into both halves, so
//     a channel is the one-channel kernel on its half and the two share
//     every descriptor.  They meet where the Bloch wrap reads across the
//     grid with a complex phase ph = a + i b (A.wph / A.wphim, 1 / ph in
//     A.wphi / A.wphii): the wrapped read of channel 0 is a own - b other,
//     of channel 1 b other + a own (other: the partner channel's value,
//     step._sh's rotation); channel 1's sources read the waveform rows
//     swapped, (w_re, w_im) -> (w_im, -w_re), which gives Im(w amp); the
//     DTFT accumulates the complex field times the complex weight, the
//     centred average's wrapped read rotated axis by axis as the plain
//     version's passes; K4's products and series are (re, im) pairs of the
//     complex weights (interleaved in A.pr.w) times the complex field.
//   * BFAST (the fork's fixed-angle broadband term, step._bfast_update):
//     a BFAST plan has complex fields, so it runs as a real pair, in the
//     PAIR variant with the term compiled in (Tiling.direct = 5).  Right
//     after a two-partner curl component's update at a site, the same
//     thread updates its flip-flop auxiliary F (a state slot) and adds the
//     change to f (and f_u) through the chains, channel by channel: A =
//     (k1 pair(g+) - k2 pair(g-)) bftap, F_new = A - gam F_prev, delta =
//     F_new - F_prev, pair(g) the partner plus its neighbour read as the
//     curl reads it (across the wrap, zero off the grid), bftap a per-site
//     coefficient slot, gam the chains' decay (kap - sig) siginv or,
//     without a chain, the E/H component's W chain's (kapw - sigw) /
//     (kapw + sigw) (A.bf, A.bt, A.bw, A.bk).  The term reads only the partners (not updated in this
//     half) and the site's own arrays, so no barrier is added.
//   * Cylindrical cells and 2D cells with an out-of-plane wavenumber beta
//     (special_kz; step._curl, step._axis_specials): the direct schedule
//     in its CYL variants, real fields (m = 0: Tiling.direct = 6) or a
//     real pair (m != 0, beta, or complex m = 0: Tiling.direct = 7, the
//     PAIR variant's reads across a wrap included).  Per curl component the
//     wrapper's table A.cyl (CylP, ops/resident.py::_cyl_table) names the
//     r-profiles, per-axis vectors along r (axis 0) staged like the PML
//     profiles: a z component's r-weighted difference rfinv(r) * diff(rg *
//     g) (rg at the partner's r, the backward difference zero at r = 0 as
//     step._sh fills), and the phi term i (phi_sign sgn Courant) imr f[phi]
//     (imr = m dx / r, or beta dx as a constant), which on a pair is a
//     channel rotation of the partner at the same site, (re, im) -> (-s im,
//     s re) times imr, added to the curl's delta before the chains.  Then,
//     at the r = 0 site, after its chains and the mask, the thread that
//     updated the component adds the reference's axis correction (the
//     partner at ring 0 or 1 times a real or, on the pair, an imaginary
//     factor) to f only, never to f_u / f_w, and applies the mask again.
//     The corrections read only the other family's fields (H in the D
//     half, E ring 1 for br in the B half), which no thread writes in that
//     sub-update, so they need no barrier of their own.
//   * Anisotropic media (step._offdiag, step._pol_update_lorentzian's
//     off-diagonal sigma, step._pol_update_gyro): two compile-time modes
//     (AX, from A.axmode; linear real fields without a wrap; OFFDIAG on
//     tiles or the plain direct schedule, GYRO on the plain direct
//     schedule only), whose tables the wrapper puts in device
//     memory (A.ax, AxTab).  OFFDIAG: E's update adds each off-diagonal
//     chi1inv row's average 0.25 (t + t'), t = (g1 + g1 shifted) u1 at the
//     site and one site along its own axis, g1 the partner's D - P, so E
//     reads its neighbours (not site-local, c = 2).  GYRO: a pole that
//     reads its partners' W at neighbouring sites (a gyrotropic one, a
//     Lorentzian one with off-diagonal sigma) cannot be fused into the
//     thread that updated E at its site; such poles run in a sub-update
//     of their own after the family's E (H) and a grid barrier (sep_all,
//     over the whole grid); the other poles stay fused.  The new P of a
//     pole goes into its previous P's arrays, as the fused ADE's does.
//     A tiled GYRO variant (the pole sub-update on a box one site smaller,
//     c grown by one) spilled and ran 1.54x slower, so there is none.
//   * Per-step inputs: the source currents (nsteps, nsrc, 2) and the DTFT
//     phase rows (nsteps, nfreq) of build_xs, uploaded once per launch, and
//     a per-step flag word saying which of them are nonzero: a step whose
//     currents of a family are all zero skips that family's sources, one
//     whose phase rows are all zero skips the DTFT (the plain version adds
//     exact zeros there).
//
// Block barriers of one step: B curl (+ H) | [B sources | H |] D curl
// (+ E, fused when E is site-local and no D source is on) | [[D sources |]
// E |] DTFT, probe products |.  The co-resident grid is sized per device
// (mnt_k3_max_blocks: occupancy of the variant at its shared memory, which
// the wrapper asks once per device, variant and shared memory).

#include <cooperative_groups.h>

#include "fdtd3d_site.cuh"

namespace cg = cooperative_groups;

#define NTHR 512        // threads per block (the nonlinear variant: half,
                        // for registers without spill)
#define MAXSLOT 96      // staged arrays (tiles; the direct schedule has
                        // no limit)
#define STEP_BSRC 1
#define STEP_DSRC 2
#define STEP_DFT 4

#ifdef MNT_CUDA_STUB
#define K3_SMEM ((float*)stub_dynamic_smem())
#else
extern __shared__ __align__(16) float k3_smem[];
#define K3_SMEM k3_smem
#endif

// Mirrored by meep_nl_tpu_torch/ops/resident.py; every member is 8 bytes.
struct DftM {
  void* acc;            // (nfreq, 2, R) frequency-major accumulators
  const void* f;        // slot token of the field component it reads
  const void* w;        // (R) weights of the region sites (real parts)
  const void* wi;       // (R) imaginary parts, or null: real weights
  const void* phr;      // (nsteps, nfreq) phase rows
  const void* phi;
  i64 nfreq, R;         // frequencies, region sites
  i64 lo[3], n[3];      // region origin and extents per axis (n = 1: absent)
  i64 navg, avg[3];     // axes of the centred average, ascending
};

struct SrcFam {         // one family's sources, by site
  const void* slot_off;    // (nslot) int32 flat offset of the site
  const void* slot_q;      // (nslot) int32 index into Params.curl[]
  const void* slot_start;  // (nslot + 1) int32: the site's contributions
  const void* c_src;       // int32 source index (column of the currents)
  const void* c_re;        // float dense_re / dense_im at the site
  const void* c_im;
  const void* tstart;      // (ntile + 1) int32: each tile's entries
  const void* tslot;       // int32 sites (slot indices) in the tile's box
  i64 nslot;
};

struct Probes {         // K4: the probes' points, probe after probe
  const void* off;         // (npt) int32 flat offsets
  const void* tok;         // (npt) int32 slot token of the component
  const void* w;           // (npt) float weights
  const void* start;       // (nprobe + 1) int32: each probe's points
  const void* tstart;      // (ntile + 1) int32: each tile's entries
  const void* tpt;         // int32 points in the tile's interior
  void* series;            // (nprobe, nsteps) float
  void* prod;              // (2, T, npt) float: w * f by pass parity, step
  i64 nprobe, npt;
};

struct Tiling {         // ops/resident.py::tiling
  i64 t[3];                // tile interior extents
  i64 nt[3];               // tiles per axis
  i64 e[3];                // sites past the interior's upper side the
                           // pass's last step leaves valid (the DTFT)
  i64 T;                   // steps of a full pass
  i64 c;                   // sites per side a step costs the valid region
  i64 vol;                 // floats per slot (the largest staged box)
  i64 nslot, nstate;       // staged arrays; the first nstate are written
  i64 nvec, gvec;          // staged per-axis vectors, floats each
  i64 direct;              // 1: the direct schedule (one tile, T = 1)
};

struct ResArgs {
  Params pb[2], pd[2];  // [step parity]: the P/PP roles of that step;
                        // per-site arrays as slot tokens
  SrcFam src[2];        // 0: B family, 1: D family
  Probes pr;
  Tiling tl;
  const void* set[2][MAXSLOT];  // each slot's array in state set 0 and 1
  const void* vec;      // (nvec, 2) int64: each per-axis vector's address
                        // and axis
  void* base;           // the direct schedule's buffer (nslot arrays of
                        // vol floats, then nvec vectors of gvec floats)
  const DftM* dft;      // (ndft) monitors
  const void* cur;      // (nsteps, nsrc, 2) float source currents
  const void* flags;    // (nsteps) int32 STEP_* bits
  double dt;
  i64 nsteps, nsrc, ndft;
  i64 e_local;          // 1: E from D reads no neighbour (fusable)
  // the D curl's node-mirror fold ghosts (ops/resident.py::set_ghosts):
  // for D component q and partner m (0 gp, 1 gm) the row k0 and the sign
  // (0: none) of sign * g[k0], read below plane 0 of the partner's axis
  i64 gk[NCOMP][2];
  double gs[NCOMP][2];
  // the rotational fold ghosts (the ROT variant of the direct schedule,
  // whose box is the grid; set_ghosts): the ghost below plane 0 is
  // gs * the array of slot token gsrc (0: none) at the site's offset +
  // goff + j * gmul, j the site's index along axis gax, 0 where j >= glim
  i64 gsrc[NCOMP][2], goff[NCOMP][2], gmul[NCOMP][2], gax[NCOMP][2],
      glim[NCOMP][2];
  // the Bloch wrap (the WRAP variant of the direct schedule; set_ghosts):
  // per axis the live extent n (0: not periodic), the phase and its
  // inverse
  i64 wn[3];
  double wph[3], wphi[3];
  // the PAIR variant (direct schedule): the imaginary parts of the phase
  // and of its inverse, and the floats from channel 0's half of the
  // buffer to channel 1's
  double wphim[3], wphii[3];
  i64 half;
  // BFAST (the PAIR variant with the term, Tiling.direct 5; ops/resident.py
  // _bfast_table): per family (0 B, 1 D) and curl component the slot
  // tokens of F and of the taper (0: none; F 0: no term), the E/H
  // component whose W chain gives the decay where the curl has no chain
  // (-1: none), and k1, k2
  i64 bf[2][NCOMP], bt[2][NCOMP], bw[2][NCOMP];
  double bk[2][NCOMP][2];
  // the CYL variants (Tiling.direct 6, 7): the (2, NCOMP) CylP table in
  // device memory, per family (0 B, 1 D) and curl component; null in
  // every other variant
  const void* cyl;
  // the anisotropic modes (AX_OFFDIAG, AX_GYRO; 0: neither): the AxTab in
  // device memory (null with mode 0)
  i64 axmode;
  const void* ax;
};

// the anisotropic modes: off-diagonal chi1inv rows in E's update
// (OFFDIAG), and besides them poles that run in a sub-update of their own
// after the family's E (H): gyrotropic ones, Lorentzian ones with
// off-diagonal sigma rows (GYRO)
enum { AX_NONE = 0, AX_OFFDIAG = 1, AX_GYRO = 2 };

// one pole's update at one component (ops/resident.py::_ax_table; every
// member 8 bytes): kind -1: the pole has no entry at the component, 0: a
// Lorentzian with off-diagonal sigma rows, 1: a gyrotropic Lorentzian /
// Drude, 2: a saturated gyrotropic one; slot tokens of the entries along
// the component's own direction and the two cycled ones (p: the array the
// even steps read as the current P, pp: as the previous one, which the
// new P replaces; 1, 2 gyrotropic only); coefficient tokens of the
// diagonal sigma and (kind 0) the off-diagonal rows along the cycled
// directions (0: none); w: the E (H) index of the drive field along the
// own and the cycled directions (-1: none); av: per cycled direction how
// its W is averaged onto the site (step.gyro_avg; kind 0: the OFFDIAG
// average): mode (0 none, 1 four sites, 2 two along the own axis, 3 two
// along the partner's), the own axis, the partner's axis; k, c, inv: the
// update's constants (kind 1: diag, gamma1, omega0dtsqr; kind 2: -w2pidt,
// alpha / 2, dt2pi, g2pidt; c: the r rows' partner factors c01, c02, c10,
// c12, c21, c20; inv the 3x3 solve), step._pol_update_gyro's values
struct SepP {
  i64 kind;
  i64 p[3], pp[3];
  i64 sig, so[2];
  i64 w[3];
  i64 av[2][3];
  double k[4], c[6], inv[9];
};

struct AxTab {
  i64 u1[2][NCOMP], u2[2][NCOMP];  // per family and E (H) component: the
                                   // coefficient tokens of the off-diagonal
                                   // chi1inv rows (0: none)
  i64 sep[2];                      // per family: bit p, pole p runs in the
                                   // pole sub-update (else fused in E / H)
  SepP pole[2][MAXPOL][NCOMP];
};

// one curl component's cylindrical / beta terms (ops/resident.py
// _cyl_table; every member 8 bytes): vector tokens (vector + 1, 0: none)
// of rg and rfinv (the r-weighted difference of gp) and imr; the slot
// token of the phi partner (0: none), its factor ps = phi_sign sgn Courant
// and imr's constant where it has no vector (beta dx); the axis
// correction at r = 0: the slot token of its partner (0: none), the
// partner's ring and the factor are + i aim
struct CylP {
  i64 rg, rfinv, imr, phi;
  double ps, imc;
  i64 ag, ar;
  double are, aim;
};

// the direct schedule's ghost reads: none, the rotational folds' (ROT),
// the Bloch wrap's (WRAP), the Bloch wrap of a real pair (PAIR), the same
// with BFAST's term (PAIRBF), the cylindrical / beta terms on real
// fields (CYL) and on a real pair (PAIRCYL, with the PAIR variant's wrap)
enum {
  GK_NONE = 0,
  GK_ROT = 1,
  GK_WRAP = 2,
  GK_PAIR = 3,
  GK_PAIRBF = 4,
  GK_CYL = 5,
  GK_PAIRCYL = 6
};

// the box a block stages in a pass: origin and extents in the grid
struct Box {
  int o[3], n[3];
};

// A family's parameter block of one step parity on a tile's staged box:
// the staged arrays as float offsets into the tile's shared memory (-1:
// absent; from the wrapper's slot tokens), the per-axis vectors at the
// box's origin, local strides.  Built per tile (build_fam); the sub-update
// loops copy one component's descriptor into registers.
struct CurlT {
  int f, fu, gp, gm;
  int ap, am;               // derivative axes of gp / gm
  int stp, stm;             // their local strides
  int sig_ax, sigu_ax;      // chain axes (-1: none)
  int kap, sig, siginv, kapu, sigu, siginvu;   // staged vectors
  int alive[3];             // -1: all 1
  int gop, gom;             // a fold ghost below plane 0 of ap / am: its
  float gsp, gsm;           //   row's local offset k0 * st and sign (0:
                            //   none: the box does not start at a plane)
};

struct EhT {
  int f, fw, d, u, nreps, nrchi2, chi3, chi2;
  int w_ax;                 // W chain axis (-1: none)
  int dc1, dc2, ax_own, ax_1, ax_2;
  int kapw, sigw;
  int alive[3];
};

struct PolT {               // one E/H component's poles (indexed at run
  int p[MAXPOL], pp[MAXPOL], sigma[MAXPOL];   // time: read in place)
};

struct FamS {               // the family's scalars
  float pg1inv[MAXPOL], pg1[MAXPOL], p2md[MAXPOL], pw2[MAXPOL];
  float csgn;
  int ncurl, neh, npol, sgn, nr_iters;
};

struct FamT {
  CurlT curl[NCOMP];
  EhT eh[NCOMP];
  PolT pol[NCOMP];
  FamS s;
};

__device__ __forceinline__ int off_of(const void* tok, int vol) {
  return tok ? ((int)(uintptr_t)tok - 1) * vol : -1;
}

// a staged per-axis vector's offset from its token (vector + 1; the
// vectors follow the slots, gvec floats each)
__device__ __forceinline__ int vec_of(const void* tok, const Tiling& tl) {
  return tok ? (int)(tl.nslot * tl.vol + ((i64)(uintptr_t)tok - 1) * tl.gvec)
             : -1;
}

__device__ __forceinline__ int lstride(const Box& b, i64 ax) {
  return ax == 0 ? b.n[1] * b.n[2] : (ax == 1 ? b.n[2] : 1);
}

// piece `w` (0-2: curl component, 3-5: E/H component, 6: scalars) of the
// descriptor of parameter block P on box b
__device__ void build_fam(FamT& F, const Params& P, int w, const Box& b,
                          const Tiling& tl, const ResArgs* ghosts) {
  const int vol = (int)tl.vol;
  if (w < 3 && w < P.ncurl) {
    const CurlP& c = P.curl[w];
    CurlT& t = F.curl[w];
    t.f = off_of(c.f, vol);
    t.fu = off_of(c.fu, vol);
    t.gp = off_of(c.gp, vol);
    t.gm = off_of(c.gm, vol);
    t.ap = (int)c.ap;
    t.am = (int)c.am;
    t.stp = lstride(b, c.ap);
    t.stm = lstride(b, c.am);
    t.sig_ax = (int)c.sig_ax;
    t.sigu_ax = (int)c.sigu_ax;
    t.kap = vec_of(c.kap, tl);
    t.sig = vec_of(c.sig, tl);
    t.siginv = vec_of(c.siginv, tl);
    t.kapu = vec_of(c.kapu, tl);
    t.sigu = vec_of(c.sigu, tl);
    t.siginvu = vec_of(c.siginvu, tl);
    for (int ax = 0; ax < 3; ++ax) t.alive[ax] = vec_of(c.alive[ax], tl);
    // the D family's fold ghosts, where this box starts at a mirror plane
    t.gop = t.gom = 0;
    t.gsp = t.gsm = 0.0f;
    if (ghosts) {
      if (c.gp && b.o[c.ap] == 0 && ghosts->gs[w][0] != 0.0) {
        t.gsp = (float)ghosts->gs[w][0];
        t.gop = (int)ghosts->gk[w][0] * t.stp;
      }
      if (c.gm && b.o[c.am] == 0 && ghosts->gs[w][1] != 0.0) {
        t.gsm = (float)ghosts->gs[w][1];
        t.gom = (int)ghosts->gk[w][1] * t.stm;
      }
    }
  } else if (w >= 3 && w < 6 && w - 3 < P.neh) {
    const EhP& e = P.eh[w - 3];
    EhT& t = F.eh[w - 3];
    t.f = off_of(e.f, vol);
    t.fw = off_of(e.fw, vol);
    t.d = off_of(e.d, vol);
    t.u = off_of(e.u, vol);
    t.nreps = off_of(e.nreps, vol);
    t.nrchi2 = off_of(e.nrchi2, vol);
    t.chi3 = off_of(e.chi3, vol);
    t.chi2 = off_of(e.chi2, vol);
    t.w_ax = (int)e.w_ax;
    t.dc1 = (int)e.dc1;
    t.dc2 = (int)e.dc2;
    t.ax_own = (int)e.ax_own;
    t.ax_1 = (int)e.ax_1;
    t.ax_2 = (int)e.ax_2;
    PolT& pl = F.pol[w - 3];
    for (int p = 0; p < MAXPOL; ++p) {
      pl.p[p] = off_of(e.pol[p].p, vol);
      pl.pp[p] = off_of(e.pol[p].pp, vol);
      pl.sigma[p] = off_of(e.pol[p].sigma, vol);
    }
    t.kapw = vec_of(e.kapw, tl);
    t.sigw = vec_of(e.sigw, tl);
    for (int ax = 0; ax < 3; ++ax) t.alive[ax] = vec_of(e.alive[ax], tl);
  } else if (w == 6) {
    FamS& s = F.s;
    for (int p = 0; p < MAXPOL; ++p) {
      s.pg1inv[p] = (float)P.pg1inv[p];
      s.pg1[p] = (float)P.pg1[p];
      s.p2md[p] = (float)P.p2md[p];
      s.pw2[p] = (float)P.pw2[p];
    }
    s.csgn = (float)P.csgn;
    s.ncurl = (int)P.ncurl;
    s.neh = (int)P.neh;
    s.npol = (int)P.npol;
    s.sgn = (int)P.sgn;
    s.nr_iters = (int)P.nr_iters;
  }
}

// the threads that share a sub-update: a block's on a tile, the grid's in
// the direct schedule
struct Team {
  unsigned rank, size;
};

template <bool DIRECT>
__device__ __forceinline__ Team team_of() {
  Team t;
  t.rank = DIRECT ? blockIdx.x * blockDim.x + threadIdx.x : threadIdx.x;
  t.size = DIRECT ? gridDim.x * blockDim.x : blockDim.x;
  return t;
}

// the barrier between sub-updates: the block's, or the grid's
template <bool DIRECT>
__device__ __forceinline__ void bar() {
  if (DIRECT)
    cg::this_grid().sync();
  else
    __syncthreads();
}

// a site of the staged box: local flat index and local coordinates
struct Loc {
  int l, i, j, k;
};

// every site of the box [lo, hi) (grid coordinates, inside the staged box
// b), one per thread of the team: f(Loc); the same thread gets the same
// site in every call with the same box
template <class F>
__device__ __forceinline__ void over(const Box& b, const int* lo,
                                     const int* hi, const Team& tm, F f) {
  const int n0 = hi[0] - lo[0], n1 = hi[1] - lo[1], n2 = hi[2] - lo[2];
  if (n0 <= 0 || n1 <= 0 || n2 <= 0) return;
  const unsigned n12 = (unsigned)(n1 * n2), nn = (unsigned)n0 * n12;
  for (unsigned u = tm.rank; u < nn; u += tm.size) {
    const unsigned a = u / n12, r = u - a * n12;
    const unsigned c = n2 == 1 ? r : r / (unsigned)n2;
    Loc x;
    x.i = lo[0] - b.o[0] + (int)a;
    x.j = lo[1] - b.o[1] + (int)c;
    x.k = lo[2] - b.o[2] + (int)(r - c * (unsigned)n2);
    x.l = (x.i * b.n[1] + x.j) * b.n[2] + x.k;
    f(x);
  }
}

__device__ __forceinline__ int coord_of(int ax, const Loc& x) {
  return ax == 0 ? x.i : (ax == 1 ? x.j : x.k);
}

// the product of the per-axis 0/1 vectors (step.alive_vectors) at the
// site, on the box's vectors
__device__ __forceinline__ float mask_t(const int* alive, const float* sm,
                                        const Loc& x) {
  float m = 1.0f;
  if (alive[0] >= 0) m = m * sm[alive[0] + x.i];
  if (alive[1] >= 0) m = m * sm[alive[1] + x.j];
  if (alive[2] >= 0) m = m * sm[alive[2] + x.k];
  return m;
}

// diff (fdtd3d_site.cuh) of the staged array at offset g: the box's edge
// is the grid's wherever the schedule computes a site; below a node
// mirror's plane a backward difference reads the fold ghost gsg * g[k0]
// (gog = k0 * st; gsg = 0: the zero fill), refreshed at every step since
// it reads the staged array as it stands
template <bool IS_D>
__device__ __forceinline__ float diff_t(const float* sm, int g, int ax,
                                        int st, int gog, float gsg,
                                        const Box& b, const Loc& x) {
  const int c = coord_of(ax, x);
  if (IS_D)
    return sm[g + x.l] -
           (c > 0 ? sm[g + x.l - st]
                  : (gsg != 0.0f ? gsg * sm[g + x.l + gog] : 0.0f));
  return (c < b.n[ax] - 1 ? sm[g + x.l + st] : 0.0f) - sm[g + x.l];
}

// the D curl's backward difference of the staged array at offset g in the
// ROT variant (direct schedule: the box is the grid): below plane 0 of
// axis ax it reads partner m of component q's rotational ghost (A.gsrc,
// ...; step.rot2_ghost / rot4_ghost)
__device__ __forceinline__ float diff_rot(const float* sm, int g, int ax,
                                          int st, const ResArgs& A, int vol,
                                          int q, int m, const Loc& x) {
  float lo = 0.0f;
  if (coord_of(ax, x) > 0) {
    lo = sm[g + x.l - st];
  } else if (A.gsrc[q][m]) {
    const int j = A.gax[q][m] >= 0 ? coord_of((int)A.gax[q][m], x) : 0;
    if (j < A.glim[q][m])
      lo = (float)A.gs[q][m] *
           sm[((int)A.gsrc[q][m] - 1) * vol + x.l + (int)A.goff[q][m] +
              j * (int)A.gmul[q][m]];
  }
  return sm[g + x.l] - lo;
}

// diff_t in the WRAP variant (direct schedule: the box is the grid):
// across a periodic axis of live extent n the B curl's forward difference
// at plane n - 1 reads wph * g(0), the D curl's backward difference at
// plane 0 reads wphi * g(n - 1), and a site of a dead plane (n and up)
// reads zero across the axis, as step._sh shifts
template <bool IS_D>
__device__ __forceinline__ float diff_w(const float* sm, int g, int ax,
                                        int st, int gog, float gsg,
                                        const Box& b, const Loc& x,
                                        const ResArgs& A) {
  const int n = (int)A.wn[ax];
  if (n == 0) return diff_t<IS_D>(sm, g, ax, st, gog, gsg, b, x);
  const int c = coord_of(ax, x);
  const float v = sm[g + x.l];
  if (IS_D)
    return v - (c == 0 ? (float)A.wphi[ax] * sm[g + x.l + (n - 1) * st]
                       : (c < n ? sm[g + x.l - st] : 0.0f));
  return (c < n - 1 ? sm[g + x.l + st]
                    : (c == n - 1 ? (float)A.wph[ax] *
                                        sm[g + x.l - (n - 1) * st]
                                  : 0.0f)) -
         v;
}

// a real pair's channel `ch` at staged offset `at` times the complex
// factor a + i b: channel 0 a own - b other, channel 1 b other + a own
// (stencil.cmul_pair: step._sh's rotation of a wrapped read, the phi term
// and the axis ring's imaginary factor; a real factor scales both)
__device__ __forceinline__ float wrap_pair(const float* sm, int at,
                                           const ResArgs& A, int ch, float a,
                                           float bb) {
  const float own = sm[at];
  if (bb == 0.0f) return a * own;
  const float other = sm[at + (ch ? -(int)A.half : (int)A.half)];
  return ch ? bb * other + a * own : a * own - bb * other;
}

// diff_w of channel `ch` of a real pair (the PAIR variant): the wrapped
// plane's read takes the complex phase as a rotation of the channels
template <bool IS_D>
__device__ __forceinline__ float diff_p(const float* sm, int g, int ax,
                                        int st, int gog, float gsg,
                                        const Box& b, const Loc& x,
                                        const ResArgs& A, int ch) {
  const int n = (int)A.wn[ax];
  if (n == 0) return diff_t<IS_D>(sm, g, ax, st, gog, gsg, b, x);
  const int c = coord_of(ax, x);
  const float v = sm[g + x.l];
  if (IS_D)
    return v - (c == 0 ? wrap_pair(sm, g + x.l + (n - 1) * st, A, ch,
                                   (float)A.wphi[ax], (float)A.wphii[ax])
                       : (c < n ? sm[g + x.l - st] : 0.0f));
  return (c < n - 1 ? sm[g + x.l + st]
                    : (c == n - 1 ? wrap_pair(sm, g + x.l - (n - 1) * st, A,
                                              ch, (float)A.wph[ax],
                                              (float)A.wphim[ax])
                                  : 0.0f)) -
         v;
}

// BFAST's pair(g) of channel `ch` of a real pair (the PAIRBF variant):
// the staged array at offset g plus its neighbour along ax, below it (D)
// or above it (B), read as step._sh shifts: across a wrap of live extent
// A.wn[ax] the far end times the phase (rotating the channels), zero off
// the grid and from a dead plane
template <bool IS_D>
__device__ __forceinline__ float pair_p(const float* sm, int g, int ax,
                                        int st, const Box& b, const Loc& x,
                                        const ResArgs& A, int ch) {
  const int n = (int)A.wn[ax];
  const int c = coord_of(ax, x);
  const float v = sm[g + x.l];
  float nb;
  if (IS_D) {
    if (n == 0)
      nb = c > 0 ? sm[g + x.l - st] : 0.0f;
    else
      nb = c == 0 ? wrap_pair(sm, g + x.l + (n - 1) * st, A, ch,
                              (float)A.wphi[ax], (float)A.wphii[ax])
                  : (c < n ? sm[g + x.l - st] : 0.0f);
    return v + nb;
  }
  if (n == 0)
    nb = c < b.n[ax] - 1 ? sm[g + x.l + st] : 0.0f;
  else
    nb = c < n - 1 ? sm[g + x.l + st]
                   : (c == n - 1 ? wrap_pair(sm, g + x.l - (n - 1) * st, A,
                                             ch, (float)A.wph[ax],
                                             (float)A.wphim[ax])
                                 : 0.0f);
  return nb + v;
}

// one curl component's BFAST term (PAIRBF): offsets of F and the taper
// (-1: none; F -1: no term), the W chain's vectors and axis (wax -1: no
// decay from it), k1, k2
struct BfT {
  int F, tap, kw, sw, wax;
  float k1, k2;
};

template <bool IS_D>
__device__ __forceinline__ BfT bfast_of(const FamT& F, const ResArgs& A,
                                        int q) {
  const int fam = IS_D ? 1 : 0, vol = (int)A.tl.vol;
  BfT t;
  t.F = A.bf[fam][q] ? ((int)A.bf[fam][q] - 1) * vol : -1;
  t.tap = A.bt[fam][q] ? ((int)A.bt[fam][q] - 1) * vol : -1;
  const int w = (int)A.bw[fam][q];
  t.wax = w >= 0 ? F.eh[w].w_ax : -1;
  t.kw = w >= 0 ? F.eh[w].kapw : 0;
  t.sw = w >= 0 ? F.eh[w].sigw : 0;
  t.k1 = (float)A.bk[fam][q][0];
  t.k2 = (float)A.bk[fam][q][1];
  return t;
}

// one curl component's CylP on the direct schedule's buffer: offsets of
// the vectors and of the phi and axis partners (-1: none), the axis
// partner's ring as an offset along r
struct CylT {
  int rg, rfinv, imr, phi, ag, aro;
  float ps, imc, are, aim;
};

template <bool IS_D>
__device__ __forceinline__ CylT cyl_of(const ResArgs& A, int q,
                                       const Box& b) {
  const CylP& p = ((const CylP*)A.cyl)[(IS_D ? NCOMP : 0) + q];
  const int vol = (int)A.tl.vol;
  CylT t;
  t.rg = vec_of((const void*)p.rg, A.tl);
  t.rfinv = vec_of((const void*)p.rfinv, A.tl);
  t.imr = vec_of((const void*)p.imr, A.tl);
  t.phi = p.phi ? ((int)p.phi - 1) * vol : -1;
  t.ag = p.ag ? ((int)p.ag - 1) * vol : -1;
  t.aro = (int)p.ar * lstride(b, 0);
  t.ps = (float)p.ps;
  t.imc = (float)p.imc;
  t.are = (float)p.are;
  t.aim = (float)p.aim;
  return t;
}

// the r-weighted difference (1/r) d(r g)/dr of the staged array at offset
// g (step._curl: rfinv * diff(rg * g) along r, axis 0, stride st): the
// products rg * g at the site and its neighbour, backward (D) with zero
// below r = 0, forward (B) with zero past the grid
template <bool IS_D>
__device__ __forceinline__ float diff_r(const float* sm, int g, int st,
                                        const CylT& cy, const Box& b,
                                        const Loc& x) {
  const float v = sm[cy.rg + x.i] * sm[g + x.l];
  if (IS_D)
    return sm[cy.rfinv + x.i] *
           (v - (x.i > 0 ? sm[cy.rg + x.i - 1] * sm[g + x.l - st] : 0.0f));
  return sm[cy.rfinv + x.i] *
         ((x.i < b.n[0] - 1 ? sm[cy.rg + x.i + 1] * sm[g + x.l + st]
                            : 0.0f) -
          v);
}

// step._curl_update of one component (q of its family) at one site; GK:
// the D curl reads the rotational ghosts of A (GK_ROT), both curls read
// across the Bloch wrap (GK_WRAP), channel `ch` of a real pair's across it
// (GK_PAIR; sm is the channel's half of the buffer), and then adds
// BFAST's term `bt` (GK_PAIRBF: step._bfast_update, in its order)
template <bool IS_D, int GK>
__device__ __forceinline__ void curl_t(const CurlT& c, float csgn, float* sm,
                                       const Box& b, const Loc& x,
                                       const ResArgs& A, int q, int ch = 0,
                                       const BfT* bt = nullptr,
                                       const CylT* cy = nullptr) {
  constexpr bool CYL = GK == GK_CYL || GK == GK_PAIRCYL;
  float dp = 0.0f, dm = 0.0f;
  if (CYL && cy->rg >= 0) {
    // the r-weighted partner (a z component's gp), then gm as the
    // variant reads it
    dp = diff_r<IS_D>(sm, c.gp, c.stp, *cy, b, x);
    if (c.gm >= 0)
      dm = GK == GK_PAIRCYL
               ? diff_p<IS_D>(sm, c.gm, c.am, c.stm, c.gom, c.gsm, b, x, A,
                              ch)
               : diff_t<IS_D>(sm, c.gm, c.am, c.stm, c.gom, c.gsm, b, x);
  } else if (GK == GK_PAIR || GK == GK_PAIRBF || GK == GK_PAIRCYL) {
    if (c.gp >= 0)
      dp = diff_p<IS_D>(sm, c.gp, c.ap, c.stp, c.gop, c.gsp, b, x, A, ch);
    if (c.gm >= 0)
      dm = diff_p<IS_D>(sm, c.gm, c.am, c.stm, c.gom, c.gsm, b, x, A, ch);
  } else if (IS_D && GK == GK_ROT) {
    const int vol = (int)A.tl.vol;
    if (c.gp >= 0) dp = diff_rot(sm, c.gp, c.ap, c.stp, A, vol, q, 0, x);
    if (c.gm >= 0) dm = diff_rot(sm, c.gm, c.am, c.stm, A, vol, q, 1, x);
  } else if (GK == GK_WRAP) {
    if (c.gp >= 0)
      dp = diff_w<IS_D>(sm, c.gp, c.ap, c.stp, c.gop, c.gsp, b, x, A);
    if (c.gm >= 0)
      dm = diff_w<IS_D>(sm, c.gm, c.am, c.stm, c.gom, c.gsm, b, x, A);
  } else {
    if (c.gp >= 0)
      dp = diff_t<IS_D>(sm, c.gp, c.ap, c.stp, c.gop, c.gsp, b, x);
    if (c.gm >= 0)
      dm = diff_t<IS_D>(sm, c.gm, c.am, c.stm, c.gom, c.gsm, b, x);
  }
  float dfl = curl_delta<float>(c.gp >= 0, dp, c.gm >= 0, dm, csgn);
  if (GK == GK_PAIRCYL && cy->phi >= 0) {
    // i (ps) imr f[phi]: imr times the partner rotated by i ps
    const float imr = cy->imr >= 0 ? sm[cy->imr + x.i] : cy->imc;
    const float t = imr * wrap_pair(sm, cy->phi + x.l, A, ch, 0.0f, cy->ps);
    dfl = (c.gp >= 0 || c.gm >= 0) ? dfl + t : t;
  }
  const float f = sm[c.f + x.l];
  float kap = 0.0f, sig = 0.0f, siginv = 0.0f;
  float kapu = 0.0f, sigu = 0.0f, siginvu = 0.0f, fuo = 0.0f, fun = 0.0f;
  const bool sig_on = c.sig_ax >= 0, sigu_on = c.sigu_ax >= 0;
  if (sigu_on) {
    const int cu = coord_of(c.sigu_ax, x);
    kapu = sm[c.kapu + cu];
    sigu = sm[c.sigu + cu];
    siginvu = sm[c.siginvu + cu];
    fuo = sm[c.fu + x.l];
  }
  if (sig_on) {
    const int cs = coord_of(c.sig_ax, x);
    kap = sm[c.kap + cs];
    sig = sm[c.sig + cs];
    siginv = sm[c.siginv + cs];
  }
  const float base = curl_value<float>(f, dfl, sig_on, sig_on, kap - sig,
                                       siginv, sigu_on, kapu - sigu, siginvu,
                                       fuo, &fun);
  if (GK == GK_PAIRBF && bt->F >= 0) {
    const float m = mask_t(c.alive, sm, x);
    float a = 0.0f;
    if (bt->k1 != 0.0f)
      a = a + bt->k1 * pair_p<IS_D>(sm, c.gp, c.ap, c.stp, b, x, A, ch);
    if (bt->k2 != 0.0f)
      a = a - bt->k2 * pair_p<IS_D>(sm, c.gm, c.am, c.stm, b, x, A, ch);
    if (bt->tap >= 0) a = a * sm[bt->tap + x.l];
    // the decay (1 where nothing decays: 1 * F is F exactly)
    float gam = 1.0f;
    if (sig_on) gam = (kap - sig) * siginv;
    if (sigu_on) {
      const float g2 = (kapu - sigu) * siginvu;
      gam = sig_on ? gam * g2 : g2;
    }
    if (!sig_on && !sigu_on && bt->wax >= 0) {
      const int cw = coord_of(bt->wax, x);
      const float kw = sm[bt->kw + cw], sw = sm[bt->sw + cw];
      gam = (kw - sw) / (kw + sw);
    }
    const float fp = sm[bt->F + x.l];
    const float fn = a - gam * fp;
    float delta = fn - fp;
    sm[bt->F + x.l] = fn;
    if (sig_on) delta = delta * siginv;
    if (sigu_on) {
      sm[c.fu + x.l] = fun + delta;
      delta = delta * siginvu;
    }
    sm[c.f + x.l] = (base * m + delta) * m;
    return;
  }
  if (sigu_on) sm[c.fu + x.l] = fun;
  if (CYL && cy->ag >= 0 && x.i == 0) {
    // the axis correction at r = 0 (step._axis_specials), into f only,
    // then the mask again
    const float m = mask_t(c.alive, sm, x);
    const int at = cy->ag + x.l + cy->aro;
    const float add = GK == GK_PAIRCYL
                          ? wrap_pair(sm, at, A, ch, cy->are, cy->aim)
                          : cy->are * sm[at];
    sm[c.f + x.l] = (base * m + add) * m;
    return;
  }
  sm[c.f + x.l] = base * mask_t(c.alive, sm, x);
}

// D - P of component e at local site l: D, then each P in pole order
__device__ __forceinline__ float dmp_t(int d, const PolT& pl, int npol,
                                       const float* sm, int l) {
  float v = sm[d + l];
  for (int p = 0; p < npol; ++p)
    if (pl.p[p] >= 0) v = v - sm[pl.p[p] + l];
  return v;
}

// the local index of the site shifted by da along axis a and db along
// axis bb (-1: none), or -1 off the grid (the box's edge there)
__device__ __forceinline__ int nb_l(const Box& b, const Loc& x, int a, int da,
                                    int bb, int db) {
  const int ci = x.i + (a == 0 ? da : 0) + (bb == 0 ? db : 0);
  const int cj = x.j + (a == 1 ? da : 0) + (bb == 1 ? db : 0);
  const int ck = x.k + (a == 2 ? da : 0) + (bb == 2 ? db : 0);
  if (ci < 0 || ci >= b.n[0] || cj < 0 || cj >= b.n[1] || ck < 0 ||
      ck >= b.n[2])
    return -1;
  return (ci * b.n[1] + cj) * b.n[2] + ck;
}

// D - P of component e at that shifted site; zero off the grid
__device__ float dmp_nb_t(int d, const PolT& pl, int npol, const float* sm,
                          const Box& b, const Loc& x, int a, int da, int bb,
                          int db) {
  const int l = nb_l(b, x, a, da, bb, db);
  return l < 0 ? 0.0f : dmp_t(d, pl, npol, sm, l);
}

// sum4 (step._sum4 / _avg4) of partner q of family F around the site
__device__ float sum4_t(const FamT& F, int q, const float* sm, const Box& b,
                        const Loc& x, int own, int off) {
  const int g = F.s.sgn, d = F.eh[q].d, np = F.s.npol;
  const PolT& pl = F.pol[q];
  const float v0 = dmp_nb_t(d, pl, np, sm, b, x, -1, 0, -1, 0);
  const float vs = dmp_nb_t(d, pl, np, sm, b, x, own, g, -1, 0);
  const float vx = dmp_nb_t(d, pl, np, sm, b, x, off, -g, -1, 0);
  const float vsx = dmp_nb_t(d, pl, np, sm, b, x, own, g, off, -g);
  return v0 + vs + vx + vsx;
}

// the staged array at offset o at the site shifted by da along axis a and
// db along axis bb (nb_l), zero off the grid
__device__ __forceinline__ float at_nb(const float* sm, int o, const Box& b,
                                       const Loc& x, int a, int da, int bb,
                                       int db) {
  const int l = nb_l(b, x, a, da, bb, db);
  return l >= 0 ? sm[o + l] : 0.0f;
}

// OFFDIAG (step._offdiag, step_generic.cpp:597) of the off-diagonal
// chi1inv row at offset u against partner q's D - P: t = (g1 + g1 shifted
// by -g along a1) u at the site and at the site shifted by g along the own
// axis (zero past the grid), 0.25 (t + t'); u taken at each of the two
// sites
__device__ float offdiag_t(const FamT& F, int q, int u, const float* sm,
                           const Box& b, const Loc& x, int a1, int own) {
  const int g = F.s.sgn, d = F.eh[q].d, np = F.s.npol;
  const PolT& pl = F.pol[q];
  const float t0 = (dmp_t(d, pl, np, sm, x.l) +
                    dmp_nb_t(d, pl, np, sm, b, x, a1, -g, -1, 0)) *
                   sm[u + x.l];
  const int l1 = nb_l(b, x, own, g, -1, 0);
  float t1 = 0.0f;
  if (l1 >= 0)
    t1 = (dmp_t(d, pl, np, sm, l1) +
          dmp_nb_t(d, pl, np, sm, b, x, own, g, a1, -g)) *
         sm[u + l1];
  return 0.25f * (t0 + t1);
}

// step._eh_update of one E (or H) component (descriptor e, in registers;
// its poles pl) at one site, then its ADE (step._pol_update_lorentzian):
// the new P into the PP buffer, whose old value only this site reads; F is
// the family (its scalars, the chi2/chi3 partners of an NL block).  AX
// (the anisotropic modes): the off-diagonal rows at offsets u1 / u2 (-1:
// none) add their OFFDIAG averages; poles whose bit is set in `sep` run in
// the pole sub-update instead (AX_GYRO)
template <bool NL, int AX = AX_NONE>
__device__ __forceinline__ void eh_t(const FamT& F, const EhT& e,
                                     const PolT& pl, float* sm, const Box& b,
                                     const Loc& x, int u1 = -1, int u2 = -1,
                                     unsigned sep = 0u) {
  const FamS& s = F.s;
  const int l = x.l;
  const float gs = dmp_t(e.d, pl, s.npol, sm, l);
  const float us = e.u >= 0 ? sm[e.u + l] : 1.0f;
  float lin = e.u >= 0 ? gs * us : gs;
  if (AX != AX_NONE) {
    if (u1 >= 0) lin = lin + offdiag_t(F, e.dc1, u1, sm, b, x, e.ax_1,
                                       e.ax_own);
    if (u2 >= 0) lin = lin + offdiag_t(F, e.dc2, u2, sm, b, x, e.ax_2,
                                       e.ax_own);
  }
  if (NL && e.chi3 >= 0) {
    float Dsqr = gs * gs;
    if (e.dc1 >= 0)
      Dsqr = dsqr_add<float>(
          Dsqr, sum4_t(F, e.dc1, sm, b, x, e.ax_own, e.ax_1));
    if (e.dc2 >= 0)
      Dsqr = dsqr_add<float>(
          Dsqr, sum4_t(F, e.dc2, sm, b, x, e.ax_own, e.ax_2));
    lin = pade<float>(lin, gs, Dsqr, sm[e.chi2 + l], sm[e.chi3 + l], us);
  }
  if (NL && e.nrchi2 >= 0) {
    const float chi2 = sm[e.nrchi2 + l];
    if (chi2 != 0.0f) {
      const float g1 =
          e.dc1 >= 0 ? 0.25f * sum4_t(F, e.dc1, sm, b, x, e.ax_own, e.ax_1)
                     : 0.0f;
      const float g2 =
          e.dc2 >= 0 ? 0.25f * sum4_t(F, e.dc2, sm, b, x, e.ax_own, e.ax_2)
                     : 0.0f;
      lin = nr_solve<float>(gs, g1, g2, sm[e.nreps + l], chi2, s.nr_iters);
    }
  }
  WIn<float> w;
  w.on = e.w_ax >= 0;
  w.f = w.fw = w.kp = w.km = 0.0f;
  if (w.on) {
    const int cw = coord_of(e.w_ax, x);
    const float kw = sm[e.kapw + cw], sw = sm[e.sigw + cw];
    w.kp = kw + sw;
    w.km = kw - sw;
    w.f = sm[e.f + l];
    w.fw = sm[e.fw + l];
  }
  w.mask = mask_t(e.alive, sm, x);
  const float fnew = w_value<float>(lin, w);
  if (w.on) sm[e.fw + l] = lin;
  sm[e.f + l] = fnew;
  const float W = e.w_ax >= 0 ? lin : fnew;
  for (int p = 0; p < s.npol; ++p) {
    if (pl.p[p] < 0) continue;
    if (AX == AX_GYRO && ((sep >> p) & 1u)) continue;
    sm[pl.pp[p] + l] = ade_value<float>(
        s.pg1inv[p], s.p2md[p], s.pg1[p], s.pw2[p], W, sm[pl.sigma[p] + l],
        sm[pl.p[p] + l], sm[pl.pp[p] + l]);
  }
}

// the curl of every component of family F over [lo, hi), component by
// component (each one's descriptor in registers)
template <bool IS_D, int GK>
__device__ __forceinline__ void curl_all(const FamT& F, float* sm,
                                         const Box& b, const int* lo,
                                         const int* hi, const Team& tm,
                                         const ResArgs& A, int ch = 0) {
  const float csgn = F.s.csgn;
  for (int q = 0; q < F.s.ncurl; ++q) {
    const CurlT c = F.curl[q];
    if (GK == GK_PAIRBF) {
      const BfT bt = bfast_of<IS_D>(F, A, q);
      over(b, lo, hi, tm, [&](const Loc& x) {
        curl_t<IS_D, GK>(c, csgn, sm, b, x, A, q, ch, &bt);
      });
      continue;
    }
    if (GK == GK_CYL || GK == GK_PAIRCYL) {
      const CylT cy = cyl_of<IS_D>(A, q, b);
      over(b, lo, hi, tm, [&](const Loc& x) {
        curl_t<IS_D, GK>(c, csgn, sm, b, x, A, q, ch, nullptr, &cy);
      });
      continue;
    }
    over(b, lo, hi, tm, [&](const Loc& x) {
      curl_t<IS_D, GK>(c, csgn, sm, b, x, A, q, ch);
    });
  }
}

// E (or H) and the ADE of every component of family F over [lo, hi),
// component by component: the descriptor in registers, its poles (indexed
// at run time, which registers cannot be) and the family's scalars read in
// place
template <bool NL, int AX = AX_NONE>
__device__ __forceinline__ void eh_all(const FamT& F, float* sm,
                                       const Box& b, const int* lo,
                                       const int* hi, const Team& tm,
                                       const ResArgs* A = nullptr,
                                       int fam = 0) {
  for (int q = 0; q < F.s.neh; ++q) {
    const EhT e = F.eh[q];
    const PolT& pl = F.pol[q];
    if (AX != AX_NONE) {
      const AxTab* X = (const AxTab*)A->ax;
      const int vol = (int)A->tl.vol;
      const int u1 = off_of((const void*)X->u1[fam][q], vol);
      const int u2 = off_of((const void*)X->u2[fam][q], vol);
      const unsigned sep = (unsigned)X->sep[fam];
      over(b, lo, hi, tm, [&](const Loc& x) {
        eh_t<NL, AX>(F, e, pl, sm, b, x, u1, u2, sep);
      });
      continue;
    }
    over(b, lo, hi, tm,
         [&](const Loc& x) { eh_t<NL>(F, e, pl, sm, b, x); });
  }
}

// one pole's update at one component (SepP) on a box: offsets of its
// entries (cur: the current P, prv: the previous one, which the new P
// replaces; by step parity), of sigma and the off-diagonal rows, of the
// drive fields, the averages' modes and axes, the constants
struct SepT {
  int kind, cur[3], prv[3], sig, so[2], w[3], av[2][3];
  float k[4], c[6], inv[9];
};

// the W of E (H) component q: its W chain's input where it has one, else
// the field (step._W)
__device__ __forceinline__ int w_of(const FamT& F, int q) {
  return F.eh[q].w_ax >= 0 ? F.eh[q].fw : F.eh[q].f;
}

__device__ SepT sep_of(const SepP& e, const FamT& F, int odd, int vol) {
  SepT t;
  t.kind = (int)e.kind;
  for (int j = 0; j < 3; ++j) {
    const int a = off_of((const void*)e.p[j], vol);
    const int b = off_of((const void*)e.pp[j], vol);
    t.cur[j] = odd ? b : a;
    t.prv[j] = odd ? a : b;
    t.w[j] = e.w[j] >= 0 ? w_of(F, (int)e.w[j]) : -1;
  }
  t.sig = off_of((const void*)e.sig, vol);
  for (int j = 0; j < 2; ++j) {
    t.so[j] = off_of((const void*)e.so[j], vol);
    for (int m = 0; m < 3; ++m) t.av[j][m] = (int)e.av[j][m];
  }
  for (int m = 0; m < 4; ++m) t.k[m] = (float)e.k[m];
  for (int m = 0; m < 6; ++m) t.c[m] = (float)e.c[m];
  for (int m = 0; m < 9; ++m) t.inv[m] = (float)e.inv[m];
  return t;
}

// a partner W (staged at offset o) averaged onto the site
// (step.gyro_avg): mode 1 the four sites around it (step._avg4), 2 two
// along the own axis, 3 two along the partner's, 0 the value itself
__device__ __forceinline__ float gyro_avg_t(const float* sm, int o,
                                            const Box& b, const Loc& x,
                                            const int* av, int g) {
  const float w = sm[o + x.l];
  const int own = av[1], off = av[2];
  if (av[0] == 1) {
    const float gs = at_nb(sm, o, b, x, own, g, -1, 0);
    const float gx = at_nb(sm, o, b, x, off, -g, -1, 0);
    const float gsx = at_nb(sm, o, b, x, own, g, off, -g);
    return 0.25f * (w + gs + gx + gsx);
  }
  if (av[0] == 2) return 0.5f * (w + at_nb(sm, o, b, x, own, g, -1, 0));
  if (av[0] == 3) return 0.5f * (w + at_nb(sm, o, b, x, off, -g, -1, 0));
  return w;
}

// step._offdiag of an off-diagonal sigma row (offset u) against a partner
// W (offset o), the partner's axis and the own one in av
__device__ __forceinline__ float offdiag_w(const float* sm, int o, int u,
                                           const Box& b, const Loc& x,
                                           const int* av, int g) {
  const int own = av[1], off = av[2];
  const float t0 = (sm[o + x.l] + at_nb(sm, o, b, x, off, -g, -1, 0)) *
                   sm[u + x.l];
  const int l1 = nb_l(b, x, own, g, -1, 0);
  float t1 = 0.0f;
  if (l1 >= 0)
    t1 = (sm[o + l1] + at_nb(sm, o, b, x, own, g, off, -g)) * sm[u + l1];
  return 0.25f * (t0 + t1);
}

// one pole at one component and site, after the family's E (H): kind 0 the
// Lorentzian leapfrog with the off-diagonal sigma drive and the s != 0
// guard (step._pol_update_lorentzian), kinds 1 and 2 the gyrotropic
// precession (step._pol_update_gyro) in the plain version's order; the
// new P into the previous one's arrays
__device__ __forceinline__ void sep_t(const SepT& t, const FamS& fs, int p,
                                      float* sm, const Box& b, const Loc& x) {
  const int l = x.l, g = fs.sgn;
  const float s = sm[t.sig + l];
  const float w0 = sm[t.w[0] + l];
  if (t.kind == 0) {
    float drive = s * w0;
    bool aniso = false;
    for (int j = 0; j < 2; ++j) {
      if (t.so[j] < 0) continue;
      aniso = true;
      drive = drive + offdiag_w(sm, t.w[j + 1], t.so[j], b, x, t.av[j], g);
    }
    const float pc = sm[t.cur[0] + l];
    const float pn = fs.pg1inv[p] * (pc * fs.p2md[p] -
                                     fs.pg1[p] * sm[t.prv[0] + l] +
                                     fs.pw2[p] * drive);
    sm[t.prv[0] + l] = (aniso && s == 0.0f) ? pc : pn;
    return;
  }
  const float a1 = t.w[1] >= 0 ? gyro_avg_t(sm, t.w[1], b, x, t.av[0], g)
                               : 0.0f;
  const float a2 = t.w[2] >= 0 ? gyro_avg_t(sm, t.w[2], b, x, t.av[1], g)
                               : 0.0f;
  const float p0 = sm[t.cur[0] + l], p1 = sm[t.cur[1] + l],
              p2 = sm[t.cur[2] + l];
  const float pp0 = sm[t.prv[0] + l], pp1 = sm[t.prv[1] + l],
              pp2 = sm[t.prv[2] + l];
  const float ks = t.k[2] * s;
  float r0, r1, r2;
  if (t.kind == 2) {
    const float q0 = t.k[0] * p0 + t.k[1] * pp0 + ks * w0;
    const float q1 = t.k[0] * p1 + t.k[1] * pp1 + ks * a1;
    const float q2 = t.k[0] * p2 + t.k[1] * pp2 + ks * a2;
    r0 = 0.5f * pp0 - t.k[3] * p0 + t.c[0] * q1 + t.c[1] * q2;
    r1 = 0.5f * pp1 - t.k[3] * p1 + t.c[3] * q2 + t.c[2] * q0;
    r2 = 0.5f * pp2 - t.k[3] * p2 + t.c[5] * q0 + t.c[4] * q1;
  } else {
    r0 = t.k[0] * p0 - t.k[1] * pp0 + ks * w0 - t.c[0] * pp1 - t.c[1] * pp2;
    r1 = t.k[0] * p1 - t.k[1] * pp1 + ks * a1 - t.c[2] * pp0 - t.c[3] * pp2;
    r2 = t.k[0] * p2 - t.k[1] * pp2 + ks * a2 - t.c[4] * pp1 - t.c[5] * pp0;
  }
  sm[t.prv[0] + l] = t.inv[0] * r0 + t.inv[1] * r1 + t.inv[2] * r2;
  sm[t.prv[1] + l] = t.inv[3] * r0 + t.inv[4] * r1 + t.inv[5] * r2;
  sm[t.prv[2] + l] = t.inv[6] * r0 + t.inv[7] * r1 + t.inv[8] * r2;
}

// the pole sub-update of family F (fam 0 B, 1 D) over [lo, hi): every
// pole of the AxTab's `sep` mask, component by component
__device__ void sep_all(const FamT& F, const ResArgs& A, int fam, int odd,
                        float* sm, const Box& b, const int* lo,
                        const int* hi, const Team& tm) {
  const AxTab* X = (const AxTab*)A.ax;
  const unsigned sep = (unsigned)X->sep[fam];
  for (int p = 0; p < F.s.npol; ++p) {
    if (!((sep >> p) & 1u)) continue;
    for (int q = 0; q < F.s.neh; ++q) {
      if (X->pole[fam][p][q].kind < 0) continue;
      const SepT t = sep_of(X->pole[fam][p][q], F, odd, (int)A.tl.vol);
      over(b, lo, hi, tm,
           [&](const Loc& x) { sep_t(t, F.s, p, sm, b, x); });
    }
  }
}

// the local index of grid offset `off` in box b, or -1 outside it
__device__ __forceinline__ int local_of(int off, const Box& b, int S1,
                                        int S2) {
  const int i = off / (S1 * S2), r = off - i * S1 * S2;
  const int j = r / S2, k = r - j * S2;
  const int li = i - b.o[0], lj = j - b.o[1], lk = k - b.o[2];
  if (li < 0 || li >= b.n[0] || lj < 0 || lj >= b.n[1] || lk < 0 ||
      lk >= b.n[2])
    return -1;
  return (li * b.n[1] + lj) * b.n[2] + lk;
}

// the family's sources at the tile's staged sites, in source order per
// site; IM: a real pair's channel 1, which reads the waveform rows swapped,
// (w_re, w_im) -> (w_im, -w_re): w amp's imaginary part
template <bool IM = false>
__device__ void sources_at(const ResArgs& A, const SrcFam& sf, const FamT& F,
                           float* sm, const Box& b, int tile, i64 s, int S1,
                           int S2, const Team& tm) {
  const float dt = (float)A.dt;
  const float* cur = (const float*)A.cur + s * A.nsrc * 2;
  const int* soff = (const int*)sf.slot_off;
  const int* sq = (const int*)sf.slot_q;
  const int* start = (const int*)sf.slot_start;
  const int* csrc = (const int*)sf.c_src;
  const float* cre = (const float*)sf.c_re;
  const float* cim = (const float*)sf.c_im;
  const int* ts = (const int*)sf.tstart;
  const int* tsl = (const int*)sf.tslot;
  for (int u = ts[tile] + (int)tm.rank; u < ts[tile + 1]; u += (int)tm.size) {
    const int t = tsl[u];
    const int l = local_of(soff[t], b, S1, S2);
    if (l < 0) continue;               // outside a shorter pass's box
    float* f = sm + F.curl[sq[t]].f + l;
    float v = *f;
    for (int c = start[t]; c < start[t + 1]; ++c) {
      const float wre = IM ? cur[2 * csrc[c] + 1] : cur[2 * csrc[c]];
      const float wim = IM ? -cur[2 * csrc[c]] : cur[2 * csrc[c] + 1];
      v = v - (wre * cre[c] - wim * cim[c]) * dt;
    }
    *f = v;
  }
}

// the monitor's field value at the site: the centred average folded over
// its axes in order, 0.5 * (lower + upper) per axis, zero past the grid
// (step._region_values); f: the component's staged array.  WRAP (direct
// schedule, the box is the grid): on a periodic axis of live extent n the
// upper read of plane n - 1 is wph * plane 0, that of a dead plane zero
template <int GK>
__device__ __forceinline__ float region_value(const DftM& d, const float* f,
                                              const Box& b, const Loc& x,
                                              const ResArgs& A) {
  float v[8];
  const int nc = 1 << d.navg;
  for (int c = 0; c < nc; ++c) {
    int ci = x.i, cj = x.j, ck = x.k;
    float sc = 1.0f;
    bool in = true;
    for (int m = 0; m < d.navg; ++m) {
      if (!((c >> m) & 1)) continue;
      const int ax = (int)d.avg[m];
      const int cur = ax == 0 ? ci : (ax == 1 ? cj : ck);
      const int n = GK == GK_WRAP ? (int)A.wn[ax] : 0;
      int nxt = cur + 1;
      if (n == 0) {
        in = in && nxt < (ax == 0 ? b.n[0] : (ax == 1 ? b.n[1] : b.n[2]));
      } else if (cur == n - 1) {
        nxt = 0;
        sc = sc * (float)A.wph[ax];
      } else if (cur >= n) {
        in = false;
      }
      if (ax == 0) ci = nxt;
      else if (ax == 1) cj = nxt;
      else ck = nxt;
    }
    v[c] = in ? sc * f[(ci * b.n[1] + cj) * b.n[2] + ck] : 0.0f;
  }
  for (int m = 1; m <= d.navg; ++m)
    for (int c = 0; c < (nc >> m); ++c)
      v[c] = 0.5f * (v[2 * c] + v[2 * c + 1]);
  return v[0];
}

// the DTFT update (acc += ph * w * fv, re and im rows) at the region sites
// of the tile's interior [lo, hi)
template <int GK>
__device__ void dtft(const ResArgs& A, float* sm, int vol, const Box& b,
                     const int* lo, const int* hi, i64 s, const Team& tm) {
  for (int m = 0; m < A.ndft; ++m) {
    const DftM& d = A.dft[m];
    int rlo[3], rhi[3];
    for (int ax = 0; ax < 3; ++ax) {
      rlo[ax] = max(lo[ax], (int)d.lo[ax]);
      rhi[ax] = min(hi[ax], (int)(d.lo[ax] + d.n[ax]));
    }
    const float* f = sm + off_of(d.f, vol);
    const float* phr = (const float*)d.phr + s * d.nfreq;
    const float* phi = (const float*)d.phi + s * d.nfreq;
    float* acc = (float*)d.acc;
    const bool cplx = d.wi != nullptr;
    over(b, rlo, rhi, tm, [&](const Loc& x) {
      const int r = ((x.i + b.o[0] - (int)d.lo[0]) * (int)d.n[1] +
                     (x.j + b.o[1] - (int)d.lo[1])) *
                        (int)d.n[2] +
                    (x.k + b.o[2] - (int)d.lo[2]);
      const float fv = region_value<GK>(d, f, b, x, A);
      const float cr = ((const float*)d.w)[r] * fv;
      // complex weights (LDOS): c = cr + i ci, acc += ph c
      const float ci = cplx ? ((const float*)d.wi)[r] * fv : 0.0f;
      for (int q0 = 0; q0 < d.nfreq; q0 += 4) {   // 8 loads in flight
        float re[4], im[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (q0 + m >= d.nfreq) continue;
          re[m] = acc[(2 * (q0 + m)) * d.R + r];
          im[m] = acc[(2 * (q0 + m) + 1) * d.R + r];
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int q = q0 + m;
          if (q >= d.nfreq) continue;
          if (cplx) {
            acc[(2 * q) * d.R + r] = re[m] + (phr[q] * cr - phi[q] * ci);
            acc[(2 * q + 1) * d.R + r] = im[m] + (phi[q] * cr + phr[q] * ci);
          } else {
            acc[(2 * q) * d.R + r] = re[m] + phr[q] * cr;
            acc[(2 * q + 1) * d.R + r] = im[m] + phi[q] * cr;
          }
        }
      }
    });
  }
}

// region_value of a real pair (the PAIR variant, direct schedule): the
// corners' (re, im) from both channels (f0: channel 0's array, channel 1's
// A.half on), averaged axis by axis in the plain version's order, the
// upper read across a wrapped axis at plane n - 1 rotated by that axis's
// phase before its average (step._region_values through step._sh)
__device__ __forceinline__ void region_value_pair(const DftM& d,
                                                  const float* f0,
                                                  const Box& b, const Loc& x,
                                                  const ResArgs& A, float* vr,
                                                  float* vi) {
  float re[8], im[8];
  const int nc = 1 << d.navg;
  bool wraps[3];
  for (int m = 0; m < d.navg; ++m) {
    const int ax = (int)d.avg[m], n = (int)A.wn[ax];
    wraps[m] = n > 0 && coord_of(ax, x) == n - 1;
  }
  for (int c = 0; c < nc; ++c) {
    int ci = x.i, cj = x.j, ck = x.k;
    bool in = true;
    for (int m = 0; m < d.navg; ++m) {
      if (!((c >> m) & 1)) continue;
      const int ax = (int)d.avg[m];
      const int cur = ax == 0 ? ci : (ax == 1 ? cj : ck);
      const int n = (int)A.wn[ax];
      int nxt = cur + 1;
      if (n == 0) {
        in = in && nxt < (ax == 0 ? b.n[0] : (ax == 1 ? b.n[1] : b.n[2]));
      } else if (cur == n - 1) {
        nxt = 0;
      } else if (cur >= n) {
        in = false;
      }
      if (ax == 0) ci = nxt;
      else if (ax == 1) cj = nxt;
      else ck = nxt;
    }
    const int l = (ci * b.n[1] + cj) * b.n[2] + ck;
    re[c] = in ? f0[l] : 0.0f;
    im[c] = in ? f0[l + A.half] : 0.0f;
  }
  for (int m = 0; m < d.navg; ++m) {
    const int ax = (int)d.avg[m];
    const float a = (float)A.wph[ax], bb = (float)A.wphim[ax];
    for (int c = 0; c < (nc >> (m + 1)); ++c) {
      float ur = re[2 * c + 1], ui = im[2 * c + 1];
      if (wraps[m]) {
        if (bb == 0.0f) {
          ur = a * ur;
          ui = a * ui;
        } else {
          const float r = a * ur - bb * ui, i2 = bb * ur + a * ui;
          ur = r;
          ui = i2;
        }
      }
      re[c] = 0.5f * (re[2 * c] + ur);
      im[c] = 0.5f * (im[2 * c] + ui);
    }
  }
  *vr = re[0];
  *vi = im[0];
}

// the DTFT update of a real pair (the PAIR variant): c = w fv with the
// complex field fv = fr + i fi and the weight w = wr (+ i wi), cr = wr fr
// (- wi fi), ci = wr fi (+ wi fr), then acc += ph c (step._dft_update)
__device__ void dtft_pair(const ResArgs& A, float* sm, int vol,
                          const Box& b, const int* lo, const int* hi, i64 s,
                          const Team& tm) {
  for (int m = 0; m < A.ndft; ++m) {
    const DftM& d = A.dft[m];
    int rlo[3], rhi[3];
    for (int ax = 0; ax < 3; ++ax) {
      rlo[ax] = max(lo[ax], (int)d.lo[ax]);
      rhi[ax] = min(hi[ax], (int)(d.lo[ax] + d.n[ax]));
    }
    const float* f = sm + off_of(d.f, vol);
    const float* phr = (const float*)d.phr + s * d.nfreq;
    const float* phi = (const float*)d.phi + s * d.nfreq;
    float* acc = (float*)d.acc;
    over(b, rlo, rhi, tm, [&](const Loc& x) {
      const int r = ((x.i + b.o[0] - (int)d.lo[0]) * (int)d.n[1] +
                     (x.j + b.o[1] - (int)d.lo[1])) *
                        (int)d.n[2] +
                    (x.k + b.o[2] - (int)d.lo[2]);
      float fr, fi;
      if (d.navg) {
        region_value_pair(d, f, b, x, A, &fr, &fi);
      } else {
        fr = f[x.l];
        fi = f[x.l + A.half];
      }
      const float wr = ((const float*)d.w)[r];
      float cr = wr * fr, ci = wr * fi;
      if (d.wi) {
        const float wi = ((const float*)d.wi)[r];
        cr = cr - wi * fi;
        ci = ci + wi * fr;
      }
      for (int q = 0; q < d.nfreq; ++q) {
        const float re = acc[(2 * q) * d.R + r];
        const float im = acc[(2 * q + 1) * d.R + r];
        acc[(2 * q) * d.R + r] = re + (phr[q] * cr - phi[q] * ci);
        acc[(2 * q + 1) * d.R + r] = im + (phi[q] * cr + phr[q] * ci);
      }
    });
  }
}

// K4: the tile's probe points, resolved once per pass: the team's thread t
// holds the t-th point of the tile (and the t + size-th, ...) as its index
// q, the component's staged offset plus the local site, and its weight
struct Pts {
  int q, at;
  float w;
};

__device__ __forceinline__ Pts probe_point(const ResArgs& A, int vol,
                                           const Box& b, int u, int S1,
                                           int S2) {
  const Probes& pr = A.pr;
  Pts p;
  p.q = ((const int*)pr.tpt)[u];
  p.at = (((const int*)pr.tok)[p.q] - 1) * vol +
         local_of(((const int*)pr.off)[p.q], b, S1, S2);
  p.w = ((const float*)pr.w)[p.q];
  return p;
}

// K4: w * f at the probe points of the tile's interior, step r of the pass;
// `mine` is the thread's first point (q -1: none), the rest are resolved
// here
__device__ __forceinline__ void probe_products(const ResArgs& A,
                                               const float* sm, int vol,
                                               const Box& b, int tile,
                                               i64 pass, int r, int S1,
                                               int S2, const Pts& mine,
                                               const Team& tm) {
  const Probes& pr = A.pr;
  float* out = (float*)pr.prod + ((pass & 1) * A.tl.T + r) * pr.npt;
  if (mine.q >= 0) out[mine.q] = sm[mine.at] * mine.w;
  const int* ts = (const int*)pr.tstart;
  for (int u = ts[tile] + (int)(tm.rank + tm.size); u < ts[tile + 1];
       u += (int)tm.size) {
    const Pts p = probe_point(A, vol, b, u, S1, S2);
    out[p.q] = sm[p.at] * p.w;
  }
}

// K4: the series of pass `pass` (steps s0 .. s0 + Tp - 1): per probe and
// step, the products summed in point order from 0.0f; all blocks share it
__device__ void probe_sums(const ResArgs& A, i64 pass) {
  const Probes& pr = A.pr;
  const i64 s0 = pass * A.tl.T;
  const int Tp = (int)min(A.tl.T, A.nsteps - s0);
  const float* prod = (const float*)pr.prod + (pass & 1) * A.tl.T * pr.npt;
  const int* start = (const int*)pr.start;
  const unsigned n = (unsigned)(pr.nprobe * Tp);
  for (unsigned w = blockIdx.x * blockDim.x + threadIdx.x; w < n;
       w += gridDim.x * blockDim.x) {
    const int p = (int)(w / (unsigned)Tp), r = (int)(w % (unsigned)Tp);
    const float* row = prod + r * pr.npt;
    float v = 0.0f;
    for (int q = start[p]; q < start[p + 1]; ++q) v = v + row[q];
    ((float*)pr.series)[p * A.nsteps + s0 + r] = v;
  }
}

// K4 of a real pair (the PAIR variant, direct schedule: T = 1, one tile):
// per point the complex product w f, (fr wr - fi wi, fr wi + fi wr), the
// weights interleaved (re, im) in A.pr.w, into the (2, npt, 2) buffer by
// step parity
__device__ void probe_products_pair(const ResArgs& A, const float* sm,
                                    int vol, const Box& b, i64 s, int S1,
                                    int S2, const Team& tm) {
  const Probes& pr = A.pr;
  float* out = (float*)pr.prod + (s & 1) * pr.npt * 2;
  const float* w = (const float*)pr.w;
  for (unsigned u = tm.rank; u < (unsigned)pr.npt; u += tm.size) {
    const int at = (((const int*)pr.tok)[u] - 1) * vol +
                   local_of(((const int*)pr.off)[u], b, S1, S2);
    const float fr = sm[at], fi = sm[at + A.half];
    const float wr = w[2 * u], wi = w[2 * u + 1];
    out[2 * u] = fr * wr - fi * wi;
    out[2 * u + 1] = fr * wi + fi * wr;
  }
}

// K4 of a real pair: step s's (re, im) series rows, each probe's products
// summed in point order from 0.0f, into (nprobe, nsteps, 2)
__device__ void probe_sums_pair(const ResArgs& A, i64 s) {
  const Probes& pr = A.pr;
  const float* row = (const float*)pr.prod + (s & 1) * pr.npt * 2;
  const int* start = (const int*)pr.start;
  const unsigned n = (unsigned)(pr.nprobe * 2);
  for (unsigned w = blockIdx.x * blockDim.x + threadIdx.x; w < n;
       w += gridDim.x * blockDim.x) {
    const int p = (int)(w / 2), part = (int)(w % 2);
    float v = 0.0f;
    for (int q = start[p]; q < start[p + 1]; ++q) v = v + row[2 * q + part];
    ((float*)pr.series)[(p * A.nsteps + s) * 2 + part] = v;
  }
}

// copy the box [lo, lo + n) of each of the first `ns` arrays between the
// grid (arrays `grid[k]`, strides S1 S2) and shared memory (slot k at
// k * vol, strided as the staged box b): into shared memory when IN, out of
// it else; eight loads in flight per thread
template <bool IN>
__device__ __forceinline__ void copy_box(const void* const* grid, float* sm,
                                         int vol, int ns, const Box& b,
                                         const int* lo, const int* n, int S1,
                                         int S2) {
  const int n12 = n[1] * n[2];
  const unsigned bv = (unsigned)(n[0] * n12), tot = (unsigned)ns * bv;
  const unsigned step = blockDim.x;
  for (unsigned u0 = threadIdx.x; u0 < tot; u0 += 8 * step) {
    float v[8];
    int g[8], s[8], k[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const unsigned u = u0 + m * step;
      g[m] = -1;
      if (u >= tot) continue;
      k[m] = (int)(u / bv);
      const int l = (int)(u - (unsigned)k[m] * bv);
      const int i = l / n12, r = l - i * n12;
      const int j = r / n[2], kk = r - j * n[2];
      g[m] = ((lo[0] + i) * S1 + lo[1] + j) * S2 + lo[2] + kk;
      s[m] = k[m] * vol +
             ((lo[0] - b.o[0] + i) * b.n[1] + lo[1] - b.o[1] + j) * b.n[2] +
             lo[2] - b.o[2] + kk;
      v[m] = IN ? ((const float*)grid[k[m]])[g[m]] : sm[s[m]];
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      if (g[m] < 0) continue;
      if (IN) sm[s[m]] = v[m];
      else ((float*)grid[k[m]])[g[m]] = v[m];
    }
  }
}

// the Tp steps of pass `pass` on box b (staged in sm, or the grid itself
// in the direct schedule), interior [lo, hi); `tf` the descriptors on b,
// `mine` the thread's first probe point; GK: the rotational ghosts or the
// Bloch wrap (direct schedule only); AX: the anisotropic modes (linear
// plans without a wrap), GYRO on the direct schedule only, whose poles of
// the AxTab's `sep` masks run after their family's E (H) and a barrier,
// on the whole grid
template <bool NL, bool PROBED, bool DIRECT, int GK, int AX = AX_NONE>
__device__ void pass_steps(const ResArgs& A, const FamT (&tf)[2][2],
                           float* sm, const Box& b, const int* lo,
                           const int* hi, int tile, i64 pass, int Tp,
                           const Pts& mine) {
  static_assert(AX != AX_GYRO || DIRECT, "GYRO: the direct schedule only");
  const Tiling& tl = A.tl;
  const Team tm = team_of<DIRECT>();
  const int S[3] = {(int)A.pb[0].S0, (int)A.pb[0].S1, (int)A.pb[0].S2};
  const int vol = (int)tl.vol;
  const int c = (int)tl.c, nl = c - 1;
  const int* flags = (const int*)A.flags;
  const AxTab* X = (const AxTab*)A.ax;
  for (int r = 0; r < Tp; ++r) {
    const i64 s = pass * tl.T + r;
    const FamT& FB = tf[0][s & 1];
    const FamT& FD = tf[1][s & 1];
    const int fl = flags[s];
    const bool bsrc = fl & STEP_BSRC, dsrc = fl & STEP_DSRC;
    const int L = (Tp - r) * c;
    int blo[3], bhi[3], dlo[3], elo[3], ehi[3];
    for (int ax = 0; ax < 3; ++ax) {
      const int H = L + (int)tl.e[ax];
      blo[ax] = max(0, lo[ax] - L);
      bhi[ax] = min(S[ax], hi[ax] + H - 1);
      dlo[ax] = max(0, lo[ax] - L + 1);
      elo[ax] = max(0, lo[ax] - L + 1 + nl);
      ehi[ax] = min(S[ax], hi[ax] + H - 1 - nl);
    }
    // B curl (+ H)
    curl_all<false, GK == GK_WRAP || GK == GK_CYL ? GK : GK_NONE>(
        FB, sm, b, blo, bhi, tm, A);
    if (!bsrc) eh_all<false, AX>(FB, sm, b, blo, bhi, tm, &A, 0);
    bar<DIRECT>();
    if (bsrc) {
      sources_at(A, A.src[0], FB, sm, b, tile, s, S[1], S[2], tm);
      bar<DIRECT>();
      eh_all<false, AX>(FB, sm, b, blo, bhi, tm, &A, 0);
      bar<DIRECT>();
    }
    if (AX == AX_GYRO && X->sep[0]) {
      sep_all(FB, A, 0, (int)(s & 1), sm, b, lo, hi, tm);
      bar<DIRECT>();
    }
    // D curl (+ E)
    const bool fused = A.e_local && !dsrc;
    curl_all<true, GK>(FD, sm, b, dlo, bhi, tm, A);
    if (fused) eh_all<NL, AX>(FD, sm, b, dlo, bhi, tm, &A, 1);
    bar<DIRECT>();
    if (!fused) {
      if (dsrc) {
        sources_at(A, A.src[1], FD, sm, b, tile, s, S[1], S[2], tm);
        bar<DIRECT>();
      }
      eh_all<NL, AX>(FD, sm, b, elo, ehi, tm, &A, 1);
      bar<DIRECT>();
    }
    if (AX == AX_GYRO && X->sep[1]) {
      sep_all(FD, A, 1, (int)(s & 1), sm, b, lo, hi, tm);
      bar<DIRECT>();
    }
    // DTFT and probe products at the interior's sites
    const bool dft = fl & STEP_DFT;
    if (dft) dtft<GK>(A, sm, vol, b, lo, hi, s, tm);
    if (PROBED)
      probe_products(A, sm, vol, b, tile, pass, r, S[1], S[2], mine, tm);
    if (dft || PROBED) bar<DIRECT>();
  }
}

// one step s of a real pair in the PAIR variant (direct schedule: the box
// is the grid, sm = A.base): each sub-update runs channel 0 on sm and
// channel 1 on sm + A.half before the grid barrier that ends it, with the
// barriers of pass_steps; the step's K4 series row after the next
// barrier; GK: GK_PAIR, or GK_PAIRBF with BFAST's term after each curl
template <bool PROBED, int GK>
__device__ void pair_step(const ResArgs& A, const FamT (&tf)[2][2],
                          float* sm, const Box& b, const int* lo,
                          const int* hi, i64 s) {
  const Tiling& tl = A.tl;
  const Team tm = team_of<true>();
  const int S[3] = {(int)A.pb[0].S0, (int)A.pb[0].S1, (int)A.pb[0].S2};
  const int vol = (int)tl.vol;
  float* sm1 = sm + A.half;
  const FamT& FB = tf[0][s & 1];
  const FamT& FD = tf[1][s & 1];
  const int fl = ((const int*)A.flags)[s];
  const bool bsrc = fl & STEP_BSRC, dsrc = fl & STEP_DSRC;
  int bhi[3], dlo[3];
  for (int ax = 0; ax < 3; ++ax) {
    bhi[ax] = min(S[ax], hi[ax] + (int)tl.e[ax]);
    dlo[ax] = max(0, lo[ax]);
  }
  // B curl (+ H)
  curl_all<false, GK>(FB, sm, b, lo, bhi, tm, A, 0);
  curl_all<false, GK>(FB, sm1, b, lo, bhi, tm, A, 1);
  if (!bsrc) {
    eh_all<false>(FB, sm, b, lo, bhi, tm);
    eh_all<false>(FB, sm1, b, lo, bhi, tm);
  }
  bar<true>();
  if (bsrc) {
    sources_at<false>(A, A.src[0], FB, sm, b, 0, s, S[1], S[2], tm);
    sources_at<true>(A, A.src[0], FB, sm1, b, 0, s, S[1], S[2], tm);
    bar<true>();
    eh_all<false>(FB, sm, b, lo, bhi, tm);
    eh_all<false>(FB, sm1, b, lo, bhi, tm);
    bar<true>();
  }
  // D curl (+ E: site-local, pair fields carry no chi2/chi3)
  curl_all<true, GK>(FD, sm, b, dlo, bhi, tm, A, 0);
  curl_all<true, GK>(FD, sm1, b, dlo, bhi, tm, A, 1);
  if (!dsrc) {
    eh_all<false>(FD, sm, b, dlo, bhi, tm);
    eh_all<false>(FD, sm1, b, dlo, bhi, tm);
  }
  bar<true>();
  if (dsrc) {
    sources_at<false>(A, A.src[1], FD, sm, b, 0, s, S[1], S[2], tm);
    sources_at<true>(A, A.src[1], FD, sm1, b, 0, s, S[1], S[2], tm);
    bar<true>();
    eh_all<false>(FD, sm, b, dlo, bhi, tm);
    eh_all<false>(FD, sm1, b, dlo, bhi, tm);
    bar<true>();
  }
  const bool dft = fl & STEP_DFT;
  if (dft) dtft_pair(A, sm, vol, b, lo, hi, s, tm);
  if (PROBED) probe_products_pair(A, sm, vol, b, s, S[1], S[2], tm);
  if (dft || PROBED) bar<true>();
}

// tile `tile`'s interior [lo, hi) and its staged box b in a pass of Tp
// steps
__device__ __forceinline__ void tile_box(const ResArgs& A, int tile, int Tp,
                                         int* lo, int* hi, Box& b) {
  const Tiling& tl = A.tl;
  const int S[3] = {(int)A.pb[0].S0, (int)A.pb[0].S1, (int)A.pb[0].S2};
  const int c = (int)tl.c;
  const int nt12 = (int)(tl.nt[1] * tl.nt[2]);
  const int at[3] = {tile / nt12, (tile / (int)tl.nt[2]) % (int)tl.nt[1],
                     tile % (int)tl.nt[2]};
  for (int ax = 0; ax < 3; ++ax) {
    lo[ax] = at[ax] * (int)tl.t[ax];
    hi[ax] = min(S[ax], lo[ax] + (int)tl.t[ax]);
    b.o[ax] = max(0, lo[ax] - Tp * c);
    b.n[ax] = min(S[ax], hi[ax] + Tp * c + (int)tl.e[ax]) - b.o[ax];
  }
}

// the four parameter blocks' descriptors on box b, and the thread's first
// probe point of the tile (its team's); the caller syncs the block
template <bool PROBED, bool DIRECT>
__device__ __forceinline__ void describe_box(const ResArgs& A,
                                             FamT (&tf)[2][2], const Box& b,
                                             int tile, Pts& mine) {
  for (unsigned w = threadIdx.x; w < 28; w += blockDim.x) {
    const unsigned fp = w / 7;
    const Params& P = fp < 2 ? A.pb[fp] : A.pd[fp - 2];
    build_fam(tf[fp / 2][fp % 2], P, (int)(w % 7), b, A.tl,
              fp < 2 ? nullptr : &A);
  }
  mine.q = -1;
  if (PROBED) {
    const int* ts = (const int*)A.pr.tstart;
    const int u = ts[tile] + (int)team_of<DIRECT>().rank;
    if (u < ts[tile + 1])
      mine = probe_point(A, (int)A.tl.vol, b, u, (int)A.pb[0].S1,
                         (int)A.pb[0].S2);
  }
}

// one tile's pass: stage, Tp steps, write the interior into the other set
template <bool NL, bool PROBED, int AX = AX_NONE>
__device__ void tile_pass(const ResArgs& A, FamT (&tf)[2][2], float* sm,
                          int tile, i64 pass, int Tp) {
  const Tiling& tl = A.tl;
  const int S1 = (int)A.pb[0].S1, S2 = (int)A.pb[0].S2;
  const int vol = (int)tl.vol;
  int lo[3], hi[3], n[3];
  Box b;
  tile_box(A, tile, Tp, lo, hi, b);
  for (int ax = 0; ax < 3; ++ax) n[ax] = hi[ax] - lo[ax];
  // the parameter blocks on this box, and the staged arrays from the set
  // this pass reads
  Pts mine;
  describe_box<PROBED, false>(A, tf, b, tile, mine);
  copy_box<true>(A.set[pass & 1], sm, vol, (int)tl.nslot, b, b.o, b.n, S1,
                 S2);
  // the per-axis vectors on the box's range of their axis
  const i64* vt = (const i64*)A.vec;
  for (unsigned u = threadIdx.x; u < (unsigned)(tl.nvec * tl.gvec);
       u += blockDim.x) {
    const int v = (int)(u / (unsigned)tl.gvec), m = (int)(u % tl.gvec);
    const int ax = (int)vt[2 * v + 1];
    if (m < b.n[ax])
      sm[tl.nslot * vol + u] = ((const float*)vt[2 * v])[b.o[ax] + m];
  }
  __syncthreads();
  pass_steps<NL, PROBED, false, GK_NONE, AX>(A, tf, sm, b, lo, hi, tile,
                                              pass, Tp, mine);
  // the interior into the set this pass writes
  copy_box<false>(A.set[(pass + 1) & 1], sm, vol, (int)tl.nstate, b, lo, n,
                  S1, S2);
  __syncthreads();                     // before the next tile stages
}

// NL: the E family carries chi3 / chi2-NR coefficients; PROBED: K4; DIRECT:
// the direct schedule (one tile, the whole grid, stepped in place in A.base
// by all the grid's threads, T = 1); GK (with DIRECT): the rotational fold
// ghosts or the Bloch wrap; AX: the anisotropic modes (GK_NONE, linear)
template <bool NL, bool PROBED, bool DIRECT, int GK, int AX = AX_NONE>
__global__ void __launch_bounds__(NL ? NTHR / 2 : NTHR, 1)
    k3_kernel(const ResArgs* gA) {
  __shared__ __align__(16) ResArgs A;
  __shared__ __align__(16) FamT tf[2][2];  // [family][step parity] on the tile
  {
    const i64* from = (const i64*)gA;
    i64* to = (i64*)&A;
    for (unsigned w = threadIdx.x; w < sizeof(ResArgs) / 8; w += blockDim.x)
      to[w] = from[w];
  }
  __syncthreads();
  const i64 npass = (A.nsteps + A.tl.T - 1) / A.tl.T;
  if (DIRECT && (GK == GK_PAIR || GK == GK_PAIRBF || GK == GK_PAIRCYL)) {
    int lo[3], hi[3];
    Box b;
    tile_box(A, 0, 1, lo, hi, b);
    Pts mine;
    describe_box<false, true>(A, tf, b, 0, mine);
    __syncthreads();
    for (i64 s = 0; s < A.nsteps; ++s) {
      if (PROBED && s > 0) probe_sums_pair(A, s - 1);
      pair_step<PROBED, GK>(A, tf, (float*)A.base, b, lo, hi, s);
    }
    if (PROBED) probe_sums_pair(A, A.nsteps - 1);
    return;
  }
  if constexpr (DIRECT) {
    int lo[3], hi[3];
    Box b;
    tile_box(A, 0, 1, lo, hi, b);
    Pts mine;
    describe_box<PROBED, true>(A, tf, b, 0, mine);
    __syncthreads();
    // every step ends with a grid barrier (after E, or after the DTFT and
    // the probe products)
    for (i64 p = 0; p < npass; ++p) {
      if (PROBED && p > 0) probe_sums(A, p - 1);
      pass_steps<NL, PROBED, true, GK, AX>(A, tf, (float*)A.base, b, lo,
                                           hi, 0, p, 1, mine);
    }
  } else {
    cg::grid_group grid = cg::this_grid();
    float* sm = K3_SMEM;
    const int ntile = (int)(A.tl.nt[0] * A.tl.nt[1] * A.tl.nt[2]);
    for (i64 p = 0; p < npass; ++p) {
      if (PROBED && p > 0) probe_sums(A, p - 1);
      const int Tp = (int)min(A.tl.T, A.nsteps - p * A.tl.T);
      for (int tile = (int)blockIdx.x; tile < ntile; tile += (int)gridDim.x)
        tile_pass<NL, PROBED, AX>(A, tf, sm, tile, p, Tp);
      if (PROBED || p + 1 < npass) grid.sync();
    }
  }
  if (PROBED) probe_sums(A, npass - 1);
}

static int threads_of(int nl) { return nl ? NTHR / 2 : NTHR; }

// the anisotropic modes' variants: linear, K3 or K4; OFFDIAG on tiles
// (direct 0) or the direct schedule (1), GYRO on the direct schedule only
// (its tiled variant spilled and ran slower)
template <int AX, bool DIRECT>
static const void* kernel_ax(int probed) {
  return probed ? (const void*)k3_kernel<false, true, DIRECT, GK_NONE, AX>
                : (const void*)k3_kernel<false, false, DIRECT, GK_NONE, AX>;
}

static const void* kernel_ax(int axmode, int probed, int direct) {
  if (axmode == AX_GYRO)
    return direct ? kernel_ax<AX_GYRO, true>(probed) : nullptr;
  return direct ? kernel_ax<AX_OFFDIAG, true>(probed)
                : kernel_ax<AX_OFFDIAG, false>(probed);
}

template <bool NL, bool PROBED>
static const void* kernel_dir(int direct) {
  if (direct == 3) return (const void*)k3_kernel<NL, PROBED, true, GK_WRAP>;
  return direct ? (const void*)k3_kernel<NL, PROBED, true, GK_NONE>
                : (const void*)k3_kernel<NL, PROBED, false, GK_NONE>;
}

// the variant; direct 2: the direct schedule with the rotational ghosts
// (linear plans only: a fold declines chi2/chi3), else nullptr; direct 3:
// the direct schedule with the Bloch wrap; direct 4: the direct schedule
// of a real pair (linear plans only: pair fields refuse chi2/chi3); direct
// 5: the same with BFAST's term; direct 6: the direct schedule of a
// cylindrical plan on real fields, 7: of a cylindrical or beta plan on a
// real pair (linear plans only: the wrapper declines chi2/chi3 there)
static const void* kernel_of(int nl, int probed, int direct,
                             int axmode = AX_NONE) {
  if (axmode != AX_NONE)
    return (nl || direct > 1) ? nullptr
                              : kernel_ax(axmode, probed, direct);
  if (direct == 7)
    return nl ? nullptr
              : (probed ? (const void*)k3_kernel<false, true, true, GK_PAIRCYL>
                        : (const void*)k3_kernel<false, false, true,
                                                 GK_PAIRCYL>);
  if (direct == 6)
    return nl ? nullptr
              : (probed ? (const void*)k3_kernel<false, true, true, GK_CYL>
                        : (const void*)k3_kernel<false, false, true, GK_CYL>);
  if (direct == 5)
    return nl ? nullptr
              : (probed ? (const void*)k3_kernel<false, true, true, GK_PAIRBF>
                        : (const void*)k3_kernel<false, false, true,
                                                 GK_PAIRBF>);
  if (direct == 4)
    return nl ? nullptr
              : (probed ? (const void*)k3_kernel<false, true, true, GK_PAIR>
                        : (const void*)k3_kernel<false, false, true, GK_PAIR>);
  if (direct == 2)
    return nl ? nullptr
              : (probed ? (const void*)k3_kernel<false, true, true, GK_ROT>
                        : (const void*)k3_kernel<false, false, true, GK_ROT>);
  if (nl)
    return probed ? kernel_dir<true, true>(direct)
                  : kernel_dir<true, false>(direct);
  return probed ? kernel_dir<false, true>(direct)
                : kernel_dir<false, false>(direct);
}

extern "C" {

i64 mnt_k3_args_size(void) { return (i64)sizeof(ResArgs); }

// threads per block of the linear (nl 0) or nonlinear variant
i64 mnt_k3_threads(int nl) { return threads_of(nl); }

i64 mnt_k3_maxslot(void) { return MAXSLOT; }

// the kernel's static shared memory: its argument block and the tile's
// parameter-block descriptors
i64 mnt_k3_static_smem(void) {
  return (i64)((sizeof(ResArgs) + 15) / 16 * 16 + 4 * sizeof(FamT));
}

// the shared memory a block may have on the current device: [0] a block's
// opt-in most, [1] an SM's, [2] the reserve per block, [3] the kernel's
// static shared memory (its argument block and the tile's descriptors);
// returns the cudaError, else 0
int mnt_k3_smem(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const cudaDeviceAttr attr[3] = {cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                  cudaDevAttrReservedSharedMemoryPerBlock};
  for (int i = 0; i < 3 && e == cudaSuccess; ++i)
    e = cudaDeviceGetAttribute(&out[i], attr[i], dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel_of(0, 0, 0));
  if (e == cudaSuccess) out[3] = (int)fa.sharedSizeBytes;
  return (int)e;
}

// the current device's SM count, or -cudaError
int mnt_k3_sms(void) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e == cudaSuccess ? sms : -(int)e;
}

// the largest co-resident grid of the variant (nl, probed, direct: 0 tiles,
// 1 the direct schedule, 2 with the rotational ghosts, 3 with the Bloch
// wrap, 4 a real pair, 5 a real pair with BFAST, 6 cylindrical, 7 a
// cylindrical or beta real pair; axmode: the anisotropic modes) with
// `smem` bytes of dynamic shared memory on the current device, after
// allowing the variant that much there; or -cudaError.  The wrapper asks
// once per device, variant and smem, and launches at most that many blocks.
int mnt_k3_max_blocks(int nl, int probed, int direct, int axmode,
                      int smem) {
  const void* fn = kernel_of(nl != 0, probed != 0, direct, axmode);
  if (!fn) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, fn, threads_of(nl != 0), (size_t)smem);
  if (e != cudaSuccess) return -(int)e;
  if (per < 1 || sms < 1) return -(int)cudaErrorLaunchOutOfResources;
  return per * sms;
}

// Launch the kernel cooperatively on `stream` over the argument block at
// device address `args` (`host` is the same block in host memory, read for
// the variant) with `blocks` blocks (at most mnt_k3_max_blocks' figure for
// the variant and `smem` on this device) and `smem` bytes of dynamic shared
// memory; the variant with the nonlinear branches when an E-family block
// carries chi3 / chi2-NR coefficients, the probed one (K4) when the block
// has probes, the direct one when the tiling says so.  Returns the
// cudaError of the first call that failed, else 0.
int mnt_k3_launch(const ResArgs* host, const void* args, int blocks,
                  int smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  for (int par = 0; par < 2; ++par) {
    if (has_nl(host->pb[par])) return (int)cudaErrorInvalidValue;
    // the descriptors run the PML chains everywhere (no slabs)
    for (int fam = 0; fam < 2; ++fam) {
      const Params& P = fam ? host->pd[par] : host->pb[par];
      for (int q = 0; q < P.ncurl; ++q)
        if (P.curl[q].slab) return (int)cudaErrorInvalidValue;
      for (int q = 0; q < P.neh; ++q)
        if (P.eh[q].w_slab) return (int)cudaErrorInvalidValue;
    }
  }
  const Tiling& tl = host->tl;
  const int direct = (int)tl.direct;
  if (direct < 0 || direct > 7) return (int)cudaErrorInvalidValue;
  // rotational ghosts, the Bloch wrap and BFAST only in their variants,
  // which have them (the pair's with or without a wrap); the pair's
  // channel 1 past channel 0's half of the buffer
  bool rot = false, wrap = false, bfast = false;
  for (int q = 0; q < NCOMP; ++q)
    for (int m = 0; m < 2; ++m) rot = rot || host->gsrc[q][m] != 0;
  for (int ax = 0; ax < 3; ++ax) wrap = wrap || host->wn[ax] != 0;
  for (int fam = 0; fam < 2; ++fam)
    for (int q = 0; q < NCOMP; ++q) bfast = bfast || host->bf[fam][q] != 0;
  const bool pair = direct == 4 || direct == 5 || direct == 7;
  if (rot != (direct == 2) || (!pair && wrap != (direct == 3)) ||
      bfast != (direct == 5) ||
      (host->cyl != nullptr) != (direct == 6 || direct == 7))
    return (int)cudaErrorInvalidValue;
  if (pair != (host->half > 0)) return (int)cudaErrorInvalidValue;
  // the anisotropic modes: their table, tiles or the plain direct schedule
  const int axmode = (int)host->axmode;
  if (axmode < 0 || axmode > AX_GYRO || (axmode != 0) != (host->ax != nullptr)
      || (axmode != 0 && direct > 1))
    return (int)cudaErrorInvalidValue;
  if (tl.T < 1 || tl.c < 1 || tl.nstate > tl.nslot || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const i64 ntile = tl.nt[0] * tl.nt[1] * tl.nt[2];
  if (direct ? (tl.T != 1 || !host->base || ntile != 1) : tl.nslot > MAXSLOT)
    return (int)cudaErrorInvalidValue;
  const int nl = has_nl(host->pd[0]) ? 1 : 0;
  const int probed = host->pr.nprobe > 0 ? 1 : 0;
  if (!kernel_of(nl, probed, direct, axmode))
    return (int)cudaErrorInvalidValue;
  void* kargs[] = {(void*)&args};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel_of(nl, probed, direct, axmode), dim3((unsigned)blocks),
      dim3(threads_of(nl)), kargs, (size_t)smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
