// K5 on Hopper: one fused half step (B then H, or D then E) of a 3D uPML
// plan with diagonal media, with the half's current sources folded in,
// written by hand for sm_90a and bound through a plain C interface
// (ctypes).
//
// Replaces the TPU kernel meep_nl_tpu/ops/pallas/fused.py::build_half_step
// (:71; kernel body :174-296, pallas_call :302), the round-1 kernel that
// Simulation(use_pallas=True) steps through, together with the source
// fix-up that follows it (build_source_fixup, :358).  It computes, site by
// site and in the same operation order, what ops/fused.py's plain versions
// compute (half_step_ref, then SourceFixup._ref):
//   dfl  = (+-Courant) * (diff g_plus - diff g_minus), the g family's
//          neighbours at +-1, zero outside the storage (the reference's
//          make_shifted / shift_yz);
//   D/B  through the full-grid sigma chain (f_u aux) and sigma_u chain:
//          fu_new = ((kap - sig) fu + dfl) siginv     (or fu + dfl)
//          f_new  = siginvu ((kapu - sigu) f + fu_new - fu_old);
//   E/H  from the site's new D/B: lin = u D, then the W chain
//          e_new  = e + (kapw + sigw) lin - (kapw - sigw) fw_old, fw = lin;
//   the dead-plane masks (per-axis 0/1 vectors) on the new D/B and E/H;
//   then each current source entry at the site, in plan.sources order and
//   entry order: dD = -J dt into D/B, dlin = u dD into f_w, and
//   (kapw + sigw) dlin (or dlin) times the E/H mask into E/H.
// The arithmetic is fdtd3d_site.cuh's value functions (curl_delta,
// curl_value, w_value, source_amp), which K1-K4 run too, built without FMA
// contraction: the kernel agrees with the plain versions bit for bit in
// fp32.  The chains run on every site, as the reference's do: outside the
// PML slabs they do not reduce to f + dfl in floating point, so f_u and
// f_w are read and written everywhere.
//
// What bounds it on the H100: device-memory bytes.  With uPML on every face
// a half step streams the three curl partners in, D/B, f_u, E/H and f_w in
// and out (and u in, where the medium has one): ops/fused.py::step_cost,
// 1.08 ms a step at 255^3 vacuum.  The launches reach about 80 % of it
// there and half of it at 96^3 (PERF.md §6).
//
// Layout of work (K1's, csrc/fdtd3d.cu, for one launch kind per half).  A
// block owns a (TY, TZ) tile of the y-z plane, k fastest (a warp reads one
// row of consecutive addresses), and marches along x over a chunk of `ch`
// planes; the wrapper picks ch so that there are several (tile, chunk)
// items for each SM.  The curl partners live in a ring of planes in
// dynamic shared memory: the B half keeps the E planes i and i+1 with a +1
// halo in y and z, the D half the H planes i-1 and i with a -1 halo.  The
// next plane comes in by cp.async while this one computes; each thread
// copies its fixed ring positions (offsets worked out once per item).  What
// a site reads at its own position (f, f_u, u, e, f_w) is loaded into
// registers a plane ahead (Own: the loads of plane i + 1 are issued before
// plane i's site work, two sets in registers), so a plane's work waits for
// memory once and the loads overlap the work.
// The chain coefficients and alive factors along y and z are worked out
// once per item into the site's entries of a shared-memory table (Site),
// those along x into a table of the chunk.  Offsets are 32-bit (the wrapper
// refuses a storage of 2^31 sites or more); a thread's j, k come from its
// block and lane, with no division in the site loop.
// Read-after-write: the B half reads only E across sites and writes B,
// f_u, H and H's f_w; the D half reads only H across sites.  So the halos
// are plain loads, the update is in place, and no grid barrier is needed.
// The sources of a site are added by the thread that owns it, from a
// per-(tile, plane) list sorted by site, then in plan.sources order and
// entry order (the plain version's order of accumulation): no atomics and
// no launch of their own.
//
// Host emulation: tile loads and site work are block-stride loops and the
// items a grid-stride loop, every cp.async has a plain-copy twin, and the
// launch goes through cudaLaunchKernel, so tests/cuda_stub runs this file
// with one thread per block (tests/test_torch_fused_emul.py).

#include "fdtd3d_march.cuh"

// the y-z tile: TY rows (j) of TZ columns (k), one warp a row; another
// tile is a build option (-DK5_TY=.. -DK5_TZ=..), which the host emulation
// uses to put tile edges inside small grids
#ifndef K5_TY
#define K5_TY 8
#endif
#ifndef K5_TZ
#define K5_TZ 32
#endif
// blocks an SM should hold, the register budget of __launch_bounds__ (2
// and 4 measured slower on the H100, PERF.md §6)
#define MINB 3
#define TY K5_TY
#define TZ K5_TZ
#define NT (TY * TZ)                  // sites of a tile plane
// sites a thread owns: one on the card; the host emulation runs one
// thread that owns them all
#ifdef MNT_CUDA_STUB
#define SPT NT
#else
#define SPT 1
#endif
#define NTHR (NT / SPT)               // threads per block
#define MAXSRC 32                     // waveforms passed by value
// the x vectors a block stages: kap sig siginv kapu sigu siginvu alive of
// each D/B component, kapw sigw alive of each E/H component
#define NTAB_CURL (7 * NCOMP)
#define NTAB (NTAB_CURL + 3 * NCOMP)
// the per-site y/z factors (Site): 8 per component
#define SITE_WORDS (8 * NCOMP * NT)

// Mirrored by meep_nl_tpu_torch/ops/fused.py (_K5Args).
struct K5Args {
  Params P;                           // the half's block (build_params)
  const void* ring[NCOMP];            // the curl partners
  const void* src_ptr;                // int32 [tile * S0 + i] -> entries
  const void* src_key;                // int32 (site << 4) | (qe << 2) | qc
  const void* src_id;                 // int32 waveform index
  const void* src_amp;                // T (n, 2): amplitude re, im
  const void* wave_dev;               // double (nsrc, 2), or null: wave
  double wave[2 * MAXSRC];            // this step's waveforms (re, im)
  double dt;
  CurlC cc[NCOMP];
  EhC ec[NCOMP];
  int d_of[NCOMP];                    // curl index of E/H q's D/B
  int nring, S0, S1, S2, nty, ntz, ch, nch;
};

#ifdef MNT_CUDA_STUB
#define K5_SMEM stub_dynamic_smem()
#else
extern __shared__ __align__(16) unsigned char k5_smem[];
#define K5_SMEM k5_smem
#endif

// the plane ring of a half: the halo below / above the tile in y and z,
// the slots, the positions a thread copies
template <bool IS_D>
struct Ring {
  static constexpr int LO = IS_D ? 1 : 0;
  static constexpr int HI = IS_D ? 0 : 1;
  static constexpr int NSLOT = 3;
  static constexpr int RW = TZ + 1;
  static constexpr int PW = RW * (TY + 1);
  static constexpr int NPOS = (PW + NTHR - 1) / NTHR;
};

// ---- what a site keeps along the march ------------------------------------

// the per-site factors that do not change along x, one entry per site of
// the tile (NT apart) in shared memory; a site reads only its own entries:
// the W chain's kp, km (kapw +- sigw), the E/H alive factor of y and z,
// the chains' kms (kap - sig, rounded as the plain version's), siv, kmsu,
// sivu, and the D/B alive factor
enum { F_KP = 0, F_KM = 1, F_ME = 2, F_KMS = 3, F_SIV = 4, F_KMSU = 5,
       F_SIVU = 6, F_MC = 7 };

template <typename T>
struct Site {
  int jj, kk, n0;                     // tile row and column, j * S2 + k
  bool ok;                            // inside the storage
  T* v;                               // this site's entry of the factors
  __device__ __forceinline__ T& f(int field, int q) const {
    return v[(field * NCOMP + q) * NT];
  }
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

template <typename T, bool U>
__device__ __forceinline__ void site_setup(const K5Args& A, Site<T>& s,
                                           T* sv, int t, int j0, int k0) {
  const Params& P = A.P;
  s.v = sv + t;
  s.jj = t / TZ;
  s.kk = t - s.jj * TZ;
  const int j = j0 + s.jj, k = k0 + s.kk;
  s.ok = j < A.S1 && k < A.S2;
  s.n0 = j * A.S2 + k;
  if (!s.ok) return;
#pragma unroll
  for (int q = 0; q < NCOMP; ++q) {
    T kms = T(0), siv = T(0), kmsu = T(0), sivu = T(0), mc = T(1);
    if (q < P.ncurl) {
      const CurlP& c = P.curl[q];
      const int ax = U ? u_ax1(q) : A.cc[q].sax;
      const int axu = U ? u_ax2(q) : A.cc[q].uax;
      if (ax > 0) {
        kms = yz<T>(c.kap, ax, j, k) - yz<T>(c.sig, ax, j, k);
        siv = yz<T>(c.siginv, ax, j, k);
      }
      if (axu > 0) {
        kmsu = yz<T>(c.kapu, axu, j, k) - yz<T>(c.sigu, axu, j, k);
        sivu = yz<T>(c.siginvu, axu, j, k);
      }
      mc = alive_yz<T>(c.alive, j, k);
    }
    s.f(F_KMS, q) = kms;
    s.f(F_SIV, q) = siv;
    s.f(F_KMSU, q) = kmsu;
    s.f(F_SIVU, q) = sivu;
    s.f(F_MC, q) = mc;
    T kp = T(0), km = T(0), me = T(1);
    if (q < P.neh) {
      const EhP& e = P.eh[q];
      const int ax = U ? q : A.ec[q].wax;
      if (ax > 0) {
        const T kw = yz<T>(e.kapw, ax, j, k), sw = yz<T>(e.sigw, ax, j, k);
        kp = kw + sw;
        km = kw - sw;
      }
      me = alive_yz<T>(e.alive, j, k);
    }
    s.f(F_KP, q) = kp;
    s.f(F_KM, q) = km;
    s.f(F_ME, q) = me;
  }
}

// the chunk's x vectors in shared memory (L = ch entries each): D/B
// components first, then E/H components; a vector along another axis is
// not staged, a null alive vector reads 1
template <typename T>
__device__ __forceinline__ void load_tables(const K5Args& A, T* tab, int i0,
                                            int tid) {
  const Params& P = A.P;
  const int L = A.ch;
  for (int e = tid; e < NTAB * L; e += NTHR) {
    const int d = e / L, l = e - d * L, i = i0 + l;
    const void* src = nullptr;
    bool alive;
    if (d < NTAB_CURL) {
      const int q = d / 7, m = d - 7 * q;
      alive = m == 6;
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
      const int q = (d - NTAB_CURL) / 3, m = d - NTAB_CURL - 3 * q;
      alive = m == 2;
      if (q < P.neh) {
        const EhP& h = P.eh[q];
        if (m < 2 && A.ec[q].wax == 0) src = m == 0 ? h.kapw : h.sigw;
        else if (m == 2) src = h.alive[0];
      }
    }
    tab[e] = (src && i < A.S0) ? ((const T*)src)[i] : T(alive ? 1 : 0);
  }
}

// a thread's ring positions: their offsets in a ring plane and in a
// storage plane, and whether they lie inside the storage
template <bool IS_D>
struct RingPos {
  int o[Ring<IS_D>::NPOS], g[Ring<IS_D>::NPOS];
  bool ok[Ring<IS_D>::NPOS];
};

template <bool IS_D>
__device__ __forceinline__ void ring_setup(const K5Args& A,
                                           RingPos<IS_D>& rp, int tid,
                                           int j0, int k0) {
  typedef Ring<IS_D> G;
#pragma unroll
  for (int u = 0; u < G::NPOS; ++u) {
    const int o = tid + u * NTHR;
    const int rj = o / G::RW, rk = o - rj * G::RW;
    const int j = j0 - G::LO + rj, k = k0 - G::LO + rk;
    rp.o[u] = o < G::PW ? o : -1;
    rp.ok[u] = o < G::PW && j >= 0 && j < A.S1 && k >= 0 && k < A.S2;
    rp.g[u] = j * A.S2 + k;
  }
}

// issue the copies of plane p of every ring array into its slot; sites
// outside the storage read zero (the plain version's zero fill)
template <typename T, bool IS_D>
__device__ __forceinline__ void ring_issue(const K5Args& A,
                                           const RingPos<IS_D>& rp, T* ring,
                                           int p) {
  typedef Ring<IS_D> G;
  T* slot = ring + ((p + G::NSLOT) % G::NSLOT) * A.nring * G::PW;
  const bool pin = p >= 0 && p < A.S0;
  const int base = p * A.S1 * A.S2;
  for (int r = 0; r < A.nring; ++r) {
    const T* src = (const T*)A.ring[r] + base;
    T* dst = slot + r * G::PW;
#pragma unroll
    for (int u = 0; u < G::NPOS; ++u) {
      if (rp.o[u] < 0) continue;
      if (pin && rp.ok[u]) cp_async<T>(dst + rp.o[u], src + rp.g[u]);
      else dst[rp.o[u]] = T(0);
    }
  }
}

// ---- what a site reads at its own position --------------------------------

// The operands a site reads at its own position in one plane, loaded a
// plane ahead: f, fu each D/B component and its f_u, u, e, fw each E/H
// component's chi1inv, old value and f_w (what its W chain reads), and
// the site's source list range.
template <typename T>
struct Own {
  T f[NCOMP], fu[NCOMP], u[NCOMP], e[NCOMP], fw[NCOMP];
  int sa, sb;
};

template <typename T, bool U>
__device__ __forceinline__ void own_load(const K5Args& A, const Site<T>& s,
                                         int i, int tile, Own<T>& o) {
  const Params& P = A.P;
  const int n = i * A.S1 * A.S2 + s.n0;
#pragma unroll
  for (int q = 0; q < NCOMP; ++q) {
    const CurlP& c = P.curl[q];
    const bool has = q < P.ncurl;
    const bool uon = has && (U ? u_ax2(q) : A.cc[q].uax) >= 0;
    o.f[q] = has ? ((const T*)c.f)[n] : T(0);
    o.fu[q] = uon ? ((const T*)c.fu)[n] : T(0);
  }
#pragma unroll
  for (int q = 0; q < NCOMP; ++q) {
    const EhP& e = P.eh[q];
    const bool has = q < P.neh;
    const bool won = has && (U ? q : A.ec[q].wax) >= 0;
    o.u[q] = has && A.ec[q].has_u ? ((const T*)e.u)[n] : T(1);
    o.e[q] = won ? ((const T*)e.f)[n] : T(0);
    o.fw[q] = won ? ((const T*)e.fw)[n] : T(0);
  }
  o.sa = o.sb = 0;
  if (A.src_ptr) {
    o.sa = ((const int*)A.src_ptr)[tile * A.S0 + i];
    o.sb = ((const int*)A.src_ptr)[tile * A.S0 + i + 1];
  }
}

// ---- the site work --------------------------------------------------------

// the difference of ring array r along axis ax at the site: the D half
// backward (g - g[-1]), the B half forward (g[+1] - g); `here` points at
// the site in the plane's slot, `xnb` at it in the x-neighbour plane's
// slot; r < 0: none.  Written without branches, so that the three
// components' dependency chains interleave.
template <typename T, bool IS_D>
__device__ __forceinline__ T ring_diff(const T* here, const T* xnb, int r,
                                       int ax) {
  typedef Ring<IS_D> G;
  const int rr = (r < 0 ? 0 : r) * G::PW;
  const int st = (ax == 1 ? G::RW : 1) * (IS_D ? -1 : 1);
  const T g = here[rr];
  const T nb = ax == 0 ? xnb[rr] : here[rr + st];
  const T d = IS_D ? g - nb : nb - g;
  return r < 0 ? T(0) : d;
}

// the current sources of entries [a, b) (the site's tile plane) at tile
// site `me`, after the half's update: dD into the new D/B f[qc], dlin = u dD
// into the new f_w fw[qe] where the W chain runs, and (kapw + sigw) dlin
// (or dlin) times the E/H mask into the new E/H e[qe]; in plan.sources
// order and entry order, as SourceFixup._ref accumulates
template <typename T>
__device__ __forceinline__ void add_sources(const K5Args& A, int a, int b,
                                            int me, const Own<T>& ow,
                                            const WIn<T>* w, T* f, T* e,
                                            T* fw) {
  if (a == b) return;
  const int* key = (const int*)A.src_key;
  int lo = a, hi = b;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((key[mid] >> 4) < me) lo = mid + 1;
    else hi = mid;
  }
  const T* amp = (const T*)A.src_amp;
  const double* wv = A.wave_dev ? (const double*)A.wave_dev : A.wave;
  for (int t = lo; t < b && (key[t] >> 4) == me; ++t) {
    const int s = ((const int*)A.src_id)[t];
    const T dD = -source_amp<T>(amp, amp + 1, 2 * t, T(wv[2 * s]),
                                T(wv[2 * s + 1]), T(A.dt));
    const int qc = key[t] & 3, qe = (key[t] >> 2) & 3;
#pragma unroll
    for (int q = 0; q < NCOMP; ++q) {
      if (q == qc) f[q] = f[q] + dD;
      if (q != qe) continue;
      const T dlin = A.ec[q].has_u ? dD * ow.u[q] : dD;
      if (w[q].on) {
        fw[q] = fw[q] + dlin;
        e[q] = e[q] + w[q].kp * dlin * w[q].mask;
      } else {
        e[q] = e[q] + dlin * w[q].mask;
      }
    }
  }
}

// one site of a half: the masked curl update of every D/B component, E/H
// from the new D/B through the W chain and the mask, the sources, the
// stores.  A component the plan lacks computes on zeros and stores nothing.
template <typename T, bool IS_D, bool U>
__device__ __forceinline__ void site_k5(const K5Args& A, const T* tab,
                                        const T* ring, const Site<T>& s,
                                        const Own<T>& ow, int i, int xl,
                                        int sh, int sx) {
  typedef Ring<IS_D> G;
  const Params& P = A.P;
  const int L = A.ch;
  const int n = i * A.S1 * A.S2 + s.n0;
  const int o = (s.jj + G::LO) * G::RW + s.kk + G::LO;
  const T* here = ring + sh * A.nring * G::PW + o;
  const T* xnb = ring + sx * A.nring * G::PW + o;
  const T csgn = T(P.csgn);
  T fnew[NCOMP], fun[NCOMP];
#pragma unroll
  for (int q = 0; q < NCOMP; ++q) {
    const CurlC& cc = A.cc[q];
    const int gp = U ? u_gp(q) : cc.gp, gm = U ? u_gm(q) : cc.gm;
    const int sax = U ? u_ax1(q) : cc.sax, uax = U ? u_ax2(q) : cc.uax;
    const T dfl = curl_delta<T>(
        gp >= 0, ring_diff<T, IS_D>(here, xnb, gp, U ? u_ax1(q) : cc.ap),
        gm >= 0, ring_diff<T, IS_D>(here, xnb, gm, U ? u_ax2(q) : cc.am),
        csgn);
    const T* tq = tab + 7 * q * L;
    const bool xs = sax == 0, xu = uax == 0;
    const T kms = xs ? tq[xl] - tq[L + xl] : s.f(F_KMS, q);
    const T siv = xs ? tq[2 * L + xl] : s.f(F_SIV, q);
    const T kmsu = xu ? tq[3 * L + xl] - tq[4 * L + xl] : s.f(F_KMSU, q);
    const T sivu = xu ? tq[5 * L + xl] : s.f(F_SIVU, q);
    fun[q] = T(0);
    fnew[q] = curl_value<T>(ow.f[q], dfl, sax >= 0, sax >= 0, kms, siv,
                            q < P.ncurl && uax >= 0, kmsu, sivu, ow.fu[q],
                            &fun[q]) *
              (tq[6 * L + xl] * s.f(F_MC, q));
  }
  // E/H from the new D/B
  T lin[NCOMP], enew[NCOMP];
  WIn<T> w[NCOMP];
#pragma unroll
  for (int q = 0; q < NCOMP; ++q) {
    T gs = T(0);
#pragma unroll
    for (int qq = 0; qq < NCOMP; ++qq)
      if (qq == A.d_of[q]) gs = fnew[qq];
    lin[q] = A.ec[q].has_u ? gs * ow.u[q] : gs;
    const bool x = (U ? q : A.ec[q].wax) == 0;
    const T* tq = tab + (NTAB_CURL + 3 * q) * L;
    const T kw = tq[xl], sw = tq[L + xl];
    w[q].on = q < P.neh && (U ? q : A.ec[q].wax) >= 0;
    w[q].kp = x ? kw + sw : s.f(F_KP, q);
    w[q].km = x ? kw - sw : s.f(F_KM, q);
    w[q].f = ow.e[q];
    w[q].fw = ow.fw[q];
    w[q].mask = tq[2 * L + xl] * s.f(F_ME, q);
    enew[q] = w_value<T>(lin[q], w[q]);
  }
  add_sources<T>(A, ow.sa, ow.sb, s.jj * TZ + s.kk, ow, w, fnew, enew, lin);
#pragma unroll
  for (int q = 0; q < NCOMP; ++q) {
    if (q >= P.ncurl) continue;
    if ((U ? u_ax2(q) : A.cc[q].uax) >= 0) ((T*)P.curl[q].fu)[n] = fun[q];
    ((T*)P.curl[q].f)[n] = fnew[q];
  }
#pragma unroll
  for (int q = 0; q < NCOMP; ++q) {
    if (q >= P.neh) continue;
    if (w[q].on) ((T*)P.eh[q].fw)[n] = lin[q];
    ((T*)P.eh[q].f)[n] = enew[q];
  }
}

// ---- the x-march of one item -----------------------------------------------

// one plane i of the march: wait for its ring planes, load the own
// operands of plane i + 1 into `nxt`, then the site work on those of plane
// i in `cur` (the loads are in flight during it)
template <typename T, bool IS_D, bool U>
__device__ __forceinline__ void plane(const K5Args& A, const T* tab, T* ring,
                                      const Site<T>* s, Own<T>* cur,
                                      Own<T>* nxt, const RingPos<IS_D>& rp,
                                      int tile, int i, int i0, int i1) {
  constexpr int AHEAD = IS_D ? 1 : 2;
  const int last = IS_D ? i1 - 1 : i1;           // the last plane read
  if (i + AHEAD <= last) ring_issue<T, IS_D>(A, rp, ring, i + AHEAD);
  cp_commit();
  cp_wait1();
  __syncthreads();
  if (i + 1 < i1) {
#pragma unroll
    for (int m = 0; m < SPT; ++m)
      if (s[m].ok) own_load<T, U>(A, s[m], i + 1, tile, nxt[m]);
  }
  const int sh = i % 3;
  const int sx = (i + (IS_D ? 2 : 1)) % 3;
#pragma unroll
  for (int m = 0; m < SPT; ++m)
    if (s[m].ok)
      site_k5<T, IS_D, U>(A, tab, ring, s[m], cur[m], i, i - i0, sh, sx);
  __syncthreads();
}

// the B half reads the ring planes i and i+1 (and brings in i+2), the D
// half the planes i-1 and i (brings in i+1); planes go in pairs, so that
// the two sets of own operands (ow: even planes of the item, ow2: odd)
// stay in registers
template <typename T, bool IS_D, bool U>
__device__ __forceinline__ void march(const K5Args& A, const T* tab, T* ring,
                                      const Site<T>* s, Own<T>* ow,
                                      Own<T>* ow2, const RingPos<IS_D>& rp,
                                      int tile, int i0, int i1) {
  constexpr int AHEAD = IS_D ? 1 : 2;
  ring_issue<T, IS_D>(A, rp, ring, i0 + AHEAD - 2);
  cp_commit();
  ring_issue<T, IS_D>(A, rp, ring, i0 + AHEAD - 1);
  cp_commit();
#pragma unroll
  for (int m = 0; m < SPT; ++m)
    if (s[m].ok) own_load<T, U>(A, s[m], i0, tile, ow[m]);
  for (int i = i0; i < i1; i += 2) {
    plane<T, IS_D, U>(A, tab, ring, s, ow, ow2, rp, tile, i, i0, i1);
    if (i + 1 < i1)
      plane<T, IS_D, U>(A, tab, ring, s, ow2, ow, rp, tile, i + 1, i0, i1);
  }
}

// ---- the kernel ---------------------------------------------------------

// U: the plan has the standard uPML layout (u_ax1 ...)
template <typename T, bool IS_D, bool U>
__global__ void __launch_bounds__(NTHR, MINB)
k5_kernel(const __grid_constant__ K5Args A) {
  T* tab = (T*)K5_SMEM;
  T* sv = tab + NTAB * A.ch;
  T* ring = sv + SITE_WORDS;
  const int tid = threadIdx.x;
  const int nitems = A.nch * A.nty * A.ntz;
  Site<T> s[SPT];
  Own<T> ow[SPT], ow2[SPT];
  RingPos<IS_D> rp;
  for (int w = blockIdx.x; w < nitems; w += gridDim.x) {
    const int tz = w % A.ntz, ty = (w / A.ntz) % A.nty;
    const int c = w / (A.ntz * A.nty);
    const int i0 = c * A.ch, i1 = i0 + A.ch < A.S0 ? i0 + A.ch : A.S0;
    const int j0 = ty * TY, k0 = tz * TZ;
    __syncthreads();                  // the last item's readers are done
    load_tables<T>(A, tab, i0, tid);
#pragma unroll
    for (int m = 0; m < SPT; ++m)
      site_setup<T, U>(A, s[m], sv, tid + m * NTHR, j0, k0);
    ring_setup<IS_D>(A, rp, tid, j0, k0);
    march<T, IS_D, U>(A, tab, ring, s, ow, ow2, rp, ty * A.ntz + tz, i0,
                      i1);
  }
}

// dynamic shared memory of a launch: the x tables, the site table, the ring
template <typename T>
static size_t smem_bytes(const K5Args& A) {
  typedef Ring<false> G;              // both halves' rings are this size
  return ((size_t)NTAB * A.ch + SITE_WORDS + G::NSLOT * A.nring * G::PW) *
         sizeof(T);
}

template <typename T, bool IS_D, bool U>
static int launch_v(const K5Args* a, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(*a);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        k5_kernel<T, IS_D, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  void* args[] = {(void*)a};
  const unsigned grid = (unsigned)(a->nch * a->nty * a->ntz);
  cudaError_t rc = cudaLaunchKernel(k5_kernel<T, IS_D, U>, dim3(grid),
                                    dim3(NTHR), args, smem, s);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

template <typename T>
static int launch(const K5Args* a, int is_d, cudaStream_t s) {
  if (a->S0 < 1 || a->ch < 1 || a->nring > NCOMP || a->P.ncurl > NCOMP ||
      a->P.neh > NCOMP || a->P.npol != 0)
    return (int)cudaErrorInvalidValue;
  const bool u = upml_curl(a->cc, (int)a->P.ncurl) &&
                 upml_eh(a->ec, (int)a->P.neh);
  if (is_d)
    return u ? launch_v<T, true, true>(a, s) : launch_v<T, true, false>(a, s);
  return u ? launch_v<T, false, true>(a, s) : launch_v<T, false, false>(a, s);
}

extern "C" {

i64 mnt_k5_args_size(void) { return (i64)sizeof(K5Args); }

i64 mnt_k5_params_size(void) { return (i64)sizeof(Params); }

// the y-z tile this library was built with
void mnt_k5_tile(int* ty_tz) {
  ty_tz[0] = TY;
  ty_tz[1] = TZ;
}

// a launch's dynamic shared memory in bytes
i64 mnt_k5_smem(const K5Args* a, int fp64) {
  return (i64)(fp64 ? smem_bytes<double>(*a) : smem_bytes<float>(*a));
}

int mnt_k5_half(const K5Args* a, int is_d, int fp64, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return fp64 ? launch<double>(a, is_d, s) : launch<float>(a, is_d, s);
}

}  // extern "C"
