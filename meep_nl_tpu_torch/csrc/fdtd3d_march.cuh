// What K1 (fdtd3d.cu), K2 (fdtd3d_t2.cu) and K5 (fused.cu) share beyond
// the per-site value functions of fdtd3d_site.cuh: support boxes, the
// 32-bit copies of the parameter fields the site work reads (CurlC, EhC)
// with their slab rule, the standard uPML layout as compile-time values
// and the test for it, and the asynchronous plane copies into shared
// memory (plain copies on the host, where tests/cuda_stub compiles these
// sources).

#pragma once

#include "fdtd3d_site.cuh"

// a support box [lo, hi) per axis; empty when lo >= hi on an axis
struct Box {
  int lo[3], hi[3];
};

// The fields of a component that the site work reads, as 32-bit copies of
// Params' (filled by the wrapper).  A slab rule (lo, hi0, n) is on at c
// when c < lo or hi0 <= c < n: the chain's slabs with plan.slab_opt, every
// site (lo = INT_MAX) without.
struct CurlC {
  int gp, gm, ap, am;                 // ring index (-1: none) and axis of
                                      // the curl partners
  int sax, s_lo, s_hi0, s_n;          // sigma chain (axis -1: none)
  int uax, u_lo, u_hi0, u_n;          // sigma_u chain
};

struct EhC {
  int wax, w_lo, w_hi0, w_n;          // W chain (axis -1: none)
  int has_u;                          // chi1inv given (else 1)
  int pols;                           // bit p: polarization p holds it
};

// The standard layout of a 3D plan with uPML on every axis: component q
// (0 x, 1 y, 2 z) differentiates its curl partners (ring arrays
// u_gp(q), u_gm(q)) along (q+1)%3 and (q+2)%3 and runs its sigma chain
// along (q+1)%3, its sigma_u chain along (q+2)%3; an E/H component runs its
// W chain along its own axis.  The launches of a plan with this layout
// (`upml_layout`) take these as compile-time values (template flag U): the
// selects and indices they feed fold away.
__host__ __device__ constexpr int u_ax1(int q) { return (q + 1) % 3; }
__host__ __device__ constexpr int u_ax2(int q) { return (q + 2) % 3; }
__host__ __device__ constexpr int u_gp(int q) {
  return q == 0 ? 0 : (q == 1 ? 2 : 1);
}
__host__ __device__ constexpr int u_gm(int q) {
  return q == 0 ? 1 : (q == 1 ? 0 : 2);
}

// whether the curl components cc[0, n) (ring indices of their partners
// included) and the E/H components ec[0, n) have that layout
inline bool upml_curl(const CurlC* cc, int n) {
  if (n != NCOMP) return false;
  for (int q = 0; q < NCOMP; ++q)
    if (cc[q].gp != u_gp(q) || cc[q].gm != u_gm(q) || cc[q].ap != u_ax1(q) ||
        cc[q].am != u_ax2(q) || cc[q].sax != u_ax1(q) ||
        cc[q].uax != u_ax2(q))
      return false;
  return true;
}

inline bool upml_eh(const EhC* ec, int n) {
  if (n != NCOMP) return false;
  for (int q = 0; q < NCOMP; ++q)
    if (ec[q].wax != q) return false;
  return true;
}

// ---- asynchronous copies into shared memory (plain copies on the host) ---

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most one group of this thread is in flight
__device__ __forceinline__ void cp_wait1() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

__device__ __forceinline__ bool in_rule(int c, int lo, int hi0, int n) {
  return c < lo || (c >= hi0 && c < n);
}

__device__ __forceinline__ bool in_box(const Box& b, int i, int j, int k) {
  return i >= b.lo[0] && i < b.hi[0] && j >= b.lo[1] && j < b.hi[1] &&
         k >= b.lo[2] && k < b.hi[2];
}
