"""K2: `depth` (2 or 3) Yee steps in one pass over the grid, as one
hand-written CUDA kernel (csrc/fdtd3d_t2.cu), with its capture variant.

The port of ``meep_nl_tpu/ops/pallas/fdtd3d_t2.py`` (``_build_call2``, driven
by ``Fdtd3dT2Kernel``).  One call computes `depth` applications of K1's step
(ops/fdtd3d.py), stage s with row s of the source table; with `cap_planes`
it also returns the E/H x-planes of the intermediate stages, which the
hybrid driver feeds to the DTFT so that a run that samples every step still
advances `depth` steps per pass.  The state is the eager stepper's own dict
(`to_full`/`from_full` are the identity, as K1's).

The kernel is one ordinary launch per call.  A block owns an item, a y-z
output tile times an x-chunk (`plan_items`), and computes all the stages of
it on the tile grown by a halo that shrinks stage by stage (`regions`),
marching along x with every stage a few planes behind the one before
(`march`, `march_order`) and the planes in flight in shared-memory rings.
Items whose first stage meets a chi2/chi3 box grow by two sites a stage
(the neighbour sums), the others by one.

Out of place: a call reads the input state's tensors and writes a second
set, which it returns; the plan keeps the two sets paired, so the input's
tensors are the next call's output.  A caller must use only the returned
state.

`Fdtd3dT2Kernel.step` launches the kernel when the state lies on a CUDA
device; for a state on the CPU it runs the plain version `steps_ref`.
`launches` counts the CUDA launches (one per call), `plain_steps` the steps
the plain version took; the residue of a `run` whose length is no multiple
of `depth` goes through K1, on K1's own counters.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from . import fdtd3d
from .fdtd3d import (_Box, _CurlC, _EhC, _Params, _box, _rule, _set_box,
                     build_params, set_mirror)
from ..stepper.step import build_xs, source_index, xs_rows

NCOMP = fdtd3d.NCOMP
MAXPOL = fdtd3d.MAXPOL
#: the rings of an item (csrc/fdtd3d_t2.cu): E, H, D - P, then the arrays a
#: site reads only at its own position
(R_E, R_H, R_M, R_B, R_FUB, R_FWH, R_D, R_FUD, R_FWE, R_P,
 R_PP) = range(11)
NROLE = 11
NQ = NCOMP * MAXPOL
#: the region kind of each ring's plane: the item's whole region (E), the
#: first stage's B/H region, its D region, its E region
G_E, G_B, G_D, G_F = range(4)
KIND = {R_E: G_E, R_H: G_B, R_B: G_B, R_FUB: G_B, R_FWH: G_B, R_M: G_D,
        R_D: G_D, R_FUD: G_D, R_FWE: G_F, R_P: G_F, R_PP: G_F}
#: the rows of per-axis coefficients an item stages along y and along z
#: (csrc/fdtd3d_t2.cu: 5 fields of 6 curl components, 3 of 6 E/H ones)
NROW = 48
#: the (tile, chunk) linear items a call aims at for each block an SM holds
ITEMS_PER_BLOCK = 4
#: the shared memory of a block that has its SM to itself on the H100
#: (bytes): what `supported` admits a plan by; `Fdtd3dT2Kernel._items` takes
#: the same from the card (mnt_k2_smem: the least of a block's most and the
#: SM's less the per-block reserve), and the card tests hold the two equal
SMEM_H100 = 232448


def supported(plan, depth: int = 2, allow_periodic_x: bool = False) -> bool:
    """The semantic envelope of the JAX package's fdtd3d_t2.supported
    (fdtd3d_t2.py:129-172): K1's envelope (`fdtd3d.supported`), `depth` 2 or
    3, at least two x-planes per stage, and the rings of the smallest item
    within the card's shared memory.  `allow_periodic_x` admits an
    x-periodic plan in K1's x-wrap envelope whose items are all linear
    (no chi2/chi3 box), with at most one pole and at least 6 live x-planes
    (more than a call's halo): the kernel's x-wrap variant (W in
    csrc/fdtd3d_t2.cu), the reference's `periodic` mode of _build_call2
    (fdtd3d_t2.py:204-214) as `periodicx.PeriodicXT2Kernel` drives it.

    Differences, all deliberate.  Dropped, because they describe the TPU
    kernel's blocking and not the function: the VMEM budgets of `_pick_bx`
    (:68-100; the shared-memory rule above is this kernel's own), the
    dispersive window clear of the edge calls (`_disp_fits` :54), the
    `bx >= 8` rule for folded conductivity at depth 3 (:157; the port's K1
    declines conductivity altogether), `_cond_clear_of_window` (:103) and
    the block counts between the x-PML slabs (:164-169): this kernel has
    one march for every plane and no call segments.  Not needed: the
    reference declines `has_u` on an H spec (:146-148) because its trailing
    stage lacks the full mu-inverse; every stage here reads the coefficient
    arrays at the site's true index, so mu != 1 runs.  The number of
    sources is not limited, as in the reference."""
    if depth not in (2, 3) or not fdtd3d.supported(plan, allow_periodic_x):
        return False
    if plan.periodic[0] and (_nl_box(plan) is not None
                             or len(plan.pol_specs_e) > 1
                             or plan.gv.num[0] < 6):
        return False
    S0 = tuple(plan.storage_shape or plan.gv.shape)[0]
    if S0 < 2 * depth:
        return False
    item = np.dtype(plan.dtype).itemsize
    roles = _roles(plan, None)
    nl = _nl_box(plan) is not None
    return _layout(roles, depth, nl, (1, 1))[0] * item <= SMEM_H100


def capture_list(depth: int, cap_planes) -> List[Tuple[int, str, int]]:
    """[(stage, comp, x)] of the planes one call captures: E components
    after stages 1..depth-1 (the last stage's E is read from the advanced
    state), H components after every stage (the rule of the reference's
    Fdtd3dT2Kernel.__init__, fdtd3d_t2.py:2125-2134)."""
    out = []
    for comp, x in sorted(set(cap_planes or [])):
        last = depth - 1 if comp[0] == "e" else depth
        out += [(s, comp, int(x)) for s in range(1, last + 1)]
    return out


def cap_key(stage: int, comp: str, x: int) -> str:
    return f"cap:{stage}:{comp}:{x}"


def steps_ref(plan, depth: int, cap_planes=None):
    """The plain version: fn(state, rows) -> (state advanced `depth` steps,
    {cap:{stage}:{comp}:{x}: (1, S1, S2) plane}); `rows` are the `depth`
    per-step rows of the xs table."""
    step = fdtd3d.step_ref(plan)
    want = capture_list(depth, cap_planes)

    def run(state, rows):
        caps = {}
        for s in range(1, depth + 1):
            state = step(state, rows[s - 1] if rows else {})
            for st, comp, x in want:
                if st == s:
                    caps[cap_key(s, comp, x)] = state["f"][comp][x:x + 1]
        return state, caps

    return run


# ---------------------------------------------------------------------------
# the march of one item: halos, lags, ring planes
# ---------------------------------------------------------------------------


def march(depth: int, nl: bool) -> Dict[str, Any]:
    """The x-march of an item.  h: the sites a stage's region grows by
    (2 where the chi2/chi3 neighbour sums read D - P at +-1); lag: the
    planes a stage trails the one before it (B reads E at x+1); n: the
    planes E trails B/H and D within a stage (E reads D - P at x+1).
    ns: the planes each ring holds, from the step that first writes a
    plane's slot to the last read of it (csrc/fdtd3d_t2.cu; replayed by
    tests/test_torch_fdtd3d_t2.py)."""
    h = 2 if nl else 1
    n, lag = h - 1, h
    late = (depth - 1) * lag
    own = late + 1
    ns = {R_E: late + n + 3,            # loaded two planes ahead
          R_H: late + 2,                # D reads H at x-1
          R_M: late + 3 if nl else 0,   # E reads D - P at x+-1
          R_B: own, R_FUB: own, R_FWH: own,
          R_D: late + n + 1, R_FUD: late + n + 1,
          R_FWE: own, R_P: own, R_PP: own}
    return {"h": h, "n": n, "lag": lag, "ns": ns}


def regions(depth: int, nl: bool, lo: int, hi: int, size: int, hs=None
            ) -> Dict[Any, Tuple[int, int]]:
    """Along one axis, the sites an item with output [lo, hi) updates,
    clipped to [0, size): per stage s (1-based) its B/H ('b', s), D ('d', s) and E
    ('e', s) regions; and per ring kind the span of its plane, unclipped
    (the first stage's region of the ring's first writer; the E ring also
    the input's E that the first B/H reads at +1).  `hs` = (below, above):
    the sites a stage grows by on each side (default: march's h on both;
    1 on a side of a nonlinear item where no stage's E region reaches a
    chi2/chi3 site at its edge, `side_widths`); the ring planes keep the
    class's h."""
    m = march(depth, nl)
    h = m["h"]
    ha, hb = hs or (h, h)

    def clip(a, b):
        return max(a, 0), min(b, size)

    out = {}
    for s in range(1, depth + 1):
        ga, gb = (depth - s) * ha, (depth - s) * hb
        out["b", s] = clip(lo - ga - ha, hi + gb + hb - 1)
        out["d", s] = clip(lo - ga - ha + 1, hi + gb + hb - 1)
        out["e", s] = clip(lo - ga, hi + gb)
    n = h - 1
    g1 = (depth - 1) * h
    out[G_E] = (lo - depth * h, hi + depth * h)
    out[G_B] = (lo - g1 - h, hi + g1 + n)
    out[G_D] = (lo - g1 - n, hi + g1 + n)
    out[G_F] = (lo - g1, hi + g1)
    return out


def march_order(depth: int, nl: bool, i0: int, i1: int, S0: int, hs=None):
    """The x-march of an item with output planes [i0, i1), as the kernel
    runs it: [(step, what, stage, plane)] in order, what being 'load' (the
    input's E plane brought into its ring, issued at that step and complete
    one step later), 'b' (B/H), 'd' (D) or 'e' (E with the ADE).  `hs`: the
    planes a stage grows by below and above, as in `regions`."""
    m = march(depth, nl)
    h, n, lag = m["h"], m["n"], m["lag"]
    ha, hb = hs or (h, h)
    out = []

    def load(t, p):
        if i0 - depth * ha <= p < i1 + depth * hb and 0 <= p < S0:
            out.append((t, "load", 0, p))

    t0, t1 = i0 - depth * ha, i1 + n + (depth - 1) * lag
    load(t0 - 1, t0)
    load(t0 - 1, t0 + 1)
    for t in range(t0, t1):
        load(t, t + 2)
        for s in range(1, depth + 1):
            ga, gb = (depth - s) * ha, (depth - s) * hb
            b = t - (s - 1) * lag
            xlo, xhi = i0 - ga, i1 + gb
            if xlo - ha <= b < xhi + hb - 1 and 0 <= b < S0:
                out.append((t, "b", s, b))
            if xlo - ha + 1 <= b < xhi + hb - 1 and 0 <= b < S0:
                out.append((t, "d", s, b))
            if xlo <= b - n < xhi and 0 <= b - n < S0:
                out.append((t, "e", s, b - n))
    return out


def side_widths(depth: int, sat, box) -> int:
    """The sides of a nonlinear item (output `box` = ((x0, x1), (y0, y1),
    (z0, z1))) that grow by 2 sites a stage, as bits (axis * 2 + 0 below,
    + 1 above); the others grow by 1.  A side may grow by 1 when no stage's
    E region, grown so, holds a chi2/chi3 site (`sat`, _nl_counts) in its
    edge layer on that side: only such a site reads D - P one site beyond
    its stage's E region (the region of every stage the others span by at
    most 2 sites a stage)."""
    bits = 0
    for ax in range(3):
        lo, hi = box[ax]
        for side in (0, 1):
            for s in range(1, depth + 1):
                e = depth - s
                layer = [(a - 2 * e, b + 2 * e) for a, b in box]
                c = lo - e if side == 0 else hi + e - 1
                layer[ax] = (c, c + 1)
                if _count(sat, layer) > 0:
                    bits |= 1 << (ax * 2 + side)
    return bits


# ---------------------------------------------------------------------------
# items and their shared memory
# ---------------------------------------------------------------------------


def _nl_box(plan):
    """The union of the E family's chi3 and chi2-NR support boxes (None:
    the plan has none)."""
    shape = tuple(plan.storage_shape or plan.gv.shape)
    boxes = []
    for s in plan.eh_specs_e:
        if s.has_chi3:
            boxes.append(_box(plan, (f"{s.ec}:chi3", f"{s.ec}:chi2"), shape))
        if s.has_nr:
            boxes.append(_box(plan, (f"{s.ec}:nrchi2",), shape))
    boxes = [b for b in boxes if all(lo < hi for lo, hi in b)]
    if not boxes:
        return None
    return tuple((min(b[ax][0] for b in boxes), max(b[ax][1] for b in boxes))
                 for ax in range(3))


def _nl_counts(plan):
    """The summed-volume table of the sites where a chi2/chi3 coefficient of
    the E family is nonzero (None: no such site): the sites that take the
    nonlinear update, counted in any box in O(1) (`_count`)."""
    shape = tuple(plan.storage_shape or plan.gv.shape)
    mask = np.zeros(shape, bool)
    for s in plan.eh_specs_e:
        keys = ([f"{s.ec}:chi3", f"{s.ec}:chi2"] if s.has_chi3 else []) + \
            ([f"{s.ec}:nrchi2"] if s.has_nr else [])
        for key in keys:
            if key in plan.coefs:
                c = plan.coefs[key].detach().cpu().numpy()
                mask |= np.broadcast_to(c != 0, shape)
    if not mask.any():
        return None
    out = np.zeros(tuple(n + 1 for n in shape), np.int64)
    out[1:, 1:, 1:] = mask.cumsum(0).cumsum(1).cumsum(2)
    return out


def _count(sat, box):
    """The nonlinear sites in box ((x0, x1), (y0, y1), (z0, z1)), clipped to
    the storage, from the summed-volume table `sat`."""
    (a0, a1), (b0, b1), (c0, c1) = [
        (min(max(lo, 0), n - 1), min(max(hi, 0), n - 1))
        for (lo, hi), n in zip(box, sat.shape)]
    return (sat[a1, b1, c1] - sat[a0, b1, c1] - sat[a1, b0, c1]
            - sat[a1, b1, c0] + sat[a0, b0, c1] + sat[a0, b1, c0]
            + sat[a1, b0, c0] - sat[a0, b0, c0])


def _roles(plan, meets):
    """{role: [slot]} of the rings a class of items needs: every array of
    the plan's state, except the slab-local PML auxiliaries whose slabs
    meet none of the class's items (`meets(axis, rule)`: whether some
    item's region meets the sites where a chain of slab rule (lo, hi0, n)
    along `axis` runs; None: assume they all do)."""
    def need(axis, rule):
        return meets is None or rule == fdtd3d.EVERYWHERE or meets(axis, rule)

    slab = plan.slab_opt
    has_pols = bool(plan.pol_specs_e)
    out = {r: [] for r in range(NROLE)}
    out[R_E] = list(range(len(plan.eh_specs_e)))
    out[R_H] = list(range(len(plan.eh_specs_h)))
    for fam, specs, rb, ru in (("b", plan.curl_specs_b, R_B, R_FUB),
                               ("d", plan.curl_specs_d, R_D, R_FUD)):
        for q, s in enumerate(specs):
            out[rb].append(q)
            if s.dsigu_axis is not None and need(s.dsigu_axis, _rule(
                    *s.dsigu_slabs, plan.gv.num[s.dsigu_axis] + 1, slab)):
                out[ru].append(q)
    for specs, rw, local in ((plan.eh_specs_h, R_FWH, slab),
                             (plan.eh_specs_e, R_FWE, slab and not has_pols)):
        for q, s in enumerate(specs):
            if s.dsigw_axis is not None and need(s.dsigw_axis, _rule(
                    *s.dsigw_slabs, plan.gv.num[s.dsigw_axis] + 1, local)):
                out[rw].append(q)
    comps = [s.ec for s in plan.eh_specs_e]
    for pi, p in enumerate(plan.pol_specs_e):
        for c, d in p.sigma:
            if d == c[1] and c in comps:
                q = comps.index(c)
                out[R_P].append(q * MAXPOL + pi)
                out[R_PP].append(q * MAXPOL + pi)
    return out


def _layout(roles, depth, nl, tile):
    """(words, {kind: (below, columns, sites)}, {role: {slot: offset}},
    {role: planes}, (first element, lengths along y and z) of the
    coefficient rows) of one item class's shared memory for output tiles
    of at most `tile` = (rows, columns)."""
    m = march(depth, nl)
    kinds = {}
    for g in range(4):
        span = regions(depth, nl, 0, 1, 1)[g]
        below, above = -span[0], span[1] - 1
        rows, cols = tile[0] + below + above, tile[1] + below + above
        kinds[g] = (below, cols, rows * cols)
    off, words = {}, 0
    for r in range(NROLE):
        if r == R_M and not nl:
            continue
        for c in (roles[R_E] if r == R_M else roles[r]):
            off.setdefault(r, {})[c] = words
            words += m["ns"][r] * kinds[KIND[r]][2]
    below, cols, sites = kinds[G_E]
    rows = (words, sites // cols, cols)
    return words + NROW * (rows[1] + rows[2]), kinds, off, m["ns"], rows


def _splits(size: int, most: int) -> List[Tuple[int, int]]:
    """[0, size) cut into the fewest parts of at most `most`, as equal as
    they can be."""
    m = -(-size // most)
    edges = [round(i * size / m) for i in range(m + 1)]
    return list(zip(edges[:-1], edges[1:]))


def _tiles(most):
    """Candidate output tiles of at most `most` = (rows, columns), the
    largest first (then the one with fewer halo sites per output site)."""
    ys = sorted({max(most[0] >> a, 1) for a in range(8)})
    zs = sorted({max(most[1] >> a, 1) for a in range(8)})
    cand = [(y, z) for y in ys for z in zs]
    return sorted(cand, key=lambda t: (-t[0] * t[1], t[0] + t[1]))


def plan_items(plan, depth: int, most, budgets, ch=None, blocks=1,
               xcut=None):
    """The items of one call and the two classes' layouts: y-z tiles of at
    most `most` sites cut as evenly as the storage allows, x-chunks of `ch`
    planes (default: ITEMS_PER_BLOCK items for each of the `blocks` linear
    blocks each of the card's SMs holds).  An item is nonlinear when its
    first stage's E region holds a site with a nonzero chi2 or chi3
    coefficient (elsewhere the linear update is exact: the Pade factor of
    zero coefficients is 1, the NR solve is skipped): the y-z tiles that
    hold one anywhere along x are cut into the nonlinear class's smaller
    tiles, each over the planes between its first and last that need the
    nonlinear update, cut into x-chunks of at most the planes that would
    spread all of these evenly over the card's SMs (one nonlinear block an
    SM), the planes before and after linear items in chunks.  Each class
    takes the largest tile whose rings fit its budget (bytes; `budgets` =
    (linear, nonlinear)).  `xcut` (an x-periodic plan's live extent): no
    item spans it, the live planes and the dead ones are cut into chunks
    of their own.  Returns (items as an (n, 8) int32 array, the
    linear ones first, [linear layout or None, nonlinear layout or None],
    chunk length, items per class, the linear tile)."""
    shape = tuple(plan.storage_shape or plan.gv.shape)
    item = np.dtype(plan.dtype).itemsize
    sat = _nl_counts(plan)
    g = depth - 1

    def nonlinear(box):
        return sat is not None and _count(
            sat, [(lo - g, hi + g) for lo, hi in box]) > 0

    def hot(y, z):
        """The planes [a, b) of column (y, z) from the first to the last
        whose first stage meets a nonlinear site, or None."""
        ps = [p for p in range(shape[0]) if nonlinear(((p, p + 1), y, z))]
        return (ps[0], ps[-1] + 1) if ps else None

    for tl in _tiles(most):
        ys, zs = _splits(shape[1], tl[0]), _splits(shape[2], tl[1])
        if ch is None:
            nch = -(-fdtd3d.SMS * ITEMS_PER_BLOCK * blocks
                    // (len(ys) * len(zs)))
            chunk = -(-shape[0] // max(1, min(shape[0], nch)))
        else:
            chunk = int(ch)
        cols = {(y, z): hot(y, z) for y in ys for z in zs}
        spans = [(0, shape[0])] if xcut is None else \
            [(0, xcut), (xcut, shape[0])]
        lin0 = [(x, *c) for c, h in cols.items() if h is None
                for span in spans for x in _splits_in(span, chunk)]
        cands = [t for t in _tiles(tl) if t[0] <= tl[0] and t[1] <= tl[1]]
        hot_cols = [(c, h) for c, h in cols.items() if h is not None]
        for tn in (cands if hot_cols else [tl]):
            lin, nl, hots = list(lin0), [], []
            for (y, z), (a, b) in hot_cols:
                # the column's planes before and after [a, b) whole
                lin += [(x, y, z) for span in ((0, a), (b, shape[0]))
                        for x in _splits_in(span, chunk)]
                for y2 in _splits_in(y, tn[0]):
                    for z2 in _splits_in(z, tn[1]):
                        h = hot(y2, z2)
                        spans = [(a, b)] if h is None else \
                            [(a, h[0]), (h[1], b)]
                        if h is not None:
                            hots.append((h, y2, z2))
                        lin += [(x, y2, z2) for span in spans
                                for x in _splits_in(span, chunk)]
            # the nonlinear planes spread over the card's SMs: a column's
            # hot planes in chunks of at most an SM's share of them all
            share = -(-sum(b - a for (a, b), _, _ in hots) // fdtd3d.SMS)
            for (a, b), y2, z2 in hots:
                nl += [(x, y2, z2) for x in _splits_in((a, b), share)]
            lay_lin = _fit(plan, depth, False, lin, tl, budgets[0], item) \
                if lin else None
            if lin and lay_lin is None:
                break                       # a smaller linear tile
            lay_nl = _fit(plan, depth, True, nl, tn, budgets[1], item) \
                if nl else None
            if nl and lay_nl is None:
                continue
            items = [(*x, *y, *z, 0, 0) for x, y, z in lin] + \
                [(*x, *y, *z, side_widths(depth, sat, (x, y, z)), 0)
                 for x, y, z in nl]
            return (np.array(items, np.int32).reshape(-1, 8),
                    [lay_lin, lay_nl], chunk, (len(lin), len(nl)), tl)
    raise ValueError("fdtd3d_t2: no item's rings fit the card's shared "
                     "memory")


def _splits_in(span, most):
    lo, hi = span
    if hi <= lo:
        return []
    return [(lo + a, lo + b) for a, b in _splits(hi - lo, most)]


def _fit(plan, depth, nl, boxes, tile, budget, item):
    """The layout of a class of items (`boxes`: ((x0, x1), (y0, y1),
    (z0, z1)) each) for output tiles of at most `tile`, with the slab-local
    rings only where some item's region meets their slabs; None when it
    does not fit `budget` bytes."""
    shape = tuple(plan.storage_shape or plan.gv.shape)
    G = depth * march(depth, nl)["h"]

    def meets(axis, rule):
        lo, hi0, n = rule
        for b in boxes:
            a, z = max(b[axis][0] - G, 0), min(b[axis][1] + G, shape[axis])
            if a < lo or max(a, hi0) < min(z, n):
                return True
        return False

    lay = _layout(_roles(plan, meets), depth, nl, tile)
    return lay if lay[0] * item <= budget else None


# ---------------------------------------------------------------------------
# the C argument block (mirrors csrc/fdtd3d_t2.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


class _K2Class(ctypes.Structure):
    _fields_ = [("off", (_I * NQ) * NROLE), ("ns", _I * NROLE),
                ("below", _I * 4), ("rz", _I * 4), ("pw", _I * 4),
                ("tab", _I), ("ly", _I), ("lz", _I), ("words", _I)]


class _K2Args(ctypes.Structure):
    _fields_ = ([("pb", _Params), ("pd", _Params)]
                + [(n, _P * NCOMP) for n in (
                    "out_b", "out_fub", "out_h", "out_fwh", "out_d",
                    "out_fud", "out_e", "out_fwe")]
                + [("out_p", (_P * MAXPOL) * NCOMP),
                   ("out_pp", (_P * MAXPOL) * NCOMP), ("items", _P)]
                + [(n, _P * 2) for n in ("src_ptr", "src_key", "src_id",
                                         "src_amp")]
                + [("wave", _P), ("cap_ptr", _P), ("cap_q", _P),
                   ("cap_out", _P), ("dt", ctypes.c_double),
                   ("nl3", _Box * NCOMP), ("nlnr", _Box * NCOMP),
                   ("pol", (_Box * MAXPOL) * NCOMP),
                   ("cb", _CurlC * NCOMP), ("cd", _CurlC * NCOMP),
                   ("eh", _EhC * NCOMP), ("ee", _EhC * NCOMP),
                   ("hb_of", _I * NCOMP), ("ed_of", _I * NCOMP),
                   ("cls", _K2Class * 2), ("nitems", _I * 2),
                   ("pair", _I)]
                + [(n, _I) for n in ("depth", "S0", "S1", "S2", "nsrc",
                                     "mir")]
                + [("mk0", (_I * 2) * NCOMP), ("msg", (_I * 2) * NCOMP),
                   ("wn", _I), ("wph", ctypes.c_double),
                   ("wphi", ctypes.c_double)])


def _lib():
    from . import _build
    return bind(_build.load("fdtd3d_t2"))


def bind(lib):
    """Declare csrc/fdtd3d_t2.cu's C functions on a loaded library and
    check its argument layout against this module's (once per library)."""
    if not getattr(lib, "_mnt_bound", False):
        lib.mnt_k2_args_size.restype = ctypes.c_longlong
        lib.mnt_k2_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
        lib.mnt_k2_launch.restype = ctypes.c_int
        if lib.mnt_k2_args_size() != ctypes.sizeof(_K2Args):
            raise RuntimeError("csrc/fdtd3d_t2.cu K2Args layout does not "
                               "match ops/fdtd3d_t2.py")
        tile = (ctypes.c_int * 3)()
        lib.mnt_k2_tile(tile)
        lib.mnt_tile = (tile[0], tile[1])
        lib.mnt_nthr = tile[2]
        lib._mnt_bound = True
    return lib


def side_stream(device):
    """A stream of higher priority than the default on `device`, for the
    nonlinear item class (one per kernel object, so no two plans or
    devices share it)."""
    return torch.cuda.Stream(device=device, priority=-1)


def k1_of(plan) -> fdtd3d.Fdtd3dKernel:
    """The plan's one K1 kernel object (the residue step of every K2 kernel
    of the plan and the hybrid driver's one-step calls share it, so its
    counters see every K1 step of the plan); for an x-periodic plan K1's
    x-wrap variant (periodicx.PeriodicXKernel), its pair wrap for complex
    fields (periodicx.PairPeriodicXKernel)."""
    ker = plan.__dict__.get("_k1_kernel")
    if ker is None:
        if plan.periodic[0]:
            from .periodicx import PairPeriodicXKernel, PeriodicXKernel
            ker = PairPeriodicXKernel(plan) if plan.complex_fields \
                else PeriodicXKernel(plan)
        else:
            ker = fdtd3d.Fdtd3dKernel(plan)
        plan._k1_kernel = ker
    return ker


def _state_paths(plan):
    """[(path into the state, input setter, output setter)] of every state
    tensor a call reads and writes, for the argument block `A`: the input
    through the families' parameter blocks, the output through out_*."""
    out = []

    def slot(path, inp, outp):
        out.append((path, inp, outp))

    for fam, specs, ehs, P, ob, ou, oe, ow in (
            ("b", plan.curl_specs_b, plan.eh_specs_h, "pb", "out_b",
             "out_fub", "out_h", "out_fwh"),
            ("d", plan.curl_specs_d, plan.eh_specs_e, "pd", "out_d",
             "out_fud", "out_e", "out_fwe")):
        for q, s in enumerate(specs):
            slot(("f", s.c), (P, "curl", q, "f"), (ob, q))
            if s.dsigu_axis is not None:
                slot(("f_u", s.c), (P, "curl", q, "fu"), (ou, q))
        for q, s in enumerate(ehs):
            slot(("f", s.ec), (P, "eh", q, "f"), (oe, q))
            if s.dsigw_axis is not None:
                slot(("f_w", s.ec), (P, "eh", q, "fw"), (ow, q))
    comps = [s.ec for s in plan.eh_specs_e]
    for pi, p in enumerate(plan.pol_specs_e):
        for c, d in p.sigma:
            if d == c[1] and c in comps:
                q = comps.index(c)
                slot(("pol", pi, "p", c), ("pd", "eh", q, "pol", pi, "p"),
                     ("out_p", q, pi))
                slot(("pol", pi, "pp", c), ("pd", "eh", q, "pol", pi, "pp"),
                     ("out_pp", q, pi))
    return out


def _lookup(state, path):
    t = state
    for key in path:
        t = t[key]
    return t


def _setter(A, path):
    """A function that sets A.<path> (field names and indices) to a
    value; the containers it walks are views of A's buffer."""
    obj = A
    for key in path[:-1]:
        obj = obj[key] if isinstance(key, int) else getattr(obj, key)
    last = path[-1]
    if isinstance(last, int):
        return lambda v: obj.__setitem__(last, v)
    return lambda v: setattr(obj, last, v)


class Fdtd3dT2Kernel:
    """`depth` steps per call for one plan (the counterpart of the JAX
    package's Fdtd3dT2Kernel).  `cap_planes`: [(comp, x)] monitor planes
    whose intermediate stages `capture_step` returns; `ch`: x-planes per
    item (default: `plan_items`' choice); `allow_periodic_x`: take an
    x-periodic plan (`supported`), whose calls read across the wrap."""

    def __init__(self, plan, depth: int = 2, cap_planes=None, ch=None,
                 allow_periodic_x: bool = False):
        if not supported(plan, depth, allow_periodic_x):
            raise ValueError("plan outside the fdtd3d_t2 kernel envelope")
        self.plan = plan
        self.depth = depth
        #: the x wrap: (live extent, real phase), or None
        self.wrap = (plan.gv.num[0], float(np.real(plan.bloch_phase[0]))) \
            if plan.periodic[0] else None
        self.k3 = None                    # hybrid.py: the depth-3 companion
        self._k1 = k1_of(plan)
        self.shape = self._k1.shape
        self.dtype = self._k1.dtype
        self.cap_planes = sorted(set((c, int(x)) for c, x in
                                     (cap_planes or [])))
        self.captures = capture_list(depth, self.cap_planes)
        comps = {s.ec for s in plan.eh_specs_e + plan.eh_specs_h}
        for comp, x in self.cap_planes:
            if comp not in comps or not 0 <= x < self.shape[0]:
                raise ValueError(f"no capture plane ({comp!r}, {x})")
        self._ref = steps_ref(plan, depth, self.cap_planes)
        self.launches = 0                 # CUDA launches
        self.launches_per_call = 1
        self.plain_steps = 0              # steps of the plain version
        self.ch = ch
        self._cuda = None                 # built at the first CUDA call

    # ---- the identity conversions of this slice ---------------------------
    def to_full(self, state, C=None):
        return state

    def from_full(self, full):
        return full

    # ---- stepping ----------------------------------------------------------
    def capture_step(self, state: Dict[str, Any], rows
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Advance `depth` steps with the `depth` rows of the xs table;
        returns (state, captured planes).  CUDA state: through the kernel,
        out of place: the input state's tensors are handed over (they
        become the output of the plan's next K2 call), so the caller must
        use only the returned state; the capture planes are new tensors.
        CPU state: the plain version."""
        dev = state["f"][self.plan.curl_specs_d[0].c].device
        if dev.type == "cpu":
            self.plain_steps += self.depth
            return self._ref(state, rows)
        if dev.type != "cuda":
            raise RuntimeError(f"fdtd3d_t2: unsupported device {dev}")
        return self._step_cuda(state, rows)

    def step(self, state: Dict[str, Any], rows) -> Dict[str, Any]:
        """capture_step's state alone (the same hand-over of the input's
        tensors on CUDA)."""
        return self.capture_step(state, rows)[0]

    def run(self, state, nsteps: int, t0: int = 0):
        """nsteps // depth calls, the residue through K1 (the reference's
        run, fdtd3d_t2.py:2196-2225)."""
        rows = xs_rows(self.plan, build_xs(self.plan, nsteps, t0))
        ncall = nsteps // self.depth
        for c in range(ncall):
            state = self.step(state, rows[c * self.depth:
                                          (c + 1) * self.depth])
        for i in range(ncall * self.depth, nsteps):
            state = self._k1.step(state, rows[i] if rows else {})
        return state

    # ---- CUDA path ---------------------------------------------------------
    def _source_lists(self, family):
        """The family's current sources as per-plane lists for the thread
        that owns each site: entries sorted by plane, then by site and
        component, then in plan.sources order and entry order (the plain
        version's order of accumulation); an entry's id is its source's
        index in plan.sources (the row of the waveform table)."""
        plan = self.plan
        curls = plan.curl_specs_b if family == "b" else plan.curl_specs_d
        q_of = {s.c: q for q, s in enumerate(curls)}
        src = [si for si, s in enumerate(plan.sources)
               if (s.component[0] == "h") == (family == "b")]
        if not src:
            return None
        S0, S1, S2 = self.shape
        buckets, keys, ids, amps = [], [], [], []
        for si in src:
            i, j, k = (t.cpu().numpy() for t in source_index(plan, si))
            q = q_of[family + plan.sources[si].component[1]]
            buckets.append(i)
            keys.append(((j * S2 + k) << 2) | q)
            ids.append(np.full(len(i), si))
            amps.append(torch.stack([plan.coefs[f"src{si}:amp_re"],
                                     plan.coefs[f"src{si}:amp_im"]], 1))
        bucket, key = np.concatenate(buckets), np.concatenate(keys)
        order = np.lexsort((np.arange(len(key)), key, bucket))
        ptr = np.searchsorted(bucket[order], np.arange(S0 + 1))
        dev = plan.device

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=dev)

        amp = torch.cat(amps)[torch.as_tensor(order, device=dev)]
        return {"ptr": i32(ptr), "key": i32(key[order]),
                "id": i32(np.concatenate(ids)[order]),
                "amp": amp.contiguous()}

    def _capture_table(self):
        """The capture planes as per-(stage, family, plane) lists: the
        entries' components and, in entry order, the planes of the call's
        capture tensor; {cap_key: plane}."""
        plan = self.plan
        S0 = self.shape[0]
        q_of = {s.ec: q for specs in (plan.eh_specs_e, plan.eh_specs_h)
                for q, s in enumerate(specs)}
        keyed = sorted((((st - 1) * 2 + (1 if comp[0] == "e" else 0)) * S0
                        + x, q_of[comp], cap_key(st, comp, x))
                       for st, comp, x in self.captures)
        ptr = np.searchsorted(np.array([k for k, _, _ in keyed], np.int64),
                              np.arange(self.depth * 2 * S0 + 1))
        dev = plan.device
        return (torch.as_tensor(ptr.astype(np.int32), device=dev),
                torch.as_tensor(np.array([q for _, q, _ in keyed], np.int32),
                                device=dev),
                {name: e for e, (_, _, name) in enumerate(keyed)})

    def _compact(self, A):
        """The compact per-component fields of A (K1's), the curl partners
        as indices into the E (B family) and H (D family) rings, and which
        B / D component feeds each H / E."""
        plan = self.plan
        e_idx = {s.ec: q for q, s in enumerate(plan.eh_specs_e)}
        h_idx = {s.ec: q for q, s in enumerate(plan.eh_specs_h)}
        for P, specs, dst, part in ((A.pb, plan.curl_specs_b, A.cb, e_idx),
                                    (A.pd, plan.curl_specs_d, A.cd, h_idx)):
            for q, s in enumerate(specs):
                c, cc = P.curl[q], dst[q]
                cc.gp = part[s.g_plus] if s.g_plus else -1
                cc.gm = part[s.g_minus] if s.g_minus else -1
                cc.ap, cc.am = c.ap, c.am
                cc.sax, cc.uax = c.sig_ax, c.sigu_ax
                cc.s_lo, cc.s_hi0, cc.s_n = _rule(c.sig_lo, c.sig_hi,
                                                  c.sig_n, c.slab)
                cc.u_lo, cc.u_hi0, cc.u_n = _rule(c.sigu_lo, c.sigu_hi,
                                                  c.sigu_n, c.slab)
        for P, dst in ((A.pb, A.eh), (A.pd, A.ee)):
            for q in range(P.neh):
                e, ec = P.eh[q], dst[q]
                ec.wax = e.w_ax
                ec.w_lo, ec.w_hi0, ec.w_n = _rule(e.w_lo, e.w_hi, e.w_n,
                                                  e.w_slab)
                ec.has_u = 1 if e.u else 0
                ec.pols = sum(1 << p for p in range(P.npol) if e.pol[p].p)
        b_idx = {s.c: q for q, s in enumerate(plan.curl_specs_b)}
        d_idx = {s.c: q for q, s in enumerate(plan.curl_specs_d)}
        for q, s in enumerate(plan.eh_specs_h):
            A.hb_of[q] = b_idx[s.dc]
        for q, s in enumerate(plan.eh_specs_e):
            A.ed_of[q] = d_idx[s.dc]

    def _items(self, lib, A):
        """plan_items for the loaded library, with A.pair set: a nonlinear
        block, or a linear one that has its SM to itself, gets the card's
        whole budget (SMEM_H100 on the H100); linear items run two blocks
        an SM (the variant held to 64 registers, each with half the SM's
        shared memory) when that still takes the largest tile the single
        block does, or when the plan has nonlinear items: those hold an SM
        each for most of the call, and the finer linear blocks fill the
        rest of the card more evenly (PERF.md §6)."""
        smem = (ctypes.c_int * 3)()
        rc = lib.mnt_k2_smem(smem)
        if rc != 0:
            raise RuntimeError(f"fdtd3d_t2: shared memory (cudaError {rc})")
        most, per_sm, reserve = smem
        one = min(most, per_sm - reserve)
        two = min(most, per_sm // 2 - reserve)
        plans = {}
        for pair, lin in ((0, one), (1, two)):
            A.pair = pair
            try:
                plans[pair] = plan_items(
                    self.plan, self.depth, lib.mnt_tile, (lin, one), self.ch,
                    1 + pair, xcut=self.wrap[0] if self.wrap else None)
            except ValueError:
                if pair == 0:
                    raise
        two_ok = 1 in plans and (
            plans[1][3][1] > 0
            or plans[1][4][0] * plans[1][4][1]
            >= plans[0][4][0] * plans[0][4][1])
        A.pair = 1 if two_ok else 0
        return plans[A.pair][:4]

    def _setup_cuda(self, lib, state):
        """Items, ring layouts, source and capture lists and the static part
        of the argument block, for the plan as it is now (plan.slab_opt
        included) and the loaded library's tile."""
        plan, depth = self.plan, self.depth
        S0, S1, S2 = self.shape
        A = _K2Args()
        A.pb = build_params(plan, "b", state)
        A.pd = build_params(plan, "d", state)
        A.depth, A.S0, A.S1, A.S2 = depth, S0, S1, S2
        A.dt = plan.dt
        A.nsrc = len(plan.sources)
        self._compact(A)
        set_mirror(A, plan, [s.ec for s in plan.eh_specs_h])
        if self.wrap is not None:
            A.wn, ph = self.wrap
            A.wph, A.wphi = ph, 1.0 / ph
        items, lays, ch, counts = self._items(lib, A)
        A.nitems[0], A.nitems[1] = counts
        for ci, lay in enumerate(lays):
            cl = A.cls[ci]
            for r in range(NROLE):
                for c in range(NQ):
                    cl.off[r][c] = -1
            if lay is None:
                continue
            words, kinds, off, ns, (cl.tab, cl.ly, cl.lz) = lay
            cl.words = words
            for g, (below, cols, sites) in kinds.items():
                cl.below[g], cl.rz[g], cl.pw[g] = below, cols, sites
            for r in range(NROLE):
                cl.ns[r] = max(ns[r], 1)
                for c, o in off.get(r, {}).items():
                    cl.off[r][c] = o
        # the E family's support boxes (coefficients zero outside them)
        shape = self.shape
        for q, s in enumerate(plan.eh_specs_e):
            _set_box(A.nl3[q], _box(plan, (f"{s.ec}:chi3", f"{s.ec}:chi2"),
                                    shape) if s.has_chi3 else ((0, 0),) * 3)
            _set_box(A.nlnr[q], _box(plan, (f"{s.ec}:nrchi2",), shape)
                     if s.has_nr else ((0, 0),) * 3)
            for pi in range(len(plan.pol_specs_e)):
                _set_box(A.pol[q][pi],
                         _box(plan, (f"pol{pi}:{s.ec}:{s.ec[1]}",), shape))
        dev = plan.device
        items_t = torch.as_tensor(items, device=dev)
        A.items = items_t.data_ptr()
        src = {f: self._source_lists(f) for f in "bd"}
        for fi, f in enumerate("bd"):
            if src[f] is not None:
                A.src_ptr[fi] = src[f]["ptr"].data_ptr()
                A.src_key[fi] = src[f]["key"].data_ptr()
                A.src_id[fi] = src[f]["id"].data_ptr()
                A.src_amp[fi] = src[f]["amp"].data_ptr()
        caps = None
        if self.captures:
            cptr, cq, cplane = self._capture_table()
            A.cap_ptr, A.cap_q = cptr.data_ptr(), cq.data_ptr()
            caps = (cptr, cq, cplane)
        self._cuda = {"args": A, "items": items_t, "src": src, "caps": caps,
                      "paths": [(path, _setter(A, i), _setter(A, o))
                                for path, i, o in _state_paths(plan)],
                      "slab_opt": plan.slab_opt,
                      "tile": lib.mnt_tile, "ch": ch, "lays": lays,
                      "nitems": len(items), "nl_items": counts[1],
                      "pair": A.pair}
        self.launches_per_call = sum(1 for c in counts if c)
        return self._cuda

    def _outputs(self, state):
        """The output state of a call: for every tensor of `state` its
        partner in the plan's second set (made on first use: empty, or a
        copy for a slab-local PML auxiliary, whose sites outside its slabs
        the kernel does not write and which must hold what the input
        holds there).  The pairing lives on the plan, so every K2 kernel of
        the plan shares the second set; a tensor that none pairs (the eager
        stepper's, a caller's) gets a new partner."""
        plan = self.plan
        book = plan.__dict__.get("_k2_pairs")
        old = book[1] if book is not None and book[0] == plan.slab_opt \
            else {}
        has_pols = bool(plan.pol_specs_e)
        local = set()
        if plan.slab_opt:
            local = {s.c for s in plan.curl_specs_d + plan.curl_specs_b
                     if s.dsigu_axis is not None}
            local |= {s.ec for s in plan.eh_specs_e + plan.eh_specs_h
                      if s.dsigw_axis is not None
                      and not (has_pols and s.ec[0] == "e")}
        ins = {t.data_ptr() for key in ("f", "f_u", "f_w")
               for t in state[key].values()}
        ins |= {t.data_ptr() for e in state["pol"] for k in ("p", "pp")
                for t in e[k].values()}
        new = {}

        def partner(t, carry):
            o = old.get(t.data_ptr())
            if o is None or o.data_ptr() in ins:
                o = t.clone() if carry else torch.empty_like(t)
            new[t.data_ptr()] = o
            new[o.data_ptr()] = t
            return o

        out = {**state,
               "f": {c: partner(t, False) for c, t in state["f"].items()},
               "f_u": {c: partner(t, c in local)
                       for c, t in state["f_u"].items()},
               "f_w": {c: partner(t, c in local)
                       for c, t in state["f_w"].items()},
               "pol": [{k: {c: partner(t, False) for c, t in e[k].items()}
                        for k in ("p", "pp")} for e in state["pol"]]}
        plan._k2_pairs = (plan.slab_opt, new)
        return out

    def _step_cuda(self, state, rows):
        self._k1._check(state)
        if len(rows) != self.depth and (rows or self.plan.sources):
            raise ValueError(f"fdtd3d_t2: {self.depth} rows of the xs table "
                             f"expected, got {len(rows)}")
        lib = _lib()
        cu = self._cuda
        if cu is None or cu["slab_opt"] != self.plan.slab_opt \
                or cu["tile"] != lib.mnt_tile:
            cu = self._setup_cuda(lib, state)
        A = cu["args"]
        out = self._outputs(state)
        for path, set_in, set_out in cu["paths"]:
            set_in(_lookup(state, path).data_ptr())
            set_out(_lookup(out, path).data_ptr())
        dev = self.plan.device
        keep = []
        if self.plan.sources:
            wave = torch.tensor(
                [[[float(rows[s][f"src{si}:cur_re"]),
                   float(rows[s][f"src{si}:cur_im"])]
                  for si in range(len(self.plan.sources))]
                 for s in range(self.depth)], dtype=torch.float64)
            wave = wave.pin_memory().to(dev, non_blocking=True) \
                if torch.cuda.is_available() else wave.to(dev)
            A.wave = wave.data_ptr()
            keep.append(wave)
        caps = {}
        if cu["caps"] is not None:
            S1, S2 = self.shape[1:]
            plane = cu["caps"][2]
            cap_out = torch.empty((len(plane), S1, S2), dtype=self.dtype,
                                  device=dev)
            A.cap_out = cap_out.data_ptr()
            caps = {name: cap_out[e:e + 1] for name, e in plane.items()}
        self._launch(lib, cu, A)
        return {**out, "t": state["t"] + self.depth}, caps

    def _launch(self, lib, cu, A):
        """Launch the call's item classes: a lone class on the caller's
        stream; both, the nonlinear class on the kernel's side stream of
        higher priority, forked from the caller's stream and joined back to
        it, and the linear class on the caller's."""
        fp64 = 1 if self.dtype == torch.float64 else 0
        cur = torch.cuda.current_stream()
        if A.nitems[0] and A.nitems[1]:
            side = cu.get("side")
            if side is None:
                side = cu["side"] = side_stream(self.plan.device)
            side.wait_stream(cur)
            rc = lib.mnt_k2_launch(ctypes.byref(A), 1, fp64,
                                   side.cuda_stream)
            if rc == 0:
                rc = lib.mnt_k2_launch(ctypes.byref(A), 0, fp64,
                                       cur.cuda_stream)
            cur.wait_stream(side)
        else:
            rc = lib.mnt_k2_launch(ctypes.byref(A), 1 if A.nitems[1] else 0,
                                   fp64, cur.cuda_stream)
        self.launches += self.launches_per_call
        if rc != 0:
            raise RuntimeError(f"fdtd3d_t2 kernel launch failed: "
                               f"cudaError {rc}")


# ---------------------------------------------------------------------------
# the bound: bytes and operations one call must move / do
# ---------------------------------------------------------------------------


def step_cost(plan, depth: int = 2, ncap: int = 0) -> Dict[str, float]:
    """Bytes and floating-point operations of one call, whatever design
    implements it: every state array read once and written once per `depth`
    steps (K1's byte count, not multiplied), `ncap` captured (S1, S2)
    planes written once, `depth` times K1's operations."""
    one = fdtd3d.step_cost(plan)
    S = tuple(plan.storage_shape or plan.gv.shape)
    item = np.dtype(plan.dtype).itemsize
    return {"bytes": one["bytes"] + float(ncap * S[1] * S[2] * item),
            "ops": depth * one["ops"]}
