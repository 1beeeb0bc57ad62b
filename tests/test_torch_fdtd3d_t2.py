"""K2 (meep_nl_tpu_torch/ops/fdtd3d_t2.py): its plain version and its capture
planes against the JAX package's jnp stepper (the reference that the JAX
package's own tests/test_fdtd3d_t2.py uses), one small case against the
reference's capture kernel in interpret mode, its envelope against the JAX
kernel's, its bound, the march of its items (stage lags, ring planes, halo
widths) replayed on version counters, its item planning, and a Simulation
with more current sources than its first port took.  The CUDA kernel
itself is held against its plain version in test_torch_fdtd3d_t2_emul.py
(on the host) and test_torch_fdtd3d_t2_gpu.py (on the card).

The kernel route runs the slab-local PML chains (plan.slab_opt), so the JAX
side runs with the same flag.  Tolerance: fp32 1e-5 of the field maximum."""

import functools

import jax
import numpy as np
import pytest
import torch

import meep_nl_tpu_torch as mtt
from meep_nl_tpu.ops.pallas import fdtd3d_t2 as JT2
from meep_nl_tpu.stepper import step as JS
from meep_nl_tpu_torch import interop
from meep_nl_tpu_torch.ops import fdtd3d as TF
from meep_nl_tpu_torch.ops import fdtd3d_t2 as T2
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_plan import CASES, JAX, PORT, build_plan, random_state
from test_torch_step import assert_states_close, jax_run

torch.set_num_threads(2)

NSTEPS = 7          # odd: both depths end with a K1 residue step
RUN_CASES = ("upml", "upml_subset", "flagship")


@functools.lru_cache(maxsize=None)
def _jax_reference(case):
    kw = CASES[case]
    st_np = random_state(build_plan(JAX, **kw), seed=5)
    return st_np, jax_run(kw, np.float32, True, st_np, NSTEPS)


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("case", RUN_CASES)
def test_run_matches_jax(case, depth):
    st_np, want = _jax_reference(case)
    pt = build_plan(PORT, device="cpu", **CASES[case])
    pt.slab_opt = True
    ker = T2.Fdtd3dT2Kernel(pt, depth=depth)
    got = ker.run(interop.state_from_numpy(st_np, "cpu"), NSTEPS, t0=0)
    # a CPU state runs the plain versions, and launches nothing
    assert ker.plain_steps == NSTEPS // depth * depth
    assert ker._k1.plain_steps == NSTEPS % depth
    assert ker.launches == 0 and ker._k1.launches == 0
    assert_states_close(interop.state_to_numpy(got), want, 1e-5,
                        keys=("f", "f_u", "f_w"))


@pytest.mark.parametrize("depth", [2, 3])
def test_capture_planes_match_jax_stepper(depth):
    """The planes one call captures are the jnp stepper's fields after
    each single step: E after stages 1..depth-1, H after every stage."""
    kw = CASES["flagship"]
    pj = build_plan(JAX, **kw)
    pj.slab_opt = True
    st_np = random_state(pj, seed=8)
    planes = [("ey", 11), ("ez", 12), ("hy", 11), ("hz", 3)]
    pt = build_plan(PORT, device="cpu", **kw)
    pt.slab_opt = True
    ker = T2.Fdtd3dT2Kernel(pt, depth=depth, cap_planes=planes)
    rows = TS.xs_rows(pt, TS.build_xs(pt, depth, 150))
    got_state, caps = ker.capture_step(
        interop.state_from_numpy(st_np, "cpu"), rows)
    want_keys = {T2.cap_key(s, c, x) for c, x in planes
                 for s in range(1, depth + (c[0] == "h"))}
    assert set(caps) == want_keys
    st = jax.tree_util.tree_map(jax.numpy.asarray, st_np)
    scale = max(float(np.abs(v).max()) for v in st_np["f"].values())
    for s in range(1, depth + 1):
        st = JS.run(pj, st, 1, t0=150 + s - 1)
        for c, x in planes:
            key = T2.cap_key(s, c, x)
            if key in caps:
                err = np.abs(caps[key].numpy()
                             - np.asarray(st["f"][c][x:x + 1])).max()
                assert err <= 1e-5 * scale, f"{key}: {err:.3e}"
    assert_states_close(interop.state_to_numpy(got_state),
                        jax.tree_util.tree_map(np.asarray, st), 1e-5,
                        keys=("f", "f_u", "f_w"))


def test_capture_matches_reference_kernel_interpreted(monkeypatch):
    """One small case against the reference's own capture kernel
    (make_capture_step, Pallas interpret mode): same state after the call,
    same capture planes under the same keys.  The start state is a developed
    one (the jnp stepper's, 25 steps around the source's peak), since the
    reference's compact layout holds no E or PML auxiliary outside its
    slabs."""
    monkeypatch.setenv("MNT_PALLAS_INTERPRET", "1")
    depth, t0 = 2, 150
    kw = dict(cells=(20, 12, 12))
    pj = build_plan(JAX, **kw)
    pj.slab_opt = True
    assert JT2.supported(pj, depth=depth)
    start = JS.run(pj, JS.init_state(pj), 25, t0=t0 - 25)
    planes = [("ez", 7), ("hy", 7), ("hy", 8)]
    jker = JT2.Fdtd3dT2Kernel(pj, depth=depth, cap_planes=planes)
    xs = {k: np.asarray(v) for k, v in JS.build_xs(pj, depth, t0).items()
          if k in jker.xs_keys}
    comp, jcaps = jker.make_capture_step()(jker.from_full(start), xs,
                                           pj.coefs)
    want = jax.tree_util.tree_map(np.asarray, jker.to_full(comp, pj.coefs))

    pt = build_plan(PORT, device="cpu", **kw)
    pt.slab_opt = True
    ker = T2.Fdtd3dT2Kernel(pt, depth=depth, cap_planes=planes)
    st_np = jax.tree_util.tree_map(np.asarray, start)
    got, caps = ker.capture_step(interop.state_from_numpy(st_np, "cpu"),
                                 TS.xs_rows(pt, TS.build_xs(pt, depth, t0)))
    assert set(caps) == set(jcaps)
    scale = max(float(np.abs(v).max()) for v in want["f"].values())
    assert scale > 0
    for key in caps:
        err = np.abs(caps[key].numpy() - np.asarray(jcaps[key])).max()
        assert err <= 1e-5 * scale, f"{key}: {err:.3e}"
    assert any(float(np.abs(np.asarray(v)).max()) > 1e-3 * scale
               for v in jcaps.values())
    assert_states_close(interop.state_to_numpy(got), want, 1e-5,
                        keys=("f", "f_u", "f_w"))


def _mu_plan(pkg, **extra):
    """Vacuum uPML with mu = 2 in a slab (has_u on the H specs)."""
    gv = pkg.G.GridVolume.create("3d", [2.0, 2.0, 2.0], 8.0)
    inv = {}
    for c in ("hx", "hy", "hz"):
        mu = np.ones(gv.shape)
        mu[6:10] = 2.0
        inv[c] = {c[1]: 1.0 / mu}
    pts = gv.interp_weights("ez", [-0.6, 0.05, 0.0])
    src = pkg.P.SrcVolSpec("ez", np.array([p for p, w in pts], np.int32),
                           np.array([w for p, w in pts], np.complex128),
                           pkg.Gaussian(frequency=1.0, fwidth=0.5))
    return pkg.P.compile_plan(gv, pkg.P.MaterialSpec(chi1inv=inv),
                              pmls=[pkg.P.PMLSpec(d, 0.5) for d in "xyz"],
                              sources=[src], pad_to_multiple=(8, 1, 1),
                              **extra)


#: case -> (build_plan kwargs, depth, why the port's envelope differs or
#: None).  "tpu_blocks": a condition of the reference's x-blocking (block
#: counts between the x-PML slabs, the dispersive window clear of the edge
#: calls) that this kernel's one schedule does not have.
ENVELOPE = {
    "vacuum_16_d2": (dict(), 2, "tpu_blocks"),
    "vacuum_24_d2": (dict(cells=(24, 16, 16)), 2, None),
    "vacuum_24_d3": (dict(cells=(24, 16, 16)), 3, "tpu_blocks"),
    "vacuum_32_d3": (dict(cells=(32, 24, 24)), 3, None),
    "flagship_32_d2": (dict(cells=(32, 24, 24), ball=True, pol=True,
                            nr=True, flux=True), 2, None),
    "flagship_32_d3": (dict(cells=(32, 24, 24), ball=True, pol=True,
                            nr=True, flux=True), 3, None),
    "flagship_16_d2": (dict(ball=True, pol=True, nr=True), 2, "tpu_blocks"),
    "h_source_d2": (dict(cells=(24, 16, 16), src_comp="hz"), 2, None),
    "conductivity_d2": (dict(ball=True, cond=True), 2, None),
    "h_pole_d2": (dict(ball=True, hpol=True), 2, None),
    "periodic_x_d2": (dict(periodic=(True, False, False)), 2, None),
    "integrated_src_d3": (dict(integrated=True), 3, None),
    "short_x_d3": (dict(cells=(4, 16, 16), pad=1), 3, None),
}


@pytest.mark.parametrize("case", sorted(ENVELOPE))
def test_envelope_matches_jax(case):
    kw, depth, why = ENVELOPE[case]
    j = JT2.supported(build_plan(JAX, **kw), depth=depth)
    t = T2.supported(build_plan(PORT, device="cpu", **kw), depth=depth)
    if why is None:
        assert j == t
    else:
        assert (j, t) == (False, True)


def test_envelope_deliberate_differences():
    """mu != 1 on H: the reference declines (its trailing stage lacks the
    full mu-inverse), the port runs it; depths other than 2 and 3 and 2D
    plans are declined."""
    assert JT2.supported(_mu_plan(JAX)) is False
    pt = _mu_plan(PORT, device="cpu")
    assert any(s.has_u for s in pt.eh_specs_h)
    assert T2.supported(pt, depth=2) and T2.supported(pt, depth=3)
    assert not T2.supported(build_plan(PORT, device="cpu"), depth=1)
    assert not T2.supported(build_plan(PORT, device="cpu"), depth=4)
    gv = PORT.G.GridVolume.create("2d", [2.0, 2.0], 8.0)
    p2 = PORT.P.compile_plan(gv, PORT.P.MaterialSpec(chi1inv={}),
                             pmls=[PORT.P.PMLSpec("x", 0.5)], device="cpu")
    assert not T2.supported(p2)
    with pytest.raises(ValueError):
        T2.Fdtd3dT2Kernel(p2)


def test_mu_plan_matches_jax_stepper():
    """The envelope's one widening, held to the jnp stepper."""
    pj = _mu_plan(JAX)
    pj.slab_opt = True
    st_np = random_state(pj, seed=2)
    want = jax.tree_util.tree_map(np.asarray, JS.run(
        pj, jax.tree_util.tree_map(jax.numpy.asarray, st_np), 6, t0=0))
    pt = _mu_plan(PORT, device="cpu")
    pt.slab_opt = True
    got = T2.Fdtd3dT2Kernel(pt, depth=3).run(
        interop.state_from_numpy(st_np, "cpu"), 6, t0=0)
    assert_states_close(interop.state_to_numpy(got), want, 1e-5,
                        keys=("f", "f_u", "f_w"))


def test_kernel_state_checks():
    """The CUDA path refuses CPU tensors, and the constructor refuses
    planes it cannot capture (checked without a device: the checks run
    before any launch)."""
    pt = build_plan(PORT, device="cpu")
    ker = T2.Fdtd3dT2Kernel(pt, depth=2, cap_planes=[("ez", 3), ("hy", 3)])
    assert ker.launches_per_call == 1
    assert ker.captures == [(1, "ez", 3), (1, "hy", 3), (2, "hy", 3)]
    st = interop.state_from_numpy(random_state(build_plan(JAX), 1), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ker._step_cuda(st, [{}, {}])
    assert ker.launches == 0
    for bad in ([("dz", 3)], [("ez", 99)]):
        with pytest.raises(ValueError, match="capture plane"):
            T2.Fdtd3dT2Kernel(pt, cap_planes=bad)
    with pytest.raises(ValueError, match="envelope"):
        T2.Fdtd3dT2Kernel(pt, depth=4)


@pytest.mark.parametrize("depth", [2, 3])
def test_step_cost_is_k1s_bytes_plus_the_captures(depth):
    pt = build_plan(PORT, device="cpu", **CASES["flagship"])
    pt.slab_opt = True
    one = TF.step_cost(pt)
    plane = pt.storage_shape[1] * pt.storage_shape[2] * 4
    ncap = len(T2.capture_list(depth, [("ey", 5), ("hz", 5)]))
    assert ncap == 2 * depth - 1
    cost = T2.step_cost(pt, depth, ncap)
    assert cost["bytes"] == one["bytes"] + ncap * plane
    assert cost["ops"] == depth * one["ops"]
    assert T2.step_cost(pt, depth)["bytes"] == one["bytes"]


# ---------------------------------------------------------------------------
# the march of an item, replayed on version counters
# ---------------------------------------------------------------------------

#: what each sub-update of stage s reads at its own site (at the version
#: of stage s - 1; stage 1 reads them from the input state) and writes
OWN = {"b": (T2.R_B, T2.R_FUB, T2.R_FWH, T2.R_H),
       "d": (T2.R_D, T2.R_FUD),
       "e": (T2.R_FWE, T2.R_P, T2.R_PP, T2.R_E)}


def replay_march(depth, nl, i0, i1, S0, ns=None, hs=None, hot=None):
    """Execute T2.march_order on counters instead of fields.  Every (ring,
    slot) holds (plane, stage); a read must find the plane it wants at the
    stage the sequential algorithm gives it, the input's E planes must be
    complete (issued a step before), and the last stage must reach every
    output plane.  `ns`: ring planes (default T2.march's); `hs`: the growth
    below and above (march_order); `hot`: the planes whose E reads D - P at
    +-1 on a nonlinear item (default: all)."""
    ns = ns or T2.march(depth, nl)["ns"]
    ring, issued, done = {}, {}, set()

    def write(role, p, v):
        ring[role, p % ns[role]] = (p, v)

    def read(role, p, v, t, what):
        if 0 <= p < S0:
            assert ring.get((role, p % ns[role])) == (p, v), \
                (what, role, p, v, ring.get((role, p % ns[role])))
            if role == T2.R_E and v == 0:
                assert issued[p] < t, ("E not loaded", p)

    for t, what, s, p in T2.march_order(depth, nl, i0, i1, S0, hs):
        ev = (what, s, p)
        if what == "load":
            write(T2.R_E, p, 0)
            issued[p] = t
            continue
        if s > 1:
            for role in OWN[what]:
                read(role, p, s - 1, t, ev)
        if what == "b":
            read(T2.R_E, p, s - 1, t, ev)
            read(T2.R_E, p + 1, s - 1, t, ev)
        elif what == "d":
            read(T2.R_H, p, s, t, ev)
            read(T2.R_H, p - 1, s, t, ev)
            if nl and s > 1:
                read(T2.R_P, p, s - 1, t, ev)
        else:
            read(T2.R_D, p, s, t, ev)
            if nl and (hot is None or p in hot):
                for dp in (-1, 0, 1):
                    read(T2.R_M, p + dp, s, t, ev)
        for role in OWN[what] + ((T2.R_M,) if nl and what == "d" else ()):
            write(role, p, s)
        done.add(ev)
    for p in range(i0, i1):
        assert {(w, depth, p) for w in "bde"} <= done, p


def replay_regions(depth, nl, lo, hi, size, reg=None, hs=None, hot=None):
    """The same along y or z, with T2.regions: every site a stage reads
    across sites or at its own position was updated by the stage that
    must have written it, or (stage 1) lies in the input's E plane of the
    ring; every read falls inside its ring's plane; the last stage covers
    the output [lo, hi).  `hs`, `hot` as in replay_march."""
    reg = reg or T2.regions(depth, nl, lo, hi, size, hs)
    ver = {}

    def span(key):
        a, b = reg[key]
        return range(a, b)

    def read(role, c, v):
        if not 0 <= c < size or (v == 0 and role != T2.R_E):
            return            # zero outside the storage; the input state
        a, b = reg[T2.KIND[role]]
        assert a <= c < b, ("outside the ring plane", role, c)
        if v:                 # v == 0: the input's E, loaded into the ring
            assert ver.get((role, c)) == v, (role, c, v, ver.get((role, c)))

    for s in range(1, depth + 1):
        for what in "bde":
            for c in span((what, s)):
                for role in OWN[what]:
                    read(role, c, s - 1)
                if what == "b":
                    read(T2.R_E, c, s - 1)
                    read(T2.R_E, c + 1, s - 1)
                elif what == "d":
                    read(T2.R_H, c, s)
                    read(T2.R_H, c - 1, s)
                    if nl:
                        read(T2.R_P, c, s - 1)
                else:
                    read(T2.R_D, c, s)
                    near = nl and (hot is None or c in hot)
                    for dc in ((-1, 0, 1) if near else ()):
                        read(T2.R_M, c + dc, s)
            for c in span((what, s)):
                for role in OWN[what] + ((T2.R_M,) if nl and what == "d"
                                         else ()):
                    ver[role, c] = s
    for c in range(max(lo, 0), min(hi, size)):
        assert all(ver.get((r, c)) == depth for w in "bde" for r in OWN[w])


#: (i0, i1, S0) of an item: inside the storage, at x = 0, at the end
PLACES = {"inner": (9, 14, 40), "low-edge": (0, 4, 40),
          "high-edge": (33, 40, 40)}


@pytest.mark.parametrize("place", sorted(PLACES))
@pytest.mark.parametrize("nl", [False, True], ids=["linear", "nonlinear"])
@pytest.mark.parametrize("depth", [2, 3])
def test_march_orders_every_access(depth, nl, place):
    i0, i1, S0 = PLACES[place]
    replay_march(depth, nl, i0, i1, S0)
    replay_regions(depth, nl, i0, i1, S0)


@pytest.mark.parametrize("role", ["R_E", "R_H", "R_M", "R_B", "R_D", "R_P"])
def test_march_replay_catches_a_short_ring(role):
    """One plane fewer in any ring and some read finds a newer plane."""
    ns = dict(T2.march(3, True)["ns"])
    ns[getattr(T2, role)] -= 1
    with pytest.raises(AssertionError):
        replay_march(3, True, *PLACES["inner"], ns=ns)


def narrow_hot(depth, lo, hi, size, hs):
    """The chi2/chi3 coordinates a nonlinear item with growth `hs` may
    hold: all but the edge layers of its stages' E regions on its narrow
    (growth 1) sides."""
    edge = set()
    if hs[0] == 1:
        edge |= set(range(lo - depth + 1, lo + 1))
    if hs[1] == 1:
        edge |= set(range(hi - 1, hi + depth - 1))
    return set(range(size)) - edge


#: (below, above) growth of a nonlinear item's narrow sides
NARROW = {"below": (1, 2), "above": (2, 1), "both": (1, 1)}


@pytest.mark.parametrize("place", sorted(PLACES))
@pytest.mark.parametrize("hs", sorted(NARROW))
@pytest.mark.parametrize("depth", [2, 3])
def test_narrow_sides_order_every_access(depth, hs, place):
    """A nonlinear item grown by 1 on a side whose stages' E regions hold
    no chi2/chi3 site at their edge: the march and the regions still find
    every value they read."""
    i0, i1, S0 = PLACES[place]
    hot = narrow_hot(depth, i0, i1, S0, NARROW[hs])
    replay_march(depth, True, i0, i1, S0, hs=NARROW[hs], hot=hot)
    replay_regions(depth, True, i0, i1, S0, hs=NARROW[hs], hot=hot)


@pytest.mark.parametrize("hs", sorted(NARROW))
def test_narrow_side_replay_catches_a_site_at_the_edge(hs):
    """A chi2/chi3 site in a narrow side's edge layer reads D - P that no
    stage computed."""
    i0, i1, S0 = PLACES["inner"]
    ha, hb = NARROW[hs]
    hot = narrow_hot(3, i0, i1, S0, NARROW[hs])
    hot.add(i0 if ha == 1 else i1 - 1)
    with pytest.raises(AssertionError):
        replay_regions(3, True, i0, i1, S0, hs=NARROW[hs], hot=hot)
    with pytest.raises(AssertionError):
        replay_march(3, True, i0, i1, S0, hs=NARROW[hs], hot=hot)


@pytest.mark.parametrize("depth", [2, 3])
def test_side_widths_match_the_edge_layers(depth):
    """side_widths (summed-volume counts) against the edge layers cut from
    a random chi2 mask directly."""
    rng = np.random.default_rng(depth)
    mask = rng.random((20, 18, 16)) < 0.01
    sat = np.zeros(tuple(n + 1 for n in mask.shape), np.int64)
    sat[1:, 1:, 1:] = mask.cumsum(0).cumsum(1).cumsum(2)
    wide = 0
    for _ in range(40):
        box = [tuple(sorted(rng.integers(0, n, 2) + (0, 1)))
               for n in mask.shape]
        bits = T2.side_widths(depth, sat, box)
        for ax in range(3):
            for side in (0, 1):
                need = False
                for s in range(1, depth + 1):
                    g = 2 * (depth - s)
                    sl = [slice(max(lo - g, 0), max(hi + g, 0))
                          for lo, hi in box]
                    lo, hi = box[ax]
                    c = lo - (depth - s) if side == 0 else hi + depth - s - 1
                    sl[ax] = slice(c, c + 1) if 0 <= c < mask.shape[ax] \
                        else slice(0, 0)
                    need |= bool(mask[tuple(sl)].any())
                assert bool((bits >> (2 * ax + side)) & 1) == need
                wide += need
    assert 0 < wide < 40 * 6


def test_region_replay_catches_a_short_halo():
    reg = T2.regions(3, True, 9, 14, 40)
    a, b = reg["d", 2]
    reg["d", 2] = (a + 1, b)
    with pytest.raises(AssertionError):
        replay_regions(3, True, 9, 14, 40, reg=reg)


@pytest.mark.parametrize("scene", ["flagship", "upml"])
def test_items_tile_the_storage_once(scene):
    """Every site of the storage is the output of exactly one item; the
    nonlinear class holds every item whose first stage meets a nonzero
    chi2 site, and no other; each class's rings fit the budget."""
    kw = dict(cells=(32, 24, 24), ball=True, pol=True, nr=True) \
        if scene == "flagship" else dict(cells=(32, 24, 24))
    pt = build_plan(PORT, device="cpu", **kw)
    pt.slab_opt = True
    S = pt.storage_shape
    budget = T2.SMEM_H100 // 2
    items, lays, ch, counts, tile = T2.plan_items(pt, 3, (4, 8),
                                                  (budget, budget))
    assert tile[0] <= 4 and tile[1] <= 8
    assert len(items) == sum(counts)
    cover = np.zeros(S, np.int32)
    for i0, i1, j0, j1, k0, k1, _, _ in items:
        cover[i0:i1, j0:j1, k0:k1] += 1
    assert (cover == 1).all()
    sat = T2._nl_counts(pt)
    assert (sat is not None) == (scene == "flagship")
    for n, (i0, i1, j0, j1, k0, k1, _, _) in enumerate(items):
        # the first stage's E region holds a nonzero chi2 site
        meets = sat is not None and T2._count(
            sat, ((i0 - 2, i1 + 2), (j0 - 2, j1 + 2), (k0 - 2, k1 + 2))) > 0
        assert meets == (n >= counts[0])
    if sat is not None:
        # the count agrees with the coefficient arrays
        nr = pt.coefs["ex:nrchi2"].numpy() != 0
        assert T2._count(sat, ((0, S[0]),) * 3) == int(
            (nr | (pt.coefs["ey:nrchi2"].numpy() != 0)
             | (pt.coefs["ez:nrchi2"].numpy() != 0)).sum())
    for lay in lays:
        assert lay is None or lay[0] * 4 <= budget
    assert (counts[1] > 0) == (scene == "flagship") and counts[0] > 0


def nine_source_sim(device, **kw):
    from chip_smoke import nine_source_sim as sim
    return sim(mtt, device, **kw)


def test_nine_sources_take_the_hybrid_route(monkeypatch):
    """The first K2 port refused more than 8 current sources in its
    constructor; the scene runs through the hybrid route (the resident one
    declined) as the eager stepper does."""
    from meep_nl_tpu_torch.ops import resident as R
    monkeypatch.setattr(R, "VMEM_BUDGET", 0)
    sim = nine_source_sim("cpu")
    assert len(sim.plan.sources) == 9 and T2.supported(sim.plan, 3)
    sim.run(until=2.0)
    assert dict(sim.routes) == {"hybrid": 1}
    ker = sim.plan._t2_kernel
    assert ker.k3.plain_steps > 0
    eager = nine_source_sim("cpu", use_fused=False)
    eager.run(until=2.0)
    want = eager.get_array(mtt.Ez)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(sim.get_array(mtt.Ez), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
