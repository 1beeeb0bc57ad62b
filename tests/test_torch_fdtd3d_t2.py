"""K2 (meep_nl_tpu_torch/ops/fdtd3d_t2.py): its plain version and its capture
planes against the JAX package's jnp stepper (the reference that the JAX
package's own tests/test_fdtd3d_t2.py uses), one small case against the
reference's capture kernel in interpret mode, its envelope against the JAX
kernel's, its bound, and its wavefront schedule.  The CUDA kernel itself is
held against its plain version in test_torch_fdtd3d_t2_gpu.py.

The kernel route runs the slab-local PML chains (plan.slab_opt), so the JAX
side runs with the same flag.  Tolerance: fp32 1e-5 of the field maximum."""

import functools

import jax
import numpy as np
import pytest
import torch

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
    one (the jnp stepper's, 24 steps around the source's peak), since the
    reference's compact layout holds no E or PML auxiliary outside its
    slabs."""
    monkeypatch.setenv("MNT_PALLAS_INTERPRET", "1")
    depth, t0 = 2, 150
    kw = dict(cells=(20, 12, 12))
    pj = build_plan(JAX, **kw)
    pj.slab_opt = True
    assert JT2.supported(pj, depth=depth)
    start = JS.run(pj, JS.init_state(pj), 24, t0=t0 - 24)
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
# the wavefront schedule, replayed on version counters
# ---------------------------------------------------------------------------


def replay(ops, bx, nphase, R, S0):
    """Execute a schedule on counters instead of fields.  Every (group,
    ring slot) holds (plane, version); an op's read must find its plane at
    the version the sequential program gives it (the number of earlier ops
    that write the group), ops of one phase must not touch what another op
    of that phase writes, and STORE must see every plane finished."""
    expect = {}
    for n, op in enumerate(ops):
        expect[op.name] = {g: sum(1 for first in ops[:n] if g in first.writes)
                           for g in T2.GROUPS}
    final = {g: sum(1 for op in ops if g in op.writes) for g in T2.GROUPS}
    ring = {}
    stored = set()
    nwave = (S0 - 1 + max(op.off for op in ops)) // bx + 1
    for w in range(nwave):
        for ph in range(nphase):
            writes, reads = {}, {}
            for op in ops:
                if op.phase != ph:
                    continue
                for x in range(max(w * bx - op.off, 0),
                               min(w * bx - op.off + bx, S0)):
                    for g, dx in op.reads:
                        if not 0 <= x + dx < S0:
                            continue
                        cell = (g, (x + dx) % R)
                        assert ring.get(cell) == (x + dx, expect[op.name][g]), \
                            (op.name, x, g, dx, ring.get(cell))
                        reads.setdefault(cell, set()).add((op.name, x))
                    for g in op.writes:
                        cell = (g, x % R)
                        assert cell not in writes, (op.name, x, g)
                        writes[cell] = (op.name, x)
                    if op.kind == T2.OP_STORE:
                        assert all(ring[(g, x % R)] == (x, final[g])
                                   for g in T2.GROUPS)
                        stored.add(x)
            for cell, who in writes.items():
                assert reads.get(cell, set()) <= {who}, (cell, who)
            for (g, slot), (name, x) in writes.items():
                ring[(g, slot)] = (x, expect[name][g] + 1)
    assert stored == set(range(S0))


@pytest.mark.parametrize("depth,b_src,d_src,bx,nphase,S0", [
    (2, (), (0,), 4, None, 24), (3, (), (0,), 5, None, 24),
    (2, (0,), (1,), 3, None, 17), (3, (0, 1), (2,), 2, None, 13),
    (3, (), (), 8, None, 24), (2, (), (0,), 4, 3, 24),
    (3, (0,), (1,), 3, 4, 19), (3, (), (0,), 16, None, 8),
])
def test_schedule_orders_every_access(depth, b_src, d_src, bx, nphase, S0):
    ops = T2.program(depth, b_src, d_src)
    nphase, R = T2.schedule(ops, bx, nphase)
    assert R == max(op.off for op in ops) + 1 + bx
    replay(ops, bx, nphase, R, S0)


def test_schedule_replay_catches_a_broken_offset():
    ops = T2.program(2, (), (0,))
    nphase, R = T2.schedule(ops, 4)
    next(op for op in ops if op.name == "ee1").off -= 1
    with pytest.raises(AssertionError):
        replay(ops, 4, nphase, R, 24)
