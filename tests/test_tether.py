"""Motion constraints (MotionConstraintParams; the Unity Cloth
``maxDistance`` per-vertex tether) — oracle/reference.py::tether_dx is the
binding semantics, solver/tether.py the device twin; anchors/radii are
Topology array data animated with api.move_tethers."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbodyunity_tpu import api
from softbodyunity_tpu.core.config import (
    CollisionParams,
    MotionConstraintParams,
    SimConfig,
    Solver,
    SpringParams,
)
from softbodyunity_tpu.core.topology import (
    cloth_grid,
    merge_bodies,
    set_motion_constraints,
)
from softbodyunity_tpu.oracle import reference as oracle

SOLVERS = [Solver.SEMI_IMPLICIT_EULER, Solver.VERLET, Solver.XPBD]


@pytest.fixture(autouse=True)
def _restore_x64():
    prev = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", prev)


def _scene(solver, max_distance=0.05, scale=1.0, plane=False, **cfg_kw):
    """Free-hanging SOFT cloth tethered to its rest pose: gravity pulls it
    far past the slack, so the tether clamp does real work every frame."""
    from softbodyunity_tpu.core.config import XPBDParams

    cfg = SimConfig(
        solver=solver,
        motion=MotionConstraintParams(enabled=True, scale=scale),
        springs=SpringParams(k_structural=20.0, k_shear=10.0, k_bend=4.0,
                             damping=0.5),
        xpbd=XPBDParams(compliance_distance=5e-3, compliance_bend=5e-2),
        collision=CollisionParams(enable_plane=plane),
        global_damping=0.5,
        **cfg_kw,
    )
    host = cloth_grid(8, 8, spacing=0.1, mass=0.05, pinned=(),
                      shear=True, bend=True, springs=cfg.springs,
                      xpbd=cfg.xpbd, plane_height=-100.0, orientation="xz")
    host = set_motion_constraints(host, max_distance)
    return host, cfg


def _anchor_excess(host, x, scale=1.0):
    """Max distance-past-radius over all constrained movable vertices."""
    d = np.linalg.norm(x - host.tether_anchor, axis=1)
    r = host.tether_radius * scale
    finite = np.isfinite(r) & (host.inv_mass > 0.0)
    if not finite.any():
        return 0.0
    return float((d - r)[finite].max())


@pytest.mark.parametrize("solver", SOLVERS)
def test_f64_exact_parity(solver):
    """Device tether clamp == oracle to f64 rounding on the falling soft
    cloth (the clamp is active from the first frames)."""
    host, cfg = _scene(solver)
    jax.config.update("jax_enable_x64", True)
    top, state = api.init(host, dtype=jnp.float64)
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    for _ in range(40):
        x, v, xp = oracle.step(host, cfg, x, v, xp)
        state = api.step(top, cfg, state)
    drift = np.max(np.abs(np.asarray(state.x) - x))
    assert drift < 1e-6, f"{solver}: f64 drift {drift:.3e}"
    # sanity: gravity actually drives the cloth into the clamp
    assert _anchor_excess(host, x) > -0.01


@pytest.mark.parametrize("solver", SOLVERS)
def test_tether_bound_invariant(solver):
    """The defining invariant: with no contact stage after the clamp,
    every constrained vertex ends each frame inside its tether sphere
    (f32 rounding slack only) — while the untethered cloth free-falls."""
    host, cfg = _scene(solver)
    top, state = api.init(host)
    for _ in range(200):
        state = api.step(top, cfg, state)
    x = np.asarray(state.x)
    assert np.isfinite(x).all()
    assert _anchor_excess(host, x) < 1e-5
    cfg_off = cfg.replace(motion=MotionConstraintParams(enabled=False))
    top2, state2 = api.init(host)
    for _ in range(200):
        state2 = api.step(top2, cfg_off, state2)
    assert _anchor_excess(host, np.asarray(state2.x)) > 1.0


def test_scale_zero_welds():
    """scale=0 hard-welds every constrained vertex to its anchor."""
    host, cfg = _scene(Solver.VERLET, max_distance=0.5, scale=0.0)
    top, state = api.init(host)
    for _ in range(50):
        state = api.step(top, cfg, state)
    x = np.asarray(state.x)
    np.testing.assert_allclose(x, host.tether_anchor, atol=1e-5)


def test_inf_radius_is_free():
    """inf radii: the clamp correction is exactly zero, and the rollout
    matches the unconstrained scene (to XLA refusion rounding — inserting
    a fused-out zero add can flip last-ulp bits downstream)."""
    from softbodyunity_tpu.solver.tether import tether_dx

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER, max_distance=np.inf)
    top, state = api.init(host)
    dx = tether_dx(top, cfg, state.x + 5.0)
    assert float(jnp.abs(dx).max()) == 0.0
    cfg_off = cfg.replace(motion=MotionConstraintParams(enabled=False))
    top2, state2 = api.init(host)
    for _ in range(30):
        state = api.step(top, cfg, state)
        state2 = api.step(top2, cfg_off, state2)
    np.testing.assert_allclose(np.asarray(state.x), np.asarray(state2.x),
                               atol=1e-6)


def test_indices_subset():
    """Constrain only the top row: it stays tethered, the rest of the
    cloth hangs below (farther from rest than the slack)."""
    host = cloth_grid(8, 8, spacing=0.1, mass=0.05, pinned=(),
                      shear=True, bend=True, plane_height=-100.0,
                      orientation="xz")
    top_row = np.arange(8)  # first grid row
    host = set_motion_constraints(host, 0.02, indices=top_row)
    assert np.isfinite(host.tether_radius).sum() == 8
    cfg = SimConfig(
        motion=MotionConstraintParams(enabled=True),
        springs=SpringParams(k_structural=20.0, k_shear=10.0, k_bend=4.0,
                             damping=0.5),
        collision=CollisionParams(enable_plane=False),
        global_damping=0.5,
    )
    top, state = api.init(host)
    for _ in range(100):
        state = api.step(top, cfg, state)
    x = np.asarray(state.x)
    assert _anchor_excess(host, x) < 1e-5
    free = np.isinf(host.tether_radius)
    sag = np.linalg.norm(x - host.positions0, axis=1)[free].max()
    assert sag > 0.1


def test_move_tethers_animates():
    """Dragging the anchors drags the cloth (the skinned-body use case);
    per-index updates touch only those anchors; no recompile needed."""
    host, cfg = _scene(Solver.XPBD, max_distance=0.03)
    top, state = api.init(host)
    shift = np.array([0.4, 0.0, 0.0], np.float32)
    top2 = api.move_tethers(top, anchors=host.tether_anchor + shift)
    for _ in range(100):
        state = api.step(top2, cfg, state)
    x = np.asarray(state.x)
    moved = np.linalg.norm(
        x - (host.tether_anchor + shift), axis=1)
    assert moved.max() < 0.03 + 1e-4
    # per-index update: one anchor teleports, the rest stay
    ids = np.array([5])
    top3 = api.move_tethers(top2, anchors=[[9.0, 9.0, 9.0]], indices=ids)
    a = np.asarray(top3.tether_anchor)
    np.testing.assert_allclose(a[5], [9.0, 9.0, 9.0])
    np.testing.assert_allclose(
        np.delete(a, 5, axis=0),
        np.delete(np.asarray(top2.tether_anchor), 5, axis=0))
    # radii too
    top4 = api.move_tethers(top3, radii=np.full(64, 0.5, np.float32))
    assert float(np.asarray(top4.tether_radius)[0]) == 0.5
    with pytest.raises(ValueError, match="no motion constraints"):
        plain, _ = api.init(cloth_grid(4, 4))
        api.move_tethers(plain, anchors=np.zeros((16, 3)))


@pytest.mark.parametrize("solver", SOLVERS)
def test_contact_wins(solver):
    """An anchor buried under the floor cannot pull cloth through it:
    the contact stage runs after the clamp and always wins."""
    host, cfg = _scene(solver, max_distance=0.0, plane=True)
    # plane at y=-0.2, anchors dragged to y=-1 (far below)
    host.plane_height = -0.2
    anchors = host.positions0.copy()
    anchors[:, 1] = -1.0
    host = set_motion_constraints(host, 0.0, anchors=anchors)
    top, state = api.init(host)
    for _ in range(100):
        state = api.step(top, cfg, state)
    x = np.asarray(state.x)
    assert np.isfinite(x).all()
    assert x[:, 1].min() > -0.2 - 1e-4


def test_f64_parity_coupled():
    """Coupled Euler with motion constraints == oracle step_coupled."""
    from softbodyunity_tpu.solver.rigid import make_rigid_state

    jax.config.update("jax_enable_x64", True)
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        motion=MotionConstraintParams(enabled=True),
        springs=SpringParams(k_structural=30.0, k_shear=15.0, k_bend=6.0,
                             damping=0.5),
        collision=CollisionParams(enable_plane=True, enable_spheres=True,
                                  friction=0.2),
        global_damping=0.5,
    )
    host = cloth_grid(8, 8, spacing=0.1, mass=0.05,
                      pinned=("tl", "tr", "bl", "br"), shear=True,
                      bend=True, springs=cfg.springs, xpbd=cfg.xpbd,
                      plane_height=-2.0, orientation="xz",
                      sphere_centers=[[0.35, 0.3, 0.35]],
                      sphere_radii=[0.12])
    host = set_motion_constraints(host, 0.08)
    top, state = api.init(host, dtype=jnp.float64)
    rigid = make_rigid_state(top, [0.3])
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    rc = np.asarray(host.sphere_centers, np.float64)
    rv = np.zeros_like(rc)
    rom = np.zeros_like(rc)
    for _ in range(40):
        x, v, xp, rc, rv, rom = oracle.step_coupled(
            host, cfg, x, v, xp, rc, rv, np.asarray([1.0 / 0.3]),
            romega=rom)
        state, rigid = api.step_coupled(top, cfg, state, rigid)
    assert np.max(np.abs(np.asarray(state.x) - x)) < 1e-6
    assert np.max(np.abs(np.asarray(rigid.centers) - rc)) < 1e-6


@pytest.mark.parametrize("solver", SOLVERS)
def test_f64_parity_coupled_projection(solver):
    """Coupled Verlet/XPBD with motion constraints == oracle (the
    position-level slot after shape matching / strain limiting)."""
    if solver == Solver.SEMI_IMPLICIT_EULER:
        pytest.skip("covered by test_f64_parity_coupled")
    from softbodyunity_tpu.solver.rigid import make_rigid_state

    jax.config.update("jax_enable_x64", True)
    cfg = SimConfig(
        solver=solver,
        motion=MotionConstraintParams(enabled=True),
        springs=SpringParams(k_structural=30.0, k_shear=15.0, k_bend=6.0,
                             damping=0.5),
        collision=CollisionParams(enable_plane=True, enable_spheres=True,
                                  friction=0.2),
        global_damping=0.5,
    )
    host = cloth_grid(6, 6, spacing=0.1, mass=0.05, pinned=(),
                      shear=True, bend=True, springs=cfg.springs,
                      xpbd=cfg.xpbd, plane_height=-2.0, orientation="xz",
                      sphere_centers=[[0.25, 0.25, 0.25]],
                      sphere_radii=[0.1])
    host = set_motion_constraints(host, 0.06)
    top, state = api.init(host, dtype=jnp.float64)
    rigid = make_rigid_state(top, [0.3])
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    rc = np.asarray(host.sphere_centers, np.float64)
    rv = np.zeros_like(rc)
    rom = np.zeros_like(rc)
    for _ in range(40):
        x, v, xp, rc, rv, rom = oracle.step_coupled(
            host, cfg, x, v, xp, rc, rv, np.asarray([1.0 / 0.3]),
            romega=rom)
        state, rigid = api.step_coupled(top, cfg, state, rigid)
    assert np.max(np.abs(np.asarray(state.x) - x)) < 1e-6


def test_dispatch_gates_fast_paths_off():
    """Motion-constrained scenes must never silently drop the clamp: the
    stencil path refuses, the jnp path runs it."""
    from softbodyunity_tpu.kernels import dispatch

    host = cloth_grid(16, 16, spacing=0.05, shear=True, bend=True)
    host = set_motion_constraints(host, 0.05)
    top, _ = api.init(host)
    cfg_on = SimConfig(motion=MotionConstraintParams(enabled=True))
    cfg_off = SimConfig()
    assert dispatch.maybe_fast_step(top, cfg_on) is None
    assert dispatch.maybe_fast_step(top, cfg_off) is not None
    # enabled in cfg but no arrays on the topology: the feature is off
    plain, _ = api.init(cloth_grid(16, 16, spacing=0.05, shear=True,
                                   bend=True))
    assert dispatch.maybe_fast_step(plain, cfg_on) is not None


def test_halo_gates():
    """Every halo path takes motion constraints as sharded tether planes
    — and rejects MISSING inputs loudly at call time (no silent drop on
    multi-chip; round-3 VERDICT closed the lattice hole).  Equality is
    covered by tests/test_halo.py::
    test_halo_strain_tether_matches_single_device (+_lattice_)."""
    from jax.sharding import Mesh

    from softbodyunity_tpu.parallel import halo

    host = cloth_grid(16, 16, spacing=0.05, shear=True, bend=True)
    host = set_motion_constraints(host, 0.05)
    top, state = api.init(host)
    cfg = SimConfig(motion=MotionConstraintParams(enabled=True))
    mesh = Mesh(np.array(jax.devices()[:2]), ("rows",))
    fn = halo.make_halo_step(top, cfg, mesh)  # builds fine
    x3, v3, im3, ph = halo.shard_grid_state(top, state, mesh)
    with pytest.raises(ValueError, match="tether_anchors"):
        fn(x3, v3, im3, ph, cfg.dt, 1)  # but the planes must be passed

    from softbodyunity_tpu.core.topology import tet_cube

    cube = tet_cube(8, spacing=0.08, springs=cfg.springs, xpbd=cfg.xpbd,
                    plane_height=0.0)
    cube = set_motion_constraints(cube, 0.05)
    ctop, cstate = api.init(cube)
    cfn = halo.make_halo_lattice_step(ctop, cfg, mesh)  # builds fine now
    args = halo.shard_lattice_state(ctop, cstate, mesh)
    with pytest.raises(ValueError, match="tether_anchors"):
        cfn(*args, cfg.dt, 1)  # same missing-inputs contract as cloth


def test_batched_matches_single():
    from softbodyunity_tpu.parallel.batch import batch_state, step_batched

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    single = api.step(top, cfg, state)
    multi = step_batched(top, cfg, batch_state(state, 3))
    for b in range(3):
        np.testing.assert_allclose(np.asarray(multi.x[b]),
                                   np.asarray(single.x), atol=1e-6)


def test_batched_per_scene_anchors():
    """step_batched_colliders varies the tether anchors per scene: each
    scene's cloth ends up at ITS shifted anchor set."""
    from softbodyunity_tpu.parallel.batch import (
        batch_state, step_batched_colliders)

    host, cfg = _scene(Solver.VERLET, max_distance=0.02)
    top, state = api.init(host)
    b = 3
    shifts = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0],
                       [0.0, 0.0, 0.7]], np.float32)
    anchors = (np.asarray(host.tether_anchor, np.float32)[None]
               + shifts[:, None, :])
    states = batch_state(state, b)
    for _ in range(100):
        states = step_batched_colliders(top, cfg, states,
                                        tether_anchor=anchors)
    x = np.asarray(states.x)
    for i in range(b):
        d = np.linalg.norm(x[i] - anchors[i], axis=1)
        assert d.max() < 0.02 + 1e-4, f"scene {i}: {d.max()}"


def test_merge_bodies_keeps_tethers():
    """merge_bodies concatenates constraints; bodies without them stay
    unconstrained (inf radii), and the merged scene reproduces both."""
    tethered = cloth_grid(6, 6, spacing=0.1, mass=0.05, pinned=(),
                          plane_height=-100.0, orientation="xz")
    tethered = set_motion_constraints(tethered, 0.03)
    free = cloth_grid(6, 6, spacing=0.1, mass=0.05, pinned=(),
                      plane_height=-100.0, orientation="xz",
                      origin=(2.0, 0.0, 0.0))
    merged = merge_bodies(tethered, free)
    assert merged.tether_anchor.shape == (72, 3)
    assert np.isfinite(merged.tether_radius[:36]).all()
    assert np.isinf(merged.tether_radius[36:]).all()
    cfg = SimConfig(
        motion=MotionConstraintParams(enabled=True),
        springs=SpringParams(k_structural=20.0, k_shear=10.0, k_bend=4.0,
                             damping=0.5),
        collision=CollisionParams(enable_plane=False),
        global_damping=0.5,
    )
    top, state = api.init(merged)
    for _ in range(150):
        state = api.step(top, cfg, state)
    x = np.asarray(state.x)
    assert _anchor_excess(merged, x) < 1e-5          # tethered body held
    fall = (merged.positions0[36:, 1] - x[36:, 1]).min()
    assert fall > 0.5                                 # free body fell


def test_set_motion_constraints_validation():
    host = cloth_grid(4, 4)
    with pytest.raises(ValueError, match="must be >= 0"):
        set_motion_constraints(host, -1.0)
    with pytest.raises(ValueError, match="entries for"):
        set_motion_constraints(host, np.ones(5))
    with pytest.raises(ValueError, match="anchors shape"):
        set_motion_constraints(host, 0.1, anchors=np.zeros((3, 3)))
    with pytest.raises(ValueError, match="must[\\s\\S]*match indices"):
        set_motion_constraints(host, np.ones(3), indices=[0, 1])
