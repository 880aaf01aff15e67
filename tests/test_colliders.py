"""Capsule + box collider tests.

BASELINE.json:5 mandates plane/sphere resolve; capsules and oriented boxes
are the other two standard Unity primitive colliders (CapsuleCollider /
BoxCollider), so a reference user migrating a Unity scene expects them.
Semantics are oracle-defined (oracle/reference.py resolve_capsules /
resolve_boxes); every device path (general jnp, stencil) must match the
oracle exactly in f64 and keep vertices outside the geometry in f32.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbodyunity_tpu import api
from softbodyunity_tpu.core.config import CollisionParams, SimConfig, Solver
from softbodyunity_tpu.core.topology import add_colliders, cloth_grid
from softbodyunity_tpu.oracle import reference as oracle


def _rot_z(deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _scene(solver, *, rot_deg=30.0, origin_y=0.25, nx=12, ny=12):
    """Cloth falling onto a capsule and a tilted box (plane far below so
    contact is capsule/box-driven).  ``origin_y=0.05`` starts the cloth
    INSIDE the collider band so short runs exercise contact."""
    cfg = SimConfig(
        solver=solver,
        collision=CollisionParams(
            enable_plane=True, enable_capsules=True, enable_boxes=True,
            restitution=0.1, friction=0.3,
        ),
        global_damping=0.3,
    )
    host = cloth_grid(
        nx, ny, spacing=0.05, shear=True, bend=True, pinned=(),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-2.0,
        origin=(-0.28, origin_y, -0.28), orientation="xz",
    )
    host = add_colliders(
        host,
        capsule_p0=[[-0.3, 0.0, 0.0]],
        capsule_p1=[[0.05, 0.0, 0.0]],
        capsule_radii=[0.12],
        box_centers=[[0.18, -0.05, 0.1]],
        box_half_extents=[[0.15, 0.1, 0.12]],
        box_rotations=[_rot_z(rot_deg)],
    )
    return host, cfg


SOLVERS = [Solver.SEMI_IMPLICIT_EULER, Solver.VERLET, Solver.XPBD]


@pytest.fixture(autouse=True)
def _restore_x64():
    """_run_pair flips jax_enable_x64 on; alphabetically later test files
    (test_differentiable, ...) assume the f32 default — restore it."""
    prev = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", prev)


def _run_pair(host, cfg, n_steps, dtype):
    if dtype == jnp.float64:
        jax.config.update("jax_enable_x64", True)
    top, state = api.init(host, dtype=dtype)
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    s = state
    for _ in range(n_steps):
        x, v, xp = oracle.step(host, cfg, x, v, xp)
        s = api.step(top, cfg, s)
    return np.asarray(s.x), x


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("backend", ["jnp", "stencil"])
def test_f64_exact_parity(solver, backend):
    """Both device formulations implement exactly the oracle capsule/box
    semantics (f64; bound = summation-reorder noise under contact)."""
    host, cfg = _scene(solver)
    cfg = cfg.replace(backend=backend)
    got, want = _run_pair(host, cfg, n_steps=40, dtype=jnp.float64)
    drift = np.max(np.abs(got - want))
    # noise floor is f64 summation-reorder (~1e-8 at step 5, measured),
    # amplified exponentially by capsule/box contact chaos; XPBD's Jacobi
    # iterations amplify hardest (8e-6 at 40 steps).  A semantic
    # difference would appear from step 1 at 1e-3+.
    bound = 3e-5 if solver == Solver.XPBD else 1e-6
    assert drift < bound, f"{solver} {backend}: f64 drift {drift:.3e}"


@pytest.mark.parametrize("solver", SOLVERS)
def test_no_penetration_after_settle(solver):
    """f32 long-horizon contact invariant: after the drop settles, no vertex
    is inside the capsule or the (tilted) box beyond f32 contact noise."""
    host, cfg = _scene(solver)
    top, state = api.init(host)
    for _ in range(150):
        state = api.step(top, cfg, state)
    x = np.asarray(state.x, np.float64)
    assert np.isfinite(x).all()
    # capsule clearance
    p0, p1 = host.capsule_p0[0], host.capsule_p1[0]
    ax = p1 - p0
    t = np.clip((x - p0) @ ax / np.dot(ax, ax), 0.0, 1.0)
    d = np.linalg.norm(x - (p0 + t[:, None] * ax), axis=1)
    assert d.min() >= host.capsule_radii[0] - 1e-4, d.min()
    # box clearance: local-coords |q| must reach the surface
    R = host.box_rotations[0]
    q = np.abs((x - host.box_centers[0]) @ R)
    pen = (host.box_half_extents[0][None, :] - q).min(axis=1)
    assert pen.max() <= 1e-4, f"vertex {pen.max():.2e} inside the box"


def test_box_rotation_matters():
    """A tilted box must produce a different (still penetration-free)
    settle than the axis-aligned box — the rotation is actually applied."""
    host_a, cfg = _scene(Solver.SEMI_IMPLICIT_EULER, rot_deg=0.0)
    host_b, _ = _scene(Solver.SEMI_IMPLICIT_EULER, rot_deg=40.0)
    outs = []
    for host in (host_a, host_b):
        top, state = api.init(host)
        for _ in range(60):
            state = api.step(top, cfg, state)
        outs.append(np.asarray(state.x))
    assert np.abs(outs[0] - outs[1]).max() > 1e-3


def test_move_capsule_box_no_recompile():
    """Animated capsule/box geometry is array data: moving it between
    frames must reuse the compiled executable."""
    from softbodyunity_tpu.solver import step as step_mod

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    fn = jax.jit(lambda t, s: step_mod.step_scan(t, cfg, s, cfg.dt, 4))
    for i in range(4):
        top = api.move_colliders(
            top,
            capsule_p0=np.array([[-0.3, 0.01 * i, 0.0]]),
            box_centers=np.array([[0.18, -0.05 - 0.01 * i, 0.1]]),
            box_rotations=np.array([_rot_z(30.0 + 5 * i)]),
        )
        state = fn(top, state)
    assert np.isfinite(np.asarray(state.x)).all()
    assert fn._cache_size() == 1, "moving capsule/box must not retrace"


def test_batched_capsule_box_consistency():
    """vmap over B identical capsule/box scenes == the single scene."""
    from softbodyunity_tpu.parallel import batch

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    states = batch.batch_state(state, 3)
    single = state
    for _ in range(5):
        states = batch.step_batched(top, cfg, states)
        single = api.step(top, cfg, single)
    for b in range(3):
        np.testing.assert_array_equal(
            np.asarray(states.x[b]), np.asarray(single.x)
        )


def _cube_scene(solver):
    """Tet cube dropped onto a capsule + tilted box."""
    from softbodyunity_tpu.core.topology import tet_cube

    cfg = SimConfig(
        solver=solver,
        collision=CollisionParams(
            enable_plane=True, enable_capsules=True, enable_boxes=True,
            friction=0.3,
        ),
        volume_stiffness=0.5,
        global_damping=0.4,
    )
    # origin straddles the capsule/box band -> contact from substep 1
    host = tet_cube(5, spacing=0.05, springs=cfg.springs, xpbd=cfg.xpbd,
                    plane_height=-0.5, origin=(-0.1, -0.02, -0.1))
    host = add_colliders(
        host,
        capsule_p0=[[-0.15, 0.0, 0.1]], capsule_p1=[[0.25, 0.0, 0.1]],
        capsule_radii=[0.06],
        box_centers=[[0.05, -0.06, -0.05]],
        box_half_extents=[[0.12, 0.05, 0.1]],
        box_rotations=[_rot_z(20.0)],
    )
    return host, cfg


# scenes that start in contact, on the path that serves each: the
# stencil for the 12- and 16-row grids, the banded jnp path for the cube
SERVED = ([("grid", 12, sv) for sv in SOLVERS]
          + [("grid", 16, sv) for sv in SOLVERS]
          + [("cube", 5, Solver.SEMI_IMPLICIT_EULER),
             ("cube", 5, Solver.XPBD)])


@pytest.mark.parametrize("kind,ny,solver", SERVED)
def test_in_contact_matches_oracle(f64_oracle_run, kind, ny, solver):
    from softbodyunity_tpu.kernels import dispatch

    if kind == "cube":
        host, cfg = _cube_scene(solver)
    else:
        host, cfg = _scene(solver, origin_y=0.05, ny=ny)
    top, _ = api.init(host)
    assert (dispatch.maybe_fast_step(top, cfg) is None) == (kind == "cube")
    s, x, _ = f64_oracle_run(host, cfg, 3)
    # contact actually happened: the colliders moved vertices up
    assert (x[:, 1] - host.positions0[:, 1]).max() > 1e-3
    drift = np.max(np.abs(np.asarray(s.x) - x))
    assert drift < 1e-8, f"{kind} {ny} {solver}: f64 drift {drift:.3e}"


def test_batched_hetero_capsules_boxes():
    """Per-scene capsule/box geometry via step_batched_colliders: scene b
    with the shared geometry must equal the single-scene step; a scene with
    shifted geometry must differ."""
    from softbodyunity_tpu.parallel import batch

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER, origin_y=0.05)
    top, state = api.init(host)
    b = 3
    states = batch.batch_state(state, b)
    cap_p0 = np.broadcast_to(host.capsule_p0, (b, 1, 3)).copy()
    cap_p0[2, 0, 1] += 0.5  # scene 2's capsule moved away
    box_c = np.broadcast_to(host.box_centers, (b, 1, 3)).copy()
    box_c[2, 0, 1] -= 0.5
    out = batch.step_batched_colliders(
        top, cfg, states,
        capsule_p0=cap_p0, box_centers=box_c,
    )
    single = api.step(top, cfg, state)
    np.testing.assert_array_equal(np.asarray(out.x[0]), np.asarray(single.x))
    np.testing.assert_array_equal(np.asarray(out.x[1]), np.asarray(single.x))
    assert np.abs(np.asarray(out.x[2]) - np.asarray(single.x)).max() > 1e-4


def test_halo_lattice_rejects_capsules_loudly():
    """Cloth halo paths run capsules/boxes via the shared component
    primitives (tests/test_halo.py equality tests); the volumetric lattice
    paths still reject loudly."""
    from jax.sharding import Mesh

    from softbodyunity_tpu.core.topology import tet_cube
    from softbodyunity_tpu.parallel import halo

    cfg = _scene(Solver.SEMI_IMPLICIT_EULER)[1]
    cube = tet_cube(4, spacing=0.05, springs=cfg.springs, xpbd=cfg.xpbd)
    cube = add_colliders(
        cube, capsule_p0=[[0.0, -0.2, 0.0]], capsule_p1=[[0.2, -0.2, 0.0]],
        capsule_radii=[0.1],
    )
    ctop, _ = api.init(cube)
    mesh = Mesh(np.array(jax.devices()[:2]), (halo.ROWS_AXIS,))
    with pytest.raises(NotImplementedError):
        halo.make_halo_lattice_step(ctop, cfg, mesh)


def test_add_colliders_rejects_mismatched_counts():
    """Mismatched collider array counts must raise at build time: on
    device a short array silently CLAMPS out-of-range indices (jit gather
    semantics) into a phantom collider at the wrong geometry."""
    import pytest
    from softbodyunity_tpu.core.topology import add_colliders, cloth_grid

    host = cloth_grid(4, 4, spacing=0.1)
    with pytest.raises(ValueError, match="disagree"):
        add_colliders(host, capsule_p0=[[0, 0, 0]], capsule_p1=[[1, 0, 0]],
                      capsule_radii=[0.1, 0.2])
    with pytest.raises(ValueError, match="disagree"):
        add_colliders(host, box_centers=[[0, 0, 0]],
                      box_half_extents=[[0.1] * 3, [0.2] * 3])
    import numpy as np
    with pytest.raises(ValueError, match="box_rotations"):
        add_colliders(host, box_centers=[[0, 0, 0]],
                      box_half_extents=[[0.1] * 3],
                      box_rotations=np.broadcast_to(np.eye(3), (2, 3, 3)))
