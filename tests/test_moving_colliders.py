"""Kinematic collider velocities (the Unity moving-Rigidbody/kinematic-
Collider contact analogue): friction and restitution act on the velocity
RELATIVE to each collider, so a dragged sphere carries the cloth, a plane
with a surface velocity is a conveyor belt, and bounces off a moving box
pick up its motion.

Binding semantics: oracle/reference.py ``_contact_velocity_response`` /
``resolve_plane(velocity=...)``.  Velocities are Topology *array* data
(``plane_velocity``, ``sphere_velocities``, ``capsule_velocities``,
``box_velocities``, ``sdf_velocities``) — animatable between frames without
recompiling, batchable per scene, and replicated on the halo paths.  Only
the velocity-level (Euler) solver reads them; Verlet/XPBD contact is
position-projection (the oracle has no velocity response there).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from softbodyunity_tpu import api
from softbodyunity_tpu.core.config import (
    CollisionParams,
    SimConfig,
    Solver,
)
from softbodyunity_tpu.core.topology import add_colliders, cloth_grid
from softbodyunity_tpu.oracle import reference as oracle


@pytest.fixture(autouse=True)
def _restore_x64():
    prev = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", prev)


def _scene(*, nx=12, ny=12, friction=0.4, restitution=0.2):
    """Cloth resting near a moving sphere, capsule, box and a conveyor
    plane: every collider family carries a distinct kinematic velocity so
    a wrong index/zero velocity shows up as oracle drift."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        collision=CollisionParams(
            enable_plane=True, enable_spheres=True, enable_capsules=True,
            enable_boxes=True, restitution=restitution, friction=friction,
        ),
        global_damping=0.3,
    )
    host = cloth_grid(
        nx, ny, spacing=0.05, shear=True, bend=True, pinned=(),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=0.0,
        origin=(-0.28, 0.12, -0.28), orientation="xz",
        sphere_centers=np.array([[-0.15, 0.0, -0.1]]),
        sphere_radii=np.array([0.13]),
    )
    host = add_colliders(
        host,
        capsule_p0=[[0.0, 0.0, 0.05]],
        capsule_p1=[[0.3, 0.0, 0.05]],
        capsule_radii=[0.11],
        box_centers=[[0.05, 0.0, -0.25]],
        box_half_extents=[[0.1, 0.13, 0.1]],
        box_rotations=[np.eye(3)],
        plane_velocity=[0.3, 0.0, -0.1],
        sphere_velocities=[[0.25, 0.0, 0.0]],
        capsule_velocities=[[-0.2, 0.0, 0.1]],
        box_velocities=[[0.0, 0.0, 0.2]],
    )
    return host, cfg


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


@pytest.mark.parametrize("backend", ["jnp", "stencil"])
def test_f64_exact_parity(backend):
    """Device relative-frame contact == oracle, all four moving collider
    families live in one scene (f64; bound = contact-chaos-amplified
    summation reorder)."""
    host, cfg = _scene()
    cfg = cfg.replace(backend=backend)
    got, want = _run_pair(host, cfg, n_steps=40, dtype=jnp.float64)
    drift = np.max(np.abs(got - want))
    assert drift < 1e-6, f"{backend}: f64 drift {drift:.3e}"


def test_f64_parity_16x16_stencil(f64_oracle_run):
    """The moving-collider scene on a 16x16 grid (the stencil path)
    against the oracle in f64."""
    from softbodyunity_tpu.kernels import dispatch

    host, cfg = _scene(nx=16, ny=16)
    top, _ = api.init(host)
    assert dispatch.maybe_fast_step(top, cfg) is not None
    s, x, _ = f64_oracle_run(host, cfg, 2)
    # the moving colliders actually engaged: the cloth picked up momentum
    assert np.abs(np.asarray(s.v)).max() > 0.05
    drift = np.max(np.abs(np.asarray(s.x) - x))
    assert drift < 1e-8, f"f64 drift {drift:.3e}"


def test_conveyor_plane_carries_cloth():
    """A resting cloth on a plane with surface velocity +x is dragged
    toward +x by friction and approaches the belt speed."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        collision=CollisionParams(enable_plane=True, friction=0.4),
        global_damping=0.0,
    )
    host = cloth_grid(
        10, 10, spacing=0.05, pinned=(), springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=0.0, origin=(0.0, 0.002, 0.0), orientation="xz",
    )
    host = add_colliders(host, plane_velocity=[0.5, 0.0, 0.0])
    top, state = api.init(host)
    for _ in range(120):
        state = api.step(top, cfg, state)
    v = np.asarray(state.v)
    x = np.asarray(state.x)
    assert np.isfinite(x).all()
    assert v[:, 0].mean() > 0.45, "belt did not carry the cloth"
    assert x[:, 1].min() >= -1e-6, "cloth fell through the belt"


def test_moving_sphere_drags_cloth():
    """A sphere sweeping +x under a draped cloth imparts +x momentum via
    friction (zero-velocity contact would leave mean vx ~ 0)."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        collision=CollisionParams(
            enable_plane=True, enable_spheres=True, friction=0.5,
        ),
        global_damping=0.1,
    )
    host = cloth_grid(
        14, 14, spacing=0.05, pinned=(), springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-2.0, origin=(-0.35, 0.3, -0.35), orientation="xz",
        sphere_centers=np.array([[0.0, 0.1, 0.0]]),
        sphere_radii=np.array([0.22]),
    )
    top, state = api.init(host)
    # settle the drape on the static sphere first
    for _ in range(60):
        state = api.step(top, cfg, state)
    v_static = np.abs(np.asarray(state.v)[:, 0].mean())
    # now drag the sphere: geometry + matching kinematic velocity per frame
    centers = np.asarray(top.sphere_centers)
    vel = np.array([[0.4, 0.0, 0.0]], np.float32)
    for k in range(30):
        top = api.move_colliders(
            top,
            sphere_centers=centers + vel * (k + 1) * cfg.dt * cfg.n_substeps,
            sphere_velocities=vel,
        )
        state = api.step(top, cfg, state)
    v_dragged = np.asarray(state.v)[:, 0].mean()
    assert v_dragged > v_static + 0.05, (
        f"dragged sphere imparted no momentum ({v_dragged:.3f})"
    )


def test_zero_velocity_is_exactly_static():
    """Explicit zero velocities must reproduce the static-collider
    trajectory bit-for-bit (the default zeros ARE the old semantics)."""
    host, cfg = _scene()
    host.plane_velocity = np.zeros(3)
    host.sphere_velocities = np.zeros((1, 3))
    host.capsule_velocities = np.zeros((1, 3))
    host.box_velocities = np.zeros((1, 3))
    top_a, state_a = api.init(host)
    host.plane_velocity = None
    host.sphere_velocities = None
    host.capsule_velocities = None
    host.box_velocities = None
    top_b, state_b = api.init(host)
    for _ in range(30):
        state_a = api.step(top_a, cfg, state_a)
        state_b = api.step(top_b, cfg, state_b)
    np.testing.assert_array_equal(
        np.asarray(state_a.x), np.asarray(state_b.x)
    )


def test_batched_per_scene_velocities():
    """step_batched_colliders: scenes sharing geometry but carrying
    different sphere velocities diverge, and the moving scene matches its
    single-scene run exactly."""
    from softbodyunity_tpu.parallel import batch

    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        collision=CollisionParams(
            enable_plane=True, enable_spheres=True, friction=0.5,
        ),
        global_damping=0.1,
        # the batched path runs the general solver; pin the single-scene
        # run to the same formulation so equality is bitwise
        backend="jnp",
    )
    host = cloth_grid(
        10, 10, spacing=0.05, pinned=(), springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-2.0, origin=(-0.25, 0.15, -0.25), orientation="xz",
        sphere_centers=np.array([[0.0, 0.0, 0.0]]),
        sphere_radii=np.array([0.18]),
    )
    top, state = api.init(host)
    states = batch.batch_state(state, 2)
    svel = jnp.asarray(
        np.array([[[0.4, 0.0, 0.0]], [[0.0, 0.0, 0.0]]]), jnp.float32
    )  # [B=2, S=1, 3]
    single_mv = state
    top_mv = api.move_colliders(top, sphere_velocities=np.array(svel[0]))
    for _ in range(10):
        states = batch.step_batched_colliders(
            top, cfg, states, sphere_velocities=svel
        )
        single_mv = api.step(top_mv, cfg, single_mv)
    xb = np.asarray(states.x)
    assert np.abs(xb[0] - xb[1]).max() > 1e-4, "velocities had no effect"
    np.testing.assert_array_equal(xb[0], np.asarray(single_mv.x))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_halo_moving_colliders_match_single_device(n_dev):
    """Row-sharded Euler halo path with conveyor plane + moving sphere
    matches the single-device stencil path."""
    from softbodyunity_tpu.kernels.stencil import make_stencil_step
    from softbodyunity_tpu.parallel import halo

    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        collision=CollisionParams(
            enable_plane=True, enable_spheres=True, friction=0.3,
            restitution=0.1,
        ),
        global_damping=0.2,
    )
    host = cloth_grid(
        16, 32, spacing=0.05, shear=True, bend=True, pinned=(),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-0.15,
        origin=(-0.4, 0.0, -0.4), orientation="xz",
        sphere_centers=np.array([[0.0, -0.1, 0.0]]),
        sphere_radii=np.array([0.15]),
    )
    host = add_colliders(
        host,
        plane_velocity=[0.2, 0.0, 0.0],
        sphere_velocities=[[0.0, 0.0, 0.3]],
    )
    top, state = api.init(host)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), (halo.ROWS_AXIS,))
    sharded = jax.jit(halo.make_halo_step(top, cfg, mesh),
                      static_argnums=(5,))
    x3, v3, im3, ph = halo.shard_grid_state(top, state, mesh)
    xf, vf = sharded(
        x3, v3, im3, ph, cfg.dt, 64,
        sphere_centers=top.sphere_centers, sphere_radii=top.sphere_radii,
        plane_velocity=top.plane_velocity,
        sphere_velocities=top.sphere_velocities,
    )
    got = halo.unshard_to_state(xf, vf, cfg.dt)
    ref_fn = jax.jit(lambda t, s: make_stencil_step(t, cfg)(s, cfg.dt, 64))
    want = ref_fn(top, state)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(want.x),
                               atol=1e-5)
