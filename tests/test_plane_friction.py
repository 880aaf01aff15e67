"""Plane contact friction on the position-projection solvers (Verlet /
XPBD) — oracle plane_friction_positions is binding: the substep's
tangential displacement relative to the plane surface is damped by
(1 - friction) at the OR of the projections' pre-clamp contact masks,
once per substep.  Mirrors the Euler convention (v = dx/dt), so all
three solvers now share one friction semantic; plane_velocity gives
conveyor dragging on every solver."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbodyunity_tpu import api
from softbodyunity_tpu.core.config import (
    CollisionParams,
    SimConfig,
    Solver,
    SpringParams,
)
from softbodyunity_tpu.core.topology import (
    add_colliders,
    cloth_grid,
    from_triangle_mesh,
)
from softbodyunity_tpu.oracle import reference as oracle


@pytest.fixture(autouse=True)
def _restore_x64():
    prev = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", prev)


def _sliding_scene(solver, friction, grid=True):
    cfg = SimConfig(
        solver=solver,
        springs=SpringParams(k_structural=500.0, damping=0.5),
        collision=CollisionParams(enable_plane=True, friction=friction),
        global_damping=0.0,
    )
    host = cloth_grid(8, 8, spacing=0.05, pinned=(), springs=cfg.springs,
                      xpbd=cfg.xpbd, plane_height=0.0, orientation="xz")
    if not grid:
        host = from_triangle_mesh(
            host.positions0, host.triangles, mass=1.0, springs=cfg.springs,
            xpbd=cfg.xpbd, plane_height=0.0, reorder=False, bend=False)
    return host, cfg


def _slide(host, cfg, n_frames=50, dtype=jnp.float32):
    top, state = api.init(host, dtype=dtype)
    v0 = jnp.zeros_like(state.x).at[:, 0].set(1.0)
    state = state.replace(v=v0, x_prev=state.x - cfg.dt * v0)
    for _ in range(n_frames):
        state = api.step(top, cfg, state)
    return state


@pytest.mark.parametrize("solver", [Solver.SEMI_IMPLICIT_EULER,
                                    Solver.VERLET, Solver.XPBD])
@pytest.mark.parametrize("grid", [True, False])
def test_sliding_cloth_decelerates(solver, grid):
    """friction > 0 stops a sliding cloth on every solver and path
    (grid=True exercises the stencil routing, False the
    banded/jnp path); friction = 0 keeps it sliding."""
    host, cfg = _sliding_scene(solver, friction=0.3, grid=grid)
    s = _slide(host, cfg)
    assert np.abs(np.asarray(s.v)[:, 0]).max() < 0.05
    host0, cfg0 = _sliding_scene(solver, friction=0.0, grid=grid)
    s0 = _slide(host0, cfg0)
    assert np.asarray(s0.v)[:, 0].mean() > 0.9


@pytest.mark.parametrize("solver", [Solver.VERLET, Solver.XPBD])
def test_sliding_oracle_parity_f64(solver):
    """f64 exact tier for the new semantics: device path == oracle on a
    sliding contact scene (both the stencil-routed grid and the banded
    mesh forms)."""
    jax.config.update("jax_enable_x64", True)
    for grid in (True, False):
        host, cfg = _sliding_scene(solver, friction=0.3, grid=grid)
        top, state = api.init(host, dtype=jnp.float64)
        v0 = jnp.zeros_like(state.x).at[:, 0].set(1.0)
        state = state.replace(v=v0, x_prev=state.x - cfg.dt * v0)
        x = host.positions0.copy()
        v = np.asarray(v0, np.float64)
        xp = x - cfg.dt * v
        s = state
        for _ in range(50):
            x, v, xp = oracle.step(host, cfg, x, v, xp)
            s = api.step(top, cfg, s)
        drift = np.max(np.abs(np.asarray(s.x) - x))
        assert drift < 1e-7, f"grid={grid}: {drift:.2e}"


@pytest.mark.parametrize("solver", [Solver.VERLET, Solver.XPBD])
def test_conveyor_drags_projection_solvers(solver):
    """plane_velocity now drags Verlet/XPBD cloth too: a resting cloth on
    a +x conveyor acquires the belt velocity."""
    cfg = SimConfig(
        solver=solver,
        springs=SpringParams(k_structural=500.0, damping=0.5),
        collision=CollisionParams(enable_plane=True, friction=0.4),
        global_damping=0.0,
    )
    host = cloth_grid(8, 8, spacing=0.05, pinned=(), springs=cfg.springs,
                      xpbd=cfg.xpbd, plane_height=0.0, orientation="xz")
    host = add_colliders(host, plane_velocity=[0.5, 0.0, 0.0])
    top, state = api.init(host)
    for _ in range(60):
        state = api.step(top, cfg, state)
    vx = np.asarray(state.v)[:, 0].mean()
    assert vx > 0.4, f"belt didn't drag: vx={vx}"


def test_pinned_never_rubbed():
    """Friction must never move pinned vertices (the contact mask is
    movable-gated on every path)."""
    cfg = SimConfig(
        solver=Solver.VERLET,
        springs=SpringParams(k_structural=500.0, damping=0.5),
        collision=CollisionParams(enable_plane=True, friction=0.5),
        global_damping=0.0,
    )
    host = cloth_grid(8, 8, spacing=0.05, pinned=(0, 7), springs=cfg.springs,
                      xpbd=cfg.xpbd, plane_height=0.0, orientation="xz")
    top, state = api.init(host)
    x0 = np.asarray(state.x)
    for _ in range(30):
        state = api.step(top, cfg, state)
    x = np.asarray(state.x)
    np.testing.assert_array_equal(x[0], x0[0])
    np.testing.assert_array_equal(x[7], x0[7])


def _sphere_drape_scene(solver, friction):
    cfg = SimConfig(
        solver=solver,
        springs=SpringParams(k_structural=800.0, k_shear=400.0,
                             k_bend=150.0, damping=0.8),
        collision=CollisionParams(enable_plane=True, enable_spheres=True,
                                  friction=friction),
        global_damping=0.2,
    )
    host = cloth_grid(
        16, 16, spacing=0.05, shear=True, bend=True, pinned=(),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-3.0,
        orientation="xz", origin=(-0.375, 0.2, -0.375),
        sphere_centers=[[0.0, -0.15, 0.0]], sphere_radii=[0.3],
    )
    return host, cfg


@pytest.mark.parametrize("solver", [Solver.VERLET, Solver.XPBD])
def test_sphere_friction_oracle_parity_f64(solver):
    """f64 exact tier for the sphere-contact friction semantics: device
    path == oracle on a cloth draped over a sphere."""
    jax.config.update("jax_enable_x64", True)
    host, cfg = _sphere_drape_scene(solver, friction=0.3)
    top, state = api.init(host, dtype=jnp.float64)
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    s = state
    for _ in range(60):
        x, v, xp = oracle.step(host, cfg, x, v, xp)
        s = api.step(top, cfg, s)
    drift = np.max(np.abs(np.asarray(s.x) - x))
    assert drift < 1e-6, f"{drift:.2e}"
    # the cloth actually rests on the sphere (contact exercised)
    d = np.linalg.norm(x - np.array([0.0, -0.15, 0.0]), axis=1)
    assert d.min() < 0.301


@pytest.mark.parametrize("solver", [Solver.VERLET, Solver.XPBD])
def test_sphere_friction_slows_sliding(solver):
    """Tangential motion on a sphere surface decays with friction and
    persists without: spin a draped cloth around the sphere's vertical
    axis and compare the tangential speed after 40 frames."""
    out = {}
    for friction in (0.4, 0.0):
        host, cfg = _sphere_drape_scene(solver, friction)
        top, state = api.init(host)
        # drape first so the cloth is in contact
        for _ in range(40):
            state = api.step(top, cfg, state)
        x = np.asarray(state.x)
        # tangential (horizontal, azimuthal) kick around the y-axis
        r = x - np.array([0.0, -0.15, 0.0])
        t_dir = np.stack([-r[:, 2], np.zeros(len(x)), r[:, 0]], axis=1)
        t_dir /= np.maximum(np.linalg.norm(t_dir, axis=1), 1e-9)[:, None]
        v0 = jnp.asarray(t_dir * 0.5, state.v.dtype)
        s = state.replace(v=v0, x_prev=state.x - cfg.dt * v0)
        for _ in range(40):
            s = api.step(top, cfg, s)
        out[friction] = float(np.abs(np.asarray(s.v)).mean())
    assert out[0.4] < 0.5 * out[0.0], out


def _box_slide_scene(solver, friction):
    """Cloth resting on the flat top face of a wide box (plane far below:
    contact is box-driven), plus a capsule ridge it also touches."""
    cfg = SimConfig(
        solver=solver,
        springs=SpringParams(k_structural=800.0, k_shear=400.0,
                             k_bend=150.0, damping=0.8),
        collision=CollisionParams(enable_plane=True, enable_boxes=True,
                                  enable_capsules=True, friction=friction),
        global_damping=0.0,
    )
    host = cloth_grid(
        12, 12, spacing=0.05, shear=True, bend=True, pinned=(),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-3.0,
        orientation="xz", origin=(-0.275, 0.02, -0.275),
    )
    host = add_colliders(
        host,
        box_centers=[[0.0, -0.5, 0.0]],
        box_half_extents=[[2.0, 0.5, 2.0]],
        box_rotations=[np.eye(3)],
        capsule_p0=[[-0.1, -0.02, -2.0]],
        capsule_p1=[[-0.1, -0.02, 2.0]],
        capsule_radii=[0.05],
    )
    return host, cfg


@pytest.mark.parametrize("solver", [Solver.VERLET, Solver.XPBD])
def test_box_capsule_friction_oracle_parity_f64(solver):
    """f64 exact tier for the capsule/box rest friction semantics
    (oracle rest_friction_positions) on a sliding contact scene."""
    jax.config.update("jax_enable_x64", True)
    host, cfg = _box_slide_scene(solver, friction=0.3)
    top, state = api.init(host, dtype=jnp.float64)
    v0 = jnp.zeros_like(state.x).at[:, 0].set(0.8)
    state = state.replace(v=v0, x_prev=state.x - cfg.dt * v0)
    x = host.positions0.copy()
    v = np.asarray(v0, np.float64)
    xp = x - cfg.dt * v
    s = state
    for _ in range(50):
        x, v, xp = oracle.step(host, cfg, x, v, xp)
        s = api.step(top, cfg, s)
    drift = np.max(np.abs(np.asarray(s.x) - x))
    assert drift < 1e-6, f"{drift:.2e}"
    # box-top and capsule contacts were both exercised
    assert (x[:, 1] < 0.0 + 1e-3).any()


@pytest.mark.parametrize("solver", [Solver.VERLET, Solver.XPBD])
def test_box_friction_slows_sliding(solver):
    """A cloth kicked across a box top slides on at mu=0 and stops with
    mu=0.5 (same semantics as the plane, on the box face)."""
    out = {}
    for friction in (0.5, 0.0):
        host, cfg = _box_slide_scene(solver, friction)
        top, state = api.init(host)
        for _ in range(20):           # settle onto the box top
            state = api.step(top, cfg, state)
        v0 = jnp.zeros_like(state.v).at[:, 0].set(1.0)
        s = state.replace(v=v0, x_prev=state.x - cfg.dt * v0)
        for _ in range(40):
            s = api.step(top, cfg, s)
        out[friction] = float(np.abs(np.asarray(s.v)[:, 0]).mean())
    assert out[0.5] < 0.4 * out[0.0], out
