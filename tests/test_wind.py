"""Wind / aerodynamic forcing tests (WindParams: isotropic drag +
normal-projected lift; oracle/reference.py wind_forces is the binding
definition).  Device paths — general jnp and stencil (grid normals as
rolls) — must match the oracle exactly in f64."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbodyunity_tpu import api
from softbodyunity_tpu.core.config import (
    CollisionParams,
    SimConfig,
    Solver,
    WindParams,
)
from softbodyunity_tpu.core.topology import cloth_grid, tet_cube
from softbodyunity_tpu.oracle import reference as oracle

SOLVERS = [Solver.SEMI_IMPLICIT_EULER, Solver.VERLET, Solver.XPBD]


@pytest.fixture(autouse=True)
def _restore_x64():
    prev = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", prev)


def _scene(solver, nx=10, ny=10):
    cfg = SimConfig(
        solver=solver,
        wind=WindParams(velocity=(2.0, 0.5, 1.0), drag=0.3, lift=0.8),
        collision=CollisionParams(enable_plane=True),
        global_damping=0.2,
    )
    host = cloth_grid(
        nx, ny, spacing=0.05, shear=True, bend=True, pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-1.0,
        orientation="xy",
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


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("backend", ["jnp", "stencil"])
def test_f64_exact_parity(solver, backend):
    """The roll-based grid-normal lift (stencil) and the segment-sum lift
    (jnp) both implement exactly the oracle's triangle-normal semantics."""
    host, cfg = _scene(solver)
    cfg = cfg.replace(backend=backend)
    got, want = _run_pair(host, cfg, n_steps=40, dtype=jnp.float64)
    drift = np.max(np.abs(got - want))
    assert drift < 1e-6, f"{solver} {backend}: f64 drift {drift:.3e}"


def test_wind_blows_cloth_downwind():
    """Physical sanity: a hanging cloth under lateral wind deflects in the
    wind direction and keeps fluttering (finite, nonzero velocity)."""
    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER, nx=16, ny=16)
    top, state = api.init(host)
    for _ in range(90):
        state = api.step(top, cfg, state)
    x = np.asarray(state.x)
    assert np.isfinite(x).all()
    # center of mass moved toward +x (wind velocity has +2 in x)
    assert x[:, 0].mean() > np.asarray(host.positions0)[:, 0].mean() + 0.02


def test_drag_only_wind_no_triangles_ok():
    """Drag-only wind works on topologies without triangles (pure spring
    networks): lift silently contributes nothing when there are none."""
    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    host.triangles = np.zeros((0, 3), np.int32)
    top, state = api.init(host)
    state = api.step(top, cfg, state)
    assert np.isfinite(np.asarray(state.x)).all()


def test_lattice_drag_wind_matches_oracle(f64_oracle_run):
    """Drag-only wind on a tet lattice (the banded jnp path) matches the
    oracle in f64, and the wind pushes the cube downwind."""
    from softbodyunity_tpu.kernels import dispatch

    cfg = SimConfig(
        wind=WindParams(velocity=(3.0, 0.0, 0.0), drag=0.5, lift=0.0),
        collision=CollisionParams(enable_plane=True),
        volume_stiffness=0.5,
        global_damping=0.3,
    )
    host = tet_cube(5, spacing=0.05, springs=cfg.springs, xpbd=cfg.xpbd,
                    plane_height=0.0, origin=(0.0, 0.05, 0.0))
    top, _ = api.init(host)
    assert dispatch.maybe_fast_step(top, cfg) is None
    assert top.offset_groups.n_residual == 0       # fully banded
    s, x, _ = f64_oracle_run(host, cfg, 3)
    drift = np.max(np.abs(np.asarray(s.x) - x))
    assert drift < 1e-8, f"f64 drift {drift:.3e}"
    assert x[:, 0].mean() > 0.1


@pytest.mark.parametrize("solver", SOLVERS)
def test_f64_parity_tall_contact_free_grid(f64_oracle_run, solver):
    """Full wind (drag + lift) on a taller 16x24 grid with 3 XPBD
    iterations, contact-free, on the stencil path against the oracle."""
    from softbodyunity_tpu.core.config import XPBDParams
    from softbodyunity_tpu.kernels import dispatch

    cfg = SimConfig(
        solver=solver,
        wind=WindParams(velocity=(2.0, 0.5, 1.0), drag=0.3, lift=0.8),
        xpbd=XPBDParams(n_iterations=3),
        collision=CollisionParams(enable_plane=True),
        global_damping=0.2,
    )
    host = cloth_grid(
        16, 24, spacing=0.05, shear=True, bend=True, pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-3.0,
        orientation="xy",
    )
    top, _ = api.init(host)
    assert dispatch.maybe_fast_step(top, cfg) is not None
    s, x, _ = f64_oracle_run(host, cfg, 3)
    drift = np.max(np.abs(np.asarray(s.x) - x))
    assert drift < 1e-8, f"{solver}: f64 drift {drift:.3e}"


@pytest.mark.parametrize("solver", SOLVERS)
def test_halo_wind_matches_single_device(solver):
    """Row-sharded cloth under full wind (drag + lift) equals the
    single-device stencil path: the lift normal's 1-ring read stays inside
    the exchanged 2-row halo."""
    from jax.sharding import Mesh
    from softbodyunity_tpu.kernels.stencil import make_stencil_step
    from softbodyunity_tpu.parallel import halo

    host, cfg = _scene(solver, nx=12, ny=16)
    top, state = api.init(host)
    mesh = Mesh(np.array(jax.devices()[:4]), (halo.ROWS_AXIS,))
    if solver == Solver.SEMI_IMPLICIT_EULER:
        make = halo.make_halo_step
    elif solver == Solver.VERLET:
        make = halo.make_halo_verlet_step
    else:
        make = halo.make_halo_xpbd_step
    sharded = jax.jit(make(top, cfg, mesh), static_argnums=(5,))
    x3, v3, im3, ph = halo.shard_grid_state(top, state, mesh)
    if solver == Solver.VERLET:
        xp3 = x3  # state starts with x_prev == x
        xf, vf = sharded(x3, xp3, im3, ph, cfg.dt, 48)
    else:
        xf, vf = sharded(x3, v3, im3, ph, cfg.dt, 48)
    got = halo.unshard_to_state(xf, vf, cfg.dt)
    ref = jax.jit(lambda t, s: make_stencil_step(t, cfg)(s, cfg.dt, 48))
    want = ref(top, state)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(want.x), atol=2e-5
    )


def test_halo_lattice_drag_wind_matches_single_device():
    """Slab-sharded tet lattice supports drag-only wind (pointwise);
    equality vs the single-device banded path."""
    from jax.sharding import Mesh
    from softbodyunity_tpu.parallel import halo
    from softbodyunity_tpu.solver.step import step_scan

    cfg = SimConfig(
        wind=WindParams(velocity=(3.0, 0.0, 0.0), drag=0.5, lift=0.0),
        collision=CollisionParams(enable_plane=True),
        volume_stiffness=0.5,
        global_damping=0.3,
    )
    host = tet_cube(8, spacing=0.05, springs=cfg.springs, xpbd=cfg.xpbd,
                    plane_height=0.0, origin=(0.0, 0.05, 0.0))
    top, state = api.init(host)
    mesh = Mesh(np.array(jax.devices()[:4]), (halo.ROWS_AXIS,))
    sharded = jax.jit(
        halo.make_halo_lattice_step(top, cfg, mesh), static_argnums=(7,)
    )
    args = halo.shard_lattice_state(top, state, mesh)
    xf, vf = sharded(*args, cfg.dt, 48)
    got = halo.unshard_to_state(xf, vf, cfg.dt)
    want = jax.jit(lambda t, s: step_scan(t, cfg, s, cfg.dt, 48))(top, state)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(want.x), atol=2e-5
    )


def test_halo_lattice_lift_raises():
    from jax.sharding import Mesh
    from softbodyunity_tpu.parallel import halo

    cfg = SimConfig(wind=WindParams(velocity=(1.0, 0, 0), drag=0.1, lift=0.5))
    host = tet_cube(4, spacing=0.05, springs=cfg.springs, xpbd=cfg.xpbd)
    top, _ = api.init(host)
    mesh = Mesh(np.array(jax.devices()[:2]), (halo.ROWS_AXIS,))
    with pytest.raises(NotImplementedError):
        halo.make_halo_lattice_step(top, cfg, mesh)


def test_lattice_lift_gates_to_jnp():
    from softbodyunity_tpu.kernels import dispatch

    cfg = SimConfig(
        wind=WindParams(velocity=(3.0, 0.0, 0.0), drag=0.1, lift=0.5),
        volume_stiffness=0.5,
    )
    host = tet_cube(4, spacing=0.05, springs=cfg.springs, xpbd=cfg.xpbd)
    top, _ = api.init(host)
    assert dispatch.maybe_fast_step(top, cfg) is None
