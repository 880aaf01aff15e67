"""Pressure (closed-shell gas volume) tests — PressureParams semantics;
oracle/reference.py::pressure_forces is the binding definition.

The balloon is the classic Unity "inflatable" soft body: a closed
triangle shell whose enclosed gas resists volume change with ideal-gas
style pressure P ~ (V0/V - 1).  Device paths take the exact jnp gather
path (closed shells are irregular meshes)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbodyunity_tpu import api
from softbodyunity_tpu.core.config import (
    CollisionParams,
    PressureParams,
    SimConfig,
    Solver,
)
from softbodyunity_tpu.core.topology import (
    cloth_grid,
    enable_pressure,
    from_triangle_mesh,
    icosphere_mesh,
    merge_bodies,
)
from softbodyunity_tpu.oracle import reference as oracle

SOLVERS = [Solver.SEMI_IMPLICIT_EULER, Solver.VERLET, Solver.XPBD]


@pytest.fixture(autouse=True)
def _restore_x64():
    prev = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", prev)


def _balloon(center=(0.0, 0.5, 0.0), radius=0.25, subdivisions=1,
             springs=None, xpbd=None):
    pos, tris = icosphere_mesh(radius=radius, subdivisions=subdivisions,
                               center=center)
    host = from_triangle_mesh(pos, tris, springs=springs, xpbd=xpbd,
                              plane_height=0.0)
    return enable_pressure(host)


def _scene(solver, inflation=1.0, stiffness=30.0):
    cfg = SimConfig(
        solver=solver,
        pressure=PressureParams(enabled=True, stiffness=stiffness,
                                inflation=inflation),
        collision=CollisionParams(enable_plane=True),
        global_damping=0.3,
    )
    host = _balloon(springs=cfg.springs, xpbd=cfg.xpbd)
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
def test_f64_exact_parity(solver):
    """Device jnp pressure == oracle to f64 rounding on a falling balloon
    (plane contact included)."""
    host, cfg = _scene(solver)
    got, want = _run_pair(host, cfg, n_steps=40, dtype=jnp.float64)
    drift = np.max(np.abs(got - want))
    assert drift < 1e-6, f"{solver}: f64 drift {drift:.3e}"


def test_net_pressure_force_is_zero():
    """Divergence theorem holds discretely: the pressure force on a closed
    shell sums to exactly zero, even squashed (no momentum injection)."""
    from softbodyunity_tpu.solver.pressure import pressure_forces

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    jax.config.update("jax_enable_x64", True)
    top, state = api.init(host, dtype=jnp.float64)
    x = state.x * jnp.asarray([1.0, 0.4, 1.0])  # squashed: P is large
    f = pressure_forces(top, cfg, x)
    assert float(jnp.max(jnp.abs(jnp.sum(f, axis=0)))) < 1e-12


def test_squashed_balloon_reinflates():
    """A balloon squashed to ~40% height recovers most of its rest volume
    (the gas pushes back out)."""
    from softbodyunity_tpu.solver.pressure import body_volumes

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER, stiffness=60.0)
    host.plane_height = -10.0  # free space
    cfg = cfg.replace(gravity=(0.0, 0.0, 0.0))
    top, state = api.init(host)
    c = np.asarray(host.positions0).mean(axis=0)
    squash = (np.asarray(host.positions0) - c) * [1.0, 0.4, 1.0] + c
    state = state.replace(
        x=jnp.asarray(squash, jnp.float32),
        x_prev=jnp.asarray(squash, jnp.float32),
    )
    v_start = float(body_volumes(top, state.x)[0])
    for _ in range(120):
        state = api.step(top, cfg, state)
    v_end = float(body_volumes(top, state.x)[0])
    v0 = float(np.asarray(host.pressure_rest_volume)[0])
    assert np.isfinite(np.asarray(state.x)).all()
    assert v_start < 0.55 * v0
    assert v_end > 0.8 * v0, f"volume only recovered to {v_end / v0:.2f} V0"


def test_inflation_expands_above_rest():
    """inflation > 1 pumps the balloon past its rest volume (the shell
    springs must be soft enough for the gas to stretch them)."""
    from softbodyunity_tpu.core.config import SpringParams
    from softbodyunity_tpu.solver.pressure import body_volumes

    cfg = SimConfig(
        pressure=PressureParams(enabled=True, stiffness=200.0,
                                inflation=1.6),
        springs=SpringParams(k_structural=50.0, k_shear=25.0, k_bend=10.0),
        collision=CollisionParams(enable_plane=True),
        global_damping=0.3,
        gravity=(0.0, 0.0, 0.0),
    )
    host = _balloon(springs=cfg.springs, xpbd=cfg.xpbd)
    host.plane_height = -10.0
    top, state = api.init(host)
    for _ in range(120):
        state = api.step(top, cfg, state)
    v0 = float(np.asarray(host.pressure_rest_volume)[0])
    v_end = float(body_volumes(top, state.x)[0])
    assert v_end > 1.1 * v0


def test_merged_balloons_have_independent_volumes():
    """merge_bodies keeps one gas volume per balloon: squashing the first
    must not pressurize the second (its pressure force stays ~0)."""
    from softbodyunity_tpu.solver.pressure import body_volumes, pressure_forces

    cfg = SimConfig(
        pressure=PressureParams(enabled=True, stiffness=30.0),
    )
    b1 = _balloon(center=(0.0, 0.5, 0.0), springs=cfg.springs, xpbd=cfg.xpbd)
    b2 = _balloon(center=(1.0, 0.5, 0.0), springs=cfg.springs, xpbd=cfg.xpbd)
    n1 = b1.positions0.shape[0]
    host = merge_bodies(b1, b2)
    assert host.pressure_rest_volume.shape == (2,)
    assert set(np.unique(host.tri_body)) == {0, 1}
    jax.config.update("jax_enable_x64", True)
    top, state = api.init(host, dtype=jnp.float64)
    x = np.asarray(state.x).copy()
    c1 = x[:n1].mean(axis=0)
    x[:n1] = (x[:n1] - c1) * [1.0, 0.5, 1.0] + c1
    x = jnp.asarray(x)
    vols = np.asarray(body_volumes(top, x))
    v0 = np.asarray(host.pressure_rest_volume)
    assert vols[0] < 0.6 * v0[0]
    assert abs(vols[1] - v0[1]) < 1e-9 * v0[1]
    f = np.asarray(pressure_forces(top, cfg, x))
    assert np.abs(f[:n1]).max() > 1e-3       # squashed balloon pushes back
    assert np.abs(f[n1:]).max() < 1e-12      # untouched balloon: P == 0
    # oracle twin agrees on the merged scene
    f_oracle = oracle.pressure_forces(host, cfg, np.asarray(x))
    np.testing.assert_allclose(f, f_oracle, atol=1e-12)


def test_enable_pressure_rejects_open_mesh():
    host = cloth_grid(4, 4, spacing=0.1)
    with pytest.raises(ValueError, match="not closed"):
        enable_pressure(host)


def test_enable_pressure_canonicalizes_winding():
    """Inward-wound shells are rewound outward at enable time; the gas
    volume is positive either way."""
    pos, tris = icosphere_mesh(radius=0.25, subdivisions=1)
    host_fwd = enable_pressure(from_triangle_mesh(pos, tris))
    host_rev = enable_pressure(from_triangle_mesh(pos, tris[:, [0, 2, 1]]))
    v_fwd = float(host_fwd.pressure_rest_volume[0])
    v_rev = float(host_rev.pressure_rest_volume[0])
    assert v_fwd > 0 and abs(v_fwd - v_rev) < 1e-12
    # volume ~ sphere volume (icosphere subdiv 1 is ~93% of the ball)
    ball = 4.0 / 3.0 * np.pi * 0.25**3
    assert 0.85 * ball < v_fwd < ball


def test_pressure_gates_fast_paths_off():
    """A pressure body must never silently lose its gas on a fast path."""
    from softbodyunity_tpu.kernels import dispatch

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, _ = api.init(host)
    assert dispatch.maybe_fast_step(top, cfg) is None
    # grid cloth with pressure enabled but NO pressure bodies keeps its
    # fast path (the force is identically zero)
    grid = cloth_grid(16, 16, spacing=0.05, shear=True, bend=True)
    gtop, _ = api.init(grid)
    assert dispatch.maybe_fast_step(gtop, cfg) is not None


def test_batched_balloons_match_single():
    """vmapped stepping of B identical balloons == the single-scene step."""
    from softbodyunity_tpu.parallel.batch import batch_state, step_batched

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    batched = batch_state(state, 3)
    single = api.step(top, cfg, state)
    multi = step_batched(top, cfg, batched)
    for b in range(3):
        # vmap reassociates the cross/segment reductions: LSB-level only
        np.testing.assert_allclose(
            np.asarray(multi.x[b]), np.asarray(single.x), atol=1e-6
        )


def test_pressure_is_differentiable():
    """grad flows through the enclosed-volume force (system id on the
    gas stiffness analogue: d(final height)/d(inflation) exists)."""
    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)

    def loss(x0):
        from softbodyunity_tpu.solver.step import step_scan

        s = state.replace(x=x0, x_prev=x0)
        out = step_scan(top, cfg, s, cfg.dt, 8)
        return jnp.sum(out.x[:, 1])

    g = jax.grad(loss)(state.x)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.max(jnp.abs(g))) > 0.0


def test_diagnostics_reports_volume_ratio():
    from softbodyunity_tpu import diagnostics

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    d = diagnostics(top, cfg, state)
    assert 0.95 < d["pressure_volume_ratio_min"] <= 1.01
    assert d["pressure_volume_ratio_max"] <= 1.01


def test_balloon_preset_registered():
    from softbodyunity_tpu.models import presets

    host, cfg = presets.build("balloon_drop")
    assert cfg.pressure.enabled
    assert host.pressure_rest_volume.shape == (1,)


def test_sharded_balloons_match_single():
    """Batch-sharded balloons on the 8-device mesh == single-scene step
    (pressure flows through the dp sharding path like every force)."""
    from softbodyunity_tpu.parallel.batch import batch_state
    from softbodyunity_tpu.parallel.sharding import (
        make_mesh,
        replicate_topology,
        shard_batched_state,
        step_sharded,
    )

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    mesh = make_mesh()
    tops = replicate_topology(top, mesh)
    states = shard_batched_state(batch_state(state, 8), mesh)
    single = api.step(top, cfg, state)
    multi = step_sharded(tops, cfg, states, mesh)
    for b in range(8):
        np.testing.assert_allclose(
            np.asarray(multi.x[b]), np.asarray(single.x), atol=1e-6
        )


def test_enable_pressure_rejects_mixed_winding():
    """One backwards face in an otherwise closed shell must be REJECTED:
    an undirected closedness check would accept it, store a wrong rest
    volume, and the 'exact zero net force' invariant would break (the
    balloon would inject momentum every substep)."""
    pos, tris = icosphere_mesh(radius=0.25, subdivisions=1)
    tris = np.asarray(tris).copy()
    tris[0] = tris[0][[0, 2, 1]]              # flip a single face
    host = from_triangle_mesh(pos, tris)
    with pytest.raises(ValueError, match="winding|directed"):
        enable_pressure(host)


@pytest.mark.slow
def test_balloon_1k_frames_stable():
    """Long-horizon f32 statement for pressure bodies: 1000 frames of the
    balloon_drop preset stay finite with the gas volume inside sane
    bounds (no slow inflation/collapse from f32 rounding)."""
    from softbodyunity_tpu.models import presets
    from softbodyunity_tpu.solver.pressure import body_volumes

    host, cfg = presets.build("balloon_drop")
    top, state = api.init(host)
    v0 = float(np.asarray(host.pressure_rest_volume)[0])
    for _ in range(1000):
        state = api.step(top, cfg, state)
    x = np.asarray(state.x)
    v_end = float(body_volumes(top, state.x)[0])
    assert np.isfinite(x).all()
    assert x[:, 1].min() > -1e-3            # resting on the plane
    assert 0.8 * v0 < v_end < 1.3 * v0      # gas volume stays bounded
