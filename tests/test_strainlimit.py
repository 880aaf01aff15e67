"""Strain limiting (StrainLimitParams; Provot-style hard stretch bound) —
oracle/reference.py::strain_limit_dx is the binding semantics,
solver/strainlimit.py the device twin."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbodyunity_tpu import api
from softbodyunity_tpu.core.config import (
    CollisionParams,
    PlasticityParams,
    SimConfig,
    Solver,
    SpringParams,
    StrainLimitParams,
    TearParams,
)
from softbodyunity_tpu.core.topology import cloth_grid
from softbodyunity_tpu.oracle import reference as oracle

SOLVERS = [Solver.SEMI_IMPLICIT_EULER, Solver.VERLET, Solver.XPBD]


@pytest.fixture(autouse=True)
def _restore_x64():
    prev = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", prev)


def _scene(solver, max_stretch=0.1, soft=True, **cfg_kw):
    """Hanging cloth with deliberately SOFT springs (and, for XPBD, HIGH
    distance compliance): gravity stretches it far past the limit, so
    the strain clamp does real work."""
    from softbodyunity_tpu.core.config import XPBDParams

    k = 20.0 if soft else 400.0
    cfg = SimConfig(
        solver=solver,
        strain_limit=StrainLimitParams(enabled=True,
                                       max_stretch=max_stretch),
        springs=SpringParams(k_structural=k, k_shear=k / 2, k_bend=k / 5,
                             damping=0.5),
        xpbd=XPBDParams(compliance_distance=5e-3, compliance_bend=5e-2),
        collision=CollisionParams(enable_plane=False),
        global_damping=0.5,
        **cfg_kw,
    )
    host = cloth_grid(8, 8, spacing=0.1, mass=0.05, pinned=("top",),
                      shear=True, bend=True, springs=cfg.springs,
                      xpbd=cfg.xpbd, plane_height=-100.0, orientation="xy")
    return host, cfg


def _max_strain(host, x):
    a, b = host.edges[:, 0], host.edges[:, 1]
    length = np.linalg.norm(x[b] - x[a], axis=1)
    return float(((length - host.rest_length) / host.rest_length).max())


@pytest.mark.parametrize("solver", SOLVERS)
def test_f64_exact_parity(solver):
    """Device strain limiting == oracle to f64 rounding on the falling
    soft cloth (the clamp is active from the first frames)."""
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
    # sanity: the scene actually stretches into the clamp
    assert _max_strain(host, x) > 0.05


@pytest.mark.parametrize("solver", SOLVERS)
def test_strain_stays_bounded(solver):
    """The defining invariant: a soft cloth whose springs alone stretch
    >40% settles with max strain ~ the 10% limit (Jacobi sweeps leave a
    small residual; contact/gravity re-stretch each substep)."""
    host, cfg = _scene(solver)
    top, state = api.init(host)
    for _ in range(200):
        state = api.step(top, cfg, state)
    x = np.asarray(state.x)
    assert np.isfinite(x).all()
    limited = _max_strain(host, x)
    assert limited < 0.13, f"{solver}: strain {limited:.3f} past the limit"
    # and WITHOUT the limiter the same scene stretches far beyond it
    cfg_off = cfg.replace(strain_limit=StrainLimitParams(enabled=False))
    top2, state2 = api.init(host)
    for _ in range(200):
        state2 = api.step(top2, cfg_off, state2)
    unlimited = _max_strain(host, np.asarray(state2.x))
    assert unlimited > 2.0 * limited


def test_pinned_vertices_frozen():
    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    x0 = np.asarray(state.x)
    pinned = np.asarray(host.inv_mass) == 0.0
    for _ in range(50):
        state = api.step(top, cfg, state)
    assert np.array_equal(np.asarray(state.x)[pinned], x0[pinned])


def test_compression_bound():
    """max_compress >= 0 also bounds squashing: a squeezed free-floating
    cloth re-expands to within the band."""
    cfg = SimConfig(
        strain_limit=StrainLimitParams(enabled=True, max_stretch=0.05,
                                       max_compress=0.05, iterations=8),
        springs=SpringParams(k_structural=0.0, k_shear=0.0, k_bend=0.0),
        gravity=(0.0, 0.0, 0.0),
        global_damping=2.0,
    )
    host = cloth_grid(8, 8, spacing=0.1, springs=cfg.springs, xpbd=cfg.xpbd,
                      plane_height=-100.0)
    top, state = api.init(host)
    x0 = np.asarray(state.x)
    c = x0.mean(axis=0)
    squeezed = ((x0 - c) * 0.7 + c).astype(np.float32)
    state = state.replace(x=jnp.asarray(squeezed),
                          x_prev=jnp.asarray(squeezed))
    for _ in range(60):
        state = api.step(top, cfg, state)
    a, b = host.edges[:, 0], host.edges[:, 1]
    x = np.asarray(state.x)
    length = np.linalg.norm(x[b] - x[a], axis=1)
    strain = (length - host.rest_length) / host.rest_length
    assert strain.min() > -0.08 and strain.max() < 0.08


def test_torn_edges_are_inert():
    """A dead (torn) edge no longer limits: kill every edge and the
    correction is identically zero."""
    from softbodyunity_tpu.solver.strainlimit import strain_limit_dx

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER,
                       tear=TearParams(enabled=True, strain_limit=9.0))
    jax.config.update("jax_enable_x64", True)
    top, state = api.init(host, dtype=jnp.float64)
    x = state.x * 1.5  # uniformly stretched
    dead = jnp.zeros(host.edges.shape[0], jnp.float64)
    live = jnp.ones(host.edges.shape[0], jnp.float64)
    dx_dead = strain_limit_dx(top, cfg, x, alive=dead)
    dx_live = strain_limit_dx(top, cfg, x, alive=live)
    assert float(jnp.abs(dx_dead).max()) == 0.0
    assert float(jnp.abs(dx_live).max()) > 0.0


def test_plastic_rest_scale_honoured():
    """Strain limiting measures strain against the PLASTIC rest length:
    with rest_scale = 1.5 a 1.5x-stretched cloth is exactly at rest (no
    correction); with scale 1 it is far past the limit."""
    from softbodyunity_tpu.solver.strainlimit import strain_limit_dx

    host, cfg = _scene(
        Solver.SEMI_IMPLICIT_EULER,
        plasticity=PlasticityParams(enabled=True, yield_strain=0.05,
                                    creep=0.1),
    )
    jax.config.update("jax_enable_x64", True)
    top, state = api.init(host, dtype=jnp.float64)
    c = state.x.mean(axis=0)
    x = (state.x - c) * 1.5 + c
    e = host.edges.shape[0]
    dx_scaled = strain_limit_dx(top, cfg, x,
                                rest_scale=1.5 * jnp.ones(e, jnp.float64))
    dx_plain = strain_limit_dx(top, cfg, x)
    assert float(jnp.abs(dx_scaled).max()) < 1e-12
    assert float(jnp.abs(dx_plain).max()) > 0.0


def test_f64_parity_coupled():
    """Coupled Euler with strain limiting == oracle step_coupled."""
    from softbodyunity_tpu.solver.rigid import make_rigid_state

    jax.config.update("jax_enable_x64", True)
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        strain_limit=StrainLimitParams(enabled=True, max_stretch=0.1),
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


def _grid_scene(solver, tear=False, plastic=False):
    """Soft 16x16 grid with plane contact.  High XPBD compliance keeps the springs stretchy there too, so the
    limiter does real work on all three solvers."""
    from softbodyunity_tpu.core.config import XPBDParams

    cfg = SimConfig(
        solver=solver,
        strain_limit=StrainLimitParams(enabled=True, max_stretch=0.08),
        springs=SpringParams(k_structural=30.0, k_shear=15.0, k_bend=6.0,
                             damping=0.5),
        xpbd=XPBDParams(compliance_distance=5e-3, compliance_bend=5e-2),
        tear=TearParams(enabled=tear, strain_limit=0.2),
        plasticity=PlasticityParams(enabled=plastic, yield_strain=0.02,
                                    creep=0.1),
        global_damping=0.4,
    )
    host = cloth_grid(16, 16, spacing=0.08, mass=0.04, pinned=("top",),
                      shear=True, bend=True, springs=cfg.springs,
                      xpbd=cfg.xpbd, plane_height=-0.9, orientation="xy")
    return host, cfg


@pytest.mark.parametrize("solver,tear,plastic", [
    (Solver.SEMI_IMPLICIT_EULER, False, False),
    (Solver.VERLET, False, False),
    (Solver.XPBD, False, False),
    (Solver.SEMI_IMPLICIT_EULER, True, True),
    (Solver.VERLET, True, False),
    (Solver.XPBD, True, False),
])
def test_f64_parity_grid_with_contact(f64_oracle_run, solver, tear, plastic):
    """The soft 16x16 grid, alone and composed with tearing/plasticity,
    on the general path (strain-limited grids never take the stencil
    path) against the oracle in f64.  The plane sits out of reach here:
    with vertices resting exactly at the plane height, f64 summation-order
    noise in the sweeps decides the ``y < plane`` ties and the two
    trajectories part at the second substep."""
    from softbodyunity_tpu.kernels import dispatch

    host, cfg = _grid_scene(solver, tear=tear, plastic=plastic)
    host = cloth_grid(16, 16, spacing=0.08, mass=0.04, pinned=("top",),
                      shear=True, bend=True, springs=cfg.springs,
                      xpbd=cfg.xpbd, plane_height=-5.0, orientation="xy")
    top, _ = api.init(host)
    assert dispatch.maybe_fast_step(top, cfg) is None
    s, x, extras = f64_oracle_run(host, cfg, 4)
    if tear:
        np.testing.assert_array_equal(np.asarray(s.edge_alive),
                                      extras["alive"])
    drift = np.max(np.abs(np.asarray(s.x) - x))
    assert drift < 1e-8, f"{solver}: f64 drift {drift:.3e}"
    # the limiter was actually active (soft springs stretch past 5%)
    assert _max_strain(host, x) > 0.05


def test_banded_twin_matches_gather():
    """The banded (roll-based) sweep == the gather sweep to f32 rounding
    on a fully-banded grid (the banded path is what grids actually run)."""
    from softbodyunity_tpu.solver import strainlimit

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    assert top.offset_groups.n_residual == 0
    rng = np.random.default_rng(2)
    x = state.x + jnp.asarray(
        rng.normal(0, 0.08, state.x.shape).astype(np.float32))
    dx_banded = strainlimit.strain_limit_dx(top, cfg, x)
    # force the gather path by threading an (all-ones) alive mask
    dx_gather = strainlimit.strain_limit_dx(
        top, cfg, x, alive=jnp.ones(host.edges.shape[0], jnp.float32))
    np.testing.assert_allclose(np.asarray(dx_banded),
                               np.asarray(dx_gather), atol=2e-6)
    assert float(jnp.abs(dx_banded).max()) > 0.0


def test_gates_fast_paths_off():
    """Strain-limited scenes must never silently drop the sweeps: they
    never take the stencil path, which refuses them outright."""
    from softbodyunity_tpu.kernels import dispatch
    from softbodyunity_tpu.kernels.stencil import make_stencil_step

    grid = cloth_grid(16, 16, spacing=0.05, shear=True, bend=True)
    top, _ = api.init(grid)
    cfg_on = SimConfig(strain_limit=StrainLimitParams(enabled=True))
    cfg_off = SimConfig()
    assert dispatch.maybe_fast_step(top, cfg_on) is None
    assert dispatch.maybe_fast_step(top, cfg_off) is not None
    with pytest.raises(ValueError, match="strain limiting"):
        make_stencil_step(top, cfg_on)


def test_batched_matches_single():
    from softbodyunity_tpu.parallel.batch import batch_state, step_batched

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    single = api.step(top, cfg, state)
    multi = step_batched(top, cfg, batch_state(state, 3))
    for b in range(3):
        np.testing.assert_allclose(np.asarray(multi.x[b]),
                                   np.asarray(single.x), atol=1e-6)
