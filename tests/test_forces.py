"""Per-op twin tests (SURVEY.md §4 "Unit (per-op)"): the gather-based
accumulation equals the segment_sum twin equals the float64 oracle; the
spatial hash reproduces the dense O(N^2) rule exactly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbodyunity_tpu import api
from softbodyunity_tpu.core.config import SelfCollisionParams, SimConfig
from softbodyunity_tpu.core.topology import cloth_grid, tet_cube
from softbodyunity_tpu.models import presets
from softbodyunity_tpu.oracle import reference as oracle
from softbodyunity_tpu.solver import forces, hashgrid, normals


@pytest.fixture(scope="module")
def scene(rng):
    host = cloth_grid(7, 6, shear=True, bend=True, pinned=("tl",))
    cfg = SimConfig()
    top = api.device_topology(host)
    n = host.positions0.shape[0]
    x = host.positions0 + 0.02 * rng.standard_normal((n, 3))
    v = 0.5 * rng.standard_normal((n, 3))
    return host, cfg, top, x, v


def test_gather_equals_segment(scene):
    host, cfg, top, x, v = scene
    xj = jnp.asarray(x, jnp.float32)
    vj = jnp.asarray(v, jnp.float32)
    f_gather = forces.spring_forces_gather(top, xj, vj, cfg)
    f_segment = forces.spring_forces_segment(top, xj, vj, cfg)
    np.testing.assert_allclose(f_gather, f_segment, rtol=1e-5, atol=1e-5)


def test_gather_matches_oracle(scene):
    host, cfg, top, x, v = scene
    f_ref = oracle.spring_forces(host, x, v, cfg=cfg)
    xj = jnp.asarray(x, jnp.float32)
    vj = jnp.asarray(v, jnp.float32)
    f = forces.spring_forces_gather(top, xj, vj, cfg)
    scale = np.abs(f_ref).max()
    np.testing.assert_allclose(np.asarray(f), f_ref, atol=1e-4 * max(scale, 1.0))


def test_dense_self_collision_matches_oracle(rng):
    x = rng.uniform(-0.1, 0.1, size=(40, 3))
    f_ref = oracle.self_collision_forces(x, radius=0.06, stiffness=3.0)
    f = forces.self_collision_forces_dense(jnp.asarray(x, jnp.float32), 0.06, 3.0)
    np.testing.assert_allclose(np.asarray(f), f_ref, atol=1e-5)


def test_dense_mxu_matches_dense(rng):
    """The Gram-matrix formulation equals the direct dense rule."""
    x = rng.uniform(0.0, 0.5, size=(100, 3)).astype(np.float32) + 3.0  # offset origin
    xj = jnp.asarray(x)
    f_mxu = forces.self_collision_forces_dense_mxu(xj, 0.06, 5.0)
    f_dense = forces.self_collision_forces_dense(xj, 0.06, 5.0)
    scale = float(jnp.abs(f_dense).max()) or 1.0
    np.testing.assert_allclose(
        np.asarray(f_mxu), np.asarray(f_dense), atol=2e-3 * scale
    )


def test_dense_mxu_under_vmap(rng):
    x = rng.uniform(0.0, 0.3, size=(4, 50, 3)).astype(np.float32)
    f = jax.vmap(lambda xi: forces.self_collision_forces_dense_mxu(xi, 0.05, 2.0))(
        jnp.asarray(x)
    )
    for b in range(4):
        f_dense = forces.self_collision_forces_dense(jnp.asarray(x[b]), 0.05, 2.0)
        np.testing.assert_allclose(np.asarray(f[b]), np.asarray(f_dense), atol=1e-4)


@pytest.mark.parametrize("n_pts", [32, 200])
def test_hash_equals_dense(rng, n_pts):
    """With cell_size >= radius and generous capacity the hash pair set is
    exactly the dense pair set (SURVEY.md §7)."""
    x = rng.uniform(0.0, 0.4, size=(n_pts, 3))
    p = SelfCollisionParams(
        enabled=True, radius=0.05, stiffness=2.0, cell_size=0.05,
        grid_dim=16, max_per_cell=max(8, n_pts // 4),
    )
    xj = jnp.asarray(x, jnp.float32)
    f_hash = hashgrid.self_collision_forces_hash(xj, p)
    f_dense = forces.self_collision_forces_dense(xj, p.radius, p.stiffness)
    np.testing.assert_allclose(np.asarray(f_hash), np.asarray(f_dense), atol=1e-5)


def test_hash_under_vmap(rng):
    """hash path must be vmappable for the 1024-scene batch (BASELINE.json:11)."""
    x = rng.uniform(0.0, 0.3, size=(4, 50, 3)).astype(np.float32)
    p = SelfCollisionParams(radius=0.05, cell_size=0.05, grid_dim=8, max_per_cell=16)
    f = jax.vmap(lambda xi: hashgrid.self_collision_forces_hash(xi, p))(jnp.asarray(x))
    for b in range(4):
        f_dense = forces.self_collision_forces_dense(jnp.asarray(x[b]), p.radius, p.stiffness)
        np.testing.assert_allclose(np.asarray(f[b]), np.asarray(f_dense), atol=1e-5)


def test_normals_match_oracle(scene):
    host, cfg, top, x, v = scene
    n_ref = oracle.vertex_normals(host.triangles, x)
    n_jax = normals.vertex_normals(top.triangles, jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(np.asarray(n_jax), n_ref, atol=1e-4)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(n_jax), axis=1), 1.0, atol=1e-5
    )


def test_volume_projection_matches_oracle(rng):
    host = tet_cube(3, spacing=0.1)
    top = api.device_topology(host)
    x = host.positions0 + 0.01 * rng.standard_normal(host.positions0.shape)
    from softbodyunity_tpu.solver import xpbd as jxpbd

    dx_ref = oracle.volume_projection(host, x, stiffness=0.7)
    dx = jxpbd.volume_projection(top, jnp.asarray(x, jnp.float32), 0.7)
    np.testing.assert_allclose(np.asarray(dx), dx_ref, atol=1e-5)


def test_dense_mxu_stable_long_horizon():
    """The Gram self-collision batch stays finite for 60 frames at the
    program's own matmul precision (solver/forces.py GRAM_PRECISION): a
    low-mantissa Gram product turns close-pair distances into garbage and
    the batch explodes to NaN within a few frames.  On the CPU every f32
    product is exact; ``python chip_smoke.py`` runs the 1024-scene batch
    on the card."""
    from softbodyunity_tpu.parallel import batch

    host, cfg = presets.build("cloth_batch_rl")
    top, state = api.init(host)
    states = batch.batch_state(state, 64)
    for _ in range(60):
        states = batch.step_batched(top, cfg, states)
    assert bool(jnp.isfinite(states.x).all())


def test_hash_points_far_outside_grid_stay_finite(rng):
    """Vertices spread far wider than grid_dim*cell_size clip into border
    cells; forces must stay finite and pairs beyond the radius untouched."""
    x = rng.uniform(-50.0, 50.0, size=(64, 3)).astype(np.float32)
    p = SelfCollisionParams(radius=0.05, cell_size=0.05, grid_dim=8, max_per_cell=8)
    f = hashgrid.self_collision_forces_hash(jnp.asarray(x), p)
    assert np.isfinite(np.asarray(f)).all()
    # widely separated points get zero force even when sharing clipped cells
    far = np.linalg.norm(x[:, None] - x[None, :], axis=-1) + np.eye(64) * 1e9
    if far.min() > p.radius:
        np.testing.assert_array_equal(np.asarray(f), 0.0)


def test_xpbd_self_collision_enters_predict():
    """Self-collision repulsion is an external force in XPBD (enters the
    velocity predict like wind — oracle substep_xpbd): f64 exact parity,
    and the repulsion actually separates crowded vertices (disabling it
    changes the trajectory)."""
    import dataclasses
    from softbodyunity_tpu.core.config import Solver, SpringParams, XPBDParams

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        cfg = SimConfig(
            solver=Solver.XPBD,
            springs=SpringParams(),
            xpbd=XPBDParams(compliance_distance=3e-4, n_iterations=4),
            self_collision=SelfCollisionParams(
                enabled=True, method="dense", radius=0.06, stiffness=30.0
            ),
            global_damping=0.2,
        )
        # fold the cloth so vertices crowd within the repulsion radius
        host = cloth_grid(
            6, 10, spacing=0.04, shear=True, bend=True, pinned=("tl", "tr"),
            springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-5.0,
            orientation="xy",
        )
        top, state = api.init(host, dtype=jnp.float64)
        x = host.positions0.copy()
        v = np.zeros_like(x)
        xp = x.copy()
        s = state
        for _ in range(30):
            x, v, xp = oracle.step(host, cfg, x, v, xp)
            s = api.step(top, cfg, s)
        drift = np.max(np.abs(np.asarray(s.x) - x))
        assert drift < 1e-6, f"xpbd+self-collision f64 drift {drift:.3e}"
        # the force is live: turning it off diverges the trajectory
        cfg_off = cfg.replace(
            self_collision=dataclasses.replace(cfg.self_collision,
                                               enabled=False)
        )
        s_off = api.init(host, dtype=jnp.float64)[1]
        for _ in range(30):
            s_off = api.step(top, cfg_off, s_off)
        assert np.max(np.abs(np.asarray(s.x) - np.asarray(s_off.x))) > 1e-4
    finally:
        jax.config.update("jax_enable_x64", prev)


def test_unknown_self_collision_method_raises():
    import pytest
    from softbodyunity_tpu.core.config import (
        SelfCollisionParams,
        SimConfig,
    )
    from softbodyunity_tpu.solver.step import self_collision_force

    cfg = SimConfig(self_collision=SelfCollisionParams(
        enabled=True, method="dense-mxu"))  # typo for dense_mxu
    with pytest.raises(ValueError, match="unknown self-collision method"):
        self_collision_force(cfg, jnp.zeros((8, 3)))


def test_gram_products_ask_for_highest():
    """The Gram self-collision's two products run at HIGHEST: at HIGH the
    GPU may use TF32, whose error feeds the d^2 cancellation (PERF.md)."""
    x = jnp.zeros((16, 3), jnp.float32)
    jaxpr = str(jax.make_jaxpr(
        lambda y: forces.self_collision_forces_dense_mxu(y, 0.1, 1.0))(x))
    assert jaxpr.count("dot_general") == 2
    assert jaxpr.count("Precision.HIGHEST") >= 2
    assert "Precision.HIGH," not in jaxpr
