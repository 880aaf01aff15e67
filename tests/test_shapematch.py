"""Shape matching (Muller-style meshless deformation) tests —
ShapeMatchParams semantics; oracle/reference.py::shape_match_dx is the
binding definition, solver/shapematch.py the device twin.

The shape-matched body is the classic Unity "jelly" soft body: clusters
remember their rest shape and pull toward its best-fit rigid transform
every substep."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbodyunity_tpu import api
from softbodyunity_tpu.core.config import (
    CollisionParams,
    ShapeMatchParams,
    SimConfig,
    Solver,
    SpringParams,
)
from softbodyunity_tpu.core.topology import (
    cloth_grid,
    enable_shape_matching,
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


def _jelly(center=(0.0, 0.5, 0.0), radius=0.25, springs=None, xpbd=None,
           **sm_kwargs):
    pos, tris = icosphere_mesh(radius=radius, subdivisions=1, center=center)
    host = from_triangle_mesh(pos, tris, springs=springs, xpbd=xpbd,
                              plane_height=0.0)
    return enable_shape_matching(host, **sm_kwargs)


def _scene(solver, stiffness=0.3, **sm_kwargs):
    cfg = SimConfig(
        solver=solver,
        shape_match=ShapeMatchParams(enabled=True, stiffness=stiffness),
        springs=SpringParams(k_structural=20.0, k_shear=10.0, k_bend=5.0),
        collision=CollisionParams(enable_plane=True),
        global_damping=0.3,
    )
    host = _jelly(springs=cfg.springs, xpbd=cfg.xpbd, **sm_kwargs)
    return host, cfg


def _identity_quats(k):
    q = np.zeros((k, 4))
    q[:, 0] = 1.0
    return q


def _run_pair(host, cfg, n_steps, dtype):
    if dtype == jnp.float64:
        jax.config.update("jax_enable_x64", True)
    top, state = api.init(host, dtype=dtype)
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    q = _identity_quats(host.n_clusters)
    s = state
    for _ in range(n_steps):
        x, v, xp, q = oracle.step(host, cfg, x, v, xp, quats=q)
        s = api.step(top, cfg, s)
    return np.asarray(s.x), x, np.asarray(s.cluster_quat), q


@pytest.mark.parametrize("solver", SOLVERS)
def test_f64_exact_parity(solver):
    """Device jnp shape matching == oracle to f64 rounding on a falling
    jelly ball (plane contact included), quats included."""
    host, cfg = _scene(solver)
    got, want, got_q, want_q = _run_pair(host, cfg, n_steps=40,
                                         dtype=jnp.float64)
    drift = np.max(np.abs(got - want))
    assert drift < 1e-6, f"{solver}: f64 drift {drift:.3e}"
    # quaternion sign is canonical through the warm start, compare directly
    assert np.max(np.abs(got_q - want_q)) < 1e-6


@pytest.mark.parametrize("solver", SOLVERS)
def test_f32_parity_short(solver):
    """f32 device vs f64 oracle stays within contact-scene drift bounds
    over 40 frames."""
    host, cfg = _scene(solver)
    got, want, _, _ = _run_pair(host, cfg, n_steps=40, dtype=jnp.float32)
    assert np.isfinite(got).all()
    assert np.max(np.abs(got - want)) < 5e-3


def test_momentum_conserved():
    """Shape matching injects zero net momentum: with gravity and contact
    off, a deformed body's total momentum stays ~0 (``sum m_i q_i = 0``
    by construction)."""
    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER, stiffness=0.8)
    host.plane_height = -10.0
    cfg = cfg.replace(gravity=(0.0, 0.0, 0.0), global_damping=0.0)
    jax.config.update("jax_enable_x64", True)
    top, state = api.init(host, dtype=jnp.float64)
    c = np.asarray(host.positions0).mean(axis=0)
    squash = (np.asarray(host.positions0) - c) * [1.3, 0.5, 1.1] + c
    state = state.replace(x=jnp.asarray(squash), x_prev=jnp.asarray(squash))
    m = 1.0 / np.asarray(top.inv_mass)
    for _ in range(30):
        state = api.step(top, cfg, state)
    p = (m[:, None] * np.asarray(state.v)).sum(axis=0)
    # exactly zero in real arithmetic; the f64 residual is the centroid
    # division's rounding accumulated over 240 substeps of O(1) velocities
    assert np.max(np.abs(p)) < 1e-7


def test_rigid_rotation_is_a_fixed_point():
    """A rigidly ROTATED body with a CONVERGED warm start is already at
    its goal: shape matching applies zero correction and the quaternion
    stays put (the classic validation of Muller-style rotation
    extraction).  Cold-started, the extraction recovers the rotation to
    high accuracy within a few dozen sweeps."""
    from softbodyunity_tpu.solver.shapematch import shape_match_dx

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER, stiffness=1.0)
    jax.config.update("jax_enable_x64", True)
    top, _ = api.init(host, dtype=jnp.float64)
    th = 0.7
    R = np.array([
        [np.cos(th), 0.0, np.sin(th)],
        [0.0, 1.0, 0.0],
        [-np.sin(th), 0.0, np.cos(th)],
    ])
    q_true = np.array([[np.cos(th / 2), 0.0, np.sin(th / 2), 0.0]])
    c = np.asarray(host.positions0).mean(axis=0)
    xr = (np.asarray(host.positions0) - c) @ R.T + c
    # converged warm start: exact fixed point (dx == 0, quat unchanged)
    dx, q_out = shape_match_dx(top, cfg, jnp.asarray(xr),
                               jnp.asarray(q_true))
    assert np.max(np.abs(np.asarray(dx))) < 1e-12
    assert np.max(np.abs(np.asarray(q_out) - q_true)) < 1e-12
    # cold start: the warm-started iteration converges across substeps
    # (4 sweeps per call, state carried), recovering the true rotation
    q = jnp.asarray(_identity_quats(1))
    for _ in range(20):
        _, q = shape_match_dx(top, cfg, jnp.asarray(xr), q)
    assert np.max(np.abs(np.asarray(q) - q_true)) < 1e-9


def test_squashed_jelly_recovers_shape():
    """A ball squashed to 50% height springs back to its rest shape (the
    defining jelly behaviour; springs alone would too, so drive it with
    shape matching only: zero-stiffness springs)."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        shape_match=ShapeMatchParams(enabled=True, stiffness=0.5),
        springs=SpringParams(k_structural=0.0, k_shear=0.0, k_bend=0.0),
        gravity=(0.0, 0.0, 0.0),
        global_damping=2.0,
    )
    host = _jelly(springs=cfg.springs, xpbd=cfg.xpbd)
    host.plane_height = -10.0
    top, state = api.init(host)
    x0 = np.asarray(host.positions0)
    c = x0.mean(axis=0)
    squash = (x0 - c) * [1.0, 0.5, 1.0] + c
    state = state.replace(
        x=jnp.asarray(squash, jnp.float32),
        x_prev=jnp.asarray(squash, jnp.float32),
    )
    for _ in range(120):
        state = api.step(top, cfg, state)
    x = np.asarray(state.x)
    assert np.isfinite(x).all()
    # recovered to the rest shape up to a rigid transform; the rest pose
    # itself is the attractor here (identity warm start, symmetric squash)
    assert np.max(np.abs(x - x0)) < 0.02 * 0.25


def test_cell_size_clustering_is_local():
    """cell_size clustering yields >1 cluster on a cloth grid and keeps
    every cluster's rest offsets mass-centered (sum m q = 0 per cluster)."""
    host = cloth_grid(8, 8, spacing=0.1)
    host = enable_shape_matching(host, cell_size=0.35)
    assert host.n_clusters > 1
    m = np.where(host.inv_mass > 0, 1.0 / np.maximum(host.inv_mass, 1e-30),
                 0.0)
    for k in range(host.n_clusters):
        sel = host.cluster_id == k
        mq = (m[sel, None] * host.cluster_rest[sel]).sum(axis=0)
        assert np.max(np.abs(mq)) < 1e-9


def test_pinned_vertices_excluded():
    """Pinned vertices never participate: their rest offsets are zero and
    shape matching applies no correction to them."""
    from softbodyunity_tpu.solver.shapematch import shape_match_dx

    host = cloth_grid(6, 6, spacing=0.1, pinned=("top",))
    host = enable_shape_matching(host)
    cfg = SimConfig(shape_match=ShapeMatchParams(enabled=True, stiffness=1.0))
    jax.config.update("jax_enable_x64", True)
    top, state = api.init(host, dtype=jnp.float64)
    pinned = np.asarray(host.inv_mass) == 0.0
    assert np.abs(host.cluster_rest[pinned]).max() == 0.0
    x = state.x + jnp.asarray(np.random.default_rng(0).normal(
        0, 0.02, state.x.shape))
    q = jnp.asarray(_identity_quats(host.n_clusters))
    dx, _ = shape_match_dx(top, cfg, x, q)
    assert np.abs(np.asarray(dx)[pinned]).max() == 0.0
    assert np.abs(np.asarray(dx)[~pinned]).max() > 0.0


def test_merge_bodies_offsets_clusters():
    """Merged bodies keep independent clusters (ids offset); a body without
    clusters stays out (-1)."""
    b1 = _jelly(center=(0.0, 0.5, 0.0))
    b2 = cloth_grid(4, 4, spacing=0.1)
    b3 = _jelly(center=(1.0, 0.5, 0.0))
    n1 = b1.positions0.shape[0]
    n2 = b2.positions0.shape[0]
    host = merge_bodies(b1, b2, b3)
    assert host.n_clusters == 2
    assert set(np.unique(host.cluster_id[:n1])) == {0}
    assert set(np.unique(host.cluster_id[n1:n1 + n2])) == {-1}
    assert set(np.unique(host.cluster_id[n1 + n2:])) == {1}


def test_enable_shape_matching_validates():
    host = cloth_grid(4, 4, spacing=0.1)
    with pytest.raises(ValueError, match="not both"):
        enable_shape_matching(host, cluster_ids=np.zeros(16, np.int64),
                              cell_size=0.1)
    with pytest.raises(ValueError, match="cell_size"):
        enable_shape_matching(host, cell_size=0.0)
    with pytest.raises(ValueError, match="entries"):
        enable_shape_matching(host, cluster_ids=np.zeros(3, np.int64))
    with pytest.raises(ValueError, match="no cluster members"):
        enable_shape_matching(host, cluster_ids=np.full(16, -1, np.int64))
    with pytest.raises(ValueError, match="movable mass"):
        # id 1 never used: empty label
        ids = np.zeros(16, np.int64)
        ids[0] = 2
        enable_shape_matching(host, cluster_ids=ids)


def test_shape_match_gates_fast_paths_off():
    """A clustered grid scene must never silently lose its shape memory on
    a fast path; a config with shape_match enabled but NO clusters keeps
    its fast path (the correction is identically zero)."""
    from softbodyunity_tpu.kernels import dispatch

    grid = cloth_grid(16, 16, spacing=0.05, shear=True, bend=True)
    cfg = SimConfig(shape_match=ShapeMatchParams(enabled=True))
    clustered = enable_shape_matching(cloth_grid(16, 16, spacing=0.05,
                                                 shear=True, bend=True))
    ctop, _ = api.init(clustered)
    gtop, _ = api.init(grid)
    assert dispatch.maybe_fast_step(ctop, cfg) is None
    assert dispatch.maybe_fast_step(gtop, cfg) is not None


def test_batched_jellies_match_single():
    """vmapped stepping of B identical jellies == the single-scene step."""
    from softbodyunity_tpu.parallel.batch import batch_state, step_batched

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    single = api.step(top, cfg, state)
    multi = step_batched(top, cfg, batch_state(state, 3))
    assert multi.cluster_quat.shape == (3, host.n_clusters, 4)
    for b in range(3):
        np.testing.assert_allclose(
            np.asarray(multi.x[b]), np.asarray(single.x), atol=1e-6
        )


def _coupled_jelly_scene(solver):
    """Shape-matched jelly ball dropping onto a DYNAMIC rigid ball that
    rests on the plane — exercises the coupled substeps' shape-matching
    slot together with the measured momentum exchange."""
    from softbodyunity_tpu.core.config import CollisionParams

    cfg = SimConfig(
        solver=solver,
        shape_match=ShapeMatchParams(enabled=True, stiffness=0.3),
        springs=SpringParams(k_structural=20.0, k_shear=10.0, k_bend=5.0),
        collision=CollisionParams(enable_plane=True, enable_spheres=True,
                                  friction=0.2),
        global_damping=0.3,
    )
    pos, tris = icosphere_mesh(radius=0.2, subdivisions=1,
                               center=(0.0, 0.7, 0.0))
    host = from_triangle_mesh(
        pos, tris, mass=0.02, springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=0.0,
        sphere_centers=[[0.05, 0.15, 0.0]], sphere_radii=[0.15],
    )
    return enable_shape_matching(host), cfg


@pytest.mark.parametrize("solver,bound", [
    (Solver.SEMI_IMPLICIT_EULER, 1e-6),
    # Verlet/XPBD carry positional contact noise undamped; same bound
    # rationale as tests/test_coupling.py::test_f64_exact_parity_coupled
    (Solver.VERLET, 5e-4),
    (Solver.XPBD, 1e-4),
])
def test_f64_exact_parity_coupled(solver, bound):
    """Coupled device step with shape matching == oracle step_coupled
    (quats threaded) to f64 rounding, through the jelly-on-ball impact."""
    from softbodyunity_tpu.solver.rigid import make_rigid_state

    jax.config.update("jax_enable_x64", True)
    host, cfg = _coupled_jelly_scene(solver)
    top, state = api.init(host, dtype=jnp.float64)
    rigid = make_rigid_state(top, [0.5])
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    rc = np.asarray(host.sphere_centers, np.float64)
    rv = np.zeros_like(rc)
    rom = np.zeros_like(rc)
    rim = np.asarray([2.0])
    q = _identity_quats(host.n_clusters)
    for i in range(40):
        x, v, xp, rc, rv, rom, q = oracle.step_coupled(
            host, cfg, x, v, xp, rc, rv, rim, romega=rom, quats=q)
        state, rigid = api.step_coupled(top, cfg, state, rigid)
        if i == 10:
            # pre-/early-contact: every solver must track tightly here
            assert np.max(np.abs(np.asarray(state.x) - x)) < 1e-6
    assert np.max(np.abs(np.asarray(state.x) - x)) < bound
    assert np.max(np.abs(np.asarray(state.cluster_quat) - q)) < max(
        bound, 1e-6)
    assert np.max(np.abs(np.asarray(rigid.centers) - rc)) < bound


def test_coupled_jelly_rests_on_ball():
    """Behavioral: the jelly squashes onto the dynamic ball, both settle
    finite and above the plane, and the jelly keeps its shape."""
    from softbodyunity_tpu.solver.rigid import make_rigid_state

    host, cfg = _coupled_jelly_scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    rigid = make_rigid_state(top, [0.5])
    x0 = np.asarray(state.x)
    r0 = np.linalg.norm(x0 - x0.mean(0), axis=1).mean()
    for _ in range(150):
        state, rigid = api.step_coupled(top, cfg, state, rigid)
    x = np.asarray(state.x)
    assert np.isfinite(x).all()
    assert np.isfinite(np.asarray(rigid.centers)).all()
    assert x[:, 1].min() > -1e-3
    # ball stays grounded (radius 0.15), jelly keeps its shape memory
    assert abs(float(rigid.centers[0, 1]) - 0.15) < 0.05
    r = np.linalg.norm(x - x.mean(0), axis=1).mean()
    assert r > 0.7 * r0


def test_onehot_mxu_twin_matches_segment_path(monkeypatch):
    """The one-hot matmul formulation == the segment_sum path to f32
    rounding (same math, different reduction order), quats included."""
    from softbodyunity_tpu.solver import shapematch

    host, _ = _scene(Solver.SEMI_IMPLICIT_EULER, cell_size=0.2)
    cfg = SimConfig(shape_match=ShapeMatchParams(enabled=True,
                                                 stiffness=0.7))
    top, state = api.init(host)
    rng = np.random.default_rng(1)
    x = state.x + jnp.asarray(
        rng.normal(0, 0.05, state.x.shape).astype(np.float32))
    q = jnp.asarray(_identity_quats(host.n_clusters), jnp.float32)
    dx1, q1 = shapematch.shape_match_dx(top, cfg, x, q)
    monkeypatch.setattr(shapematch, "ONEHOT_MAX_ELEMS", 0)
    dx2, q2 = shapematch.shape_match_dx(top, cfg, x, q)
    assert host.positions0.shape[0] * host.n_clusters \
        <= 2 ** 24, "scene unexpectedly big"
    np.testing.assert_allclose(np.asarray(dx1), np.asarray(dx2),
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(q1), np.asarray(q2), atol=2e-6)


def test_shape_matching_is_differentiable():
    """grad flows through the rotation extraction + goal pull."""
    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    state = api.ensure_shapematch_state(top, cfg, state)

    def loss(x0):
        from softbodyunity_tpu.solver.step import step_scan

        s = state.replace(x=x0, x_prev=x0)
        out = step_scan(top, cfg, s, cfg.dt, 8)
        return jnp.sum(out.x[:, 1])

    g = jax.grad(loss)(state.x)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.max(jnp.abs(g))) > 0.0


@pytest.mark.slow
def test_jelly_1k_frames_stable():
    """Long-horizon f32 statement: 1000 frames of a dropped jelly ball stay
    finite, resting on the plane, with the shape near rest (no slow
    rotation-extraction drift or energy pumping)."""
    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER, stiffness=0.5)
    top, state = api.init(host)
    for _ in range(1000):
        state = api.step(top, cfg, state)
    x = np.asarray(state.x)
    assert np.isfinite(x).all()
    assert x[:, 1].min() > -1e-3
    # extent stays near the rest extent (jelly didn't melt or explode)
    ext = x.max(axis=0) - x.min(axis=0)
    ext0 = (np.asarray(host.positions0).max(axis=0)
            - np.asarray(host.positions0).min(axis=0))
    assert np.all(ext < 1.3 * ext0) and np.all(ext > 0.6 * ext0)


def test_kron_statics_match_onehot_on_lattice():
    """Raster lattices with spatial cells take the Kronecker-factored
    reduction (solver/shapematch.py shape_match_kron_statics): per-axis
    one-hots + occupied-cell map reproduce the general one-hot path to
    f32 rounding on a voxelized sphere."""
    from softbodyunity_tpu.core.topology import (
        enable_shape_matching, icosphere_mesh, lattice_from_mesh)
    from softbodyunity_tpu.solver import shapematch as sm

    cfg = SimConfig(shape_match=ShapeMatchParams(enabled=True,
                                                 stiffness=0.3))
    pos, tri = icosphere_mesh(radius=0.3, center=(0.0, 0.4, 0.0),
                              subdivisions=1)
    host = lattice_from_mesh(pos, tri, resolution=12, mass=0.05,
                             plane_height=-1.0)
    host = enable_shape_matching(host, cell_size=0.2)
    top, state = api.init(host)
    state = api.ensure_shapematch_state(top, cfg, state)
    kr = sm.shape_match_kron_statics(top)
    assert kr is not None, "lattice + cell clustering must be separable"
    x = state.x + 0.02 * jax.random.normal(jax.random.PRNGKey(1),
                                           state.x.shape)
    dx_ref, q_ref = sm.shape_match_dx(top, cfg, x, state.cluster_quat)
    dx_k, q_k, x0 = sm.shape_match_dx_kron(cfg, kr, jnp.asarray(x.T),
                                           state.cluster_quat)
    assert x0.shape == (3, 1) and bool(jnp.isfinite(x0).all())
    np.testing.assert_allclose(np.asarray(dx_k.T), np.asarray(dx_ref),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(q_k), np.asarray(q_ref),
                               atol=1e-6)


def test_kron_matches_onehot_far_from_origin():
    """The round-4 advisor finding: an UNCENTERED single-pass kron moment
    reduce accumulates O(|x|*r) f32 rounding that the exact real-arithmetic
    recentering cannot remove — quats were off by 2.3e-1 at offset
    (100, 100.4, 100).  The centered two-pass form must agree with the
    one-hot path far from the origin to the same tolerance as at it."""
    from softbodyunity_tpu.core.topology import (
        enable_shape_matching, icosphere_mesh, lattice_from_mesh)
    from softbodyunity_tpu.solver import shapematch as sm

    cfg = SimConfig(shape_match=ShapeMatchParams(enabled=True,
                                                 stiffness=0.3))
    pos, tri = icosphere_mesh(radius=0.3, center=(0.0, 0.4, 0.0),
                              subdivisions=1)
    host = lattice_from_mesh(pos, tri, resolution=12, mass=0.05,
                             plane_height=-1.0)
    host = enable_shape_matching(host, cell_size=0.2)
    top, state = api.init(host)
    state = api.ensure_shapematch_state(top, cfg, state)
    kr = sm.shape_match_kron_statics(top)
    assert kr is not None
    offset = jnp.asarray([100.0, 100.4, 100.0])
    x = (state.x + offset
         + 0.02 * jax.random.normal(jax.random.PRNGKey(1), state.x.shape))
    dx_ref, q_ref = sm.shape_match_dx(top, cfg, x, state.cluster_quat)
    dx_k, q_k, _ = sm.shape_match_dx_kron(cfg, kr, jnp.asarray(x.T),
                                          state.cluster_quat)
    np.testing.assert_allclose(np.asarray(q_k), np.asarray(q_ref),
                               atol=5e-5)
    np.testing.assert_allclose(np.asarray(dx_k.T), np.asarray(dx_ref),
                               atol=5e-5)


def test_kron_statics_decline_non_separable():
    """Explicit per-vertex cluster ids that do not factor per raster axis
    make shape_match_kron_statics return None (the general one-hot path
    keeps serving them) — the verification is exact, never heuristic."""
    from softbodyunity_tpu.core.topology import (
        enable_shape_matching, tet_cube)
    from softbodyunity_tpu.solver import shapematch as sm

    host = tet_cube(6, spacing=0.1, mass=0.05)
    rng = np.random.default_rng(3)
    cids = rng.integers(0, 4, host.positions0.shape[0])
    host = enable_shape_matching(host, cluster_ids=cids)
    top, _ = api.init(host)
    assert sm.shape_match_kron_statics(top) is None


def test_kron_statics_accept_tet_cube_cells():
    """tet_cube carries lattice_shape, so spatial cells on it factor."""
    from softbodyunity_tpu.core.topology import (
        enable_shape_matching, tet_cube)
    from softbodyunity_tpu.solver import shapematch as sm

    host = tet_cube(8, spacing=0.1, mass=0.05)
    host = enable_shape_matching(host, cell_size=0.25)
    top, _ = api.init(host)
    kr = sm.shape_match_kron_statics(top)
    assert kr is not None
    nx, ny, nz = kr["dims"]
    assert (nx, ny, nz) == (8, 8, 8)


@pytest.mark.parametrize("form", ["onehot", "kron"])
def test_cluster_contractions_ask_for_highest(form):
    """Every shape-matching contraction runs at HIGHEST: at HIGH the GPU
    may use TF32, which cost the Kronecker form ~1% of the correction on
    the card (PERF.md)."""
    from softbodyunity_tpu.core.topology import (
        enable_shape_matching, icosphere_mesh, lattice_from_mesh)
    from softbodyunity_tpu.solver import shapematch as sm

    cfg = SimConfig(shape_match=ShapeMatchParams(enabled=True))
    pos, tri = icosphere_mesh(radius=0.3, subdivisions=1)
    host = enable_shape_matching(
        lattice_from_mesh(pos, tri, resolution=8, plane_height=-1.0),
        cell_size=0.2)
    top, state = api.init(host)
    state = api.ensure_shapematch_state(top, cfg, state)
    if form == "onehot":
        fn = lambda x, q: sm.shape_match_dx(top, cfg, x, q)
        args = (state.x, state.cluster_quat)
    else:
        kr = sm.shape_match_kron_statics(top)
        fn = lambda x, q: sm.shape_match_dx_kron(cfg, kr, x.T, q)
        args = (state.x, state.cluster_quat)
    jaxpr = str(jax.make_jaxpr(fn)(*args))
    assert jaxpr.count("dot_general") >= 3
    assert "Precision.HIGH," not in jaxpr and "Precision.HIGH)" not in jaxpr
    assert "precision=None" not in jaxpr
