"""Mesh (SDF) collider tests.

BASELINE.json:5 mandates plane/sphere resolve; arbitrary static meshes are
the Unity MeshCollider analogue, implemented as baked signed-distance grids
(core/sdf.py) sampled trilinearly (oracle/reference.py _sdf_sample_grad is
the binding semantics; solver/collide.py mirrors it on device).  Every
device path (general jnp, stencil, XPBD delta-form) must match the oracle
exactly in f64 and keep vertices outside the mesh in f32.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbodyunity_tpu import api
from softbodyunity_tpu.core.config import CollisionParams, SimConfig, Solver
from softbodyunity_tpu.core.sdf import sdf_from_mesh, sdf_from_sphere
from softbodyunity_tpu.core.topology import add_colliders, cloth_grid
from softbodyunity_tpu.oracle import reference as oracle


@pytest.fixture(autouse=True)
def _restore_x64():
    prev = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", prev)


def _cube_mesh(half=0.25, center=(0.0, 0.0, 0.0)):
    """Watertight box center +- half (scalar or per-axis): 8 vertices, 12
    triangles (winding doesn't matter for parity sign)."""
    hx, hy, hz = np.broadcast_to(np.asarray(half, np.float64), (3,))
    v = np.asarray(center, np.float64) + np.array(
        [[x, y, z] for x in (-hx, hx) for y in (-hy, hy) for z in (-hz, hz)],
        np.float64)
    f = np.array([
        [0, 1, 3], [0, 3, 2],      # x = -half
        [4, 6, 7], [4, 7, 5],      # x = +half
        [0, 4, 5], [0, 5, 1],      # y = -half
        [2, 3, 7], [2, 7, 6],      # y = +half
        [0, 2, 6], [0, 6, 4],      # z = -half
        [1, 5, 7], [1, 7, 3],      # z = +half
    ])
    return v, f


def test_sdf_from_mesh_cube():
    """Baking a cube mesh gives the exact cube SDF away from edges: negative
    inside, positive outside, |phi| = axis distance to the nearest face."""
    v, f = _cube_mesh(0.25)
    # pad far enough that the 0.4-distance query below is in-grid (outside
    # the grid the clamped border value would be returned instead)
    grid, origin, h = sdf_from_mesh(v, f, resolution=16, padding=0.2)
    q = np.array([
        [0.0, 0.0, 0.0],        # center: -0.25
        [0.2, 0.0, 0.0],        # inside near +x face: -0.05
        [0.4, 0.0, 0.0],        # outside +x face: +0.15
        [0.0, -0.3, 0.1],       # outside -y face: +0.05
    ])
    want = np.array([-0.25, -0.05, 0.15, 0.05])
    phi, grad = oracle._sdf_sample_grad(grid, origin, np.float64(h), q)
    # trilinear kink error at cell scale; h ~ 0.033
    np.testing.assert_allclose(phi, want, atol=2.5 * h)
    # outward gradient outside the +x face points along +x
    gn = grad[2] / np.linalg.norm(grad[2])
    assert gn[0] > 0.95


def test_sdf_from_mesh_degenerate_triangles():
    """Zero-area triangles (duplicated vertices, e.g. UV-sphere pole fans)
    must not poison the distance field (regression: they once claimed
    'interior at distance 0' for every query point)."""
    v, f = _cube_mesh(0.25)
    v = np.concatenate([v, v[:1], v[:1]])          # duplicated vertex
    f = np.concatenate([f, [[0, 8, 9]]])           # exactly-degenerate tri
    grid, origin, h = sdf_from_mesh(v, f, resolution=12)
    phi, _ = oracle._sdf_sample_grad(
        grid, origin, np.float64(h), np.array([[0.0, 0.0, 0.0]])
    )
    assert phi[0] < -0.2


def _scene(solver, *, res=24, origin_y=0.32, nx=12, ny=12, shape="sphere"):
    """Cloth falling onto an SDF collider (plane far below so contact is
    SDF-driven).  ``shape="sphere"``: analytic-baked sphere radius 0.3 at
    y=-0.15 (contact-rich; the frictionless projection solvers slide off it
    eventually — use for short-horizon parity).  ``shape="table"``: a baked
    wide flat-topped box mesh, top face at y=0 (stable rest for every
    solver — use for long-horizon settle invariants)."""
    cfg = SimConfig(
        solver=solver,
        collision=CollisionParams(
            enable_plane=True, enable_sdf=True,
            restitution=0.1, friction=0.3,
        ),
        global_damping=0.3,
    )
    host = cloth_grid(
        nx, ny, spacing=0.05, shear=True, bend=True, pinned=(),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-2.0,
        origin=(-0.28, origin_y, -0.28), orientation="xz",
    )
    if shape == "sphere":
        grid, origin, h = sdf_from_sphere([0.0, -0.15, 0.0], 0.3,
                                          resolution=res)
    else:
        v, f = _cube_mesh((0.55, 0.2, 0.55), center=(0.0, -0.2, 0.0))
        grid, origin, h = sdf_from_mesh(v, f, resolution=res)
    host = add_colliders(host, sdf_grids=grid, sdf_origins=[origin],
                         sdf_spacings=[h])
    return host, cfg


SOLVERS = [Solver.SEMI_IMPLICIT_EULER, Solver.VERLET, Solver.XPBD]


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
    """Both device formulations implement exactly the oracle SDF sampling
    and resolve semantics (f64; bound = summation-reorder noise under
    contact, as for the other colliders)."""
    host, cfg = _scene(solver)
    cfg = cfg.replace(backend=backend)
    got, want = _run_pair(host, cfg, n_steps=40, dtype=jnp.float64)
    drift = np.max(np.abs(got - want))
    bound = 3e-5 if solver == Solver.XPBD else 1e-6
    assert drift < bound, f"{solver} {backend}: f64 drift {drift:.3e}"


@pytest.mark.parametrize("solver", SOLVERS)
def test_no_penetration_after_settle(solver):
    """f32 long-horizon contact invariant: after dropping onto a baked
    flat-topped mesh the cloth rests on it (the projection-only solvers
    slide off a small frictionless sphere — correct physics, wrong scene
    for a settle test) and phi >= -(f32 contact noise) for every vertex."""
    host, cfg = _scene(solver, res=32, shape="table")
    top, state = api.init(host)
    for _ in range(150):
        state = api.step(top, cfg, state)
    x = np.asarray(state.x, np.float64)
    assert np.isfinite(x).all()
    phi, _ = oracle._sdf_sample_grad(
        host.sdf_grids[0], host.sdf_origins[0], host.sdf_spacings[0], x
    )
    # the contact surface IS the trilinear zero level set, so the only
    # slack needed is f32 resolve noise
    assert phi.min() >= -1e-3, f"penetration {phi.min():.2e}"
    # and the cloth is actually resting on the table top (y=0), not fallen
    # through to the plane at y=-2
    assert x[:, 1].max() > -0.05


def test_sdf_sphere_matches_analytic_sphere():
    """Draping on the SDF bake of a sphere lands within the grid's
    discretization error of draping on the analytic sphere collider —
    the two formulations describe the same physics."""
    host_sdf, cfg_sdf = _scene(Solver.SEMI_IMPLICIT_EULER, res=48)
    cfg_sph = cfg_sdf.replace(
        collision=dataclasses.replace(
            cfg_sdf.collision, enable_sdf=False, enable_spheres=True
        )
    )
    host_sph = cloth_grid(
        12, 12, spacing=0.05, shear=True, bend=True, pinned=(),
        springs=cfg_sph.springs, xpbd=cfg_sph.xpbd, plane_height=-2.0,
        origin=(-0.28, 0.32, -0.28), orientation="xz",
        sphere_centers=[[0.0, -0.15, 0.0]], sphere_radii=[0.3],
    )
    outs = []
    for host, cfg in ((host_sdf, cfg_sdf), (host_sph, cfg_sph)):
        top, state = api.init(host)
        for _ in range(120):
            state = api.step(top, cfg, state)
        outs.append(np.asarray(state.x))
    # res=48 => spacing ~ 0.0128; trilinear surface error ~ h^2/(2R) plus
    # contact-chaos amplification over 120 frames
    assert np.abs(outs[0] - outs[1]).max() < 0.02


def test_move_sdf_no_recompile():
    """Animated SDF placement (sdf_origins) is array data: moving it
    between frames must reuse the compiled executable."""
    from softbodyunity_tpu.solver import step as step_mod

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    fn = jax.jit(lambda t, s: step_mod.step_scan(t, cfg, s, cfg.dt, 4))
    for i in range(4):
        top = api.move_colliders(
            top, sdf_origins=np.asarray(host.sdf_origins)
            + np.array([[0.01 * i, 0.0, 0.0]])
        )
        state = fn(top, state)
    assert np.isfinite(np.asarray(state.x)).all()
    assert fn._cache_size() == 1, "moving the SDF must not retrace"


def test_batched_sdf_consistency():
    """vmap over B identical SDF scenes == the single scene; per-scene
    sdf_origins via step_batched_colliders shift each scene's contact."""
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
    # heterogeneous placement: scene 2's sphere sits far away -> it falls
    origins = np.stack([
        np.asarray(host.sdf_origins),
        np.asarray(host.sdf_origins),
        np.asarray(host.sdf_origins) + np.array([[10.0, 0.0, 0.0]]),
    ])
    states = batch.batch_state(state, 3)
    for _ in range(60):
        states = batch.step_batched_colliders(
            top, cfg, states, sdf_origins=origins
        )
    x = np.asarray(states.x)
    assert x[0, :, 1].max() > 0.0          # resting on the sphere
    np.testing.assert_array_equal(x[0], x[1])
    assert x[2, :, 1].max() < x[0, :, 1].max() - 0.05  # fell past it


def test_contact_impulses_report_sdf_support():
    """Coupling surface: a cloth resting on the SDF sphere reports an
    upward support impulse for that collider."""
    from softbodyunity_tpu.utils.profiling import contact_impulses

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    for _ in range(120):
        state = api.step(top, cfg, state)
    imp = contact_impulses(top, cfg, state)
    assert "sdfs" in imp and imp["sdfs"].shape == (1, 3)
    assert np.isfinite(np.asarray(imp["sdfs"])).all()
    assert float(np.asarray(imp["sdfs"])[0, 1]) > 0.0


def test_halo_lattice_gate_rejects_sdf():
    """The halo-sharded LATTICE paths reject SDF colliders loudly (the
    cloth paths accept them — equality test in tests/test_halo.py)."""
    from softbodyunity_tpu.parallel.halo import _check_halo_colliders

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, _ = api.init(host)
    with pytest.raises(NotImplementedError, match="sdf"):
        _check_halo_colliders(top, cfg, sdf="none")
    _check_halo_colliders(top, cfg)  # cloth gate accepts


def test_sdf_bake_warns_on_thin_features():
    """A mesh thinner than ~2 voxels can't register 'inside' after
    trilinear sampling (cloth tunnels with no error downstream) — the
    bake must warn and suggest a resolution."""
    import warnings as _w
    from softbodyunity_tpu.core.sdf import sdf_from_mesh

    # 10 x 0.4 x 10 slab at resolution 24 -> spacing ~0.43 > thickness/2
    v = np.array([[x, y, z] for x in (-5.0, 5.0) for y in (-1.0, -0.6)
                  for z in (-5.0, 5.0)])
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    with pytest.warns(UserWarning, match="tunnel"):
        sdf_from_mesh(v, f, resolution=24)
    with _w.catch_warnings():
        _w.simplefilter("error")        # well-resolved bake: no warning
        sdf_from_mesh(v, f, resolution=64)
