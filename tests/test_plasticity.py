"""Plastic deformation tests (PlasticityParams: rest-length creep past the
yield strain; oracle/reference.py::plastic_update is the binding
definition).  Rest scale is dynamic state (State.rest_scale) so shapes
stay static under jit/vmap."""

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
    TearParams,
    XPBDParams,
)
from softbodyunity_tpu.core.topology import cloth_grid
from softbodyunity_tpu.oracle import reference as oracle

SOLVERS = [Solver.SEMI_IMPLICIT_EULER, Solver.VERLET, Solver.XPBD]


@pytest.fixture(autouse=True)
def _restore_x64():
    prev = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", prev)


def _scene(solver, yield_strain=0.02, creep=0.25, nx=8, ny=12):
    """A hanging cloth pinned along the top row: gravity strains the
    upper springs past a small yield point, so the cloth creeps longer
    and keeps the stretch — plastic sag."""
    cfg = SimConfig(
        solver=solver,
        springs=SpringParams(k_structural=300.0, k_shear=150.0,
                             k_bend=60.0, damping=0.3),
        xpbd=XPBDParams(compliance_distance=3e-4, compliance_bend=1e-3,
                        n_iterations=4),
        plasticity=PlasticityParams(enabled=True, yield_strain=yield_strain,
                                    creep=creep),
        collision=CollisionParams(enable_plane=True),
        global_damping=0.1,
    )
    host = cloth_grid(
        nx, ny, spacing=0.05, shear=True, bend=True, pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-5.0,
        orientation="xy",
    )
    return host, cfg


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("backend", ["jnp", "stencil"])
def test_f64_exact_parity(solver, backend):
    """Device plasticity == oracle plasticity in f64, including identical
    rest-scale planes (the scale feeds back into the forces, so a single
    divergent edge would compound immediately).  The stencil path carries
    rest scales as per-offset planes; the flat<->plane mapping must
    round-trip every edge exactly."""
    jax.config.update("jax_enable_x64", True)
    host, cfg = _scene(solver)
    cfg = cfg.replace(backend=backend)
    top, state = api.init(host, dtype=jnp.float64)
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    scale_o = np.ones(host.edges.shape[0])
    s = state
    for _ in range(40):
        x, v, xp, scale_o = oracle.step(host, cfg, x, v, xp,
                                        rest_scale=scale_o)
        s = api.step(top, cfg, s)
    assert s.rest_scale is not None
    assert scale_o.max() > 1.0 + 1e-6, "nothing yielded — test is vacuous"
    np.testing.assert_allclose(np.asarray(s.rest_scale), scale_o,
                               rtol=0, atol=1e-9)
    drift = np.max(np.abs(np.asarray(s.x) - x))
    assert drift < 1e-6, f"{solver}: f64 drift {drift:.3e}"


@pytest.mark.parametrize("solver", SOLVERS)
def test_plastic_sag_is_permanent(solver):
    """The plastic cloth creeps longer than an elastic copy under the same
    load, and the rest scale stays within the configured clamp."""
    host, cfg = _scene(solver)
    top, state = api.init(host)
    s = state
    for _ in range(80):
        s = api.step(top, cfg, s)
    assert np.isfinite(np.asarray(s.x)).all()
    scale = np.asarray(s.rest_scale)
    assert scale.max() > 1.01, "no plastic flow"
    assert scale.max() <= cfg.plasticity.max_scale + 1e-6
    assert scale.min() >= cfg.plasticity.min_scale - 1e-6
    cfg_el = cfg.replace(plasticity=PlasticityParams(enabled=False))
    s_el = api.init(host)[1]
    for _ in range(80):
        s_el = api.step(top, cfg_el, s_el)
    assert (np.asarray(s.x)[:, 1].min()
            < np.asarray(s_el.x)[:, 1].min() - 0.005)


def test_huge_yield_identical_to_disabled():
    """With an unreachable yield strain the plastic path must reproduce
    the elastic trajectory exactly (scale stays all-ones and scaled rest
    lengths are bit-identical to unscaled)."""
    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER, yield_strain=1e9)
    top, state = api.init(host)
    s_p = state
    s_e = state
    cfg_e = cfg.replace(plasticity=PlasticityParams(enabled=False),
                        backend="jnp")
    cfg_p = cfg.replace(backend="jnp")
    for _ in range(30):
        s_p = api.step(top, cfg_p, s_p)
        s_e = api.step(top, cfg_e, s_e)
    # all-ones scale: same physics; tolerance because the elastic path uses
    # the banded formulation (different f32 op order than gather — same
    # rationale as test_tearing.test_huge_strain_limit_identical_to_disabled).
    # Exactness vs the oracle is the f64 test above.
    np.testing.assert_allclose(np.asarray(s_p.x), np.asarray(s_e.x),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(s_p.rest_scale),
                                  np.ones(host.edges.shape[0], np.float32))


@pytest.mark.parametrize("solver", SOLVERS)
def test_plastic_plus_tearing_f64_parity(solver):
    """Plasticity and tearing compose: plastic flow first, then the tear
    check against the RESCALED rest length — mask and scale sequences
    must match the oracle exactly."""
    jax.config.update("jax_enable_x64", True)
    host, cfg = _scene(solver, yield_strain=0.02, creep=0.1)
    cfg = cfg.replace(tear=TearParams(enabled=True, strain_limit=0.12))
    top, state = api.init(host, dtype=jnp.float64)
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    alive_o = np.ones(host.edges.shape[0])
    scale_o = np.ones(host.edges.shape[0])
    s = state
    for _ in range(50):
        x, v, xp, alive_o, scale_o = oracle.step(
            host, cfg, x, v, xp, alive=alive_o, rest_scale=scale_o
        )
        s = api.step(top, cfg, s)
    np.testing.assert_array_equal(np.asarray(s.edge_alive), alive_o)
    np.testing.assert_allclose(np.asarray(s.rest_scale), scale_o,
                               rtol=0, atol=1e-9)
    assert scale_o.max() > 1.0 + 1e-6, "nothing yielded"


# plastic grids beyond test_f64_exact_parity's scene: with tearing at the
# stronger creep, and taller grids (multiples of 8 and 16 rows) with and
# without tearing, held to the oracle on the stencil path
SERVED = ([(sv, 12, True) for sv in SOLVERS]
          + [(sv, 32 if sv == Solver.XPBD else 24, tear)
             for sv in SOLVERS for tear in (False, True)])


@pytest.mark.parametrize("solver,ny,with_tear", SERVED)
def test_f64_parity_served_grids(f64_oracle_run, solver, ny, with_tear):
    from softbodyunity_tpu.kernels import dispatch

    host, cfg = _scene(solver, nx=8, ny=ny)
    if with_tear:
        cfg = cfg.replace(tear=TearParams(enabled=True, strain_limit=0.12))
    top, _ = api.init(host)
    assert dispatch.maybe_fast_step(top, cfg) is not None
    s, x, extras = f64_oracle_run(host, cfg, 4)
    np.testing.assert_allclose(np.asarray(s.rest_scale),
                               extras["rest_scale"], rtol=0, atol=1e-9)
    assert extras["rest_scale"].max() > 1.001, "no flow"
    if with_tear:
        np.testing.assert_array_equal(np.asarray(s.edge_alive),
                                      extras["alive"])
    drift = np.max(np.abs(np.asarray(s.x) - x))
    assert drift < 1e-8, f"{solver} ny={ny}: f64 drift {drift:.3e}"


def test_dispatch_routes_plasticity():
    """Plastic grid scenes run on the stencil path (rest scales as
    per-offset planes); irregular meshes take the exact jnp gather
    path."""
    from softbodyunity_tpu.core.topology import from_triangle_mesh
    from softbodyunity_tpu.kernels import dispatch

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, _ = api.init(host)
    fn = dispatch.maybe_fast_step(top, cfg)
    assert fn is not None
    assert fn.__module__ == "softbodyunity_tpu.kernels.stencil"
    # irregular mesh: no grid planes -> jnp gather path
    verts = np.asarray(host.positions0)
    tris = np.asarray(host.triangles)
    ihost = from_triangle_mesh(verts, tris, springs=cfg.springs,
                               xpbd=cfg.xpbd)
    itop, _ = api.init(ihost)
    assert dispatch.maybe_fast_step(itop, cfg) is None


def test_batched_plasticity_consistency():
    """vmapped plastic scenes == the single-scene trajectory per scene."""
    from softbodyunity_tpu.parallel import batch

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    states = batch.batch_state(state, 3)
    for _ in range(25):
        states = batch.step_batched(top, cfg, states)
        state = api.step(top, cfg, state)
    assert states.rest_scale is not None
    for b in range(3):
        # vmap layouts reorder f32 ops slightly (~5e-6 after 400 substeps)
        np.testing.assert_allclose(
            np.asarray(states.x[b]), np.asarray(state.x), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(states.rest_scale[b]), np.asarray(state.rest_scale),
            atol=1e-5,
        )


def test_checkpoint_roundtrip_with_plasticity(tmp_path):
    from softbodyunity_tpu.utils import checkpoint

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    for _ in range(40):
        state = api.step(top, cfg, state)
    p = str(tmp_path / "plastic.npz")
    checkpoint.save_npz(p, state)
    restored = checkpoint.load_npz(p, like=state)
    np.testing.assert_array_equal(np.asarray(restored.rest_scale),
                                  np.asarray(state.rest_scale))
    a = api.step(top, cfg, state)
    b = api.step(top, cfg, restored)
    np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
    np.testing.assert_array_equal(np.asarray(a.rest_scale),
                                  np.asarray(b.rest_scale))


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("with_tear", [False, True])
def test_halo_plasticity_matches_single_device(solver, with_tear):
    """Multi-chip plasticity: row-sharded rest-scale planes (exchanged
    with the state each substep, updated with one extra post-substep
    exchange, optionally composed with tear liveness planes) equal the
    single-device stencil path — identical scale planes included."""
    from jax.sharding import Mesh
    from softbodyunity_tpu.kernels.stencil import make_stencil_step
    from softbodyunity_tpu.parallel import halo

    host, cfg = _scene(solver, nx=12, ny=16)
    if with_tear:
        cfg = cfg.replace(tear=TearParams(enabled=True, strain_limit=0.12))
    top, state = api.init(host)
    state = api.ensure_tear_state(top, cfg, state)
    state = api.ensure_plastic_state(top, cfg, state)
    mesh = Mesh(np.array(jax.devices()[:4]), (halo.ROWS_AXIS,))
    shard_planes, unshard_planes = halo.tear_plane_shard_maps(top, cfg, mesh)
    scale3 = shard_planes(state.rest_scale)
    alive3 = shard_planes(state.edge_alive) if with_tear else None
    if solver == Solver.SEMI_IMPLICIT_EULER:
        make = halo.make_halo_step
    elif solver == Solver.VERLET:
        make = halo.make_halo_verlet_step
    else:
        make = halo.make_halo_xpbd_step
    sharded = jax.jit(make(top, cfg, mesh), static_argnums=(5,))
    x3, v3, im3, ph = halo.shard_grid_state(top, state, mesh)
    second = v3 if solver != Solver.VERLET else x3  # verlet carries (x, xp)
    out = sharded(x3, second, im3, ph, cfg.dt, 48, alive3=alive3,
                  scale3=scale3)
    got = halo.unshard_to_state(out[0], out[1], cfg.dt)
    got_scale = unshard_planes(out[-1])
    ref = jax.jit(lambda t, s: make_stencil_step(t, cfg)(s, cfg.dt, 48))
    want = ref(top, state)
    np.testing.assert_allclose(
        np.asarray(got_scale), np.asarray(want.rest_scale), atol=1e-6
    )
    assert float(np.asarray(want.rest_scale).max()) > 1.001, "no flow"
    if with_tear:
        np.testing.assert_array_equal(
            np.asarray(unshard_planes(out[2])), np.asarray(want.edge_alive)
        )
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(want.x), atol=2e-5
    )
