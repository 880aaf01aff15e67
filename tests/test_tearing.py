"""Cloth tearing tests (TearParams: permanent strain-based edge failure;
oracle/reference.py tear_update is the binding definition).  Liveness is
dynamic state (State.edge_alive), so shapes stay static under jit/vmap."""

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


def _scene(solver, strain_limit=0.03, nx=8, ny=12):
    """A hanging cloth pinned along the whole top row: gravity stretches the
    top-row-adjacent structural springs past a tight strain limit, so the
    cloth tears near the pins and drops — the classic Unity tearing demo."""
    cfg = SimConfig(
        solver=solver,
        springs=SpringParams(k_structural=300.0, k_shear=150.0,
                             k_bend=60.0, damping=0.3),
        xpbd=XPBDParams(compliance_distance=3e-4, compliance_bend=1e-3,
                        n_iterations=4),
        tear=TearParams(enabled=True, strain_limit=strain_limit),
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
    """Device tearing == oracle tearing in f64, including identical tear
    masks (a single different edge death would diverge immediately).  The
    stencil path carries liveness as per-offset planes; the flat<->plane
    mapping must round-trip every edge exactly."""
    jax.config.update("jax_enable_x64", True)
    host, cfg = _scene(solver)
    cfg = cfg.replace(backend=backend)
    top, state = api.init(host, dtype=jnp.float64)
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    alive_o = np.ones(host.edges.shape[0])
    s = state
    for _ in range(40):
        x, v, xp, alive_o = oracle.step(host, cfg, x, v, xp, alive=alive_o)
        s = api.step(top, cfg, s)
    assert s.edge_alive is not None
    np.testing.assert_array_equal(np.asarray(s.edge_alive), alive_o)
    assert alive_o.min() == 0.0, "scene never tore — test is vacuous"
    drift = np.max(np.abs(np.asarray(s.x) - x))
    assert drift < 1e-6, f"{solver}: f64 drift {drift:.3e}"


@pytest.mark.parametrize("solver", SOLVERS)
def test_tearing_physical(solver):
    """Torn cloth falls: liveness is monotone non-increasing, some edges
    die, the free part drops further than an untearable copy, and the
    pinned row stays bit-frozen."""
    host, cfg = _scene(solver)
    top, state = api.init(host)
    x0 = np.asarray(state.x)
    alive_hist = []
    s = state
    for _ in range(60):
        s = api.step(top, cfg, s)
        alive_hist.append(float(jnp.sum(s.edge_alive)))
    assert np.isfinite(np.asarray(s.x)).all()
    # monotone non-increasing liveness (permanent failure)
    assert all(b <= a + 1e-9 for a, b in zip(alive_hist, alive_hist[1:]))
    assert alive_hist[-1] < alive_hist[0], "nothing tore"
    # untearable copy hangs; torn cloth falls below it
    cfg_no = cfg.replace(tear=TearParams(enabled=False))
    s_no = api.init(host)[1]
    for _ in range(60):
        s_no = api.step(top, cfg_no, s_no)
    assert (np.asarray(s.x)[:, 1].min()
            < np.asarray(s_no.x)[:, 1].min() - 0.05)
    pinned = np.asarray(host.inv_mass) == 0.0
    np.testing.assert_array_equal(np.asarray(s.x)[pinned], x0[pinned])


def test_huge_strain_limit_identical_to_disabled():
    """With an unreachable strain limit the tearing path must reproduce the
    no-tearing trajectory exactly (the alive mask is all-ones, and masked
    forces/counts are bit-identical to unmasked ones)."""
    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER, strain_limit=1e9)
    top, state = api.init(host)
    s_tear = state
    s_ref = state
    cfg_ref = cfg.replace(tear=TearParams(enabled=False), backend="jnp")
    cfg_tear = cfg.replace(backend="jnp")
    for _ in range(30):
        s_tear = api.step(top, cfg_tear, s_tear)
        s_ref = api.step(top, cfg_ref, s_ref)
    # all-ones mask: same physics; tolerance because the no-tear path uses
    # the banded formulation (different f32 op order than gather; ~5e-7
    # after 480 substeps).  Exactness vs the oracle is the f64 test above.
    np.testing.assert_allclose(
        np.asarray(s_tear.x), np.asarray(s_ref.x), atol=1e-5
    )
    assert float(jnp.min(s_tear.edge_alive)) == 1.0


def test_dispatch_routes_tearing():
    """Grid tearing scenes take the stencil path (liveness planes);
    non-grid tearing falls to the jnp gather path."""
    from softbodyunity_tpu.core.topology import tet_cube
    from softbodyunity_tpu.kernels import dispatch

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, _ = api.init(host)
    assert dispatch.maybe_fast_step(top, cfg) is not None
    cube = tet_cube(4, spacing=0.05, springs=cfg.springs, xpbd=cfg.xpbd)
    ctop, _ = api.init(cube)
    assert dispatch.maybe_fast_step(ctop, cfg) is None


def test_batched_tearing_consistency():
    """vmapped tearing == per-scene tearing (each scene carries its own
    liveness plane [B, E])."""
    from softbodyunity_tpu.parallel import batch

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    states = batch.batch_state(state, 3)
    states = batch.step_batched(top, cfg, states)
    states = batch.step_batched(top, cfg, states)
    single = api.step(top, cfg, api.step(top, cfg, state))
    # scenes are bit-identical to each other; vs single allow vmap-lowering
    # rounding (same tolerance stance as tests/test_batch.py)
    np.testing.assert_array_equal(
        np.asarray(states.x[0]), np.asarray(states.x[1])
    )
    for b in range(3):
        np.testing.assert_allclose(
            np.asarray(states.x[b]), np.asarray(single.x), atol=1e-8
        )
        np.testing.assert_array_equal(
            np.asarray(states.edge_alive[b]), np.asarray(single.edge_alive)
        )


def test_checkpoint_roundtrip_with_tearing():
    """edge_alive is part of the State pytree: npz save/restore resumes the
    torn trajectory bit-identically."""
    from softbodyunity_tpu.utils import checkpoint

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    for _ in range(30):
        state = api.step(top, cfg, state)
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "state.npz")
        checkpoint.save_state(p, state)
        restored = checkpoint.load_state(p, state)
    a = api.step(top, cfg, state)
    b = api.step(top, cfg, restored)
    np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
    np.testing.assert_array_equal(
        np.asarray(a.edge_alive), np.asarray(b.edge_alive)
    )


def test_halo_lattice_rejects_tearing():
    """Cloth halo paths shard the liveness planes; the volumetric lattice
    paths still reject tearing loudly (per-edge masks don't fit the banded
    slab decomposition yet)."""
    from jax.sharding import Mesh
    from softbodyunity_tpu.core.topology import tet_cube
    from softbodyunity_tpu.parallel import halo

    cfg = _scene(Solver.SEMI_IMPLICIT_EULER)[1]
    cube = tet_cube(4, spacing=0.05, springs=cfg.springs, xpbd=cfg.xpbd)
    ctop, _ = api.init(cube)
    mesh = Mesh(np.array(jax.devices()[:2]), (halo.ROWS_AXIS,))
    with pytest.raises(NotImplementedError):
        halo.make_halo_lattice_step(ctop, cfg, mesh)


# taller grids (heights that are multiples of 8 and 16 rows), held to the
# oracle on the stencil path with identical tear masks
@pytest.mark.parametrize("solver,ny", [(Solver.SEMI_IMPLICIT_EULER, 24),
                                       (Solver.VERLET, 24),
                                       (Solver.XPBD, 32)])
def test_f64_parity_tall_grids(f64_oracle_run, solver, ny):
    host, cfg = _scene(solver, nx=8, ny=ny)
    top, _ = api.init(host)
    from softbodyunity_tpu.kernels import dispatch

    assert dispatch.maybe_fast_step(top, cfg) is not None
    s, x, extras = f64_oracle_run(host, cfg, 4)
    np.testing.assert_array_equal(np.asarray(s.edge_alive), extras["alive"])
    assert extras["alive"].min() == 0.0, "nothing tore"
    drift = np.max(np.abs(np.asarray(s.x) - x))
    assert drift < 1e-8, f"{solver} ny={ny}: f64 drift {drift:.3e}"


def test_diagnostics_reports_torn_edges():
    """diagnostics() counts torn edges and excludes them from the spring
    energy / residual (a torn stretched cloth would otherwise report huge
    phantom elastic energy)."""
    from softbodyunity_tpu.utils.profiling import diagnostics

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    for _ in range(60):
        state = api.step(top, cfg, state)
    d = diagnostics(top, cfg, state)
    torn = int(host.edges.shape[0] - float(jnp.sum(state.edge_alive)))
    assert d["torn_edges"] == torn > 0
    # residual over LIVE edges only: the free-hanging remnant is near rest
    assert d["max_edge_residual"] < 0.05 * 2  # bend rest is 2*spacing


@pytest.mark.parametrize("solver", SOLVERS)
def test_wind_plus_tearing_f64_parity(solver):
    """Feature composition: a windy scene that tears must still match the
    oracle exactly (wind enters the force/predict stage, tearing masks the
    springs — both per-substep, order defined by the oracle)."""
    from softbodyunity_tpu.core.config import WindParams

    jax.config.update("jax_enable_x64", True)
    host, cfg = _scene(solver, strain_limit=0.04)
    cfg = cfg.replace(
        wind=WindParams(velocity=(2.5, 0.0, 1.0), drag=0.3, lift=0.6),
        backend="stencil",
    )
    top, state = api.init(host, dtype=jnp.float64)
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    alive_o = np.ones(host.edges.shape[0])
    s = state
    for _ in range(40):
        x, v, xp, alive_o = oracle.step(host, cfg, x, v, xp, alive=alive_o)
        s = api.step(top, cfg, s)
    np.testing.assert_array_equal(np.asarray(s.edge_alive), alive_o)
    drift = np.max(np.abs(np.asarray(s.x) - x))
    assert drift < 1e-6, f"{solver}: wind+tear f64 drift {drift:.3e}"


@pytest.mark.parametrize("solver", SOLVERS)
def test_halo_tearing_matches_single_device(solver):
    """Multi-chip tearing: row-sharded liveness planes (exchanged with the
    state each substep, torn with one extra post-substep exchange) equal
    the single-device stencil path — identical tear masks included."""
    from jax.sharding import Mesh
    from softbodyunity_tpu.kernels.stencil import make_stencil_step
    from softbodyunity_tpu.parallel import halo

    host, cfg = _scene(solver, nx=12, ny=16)
    top, state = api.init(host)
    state = api.ensure_tear_state(top, cfg, state)
    mesh = Mesh(np.array(jax.devices()[:4]), (halo.ROWS_AXIS,))
    shard_alive, unshard_alive = halo.tear_plane_shard_maps(top, cfg, mesh)
    alive3 = shard_alive(state.edge_alive)
    if solver == Solver.SEMI_IMPLICIT_EULER:
        make = halo.make_halo_step
    elif solver == Solver.VERLET:
        make = halo.make_halo_verlet_step
    else:
        make = halo.make_halo_xpbd_step
    sharded = jax.jit(make(top, cfg, mesh), static_argnums=(5,))
    x3, v3, im3, ph = halo.shard_grid_state(top, state, mesh)
    first = x3
    second = v3 if solver != Solver.VERLET else x3  # verlet carries (x, xp)
    xf, vf, af = sharded(first, second, im3, ph, cfg.dt, 48, alive3=alive3)
    got = halo.unshard_to_state(xf, vf, cfg.dt)
    got_alive = unshard_alive(af)
    ref = jax.jit(lambda t, s: make_stencil_step(t, cfg)(s, cfg.dt, 48))
    want = ref(top, state)
    np.testing.assert_array_equal(
        np.asarray(got_alive), np.asarray(want.edge_alive)
    )
    assert float(np.asarray(want.edge_alive).min()) == 0.0, "nothing tore"
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(want.x), atol=2e-5
    )


def test_halo_tearing_with_spheres_matches_single_device():
    """Pins the positional-varargs ordering in the halo makers (sphere
    geometry before liveness planes): spheres + tearing together must still
    match the single-device stencil path with identical masks."""
    from jax.sharding import Mesh
    from softbodyunity_tpu.kernels.stencil import make_stencil_step
    from softbodyunity_tpu.parallel import halo

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER, nx=12, ny=16)
    cfg = cfg.replace(
        collision=CollisionParams(enable_plane=True, enable_spheres=True)
    )
    host = cloth_grid(
        12, 16, spacing=0.05, shear=True, bend=True, pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-5.0,
        sphere_centers=np.array([[0.3, -0.4, 0.05]]),
        sphere_radii=np.array([0.15]),
        orientation="xy",
    )
    top, state = api.init(host)
    state = api.ensure_tear_state(top, cfg, state)
    mesh = Mesh(np.array(jax.devices()[:4]), (halo.ROWS_AXIS,))
    shard_alive, unshard_alive = halo.tear_plane_shard_maps(top, cfg, mesh)
    sharded = jax.jit(halo.make_halo_step(top, cfg, mesh), static_argnums=(5,))
    x3, v3, im3, ph = halo.shard_grid_state(top, state, mesh)
    xf, vf, af = sharded(
        x3, v3, im3, ph, cfg.dt, 48,
        sphere_centers=top.sphere_centers, sphere_radii=top.sphere_radii,
        alive3=shard_alive(state.edge_alive),
    )
    got = halo.unshard_to_state(xf, vf, cfg.dt)
    ref = jax.jit(lambda t, s: make_stencil_step(t, cfg)(s, cfg.dt, 48))
    want = ref(top, state)
    np.testing.assert_array_equal(
        np.asarray(unshard_alive(af)), np.asarray(want.edge_alive)
    )
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(want.x), atol=2e-5
    )


def test_batched_collider_steppers_populate_tear_state():
    """step_batched_colliders / step_batched_hetero must lazily populate
    edge_alive exactly like step_batched — a tearing config through these
    entry points previously tore nothing, silently."""
    from softbodyunity_tpu.parallel import batch

    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER)
    top, state = api.init(host)
    states = batch.batch_state(state, 2)
    for _ in range(60):
        states = batch.step_batched_colliders(
            top, cfg, states, plane_height=np.array([-5.0, -5.0])
        )
    assert states.edge_alive is not None
    assert float(jnp.sum(states.edge_alive[0])) < host.edges.shape[0], \
        "nothing tore through step_batched_colliders"
    states2 = batch.batch_state(state, 2)
    for _ in range(60):
        states2 = batch.step_batched_hetero(
            top, cfg, states2,
            np.zeros((2, 1, 3)), np.full((2, 1), 1e-6),
        )
    assert states2.edge_alive is not None
    assert float(jnp.sum(states2.edge_alive[0])) < host.edges.shape[0]
