"""Voxel soft-bodies (core/topology.py::lattice_from_mesh): any closed
surface mesh becomes a banded tet lattice that runs the gather-free
banded path — the Unity proxy-lattice workflow.

The design invariant under test: ghost vertices keep the full raster
order, so the edge AND tet delta groups have zero residual, exactly like
a cube."""

import numpy as np
import pytest

import jax

from softbodyunity_tpu import api
from softbodyunity_tpu.core.config import (
    CollisionParams,
    SimConfig,
    Solver,
    SpringParams,
)
from softbodyunity_tpu.core.embed import embed_mesh, skin
from softbodyunity_tpu.core.topology import (
    _signed_volume,
    icosphere_mesh,
    lattice_from_mesh,
)


def _sphere_scene(resolution=8):
    cfg = SimConfig(
        springs=SpringParams(k_structural=400.0, damping=0.4),
        collision=CollisionParams(enable_plane=True, friction=0.3),
        volume_stiffness=0.5,
        global_damping=0.5,
    )
    pos, tri = icosphere_mesh(radius=0.3, center=(0.0, 0.5, 0.0),
                              subdivisions=2)
    host = lattice_from_mesh(
        pos, tri, resolution=resolution, mass=0.02, springs=cfg.springs,
        xpbd=cfg.xpbd, plane_height=0.0,
    )
    return host, cfg, pos, tri


def test_voxelized_sphere_is_fully_banded():
    host, cfg, _pos, _tri = _sphere_scene()
    assert host.tets.shape[0] > 0
    assert (host.rest_volume > 0).all()
    top, _state = api.init(host)
    assert top.offset_groups.n_residual == 0
    assert top.tet_groups.n_residual == 0


def test_surface_shell_watertight_and_outward():
    """The emitted boundary triangles form a closed, outward-wound shell:
    every undirected edge is shared by exactly two triangles with opposite
    orientation, and the enclosed volume is positive ~= voxel volume."""
    host, _cfg, _pos, _tri = _sphere_scene()
    tris = np.asarray(host.triangles, np.int64)
    directed = {}
    for t in tris:
        for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            assert e not in directed, f"duplicated directed edge {e}"
            directed[e] = True
    for (a, b) in directed:
        assert (b, a) in directed, f"boundary edge {(a, b)} has no twin"
    # the 5-tet split tiles each cell exactly, so the shell's enclosed
    # volume equals the summed tet rest volume
    v = _signed_volume(host.positions0, tris)
    np.testing.assert_allclose(v, host.rest_volume.sum(), rtol=1e-9)
    assert v > 0


def test_ghosts_frozen_and_shape_drops():
    host, cfg, _pos, _tri = _sphere_scene()
    top, state = api.init(host)
    x0 = np.asarray(state.x)
    live = np.asarray(host.inv_mass) > 0
    for _ in range(40):
        state = api.step(top, cfg, state, n_substeps=4)
    x = np.asarray(state.x)
    assert np.isfinite(x).all()
    np.testing.assert_array_equal(x[~live], x0[~live])   # ghosts bit-frozen
    assert x[live, 1].mean() < x0[live, 1].mean()        # it fell
    assert x[live, 1].min() >= -1e-4                     # plane holds


def test_volume_approximately_preserved_after_settle():
    host, cfg, _pos, _tri = _sphere_scene()
    top, state = api.init(host)
    v0 = float(np.sum(np.asarray(host.rest_volume)))
    for _ in range(60):
        state = api.step(top, cfg, state, n_substeps=4)
    x = np.asarray(state.x, dtype=np.float64)
    t = host.tets
    p0, p1, p2, p3 = x[t[:, 0]], x[t[:, 1]], x[t[:, 2]], x[t[:, 3]]
    vol = np.einsum("ij,ij->i", np.cross(p1 - p0, p2 - p0), p3 - p0) / 6.0
    assert abs(vol.sum() - v0) / v0 < 0.15


def test_skin_original_mesh_tracks_lattice():
    host, cfg, pos, tri = _sphere_scene()
    emb = embed_mesh(host, pos, tri)
    top, state = api.init(host)
    p0 = np.asarray(skin(emb, state.x))
    np.testing.assert_allclose(p0, pos, atol=1e-5)       # exact at rest
    for _ in range(30):
        state = api.step(top, cfg, state, n_substeps=4)
    p = np.asarray(skin(emb, state.x))
    assert np.isfinite(p).all()
    x = np.asarray(state.x)
    live = np.asarray(host.inv_mass) > 0
    pad = 0.1
    assert (p[:, 1] >= x[live, 1].min() - pad).all()


def test_validation():
    pos, tri = icosphere_mesh(radius=0.3, subdivisions=1)
    with pytest.raises(ValueError):
        lattice_from_mesh(pos, tri, resolution=1)
    with pytest.raises(ValueError):
        lattice_from_mesh(pos, tri, resolution=6, margin=-10.0)
    with pytest.raises(ValueError):
        lattice_from_mesh(pos, tri, resolution=6, pinned_ids=(10 ** 9,))


@pytest.mark.parametrize("solver", [Solver.SEMI_IMPLICIT_EULER,
                                    Solver.VERLET, Solver.XPBD])
def test_voxel_lattice_matches_oracle(f64_oracle_run, solver):
    """A VOXEL shape (irregular per-group masks, the novel part vs a full
    cube) on the banded path against the oracle in f64, for every
    solver; ghosts stay bit-frozen."""
    cfg = SimConfig(
        springs=SpringParams(k_structural=400.0, damping=0.4),
        collision=CollisionParams(enable_plane=True),
        volume_stiffness=0.5,
        global_damping=0.5,
        solver=solver,
    )
    pos, tri = icosphere_mesh(radius=0.3, center=(0.0, 0.45, 0.0),
                              subdivisions=2)
    host = lattice_from_mesh(pos, tri, resolution=7, mass=0.02,
                             springs=cfg.springs, xpbd=cfg.xpbd,
                             plane_height=0.0)
    s, x, _ = f64_oracle_run(host, cfg, 3)
    assert s.x.dtype == np.float64
    drift = np.max(np.abs(np.asarray(s.x) - x))
    assert drift < 1e-8, f"{solver}: f64 drift {drift:.3e}"
    ghosts = np.asarray(host.inv_mass) == 0.0
    np.testing.assert_array_equal(np.asarray(s.x)[ghosts],
                                  host.positions0[ghosts])
