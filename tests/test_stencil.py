"""Stencil fast-path equivalence (SURVEY.md §1b):
the shift-based grid formulation must reproduce the edge-list path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbodyunity_tpu import api
from softbodyunity_tpu.core.config import CollisionParams, SimConfig, SpringParams
from softbodyunity_tpu.core.topology import cloth_grid
from softbodyunity_tpu.kernels.stencil import make_stencil_step
from softbodyunity_tpu.solver import step as step_mod


@pytest.mark.parametrize("shear,bend", [(False, False), (True, False), (True, True)])
def test_stencil_step_matches_general(shear, bend):
    cfg = SimConfig(
        springs=SpringParams(k_structural=500.0, k_shear=250.0, k_bend=100.0, damping=0.6),
        collision=CollisionParams(enable_plane=True, friction=0.2),
        global_damping=0.3,
    )
    host = cloth_grid(
        9, 7, spacing=0.05, shear=shear, bend=bend, pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-0.25, orientation="xy",
    )
    top, state = api.init(host)
    # NB: pass `top` as a jit *argument*, never a closure constant — closure
    # device-array constants stall lowering in this environment
    fast = jax.jit(lambda t, s: make_stencil_step(t, cfg)(s, cfg.dt, 120))
    gen = jax.jit(lambda t, s: step_mod.step_scan(t, cfg, s, cfg.dt, 120))
    s_gen = gen(top, state)
    s_fast = fast(top, state)
    np.testing.assert_allclose(np.asarray(s_fast.x), np.asarray(s_gen.x), atol=2e-5)
    np.testing.assert_allclose(np.asarray(s_fast.v), np.asarray(s_gen.v), atol=2e-3)


def test_stencil_with_sphere_collider():
    cfg = SimConfig(
        collision=CollisionParams(enable_plane=True, enable_spheres=True, friction=0.2),
        global_damping=0.3,
    )
    host = cloth_grid(
        8, 8, spacing=0.05, shear=True, bend=True, pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-2.0,
        sphere_centers=np.array([[0.15, -0.25, 0.0]]),
        sphere_radii=np.array([0.12]),
        orientation="xy",
    )
    top, state = api.init(host)
    fast = jax.jit(lambda t, s: make_stencil_step(t, cfg)(s, cfg.dt, 160))
    gen = jax.jit(lambda t, s: step_mod.step_scan(t, cfg, s, cfg.dt, 160))
    s_gen = gen(top, state)
    s_fast = fast(top, state)
    np.testing.assert_allclose(np.asarray(s_fast.x), np.asarray(s_gen.x), atol=5e-5)


@pytest.mark.parametrize("solver", ["verlet", "xpbd"])
def test_stencil_verlet_xpbd_match_general(solver):
    from softbodyunity_tpu.core.config import Solver, XPBDParams

    cfg = SimConfig(
        solver=Solver.VERLET if solver == "verlet" else Solver.XPBD,
        springs=SpringParams(k_structural=500.0, k_shear=250.0, k_bend=100.0, damping=0.6),
        xpbd=XPBDParams(compliance_distance=1e-6, compliance_bend=5e-4,
                        n_iterations=6, relaxation=1.0),
        collision=CollisionParams(enable_plane=True),
        global_damping=0.3,
    )
    host = cloth_grid(
        9, 7, spacing=0.05, shear=True, bend=True, pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-0.25, orientation="xy",
    )
    top, state = api.init(host)
    fast = jax.jit(lambda t, s: make_stencil_step(t, cfg)(s, cfg.dt, 120))
    gen = jax.jit(lambda t, s: step_mod.step_scan(t, cfg, s, cfg.dt, 120))
    s_gen = gen(top, state)
    s_fast = fast(top, state)
    np.testing.assert_allclose(np.asarray(s_fast.x), np.asarray(s_gen.x), atol=5e-5)
    np.testing.assert_allclose(np.asarray(s_fast.v), np.asarray(s_gen.v), atol=5e-3)


def test_backend_auto_dispatches_stencil():
    """cfg.backend='stencil' routes through api.step transparently."""
    host, cfg = _bench_like(16)
    top, state = api.init(host)
    s_jnp = api.step(top, cfg.replace(backend="jnp"), state)
    s_st = api.step(top, cfg.replace(backend="stencil"), state)
    np.testing.assert_allclose(np.asarray(s_st.x), np.asarray(s_jnp.x), atol=1e-5)


def _bench_like(n):
    cfg = SimConfig(collision=CollisionParams(enable_plane=True))
    host = cloth_grid(
        n, n, spacing=0.02, shear=True, bend=True, pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-1.0, orientation="xy",
    )
    return host, cfg
