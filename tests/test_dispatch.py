"""Dispatch guarantees: grid scenes take the stencil path and every
preset lowers to plain XLA (no ``pallas_call``); the removed ``pallas``
backend is refused; block self-collision picks its implementation by
platform, in one place; the chip smoke script refuses a machine without
a GPU; the compile cache follows ``JAX_COMPILATION_CACHE_DIR``."""

import os
import subprocess
import sys

import pytest

import jax

from softbodyunity_tpu import api
from softbodyunity_tpu.core.config import SimConfig
from softbodyunity_tpu.kernels import block_pairs, dispatch
from softbodyunity_tpu.models import presets
from softbodyunity_tpu.utils import cache

GRID_STENCIL = ["cloth_32_euler", "cloth_hanging_sphere", "cloth_xpbd",
                "cloth_bench_64k", "cloth_bench_64k_verlet",
                "cloth_bench_64k_xpbd", "cloth_tearing_64k",
                "cloth_plastic_64k", "cloth_wind_64k", "cloth_bench_262k",
                "cloth_tearing_262k", "cloth_plastic_262k"]
# grids the stencil path does not serve: strain limiting, self-collision
GRID_GENERAL = ["cloth_strain_64k", "cloth_strain_limited",
                "cloth_selfcollide_16k"]


def _lowers_without_pallas(preset_name, stencil):
    host, cfg = presets.build(preset_name)
    top, state = api.init(host)
    state = api.ensure_tear_state(top, cfg, state)
    state = api.ensure_plastic_state(top, cfg, state)
    assert (dispatch.maybe_fast_step(top, cfg) is not None) == stencil
    jaxpr = str(jax.make_jaxpr(
        lambda t, s: api._dispatch_step(t, cfg, s, cfg.dt, 2))(top, state))
    assert "pallas_call" not in jaxpr, preset_name


@pytest.mark.parametrize("preset", GRID_STENCIL + GRID_GENERAL)
def test_presets_lower_without_pallas_call(preset):
    _lowers_without_pallas(preset, preset in GRID_STENCIL)


@pytest.mark.slow
def test_1m_preset_lowers_without_pallas_call():
    _lowers_without_pallas("cloth_bench_1m", True)


def test_grid_solvers_never_fall_to_jnp():
    """For structured grids every (solver, collider) combination resolves
    to the stencil path — never None (the general jnp path) — and lowers
    with no ``pallas_call``."""
    import dataclasses

    from softbodyunity_tpu.core.config import Solver, XPBDParams

    host, cfg0 = presets.build("cloth_hanging_sphere")
    top, state = api.init(host)
    for solver in (Solver.SEMI_IMPLICIT_EULER, Solver.VERLET, Solver.XPBD):
        for spheres in (False, True):
            cfg = cfg0.replace(
                solver=solver,
                xpbd=XPBDParams(n_iterations=4),
                collision=dataclasses.replace(
                    cfg0.collision, enable_spheres=spheres
                ),
            )
            fn = dispatch.maybe_fast_step(top, cfg)
            assert fn is not None, (solver, spheres)
            jaxpr = str(jax.make_jaxpr(lambda t, s: fn(s, cfg.dt, 2))(top, state))
            assert "pallas_call" not in jaxpr, (solver, spheres)


@pytest.mark.parametrize("how", ["construct", "replace"])
def test_pallas_backend_rejected(how):
    with pytest.raises(ValueError, match="pallas"):
        if how == "construct":
            SimConfig(backend="pallas")
        else:
            SimConfig().replace(backend="pallas")


def test_backend_values_accepted():
    for b in ("auto", "jnp", "stencil"):
        assert SimConfig(backend=b).backend == b


@pytest.mark.parametrize("platform,route", [
    ("gpu", "triton"), ("cpu", "jnp"), ("rocm", None), ("metal", None)])
def test_block_route_by_platform(monkeypatch, platform, route):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if route is None:
        with pytest.raises(ValueError, match=platform):
            block_pairs.pair_route()
    else:
        assert block_pairs.pair_route() == route


def test_chip_smoke_guard_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(cache.CHECKOUT / "chip_smoke.py")],
        cwd=cache.CHECKOUT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("script", ["bench.py --part 64k",
                                    "tools/prof_selfcollision.py",
                                    "tools/check_precision.py"])
def test_gpu_scripts_refuse_cpu(script):
    """Measurement scripts fail on a machine without a GPU instead of
    reporting CPU numbers."""
    path, *args = script.split()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(cache.CHECKOUT / path), *args],
        cwd=cache.CHECKOUT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "GPU" in out.stderr or "gpu" in out.stderr


def _grid_top(**kw):
    from softbodyunity_tpu.core.topology import cloth_grid

    top, _ = api.init(cloth_grid(8, 8, spacing=0.05, **kw))
    return top


def _routes():
    """(label, top builder, cfg, stencil?) for the stencil routing rule."""
    from softbodyunity_tpu.core.config import (
        MotionConstraintParams, PlasticityParams, PressureParams,
        SelfCollisionParams, ShapeMatchParams, StrainLimitParams,
        TearParams, WindParams)
    from softbodyunity_tpu.core.topology import (
        enable_pressure, enable_shape_matching, icosphere_mesh,
        from_triangle_mesh, set_motion_constraints, tet_cube, cloth_grid)

    def grid(modify=None):
        def build():
            host = cloth_grid(8, 8, spacing=0.05)
            return api.init(modify(host) if modify else host)[0]
        return build

    def ball(modify):
        def build():
            pos, tri = icosphere_mesh(radius=0.2, subdivisions=1)
            return api.init(modify(from_triangle_mesh(pos, tri)))[0]
        return build

    cube = lambda: api.init(tet_cube(3, spacing=0.1))[0]
    return [
        ("plain grid", grid(), SimConfig(), True),
        ("tearing grid", grid(), SimConfig(tear=TearParams(enabled=True)),
         True),
        ("plastic grid", grid(),
         SimConfig(plasticity=PlasticityParams(enabled=True)), True),
        ("wind grid", grid(), SimConfig(wind=WindParams(lift=0.5)), True),
        ("strain-limited grid", grid(),
         SimConfig(strain_limit=StrainLimitParams(enabled=True)), False),
        ("self-colliding grid", grid(),
         SimConfig(self_collision=SelfCollisionParams(enabled=True)), False),
        ("tethered grid", grid(lambda h: set_motion_constraints(h, 0.1)),
         SimConfig(motion=MotionConstraintParams(enabled=True)), False),
        ("clustered grid", grid(enable_shape_matching),
         SimConfig(shape_match=ShapeMatchParams(enabled=True)), False),
        ("pressure shell", ball(enable_pressure),
         SimConfig(pressure=PressureParams(enabled=True)), False),
        ("tet cube", cube, SimConfig(), False),
    ]


@pytest.mark.parametrize("idx", range(10))
def test_stencil_routing_rule(idx):
    label, build, cfg, stencil = _routes()[idx]
    assert dispatch.stencil_applicable(build(), cfg) == stencil, label


def _cache_updates(monkeypatch, env_dir):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    return cache.enable_compile_cache(), calls


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    path, calls = _cache_updates(monkeypatch, str(tmp_path))
    assert path == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls


def test_compile_cache_default_inside_checkout(monkeypatch):
    path, calls = _cache_updates(monkeypatch, None)
    assert calls["jax_compilation_cache_dir"] == path
    assert path == str(cache.CHECKOUT / ".tmp" / "jax_cache")
    assert (cache.CHECKOUT / "softbodyunity_tpu").is_dir()
