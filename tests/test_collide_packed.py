"""Packed collider rows (solver/collide.py pack_capsules / pack_boxes and
the *_packed resolve/project/friction helpers): the row-sharded halo
paths take capsule/box geometry as packed rows, and must run exactly the
same component formulation as the topology-reading helpers."""

import numpy as np
import pytest

import jax.numpy as jnp

from softbodyunity_tpu import api
from softbodyunity_tpu.core.config import CollisionParams, SimConfig
from softbodyunity_tpu.core.topology import add_colliders, cloth_grid
from softbodyunity_tpu.solver import collide


def _rot_z(deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _scene(kinds):
    cfg = SimConfig(collision=CollisionParams(
        enable_capsules="caps" in kinds, enable_boxes="boxes" in kinds,
        restitution=0.2, friction=0.3))
    host = cloth_grid(10, 10, spacing=0.05, orientation="xz",
                      origin=(-0.25, 0.0, -0.25), springs=cfg.springs,
                      xpbd=cfg.xpbd)
    kw = {}
    if "caps" in kinds:
        kw.update(capsule_p0=[[-0.3, 0.0, 0.0]], capsule_p1=[[0.1, 0.02, 0.0]],
                  capsule_radii=[0.1],
                  capsule_velocities=[[0.1, 0.0, 0.0]])
    if "boxes" in kinds:
        kw.update(box_centers=[[0.1, -0.03, 0.1]],
                  box_half_extents=[[0.12, 0.06, 0.1]],
                  box_rotations=[_rot_z(25.0)],
                  box_velocities=[[0.0, 0.0, -0.2]])
    host = add_colliders(host, **kw)
    top, state = api.init(host)
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(0, 0.3, state.x.shape).astype(np.float32))
    return top, cfg, state.x, v


def _comp(a):
    return [a[:, 0], a[:, 1], a[:, 2]]


KINDS = [("caps",), ("boxes",), ("caps", "boxes")]


@pytest.mark.parametrize("kinds", KINDS)
def test_packed_resolve_matches_topology_form(kinds):
    top, cfg, x, v = _scene(kinds)
    movable = top.inv_mass > 0.0
    want_x, want_v = collide.resolve_capsules_boxes_components(
        top, cfg, _comp(x), _comp(v), movable)
    cap, box = collide.pack_capsules(top), collide.pack_boxes(top)
    got_x, got_v = collide.resolve_capsules_boxes_packed(
        _comp(x), _comp(v), movable, cap, cap.shape[0], box, box.shape[0],
        cfg.collision.restitution, cfg.collision.friction)
    assert float(jnp.abs(jnp.stack(want_x) - x.T).max()) > 0.0  # contact
    for a, b in zip(want_x + want_v, got_x + got_v):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kinds", KINDS)
def test_packed_project_matches_topology_form(kinds):
    top, cfg, x, _ = _scene(kinds)
    movable = top.inv_mass > 0.0
    want = collide.project_capsules_boxes_components(top, cfg, _comp(x),
                                                     movable)
    cap, box = collide.pack_capsules(top), collide.pack_boxes(top)
    got = collide.project_capsules_boxes_packed(
        _comp(x), movable, cap, cap.shape[0], box, box.shape[0])
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kinds", KINDS)
def test_packed_friction_matches_topology_form(kinds):
    top, cfg, x, v = _scene(kinds)
    movable = top.inv_mass > 0.0
    dt = cfg.dt
    x_start = x - dt * v
    want = collide.rest_friction_components(top, cfg, _comp(x),
                                            _comp(x_start), movable, dt)
    cap, box = collide.pack_capsules(top), collide.pack_boxes(top)
    got = collide.rest_friction_packed(
        _comp(x), _comp(x_start), movable, cap, cap.shape[0], box,
        box.shape[0], cfg.collision.friction, dt)
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7)


def test_pack_rows_layout_and_empty():
    top, _, _, _ = _scene(("caps", "boxes"))
    cap, box = collide.pack_capsules(top), collide.pack_boxes(top)
    assert cap.shape == (1, 10) and box.shape == (1, 18)
    np.testing.assert_allclose(np.asarray(cap[0]),
                               [-0.3, 0, 0, 0.1, 0.02, 0, 0.1, 0.1, 0, 0],
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(box[0, 15:]), [0, 0, -0.2])
    plain, _ = api.init(cloth_grid(4, 4, spacing=0.1))
    assert collide.pack_capsules(plain).shape == (0, 10)
    assert collide.pack_boxes(plain).shape == (0, 18)
