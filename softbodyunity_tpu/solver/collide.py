"""Plane / sphere / capsule / box / mesh(SDF) collision resolve — branchless
jnp ops.

The reference resolves collisions with per-vertex ``if`` tests inline in the
substep loop ("plane/sphere collision resolve", BASELINE.json:5; capsules
and boxes are the other two standard Unity primitive colliders).  Here
branches become ``jnp.where`` masks (SURVEY.md C8/C9); semantics mirror
:func:`softbodyunity_tpu.oracle.reference.resolve_plane` /
``resolve_spheres`` / ``resolve_capsules`` / ``resolve_boxes`` /
``project_positions_only`` exactly.

Capsule/box math is written once as *component-list* primitives (``xz`` is a
list of three same-shaped arrays), so the [N,3] general path, the
``[3, ny, nx]`` stencil path, and the row-sharded halo path (packed
geometry rows) all run the identical formulation.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.topology import Topology


# ---------------------------------------------------------------------------
# Component-list capsule / box primitives (single collider)
# ---------------------------------------------------------------------------

def _capsule_closest_components(xz, p0, p1):
    """Closest point on the segment p0->p1 per element; ``p0``/``p1`` are
    length-3 scalar sequences, ``xz`` three same-shaped component arrays."""
    ax = [p1[c] - p0[c] for c in range(3)]
    l2 = ax[0] * ax[0] + ax[1] * ax[1] + ax[2] * ax[2]
    dp = [xz[c] - p0[c] for c in range(3)]
    t = (dp[0] * ax[0] + dp[1] * ax[1] + dp[2] * ax[2]) / jnp.maximum(l2, 1e-12)
    t = jnp.clip(t, 0.0, 1.0)
    return [p0[c] + t * ax[c] for c in range(3)]


def _radial_pen_normal(xz, center, radius):
    """(pen, n) of a sphere-like surface around ``center`` (scalar triple or
    component arrays): penetration depth and outward unit normal."""
    d = [xz[c] - center[c] for c in range(3)]
    dist = jnp.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    inv = 1.0 / jnp.maximum(dist, 1e-12)
    return radius - dist, [d[c] * inv for c in range(3)]


def capsule_project_components(xz, movable, p0, p1, radius):
    """Position-only capsule push-out (oracle project_positions_only twin)."""
    cpt = _capsule_closest_components(xz, p0, p1)
    pen, n = _radial_pen_normal(xz, cpt, radius)
    contact = (pen > 0.0) & movable
    pen_pos = jnp.where(contact, pen, 0.0)
    return [xz[c] + pen_pos * n[c] for c in range(3)]


def _normal_velocity_response(xz, vz, contact, pen, n, restitution, friction,
                              w=None):
    """Shared contact response: push out by ``pen`` along ``n``, reflect the
    inward relative normal velocity by (1+restitution), damp the relative
    tangent by (1-friction).  ``w`` (length-3 scalars, default static) is
    the collider's kinematic velocity: the response runs in the collider's
    rest frame (oracle ``_contact_velocity_response`` twin, exactly)."""
    if w is None:
        w = (0.0, 0.0, 0.0)
    pen_pos = jnp.where(contact, pen, 0.0)
    xz = [xz[c] + pen_pos * n[c] for c in range(3)]
    uz = [vz[c] - w[c] for c in range(3)]
    un = uz[0] * n[0] + uz[1] * n[1] + uz[2] * n[2]
    inward = contact & (un < 0.0)
    rem = jnp.where(inward, (1.0 + restitution) * un, 0.0)
    vz = [vz[c] - rem * n[c] for c in range(3)]
    uz = [vz[c] - w[c] for c in range(3)]
    un2 = uz[0] * n[0] + uz[1] * n[1] + uz[2] * n[2]
    fr = 1.0 - friction
    vz = [
        jnp.where(contact,
                  w[c] + un2 * n[c] + (uz[c] - un2 * n[c]) * fr, vz[c])
        for c in range(3)
    ]
    return xz, vz


def capsule_resolve_components(xz, vz, movable, p0, p1, radius,
                               restitution, friction, w=None):
    """Velocity-level capsule resolve (oracle resolve_capsules twin);
    ``w`` = the capsule's kinematic velocity (length-3 scalars)."""
    cpt = _capsule_closest_components(xz, p0, p1)
    pen, n = _radial_pen_normal(xz, cpt, radius)
    contact = (pen > 0.0) & movable
    return _normal_velocity_response(xz, vz, contact, pen, n,
                                     restitution, friction, w=w)


def box_face_push_components(xz, center, half, rot):
    """(inside, push, n) for an oriented box.  ``center``/``half`` are
    length-3 scalars; ``rot[c][i]`` = R[c, i] with columns = the box's local
    axes in world space.  Exit face = axis of minimum penetration, ties
    broken x < y < z (the oracle's _box_face_push rule, exactly)."""
    d = [xz[c] - center[c] for c in range(3)]
    q = [d[0] * rot[0][i] + d[1] * rot[1][i] + d[2] * rot[2][i]
         for i in range(3)]
    pen = [half[i] - jnp.abs(q[i]) for i in range(3)]
    inside = (pen[0] > 0.0) & (pen[1] > 0.0) & (pen[2] > 0.0)
    k0 = (pen[0] <= pen[1]) & (pen[0] <= pen[2])
    k1 = (~k0) & (pen[1] <= pen[2])
    k = [k0, k1, ~(k0 | k1)]
    sgn = [jnp.where(q[i] >= 0.0, 1.0, -1.0) for i in range(3)]
    # world normal n_c = sum_i [k_i] * sgn_i * R[c, i]
    n = [
        sum(jnp.where(k[i], sgn[i], 0.0) * rot[c][i] for i in range(3))
        for c in range(3)
    ]
    push = sum(jnp.where(k[i], pen[i], 0.0) for i in range(3))
    return inside, push, n


def box_project_components(xz, movable, center, half, rot):
    """Position-only box push-out."""
    inside, push, n = box_face_push_components(xz, center, half, rot)
    contact = inside & movable
    pen_pos = jnp.where(contact, push, 0.0)
    return [xz[c] + pen_pos * n[c] for c in range(3)]


def box_resolve_components(xz, vz, movable, center, half, rot,
                           restitution, friction, w=None):
    """Velocity-level box resolve (oracle resolve_boxes twin); ``w`` = the
    box's kinematic velocity (length-3 scalars)."""
    inside, push, n = box_face_push_components(xz, center, half, rot)
    contact = inside & movable
    return _normal_velocity_response(xz, vz, contact, push, n,
                                     restitution, friction, w=w)


def sdf_sample_grad_components(xz, grid, origin, spacing):
    """Trilinear SDF sample + analytic gradient (oracle ``_sdf_sample_grad``
    twin, exactly): ``xz`` component arrays of any shape, ``grid``
    f32[gx,gy,gz], ``origin`` length-3 scalars, ``spacing`` scalar.
    Returns (phi, [gx, gy, gz]) with phi/components shaped like xz[0].

    Cost: 8 gathers of one scalar plane per vertex — O(N), not O(E) —
    into a small grid; this is the cheap
    formulation of mesh contact (core/sdf.py module docstring)."""
    gx, gy, gz = grid.shape
    u = [(xz[c] - origin[c]) / spacing for c in range(3)]
    dims = (gx, gy, gz)
    i = [jnp.clip(jnp.floor(u[c]).astype(jnp.int32), 0, dims[c] - 2)
         for c in range(3)]
    f = [jnp.clip(u[c] - i[c], 0.0, 1.0) for c in range(3)]
    c8 = [[[grid[i[0] + a, i[1] + b, i[2] + cc] for cc in (0, 1)]
           for b in (0, 1)] for a in (0, 1)]
    fx, fy, fz = f
    cz = [[c8[a][b][0] * (1 - fz) + c8[a][b][1] * fz for b in (0, 1)]
          for a in (0, 1)]
    cy = [cz[a][0] * (1 - fy) + cz[a][1] * fy for a in (0, 1)]
    phi = cy[0] * (1 - fx) + cy[1] * fx
    ddx = (cy[1] - cy[0]) / spacing
    ddy = ((cz[0][1] - cz[0][0]) * (1 - fx)
           + (cz[1][1] - cz[1][0]) * fx) / spacing
    dz = [[c8[a][b][1] - c8[a][b][0] for b in (0, 1)] for a in (0, 1)]
    ddz = ((dz[0][0] * (1 - fy) + dz[0][1] * fy) * (1 - fx)
           + (dz[1][0] * (1 - fy) + dz[1][1] * fy) * fx) / spacing
    return phi, [ddx, ddy, ddz]


def _sdf_pen_normal(xz, grid, origin, spacing):
    """(pen, n) of an SDF collider: penetration depth -phi and outward
    unit normal = normalized SDF gradient."""
    phi, grad = sdf_sample_grad_components(xz, grid, origin, spacing)
    gn = jnp.sqrt(grad[0] * grad[0] + grad[1] * grad[1]
                  + grad[2] * grad[2])
    inv = 1.0 / jnp.maximum(gn, 1e-12)
    return -phi, [grad[c] * inv for c in range(3)]


def sdf_project_components(xz, movable, grid, origin, spacing):
    """Position-only SDF push-out (oracle project_positions_only twin)."""
    pen, n = _sdf_pen_normal(xz, grid, origin, spacing)
    contact = (pen > 0.0) & movable
    pen_pos = jnp.where(contact, pen, 0.0)
    return [xz[c] + pen_pos * n[c] for c in range(3)]


def sdf_resolve_components(xz, vz, movable, grid, origin, spacing,
                           restitution, friction, w=None):
    """Velocity-level SDF resolve (oracle resolve_sdfs twin); ``w`` = the
    bake's kinematic velocity (length-3 scalars)."""
    pen, n = _sdf_pen_normal(xz, grid, origin, spacing)
    contact = (pen > 0.0) & movable
    return _normal_velocity_response(xz, vz, contact, pen, n,
                                     restitution, friction, w=w)


def _sdf_scalars(top: Topology, s: int):
    return (
        top.sdf_grids[s],
        [top.sdf_origins[s, c] for c in range(3)],
        top.sdf_spacings[s],
    )


def _velocity_scalars(velocities, s):
    """Length-3 scalar list for collider ``s`` of a [K,3] kinematic-velocity
    array; None (static) when the scene carries no velocities."""
    if velocities is None:
        return None
    return [velocities[s, c] for c in range(3)]


def resolve_sdfs_components(top, cfg, xz, vz, movable):
    """All enabled SDF colliders, velocity level, sequential order."""
    r, f = cfg.collision.restitution, cfg.collision.friction
    for s in range(top.n_sdfs):
        g, o, h = _sdf_scalars(top, s)
        xz, vz = sdf_resolve_components(
            xz, vz, movable, g, o, h, r, f,
            w=_velocity_scalars(top.sdf_velocities, s))
    return xz, vz


def project_sdfs_components(top, cfg, xz, movable):
    """All enabled SDF colliders, position only."""
    for s in range(top.n_sdfs):
        g, o, h = _sdf_scalars(top, s)
        xz = sdf_project_components(xz, movable, g, o, h)
    return xz


def _needs_sdf(top: Topology, cfg: SimConfig) -> bool:
    return cfg.collision.enable_sdf and top.n_sdfs > 0


def _capsule_scalars(top: Topology, s: int):
    return (
        [top.capsule_p0[s, c] for c in range(3)],
        [top.capsule_p1[s, c] for c in range(3)],
        top.capsule_radii[s],
    )


def _box_scalars(top: Topology, s: int):
    return (
        [top.box_centers[s, c] for c in range(3)],
        [top.box_half_extents[s, c] for c in range(3)],
        [[top.box_rotations[s, c, i] for i in range(3)] for c in range(3)],
    )


def resolve_capsules_boxes_components(top, cfg, xz, vz, movable,
                                      skip_boxes=False):
    """All enabled capsule then box colliders, velocity level, in the
    oracle's sequential order; ``xz``/``vz`` component lists of any shape.
    ``skip_boxes`` when the boxes are DYNAMIC rigid bodies this substep
    (solver/rigid.py resolves them in its coupled box loop)."""
    r, f = cfg.collision.restitution, cfg.collision.friction
    if cfg.collision.enable_capsules and top.n_capsules > 0:
        for s in range(top.n_capsules):
            p0, p1, rad = _capsule_scalars(top, s)
            xz, vz = capsule_resolve_components(
                xz, vz, movable, p0, p1, rad, r, f,
                w=_velocity_scalars(top.capsule_velocities, s))
    if cfg.collision.enable_boxes and top.n_boxes > 0 and not skip_boxes:
        for s in range(top.n_boxes):
            c, h, rot = _box_scalars(top, s)
            xz, vz = box_resolve_components(
                xz, vz, movable, c, h, rot, r, f,
                w=_velocity_scalars(top.box_velocities, s))
    return xz, vz


def project_capsules_boxes_components(top, cfg, xz, movable,
                                      skip_boxes=False):
    """All enabled capsule then box colliders, position only."""
    if cfg.collision.enable_capsules and top.n_capsules > 0:
        for s in range(top.n_capsules):
            p0, p1, rad = _capsule_scalars(top, s)
            xz = capsule_project_components(xz, movable, p0, p1, rad)
    if cfg.collision.enable_boxes and top.n_boxes > 0 and not skip_boxes:
        for s in range(top.n_boxes):
            c, h, rot = _box_scalars(top, s)
            xz = box_project_components(xz, movable, c, h, rot)
    return xz


def _needs_capsule_box(top: Topology, cfg: SimConfig) -> bool:
    return (cfg.collision.enable_capsules and top.n_capsules > 0) or (
        cfg.collision.enable_boxes and top.n_boxes > 0
    )


# ---------------------------------------------------------------------------
# Packed collider rows: capsule/box geometry plus kinematic velocity as one
# f32 row per collider, for paths that take the geometry as array inputs
# (the row-sharded halo steps pass them replicated, never as closure
# constants)
# ---------------------------------------------------------------------------

def _zero_vel(vel, n):
    """Kinematic velocity rows, zeros when the topology carries none."""
    if vel is None:
        return jnp.zeros((n, 3), jnp.float32)
    return vel


def pack_capsules(top: Topology):
    """[C, 10] rows: p0 (3), p1 (3), radius, kinematic velocity (3)."""
    if top.n_capsules == 0:
        return jnp.zeros((0, 10), jnp.float32)
    return jnp.concatenate(
        [top.capsule_p0, top.capsule_p1, top.capsule_radii[:, None],
         _zero_vel(top.capsule_velocities, top.n_capsules)], axis=1
    ).astype(jnp.float32)


def pack_boxes(top: Topology):
    """[B, 18] rows: center (3), half extents (3), R row-major (9),
    kinematic velocity (3)."""
    if top.n_boxes == 0:
        return jnp.zeros((0, 18), jnp.float32)
    return jnp.concatenate(
        [top.box_centers, top.box_half_extents,
         top.box_rotations.reshape(-1, 9),
         _zero_vel(top.box_velocities, top.n_boxes)], axis=1
    ).astype(jnp.float32)


def _packed_capsule(cap, s):
    return ([cap[s, c] for c in range(3)], [cap[s, 3 + c] for c in range(3)],
            cap[s, 6], [cap[s, 7 + c] for c in range(3)])


def _packed_box(box, s):
    return ([box[s, c] for c in range(3)], [box[s, 3 + c] for c in range(3)],
            [[box[s, 6 + 3 * c + i] for i in range(3)] for c in range(3)],
            [box[s, 15 + c] for c in range(3)])


def resolve_capsules_boxes_packed(xz, vz, movable, cap, n_capsules, box,
                                  n_boxes, restitution, friction):
    """Velocity-level capsule/box resolve from packed rows (the same
    component formulation as :func:`resolve_capsules_boxes_components`)."""
    for s in range(n_capsules):
        p0, p1, rad, w = _packed_capsule(cap, s)
        xz, vz = capsule_resolve_components(
            xz, vz, movable, p0, p1, rad, restitution, friction, w=w)
    for s in range(n_boxes):
        ce, hf, rot, w = _packed_box(box, s)
        xz, vz = box_resolve_components(
            xz, vz, movable, ce, hf, rot, restitution, friction, w=w)
    return xz, vz


def project_capsules_boxes_packed(xz, movable, cap, n_capsules, box,
                                  n_boxes):
    """Position-only capsule/box push-out from packed rows."""
    for s in range(n_capsules):
        p0, p1, rad, _ = _packed_capsule(cap, s)
        xz = capsule_project_components(xz, movable, p0, p1, rad)
    for s in range(n_boxes):
        ce, hf, rot, _ = _packed_box(box, s)
        xz = box_project_components(xz, movable, ce, hf, rot)
    return xz


def rest_friction_packed(xz, xsz, movable, cap, n_capsules, box, n_boxes,
                         mu, dt):
    """Capsule/box position-level friction from packed rows (once per
    substep, after the sphere friction); ``xsz`` = substep-start
    components."""
    for s in range(n_capsules):
        p0, p1, rad, w = _packed_capsule(cap, s)
        xz = capsule_friction_components(xz, xsz, movable, p0, p1, rad, w,
                                         mu, dt)
    for s in range(n_boxes):
        ce, hf, rot, w = _packed_box(box, s)
        xz = box_friction_components(xz, xsz, movable, ce, hf, rot, w, mu,
                                     dt)
    return xz


def resolve_plane(x, v, plane_y, restitution, friction, movable, w=None):
    """``w`` = plane SURFACE velocity (conveyor; oracle resolve_plane twin:
    geometry stays at plane_y, the response runs relative to w)."""
    if w is None:
        w = (0.0, 0.0, 0.0)
    contact = (x[:, 1] < plane_y) & movable
    y = jnp.where(contact, plane_y, x[:, 1])
    x = x.at[:, 1].set(y)
    vy = v[:, 1]
    uy = vy - w[1]
    vy_new = jnp.where(
        contact, jnp.where(uy < 0.0, w[1] - restitution * uy, vy), vy)
    vx = jnp.where(
        contact, w[0] + (v[:, 0] - w[0]) * (1.0 - friction), v[:, 0])
    vz = jnp.where(
        contact, w[2] + (v[:, 2] - w[2]) * (1.0 - friction), v[:, 2])
    return x, jnp.stack([vx, vy_new, vz], axis=1)


def _resolve_one_sphere(x, v, center, radius, restitution, friction, movable,
                        w=None):
    if w is None:
        w = jnp.zeros(3, dtype=v.dtype)
    d = x - center
    dist = jnp.linalg.norm(d, axis=1)
    pen = radius - dist
    contact = (pen > 0.0) & movable
    n = d / jnp.maximum(dist, 1e-12)[:, None]
    x = x + jnp.where(contact, pen, 0.0)[:, None] * n
    u = v - w[None, :]
    un = jnp.einsum("ij,ij->i", u, n)
    inward = contact & (un < 0.0)
    v = v - jnp.where(inward, (1.0 + restitution) * un, 0.0)[:, None] * n
    u2 = v - w[None, :]
    un2 = jnp.einsum("ij,ij->i", u2, n)[:, None] * n
    ut = u2 - un2
    v = jnp.where(contact[:, None],
                  w[None, :] + un2 + ut * (1.0 - friction), v)
    return x, v


def resolve_spheres(x, v, centers, radii, restitution, friction, movable,
                    velocities=None):
    # S is small and static; a Python loop unrolls into the jitted graph,
    # matching the oracle's sequential per-sphere resolve order.
    for s in range(radii.shape[0]):
        x, v = _resolve_one_sphere(
            x, v, centers[s], radii[s], restitution, friction, movable,
            w=None if velocities is None else velocities[s],
        )
    return x, v


def resolve_plane_stage(top: Topology, cfg: SimConfig, x, v, movable):
    """First stage of the Euler resolve order (plane only)."""
    if cfg.collision.enable_plane:
        x, v = resolve_plane(
            x, v, top.plane_height, cfg.collision.restitution,
            cfg.collision.friction, movable,
            w=(None if top.plane_velocity is None
               else [top.plane_velocity[c] for c in range(3)]),
        )
    return x, v


def resolve_after_spheres(top: Topology, cfg: SimConfig, x, v, movable,
                          skip_boxes=False):
    """Last stage of the Euler resolve order: capsules/boxes, then SDFs
    (everything sequenced after the spheres)."""
    if _needs_capsule_box(top, cfg):
        xz, vz = resolve_capsules_boxes_components(
            top, cfg, [x[:, 0], x[:, 1], x[:, 2]],
            [v[:, 0], v[:, 1], v[:, 2]], movable, skip_boxes=skip_boxes,
        )
        x = jnp.stack(xz, axis=1)
        v = jnp.stack(vz, axis=1)
    if _needs_sdf(top, cfg):
        xz, vz = resolve_sdfs_components(
            top, cfg, [x[:, 0], x[:, 1], x[:, 2]],
            [v[:, 0], v[:, 1], v[:, 2]], movable,
        )
        x = jnp.stack(xz, axis=1)
        v = jnp.stack(vz, axis=1)
    return x, v


def resolve_velocity_level(top: Topology, cfg: SimConfig, x, v, movable):
    """Euler-path resolve: position projection + velocity response, in the
    oracle's sequential order (plane -> spheres -> capsules/boxes -> SDFs).
    The coupled path (solver/rigid.py) reuses the plane/after-spheres
    stages around its impulse-instrumented sphere resolve."""
    x, v = resolve_plane_stage(top, cfg, x, v, movable)
    if cfg.collision.enable_spheres and top.n_spheres > 0:
        x, v = resolve_spheres(
            x, v, top.sphere_centers, top.sphere_radii,
            cfg.collision.restitution, cfg.collision.friction, movable,
            velocities=top.sphere_velocities,
        )
    return resolve_after_spheres(top, cfg, x, v, movable)


def project_positions_delta(top: Topology, cfg: SimConfig, x_prev, delta,
                            movable):
    """Delta-form twin of :func:`project_positions_only` for the XPBD
    drift-controlled accumulation (solver/step.py substep_xpbd): the plane
    clamp is expressed exactly as ``plane_y - x_prev`` (no rounding crumb),
    spheres as the projection displacement at the evaluation point.  Every
    XPBD path (general, banded, stencil, Pallas, halo) uses these same
    forms so cross-path equivalence stays at rounding level.

    Returns ``(delta, plane_contact)`` — the plane stage's pre-clamp
    penetration mask, which the LAST Jacobi iteration feeds to
    :func:`plane_friction_delta`."""
    plane_contact = jnp.zeros(delta.shape[0], bool)
    if cfg.collision.enable_plane:
        xe_y = x_prev[:, 1] + delta[:, 1]
        plane_contact = (xe_y < top.plane_height) & movable
        delta = delta.at[:, 1].set(
            jnp.where(plane_contact, top.plane_height - x_prev[:, 1],
                      delta[:, 1])
        )
    if cfg.collision.enable_spheres and top.n_spheres > 0:
        xe = x_prev + delta
        xproj = xe
        for s in range(top.n_spheres):
            d = xproj - top.sphere_centers[s]
            dist = jnp.linalg.norm(d, axis=1)
            pen = top.sphere_radii[s] - dist
            contact = (pen > 0.0) & movable
            n = d / jnp.maximum(dist, 1e-12)[:, None]
            xproj = xproj + jnp.where(contact, pen, 0.0)[:, None] * n
        delta = delta + (xproj - xe)
    if _needs_capsule_box(top, cfg):
        xe = x_prev + delta
        xz = project_capsules_boxes_components(
            top, cfg, [xe[:, 0], xe[:, 1], xe[:, 2]], movable
        )
        delta = delta + (jnp.stack(xz, axis=1) - xe)
    if _needs_sdf(top, cfg):
        xe = x_prev + delta
        xz = project_sdfs_components(
            top, cfg, [xe[:, 0], xe[:, 1], xe[:, 2]], movable
        )
        delta = delta + (jnp.stack(xz, axis=1) - xe)
    return delta, plane_contact


def plane_contact_preclamp(top: Topology, cfg: SimConfig, x, movable):
    """Pre-clamp plane penetration mask of the substep's FINAL projection
    — the friction contact set (oracle twin: reference.
    plane_contact_preclamp; a post-clamp ``y == plane_height`` equality
    would wobble by 1 ulp in the XPBD delta-form reconstruction)."""
    if not cfg.collision.enable_plane:
        return jnp.zeros(x.shape[0], bool)
    return (x[:, 1] < top.plane_height) & movable


def plane_friction_positions(top: Topology, cfg: SimConfig, x, x_start, dt,
                             contact):
    """Plane friction for the position-projection solvers (oracle twin:
    reference.plane_friction_positions): contacting vertices have their
    tangential substep displacement relative to the plane surface damped
    by (1 - friction); ``plane_velocity`` = conveyor dragging.  ONCE per
    substep, after the final projection, with the projection's own
    pre-clamp ``contact`` mask."""
    mu = cfg.collision.friction
    if not cfg.collision.enable_plane or mu == 0.0:
        return x
    cols = []
    for ax in (0, 2):
        w = 0.0 if top.plane_velocity is None else top.plane_velocity[ax]
        target = x_start[:, ax] + w * dt
        cols.append(jnp.where(
            contact, target + (x[:, ax] - target) * (1.0 - mu), x[:, ax]
        ))
    return jnp.stack([cols[0], x[:, 1], cols[1]], axis=1)


def plane_friction_delta(top: Topology, cfg: SimConfig, delta, dt, contact):
    """Delta-form twin of :func:`plane_friction_positions` for the XPBD
    drift-controlled accumulation: the substep displacement IS the delta,
    so the damped tangential delta is ``w*dt + (1-mu)*(delta - w*dt)``
    (algebraically identical to the oracle's
    ``target + (x - target)*(1-mu)`` with ``x = x_prev + delta``)."""
    mu = cfg.collision.friction
    if not cfg.collision.enable_plane or mu == 0.0:
        return delta
    for ax in (0, 2):
        w = 0.0 if top.plane_velocity is None else top.plane_velocity[ax]
        wdt = w * dt
        delta = delta.at[:, ax].set(jnp.where(
            contact, wdt + (delta[:, ax] - wdt) * (1.0 - mu), delta[:, ax]
        ))
    return delta


# sphere-contact shell for position-level friction (oracle
# SPHERE_CONTACT_SHELL): projected vertices sit within ulps of the
# surface, so exact dist == r is a knife edge
SPHERE_CONTACT_SHELL = 1.0 + 1e-5


def sphere_friction_positions(top: Topology, cfg: SimConfig, x, x_start, dt,
                              movable):
    """Substep-end sphere friction for the position-projection solvers
    (oracle twin: reference.sphere_friction_positions): vertices ending
    the substep ON a sphere (``dist <= r * SPHERE_CONTACT_SHELL``) have
    the TANGENTIAL part of their substep displacement — relative to the
    sphere's kinematic surface velocity — damped by (1 - friction).
    Spheres apply sequentially after the plane friction, ONCE per
    substep.  Static-collider path; the coupled dynamic-sphere substeps
    measure and react the impulse (solver/rigid.py)."""
    mu = cfg.collision.friction
    if (not cfg.collision.enable_spheres or mu == 0.0
            or top.n_spheres == 0):
        return x
    for s in range(top.n_spheres):
        d = x - top.sphere_centers[s]
        dist = jnp.linalg.norm(d, axis=1)
        n = d / jnp.maximum(dist, 1e-12)[:, None]
        contact = (dist <= top.sphere_radii[s] * SPHERE_CONTACT_SHELL) \
            & movable
        w = (jnp.zeros(3, x.dtype) if top.sphere_velocities is None
             else top.sphere_velocities[s])
        rel = (x - x_start) - w[None, :] * dt
        rel_t = rel - jnp.einsum("ij,ij->i", rel, n)[:, None] * n
        x = jnp.where(contact[:, None], x - mu * rel_t, x)
    return x


# box / SDF contact shells for the position-level friction (oracle
# BOX_CONTACT_SHELL / SDF_CONTACT_SHELL): relative to max half-extent and
# grid spacing respectively
BOX_CONTACT_SHELL = 1e-5
SDF_CONTACT_SHELL = 1e-3


def _friction_tangent_components(xz, xsz, contact, n, w, mu, dt):
    """Shared position-level friction rule on component lists (oracle
    _friction_tangent twin): damp the tangential substep displacement
    (relative to the collider's kinematic velocity ``w``) by (1 - mu) at
    the contacting vertices."""
    if w is None:
        w = (0.0, 0.0, 0.0)
    rel = [xz[c] - xsz[c] - w[c] * dt for c in range(3)]
    rel_n = rel[0] * n[0] + rel[1] * n[1] + rel[2] * n[2]
    return [
        jnp.where(contact, xz[c] - mu * (rel[c] - rel_n * n[c]), xz[c])
        for c in range(3)
    ]


def capsule_friction_components(xz, xsz, movable, p0, p1, radius, w, mu, dt):
    """Capsule position-level friction (sphere shell around the closest
    core point; oracle rest_friction_positions capsule leg)."""
    cpt = _capsule_closest_components(xz, p0, p1)
    d = [xz[c] - cpt[c] for c in range(3)]
    dist = jnp.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    inv = 1.0 / jnp.maximum(dist, 1e-12)
    n = [d[c] * inv for c in range(3)]
    contact = (dist <= radius * SPHERE_CONTACT_SHELL) & movable
    return _friction_tangent_components(xz, xsz, contact, n, w, mu, dt)


def box_friction_components(xz, xsz, movable, center, half, rot, w, mu, dt):
    """Oriented-box position-level friction: vertices within
    BOX_CONTACT_SHELL * max(half) of the nearest face (oracle
    rest_friction_positions box leg)."""
    d = [xz[c] - center[c] for c in range(3)]
    q = [d[0] * rot[0][i] + d[1] * rot[1][i] + d[2] * rot[2][i]
         for i in range(3)]
    pen = [half[i] - jnp.abs(q[i]) for i in range(3)]
    mn = jnp.minimum(jnp.minimum(pen[0], pen[1]), pen[2])
    shell = BOX_CONTACT_SHELL * jnp.maximum(
        jnp.maximum(half[0], half[1]), half[2])
    contact = (mn >= -shell) & (mn <= shell) & movable
    _, _, n = box_face_push_components(xz, center, half, rot)
    return _friction_tangent_components(xz, xsz, contact, n, w, mu, dt)


def sdf_friction_components(xz, xsz, movable, grid, origin, spacing, w, mu,
                            dt):
    """SDF position-level friction: vertices within
    SDF_CONTACT_SHELL * spacing of the zero level set (oracle
    rest_friction_positions SDF leg)."""
    phi, grad = sdf_sample_grad_components(xz, grid, origin, spacing)
    gn = jnp.sqrt(grad[0] * grad[0] + grad[1] * grad[1]
                  + grad[2] * grad[2])
    inv = 1.0 / jnp.maximum(gn, 1e-12)
    n = [grad[c] * inv for c in range(3)]
    contact = (phi <= SDF_CONTACT_SHELL * spacing) & movable
    return _friction_tangent_components(xz, xsz, contact, n, w, mu, dt)


def rest_friction_components(top: Topology, cfg: SimConfig, xz, xsz,
                             movable, dt, skip_boxes=False):
    """Capsule / box / SDF position-level friction on component lists, in
    the oracle's sequential order (oracle rest_friction_positions twin);
    runs ONCE per substep after the sphere friction."""
    mu = cfg.collision.friction
    if mu == 0.0:
        return xz
    if cfg.collision.enable_capsules and top.n_capsules > 0:
        for s in range(top.n_capsules):
            p0, p1, rad = _capsule_scalars(top, s)
            xz = capsule_friction_components(
                xz, xsz, movable, p0, p1, rad,
                _velocity_scalars(top.capsule_velocities, s), mu, dt)
    if cfg.collision.enable_boxes and top.n_boxes > 0 and not skip_boxes:
        for s in range(top.n_boxes):
            c, h, rot = _box_scalars(top, s)
            xz = box_friction_components(
                xz, xsz, movable, c, h, rot,
                _velocity_scalars(top.box_velocities, s), mu, dt)
    if _needs_sdf(top, cfg):
        for s in range(top.n_sdfs):
            g, o, h = _sdf_scalars(top, s)
            xz = sdf_friction_components(
                xz, xsz, movable, g, o, h,
                _velocity_scalars(top.sdf_velocities, s), mu, dt)
    return xz


def rest_friction_positions(top: Topology, cfg: SimConfig, x, x_start, dt,
                            movable, skip_boxes=False):
    """[N,3] wrapper of rest_friction_components (solver/step.py paths)."""
    mu = cfg.collision.friction
    if mu == 0.0 or not (
            _needs_capsule_box(top, cfg) or _needs_sdf(top, cfg)):
        return x
    xz = rest_friction_components(
        top, cfg, [x[:, 0], x[:, 1], x[:, 2]],
        [x_start[:, 0], x_start[:, 1], x_start[:, 2]], movable, dt,
        skip_boxes=skip_boxes)
    return jnp.stack(xz, axis=1)


def project_positions_only(top: Topology, cfg: SimConfig, x, movable):
    """Verlet/XPBD-path resolve: positions only (velocity is implicit)."""
    if cfg.collision.enable_plane:
        contact = (x[:, 1] < top.plane_height) & movable
        x = x.at[:, 1].set(jnp.where(contact, top.plane_height, x[:, 1]))
    if cfg.collision.enable_spheres and top.n_spheres > 0:
        for s in range(top.n_spheres):
            d = x - top.sphere_centers[s]
            dist = jnp.linalg.norm(d, axis=1)
            pen = top.sphere_radii[s] - dist
            contact = (pen > 0.0) & movable
            n = d / jnp.maximum(dist, 1e-12)[:, None]
            x = x + jnp.where(contact, pen, 0.0)[:, None] * n
    if _needs_capsule_box(top, cfg):
        xz = project_capsules_boxes_components(
            top, cfg, [x[:, 0], x[:, 1], x[:, 2]], movable
        )
        x = jnp.stack(xz, axis=1)
    if _needs_sdf(top, cfg):
        xz = project_sdfs_components(
            top, cfg, [x[:, 0], x[:, 1], x[:, 2]], movable
        )
        x = jnp.stack(xz, axis=1)
    return x
