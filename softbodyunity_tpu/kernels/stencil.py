"""Stencil (shift-based) fast path for structured grid cloth.

The general solver gathers over an explicit edge list (the reference's data
model).  But a cloth *grid* (BASELINE.json:7-8) has fully regular topology:
every spring class is a constant offset ``(di, dj)`` on the grid —

  structural: (0,1), (1,0)        shear: (1,1), (1,-1)      bend: (0,2), (2,0)

— so spring-force accumulation becomes six shifted-window subtractions on
dense ``[3, ny, nx]`` component planes: zero gathers, zero scatters.
This is the re-design of the reference's per-edge loop (SURVEY.md §1b),
and the layout the halo-decomposed multi-device path builds on.

Semantics are *identical* to the edge-list path (same springs enumerated
once each, same Euler substep as the oracle); tests assert equality.

Requires: uniform grid spacing (``Topology.grid_spacing``), Euler solver,
no tets/self-collision.  Dispatcher falls back to the general path
otherwise (kernels/dispatch.py).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.state import State
from ..core.topology import EDGE_BEND, EDGE_SHEAR, Topology
from ..solver import collide
from ..solver.forces import (length_dir_planes,
                             length_dir_planes_mul, safe_sqrt)


def _shift(a: jax.Array, di: int, dj: int) -> jax.Array:
    """out[..., i, j] = a[..., i+di, j+dj], zero outside.

    Implemented as pad+slice (pure data movement, no dynamic-update-slice):
    XLA folds it into the consuming elementwise fusion.
    """
    ny, nx = a.shape[-2], a.shape[-1]
    pad = [(0, 0)] * (a.ndim - 2) + [
        (max(0, -di), max(0, di)),
        (max(0, -dj), max(0, dj)),
    ]
    ap = jnp.pad(a, pad)
    r0 = max(0, -di) + di
    c0 = max(0, -dj) + dj
    return ap[..., r0 : r0 + ny, c0 : c0 + nx]


def _valid_mask(ny: int, nx: int, di: int, dj: int) -> np.ndarray:
    """Constant mask of vertices whose (i+di, j+dj) neighbour exists."""
    m = np.zeros((ny, nx), np.float32)
    r0, r1 = max(0, -di), ny - max(0, di)
    c0, c1 = max(0, -dj), nx - max(0, dj)
    m[r0:r1, c0:c1] = 1.0
    return m


def _offsets(cfg: SimConfig, spacing: float, has_shear: bool, has_bend: bool):
    """(di, dj, stiffness, rest_length) per spring class present."""
    s = cfg.springs
    offs = [
        (0, 1, s.k_structural, spacing),
        (1, 0, s.k_structural, spacing),
    ]
    if has_shear:
        r2 = spacing * float(np.sqrt(2.0))
        offs += [(1, 1, s.k_shear, r2), (1, -1, s.k_shear, r2)]
    if has_bend:
        offs += [(0, 2, s.k_bend, 2 * spacing), (2, 0, s.k_bend, 2 * spacing)]
    return offs


def stencil_spring_forces(
    x3: jax.Array,       # f32[3, ny, nx]
    v3: jax.Array,       # f32[3, ny, nx]
    offsets,             # from _offsets
    damping: float,
    alive=None,          # f32[n_off, ny, nx] tear liveness planes, or None
    rest_scale=None,     # f32[n_off, ny, nx] plastic rest scales, or None
) -> jax.Array:
    """Hooke + axial damper over all spring classes, stencil-accumulated.

    For each offset o: every vertex (i,j) owns the edge to (i,j)+o; the
    equal-and-opposite reaction is applied by shifting the force plane back
    by -o.  Equivalent to the oracle's per-edge scatter, with no scatter.
    ``alive`` (TearParams) silences torn edges; entries at invalid grid
    positions are 0 by construction, so it subsumes the validity mask.
    """
    ny, nx = x3.shape[-2], x3.shape[-1]
    f_total = jnp.zeros_like(x3)
    for o, (di, dj, k, rest) in enumerate(offsets):
        xn = _shift(x3, di, dj)
        vn = _shift(v3, di, dj)
        d = xn - x3
        # grad-safe norm: sqrt'(0) is a 0/0 NaN in the backward pass for
        # zero-length PHANTOM boundary pairs (the zero-padded shift
        # meeting the origin vertex) and for truly coincident vertices.
        # length_dir_planes_mul keeps the verbatim old ops as the
        # compiled primal — even a where-select on the reciprocal
        # shifted fusion rounding by 1 ulp and broke the step_coupled /
        # batched-hetero bit contracts (solver/forces.py).
        length, n = length_dir_planes_mul(d)
        rel_v = jnp.sum((vn - v3) * n, axis=0)
        mask = (jnp.asarray(_valid_mask(ny, nx, di, dj))
                if alive is None else alive[o])
        rest_eff = rest if rest_scale is None else rest * rest_scale[o]
        fmag = (k * (length - rest_eff) + damping * rel_v) * mask
        f = fmag * n                       # force on (i,j), toward neighbour
        f_total = f_total + f - _shift(f, -di, -dj)
    return f_total


def tear_ok_planes(x3, offsets, strain_limit: float, shift=_shift,
                   rest_scale=None):
    """Per-offset survival masks of the tear check (oracle tear_update's
    comparison): 1.0 where the edge owned at (i, j) is within its strain
    limit.  Single source of the tear math for the stencil and halo
    paths.  ``rest_scale`` (plasticity)
    rescales the rest lengths first."""
    ok = []
    for o, off in enumerate(offsets):
        di, dj, rest = off[0], off[1], off[3]
        d = shift(x3, di, dj) - x3
        # safe_sqrt: bit-identical primal, grad-safe at 0 (see
        # solver/forces.py)
        length = safe_sqrt(jnp.sum(d * d, axis=0))
        rest_eff = rest if rest_scale is None else rest * rest_scale[o]
        ok.append((length <= rest_eff * (1.0 + strain_limit))
                  .astype(x3.dtype))
    return ok


def tear_update_grid(x3, offsets, alive, strain_limit: float, shift=_shift,
                     rest_scale=None):
    """End-of-substep tear check on liveness planes (oracle tear_update
    twin, zero gathers).  Invalid grid positions are already 0 in ``alive``
    and stay 0 regardless of the garbage lengths the shift makes there.
    ``alive`` is anything [o]-indexable (stacked planes
    or a loop-carry list)."""
    ok = tear_ok_planes(x3, offsets, strain_limit, shift=shift,
                        rest_scale=rest_scale)
    return jnp.stack([alive[o] * ok[o] for o in range(len(offsets))])


def plastic_update_grid(x3, offsets, scale, pp, shift=_shift):
    """End-of-substep plastic flow on rest-scale planes (oracle
    plastic_update twin, zero gathers; PlasticityParams ``pp``).  Invalid
    grid positions carry garbage scales (0 from the flat->plane scatter,
    clamped to min_scale after one update) that nothing ever reads: the
    force/constraint masks zero those positions and planes_to_alive only
    gathers valid owners."""
    out = []
    for o, off in enumerate(offsets):
        di, dj, rest = off[0], off[1], off[3]
        d = shift(x3, di, dj) - x3
        # safe_sqrt: bit-identical primal, grad-safe at 0 (see
        # solver/forces.py)
        length = safe_sqrt(jnp.sum(d * d, axis=0))
        rest_eff = jnp.maximum(rest * scale[o], 1e-12)
        strain = (length - rest_eff) / rest_eff
        excess = jnp.sign(strain) * jnp.maximum(
            jnp.abs(strain) - pp.yield_strain, 0.0
        )
        out.append(jnp.clip(scale[o] * (1.0 + pp.creep * excess),
                            pp.min_scale, pp.max_scale))
    return jnp.stack(out)


def _cross3(a, b):
    """Cross product on stacked [3, ...] component planes."""
    return jnp.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def grid_vertex_normals(x3: jax.Array, shift=_shift, cell_mask=None) -> jax.Array:
    """Unit area-weighted vertex normals of the grid triangulation —
    EXACTLY the C11 semantics (oracle vertex_normals over cloth_grid's
    triangles) expressed as shifts, so wind lift can run inside the
    stencil hot loop with zero gathers.

    cloth_grid triangulates each cell (i, j) as
    ``(v(i,j), v(i+1,j), v(i,j+1))`` and ``(v(i,j+1), v(i+1,j), v(i+1,j+1))``;
    the face-normal planes are zero at invalid cells (last row/col), so
    reaction shifts — wrap-around rolls included — annihilate.

    ``shift`` is the neighbour primitive (`_shift`: pad + slice);
    ``cell_mask`` overrides the host-constant valid-cell mask (the halo
    rows pass one built from global row indices)."""
    ny, nx = x3.shape[-2], x3.shape[-1]
    cell = (jnp.asarray(_valid_mask(ny, nx, 1, 1))
            if cell_mask is None else cell_mask)
    pi = shift(x3, 1, 0)      # p(i+1, j)
    pj = shift(x3, 0, 1)      # p(i, j+1)
    pij = shift(x3, 1, 1)     # p(i+1, j+1)
    f1 = _cross3(pi - x3, pj - x3) * cell
    f2 = _cross3(pi - pj, pij - pj) * cell
    acc = (
        f1 + shift(f1, -1, 0) + shift(f1, 0, -1)
        + shift(f2, 0, -1) + shift(f2, -1, 0) + shift(f2, -1, -1)
    )
    norm2 = acc[0] * acc[0] + acc[1] * acc[1] + acc[2] * acc[2]
    # safe_sqrt: bit-identical primal, grad-safe for degenerate normals
    return acc / jnp.maximum(safe_sqrt(norm2), 1e-12)


def wind_forces_grid(x3, v3, cfg: SimConfig, shift=_shift, cell_mask=None):
    """WindParams force on grid planes (oracle wind_forces twin).

    The wind velocity enters as three Python-float scalars (never a [3]
    array constant captured by the trace)."""
    wp = cfg.wind
    vrel = jnp.stack([wp.velocity[c] - v3[c] for c in range(3)])
    f = wp.drag * vrel
    if wp.lift != 0.0:
        n = grid_vertex_normals(x3, shift=shift, cell_mask=cell_mask)
        vn = vrel[0] * n[0] + vrel[1] * n[1] + vrel[2] * n[2]
        f = f + wp.lift * vn * n
    return f


def euler_substep_grid(
    x3, v3, inv_mass2, offsets, cfg: SimConfig, dt: float,
    plane_height, sphere_centers, sphere_radii, top=None, alive=None,
    scale=None,
):
    """One semi-implicit Euler substep on grid planes — oracle semantics
    (oracle/reference.py substep_euler) in stencil form.  ``alive`` (tear
    liveness planes) / ``scale`` (plastic rest-scale planes) ride along;
    returns ``(x3, v3, alive, scale)`` with Nones preserved."""
    g = jnp.asarray(cfg.gravity, dtype=x3.dtype).reshape(3, 1, 1)
    movable = inv_mass2 > 0.0
    f = stencil_spring_forces(x3, v3, offsets, cfg.springs.damping,
                              alive=alive, rest_scale=scale)
    if cfg.wind.enabled:
        f = f + wind_forces_grid(x3, v3, cfg)
    v3 = (v3 + dt * (g + f * inv_mass2)) * (1.0 - cfg.global_damping * dt)
    v3 = jnp.where(movable, v3, 0.0)
    x3 = x3 + dt * v3

    if cfg.collision.enable_plane:
        # plane surface (conveyor) velocity: response relative to wp
        wp = [0.0, 0.0, 0.0]
        if top is not None and top.plane_velocity is not None:
            wp = [top.plane_velocity[c] for c in range(3)]
        contact = (x3[1] < plane_height) & movable[0]
        x3 = x3.at[1].set(jnp.where(contact, plane_height, x3[1]))
        vy = v3[1]
        uy = vy - wp[1]
        vy = jnp.where(
            contact,
            jnp.where(uy < 0.0, wp[1] - cfg.collision.restitution * uy, vy),
            vy,
        )
        fr = 1.0 - cfg.collision.friction
        v3 = jnp.stack(
            [jnp.where(contact, wp[0] + (v3[0] - wp[0]) * fr, v3[0]), vy,
             jnp.where(contact, wp[2] + (v3[2] - wp[2]) * fr, v3[2])]
        )
    if cfg.collision.enable_spheres and sphere_radii.shape[0] > 0:
        for s in range(sphere_radii.shape[0]):
            c = sphere_centers[s].reshape(3, 1, 1)
            w = 0.0
            if top is not None and top.sphere_velocities is not None:
                w = top.sphere_velocities[s].reshape(3, 1, 1)
            d = x3 - c
            dist = jnp.sqrt(jnp.sum(d * d, axis=0))
            pen = sphere_radii[s] - dist
            contact = (pen > 0.0) & movable[0]
            n = d / jnp.maximum(dist, 1e-12)
            x3 = x3 + jnp.where(contact, pen, 0.0) * n
            un = jnp.sum((v3 - w) * n, axis=0)
            inward = contact & (un < 0.0)
            v3 = v3 - jnp.where(inward, (1.0 + cfg.collision.restitution) * un, 0.0) * n
            u2 = v3 - w
            un2 = jnp.sum(u2 * n, axis=0) * n
            ut = u2 - un2
            v3 = jnp.where(contact, w + un2 + ut * (1.0 - cfg.collision.friction), v3)
    if top is not None and collide._needs_capsule_box(top, cfg):
        xz, vz = collide.resolve_capsules_boxes_components(
            top, cfg, [x3[0], x3[1], x3[2]], [v3[0], v3[1], v3[2]], movable[0]
        )
        x3 = jnp.stack(xz)
        v3 = jnp.stack(vz)
    if top is not None and collide._needs_sdf(top, cfg):
        xz, vz = collide.resolve_sdfs_components(
            top, cfg, [x3[0], x3[1], x3[2]], [v3[0], v3[1], v3[2]], movable[0]
        )
        x3 = jnp.stack(xz)
        v3 = jnp.stack(vz)
    if scale is not None:
        scale = plastic_update_grid(x3, offsets, scale, cfg.plasticity)
    if alive is not None:
        alive = tear_update_grid(x3, offsets, alive, cfg.tear.strain_limit,
                                 rest_scale=scale)
    return x3, v3, alive, scale


def verlet_substep_grid(
    x3, xp3, inv_mass2, offsets, cfg: SimConfig, dt: float,
    plane_height, sphere_centers, sphere_radii, top=None, alive=None,
    scale=None,
):
    """Position-Verlet substep in stencil form (oracle substep_verlet).
    Returns ``(x_new, x3, alive, scale)`` with Nones preserved."""
    g = jnp.asarray(cfg.gravity, dtype=x3.dtype).reshape(3, 1, 1)
    movable = inv_mass2 > 0.0
    v_est = (x3 - xp3) / dt
    f = stencil_spring_forces(x3, v_est, offsets, cfg.springs.damping,
                              alive=alive, rest_scale=scale)
    if cfg.wind.enabled:
        f = f + wind_forces_grid(x3, v_est, cfg)
    accel = g + f * inv_mass2
    x_new = x3 + (x3 - xp3) * (1.0 - cfg.global_damping * dt) + accel * dt * dt
    x_new = jnp.where(movable, x_new, x3)
    contact = (x_new[1] < plane_height) & movable[0] \
        if cfg.collision.enable_plane else None
    x_new = _project_positions_grid(
        x_new, movable, cfg, plane_height, sphere_centers, sphere_radii, top
    )
    x_new = _plane_friction_grid(x_new, x3, cfg, dt, contact, top)
    x_new = _sphere_friction_grid(x_new, x3, cfg, dt, movable,
                                  sphere_centers, sphere_radii, top)
    x_new = _rest_friction_grid(x_new, x3, cfg, dt, movable, top)
    if scale is not None:
        scale = plastic_update_grid(x_new, offsets, scale, cfg.plasticity)
    if alive is not None:
        alive = tear_update_grid(x_new, offsets, alive,
                                 cfg.tear.strain_limit, rest_scale=scale)
    return x_new, x3, alive, scale


def _sphere_friction_grid(x3, x_start3, cfg, dt, movable, sphere_centers,
                          sphere_radii, top=None):
    """Grid twin of collide.sphere_friction_positions: damp the tangential
    substep displacement (relative to each sphere's kinematic velocity) by
    (1 - friction) at the substep-end contact shell.  ONCE per substep,
    after the plane friction."""
    mu = cfg.collision.friction
    if (not cfg.collision.enable_spheres or mu == 0.0
            or sphere_radii.shape[0] == 0):
        return x3
    shell = collide.SPHERE_CONTACT_SHELL
    for s in range(sphere_radii.shape[0]):
        c = sphere_centers[s].reshape(3, 1, 1)
        d = x3 - c
        dist = jnp.sqrt(jnp.sum(d * d, axis=0))
        n = d / jnp.maximum(dist, 1e-12)
        contact = (dist <= sphere_radii[s] * shell) & movable[0]
        if top is not None and top.sphere_velocities is not None:
            w = top.sphere_velocities[s].reshape(3, 1, 1)
        else:
            w = jnp.zeros((3, 1, 1), x3.dtype)
        rel = (x3 - x_start3) - w * dt
        rel_t = rel - jnp.sum(rel * n, axis=0) * n
        x3 = jnp.where(contact, x3 - mu * rel_t, x3)
    return x3


def _rest_friction_grid(x3, x_start3, cfg, dt, movable, top=None):
    """Grid twin of collide.rest_friction_positions: capsule/box/SDF
    position-level friction on [3, ny, nx] planes (ONCE per substep,
    after the sphere friction)."""
    if top is None or cfg.collision.friction == 0.0 or not (
            collide._needs_capsule_box(top, cfg)
            or collide._needs_sdf(top, cfg)):
        return x3
    xz = collide.rest_friction_components(
        top, cfg, [x3[0], x3[1], x3[2]],
        [x_start3[0], x_start3[1], x_start3[2]], movable[0], dt)
    return jnp.stack(xz)


def _plane_friction_grid(x3, x_start3, cfg, dt, contact, top=None):
    """Grid-plane twin of collide.plane_friction_positions: damp the
    substep's tangential displacement (relative to the plane surface
    velocity) by (1 - friction) at the final projection's pre-clamp
    ``contact`` mask.  ONCE per substep."""
    mu = cfg.collision.friction
    if contact is None or not cfg.collision.enable_plane or mu == 0.0:
        return x3
    for ax in (0, 2):
        w = 0.0
        if top is not None and top.plane_velocity is not None:
            w = top.plane_velocity[ax]
        target = x_start3[ax] + w * dt
        x3 = x3.at[ax].set(jnp.where(
            contact, target + (x3[ax] - target) * (1.0 - mu), x3[ax]
        ))
    return x3


def _project_positions_grid(x3, movable, cfg, plane_height, sphere_centers,
                            sphere_radii, top=None):
    if cfg.collision.enable_plane:
        contact = (x3[1] < plane_height) & movable[0]
        x3 = x3.at[1].set(jnp.where(contact, plane_height, x3[1]))
    if cfg.collision.enable_spheres and sphere_radii.shape[0] > 0:
        for s in range(sphere_radii.shape[0]):
            c = sphere_centers[s].reshape(3, 1, 1)
            d = x3 - c
            dist = jnp.sqrt(jnp.sum(d * d, axis=0))
            pen = sphere_radii[s] - dist
            contact = (pen > 0.0) & movable[0]
            n = d / jnp.maximum(dist, 1e-12)
            x3 = x3 + jnp.where(contact, pen, 0.0) * n
    if top is not None and collide._needs_capsule_box(top, cfg):
        xz = collide.project_capsules_boxes_components(
            top, cfg, [x3[0], x3[1], x3[2]], movable[0]
        )
        x3 = jnp.stack(xz)
    if top is not None and collide._needs_sdf(top, cfg):
        xz = collide.project_sdfs_components(
            top, cfg, [x3[0], x3[1], x3[2]], movable[0]
        )
        x3 = jnp.stack(xz)
    return x3


def _xpbd_offsets(cfg: SimConfig, spacing: float, has_shear: bool, has_bend: bool):
    """(di, dj, compliance, rest_length) per spring class, mirroring the
    per-edge compliance assignment in core/topology._edge_arrays."""
    xp = cfg.xpbd
    offs = [
        (0, 1, xp.compliance_distance, spacing),
        (1, 0, xp.compliance_distance, spacing),
    ]
    if has_shear:
        r2 = spacing * float(np.sqrt(2.0))
        offs += [(1, 1, xp.compliance_distance, r2), (1, -1, xp.compliance_distance, r2)]
    if has_bend:
        offs += [(0, 2, xp.compliance_bend, 2 * spacing), (2, 0, xp.compliance_bend, 2 * spacing)]
    return offs


def xpbd_substep_grid(
    x3, v3, inv_mass2, xoffsets, cfg: SimConfig, dt: float,
    plane_height, sphere_centers, sphere_radii, top=None, alive=None,
    scale=None,
):
    """XPBD substep in stencil form (oracle substep_xpbd): predict, then
    ``n_iterations`` of Jacobi distance-constraint projection with
    compliance, count-averaged and under-relaxed, then position-only
    collide and velocity recovery.  Per-edge lambdas live as one
    ``[ny, nx]`` plane per offset class, carried across iterations.

    f32 drift control: the loop carries the substep's accumulated position
    change ``delta`` (small magnitudes, low-error additions) instead of
    repeatedly rounding tiny corrections into ``x`` — only the per-iteration
    *evaluation point* ``x_prev + delta`` takes a large+small rounding, and
    it is never stored.  This cut the 1k-step f32 bias 4.3e-3 -> 2.3e-6
    (exactly equal in real arithmetic; the oracle's plain accumulation is
    matched to f64 rounding by the exact-parity tier)."""
    ny, nx = x3.shape[-2], x3.shape[-1]
    g = jnp.asarray(cfg.gravity, dtype=x3.dtype).reshape(3, 1, 1)
    movable = inv_mass2 > 0.0
    w = inv_mass2[0]                                    # [ny, nx]

    accel = g
    if cfg.wind.enabled:
        # external forces enter XPBD through the velocity predict (oracle)
        accel = accel + wind_forces_grid(x3, v3, cfg) * inv_mass2
    v3 = (v3 + dt * accel) * (1.0 - cfg.global_damping * dt)
    v3 = jnp.where(movable, v3, 0.0)
    x_prev = x3
    delta0 = dt * v3

    # liveness planes subsume the validity masks (0 at invalid positions);
    # dead edges leave both the projection and the Jacobi count
    if alive is None:
        masks = [jnp.asarray(_valid_mask(ny, nx, di, dj))
                 for di, dj, _, _ in xoffsets]
    else:
        masks = [alive[o] for o in range(len(xoffsets))]
    # per-vertex constraint count: owned edges + edges owning this vertex
    cnt = jnp.zeros((ny, nx), x3.dtype)
    for (di, dj, _, _), m in zip(xoffsets, masks):
        cnt = cnt + m + _shift(m, -di, -dj)
    cnt = jnp.maximum(cnt, 1.0)

    def iteration(carry, _):
        delta, lams, contact_in = carry
        xe = x_prev + delta            # evaluation point (not stored)
        dx = jnp.zeros_like(xe)
        new_lams = []
        for o, ((di, dj, alpha, rest), m, lam) in enumerate(
                zip(xoffsets, masks, lams)):
            xn = _shift(xe, di, dj)
            d = xn - xe
            # grad-safe norm, bit-identical fwd (stencil_spring_forces)
            length, n = length_dir_planes(d)
            # plastic rest scale is substep-constant (oracle: the update
            # runs after the iteration loop)
            rest_eff = rest if scale is None else rest * scale[o]
            c_val = length - rest_eff
            alpha_t = alpha / (dt * dt)
            wn = _shift(w[None], di, dj)[0]
            denom = jnp.maximum(w + wn + alpha_t, 1e-12)
            dlam = -(c_val + alpha_t * lam) / denom * m
            new_lams.append(lam + dlam)
            # dx_a = -w * dlam * n at the owner; dx_b = +wn * dlam * n at
            # the neighbour (scattered by the reverse shift)
            contrib_a = -(w * dlam) * n
            contrib_b = (wn * dlam) * n
            dx = dx + contrib_a + _shift(contrib_b, -di, -dj)
        delta = delta + cfg.xpbd.relaxation * dx / cnt
        # contacts projected inside the loop (see oracle substep_xpbd),
        # rebased into delta form — plane clamp in the exact
        # ``plane - x_prev`` form, spheres as the projection displacement
        # (same forms as every other XPBD path; collide.py
        # project_positions_delta)
        pc = jnp.zeros((ny, nx), bool)
        if cfg.collision.enable_plane:
            xe1 = x_prev[1] + delta[1]
            pc = (xe1 < plane_height) & movable[0]
            delta = delta.at[1].set(
                jnp.where(pc, plane_height - x_prev[1], delta[1])
            )
        if cfg.collision.enable_spheres and sphere_radii.shape[0] > 0:
            xe = x_prev + delta
            xproj = xe
            for s in range(sphere_radii.shape[0]):
                c = sphere_centers[s].reshape(3, 1, 1)
                d = xproj - c
                dist = jnp.sqrt(jnp.sum(d * d, axis=0))
                pen = sphere_radii[s] - dist
                contact = (pen > 0.0) & movable[0]
                n = d / jnp.maximum(dist, 1e-12)
                xproj = xproj + jnp.where(contact, pen, 0.0) * n
            delta = delta + (xproj - xe)
        if top is not None and collide._needs_capsule_box(top, cfg):
            xe = x_prev + delta
            xz = collide.project_capsules_boxes_components(
                top, cfg, [xe[0], xe[1], xe[2]], movable[0]
            )
            delta = delta + (jnp.stack(xz) - xe)
        if top is not None and collide._needs_sdf(top, cfg):
            xe = x_prev + delta
            xz = collide.project_sdfs_components(
                top, cfg, [xe[0], xe[1], xe[2]], movable[0]
            )
            delta = delta + (jnp.stack(xz) - xe)
        return (delta, tuple(new_lams), contact_in | pc), None

    lams0 = tuple(jnp.zeros((ny, nx), x3.dtype) for _ in xoffsets)
    pc0 = jnp.zeros((ny, nx), bool)
    (delta, _, contact), _ = jax.lax.scan(
        iteration, (delta0, lams0, pc0), None, length=cfg.xpbd.n_iterations
    )
    # plane friction ONCE per substep, from the OR of the iterations'
    # pre-clamp contact masks (oracle substep_xpbd; delta form of
    # collide.plane_friction_delta)
    if cfg.collision.enable_plane and cfg.collision.friction != 0.0:
        mu = cfg.collision.friction
        for ax in (0, 2):
            wv = 0.0
            if top is not None and top.plane_velocity is not None:
                wv = top.plane_velocity[ax]
            wdt = wv * dt
            delta = delta.at[ax].set(jnp.where(
                contact, wdt + (delta[ax] - wdt) * (1.0 - mu), delta[ax]
            ))
    # sphere + capsule/box/SDF friction at the substep-end contact shells
    # (delta rebased)
    xe = x_prev + delta
    xf = _sphere_friction_grid(xe, x_prev, cfg, dt, movable,
                               sphere_centers, sphere_radii, top)
    xf = _rest_friction_grid(xf, x_prev, cfg, dt, movable, top)
    delta = delta + (xf - xe)
    delta = jnp.where(movable, delta, 0.0)
    x_new = x_prev + delta
    if scale is not None:
        scale = plastic_update_grid(x_new, xoffsets, scale, cfg.plasticity)
    if alive is not None:
        alive = tear_update_grid(x_new, xoffsets, alive,
                                 cfg.tear.strain_limit, rest_scale=scale)
    return x_new, delta / dt, alive, scale


def tear_plane_maps(top: Topology, offsets, ny: int, nx: int):
    """(alive_to_planes, planes_to_alive): flat-[E] <-> per-offset-plane
    liveness conversion.  Edge e maps to (offset o, owner vertex) where
    owner + (di,dj) = neighbour.  Pure index arithmetic under jit (one
    scatter + one gather per FRAME, not per substep).  Offset (di,dj)
    order is identical in _offsets and _xpbd_offsets, so one mapping
    serves all solvers."""
    import numpy as np

    offs_dij = [(o[0], o[1]) for o in offsets]
    if isinstance(top.edges, jax.core.Tracer):
        # called at trace time (dispatch inside api's jitted step): the
        # index math stays symbolic — no value fetch happens
        xp = jnp
        a_idx = top.edges[:, 0]
        b_idx = top.edges[:, 1]
    else:
        # called with a concrete Topology (maker used directly, fn jitted
        # afterwards): do the pure index arithmetic HOST-side — a device
        # plane_idx would be captured as a jit closure constant, which
        # fetches its value at trace time (repo CLAUDE.md rule)
        xp = np
        edges_h = np.asarray(top.edges)
        a_idx = edges_h[:, 0]
        b_idx = edges_h[:, 1]
    di_e = b_idx // nx - a_idx // nx
    dj_e = b_idx % nx - a_idx % nx
    o_e = xp.zeros_like(a_idx)
    owner = a_idx
    for o, (di, dj) in enumerate(offs_dij):
        fwd = (di_e == di) & (dj_e == dj)
        rev = (di_e == -di) & (dj_e == -dj)
        o_e = xp.where(fwd | rev, o, o_e)
        owner = xp.where(rev, b_idx, owner)
    # concrete case: plane_idx stays a HOST numpy array — closing over it
    # embeds the values at lowering with no device fetch
    plane_idx = o_e * (ny * nx) + owner
    n_off = len(offsets)

    def alive_to_planes(alive):
        flat = jnp.zeros((n_off * ny * nx,), alive.dtype)
        return flat.at[plane_idx].set(alive).reshape(n_off, ny, nx)

    def planes_to_alive(planes):
        return planes.reshape(-1)[plane_idx]

    return alive_to_planes, planes_to_alive


def make_stencil_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` for a grid-cloth scene.

    Supports all three solvers (BASELINE.json:5 Euler / Verlet / XPBD) in
    stencil form; semantics identical to the general edge-list path.
    """
    from ..core.config import Solver

    if cfg.strain_limit.enabled:
        # the stencil path does not implement the strain-limit sweeps;
        # silently dropping them would be a semantics bug — the dispatcher
        # routes strain-limited scenes to the jnp banded path instead
        raise ValueError(
            "strain limiting is not implemented on the stencil path")

    ny, nx = top.grid_shape
    spacing = top.grid_spacing
    has_shear = EDGE_SHEAR in top.edge_classes_present
    has_bend = EDGE_BEND in top.edge_classes_present
    offsets = _offsets(cfg, spacing, has_shear, has_bend)
    xoffsets = _xpbd_offsets(cfg, spacing, has_shear, has_bend)
    inv_mass2 = top.inv_mass.reshape(1, ny, nx)
    colliders = (top.plane_height, top.sphere_centers, top.sphere_radii, top)

    def to_planes(a):      # [N,3] -> [3,ny,nx]
        return a.T.reshape(3, ny, nx)

    def from_planes(a):    # [3,ny,nx] -> [N,3]
        return a.reshape(3, ny * nx).T

    tearing = cfg.tear.enabled
    plastic = cfg.plasticity.enabled
    if tearing or plastic:
        # one flat-[E] <-> plane mapping serves both liveness masks and
        # rest-scale planes (pure per-edge index arithmetic)
        alive_to_planes, planes_to_alive = tear_plane_maps(
            top, offsets, ny, nx
        )

    def fn(state: State, dt: float, n_substeps: int) -> State:
        x3 = to_planes(state.x)
        v3 = to_planes(state.v)
        xp3 = to_planes(state.x_prev)
        ap = alive_to_planes(state.edge_alive) if tearing else None
        sp = alive_to_planes(state.rest_scale) if plastic else None

        if cfg.solver == Solver.SEMI_IMPLICIT_EULER:

            def body(carry, _):
                x3, v3, ap, sp = carry
                out = euler_substep_grid(
                    x3, v3, inv_mass2, offsets, cfg, dt, *colliders,
                    alive=ap, scale=sp,
                )
                return out, None

            (x3f, v3f, apf, spf), _ = jax.lax.scan(
                body, (x3, v3, ap, sp), None, length=n_substeps
            )
            # the Euler solver never reads x_prev; reconstruct the natural
            # value (position before the final integrate) cheaply
            xp3f = x3f - dt * v3f
        elif cfg.solver == Solver.VERLET:

            def body(carry, _):
                x3, xp3, ap, sp = carry
                out = verlet_substep_grid(
                    x3, xp3, inv_mass2, offsets, cfg, dt, *colliders,
                    alive=ap, scale=sp,
                )
                return out, None

            (x3f, xp3f, apf, spf), _ = jax.lax.scan(
                body, (x3, xp3, ap, sp), None, length=n_substeps
            )
            v3f = (x3f - xp3f) / dt
        elif cfg.solver == Solver.XPBD:

            def body(carry, _):
                x3, v3, ap, sp = carry
                out = xpbd_substep_grid(
                    x3, v3, inv_mass2, xoffsets, cfg, dt, *colliders,
                    alive=ap, scale=sp,
                )
                return out, None

            (x3f, v3f, apf, spf), _ = jax.lax.scan(
                body, (x3, v3, ap, sp), None, length=n_substeps
            )
            xp3f = x3f - dt * v3f  # = pre-collision predicted origin
        else:  # pragma: no cover
            raise ValueError(f"unsupported solver {cfg.solver}")

        return State(
            x=from_planes(x3f), v=from_planes(v3f), x_prev=from_planes(xp3f),
            edge_alive=planes_to_alive(apf) if tearing else state.edge_alive,
            rest_scale=(planes_to_alive(spf) if plastic
                        else state.rest_scale),
        )

    return fn
