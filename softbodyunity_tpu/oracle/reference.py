"""Float64 NumPy oracle — the binding definition of the physics.

The reference snapshot contains no runnable code (only the project title,
/root/reference/README.md:1), so "physics fidelity is validated against
reference trajectories at fixed dt" (BASELINE.json:5) is anchored here: this
module is a literal, slow, float64 implementation of the canonical Unity
soft-body frame loop — spring-force accumulation over edge lists,
semi-implicit Euler / Verlet integration, XPBD constraint projection with
compliance, plane/sphere collision resolve, vertex-normal recompute
(BASELINE.json:5).  Golden trajectories generated from this module are the
"reference trajectories"; the device path (f32) must track them to <=1e-3
positional drift over 1k steps (SURVEY.md C17, §4).

Semantics defined here, mirrored exactly by :mod:`softbodyunity_tpu.solver`:

Euler substep (Solver.SEMI_IMPLICIT_EULER):
  1. F  = spring forces (Hooke + axial damper) + self-collision penalty
  2. v  = (v + dt * (g + F * w)) * (1 - global_damping * dt); v[pinned] = 0
  3. x += dt * v
  4. volume-preservation projection (if tets): dx applied to x, v += dx/dt
  5. plane/sphere resolve (then capsules/boxes if enabled): position
     projection + velocity response (restitution on the inward normal
     component, friction on tangent); pinned vertices are never displaced

Verlet substep (Solver.VERLET):
  1. v_est = (x - x_prev)/dt;  F as above using v_est
  2. x_new = x + (x - x_prev) * (1 - global_damping*dt) + (g + F*w) * dt^2
  3. volume projection, then position-only collision projection
  4. x_prev, x = x, x_new;  v = (x - x_prev)/dt

XPBD substep (Solver.XPBD; BASELINE.json:9):
  1. v = (v + dt*g) * (1 - global_damping*dt); v[pinned] = 0
  2. x_prev = x;  x += dt*v   (predict)
  3. n_iterations of Jacobi projection over distance (incl. bend-class) and
     tet-volume constraints with compliance alpha_tilde = alpha/dt^2 and
     per-constraint lambda accumulated across iterations; per-vertex Jacobi
     corrections are averaged by constraint count and scaled by `relaxation`
  4. position-only collision projection
  5. v = (x - x_prev)/dt

Self-collision penalty (BASELINE.json:11): every unordered vertex pair with
distance < radius receives F = stiffness_sc * (radius - dist) * dir (no mesh
exclusions; configs choose radius < rest spacing).  The oracle computes this
brute-force O(N^2); the device path reproduces the same pair set exactly via
the spatial hash when cell capacity is not exceeded.
"""

from __future__ import annotations

import numpy as np

from ..core.config import SimConfig, Solver
from ..core.topology import HostTopology


def spring_forces(
    top: HostTopology, x: np.ndarray, v: np.ndarray,
    damping: "float | None" = None, cfg: SimConfig = None,
    alive: "np.ndarray | None" = None,
    rest_scale: "np.ndarray | None" = None,
) -> np.ndarray:
    """Per-edge Hooke + axial damper, scatter-added to both endpoints.
    ``alive`` (TearParams liveness mask f64[E] of {0,1}) silences torn
    edges; ``rest_scale`` (PlasticityParams f64[E]) multiplies the rest
    lengths; None means all edges live / unscaled."""
    c = cfg.springs.damping if damping is None else damping
    a = top.edges[:, 0]
    b = top.edges[:, 1]
    d = x[b] - x[a]                                   # [E,3]
    length = np.linalg.norm(d, axis=1)
    length = np.maximum(length, 1e-12)
    n = d / length[:, None]
    rel_v = np.einsum("ej,ej->e", v[b] - v[a], n)     # axial relative velocity
    rest = (top.rest_length if rest_scale is None
            else top.rest_length * rest_scale)
    fmag = top.edge_stiffness * (length - rest) + c * rel_v
    if alive is not None:
        fmag = fmag * alive
    f_edge = fmag[:, None] * n                        # force on endpoint a (toward b)
    forces = np.zeros_like(x)
    np.add.at(forces, a, f_edge)
    np.add.at(forces, b, -f_edge)
    return forces


def self_collision_forces(x: np.ndarray, radius: float, stiffness: float) -> np.ndarray:
    """Brute-force O(N^2) pairwise repulsion penalty (oracle ground truth)."""
    n = x.shape[0]
    diff = x[None, :, :] - x[:, None, :]              # [i, j] = x_j - x_i
    dist = np.linalg.norm(diff, axis=-1)
    np.fill_diagonal(dist, np.inf)
    overlap = radius - dist
    active = overlap > 0.0
    dirs = diff / np.maximum(dist, 1e-12)[:, :, None]
    # force on i is away from j: -dir * overlap * k
    f = -(stiffness * np.where(active, overlap, 0.0))[:, :, None] * dirs
    return f.sum(axis=1)


def volume_projection(
    top: HostTopology, x: np.ndarray, stiffness: float
) -> np.ndarray:
    """PBD-style tet volume-preservation projection; returns dx (Jacobi,
    count-averaged).  C = V - V0 with V = det/6."""
    if top.tets.shape[0] == 0 or stiffness == 0.0:
        return np.zeros_like(x)
    t = top.tets
    p0, p1, p2, p3 = x[t[:, 0]], x[t[:, 1]], x[t[:, 2]], x[t[:, 3]]
    vol = np.einsum("ij,ij->i", np.cross(p1 - p0, p2 - p0), p3 - p0) / 6.0
    c_val = vol - top.rest_volume
    g1 = np.cross(p2 - p0, p3 - p0) / 6.0
    g2 = np.cross(p3 - p0, p1 - p0) / 6.0
    g3 = np.cross(p1 - p0, p2 - p0) / 6.0
    g0 = -(g1 + g2 + g3)
    w = top.inv_mass
    w0, w1, w2, w3 = w[t[:, 0]], w[t[:, 1]], w[t[:, 2]], w[t[:, 3]]
    denom = (
        w0 * np.einsum("ij,ij->i", g0, g0)
        + w1 * np.einsum("ij,ij->i", g1, g1)
        + w2 * np.einsum("ij,ij->i", g2, g2)
        + w3 * np.einsum("ij,ij->i", g3, g3)
    )
    s = -c_val / np.maximum(denom, 1e-12)
    dx = np.zeros_like(x)
    cnt = np.zeros(x.shape[0])
    for col, g in zip(range(4), (g0, g1, g2, g3)):
        ids = t[:, col]
        np.add.at(dx, ids, (w[ids] * s)[:, None] * g)
        np.add.at(cnt, ids, 1.0)
    dx = stiffness * dx / np.maximum(cnt, 1.0)[:, None]
    return np.where((top.inv_mass > 0.0)[:, None], dx, 0.0)


def _collider_velocity(velocities, s):
    """Kinematic linear velocity of collider ``s`` (zeros = static, the
    default; see HostTopology *_velocities)."""
    if velocities is None:
        return np.zeros(3)
    return np.asarray(velocities, np.float64)[s]


def _contact_velocity_response(v, n, w, contact, restitution, friction):
    """Binding contact response in the collider's rest frame: with relative
    velocity u = v - w (``w`` the collider's kinematic velocity), remove the
    inward normal component of u (scaled by 1+restitution) and damp the
    tangential component of u by (1-friction) on contact.  With w = 0 this
    is exactly the classic static-collider response; with w != 0 friction
    drags vertices toward the collider's motion (a conveyor/carried cloth)
    and restitution bounces off the moving surface."""
    u = v - w[None, :]
    un = np.einsum("ij,ij->i", u, n)
    inward = contact & (un < 0.0)
    v = v - np.where(inward, (1.0 + restitution) * un, 0.0)[:, None] * n
    u2 = v - w[None, :]
    un2 = np.einsum("ij,ij->i", u2, n)[:, None] * n
    ut = u2 - un2
    return np.where(contact[:, None],
                    w[None, :] + un2 + ut * (1.0 - friction), v)


def resolve_plane(x, v, plane_y, restitution, friction, movable,
                  velocity=None):
    """Ground-plane resolve: project up to the plane, reflect inward normal
    velocity by -restitution, damp tangential velocity by (1-friction).

    ``velocity`` (length-3, default zeros) is the plane's kinematic SURFACE
    velocity — the geometry stays at ``plane_y`` (a conveyor belt): friction
    drags contacting vertices toward it and restitution reflects the
    relative vertical velocity."""
    w = np.zeros(3) if velocity is None else np.asarray(velocity, np.float64)
    contact = (x[:, 1] < plane_y) & movable
    x = x.copy()
    v = v.copy()
    x[:, 1] = np.where(contact, plane_y, x[:, 1])
    uy = v[:, 1] - w[1]
    v[:, 1] = np.where(
        contact, np.where(uy < 0.0, w[1] - restitution * uy, v[:, 1]),
        v[:, 1],
    )
    for ax in (0, 2):
        v[:, ax] = np.where(
            contact, w[ax] + (v[:, ax] - w[ax]) * (1.0 - friction), v[:, ax]
        )
    return x, v


def resolve_spheres(x, v, centers, radii, restitution, friction, movable,
                    velocities=None):
    """Push vertices out of each sphere along the radial normal; remove the
    inward RELATIVE normal velocity component (scaled by 1+restitution) and
    damp the relative tangential component by (1-friction) on contact.
    ``velocities`` [S,3] are per-sphere kinematic velocities (None =
    static)."""
    x = x.copy()
    v = v.copy()
    for s in range(centers.shape[0]):
        d = x - centers[s]
        dist = np.linalg.norm(d, axis=1)
        pen = radii[s] - dist
        contact = (pen > 0.0) & movable
        n = d / np.maximum(dist, 1e-12)[:, None]
        x = x + np.where(contact, pen, 0.0)[:, None] * n
        v = _contact_velocity_response(
            v, n, _collider_velocity(velocities, s), contact,
            restitution, friction,
        )
    return x, v


def _capsule_closest(x, p0, p1):
    """Closest point on the capsule's core segment to each vertex."""
    axis = p1 - p0
    l2 = float(np.dot(axis, axis))
    t = np.clip((x - p0) @ axis / max(l2, 1e-12), 0.0, 1.0)
    return p0 + t[:, None] * axis


def resolve_capsules(x, v, p0s, p1s, radii, restitution, friction, movable,
                     velocities=None):
    """Capsule resolve (Unity CapsuleCollider analogue): sphere semantics
    around the closest point on the core segment — push out along the
    radial normal, reflect the inward relative normal velocity by
    (1+restitution), damp the relative tangential component by (1-friction)
    on contact.  ``velocities`` [C,3] per-capsule kinematic velocities."""
    x = x.copy()
    v = v.copy()
    for s in range(radii.shape[0]):
        c = _capsule_closest(x, p0s[s], p1s[s])
        d = x - c
        dist = np.linalg.norm(d, axis=1)
        pen = radii[s] - dist
        contact = (pen > 0.0) & movable
        n = d / np.maximum(dist, 1e-12)[:, None]
        x = x + np.where(contact, pen, 0.0)[:, None] * n
        v = _contact_velocity_response(
            v, n, _collider_velocity(velocities, s), contact,
            restitution, friction,
        )
    return x, v


def _box_face_push(x, center, half, rot):
    """Per-vertex (inside, push, n): whether the vertex is inside the
    oriented box, the push-out distance to the nearest face, and the world
    face normal.  Local coords q = R^T (x - c); the exit face is the axis
    of minimum penetration h_i - |q_i| (ties broken x < y < z — the same
    deterministic rule in every implementation)."""
    q = (x - center) @ rot                         # [N, 3] local coords
    pen = half[None, :] - np.abs(q)
    inside = (pen > 0.0).all(axis=1)
    k0 = (pen[:, 0] <= pen[:, 1]) & (pen[:, 0] <= pen[:, 2])
    k1 = (~k0) & (pen[:, 1] <= pen[:, 2])
    kmask = np.stack([k0, k1, ~(k0 | k1)], axis=1)
    sgn = np.where(q >= 0.0, 1.0, -1.0)
    n = np.where(kmask, sgn, 0.0) @ rot.T          # world face normal
    push = (pen * kmask).sum(axis=1)
    return inside, push, n


def resolve_boxes(x, v, centers, half_extents, rotations, restitution,
                  friction, movable, velocities=None):
    """Oriented-box resolve (Unity BoxCollider analogue): vertices inside
    the box are pushed out through the nearest face; velocity response as
    for plane/sphere (restitution on the inward relative normal component,
    friction on the relative tangent).  ``velocities`` [B,3] per-box
    kinematic velocities."""
    x = x.copy()
    v = v.copy()
    for s in range(centers.shape[0]):
        inside, push, n = _box_face_push(
            x, centers[s], half_extents[s], rotations[s]
        )
        contact = inside & movable
        x = x + np.where(contact, push, 0.0)[:, None] * n
        v = _contact_velocity_response(
            v, n, _collider_velocity(velocities, s), contact,
            restitution, friction,
        )
    return x, v


def _sdf_sample_grad(grid, origin, spacing, x):
    """Trilinear SDF sample + analytic gradient at points ``x`` [N,3].

    The binding sampling semantics for mesh (SDF) colliders, mirrored
    exactly by ``solver/collide.py`` ``sdf_sample_grad_components``:
    cell index floor-clamped to the interior, fractional coordinate
    clamped to [0,1] (border values extend outward — the grid is built
    with a positive-distance pad so clamped regions are never in
    contact), value = trilinear blend of the 8 cell corners, gradient =
    the trilinear interpolant's own derivative (bilinear blends of
    corner differences / spacing).  Returns (phi[N], grad[N,3])."""
    gx, gy, gz = grid.shape
    u = (x - origin[None, :]) / spacing
    i = np.clip(np.floor(u).astype(np.int64), 0,
                np.array([gx - 2, gy - 2, gz - 2]))
    f = np.clip(u - i, 0.0, 1.0)
    i0, j0, k0 = i[:, 0], i[:, 1], i[:, 2]
    c = [[[grid[i0 + a, j0 + b, k0 + cc] for cc in (0, 1)] for b in (0, 1)]
         for a in (0, 1)]
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    # interpolate z, then y, then x; keep the y-collapsed planes for ddx/ddy
    cz = [[c[a][b][0] * (1 - fz) + c[a][b][1] * fz for b in (0, 1)]
          for a in (0, 1)]
    cy = [cz[a][0] * (1 - fy) + cz[a][1] * fy for a in (0, 1)]
    phi = cy[0] * (1 - fx) + cy[1] * fx
    ddx = (cy[1] - cy[0]) / spacing
    ddy = ((cz[0][1] - cz[0][0]) * (1 - fx)
           + (cz[1][1] - cz[1][0]) * fx) / spacing
    dz = [[c[a][b][1] - c[a][b][0] for b in (0, 1)] for a in (0, 1)]
    ddz = ((dz[0][0] * (1 - fy) + dz[0][1] * fy) * (1 - fx)
           + (dz[1][0] * (1 - fy) + dz[1][1] * fy) * fx) / spacing
    return phi, np.stack([ddx, ddy, ddz], axis=1)


def resolve_sdfs(x, v, grids, origins, spacings, restitution, friction,
                 movable, velocities=None):
    """Mesh-collider (SDF) resolve: vertices with phi < 0 are pushed out
    along the normalized SDF gradient by -phi; velocity response as for
    plane/sphere (restitution on the inward relative normal component,
    friction on the relative tangent).  ``velocities`` [Sg,3] per-bake
    kinematic velocities (animate placement with move_colliders and set
    the matching velocity for correct contact drag)."""
    x = x.copy()
    v = v.copy()
    for s in range(grids.shape[0]):
        phi, grad = _sdf_sample_grad(grids[s], origins[s], spacings[s], x)
        pen = -phi
        contact = (pen > 0.0) & movable
        gn = np.linalg.norm(grad, axis=1)
        n = grad / np.maximum(gn, 1e-12)[:, None]
        x = x + np.where(contact, pen, 0.0)[:, None] * n
        v = _contact_velocity_response(
            v, n, _collider_velocity(velocities, s), contact,
            restitution, friction,
        )
    return x, v


def _has_sdfs(top: HostTopology, cfg: SimConfig) -> bool:
    return (
        cfg.collision.enable_sdf
        and getattr(top, "sdf_grids", None) is not None
        and top.sdf_grids.shape[0] > 0
    )


def _has_capsules(top: HostTopology, cfg: SimConfig) -> bool:
    return (
        cfg.collision.enable_capsules
        and top.capsule_radii is not None
        and top.capsule_radii.shape[0] > 0
    )


def _has_boxes(top: HostTopology, cfg: SimConfig) -> bool:
    return (
        cfg.collision.enable_boxes
        and top.box_centers is not None
        and top.box_centers.shape[0] > 0
    )


def project_positions_only(top: HostTopology, cfg: SimConfig, x, movable):
    """Position-only collision projection (Verlet / XPBD paths)."""
    if cfg.collision.enable_plane:
        contact = (x[:, 1] < top.plane_height) & movable
        x = x.copy()
        x[:, 1] = np.where(contact, top.plane_height, x[:, 1])
    if cfg.collision.enable_spheres:
        for s in range(top.sphere_centers.shape[0]):
            d = x - top.sphere_centers[s]
            dist = np.linalg.norm(d, axis=1)
            pen = top.sphere_radii[s] - dist
            contact = (pen > 0.0) & movable
            n = d / np.maximum(dist, 1e-12)[:, None]
            x = x + np.where(contact, pen, 0.0)[:, None] * n
    if _has_capsules(top, cfg):
        for s in range(top.capsule_radii.shape[0]):
            c = _capsule_closest(x, top.capsule_p0[s], top.capsule_p1[s])
            d = x - c
            dist = np.linalg.norm(d, axis=1)
            pen = top.capsule_radii[s] - dist
            contact = (pen > 0.0) & movable
            n = d / np.maximum(dist, 1e-12)[:, None]
            x = x + np.where(contact, pen, 0.0)[:, None] * n
    if _has_boxes(top, cfg):
        for s in range(top.box_centers.shape[0]):
            inside, push, n = _box_face_push(
                x, top.box_centers[s], top.box_half_extents[s],
                top.box_rotations[s],
            )
            contact = inside & movable
            x = x + np.where(contact, push, 0.0)[:, None] * n
    if _has_sdfs(top, cfg):
        for s in range(top.sdf_grids.shape[0]):
            phi, grad = _sdf_sample_grad(
                top.sdf_grids[s], top.sdf_origins[s], top.sdf_spacings[s], x
            )
            pen = -phi
            contact = (pen > 0.0) & movable
            n = grad / np.maximum(
                np.linalg.norm(grad, axis=1), 1e-12
            )[:, None]
            x = x + np.where(contact, pen, 0.0)[:, None] * n
    return x


def plane_friction_positions(top: HostTopology, cfg: SimConfig, x, x_start,
                             dt, contact):
    """Plane friction for the position-projection solvers (Verlet / XPBD)
    — the position-level mirror of resolve_plane's velocity response
    (``v = dx/dt`` makes the conventions identical): contacting vertices
    have their tangential displacement RELATIVE TO THE PLANE SURFACE
    damped by (1 - friction); ``plane_velocity`` gives conveyor dragging
    on the projection solvers too.

    ``contact`` is the pre-clamp penetration mask of the substep's plane
    projections — for Verlet the single projection's mask, for XPBD the
    OR across the Jacobi loop's projections (after the first in-loop
    clamp a resting vertex sits bit-exactly AT the plane, so the last
    iteration alone sees no penetration).  Pre-clamp ``y <
    plane_height`` is computed with identical arithmetic on every path,
    unlike a post-clamp ``y == plane_height`` equality, which wobbles by
    1 ulp in the delta form's ``x_prev + (plane_h - x_prev)``
    reconstruction.  The friction itself runs ONCE per substep — never
    per Jacobi iteration, which would compound the damping."""
    mu = cfg.collision.friction
    if not cfg.collision.enable_plane or mu == 0.0:
        return x
    w = (np.zeros(3) if top.plane_velocity is None
         else np.asarray(top.plane_velocity, np.float64))
    x = x.copy()
    for ax in (0, 2):
        target = x_start[:, ax] + w[ax] * dt
        x[:, ax] = np.where(
            contact, target + (x[:, ax] - target) * (1.0 - mu), x[:, ax]
        )
    return x


def plane_contact_preclamp(top: HostTopology, cfg: SimConfig, x, movable):
    """The final projection's pre-clamp plane penetration mask (the
    friction contact set; see plane_friction_positions)."""
    if not cfg.collision.enable_plane:
        return np.zeros(x.shape[0], bool)
    return (x[:, 1] < top.plane_height) & movable


# sphere-contact shell for the position-level friction test: projected
# vertices sit within ulps of the surface, so exact dist == r is a knife
# edge; the relative shell keeps resting verts safely inside and only
# verts hovering within 1e-5*r of the surface are chaos-sensitive
SPHERE_CONTACT_SHELL = 1.0 + 1e-5


def sphere_friction_positions(top: HostTopology, cfg: SimConfig, x, x_start,
                              dt, movable):
    """Substep-end sphere friction for the position-projection solvers
    (Verlet / XPBD): vertices ending the substep ON a sphere surface
    (``dist <= r * SPHERE_CONTACT_SHELL``) have the TANGENTIAL part of
    their substep displacement — relative to the sphere's kinematic
    surface velocity — damped by (1 - friction).  The normal component is
    untouched (the projection owns it).  Spheres apply sequentially in
    index order, after the plane friction; runs ONCE per substep.  The
    STATIC-collider path only: the coupled dynamic-sphere substeps keep
    their radial-only, no-tangential-coupling contract (solver/rigid.py).
    """
    mu = cfg.collision.friction
    if (not cfg.collision.enable_spheres or mu == 0.0
            or top.sphere_centers.shape[0] == 0):
        return x
    x = x.copy()
    for s in range(top.sphere_centers.shape[0]):
        w = _collider_velocity(top.sphere_velocities, s)
        x, _ = _one_sphere_friction(
            x, x_start, dt, movable, top.sphere_centers[s],
            top.sphere_radii[s], w, mu, None)
    return x


def _one_sphere_friction(x, x_start, dt, movable, center, radius, w, mu, m,
                         w_b=0.0):
    """One sphere's tangential friction on contacting vertices; returns
    ``(x, J_t)`` where J_t is the tangential impulse ``sum m_i dx_t_i/dt``
    removed from the cloth (the coupled paths react ``-J_t`` onto the
    dynamic ball; ``m=None`` skips the measurement).  ``w_b`` (the ball's
    inverse mass) engages the reduced-mass scaling for dynamic balls —
    see _project_spheres_measured; 0 = kinematic, full friction."""
    d = x - center
    dist = np.linalg.norm(d, axis=1)
    n = d / np.maximum(dist, 1e-12)[:, None]
    contact = (dist <= radius * SPHERE_CONTACT_SHELL) & movable
    rel = (x - x_start) - np.asarray(w)[None, :] * dt
    rel_t = rel - np.einsum("ij,ij->i", rel, n)[:, None] * n
    beta = (1.0 if m is None
            else 1.0 / (1.0 + w_b * (m * contact).sum()))
    dx_t = np.where(contact[:, None], -mu * beta * rel_t, 0.0)
    j_t = None if m is None else (m[:, None] * dx_t).sum(axis=0) / dt
    return x + dx_t, j_t


# contact shells for the capsule / box / SDF position-level friction (same
# knife-edge rationale as SPHERE_CONTACT_SHELL): capsules reuse the sphere
# rule around the closest core point; boxes use a shell of
# BOX_CONTACT_SHELL * max(half_extent) around the nearest face; SDFs a
# shell of SDF_CONTACT_SHELL * grid spacing around phi = 0 (projection
# leaves a residual phi of order pen * |1 - |grad||, far below this)
BOX_CONTACT_SHELL = 1e-5
SDF_CONTACT_SHELL = 1e-3


def _friction_tangent(x, x_start, dt, contact, n, w, mu):
    """Shared position-level friction rule: damp the tangential substep
    displacement (relative to the collider's kinematic velocity ``w``) by
    (1 - mu) at the contacting vertices; the normal component is owned by
    the projection and untouched."""
    rel = (x - x_start) - np.asarray(w)[None, :] * dt
    rel_t = rel - np.einsum("ij,ij->i", rel, n)[:, None] * n
    return np.where(contact[:, None], x - mu * rel_t, x)


def rest_friction_positions(top: HostTopology, cfg: SimConfig, x, x_start,
                            dt, movable, skip_boxes=False):
    """Substep-end capsule / box / SDF friction for the position-projection
    solvers (Verlet / XPBD) — the static-collider completion of
    plane_friction_positions + sphere_friction_positions: each collider
    class damps the tangential substep displacement of its contact-shell
    vertices by (1 - friction), sequentially in the projection order
    (capsules, then boxes, then SDFs), ONCE per substep, after the sphere
    friction.  ``skip_boxes`` when the boxes are dynamic this substep
    (their friction is the measured _one_box_friction)."""
    mu = cfg.collision.friction
    if mu == 0.0:
        return x
    x = np.asarray(x, np.float64).copy()
    if _has_capsules(top, cfg):
        for s in range(top.capsule_radii.shape[0]):
            c = _capsule_closest(x, top.capsule_p0[s], top.capsule_p1[s])
            d = x - c
            dist = np.linalg.norm(d, axis=1)
            n = d / np.maximum(dist, 1e-12)[:, None]
            contact = (dist <= top.capsule_radii[s] * SPHERE_CONTACT_SHELL) \
                & movable
            w = _collider_velocity(top.capsule_velocities, s)
            x = _friction_tangent(x, x_start, dt, contact, n, w, mu)
    if _has_boxes(top, cfg) and not skip_boxes:
        for s in range(top.box_centers.shape[0]):
            half = top.box_half_extents[s]
            shell = BOX_CONTACT_SHELL * float(np.max(half))
            q = (x - top.box_centers[s]) @ top.box_rotations[s]
            pen = half[None, :] - np.abs(q)
            mn = pen.min(axis=1)
            contact = (mn >= -shell) & (mn <= shell) & movable
            _, _, n = _box_face_push(
                x, top.box_centers[s], half, top.box_rotations[s])
            w = _collider_velocity(top.box_velocities, s)
            x = _friction_tangent(x, x_start, dt, contact, n, w, mu)
    if _has_sdfs(top, cfg):
        for s in range(top.sdf_grids.shape[0]):
            phi, grad = _sdf_sample_grad(
                top.sdf_grids[s], top.sdf_origins[s], top.sdf_spacings[s], x
            )
            n = grad / np.maximum(
                np.linalg.norm(grad, axis=1), 1e-12)[:, None]
            shell = SDF_CONTACT_SHELL * float(top.sdf_spacings[s])
            contact = (phi <= shell) & movable
            w = _collider_velocity(
                getattr(top, "sdf_velocities", None), s)
            x = _friction_tangent(x, x_start, dt, contact, n, w, mu)
    return x


def wind_forces(top: HostTopology, cfg: SimConfig, x, v) -> np.ndarray:
    """Wind / aerodynamic force (WindParams semantics): isotropic drag
    toward the wind velocity plus a normal-projected lift term using the
    unit area-weighted vertex normal (C11)."""
    wp = cfg.wind
    vrel = np.asarray(wp.velocity)[None, :] - v
    f = wp.drag * vrel
    if wp.lift != 0.0 and top.triangles.shape[0] > 0:
        n = vertex_normals(top.triangles, x)
        f = f + wp.lift * np.einsum("ij,ij->i", vrel, n)[:, None] * n
    return f


def pressure_forces(top: HostTopology, cfg: SimConfig, x) -> np.ndarray:
    """Closed-shell gas pressure (PressureParams semantics, binding).

    Per pressure body b (tri_body/pressure_rest_volume, set by
    core.topology.enable_pressure): signed enclosed volume V_b, ideal-gas
    style pressure P_b = stiffness * (inflation * V0_b / V_b - 1), and a
    per-face force P_b * A * n_hat distributed equally to the face's three
    vertices (cross/6 per corner, cross = twice the outward area vector).
    The net force over a closed shell is exactly zero (the corner crosses
    telescope), so pressure never injects momentum."""
    pp = cfg.pressure
    f = np.zeros_like(x)
    if top.pressure_rest_volume is None:
        return f
    body = np.asarray(top.tri_body, np.int64)
    sel = body >= 0
    if not sel.any():
        return f
    tris = np.asarray(top.triangles, np.int64)[sel]
    b_ids = body[sel]
    n_bodies = top.pressure_rest_volume.shape[0]
    pa, pb, pc = x[tris[:, 0]], x[tris[:, 1]], x[tris[:, 2]]
    contrib = np.einsum("ij,ij->i", pa, np.cross(pb, pc)) / 6.0
    vol = np.zeros(n_bodies)
    np.add.at(vol, b_ids, contrib)
    v0 = np.asarray(top.pressure_rest_volume)
    p_body = pp.stiffness * (
        pp.inflation * v0 / np.maximum(vol, 1e-9 * v0) - 1.0
    )
    cross = np.cross(pb - pa, pc - pa)
    f_corner = p_body[b_ids][:, None] * cross / 6.0
    for col in range(3):
        np.add.at(f, tris[:, col], f_corner)
    return f


def tear_update(top: HostTopology, cfg: SimConfig, x, alive,
                rest_scale=None):
    """End-of-substep tear check (TearParams semantics, binding): an edge
    whose post-substep elongation exceeds the strain limit dies forever.
    Plastic flow (``rest_scale``) rescales the rest length first, so
    creeping edges tear later."""
    a = top.edges[:, 0]
    b = top.edges[:, 1]
    length = np.linalg.norm(x[b] - x[a], axis=1)
    rest = (top.rest_length if rest_scale is None
            else top.rest_length * rest_scale)
    limit = rest * (1.0 + cfg.tear.strain_limit)
    return alive * (length <= limit).astype(alive.dtype)


def plastic_update(top: HostTopology, cfg: SimConfig, x, scale):
    """End-of-substep plastic flow (PlasticityParams semantics, binding):
    edges strained past the yield point creep their rest-length scale
    toward the deformed length; runs BEFORE the tear check each substep."""
    a = top.edges[:, 0]
    b = top.edges[:, 1]
    length = np.linalg.norm(x[b] - x[a], axis=1)
    rest = np.maximum(top.rest_length * scale, 1e-12)
    strain = (length - rest) / rest
    pp = cfg.plasticity
    excess = np.sign(strain) * np.maximum(np.abs(strain) - pp.yield_strain,
                                          0.0)
    return np.clip(scale * (1.0 + pp.creep * excess),
                   pp.min_scale, pp.max_scale)


def _quat_to_matrix(q):
    """Unit quaternion (wxyz) -> rotation matrix."""
    w, qx, qy, qz = q
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - w * qz),
         2 * (qx * qz + w * qy)],
        [2 * (qx * qy + w * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - w * qx)],
        [2 * (qx * qz - w * qy), 2 * (qy * qz + w * qx),
         1 - 2 * (qx * qx + qy * qy)],
    ])


def extract_rotations(A, quats, iterations):
    """Rotation part of each cluster's shape matrix ``A`` f64[K,3,3] —
    the branchless warm-started quaternion iteration of Muller et al.
    2016 ("A Robust Method to Extract the Rotational Part of
    Deformations"), the BINDING extraction for ShapeMatchParams (the
    device twin solver/shapematch.py runs the identical fixed-iteration
    recurrence, so oracle and device agree to rounding, not merely in
    the converged limit).  Per sweep, with R = R(q) and columns r_i/a_i::

        omega = sum_i r_i x a_i / (|sum_i r_i . a_i| + 1e-9)
        q     = normalize(exp(omega / 2) * q)

    Returns the updated quaternions f64[K, 4] (wxyz)."""
    q = np.array(quats, np.float64)
    for _ in range(iterations):
        for k in range(A.shape[0]):
            R = _quat_to_matrix(q[k])
            num = (np.cross(R[:, 0], A[k][:, 0])
                   + np.cross(R[:, 1], A[k][:, 1])
                   + np.cross(R[:, 2], A[k][:, 2]))
            den = abs(float((R * A[k]).sum())) + 1e-9
            qn = _quat_mul(_quat_from_rotvec(num / den), q[k])
            q[k] = qn / np.linalg.norm(qn)
    return q


def shape_match_dx(top: HostTopology, cfg: SimConfig, x, quats):
    """Shape-matching position correction (ShapeMatchParams semantics,
    binding).  Per cluster (enable_shape_matching; weights ``m_i =
    1/inv_mass`` over the cluster's movable vertices): current mass
    centroid ``c``, shape matrix ``A = sum m_i (x_i - c) q_i^T`` (the
    rest offsets ``q_i = top.cluster_rest`` are centered so
    ``sum m_i q_i = 0`` and the centroid term drops), rotation ``R``
    from :func:`extract_rotations` warm-started at ``quats``, goals
    ``g_i = R q_i + c``, correction ``dx_i = stiffness * (g_i - x_i)``
    on movable members (zero net momentum by construction).  Returns
    ``(dx, quats')``."""
    sm = cfg.shape_match
    k = int(top.n_clusters)
    cid = np.maximum(np.asarray(top.cluster_id, np.int64), 0)
    member = (np.asarray(top.cluster_id, np.int64) >= 0) & (top.inv_mass > 0.0)
    m = np.where(member, 1.0 / np.maximum(top.inv_mass, 1e-30), 0.0)
    mass = np.zeros(k)
    np.add.at(mass, cid, m)
    cx = np.zeros((k, 3))
    np.add.at(cx, cid, m[:, None] * x)
    c = cx / np.maximum(mass, 1e-30)[:, None]
    A = np.zeros((k, 3, 3))
    np.add.at(A, cid, m[:, None, None]
              * x[:, :, None] * top.cluster_rest[:, None, :])
    quats = extract_rotations(A, quats, sm.iterations)
    # vectorized _quat_rotate: v + 2 qv x (qv x v + qw v)
    qn = quats[cid]
    qv, qw = qn[:, 1:], qn[:, 0:1]
    r = top.cluster_rest
    g = r + 2.0 * np.cross(qv, np.cross(qv, r) + qw * r) + c[cid]
    dx = sm.stiffness * (g - x)
    return np.where(member[:, None], dx, 0.0), quats


def _shape_match_enabled(top: HostTopology, cfg: SimConfig) -> bool:
    return (cfg.shape_match.enabled and top.cluster_id is not None
            and top.n_clusters > 0)


def strain_limit_dx(top: HostTopology, cfg: SimConfig, x, alive=None,
                    rest_scale=None):
    """Strain-limiting position correction (StrainLimitParams semantics,
    binding; Provot-style).  ``iterations`` Jacobi sweeps: every edge
    outside the ``[rest*(1-max_compress), rest*(1+max_stretch)]`` length
    band is projected back to the nearest bound, endpoints weighted by
    inverse mass, vertex updates averaged over the VIOLATING edges
    incident to it.  ``rest`` honours plasticity's scale; torn edges are
    inert; pinned vertices never move.  Returns the total dx."""
    sl = cfg.strain_limit
    w = top.inv_mass
    a_idx = top.edges[:, 0]
    b_idx = top.edges[:, 1]
    rest = (top.rest_length if rest_scale is None
            else top.rest_length * rest_scale)
    hi = rest * (1.0 + sl.max_stretch)
    lo = (rest * (1.0 - sl.max_compress) if sl.max_compress >= 0.0
          else np.zeros_like(rest))
    x = np.array(x, np.float64)
    x0 = x.copy()
    # Jacobi mean over the ALIVE incident edges (the xpbd_iteration
    # convention) — a violating-edge count would be DISCONTINUOUS in x,
    # letting f64 scatter-order noise flip counts and diverge device vs
    # oracle discretely; the alive count is constant per substep
    e_cnt = np.ones(a_idx.shape[0]) if alive is None else alive
    cnt = np.zeros(x.shape[0])
    np.add.at(cnt, a_idx, e_cnt)
    np.add.at(cnt, b_idx, e_cnt)
    inv_cnt = 1.0 / np.maximum(cnt, 1.0)
    for _ in range(sl.iterations):
        d = x[b_idx] - x[a_idx]
        length = np.linalg.norm(d, axis=1)
        n = d / np.maximum(length, 1e-12)[:, None]
        c_val = length - np.clip(length, lo, hi)
        if alive is not None:
            c_val = c_val * alive
        denom = w[a_idx] + w[b_idx]
        corr = c_val / np.maximum(denom, 1e-12)
        dx = np.zeros_like(x)
        np.add.at(dx, a_idx, (w[a_idx] * corr)[:, None] * n)
        np.add.at(dx, b_idx, -(w[b_idx] * corr)[:, None] * n)
        x = x + dx * inv_cnt[:, None]
    return x - x0


def tether_dx(top: HostTopology, cfg: SimConfig, x):
    """Motion-constraint position correction (MotionConstraintParams
    semantics, binding; the Unity Cloth ``maxDistance`` coefficient).
    Every movable vertex is clamped inside a sphere of radius
    ``tether_radius[i] * scale`` around ``tether_anchor[i]`` (``inf`` =
    unconstrained)::

        d      = x_i - anchor_i
        excess = max(|d| - radius_i * scale, 0)
        dx_i   = -excess * d / |d|

    Runs after integration / shape matching / strain limiting, before
    contact (contact always wins).  Returns dx."""
    d = x - top.tether_anchor
    dist = np.linalg.norm(d, axis=1)
    r = top.tether_radius * cfg.motion.scale
    excess = np.maximum(dist - r, 0.0)
    n = d / np.maximum(dist, 1e-12)[:, None]
    dx = -excess[:, None] * n
    return np.where((top.inv_mass > 0.0)[:, None], dx, 0.0)


def _motion_enabled(top: HostTopology, cfg: SimConfig) -> bool:
    return (cfg.motion.enabled
            and getattr(top, "tether_anchor", None) is not None)


def _total_forces(top, cfg, x, v, alive=None, rest_scale=None):
    f = spring_forces(top, x, v, cfg=cfg, alive=alive, rest_scale=rest_scale)
    if cfg.self_collision.enabled:
        f = f + self_collision_forces(
            x, cfg.self_collision.radius, cfg.self_collision.stiffness
        )
    if cfg.wind.enabled:
        f = f + wind_forces(top, cfg, x, v)
    if cfg.pressure.enabled:
        f = f + pressure_forces(top, cfg, x)
    return f


def _euler_integrate(top: HostTopology, cfg: SimConfig, x, v, dt,
                     alive=None, scale=None):
    """The Euler substep BEFORE contact resolve: forces, semi-implicit
    update, volume projection (shared with substep_euler_coupled)."""
    w = top.inv_mass[:, None]
    movable = top.inv_mass > 0.0
    g = np.asarray(cfg.gravity)
    f = _total_forces(top, cfg, x, v, alive=alive, rest_scale=scale)
    v = (v + dt * (g[None, :] + f * w)) * (1.0 - cfg.global_damping * dt)
    v = np.where(movable[:, None], v, 0.0)
    x_prev = x
    x = x + dt * v
    dx = volume_projection(top, x, cfg.volume_stiffness)
    x = x + dx
    v = v + dx / dt
    return x, v, x_prev, movable


def _resolve_plane_stage(top: HostTopology, cfg: SimConfig, x, v, movable):
    if cfg.collision.enable_plane:
        x, v = resolve_plane(
            x, v, top.plane_height, cfg.collision.restitution,
            cfg.collision.friction, movable,
            velocity=getattr(top, "plane_velocity", None),
        )
    return x, v


def _resolve_after_spheres(top: HostTopology, cfg: SimConfig, x, v, movable,
                           skip_boxes=False):
    """Capsules -> boxes -> SDFs (the resolve order after the spheres;
    shared with substep_euler_coupled).  ``skip_boxes`` when the boxes
    are DYNAMIC rigid bodies this substep (they resolve in the coupled
    box loop, not as static scenery)."""
    if _has_capsules(top, cfg):
        x, v = resolve_capsules(
            x, v, top.capsule_p0, top.capsule_p1, top.capsule_radii,
            cfg.collision.restitution, cfg.collision.friction, movable,
            velocities=getattr(top, "capsule_velocities", None),
        )
    if _has_boxes(top, cfg) and not skip_boxes:
        x, v = resolve_boxes(
            x, v, top.box_centers, top.box_half_extents, top.box_rotations,
            cfg.collision.restitution, cfg.collision.friction, movable,
            velocities=getattr(top, "box_velocities", None),
        )
    if _has_sdfs(top, cfg):
        x, v = resolve_sdfs(
            x, v, top.sdf_grids, top.sdf_origins, top.sdf_spacings,
            cfg.collision.restitution, cfg.collision.friction, movable,
            velocities=getattr(top, "sdf_velocities", None),
        )
    return x, v


def substep_euler(top: HostTopology, cfg: SimConfig, x, v, x_prev, dt,
                  alive=None, scale=None, quats=None):
    x, v, x_prev, movable = _euler_integrate(top, cfg, x, v, dt,
                                             alive=alive, scale=scale)
    if quats is not None:
        # shape matching runs after the (volume-projected) integration,
        # before collision — the contact projection always wins
        dxs, quats = shape_match_dx(top, cfg, x, quats)
        x = x + dxs
        v = v + dxs / dt
    if cfg.strain_limit.enabled:
        # strain limiting after shape matching, before collision; the
        # position clamp feeds back into velocity on the Euler solver
        dxl = strain_limit_dx(top, cfg, x, alive=alive, rest_scale=scale)
        x = x + dxl
        v = v + dxl / dt
    if _motion_enabled(top, cfg):
        # motion constraints after strain limiting, before collision
        # (contact always wins); velocity feedback on the Euler solver
        dxt = tether_dx(top, cfg, x)
        x = x + dxt
        v = v + dxt / dt
    x, v = _resolve_plane_stage(top, cfg, x, v, movable)
    if cfg.collision.enable_spheres:
        x, v = resolve_spheres(
            x, v, top.sphere_centers, top.sphere_radii,
            cfg.collision.restitution, cfg.collision.friction, movable,
            velocities=getattr(top, "sphere_velocities", None),
        )
    x, v = _resolve_after_spheres(top, cfg, x, v, movable)
    if scale is not None:
        scale = plastic_update(top, cfg, x, scale)
    if alive is not None:
        alive = tear_update(top, cfg, x, alive, rest_scale=scale)
    out = (x, v, x_prev, alive, scale)
    return out if quats is None else out + (quats,)


def substep_euler_coupled(top: HostTopology, cfg: SimConfig, x, v, x_prev,
                          rc, rv, r_inv_mass, dt, alive=None, scale=None,
                          romega=None, rq=None, boxes=None, quats=None):
    """Two-way coupled Euler substep (binding): the scene's spheres are
    DYNAMIC rigid bodies (centers ``rc`` f64[S,3], velocities ``rv``,
    angular velocities ``romega``, inverse masses ``r_inv_mass``;
    0 = kinematic) exchanging momentum with the cloth inside the substep
    — no host loop, no force fudge.

    Order per substep:

    1. rigid predict: ``rv += dt*g`` (dynamic spheres), ``rc += dt*rv``;
    2. the ordinary Euler cloth substep with sphere geometry at ``rc``;
       each contacting vertex sees the sphere's SURFACE velocity at its
       own contact point, ``w_i = rv + romega x (radius * n_i)`` (a
       spinning ball drags the cloth); the patch side of every
       position/velocity change is REDUCED-MASS scaled by
       ``beta = M/(M + m_patch)`` (see the in-loop comment) and the
       ball's center takes the complementary push; per-sphere linear
       impulse ``J = sum_i m_i dv_i`` and contact torque impulse
       ``L = sum_i (radius * n_i) x (m_i dv_i)`` are measured across
       that sphere's resolve;
    3. reaction: ``rv -= J * inv_m``; ``romega -= L * inv_I`` with the
       solid-sphere inertia ``I = (2/5) m r^2`` — contact exchanges
       linear AND angular momentum exactly;
    4. rigid-plane: the normal response bounces ``rv_y`` by restitution;
       the tangential friction impulse acts on the CONTACT-POINT velocity
       ``u = rv + romega x a`` (arm ``a = -r n``) with effective inverse
       mass ``k = inv_m + r^2 inv_I``: ``P = -friction * u_t / k``,
       ``rv += P inv_m``, ``romega += inv_I (a x P)`` — friction torque
       makes the ball ROLL instead of skid.

    The RigidState spheres resolve unconditionally (they ARE the rigid
    bodies; api.step_coupled rejects enable_spheres=False configs).

    ``boxes = (bc, bv, bom, bq, bw)`` promotes the scene's oriented boxes
    to dynamic rigid bodies too (inverse masses ``bw``; 0 = kinematic):
    same predict / cloth-exchange / environment pattern, with box-plane
    contact through corner impulses, ball-vs-box and corner-vs-face
    box-vs-box contacts (_box_environment) and the static box resolve
    skipped (the boxes are no longer scenery).
    """
    movable = top.inv_mass > 0.0
    g = np.asarray(cfg.gravity)
    if romega is None:
        romega = np.zeros_like(rv)
    radii = np.asarray(top.sphere_radii, np.float64)
    inv_i = r_inv_mass * 2.5 / np.maximum(radii * radii, 1e-12)
    dyn = (r_inv_mass > 0.0)[:, None]
    rv = np.where(dyn, rv + dt * g[None, :], rv)
    rc = rc + dt * rv
    if rq is not None:
        rq = _quat_integrate(rq, romega, dt)
    if boxes is not None:
        boxes = _boxes_predict(cfg, boxes, dt)

    x, v, x_prev, movable = _euler_integrate(top, cfg, x, v, dt,
                                             alive=alive, scale=scale)
    if quats is not None:
        # shape matching after integration, before all contact (the same
        # slot as the uncoupled substep_euler); the contact stages —
        # including the measured rigid exchanges below — always win
        dxs, quats = shape_match_dx(top, cfg, x, quats)
        x = x + dxs
        v = v + dxs / dt
    if cfg.strain_limit.enabled:
        dxl = strain_limit_dx(top, cfg, x, alive=alive, rest_scale=scale)
        x = x + dxl
        v = v + dxl / dt
    if _motion_enabled(top, cfg):
        dxt = tether_dx(top, cfg, x)
        x = x + dxt
        v = v + dxt / dt
    x, v = _resolve_plane_stage(top, cfg, x, v, movable)
    m = np.where(movable, 1.0 / np.maximum(top.inv_mass, 1e-12), 0.0)
    romega = np.array(romega, np.float64)
    for s in range(rc.shape[0]):
        d = x - rc[s]
        dist = np.linalg.norm(d, axis=1)
        pen = radii[s] - dist
        contact = (pen > 0.0) & movable
        n = d / np.maximum(dist, 1e-12)[:, None]
        # reduced-mass factor: the ball (mass M = 1/w_b) and its contact
        # patch (total contacting cloth mass m_c) exchange as a TWO-BODY
        # system — the patch side of every position/velocity change is
        # scaled by beta = M/(M + m_c) and the ball takes the complement.
        # Forcing vertices all the way to the ball frame and slapping the
        # full measured impulse back (the kinematic-collider rule, beta=1)
        # over-exchanges momentum by (M+m_c)/M and EXPLODES once
        # (1+e)*m_c > M (a stacked-ball resonance reached 790 m/s); with
        # beta the post-contact relative normal velocity is exactly
        # -e*u_n, Newton restitution for the patch exchange, stable for
        # any mass ratio.  Kinematic balls (w_b = 0) keep beta = 1: the
        # kinematic-collider semantics are unchanged.
        m_c = (m * contact).sum()
        beta = 1.0 / (1.0 + r_inv_mass[s] * m_c)
        dx = beta * np.where(contact, pen, 0.0)[:, None] * n
        x = x + dx
        rc[s] = rc[s] - r_inv_mass[s] * (m[:, None] * dx).sum(axis=0)
        # per-vertex surface velocity: linear + spin at the contact point
        arm = radii[s] * n
        w_i = rv[s][None, :] + np.cross(
            np.broadcast_to(romega[s], arm.shape), arm
        )
        v0 = v
        u = v - w_i
        un = np.einsum("ij,ij->i", u, n)
        inward = contact & (un < 0.0)
        v1 = v - np.where(
            inward, (1.0 + cfg.collision.restitution) * un, 0.0
        )[:, None] * n
        u2 = v1 - w_i
        un2 = np.einsum("ij,ij->i", u2, n)[:, None] * n
        ut = u2 - un2
        v_t = np.where(contact[:, None],
                       w_i + un2 + ut * (1.0 - cfg.collision.friction), v1)
        v = v0 + beta * (v_t - v0)
        dp = m[:, None] * (v - v0)
        rv[s] = rv[s] - dp.sum(axis=0) * r_inv_mass[s]
        romega[s] = romega[s] - np.cross(arm, dp).sum(axis=0) * inv_i[s]
    if boxes is not None:
        bc, bv, bom, bq, bw = boxes
        x, v, bc, bv, bom = _dynamic_boxes_euler(
            top, cfg, x, v, movable, m, bc, bv, bom, bq, bw)
        boxes = (bc, bv, bom, bq, bw)
    x, v = _resolve_after_spheres(top, cfg, x, v, movable,
                                  skip_boxes=boxes is not None)
    if cfg.collision.enable_plane:
        # dynamic sphere vs ground plane: normal bounce on rv, tangential
        # friction impulse at the contact point (arm a = -r n) so friction
        # torque makes the ball roll
        pen = top.plane_height - (rc[:, 1] - radii)
        hit = (pen > 0.0) & (r_inv_mass > 0.0)
        rc[:, 1] = np.where(hit, top.plane_height + radii, rc[:, 1])
        vy = rv[:, 1]
        rv[:, 1] = np.where(hit & (vy < 0.0),
                            -cfg.collision.restitution * vy, vy)
        arm = np.stack([np.zeros_like(radii), -radii,
                        np.zeros_like(radii)], axis=1)
        u = rv + np.cross(romega, arm)
        ut = u.copy()
        ut[:, 1] = 0.0
        k = r_inv_mass + inv_i * radii * radii
        p_t = -cfg.collision.friction * ut / np.maximum(k, 1e-12)[:, None]
        p_t = np.where(hit[:, None], p_t, 0.0)
        rv = rv + p_t * r_inv_mass[:, None]
        romega = romega + np.cross(arm, p_t) * inv_i[:, None]
    rc, rv, romega = _rigid_static_bounce(top, cfg, rc, rv, romega,
                                          r_inv_mass, inv_i, radii,
                                          skip_boxes=boxes is not None)
    rc, rv, romega = _rigid_rigid_bounce(cfg, rc, rv, romega,
                                         r_inv_mass, inv_i, radii)
    if boxes is not None:
        bc, bv, bom, bq, bw = boxes
        rc, rv, romega, bc, bv, bom = _box_environment(
            top, cfg, rc, rv, romega, r_inv_mass, inv_i, radii,
            bc, bv, bom, bq, bw)
        boxes = (bc, bv, bom, bq, bw)
    if top.joint_meta is not None:
        _require_joint_state(top, rq, boxes)
        rc, rv, romega, rq, boxes = _solve_rigid_joints(
            top, cfg, rc, rv, romega, rq, r_inv_mass, inv_i, boxes, dt)
    if top.attach_ids is not None:
        if rq is None:
            raise ValueError(
                "topology has rigid attachments: pass ball orientations rq")
        x, v, rc, rv, romega, rq = _solve_attachments(
            top, cfg, x, v, rc, rv, romega, rq, r_inv_mass, inv_i, dt)
    if top.attach_box_ids is not None:
        if boxes is None:
            raise ValueError(
                "topology has box attachments: pass dynamic boxes")
        bc, bv, bom, bq, bw = boxes
        x, v, bc, bv, bom, bq = _solve_box_attachments(
            top, cfg, x, v, bc, bv, bom, bq, bw, dt)
        boxes = (bc, bv, bom, bq, bw)
    if scale is not None:
        scale = plastic_update(top, cfg, x, scale)
    if alive is not None:
        alive = tear_update(top, cfg, x, alive, rest_scale=scale)
    out = (x, v, x_prev, rc, rv, romega, alive, scale)
    if quats is not None:
        out = out + (quats,)
    if rq is not None:
        out = out + (rq,)
    return out if boxes is None else out + (boxes,)


def _rigid_predict(cfg, rc, rv, r_inv_mass, dt):
    dyn = (r_inv_mass > 0.0)[:, None]
    rv = np.where(dyn, rv + dt * np.asarray(cfg.gravity)[None, :], rv)
    return rc + dt * rv, rv


# ---- quaternion helpers (wxyz; unit) — ball orientation state for rigid
# attachments (the attachment point rides the ball's rotation) -----------

def _quat_mul(p, q):
    pw, px, py, pz = p
    qw, qx, qy, qz = q
    return np.array([
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw,
    ])


def _quat_rotate(q, v):
    """Rotate vector v by unit quaternion q: v + 2 qv x (qv x v + qw v)."""
    qv = q[1:]
    return v + 2.0 * np.cross(qv, np.cross(qv, v) + q[0] * v)


def _quat_from_rotvec(t):
    """Exact exponential map (angle = |t|), series-safe near zero."""
    angle = np.linalg.norm(t)
    if angle < 1e-12:
        return np.array([1.0, 0.5 * t[0], 0.5 * t[1], 0.5 * t[2]])
    axis = t / angle
    h = 0.5 * angle
    return np.concatenate([[np.cos(h)], np.sin(h) * axis])


def _quat_integrate(rq, romega, dt):
    """Per-ball orientation update q' = normalize(exp(dt*omega/2) * q)."""
    out = rq.copy()
    for s in range(rq.shape[0]):
        q = _quat_mul(_quat_from_rotvec(dt * romega[s]), rq[s])
        out[s] = q / np.linalg.norm(q)
    return out


def _solve_attachments(top, cfg, x, v, rc, rv, romega, rq, r_inv_mass,
                       inv_i, dt):
    """Rigid attachments (binding semantics): each cloth vertex welded to
    a point in a ball's body frame is solved SEQUENTIALLY (Gauss-Seidel in
    attachment-index order), one pass per substep.  The constraint
    ``C = x_vid - (rc_b + R(q_b) a_local) = 0`` is closed exactly in the
    linearization by the generalized-inverse-mass split: with world arm
    ``a``, ``K = (w_v + w_b) I + ii (|a|^2 I - a a^T)`` and the correction
    ``P = -K^{-1} C`` (Sherman-Morrison closed form), the vertex takes
    ``+w_v P``, the ball center ``-w_b P``, the orientation the rotation
    vector ``-ii (a x P)``; velocities receive the same split over dt
    (``v`` None skips the vertex-velocity half — the position-projection
    solvers derive v from positions).  Kinematic balls (w_b = 0) drag the
    vertex exactly onto the target; pinned vertices (w_v = 0) anchor the
    ball."""
    x, rc, rv = np.array(x), np.array(rc), np.array(rv)
    romega, rq = np.array(romega), np.array(rq)
    v = None if v is None else np.array(v)
    for k in range(top.attach_ids.shape[0]):
        vid = int(top.attach_ids[k])
        b = int(top.attach_body[k])
        a = _quat_rotate(rq[b], np.asarray(top.attach_local[k], np.float64))
        C = x[vid] - (rc[b] + a)
        w_v = float(top.inv_mass[vid])
        w_b = float(r_inv_mass[b])
        ii = float(inv_i[b])
        al = w_v + w_b + ii * float(a @ a)
        if al <= 0.0:
            continue        # pinned vertex on a kinematic ball: inert
        P = -(C / al + ii * float(a @ C) * a
              / (al * max(w_v + w_b, 1e-12)))
        x[vid] = x[vid] + w_v * P
        if v is not None:
            v[vid] = v[vid] + w_v * P / dt
        rc[b] = rc[b] - w_b * P
        rv[b] = rv[b] - w_b * P / dt
        dth = -ii * np.cross(a, P)
        romega[b] = romega[b] + dth / dt
        q = _quat_mul(_quat_from_rotvec(dth), rq[b])
        rq[b] = q / np.linalg.norm(q)
    return x, v, rc, rv, romega, rq


def _project_spheres_measured(x, movable, m, rc, radii, dt,
                              r_inv_mass=None):
    """Position-only sphere projection at the rigid centers: returns
    (x, j_lin f64[S,3]) — the per-sphere projection momentum
    ``sum_i m_i dx_i / dt``.  The push is purely RADIAL (parallel to the
    contact normal through the center), so it exerts exactly zero torque
    — there is no angular term.

    ``r_inv_mass`` (dynamic balls) engages the reduced-mass pair split:
    the vertex side of each push is scaled by ``beta = M/(M + m_c)``
    (m_c = total contacting cloth mass) and the caller shifts the ball
    by the complement ``-w_b * j_lin * dt`` — without it the reaction
    ``-j_lin * w_b`` grows unbounded with m_c/M and a ball under a heavy
    cloth is catapulted.  ``None`` (kinematic geometry) keeps the full
    push, beta = 1."""
    j_lin = np.zeros((rc.shape[0], 3))
    for s in range(rc.shape[0]):
        d = x - rc[s]
        dist = np.linalg.norm(d, axis=1)
        pen = radii[s] - dist
        contact = (pen > 0.0) & movable
        n = d / np.maximum(dist, 1e-12)[:, None]
        beta = (1.0 if r_inv_mass is None
                else 1.0 / (1.0 + r_inv_mass[s] * (m * contact).sum()))
        dx = beta * np.where(contact, pen, 0.0)[:, None] * n
        x = x + dx
        j_lin[s] = (m[:, None] * dx / dt).sum(axis=0)
    return x, j_lin


# ---- dynamic rigid boxes (binding semantics) ----------------------------
# The scene's oriented boxes promote to dynamic rigid bodies exactly like
# the spheres: ``boxes = (bc, bv, bom, bq, bw)`` — centers f64[B,3],
# velocities, angular velocities, orientation quaternions (wxyz; the world
# rotation is R(bq) @ box_rotations, so identity bq = the build pose), and
# inverse masses (0 = kinematic).  Solid-box inertia is diagonal in the
# body frame, I_i = (m/3)(e_j^2 + e_k^2) for half extents e; the world
# inverse-inertia application is R diag(ib) R^T.  The torque-free
# gyroscopic precession term (omega x I omega) is NOT integrated — the
# standard game-engine rule (PhysX disables it by default): explicit
# integration of that term is unstable and a tumbling crate doesn't read
# differently without it.

_BOX_CORNER_SIGNS = np.array(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
     for sz in (-1.0, 1.0)])


def _quat_to_matrix(q):
    """Unit quaternion (wxyz) -> rotation matrix, world-from-body."""
    w, xq, yq, zq = q
    return np.array([
        [1 - 2 * (yq * yq + zq * zq), 2 * (xq * yq - w * zq),
         2 * (xq * zq + w * yq)],
        [2 * (xq * yq + w * zq), 1 - 2 * (xq * xq + zq * zq),
         2 * (yq * zq - w * xq)],
        [2 * (xq * zq - w * yq), 2 * (yq * zq + w * xq),
         1 - 2 * (xq * xq + yq * yq)],
    ])


def _box_inv_inertia_body(bw, half):
    """Solid-box inverse inertia, diagonal in the body frame, f64[B,3]."""
    e2 = half * half
    s = np.stack([e2[:, 1] + e2[:, 2], e2[:, 0] + e2[:, 2],
                  e2[:, 0] + e2[:, 1]], axis=1)
    return bw[:, None] * 3.0 / np.maximum(s, 1e-12)


def _box_world_rot(top, bq, s):
    """World rotation of dynamic box s: orientation quat on top of the
    build pose."""
    return _quat_to_matrix(bq[s]) @ np.asarray(top.box_rotations[s],
                                               np.float64)


def _dynamic_boxes_euler(top, cfg, x, v, movable, m, bc, bv, bom, bq, bw):
    """Velocity-level cloth<->box contact (the sphere loop of
    substep_euler_coupled generalized to oriented boxes): face push-out
    reduced-mass scaled (box center takes the complementary translation),
    restitution + friction against the box's SURFACE velocity at each
    contact point ``w_i = bv + bom x (x_i - bc)``; the measured impulse
    reacts on ``bv`` and — through the contact-point arms — on ``bom``
    via the world inverse inertia (a crate hit off-center spins away).
    The position push-out reacts on the CENTER only (no rotational
    position correction; angular momentum exchanges at the velocity
    level), mirroring the attachment/sphere convention."""
    e, mu = cfg.collision.restitution, cfg.collision.friction
    half = np.asarray(top.box_half_extents, np.float64)
    ib = _box_inv_inertia_body(bw, half)
    for s in range(bc.shape[0]):
        rot = _box_world_rot(top, bq, s)
        inside, push, n = _box_face_push(x, bc[s], half[s], rot)
        contact = inside & movable
        m_c = (m * contact).sum()
        beta = 1.0 / (1.0 + bw[s] * m_c)
        dx = beta * np.where(contact, push, 0.0)[:, None] * n
        x = x + dx
        bc[s] = bc[s] - bw[s] * (m[:, None] * dx).sum(axis=0)
        arm = x - bc[s]                      # contact-point arms
        w_i = bv[s][None, :] + np.cross(
            np.broadcast_to(bom[s], arm.shape), arm)
        v0 = v
        u = v - w_i
        un = np.einsum("ij,ij->i", u, n)
        inward = contact & (un < 0.0)
        v1 = v - np.where(inward, (1.0 + e) * un, 0.0)[:, None] * n
        u2 = v1 - w_i
        un2 = np.einsum("ij,ij->i", u2, n)[:, None] * n
        ut = u2 - un2
        v_t = np.where(contact[:, None], w_i + un2 + ut * (1.0 - mu), v1)
        v = v0 + beta * (v_t - v0)
        dp = m[:, None] * (v - v0)
        bv[s] = bv[s] - dp.sum(axis=0) * bw[s]
        L = np.cross(arm, dp).sum(axis=0)
        bom[s] = bom[s] - rot @ (ib[s] * (rot.T @ L))
    return x, v, bc, bv, bom


def _project_boxes_measured(top, x, movable, m, bc, bq, dt, bw):
    """Position-only box projection at the dynamic poses (the
    _project_spheres_measured analogue): face push-out, reduced-mass
    scaled; returns (x, j_lin f64[B,3]).  Like the sphere path, the
    position-level reaction is LINEAR only (callers shift centers by
    ``-w_b j_lin dt``); boxes exchange angular momentum through the
    box-plane corner impulses, not through cloth projection — the PBD
    coupled contract stays spin-free."""
    half = np.asarray(top.box_half_extents, np.float64)
    j_lin = np.zeros((bc.shape[0], 3))
    for s in range(bc.shape[0]):
        rot = _box_world_rot(top, bq, s)
        inside, push, n = _box_face_push(x, bc[s], half[s], rot)
        contact = inside & movable
        beta = 1.0 / (1.0 + bw[s] * (m * contact).sum())
        dx = beta * np.where(contact, push, 0.0)[:, None] * n
        x = x + dx
        j_lin[s] = (m[:, None] * dx / dt).sum(axis=0)
    return x, j_lin


def _one_box_friction(top, x, x_start, dt, movable, bc, bq, s, w, mu, m,
                      w_b):
    """One dynamic box's tangential position friction (the
    _one_sphere_friction analogue at the dynamic pose): contact-shell rule
    of rest_friction_positions (|min-axis penetration| <= shell), tangent
    from the face normal, relative to the box's LINEAR velocity ``w``,
    reduced-mass scaled; returns (x, J_t)."""
    half = np.asarray(top.box_half_extents[s], np.float64)
    shell = BOX_CONTACT_SHELL * float(np.max(half))
    rot = _box_world_rot(top, bq, s)
    q = (x - bc[s]) @ rot
    pen = half[None, :] - np.abs(q)
    mn = pen.min(axis=1)
    contact = (mn >= -shell) & (mn <= shell) & movable
    _, _, n = _box_face_push(x, bc[s], half, rot)
    rel = (x - x_start) - np.asarray(w)[None, :] * dt
    rel_t = rel - np.einsum("ij,ij->i", rel, n)[:, None] * n
    beta = 1.0 / (1.0 + w_b * (m * contact).sum())
    dx_t = np.where(contact[:, None], -mu * beta * rel_t, 0.0)
    j_t = (m[:, None] * dx_t).sum(axis=0) / dt
    return x + dx_t, j_t


def _box_plane_bounce(top, cfg, bc, bv, bom, bq, bw):
    """Dynamic box vs ground plane (shared by every coupled solver): the
    box lifts out by its deepest corner's penetration (translation only),
    then the corners that WERE penetrating receive SEQUENTIAL contact
    impulses in corner-index order (signs (-,-,-) .. (+,+,+) x/y/z
    fastest-last): a normal impulse with restitution on approach and a
    tangential friction impulse ``-mu u_t / k_t``, each with the exact
    effective inverse mass ``k = w_b + (r x d)^T I^-1 (r x d)`` at the
    corner arm r — corner impulses exert torque, so an edge-dropped crate
    tumbles flat and a sliding crate's friction makes it tip."""
    if not cfg.collision.enable_plane:
        return bc, bv, bom
    e, mu = cfg.collision.restitution, cfg.collision.friction
    half = np.asarray(top.box_half_extents, np.float64)
    ib = _box_inv_inertia_body(bw, half)
    n = np.array([0.0, 1.0, 0.0])
    for s in range(bc.shape[0]):
        if not bw[s] > 0.0:
            continue
        rot = _box_world_rot(top, bq, s)
        corners = bc[s][None, :] + (_BOX_CORNER_SIGNS * half[s]) @ rot.T
        pen = top.plane_height - corners[:, 1]
        lift = max(float(pen.max()), 0.0)
        bc[s, 1] += lift
        corners[:, 1] += lift

        def iinv(L):
            return rot @ (ib[s] * (rot.T @ L))

        for k in range(8):
            if not pen[k] > 0.0:
                continue
            r = corners[k] - bc[s]
            u = bv[s] + np.cross(bom[s], r)
            un = u[1]
            if un < 0.0:
                cr = np.cross(r, n)
                kn = bw[s] + cr @ iinv(cr)
                P = (-(1.0 + e) * un / max(kn, 1e-12)) * n
                bv[s] = bv[s] + P * bw[s]
                bom[s] = bom[s] + iinv(np.cross(r, P))
            u = bv[s] + np.cross(bom[s], r)
            ut = np.array([u[0], 0.0, u[2]])
            t = ut / max(np.linalg.norm(ut), 1e-12)
            ct = np.cross(r, t)
            kt = bw[s] + ct @ iinv(ct)
            Pt = -mu * ut / max(kt, 1e-12)
            bv[s] = bv[s] + Pt * bw[s]
            bom[s] = bom[s] + iinv(np.cross(r, Pt))
    return bc, bv, bom


def _solve3(K, b):
    """Closed-form 3x3 solve by cofactor expansion — the SAME operation
    order as the device twin (solver/rigid.py _solve3) so f64 parity is
    tight.  Returns (x, det)."""
    a00, a01, a02 = K[0, 0], K[0, 1], K[0, 2]
    a10, a11, a12 = K[1, 0], K[1, 1], K[1, 2]
    a20, a21, a22 = K[2, 0], K[2, 1], K[2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    x = np.array([
        c00 * b[0] + c10 * b[1] + c20 * b[2],
        c01 * b[0] + c11 * b[1] + c21 * b[2],
        c02 * b[0] + c12 * b[1] + c22 * b[2],
    ]) / max(det, 1e-18)
    return x, det


def _solve_box_attachments(top, cfg, x, v, bc, bv, bom, bq, bw, dt):
    """Box attachments (binding semantics): each cloth vertex welded to a
    point in a dynamic box's body frame, solved SEQUENTIALLY (Gauss-Seidel
    in attachment-index order), one pass per substep.  The constraint
    ``C = x_vid - (bc_b + R(q) R0 local) = 0`` closes exactly in the
    linearization through the full anisotropic generalized-inverse-mass
    matrix ``K = (w_v + w_b) I - [a]x Iinv_w [a]x`` (world arm ``a``,
    world inverse inertia ``Iinv_w = R diag(ib) R^T`` — SPD whenever
    either side is dynamic): ``P = -K^{-1} C`` by the cofactor closed
    form, vertex takes ``+w_v P``, box center ``-w_b P``, orientation the
    rotation vector ``-Iinv_w (a x P)``; velocities get the same split
    over dt (``v`` None skips the vertex-velocity half).  A kinematic box
    drags the vertex exactly; a pinned vertex anchors the box; pinned +
    kinematic (det = 0) is inert."""
    x, bc, bv = np.array(x), np.array(bc), np.array(bv)
    bom, bq = np.array(bom), np.array(bq)
    v = None if v is None else np.array(v)
    half = np.asarray(top.box_half_extents, np.float64)
    ib = _box_inv_inertia_body(bw, half)
    eye = np.eye(3)
    for k in range(top.attach_box_ids.shape[0]):
        vid = int(top.attach_box_ids[k])
        b = int(top.attach_box_body[k])
        rot = _box_world_rot(top, bq, b)
        a = rot @ np.asarray(top.attach_box_local[k], np.float64)
        C = x[vid] - (bc[b] + a)
        w_v = float(top.inv_mass[vid])
        w_b = float(bw[b])
        iinv_w = rot @ (ib[b][:, None] * rot.T)
        ax = np.array([[0.0, -a[2], a[1]],
                       [a[2], 0.0, -a[0]],
                       [-a[1], a[0], 0.0]])
        K = (w_v + w_b) * eye - ax @ iinv_w @ ax
        P, det = _solve3(K, C)
        if det <= 1e-18:
            continue                      # pinned vertex + kinematic box
        P = -P
        x[vid] = x[vid] + w_v * P
        if v is not None:
            v[vid] = v[vid] + w_v * P / dt
        bc[b] = bc[b] - w_b * P
        bv[b] = bv[b] - w_b * P / dt
        dth = -iinv_w @ np.cross(a, P)
        bom[b] = bom[b] + dth / dt
        q = _quat_mul(_quat_from_rotvec(dth), bq[b])
        bq[b] = q / np.linalg.norm(q)
    return x, v, bc, bv, bom, bq


def _skew(a):
    return np.array([[0.0, -a[2], a[1]],
                     [a[2], 0.0, -a[0]],
                     [-a[1], a[0], 0.0]])


def _require_joint_state(top, rq, boxes):
    """Joints bind to promoted rigid state: sphere sides need orientations
    (rq), box sides need the dynamic-box 5-tuple."""
    kinds = {k for _, ka, _, kb, _ in top.joint_meta for k in (ka, kb)}
    if "sphere" in kinds and rq is None:
        raise ValueError(
            "topology has sphere-side rigid joints: pass ball "
            "orientations rq")
    if "box" in kinds and boxes is None:
        raise ValueError(
            "topology has box-side rigid joints: pass dynamic boxes")


def _solve_rigid_joints(top, cfg, rc, rv, romega, rq, r_inv_mass, inv_i,
                        boxes, dt):
    """Rigid-rigid joints (binding semantics) — Unity Joint analogues
    between DYNAMIC bodies (spheres/boxes) and/or the world, solved
    SEQUENTIALLY in joint-index order, one Gauss-Seidel pass per substep,
    position-level with /dt velocity updates (the scheme of the cloth
    attachments, `_solve_attachments`).  Body refs are the static
    ``top.joint_meta`` records ``(jtype, kind_a, idx_a, kind_b, idx_b)``;
    anchors/axes live in the body frames (``joint_local_*`` /
    ``joint_axis_*``; a "world" side stores the world point/axis itself).

    * ball: the anchor constraint ``C = p_a - p_b = 0`` closes exactly in
      the linearization through the two-body generalized inverse mass
      ``K = (w_a + w_b) I - [a]x Iinv_a [a]x - [b]x Iinv_b [b]x``
      (cofactor solve, `_solve3`); the impulse ``P = -K^{-1} C`` is
      applied +P at arm ``a`` on body a and -P at arm ``b`` on body b —
      each side's center, velocity (/dt), orientation (rotation vector
      ``Iinv (arm x +-P)``) and omega update by its generalized masses.
    * hinge: FIRST the axis misalignment ``t = a_w x b_w`` is removed
      through the angular generalized inverse mass
      ``w_rot = n^T (Iinv_a + Iinv_b) n`` (body a rotates by
      ``+Iinv_a n lam``, body b by ``-Iinv_b n lam``,
      ``lam = |t| / w_rot``), THEN the ball solve runs on the rotated
      frames so the anchor is exact at pass end.
    * distance: the scalar ``C = |p_a - p_b| - rest`` along ``n`` with
      XPBD compliance: ``lam = -C / (w_eff + alpha/dt^2)``,
      ``w_eff = w_a + w_b + (a x n)^T Iinv_a (a x n) + (b x n)^T Iinv_b
      (b x n)``, impulse ``lam n`` applied like the ball impulse.
      ``alpha = 0`` is a rigid rod; > 0 closes the fraction
      ``w_eff/(w_eff + alpha/dt^2)`` of the error per pass (a spring).

    Kinematic bodies (w = 0, Iinv = 0) and world sides anchor without
    reacting; a joint whose two sides are both immovable is inert
    (det/w_eff guards).  Returns (rc, rv, romega, rq, boxes)."""
    rc, rv = np.array(rc, np.float64), np.array(rv, np.float64)
    romega = np.array(romega, np.float64)
    rq = None if rq is None else np.array(rq, np.float64)
    if boxes is not None:
        bc, bv, bom, bq, bw = (np.array(b, np.float64) for b in boxes)
        ib = _box_inv_inertia_body(bw, np.asarray(top.box_half_extents,
                                                  np.float64))
    eye = np.eye(3)

    def _iinv(kind, i):
        if kind == "world":
            return np.zeros((3, 3))
        if kind == "sphere":
            return inv_i[i] * eye
        rot = _box_world_rot(top, bq, i)
        return rot @ (ib[i][:, None] * rot.T)

    def _frame_vec(kind, i, v):
        if kind == "world":
            return np.asarray(v, np.float64)
        if kind == "sphere":
            return _quat_rotate(rq[i], np.asarray(v, np.float64))
        return _box_world_rot(top, bq, i) @ np.asarray(v, np.float64)

    def _side(kind, i, local):
        """(anchor point, world arm, inverse mass, world inverse inertia)."""
        if kind == "world":
            return np.asarray(local, np.float64), np.zeros(3), 0.0, \
                np.zeros((3, 3))
        a = _frame_vec(kind, i, local)
        c = rc[i] if kind == "sphere" else bc[i]
        w = float(r_inv_mass[i]) if kind == "sphere" else float(bw[i])
        return c + a, a, w, _iinv(kind, i)

    def _apply(kind, i, P, arm, iinv):
        """Impulse P at world arm `arm`: position-level with /dt velocity
        updates (kinematic sides take 0 via w = 0, Iinv = 0)."""
        if kind == "world":
            return
        dth = iinv @ np.cross(arm, P)
        if kind == "sphere":
            w = float(r_inv_mass[i])
            rc[i] = rc[i] + w * P
            rv[i] = rv[i] + w * P / dt
            romega[i] = romega[i] + dth / dt
            q = _quat_mul(_quat_from_rotvec(dth), rq[i])
            rq[i] = q / np.linalg.norm(q)
        else:
            w = float(bw[i])
            bc[i] = bc[i] + w * P
            bv[i] = bv[i] + w * P / dt
            bom[i] = bom[i] + dth / dt
            q = _quat_mul(_quat_from_rotvec(dth), bq[i])
            bq[i] = q / np.linalg.norm(q)

    def _apply_rot(kind, i, dth):
        if kind == "world":
            return
        if kind == "sphere":
            romega[i] = romega[i] + dth / dt
            q = _quat_mul(_quat_from_rotvec(dth), rq[i])
            rq[i] = q / np.linalg.norm(q)
        else:
            bom[i] = bom[i] + dth / dt
            q = _quat_mul(_quat_from_rotvec(dth), bq[i])
            bq[i] = q / np.linalg.norm(q)

    def _omega(kind, i):
        if kind == "world":
            return np.zeros(3)
        return romega[i] if kind == "sphere" else bom[i]

    def _apply_omega(kind, i, dom):
        """Velocity-only angular impulse (the hinge motor): omega moves,
        the orientation does NOT (a motor drives velocity, not pose)."""
        if kind == "world":
            return
        if kind == "sphere":
            romega[i] = romega[i] + dom
        else:
            bom[i] = bom[i] + dom

    def _ball_solve(kind_a, ia_, la, kind_b, ib_, lb):
        p_a, a, w_a, iinv_a = _side(kind_a, ia_, la)
        p_b, b_arm, w_b, iinv_b = _side(kind_b, ib_, lb)
        C = p_a - p_b
        sa, sb = _skew(a), _skew(b_arm)
        K = (w_a + w_b) * eye - sa @ iinv_a @ sa - sb @ iinv_b @ sb
        P, det = _solve3(K, C)
        if det <= 1e-18:
            return                           # both sides immovable: inert
        P = -P
        _apply(kind_a, ia_, P, a, iinv_a)
        _apply(kind_b, ib_, -P, b_arm, iinv_b)

    for k, (jtype, kind_a, ia_, kind_b, ib_) in enumerate(top.joint_meta):
        la = np.asarray(top.joint_local_a[k], np.float64)
        lb = np.asarray(top.joint_local_b[k], np.float64)
        if jtype == "hinge":
            aw = _frame_vec(kind_a, ia_, top.joint_axis_a[k])
            bw_ax = _frame_vec(kind_b, ib_, top.joint_axis_b[k])
            t = np.cross(aw, bw_ax)
            tn = np.linalg.norm(t)
            if tn > 1e-12:
                nhat = t / tn
                iinv_a, iinv_b = _iinv(kind_a, ia_), _iinv(kind_b, ib_)
                w_rot = nhat @ ((iinv_a + iinv_b) @ nhat)
                if w_rot > 1e-18:
                    lam = tn / w_rot
                    _apply_rot(kind_a, ia_, iinv_a @ (nhat * lam))
                    _apply_rot(kind_b, ib_, -(iinv_b @ (nhat * lam)))
            # limits (position-level) about the now-aligned axis, then
            # the ball anchor; the MOTOR runs last (velocity-level, so
            # the target relative speed is exact at pass end)
            lim = np.asarray(top.joint_limit[k], np.float64)
            mot = np.asarray(top.joint_motor[k], np.float64)
            use_lim, use_mot = lim[0] <= lim[1], mot[1] > 0.0
            if use_lim or use_mot:
                n_ax = _frame_vec(kind_a, ia_, top.joint_axis_a[k])
                n_ax = n_ax / np.linalg.norm(n_ax)
                iinv_a = _iinv(kind_a, ia_)
                iinv_b = _iinv(kind_b, ib_)
                w_rot = n_ax @ ((iinv_a + iinv_b) @ n_ax)
            if use_lim and w_rot > 1e-18:
                ra_w = _frame_vec(kind_a, ia_, top.joint_ref_a[k])
                rb_w = _frame_vec(kind_b, ib_, top.joint_ref_b[k])
                ra_p = ra_w - (ra_w @ n_ax) * n_ax
                rb_p = rb_w - (rb_w @ n_ax) * n_ax
                theta = np.arctan2(np.cross(rb_p, ra_p) @ n_ax,
                                   ra_p @ rb_p)
                excess = (theta - lim[1] if theta > lim[1]
                          else theta - lim[0] if theta < lim[0] else 0.0)
                if excess != 0.0:
                    lam = -excess / w_rot
                    _apply_rot(kind_a, ia_, iinv_a @ (n_ax * lam))
                    _apply_rot(kind_b, ib_, -(iinv_b @ (n_ax * lam)))
            _ball_solve(kind_a, ia_, la, kind_b, ib_, lb)
            if use_mot and w_rot > 1e-18:
                rel = (_omega(kind_a, ia_) - _omega(kind_b, ib_)) @ n_ax \
                    - mot[0]
                lam = np.clip(-rel / w_rot, -mot[1] * dt, mot[1] * dt)
                _apply_omega(kind_a, ia_, iinv_a @ (n_ax * lam))
                _apply_omega(kind_b, ib_, -(iinv_b @ (n_ax * lam)))
        elif jtype == "ball":
            _ball_solve(kind_a, ia_, la, kind_b, ib_, lb)
        else:                                               # distance
            p_a, a, w_a, iinv_a = _side(kind_a, ia_, la)
            p_b, b_arm, w_b, iinv_b = _side(kind_b, ib_, lb)
            d = p_a - p_b
            L = np.linalg.norm(d)
            nhat = d / max(L, 1e-12)
            C = L - float(top.joint_rest[k])
            axn, bxn = np.cross(a, nhat), np.cross(b_arm, nhat)
            w_eff = w_a + w_b + axn @ (iinv_a @ axn) + bxn @ (iinv_b @ bxn)
            alpha_t = float(top.joint_compliance[k]) / (dt * dt)
            if w_eff + alpha_t <= 1e-18:
                continue
            P = (-C / (w_eff + alpha_t)) * nhat
            _apply(kind_a, ia_, P, a, iinv_a)
            _apply(kind_b, ib_, -P, b_arm, iinv_b)

    out_boxes = None if boxes is None else (bc, bv, bom, bq, bw)
    return rc, rv, romega, rq, out_boxes


def _ball_box_bounce(top, cfg, rc, rv, romega, r_inv_mass, inv_i, radii,
                     bc, bv, bom, bq, bw, ib):
    """Dynamic ball vs dynamic box, pairwise sequential (ball-major,
    then box index): the ball-vs-static-box geometry (closest point
    outside, nearest-face push when the center is inside) generalized to
    a TWO-BODY exchange — inverse-mass-weighted separation, a normal
    impulse with restitution on approach (center velocities, the
    ball-ball convention), and a contact friction impulse with torque on
    BOTH bodies (ball arm ``-r n``, box arm ``p - bc`` at the ball's
    surface point) using the exact direction-dependent effective inverse
    mass.  Kinematic-kinematic pairs are inert scenery and skip."""
    e, mu = cfg.collision.restitution, cfg.collision.friction
    half = np.asarray(top.box_half_extents, np.float64)
    rc, rv, romega = rc.copy(), rv.copy(), romega.copy()
    bc, bv, bom = bc.copy(), bv.copy(), bom.copy()
    for i in range(rc.shape[0]):
        for s in range(bc.shape[0]):
            wi, ws = r_inv_mass[i], bw[s]
            wsum = wi + ws
            if not wsum > 0.0:
                continue
            rot = _box_world_rot(top, bq, s)
            q = rot.T @ (rc[i] - bc[s])
            qc = np.clip(q, -half[s], half[s])
            dloc = q - qc
            dist = np.linalg.norm(dloc)
            pen_f = half[s] - np.abs(q)
            inside = (pen_f > 0.0).all()
            if inside:
                k = int(np.argmin(pen_f))      # ties: argmin -> x < y < z
                sgn = 1.0 if q[k] >= 0.0 else -1.0
                n = sgn * rot[:, k]
                pen = pen_f[k] + radii[i]
            else:
                n = rot @ (dloc / max(dist, 1e-12))
                pen = radii[i] - dist
            if not pen > 0.0:
                continue
            rc[i] = rc[i] + pen * (wi / wsum) * n
            bc[s] = bc[s] - pen * (ws / wsum) * n
            un = float(np.dot(rv[i] - bv[s], n))
            if un < 0.0:
                p_n = -(1.0 + e) * un / wsum
                rv[i] = rv[i] + p_n * wi * n
                bv[s] = bv[s] - p_n * ws * n
            a_i = -radii[i] * n
            p_c = rc[i] + a_i                   # ball surface point
            a_s = p_c - bc[s]
            u = (rv[i] + np.cross(romega[i], a_i)) \
                - (bv[s] + np.cross(bom[s], a_s))
            ut = u - np.dot(u, n) * n
            t = ut / max(np.linalg.norm(ut), 1e-12)
            iinv_s = rot @ (ib[s][:, None] * rot.T)
            ct = np.cross(a_s, t)
            k_t = wsum + inv_i[i] * radii[i] ** 2 + ct @ (iinv_s @ ct)
            p_t = -mu * ut / max(k_t, 1e-12)
            rv[i] = rv[i] + p_t * wi
            romega[i] = romega[i] + np.cross(a_i, p_t) * inv_i[i]
            bv[s] = bv[s] - p_t * ws
            bom[s] = bom[s] - iinv_s @ np.cross(a_s, p_t)
    return rc, rv, romega, bc, bv, bom


def _box_box_bounce(top, cfg, bc, bv, bom, bq, bw, ib):
    """Dynamic box vs dynamic box: CORNER-vs-FACE contacts, ordered
    pairs (s, t), s != t, each of box s's 8 corners tested against box
    t's faces in corner-index order — the same sequential-impulse scheme
    as the box-plane bounce with box t's face normal in place of the
    plane normal and torque on BOTH bodies.  Covers resting stacks and
    tumbling collisions.

    A second pass over UNORDERED pairs (s < t) catches the manifolds the
    corner scheme cannot see — penetration with NO corner of either box
    inside the other — via a 15-axis SAT (`_box_sat_fallback_contact`):
    two boxes crossing like an X (minimal axis = an edge-cross axis;
    contact at the closest points of the two support edges) and two
    slabs crossing like a plus sign (minimal axis = a face axis; contact
    at the midpoint of the centers, the overlap centroid for symmetric
    crossings — a one-point approximation of the clipped face manifold).
    Perfectly FLUSH identical faces (corners exactly on the other box's
    face plane, a measure-zero alignment) still register only through
    the SAT pass's single point."""
    e, mu = cfg.collision.restitution, cfg.collision.friction
    half = np.asarray(top.box_half_extents, np.float64)
    bc, bv, bom = bc.copy(), bv.copy(), bom.copy()
    B = bc.shape[0]
    for s in range(B):
        for t in range(B):
            if s == t:
                continue
            ws, wt = bw[s], bw[t]
            wsum = ws + wt
            if not wsum > 0.0:
                continue
            rot_s = _box_world_rot(top, bq, s)
            rot_t = _box_world_rot(top, bq, t)
            iinv_s = rot_s @ (ib[s][:, None] * rot_s.T)
            iinv_t = rot_t @ (ib[t][:, None] * rot_t.T)
            for k in range(8):
                corner = bc[s] + rot_s @ (_BOX_CORNER_SIGNS[k] * half[s])
                q = rot_t.T @ (corner - bc[t])
                pen_f = half[t] - np.abs(q)
                if not (pen_f > 0.0).all():
                    continue
                kk = int(np.argmin(pen_f))
                sgn = 1.0 if q[kk] >= 0.0 else -1.0
                n = sgn * rot_t[:, kk]          # pushes the corner OUT
                push = pen_f[kk]
                bc[s] = bc[s] + push * (ws / wsum) * n
                bc[t] = bc[t] - push * (wt / wsum) * n
                r_s = corner - bc[s]
                r_t = corner - bc[t]
                u = (bv[s] + np.cross(bom[s], r_s)) \
                    - (bv[t] + np.cross(bom[t], r_t))
                un = float(np.dot(u, n))
                if un < 0.0:
                    cs = np.cross(r_s, n)
                    ctn = np.cross(r_t, n)
                    k_n = wsum + cs @ (iinv_s @ cs) + ctn @ (iinv_t @ ctn)
                    P = (-(1.0 + e) * un / max(k_n, 1e-12)) * n
                    bv[s] = bv[s] + P * ws
                    bom[s] = bom[s] + iinv_s @ np.cross(r_s, P)
                    bv[t] = bv[t] - P * wt
                    bom[t] = bom[t] - iinv_t @ np.cross(r_t, P)
                u2 = (bv[s] + np.cross(bom[s], r_s)) \
                    - (bv[t] + np.cross(bom[t], r_t))
                ut = u2 - np.dot(u2, n) * n
                th = ut / max(np.linalg.norm(ut), 1e-12)
                cst = np.cross(r_s, th)
                ctt = np.cross(r_t, th)
                k_t = wsum + cst @ (iinv_s @ cst) + ctt @ (iinv_t @ ctt)
                P_t = -mu * ut / max(k_t, 1e-12)
                bv[s] = bv[s] + P_t * ws
                bom[s] = bom[s] + iinv_s @ np.cross(r_s, P_t)
                bv[t] = bv[t] - P_t * wt
                bom[t] = bom[t] - iinv_t @ np.cross(r_t, P_t)
    # ---- SAT fallback pass (unordered pairs): the no-corner-inside
    # manifolds — X edge-edge crossings and plus-sign slab crossings ----
    for s in range(B):
        for t in range(s + 1, B):
            ws, wt = bw[s], bw[t]
            wsum = ws + wt
            if not wsum > 0.0:
                continue
            rot_s = _box_world_rot(top, bq, s)
            rot_t = _box_world_rot(top, bq, t)
            hit, n, depth, p = _box_sat_fallback_contact(
                bc[s], rot_s, half[s], bc[t], rot_t, half[t])
            if not hit:
                continue
            iinv_s = rot_s @ (ib[s][:, None] * rot_s.T)
            iinv_t = rot_t @ (ib[t][:, None] * rot_t.T)
            # n points s -> t: push s backward, t forward
            bc[s] = bc[s] - depth * (ws / wsum) * n
            bc[t] = bc[t] + depth * (wt / wsum) * n
            r_s = p - bc[s]
            r_t = p - bc[t]
            u = (bv[s] + np.cross(bom[s], r_s)) \
                - (bv[t] + np.cross(bom[t], r_t))
            un = float(np.dot(u, n))
            if un > 0.0:                 # closing along +n (s moving into t)
                cs = np.cross(r_s, n)
                ctn = np.cross(r_t, n)
                k_n = wsum + cs @ (iinv_s @ cs) + ctn @ (iinv_t @ ctn)
                e = cfg.collision.restitution
                P = (-(1.0 + e) * un / max(k_n, 1e-12)) * n
                bv[s] = bv[s] + P * ws
                bom[s] = bom[s] + iinv_s @ np.cross(r_s, P)
                bv[t] = bv[t] - P * wt
                bom[t] = bom[t] - iinv_t @ np.cross(r_t, P)
            u2 = (bv[s] + np.cross(bom[s], r_s)) \
                - (bv[t] + np.cross(bom[t], r_t))
            ut = u2 - np.dot(u2, n) * n
            th = ut / max(np.linalg.norm(ut), 1e-12)
            cst = np.cross(r_s, th)
            ctt = np.cross(r_t, th)
            k_t = wsum + cst @ (iinv_s @ cst) + ctt @ (iinv_t @ ctt)
            P_t = -cfg.collision.friction * ut / max(k_t, 1e-12)
            bv[s] = bv[s] + P_t * ws
            bom[s] = bom[s] + iinv_s @ np.cross(r_s, P_t)
            bv[t] = bv[t] - P_t * wt
            bom[t] = bom[t] - iinv_t @ np.cross(r_t, P_t)
    return bc, bv, bom


def _box_sat_fallback_contact(cs_, rot_s, hs, ct_, rot_t, ht):
    """15-axis OBB SAT, restricted to the manifolds the corner scheme
    misses: returns (hit, n, depth, point) with ``hit`` True only when
    the boxes penetrate AND no corner of either box is inside the other.
    ``n`` is the minimal-penetration axis oriented s -> t.  Cross-axis
    minimal: ``point`` = midpoint of the closest points of the two
    support edges; face-axis minimal: ``point`` = midpoint of the
    centers (the overlap centroid for symmetric crossings).  Axis order
    (s faces 0-2, t faces 3-5, crosses i*3+j at 6+) and first-minimum
    tie-breaking are part of the binding semantics (device twin mirrors
    them).

    Penetration SLOP: the contact fires only when the minimal overlap
    exceeds ``1e-3 x the smaller box dimension``.  A flush-resting stack
    sits at overlap = 0 +- 1 ULP and a strict > 0 gate chatters on
    rounding noise (oracle and device rounding differ, destroying
    parity, and f32 noise is ~1e-7 at unit scale); real crossings
    accumulate gravity penetration ~v*dt per substep and cross the slop
    transversally, so resting depth just oscillates in [0, slop] --
    invisible at 5e-5 of a 5 cm box."""
    slop = 1e-3 * min(float(hs.min()), float(ht.min()))
    d = ct_ - cs_
    no = (False, np.zeros(3), 0.0, np.zeros(3))
    # corner containment (either direction) => the corner scheme owns it
    corners_s = cs_[None, :] + (_BOX_CORNER_SIGNS * hs) @ rot_s.T
    q_in_t = np.abs((corners_s - ct_) @ rot_t)      # rot_t.T @ per row
    if (q_in_t < ht[None, :]).all(axis=1).any():
        return no
    corners_t = ct_[None, :] + (_BOX_CORNER_SIGNS * ht) @ rot_t.T
    q_in_s = np.abs((corners_t - cs_) @ rot_s)
    if (q_in_s < hs[None, :]).all(axis=1).any():
        return no
    # the 15 separating-axis candidates
    best_overlap = np.inf
    best_idx = -1
    best_axis = np.zeros(3)
    for idx in range(15):
        if idx < 3:
            u = rot_s[:, idx]
        elif idx < 6:
            u = rot_t[:, idx - 3]
        else:
            i, j = (idx - 6) // 3, (idx - 6) % 3
            u = np.cross(rot_s[:, i], rot_t[:, j])
            nu = np.linalg.norm(u)
            if nu < 1e-9:                 # near-parallel edges: degenerate
                continue
            u = u / nu
        ra = float(np.abs(u @ rot_s) @ hs)
        rb = float(np.abs(u @ rot_t) @ ht)
        overlap = ra + rb - abs(float(u @ d))
        if overlap <= 0.0:
            return no                     # separated
        if overlap < best_overlap:
            best_overlap = overlap
            best_idx = idx
            best_axis = u
    if best_overlap <= slop:
        return no
    n = best_axis if float(best_axis @ d) >= 0.0 else -best_axis
    if best_idx < 6:
        p = 0.5 * (cs_ + ct_)
        return True, n, best_overlap, p
    i, j = (best_idx - 6) // 3, (best_idx - 6) % 3
    a_dir, b_dir = rot_s[:, i], rot_t[:, j]
    # support edge of s along +n / of t along -n
    off_s = np.zeros(3)
    for k in range(3):
        if k != i:
            off_s = off_s + np.sign(n @ rot_s[:, k]) * hs[k] * rot_s[:, k]
    off_t = np.zeros(3)
    for k in range(3):
        if k != j:
            off_t = off_t - np.sign(n @ rot_t[:, k]) * ht[k] * rot_t[:, k]
    p_s0 = cs_ + off_s
    p_t0 = ct_ + off_t
    # closest points of the two edge lines, clamped to the edge extents
    r = p_t0 - p_s0
    ab = float(a_dir @ b_dir)
    denom = max(1.0 - ab * ab, 1e-12)
    sc = (float(a_dir @ r) - ab * float(b_dir @ r)) / denom
    tc = (ab * float(a_dir @ r) - float(b_dir @ r)) / denom
    sc = np.clip(sc, -hs[i], hs[i])
    tc = np.clip(tc, -ht[j], ht[j])
    p = 0.5 * ((p_s0 + sc * a_dir) + (p_t0 + tc * b_dir))
    return True, n, best_overlap, p


def _box_environment(top, cfg, rc, rv, romega, r_inv_mass, inv_i, radii,
                     bc, bv, bom, bq, bw):
    """The dynamic boxes' full environment, shared by every coupled
    substep (runs AFTER the balls' _rigid_environment): box-plane corner
    bounce, then ball-vs-box, then box-vs-box contacts."""
    bc, bv, bom = _box_plane_bounce(top, cfg, bc, bv, bom, bq, bw)
    half = np.asarray(top.box_half_extents, np.float64)
    ib = _box_inv_inertia_body(bw, half)
    rc, rv, romega, bc, bv, bom = _ball_box_bounce(
        top, cfg, rc, rv, romega, r_inv_mass, inv_i, radii,
        bc, bv, bom, bq, bw, ib)
    bc, bv, bom = _box_box_bounce(top, cfg, bc, bv, bom, bq, bw, ib)
    return rc, rv, romega, bc, bv, bom


def _boxes_predict(cfg, boxes, dt):
    """Gravity predict + orientation integrate for the dynamic boxes
    (every coupled solver's step 1)."""
    bc, bv, bom, bq, bw = boxes
    bc, bv = np.array(bc), np.array(bv)
    bom, bq = np.array(bom), np.array(bq)
    dyn = (bw > 0.0)[:, None]
    bv = np.where(dyn, bv + dt * np.asarray(cfg.gravity)[None, :], bv)
    bc = bc + dt * bv
    bq = _quat_integrate(bq, bom, dt)
    return bc, bv, bom, bq, np.asarray(bw, np.float64)


def _rigid_plane_bounce(top, cfg, rc, rv, romega, r_inv_mass, inv_i, radii):
    """Dynamic sphere vs ground plane: normal bounce + rolling friction
    impulse at the contact point (shared by every coupled solver; the
    ball's own state is always explicit)."""
    if not cfg.collision.enable_plane:
        return rc, rv, romega
    pen = top.plane_height - (rc[:, 1] - radii)
    hit = (pen > 0.0) & (r_inv_mass > 0.0)
    rc[:, 1] = np.where(hit, top.plane_height + radii, rc[:, 1])
    vy = rv[:, 1]
    rv[:, 1] = np.where(hit & (vy < 0.0),
                        -cfg.collision.restitution * vy, vy)
    arm = np.stack([np.zeros_like(radii), -radii,
                    np.zeros_like(radii)], axis=1)
    u = rv + np.cross(romega, arm)
    ut = u.copy()
    ut[:, 1] = 0.0
    k = r_inv_mass + inv_i * radii * radii
    p_t = -cfg.collision.friction * ut / np.maximum(k, 1e-12)[:, None]
    p_t = np.where(hit[:, None], p_t, 0.0)
    rv = rv + p_t * r_inv_mass[:, None]
    romega = romega + np.cross(arm, p_t) * inv_i[:, None]
    return rc, rv, romega


def _ball_static_response(cfg, rc, rv, romega, r_inv_mass, inv_i, radii,
                          pen, n):
    """Shared dynamic-ball-vs-static-surface response, vectorized over
    balls (the plane bounce generalized to an arbitrary contact normal):
    push out by ``pen`` along ``n``, reflect the inward normal velocity by
    (1 + restitution), rolling-friction impulse with torque at the contact
    point (arm = -r n)."""
    e, mu = cfg.collision.restitution, cfg.collision.friction
    hit = (pen > 0.0) & (r_inv_mass > 0.0)
    rc = rc + np.where(hit, pen, 0.0)[:, None] * n
    un = np.einsum("ij,ij->i", rv, n)
    refl = hit & (un < 0.0)
    rv = rv - np.where(refl, (1.0 + e) * un, 0.0)[:, None] * n
    arm = -radii[:, None] * n
    u = rv + np.cross(romega, arm)
    ut = u - np.einsum("ij,ij->i", u, n)[:, None] * n
    k = r_inv_mass + inv_i * radii * radii
    p_t = -mu * ut / np.maximum(k, 1e-12)[:, None]
    p_t = np.where(hit[:, None], p_t, 0.0)
    rv = rv + p_t * r_inv_mass[:, None]
    romega = romega + np.cross(arm, p_t) * inv_i[:, None]
    return rc, rv, romega


def _rigid_static_bounce(top, cfg, rc, rv, romega, r_inv_mass, inv_i,
                         radii, skip_boxes=False):
    """Dynamic sphere vs the scene's STATIC colliders — capsules, boxes,
    SDFs, in that (collider-enable) order; the ground plane has its own
    bounce.  Each collider computes (pen, n) for every ball center and
    runs the shared _ball_static_response.  ``skip_boxes`` when the boxes
    are dynamic this substep (ball-vs-dynamic-box runs two-body in
    _ball_box_bounce instead)."""
    if _has_capsules(top, cfg):
        for s in range(top.capsule_radii.shape[0]):
            cpt = _capsule_closest(rc, top.capsule_p0[s], top.capsule_p1[s])
            d = rc - cpt
            dist = np.linalg.norm(d, axis=1)
            n = d / np.maximum(dist, 1e-12)[:, None]
            pen = (top.capsule_radii[s] + radii) - dist
            rc, rv, romega = _ball_static_response(
                cfg, rc, rv, romega, r_inv_mass, inv_i, radii, pen, n)
    if _has_boxes(top, cfg) and not skip_boxes:
        for s in range(top.box_centers.shape[0]):
            c, h = top.box_centers[s], top.box_half_extents[s]
            rot = top.box_rotations[s]
            q = (rc - c) @ rot
            qc = np.clip(q, -h, h)
            dloc = q - qc
            dist = np.linalg.norm(dloc, axis=1)
            # outside: closest-point normal; center inside: face push rule
            n_out = (dloc / np.maximum(dist, 1e-12)[:, None]) @ rot.T
            inside, push, n_in = _box_face_push(rc, c, h, rot)
            pen = np.where(inside, push + radii, radii - dist)
            n = np.where(inside[:, None], n_in, n_out)
            rc, rv, romega = _ball_static_response(
                cfg, rc, rv, romega, r_inv_mass, inv_i, radii, pen, n)
    if _has_sdfs(top, cfg):
        for s in range(top.sdf_grids.shape[0]):
            phi, grad = _sdf_sample_grad(
                top.sdf_grids[s], top.sdf_origins[s], top.sdf_spacings[s],
                rc)
            n = grad / np.maximum(
                np.linalg.norm(grad, axis=1), 1e-12)[:, None]
            pen = radii - phi
            rc, rv, romega = _ball_static_response(
                cfg, rc, rv, romega, r_inv_mass, inv_i, radii, pen, n)
    return rc, rv, romega


def _rigid_rigid_bounce(cfg, rc, rv, romega, r_inv_mass, inv_i, radii):
    """Dynamic sphere vs sphere: pairwise sequential (i < j in index
    order) inverse-mass-weighted position separation, a normal impulse
    with restitution on approach, and a contact friction impulse with
    torque at the contact (arms a_i = r_i n, a_j = -r_j n) — the plane
    response generalized to two mobile bodies; the friction impulse
    -mu u_t / k damps the contact slip by exactly (1 - mu), the plane
    convention.  Kinematic balls (inv_mass 0) push without reacting;
    kinematic-kinematic pairs are inert scenery and skip."""
    S = rc.shape[0]
    e, mu = cfg.collision.restitution, cfg.collision.friction
    rc, rv, romega = rc.copy(), rv.copy(), romega.copy()
    for i in range(S):
        for j in range(i + 1, S):
            wi, wj = r_inv_mass[i], r_inv_mass[j]
            wsum = wi + wj
            d = rc[j] - rc[i]
            dist = np.linalg.norm(d)
            n = d / max(dist, 1e-12)
            pen = (radii[i] + radii[j]) - dist
            if not (pen > 0.0 and wsum > 0.0):
                continue
            rc[i] = rc[i] - pen * (wi / wsum) * n
            rc[j] = rc[j] + pen * (wj / wsum) * n
            un = float(np.dot(rv[j] - rv[i], n))
            if un < 0.0:
                p_n = -(1.0 + e) * un / wsum
                rv[i] = rv[i] - p_n * wi * n
                rv[j] = rv[j] + p_n * wj * n
            ai, aj = radii[i] * n, -radii[j] * n
            u = (rv[j] + np.cross(romega[j], aj)) \
                - (rv[i] + np.cross(romega[i], ai))
            ut = u - np.dot(u, n) * n
            k = wsum + inv_i[i] * radii[i] ** 2 + inv_i[j] * radii[j] ** 2
            p_t = -mu * ut / max(k, 1e-12)
            rv[j] = rv[j] + p_t * wj
            rv[i] = rv[i] - p_t * wi
            romega[j] = romega[j] + np.cross(aj, p_t) * inv_i[j]
            romega[i] = romega[i] + np.cross(ai, -p_t) * inv_i[i]
    return rc, rv, romega


def _rigid_environment(top, cfg, rc, rv, romega, r_inv_mass, inv_i, radii,
                       skip_boxes=False):
    """The dynamic balls' full environment response, shared by every
    coupled substep: ground plane, then static capsules/boxes/SDFs, then
    ball-ball contacts (so balls end the substep mutually separated).
    ``skip_boxes`` when the scene's boxes are dynamic this substep."""
    rc, rv, romega = _rigid_plane_bounce(top, cfg, rc, rv, romega,
                                         r_inv_mass, inv_i, radii)
    rc, rv, romega = _rigid_static_bounce(top, cfg, rc, rv, romega,
                                          r_inv_mass, inv_i, radii,
                                          skip_boxes=skip_boxes)
    rc, rv, romega = _rigid_rigid_bounce(cfg, rc, rv, romega,
                                         r_inv_mass, inv_i, radii)
    return rc, rv, romega


def _verlet_integrate(top: HostTopology, cfg: SimConfig, x, x_prev, dt,
                      alive=None, scale=None):
    """The Verlet substep BEFORE contact projection (shared with
    substep_verlet_coupled)."""
    movable = top.inv_mass > 0.0
    g = np.asarray(cfg.gravity)
    w = top.inv_mass[:, None]
    v_est = (x - x_prev) / dt
    f = _total_forces(top, cfg, x, v_est, alive=alive, rest_scale=scale)
    accel = g[None, :] + f * w
    x_new = x + (x - x_prev) * (1.0 - cfg.global_damping * dt) + accel * dt * dt
    x_new = np.where(movable[:, None], x_new, x)
    x_new = x_new + volume_projection(top, x_new, cfg.volume_stiffness)
    return x_new, movable


def substep_verlet_coupled(top: HostTopology, cfg: SimConfig, x, v, x_prev,
                           rc, rv, r_inv_mass, dt, romega=None, rq=None,
                           boxes=None, quats=None):
    """Coupled Verlet substep (binding): Verlet resolves contacts as
    position projections, so the momentum the cloth receives from sphere
    s is the projection impulse ``J_s = sum_i m_i dx_i / dt`` and the
    reaction is ``-J_s``.  The radial push exerts zero torque and carries
    no surface-velocity term: a SPINNING ball neither drags Verlet/XPBD
    cloth nor picks up spin from it (consistent with how these solvers
    treat kinematic collider velocities).  Dynamic boxes (``boxes``)
    follow the same contract — projection + friction impulses, linear
    reaction only; their spin comes from the box-plane corner bounce."""
    if romega is None:
        romega = np.zeros_like(rv)
    romega = np.array(romega, np.float64)
    radii = np.asarray(top.sphere_radii, np.float64)
    inv_i = r_inv_mass * 2.5 / np.maximum(radii * radii, 1e-12)
    rc, rv = _rigid_predict(cfg, rc, rv, r_inv_mass, dt)
    if rq is not None:
        rq = _quat_integrate(rq, romega, dt)
    if boxes is not None:
        bc, bv, bom, bq, bw = _boxes_predict(cfg, boxes, dt)

    x_new, movable = _verlet_integrate(top, cfg, x, x_prev, dt)
    if quats is not None:
        # shape matching after integration, before contact (same slot as
        # the uncoupled substep_verlet; position-only)
        dxs, quats = shape_match_dx(top, cfg, x_new, quats)
        x_new = x_new + dxs
    if cfg.strain_limit.enabled:
        x_new = x_new + strain_limit_dx(top, cfg, x_new)
    if _motion_enabled(top, cfg):
        x_new = x_new + tether_dx(top, cfg, x_new)
    # projection order mirrors project_positions_only: plane, spheres
    # (measured, at the rigid centers), dynamic boxes (measured), then
    # the static rest
    contact = plane_contact_preclamp(top, cfg, x_new, movable)
    if cfg.collision.enable_plane:
        x_new[:, 1] = np.where(contact, top.plane_height, x_new[:, 1])
    m = np.where(movable, 1.0 / np.maximum(top.inv_mass, 1e-12), 0.0)
    x_new, j_lin = _project_spheres_measured(x_new, movable, m, rc, radii,
                                             dt, r_inv_mass)
    rv = rv - j_lin * r_inv_mass[:, None]
    rc = rc - (j_lin * dt) * r_inv_mass[:, None]
    if boxes is not None:
        x_new, j_b = _project_boxes_measured(top, x_new, movable, m, bc,
                                             bq, dt, bw)
        bv = bv - j_b * bw[:, None]
        bc = bc - (j_b * dt) * bw[:, None]
    x_new = _project_static_rest(top, cfg, x_new, movable,
                                 skip_boxes=boxes is not None)
    x_new = plane_friction_positions(top, cfg, x_new, x, dt, contact)
    # sphere tangential friction at the DYNAMIC centers, relative to each
    # ball's velocity; the linear impulse reacts onto the ball (no torque
    # — the PBD coupled contract stays spin-free)
    mu = cfg.collision.friction
    if cfg.collision.enable_spheres and mu != 0.0:
        for s in range(rc.shape[0]):
            x_new, j_t = _one_sphere_friction(
                x_new, x, dt, movable, rc[s], radii[s], rv[s], mu, m,
                r_inv_mass[s])
            rv[s] = rv[s] - j_t * r_inv_mass[s]
    if boxes is not None and cfg.collision.enable_boxes and mu != 0.0:
        for s in range(bc.shape[0]):
            x_new, j_t = _one_box_friction(
                top, x_new, x, dt, movable, bc, bq, s, bv[s], mu, m, bw[s])
            bv[s] = bv[s] - j_t * bw[s]
    x_new = rest_friction_positions(top, cfg, x_new, x, dt, movable,
                                    skip_boxes=boxes is not None)
    rc, rv, romega = _rigid_environment(top, cfg, rc, rv, romega,
                                        r_inv_mass, inv_i, radii,
                                        skip_boxes=boxes is not None)
    if boxes is not None:
        rc, rv, romega, bc, bv, bom = _box_environment(
            top, cfg, rc, rv, romega, r_inv_mass, inv_i, radii,
            bc, bv, bom, bq, bw)
        boxes = (bc, bv, bom, bq, bw)
    if top.joint_meta is not None:
        _require_joint_state(top, rq, boxes)
        rc, rv, romega, rq, boxes = _solve_rigid_joints(
            top, cfg, rc, rv, romega, rq, r_inv_mass, inv_i, boxes, dt)
        if boxes is not None:
            bc, bv, bom, bq, bw = boxes
    if top.attach_ids is not None:
        if rq is None:
            raise ValueError(
                "topology has rigid attachments: pass ball orientations rq")
        x_new, _, rc, rv, romega, rq = _solve_attachments(
            top, cfg, x_new, None, rc, rv, romega, rq, r_inv_mass, inv_i,
            dt)
    if top.attach_box_ids is not None:
        if boxes is None:
            raise ValueError(
                "topology has box attachments: pass dynamic boxes")
        x_new, _, bc, bv, bom, bq = _solve_box_attachments(
            top, cfg, x_new, None, bc, bv, bom, bq, bw, dt)
        boxes = (bc, bv, bom, bq, bw)
    v_new = (x_new - x) / dt
    out = (x_new, v_new, x, rc, rv, romega)
    if quats is not None:
        out = out + (quats,)
    if rq is not None:
        out = out + (rq,)
    return out if boxes is None else out + (boxes,)


def _project_static_rest(top: HostTopology, cfg: SimConfig, x, movable,
                         skip_boxes=False):
    """Position-only capsule/box/SDF projection (after the spheres).
    ``skip_boxes`` when the boxes are dynamic this substep."""
    if _has_capsules(top, cfg):
        for s in range(top.capsule_radii.shape[0]):
            c = _capsule_closest(x, top.capsule_p0[s], top.capsule_p1[s])
            d = x - c
            dist = np.linalg.norm(d, axis=1)
            pen = top.capsule_radii[s] - dist
            contact = (pen > 0.0) & movable
            n = d / np.maximum(dist, 1e-12)[:, None]
            x = x + np.where(contact, pen, 0.0)[:, None] * n
    if _has_boxes(top, cfg) and not skip_boxes:
        for s in range(top.box_centers.shape[0]):
            inside, push, n = _box_face_push(
                x, top.box_centers[s], top.box_half_extents[s],
                top.box_rotations[s])
            contact = inside & movable
            x = x + np.where(contact, push, 0.0)[:, None] * n
    if _has_sdfs(top, cfg):
        for s in range(top.sdf_grids.shape[0]):
            phi, grad = _sdf_sample_grad(
                top.sdf_grids[s], top.sdf_origins[s], top.sdf_spacings[s], x)
            pen = -phi
            contact = (pen > 0.0) & movable
            n = grad / np.maximum(
                np.linalg.norm(grad, axis=1), 1e-12)[:, None]
            x = x + np.where(contact, pen, 0.0)[:, None] * n
    return x


def substep_xpbd_coupled(top: HostTopology, cfg: SimConfig, x, v, x_prev,
                         rc, rv, r_inv_mass, dt, romega=None, rq=None,
                         boxes=None, quats=None):
    """Coupled XPBD substep (binding): contacts project inside the Jacobi
    loop, and each iteration's measured projection impulse reacts on the
    body IMMEDIATELY (velocity ``-j w_b`` and the complementary position
    share ``-j dt w_b``) — the body participates in the iteration like a
    particle with inverse mass w_b, so penetration self-limits as the
    body yields.  (Accumulating the impulses and reacting once at the
    substep end let them pile up ~n_iterations-fold against a body the
    loop never moved: a 0.5 kg body under a 1 kg/vertex cloth launched
    at 10 m/s.)  No spin-drag (position projection has no surface-
    velocity term).  Dynamic boxes follow the same in-loop contract
    (linear reaction; spin from the box-plane corner bounce)."""
    movable = top.inv_mass > 0.0
    if romega is None:
        romega = np.zeros_like(rv)
    romega = np.array(romega, np.float64)
    radii = np.asarray(top.sphere_radii, np.float64)
    inv_i = r_inv_mass * 2.5 / np.maximum(radii * radii, 1e-12)
    rc, rv = _rigid_predict(cfg, rc, rv, r_inv_mass, dt)
    if rq is not None:
        rq = _quat_integrate(rq, romega, dt)
    if boxes is not None:
        bc, bv, bom, bq, bw = _boxes_predict(cfg, boxes, dt)

    g = np.asarray(cfg.gravity)
    accel = g[None, :]
    if cfg.wind.enabled:
        accel = accel + wind_forces(top, cfg, x, v) * top.inv_mass[:, None]
    if cfg.self_collision.enabled:
        accel = accel + self_collision_forces(
            x, cfg.self_collision.radius, cfg.self_collision.stiffness
        ) * top.inv_mass[:, None]
    if cfg.pressure.enabled:
        accel = accel + pressure_forces(top, cfg, x) * top.inv_mass[:, None]
    v = (v + dt * accel) * (1.0 - cfg.global_damping * dt)
    v = np.where(movable[:, None], v, 0.0)
    x_prev = x
    x = x + dt * v
    m = np.where(movable, 1.0 / np.maximum(top.inv_mass, 1e-12), 0.0)
    lam = np.zeros(top.edges.shape[0])
    lam_vol = np.zeros(top.tets.shape[0])
    contact = np.zeros(x.shape[0], bool)
    for it in range(cfg.xpbd.n_iterations):
        x, lam, lam_vol = xpbd_iteration(top, cfg, x, lam, lam_vol, dt)
        pc = plane_contact_preclamp(top, cfg, x, movable)
        contact |= pc
        if cfg.collision.enable_plane:
            x[:, 1] = np.where(pc, top.plane_height, x[:, 1])
        x, jl = _project_spheres_measured(x, movable, m, rc, radii, dt,
                                          r_inv_mass)
        rv = rv - jl * r_inv_mass[:, None]
        rc = rc - (jl * dt) * r_inv_mass[:, None]
        if boxes is not None:
            x, jb = _project_boxes_measured(top, x, movable, m, bc, bq,
                                            dt, bw)
            bv = bv - jb * bw[:, None]
            bc = bc - (jb * dt) * bw[:, None]
        x = _project_static_rest(top, cfg, x, movable,
                                 skip_boxes=boxes is not None)
    if (quats is not None or cfg.strain_limit.enabled
            or _motion_enabled(top, cfg)):
        # shape matching + strain limiting + motion constraints after the
        # Jacobi loop (same slots as the uncoupled substep_xpbd), then ONE
        # more contact pass so the corrections never leave penetration
        # behind — with the measured rigid reactions of an in-loop
        # iteration (the bodies stay momentum-consistent)
        if quats is not None:
            dxs, quats = shape_match_dx(top, cfg, x, quats)
            x = x + dxs
        if cfg.strain_limit.enabled:
            x = x + strain_limit_dx(top, cfg, x)
        if _motion_enabled(top, cfg):
            x = x + tether_dx(top, cfg, x)
        pc = plane_contact_preclamp(top, cfg, x, movable)
        contact |= pc
        if cfg.collision.enable_plane:
            x[:, 1] = np.where(pc, top.plane_height, x[:, 1])
        x, jl = _project_spheres_measured(x, movable, m, rc, radii, dt,
                                          r_inv_mass)
        rv = rv - jl * r_inv_mass[:, None]
        rc = rc - (jl * dt) * r_inv_mass[:, None]
        if boxes is not None:
            x, jb = _project_boxes_measured(top, x, movable, m, bc, bq,
                                            dt, bw)
            bv = bv - jb * bw[:, None]
            bc = bc - (jb * dt) * bw[:, None]
        x = _project_static_rest(top, cfg, x, movable,
                                 skip_boxes=boxes is not None)
    x = plane_friction_positions(top, cfg, x, x_prev, dt, contact)
    mu = cfg.collision.friction
    if cfg.collision.enable_spheres and mu != 0.0:
        for s in range(rc.shape[0]):
            x, j_t = _one_sphere_friction(
                x, x_prev, dt, movable, rc[s], radii[s], rv[s], mu, m,
                r_inv_mass[s])
            rv[s] = rv[s] - j_t * r_inv_mass[s]
    if boxes is not None and cfg.collision.enable_boxes and mu != 0.0:
        for s in range(bc.shape[0]):
            x, j_t = _one_box_friction(
                top, x, x_prev, dt, movable, bc, bq, s, bv[s], mu, m,
                bw[s])
            bv[s] = bv[s] - j_t * bw[s]
    x = rest_friction_positions(top, cfg, x, x_prev, dt, movable,
                                skip_boxes=boxes is not None)
    rc, rv, romega = _rigid_environment(top, cfg, rc, rv, romega,
                                        r_inv_mass, inv_i, radii,
                                        skip_boxes=boxes is not None)
    if boxes is not None:
        rc, rv, romega, bc, bv, bom = _box_environment(
            top, cfg, rc, rv, romega, r_inv_mass, inv_i, radii,
            bc, bv, bom, bq, bw)
        boxes = (bc, bv, bom, bq, bw)
    if top.joint_meta is not None:
        _require_joint_state(top, rq, boxes)
        rc, rv, romega, rq, boxes = _solve_rigid_joints(
            top, cfg, rc, rv, romega, rq, r_inv_mass, inv_i, boxes, dt)
        if boxes is not None:
            bc, bv, bom, bq, bw = boxes
    if top.attach_ids is not None:
        if rq is None:
            raise ValueError(
                "topology has rigid attachments: pass ball orientations rq")
        x, _, rc, rv, romega, rq = _solve_attachments(
            top, cfg, x, None, rc, rv, romega, rq, r_inv_mass, inv_i, dt)
    if top.attach_box_ids is not None:
        if boxes is None:
            raise ValueError(
                "topology has box attachments: pass dynamic boxes")
        x, _, bc, bv, bom, bq = _solve_box_attachments(
            top, cfg, x, None, bc, bv, bom, bq, bw, dt)
        boxes = (bc, bv, bom, bq, bw)
    x = np.where(movable[:, None], x, x_prev)
    v = (x - x_prev) / dt
    out = (x, v, x_prev, rc, rv, romega)
    if quats is not None:
        out = out + (quats,)
    if rq is not None:
        out = out + (rq,)
    return out if boxes is None else out + (boxes,)


_SUBSTEP_COUPLED = {
    Solver.SEMI_IMPLICIT_EULER: None,  # handled below (extra feature args)
    Solver.VERLET: substep_verlet_coupled,
    Solver.XPBD: substep_xpbd_coupled,
}


def step_coupled(top: HostTopology, cfg: SimConfig, x, v, x_prev, rc, rv,
                 r_inv_mass, dt=None, n_substeps=None, romega=None,
                 rq=None, boxes=None, quats=None):
    """n_substeps coupled substeps (solver from cfg); returns
    (x, v, x_prev, rc, rv, romega) — plus the shape-matching cluster
    quaternions ``quats`` appended when given, plus the ball orientations
    ``rq`` appended when given (required when the topology carries rigid
    attachments), plus the dynamic-box state 5-tuple
    ``(bc, bv, bom, bq, bw)`` appended LAST when ``boxes`` is given."""
    dt = cfg.dt if dt is None else dt
    n = cfg.n_substeps if n_substeps is None else n_substeps
    rc = np.array(rc, np.float64)
    rv = np.array(rv, np.float64)
    romega = (np.zeros_like(rv) if romega is None
              else np.array(romega, np.float64))
    if rq is None and (top.attach_ids is not None
                       or top.joint_meta is not None):
        rq = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (rc.shape[0], 1))
    if rq is not None:
        rq = np.array(rq, np.float64)
    if boxes is not None:
        boxes = tuple(np.array(b, np.float64) for b in boxes)
    use_q = quats if _shape_match_enabled(top, cfg) else None
    if use_q is not None:
        use_q = np.array(use_q, np.float64)
    for _ in range(n):
        if cfg.solver == Solver.SEMI_IMPLICIT_EULER:
            out = substep_euler_coupled(
                top, cfg, x, v, x_prev, rc, rv, r_inv_mass, dt,
                romega=romega, rq=rq, boxes=boxes, quats=use_q)
            x, v, x_prev, rc, rv, romega = out[0], out[1], out[2], \
                out[3], out[4], out[5]
            i = 8
        else:
            fn = _SUBSTEP_COUPLED[cfg.solver]
            out = fn(top, cfg, x, v, x_prev, rc, rv, r_inv_mass, dt,
                     romega=romega, rq=rq, boxes=boxes, quats=use_q)
            x, v, x_prev, rc, rv, romega = out[:6]
            i = 6
        if use_q is not None:
            use_q = out[i]
            i += 1
        if rq is not None:
            rq = out[i]
        boxes = out[-1] if boxes is not None else None
    base = (x, v, x_prev, rc, rv, romega)
    if quats is not None:
        base = base + ((use_q if use_q is not None else quats),)
    if rq is not None:
        base = base + (rq,)
    return base if boxes is None else base + (boxes,)


def substep_verlet(top: HostTopology, cfg: SimConfig, x, v, x_prev, dt,
                   alive=None, scale=None, quats=None):
    x_new, movable = _verlet_integrate(top, cfg, x, x_prev, dt,
                                       alive=alive, scale=scale)
    if quats is not None:
        # shape matching after integration, before contact (position-only
        # on the projection solvers; Verlet recovers v from positions)
        dxs, quats = shape_match_dx(top, cfg, x_new, quats)
        x_new = x_new + dxs
    if cfg.strain_limit.enabled:
        # strain limiting after shape matching, before contact
        x_new = x_new + strain_limit_dx(top, cfg, x_new, alive=alive,
                                        rest_scale=scale)
    if _motion_enabled(top, cfg):
        # motion constraints after strain limiting, before contact
        # (position-only on the projection solvers)
        x_new = x_new + tether_dx(top, cfg, x_new)
    contact = plane_contact_preclamp(top, cfg, x_new, movable)
    x_new = project_positions_only(top, cfg, x_new, movable)
    x_new = plane_friction_positions(top, cfg, x_new, x, dt, contact)
    x_new = sphere_friction_positions(top, cfg, x_new, x, dt, movable)
    x_new = rest_friction_positions(top, cfg, x_new, x, dt, movable)
    v_new = (x_new - x) / dt
    if scale is not None:
        scale = plastic_update(top, cfg, x_new, scale)
    if alive is not None:
        alive = tear_update(top, cfg, x_new, alive, rest_scale=scale)
    out = (x_new, v_new, x, alive, scale)
    return out if quats is None else out + (quats,)


def xpbd_iteration(top: HostTopology, cfg: SimConfig, x, lam, lam_vol, dt,
                   alive=None, rest_scale=None):
    """One Jacobi projection sweep over distance + volume constraints.
    Dead (torn) edges project nothing and leave the Jacobi count;
    ``rest_scale`` rescales the distance targets (PlasticityParams)."""
    w = top.inv_mass
    a_idx = top.edges[:, 0]
    b_idx = top.edges[:, 1]
    d = x[b_idx] - x[a_idx]
    length = np.linalg.norm(d, axis=1)
    n = d / np.maximum(length, 1e-12)[:, None]
    rest = (top.rest_length if rest_scale is None
            else top.rest_length * rest_scale)
    c_val = length - rest
    alpha_t = top.edge_compliance / (dt * dt)
    denom = w[a_idx] + w[b_idx] + alpha_t
    dlam = -(c_val + alpha_t * lam) / np.maximum(denom, 1e-12)
    e_cnt = np.ones_like(dlam)
    if alive is not None:
        dlam = dlam * alive
        e_cnt = alive
    lam = lam + dlam
    dx = np.zeros_like(x)
    cnt = np.zeros(x.shape[0])
    np.add.at(dx, a_idx, -(w[a_idx] * dlam)[:, None] * n)
    np.add.at(dx, b_idx, (w[b_idx] * dlam)[:, None] * n)
    np.add.at(cnt, a_idx, e_cnt)
    np.add.at(cnt, b_idx, e_cnt)
    # tet volume constraints with compliance
    if top.tets.shape[0] > 0:
        t = top.tets
        p0, p1, p2, p3 = x[t[:, 0]], x[t[:, 1]], x[t[:, 2]], x[t[:, 3]]
        vol = np.einsum("ij,ij->i", np.cross(p1 - p0, p2 - p0), p3 - p0) / 6.0
        c_v = vol - top.rest_volume
        g1 = np.cross(p2 - p0, p3 - p0) / 6.0
        g2 = np.cross(p3 - p0, p1 - p0) / 6.0
        g3 = np.cross(p1 - p0, p2 - p0) / 6.0
        g0 = -(g1 + g2 + g3)
        alpha_v = cfg.xpbd.compliance_volume / (dt * dt)
        denom_v = (
            w[t[:, 0]] * np.einsum("ij,ij->i", g0, g0)
            + w[t[:, 1]] * np.einsum("ij,ij->i", g1, g1)
            + w[t[:, 2]] * np.einsum("ij,ij->i", g2, g2)
            + w[t[:, 3]] * np.einsum("ij,ij->i", g3, g3)
            + alpha_v
        )
        dlam_v = -(c_v + alpha_v * lam_vol) / np.maximum(denom_v, 1e-12)
        lam_vol = lam_vol + dlam_v
        for col, g in zip(range(4), (g0, g1, g2, g3)):
            ids = t[:, col]
            np.add.at(dx, ids, (w[ids] * dlam_v)[:, None] * g)
            np.add.at(cnt, ids, 1.0)
    x = x + cfg.xpbd.relaxation * dx / np.maximum(cnt, 1.0)[:, None]
    return x, lam, lam_vol


def substep_xpbd(top: HostTopology, cfg: SimConfig, x, v, x_prev, dt,
                 alive=None, scale=None, quats=None):
    movable = top.inv_mass > 0.0
    g = np.asarray(cfg.gravity)
    accel = g[None, :]
    if cfg.wind.enabled:
        # external forces enter XPBD through the velocity predict
        accel = accel + wind_forces(top, cfg, x, v) * top.inv_mass[:, None]
    if cfg.self_collision.enabled:
        # self-collision repulsion is an external force too (the XPBD
        # constraints only cover springs/volume); same predict-stage entry
        accel = accel + self_collision_forces(
            x, cfg.self_collision.radius, cfg.self_collision.stiffness
        ) * top.inv_mass[:, None]
    if cfg.pressure.enabled:
        # gas pressure is an external force (not a constraint): same
        # predict-stage entry as wind / self-collision
        accel = accel + pressure_forces(top, cfg, x) * top.inv_mass[:, None]
    v = (v + dt * accel) * (1.0 - cfg.global_damping * dt)
    v = np.where(movable[:, None], v, 0.0)
    x_prev = x
    x = x + dt * v
    lam = np.zeros(top.edges.shape[0])
    lam_vol = np.zeros(top.tets.shape[0])
    contact = np.zeros(x.shape[0], bool)
    for it in range(cfg.xpbd.n_iterations):
        x, lam, lam_vol = xpbd_iteration(top, cfg, x, lam, lam_vol, dt,
                                         alive=alive, rest_scale=scale)
        # contacts are projected INSIDE the Jacobi loop: projecting only
        # after the loop lets constraint corrections and the contact fight,
        # and the velocity recovery below turns the unresolved conflict into
        # injected energy (measured: draped-cloth blowup) — the standard
        # PBD/XPBD ordering interleaves them.
        contact |= plane_contact_preclamp(top, cfg, x, movable)
        x = project_positions_only(top, cfg, x, movable)
    if quats is not None:
        # shape matching after the Jacobi loop
        dxs, quats = shape_match_dx(top, cfg, x, quats)
        x = x + dxs
    if cfg.strain_limit.enabled:
        # strain limiting after shape matching
        x = x + strain_limit_dx(top, cfg, x, alive=alive, rest_scale=scale)
    if _motion_enabled(top, cfg):
        # motion constraints after strain limiting (position-only)
        x = x + tether_dx(top, cfg, x)
    if (quats is not None or cfg.strain_limit.enabled
            or _motion_enabled(top, cfg)):
        # ONE more contact projection so the goal pull / strain clamp /
        # tether clamp never leaves penetration behind
        contact |= plane_contact_preclamp(top, cfg, x, movable)
        x = project_positions_only(top, cfg, x, movable)
    x = plane_friction_positions(top, cfg, x, x_prev, dt, contact)
    x = sphere_friction_positions(top, cfg, x, x_prev, dt, movable)
    x = rest_friction_positions(top, cfg, x, x_prev, dt, movable)
    x = np.where(movable[:, None], x, x_prev)
    v = (x - x_prev) / dt
    if scale is not None:
        scale = plastic_update(top, cfg, x, scale)
    if alive is not None:
        alive = tear_update(top, cfg, x, alive, rest_scale=scale)
    out = (x, v, x_prev, alive, scale)
    return out if quats is None else out + (quats,)


_SUBSTEP = {
    Solver.SEMI_IMPLICIT_EULER: substep_euler,
    Solver.VERLET: substep_verlet,
    Solver.XPBD: substep_xpbd,
}


def step(top: HostTopology, cfg: SimConfig, x, v, x_prev, dt=None,
         n_substeps=None, alive=None, rest_scale=None, quats=None):
    """One frame = n_substeps substeps (mirrors FixedUpdate + inner loop).
    Returns ``(x, v, x_prev)``, plus ``alive`` when an edge liveness mask
    was passed (TearParams), plus ``rest_scale`` when a plastic scale was
    passed (PlasticityParams), plus ``quats`` when cluster quaternions
    were passed (ShapeMatchParams)."""
    dt = cfg.dt if dt is None else dt
    n = cfg.n_substeps if n_substeps is None else n_substeps
    fn = _SUBSTEP[cfg.solver]
    # tearing/plasticity/shape-matching only act when the CONFIG enables
    # them (device-path parity: solver/step.py _tear_alive/_plastic_scale);
    # a mask passed with the feature disabled is inert, returned unchanged
    use = alive if cfg.tear.enabled else None
    use_s = rest_scale if cfg.plasticity.enabled else None
    use_q = quats if _shape_match_enabled(top, cfg) else None
    for _ in range(n):
        res = fn(top, cfg, x, v, x_prev, dt, alive=use, scale=use_s,
                 quats=use_q)
        x, v, x_prev, use, use_s = res[:5]
        if use_q is not None:
            use_q = res[5]
    out = (x, v, x_prev)
    if alive is not None:
        out = out + ((use if cfg.tear.enabled else alive),)
    if rest_scale is not None:
        out = out + ((use_s if cfg.plasticity.enabled else rest_scale),)
    if quats is not None:
        out = out + ((use_q if use_q is not None else quats),)
    return out


def run_trajectory(top: HostTopology, cfg: SimConfig, n_steps: int, record_every: int = 1):
    """Roll out n_steps frames from rest; returns stacked positions
    f64[n_records, N, 3] — the golden "reference trajectory"."""
    x = top.positions0.copy()
    v = np.zeros_like(x)
    x_prev = x.copy()
    quats = None
    if _shape_match_enabled(top, cfg):
        quats = np.zeros((top.n_clusters, 4))
        quats[:, 0] = 1.0
    rec = []
    for i in range(n_steps):
        if quats is None:
            x, v, x_prev = step(top, cfg, x, v, x_prev)
        else:
            x, v, x_prev, quats = step(top, cfg, x, v, x_prev, quats=quats)
        if (i + 1) % record_every == 0:
            rec.append(x.copy())
    return np.stack(rec, axis=0)


def vertex_normals(triangles: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (mesh.RecalculateNormals analogue,
    BASELINE.json:5 "vertex-normal recompute for rendering")."""
    p0 = x[triangles[:, 0]]
    p1 = x[triangles[:, 1]]
    p2 = x[triangles[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)  # area-weighted face normal
    out = np.zeros_like(x)
    for c in range(3):
        np.add.at(out, triangles[:, c], fn)
    norm = np.linalg.norm(out, axis=1)
    return out / np.maximum(norm, 1e-12)[:, None]


def raycast(triangles: np.ndarray, x: np.ndarray, origin: np.ndarray,
            direction: np.ndarray, eps: float = 1e-9):
    """Nearest ray-triangle intersection (Moller-Trumbore, binding
    definition for the device twin).

    The interaction analogue of Unity's ``Physics.Raycast`` against the
    deformed soft-body mesh (mouse picking / grabbing; the reference
    snapshot has no code, so the canonical editor interaction is the
    spec).  ``direction`` need not be unit length; ``t`` is in units of
    ``|direction|``.

    Returns ``(t, tri, u, v)``: distance-parameter, triangle index and
    barycentric (u, v) of the nearest front- or back-face hit with
    ``t >= 0``; ``t = inf`` and ``tri = -1`` on a miss.  Ties (exactly
    equal t) break toward the lowest triangle index.
    """
    o = np.asarray(origin, dtype=np.float64)
    d = np.asarray(direction, dtype=np.float64)
    p0 = x[triangles[:, 0]]
    p1 = x[triangles[:, 1]]
    p2 = x[triangles[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    h = np.cross(d[None, :], e2)
    a = np.einsum("fc,fc->f", e1, h)
    parallel = np.abs(a) < eps
    f = 1.0 / np.where(parallel, 1.0, a)
    s = o[None, :] - p0
    u = f * np.einsum("fc,fc->f", s, h)
    q = np.cross(s, e1)
    v = f * np.einsum("fc,fc->f", d[None, :], q)
    t = f * np.einsum("fc,fc->f", e2, q)
    hit = (~parallel) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
    t = np.where(hit, t, np.inf)
    i = int(np.argmin(t))
    if not np.isfinite(t[i]):
        return np.inf, -1, 0.0, 0.0
    return float(t[i]), i, float(u[i]), float(v[i])
