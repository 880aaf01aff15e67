"""On-device two-way rigid-soft coupling — dynamic rigid spheres exchange
momentum with the cloth INSIDE the jitted substep loop.

The observable-tier coupling (`utils.profiling.contact_impulses` + a host
loop, examples/16) costs one host round-trip per substep; here the rigid
bodies are state (`RigidState`) carried through ``lax.scan``, so a
coupled scene runs at full substep rate with zero host traffic — and
vmaps over batched scenes.  Semantics are the oracle's
``substep_*_coupled`` (binding): rigid predict -> cloth substep with
per-sphere impulse measurement -> momentum reaction -> rigid-plane
bounce.  Euler exchanges velocity-level impulses (with spin drag and
reaction torque); Verlet/XPBD exchange the position-projection impulses
``sum m_i dx_i / dt`` — purely radial pushes, so cloth contact exerts
NO torque there (and no spin-drag: projection carries no
surface-velocity term).  Every cloth-ball exchange is REDUCED-MASS
scaled: the patch side of each push/velocity change carries
``beta = M/(M + m_patch)`` and the ball the complement, making contact
stable at any cloth/ball mass ratio (beta = 1, the kinematic-collider
rule, over-exchanges by (M+m_patch)/M and explodes once
(1+e) m_patch > M).  Note the coupled XPBD substep always runs the
general gather-path constraint iteration, never the banded roll path —
coupled scenes are small RL cloths where gathers are cheap; a banded
coupled variant would need the projection measurement inside the
transposed delta loop (solver/step.py substep_xpbd).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..core.config import SimConfig, Solver
from ..core.state import State
from ..core.topology import Topology
from . import collide, step as _step, tether


def _highp(fn):
    """Trace ``fn`` under ``default_matmul_precision('highest')``.

    Every rigid-body contraction is tiny — 3-vectors, 3x3 inertia
    tensors, O(bodies) Python loops — but they feed cancellation-
    sensitive impulse denominators (``w + c @ Iinv @ c``) and joint
    angle/axis projections.  At a reduced-mantissa default matmul
    precision (TF32 on the GPU) these measurably diverge: a hinge motor
    (velocity-level clamp ``-rel/w_rot``) overshot a 2.0 rad/s target to
    3.8 rad/s on an accelerator while CPU f32 hit it exactly.  HIGHEST
    is free at this size.  CPU tests cannot catch this class — see
    CLAUDE.md "Matmul precision"."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RigidState:
    """Dynamic rigid spheres: pytree state for the coupled step.

    ``inv_mass`` 0 marks a KINEMATIC sphere (scripted scenery: it still
    moves with ``velocities`` and pushes the cloth, but takes no
    reaction) — the dynamic superset of ``move_colliders``-animated
    geometry.
    """

    centers: jax.Array      # f32[S, 3]
    velocities: jax.Array   # f32[S, 3]
    inv_mass: jax.Array     # f32[S]; 0 = kinematic
    omega: jax.Array = None  # f32[S, 3] angular velocity (spin)
    quat: jax.Array = None   # f32[S, 4] orientation (wxyz unit quaternion);
    #                          required when the topology carries rigid
    #                          attachments (the weld point rides rotation)
    # --- dynamic rigid BOXES (None = the scene's boxes stay static
    #     scenery; all-or-none — make_rigid_state(box_masses=...) fills
    #     the set).  World rotation of box s = R(box_quat[s]) @
    #     top.box_rotations[s], so identity quats = the build pose. -----
    box_centers: jax.Array = None     # f32[B, 3]
    box_velocities: jax.Array = None  # f32[B, 3]
    box_inv_mass: jax.Array = None    # f32[B]; 0 = kinematic
    box_omega: jax.Array = None       # f32[B, 3]
    box_quat: jax.Array = None        # f32[B, 4] (wxyz)

    def replace(self, **kw) -> "RigidState":
        return dataclasses.replace(self, **kw)

    @property
    def has_boxes(self) -> bool:
        return self.box_centers is not None


def make_rigid_state(top: Topology, masses=None, velocities=None,
                     omega=None, quats=None, box_masses=None,
                     box_velocities=None, box_omega=None,
                     box_quats=None) -> RigidState:
    """Promote the scene's spheres — and, with ``box_masses``, its
    oriented boxes — to dynamic rigid bodies.  ``masses`` f32[S]
    (``inf``/``0`` => kinematic); initial centers come from the
    topology's sphere geometry; ``masses=None`` is valid only for a
    sphere-free scene (boxes-only coupling).  ``omega`` f32[S,3] initial
    spin (solid spheres, I = 2/5 m r^2); ``quats`` f32[S,4] initial
    orientation (wxyz, default identity — orientation makes rigid
    attachments ride the ball's rotation and is always carried).
    ``box_masses`` f32[B] promotes ALL the scene's boxes (solid-box
    inertia, diagonal in the body frame); ``box_quats`` default identity
    = the build-pose ``box_rotations``."""
    if top.sphere_centers is not None and top.n_spheres > 0:
        c = jnp.asarray(top.sphere_centers)
        if masses is None:
            raise ValueError(
                "the scene has spheres: pass their masses (inf/0 for "
                "kinematic scenery)")
    else:
        dtype = (jnp.asarray(top.box_centers).dtype
                 if top.box_centers is not None else jnp.float32)
        c = jnp.zeros((0, 3), dtype)
        if masses is not None and np.size(masses) > 0:
            raise ValueError("masses given but the scene has no spheres")
        masses = np.zeros((0,))
    m = np.asarray(masses, np.float64).reshape(-1)
    if m.shape[0] != c.shape[0]:
        raise ValueError(
            f"masses ({m.shape[0]}) must match the scene's sphere count "
            f"({c.shape[0]})"
        )
    with np.errstate(divide="ignore"):
        im = np.where(np.isfinite(m) & (m > 0.0), 1.0 / m, 0.0)
    v = (jnp.zeros_like(c) if velocities is None
         else jnp.asarray(velocities, c.dtype).reshape(-1, 3))
    om = (jnp.zeros_like(c) if omega is None
          else jnp.asarray(omega, c.dtype).reshape(-1, 3))
    q = (jnp.tile(jnp.asarray([1.0, 0.0, 0.0, 0.0], c.dtype),
                  (c.shape[0], 1))
         if quats is None else jnp.asarray(quats, c.dtype).reshape(-1, 4))
    box = dict(box_centers=None, box_velocities=None, box_inv_mass=None,
               box_omega=None, box_quat=None)
    if box_masses is not None:
        if top.box_centers is None or top.n_boxes == 0:
            raise ValueError("box_masses given but the scene has no boxes")
        bc = jnp.asarray(top.box_centers)
        bm = np.asarray(box_masses, np.float64).reshape(-1)
        if bm.shape[0] != bc.shape[0]:
            raise ValueError(
                f"box_masses ({bm.shape[0]}) must match the scene's box "
                f"count ({bc.shape[0]})")
        with np.errstate(divide="ignore"):
            bim = np.where(np.isfinite(bm) & (bm > 0.0), 1.0 / bm, 0.0)
        box = dict(
            box_centers=bc,
            box_velocities=(jnp.zeros_like(bc) if box_velocities is None
                            else jnp.asarray(box_velocities,
                                             bc.dtype).reshape(-1, 3)),
            box_inv_mass=jnp.asarray(bim, bc.dtype),
            box_omega=(jnp.zeros_like(bc) if box_omega is None
                       else jnp.asarray(box_omega,
                                        bc.dtype).reshape(-1, 3)),
            box_quat=(jnp.tile(jnp.asarray([1.0, 0.0, 0.0, 0.0], bc.dtype),
                               (bc.shape[0], 1))
                      if box_quats is None
                      else jnp.asarray(box_quats,
                                       bc.dtype).reshape(-1, 4)),
        )
    return RigidState(centers=c, velocities=v,
                      inv_mass=jnp.asarray(im, c.dtype), omega=om, quat=q,
                      **box)


def substep_euler_coupled(top: Topology, cfg: SimConfig, s: State,
                          r: RigidState, dt: float
                          ) -> Tuple[State, RigidState]:
    """Oracle substep_euler_coupled twin (f64 exact-parity tested).

    The RigidState spheres are resolved unconditionally — they ARE the
    rigid bodies (api.step_coupled rejects configs with
    ``enable_spheres=False`` so the two entries never silently diverge).
    """
    alive = _step._tear_alive(cfg, s)
    scale = _step._plastic_scale(cfg, s)
    quats = _step._cluster_quats(cfg, s)

    # 1. rigid predict
    rc, rv, romega, radii, inv_i, rq = _rigid_predict(top, cfg, r, dt)

    # 2. cloth substep: shared integrate + plane stage ...
    x, v, x_prev, movable = _step.euler_integrate(top, cfg, s, dt, alive,
                                                  scale)
    if quats is not None:
        # shape matching after integration, before all contact (oracle
        # substep_euler_coupled slot)
        from .shapematch import shape_match_dx

        dxs, quats = shape_match_dx(top, cfg, x, quats)
        x = x + dxs
        v = v + dxs / dt
    if cfg.strain_limit.enabled:
        from .strainlimit import strain_limit_dx

        dxl = strain_limit_dx(top, cfg, x, alive=alive, rest_scale=scale)
        x = x + dxl
        v = v + dxl / dt
    if tether.motion_enabled(top, cfg):
        dxt = tether.tether_dx(top, cfg, x)
        x = x + dxt
        v = v + dxt / dt
    x, v = collide.resolve_plane_stage(top, cfg, x, v, movable)
    # ... spheres at the rigid centers: each contacting vertex sees the
    # sphere's SURFACE velocity at its own contact point (linear + spin),
    # measuring the per-sphere linear impulse and contact torque
    m = jnp.where(movable, 1.0 / jnp.maximum(top.inv_mass, 1e-12), 0.0)
    jlist = []
    llist = []
    for si in range(top.n_spheres):
        d = x - rc[si]
        dist = jnp.linalg.norm(d, axis=1)
        pen = radii[si] - dist
        contact = (pen > 0.0) & movable
        n = d / jnp.maximum(dist, 1e-12)[:, None]
        # reduced-mass pair split (oracle semantics): the patch side of
        # every position/velocity change scales by beta = M/(M + m_c),
        # the ball takes the complement — stable at any cloth/ball mass
        # ratio; kinematic balls (inv_mass 0) keep beta = 1 exactly
        m_c = jnp.sum(m * contact)
        beta = 1.0 / (1.0 + r.inv_mass[si] * m_c)
        dx = beta * jnp.where(contact, pen, 0.0)[:, None] * n
        x = x + dx
        rc = rc.at[si].add(-r.inv_mass[si]
                           * jnp.sum(m[:, None] * dx, axis=0))
        arm = radii[si] * n
        w_i = rv[si][None, :] + jnp.cross(
            jnp.broadcast_to(romega[si], arm.shape), arm
        )
        v0 = v
        u = v - w_i
        un = jnp.einsum("ij,ij->i", u, n)
        inward = contact & (un < 0.0)
        v1 = v - jnp.where(
            inward, (1.0 + cfg.collision.restitution) * un, 0.0
        )[:, None] * n
        u2 = v1 - w_i
        un2 = jnp.einsum("ij,ij->i", u2, n)[:, None] * n
        ut = u2 - un2
        v_t = jnp.where(contact[:, None],
                        w_i + un2 + ut * (1.0 - cfg.collision.friction), v1)
        v = v0 + beta * (v_t - v0)
        dp = m[:, None] * (v - v0)
        jlist.append(jnp.sum(dp, axis=0))
        llist.append(jnp.sum(jnp.cross(arm, dp), axis=0))
    # ... dynamic boxes (oracle loop order: after the spheres, before the
    # static rest; reactions applied inline)
    boxed = r.has_boxes
    if boxed:
        bc, bv, bom, bq, bw = _boxes_predict(cfg, r, dt)
        x, v, bc, bv, bom = _dynamic_boxes_euler(
            top, cfg, x, v, movable, m, bc, bv, bom, bq, bw)
    x, v = collide.resolve_after_spheres(top, cfg, x, v, movable,
                                         skip_boxes=boxed)

    # 3. momentum + angular-momentum reaction on the dynamic spheres
    if jlist:
        j = jnp.stack(jlist)                                    # [S, 3]
        rv = rv - j * r.inv_mass[:, None]
        romega = romega - jnp.stack(llist) * inv_i[:, None]

    # 4. the balls' own environment: plane, static colliders, ball-ball;
    # then the boxes' own environment (plane corners, ball-box, box-box)
    rc, rv, romega = _rigid_environment(top, cfg, r, rc, rv, romega,
                                        radii, inv_i, skip_boxes=boxed)
    if boxed:
        rc, rv, romega, bc, bv, bom = _box_environment(
            top, cfg, rc, rv, romega, r.inv_mass, inv_i, radii,
            bc, bv, bom, bq, bw)

    # 5. rigid-rigid joints, then rigid attachments (weld constraints),
    # before the tear/plastic checks in finish_euler_substep (oracle
    # order)
    if top.joint_meta is not None:
        rc, rv, romega, rq, *bx = _solve_joints(
            top, cfg, rc, rv, romega, rq, r.inv_mass, inv_i,
            *((bc, bv, bom, bq) if boxed else (None,) * 4),
            bw if boxed else None, dt)
        if boxed:
            bc, bv, bom, bq = bx
    if top.attach_ids is not None:
        x, v, rc, rv, romega, rq = _solve_attachments(
            top, cfg, x, v, rc, rv, romega, rq, r.inv_mass, inv_i, dt)
    if top.attach_box_ids is not None:
        x, v, bc, bv, bom, bq = _solve_box_attachments(
            top, cfg, x, v, bc, bv, bom, bq, bw, dt)

    return (
        _step.finish_euler_substep(top, cfg, s, x, v, x_prev, alive, scale,
                                   quats=quats),
        RigidState(centers=rc, velocities=rv, inv_mass=r.inv_mass,
                   omega=romega, quat=rq,
                   **(dict(box_centers=bc, box_velocities=bv,
                           box_inv_mass=bw, box_omega=bom, box_quat=bq)
                      if boxed else {})),
    )


def _rigid_predict(top: Topology, cfg: SimConfig, r: RigidState, dt: float):
    """Rigid gravity predict + derived quantities (shared by all coupled
    substeps).  Integrates the orientation quaternion when carried
    (isotropic sphere inertia: no gyroscopic precession term)."""
    g = jnp.asarray(cfg.gravity, dtype=r.centers.dtype)
    dyn = (r.inv_mass > 0.0)[:, None]
    rv = jnp.where(dyn, r.velocities + dt * g[None, :], r.velocities)
    rc = r.centers + dt * rv
    romega = (r.omega if r.omega is not None
              else jnp.zeros_like(r.velocities))
    radii = (top.sphere_radii if top.sphere_radii is not None
             else jnp.zeros((0,), rc.dtype))     # sphere-free coupled scene
    inv_i = r.inv_mass * 2.5 / jnp.maximum(radii * radii, 1e-12)
    rq = None if r.quat is None else _quat_integrate(r.quat, romega, dt)
    return rc, rv, romega, radii, inv_i, rq


def _nearest_face(q, half):
    """Scalar nearest-face rule for a local point q in a box of half
    extents ``half`` (oracle argmin with ties x < y < z): returns
    (inside, push, n_local)."""
    pen = half - jnp.abs(q)
    inside = (pen > 0.0).all()
    k0 = (pen[0] <= pen[1]) & (pen[0] <= pen[2])
    k1 = (~k0) & (pen[1] <= pen[2])
    kmask = jnp.stack([k0, k1, ~(k0 | k1)]).astype(q.dtype)
    sgn = jnp.where(q >= 0.0, 1.0, -1.0)
    n_loc = kmask * sgn
    push = jnp.sum(pen * kmask)
    return inside, push, n_loc


def _ball_box_bounce(top, cfg, rc, rv, romega, r_inv_mass, inv_i, radii,
                     bc, bv, bom, bq, bw, ib):
    """Oracle _ball_box_bounce twin: dynamic ball vs dynamic box pair
    contacts, hit-masked instead of branched so it jits and vmaps."""
    e, mu = cfg.collision.restitution, cfg.collision.friction
    half = top.box_half_extents.astype(rc.dtype)
    for i in range(rc.shape[0]):
        for s in range(bc.shape[0]):
            wi, ws = r_inv_mass[i], bw[s]
            wsum = wi + ws
            wsafe = jnp.maximum(wsum, 1e-12)
            rot = _box_world_rot(top, bq, s)
            q = rot.T @ (rc[i] - bc[s])
            qc = jnp.clip(q, -half[s], half[s])
            dloc = q - qc
            dist = jnp.linalg.norm(dloc)
            inside, push, n_loc = _nearest_face(q, half[s])
            n = jnp.where(inside,
                          rot @ n_loc,
                          rot @ (dloc / jnp.maximum(dist, 1e-12)))
            pen = jnp.where(inside, push + radii[i], radii[i] - dist)
            hit = (pen > 0.0) & (wsum > 0.0)
            sep = jnp.where(hit, pen, 0.0)
            rc = rc.at[i].add(sep * (wi / wsafe) * n)
            bc = bc.at[s].add(-sep * (ws / wsafe) * n)
            un = jnp.dot(rv[i] - bv[s], n)
            p_n = jnp.where(hit & (un < 0.0), -(1.0 + e) * un / wsafe, 0.0)
            rv = rv.at[i].add(p_n * wi * n)
            bv = bv.at[s].add(-p_n * ws * n)
            a_i = -radii[i] * n
            p_c = rc[i] + a_i
            a_s = p_c - bc[s]
            u = (rv[i] + jnp.cross(romega[i], a_i)) \
                - (bv[s] + jnp.cross(bom[s], a_s))
            ut = u - jnp.dot(u, n) * n
            t = ut / jnp.maximum(jnp.linalg.norm(ut), 1e-12)
            iinv_s = rot @ (ib[s][:, None] * rot.T)
            ct = jnp.cross(a_s, t)
            k_t = wsum + inv_i[i] * radii[i] ** 2 + ct @ (iinv_s @ ct)
            p_t = jnp.where(hit, -mu, 0.0) * ut / jnp.maximum(k_t, 1e-12)
            rv = rv.at[i].add(p_t * wi)
            romega = romega.at[i].add(jnp.cross(a_i, p_t) * inv_i[i])
            bv = bv.at[s].add(-p_t * ws)
            bom = bom.at[s].add(-iinv_s @ jnp.cross(a_s, p_t))
    return rc, rv, romega, bc, bv, bom


def _sat_fallback_contact(cs_, rot_s, hs, ct_, rot_t, ht, signs):
    """Oracle _box_sat_fallback_contact twin (branchless): 15-axis OBB
    SAT for the no-corner-inside manifolds (X edge-edge crossings,
    plus-sign slab crossings).  Same axis order, first-minimum
    tie-break, and penetration slop (1e-3 x the smaller box dimension —
    see the oracle docstring for why a strict > 0 gate chatters on
    flush-resting stacks); degenerate cross axes masked to +inf so they
    can neither separate nor win.  Returns (hit, n, depth, point) with every value
    finite regardless of ``hit`` (callers mask with jnp.where)."""
    f = cs_.dtype
    d = ct_ - cs_
    corners_s = cs_[None, :] + (signs * hs) @ rot_s.T
    in_t = (jnp.abs((corners_s - ct_) @ rot_t)
            < ht[None, :]).all(axis=1).any()
    corners_t = ct_[None, :] + (signs * ht) @ rot_t.T
    in_s = (jnp.abs((corners_t - cs_) @ rot_s)
            < hs[None, :]).all(axis=1).any()
    cross = jnp.stack([jnp.cross(rot_s[:, i], rot_t[:, j])
                       for i in range(3) for j in range(3)])
    cn = jnp.linalg.norm(cross, axis=1)
    degen = cn < 1e-9
    crossu = cross / jnp.maximum(cn, 1e-9)[:, None]
    axes = jnp.concatenate([rot_s.T, rot_t.T, crossu], axis=0)   # [15, 3]
    ra = jnp.abs(axes @ rot_s) @ hs
    rb = jnp.abs(axes @ rot_t) @ ht
    overlap = ra + rb - jnp.abs(axes @ d)
    overlap = jnp.where(
        jnp.concatenate([jnp.zeros((6,), bool), degen]),
        jnp.asarray(jnp.inf, f), overlap)
    separated = (overlap <= 0.0).any()
    best_idx = jnp.argmin(overlap)
    depth = overlap[best_idx]
    u = axes[best_idx]
    n = jnp.where(u @ d >= 0.0, 1.0, -1.0).astype(f) * u
    slop = 1e-3 * jnp.minimum(hs.min(), ht.min())
    hit = (~separated) & (~in_t) & (~in_s) & (depth > slop)
    # face-axis fallback point: midpoint of the centers
    p_face = 0.5 * (cs_ + ct_)
    # cross-axis point: closest points of the two support edges
    ii = jnp.maximum(best_idx - 6, 0)
    oh_i = jax.nn.one_hot(ii // 3, 3, dtype=f)
    oh_j = jax.nn.one_hot(ii % 3, 3, dtype=f)
    sgn_s = jnp.sign(n @ rot_s)
    sgn_t = jnp.sign(n @ rot_t)
    off_s = rot_s @ (sgn_s * hs * (1.0 - oh_i))
    off_t = -(rot_t @ (sgn_t * ht * (1.0 - oh_j)))
    a_dir = rot_s @ oh_i
    b_dir = rot_t @ oh_j
    p_s0 = cs_ + off_s
    p_t0 = ct_ + off_t
    r = p_t0 - p_s0
    ab = a_dir @ b_dir
    denom = jnp.maximum(1.0 - ab * ab, 1e-12)
    adr, bdr = a_dir @ r, b_dir @ r
    sc = (adr - ab * bdr) / denom
    tc = (ab * adr - bdr) / denom
    hs_i, ht_j = hs @ oh_i, ht @ oh_j
    sc = jnp.clip(sc, -hs_i, hs_i)
    tc = jnp.clip(tc, -ht_j, ht_j)
    p_edge = 0.5 * ((p_s0 + sc * a_dir) + (p_t0 + tc * b_dir))
    p = jnp.where(best_idx < 6, p_face, p_edge)
    return hit, n, depth, p


def _box_box_bounce(top, cfg, bc, bv, bom, bq, bw, ib):
    """Oracle _box_box_bounce twin: corner-vs-face contacts over ordered
    box pairs, sequential corner impulses with torque on both bodies,
    hit-masked; then the SAT fallback pass over unordered pairs for the
    no-corner-inside manifolds (edge-edge X crossings, plus-sign slab
    crossings)."""
    e, mu = cfg.collision.restitution, cfg.collision.friction
    half = top.box_half_extents.astype(bc.dtype)
    signs = jnp.asarray(_BOX_CORNER_SIGNS, bc.dtype)
    B = bc.shape[0]
    for s in range(B):
        for t in range(B):
            if s == t:
                continue
            ws, wt = bw[s], bw[t]
            wsum = ws + wt
            wsafe = jnp.maximum(wsum, 1e-12)
            for k in range(8):
                rot_s = _box_world_rot(top, bq, s)
                rot_t = _box_world_rot(top, bq, t)
                iinv_s_ = rot_s @ (ib[s][:, None] * rot_s.T)
                iinv_t_ = rot_t @ (ib[t][:, None] * rot_t.T)
                corner = bc[s] + rot_s @ (signs[k] * half[s])
                q = rot_t.T @ (corner - bc[t])
                inside, push, n_loc = _nearest_face(q, half[t])
                hit = inside & (wsum > 0.0)
                n = rot_t @ n_loc
                sep = jnp.where(hit, push, 0.0)
                bc = bc.at[s].add(sep * (ws / wsafe) * n)
                bc = bc.at[t].add(-sep * (wt / wsafe) * n)
                r_s = corner - bc[s]
                r_t = corner - bc[t]
                u = (bv[s] + jnp.cross(bom[s], r_s)) \
                    - (bv[t] + jnp.cross(bom[t], r_t))
                un = jnp.dot(u, n)
                cs = jnp.cross(r_s, n)
                ctn = jnp.cross(r_t, n)
                k_n = wsum + cs @ (iinv_s_ @ cs) + ctn @ (iinv_t_ @ ctn)
                p_n = jnp.where(hit & (un < 0.0),
                                -(1.0 + e) * un / jnp.maximum(k_n, 1e-12),
                                0.0)
                P = p_n * n
                bv = bv.at[s].add(P * ws)
                bom = bom.at[s].add(iinv_s_ @ jnp.cross(r_s, P))
                bv = bv.at[t].add(-P * wt)
                bom = bom.at[t].add(-iinv_t_ @ jnp.cross(r_t, P))
                u2 = (bv[s] + jnp.cross(bom[s], r_s)) \
                    - (bv[t] + jnp.cross(bom[t], r_t))
                ut = u2 - jnp.dot(u2, n) * n
                th = ut / jnp.maximum(jnp.linalg.norm(ut), 1e-12)
                cst = jnp.cross(r_s, th)
                ctt = jnp.cross(r_t, th)
                k_t = wsum + cst @ (iinv_s_ @ cst) + ctt @ (iinv_t_ @ ctt)
                P_t = jnp.where(hit, -mu, 0.0) * ut / jnp.maximum(k_t, 1e-12)
                bv = bv.at[s].add(P_t * ws)
                bom = bom.at[s].add(iinv_s_ @ jnp.cross(r_s, P_t))
                bv = bv.at[t].add(-P_t * wt)
                bom = bom.at[t].add(-iinv_t_ @ jnp.cross(r_t, P_t))
    # ---- SAT fallback pass (unordered pairs; oracle order) ----------
    for s in range(B):
        for t in range(s + 1, B):
            ws, wt = bw[s], bw[t]
            wsum = ws + wt
            wsafe = jnp.maximum(wsum, 1e-12)
            rot_s = _box_world_rot(top, bq, s)
            rot_t = _box_world_rot(top, bq, t)
            iinv_s_ = rot_s @ (ib[s][:, None] * rot_s.T)
            iinv_t_ = rot_t @ (ib[t][:, None] * rot_t.T)
            hit0, n, depth, p = _sat_fallback_contact(
                bc[s], rot_s, half[s], bc[t], rot_t, half[t], signs)
            hit = hit0 & (wsum > 0.0)
            sep = jnp.where(hit, depth, 0.0)
            bc = bc.at[s].add(-sep * (ws / wsafe) * n)
            bc = bc.at[t].add(sep * (wt / wsafe) * n)
            r_s = p - bc[s]
            r_t = p - bc[t]
            u = (bv[s] + jnp.cross(bom[s], r_s)) \
                - (bv[t] + jnp.cross(bom[t], r_t))
            un = jnp.dot(u, n)
            cs = jnp.cross(r_s, n)
            ctn = jnp.cross(r_t, n)
            k_n = wsum + cs @ (iinv_s_ @ cs) + ctn @ (iinv_t_ @ ctn)
            p_n = jnp.where(hit & (un > 0.0),
                            -(1.0 + e) * un / jnp.maximum(k_n, 1e-12),
                            0.0)
            P = p_n * n
            bv = bv.at[s].add(P * ws)
            bom = bom.at[s].add(iinv_s_ @ jnp.cross(r_s, P))
            bv = bv.at[t].add(-P * wt)
            bom = bom.at[t].add(-iinv_t_ @ jnp.cross(r_t, P))
            u2 = (bv[s] + jnp.cross(bom[s], r_s)) \
                - (bv[t] + jnp.cross(bom[t], r_t))
            ut = u2 - jnp.dot(u2, n) * n
            th = ut / jnp.maximum(jnp.linalg.norm(ut), 1e-12)
            cst = jnp.cross(r_s, th)
            ctt = jnp.cross(r_t, th)
            k_t = wsum + cst @ (iinv_s_ @ cst) + ctt @ (iinv_t_ @ ctt)
            P_t = jnp.where(hit, -mu, 0.0) * ut / jnp.maximum(k_t, 1e-12)
            bv = bv.at[s].add(P_t * ws)
            bom = bom.at[s].add(iinv_s_ @ jnp.cross(r_s, P_t))
            bv = bv.at[t].add(-P_t * wt)
            bom = bom.at[t].add(-iinv_t_ @ jnp.cross(r_t, P_t))
    return bc, bv, bom


@_highp
def _box_environment(top, cfg, rc, rv, romega, r_inv_mass, inv_i, radii,
                     bc, bv, bom, bq, bw):
    """Oracle _box_environment twin: box-plane corner bounce, then
    ball-vs-box, then box-vs-box contacts."""
    bc, bv, bom = _box_plane_bounce(top, cfg, bc, bv, bom, bq, bw)
    half = top.box_half_extents.astype(bc.dtype)
    ib = _box_inv_inertia_body(bw, half)
    rc, rv, romega, bc, bv, bom = _ball_box_bounce(
        top, cfg, rc, rv, romega, r_inv_mass, inv_i, radii,
        bc, bv, bom, bq, bw, ib)
    bc, bv, bom = _box_box_bounce(top, cfg, bc, bv, bom, bq, bw, ib)
    return rc, rv, romega, bc, bv, bom


def _boxes_predict(cfg, r: RigidState, dt: float):
    """Oracle _boxes_predict twin: gravity predict + orientation
    integrate for the dynamic boxes."""
    bc, bv = r.box_centers, r.box_velocities
    bom, bq, bw = r.box_omega, r.box_quat, r.box_inv_mass
    g = jnp.asarray(cfg.gravity, dtype=bc.dtype)
    dyn = (bw > 0.0)[:, None]
    bv = jnp.where(dyn, bv + dt * g[None, :], bv)
    bc = bc + dt * bv
    bq = _quat_integrate(bq, bom, dt)
    return bc, bv, bom, bq, bw


# ---- quaternion helpers (wxyz; oracle _quat_* twins) --------------------

def _quat_mul(p, q):
    pw, px, py, pz = p[0], p[1], p[2], p[3]
    qw, qx, qy, qz = q[0], q[1], q[2], q[3]
    return jnp.stack([
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw,
    ])


def _quat_rotate(q, v):
    qv = q[1:]
    return v + 2.0 * jnp.cross(qv, jnp.cross(qv, v) + q[0] * v)


def _quat_from_rotvec(t):
    """Exact exponential map, mirroring the oracle's small-angle branch
    (both sides switch at 1e-12 so parity holds bit-for-bit above it)."""
    angle = jnp.linalg.norm(t)
    axis = t / jnp.maximum(angle, 1e-12)
    h = 0.5 * angle
    exact = jnp.concatenate([jnp.cos(h)[None], jnp.sin(h) * axis])
    small = jnp.concatenate([jnp.ones((1,), t.dtype), 0.5 * t])
    return jnp.where(angle < 1e-12, small, exact)


def _quat_integrate(rq, romega, dt):
    def one(q, om):
        q2 = _quat_mul(_quat_from_rotvec(dt * om), q)
        return q2 / jnp.linalg.norm(q2)

    return jax.vmap(one)(rq, romega)


def _quat_to_matrix(q):
    """Oracle _quat_to_matrix twin: unit wxyz quaternion -> world-from-
    body rotation matrix."""
    w, xq, yq, zq = q[0], q[1], q[2], q[3]
    return jnp.stack([
        jnp.stack([1 - 2 * (yq * yq + zq * zq), 2 * (xq * yq - w * zq),
                   2 * (xq * zq + w * yq)]),
        jnp.stack([2 * (xq * yq + w * zq), 1 - 2 * (xq * xq + zq * zq),
                   2 * (yq * zq - w * xq)]),
        jnp.stack([2 * (xq * zq - w * yq), 2 * (yq * zq + w * xq),
                   1 - 2 * (xq * xq + yq * yq)]),
    ])


def _solve3(K, b):
    """Oracle _solve3 twin: closed-form 3x3 solve by cofactor expansion
    (same operation order, so f64 parity is tight); (x, det)."""
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
    x = jnp.stack([
        c00 * b[0] + c10 * b[1] + c20 * b[2],
        c01 * b[0] + c11 * b[1] + c21 * b[2],
        c02 * b[0] + c12 * b[1] + c22 * b[2],
    ]) / jnp.maximum(det, 1e-18)
    return x, det


@_highp
def _solve_box_attachments(top, cfg, x, v, bc, bv, bom, bq, bw, dt):
    """Oracle _solve_box_attachments twin: sequential Gauss-Seidel over
    the box-attachment list (static count, traced indices — jits and
    vmaps); the full anisotropic generalized-inverse-mass 3x3 solve via
    the cofactor closed form, split vertex/center/orientation."""
    half = top.box_half_extents.astype(x.dtype)
    ib = _box_inv_inertia_body(bw, half)
    eye = jnp.eye(3, dtype=x.dtype)
    for k in range(top.n_box_attachments):
        vid = top.attach_box_ids[k]
        b = top.attach_box_body[k]
        rot = _quat_to_matrix(bq[b]) @ top.box_rotations[b].astype(x.dtype)
        a = rot @ top.attach_box_local[k].astype(x.dtype)
        C = x[vid] - (bc[b] + a)
        w_v = top.inv_mass[vid]
        w_b = bw[b]
        iinv_w = rot @ (ib[b][:, None] * rot.T)
        ax = jnp.stack([
            jnp.stack([jnp.zeros_like(a[0]), -a[2], a[1]]),
            jnp.stack([a[2], jnp.zeros_like(a[0]), -a[0]]),
            jnp.stack([-a[1], a[0], jnp.zeros_like(a[0])]),
        ])
        K = (w_v + w_b) * eye - ax @ iinv_w @ ax
        P, det = _solve3(K, C)
        P = jnp.where(det > 1e-18, -P, 0.0)
        x = x.at[vid].add(w_v * P)
        if v is not None:
            v = v.at[vid].add(w_v * P / dt)
        bc = bc.at[b].add(-w_b * P)
        bv = bv.at[b].add(-w_b * P / dt)
        dth = -iinv_w @ jnp.cross(a, P)
        bom = bom.at[b].add(dth / dt)
        q2 = _quat_mul(_quat_from_rotvec(dth), bq[b])
        bq = bq.at[b].set(q2 / jnp.linalg.norm(q2))
    return x, v, bc, bv, bom, bq


# ---- dynamic rigid boxes (oracle "dynamic rigid boxes" section twins) ---

_BOX_CORNER_SIGNS = np.array(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
     for sz in (-1.0, 1.0)])


def _box_inv_inertia_body(bw, half):
    """Solid-box inverse inertia, diagonal in the body frame, [B,3]."""
    e2 = half * half
    s = jnp.stack([e2[:, 1] + e2[:, 2], e2[:, 0] + e2[:, 2],
                   e2[:, 0] + e2[:, 1]], axis=1)
    return bw[:, None] * 3.0 / jnp.maximum(s, 1e-12)


def _box_world_rot(top, bq, s):
    """World rotation of dynamic box s: orientation quat on top of the
    build pose (oracle _box_world_rot twin)."""
    return _quat_to_matrix(bq[s]) @ top.box_rotations[s].astype(bq.dtype)


def _box_face_push(x, center, half, rot):
    """Oracle _box_face_push twin on [N,3] arrays: (inside, push, n) with
    the nearest-face exit rule, ties x < y < z."""
    q = (x - center) @ rot
    pen = half[None, :] - jnp.abs(q)
    inside = (pen > 0.0).all(axis=1)
    k0 = (pen[:, 0] <= pen[:, 1]) & (pen[:, 0] <= pen[:, 2])
    k1 = (~k0) & (pen[:, 1] <= pen[:, 2])
    kmask = jnp.stack([k0, k1, ~(k0 | k1)], axis=1)
    sgn = jnp.where(q >= 0.0, 1.0, -1.0)
    n = jnp.where(kmask, sgn, 0.0) @ rot.T
    push = (pen * kmask).sum(axis=1)
    return inside, push, n


@_highp
def _dynamic_boxes_euler(top, cfg, x, v, movable, m, bc, bv, bom, bq, bw):
    """Oracle _dynamic_boxes_euler twin: velocity-level cloth<->box
    contact — face push-out reduced-mass scaled (center takes the
    complementary translation), restitution + friction against the box's
    surface velocity at each contact point, measured impulse reacting on
    ``bv`` and (through the contact-point arms) on ``bom`` via the world
    inverse inertia."""
    e, mu = cfg.collision.restitution, cfg.collision.friction
    half = top.box_half_extents.astype(x.dtype)
    ib = _box_inv_inertia_body(bw, half)
    for s in range(bc.shape[0]):
        rot = _box_world_rot(top, bq, s)
        inside, push, n = _box_face_push(x, bc[s], half[s], rot)
        contact = inside & movable
        m_c = jnp.sum(m * contact)
        beta = 1.0 / (1.0 + bw[s] * m_c)
        dx = beta * jnp.where(contact, push, 0.0)[:, None] * n
        x = x + dx
        bc = bc.at[s].add(-bw[s] * jnp.sum(m[:, None] * dx, axis=0))
        arm = x - bc[s]
        w_i = bv[s][None, :] + jnp.cross(
            jnp.broadcast_to(bom[s], arm.shape), arm)
        v0 = v
        u = v - w_i
        un = jnp.einsum("ij,ij->i", u, n)
        inward = contact & (un < 0.0)
        v1 = v - jnp.where(inward, (1.0 + e) * un, 0.0)[:, None] * n
        u2 = v1 - w_i
        un2 = jnp.einsum("ij,ij->i", u2, n)[:, None] * n
        ut = u2 - un2
        v_t = jnp.where(contact[:, None],
                        w_i + un2 + ut * (1.0 - mu), v1)
        v = v0 + beta * (v_t - v0)
        dp = m[:, None] * (v - v0)
        bv = bv.at[s].add(-jnp.sum(dp, axis=0) * bw[s])
        L = jnp.sum(jnp.cross(arm, dp), axis=0)
        bom = bom.at[s].add(-rot @ (ib[s] * (rot.T @ L)))
    return x, v, bc, bv, bom


@_highp
def _project_boxes_measured(top, x, movable, m, bc, bq, dt, bw):
    """Oracle _project_boxes_measured twin: position-only face push-out
    at the dynamic poses, reduced-mass scaled; (x, j_lin [B,3]).  Linear
    reaction only — the PBD coupled contract stays spin-free."""
    half = top.box_half_extents.astype(x.dtype)
    j_lin = []
    for s in range(bc.shape[0]):
        rot = _box_world_rot(top, bq, s)
        inside, push, n = _box_face_push(x, bc[s], half[s], rot)
        contact = inside & movable
        beta = 1.0 / (1.0 + bw[s] * jnp.sum(m * contact))
        dx = beta * jnp.where(contact, push, 0.0)[:, None] * n
        x = x + dx
        j_lin.append(jnp.sum(m[:, None] * dx / dt, axis=0))
    return x, jnp.stack(j_lin)


@_highp
def _box_friction_measured(top, cfg, x, x_start, dt, movable, m, bc, bq,
                           bv, bw):
    """Oracle _one_box_friction twin over all dynamic boxes: contact-
    shell tangential position friction relative to each box's linear
    velocity, reduced-mass scaled, measured impulse for the reaction."""
    from .collide import BOX_CONTACT_SHELL

    mu = cfg.collision.friction
    j_t = jnp.zeros_like(bc)
    if not cfg.collision.enable_boxes or mu == 0.0:
        return x, j_t
    half_all = top.box_half_extents.astype(x.dtype)
    for s in range(bc.shape[0]):
        half = half_all[s]
        shell = BOX_CONTACT_SHELL * jnp.max(half)
        rot = _box_world_rot(top, bq, s)
        q = (x - bc[s]) @ rot
        pen = half[None, :] - jnp.abs(q)
        mn = pen.min(axis=1)
        contact = (mn >= -shell) & (mn <= shell) & movable
        _, _, n = _box_face_push(x, bc[s], half, rot)
        rel = (x - x_start) - bv[s][None, :] * dt
        rel_t = rel - jnp.einsum("ij,ij->i", rel, n)[:, None] * n
        beta = 1.0 / (1.0 + bw[s] * jnp.sum(m * contact))
        dx_t = jnp.where(contact[:, None], -mu * beta * rel_t, 0.0)
        x = x + dx_t
        j_t = j_t.at[s].set((m[:, None] * dx_t).sum(axis=0) / dt)
    return x, j_t


def _box_plane_bounce(top, cfg, bc, bv, bom, bq, bw):
    """Oracle _box_plane_bounce twin: translation lift by the deepest
    corner, then sequential corner impulses (normal with restitution on
    approach + tangential friction) with the exact effective inverse
    mass at each corner arm — hit-masked instead of branched, so it jits
    and vmaps.  Corner arms are lift-invariant (r = rot @ (signs*half)),
    so pen is evaluated at the pre-lift pose exactly like the oracle."""
    if not cfg.collision.enable_plane:
        return bc, bv, bom
    e, mu = cfg.collision.restitution, cfg.collision.friction
    half = top.box_half_extents.astype(bc.dtype)
    ib = _box_inv_inertia_body(bw, half)
    signs = jnp.asarray(_BOX_CORNER_SIGNS, bc.dtype)
    n = jnp.asarray([0.0, 1.0, 0.0], bc.dtype)
    for s in range(bc.shape[0]):
        rot = _box_world_rot(top, bq, s)
        arms = (signs * half[s]) @ rot.T                       # [8, 3]
        pen = top.plane_height - (bc[s, 1] + arms[:, 1])
        dyn = bw[s] > 0.0
        lift = jnp.where(dyn, jnp.maximum(pen.max(), 0.0), 0.0)
        bc = bc.at[s, 1].add(lift)

        def iinv(L, rot=rot, ibs=ib[s]):
            return rot @ (ibs * (rot.T @ L))

        for k in range(8):
            hit = (pen[k] > 0.0) & dyn
            r_k = arms[k]
            u = bv[s] + jnp.cross(bom[s], r_k)
            un = u[1]
            cr = jnp.cross(r_k, n)
            kn = bw[s] + cr @ iinv(cr)
            Pn = jnp.where(hit & (un < 0.0),
                           -(1.0 + e) * un / jnp.maximum(kn, 1e-12),
                           0.0) * n
            bv = bv.at[s].add(Pn * bw[s])
            bom = bom.at[s].add(iinv(jnp.cross(r_k, Pn)))
            u2 = bv[s] + jnp.cross(bom[s], r_k)
            ut = u2 * jnp.asarray([1.0, 0.0, 1.0], bc.dtype)
            t = ut / jnp.maximum(jnp.linalg.norm(ut), 1e-12)
            ct = jnp.cross(r_k, t)
            kt = bw[s] + ct @ iinv(ct)
            Pt = jnp.where(hit, -mu, 0.0) * ut / jnp.maximum(kt, 1e-12)
            bv = bv.at[s].add(Pt * bw[s])
            bom = bom.at[s].add(iinv(jnp.cross(r_k, Pt)))
    return bc, bv, bom


@_highp
def _solve_joints(top: Topology, cfg: SimConfig, rc, rv, romega, rq,
                  r_inv_mass, inv_i, bc, bv, bom, bq, bw, dt):
    """Oracle ``_solve_rigid_joints`` twin — rigid-rigid ball / hinge /
    distance joints, solved sequentially in joint-index order with the
    same operation order (f64 parity).  Body refs come from the STATIC
    ``top.joint_meta`` tuple, so the loop unrolls over concrete
    (kind, index) pairs; the "inert" skips become zero impulses
    (``jnp.where`` on the det/w_rot/w_eff guards), which apply exactly
    zero updates.  Box args are None for a box-free scene."""
    f = rc.dtype
    eye = jnp.eye(3, dtype=f)
    boxed = bc is not None
    if boxed:
        half = top.box_half_extents.astype(f)
        ib = _box_inv_inertia_body(bw, half)

    def _iinv(kind, i):
        if kind == "world":
            return jnp.zeros((3, 3), f)
        if kind == "sphere":
            return inv_i[i] * eye
        rot = _box_world_rot(top, bq, i)
        return rot @ (ib[i][:, None] * rot.T)

    def _frame_vec(kind, i, v3):
        v3 = v3.astype(f)
        if kind == "world":
            return v3
        if kind == "sphere":
            return _quat_rotate(rq[i], v3)
        return _box_world_rot(top, bq, i) @ v3

    def _side(kind, i, local):
        if kind == "world":
            return local.astype(f), jnp.zeros(3, f), jnp.zeros((), f), \
                jnp.zeros((3, 3), f)
        a = _frame_vec(kind, i, local)
        c = rc[i] if kind == "sphere" else bc[i]
        w = r_inv_mass[i] if kind == "sphere" else bw[i]
        return c + a, a, w, _iinv(kind, i)

    def _apply(kind, i, P, arm, iinv):
        nonlocal rc, rv, romega, rq, bc, bv, bom, bq
        if kind == "world":
            return
        dth = iinv @ jnp.cross(arm, P)
        if kind == "sphere":
            w = r_inv_mass[i]
            rc = rc.at[i].add(w * P)
            rv = rv.at[i].add(w * P / dt)
            romega = romega.at[i].add(dth / dt)
            q = _quat_mul(_quat_from_rotvec(dth), rq[i])
            rq = rq.at[i].set(q / jnp.linalg.norm(q))
        else:
            w = bw[i]
            bc = bc.at[i].add(w * P)
            bv = bv.at[i].add(w * P / dt)
            bom = bom.at[i].add(dth / dt)
            q = _quat_mul(_quat_from_rotvec(dth), bq[i])
            bq = bq.at[i].set(q / jnp.linalg.norm(q))

    def _apply_rot(kind, i, dth):
        nonlocal romega, rq, bom, bq
        if kind == "world":
            return
        if kind == "sphere":
            romega = romega.at[i].add(dth / dt)
            q = _quat_mul(_quat_from_rotvec(dth), rq[i])
            rq = rq.at[i].set(q / jnp.linalg.norm(q))
        else:
            bom = bom.at[i].add(dth / dt)
            q = _quat_mul(_quat_from_rotvec(dth), bq[i])
            bq = bq.at[i].set(q / jnp.linalg.norm(q))

    def _omega(kind, i):
        if kind == "world":
            return jnp.zeros(3, f)
        return romega[i] if kind == "sphere" else bom[i]

    def _apply_omega(kind, i, dom):
        nonlocal romega, bom
        if kind == "world":
            return
        if kind == "sphere":
            romega = romega.at[i].add(dom)
        else:
            bom = bom.at[i].add(dom)

    def _skew(a):
        z = jnp.zeros((), f)
        return jnp.stack([
            jnp.stack([z, -a[2], a[1]]),
            jnp.stack([a[2], z, -a[0]]),
            jnp.stack([-a[1], a[0], z]),
        ])

    def _ball_solve(kind_a, ia_, la, kind_b, ib_, lb):
        p_a, a, w_a, iinv_a = _side(kind_a, ia_, la)
        p_b, b_arm, w_b, iinv_b = _side(kind_b, ib_, lb)
        C = p_a - p_b
        sa, sb = _skew(a), _skew(b_arm)
        K = (w_a + w_b) * eye - sa @ iinv_a @ sa - sb @ iinv_b @ sb
        P, det = _solve3(K, C)
        P = jnp.where(det > 1e-18, -P, 0.0)
        _apply(kind_a, ia_, P, a, iinv_a)
        _apply(kind_b, ib_, -P, b_arm, iinv_b)

    for k, (jtype, kind_a, ia_, kind_b, ib_) in enumerate(top.joint_meta):
        la = top.joint_local_a[k]
        lb = top.joint_local_b[k]
        if jtype == "hinge":
            aw = _frame_vec(kind_a, ia_, top.joint_axis_a[k])
            bw_ax = _frame_vec(kind_b, ib_, top.joint_axis_b[k])
            t = jnp.cross(aw, bw_ax)
            tn = jnp.linalg.norm(t)
            nhat = t / jnp.maximum(tn, 1e-12)
            iinv_a, iinv_b = _iinv(kind_a, ia_), _iinv(kind_b, ib_)
            w_rot = nhat @ ((iinv_a + iinv_b) @ nhat)
            lam = jnp.where((tn > 1e-12) & (w_rot > 1e-18),
                            tn / jnp.maximum(w_rot, 1e-18), 0.0)
            _apply_rot(kind_a, ia_, iinv_a @ (nhat * lam))
            _apply_rot(kind_b, ib_, -(iinv_b @ (nhat * lam)))
            # limits (position-level), then the ball anchor, then the
            # motor (velocity-level) — oracle order; all where-gated
            lim = top.joint_limit[k]
            mot = top.joint_motor[k]
            n_ax = _frame_vec(kind_a, ia_, top.joint_axis_a[k])
            n_ax = n_ax / jnp.linalg.norm(n_ax)
            iinv_a = _iinv(kind_a, ia_)
            iinv_b = _iinv(kind_b, ib_)
            w_rot = n_ax @ ((iinv_a + iinv_b) @ n_ax)
            rot_ok = w_rot > 1e-18
            ra_w = _frame_vec(kind_a, ia_, top.joint_ref_a[k])
            rb_w = _frame_vec(kind_b, ib_, top.joint_ref_b[k])
            ra_p = ra_w - (ra_w @ n_ax) * n_ax
            rb_p = rb_w - (rb_w @ n_ax) * n_ax
            theta = jnp.arctan2(jnp.cross(rb_p, ra_p) @ n_ax, ra_p @ rb_p)
            excess = jnp.where(theta > lim[1], theta - lim[1],
                               jnp.where(theta < lim[0],
                                         theta - lim[0], 0.0))
            lam_l = jnp.where((lim[0] <= lim[1]) & rot_ok,
                              -excess / jnp.maximum(w_rot, 1e-18), 0.0)
            _apply_rot(kind_a, ia_, iinv_a @ (n_ax * lam_l))
            _apply_rot(kind_b, ib_, -(iinv_b @ (n_ax * lam_l)))
            _ball_solve(kind_a, ia_, la, kind_b, ib_, lb)
            rel = (_omega(kind_a, ia_) - _omega(kind_b, ib_)) @ n_ax \
                - mot[0]
            lam_m = jnp.clip(-rel / jnp.maximum(w_rot, 1e-18),
                             -mot[1] * dt, mot[1] * dt)
            lam_m = jnp.where((mot[1] > 0.0) & rot_ok, lam_m, 0.0)
            _apply_omega(kind_a, ia_, iinv_a @ (n_ax * lam_m))
            _apply_omega(kind_b, ib_, -(iinv_b @ (n_ax * lam_m)))
        elif jtype == "ball":
            _ball_solve(kind_a, ia_, la, kind_b, ib_, lb)
        else:                                               # distance
            p_a, a, w_a, iinv_a = _side(kind_a, ia_, la)
            p_b, b_arm, w_b, iinv_b = _side(kind_b, ib_, lb)
            d = p_a - p_b
            L = jnp.linalg.norm(d)
            nhat = d / jnp.maximum(L, 1e-12)
            C = L - top.joint_rest[k]
            axn, bxn = jnp.cross(a, nhat), jnp.cross(b_arm, nhat)
            w_eff = w_a + w_b + axn @ (iinv_a @ axn) + bxn @ (iinv_b @ bxn)
            alpha_t = top.joint_compliance[k] / (dt * dt)
            lam = jnp.where(w_eff + alpha_t > 1e-18,
                            -C / jnp.maximum(w_eff + alpha_t, 1e-18), 0.0)
            P = lam * nhat
            _apply(kind_a, ia_, P, a, iinv_a)
            _apply(kind_b, ib_, -P, b_arm, iinv_b)

    return rc, rv, romega, rq, bc, bv, bom, bq


@_highp
def _solve_attachments(top, cfg, x, v, rc, rv, romega, rq, r_inv_mass,
                       inv_i, dt):
    """Oracle _solve_attachments twin: sequential Gauss-Seidel over the
    attachment list (static count, traced indices — jits and vmaps); the
    generalized-inverse-mass correction P = -K^{-1} C via the
    Sherman-Morrison closed form, split vertex/center/orientation."""
    for k in range(top.n_attachments):
        vid = top.attach_ids[k]
        b = top.attach_body[k]
        a = _quat_rotate(rq[b], top.attach_local[k].astype(x.dtype))
        C = x[vid] - (rc[b] + a)
        w_v = top.inv_mass[vid]
        w_b = r_inv_mass[b]
        ii = inv_i[b]
        al = w_v + w_b + ii * jnp.dot(a, a)
        P = -(C / jnp.maximum(al, 1e-12)
              + ii * jnp.dot(a, C) * a
              / (jnp.maximum(al, 1e-12) * jnp.maximum(w_v + w_b, 1e-12)))
        P = jnp.where(al > 0.0, P, 0.0)
        x = x.at[vid].add(w_v * P)
        if v is not None:
            v = v.at[vid].add(w_v * P / dt)
        rc = rc.at[b].add(-w_b * P)
        rv = rv.at[b].add(-w_b * P / dt)
        dth = -ii * jnp.cross(a, P)
        romega = romega.at[b].add(dth / dt)
        q2 = _quat_mul(_quat_from_rotvec(dth), rq[b])
        rq = rq.at[b].set(q2 / jnp.linalg.norm(q2))
    return x, v, rc, rv, romega, rq


def _rigid_plane_bounce(top: Topology, cfg: SimConfig, r: RigidState,
                        rc, rv, romega, radii, inv_i):
    """Dynamic sphere vs ground plane: normal bounce + tangential friction
    impulse at the contact point (arm a = -r n) — friction torque makes
    the ball roll instead of skid.  Shared by all coupled substeps (the
    ball's own state is always explicit)."""
    if not cfg.collision.enable_plane:
        return rc, rv, romega
    pen = top.plane_height - (rc[:, 1] - radii)
    hit = (pen > 0.0) & (r.inv_mass > 0.0)
    rc = rc.at[:, 1].set(
        jnp.where(hit, top.plane_height + radii, rc[:, 1]))
    vy = rv[:, 1]
    rv = rv.at[:, 1].set(
        jnp.where(hit & (vy < 0.0), -cfg.collision.restitution * vy, vy))
    arm = jnp.stack([jnp.zeros_like(radii), -radii,
                     jnp.zeros_like(radii)], axis=1)
    u = rv + jnp.cross(romega, arm)
    ut = u.at[:, 1].set(0.0)
    k = r.inv_mass + inv_i * radii * radii
    p_t = -cfg.collision.friction * ut / jnp.maximum(k, 1e-12)[:, None]
    p_t = jnp.where(hit[:, None], p_t, 0.0)
    rv = rv + p_t * r.inv_mass[:, None]
    romega = romega + jnp.cross(arm, p_t) * inv_i[:, None]
    return rc, rv, romega


def _ball_static_response(cfg, rc, rv, romega, r_inv_mass, inv_i, radii,
                          pen, n):
    """Oracle _ball_static_response twin: dynamic-ball-vs-static-surface
    push-out + normal reflect + rolling-friction impulse with torque,
    vectorized over balls, hit-masked."""
    e, mu = cfg.collision.restitution, cfg.collision.friction
    hit = (pen > 0.0) & (r_inv_mass > 0.0)
    rc = rc + jnp.where(hit, pen, 0.0)[:, None] * n
    un = jnp.einsum("ij,ij->i", rv, n)
    refl = hit & (un < 0.0)
    rv = rv - jnp.where(refl, (1.0 + e) * un, 0.0)[:, None] * n
    arm = -radii[:, None] * n
    u = rv + jnp.cross(romega, arm)
    ut = u - jnp.einsum("ij,ij->i", u, n)[:, None] * n
    k = r_inv_mass + inv_i * radii * radii
    p_t = -mu * ut / jnp.maximum(k, 1e-12)[:, None]
    p_t = jnp.where(hit[:, None], p_t, 0.0)
    rv = rv + p_t * r_inv_mass[:, None]
    romega = romega + jnp.cross(arm, p_t) * inv_i[:, None]
    return rc, rv, romega


def _rigid_static_bounce(top, cfg, rc, rv, romega, r_inv_mass, inv_i,
                         radii, skip_boxes=False):
    """Oracle _rigid_static_bounce twin: dynamic balls vs the scene's
    static capsules / boxes / SDFs (collider-enable order).
    ``skip_boxes`` when the boxes are dynamic this substep
    (ball-vs-dynamic-box runs two-body in _ball_box_bounce instead)."""
    if cfg.collision.enable_capsules and top.n_capsules > 0:
        for s in range(top.n_capsules):
            p0, p1 = top.capsule_p0[s], top.capsule_p1[s]
            ax = p1 - p0
            l2 = jnp.dot(ax, ax)
            t = jnp.clip((rc - p0) @ ax / jnp.maximum(l2, 1e-12), 0.0, 1.0)
            cpt = p0 + t[:, None] * ax
            d = rc - cpt
            dist = jnp.linalg.norm(d, axis=1)
            n = d / jnp.maximum(dist, 1e-12)[:, None]
            pen = (top.capsule_radii[s] + radii) - dist
            rc, rv, romega = _ball_static_response(
                cfg, rc, rv, romega, r_inv_mass, inv_i, radii, pen, n)
    if cfg.collision.enable_boxes and top.n_boxes > 0 and not skip_boxes:
        for s in range(top.n_boxes):
            c, h = top.box_centers[s], top.box_half_extents[s]
            rot = top.box_rotations[s]
            q = (rc - c) @ rot
            qc = jnp.clip(q, -h, h)
            dloc = q - qc
            dist = jnp.linalg.norm(dloc, axis=1)
            n_out = (dloc / jnp.maximum(dist, 1e-12)[:, None]) @ rot.T
            # center-inside: exit through the nearest face (oracle
            # _box_face_push rule, ties x < y < z)
            pen_f = h[None, :] - jnp.abs(q)
            inside = (pen_f > 0.0).all(axis=1)
            k0 = (pen_f[:, 0] <= pen_f[:, 1]) & (pen_f[:, 0] <= pen_f[:, 2])
            k1 = (~k0) & (pen_f[:, 1] <= pen_f[:, 2])
            kmask = jnp.stack([k0, k1, ~(k0 | k1)], axis=1)
            sgn = jnp.where(q >= 0.0, 1.0, -1.0)
            n_in = jnp.where(kmask, sgn, 0.0) @ rot.T
            push = (pen_f * kmask).sum(axis=1)
            pen = jnp.where(inside, push + radii, radii - dist)
            n = jnp.where(inside[:, None], n_in, n_out)
            rc, rv, romega = _ball_static_response(
                cfg, rc, rv, romega, r_inv_mass, inv_i, radii, pen, n)
    if collide._needs_sdf(top, cfg):
        for s in range(top.n_sdfs):
            g, o, h = collide._sdf_scalars(top, s)
            phi, grad = collide.sdf_sample_grad_components(
                [rc[:, 0], rc[:, 1], rc[:, 2]], g, o, h)
            gn = jnp.sqrt(grad[0] ** 2 + grad[1] ** 2 + grad[2] ** 2)
            inv = 1.0 / jnp.maximum(gn, 1e-12)
            n = jnp.stack([grad[c] * inv for c in range(3)], axis=1)
            pen = radii - phi
            rc, rv, romega = _ball_static_response(
                cfg, rc, rv, romega, r_inv_mass, inv_i, radii, pen, n)
    return rc, rv, romega


def _rigid_rigid_bounce(cfg, rc, rv, romega, r_inv_mass, inv_i, radii):
    """Oracle _rigid_rigid_bounce twin: pairwise sequential (i < j)
    ball-ball contacts — inverse-mass-weighted separation, restitution
    normal impulse on approach, contact friction impulse with torque —
    hit-masked instead of branched, so it jits and vmaps."""
    S = rc.shape[0]
    e, mu = cfg.collision.restitution, cfg.collision.friction
    for i in range(S):
        for j in range(i + 1, S):
            wi, wj = r_inv_mass[i], r_inv_mass[j]
            wsum = wi + wj
            d = rc[j] - rc[i]
            dist = jnp.linalg.norm(d)
            n = d / jnp.maximum(dist, 1e-12)
            pen = (radii[i] + radii[j]) - dist
            hit = (pen > 0.0) & (wsum > 0.0)
            wsafe = jnp.maximum(wsum, 1e-12)
            sep = jnp.where(hit, pen, 0.0)
            rc = rc.at[i].add(-sep * (wi / wsafe) * n)
            rc = rc.at[j].add(sep * (wj / wsafe) * n)
            un = jnp.dot(rv[j] - rv[i], n)
            p_n = jnp.where(hit & (un < 0.0), -(1.0 + e) * un / wsafe, 0.0)
            rv = rv.at[i].add(-p_n * wi * n)
            rv = rv.at[j].add(p_n * wj * n)
            ai, aj = radii[i] * n, -radii[j] * n
            u = (rv[j] + jnp.cross(romega[j], aj)) \
                - (rv[i] + jnp.cross(romega[i], ai))
            ut = u - jnp.dot(u, n) * n
            k = wsum + inv_i[i] * radii[i] ** 2 + inv_i[j] * radii[j] ** 2
            p_t = jnp.where(hit, -mu, 0.0) * ut / jnp.maximum(k, 1e-12)
            rv = rv.at[j].add(p_t * wj)
            rv = rv.at[i].add(-p_t * wi)
            romega = romega.at[j].add(jnp.cross(aj, p_t) * inv_i[j])
            romega = romega.at[i].add(jnp.cross(ai, -p_t) * inv_i[i])
    return rc, rv, romega


@_highp
def _rigid_environment(top, cfg, r, rc, rv, romega, radii, inv_i,
                       skip_boxes=False):
    """Oracle _rigid_environment twin: plane, then static colliders, then
    ball-ball contacts (shared by every coupled substep)."""
    rc, rv, romega = _rigid_plane_bounce(top, cfg, r, rc, rv, romega,
                                         radii, inv_i)
    rc, rv, romega = _rigid_static_bounce(top, cfg, rc, rv, romega,
                                          r.inv_mass, inv_i, radii,
                                          skip_boxes=skip_boxes)
    rc, rv, romega = _rigid_rigid_bounce(cfg, rc, rv, romega,
                                         r.inv_mass, inv_i, radii)
    return rc, rv, romega


@_highp
def _project_spheres_measured(x, movable, m, rc, radii, dt,
                              r_inv_mass=None):
    """Position-only sphere projection at the rigid centers (oracle
    _project_spheres_measured twin): returns (x, j_lin [S,3]) — the
    per-sphere projection momentum sum_i m_i dx_i / dt.  The push is
    purely RADIAL (dx parallel to the contact normal through the center),
    so it exerts exactly zero torque — no angular term to measure.
    ``r_inv_mass`` engages the reduced-mass pair split (vertex push
    scaled by beta = M/(M + m_c); callers shift the balls by
    ``-w_b * j_lin * dt``) — see the oracle docstring."""
    if rc.shape[0] == 0:                 # sphere-free coupled scene
        return x, jnp.zeros_like(rc)
    j_lin = []
    for si in range(rc.shape[0]):
        d = x - rc[si]
        dist = jnp.linalg.norm(d, axis=1)
        pen = radii[si] - dist
        contact = (pen > 0.0) & movable
        n = d / jnp.maximum(dist, 1e-12)[:, None]
        beta = (1.0 if r_inv_mass is None
                else 1.0 / (1.0 + r_inv_mass[si] * jnp.sum(m * contact)))
        dx = beta * jnp.where(contact, pen, 0.0)[:, None] * n
        x = x + dx
        j_lin.append(jnp.sum(m[:, None] * dx / dt, axis=0))
    return x, jnp.stack(j_lin)


def _project_plane_only(top, cfg, x, movable):
    if cfg.collision.enable_plane:
        contact = (x[:, 1] < top.plane_height) & movable
        x = x.at[:, 1].set(jnp.where(contact, top.plane_height, x[:, 1]))
    return x


@_highp
def _sphere_friction_measured(cfg, x, x_start, dt, movable, m, rc, rv,
                              radii, r_inv_mass):
    """Tangential sphere friction at the DYNAMIC centers, relative to each
    ball's velocity, with the linear impulse measured for the reaction
    (oracle _one_sphere_friction twin; no torque — the PBD coupled
    contract stays spin-free).  Reduced-mass scaled (beta) like the
    projection so the reaction stays bounded for heavy cloth."""
    from .collide import SPHERE_CONTACT_SHELL

    mu = cfg.collision.friction
    j_t = jnp.zeros_like(rc)
    if not cfg.collision.enable_spheres or mu == 0.0:
        return x, j_t
    for s in range(rc.shape[0]):
        d = x - rc[s]
        dist = jnp.linalg.norm(d, axis=1)
        n = d / jnp.maximum(dist, 1e-12)[:, None]
        contact = (dist <= radii[s] * SPHERE_CONTACT_SHELL) & movable
        rel = (x - x_start) - rv[s][None, :] * dt
        rel_t = rel - jnp.einsum("ij,ij->i", rel, n)[:, None] * n
        beta = 1.0 / (1.0 + r_inv_mass[s] * jnp.sum(m * contact))
        dx_t = jnp.where(contact[:, None], -mu * beta * rel_t, 0.0)
        x = x + dx_t
        j_t = j_t.at[s].set((m[:, None] * dx_t).sum(axis=0) / dt)
    return x, j_t


@_highp
def _project_static_rest(top, cfg, x, movable, skip_boxes=False):
    """Position-only capsule/box/SDF projection (after the spheres)."""
    if collide._needs_capsule_box(top, cfg):
        xz = collide.project_capsules_boxes_components(
            top, cfg, [x[:, 0], x[:, 1], x[:, 2]], movable,
            skip_boxes=skip_boxes)
        x = jnp.stack(xz, axis=1)
    if collide._needs_sdf(top, cfg):
        xz = collide.project_sdfs_components(
            top, cfg, [x[:, 0], x[:, 1], x[:, 2]], movable)
        x = jnp.stack(xz, axis=1)
    return x


def substep_verlet_coupled(top: Topology, cfg: SimConfig, s: State,
                           r: RigidState, dt: float
                           ) -> Tuple[State, RigidState]:
    """Oracle substep_verlet_coupled twin: Verlet contacts are position
    projections, so sphere s's reaction is the projection impulse
    ``-sum_i m_i dx_i / dt``.  The radial push exerts no torque and
    carries no surface-velocity term: no spin-drag, no contact spin."""
    rc, rv, romega, radii, inv_i, rq = _rigid_predict(top, cfg, r, dt)
    boxed = r.has_boxes
    if boxed:
        bc, bv, bom, bq, bw = _boxes_predict(cfg, r, dt)
    x_new, movable = _step.verlet_integrate(top, cfg, s, dt, None, None)
    quats = _step._cluster_quats(cfg, s)
    if quats is not None:
        # shape matching after integration, before contact (oracle
        # substep_verlet_coupled slot; position-only)
        from .shapematch import shape_match_dx

        dxs, quats = shape_match_dx(top, cfg, x_new, quats)
        x_new = x_new + dxs
    if cfg.strain_limit.enabled:
        from .strainlimit import strain_limit_dx

        x_new = x_new + strain_limit_dx(top, cfg, x_new)
    if tether.motion_enabled(top, cfg):
        x_new = x_new + tether.tether_dx(top, cfg, x_new)
    m = jnp.where(movable, 1.0 / jnp.maximum(top.inv_mass, 1e-12), 0.0)
    contact = collide.plane_contact_preclamp(top, cfg, x_new, movable)
    x_new = _project_plane_only(top, cfg, x_new, movable)
    x_new, j_lin = _project_spheres_measured(x_new, movable, m, rc,
                                             radii, dt, r.inv_mass)
    rv = rv - j_lin * r.inv_mass[:, None]
    rc = rc - (j_lin * dt) * r.inv_mass[:, None]
    if boxed:
        x_new, j_b = _project_boxes_measured(top, x_new, movable, m, bc,
                                             bq, dt, bw)
        bv = bv - j_b * bw[:, None]
        bc = bc - (j_b * dt) * bw[:, None]
    x_new = _project_static_rest(top, cfg, x_new, movable,
                                 skip_boxes=boxed)
    x_new = collide.plane_friction_positions(top, cfg, x_new, s.x, dt,
                                             contact)
    x_new, j_t = _sphere_friction_measured(cfg, x_new, s.x, dt, movable, m,
                                           rc, rv, radii, r.inv_mass)
    rv = rv - j_t * r.inv_mass[:, None]
    if boxed:
        x_new, j_bt = _box_friction_measured(top, cfg, x_new, s.x, dt,
                                             movable, m, bc, bq, bv, bw)
        bv = bv - j_bt * bw[:, None]
    x_new = collide.rest_friction_positions(top, cfg, x_new, s.x, dt,
                                            movable, skip_boxes=boxed)
    rc, rv, romega = _rigid_environment(top, cfg, r, rc, rv, romega,
                                        radii, inv_i, skip_boxes=boxed)
    if boxed:
        rc, rv, romega, bc, bv, bom = _box_environment(
            top, cfg, rc, rv, romega, r.inv_mass, inv_i, radii,
            bc, bv, bom, bq, bw)
    if top.joint_meta is not None:
        rc, rv, romega, rq, *bx = _solve_joints(
            top, cfg, rc, rv, romega, rq, r.inv_mass, inv_i,
            *((bc, bv, bom, bq) if boxed else (None,) * 4),
            bw if boxed else None, dt)
        if boxed:
            bc, bv, bom, bq = bx
    if top.attach_ids is not None:
        x_new, _, rc, rv, romega, rq = _solve_attachments(
            top, cfg, x_new, None, rc, rv, romega, rq, r.inv_mass, inv_i,
            dt)
    if top.attach_box_ids is not None:
        x_new, _, bc, bv, bom, bq = _solve_box_attachments(
            top, cfg, x_new, None, bc, bv, bom, bq, bw, dt)
    v_new = (x_new - s.x) / dt
    return (
        State(x=x_new, v=v_new, x_prev=s.x, edge_alive=s.edge_alive,
              rest_scale=s.rest_scale,
              cluster_quat=quats if quats is not None else s.cluster_quat),
        RigidState(centers=rc, velocities=rv, inv_mass=r.inv_mass,
                   omega=romega, quat=rq,
                   **(dict(box_centers=bc, box_velocities=bv,
                           box_inv_mass=bw, box_omega=bom, box_quat=bq)
                      if boxed else {})),
    )


def substep_xpbd_coupled(top: Topology, cfg: SimConfig, s: State,
                         r: RigidState, dt: float
                         ) -> Tuple[State, RigidState]:
    """Oracle substep_xpbd_coupled twin: contacts project inside the
    Jacobi loop and each iteration's measured projection impulse reacts
    on the body IMMEDIATELY (the body participates in the iteration like
    a particle with inverse mass w_b — see the oracle docstring for why
    end-of-substep accumulation explodes under heavy cloth), so the body
    state rides the iteration scan's carry.  Delta-form accumulation as
    in solver/step.py substep_xpbd (equal in real arithmetic to the
    oracle's plain form)."""
    from . import xpbd

    movable = top.inv_mass > 0.0
    rc, rv, romega, radii, inv_i, rq = _rigid_predict(top, cfg, r, dt)
    boxed = r.has_boxes
    if boxed:
        bc, bv, bom, bq, bw = _boxes_predict(cfg, r, dt)
    else:
        bc = bv = jnp.zeros((0, 3), s.x.dtype)
    g = jnp.asarray(cfg.gravity, dtype=s.x.dtype)
    accel = g[None, :]
    if cfg.wind.enabled:
        accel = accel + _step.wind_forces(top, cfg, s.x, s.v) \
            * top.inv_mass[:, None]
    if cfg.self_collision.enabled:
        accel = accel + _step.self_collision_force(cfg, s.x) \
            * top.inv_mass[:, None]
    if cfg.pressure.enabled and top.n_pressure_bodies > 0:
        from .pressure import pressure_forces

        accel = accel + pressure_forces(top, cfg, s.x) \
            * top.inv_mass[:, None]
    v = (s.v + dt * accel) * (1.0 - cfg.global_damping * dt)
    v = jnp.where(movable[:, None], v, 0.0)
    x_prev = s.x
    m = jnp.where(movable, 1.0 / jnp.maximum(top.inv_mass, 1e-12), 0.0)
    lam0 = jnp.zeros((top.n_edges,), s.x.dtype)
    lam_vol0 = jnp.zeros((top.n_tets,), s.x.dtype)

    def body(carry, _):
        delta, lam, lam_vol, rc_c, rv_c, bc_c, bv_c, cfm = carry
        dx, lam, lam_vol = xpbd.xpbd_iteration_dx(
            top, cfg, x_prev + delta, lam, lam_vol, dt)
        delta = delta + dx
        # contact projection in delta form: plane exact, bodies measured
        # with the reaction applied to the CARRIED body state (in-loop,
        # oracle semantics)
        xe = x_prev + delta
        pc = collide.plane_contact_preclamp(top, cfg, xe, movable)
        xe2 = _project_plane_only(top, cfg, xe, movable)
        xe3, jl = _project_spheres_measured(xe2, movable, m, rc_c, radii,
                                            dt, r.inv_mass)
        rv_c = rv_c - jl * r.inv_mass[:, None]
        rc_c = rc_c - (jl * dt) * r.inv_mass[:, None]
        if boxed:
            xe3, jb = _project_boxes_measured(top, xe3, movable, m, bc_c,
                                              bq, dt, bw)
            bv_c = bv_c - jb * bw[:, None]
            bc_c = bc_c - (jb * dt) * bw[:, None]
        xe4 = _project_static_rest(top, cfg, xe3, movable,
                                   skip_boxes=boxed)
        delta = delta + (xe4 - xe)
        return (delta, lam, lam_vol, rc_c, rv_c, bc_c, bv_c,
                cfm | pc), None

    cf0 = jnp.zeros(s.x.shape[0], bool)
    (delta, _, _, rc, rv, bc, bv, contact), _ = jax.lax.scan(
        body, (dt * v, lam0, lam_vol0, rc, rv, bc, bv, cf0), None,
        length=cfg.xpbd.n_iterations)
    quats = _step._cluster_quats(cfg, s)
    if (quats is not None or cfg.strain_limit.enabled
            or tether.motion_enabled(top, cfg)):
        # shape matching + strain limiting + motion constraints after the
        # Jacobi loop, then ONE more contact pass with measured rigid
        # reactions (oracle substep_xpbd_coupled slot)
        if quats is not None:
            from .shapematch import shape_match_dx

            dxs, quats = shape_match_dx(top, cfg, x_prev + delta, quats)
            delta = delta + dxs
        if cfg.strain_limit.enabled:
            from .strainlimit import strain_limit_dx

            delta = delta + strain_limit_dx(top, cfg, x_prev + delta)
        if tether.motion_enabled(top, cfg):
            delta = delta + tether.tether_dx(top, cfg, x_prev + delta)
        xe = x_prev + delta
        pc = collide.plane_contact_preclamp(top, cfg, xe, movable)
        contact = contact | pc
        xe2 = _project_plane_only(top, cfg, xe, movable)
        xe3, jl = _project_spheres_measured(xe2, movable, m, rc, radii,
                                            dt, r.inv_mass)
        rv = rv - jl * r.inv_mass[:, None]
        rc = rc - (jl * dt) * r.inv_mass[:, None]
        if boxed:
            xe3, jb = _project_boxes_measured(top, xe3, movable, m, bc,
                                              bq, dt, bw)
            bv = bv - jb * bw[:, None]
            bc = bc - (jb * dt) * bw[:, None]
        xe4 = _project_static_rest(top, cfg, xe3, movable, skip_boxes=boxed)
        delta = delta + (xe4 - xe)
    # plane friction ONCE per substep at the OR'd pre-clamp contact mask
    delta = collide.plane_friction_delta(top, cfg, delta, dt, contact)
    # sphere friction at the dynamic centers (delta rebased, reaction on
    # the balls)
    xe_f = x_prev + delta
    xf, j_t = _sphere_friction_measured(cfg, xe_f, x_prev, dt, movable, m,
                                        rc, rv, radii, r.inv_mass)
    delta = delta + (xf - xe_f)
    rv = rv - j_t * r.inv_mass[:, None]
    if boxed:
        xe_b = x_prev + delta
        xb, j_bt = _box_friction_measured(top, cfg, xe_b, x_prev, dt,
                                          movable, m, bc, bq, bv, bw)
        delta = delta + (xb - xe_b)
        bv = bv - j_bt * bw[:, None]
    # static capsule/box/SDF friction (no reaction; delta rebased)
    xe_r = x_prev + delta
    delta = delta + (
        collide.rest_friction_positions(top, cfg, xe_r, x_prev, dt,
                                        movable, skip_boxes=boxed)
        - xe_r)
    rc, rv, romega = _rigid_environment(top, cfg, r, rc, rv, romega,
                                        radii, inv_i, skip_boxes=boxed)
    if boxed:
        rc, rv, romega, bc, bv, bom = _box_environment(
            top, cfg, rc, rv, romega, r.inv_mass, inv_i, radii,
            bc, bv, bom, bq, bw)
    if top.joint_meta is not None:
        rc, rv, romega, rq, *bx = _solve_joints(
            top, cfg, rc, rv, romega, rq, r.inv_mass, inv_i,
            *((bc, bv, bom, bq) if boxed else (None,) * 4),
            bw if boxed else None, dt)
        if boxed:
            bc, bv, bom, bq = bx
    if top.attach_ids is not None:
        # delta-rebased like the friction stages (keeps the delta-form
        # accumulation exact for the bulk vertices)
        xe_a = x_prev + delta
        xa, _, rc, rv, romega, rq = _solve_attachments(
            top, cfg, xe_a, None, rc, rv, romega, rq, r.inv_mass, inv_i,
            dt)
        delta = delta + (xa - xe_a)
    if top.attach_box_ids is not None:
        xe_b2 = x_prev + delta
        xb2, _, bc, bv, bom, bq = _solve_box_attachments(
            top, cfg, xe_b2, None, bc, bv, bom, bq, bw, dt)
        delta = delta + (xb2 - xe_b2)
    delta = jnp.where(movable[:, None], delta, 0.0)
    x = x_prev + delta
    return (
        State(x=x, v=delta / dt, x_prev=x_prev, edge_alive=s.edge_alive,
              rest_scale=s.rest_scale,
              cluster_quat=quats if quats is not None else s.cluster_quat),
        RigidState(centers=rc, velocities=rv, inv_mass=r.inv_mass,
                   omega=romega, quat=rq,
                   **(dict(box_centers=bc, box_velocities=bv,
                           box_inv_mass=bw, box_omega=bom, box_quat=bq)
                      if boxed else {})),
    )


_SUBSTEP_COUPLED = {
    Solver.SEMI_IMPLICIT_EULER: substep_euler_coupled,
    Solver.VERLET: substep_verlet_coupled,
    Solver.XPBD: substep_xpbd_coupled,
}


def step_coupled_scan(top: Topology, cfg: SimConfig, s: State, r: RigidState,
                      dt: float, n_substeps: int
                      ) -> Tuple[State, RigidState]:
    """``lax.scan`` over coupled substeps (the body of api.step_coupled)."""
    if r.centers.shape[0] > 0 and not cfg.collision.enable_spheres:
        # the coupled substep resolves the RigidState spheres
        # unconditionally — accepting a config that sb.step would treat as
        # sphere-free silently changes semantics between the two entries
        raise ValueError(
            "step_coupled needs CollisionParams(enable_spheres=True): the "
            "rigid bodies ARE the scene's spheres"
        )
    if r.has_boxes and not cfg.collision.enable_boxes:
        raise ValueError(
            "RigidState carries dynamic boxes: step_coupled needs "
            "CollisionParams(enable_boxes=True)"
        )
    if r.has_boxes and r.box_centers.shape[0] != top.n_boxes:
        raise ValueError(
            f"RigidState has {r.box_centers.shape[0]} dynamic boxes but "
            f"the scene has {top.n_boxes} — box promotion is all-or-none "
            f"(make_rigid_state(box_masses=...))"
        )
    if top.attach_box_ids is not None and not r.has_boxes:
        raise ValueError(
            "topology has box attachments: promote the boxes with "
            "make_rigid_state(box_masses=...)"
        )
    if top.joint_meta is not None and not r.has_boxes and any(
            "box" in (ka, kb) for _, ka, _, kb, _ in top.joint_meta):
        raise ValueError(
            "topology has box-side rigid joints: promote the boxes with "
            "make_rigid_state(box_masses=...)"
        )
    if cfg.solver != Solver.SEMI_IMPLICIT_EULER and (
            cfg.tear.enabled or cfg.plasticity.enabled):
        raise NotImplementedError(
            "coupled Verlet/XPBD do not thread tearing/plasticity state"
        )
    if r.omega is None:
        # a hand-built RigidState may leave the default; the substep
        # returns omega as an array, and a None->array change would break
        # the scan carry's pytree structure
        r = r.replace(omega=jnp.zeros_like(r.velocities))
    if (top.attach_ids is not None
            or top.joint_meta is not None) and r.quat is None:
        # attachment points ride the ball's rotation: orientation state
        # is required (make_rigid_state fills the identity default)
        r = r.replace(quat=jnp.tile(
            jnp.asarray([1.0, 0.0, 0.0, 0.0], r.centers.dtype),
            (r.centers.shape[0], 1)))
    fn = _SUBSTEP_COUPLED[cfg.solver]

    def body(carry, _):
        cs, cr = carry
        return fn(top, cfg, cs, cr, dt), None

    (s, r), _ = jax.lax.scan(body, (s, r), None, length=n_substeps)
    return s, r
