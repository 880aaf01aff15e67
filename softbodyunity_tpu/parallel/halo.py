"""Spatial domain decomposition of one large cloth across devices
(SURVEY.md C16) — the sequence/context-parallel analogue.

One huge ``ny x nx`` cloth grid is sharded by *rows* over a 1-D device mesh
with ``shard_map``.  Each substep, every device exchanges a 2-row halo
(the bend-spring reach) with its mesh neighbours via ``lax.ppermute`` —
the same neighbour pattern as ring attention (SURVEY.md §5 "Long-context
/ sequence parallelism") — then runs the stencil substep on its extended
local block and keeps the interior.

Correctness argument (tests assert equality with the single-device stencil
path): all spring offsets point "down/right" ((0,1),(1,0),(1,1),(1,-1),
(0,2),(2,0)), so an edge is *owned* by its upper vertex.  With a 2-row halo
above and below, (i) interior vertices see correct neighbour positions for
owned edges, and (ii) reaction forces from edges owned by the 2 halo rows
above are recovered by the ``-offset`` shift.  Validity at global boundaries
is decided by global row index (``axis_index``-derived iota masks), so halo
zero-padding never fabricates springs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import SimConfig
from ..core.state import State
from ..core.topology import EDGE_BEND, EDGE_SHEAR, Topology
from ..kernels import stencil as st

ROWS_AXIS = "rows"
HALO = 2  # bend springs reach 2 rows


def _exchange_halo(a: jax.Array, axis_name: str) -> jax.Array:
    """[3, h, nx] local block -> [3, h + 2*HALO, nx] with neighbour rows.

    Non-periodic: the first/last device's outer halo stays zero (masked out
    by the global-row validity masks).
    """
    n_dev = jax.lax.axis_size(axis_name)
    # my bottom rows -> next device's top halo
    down_perm = [(i, i + 1) for i in range(n_dev - 1)]
    up_perm = [(i + 1, i) for i in range(n_dev - 1)]
    from_above = jax.lax.ppermute(a[:, -HALO:, :], axis_name, down_perm)
    from_below = jax.lax.ppermute(a[:, :HALO, :], axis_name, up_perm)
    return jnp.concatenate([from_above, a, from_below], axis=1)


def _owned_mask_ext(ny_local: int, nx: int, ny_global: int, di: int, dj: int,
                    dev_idx) -> jax.Array:
    """Validity of owned edge (di, dj) for each vertex of the *extended*
    block (rows include the 2-row halos), judged by global coordinates."""
    ext = ny_local + 2 * HALO
    local_rows = jax.lax.broadcasted_iota(jnp.int32, (ext, nx), 0) - HALO
    g_rows = dev_idx * ny_local + local_rows
    cols = jax.lax.broadcasted_iota(jnp.int32, (ext, nx), 1)
    row_ok = (g_rows >= 0) & (g_rows + di >= 0) & (g_rows + di <= ny_global - 1) & (
        g_rows <= ny_global - 1
    )
    col_ok = (cols + dj >= 0) & (cols + dj <= nx - 1)
    return (row_ok & col_ok).astype(jnp.float32)


def _self_collision_rows(x3, cfg, axis_name):
    """Self-collision repulsion on a row-sharded block, EXACT against the
    global pair set: all-gather the cloth's positions (one [3, ny, nx]
    tiled all_gather, ~786 KB at 64k, far cheaper than any
    partner-exchange scheme because folds make self-collision pairs
    unbounded in ROW distance, so no fixed halo can carry them), then run
    the dual block-sparse form — local rows as i-tiles, the gathered
    cloth as partner tiles (kernels/block_pairs.py).  Pair work
    shards by rows; only the Morton sort of the gathered cloth is
    replicated.  Returns forces [3, ny_local, nx]."""
    p = cfg.self_collision
    xg = jax.lax.all_gather(x3, axis_name, axis=1, tiled=True)
    xi = x3.reshape(3, -1).T                        # [n_local, 3]
    xall = xg.reshape(3, -1).T                      # [N, 3]
    from ..kernels.block_pairs import self_collision_forces_block_dual

    f = self_collision_forces_block_dual(xi, xall, p)
    return f.T.reshape(x3.shape)


def _halo_substep(x3, v3, inv_mass_ext_builder, offsets, cfg, dt,
                  plane_height, ny_global, axis_name, spheres=None,
                  alive=None, scale=None, capsules=None, boxes=None,
                  sdfs=None, plane_velocity=None, anchors=None, we=None):
    """One Euler substep on a row-sharded block (inside shard_map).
    ``alive`` (tear liveness planes [n_off, ny_local, nx], sharded like the
    state) subsumes the static ownership masks; ``scale`` (plastic
    rest-scale planes) rescales the rest lengths.  Returns
    ``(x3, v3, alive, scale)`` with Nones preserved."""
    ny_local, nx = x3.shape[-2], x3.shape[-1]
    dev = jax.lax.axis_index(axis_name)

    xe = _exchange_halo(x3, axis_name)
    ve = _exchange_halo(v3, axis_name)
    ae = _exchange_halo(alive, axis_name) if alive is not None else None
    se = _exchange_halo(scale, axis_name) if scale is not None else None

    f = jnp.zeros_like(xe)
    for o, (di, dj, k, rest) in enumerate(offsets):
        xn = st._shift(xe, di, dj)
        vn = st._shift(ve, di, dj)
        d = xn - xe
        length = jnp.sqrt(jnp.sum(d * d, axis=0))
        inv_len = 1.0 / jnp.maximum(length, 1e-12)
        n = d * inv_len
        rel_v = jnp.sum((vn - ve) * n, axis=0)
        mask = (ae[o] if ae is not None
                else _owned_mask_ext(ny_local, nx, ny_global, di, dj, dev))
        rest_eff = rest if se is None else rest * se[o]
        fmag = (k * (length - rest_eff) + cfg.springs.damping * rel_v) * mask
        fo = fmag * n
        f = f + fo - st._shift(fo, -di, -dj)
    if cfg.wind.enabled:
        f = f + _wind_force_ext(xe, ve, cfg, ny_local, nx, ny_global, dev)
    f = f[:, HALO : HALO + ny_local, :]
    if cfg.self_collision.enabled:
        f = f + _self_collision_rows(x3, cfg, axis_name)

    inv_mass2 = inv_mass_ext_builder
    movable = inv_mass2 > 0.0
    g = jnp.asarray(cfg.gravity).astype(x3.dtype).reshape(3, 1, 1)
    v3 = (v3 + dt * (g + f * inv_mass2)) * (1.0 - cfg.global_damping * dt)
    v3 = jnp.where(movable, v3, 0.0)
    x3 = x3 + dt * v3
    if cfg.strain_limit.enabled:
        # strain limiting before contact, velocity feedback on the Euler
        # solver (oracle substep_euler ordering)
        dxl = _strain_limit_halo(x3, offsets, cfg, inv_mass2, ny_global,
                                 axis_name, ae=ae, se=se, we=we)
        x3 = x3 + dxl
        v3 = v3 + dxl / dt
    if anchors is not None:
        # motion constraints after strain limiting, before contact
        dxt = _tether_dx_planes(x3, anchors[0], anchors[1], cfg, movable)
        x3 = x3 + dxt
        v3 = v3 + dxt / dt
    x3, v3 = _resolve_colliders(x3, v3, movable, cfg, plane_height, spheres,
                                capsules, boxes, sdfs,
                                plane_velocity=plane_velocity)
    if alive is not None or scale is not None:
        alive, scale = _feature_halo_update(x3, alive, scale, offsets, cfg,
                                            axis_name)
    return x3, v3, alive, scale


def _resolve_colliders(x3, v3, movable, cfg, plane_height, spheres,
                       capsules=None, boxes=None, sdfs=None,
                       plane_velocity=None):
    """Velocity-level collider resolve on plane-layout blocks (the
    collider geometry is global, so sharding needs no special handling).
    ``capsules`` [C,10] / ``boxes`` [B,18] are packed rows
    (solver/collide.py pack_capsules / pack_boxes; kinematic velocity in
    the tail); ``spheres`` is
    ``(centers, radii)`` or ``(centers, radii, velocities)``; ``sdfs`` is
    ``(grids, origins, spacings[, velocities])`` from
    :func:`pack_sdf_geometry`; ``plane_velocity`` [3] is the conveyor
    surface velocity.  The shared component primitives run unchanged here
    (single-device resolve order: plane, spheres, capsules, boxes, sdfs)."""
    if cfg.collision.enable_plane:
        wp = ([0.0, 0.0, 0.0] if plane_velocity is None
              else [plane_velocity[c] for c in range(3)])
        contact = (x3[1] < plane_height) & movable[0]
        x3 = x3.at[1].set(jnp.where(contact, plane_height, x3[1]))
        vy = v3[1]
        uy = vy - wp[1]
        vy = jnp.where(
            contact,
            jnp.where(uy < 0.0, wp[1] - cfg.collision.restitution * uy, vy),
            vy)
        fr = 1.0 - cfg.collision.friction
        v3 = jnp.stack(
            [jnp.where(contact, wp[0] + (v3[0] - wp[0]) * fr, v3[0]), vy,
             jnp.where(contact, wp[2] + (v3[2] - wp[2]) * fr, v3[2])]
        )
    if cfg.collision.enable_spheres and spheres is not None:
        centers, radii = spheres[0], spheres[1]
        svel = spheres[2] if len(spheres) > 2 else None
        for si in range(radii.shape[0]):
            c = centers[si].reshape(3, 1, 1)
            w = 0.0 if svel is None else svel[si].reshape(3, 1, 1)
            d = x3 - c
            dist = jnp.sqrt(jnp.sum(d * d, axis=0))
            pen = radii[si] - dist
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
    n_caps = capsules.shape[0] if capsules is not None else 0
    n_boxes = boxes.shape[0] if boxes is not None else 0
    if n_caps or n_boxes:
        from ..solver.collide import resolve_capsules_boxes_packed

        xz, vz = resolve_capsules_boxes_packed(
            [x3[0], x3[1], x3[2]], [v3[0], v3[1], v3[2]], movable[0],
            capsules, n_caps, boxes, n_boxes,
            cfg.collision.restitution, cfg.collision.friction,
        )
        x3 = jnp.stack(xz)
        v3 = jnp.stack(vz)
    if sdfs is not None:
        x3, v3 = _resolve_sdfs_planes(x3, v3, movable, cfg, sdfs)
    return x3, v3


def pack_sdf_geometry(top: Topology):
    """(grids [S,gx,gy,gz], origins [S,3], spacings [S]) for the halo
    makers: SDF sampling is per-vertex (no neighbour reads), so the baked
    grids ride as replicated shard_map inputs, never closure constants."""
    return top.sdf_grids, top.sdf_origins, top.sdf_spacings


def _resolve_sdfs_planes(x3, v3, movable, cfg, sdfs):
    """Velocity-level SDF resolve on plane-layout blocks (shared component
    primitives from solver/collide.py)."""
    from ..solver.collide import sdf_resolve_components

    grids, origins, spacings = sdfs[0], sdfs[1], sdfs[2]
    svel = sdfs[3] if len(sdfs) > 3 else None
    xz = [x3[0], x3[1], x3[2]]
    vz = [v3[0], v3[1], v3[2]]
    for s in range(grids.shape[0]):
        xz, vz = sdf_resolve_components(
            xz, vz, movable[0], grids[s],
            [origins[s, 0], origins[s, 1], origins[s, 2]], spacings[s],
            cfg.collision.restitution, cfg.collision.friction,
            w=(None if svel is None else [svel[s, c] for c in range(3)]),
        )
    return jnp.stack(xz), jnp.stack(vz)


def _project_sdfs_planes(x3, movable, sdfs):
    """Position-only SDF push-out on plane-layout blocks (Verlet/XPBD)."""
    from ..solver.collide import sdf_project_components

    if sdfs is None:
        return x3
    grids, origins, spacings = sdfs[0], sdfs[1], sdfs[2]
    xz = [x3[0], x3[1], x3[2]]
    for s in range(grids.shape[0]):
        xz = sdf_project_components(
            xz, movable[0], grids[s],
            [origins[s, 0], origins[s, 1], origins[s, 2]], spacings[s],
        )
    return jnp.stack(xz)


def pack_capsule_box_geometry(top: Topology):
    """(capsules [C,10], boxes [B,18]) packed rows for the halo makers —
    kinematic collider velocities ride in the row tails
    (solver/collide.py pack_capsules / pack_boxes); pass them as
    replicated inputs, never closure constants."""
    from ..solver.collide import pack_boxes, pack_capsules

    return pack_capsules(top), pack_boxes(top)


def _project_capsules_boxes(x3, movable, capsules, boxes):
    """Position-only capsule/box push-out on plane-layout blocks
    (Verlet/XPBD paths; shared component primitives)."""
    n_caps = capsules.shape[0] if capsules is not None else 0
    n_boxes = boxes.shape[0] if boxes is not None else 0
    if not (n_caps or n_boxes):
        return x3
    from ..solver.collide import project_capsules_boxes_packed

    xz = project_capsules_boxes_packed(
        [x3[0], x3[1], x3[2]], movable[0], capsules, n_caps, boxes, n_boxes
    )
    return jnp.stack(xz)


def _check_halo_colliders(top: Topology, cfg: SimConfig,
                          wind: str = "full", tear: str = "planes",
                          caps: str = "components",
                          sdf: str = "components",
                          strain: str = "none",
                          motion: str = "none",
                          sc: str = "none",
                          sm: str = "none") -> None:
    """What each halo-sharded path supports, enforced loudly.  ``wind``:
    cloth paths take drag + lift ("full"), lattice paths drag only ("drag"
    — lift needs surface triangles, which the banded single-device path
    computes exactly).  ``tear``: cloth paths shard the tear-liveness AND
    plastic rest-scale planes ("planes"); lattice paths reject both
    ("none" — the knob covers the two dynamic-plane features).  ``caps``:
    cloth paths run capsule/box colliders through the shared component
    primitives with geometry as replicated inputs ("components"); lattice
    paths reject ("none").  ``sdf``: same split for mesh (SDF) colliders —
    cloth paths sample the replicated baked grids per vertex, lattice
    paths reject."""
    from ..solver.collide import _needs_capsule_box, _needs_sdf

    if sdf == "none" and _needs_sdf(top, cfg):
        # cloth paths take the baked grids as replicated inputs
        # ("components"); lattice paths reject loudly rather than silently
        # dropping the mesh collider (same contract as the other gates)
        raise NotImplementedError(
            "sdf (mesh) colliders are not supported in the halo-sharded "
            "lattice paths; use the single-device step or batch sharding"
        )
    if caps == "none" and _needs_capsule_box(top, cfg):
        raise NotImplementedError(
            "capsule/box colliders are not supported in the halo-sharded "
            "lattice paths; use plane/sphere colliders or the "
            "single-device step"
        )
    if wind == "drag" and cfg.wind.lift != 0.0:
        raise NotImplementedError(
            "wind lift is not supported in the halo-sharded lattice paths "
            "(drag is); use the single-device banded step for lift"
        )
    if tear == "none" and cfg.tear.enabled:
        raise NotImplementedError(
            "tearing is not supported in the halo-sharded lattice paths; "
            "use the single-device step"
        )
    if tear == "none" and cfg.plasticity.enabled:
        raise NotImplementedError(
            "plasticity is not supported in the halo-sharded lattice "
            "paths; use the single-device step"
        )
    # ``strain``/``motion`` document HOW each path implements the feature
    # (every halo path now supports both): cloth paths run the strain
    # Jacobi sweeps with one halo exchange per sweep ("sweeps") and take
    # row-sharded tether anchor/radius planes ("planes"); lattice paths
    # run slab sweeps (also "sweeps") and take slab-sharded tether planes
    # ("slabs", shard_motion_slabs).
    del strain, motion
    if sm == "slabs" and cfg.shape_match.enabled and top.n_clusters > 0:
        # lattice slab paths (all three solvers): per-slab partial
        # cluster reductions + one [K]-sized psum per substep
        # (_shape_match_slab_dx); the caller must pass
        # shard_shapematch_slabs(top, mesh) planes
        pass
    elif cfg.shape_match.enabled and top.n_clusters > 0:
        raise NotImplementedError(
            "shape matching is supported on the lattice slab paths only "
            "(pass shard_shapematch_slabs planes); use batch sharding or "
            "the single-device step for this path"
        )
    if sc == "none" and cfg.self_collision.enabled:
        # cloth-rows paths run the all-gather + dual-tile block form
        # ("dual", _self_collision_rows); lattice slab paths reject —
        # silent physics drop is never an option (round-4 verdict: the
        # cloth paths used to IGNORE self_collision here)
        raise NotImplementedError(
            "self-collision is not supported in the halo-sharded lattice "
            "paths; use the cloth-rows halo, batch sharding, or the "
            "single-device step"
        )
    if sc == "dual" and cfg.self_collision.enabled and (
            cfg.self_collision.method != "block"):
        raise NotImplementedError(
            "halo-sharded self-collision runs the block method only "
            f"(got method={cfg.self_collision.method!r})"
        )



def _feature_halo_update(x3_new, alive, scale, offsets, cfg, axis_name):
    """End-of-substep tear/plastic updates on row-sharded planes: exchange
    the post-substep positions once so owner rows near the shard edge see
    their cross-shard neighbours, then apply the shared checks to the
    LOCAL planes (no plane exchange — only interior rows are kept).
    Plastic flow runs first, then the tear check against the RESCALED
    rest (oracle ordering).  One extra position exchange per substep,
    kept deliberately so the oracle's end-of-substep semantics stay
    literal rather than relying on an update-at-next-substep-start
    equivalence argument."""
    ny_local = x3_new.shape[-2]
    xne = _exchange_halo(x3_new, axis_name)

    def pad(planes):
        # extend local planes with inert halo rows (NO comms — the padded
        # rows feed only the helper's halo outputs, which are sliced away)
        z = jnp.ones((planes.shape[0], HALO, planes.shape[-1]),
                     planes.dtype)
        return jnp.concatenate([z, planes, z], axis=1)

    def local(planes):
        return planes[:, HALO : HALO + ny_local, :]

    if scale is not None:
        scale = local(st.plastic_update_grid(
            xne, offsets, pad(scale), cfg.plasticity
        ))
    if alive is not None:
        se = pad(scale) if scale is not None else None
        ok = st.tear_ok_planes(xne, offsets, cfg.tear.strain_limit,
                               rest_scale=se)
        alive = jnp.stack([
            alive[o] * ok[o][HALO : HALO + ny_local, :]
            for o in range(len(offsets))
        ])
    return alive, scale


def _strain_limit_halo(x3, offsets, cfg, inv_mass2, ny_global, axis_name,
                       ae=None, se=None, we=None):
    """Strain-limit Jacobi sweeps on a row-sharded block (oracle
    ``strain_limit_dx`` twin in plane form, with the halo exchange as
    the shift boundary).  Each sweep re-exchanges the positions: the
    updated owned rows become the next sweep's halo, so any number of
    sweeps stays exact with the fixed 2-row halo (one ppermute pair per
    sweep).  ``ae``/``se`` are the already-exchanged tear-liveness /
    plastic rest-scale planes — torn edges stop limiting, plasticity
    rescales the band (the single-device rules).  ``we`` is the exchanged
    inverse-mass halo when the caller already holds it (the XPBD substep
    does) — the halo is loop-invariant, so reusing it saves one redundant
    ppermute pair per substep.  Returns the total dx on the
    owned rows."""
    sl = cfg.strain_limit
    ny_local, nx = x3.shape[-2], x3.shape[-1]
    dev = jax.lax.axis_index(axis_name)
    if we is None:
        we = _exchange_halo(inv_mass2, axis_name)[0]
    masks = [
        (ae[o] if ae is not None
         else _owned_mask_ext(ny_local, nx, ny_global, di, dj, dev))
        for o, (di, dj, _k, _r) in enumerate(offsets)
    ]
    # Jacobi mean over the alive incident edges (owned + owning — the
    # oracle's count), judged on the extended block then sliced
    cnt = jnp.zeros_like(we)
    for (di, dj, _k, _r), m in zip(offsets, masks):
        cnt = cnt + m + st._shift(m[None], -di, -dj)[0]
    inv_cnt = (1.0 / jnp.maximum(cnt, 1.0))[HALO : HALO + ny_local, :]
    x0 = x3
    for _ in range(sl.iterations):
        xe = _exchange_halo(x3, axis_name)
        dx = jnp.zeros_like(xe)
        for o, ((di, dj, _k, rest), m) in enumerate(zip(offsets, masks)):
            xn = st._shift(xe, di, dj)
            d = xn - xe
            length = jnp.sqrt(jnp.sum(d * d, axis=0))
            n = d / jnp.maximum(length, 1e-12)
            rest_eff = rest if se is None else rest * se[o]
            hi = rest_eff * (1.0 + sl.max_stretch)
            lo = (rest_eff * (1.0 - sl.max_compress)
                  if sl.max_compress >= 0.0 else 0.0)
            c_val = (length - jnp.clip(length, lo, hi)) * m
            wn = st._shift(we[None], di, dj)[0]
            corr = c_val / jnp.maximum(we + wn, 1e-12)
            dx = dx + (we * corr)[None] * n \
                - st._shift((wn * corr)[None] * n, -di, -dj)
        x3 = x3 + dx[:, HALO : HALO + ny_local, :] * inv_cnt[None]
    return x3 - x0


def _tether_dx_planes(x3, anchor3, radius1, cfg, movable):
    """Motion-constraint clamp on plane-layout blocks (oracle ``tether_dx``
    twin): pointwise, so sharding needs no exchange.  ``inf`` radii leave
    vertices unconstrained (``dist - inf = -inf`` clamps the excess to
    zero)."""
    d = x3 - anchor3
    dist = jnp.sqrt(jnp.sum(d * d, axis=0))
    r = radius1[0] * cfg.motion.scale
    excess = jnp.maximum(dist - r, 0.0)
    n = d / jnp.maximum(dist, 1e-12)
    return jnp.where(movable, -excess[None] * n, 0.0)


def shard_motion_planes(top: Topology, mesh: Mesh):
    """Tether anchors/radii (Topology arrays) -> row-sharded planes
    ``(anchor3 f32[3, ny, nx], radius1 f32[1, ny, nx])`` for the halo
    steppers' ``tether_anchors``/``tether_radii`` inputs."""
    if top.tether_anchor is None:
        raise ValueError(
            "topology has no motion constraints: call "
            "set_motion_constraints(top, anchors, radii) before "
            "shard_motion_planes"
        )
    ny, nx = top.grid_shape
    spec = NamedSharding(mesh, P(None, ROWS_AXIS, None))
    a3 = jax.device_put(
        jnp.asarray(top.tether_anchor).T.reshape(3, ny, nx), spec)
    r1 = jax.device_put(
        jnp.asarray(top.tether_radius).reshape(1, ny, nx), spec)
    return a3, r1


def _drag_force(cfg: SimConfig, v3: jax.Array) -> jax.Array:
    """Isotropic wind drag on plane-layout blocks (pointwise; the lattice
    halo paths gate lift off — see _check_halo_colliders)."""
    wv = jnp.asarray(cfg.wind.velocity).astype(v3.dtype).reshape(3, 1, 1)
    return cfg.wind.drag * (wv - v3)


def _wind_force_ext(xe, ve, cfg, ny_local, nx, ny_global, dev):
    """WindParams force on an exchanged (extended) cloth block; interior
    rows are exact (lift's 1-ring normal read stays inside the 2-row halo;
    see kernels/stencil.py grid_vertex_normals)."""
    cell = _owned_mask_ext(ny_local, nx, ny_global, 1, 1, dev)
    return st.wind_forces_grid(xe, ve, cfg, cell_mask=cell)


def make_halo_step(top: Topology, cfg: SimConfig, mesh: Mesh):
    """Build a jittable row-sharded stepping function (semi-implicit Euler).

    Returns ``fn(x3, v3, inv_mass3, plane_height, dt, n_substeps)`` operating
    on plane-layout arrays ``f32[3, ny, nx]`` sharded ``P(None, ROWS_AXIS,
    None)``; use :func:`shard_grid_state` to produce them from a ``State``.
    Sphere colliders are supported (geometry replicated — it is global).
    """
    _check_halo_colliders(top, cfg, strain="sweeps", motion="planes",
                          sc="dual")
    ny, nx = top.grid_shape
    spheres_on = cfg.collision.enable_spheres and top.n_spheres > 0
    from ..solver.collide import _needs_capsule_box, _needs_sdf
    caps_on = _needs_capsule_box(top, cfg)
    sdf_on = _needs_sdf(top, cfg)
    tearing = cfg.tear.enabled
    plastic = cfg.plasticity.enabled
    motion_on = cfg.motion.enabled and top.tether_anchor is not None
    n_dev = mesh.shape[ROWS_AXIS]
    assert ny % n_dev == 0, f"ny={ny} must divide over {n_dev} devices"
    has_shear = EDGE_SHEAR in top.edge_classes_present
    has_bend = EDGE_BEND in top.edge_classes_present
    offsets = st._offsets(cfg, top.grid_spacing, has_shear, has_bend)

    spec = P(None, ROWS_AXIS, None)

    plane_on = cfg.collision.enable_plane

    def sharded_steps(x3, v3, inv_mass3, plane_height, dt, n_substeps,
                      sphere_centers=None, sphere_radii=None, alive3=None,
                      capsules=None, boxes=None, scale3=None,
                      sdf_grids=None, sdf_origins=None, sdf_spacings=None,
                      plane_velocity=None, sphere_velocities=None,
                      sdf_velocities=None, tether_anchors=None,
                      tether_radii=None):
        # collider geometry and liveness/rest-scale planes arrive as
        # shard_map INPUTS (replicated / sharded respectively), never jit
        # closure constants (trace-time value fetches stall on this
        # image); positional order inside `local`: spheres, capsules+boxes,
        # alive, scale
        if tearing and alive3 is None:
            raise ValueError(
                "cfg enables tearing: pass alive3 (tear_plane_shard_maps)"
            )
        if plastic and scale3 is None:
            raise ValueError(
                "cfg enables plasticity: pass scale3 (tear_plane_shard_maps)"
            )
        if caps_on and capsules is None:
            raise ValueError(
                "cfg enables capsules/boxes: pass capsules/boxes "
                "(pack_capsule_box_geometry(top))"
            )
        if sdf_on and sdf_grids is None:
            raise ValueError(
                "cfg enables sdf colliders: pass sdf_grids/sdf_origins/"
                "sdf_spacings (pack_sdf_geometry(top))"
            )
        if motion_on and tether_anchors is None:
            raise ValueError(
                "cfg enables motion constraints: pass tether_anchors/"
                "tether_radii (shard_motion_planes(top, mesh))"
            )

        def local(x3b, v3b, imb, ph, *rest):
            i = 0
            spheres = None
            if spheres_on:
                spheres = (rest[0], rest[1])
                i = 2
            cb = (None, None)
            if caps_on:
                cb = (rest[i], rest[i + 1])
                i += 2
            ab = None
            if tearing:
                ab = rest[i]
                i += 1
            sb = None
            if plastic:
                sb = rest[i]
                i += 1
            sd = (rest[i], rest[i + 1], rest[i + 2]) if sdf_on else None
            if sdf_on:
                i += 3
            # kinematic collider velocities (replicated tail inputs)
            pv = None
            if plane_on:
                pv = rest[i]
                i += 1
            if spheres_on:
                spheres = spheres + (rest[i],)
                i += 1
            if sdf_on:
                sd = sd + (rest[i],)
                i += 1
            anchors = None
            if motion_on:
                anchors = (rest[i], rest[i + 1])
                i += 2

            # the inverse-mass halo is loop-invariant: exchange it ONCE
            # before the scan (XLA does not hoist collectives out of scan
            # bodies) and thread it to the per-substep strain limiter
            we = (_exchange_halo(imb, ROWS_AXIS)[0]
                  if cfg.strain_limit.enabled else None)

            def body(carry, _):
                out = _halo_substep(
                    carry[0], carry[1], imb, offsets, cfg, dt, ph[0], ny,
                    ROWS_AXIS, spheres=spheres, alive=carry[2],
                    scale=carry[3], capsules=cb[0], boxes=cb[1], sdfs=sd,
                    plane_velocity=pv, anchors=anchors, we=we,
                )
                return out, None

            (xf, vf, af, sf), _ = jax.lax.scan(
                body, (x3b, v3b, ab, sb), None, length=n_substeps
            )
            return ((xf, vf) + ((af,) if tearing else ())
                    + ((sf,) if plastic else ()))

        args = [x3, v3, inv_mass3, plane_height]
        specs = [spec, spec, spec, P()]
        outs = (spec, spec)
        if spheres_on:
            if sphere_centers is None:
                raise ValueError(
                    "cfg enables spheres: pass sphere_centers/sphere_radii "
                    "(e.g. top.sphere_centers, top.sphere_radii)"
                )
            args += [sphere_centers, sphere_radii]
            specs += [P(), P()]
        if caps_on:
            args += [capsules, boxes]
            specs += [P(), P()]
        if tearing:
            args.append(alive3)
            specs.append(spec)
            outs = outs + (spec,)
        if plastic:
            args.append(scale3)
            specs.append(spec)
            outs = outs + (spec,)
        if sdf_on:
            args += [sdf_grids, sdf_origins, sdf_spacings]
            specs += [P(), P(), P()]
        if plane_on:
            args.append(jnp.zeros(3, jnp.float32) if plane_velocity is None
                        else plane_velocity)
            specs.append(P())
        if spheres_on:
            args.append(jnp.zeros_like(sphere_centers)
                        if sphere_velocities is None else sphere_velocities)
            specs.append(P())
        if sdf_on:
            args.append(jnp.zeros((sdf_spacings.shape[0], 3), jnp.float32)
                        if sdf_velocities is None else sdf_velocities)
            specs.append(P())
        if motion_on:
            args += [tether_anchors, tether_radii]
            specs += [spec, spec]
        return jax.shard_map(
            local, mesh=mesh, in_specs=tuple(specs), out_specs=outs
        )(*args)

    return sharded_steps


def shard_grid_state(top: Topology, state: State, mesh: Mesh):
    """State[N,3] -> row-sharded plane arrays (x3, v3, inv_mass3, plane_h)."""
    ny, nx = top.grid_shape
    spec = NamedSharding(mesh, P(None, ROWS_AXIS, None))
    x3 = jax.device_put(jnp.asarray(state.x).T.reshape(3, ny, nx), spec)
    v3 = jax.device_put(jnp.asarray(state.v).T.reshape(3, ny, nx), spec)
    im3 = jax.device_put(jnp.asarray(top.inv_mass).reshape(1, ny, nx), spec)
    ph = jax.device_put(jnp.asarray(top.plane_height).reshape(1))
    return x3, v3, im3, ph


def unshard_to_state(x3, v3, dt) -> State:
    x = x3.reshape(3, -1).T
    v = v3.reshape(3, -1).T
    return State(x=x, v=v, x_prev=x - dt * v)


def tear_plane_shard_maps(top: Topology, cfg: SimConfig, mesh: Mesh):
    """(shard, unshard) for per-edge dynamic state on the halo paths:
    ``shard(edge_values)`` -> row-sharded per-offset planes [n_off, ny,
    nx]; ``unshard`` maps stepped planes back to flat f32[E].  The same
    bijection serves tear liveness masks (``edge_alive``) and plastic
    rest scales (``rest_scale``) — it is pure index arithmetic."""
    from ..kernels.stencil import _offsets, tear_plane_maps

    ny, nx = top.grid_shape
    has_shear = EDGE_SHEAR in top.edge_classes_present
    has_bend = EDGE_BEND in top.edge_classes_present
    offsets = _offsets(cfg, top.grid_spacing, has_shear, has_bend)
    a2p, p2a = tear_plane_maps(top, offsets, ny, nx)
    spec = NamedSharding(mesh, P(None, ROWS_AXIS, None))

    def shard(edge_alive):
        return jax.device_put(a2p(edge_alive), spec)

    return shard, p2a


# ---------------------------------------------------------------------------
# XPBD halo decomposition
# ---------------------------------------------------------------------------

def _halo_xpbd_substep(x3, v3, inv_mass2, xoffsets, cfg, dt,
                       plane_height, ny_global, axis_name, cnt_inv,
                       spheres=None, alive=None, scale=None, capsules=None,
                       boxes=None, sdfs=None, anchors=None):
    """One XPBD substep on a row-sharded block (inside shard_map).

    Jacobi iterations exchange BOTH positions and the per-offset lambda
    planes each sweep: a constraint owned by a halo row is recomputed
    identically on both neighbouring devices (same x, same lambda inputs),
    so each device reconstructs the reaction corrections that land in its
    interior without any scatter communication — the same recompute-the-
    owner trick as the Euler halo forces, extended with lambda state.
    """
    ny_local, nx = x3.shape[-2], x3.shape[-1]
    dev = jax.lax.axis_index(axis_name)
    movable = inv_mass2 > 0.0
    w = inv_mass2[0]

    g = jnp.asarray(cfg.gravity, dtype=x3.dtype).reshape(3, 1, 1)
    accel = g
    if cfg.wind.enabled:
        # external forces enter XPBD through the velocity predict (oracle
        # substep_xpbd); lift's normal read needs one exchanged halo
        xe0 = _exchange_halo(x3, axis_name)
        ve0 = _exchange_halo(v3, axis_name)
        fw = _wind_force_ext(xe0, ve0, cfg, ny_local, nx, ny_global, dev)
        accel = accel + fw[:, HALO : HALO + ny_local, :] * inv_mass2
    if cfg.self_collision.enabled:
        # self-collision repulsion enters the predict (oracle substep_xpbd;
        # the constraints only cover springs)
        accel = accel + _self_collision_rows(x3, cfg, axis_name) * inv_mass2
    v3 = (v3 + dt * accel) * (1.0 - cfg.global_damping * dt)
    v3 = jnp.where(movable, v3, 0.0)
    x_prev = x3
    delta0 = dt * v3   # delta-form accumulation (see stencil xpbd twin)

    we = _exchange_halo(w[None], axis_name)[0]          # [ext, nx]
    # plastic rest scale is substep-constant: one exchange serves every
    # Jacobi iteration (oracle: the update runs after the loop)
    se = _exchange_halo(scale, axis_name) if scale is not None else None
    ae = None
    if alive is not None:
        # liveness planes subsume the static ownership masks; the Jacobi
        # count follows the live constraints, recomputed per substep
        ae = _exchange_halo(alive, axis_name)
        cnt = jnp.zeros((ny_local + 2 * HALO, nx), x3.dtype)
        for o, (di, dj, _a, _r) in enumerate(xoffsets):
            cnt = cnt + ae[o] + st._shift(ae[o][None], -di, -dj)[0]
        cnt_inv = 1.0 / jnp.maximum(cnt[HALO : HALO + ny_local, :], 1.0)

    def project_contacts(delta, cf):
        """Position-only contact projection in delta form (shared by the
        Jacobi iterations and the post-strain/tether extra projection —
        oracle project_positions_only)."""
        if cfg.collision.enable_plane:
            # OR of the pre-clamp masks -> substep-end friction (f32 0/1
            # plane, keeping the shard_map varying-axis type)
            xe1 = x_prev[1] + delta[1]
            contact = (xe1 < plane_height) & movable[0]
            delta = delta.at[1].set(
                jnp.where(contact, plane_height - x_prev[1], delta[1])
            )
            cf = jnp.maximum(cf, jnp.where(contact, 1.0, 0.0))
        if cfg.collision.enable_spheres and spheres is not None:
            # position-only sphere projection, delta-rebased (same forms
            # as collide.project_positions_delta)
            centers, radii = spheres
            xev = x_prev + delta
            xproj = xev
            for si in range(radii.shape[0]):
                c = centers[si].reshape(3, 1, 1)
                d = xproj - c
                dist = jnp.sqrt(jnp.sum(d * d, axis=0))
                pen = radii[si] - dist
                contact = (pen > 0.0) & movable[0]
                n = d / jnp.maximum(dist, 1e-12)
                xproj = xproj + jnp.where(contact, pen, 0.0) * n
            delta = delta + (xproj - xev)
        if (capsules is not None and capsules.shape[0]) or (
                boxes is not None and boxes.shape[0]):
            # capsule/box projection, delta-rebased (same ordering as the
            # stencil XPBD twin)
            xev = x_prev + delta
            xproj = _project_capsules_boxes(xev, movable, capsules, boxes)
            delta = delta + (xproj - xev)
        if sdfs is not None:
            # SDF projection, delta-rebased (same ordering as the stencil
            # XPBD twin: after capsules/boxes)
            xev = x_prev + delta
            xproj = _project_sdfs_planes(xev, movable, sdfs)
            delta = delta + (xproj - xev)
        return delta, cf

    def iteration(carry, _):
        delta, lams, cf = carry
        xe = _exchange_halo(x_prev + delta, axis_name)
        dx = jnp.zeros_like(xe)
        new_lams = []
        for o, (di, dj, alpha, rest) in enumerate(xoffsets):
            lam_e = _exchange_halo(lams[o][None], axis_name)[0]
            xn = st._shift(xe, di, dj)
            d = xn - xe
            length = jnp.sqrt(jnp.sum(d * d, axis=0))
            n = d / jnp.maximum(length, 1e-12)
            rest_eff = rest if se is None else rest * se[o]
            c_val = length - rest_eff
            alpha_t = alpha / (dt * dt)
            wn = st._shift(we[None], di, dj)[0]
            m = (ae[o] if alive is not None
                 else _owned_mask_ext(ny_local, nx, ny_global, di, dj, dev))
            denom = jnp.maximum(we + wn + alpha_t, 1e-12)
            dlam = -(c_val + alpha_t * lam_e) / denom * m
            new_lams.append(dlam[HALO : HALO + ny_local, :] + lams[o])
            dx = dx + (-(we * dlam)) * n + st._shift((wn * dlam) * n, -di, -dj)
        delta = delta + cfg.xpbd.relaxation * dx[:, HALO : HALO + ny_local, :] * cnt_inv
        delta, cf = project_contacts(delta, cf)
        return (delta, tuple(new_lams), cf), None

    # derive zeros from the sharded input so the scan carry keeps the
    # shard_map varying-axis type ({V:rows}); plain jnp.zeros is replicated
    lams0 = tuple(x3[0] * 0.0 for _ in xoffsets)
    cf0 = x3[0] * 0.0
    (delta, _, cff), _ = jax.lax.scan(
        iteration, (delta0, lams0, cf0), None, length=cfg.xpbd.n_iterations
    )
    if cfg.strain_limit.enabled or anchors is not None:
        # strain limiting then motion constraints after the Jacobi loop,
        # then ONE more contact projection so the clamps never leave
        # penetration behind (oracle substep_xpbd ordering)
        xev = x_prev + delta
        if cfg.strain_limit.enabled:
            xev = xev + _strain_limit_halo(xev, xoffsets, cfg, inv_mass2,
                                           ny_global, axis_name, ae=ae,
                                           se=se, we=we)
        if anchors is not None:
            xev = xev + _tether_dx_planes(xev, anchors[0], anchors[1], cfg,
                                          movable)
        delta = xev - x_prev
        delta, cff = project_contacts(delta, cff)
    mu = cfg.collision.friction
    if cfg.collision.enable_plane and mu != 0.0:
        # plane friction ONCE per substep at the OR'd pre-clamp mask
        # (stencil xpbd twin, delta form; static plane)
        fric = cff > 0.0
        for ax in (0, 2):
            delta = delta.at[ax].set(
                jnp.where(fric, delta[ax] * (1.0 - mu), delta[ax]))
    # sphere + capsule/box/SDF friction at the substep-end contact shells
    # (delta rebased)
    xe_f = x_prev + delta
    xf = _sphere_friction_planes(xe_f, x_prev, movable, cfg, spheres, mu)
    xf = _rest_friction_planes(xf, x_prev, movable, cfg, capsules, boxes,
                               sdfs, mu, dt)
    delta = delta + (xf - xe_f)
    delta = jnp.where(movable, delta, 0.0)
    x_new = x_prev + delta
    if alive is not None or scale is not None:
        alive, scale = _feature_halo_update(x_new, alive, scale, xoffsets,
                                            cfg, axis_name)
    return x_new, delta / dt, alive, scale


def _sphere_friction_planes(x_new, x_start, movable, cfg, spheres, mu):
    """Substep-end sphere friction on [3, rows, nx] planes (collide.
    sphere_friction_positions twin; halo Verlet/XPBD run STATIC spheres,
    so the relative frame is the rest frame)."""
    from ..solver.collide import SPHERE_CONTACT_SHELL

    if (not cfg.collision.enable_spheres or spheres is None or mu == 0.0):
        return x_new
    centers, radii = spheres
    for si in range(radii.shape[0]):
        c = centers[si].reshape(3, 1, 1)
        d = x_new - c
        dist = jnp.sqrt(jnp.sum(d * d, axis=0))
        n = d / jnp.maximum(dist, 1e-12)
        contact = (dist <= radii[si] * SPHERE_CONTACT_SHELL) & movable[0]
        rel = x_new - x_start
        rel_t = rel - jnp.sum(rel * n, axis=0) * n
        x_new = jnp.where(contact, x_new - mu * rel_t, x_new)
    return x_new


def _rest_friction_planes(x_new, x_start, movable, cfg, capsules, boxes,
                          sdfs, mu, dt):
    """Substep-end capsule/box/SDF friction on [3, rows, nx] planes
    (collide.rest_friction_components twin; the packed rows carry each
    collider's kinematic velocity, zeros when static)."""
    if mu == 0.0:
        return x_new
    n_caps = capsules.shape[0] if capsules is not None else 0
    n_boxes = boxes.shape[0] if boxes is not None else 0
    if n_caps or n_boxes:
        from ..solver.collide import rest_friction_packed

        xz = rest_friction_packed(
            [x_new[0], x_new[1], x_new[2]],
            [x_start[0], x_start[1], x_start[2]], movable[0],
            capsules, n_caps, boxes, n_boxes, mu, dt)
        x_new = jnp.stack(xz)
    if sdfs is not None:
        from ..solver.collide import sdf_friction_components

        grids, origins, spacings = sdfs[0], sdfs[1], sdfs[2]
        svel = sdfs[3] if len(sdfs) > 3 else None
        for s in range(grids.shape[0]):
            w = None if svel is None else [svel[s, c] for c in range(3)]
            xz = sdf_friction_components(
                [x_new[0], x_new[1], x_new[2]],
                [x_start[0], x_start[1], x_start[2]], movable[0],
                grids[s], [origins[s, c] for c in range(3)], spacings[s],
                w, mu, dt)
            x_new = jnp.stack(xz)
    return x_new


def _halo_verlet_substep(x3, xp3, inv_mass2, offsets, cfg, dt,
                         plane_height, ny_global, axis_name, spheres=None,
                         alive=None, scale=None, capsules=None, boxes=None,
                         sdfs=None, anchors=None, we=None):
    """One position-Verlet substep on a row-sharded block (oracle
    substep_verlet semantics; halo forces as in _halo_substep).  Returns
    ``(x_new, x3, alive, scale)`` with Nones preserved."""
    ny_local, nx = x3.shape[-2], x3.shape[-1]
    dev = jax.lax.axis_index(axis_name)
    v_est = (x3 - xp3) / dt
    xe = _exchange_halo(x3, axis_name)
    ve = _exchange_halo(v_est, axis_name)
    ae = _exchange_halo(alive, axis_name) if alive is not None else None
    se = _exchange_halo(scale, axis_name) if scale is not None else None
    f = jnp.zeros_like(xe)
    for o, (di, dj, k, rest) in enumerate(offsets):
        xn = st._shift(xe, di, dj)
        vn = st._shift(ve, di, dj)
        d = xn - xe
        length = jnp.sqrt(jnp.sum(d * d, axis=0))
        inv_len = 1.0 / jnp.maximum(length, 1e-12)
        n = d * inv_len
        rel_v = jnp.sum((vn - ve) * n, axis=0)
        mask = (ae[o] if ae is not None
                else _owned_mask_ext(ny_local, nx, ny_global, di, dj, dev))
        rest_eff = rest if se is None else rest * se[o]
        fmag = (k * (length - rest_eff) + cfg.springs.damping * rel_v) * mask
        fo = fmag * n
        f = f + fo - st._shift(fo, -di, -dj)
    if cfg.wind.enabled:
        f = f + _wind_force_ext(xe, ve, cfg, ny_local, nx, ny_global, dev)
    f = f[:, HALO : HALO + ny_local, :]
    if cfg.self_collision.enabled:
        # forces at the current positions, as in the single-device
        # verlet_integrate -> total_forces chain
        f = f + _self_collision_rows(x3, cfg, axis_name)

    movable = inv_mass2 > 0.0
    g = jnp.asarray(cfg.gravity).astype(x3.dtype).reshape(3, 1, 1)
    accel = g + f * inv_mass2
    x_new = x3 + (x3 - xp3) * (1.0 - cfg.global_damping * dt) + accel * dt * dt
    x_new = jnp.where(movable, x_new, x3)
    if cfg.strain_limit.enabled:
        # strain limiting before contact, position-only on the projection
        # solvers (oracle substep_verlet ordering)
        x_new = x_new + _strain_limit_halo(x_new, offsets, cfg, inv_mass2,
                                           ny_global, axis_name, ae=ae,
                                           se=se, we=we)
    if anchors is not None:
        # motion constraints after strain limiting, before contact
        x_new = x_new + _tether_dx_planes(x_new, anchors[0], anchors[1],
                                          cfg, movable)
    # position-only projection (Verlet path, oracle project_positions_only)
    contact_pf = (x_new[1] < plane_height) & movable[0]  # pre-clamp mask
    if cfg.collision.enable_plane:
        x_new = x_new.at[1].set(
            jnp.where(contact_pf, plane_height, x_new[1]))
    if cfg.collision.enable_spheres and spheres is not None:
        centers, radii = spheres
        for si in range(radii.shape[0]):
            c = centers[si].reshape(3, 1, 1)
            d = x_new - c
            dist = jnp.sqrt(jnp.sum(d * d, axis=0))
            pen = radii[si] - dist
            contact = (pen > 0.0) & movable[0]
            n = d / jnp.maximum(dist, 1e-12)
            x_new = x_new + jnp.where(contact, pen, 0.0) * n
    x_new = _project_capsules_boxes(x_new, movable, capsules, boxes)
    x_new = _project_sdfs_planes(x_new, movable, sdfs)
    mu = cfg.collision.friction
    if cfg.collision.enable_plane and mu != 0.0:
        # substep-end plane friction at the pre-clamp contact mask
        # (collide.plane_friction_positions twin; halo Verlet/XPBD run
        # static planes — conveyor velocity is an Euler-halo feature)
        for ax in (0, 2):
            x_new = x_new.at[ax].set(jnp.where(
                contact_pf, x3[ax] + (x_new[ax] - x3[ax]) * (1.0 - mu),
                x_new[ax],
            ))
    x_new = _sphere_friction_planes(x_new, x3, movable, cfg, spheres, mu)
    x_new = _rest_friction_planes(x_new, x3, movable, cfg, capsules, boxes,
                                  sdfs, mu, dt)
    if alive is not None or scale is not None:
        alive, scale = _feature_halo_update(x_new, alive, scale, offsets,
                                            cfg, axis_name)
    return x_new, x3, alive, scale


def make_halo_verlet_step(top: Topology, cfg: SimConfig, mesh: Mesh):
    """Row-sharded position-Verlet stepping; interface as make_halo_step but
    carries (x, x_prev) and returns (x, v=(x - x_prev)/dt)."""
    _check_halo_colliders(top, cfg, strain="sweeps", motion="planes",
                          sc="dual")
    ny, nx = top.grid_shape
    spheres_on = cfg.collision.enable_spheres and top.n_spheres > 0
    from ..solver.collide import _needs_capsule_box, _needs_sdf
    caps_on = _needs_capsule_box(top, cfg)
    sdf_on = _needs_sdf(top, cfg)
    n_dev = mesh.shape[ROWS_AXIS]
    assert ny % n_dev == 0, f"ny={ny} must divide over {n_dev} devices"
    has_shear = EDGE_SHEAR in top.edge_classes_present
    has_bend = EDGE_BEND in top.edge_classes_present
    offsets = st._offsets(cfg, top.grid_spacing, has_shear, has_bend)
    spec = P(None, ROWS_AXIS, None)

    tearing = cfg.tear.enabled
    plastic = cfg.plasticity.enabled
    motion_on = cfg.motion.enabled and top.tether_anchor is not None

    def sharded_steps(x3, xp3, inv_mass3, plane_height, dt, n_substeps,
                      sphere_centers=None, sphere_radii=None, alive3=None,
                      capsules=None, boxes=None, scale3=None,
                      sdf_grids=None, sdf_origins=None, sdf_spacings=None,
                      tether_anchors=None, tether_radii=None):
        if motion_on and tether_anchors is None:
            raise ValueError(
                "cfg enables motion constraints: pass tether_anchors/"
                "tether_radii (shard_motion_planes(top, mesh))"
            )
        if tearing and alive3 is None:
            raise ValueError(
                "cfg enables tearing: pass alive3 (tear_plane_shard_maps)"
            )
        if plastic and scale3 is None:
            raise ValueError(
                "cfg enables plasticity: pass scale3 (tear_plane_shard_maps)"
            )
        if caps_on and capsules is None:
            raise ValueError(
                "cfg enables capsules/boxes: pass capsules/boxes "
                "(pack_capsule_box_geometry(top))"
            )
        if sdf_on and sdf_grids is None:
            raise ValueError(
                "cfg enables sdf colliders: pass sdf_grids/sdf_origins/"
                "sdf_spacings (pack_sdf_geometry(top))"
            )

        def local(x3b, xp3b, imb, ph, *rest):
            i = 0
            spheres = None
            if spheres_on:
                spheres = (rest[0], rest[1])
                i = 2
            cb = (None, None)
            if caps_on:
                cb = (rest[i], rest[i + 1])
                i += 2
            ab = None
            if tearing:
                ab = rest[i]
                i += 1
            sb = None
            if plastic:
                sb = rest[i]
                i += 1
            sd = (rest[i], rest[i + 1], rest[i + 2]) if sdf_on else None
            if sdf_on:
                i += 3
            anchors = None
            if motion_on:
                anchors = (rest[i], rest[i + 1])
                i += 2

            # loop-invariant inverse-mass halo: one exchange, not one per
            # substep (see make_halo_step's body)
            we = (_exchange_halo(imb, ROWS_AXIS)[0]
                  if cfg.strain_limit.enabled else None)

            def body(carry, _):
                out = _halo_verlet_substep(
                    carry[0], carry[1], imb, offsets, cfg, dt, ph[0], ny,
                    ROWS_AXIS, spheres=spheres, alive=carry[2],
                    scale=carry[3], capsules=cb[0], boxes=cb[1], sdfs=sd,
                    anchors=anchors, we=we,
                )
                return out, None

            (xf, xpf, af, sf), _ = jax.lax.scan(
                body, (x3b, xp3b, ab, sb), None, length=n_substeps
            )
            v = (xf - xpf) / dt
            return ((xf, v) + ((af,) if tearing else ())
                    + ((sf,) if plastic else ()))

        args = [x3, xp3, inv_mass3, plane_height]
        specs = [spec, spec, spec, P()]
        outs = (spec, spec)
        if spheres_on:
            if sphere_centers is None:
                raise ValueError("cfg enables spheres: pass sphere geometry")
            args += [sphere_centers, sphere_radii]
            specs += [P(), P()]
        if caps_on:
            args += [capsules, boxes]
            specs += [P(), P()]
        if tearing:
            args.append(alive3)
            specs.append(spec)
            outs = outs + (spec,)
        if plastic:
            args.append(scale3)
            specs.append(spec)
            outs = outs + (spec,)
        if sdf_on:
            args += [sdf_grids, sdf_origins, sdf_spacings]
            specs += [P(), P(), P()]
        if motion_on:
            args += [tether_anchors, tether_radii]
            specs += [spec, spec]
        return jax.shard_map(
            local, mesh=mesh, in_specs=tuple(specs), out_specs=outs
        )(*args)

    return sharded_steps


def make_halo_xpbd_step(top: Topology, cfg: SimConfig, mesh: Mesh):
    """Row-sharded XPBD stepping (see make_halo_step for the interface)."""
    _check_halo_colliders(top, cfg, strain="sweeps", motion="planes",
                          sc="dual")
    from ..kernels.stencil import _xpbd_offsets

    ny, nx = top.grid_shape
    spheres_on = cfg.collision.enable_spheres and top.n_spheres > 0
    from ..solver.collide import _needs_capsule_box, _needs_sdf
    caps_on = _needs_capsule_box(top, cfg)
    sdf_on = _needs_sdf(top, cfg)
    n_dev = mesh.shape[ROWS_AXIS]
    assert ny % n_dev == 0, f"ny={ny} must divide over {n_dev} devices"
    has_shear = EDGE_SHEAR in top.edge_classes_present
    has_bend = EDGE_BEND in top.edge_classes_present
    xoffsets = _xpbd_offsets(cfg, top.grid_spacing, has_shear, has_bend)

    spec = P(None, ROWS_AXIS, None)

    tearing = cfg.tear.enabled
    plastic = cfg.plasticity.enabled
    motion_on = cfg.motion.enabled and top.tether_anchor is not None

    def sharded_steps(x3, v3, inv_mass3, plane_height, dt, n_substeps,
                      sphere_centers=None, sphere_radii=None, alive3=None,
                      capsules=None, boxes=None, scale3=None,
                      sdf_grids=None, sdf_origins=None, sdf_spacings=None,
                      tether_anchors=None, tether_radii=None):
        # XPBD contact is position-projection (oracle project_positions_only)
        # — kinematic collider velocities do not enter this solver.
        if motion_on and tether_anchors is None:
            raise ValueError(
                "cfg enables motion constraints: pass tether_anchors/"
                "tether_radii (shard_motion_planes(top, mesh))"
            )
        if tearing and alive3 is None:
            raise ValueError(
                "cfg enables tearing: pass alive3 (tear_plane_shard_maps)"
            )
        if plastic and scale3 is None:
            raise ValueError(
                "cfg enables plasticity: pass scale3 (tear_plane_shard_maps)"
            )
        if caps_on and capsules is None:
            raise ValueError(
                "cfg enables capsules/boxes: pass capsules/boxes "
                "(pack_capsule_box_geometry(top))"
            )
        if sdf_on and sdf_grids is None:
            raise ValueError(
                "cfg enables sdf colliders: pass sdf_grids/sdf_origins/"
                "sdf_spacings (pack_sdf_geometry(top))"
            )

        def local(x3b, v3b, imb, ph, *rest):
            i = 0
            spheres = None
            if spheres_on:
                spheres = (rest[0], rest[1])
                i = 2
            cb = (None, None)
            if caps_on:
                cb = (rest[i], rest[i + 1])
                i += 2
            ab = None
            if tearing:
                ab = rest[i]
                i += 1
            sb = None
            if plastic:
                sb = rest[i]
                i += 1
            sd = (rest[i], rest[i + 1], rest[i + 2]) if sdf_on else None
            if sdf_on:
                i += 3
            anchors = None
            if motion_on:
                anchors = (rest[i], rest[i + 1])
                i += 2
            ny_local = x3b.shape[-2]
            dev = jax.lax.axis_index(ROWS_AXIS)
            if tearing:
                cnt_inv = None  # recomputed per substep from live planes
            else:
                # per-vertex constraint count over owned + owning edges,
                # judged globally on the extended block then sliced
                cnt = jnp.zeros((ny_local + 2 * HALO, nx), x3b.dtype)
                for di, dj, _, _ in xoffsets:
                    m = _owned_mask_ext(ny_local, nx, ny, di, dj, dev)
                    cnt = cnt + m + st._shift(m[None], -di, -dj)[0]
                cnt_inv = 1.0 / jnp.maximum(
                    cnt[HALO : HALO + ny_local, :], 1.0
                )

            def body(carry, _):
                out = _halo_xpbd_substep(
                    carry[0], carry[1], imb, xoffsets, cfg, dt, ph[0], ny,
                    ROWS_AXIS, cnt_inv, spheres=spheres, alive=carry[2],
                    scale=carry[3], capsules=cb[0], boxes=cb[1], sdfs=sd,
                    anchors=anchors,
                )
                return out, None

            (xf, vf, af, sf), _ = jax.lax.scan(
                body, (x3b, v3b, ab, sb), None, length=n_substeps
            )
            return ((xf, vf) + ((af,) if tearing else ())
                    + ((sf,) if plastic else ()))

        args = [x3, v3, inv_mass3, plane_height]
        specs = [spec, spec, spec, P()]
        outs = (spec, spec)
        if spheres_on:
            if sphere_centers is None:
                raise ValueError("cfg enables spheres: pass sphere geometry")
            args += [sphere_centers, sphere_radii]
            specs += [P(), P()]
        if caps_on:
            args += [capsules, boxes]
            specs += [P(), P()]
        if tearing:
            args.append(alive3)
            specs.append(spec)
            outs = outs + (spec,)
        if plastic:
            args.append(scale3)
            specs.append(spec)
            outs = outs + (spec,)
        if sdf_on:
            args += [sdf_grids, sdf_origins, sdf_spacings]
            specs += [P(), P(), P()]
        if motion_on:
            args += [tether_anchors, tether_radii]
            specs += [spec, spec]
        return jax.shard_map(
            local, mesh=mesh, in_specs=tuple(specs), out_specs=outs
        )(*args)

    return sharded_steps


# ---------------------------------------------------------------------------
# Volumetric lattice halo decomposition (tet cube — SURVEY.md C16 extended
# to 3D: shard the outer lattice axis into i-slabs of n^2 vertices)
# ---------------------------------------------------------------------------
#
# The tet cube is an n^3 lattice whose banded edge/tet deltas all reach at
# most ONE slab in i (builders emit (di, dj, dk) with |di| <= 1), so a
# 1-slab halo exchange per substep suffices.  Within a slab, a flat delta
# r = dj*n + dk is a roll on the flattened (j,k) axis with the usual
# mask-annihilation argument (solver/banded.py); across slabs it is a
# shift on the slab axis into the exchanged halo.  Ownership masks are the
# *actual* banded group masks (sharded array data, exchanged once per
# call), so parity-dependent 5-tet patterns need no re-derivation here.

SLAB_HALO = 1


def _exchange_slab(a: jax.Array, axis_name: str) -> jax.Array:
    """[..., L, n2] local slabs -> [..., L+2, n2] with 1-slab halos."""
    n_dev = jax.lax.axis_size(axis_name)
    down_perm = [(i, i + 1) for i in range(n_dev - 1)]
    up_perm = [(i + 1, i) for i in range(n_dev - 1)]
    from_above = jax.lax.ppermute(a[..., -1:, :], axis_name, down_perm)
    from_below = jax.lax.ppermute(a[..., :1, :], axis_name, up_perm)
    return jnp.concatenate([from_above, a, from_below], axis=-2)


def _split_lattice_delta(d: int, n: int):
    """flat delta -> (slab delta di, in-slab flat delta r = dj*n + dk)."""
    n2 = n * n
    di = int(round(d / n2))
    r = d - di * n2
    if abs(di) > SLAB_HALO or abs(r) > n + 1:
        raise ValueError(f"delta {d} reaches beyond one slab (n={n})")
    return di, r


def _nbr(a: jax.Array, di: int, r: int) -> jax.Array:
    """Neighbour view on an extended block: out[.., s, p] = a[.., s+di, p+r]
    (slab shift zero-pads at the extended edge; jk roll wraps into lanes the
    ownership masks have already zeroed)."""
    out = a
    if r:
        out = jnp.roll(out, -r, axis=-1)
    if di:
        out = st._shift(out if out.ndim == 3 else out[None], di, 0)
        out = out if a.ndim == 3 else out[0]
    return out


def _rev(a: jax.Array, di: int, r: int) -> jax.Array:
    """Reverse of :func:`_nbr` (deposits owner contributions on neighbours)."""
    out = a
    if di:
        out = st._shift(out if out.ndim == 3 else out[None], -di, 0)
        out = out if a.ndim == 3 else out[0]
    if r:
        out = jnp.roll(out, r, axis=-1)
    return out


def _strain_limit_slab_inv_cnt(sgroups, we, eme, n_local):
    """Owned-slab inverse incident-edge count for the strain-limit sweeps
    (static per call — compute ONCE outside the substep scan, the count
    only depends on the exchanged masks)."""
    cnt = jnp.zeros_like(we)
    for (di, r, _rest), m in zip(sgroups, eme):
        cnt = cnt + m + _rev(m, di, r)
    return (1.0 / jnp.maximum(cnt, 1.0))[SLAB_HALO : SLAB_HALO + n_local, :]


def _strain_limit_slab(xb, sgroups, cfg, we, eme, inv_cnt, n_local,
                       axis_name):
    """Strain-limit Jacobi sweeps on slab-sharded lattice blocks — the 3D
    counterpart of :func:`_strain_limit_halo` (oracle ``strain_limit_dx``
    twin over the banded offset groups).  ``sgroups`` is
    ``((di, r, rest), ...)``; ``we``/``eme``/``inv_cnt`` are the caller's
    already-exchanged inverse-mass / group-mask slabs and the precomputed
    :func:`_strain_limit_slab_inv_cnt` (all loop-invariant — no redundant
    ppermute).  Each sweep re-exchanges the positions so any sweep count
    stays exact with the 1-slab halo.  Returns the total dx on the owned
    slabs."""
    sl = cfg.strain_limit
    x0 = xb
    for _ in range(sl.iterations):
        xe = _exchange_slab(xb, axis_name)
        dx = jnp.zeros_like(xe)
        for gi, (di, r, rest) in enumerate(sgroups):
            xn = _nbr(xe, di, r)
            d = xn - xe
            length = jnp.sqrt(jnp.sum(d * d, axis=0))
            nrm = d / jnp.maximum(length, 1e-12)
            hi = rest * (1.0 + sl.max_stretch)
            lo = (rest * (1.0 - sl.max_compress)
                  if sl.max_compress >= 0.0 else 0.0)
            c_val = (length - jnp.clip(length, lo, hi)) * eme[gi]
            wn = _nbr(we, di, r)
            corr = c_val / jnp.maximum(we + wn, 1e-12)
            dx = dx + (we * corr) * nrm - _rev((wn * corr) * nrm, di, r)
        xb = xb + dx[:, SLAB_HALO : SLAB_HALO + n_local, :] * inv_cnt
    return xb - x0


def shard_motion_slabs(top: Topology, mesh: Mesh):
    """Tether anchors/radii -> slab-sharded lattice planes
    ``(anchor3 f32[3, n, n^2], radius1 f32[1, n, n^2])`` for the lattice
    halo steppers' ``tether_anchors``/``tether_radii`` inputs (the
    :func:`shard_motion_planes` counterpart)."""
    if top.tether_anchor is None:
        raise ValueError(
            "topology has no motion constraints: call "
            "set_motion_constraints(top, anchors, radii) before "
            "shard_motion_slabs"
        )
    n = round(top.n_vertices ** (1.0 / 3.0))
    n2 = n * n
    spec = NamedSharding(mesh, P(None, ROWS_AXIS, None))
    a3 = jax.device_put(
        jnp.asarray(top.tether_anchor).T.reshape(3, n, n2), spec)
    r1 = jax.device_put(
        jnp.asarray(top.tether_radius).reshape(1, n, n2), spec)
    return a3, r1


def shard_shapematch_slabs(top: Topology, mesh: Mesh):
    """Slab-sharded cluster data for lattice shape matching:
    ``(cid3 i32[1, n, n2], rest3 f32[3, n, n2], quats0 f32[K, 4])`` —
    the cluster-id and rest-offset planes shard like the state; the
    warm-start quaternions are replicated (every device runs the same
    rotation extraction on the same psum-reduced cluster moments)."""
    if top.cluster_id is None:
        raise ValueError(
            "topology has no shape-matching clusters: call "
            "enable_shape_matching(top, ...) before shard_shapematch_slabs"
        )
    import numpy as np

    n = round(top.n_vertices ** (1.0 / 3.0))
    n2 = n * n
    spec = NamedSharding(mesh, P(None, ROWS_AXIS, None))
    cid3 = jax.device_put(
        jnp.asarray(top.cluster_id, jnp.int32).reshape(1, n, n2), spec)
    rest3 = jax.device_put(
        jnp.asarray(top.cluster_rest).T.reshape(3, n, n2), spec)
    q0 = np.zeros((int(top.n_clusters), 4), np.float32)
    q0[:, 0] = 1.0
    return cid3, rest3, jax.device_put(jnp.asarray(q0))


def _shape_match_slab_statics(cid3, imb, n_clusters: int, axis_name: str):
    """Loop-invariant cluster data on a slab (inside shard_map): local
    one-hot membership and the GLOBAL per-cluster inverse masses (one
    [K]-sized psum).  Hoisted out of the substep scan by XLA."""
    hp = jax.lax.Precision.HIGHEST
    cid = cid3.reshape(-1)
    im = imb.reshape(-1)
    member = (cid >= 0) & (im > 0.0)
    m = jnp.where(member, 1.0 / jnp.maximum(im, 1e-30), 0.0)
    oh = (cid[:, None] == jnp.arange(n_clusters, dtype=jnp.int32)
          ).astype(jnp.float32)
    mass_k = jax.lax.psum(
        jnp.einsum("n,nk->k", m, oh, precision=hp), axis_name)
    return dict(oh=oh, m=m, member=member,
                inv_mass_k=1.0 / jnp.maximum(mass_k, 1e-30))


def _shape_match_slab_dx(xb, rest3, quats, statics, cfg, axis_name):
    """Per-substep shape-matching dx on a slab-sharded lattice: the
    multi-device form of ``shape_match_dx``'s one-hot matmul branch (same
    centered formulation, same HIGHEST precision — the reductions feed
    ``x - c`` / ``g - x`` cancellations, CLAUDE.md "Matmul precision"),
    with each [*, K]-sized cluster reduction computed as a LOCAL partial
    + one ``lax.psum`` over the slab axis —
    [3, K] + [9, K] floats per substep, not vertex data.  The rotation
    extraction then runs replicated on every device (psum returns
    identical moments everywhere), so the warm-start quats never need
    communicating.  Returns ``(dx [3, L, n2], quats' [K, 4])``."""
    sm = cfg.shape_match
    hp = jax.lax.Precision.HIGHEST
    from ..solver.shapematch import _cross_rows, extract_rotations

    oh, m = statics["oh"], statics["m"]
    x = xb.reshape(3, -1)                                 # [3, nl]
    r = rest3.reshape(3, -1)
    wx = m[None] * x
    c = jax.lax.psum(
        jnp.einsum("dn,nk->dk", wx, oh, precision=hp), axis_name
    ) * statics["inv_mass_k"][None]                       # [3, K]
    cb = jnp.einsum("dk,nk->dn", c, oh, precision=hp)     # c[cid]
    xc = x - cb
    p9 = (m[None] * xc)[:, None, :] * r[None, :, :]       # [d, e, nl]
    A = jax.lax.psum(
        jnp.einsum("den,nk->kde", p9, oh, precision=hp), axis_name)
    quats = extract_rotations(A, quats, sm.iterations)
    qn = jnp.einsum("kq,nk->qn", quats, oh, precision=hp)  # quats[cid]
    qw, qv = qn[0:1], qn[1:]
    g = r + 2.0 * _cross_rows(qv, _cross_rows(qv, r) + qw * r) + cb
    dx = sm.stiffness * (g - x)
    dx = jnp.where(statics["member"][None], dx, 0.0)
    return dx.reshape(xb.shape), quats


def lattice_halo_applicable(top: Topology) -> bool:
    """Static gate: fully banded uniform lattice with an n^3 vertex count."""
    g = top.offset_groups
    t = top.tet_groups
    if g is None or len(g.deltas) == 0 or g.n_residual > 0:
        return False
    if any(u is None for u in g.uniform):
        return False
    if t is None or t.n_residual > 0:
        return False
    if len(t.deltas) > 0 and any(u is None for u in t.uniform_rest_volume):
        return False
    n = round(top.n_vertices ** (1.0 / 3.0))
    return n * n * n == top.n_vertices


def make_halo_lattice_step(top: Topology, cfg: SimConfig, mesh: Mesh):
    """Slab-sharded Euler stepping for the banded tet lattice.

    Returns ``fn(x3, v3, im3, plane_h, emask, tmask, dt, n_substeps,
    sphere_centers=None, sphere_radii=None, tether_anchors=None,
    tether_radii=None, sm_cid=None, sm_rest=None, sm_quats=None)`` over
    ``f32[3, n, n^2]`` plane-layout arrays sharded
    ``P(None, ROWS_AXIS, None)``; use :func:`shard_lattice_state`
    (and :func:`shard_motion_slabs` for the tether planes,
    :func:`shard_shapematch_slabs` for the shape-matching planes —
    with shape matching on, the function returns ``(x, v, quats)``).
    Semantics mirror solver/step.py substep_euler on the banded path
    (tested vs single device): shape matching after the volume
    projection, then strain limiting and motion tethers, all with
    velocity feedback, before contact."""
    _check_halo_colliders(top, cfg, wind="drag", tear="none", caps="none",
                          sdf="none", strain="sweeps", motion="slabs",
                          sm="slabs")
    if not lattice_halo_applicable(top):
        raise ValueError("topology is not a fully banded uniform lattice")
    n = round(top.n_vertices ** (1.0 / 3.0))
    n_dev = mesh.shape[ROWS_AXIS]
    assert n % n_dev == 0, f"n={n} slabs must divide over {n_dev} devices"
    g = top.offset_groups
    t = top.tet_groups
    egroups = tuple(
        _split_lattice_delta(d, n) + (k, rest)
        for d, (k, rest, _a) in zip(g.deltas, g.uniform)
    )
    use_volume = len(t.deltas) > 0 and cfg.volume_stiffness != 0.0
    tgroups = tuple(
        (tuple(_split_lattice_delta(d, n) for d in pat), rv)
        for pat, rv in zip(t.deltas, t.uniform_rest_volume)
    ) if use_volume else ()
    vol_stiff = cfg.volume_stiffness
    damping = cfg.springs.damping
    spheres_on = cfg.collision.enable_spheres and top.n_spheres > 0
    strain_on = cfg.strain_limit.enabled
    motion_on = cfg.motion.enabled and top.tether_anchor is not None
    sm_on = cfg.shape_match.enabled and top.n_clusters > 0
    n_clusters = int(top.n_clusters)
    sgroups = tuple((di, r, rest) for (di, r, _k, rest) in egroups)

    spec = P(None, ROWS_AXIS, None)

    def sharded_steps(x3, v3, im3, plane_height, emask, tmask, dt,
                      n_substeps, sphere_centers=None, sphere_radii=None,
                      tether_anchors=None, tether_radii=None,
                      sm_cid=None, sm_rest=None, sm_quats=None):
        if motion_on and tether_anchors is None:
            raise ValueError(
                "cfg enables motion constraints: pass tether_anchors/"
                "tether_radii (shard_motion_slabs(top, mesh))"
            )
        if sm_on and sm_cid is None:
            raise ValueError(
                "cfg enables shape matching: pass sm_cid/sm_rest/"
                "sm_quats (shard_shapematch_slabs(top, mesh))"
            )

        def local(x3b, v3b, imb, ph, emb, tmb, *rest_args):
            i = 0
            spheres = None
            if spheres_on:
                spheres = (rest_args[0], rest_args[1])
                i = 2
            anchors = None
            if motion_on:
                anchors = (rest_args[i], rest_args[i + 1])
                i += 2
            smd = None
            if sm_on:
                cid3b, rest3b, quats0 = (rest_args[i], rest_args[i + 1],
                                         rest_args[i + 2])
                smd = _shape_match_slab_statics(cid3b, imb[0], n_clusters,
                                                ROWS_AXIS)
            n_local = x3b.shape[-2]
            movable = imb > 0.0
            # static per call: extended masks, inv-mass, volume count plane
            we = _exchange_slab(imb, ROWS_AXIS)[0]         # [L+2, n2]
            eme = _exchange_slab(emb, ROWS_AXIS)           # [Ge, L+2, n2]
            if strain_on:
                sl_inv_cnt = _strain_limit_slab_inv_cnt(sgroups, we, eme,
                                                        n_local)
            if use_volume:
                tme = _exchange_slab(tmb, ROWS_AXIS)       # [Gt, L+2, n2]
                cnt = jnp.zeros_like(we)
                for gi, (corners, _rv) in enumerate(tgroups):
                    m = tme[gi]
                    cnt = cnt + m
                    for (di, r) in corners:
                        cnt = cnt + _rev(m, di, r)
                inv_cnt_vs = vol_stiff / jnp.maximum(
                    cnt[SLAB_HALO : SLAB_HALO + n_local, :], 1.0
                )

            def substep(carry, _):
                xb, vb, quats = carry
                xe = _exchange_slab(xb, ROWS_AXIS)
                ve = _exchange_slab(vb, ROWS_AXIS)
                f = jnp.zeros_like(xe)
                for gi, (di, r, k_s, rest) in enumerate(egroups):
                    xn = _nbr(xe, di, r)
                    vn = _nbr(ve, di, r)
                    d = xn - xe
                    length = jnp.sqrt(jnp.sum(d * d, axis=0))
                    nrm = d / jnp.maximum(length, 1e-12)
                    rel = jnp.sum((vn - ve) * nrm, axis=0)
                    fmag = eme[gi] * (k_s * (length - rest) + damping * rel)
                    fo = fmag * nrm
                    f = f + fo - _rev(fo, di, r)
                f = f[:, SLAB_HALO : SLAB_HALO + n_local, :]
                if cfg.wind.drag != 0.0:
                    f = f + _drag_force(cfg, vb)
                gvec = jnp.asarray(cfg.gravity).astype(xb.dtype).reshape(3, 1, 1)
                vb = (vb + dt * (gvec + f * imb)) * (1.0 - cfg.global_damping * dt)
                vb = jnp.where(movable, vb, 0.0)
                xb = xb + dt * vb
                if use_volume:
                    xve = _exchange_slab(xb, ROWS_AXIS)
                    dx = jnp.zeros_like(xve)
                    for gi, (corners, rv) in enumerate(tgroups):
                        m = tme[gi]
                        p = [_nbr(xve, di, r) for (di, r) in corners]
                        e1, e2, e3 = p[0] - xve, p[1] - xve, p[2] - xve
                        c12 = jnp.stack([
                            e1[1] * e2[2] - e1[2] * e2[1],
                            e1[2] * e2[0] - e1[0] * e2[2],
                            e1[0] * e2[1] - e1[1] * e2[0],
                        ])
                        g1 = jnp.stack([
                            e2[1] * e3[2] - e2[2] * e3[1],
                            e2[2] * e3[0] - e2[0] * e3[2],
                            e2[0] * e3[1] - e2[1] * e3[0],
                        ]) / 6.0
                        g2 = jnp.stack([
                            e3[1] * e1[2] - e3[2] * e1[1],
                            e3[2] * e1[0] - e3[0] * e1[2],
                            e3[0] * e1[1] - e3[1] * e1[0],
                        ]) / 6.0
                        g3 = c12 / 6.0
                        g0 = -(g1 + g2 + g3)
                        vol = jnp.sum(c12 * e3, axis=0) / 6.0
                        c_val = vol - rv
                        wc = [_nbr(we, di, r) for (di, r) in corners]
                        denom = (
                            we * jnp.sum(g0 * g0, axis=0)
                            + wc[0] * jnp.sum(g1 * g1, axis=0)
                            + wc[1] * jnp.sum(g2 * g2, axis=0)
                            + wc[2] * jnp.sum(g3 * g3, axis=0)
                        )
                        s = m * (-c_val) / jnp.maximum(denom, 1e-12)
                        dx = dx + (we * s) * g0
                        for ci, gv in zip(range(3), (g1, g2, g3)):
                            di, r = corners[ci]
                            dx = dx + _rev((wc[ci] * s) * gv, di, r)
                    dxi = dx[:, SLAB_HALO : SLAB_HALO + n_local, :] * inv_cnt_vs
                    dxi = jnp.where(movable, dxi, 0.0)
                    xb = xb + dxi
                    vb = vb + dxi / dt
                if sm_on:
                    # shape matching after the volume projection, before
                    # strain limiting/tethers/contact with velocity
                    # feedback (oracle substep_euler ordering)
                    dxs, quats = _shape_match_slab_dx(
                        xb, rest3b, quats, smd, cfg, ROWS_AXIS)
                    xb = xb + dxs
                    vb = vb + dxs / dt
                if strain_on:
                    # strain limiting before collision; the clamp feeds
                    # back into velocity (oracle substep_euler ordering)
                    dxl = _strain_limit_slab(xb, sgroups, cfg, we, eme,
                                             sl_inv_cnt, n_local, ROWS_AXIS)
                    xb = xb + dxl
                    vb = vb + dxl / dt
                if motion_on:
                    # tethers after strain limiting, before collision
                    # (contact always wins); velocity feedback on Euler
                    dxt = _tether_dx_planes(xb, anchors[0], anchors[1],
                                            cfg, movable)
                    xb = xb + dxt
                    vb = vb + dxt / dt
                xb, vb = _resolve_colliders(xb, vb, movable, cfg, ph[0], spheres)
                return (xb, vb, quats), None

            q0 = quats0 if sm_on else jnp.zeros((1, 4), x3b.dtype)
            (xf, vf, qf), _ = jax.lax.scan(
                substep, (x3b, v3b, q0), None, length=n_substeps
            )
            if sm_on:
                return xf, vf, qf
            return xf, vf

        args = (x3, v3, im3, plane_height, emask, tmask)
        specs = (spec, spec, spec, P(), spec, spec)
        if spheres_on:
            if sphere_centers is None:
                raise ValueError("cfg enables spheres: pass sphere geometry")
            args += (sphere_centers, sphere_radii)
            specs += (P(), P())
        if motion_on:
            args += (tether_anchors, tether_radii)
            specs += (spec, spec)
        if sm_on:
            args += (sm_cid, sm_rest, sm_quats)
            specs += (spec, spec, P())
        out_specs = (spec, spec, P()) if sm_on else (spec, spec)
        return jax.shard_map(
            local, mesh=mesh, in_specs=specs, out_specs=out_specs
        )(*args)

    return sharded_steps


def shard_lattice_state(top: Topology, state: State, mesh: Mesh):
    """State[N,3] -> slab-sharded lattice arrays
    (x3, v3, im3, plane_h, emask, tmask)."""
    n = round(top.n_vertices ** (1.0 / 3.0))
    n2 = n * n
    spec = NamedSharding(mesh, P(None, ROWS_AXIS, None))
    x3 = jax.device_put(jnp.asarray(state.x).T.reshape(3, n, n2), spec)
    v3 = jax.device_put(jnp.asarray(state.v).T.reshape(3, n, n2), spec)
    im3 = jax.device_put(jnp.asarray(top.inv_mass).reshape(1, n, n2), spec)
    ph = jax.device_put(jnp.asarray(top.plane_height).reshape(1))
    emask = jax.device_put(
        jnp.asarray(top.offset_groups.mask).reshape(-1, n, n2), spec
    )
    t = top.tet_groups
    if t is not None and len(t.deltas) > 0:
        tmask = jax.device_put(jnp.asarray(t.mask).reshape(-1, n, n2), spec)
    else:
        tmask = jax.device_put(jnp.zeros((1, n, n2), jnp.float32), spec)
    return x3, v3, im3, ph, emask, tmask


def make_halo_lattice_verlet_step(top: Topology, cfg: SimConfig, mesh: Mesh):
    """Slab-sharded position-Verlet stepping for the banded tet lattice
    (solver/step.py substep_verlet semantics on the banded path).

    Returns ``fn(x3, xp3, im3, plane_h, emask, tmask, dt, n_substeps,
    sphere_centers=None, sphere_radii=None, tether_anchors=None,
    tether_radii=None, sm_cid=None, sm_rest=None, sm_quats=None)
    -> (x, v)`` (``(x, v, quats)`` with shape matching on —
    :func:`shard_shapematch_slabs`).  Shape matching, strain limiting
    and motion tethers run position-only after the volume projection,
    before contact (oracle substep_verlet ordering)."""
    _check_halo_colliders(top, cfg, wind="drag", tear="none", caps="none",
                          sdf="none", strain="sweeps", motion="slabs",
                          sm="slabs")
    if not lattice_halo_applicable(top):
        raise ValueError("topology is not a fully banded uniform lattice")
    n = round(top.n_vertices ** (1.0 / 3.0))
    n_dev = mesh.shape[ROWS_AXIS]
    assert n % n_dev == 0, f"n={n} slabs must divide over {n_dev} devices"
    g = top.offset_groups
    t = top.tet_groups
    egroups = tuple(
        _split_lattice_delta(d, n) + (k, rest)
        for d, (k, rest, _a) in zip(g.deltas, g.uniform)
    )
    use_volume = len(t.deltas) > 0 and cfg.volume_stiffness != 0.0
    tgroups = tuple(
        (tuple(_split_lattice_delta(d, n) for d in pat), rv)
        for pat, rv in zip(t.deltas, t.uniform_rest_volume)
    ) if use_volume else ()
    vol_stiff = cfg.volume_stiffness
    damping = cfg.springs.damping
    spheres_on = cfg.collision.enable_spheres and top.n_spheres > 0
    strain_on = cfg.strain_limit.enabled
    motion_on = cfg.motion.enabled and top.tether_anchor is not None
    sm_on = cfg.shape_match.enabled and top.n_clusters > 0
    n_clusters = int(top.n_clusters)
    sgroups = tuple((di, r, rest) for (di, r, _k, rest) in egroups)
    spec = P(None, ROWS_AXIS, None)

    def sharded_steps(x3, xp3, im3, plane_height, emask, tmask, dt,
                      n_substeps, sphere_centers=None, sphere_radii=None,
                      tether_anchors=None, tether_radii=None,
                      sm_cid=None, sm_rest=None, sm_quats=None):
        if sm_on and sm_cid is None:
            raise ValueError(
                "cfg enables shape matching: pass sm_cid/sm_rest/"
                "sm_quats (shard_shapematch_slabs(top, mesh))"
            )
        if motion_on and tether_anchors is None:
            raise ValueError(
                "cfg enables motion constraints: pass tether_anchors/"
                "tether_radii (shard_motion_slabs(top, mesh))"
            )

        def local(x3b, xp3b, imb, ph, emb, tmb, *rest_args):
            i = 0
            spheres = None
            if spheres_on:
                spheres = (rest_args[0], rest_args[1])
                i = 2
            anchors = None
            if motion_on:
                anchors = (rest_args[i], rest_args[i + 1])
                i += 2
            smd = None
            if sm_on:
                cid3b, rest3b, quats0 = (rest_args[i], rest_args[i + 1],
                                         rest_args[i + 2])
                smd = _shape_match_slab_statics(cid3b, imb[0], n_clusters,
                                                ROWS_AXIS)
            n_local = x3b.shape[-2]
            movable = imb > 0.0
            we = _exchange_slab(imb, ROWS_AXIS)[0]
            eme = _exchange_slab(emb, ROWS_AXIS)
            if strain_on:
                sl_inv_cnt = _strain_limit_slab_inv_cnt(sgroups, we, eme,
                                                        n_local)
            if use_volume:
                tme = _exchange_slab(tmb, ROWS_AXIS)
                cnt = jnp.zeros_like(we)
                for gi, (corners, _rv) in enumerate(tgroups):
                    m = tme[gi]
                    cnt = cnt + m
                    for (di, r) in corners:
                        cnt = cnt + _rev(m, di, r)
                inv_cnt_vs = vol_stiff / jnp.maximum(
                    cnt[SLAB_HALO : SLAB_HALO + n_local, :], 1.0
                )

            def volume_dx_interior(xb):
                xve = _exchange_slab(xb, ROWS_AXIS)
                dx = jnp.zeros_like(xve)
                for gi, (corners, rv) in enumerate(tgroups):
                    m = tme[gi]
                    p = [_nbr(xve, di, r) for (di, r) in corners]
                    e1, e2, e3 = p[0] - xve, p[1] - xve, p[2] - xve
                    c12 = jnp.stack([
                        e1[1] * e2[2] - e1[2] * e2[1],
                        e1[2] * e2[0] - e1[0] * e2[2],
                        e1[0] * e2[1] - e1[1] * e2[0],
                    ])
                    g1 = jnp.stack([
                        e2[1] * e3[2] - e2[2] * e3[1],
                        e2[2] * e3[0] - e2[0] * e3[2],
                        e2[0] * e3[1] - e2[1] * e3[0],
                    ]) / 6.0
                    g2 = jnp.stack([
                        e3[1] * e1[2] - e3[2] * e1[1],
                        e3[2] * e1[0] - e3[0] * e1[2],
                        e3[0] * e1[1] - e3[1] * e1[0],
                    ]) / 6.0
                    g3 = c12 / 6.0
                    g0 = -(g1 + g2 + g3)
                    vol = jnp.sum(c12 * e3, axis=0) / 6.0
                    c_val = vol - rv
                    wc = [_nbr(we, di, r) for (di, r) in corners]
                    denom = (
                        we * jnp.sum(g0 * g0, axis=0)
                        + wc[0] * jnp.sum(g1 * g1, axis=0)
                        + wc[1] * jnp.sum(g2 * g2, axis=0)
                        + wc[2] * jnp.sum(g3 * g3, axis=0)
                    )
                    s = m * (-c_val) / jnp.maximum(denom, 1e-12)
                    dx = dx + (we * s) * g0
                    for ci, gv in zip(range(3), (g1, g2, g3)):
                        di, r = corners[ci]
                        dx = dx + _rev((wc[ci] * s) * gv, di, r)
                dxi = dx[:, SLAB_HALO : SLAB_HALO + n_local, :] * inv_cnt_vs
                return jnp.where(movable, dxi, 0.0)

            def substep(carry, _):
                xb, xpb, quats = carry
                v_est = (xb - xpb) / dt
                xe = _exchange_slab(xb, ROWS_AXIS)
                ve = _exchange_slab(v_est, ROWS_AXIS)
                f = jnp.zeros_like(xe)
                for gi, (di, r, k_s, rest) in enumerate(egroups):
                    xn = _nbr(xe, di, r)
                    vn = _nbr(ve, di, r)
                    d = xn - xe
                    length = jnp.sqrt(jnp.sum(d * d, axis=0))
                    nrm = d / jnp.maximum(length, 1e-12)
                    rel = jnp.sum((vn - ve) * nrm, axis=0)
                    fmag = eme[gi] * (k_s * (length - rest) + damping * rel)
                    fo = fmag * nrm
                    f = f + fo - _rev(fo, di, r)
                f = f[:, SLAB_HALO : SLAB_HALO + n_local, :]
                if cfg.wind.drag != 0.0:
                    f = f + _drag_force(cfg, v_est)
                gvec = jnp.asarray(cfg.gravity).astype(xb.dtype).reshape(3, 1, 1)
                accel = gvec + f * imb
                x_new = (xb + (xb - xpb) * (1.0 - cfg.global_damping * dt)
                         + accel * (dt * dt))
                x_new = jnp.where(movable, x_new, xb)
                if use_volume:
                    x_new = x_new + volume_dx_interior(x_new)
                if sm_on:
                    # shape matching after volume, position-only on the
                    # projection solvers (oracle substep_verlet)
                    dxs, quats = _shape_match_slab_dx(
                        x_new, rest3b, quats, smd, cfg, ROWS_AXIS)
                    x_new = x_new + dxs
                if strain_on:
                    # strain limiting before contact, position-only on
                    # the projection solvers (oracle substep_verlet)
                    x_new = x_new + _strain_limit_slab(
                        x_new, sgroups, cfg, we, eme, sl_inv_cnt, n_local,
                        ROWS_AXIS)
                if motion_on:
                    # tethers after strain limiting, before contact
                    x_new = x_new + _tether_dx_planes(
                        x_new, anchors[0], anchors[1], cfg, movable)
                # position-only collide (oracle project_positions_only)
                contact_pf = (x_new[1] < ph[0]) & movable[0]  # pre-clamp
                if cfg.collision.enable_plane:
                    x_new = x_new.at[1].set(
                        jnp.where(contact_pf, ph[0], x_new[1])
                    )
                if cfg.collision.enable_spheres and spheres is not None:
                    centers, radii = spheres
                    for si in range(radii.shape[0]):
                        c = centers[si].reshape(3, 1, 1)
                        d = x_new - c
                        dist = jnp.sqrt(jnp.sum(d * d, axis=0))
                        pen = radii[si] - dist
                        contact = (pen > 0.0) & movable[0]
                        nrm = d / jnp.maximum(dist, 1e-12)
                        x_new = x_new + jnp.where(contact, pen, 0.0) * nrm
                mu = cfg.collision.friction
                if cfg.collision.enable_plane and mu != 0.0:
                    # substep-end plane friction at the pre-clamp mask
                    # (collide.plane_friction_positions twin; static plane)
                    for ax in (0, 2):
                        x_new = x_new.at[ax].set(jnp.where(
                            contact_pf,
                            xb[ax] + (x_new[ax] - xb[ax]) * (1.0 - mu),
                            x_new[ax],
                        ))
                x_new = _sphere_friction_planes(
                    x_new, xb, imb > 0.0, cfg, spheres, mu)
                return (x_new, xb, quats), None

            q0 = quats0 if sm_on else jnp.zeros((1, 4), x3b.dtype)
            (xf, xpf, qf), _ = jax.lax.scan(
                substep, (x3b, xp3b, q0), None, length=n_substeps
            )
            if sm_on:
                return xf, (xf - xpf) / dt, qf
            return xf, (xf - xpf) / dt

        args = (x3, xp3, im3, plane_height, emask, tmask)
        specs = (spec, spec, spec, P(), spec, spec)
        if spheres_on:
            if sphere_centers is None:
                raise ValueError("cfg enables spheres: pass sphere geometry")
            args += (sphere_centers, sphere_radii)
            specs += (P(), P())
        if motion_on:
            args += (tether_anchors, tether_radii)
            specs += (spec, spec)
        if sm_on:
            args += (sm_cid, sm_rest, sm_quats)
            specs += (spec, spec, P())
        out_specs = (spec, spec, P()) if sm_on else (spec, spec)
        return jax.shard_map(
            local, mesh=mesh, in_specs=specs, out_specs=out_specs
        )(*args)

    return sharded_steps


def make_halo_lattice_xpbd_step(top: Topology, cfg: SimConfig, mesh: Mesh):
    """Slab-sharded XPBD stepping for the banded tet lattice: every Jacobi
    sweep exchanges positions AND the per-group lambda planes (the cloth
    XPBD halo's recompute-the-owner trick in 3D), with distance + volume
    compliance constraints and delta-form accumulation (solver/step.py
    substep_xpbd banded twin).  Shape matching, strain limiting and
    motion tethers run after the Jacobi loop, then ONE more contact
    projection so the corrections never leave penetration behind
    (oracle substep_xpbd)."""
    _check_halo_colliders(top, cfg, wind="drag", tear="none", caps="none",
                          sdf="none", strain="sweeps", motion="slabs",
                          sm="slabs")
    if not lattice_halo_applicable(top):
        raise ValueError("topology is not a fully banded uniform lattice")
    n = round(top.n_vertices ** (1.0 / 3.0))
    n_dev = mesh.shape[ROWS_AXIS]
    assert n % n_dev == 0, f"n={n} slabs must divide over {n_dev} devices"
    g = top.offset_groups
    t = top.tet_groups
    egroups = tuple(
        _split_lattice_delta(d, n) + (rest, alpha)
        for d, (_k, rest, alpha) in zip(g.deltas, g.uniform)
    )
    tgroups = tuple(
        (tuple(_split_lattice_delta(d, n) for d in pat), rv)
        for pat, rv in zip(t.deltas, t.uniform_rest_volume)
    )
    omega = cfg.xpbd.relaxation
    n_iter = cfg.xpbd.n_iterations
    spheres_on = cfg.collision.enable_spheres and top.n_spheres > 0
    strain_on = cfg.strain_limit.enabled
    motion_on = cfg.motion.enabled and top.tether_anchor is not None
    sm_on = cfg.shape_match.enabled and top.n_clusters > 0
    n_clusters = int(top.n_clusters)
    sgroups = tuple((di, r, rest) for (di, r, rest, _a) in egroups)
    spec = P(None, ROWS_AXIS, None)

    def sharded_steps(x3, v3, im3, plane_height, emask, tmask, dt,
                      n_substeps, sphere_centers=None, sphere_radii=None,
                      tether_anchors=None, tether_radii=None,
                      sm_cid=None, sm_rest=None, sm_quats=None):
        alpha_ts = [alpha / (dt * dt) for _, _, _, alpha in egroups]
        alpha_v = cfg.xpbd.compliance_volume / (dt * dt)
        if motion_on and tether_anchors is None:
            raise ValueError(
                "cfg enables motion constraints: pass tether_anchors/"
                "tether_radii (shard_motion_slabs(top, mesh))"
            )
        if sm_on and sm_cid is None:
            raise ValueError(
                "cfg enables shape matching: pass sm_cid/sm_rest/"
                "sm_quats (shard_shapematch_slabs(top, mesh))"
            )

        def local(x3b, v3b, imb, ph, emb, tmb, *rest_args):
            i = 0
            spheres = None
            if spheres_on:
                spheres = (rest_args[0], rest_args[1])
                i = 2
            anchors = None
            if motion_on:
                anchors = (rest_args[i], rest_args[i + 1])
                i += 2
            smd = None
            if sm_on:
                cid3b, rest3b, quats0 = (rest_args[i], rest_args[i + 1],
                                         rest_args[i + 2])
                smd = _shape_match_slab_statics(cid3b, imb[0], n_clusters,
                                                ROWS_AXIS)
            n_local = x3b.shape[-2]
            movable = imb > 0.0
            we = _exchange_slab(imb, ROWS_AXIS)[0]
            eme = _exchange_slab(emb, ROWS_AXIS)
            tme = _exchange_slab(tmb, ROWS_AXIS)
            if strain_on:
                sl_inv_cnt = _strain_limit_slab_inv_cnt(sgroups, we, eme,
                                                        n_local)
            # constraint count: owned + owning edges and tet corners
            cnt = jnp.zeros_like(we)
            for gi in range(len(egroups)):
                di, r = egroups[gi][0], egroups[gi][1]
                m = eme[gi]
                cnt = cnt + m + _rev(m, di, r)
            for gi, (corners, _rv) in enumerate(tgroups):
                m = tme[gi]
                cnt = cnt + m
                for (di, r) in corners:
                    cnt = cnt + _rev(m, di, r)
            cnt_inv = omega / jnp.maximum(
                cnt[SLAB_HALO : SLAB_HALO + n_local, :], 1.0
            )

            def substep(carry, _):
                xb, vb, quats = carry
                gvec = jnp.asarray(cfg.gravity).astype(xb.dtype).reshape(3, 1, 1)
                acc = gvec
                if cfg.wind.drag != 0.0:
                    acc = acc + _drag_force(cfg, vb) * imb
                vb = (vb + dt * acc) * (1.0 - cfg.global_damping * dt)
                vb = jnp.where(movable, vb, 0.0)
                x_prev = xb
                delta0 = dt * vb

                def project_contacts(delta, cf):
                    # plane + sphere projection in delta form, recording
                    # the OR'd pre-clamp plane mask for substep-end
                    # friction (shared by the Jacobi loop and the
                    # post-clamp re-projection)
                    if cfg.collision.enable_plane:
                        xe1 = x_prev[1] + delta[1]
                        contact = (xe1 < ph[0]) & movable[0]
                        delta = delta.at[1].set(
                            jnp.where(contact, ph[0] - x_prev[1], delta[1])
                        )
                        cf = jnp.maximum(cf, jnp.where(contact, 1.0, 0.0))
                    if cfg.collision.enable_spheres and spheres is not None:
                        centers, radii = spheres
                        xev = x_prev + delta
                        xproj = xev
                        for si in range(radii.shape[0]):
                            c = centers[si].reshape(3, 1, 1)
                            d = xproj - c
                            dist = jnp.sqrt(jnp.sum(d * d, axis=0))
                            pen = radii[si] - dist
                            contact = (pen > 0.0) & movable[0]
                            nrm = d / jnp.maximum(dist, 1e-12)
                            xproj = xproj + jnp.where(contact, pen, 0.0) * nrm
                        delta = delta + (xproj - xev)
                    return delta, cf

                def iteration(carry_it, _2):
                    delta, lams, lamv, cf = carry_it
                    xe = _exchange_slab(x_prev + delta, ROWS_AXIS)
                    dx = jnp.zeros_like(xe)
                    new_lams = []
                    for gi, (di, r, rest, _alpha) in enumerate(egroups):
                        lam_e = _exchange_slab(lams[gi][None], ROWS_AXIS)[0]
                        xn = _nbr(xe, di, r)
                        d = xn - xe
                        length = jnp.sqrt(jnp.sum(d * d, axis=0))
                        nrm = d / jnp.maximum(length, 1e-12)
                        c_val = length - rest
                        wn = _nbr(we, di, r)
                        denom = jnp.maximum(we + wn + alpha_ts[gi], 1e-12)
                        dlam = -(c_val + alpha_ts[gi] * lam_e) / denom * eme[gi]
                        new_lams.append(
                            dlam[SLAB_HALO : SLAB_HALO + n_local, :] + lams[gi]
                        )
                        dx = dx + (-(we * dlam)) * nrm + _rev((wn * dlam) * nrm, di, r)
                    new_lamv = []
                    for gi, (corners, rv) in enumerate(tgroups):
                        lamv_e = _exchange_slab(lamv[gi][None], ROWS_AXIS)[0]
                        m = tme[gi]
                        p = [_nbr(xe, di, r) for (di, r) in corners]
                        e1, e2, e3 = p[0] - xe, p[1] - xe, p[2] - xe
                        c12 = jnp.stack([
                            e1[1] * e2[2] - e1[2] * e2[1],
                            e1[2] * e2[0] - e1[0] * e2[2],
                            e1[0] * e2[1] - e1[1] * e2[0],
                        ])
                        g1 = jnp.stack([
                            e2[1] * e3[2] - e2[2] * e3[1],
                            e2[2] * e3[0] - e2[0] * e3[2],
                            e2[0] * e3[1] - e2[1] * e3[0],
                        ]) / 6.0
                        g2 = jnp.stack([
                            e3[1] * e1[2] - e3[2] * e1[1],
                            e3[2] * e1[0] - e3[0] * e1[2],
                            e3[0] * e1[1] - e3[1] * e1[0],
                        ]) / 6.0
                        g3 = c12 / 6.0
                        g0 = -(g1 + g2 + g3)
                        vol = jnp.sum(c12 * e3, axis=0) / 6.0
                        c_v = vol - rv
                        wc = [_nbr(we, di, r) for (di, r) in corners]
                        denom = (
                            we * jnp.sum(g0 * g0, axis=0)
                            + wc[0] * jnp.sum(g1 * g1, axis=0)
                            + wc[1] * jnp.sum(g2 * g2, axis=0)
                            + wc[2] * jnp.sum(g3 * g3, axis=0)
                            + alpha_v
                        )
                        dlam_v = -(c_v + alpha_v * lamv_e) / jnp.maximum(
                            denom, 1e-12
                        ) * m
                        new_lamv.append(
                            dlam_v[SLAB_HALO : SLAB_HALO + n_local, :] + lamv[gi]
                        )
                        dx = dx + (we * dlam_v) * g0
                        for ci, gv in zip(range(3), (g1, g2, g3)):
                            di, r = corners[ci]
                            dx = dx + _rev((wc[ci] * dlam_v) * gv, di, r)
                    delta = delta + dx[:, SLAB_HALO : SLAB_HALO + n_local, :] * cnt_inv
                    delta, cf = project_contacts(delta, cf)
                    return (delta, tuple(new_lams), tuple(new_lamv), cf), None

                # zeros derived from sharded input to keep {V:rows} typing
                lams0 = tuple(x3b[0] * 0.0 for _ in egroups)
                lamv0 = tuple(x3b[0] * 0.0 for _ in tgroups)
                cf0 = x3b[0] * 0.0
                (delta, _, _, cff), _ = jax.lax.scan(
                    iteration, (delta0, lams0, lamv0, cf0), None,
                    length=n_iter
                )
                if sm_on or strain_on or motion_on:
                    # shape matching, then strain limiting, then motion
                    # constraints after the Jacobi loop, then ONE more
                    # contact projection so the corrections never leave
                    # penetration behind (oracle substep_xpbd ordering)
                    xev = x_prev + delta
                    if sm_on:
                        dxs, quats = _shape_match_slab_dx(
                            xev, rest3b, quats, smd, cfg, ROWS_AXIS)
                        xev = xev + dxs
                    if strain_on:
                        xev = xev + _strain_limit_slab(
                            xev, sgroups, cfg, we, eme, sl_inv_cnt,
                            n_local, ROWS_AXIS)
                    if motion_on:
                        xev = xev + _tether_dx_planes(
                            xev, anchors[0], anchors[1], cfg, movable)
                    delta = xev - x_prev
                    delta, cff = project_contacts(delta, cff)
                mu = cfg.collision.friction
                if cfg.collision.enable_plane and mu != 0.0:
                    # plane friction ONCE per substep at the OR'd mask
                    # (stencil xpbd twin, delta form; static plane)
                    fric = cff > 0.0
                    for ax in (0, 2):
                        delta = delta.at[ax].set(jnp.where(
                            fric, delta[ax] * (1.0 - mu), delta[ax]))
                xe_f = x_prev + delta
                delta = delta + (
                    _sphere_friction_planes(xe_f, x_prev, movable, cfg,
                                            spheres, mu) - xe_f)
                delta = jnp.where(movable, delta, 0.0)
                return (x_prev + delta, delta / dt, quats), None

            q0 = quats0 if sm_on else jnp.zeros((1, 4), x3b.dtype)
            (xf, vf, qf), _ = jax.lax.scan(
                substep, (x3b, v3b, q0), None, length=n_substeps
            )
            if sm_on:
                return xf, vf, qf
            return xf, vf

        args = (x3, v3, im3, plane_height, emask, tmask)
        specs = (spec, spec, spec, P(), spec, spec)
        if spheres_on:
            if sphere_centers is None:
                raise ValueError("cfg enables spheres: pass sphere geometry")
            args += (sphere_centers, sphere_radii)
            specs += (P(), P())
        if motion_on:
            args += (tether_anchors, tether_radii)
            specs += (spec, spec)
        if sm_on:
            args += (sm_cid, sm_rest, sm_quats)
            specs += (spec, spec, P())
        out_specs = (spec, spec, P()) if sm_on else (spec, spec)
        return jax.shard_map(
            local, mesh=mesh, in_specs=specs, out_specs=out_specs
        )(*args)

    return sharded_steps
