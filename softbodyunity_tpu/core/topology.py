"""Mesh topology: vertices, edges, rest lengths, pinned mask, colliders.

The reference builds its mesh once in ``MonoBehaviour.Start()`` — grid/cube
vertex construction, edge enumeration (structural/shear/bend), rest lengths,
pinned vertices (BASELINE.json:5, :7-:10).  Here topology construction is
host-side NumPy that runs exactly once; the resulting arrays are moved to HBM
by :func:`softbodyunity_tpu.api.init` and never touched by the host again
("mesh topology ... is loaded once to HBM", BASELINE.json:5).

Details baked in at build time:

* A CSR-style *incidence table* ``incident[N, D]`` / ``incident_sign[N, D]``
  so force accumulation can be a race-free per-vertex **gather** instead of a
  per-edge scatter-add (SURVEY.md §7 "hard parts"; same trick as the GPU
  elastodynamics literature, PAPERS.md:7-8).
* Edge endpoints are also emitted sorted by first endpoint so a
  ``segment_sum`` fallback touches memory contiguously.
* Optional ``grid_shape`` metadata: structured cloth grids additionally
  support a stencil (shift) force path with zero gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import jax

EDGE_STRUCTURAL = 0
EDGE_SHEAR = 1
EDGE_BEND = 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Topology:
    """Static scene description (pytree; all array leaves, static metadata aux).

    Shapes: N vertices, E edges, D max vertex degree, T tets, F triangles,
    S spheres.  All float arrays are float32 on device (BASELINE.json:5
    "SoA float32 particle arrays"); builders produce float64 NumPy for the
    oracle, downcast in :func:`softbodyunity_tpu.api.init`.
    """

    # --- spring / constraint structure -----------------------------------
    edges: jax.Array            # i32[E, 2]  endpoint vertex ids (a, b)
    rest_length: jax.Array      # f32[E]
    edge_class: jax.Array       # i32[E]     EDGE_STRUCTURAL / SHEAR / BEND
    edge_stiffness: jax.Array   # f32[E]     per-edge spring k (class-resolved)
    edge_compliance: jax.Array  # f32[E]     per-edge XPBD alpha (class-resolved)
    # --- vertex data ------------------------------------------------------
    inv_mass: jax.Array         # f32[N]     0.0 for pinned vertices
    # --- incidence (gather-based accumulation) ----------------------------
    incident: jax.Array         # i32[N, D]  edge ids incident to vertex (pad=E)
    incident_sign: jax.Array    # f32[N, D]  +1 if vertex is edge.a, -1 if edge.b, 0 pad
    # --- volumetric (empty for cloth) -------------------------------------
    tets: jax.Array             # i32[T, 4]
    rest_volume: jax.Array      # f32[T]
    # --- rendering --------------------------------------------------------
    triangles: jax.Array        # i32[F, 3]  for vertex-normal recompute
    # --- collider geometry (array data => can vary per batched scene) -----
    plane_height: jax.Array     # f32[]      ground plane y
    sphere_centers: jax.Array   # f32[S, 3]
    sphere_radii: jax.Array     # f32[S]
    # --- offset-grouped (banded) spring/tet planes; None disables --------
    offset_groups: object = None  # Optional[solver.banded.OffsetGroups]
    tet_groups: object = None     # Optional[solver.banded.TetGroups]
    # --- capsule / box colliders (Unity CapsuleCollider / BoxCollider
    #     analogues; same movable-array-data contract as the spheres) -----
    capsule_p0: jax.Array = None      # f32[C, 3] segment endpoint 0
    capsule_p1: jax.Array = None      # f32[C, 3] segment endpoint 1
    capsule_radii: jax.Array = None   # f32[C]
    box_centers: jax.Array = None     # f32[B, 3]
    box_half_extents: jax.Array = None  # f32[B, 3] half sizes along local axes
    box_rotations: jax.Array = None   # f32[B, 3, 3] world-from-local (columns
    #                                   = the box's local axes in world space)
    # --- mesh (SDF) colliders: baked signed-distance grids (core/sdf.py);
    #     grids are static bakes, origins are movable array data ----------
    sdf_grids: jax.Array = None       # f32[Sg, gx, gy, gz]
    sdf_origins: jax.Array = None     # f32[Sg, 3] world position of voxel 0
    sdf_spacings: jax.Array = None    # f32[Sg]    cubic voxel edge length
    # --- pressure bodies (closed-shell gas volumes; None = no pressure;
    #     see enable_pressure / PressureParams) ---------------------------
    tri_body: jax.Array = None            # i32[F] pressure-body id per
    #                                       triangle (-1 = not enclosed)
    pressure_rest_volume: jax.Array = None  # f32[P] rest gas volume per body
    # --- kinematic collider velocities (always materialized — zeros when
    #     static — so animating them never changes the pytree structure and
    #     never recompiles; contact response is relative to these) --------
    plane_velocity: jax.Array = None      # f32[3] plane SURFACE velocity
    sphere_velocities: jax.Array = None   # f32[S, 3]
    capsule_velocities: jax.Array = None  # f32[C, 3]
    box_velocities: jax.Array = None      # f32[B, 3]
    sdf_velocities: jax.Array = None      # f32[Sg, 3]
    # --- rigid attachments (cloth vertices welded to a rigid sphere's
    #     body frame; only read by the coupled solvers — see attach /
    #     solver.rigid.step_coupled) ---------------------------------------
    attach_ids: jax.Array = None      # i32[A] cloth vertex ids
    attach_body: jax.Array = None     # i32[A] sphere index per attachment
    attach_local: jax.Array = None    # f32[A, 3] attachment point in the
    #                                   body frame (identity orientation
    #                                   at build time)
    # --- box attachments (welds to a dynamic BOX's body frame; local is
    #     expressed in the box's build-pose axes R0, world point =
    #     bc + R(q) R0 local — see attach_box) ----------------------------
    attach_box_ids: jax.Array = None    # i32[Ab]
    attach_box_body: jax.Array = None   # i32[Ab] box index
    attach_box_local: jax.Array = None  # f32[Ab, 3]
    # --- rigid-rigid joints (add_rigid_joint; body refs live in the
    #     static joint_meta below, anchors here as movable array data) ----
    joint_local_a: jax.Array = None   # f32[J, 3] anchor in body a's frame
    #                                   (the world POINT for a world side)
    joint_local_b: jax.Array = None   # f32[J, 3]
    joint_axis_a: jax.Array = None    # f32[J, 3] hinge axis, body a frame
    joint_axis_b: jax.Array = None    # f32[J, 3]
    joint_rest: jax.Array = None      # f32[J] distance-joint rest length
    joint_compliance: jax.Array = None  # f32[J] XPBD compliance (distance)
    joint_ref_a: jax.Array = None     # f32[J, 3] hinge angle reference
    joint_ref_b: jax.Array = None     # f32[J, 3]
    joint_limit: jax.Array = None     # f32[J, 2] (lo, hi) rad; lo>hi = off
    joint_motor: jax.Array = None     # f32[J, 2] (rad/s, max torque)
    # --- shape-matching clusters (enable_shape_matching; None = off;
    #     behaviour set by ShapeMatchParams) -------------------------------
    cluster_id: jax.Array = None      # i32[N] cluster per vertex (-1 = none)
    cluster_rest: jax.Array = None    # f32[N, 3] rest offset from the
    #                                   cluster's mass-weighted rest centroid
    #                                   (zeros for non-members / pinned)
    # Kronecker factors of the cluster field on a raster lattice (built
    # host-side in api.device_topology via shapematch.kron_factors_host;
    # None when clusters are not raster-separable): per-axis one-hots +
    # the occupied-cell -> cluster map.  Enables the near-zero-traffic
    # per-axis shape-match reductions (solver/shapematch.py)
    cluster_kron_x: jax.Array = None    # f32[nx, ncx]
    cluster_kron_y: jax.Array = None    # f32[ny, ncy]
    cluster_kron_z: jax.Array = None    # f32[nz, ncz]
    cluster_kron_cells: jax.Array = None  # f32[ncx*ncy*ncz, K]
    # --- per-vertex motion constraints (Unity Cloth maxDistance; None =
    #     none; see set_motion_constraints / MotionConstraintParams;
    #     anchors are movable array data — animate with api.move_tethers) --
    tether_anchor: jax.Array = None   # f32[N, 3] tether sphere centers
    tether_radius: jax.Array = None   # f32[N]    max distance (inf = free)
    # --- static metadata (aux / hashable) ---------------------------------
    n_clusters: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_vertices: int = dataclasses.field(metadata=dict(static=True), default=0)
    grid_shape: Optional[Tuple[int, int]] = dataclasses.field(
        metadata=dict(static=True), default=None
    )  # (ny, nx) when the mesh is a structured cloth grid
    grid_spacing: Optional[float] = dataclasses.field(
        metadata=dict(static=True), default=None
    )  # uniform rest spacing of the grid (enables the stencil fast path)
    lattice_shape: Optional[Tuple[int, int, int]] = dataclasses.field(
        metadata=dict(static=True), default=None
    )  # (nx, ny, nz) raster dims when the body is a regular lattice with
    #    vid(i,j,k) = (i*ny + j)*nz + k (tet_cube / lattice_from_mesh);
    #    enables raster-separable (Kronecker) shape-match reductions
    edge_classes_present: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True), default=(0,)
    )  # which spring classes the edge list contains (static, for dispatch)
    joint_meta: Optional[Tuple] = dataclasses.field(
        metadata=dict(static=True), default=None
    )  # per joint (jtype, kind_a, idx_a, kind_b, idx_b); static so the
    #    coupled solvers unroll over concrete body refs

    @property
    def n_edges(self) -> int:
        return self.edges.shape[0]

    @property
    def n_tets(self) -> int:
        return self.tets.shape[0]

    @property
    def n_spheres(self) -> int:
        return self.sphere_radii.shape[0]

    @property
    def n_capsules(self) -> int:
        return 0 if self.capsule_radii is None else self.capsule_radii.shape[0]

    @property
    def n_boxes(self) -> int:
        return 0 if self.box_centers is None else self.box_centers.shape[0]

    @property
    def n_sdfs(self) -> int:
        return 0 if self.sdf_grids is None else self.sdf_grids.shape[0]

    @property
    def n_pressure_bodies(self) -> int:
        return (0 if self.pressure_rest_volume is None
                else self.pressure_rest_volume.shape[0])

    @property
    def n_attachments(self) -> int:
        return 0 if self.attach_ids is None else self.attach_ids.shape[0]

    @property
    def n_box_attachments(self) -> int:
        return (0 if self.attach_box_ids is None
                else self.attach_box_ids.shape[0])

    @property
    def n_joints(self) -> int:
        return 0 if self.joint_meta is None else len(self.joint_meta)


def _build_incidence(n: int, edges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vertex -> incident-edge table, padded to the max degree.

    Padding entries point at edge id E (one past the end); callers append a
    zero "ghost" force row so padded gathers contribute nothing.  Fully
    vectorized (a python-loop version took 7 s alone at 262k vertices);
    per-vertex entries are ordered by edge id, exactly the order the loop
    formulation produced.
    """
    e = edges.shape[0]
    if e == 0 or n == 0:
        return (np.full((n, 1), e, dtype=np.int32),
                np.zeros((n, 1), dtype=np.float64))
    ends = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int64)
    eids = np.concatenate([np.arange(e), np.arange(e)])
    signs = np.concatenate([np.ones(e), -np.ones(e)])
    order = np.lexsort((eids, ends))          # by vertex, then edge id
    ends_s, eids_s, signs_s = ends[order], eids[order], signs[order]
    counts = np.bincount(ends, minlength=n)
    d = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(2 * e) - starts[ends_s]  # position within the group
    incident = np.full((n, d), e, dtype=np.int32)
    sign = np.zeros((n, d), dtype=np.float64)
    incident[ends_s, slot] = eids_s
    sign[ends_s, slot] = signs_s
    return incident, sign


def _edge_arrays(
    edge_list,
    positions: np.ndarray,
    springs,
    xpbd,
) -> Tuple[np.ndarray, ...]:
    """Pack (a, b, class) triples — a list of tuples or an i64[E, 3]
    array — into sorted topology arrays."""
    if isinstance(edge_list, np.ndarray):
        triples = edge_list.astype(np.int64, copy=False)
    else:
        # np.array() on millions of tuples is pathologically slow;
        # fromiter over the flattened stream is ~10x faster
        import itertools

        triples = np.fromiter(
            itertools.chain.from_iterable(edge_list), np.int64,
            count=3 * len(edge_list),
        ).reshape(-1, 3)
    edges = triples[:, :2]
    cls = triples[:, 2]
    # sort by first endpoint for contiguous segment_sum fallback
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    edges, cls = edges[order], cls[order]
    rest = np.linalg.norm(positions[edges[:, 1]] - positions[edges[:, 0]], axis=1)
    k_by_class = np.array(
        [springs.k_structural, springs.k_shear, springs.k_bend], dtype=np.float64
    )
    a_by_class = np.array(
        [xpbd.compliance_distance, xpbd.compliance_distance, xpbd.compliance_bend],
        dtype=np.float64,
    )
    return (
        edges.astype(np.int32),
        rest,
        cls.astype(np.int32),
        k_by_class[cls],
        a_by_class[cls],
    )


@dataclasses.dataclass
class HostTopology:
    """float64 NumPy twin of :class:`Topology`, consumed by the oracle and by
    :func:`softbodyunity_tpu.api.init` (which downcasts to f32 and device_puts).
    """

    positions0: np.ndarray      # f64[N, 3] rest positions (initial state)
    edges: np.ndarray
    rest_length: np.ndarray
    edge_class: np.ndarray
    edge_stiffness: np.ndarray
    edge_compliance: np.ndarray
    inv_mass: np.ndarray
    incident: np.ndarray
    incident_sign: np.ndarray
    tets: np.ndarray
    rest_volume: np.ndarray
    triangles: np.ndarray
    plane_height: float
    sphere_centers: np.ndarray
    sphere_radii: np.ndarray
    grid_shape: Optional[Tuple[int, int]]
    grid_spacing: Optional[float] = None
    edge_classes_present: Tuple[int, ...] = (0,)
    # capsule / box colliders (None = none; see add_colliders)
    capsule_p0: Optional[np.ndarray] = None       # f64[C, 3]
    capsule_p1: Optional[np.ndarray] = None       # f64[C, 3]
    capsule_radii: Optional[np.ndarray] = None    # f64[C]
    box_centers: Optional[np.ndarray] = None      # f64[B, 3]
    box_half_extents: Optional[np.ndarray] = None  # f64[B, 3]
    box_rotations: Optional[np.ndarray] = None    # f64[B, 3, 3]
    # mesh (SDF) colliders (None = none; see add_colliders / core/sdf.py)
    sdf_grids: Optional[np.ndarray] = None        # f64[Sg, gx, gy, gz]
    sdf_origins: Optional[np.ndarray] = None      # f64[Sg, 3]
    sdf_spacings: Optional[np.ndarray] = None     # f64[Sg]
    # pressure bodies (None = none; see enable_pressure): per-triangle
    # body id (-1 = triangle encloses no gas) + per-body rest volume
    tri_body: Optional[np.ndarray] = None             # i64[F]
    pressure_rest_volume: Optional[np.ndarray] = None  # f64[P]
    # BFS reorder bookkeeping (from_triangle_mesh / from_tet_mesh with
    # reorder=True): new id of input vertex i is old_to_new[i]; None when
    # the input ordering was kept.  Map caller-side ids (stitch, anchor,
    # pins) through this before using them on the built topology.
    old_to_new: Optional[np.ndarray] = None           # i64[N]
    # kinematic collider velocities (None = static; see set_collider_velocities):
    # contact friction/restitution act on the velocity RELATIVE to the
    # collider, so a dragged sphere carries the cloth and a plane with a
    # surface velocity is a conveyor belt.  Geometry itself is animated
    # separately (api.move_colliders) — these only shape the contact
    # response on the velocity-level (Euler) paths.
    plane_velocity: Optional[np.ndarray] = None       # f64[3] surface velocity
    sphere_velocities: Optional[np.ndarray] = None    # f64[S, 3]
    capsule_velocities: Optional[np.ndarray] = None   # f64[C, 3]
    box_velocities: Optional[np.ndarray] = None       # f64[B, 3]
    sdf_velocities: Optional[np.ndarray] = None       # f64[Sg, 3]
    # rigid attachments (None = none; see attach): cloth vertices welded
    # to a point in a rigid sphere's body frame, resolved by the coupled
    # solvers (solver/rigid.py)
    attach_ids: Optional[np.ndarray] = None           # i64[A]
    attach_body: Optional[np.ndarray] = None          # i64[A]
    attach_local: Optional[np.ndarray] = None         # f64[A, 3]
    # box attachments (attach_box): welds to a dynamic box's body frame
    attach_box_ids: Optional[np.ndarray] = None       # i64[Ab]
    attach_box_body: Optional[np.ndarray] = None      # i64[Ab]
    attach_box_local: Optional[np.ndarray] = None     # f64[Ab, 3]
    # rigid-rigid joints (None = none; see add_rigid_joint): Unity
    # FixedJoint-anchor / HingeJoint / SpringJoint analogues between
    # DYNAMIC rigid bodies (spheres/boxes promoted by make_rigid_state)
    # and/or the world, resolved by the coupled solvers.  joint_meta is
    # one static record per joint: (jtype, kind_a, idx_a, kind_b, idx_b)
    # with jtype in {"ball", "hinge", "distance"} and kind in {"sphere",
    # "box", "world"}; the arrays carry the (movable) anchor data.
    joint_meta: Optional[Tuple] = None                # static, len J
    joint_local_a: Optional[np.ndarray] = None        # f64[J, 3] anchor in
    #                                  body a's frame (world point for a
    #                                  "world" side)
    joint_local_b: Optional[np.ndarray] = None        # f64[J, 3]
    joint_axis_a: Optional[np.ndarray] = None         # f64[J, 3] hinge axis
    #                                  in body a's frame (zeros otherwise)
    joint_axis_b: Optional[np.ndarray] = None         # f64[J, 3]
    joint_rest: Optional[np.ndarray] = None           # f64[J] distance rest
    joint_compliance: Optional[np.ndarray] = None     # f64[J] XPBD
    #                                  compliance (distance joints only)
    joint_ref_a: Optional[np.ndarray] = None          # f64[J, 3] hinge
    #                                  angle reference (perp to axis),
    #                                  body a's frame
    joint_ref_b: Optional[np.ndarray] = None          # f64[J, 3]
    joint_limit: Optional[np.ndarray] = None          # f64[J, 2] hinge
    #                                  angle (lo, hi) rad; lo > hi = off
    joint_motor: Optional[np.ndarray] = None          # f64[J, 2] hinge
    #                                  motor (target rad/s, max torque);
    #                                  max torque 0 = off
    # shape-matching clusters (None = none; see enable_shape_matching):
    # per-vertex cluster id (-1 = no cluster) + rest offset from the
    # cluster's mass-weighted rest centroid; behaviour set by
    # ShapeMatchParams
    cluster_id: Optional[np.ndarray] = None           # i64[N]
    cluster_rest: Optional[np.ndarray] = None         # f64[N, 3]
    n_clusters: int = 0
    # per-vertex motion constraints (None = none; see
    # set_motion_constraints): tether sphere anchor + max distance per
    # vertex (inf = unconstrained); behaviour set by MotionConstraintParams
    tether_anchor: Optional[np.ndarray] = None        # f64[N, 3]
    tether_radius: Optional[np.ndarray] = None        # f64[N]
    # raster dims (nx, ny, nz) when the body is a regular lattice with
    # vid(i,j,k) = (i*ny + j)*nz + k (set by tet_cube / lattice_from_mesh;
    # None for general topologies and merged scenes)
    lattice_shape: Optional[Tuple[int, int, int]] = None


def add_colliders(
    host: HostTopology,
    *,
    capsule_p0=None,
    capsule_p1=None,
    capsule_radii=None,
    box_centers=None,
    box_half_extents=None,
    box_rotations=None,
    sdf_grids=None,
    sdf_origins=None,
    sdf_spacings=None,
    plane_velocity=None,
    sphere_velocities=None,
    capsule_velocities=None,
    box_velocities=None,
    sdf_velocities=None,
) -> HostTopology:
    """Attach capsule / box / mesh(SDF) colliders to any built topology (the
    analogue of adding a Unity CapsuleCollider / BoxCollider / MeshCollider
    to the scene).

    Capsules are segments ``p0 -> p1`` with a radius; boxes are oriented
    boxes given by center, per-axis half extents, and a world-from-local
    rotation matrix (columns = the box's local axes in world space;
    defaults to identity = axis-aligned).  Mesh colliders are baked signed
    distance grids from :func:`softbodyunity_tpu.core.sdf.sdf_from_mesh`:
    pass one or more ``(grid, origin, spacing)`` bakes as stacked arrays
    (all grids in a scene must share voxel dimensions).  Enable resolution
    with ``CollisionParams(enable_capsules=True)`` / ``enable_boxes=True``
    / ``enable_sdf=True``.
    """
    caps_args = (capsule_p0, capsule_p1, capsule_radii)
    if any(a is not None for a in caps_args) and any(
            a is None for a in caps_args):
        # a partial capsule spec silently attaching nothing means the cloth
        # falls straight through where the user placed a collider
        raise ValueError(
            "capsules need all of capsule_p0, capsule_p1, capsule_radii"
        )
    if (box_half_extents is not None or box_rotations is not None) \
            and box_centers is None:
        raise ValueError(
            "boxes need box_centers (with box_half_extents; box_rotations "
            "defaults to identity)"
        )
    if box_centers is not None and box_half_extents is None:
        raise ValueError("boxes need box_half_extents")
    if capsule_radii is not None:
        host.capsule_p0 = np.asarray(capsule_p0, np.float64).reshape(-1, 3)
        host.capsule_p1 = np.asarray(capsule_p1, np.float64).reshape(-1, 3)
        host.capsule_radii = np.asarray(capsule_radii, np.float64).reshape(-1)
        if not (host.capsule_p0.shape[0] == host.capsule_p1.shape[0]
                == host.capsule_radii.shape[0]):
            # on device a mismatched count silently CLAMPS out-of-range
            # indices (jit gather semantics) => a phantom collider at the
            # wrong geometry, with no error anywhere downstream
            raise ValueError(
                f"capsule_p0/p1/radii row counts disagree: "
                f"{host.capsule_p0.shape[0]}/{host.capsule_p1.shape[0]}/"
                f"{host.capsule_radii.shape[0]}"
            )
    if box_centers is not None:
        host.box_centers = np.asarray(box_centers, np.float64).reshape(-1, 3)
        host.box_half_extents = np.asarray(
            box_half_extents, np.float64
        ).reshape(-1, 3)
        if host.box_half_extents.shape[0] != host.box_centers.shape[0]:
            raise ValueError(
                f"box_centers/half_extents row counts disagree: "
                f"{host.box_centers.shape[0]}/"
                f"{host.box_half_extents.shape[0]}"
            )
        nb = host.box_centers.shape[0]
        if box_rotations is None:
            host.box_rotations = np.broadcast_to(
                np.eye(3), (nb, 3, 3)
            ).copy()
        else:
            host.box_rotations = np.asarray(
                box_rotations, np.float64
            ).reshape(-1, 3, 3)
            if host.box_rotations.shape[0] != nb:
                raise ValueError(
                    f"box_rotations rows ({host.box_rotations.shape[0]}) "
                    f"must match box_centers ({nb})"
                )
    if sdf_grids is not None:
        g = np.asarray(sdf_grids, np.float64)
        if g.ndim == 3:
            g = g[None]
        if g.ndim != 4:
            raise ValueError("sdf_grids must be [gx,gy,gz] or [S,gx,gy,gz]")
        if sdf_origins is None or sdf_spacings is None:
            raise ValueError(
                "sdf colliders need all of sdf_grids, sdf_origins, "
                "sdf_spacings (from core.sdf.sdf_from_mesh)"
            )
        host.sdf_grids = g
        host.sdf_origins = np.asarray(
            sdf_origins, np.float64).reshape(-1, 3)
        host.sdf_spacings = np.asarray(
            sdf_spacings, np.float64).reshape(-1)
        if not (host.sdf_origins.shape[0] == g.shape[0]
                == host.sdf_spacings.shape[0]):
            raise ValueError("sdf_grids / sdf_origins / sdf_spacings "
                             "leading dimensions disagree")
    # kinematic collider velocities: contact friction/restitution act on
    # the velocity RELATIVE to the collider (see Topology *_velocities)
    if plane_velocity is not None:
        host.plane_velocity = np.asarray(
            plane_velocity, np.float64).reshape(3)
    for name, vel, count in (
        ("sphere_velocities", sphere_velocities,
         np.asarray(host.sphere_radii).shape[0]),
        ("capsule_velocities", capsule_velocities,
         0 if host.capsule_radii is None else host.capsule_radii.shape[0]),
        ("box_velocities", box_velocities,
         0 if host.box_centers is None else host.box_centers.shape[0]),
        ("sdf_velocities", sdf_velocities,
         0 if host.sdf_spacings is None else host.sdf_spacings.shape[0]),
    ):
        if vel is not None:
            v = np.asarray(vel, np.float64).reshape(-1, 3)
            if v.shape[0] != count:
                raise ValueError(
                    f"{name} rows ({v.shape[0]}) must match the collider "
                    f"count ({count})"
                )
            setattr(host, name, v)
    return host


def _signed_volume(positions: np.ndarray, tris: np.ndarray) -> float:
    """Signed enclosed volume of a triangle soup (divergence theorem)."""
    if tris.shape[0] == 0:
        return 0.0
    a = positions[tris[:, 0]]
    b = positions[tris[:, 1]]
    c = positions[tris[:, 2]]
    return float(np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6.0)


def enable_pressure(host: HostTopology, triangle_ids=None) -> HostTopology:
    """Turn a closed triangle shell into a gas-filled pressure body (the
    Unity "inflatable" / balloon soft body; behaviour set by
    :class:`~softbodyunity_tpu.core.config.PressureParams`).

    ``triangle_ids`` selects the shell (default: every triangle — the
    whole body).  The shell must be CLOSED (every undirected edge shared
    by exactly two of the selected triangles): the enclosed volume and
    the zero-net-force property only exist for closed surfaces.  Winding
    is canonicalized so the enclosed volume is positive (outward normals)
    — flipped triangles are rewound in ``host.triangles`` itself, which
    also fixes rendering normals.

    Call once per body BEFORE :func:`merge_bodies`; merging offsets the
    body ids, so each balloon in a multi-body scene keeps its own
    independent gas volume.  Enable the force with
    ``SimConfig(pressure=PressureParams(enabled=True, ...))``.
    """
    tris = np.asarray(host.triangles, np.int64)
    f = tris.shape[0]
    sel = (np.arange(f) if triangle_ids is None
           else np.asarray(triangle_ids, np.int64).reshape(-1))
    if sel.size == 0:
        raise ValueError("enable_pressure: empty triangle selection")
    # closedness AND consistent orientation: every DIRECTED edge of the
    # shell must appear exactly once, with its reverse also present.  An
    # undirected count would accept a shell with one face wound backwards
    # — whose "enclosed volume" is wrong and whose net pressure force is
    # NONZERO (the balloon would inject momentum and self-accelerate).
    shell = tris[sel]
    dir_edges = np.concatenate([shell[:, [0, 1]], shell[:, [1, 2]],
                                shell[:, [2, 0]]])
    n_all = int(dir_edges.max()) + 1
    fwd = dir_edges[:, 0] * n_all + dir_edges[:, 1]
    rev = dir_edges[:, 1] * n_all + dir_edges[:, 0]
    uniq, counts = np.unique(fwd, return_counts=True)
    if (counts != 1).any():
        raise ValueError(
            "enable_pressure: shell is not a closed oriented surface "
            f"({int((counts != 1).sum())} directed edges repeat — "
            "non-manifold or doubled faces)"
        )
    missing = np.setdiff1d(rev, fwd, assume_unique=False)
    if missing.size:
        raise ValueError(
            "enable_pressure: shell is not closed with consistent winding "
            f"({missing.size} edges have no opposing twin — an open "
            "boundary or a face wound backwards); fix the mesh orientation"
        )
    v0 = _signed_volume(host.positions0, shell)
    if abs(v0) < 1e-12:
        raise ValueError("enable_pressure: shell encloses zero volume")
    if v0 < 0.0:
        # inward winding: flip the shell (also fixes rendering normals)
        tris = tris.copy()
        tris[sel] = tris[sel][:, [0, 2, 1]]
        host.triangles = tris.astype(host.triangles.dtype)
        v0 = -v0
    body = (np.full(f, -1, np.int64) if host.tri_body is None
            else np.asarray(host.tri_body, np.int64).copy())
    if (body[sel] >= 0).any():
        raise ValueError("enable_pressure: selection overlaps an existing "
                         "pressure body")
    vols = (np.zeros((0,), np.float64) if host.pressure_rest_volume is None
            else np.asarray(host.pressure_rest_volume, np.float64))
    body[sel] = vols.shape[0]
    host.tri_body = body
    host.pressure_rest_volume = np.concatenate([vols, [v0]])
    return host


def enable_shape_matching(host: HostTopology, cluster_ids=None, *,
                          cell_size: "float | None" = None) -> HostTopology:
    """Turn any built body into a shape-matching soft body (Muller-style
    meshless deformation — the classic Unity "jelly" component next to
    mass-spring and pressure; behaviour set by
    :class:`~softbodyunity_tpu.core.config.ShapeMatchParams`).

    Cluster assignment, one of:

    * default (both args None): ONE cluster over every vertex — the whole
      body remembers its rest shape (rubbery-rigid jelly);
    * ``cluster_ids`` i64[N]: explicit per-vertex cluster ids, compact in
      ``[0, K)``; ``-1`` leaves a vertex out of shape matching entirely;
    * ``cell_size``: spatial clustering — vertices are grouped by the
      rest-position voxel of edge ``cell_size`` they fall in (smaller
      cells = softer, more local shape memory).

    Weights are the build masses ``1/inv_mass`` over each cluster's
    MOVABLE vertices; pinned vertices never participate (they are held by
    the pin, and excluding them keeps ``sum m_i q_i = 0`` so shape
    matching conserves linear momentum exactly).  Every cluster must keep
    at least one movable vertex (a fully pinned cluster has no degrees of
    freedom to match).  Call BEFORE :func:`merge_bodies`; merging offsets
    the cluster ids so each body keeps independent clusters.  Enable the
    force with ``SimConfig(shape_match=ShapeMatchParams(enabled=True))``.
    """
    n = host.positions0.shape[0]
    if cluster_ids is not None and cell_size is not None:
        raise ValueError(
            "enable_shape_matching: pass cluster_ids OR cell_size, not both")
    if cell_size is not None:
        if cell_size <= 0.0:
            raise ValueError("enable_shape_matching: cell_size must be > 0")
        # cluster only MOVABLE vertices: pinned/ghost vertices never
        # participate, and a pinned-only voxel must not become an (empty)
        # cluster — e.g. lattice_from_mesh rasters carry ~50% frozen
        # ghosts outside the mesh
        movable = np.asarray(host.inv_mass, np.float64) > 0.0
        if not movable.any():
            raise ValueError("enable_shape_matching: no movable vertices")
        cells = np.floor(np.asarray(host.positions0, np.float64)
                         / float(cell_size)).astype(np.int64)
        _, inv = np.unique(cells[movable], axis=0, return_inverse=True)
        cid = np.full(n, -1, np.int64)
        cid[movable] = inv.astype(np.int64)
    elif cluster_ids is None:
        cid = np.zeros(n, np.int64)
    else:
        cid = np.asarray(cluster_ids, np.int64).reshape(-1)
        if cid.shape[0] != n:
            raise ValueError(
                f"enable_shape_matching: cluster_ids has {cid.shape[0]} "
                f"entries for {n} vertices")
    member = cid >= 0
    if not member.any():
        raise ValueError("enable_shape_matching: no cluster members")
    k = int(cid[member].max()) + 1
    inv_m = np.asarray(host.inv_mass, np.float64)
    m = np.where((inv_m > 0.0) & member, 1.0 / np.maximum(inv_m, 1e-30), 0.0)
    mass_k = np.zeros(k)
    np.add.at(mass_k, cid[member], m[member])
    if (mass_k <= 0.0).any():
        bad = int((mass_k <= 0.0).sum())
        raise ValueError(
            f"enable_shape_matching: {bad} cluster id(s) in [0, {k}) have "
            "no movable mass (empty label or fully pinned cluster); use "
            "compact ids and keep at least one movable vertex per cluster")
    cx = np.zeros((k, 3))
    np.add.at(cx, cid[member], m[member, None]
              * np.asarray(host.positions0, np.float64)[member])
    c0 = cx / mass_k[:, None]
    q = np.zeros((n, 3))
    part = m > 0.0
    q[part] = np.asarray(host.positions0, np.float64)[part] - c0[cid[part]]
    host.cluster_id = cid
    host.cluster_rest = q
    host.n_clusters = k
    return host


def set_motion_constraints(host: HostTopology, max_distance, *,
                           anchors=None, indices=None) -> HostTopology:
    """Tether vertices inside spheres around anchor points — the Unity
    Cloth ``maxDistance`` motion constraint (painted per-vertex in the
    editor; the workhorse of character cloth: simulate freely, never
    leave the animated body by more than the painted slack).

    * ``max_distance``: scalar or per-vertex f64 radii; ``np.inf`` leaves
      a vertex unconstrained.
    * ``anchors`` f64[N,3] (default: the rest positions) — the tether
      sphere centers.  Animate per frame with :func:`api.move_tethers`
      (array data, zero recompiles) to follow a skinned body.
    * ``indices``: constrain only these vertex ids (scalar
      ``max_distance`` broadcast over them; everything else ``inf``).

    Enable with ``SimConfig(motion=MotionConstraintParams(enabled=True,
    scale=...))``; semantics in :class:`MotionConstraintParams` /
    ``oracle/reference.py::tether_dx``.  Call after any BFS-reordering
    builder (ids are final) and before :func:`merge_bodies` only if every
    merged body carries constraints (merge keeps per-body arrays)."""
    n = host.positions0.shape[0]
    r = np.asarray(max_distance, np.float64)
    if indices is not None:
        ids = np.asarray(indices, np.int64).reshape(-1)
        if r.ndim == 0:
            r = np.broadcast_to(r, ids.shape)
        elif r.shape != ids.shape:
            raise ValueError(
                "set_motion_constraints: per-vertex max_distance must "
                "match indices")
        full = np.full(n, np.inf)
        full[ids] = r
        r = full
    elif r.ndim == 0:
        r = np.full(n, float(r))
    elif r.shape != (n,):
        raise ValueError(
            f"set_motion_constraints: max_distance has {r.shape[0]} "
            f"entries for {n} vertices")
    if (r < 0.0).any():
        raise ValueError("set_motion_constraints: max_distance must be >= 0")
    a = (np.array(host.positions0, np.float64) if anchors is None
         else np.asarray(anchors, np.float64))
    if a.shape != (n, 3):
        raise ValueError(
            f"set_motion_constraints: anchors shape {a.shape} != ({n}, 3)")
    host.tether_anchor = a
    host.tether_radius = np.asarray(r, np.float64)
    return host


def icosphere_mesh(radius: float = 0.5, subdivisions: int = 2,
                   center=(0.0, 0.0, 0.0)):
    """Closed icosphere shell ``(positions f64[N,3], triangles i64[F,3])``
    with outward winding — the standard balloon / inflatable geometry.
    Feed to :func:`from_triangle_mesh` + :func:`enable_pressure`.
    subdivisions 0/1/2/3 -> 12/42/162/642 vertices."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        (-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
        (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
        (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1),
    ], np.float64)
    verts /= np.linalg.norm(verts[0])
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    for _ in range(subdivisions):
        mid: dict = {}
        vlist = list(verts)

        def midpoint(u, v):
            key = (min(u, v), max(u, v))
            if key not in mid:
                m = vlist[u] + vlist[v]
                vlist.append(m / np.linalg.norm(m))
                mid[key] = len(vlist) - 1
            return mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                          (ab, bc, ca)]
        faces = new_faces
        verts = np.asarray(vlist)
    pos = verts * radius + np.asarray(center, np.float64)[None, :]
    tris = np.asarray(faces, np.int64)
    if _signed_volume(pos, tris) < 0:
        tris = tris[:, [0, 2, 1]]
    return pos, tris


def terrain_mesh(heights, spacing: float = 1.0, origin=(0.0, 0.0, 0.0),
                 base_depth: Optional[float] = None):
    """Closed terrain block from a heightfield — the Unity Terrain-collider
    analogue: ``(positions f64[2HW,3], triangles i64[F,3])``, watertight
    (top surface + skirt walls + flat bottom) with outward winding, ready
    for :func:`softbodyunity_tpu.core.sdf.sdf_from_mesh` (collision) or
    :func:`from_triangle_mesh` (a deformable terrain sheet from the top
    half).  ``heights`` is f64[H, W] of y values sampled on an xz grid of
    pitch ``spacing``; the bottom sits ``base_depth`` below the lowest
    sample (default: one grid pitch)."""
    h = np.asarray(heights, np.float64)
    if h.ndim != 2 or h.shape[0] < 2 or h.shape[1] < 2:
        raise ValueError("heights must be [H>=2, W>=2]")
    hh, ww = h.shape
    if base_depth is None:
        base_depth = spacing
    base_y = float(h.min()) - float(base_depth)
    ii, jj = np.meshgrid(np.arange(hh), np.arange(ww), indexing="ij")
    xs = jj.ravel() * spacing
    zs = ii.ravel() * spacing
    top_v = np.stack([xs, h.ravel(), zs], axis=1)
    bot_v = np.stack([xs, np.full(hh * ww, base_y), zs], axis=1)
    pos = np.concatenate([top_v, bot_v]) + np.asarray(origin, np.float64)

    ids = np.arange(hh * ww, dtype=np.int64).reshape(hh, ww)
    q00, q01 = ids[:-1, :-1], ids[:-1, 1:]
    q10, q11 = ids[1:, :-1], ids[1:, 1:]
    # top faces wound upward (+y out; +x east = columns, +z south = rows)
    top_t = np.concatenate([
        np.stack([q00, q10, q01], axis=-1).reshape(-1, 3),
        np.stack([q01, q10, q11], axis=-1).reshape(-1, 3),
    ])
    off = hh * ww
    bot_t = top_t[:, [0, 2, 1]] + off          # bottom wound downward
    walls = []
    for edge, flip in (
        (ids[0, :], False),     # north rim (z = 0): outward is -z
        (ids[-1, :], True),     # south rim: outward is +z
        (ids[:, 0], True),      # west rim: outward is -x
        (ids[:, -1], False),    # east rim: outward is +x
    ):
        a, b = edge[:-1], edge[1:]
        t1 = np.stack([a, b, a + off], axis=-1)
        t2 = np.stack([b, b + off, a + off], axis=-1)
        w = np.concatenate([t1, t2])
        walls.append(w[:, [0, 2, 1]] if flip else w)
    tris = np.concatenate([top_t, bot_t] + walls)
    if _signed_volume(pos, tris) < 0:
        tris = tris[:, [0, 2, 1]]
    return pos, tris


def cloth_grid(
    nx: int,
    ny: int,
    *,
    spacing: float = 0.05,
    mass: float = 1.0,
    pinned: Tuple[str, ...] = (),
    shear: bool = True,
    bend: bool = True,
    springs=None,
    xpbd=None,
    plane_height: float = -1.0,
    sphere_centers: Optional[np.ndarray] = None,
    sphere_radii: Optional[np.ndarray] = None,
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    orientation: str = "xz",
) -> HostTopology:
    """Build an ``nx × ny`` cloth grid (BASELINE.json:7-8).

    Vertex (i, j) — row i in [0, ny), column j in [0, nx) — lies in the
    ``xz`` plane (horizontal cloth falling under gravity) or ``xy`` plane
    (hanging cloth) at ``origin``.

    Edge classes (BASELINE.json:8 "structural/shear/bend springs"):
      * structural: 4-neighbour (i,j)-(i,j+1) and (i,j)-(i+1,j)
      * shear: diagonals (i,j)-(i+1,j+1) and (i,j+1)-(i+1,j)
      * bend: 2-apart (i,j)-(i,j+2) and (i,j)-(i+2,j)

    ``pinned`` mixes named anchors {"tl","tr","bl","br","top","bottom",
    "left","right","corners"} and integer vertex ids, marking
    vertices with inv_mass = 0 ("pinned mask", BASELINE.json:5) — the
    branch-free pinning mechanism (SURVEY.md C10).  Unknown names raise.
    """
    from .config import SpringParams, XPBDParams

    springs = springs or SpringParams()
    xpbd = xpbd or XPBDParams()

    def vid(i: int, j: int) -> int:
        return i * nx + j

    n = nx * ny
    ii, jj = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    pos = np.zeros((n, 3), dtype=np.float64)
    if orientation == "xz":
        pos[:, 0] = (jj * spacing).ravel()
        pos[:, 1] = 0.0
        pos[:, 2] = (ii * spacing).ravel()
    elif orientation == "xy":
        pos[:, 0] = (jj * spacing).ravel()
        pos[:, 1] = (-ii * spacing).ravel()  # rows hang downward
        pos[:, 2] = 0.0
    else:
        raise ValueError(f"unknown orientation {orientation!r}")
    pos += np.asarray(origin, dtype=np.float64)

    # vectorized edge enumeration (the loop formulation took ~30 s at 262k
    # vertices); _edge_arrays lexsorts, so only the (a, b, class) triple
    # SET and orientations matter, and these match the loop exactly
    ids = np.arange(n, dtype=np.int64).reshape(ny, nx)

    def _pairs(a, b, c):
        t = np.empty((a.size, 3), np.int64)
        t[:, 0] = a.ravel()
        t[:, 1] = b.ravel()
        t[:, 2] = c
        return t

    parts = [
        _pairs(ids[:, :-1], ids[:, 1:], EDGE_STRUCTURAL),     # (i,j)-(i,j+1)
        _pairs(ids[:-1, :], ids[1:, :], EDGE_STRUCTURAL),     # (i,j)-(i+1,j)
    ]
    if shear:
        parts.append(_pairs(ids[:-1, :-1], ids[1:, 1:], EDGE_SHEAR))
        parts.append(_pairs(ids[:-1, 1:], ids[1:, :-1], EDGE_SHEAR))
    if bend:
        if nx > 2:
            parts.append(_pairs(ids[:, :-2], ids[:, 2:], EDGE_BEND))
        if ny > 2:
            parts.append(_pairs(ids[:-2, :], ids[2:, :], EDGE_BEND))
    edge_triples = np.concatenate(parts)

    edges, rest, cls, k, alpha = _edge_arrays(edge_triples, pos, springs, xpbd)
    incident, sign = _build_incidence(n, edges)

    inv_mass = np.full(n, 1.0 / mass, dtype=np.float64)  # mass is per-vertex
    pin_ids: set[int] = set()
    known = {"tl", "tr", "bl", "br", "top", "bottom", "left", "right",
             "corners"}
    for p in pinned:
        if isinstance(p, (int, np.integer)):
            if not 0 <= int(p) < n:
                raise ValueError(f"pinned vertex id {p} out of range [0, {n})")
            pin_ids.add(int(p))
            continue
        if p not in known:
            # a typo here means the cloth the user believes is anchored
            # silently free-falls
            raise ValueError(f"unknown pin spec {p!r}; use one of {sorted(known)} "
                             "or an integer vertex id")
        if p == "tl" or p == "corners":
            pin_ids.add(vid(0, 0))
        if p == "tr" or p == "corners":
            pin_ids.add(vid(0, nx - 1))
        if p == "bl":
            pin_ids.add(vid(ny - 1, 0))
        if p == "br":
            pin_ids.add(vid(ny - 1, nx - 1))
        if p == "top":
            pin_ids.update(vid(0, j) for j in range(nx))
        if p == "bottom":
            pin_ids.update(vid(ny - 1, j) for j in range(nx))
        if p == "left":
            pin_ids.update(vid(i, 0) for i in range(ny))
        if p == "right":
            pin_ids.update(vid(i, nx - 1) for i in range(ny))
    for v in pin_ids:
        inv_mass[v] = 0.0

    # two triangles per quad, row-major, preserving the loop emission order
    if nx > 1 and ny > 1:
        q00 = ids[:-1, :-1]
        q01 = ids[:-1, 1:]
        q10 = ids[1:, :-1]
        q11 = ids[1:, 1:]
        tri2 = np.stack([
            np.stack([q00, q10, q01], axis=-1),
            np.stack([q01, q10, q11], axis=-1),
        ], axis=2)                              # [ny-1, nx-1, 2, 3]
        triangles = tri2.reshape(-1, 3).astype(np.int32)
    else:
        triangles = np.zeros((0, 3), np.int32)

    sc = (
        np.asarray(sphere_centers, dtype=np.float64).reshape(-1, 3)
        if sphere_centers is not None
        else np.zeros((0, 3), np.float64)
    )
    sr = (
        np.asarray(sphere_radii, dtype=np.float64).reshape(-1)
        if sphere_radii is not None
        else np.zeros((0,), np.float64)
    )

    return HostTopology(
        positions0=pos,
        edges=edges,
        rest_length=rest,
        edge_class=cls,
        edge_stiffness=k,
        edge_compliance=alpha,
        inv_mass=inv_mass,
        incident=incident,
        incident_sign=sign,
        tets=np.zeros((0, 4), np.int32),
        rest_volume=np.zeros((0,), np.float64),
        triangles=triangles,
        plane_height=float(plane_height),
        sphere_centers=sc,
        sphere_radii=sr,
        grid_shape=(ny, nx),
        grid_spacing=float(spacing),
        edge_classes_present=tuple(sorted(set(int(c) for c in cls))),
    )


# 5-tet decomposition of a lattice cell, parity-alternated so the diagonals
# of shared faces match between neighbouring cells.
_FIVE = [
    [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)],
    [(1, 1, 0), (1, 0, 0), (0, 1, 0), (1, 1, 1)],
    [(1, 0, 1), (1, 0, 0), (1, 1, 1), (0, 0, 1)],
    [(0, 1, 1), (0, 1, 0), (0, 0, 1), (1, 1, 1)],
    [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 1)],
]
_FIVE_ALT = [
    [(1, 0, 0), (1, 1, 0), (0, 0, 0), (1, 0, 1)],
    [(0, 1, 0), (1, 1, 0), (0, 0, 0), (0, 1, 1)],
    [(0, 0, 1), (0, 0, 0), (1, 0, 1), (0, 1, 1)],
    [(1, 1, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1)],
    [(1, 1, 0), (0, 0, 0), (1, 0, 1), (0, 1, 1)],
]


def rope(
    n: int,
    *,
    p0: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    p1: Optional[Tuple[float, float, float]] = None,
    spacing: float = 0.05,
    mass: float = 0.01,
    bend: bool = True,
    pinned: Tuple = ("start",),
    springs=None,
    xpbd=None,
    plane_height: float = -1.0,
) -> HostTopology:
    """1D rope / rod: ``n`` vertices in a chain from ``p0`` toward ``p1``
    (or along -y when ``p1`` is None — a hanging rope of ``(n-1)*spacing``
    length).

    Structural springs join consecutive vertices; bend springs join
    2-apart vertices and resist folding (the mass-spring rod model — the
    Unity analogue is a chain of spring joints; not present in the
    reference snapshot, /root/reference/README.md:1).  ``pinned`` mixes
    {"start", "end"} and integer vertex ids.  The chain's edge deltas are
    {1, 2}, so the general banded fast path covers it with zero residual
    edges — no dedicated kernel needed.
    """
    from .config import SpringParams, XPBDParams

    springs = springs or SpringParams()
    xpbd = xpbd or XPBDParams()
    if n < 2:
        raise ValueError(f"rope needs >= 2 vertices, got {n}")

    a = np.asarray(p0, np.float64)
    if p1 is None:
        b = a + np.array([0.0, -(n - 1) * spacing, 0.0])
    else:
        b = np.asarray(p1, np.float64)
    t = np.linspace(0.0, 1.0, n)[:, None]
    pos = a[None, :] * (1.0 - t) + b[None, :] * t

    ids = np.arange(n, dtype=np.int64)

    def _pairs(u, v, c):
        out = np.empty((u.size, 3), np.int64)
        out[:, 0] = u
        out[:, 1] = v
        out[:, 2] = c
        return out

    parts = [_pairs(ids[:-1], ids[1:], EDGE_STRUCTURAL)]
    if bend and n > 2:
        parts.append(_pairs(ids[:-2], ids[2:], EDGE_BEND))
    edges, rest, cls, k, alpha = _edge_arrays(
        np.concatenate(parts), pos, springs, xpbd)
    incident, sign = _build_incidence(n, edges)

    inv_mass = np.full(n, 1.0 / mass, dtype=np.float64)
    for p in pinned:
        if isinstance(p, (int, np.integer)):
            if not 0 <= int(p) < n:
                raise ValueError(f"pinned vertex id {p} out of range [0, {n})")
            inv_mass[int(p)] = 0.0
        elif p == "start":
            inv_mass[0] = 0.0
        elif p == "end":
            inv_mass[n - 1] = 0.0
        else:
            raise ValueError(
                f"unknown pin spec {p!r}; use 'start', 'end', or an integer")

    return HostTopology(
        positions0=pos,
        edges=edges,
        rest_length=rest,
        edge_class=cls,
        edge_stiffness=k,
        edge_compliance=alpha,
        inv_mass=inv_mass,
        incident=incident,
        incident_sign=sign,
        tets=np.zeros((0, 4), np.int32),
        rest_volume=np.zeros((0,), np.float64),
        triangles=np.zeros((0, 3), np.int32),
        plane_height=float(plane_height),
        sphere_centers=np.zeros((0, 3), np.float64),
        sphere_radii=np.zeros((0,), np.float64),
        grid_shape=None,
        grid_spacing=None,
        edge_classes_present=tuple(sorted(set(int(c) for c in cls))),
    )


def tet_cube(
    n: int,
    *,
    spacing: float = 0.1,
    mass: float = 1.0,
    springs=None,
    xpbd=None,
    plane_height: float = 0.0,
    origin: Tuple[float, float, float] = (0.0, 0.5, 0.0),
) -> HostTopology:
    """Volumetric soft-body cube: ``n³`` vertex lattice, each lattice cell
    split into 5 tetrahedra; tet edges become structural springs and tets
    carry rest volumes for the volume-preservation constraint
    (BASELINE.json:10 "tet-mesh edge springs + volume-preservation
    constraint").
    """
    from .config import SpringParams, XPBDParams

    springs = springs or SpringParams()
    xpbd = xpbd or XPBDParams()

    def vid(i: int, j: int, k: int) -> int:
        return (i * n + j) * n + k

    nv = n * n * n
    pos = np.zeros((nv, 3), dtype=np.float64)
    for i in range(n):
        for j in range(n):
            for k in range(n):
                pos[vid(i, j, k)] = (i * spacing, j * spacing, k * spacing)
    pos += np.asarray(origin, dtype=np.float64)

    FIVE, FIVE_ALT = _FIVE, _FIVE_ALT
    tets = []
    for i in range(n - 1):
        for j in range(n - 1):
            for k in range(n - 1):
                pat = FIVE if (i + j + k) % 2 == 0 else FIVE_ALT
                for t in pat:
                    tets.append(
                        tuple(vid(i + di, j + dj, k + dk) for di, dj, dk in t)
                    )
    def tet_vol(t):
        p = pos[np.asarray(t)]
        return float(np.dot(np.cross(p[1] - p[0], p[2] - p[0]), p[3] - p[0]) / 6.0)

    # canonicalize orientation: swap two vertices when the signed volume is
    # negative so every tet has positive rest volume
    tets = [t if tet_vol(t) > 0 else (t[0], t[1], t[3], t[2]) for t in tets]
    tets_arr = np.array(tets, dtype=np.int32) if tets else np.zeros((0, 4), np.int32)
    rest_vol = np.array([tet_vol(t) for t in tets], dtype=np.float64)

    # unique tet edges -> structural springs
    eset = set()
    for t in tets:
        for a in range(4):
            for b in range(a + 1, 4):
                u, v = sorted((t[a], t[b]))
                eset.add((u, v))
    edge_list = [(a, b, EDGE_STRUCTURAL) for a, b in sorted(eset)]
    edges, rest, cls, k, alpha = _edge_arrays(edge_list, pos, springs, xpbd)
    incident, sign = _build_incidence(nv, edges)
    inv_mass = np.full(nv, 1.0 / mass, dtype=np.float64)  # mass is per-vertex

    # surface triangles: boundary faces of the lattice (for normals)
    tris = []
    for i in range(n - 1):
        for j in range(n - 1):
            # bottom (k=0) and top (k=n-1) faces in each axis-aligned plane
            tris.append((vid(i, j, 0), vid(i + 1, j, 0), vid(i, j + 1, 0)))
            tris.append((vid(i + 1, j, 0), vid(i + 1, j + 1, 0), vid(i, j + 1, 0)))
            kk = n - 1
            tris.append((vid(i, j, kk), vid(i, j + 1, kk), vid(i + 1, j, kk)))
            tris.append((vid(i + 1, j, kk), vid(i, j + 1, kk), vid(i + 1, j + 1, kk)))
    triangles = np.array(tris, dtype=np.int32) if tris else np.zeros((0, 3), np.int32)

    return HostTopology(
        positions0=pos,
        edges=edges,
        rest_length=rest,
        edge_class=cls,
        edge_stiffness=k,
        edge_compliance=alpha,
        inv_mass=inv_mass,
        incident=incident,
        incident_sign=sign,
        tets=tets_arr,
        rest_volume=rest_vol,
        triangles=triangles,
        plane_height=float(plane_height),
        sphere_centers=np.zeros((0, 3), np.float64),
        sphere_radii=np.zeros((0,), np.float64),
        grid_shape=None,
        lattice_shape=(n, n, n),
    )


def _trilinear(grid: np.ndarray, origin: np.ndarray, spacing: float,
               pts: np.ndarray) -> np.ndarray:
    """Vectorized trilinear SDF sample (host-side f64 twin of the oracle's
    ``_sdf_sample_grad`` value path)."""
    q = (pts - origin) / spacing
    dims = np.asarray(grid.shape)
    q = np.clip(q, 0.0, dims - 1.000001)
    i0 = np.floor(q).astype(np.int64)
    f = q - i0
    i1 = np.minimum(i0 + 1, dims - 1)
    out = np.zeros(len(pts))
    for dx, wx in ((0, 1 - f[:, 0]), (1, f[:, 0])):
        ix = np.where(dx, i1[:, 0], i0[:, 0])
        for dy, wy in ((0, 1 - f[:, 1]), (1, f[:, 1])):
            iy = np.where(dy, i1[:, 1], i0[:, 1])
            for dz, wz in ((0, 1 - f[:, 2]), (1, f[:, 2])):
                iz = np.where(dz, i1[:, 2], i0[:, 2])
                out += wx * wy * wz * grid[ix, iy, iz]
    return out


def lattice_from_mesh(
    positions: np.ndarray,
    triangles: np.ndarray,
    *,
    resolution: int = 12,
    mass: float = 1.0,
    margin: float = 0.0,
    springs=None,
    xpbd=None,
    plane_height: float = -1.0,
    pinned_ids: Tuple[int, ...] = (),
    sdf_resolution: Optional[int] = None,
) -> HostTopology:
    """Voxelize ANY closed surface mesh into a volumetric soft-body lattice
    — the Unity "proxy lattice" workflow (make any visual mesh a soft
    body; not present in the reference snapshot,
    /root/reference/README.md:1).

    The mesh is baked to a signed distance grid
    (:func:`softbodyunity_tpu.core.sdf.sdf_from_mesh`); lattice cells
    whose center lies inside (``sdf <= margin``) are filled with the same
    parity-alternated 5-tet split as :func:`tet_cube`.  Vertex ids keep
    the FULL bounding-box raster order — unused "ghost" vertices stay in
    the arrays with ``inv_mass = 0`` and no edges — so every tet/edge
    delta is lattice-regular and the banded machinery groups them with
    zero residual: the shape runs the **banded path**, exactly like a
    cube.  (Compacting the ids would break the strides and drop the whole
    shape to the gather path; ghosts cost ~2x plane footprint on typical
    shapes.)

    ``resolution`` counts lattice cells across the largest extent.
    ``margin`` > 0 dilates the fill (captures thin features), < 0 erodes.
    Compose with :func:`softbodyunity_tpu.core.embed.embed_mesh` to skin
    the original mesh back onto the simulated lattice.
    """
    from .config import SpringParams, XPBDParams
    from .sdf import sdf_from_mesh

    springs = springs or SpringParams()
    xpbd = xpbd or XPBDParams()
    verts = np.asarray(positions, np.float64).reshape(-1, 3)
    if resolution < 2:
        raise ValueError(f"resolution must be >= 2, got {resolution}")

    grid, gorigin, gspacing = sdf_from_mesh(
        verts, triangles,
        resolution=sdf_resolution or max(2 * resolution, 24))

    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    spacing = float((hi - lo).max()) / resolution
    ncells = np.maximum(np.ceil((hi - lo) / spacing - 1e-9).astype(np.int64),
                        1)                                   # cells per axis
    nx, ny, nz = (int(c) + 1 for c in ncells)                # vertices/axis

    # cell-center occupancy from the SDF
    ci, cj, ck = np.meshgrid(np.arange(ncells[0]), np.arange(ncells[1]),
                             np.arange(ncells[2]), indexing="ij")
    centers = (np.stack([ci, cj, ck], axis=-1).reshape(-1, 3) + 0.5) \
        * spacing + lo
    occupied = (_trilinear(grid, gorigin, gspacing, centers)
                <= margin).reshape(int(ncells[0]), int(ncells[1]),
                                   int(ncells[2]))
    if not occupied.any():
        raise ValueError(
            "no lattice cell center lies inside the mesh; raise "
            "`resolution`, pass a positive `margin`, or check the mesh "
            "is closed")

    def vid(i: int, j: int, k: int) -> int:
        return (i * ny + j) * nz + k

    nv = nx * ny * nz
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    pos = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3) * spacing + lo

    # vectorized tet emission (a per-cell loop took minutes at 50k cells)
    occ_idx = np.argwhere(occupied)                          # [C, 3]
    parity = (occ_idx.sum(axis=1) % 2).astype(bool)
    pat = np.where(parity[:, None, None, None],
                   np.asarray(_FIVE_ALT, np.int64)[None],
                   np.asarray(_FIVE, np.int64)[None])        # [C, 5, 4, 3]
    corner = occ_idx[:, None, None, :] + pat
    tets_arr = ((corner[..., 0] * ny + corner[..., 1]) * nz
                + corner[..., 2]).reshape(-1, 4)

    def tet_vols(t):
        p0, p1, p2, p3 = (pos[t[:, c]] for c in range(4))
        return np.einsum("ij,ij->i", np.cross(p1 - p0, p2 - p0),
                         p3 - p0) / 6.0

    # canonicalize orientation: swap the last two corners where negative
    vols = tet_vols(tets_arr)
    neg = vols < 0
    tets_arr[neg, 2], tets_arr[neg, 3] = (tets_arr[neg, 3].copy(),
                                          tets_arr[neg, 2].copy())
    rest_vol = np.abs(vols)
    tets_arr = tets_arr.astype(np.int32)

    # unique tet edges -> structural springs (sorted rows == the
    # sorted-set emission order of tet_cube)
    pair_ix = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)])
    pairs = np.sort(tets_arr[:, pair_ix].reshape(-1, 2).astype(np.int64),
                    axis=1)
    uniq = np.unique(pairs, axis=0)
    edge_triples = np.concatenate(
        [uniq, np.full((len(uniq), 1), EDGE_STRUCTURAL, np.int64)], axis=1)
    edges, rest, cls, k_arr, alpha = _edge_arrays(edge_triples, pos, springs,
                                                  xpbd)
    incident, sign = _build_incidence(nv, edges)

    # ghost vertices (in no occupied cell) are frozen: inv_mass = 0 keeps
    # them branch-free and motionless at their raster rest positions
    used = np.zeros(nv, bool)
    used[np.unique(tets_arr)] = True
    inv_mass = np.where(used, 1.0 / mass, 0.0)
    for p in pinned_ids:
        if not 0 <= int(p) < nv:
            raise ValueError(f"pinned vertex id {p} out of range [0, {nv})")
        inv_mass[int(p)] = 0.0

    # surface triangles: faces between an occupied cell and an unoccupied
    # (or out-of-box) neighbour, wound outward (vectorized per direction)
    occ = np.zeros((int(ncells[0]) + 2, int(ncells[1]) + 2,
                    int(ncells[2]) + 2), bool)
    occ[1:-1, 1:-1, 1:-1] = occupied
    tri_parts = []
    eye = np.eye(3, dtype=np.int64)
    for axis in range(3):
        du = eye[(axis + 1) % 3]
        dv = eye[(axis + 2) % 3]
        for s in (1, -1):
            nb_occ = np.roll(occ, -s, axis=axis)[1:-1, 1:-1, 1:-1]
            cells = np.argwhere(occupied & ~nb_occ)         # [F, 3]
            if not len(cells):
                continue
            c = cells + (eye[axis] if s == 1 else 0)
            p00 = (c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]
            cu = c + du
            cv = c + dv
            cuv = c + du + dv
            p10 = (cu[:, 0] * ny + cu[:, 1]) * nz + cu[:, 2]
            p01 = (cv[:, 0] * ny + cv[:, 1]) * nz + cv[:, 2]
            p11 = (cuv[:, 0] * ny + cuv[:, 1]) * nz + cuv[:, 2]
            if s == 1:   # outward = +axis = du x dv
                tri_parts.append(np.stack([p00, p10, p01], axis=1))
                tri_parts.append(np.stack([p10, p11, p01], axis=1))
            else:        # outward = -axis
                tri_parts.append(np.stack([p00, p01, p10], axis=1))
                tri_parts.append(np.stack([p01, p11, p10], axis=1))
    triangles = np.concatenate(tri_parts).astype(np.int32)

    return HostTopology(
        positions0=pos,
        edges=edges,
        rest_length=rest,
        edge_class=cls,
        edge_stiffness=k_arr,
        edge_compliance=alpha,
        inv_mass=inv_mass,
        incident=incident,
        incident_sign=sign,
        tets=tets_arr,
        rest_volume=rest_vol,
        triangles=triangles,
        plane_height=float(plane_height),
        sphere_centers=np.zeros((0, 3), np.float64),
        sphere_radii=np.zeros((0,), np.float64),
        grid_shape=None,
        lattice_shape=(nx, ny, nz),
    )


def from_triangle_mesh(
    positions: np.ndarray,
    triangles: np.ndarray,
    *,
    mass: float = 1.0,
    pinned_ids: Tuple[int, ...] = (),
    bend: bool = True,
    springs=None,
    xpbd=None,
    plane_height: float = -1.0,
    sphere_centers: Optional[np.ndarray] = None,
    sphere_radii: Optional[np.ndarray] = None,
    reorder: bool = True,
) -> HostTopology:
    """Build a cloth topology from an ARBITRARY triangle mesh — the analogue
    of feeding any Unity ``Mesh`` to the reference's soft-body component.

    * structural springs: the unique triangle edges, rest = current length;
    * bend springs: for every interior edge (shared by two triangles), the
      classic cross-pair between the two opposite vertices;
    * ``reorder=True`` relabels vertices by BFS over the edge graph
      (Cuthill-McKee style): physical meshes then concentrate their index
      deltas into few values, which is what lets the banded (gather-free)
      force path cover most of the edge list (solver/banded.py).
      The returned topology is in the NEW vertex order;
      ``host.old_to_new`` (i64[N], None when the input order was kept)
      maps input vertex ids to the new ids — remap caller-side ids
      (``stitch``/``anchor`` targets, pins) through it.
    """
    from .config import SpringParams, XPBDParams

    springs = springs or SpringParams()
    xpbd = xpbd or XPBDParams()
    pos = np.asarray(positions, np.float64).copy()
    tris = np.asarray(triangles, np.int64).copy()
    n = pos.shape[0]

    # unique undirected edges + the triangles on each side
    edge_owner: dict = {}
    for fi, (a, b, c) in enumerate(tris):
        for u, v in ((a, b), (b, c), (c, a)):
            key = (min(u, v), max(u, v))
            edge_owner.setdefault(key, []).append(fi)

    if reorder and n > 0:
        # BFS relabel for index locality, kept only when it actually
        # IMPROVES banded coverage (see from_tet_mesh: BFS wavefronts
        # fragment already-well-ordered meshes)
        order = _bfs_order(n, set(edge_owner))
        old_to_new = np.empty(n, np.int64)
        old_to_new[order] = np.arange(n)
        remapped = {
            (min(old_to_new[u], old_to_new[v]), max(old_to_new[u], old_to_new[v])): f
            for (u, v), f in edge_owner.items()
        }
        if _banded_fraction(set(remapped)) > _banded_fraction(set(edge_owner)):
            pos = pos[order]
            tris = old_to_new[tris]
            pinned_ids = tuple(int(old_to_new[p]) for p in pinned_ids)
            edge_owner = remapped
            perm_applied = old_to_new
        else:
            perm_applied = None
    else:
        perm_applied = None

    edge_list = [(int(u), int(v), EDGE_STRUCTURAL) for (u, v) in sorted(edge_owner)]
    if bend:
        for (u, v), faces in sorted(edge_owner.items()):
            if len(faces) == 2:
                opp = []
                for fi in faces:
                    tri = set(int(t) for t in tris[fi])
                    opp.extend(tri - {int(u), int(v)})
                if len(opp) == 2 and opp[0] != opp[1]:
                    a, b = min(opp), max(opp)
                    edge_list.append((a, b, EDGE_BEND))
    # dedupe (a bend pair can coincide with an existing edge on folds)
    seen_e = set()
    uniq = []
    for a, b, c in edge_list:
        if (a, b) not in seen_e:
            seen_e.add((a, b))
            uniq.append((a, b, c))
    edges, rest, cls, k, alpha = _edge_arrays(uniq, pos, springs, xpbd)
    incident, sign = _build_incidence(n, edges)
    inv_mass = np.full(n, 1.0 / mass, dtype=np.float64)
    for p in pinned_ids:
        inv_mass[p] = 0.0

    sc = (
        np.asarray(sphere_centers, np.float64).reshape(-1, 3)
        if sphere_centers is not None else np.zeros((0, 3), np.float64)
    )
    sr = (
        np.asarray(sphere_radii, np.float64).reshape(-1)
        if sphere_radii is not None else np.zeros((0,), np.float64)
    )
    return HostTopology(
        positions0=pos,
        edges=edges,
        rest_length=rest,
        edge_class=cls,
        edge_stiffness=k,
        edge_compliance=alpha,
        inv_mass=inv_mass,
        incident=incident,
        incident_sign=sign,
        tets=np.zeros((0, 4), np.int32),
        rest_volume=np.zeros((0,), np.float64),
        triangles=tris.astype(np.int32),
        plane_height=float(plane_height),
        sphere_centers=sc,
        sphere_radii=sr,
        grid_shape=None,
        grid_spacing=None,
        edge_classes_present=tuple(sorted(set(int(c) for c in cls))),
        old_to_new=perm_applied,
    )


def _banded_fraction(eset, min_count: int = 32) -> float:
    """Fraction of edges whose index delta belongs to a group of at least
    ``min_count`` — what solver/banded.py will cover without gathers."""
    if not eset:
        return 1.0
    deltas = np.array([v - u for (u, v) in eset], np.int64)
    _, counts = np.unique(deltas, return_counts=True)
    return float(counts[counts >= min_count].sum()) / len(deltas)


def _bfs_order(n: int, eset) -> np.ndarray:
    """BFS (Cuthill-McKee style) vertex order over the edge graph."""
    from collections import deque

    adj = [[] for _ in range(n)]
    for (u, v) in eset:
        adj[u].append(v)
        adj[v].append(u)
    order = []
    seen = np.zeros(n, bool)
    for seed in range(n):
        if seen[seed]:
            continue
        q = deque([seed])
        seen[seed] = True
        while q:
            u = q.popleft()
            order.append(u)
            for w in sorted(adj[u]):
                if not seen[w]:
                    seen[w] = True
                    q.append(w)
    return np.asarray(order, np.int64)


def from_tet_mesh(
    positions: np.ndarray,
    tets: np.ndarray,
    *,
    mass: float = 1.0,
    pinned_ids: Tuple[int, ...] = (),
    springs=None,
    xpbd=None,
    plane_height: float = -1.0,
    sphere_centers: Optional[np.ndarray] = None,
    sphere_radii: Optional[np.ndarray] = None,
    reorder: bool = True,
) -> HostTopology:
    """Build a volumetric soft body from an ARBITRARY tetrahedral mesh —
    the general-geometry counterpart of :func:`tet_cube` (any tetrahedralized
    Unity mesh becomes a soft body):

    * structural springs: the unique tet edges, rest = current length;
    * volume preservation: per-tet rest volumes (orientation canonicalized
      to positive signed volume);
    * surface triangles: boundary faces (faces on exactly one tet),
      oriented outward, for vertex-normal recompute / rendering;
    * ``reorder=True`` tries a BFS relabeling of the edge graph and keeps
      whichever ordering (input vs BFS) yields MORE banded (gather-free)
      coverage — BFS rescues randomly-labeled meshes, while
      already-well-ordered lattices keep their perfect banding (BFS
      wavefronts would fragment them; measured 1.00 -> 0.52 on a 10^3
      lattice).  Irregular leftovers take the exact gather path.  When a
      relabel was applied, ``host.old_to_new`` maps input vertex ids to
      the new ids (None otherwise).
    """
    from .config import SpringParams, XPBDParams

    springs = springs or SpringParams()
    xpbd = xpbd or XPBDParams()
    pos = np.asarray(positions, np.float64).copy()
    t = np.asarray(tets, np.int64).copy()
    n = pos.shape[0]

    def signed_vol(tt):
        p = pos[tt]
        return float(np.dot(np.cross(p[1] - p[0], p[2] - p[0]), p[3] - p[0]) / 6.0)

    # canonicalize: positive signed volume (swap last two vertices)
    t = np.array(
        [tt if signed_vol(tt) > 0 else (tt[0], tt[1], tt[3], tt[2]) for tt in t],
        np.int64,
    ) if t.shape[0] else t.reshape(0, 4)

    # unique tet edges
    eset = set()
    for tt in t:
        for a in range(4):
            for b in range(a + 1, 4):
                u, v = sorted((int(tt[a]), int(tt[b])))
                eset.add((u, v))

    if reorder and n > 0:
        order = _bfs_order(n, eset)
        old_to_new = np.empty(n, np.int64)
        old_to_new[order] = np.arange(n)
        eset_bfs = {(min(old_to_new[u], old_to_new[v]),
                     max(old_to_new[u], old_to_new[v])) for (u, v) in eset}
        if _banded_fraction(eset_bfs) > _banded_fraction(eset):
            pos = pos[order]
            t = old_to_new[t] if t.shape[0] else t
            pinned_ids = tuple(int(old_to_new[p]) for p in pinned_ids)
            eset = eset_bfs
            perm_applied = old_to_new
        else:
            perm_applied = None
    else:
        perm_applied = None

    rest_vol = np.array([signed_vol(tt) for tt in t], np.float64)

    # boundary faces: appear on exactly one tet; orient outward (normal
    # away from the tet's opposite vertex)
    face_count: dict = {}
    for tt in t:
        a, b, c, d = (int(x) for x in tt)
        for f, opp in (((a, b, c), d), ((a, b, d), c), ((a, c, d), b),
                       ((b, c, d), a)):
            key = tuple(sorted(f))
            face_count.setdefault(key, []).append((f, opp))
    tris = []
    for key, lst in sorted(face_count.items()):
        if len(lst) != 1:
            continue
        (fa, fb, fc), opp = lst[0]
        nrm = np.cross(pos[fb] - pos[fa], pos[fc] - pos[fa])
        if np.dot(nrm, pos[opp] - pos[fa]) > 0:
            fb, fc = fc, fb
        tris.append((fa, fb, fc))
    triangles = np.array(tris, np.int32) if tris else np.zeros((0, 3), np.int32)

    edge_list = [(int(u), int(v), EDGE_STRUCTURAL) for (u, v) in sorted(eset)]
    edges, rest, cls, k, alpha = _edge_arrays(edge_list, pos, springs, xpbd)
    incident, sign = _build_incidence(n, edges)
    inv_mass = np.full(n, 1.0 / mass, dtype=np.float64)
    for p in pinned_ids:
        inv_mass[p] = 0.0

    sc = (
        np.asarray(sphere_centers, np.float64).reshape(-1, 3)
        if sphere_centers is not None else np.zeros((0, 3), np.float64)
    )
    sr = (
        np.asarray(sphere_radii, np.float64).reshape(-1)
        if sphere_radii is not None else np.zeros((0,), np.float64)
    )
    return HostTopology(
        positions0=pos,
        edges=edges,
        rest_length=rest,
        edge_class=cls,
        edge_stiffness=k,
        edge_compliance=alpha,
        inv_mass=inv_mass,
        incident=incident,
        incident_sign=sign,
        tets=t.astype(np.int32) if t.shape[0] else np.zeros((0, 4), np.int32),
        rest_volume=rest_vol,
        triangles=triangles,
        plane_height=float(plane_height),
        sphere_centers=sc,
        sphere_radii=sr,
        grid_shape=None,
        grid_spacing=None,
        edge_classes_present=tuple(sorted(set(int(c) for c in cls))) or (0,),
        old_to_new=perm_applied,
    )


def _none_concat(arrays, empty_shape):
    """Concatenate optional per-body collider arrays; None if ALL are None."""
    if all(a is None for a in arrays):
        return None
    return np.concatenate([
        np.asarray(a, np.float64) if a is not None
        else np.zeros(empty_shape, np.float64)
        for a in arrays
    ])


def _vel_concat(hosts, get_vel, get_count):
    """Concatenate per-body kinematic collider velocities: None if EVERY
    body is static; otherwise static bodies contribute zero rows matching
    their collider counts."""
    vels = [get_vel(h) for h in hosts]
    if all(v is None for v in vels):
        return None
    return np.concatenate([
        np.asarray(v, np.float64).reshape(-1, 3) if v is not None
        else np.zeros((get_count(h), 3))
        for v, h in zip(vels, hosts)
    ])


def merge_bodies(*hosts: HostTopology) -> HostTopology:
    """Concatenate several built topologies into ONE multi-body scene — the
    analogue of placing several soft-body GameObjects in the same Unity
    scene.  Vertex/edge/tet/triangle indices are offset per body; bodies
    interact through self-collision (body-body contact,
    ``SelfCollisionParams``) and, after :func:`stitch`, through attachment
    springs.

    Collider geometry (spheres/capsules/boxes/SDF bakes) is the union of
    every body's; the ground plane is the FIRST body's ``plane_height``
    (one scene, one floor — assign ``host.plane_height`` afterwards to
    override).  The merged scene is general topology: ``grid_shape`` is
    dropped, so stepping uses the banded/gather paths, not the grid
    stencil kernels.
    """
    if not hosts:
        raise ValueError("merge_bodies needs at least one body")
    if len(hosts) == 1:
        return hosts[0]
    offs = np.cumsum([0] + [h.positions0.shape[0] for h in hosts])[:-1]
    pos = np.concatenate([h.positions0 for h in hosts])
    edges = np.concatenate([h.edges.astype(np.int64) + o
                            for h, o in zip(hosts, offs)])
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    edges = edges[order]
    cat = lambda f: np.concatenate([f(h) for h in hosts])
    rest = cat(lambda h: h.rest_length)[order]
    cls = cat(lambda h: h.edge_class)[order]
    k = cat(lambda h: h.edge_stiffness)[order]
    alpha = cat(lambda h: h.edge_compliance)[order]
    tets = np.concatenate([h.tets.astype(np.int64) + o
                           for h, o in zip(hosts, offs)])
    tris = np.concatenate([h.triangles.astype(np.int64) + o
                           for h, o in zip(hosts, offs)])
    incident, sign = _build_incidence(pos.shape[0], edges)

    # pressure bodies: offset each host's body ids by the bodies before it
    # (triangles with no enclosed gas stay -1), concat the rest volumes
    if any(h.pressure_rest_volume is not None for h in hosts):
        body_off = 0
        tri_body_parts = []
        vol_parts = []
        for h in hosts:
            nf = h.triangles.shape[0]
            if h.pressure_rest_volume is None:
                tri_body_parts.append(np.full(nf, -1, np.int64))
            else:
                tb = np.asarray(h.tri_body, np.int64)
                tri_body_parts.append(np.where(tb >= 0, tb + body_off, -1))
                vol_parts.append(np.asarray(h.pressure_rest_volume,
                                            np.float64))
                body_off += h.pressure_rest_volume.shape[0]
        tri_body = np.concatenate(tri_body_parts)
        pressure_rest_volume = np.concatenate(vol_parts)
    else:
        tri_body = None
        pressure_rest_volume = None

    sdf_grids = [h.sdf_grids for h in hosts if h.sdf_grids is not None]
    if sdf_grids:
        dims = {g.shape[1:] for g in sdf_grids}
        if len(dims) > 1:
            # Topology stacks all scene SDF bakes in one [Sg,gx,gy,gz]
            # array; mixed voxel dims cannot stack (re-bake at a common
            # resolution instead of silently resampling physics geometry)
            raise ValueError(
                f"all SDF collider grids must share voxel dims, got {dims}"
            )
    return HostTopology(
        positions0=pos,
        edges=edges.astype(np.int32),
        rest_length=rest,
        edge_class=cls.astype(np.int32),
        edge_stiffness=k,
        edge_compliance=alpha,
        inv_mass=cat(lambda h: h.inv_mass),
        incident=incident,
        incident_sign=sign,
        tets=tets.astype(np.int32),
        rest_volume=cat(lambda h: h.rest_volume),
        triangles=tris.astype(np.int32),
        plane_height=float(hosts[0].plane_height),
        sphere_centers=cat(lambda h: h.sphere_centers),
        sphere_radii=cat(lambda h: h.sphere_radii),
        grid_shape=None,
        grid_spacing=None,
        edge_classes_present=tuple(sorted(
            set().union(*(h.edge_classes_present for h in hosts)))),
        capsule_p0=_none_concat([h.capsule_p0 for h in hosts], (0, 3)),
        capsule_p1=_none_concat([h.capsule_p1 for h in hosts], (0, 3)),
        capsule_radii=_none_concat([h.capsule_radii for h in hosts], (0,)),
        box_centers=_none_concat([h.box_centers for h in hosts], (0, 3)),
        box_half_extents=_none_concat(
            [h.box_half_extents for h in hosts], (0, 3)),
        box_rotations=_none_concat(
            [h.box_rotations for h in hosts], (0, 3, 3)),
        tri_body=tri_body,
        pressure_rest_volume=pressure_rest_volume,
        sdf_grids=(np.concatenate(sdf_grids) if sdf_grids else None),
        sdf_origins=_none_concat([h.sdf_origins for h in hosts], (0, 3)),
        sdf_spacings=_none_concat([h.sdf_spacings for h in hosts], (0,)),
        plane_velocity=hosts[0].plane_velocity,
        sphere_velocities=_vel_concat(
            hosts, lambda h: h.sphere_velocities,
            lambda h: np.asarray(h.sphere_radii).shape[0]),
        capsule_velocities=_vel_concat(
            hosts, lambda h: h.capsule_velocities,
            lambda h: (0 if h.capsule_radii is None
                       else h.capsule_radii.shape[0])),
        box_velocities=_vel_concat(
            hosts, lambda h: h.box_velocities,
            lambda h: 0 if h.box_centers is None else h.box_centers.shape[0]),
        sdf_velocities=_vel_concat(
            hosts, lambda h: h.sdf_velocities,
            lambda h: (0 if h.sdf_spacings is None
                       else h.sdf_spacings.shape[0])),
        **_merge_attachments(hosts, offs),
        **_merge_clusters(hosts),
        **_merge_tethers(hosts),
    )


def _merge_clusters(hosts):
    """Offset each host's shape-matching cluster ids by the clusters before
    it (vertices of bodies without clusters stay -1); rest offsets are
    body-local so they concatenate unchanged."""
    if not any(h.cluster_id is not None for h in hosts):
        return dict(cluster_id=None, cluster_rest=None, n_clusters=0)
    ids, rests, off = [], [], 0
    for h in hosts:
        nv = h.positions0.shape[0]
        if h.cluster_id is None:
            ids.append(np.full(nv, -1, np.int64))
            rests.append(np.zeros((nv, 3)))
        else:
            ci = np.asarray(h.cluster_id, np.int64)
            ids.append(np.where(ci >= 0, ci + off, -1))
            rests.append(np.asarray(h.cluster_rest, np.float64))
            off += int(h.n_clusters)
    return dict(cluster_id=np.concatenate(ids),
                cluster_rest=np.concatenate(rests), n_clusters=off)


def _merge_tethers(hosts):
    """Concatenate per-vertex motion constraints; bodies without them get
    ``inf`` radii (unconstrained) with their own rest positions as inert
    anchors, so merged topologies keep every body's tethers intact."""
    if not any(h.tether_anchor is not None for h in hosts):
        return dict(tether_anchor=None, tether_radius=None)
    anchors, radii = [], []
    for h in hosts:
        if h.tether_anchor is None:
            anchors.append(np.array(h.positions0, np.float64))
            radii.append(np.full(h.positions0.shape[0], np.inf))
        else:
            anchors.append(np.asarray(h.tether_anchor, np.float64))
            radii.append(np.asarray(h.tether_radius, np.float64))
    return dict(tether_anchor=np.concatenate(anchors),
                tether_radius=np.concatenate(radii))


def _merge_attachments(hosts, offs):
    """Offset each host's rigid attachments by its vertex offset and its
    body offset (spheres/boxes concatenate in host order)."""
    out = dict(attach_ids=None, attach_body=None, attach_local=None,
               attach_box_ids=None, attach_box_body=None,
               attach_box_local=None)
    if any(h.attach_ids is not None for h in hosts):
        ids, body, local = [], [], []
        sphere_off = 0
        for h, o in zip(hosts, offs):
            if h.attach_ids is not None:
                ids.append(np.asarray(h.attach_ids, np.int64) + o)
                body.append(np.asarray(h.attach_body, np.int64)
                            + sphere_off)
                local.append(np.asarray(h.attach_local, np.float64))
            sphere_off += np.asarray(h.sphere_radii).shape[0]
        out.update(attach_ids=np.concatenate(ids),
                   attach_body=np.concatenate(body),
                   attach_local=np.concatenate(local))
    if any(h.attach_box_ids is not None for h in hosts):
        ids, body, local = [], [], []
        box_off = 0
        for h, o in zip(hosts, offs):
            if h.attach_box_ids is not None:
                ids.append(np.asarray(h.attach_box_ids, np.int64) + o)
                body.append(np.asarray(h.attach_box_body, np.int64)
                            + box_off)
                local.append(np.asarray(h.attach_box_local, np.float64))
            box_off += (0 if h.box_centers is None
                        else np.asarray(h.box_centers).shape[0])
        out.update(attach_box_ids=np.concatenate(ids),
                   attach_box_body=np.concatenate(body),
                   attach_box_local=np.concatenate(local))
    out.update(joint_meta=None, joint_local_a=None, joint_local_b=None,
               joint_axis_a=None, joint_axis_b=None, joint_rest=None,
               joint_compliance=None, joint_ref_a=None, joint_ref_b=None,
               joint_limit=None, joint_motor=None)
    if any(h.joint_meta is not None for h in hosts):
        meta = []
        arrs = {n: [] for n in ("joint_local_a", "joint_local_b",
                                "joint_axis_a", "joint_axis_b",
                                "joint_rest", "joint_compliance",
                                "joint_ref_a", "joint_ref_b",
                                "joint_limit", "joint_motor")}
        sphere_off = box_off = 0
        for h in hosts:
            if h.joint_meta is not None:
                off = {"sphere": sphere_off, "box": box_off, "world": 0}
                meta.extend((jt, ka, ia + off[ka], kb, ib + off[kb])
                            for jt, ka, ia, kb, ib in h.joint_meta)
                for n in arrs:
                    arrs[n].append(np.asarray(getattr(h, n), np.float64))
            sphere_off += np.asarray(h.sphere_radii).shape[0]
            box_off += (0 if h.box_centers is None
                        else np.asarray(h.box_centers).shape[0])
        out.update(joint_meta=tuple(meta),
                   **{n: np.concatenate(v) for n, v in arrs.items()})
    return out


def stitch(
    host: HostTopology,
    ids_a,
    ids_b,
    *,
    stiffness: Optional[float] = None,
    compliance: Optional[float] = None,
    rest_length=None,
) -> HostTopology:
    """Sew vertex pairs together with springs — attachment constraints
    between (or within) soft bodies: a seam joining two cloth panels, a
    flag laced to a rope, a handle strapped to a soft cube.

    ``ids_a[i]`` is connected to ``ids_b[i]`` by a structural spring.
    ``rest_length`` defaults to the pairs' CURRENT distances (a rigid
    lacing); pass ``0.0`` for a sewing seam that pulls the pairs flush, or
    an array for per-pair lengths.  ``stiffness``/``compliance`` default
    to the mean of the host's structural springs (force solvers read
    stiffness, XPBD reads compliance).

    Returns a new :class:`HostTopology`; the input is not modified.  Like
    :func:`merge_bodies`, the result is general topology (``grid_shape``
    dropped) so the stitches are seen by every solver path.
    """
    ids_a = np.asarray(ids_a, np.int64).reshape(-1)
    ids_b = np.asarray(ids_b, np.int64).reshape(-1)
    if ids_a.shape != ids_b.shape:
        raise ValueError("ids_a and ids_b must pair up 1:1")
    n = host.positions0.shape[0]
    if ids_a.size == 0:
        return host
    if ((ids_a < 0) | (ids_a >= n) | (ids_b < 0) | (ids_b >= n)).any():
        raise ValueError(f"stitch vertex id out of range [0, {n})")
    if (ids_a == ids_b).any():
        raise ValueError("cannot stitch a vertex to itself")
    new = np.stack([np.minimum(ids_a, ids_b), np.maximum(ids_a, ids_b)],
                   axis=1)
    existing = {tuple(e) for e in host.edges.tolist()}
    dup = [tuple(e) for e in new.tolist()
           if tuple(e) in existing]
    if dup:
        # a duplicate edge silently DOUBLES that spring's stiffness
        raise ValueError(f"stitch pairs already have springs: {dup[:4]}")
    if len({tuple(e) for e in new.tolist()}) != len(new):
        raise ValueError("duplicate stitch pairs")

    struct = host.edge_class == EDGE_STRUCTURAL
    if stiffness is None:
        if not struct.any():
            raise ValueError(
                "no structural springs to default from; pass stiffness=")
        stiffness = float(host.edge_stiffness[struct].mean())
    if compliance is None:
        compliance = (float(host.edge_compliance[struct].mean())
                      if struct.any() else 0.0)
    if rest_length is None:
        rest_length = np.linalg.norm(
            host.positions0[new[:, 1]] - host.positions0[new[:, 0]], axis=1)
    rest_new = np.broadcast_to(
        np.asarray(rest_length, np.float64), (len(new),)).copy()

    edges = np.concatenate([host.edges.astype(np.int64), new])
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    app = lambda a, v: np.concatenate(
        [np.asarray(a, np.float64), np.full(len(new), v, np.float64)])
    rest = np.concatenate([host.rest_length, rest_new])[order]
    cls = np.concatenate(
        [host.edge_class.astype(np.int64),
         np.full(len(new), EDGE_STRUCTURAL, np.int64)])[order]
    k = app(host.edge_stiffness, stiffness)[order]
    alpha = app(host.edge_compliance, compliance)[order]
    edges = edges[order]
    incident, sign = _build_incidence(n, edges)
    return dataclasses.replace(
        host,
        edges=edges.astype(np.int32),
        rest_length=rest,
        edge_class=cls.astype(np.int32),
        edge_stiffness=k,
        edge_compliance=alpha,
        incident=incident,
        incident_sign=sign,
        grid_shape=None,
        grid_spacing=None,
        edge_classes_present=tuple(sorted(
            set(host.edge_classes_present) | {EDGE_STRUCTURAL})),
    )


def anchor(
    host: HostTopology,
    ids,
    points=None,
    *,
    stiffness: Optional[float] = None,
    compliance: Optional[float] = None,
    rest_length=None,
) -> HostTopology:
    """Elastic world anchors — the Unity SpringJoint-to-a-fixed-point
    analogue: tie vertices to world-space points with springs.

    For each ``ids[i]`` one PINNED phantom vertex is appended at
    ``points[i]`` (default: the vertex's own rest position) and connected
    by a structural spring, so anchors reuse the ordinary spring/XPBD
    semantics on every solver and device path — no new physics.
    ``rest_length`` defaults to the current vertex↔point distance (a slack
    tether); ``0.0`` pulls the vertex onto the point.  ``stiffness`` /
    ``compliance`` default like :func:`stitch` (mean structural).

    The phantom vertices are pins: animate them with
    :func:`softbodyunity_tpu.api.move_pins` for an elastic drag handle
    (vs the rigid grab of pinning the vertex itself).  Returns a new
    HostTopology with N + len(ids) vertices; the anchors' vertex ids are
    ``range(N, N + len(ids))`` in order.
    """
    ids = np.asarray(ids, np.int64).reshape(-1)
    n = host.positions0.shape[0]
    if ids.size == 0:
        return host
    if ((ids < 0) | (ids >= n)).any():
        raise ValueError(f"anchor vertex id out of range [0, {n})")
    if points is None:
        points = host.positions0[ids]
    points = np.asarray(points, np.float64).reshape(-1, 3)
    if points.shape[0] != ids.size:
        raise ValueError("points must pair 1:1 with ids")
    if rest_length is None:
        rest_length = np.linalg.norm(host.positions0[ids] - points, axis=1)

    phantom_ids = np.arange(n, n + ids.size, dtype=np.int64)
    out = dataclasses.replace(
        host,
        positions0=np.concatenate([host.positions0, points]),
        inv_mass=np.concatenate([host.inv_mass, np.zeros(ids.size)]),
    )
    # incidence for the enlarged vertex set is rebuilt by stitch below
    return stitch(
        out, ids, phantom_ids,
        stiffness=stiffness, compliance=compliance, rest_length=rest_length,
    )


def attach(
    host: HostTopology,
    ids,
    sphere_ids,
    points=None,
) -> HostTopology:
    """Weld cloth vertices to a rigid sphere's BODY FRAME — the Unity
    FixedJoint-to-a-Rigidbody analogue for the coupled solvers
    (:func:`softbodyunity_tpu.api.step_coupled`): cloth straps holding a
    swinging ball, a parachute payload, a wrecking ball on a cloth rope.

    ``ids[i]`` is welded to the point ``points[i]`` (world space, default:
    the vertex's own rest position) expressed in sphere ``sphere_ids[i]``'s
    body frame, so the attachment point RIDES the ball's rotation (balls
    carry an orientation quaternion in :class:`~softbodyunity_tpu.solver.
    rigid.RigidState`).  The weld is two-way: each substep solves the
    vertex<->body constraint with the exact rigid-body inverse-mass matrix
    (Sherman-Morrison closed form), splitting the correction between the
    vertex, the ball's center, and the ball's orientation by their
    generalized inverse masses — a kinematic ball (``inv_mass = 0``) drags
    the cloth like :func:`softbodyunity_tpu.api.move_pins`; a pinned
    vertex anchors the ball.

    Attachments are ignored by the plain (kinematic-sphere) ``step``;
    they bind only under ``step_coupled``.  Returns a new HostTopology;
    composable — repeated calls concatenate.
    """
    ids = np.asarray(ids, np.int64).reshape(-1)
    sphere_ids = np.asarray(sphere_ids, np.int64).reshape(-1)
    n = host.positions0.shape[0]
    n_s = np.asarray(host.sphere_radii).shape[0]
    if ids.size == 0:
        return host
    if sphere_ids.size == 1 and ids.size > 1:
        sphere_ids = np.full(ids.size, sphere_ids[0], np.int64)
    if sphere_ids.size != ids.size:
        raise ValueError("sphere_ids must pair 1:1 with ids (or be scalar)")
    if ((ids < 0) | (ids >= n)).any():
        raise ValueError(f"attach vertex id out of range [0, {n})")
    if ((sphere_ids < 0) | (sphere_ids >= n_s)).any():
        raise ValueError(
            f"attach sphere id out of range [0, {n_s}) — attachments bind "
            f"to the scene's spheres (add them to the builder first)")
    if points is None:
        points = host.positions0[ids]
    points = np.asarray(points, np.float64).reshape(-1, 3)
    if points.shape[0] != ids.size:
        raise ValueError("points must pair 1:1 with ids")
    # body frame at build time = identity orientation at the rest center
    local = points - np.asarray(host.sphere_centers, np.float64)[sphere_ids]
    out = dataclasses.replace(host)
    out.attach_ids = (ids if host.attach_ids is None
                      else np.concatenate([host.attach_ids, ids]))
    out.attach_body = (sphere_ids if host.attach_body is None
                       else np.concatenate([host.attach_body, sphere_ids]))
    out.attach_local = (local if host.attach_local is None
                        else np.concatenate([host.attach_local, local]))
    return out


def attach_box(
    host: HostTopology,
    ids,
    box_ids,
    points=None,
) -> HostTopology:
    """Weld cloth vertices to a rigid BOX's body frame — :func:`attach`
    for the scene's oriented boxes (promote them with
    ``make_rigid_state(box_masses=...)``): a parachute canopy strapped to
    a crate, a tarp over a tumbling load, a flag on a crate corner.

    ``ids[i]`` is welded to ``points[i]`` (world space, default: the
    vertex's own rest position) expressed in box ``box_ids[i]``'s body
    frame — local coords in the BUILD-POSE axes ``R0 = box_rotations``,
    world point at time t = ``bc + R(q) R0 local`` — so the weld rides
    the crate's full orientation.  Two-way: the constraint solves with
    the box's anisotropic inverse inertia (exact 3x3 generalized-mass
    solve, cofactor closed form), splitting the correction between the
    vertex, the box center, and the box orientation; a kinematic box
    drags the cloth, a pinned vertex anchors the box.

    Ignored by the plain ``step``; binds only under ``step_coupled``
    with dynamic boxes.  Composable — repeated calls concatenate."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    box_ids = np.asarray(box_ids, np.int64).reshape(-1)
    n = host.positions0.shape[0]
    if host.box_centers is None:
        raise ValueError("attach_box needs box colliders on the scene "
                         "(add_colliders(box_centers=...))")
    n_b = np.asarray(host.box_centers).shape[0]
    if ids.size == 0:
        return host
    if box_ids.size == 1 and ids.size > 1:
        box_ids = np.full(ids.size, box_ids[0], np.int64)
    if box_ids.size != ids.size:
        raise ValueError("box_ids must pair 1:1 with ids (or be scalar)")
    if ((ids < 0) | (ids >= n)).any():
        raise ValueError(f"attach_box vertex id out of range [0, {n})")
    if ((box_ids < 0) | (box_ids >= n_b)).any():
        raise ValueError(f"attach_box box id out of range [0, {n_b})")
    if points is None:
        points = host.positions0[ids]
    points = np.asarray(points, np.float64).reshape(-1, 3)
    if points.shape[0] != ids.size:
        raise ValueError("points must pair 1:1 with ids")
    # local coords in the build-pose axes: R0^T (p - c0) per attachment
    c0 = np.asarray(host.box_centers, np.float64)[box_ids]
    r0 = np.asarray(host.box_rotations, np.float64)[box_ids]
    local = np.einsum("aji,aj->ai", r0, points - c0)  # R0^T (p - c0)
    out = dataclasses.replace(host)
    out.attach_box_ids = (ids if host.attach_box_ids is None
                          else np.concatenate([host.attach_box_ids, ids]))
    out.attach_box_body = (
        box_ids if host.attach_box_body is None
        else np.concatenate([host.attach_box_body, box_ids]))
    out.attach_box_local = (
        local if host.attach_box_local is None
        else np.concatenate([host.attach_box_local, local]))
    return out


def add_rigid_joint(
    host: HostTopology,
    body_a,
    body_b=None,
    *,
    point=None,
    point_b=None,
    axis=None,
    kind=None,
    rest_length=None,
    compliance=0.0,
    limits=None,
    motor_speed=None,
    motor_max_torque=None,
) -> HostTopology:
    """Join two DYNAMIC rigid bodies (or one body and the world) with a
    joint — the Unity Joint-component analogues for the coupled solvers
    (:func:`softbodyunity_tpu.api.step_coupled`; promote the scene's
    spheres/boxes to rigid bodies with ``make_rigid_state``):

    * ``kind="ball"`` (default): ball-socket / point-to-point anchor
      (``FixedJoint``-style anchor without the rotation lock): the two
      bodies share the world anchor ``point`` (build pose); each body
      stores it in its own frame, so the anchor rides both orientations.
      Chains of ball joints make pendulums, ropes of crates, flails.
    * ``kind="hinge"``: ball anchor + axis alignment (``HingeJoint``):
      ``axis`` (world, build pose) is stored in both body frames and the
      solver removes the misalignment ``a_w x b_w`` each substep — a door
      on a post, a seesaw, a swinging gate.  ``limits=(lo, hi)`` (rad)
      clamps the relative hinge angle (measured from the build pose,
      positive = body a rotated by +axis relative to body b) with the
      same angular generalized-inverse-mass correction; ``motor_speed``
      (rad/s) + ``motor_max_torque`` (N*m, required with motor_speed)
      drive the relative angular velocity about the axis toward the
      target with a velocity-level angular impulse clamped to
      ``max_torque * dt`` per substep — Unity's useLimits/useMotor.
    * ``kind="distance"``: a rod/spring (``SpringJoint``): keeps
      ``|p_a - p_b| = rest_length`` between anchor ``point`` (on body a)
      and ``point_b`` (on body b, or the world point for a world side);
      ``compliance`` (XPBD alpha, meters/newton) softens it — 0 is a
      rigid rod, larger values a weaker spring (each substep closes the
      fraction ``w_eff / (w_eff + compliance/dt^2)`` of the error).

    ``body_a`` / ``body_b`` are ``("sphere", i)`` or ``("box", i)`` refs
    into the scene's collider arrays; ``body_b=None`` anchors to the
    WORLD (a fixed point / axis).  Kind inference: ``axis`` given ->
    hinge; ``rest_length`` or ``point_b`` given -> distance; else ball.

    Joints are ignored by the plain (static-collider) ``step``; they bind
    only under ``step_coupled``, where every referenced body must be
    promoted (kinematic bodies — ``inv_mass = 0`` — anchor without
    reacting).  Solved sequentially (Gauss-Seidel in joint-index order),
    one pass per substep, position-level with /dt velocity updates; the
    binding semantics are ``oracle.reference._solve_rigid_joints``.
    Composable — repeated calls concatenate."""
    if kind is None:
        kind = ("hinge" if axis is not None
                else "distance" if (rest_length is not None
                                    or point_b is not None) else "ball")
    if kind not in ("ball", "hinge", "distance"):
        raise ValueError(f"unknown joint kind {kind!r}")

    n_s = np.asarray(host.sphere_radii).shape[0]
    n_b = (0 if host.box_centers is None
           else np.asarray(host.box_centers).shape[0])

    def _ref(body, name):
        if body is None:
            return ("world", 0)
        try:
            bkind, idx = body
        except (TypeError, ValueError):
            raise ValueError(
                f"{name} must be ('sphere', i), ('box', i), or None "
                f"(world), got {body!r}")
        idx = int(idx)
        if bkind == "sphere":
            if not 0 <= idx < n_s:
                raise ValueError(
                    f"{name}: sphere id {idx} out of range [0, {n_s})")
        elif bkind == "box":
            if not 0 <= idx < n_b:
                raise ValueError(
                    f"{name}: box id {idx} out of range [0, {n_b})")
        else:
            raise ValueError(f"{name}: unknown body kind {bkind!r}")
        return (bkind, idx)

    kind_a, ia = _ref(body_a, "body_a")
    if kind_a == "world":
        raise ValueError("body_a must be a rigid body (swap the sides to "
                         "anchor to the world)")
    kind_b, ib = _ref(body_b, "body_b")

    def _center(bkind, i):
        if bkind == "sphere":
            return np.asarray(host.sphere_centers, np.float64)[i]
        return np.asarray(host.box_centers, np.float64)[i]

    def _to_frame(bkind, i, vec, is_point):
        """World vector/point (build pose) -> the body's frame."""
        if bkind == "world":
            return np.asarray(vec, np.float64)
        v = np.asarray(vec, np.float64)
        if is_point:
            v = v - _center(bkind, i)
        if bkind == "box":
            r0 = np.asarray(host.box_rotations, np.float64)[i]
            v = r0.T @ v
        return v

    if kind == "distance":
        if point is None:
            point = _center(kind_a, ia)
        if point_b is None:
            if kind_b == "world":
                raise ValueError(
                    "distance joint to the world needs point_b (the fixed "
                    "world anchor)")
            point_b = _center(kind_b, ib)
        p_a = np.asarray(point, np.float64).reshape(3)
        p_b = np.asarray(point_b, np.float64).reshape(3)
        if rest_length is None:
            rest_length = float(np.linalg.norm(p_a - p_b))
        local_a = _to_frame(kind_a, ia, p_a, True)
        local_b = _to_frame(kind_b, ib, p_b, True)
        ax_a = ax_b = np.zeros(3)
    else:
        if point is None:
            raise ValueError(f"{kind} joint needs the shared world anchor "
                             f"`point` (build pose)")
        p = np.asarray(point, np.float64).reshape(3)
        local_a = _to_frame(kind_a, ia, p, True)
        local_b = _to_frame(kind_b, ib, p, True)
        rest_length = 0.0
        if kind == "hinge":
            ax = np.asarray(axis, np.float64).reshape(3)
            nrm = np.linalg.norm(ax)
            if not nrm > 0.0:
                raise ValueError("hinge axis must be nonzero")
            ax = ax / nrm
            ax_a = _to_frame(kind_a, ia, ax, False)
            ax_b = _to_frame(kind_b, ib, ax, False)
        else:
            ax_a = ax_b = np.zeros(3)
    if compliance < 0.0:
        raise ValueError("compliance must be >= 0")
    ref_a = ref_b = np.zeros(3)
    limit = np.asarray([1.0, -1.0])           # lo > hi: limits off
    motor = np.zeros(2)                       # max torque 0: motor off
    if limits is not None or motor_speed is not None:
        if kind != "hinge":
            raise ValueError("limits/motor apply to hinge joints only")
        # angle reference: any world unit vector perpendicular to the
        # axis (the same vector in both frames => build pose = angle 0)
        e = np.zeros(3)
        e[int(np.argmin(np.abs(ax)))] = 1.0
        r = e - (e @ ax) * ax
        r = r / np.linalg.norm(r)
        ref_a = _to_frame(kind_a, ia, r, False)
        ref_b = _to_frame(kind_b, ib, r, False)
        if limits is not None:
            lo, hi = float(limits[0]), float(limits[1])
            if not lo <= hi:
                raise ValueError("limits must be (lo, hi) with lo <= hi")
            limit = np.asarray([lo, hi])
        if motor_speed is not None:
            if motor_max_torque is None or not motor_max_torque > 0.0:
                raise ValueError(
                    "motor_speed needs motor_max_torque > 0 (N*m)")
            motor = np.asarray([float(motor_speed),
                                float(motor_max_torque)])

    meta = ((kind, kind_a, ia, kind_b, ib),)
    rec = dict(
        joint_local_a=local_a[None, :], joint_local_b=local_b[None, :],
        joint_axis_a=ax_a[None, :], joint_axis_b=ax_b[None, :],
        joint_rest=np.asarray([rest_length], np.float64),
        joint_compliance=np.asarray([float(compliance)], np.float64),
        joint_ref_a=ref_a[None, :], joint_ref_b=ref_b[None, :],
        joint_limit=limit[None, :], joint_motor=motor[None, :],
    )
    out = dataclasses.replace(host)
    out.joint_meta = (meta if host.joint_meta is None
                      else host.joint_meta + meta)
    for name, arr in rec.items():
        prev = getattr(host, name)
        setattr(out, name,
                arr if prev is None else np.concatenate([prev, arr]))
    return out
