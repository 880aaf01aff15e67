"""Public API: ``init`` / ``step`` / ``rollout`` / ``normals``.

Mirrors the reference's scene/state model (BASELINE.json:5): ``init``
replaces ``MonoBehaviour.Start()`` (topology built host-side once, then
moved to HBM), ``step(state, dt, n_substeps)`` replaces
``FixedUpdate()`` + the inner substep loop, jit-compiled with ``lax.scan``
over substeps and ``vmap``-able over batched scenes.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .core.config import SimConfig
from .core.state import State, make_state
from .core.topology import HostTopology, Topology
from .solver import step as _step_mod
from .solver.normals import vertex_normals as _vertex_normals


def suggest_dt(host: HostTopology, cfg: SimConfig, *,
               safety: float = 0.35) -> float:
    """Largest stable substep dt for explicit integration on this scene.

    Explicit integration is stable for ``dt < 2 / omega_max``.  A single
    spring's ``omega = sqrt(k (w_a + w_b))`` underestimates a NETWORK by
    several x (neighbours moving in antiphase stack stiffness), so the
    bound uses the Gershgorin estimate of the spring Jacobian's largest
    eigenvalue: ``omega_max^2 <= 2 * max_i (w_i * sum_{e at i} k_e)``.
    Constraint projections (volume, XPBD) are unconditionally stable and
    don't tighten it.  ``safety`` (default 0.35) leaves headroom for
    spring damping, contact kicks, and wind: the hand-tuned presets sit
    at 0.04-0.70 of the Gershgorin bound, and the 262k/1M cloths blow up
    by frame ~12 at ~0.77 of it (PERF.md, "Counts that do not depend on the chip"), so 0.35
    keeps every measured scene comfortably stable.

    Host-side utility (f64, runs once at setup):

        dt = sb.suggest_dt(host, cfg)
        state = sb.step(top, cfg, state, dt=dt, n_substeps=16)
    """
    k = np.asarray(host.edge_stiffness, np.float64)
    if host.edges.shape[0] == 0 or float(k.max(initial=0.0)) <= 0.0:
        return float(cfg.dt)
    w = np.asarray(host.inv_mass, np.float64)
    k_sum = np.zeros_like(w)
    np.add.at(k_sum, host.edges[:, 0], k)
    np.add.at(k_sum, host.edges[:, 1], k)
    omega_max = float(np.sqrt(2.0 * (w * k_sum).max()))
    if omega_max <= 0.0:
        return float(cfg.dt)
    return float(safety * 2.0 / omega_max)


def _kron_fields(host: HostTopology, f32):
    """Kronecker shape-match factors for raster lattices (see
    solver/shapematch.py::kron_factors_host) — built HERE because this is
    the last point where cluster_id is concrete (under jit dispatch the
    Topology arrays are tracers)."""
    shape = getattr(host, "lattice_shape", None)
    if (host.cluster_id is None or shape is None
            or shape[0] * shape[1] * shape[2]
            != host.positions0.shape[0]):
        return {}
    from .solver.shapematch import kron_factors_host

    factors = kron_factors_host(host.cluster_id, shape, host.n_clusters)
    if factors is None:
        return {}
    ox, oy, oz, occ = factors
    return dict(cluster_kron_x=f32(ox), cluster_kron_y=f32(oy),
                cluster_kron_z=f32(oz), cluster_kron_cells=f32(occ))


def device_topology(host: HostTopology, dtype=jnp.float32) -> Topology:
    """Cast the float64 host topology to device arrays (f32 for the perf
    path; tests pass f64 to prove exact semantic parity with the oracle)."""
    from .solver.banded import build_offset_groups, build_tet_groups

    f32 = lambda a: jnp.asarray(np.asarray(a), dtype=dtype)
    i32 = lambda a: jnp.asarray(np.asarray(a), dtype=jnp.int32)
    n = host.positions0.shape[0]
    # Large structured grids always dispatch to the stencil/Pallas fast
    # paths and never read the banded planes — skip building the four
    # [G, N] planes (~150 MB HBM + host time for the 1M preset).
    build_banded = host.grid_shape is None or n <= 65536
    if build_banded:
        groups = build_offset_groups(
            n, np.asarray(host.edges),
            np.asarray(host.rest_length), np.asarray(host.edge_stiffness),
            np.asarray(host.edge_compliance),
        )
        tgroups = build_tet_groups(
            n, np.asarray(host.tets), np.asarray(host.rest_volume)
        )
    else:
        groups = None
        tgroups = None
    return Topology(
        offset_groups=groups,
        tet_groups=tgroups,
        edges=i32(host.edges),
        rest_length=f32(host.rest_length),
        edge_class=i32(host.edge_class),
        edge_stiffness=f32(host.edge_stiffness),
        edge_compliance=f32(host.edge_compliance),
        inv_mass=f32(host.inv_mass),
        incident=i32(host.incident),
        incident_sign=f32(host.incident_sign),
        tets=i32(host.tets),
        rest_volume=f32(host.rest_volume),
        triangles=i32(host.triangles),
        plane_height=f32(host.plane_height),
        sphere_centers=f32(host.sphere_centers),
        sphere_radii=f32(host.sphere_radii),
        capsule_p0=f32(host.capsule_p0 if host.capsule_p0 is not None
                       else np.zeros((0, 3))),
        capsule_p1=f32(host.capsule_p1 if host.capsule_p1 is not None
                       else np.zeros((0, 3))),
        capsule_radii=f32(host.capsule_radii if host.capsule_radii is not None
                          else np.zeros((0,))),
        box_centers=f32(host.box_centers if host.box_centers is not None
                        else np.zeros((0, 3))),
        box_half_extents=f32(
            host.box_half_extents if host.box_half_extents is not None
            else np.zeros((0, 3))
        ),
        box_rotations=f32(host.box_rotations if host.box_rotations is not None
                          else np.zeros((0, 3, 3))),
        tri_body=(i32(host.tri_body) if host.tri_body is not None
                  else None),
        pressure_rest_volume=(
            f32(host.pressure_rest_volume)
            if host.pressure_rest_volume is not None else None
        ),
        sdf_grids=(f32(host.sdf_grids) if host.sdf_grids is not None
                   else None),
        sdf_origins=(f32(host.sdf_origins) if host.sdf_origins is not None
                     else None),
        sdf_spacings=(f32(host.sdf_spacings)
                      if host.sdf_spacings is not None else None),
        plane_velocity=f32(host.plane_velocity
                           if host.plane_velocity is not None
                           else np.zeros(3)),
        sphere_velocities=f32(
            host.sphere_velocities if host.sphere_velocities is not None
            else np.zeros((np.asarray(host.sphere_radii).shape[0], 3))
        ),
        capsule_velocities=f32(
            host.capsule_velocities if host.capsule_velocities is not None
            else np.zeros((np.asarray(host.capsule_radii).shape[0]
                           if host.capsule_radii is not None else 0, 3))
        ),
        box_velocities=f32(
            host.box_velocities if host.box_velocities is not None
            else np.zeros((np.asarray(host.box_centers).shape[0]
                           if host.box_centers is not None else 0, 3))
        ),
        sdf_velocities=(
            f32(host.sdf_velocities if host.sdf_velocities is not None
                else np.zeros((np.asarray(host.sdf_spacings).shape[0], 3)))
            if host.sdf_spacings is not None else None
        ),
        attach_ids=(i32(host.attach_ids) if host.attach_ids is not None
                    else None),
        attach_body=(i32(host.attach_body) if host.attach_body is not None
                     else None),
        attach_local=(f32(host.attach_local)
                      if host.attach_local is not None else None),
        attach_box_ids=(i32(host.attach_box_ids)
                        if host.attach_box_ids is not None else None),
        attach_box_body=(i32(host.attach_box_body)
                         if host.attach_box_body is not None else None),
        attach_box_local=(f32(host.attach_box_local)
                          if host.attach_box_local is not None else None),
        joint_meta=host.joint_meta,
        joint_local_a=(f32(host.joint_local_a)
                       if host.joint_local_a is not None else None),
        joint_local_b=(f32(host.joint_local_b)
                       if host.joint_local_b is not None else None),
        joint_axis_a=(f32(host.joint_axis_a)
                      if host.joint_axis_a is not None else None),
        joint_axis_b=(f32(host.joint_axis_b)
                      if host.joint_axis_b is not None else None),
        joint_rest=(f32(host.joint_rest)
                    if host.joint_rest is not None else None),
        joint_compliance=(f32(host.joint_compliance)
                          if host.joint_compliance is not None else None),
        joint_ref_a=(f32(host.joint_ref_a)
                     if host.joint_ref_a is not None else None),
        joint_ref_b=(f32(host.joint_ref_b)
                     if host.joint_ref_b is not None else None),
        joint_limit=(f32(host.joint_limit)
                     if host.joint_limit is not None else None),
        joint_motor=(f32(host.joint_motor)
                     if host.joint_motor is not None else None),
        cluster_id=(i32(host.cluster_id) if host.cluster_id is not None
                    else None),
        cluster_rest=(f32(host.cluster_rest)
                      if host.cluster_rest is not None else None),
        **_kron_fields(host, f32),
        tether_anchor=(f32(host.tether_anchor)
                       if getattr(host, "tether_anchor", None) is not None
                       else None),
        tether_radius=(f32(host.tether_radius)
                       if getattr(host, "tether_radius", None) is not None
                       else None),
        n_clusters=host.n_clusters,
        n_vertices=host.positions0.shape[0],
        grid_shape=host.grid_shape,
        grid_spacing=host.grid_spacing,
        lattice_shape=getattr(host, "lattice_shape", None),
        edge_classes_present=host.edge_classes_present,
    )


def init(host: HostTopology, dtype=jnp.float32) -> Tuple[Topology, State]:
    """Build device topology + rest state; the one host->device boundary
    (BASELINE.json:5 "loaded once to HBM")."""
    top = device_topology(host, dtype=dtype)
    state = make_state(host.positions0, dtype=dtype)
    return jax.device_put(top), jax.device_put(state)


@functools.lru_cache(maxsize=64)
def _compiled_step(cfg: SimConfig, dt: float, n_substeps: int):
    """One jitted executable per (cfg, dt, n_substeps) triple."""

    def impl(top: Topology, state: State) -> State:
        return _dispatch_step(top, cfg, state, dt, n_substeps)

    return jax.jit(impl)


def _dispatch_step(top, cfg, state, dt, n_substeps):
    """Backend dispatch: structured-grid scenes take the stencil path
    (``backend`` "auto" or "stencil"); everything else, and
    ``backend="jnp"``, takes the general jnp/banded path."""
    if cfg.backend in ("auto", "stencil"):
        from .kernels import dispatch as _kdispatch

        fast = _kdispatch.maybe_fast_step(top, cfg)
        if fast is not None:
            return fast(state, dt, n_substeps)
    return _step_mod.step_scan(top, cfg, state, dt, n_substeps)


def ensure_tear_state(top: Topology, cfg: SimConfig, state: State) -> State:
    """Populate ``State.edge_alive`` (all edges live) when a tearing config
    meets a state without it — OUTSIDE jit, because the pytree structure
    changes.  No-op otherwise."""
    if cfg.tear.enabled and state.edge_alive is None:
        alive = jnp.ones((top.edges.shape[0],), state.x.dtype)
        state = state.replace(edge_alive=alive)
    return state


def ensure_plastic_state(top: Topology, cfg: SimConfig, state: State) -> State:
    """Populate ``State.rest_scale`` (all ones) when a plasticity config
    meets a state without it — OUTSIDE jit (pytree structure changes)."""
    if cfg.plasticity.enabled and state.rest_scale is None:
        scale = jnp.ones((top.edges.shape[0],), state.x.dtype)
        state = state.replace(rest_scale=scale)
    return state


def ensure_shapematch_state(top: Topology, cfg: SimConfig,
                            state: State) -> State:
    """Populate ``State.cluster_quat`` (identity rotations) when a
    shape-matching config meets a state without it — OUTSIDE jit (pytree
    structure changes).  No-op when the scene has no clusters
    (``enable_shape_matching`` was never called)."""
    if (cfg.shape_match.enabled and top.n_clusters > 0
            and state.cluster_quat is None):
        q = jnp.zeros((top.n_clusters, 4), state.x.dtype).at[:, 0].set(1.0)
        state = state.replace(cluster_quat=q)
    return state


def step(
    top: Topology,
    cfg: SimConfig,
    state: State,
    dt: Optional[float] = None,
    n_substeps: Optional[int] = None,
) -> State:
    """Advance one frame: ``n_substeps`` substeps of size ``dt``."""
    dt = cfg.dt if dt is None else float(dt)
    n = cfg.n_substeps if n_substeps is None else int(n_substeps)
    state = ensure_tear_state(top, cfg, state)
    state = ensure_plastic_state(top, cfg, state)
    state = ensure_shapematch_state(top, cfg, state)
    return _compiled_step(cfg, dt, n)(top, state)


@functools.lru_cache(maxsize=32)
def _compiled_rollout(cfg: SimConfig, dt: float, n_substeps: int, n_steps: int):
    """One jitted executable per rollout signature — repeated rollouts must
    not retrace/recompile the full n_steps scan."""

    def impl(top, state):
        def body(s, _):
            s2 = _dispatch_step(top, cfg, s, dt, n_substeps)
            return s2, s2.x

        return jax.lax.scan(body, state, None, length=n_steps)

    return jax.jit(impl)


def rollout(
    top: Topology,
    cfg: SimConfig,
    state: State,
    n_steps: int,
    dt: Optional[float] = None,
    n_substeps: Optional[int] = None,
):
    """Scan ``n_steps`` frames on-device; returns (final_state, xs[n_steps,N,3])."""
    dt = cfg.dt if dt is None else float(dt)
    n = cfg.n_substeps if n_substeps is None else int(n_substeps)
    state = ensure_tear_state(top, cfg, state)
    state = ensure_plastic_state(top, cfg, state)
    state = ensure_shapematch_state(top, cfg, state)
    return _compiled_rollout(cfg, dt, n, int(n_steps))(top, state)


@functools.lru_cache(maxsize=32)
def _compiled_coupled_step(cfg: SimConfig, dt: float, n_substeps: int):
    from .solver.rigid import step_coupled_scan

    def impl(top, state, rigid):
        return step_coupled_scan(top, cfg, state, rigid, dt, n_substeps)

    return jax.jit(impl)


def step_coupled(top: Topology, cfg: SimConfig, state: State, rigid,
                 dt: Optional[float] = None,
                 n_substeps: Optional[int] = None):
    """Advance cloth AND dynamic rigid bodies one frame, two-way coupled
    on-device (oracle ``substep_euler_coupled`` semantics: momentum
    exchange inside every substep, zero host round-trips).

    ``rigid`` is a :class:`~softbodyunity_tpu.solver.rigid.RigidState`
    (build with :func:`~softbodyunity_tpu.solver.rigid.make_rigid_state`);
    returns ``(state, rigid)``.  The scene's spheres are always promoted;
    ``make_rigid_state(box_masses=...)`` promotes its oriented boxes too
    (tumbling crates with solid-box inertia, box-plane corner bounce).
    All three solvers: Euler exchanges velocity-level impulses (spin
    drags the cloth); Verlet/XPBD exchange the position-projection
    impulses ``sum m_i dx_i / dt`` (XPBD reacting inside each Jacobi
    iteration) — no spin-drag there, since position projection carries
    no surface-velocity term."""
    dt = cfg.dt if dt is None else float(dt)
    n = cfg.n_substeps if n_substeps is None else int(n_substeps)
    state = ensure_tear_state(top, cfg, state)
    state = ensure_plastic_state(top, cfg, state)
    state = ensure_shapematch_state(top, cfg, state)
    return _compiled_coupled_step(cfg, dt, n)(top, state, rigid)


def normals(top: Topology, state: State) -> jax.Array:
    """Vertex normals for rendering (Unity RecalculateNormals analogue)."""
    return jax.jit(_vertex_normals)(top.triangles, state.x)


def raycast(top: Topology, state: State, origin, direction):
    """Nearest ray hit on the deformed mesh (Physics.Raycast analogue).

    Returns a :class:`~softbodyunity_tpu.solver.raycast.RayHit`
    (``t, tri, u, v, point``; ``t = inf``/``tri = -1`` on a miss).
    Oracle twin: ``oracle/reference.py::raycast``.
    """
    from .solver.raycast import raycast as _raycast

    return jax.jit(_raycast)(
        top.triangles, state.x,
        jnp.asarray(origin, dtype=state.x.dtype),
        jnp.asarray(direction, dtype=state.x.dtype),
    )


def apply_impulse(top: Topology, state: State, delta_v, indices=None,
                  center=None, radius: float = 0.0) -> State:
    """Instantaneous velocity impulse — the projectile-hit / explosion
    interaction (Unity ``AddForce(..., ForceMode.VelocityChange)``).

    Two forms:

    * ``indices`` i32[K] + ``delta_v`` f32[K, 3] (or [3], broadcast):
      targeted kick on specific vertices.
    * ``center`` [3] + ``radius`` + ``delta_v`` [3]: radial blast — every
      vertex within ``radius`` of ``center`` receives ``delta_v`` scaled
      by ``1 - dist/radius`` (linear falloff).

    Pinned vertices (inv_mass == 0) never move.  Pure function of State —
    jit/vmap-friendly, static shapes.
    """
    dv = jnp.asarray(delta_v, dtype=state.v.dtype)
    movable = (top.inv_mass > 0.0)[:, None]
    if center is not None:
        c = jnp.asarray(center, dtype=state.x.dtype)
        dist = jnp.linalg.norm(state.x - c[None, :], axis=1)
        w = jnp.maximum(1.0 - dist / radius, 0.0)[:, None]
        v = state.v + jnp.where(movable, w * dv[None, :], 0.0)
    else:
        idx = jnp.asarray(indices, dtype=jnp.int32)
        upd = jnp.where(movable[idx], jnp.broadcast_to(dv, (idx.shape[0], 3)),
                        0.0)
        v = state.v.at[idx].add(upd)
    return state.replace(v=v)


def pick_vertex(top: Topology, state: State, origin, direction) -> jax.Array:
    """Vertex id to grab along a ray (i32, -1 on miss) — feed into
    :func:`move_pins` for mouse-drag interactions."""
    from .solver.raycast import pick_vertex as _pick

    return jax.jit(_pick)(
        top.triangles, state.x,
        jnp.asarray(origin, dtype=state.x.dtype),
        jnp.asarray(direction, dtype=state.x.dtype),
    )


def move_pins(top: Topology, state: State, positions, indices) -> State:
    """Kinematic attachments (the Unity moving-anchor analogue): teleport
    pinned vertices to new targets between frames.

    ``indices`` are vertex ids with ``inv_mass == 0`` (pins; derive once on
    the host from ``host.inv_mass == 0``); ``positions`` is f32[len, 3].
    Position and Verlet history move together and velocity zeroes, so every
    solver sees a clean kinematic boundary condition; the cloth follows
    through the spring forces next step.  Pure function — jit/vmap-safe and
    recompile-free (shapes unchanged)."""
    idx = jnp.asarray(indices, jnp.int32)
    pos = jnp.asarray(positions, state.x.dtype)
    return state.replace(
        x=state.x.at[idx].set(pos),
        x_prev=state.x_prev.at[idx].set(pos),
        v=state.v.at[idx].set(0.0),
    )


def move_colliders(
    top: Topology,
    sphere_centers=None,
    sphere_radii=None,
    plane_height=None,
    capsule_p0=None,
    capsule_p1=None,
    capsule_radii=None,
    box_centers=None,
    box_half_extents=None,
    box_rotations=None,
    sdf_origins=None,
    plane_velocity=None,
    sphere_velocities=None,
    capsule_velocities=None,
    box_velocities=None,
    sdf_velocities=None,
) -> Topology:
    """Animated colliders (the Unity moving-Collider analogue): collider
    geometry is *array data* on Topology, so replacing it between frames
    changes the scene without recompiling ``step`` (shapes unchanged =>
    same executable).  Works under vmap/sharding too: batched scenes may
    each carry their own sphere positions.

    The ``*_velocities`` arrays are the colliders' kinematic velocities:
    the velocity-level (Euler) contact response runs relative to them, so
    a dragged sphere carries the cloth with friction and a
    ``plane_velocity`` makes the ground a conveyor belt.  When animating
    geometry between frames, also set the matching velocity
    (``(new - old) / frame_dt``) for physically consistent contact;
    Verlet/XPBD get moving-collider response implicitly from the position
    projection and ignore these."""
    import dataclasses

    f32 = top.plane_height.dtype
    kw = {}
    for name, val in (
        ("sphere_centers", sphere_centers),
        ("sphere_radii", sphere_radii),
        ("plane_height", plane_height),
        ("capsule_p0", capsule_p0),
        ("capsule_p1", capsule_p1),
        ("capsule_radii", capsule_radii),
        ("box_centers", box_centers),
        ("box_half_extents", box_half_extents),
        ("box_rotations", box_rotations),
        ("sdf_origins", sdf_origins),
        ("plane_velocity", plane_velocity),
        ("sphere_velocities", sphere_velocities),
        ("capsule_velocities", capsule_velocities),
        ("box_velocities", box_velocities),
        ("sdf_velocities", sdf_velocities),
    ):
        if val is not None:
            kw[name] = jnp.asarray(val, f32)
    return dataclasses.replace(top, **kw)


def move_tethers(top: Topology, anchors=None, radii=None,
                 indices=None) -> Topology:
    """Animate the motion-constraint tether anchors/radii (the per-frame
    skinned-body targets of Unity Cloth's ``maxDistance``): array data on
    Topology, zero recompiles, vmap/sharding-safe.  ``indices`` updates a
    subset (anchors/radii then have one row per index); the topology must
    already carry constraints (``set_motion_constraints``)."""
    import dataclasses

    if top.tether_anchor is None:
        raise ValueError(
            "move_tethers: topology has no motion constraints; build with "
            "core.topology.set_motion_constraints first")
    f32 = top.tether_anchor.dtype
    kw = {}
    if anchors is not None:
        a = jnp.asarray(anchors, f32)
        kw["tether_anchor"] = (top.tether_anchor.at[indices].set(a)
                               if indices is not None else a)
    if radii is not None:
        r = jnp.asarray(radii, f32)
        kw["tether_radius"] = (top.tether_radius.at[indices].set(r)
                               if indices is not None else r)
    return dataclasses.replace(top, **kw)
