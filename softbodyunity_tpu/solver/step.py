"""Substep composition + the jitted stepping loop.

The reference's frame loop is ``FixedUpdate() -> for substep: {forces;
integrate; collide}`` on the CPU main thread (BASELINE.json:5 "Unity
MonoBehaviour Update calls").  Here each substep is a pure function
``(Topology, SimConfig, State) -> State`` and the frame is
``lax.scan`` over substeps under ``jit`` (BASELINE.json:5
"`step(state, dt, n_substeps)` is jit-compiled with `lax.scan` over
substeps"); semantics mirror :mod:`softbodyunity_tpu.oracle.reference`
substep-for-substep.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import SimConfig, Solver
from ..core.state import State
from ..core.topology import Topology
from . import collide, forces, hashgrid, tether, xpbd


def wind_forces(top: Topology, cfg: SimConfig, x, v):
    """Wind drag + normal-projected lift (oracle wind_forces twin)."""
    from .normals import vertex_normals

    wp = cfg.wind
    vrel = jnp.asarray(wp.velocity, dtype=v.dtype)[None, :] - v
    f = wp.drag * vrel
    if wp.lift != 0.0 and top.triangles.shape[0] > 0:
        n = vertex_normals(top.triangles, x)
        f = f + wp.lift * jnp.einsum("ij,ij->i", vrel, n)[:, None] * n
    return f


def tear_update(top: Topology, cfg: SimConfig, x, alive, rest_scale=None):
    """End-of-substep permanent edge failure (oracle tear_update twin);
    ``rest_scale`` (plasticity) rescales the rest length first."""
    a = top.edges[:, 0]
    b = top.edges[:, 1]
    length = jnp.linalg.norm(x[b] - x[a], axis=1)
    rest = (top.rest_length if rest_scale is None
            else top.rest_length * rest_scale)
    limit = rest * (1.0 + cfg.tear.strain_limit)
    return alive * (length <= limit).astype(alive.dtype)


def plastic_update(top: Topology, cfg: SimConfig, x, scale):
    """End-of-substep plastic flow (oracle plastic_update twin): edges
    strained past the yield point creep their rest-length scale toward
    the deformed length; runs BEFORE the tear check."""
    a = top.edges[:, 0]
    b = top.edges[:, 1]
    length = jnp.linalg.norm(x[b] - x[a], axis=1)
    rest = jnp.maximum(top.rest_length * scale, 1e-12)
    strain = (length - rest) / rest
    pp = cfg.plasticity
    excess = jnp.sign(strain) * jnp.maximum(jnp.abs(strain)
                                            - pp.yield_strain, 0.0)
    return jnp.clip(scale * (1.0 + pp.creep * excess),
                    pp.min_scale, pp.max_scale)


def total_forces(top: Topology, cfg: SimConfig, x, v, alive=None,
                 rest_scale=None):
    groups = top.offset_groups
    use_banded = (
        groups is not None
        and top.n_edges > 0
        and groups.n_residual <= top.n_edges // 2  # static shape decision
        and alive is None  # tearing needs per-edge masks: gather path
        and rest_scale is None  # plasticity: per-edge rest, gather path
    )
    if use_banded:
        from . import banded

        f = banded.spring_forces_banded(groups, x, v, cfg)
    else:
        f = forces.spring_forces_gather(top, x, v, cfg, alive=alive,
                                        rest_scale=rest_scale)
    if cfg.self_collision.enabled:
        f = f + self_collision_force(cfg, x)
    if cfg.wind.enabled:
        f = f + wind_forces(top, cfg, x, v)
    if cfg.pressure.enabled and top.n_pressure_bodies > 0:
        from .pressure import pressure_forces

        f = f + pressure_forces(top, cfg, x)
    return f


def self_collision_force(cfg: SimConfig, x):
    """Method-dispatched self-collision repulsion (oracle
    self_collision_forces semantics for every method)."""
    if cfg.self_collision.method == "dense":
        return forces.self_collision_forces_dense(
            x, cfg.self_collision.radius, cfg.self_collision.stiffness
        )
    if cfg.self_collision.method == "dense_mxu":
        return forces.self_collision_forces_dense_mxu(
            x, cfg.self_collision.radius, cfg.self_collision.stiffness
        )
    if cfg.self_collision.method == "block":
        from ..kernels.block_pairs import self_collision_forces_block

        return self_collision_forces_block(x, cfg.self_collision)
    if cfg.self_collision.method != "hash":
        # a typo ("dense-mxu") silently running the hash path would be a
        # different perf class AND a soft-truncated pair set with no error
        raise ValueError(
            f"unknown self-collision method {cfg.self_collision.method!r}; "
            "use 'block', 'hash', 'dense_mxu', or 'dense'"
        )
    return hashgrid.self_collision_forces_hash(x, cfg.self_collision)


def _volume_projection(top: Topology, x, stiffness: float):
    """Route to the banded (roll-based) projection when EVERY tet is
    lattice-regular (zero residual, same gate as xpbd_banded_applicable) —
    a vertex shared by banded AND residual tets would get two separately
    count-averaged corrections, deviating from the oracle semantics.
    Mixed meshes take the gather path, which matches the oracle exactly."""
    tg = top.tet_groups
    if tg is not None and len(tg.deltas) > 0 and tg.n_residual == 0:
        from . import banded

        return banded.volume_projection_banded(top, x, stiffness)
    return xpbd.volume_projection(top, x, stiffness)


def _tear_alive(cfg: SimConfig, s: State):
    """The liveness mask this substep runs with (None = tearing inactive)."""
    return s.edge_alive if cfg.tear.enabled and s.edge_alive is not None else None


def _plastic_scale(cfg: SimConfig, s: State):
    """The rest-length scale this substep runs with (None = inactive)."""
    return (s.rest_scale
            if cfg.plasticity.enabled and s.rest_scale is not None else None)


def _cluster_quats(cfg: SimConfig, s: State):
    """The shape-matching warm-start quaternions this substep runs with
    (None = shape matching inactive)."""
    return (s.cluster_quat
            if cfg.shape_match.enabled and s.cluster_quat is not None
            else None)


def euler_integrate(top: Topology, cfg: SimConfig, s: State, dt: float,
                    alive, scale):
    """The Euler substep BEFORE contact resolve: spring/feature forces,
    semi-implicit velocity+position update, tet volume projection.
    Shared by substep_euler and the coupled substep (solver/rigid.py)."""
    w = top.inv_mass[:, None]
    movable = top.inv_mass > 0.0
    g = jnp.asarray(cfg.gravity, dtype=s.x.dtype)
    f = total_forces(top, cfg, s.x, s.v, alive=alive, rest_scale=scale)
    v = (s.v + dt * (g[None, :] + f * w)) * (1.0 - cfg.global_damping * dt)
    v = jnp.where(movable[:, None], v, 0.0)
    x_prev = s.x
    x = s.x + dt * v
    if top.n_tets > 0 and cfg.volume_stiffness != 0.0:
        dx = _volume_projection(top, x, cfg.volume_stiffness)
        x = x + dx
        v = v + dx / dt
    return x, v, x_prev, movable


def finish_euler_substep(top: Topology, cfg: SimConfig, s: State, x, v,
                         x_prev, alive, scale, quats=None) -> State:
    """End-of-substep feature updates + State assembly (shared with the
    coupled substep)."""
    scale = plastic_update(top, cfg, x, scale) if scale is not None else None
    alive = (tear_update(top, cfg, x, alive, rest_scale=scale)
             if alive is not None else s.edge_alive)
    return State(x=x, v=v, x_prev=x_prev, edge_alive=alive,
                 rest_scale=scale if scale is not None else s.rest_scale,
                 cluster_quat=quats if quats is not None else s.cluster_quat)


def substep_euler(top: Topology, cfg: SimConfig, s: State, dt: float) -> State:
    alive = _tear_alive(cfg, s)
    scale = _plastic_scale(cfg, s)
    quats = _cluster_quats(cfg, s)
    x, v, x_prev, movable = euler_integrate(top, cfg, s, dt, alive, scale)
    if quats is not None:
        # shape matching after the (volume-projected) integration, before
        # collision — the contact resolve always wins (oracle substep_euler)
        from .shapematch import shape_match_dx

        dxs, quats = shape_match_dx(top, cfg, x, quats)
        x = x + dxs
        v = v + dxs / dt
    if cfg.strain_limit.enabled:
        # strain limiting after shape matching, before collision; the
        # clamp feeds back into velocity (oracle substep_euler)
        from .strainlimit import strain_limit_dx

        dxl = strain_limit_dx(top, cfg, x, alive=alive, rest_scale=scale)
        x = x + dxl
        v = v + dxl / dt
    if tether.motion_enabled(top, cfg):
        # motion constraints after strain limiting, before collision
        # (contact always wins); velocity feedback on the Euler solver
        dxt = tether.tether_dx(top, cfg, x)
        x = x + dxt
        v = v + dxt / dt
    x, v = collide.resolve_velocity_level(top, cfg, x, v, movable)
    return finish_euler_substep(top, cfg, s, x, v, x_prev, alive, scale,
                                quats=quats)


def verlet_integrate(top: Topology, cfg: SimConfig, s: State, dt: float,
                     alive, scale):
    """The Verlet substep BEFORE contact projection: forces at the
    velocity estimate, damped position update, tet volume projection.
    Shared by substep_verlet and the coupled substep (solver/rigid.py)."""
    w = top.inv_mass[:, None]
    movable = top.inv_mass > 0.0
    g = jnp.asarray(cfg.gravity, dtype=s.x.dtype)
    v_est = (s.x - s.x_prev) / dt
    f = total_forces(top, cfg, s.x, v_est, alive=alive, rest_scale=scale)
    accel = g[None, :] + f * w
    x_new = s.x + (s.x - s.x_prev) * (1.0 - cfg.global_damping * dt) + accel * dt * dt
    x_new = jnp.where(movable[:, None], x_new, s.x)
    if top.n_tets > 0 and cfg.volume_stiffness != 0.0:
        x_new = x_new + _volume_projection(top, x_new, cfg.volume_stiffness)
    return x_new, movable


def verlet_contact_project(top: Topology, cfg: SimConfig, x_new, x_old,
                           dt: float, movable):
    """The Verlet substep's position-level contact chain (pre-clamp
    record, projection, plane/sphere/capsule-box friction)."""
    contact = collide.plane_contact_preclamp(top, cfg, x_new, movable)
    x_new = collide.project_positions_only(top, cfg, x_new, movable)
    x_new = collide.plane_friction_positions(top, cfg, x_new, x_old, dt,
                                             contact)
    x_new = collide.sphere_friction_positions(top, cfg, x_new, x_old, dt,
                                              movable)
    x_new = collide.rest_friction_positions(top, cfg, x_new, x_old, dt,
                                            movable)
    return x_new


def substep_verlet(top: Topology, cfg: SimConfig, s: State, dt: float) -> State:
    alive = _tear_alive(cfg, s)
    scale = _plastic_scale(cfg, s)
    quats = _cluster_quats(cfg, s)
    x_new, movable = verlet_integrate(top, cfg, s, dt, alive, scale)
    if quats is not None:
        # shape matching after integration, before contact (position-only
        # on the projection solvers; oracle substep_verlet)
        from .shapematch import shape_match_dx

        dxs, quats = shape_match_dx(top, cfg, x_new, quats)
        x_new = x_new + dxs
    if cfg.strain_limit.enabled:
        # strain limiting after shape matching, before contact (oracle
        # substep_verlet)
        from .strainlimit import strain_limit_dx

        x_new = x_new + strain_limit_dx(top, cfg, x_new, alive=alive,
                                        rest_scale=scale)
    if tether.motion_enabled(top, cfg):
        # motion constraints after strain limiting, before contact
        # (position-only on the projection solvers; oracle substep_verlet)
        x_new = x_new + tether.tether_dx(top, cfg, x_new)
    x_new = verlet_contact_project(top, cfg, x_new, s.x, dt, movable)
    v_new = (x_new - s.x) / dt
    scale = (plastic_update(top, cfg, x_new, scale)
             if scale is not None else None)
    alive = (tear_update(top, cfg, x_new, alive, rest_scale=scale)
             if alive is not None else s.edge_alive)
    return State(x=x_new, v=v_new, x_prev=s.x, edge_alive=alive,
                 rest_scale=scale if scale is not None else s.rest_scale,
                 cluster_quat=quats if quats is not None else s.cluster_quat)


def substep_xpbd(top: Topology, cfg: SimConfig, s: State, dt: float) -> State:
    """XPBD substep in delta form: the Jacobi loop accumulates the substep's
    total position change ``delta`` (small magnitudes, low-error additions)
    and only the per-iteration evaluation point ``x_prev + delta`` takes a
    large+small rounding — never stored.  Equal in real arithmetic to the
    oracle's plain accumulation; cuts the 1k-step f32 bias 4.3e-3 ->
    2.3e-6 (kernels/stencil.py::xpbd_substep_grid is the measured twin)."""
    from . import banded

    movable = top.inv_mass > 0.0
    alive = _tear_alive(cfg, s)
    scale = _plastic_scale(cfg, s)
    quats = _cluster_quats(cfg, s)
    g = jnp.asarray(cfg.gravity, dtype=s.x.dtype)
    accel = g[None, :]
    if cfg.wind.enabled:
        # external forces enter XPBD through the velocity predict (oracle)
        accel = accel + wind_forces(top, cfg, s.x, s.v) * top.inv_mass[:, None]
    if cfg.self_collision.enabled:
        # self-collision repulsion enters the predict too (oracle
        # substep_xpbd; the constraints only cover springs/volume)
        accel = accel + self_collision_force(cfg, s.x) * top.inv_mass[:, None]
    if cfg.pressure.enabled and top.n_pressure_bodies > 0:
        # gas pressure is an external force: predict-stage entry (oracle)
        from .pressure import pressure_forces

        accel = accel + pressure_forces(top, cfg, s.x) * top.inv_mass[:, None]
    v = (s.v + dt * accel) * (1.0 - cfg.global_damping * dt)
    v = jnp.where(movable[:, None], v, 0.0)
    x_prev = s.x
    delta0 = dt * v

    def _project_delta(delta):
        return collide.project_positions_delta(top, cfg, x_prev, delta, movable)

    if banded.xpbd_banded_applicable(top) and alive is None and scale is None:
        # gather-free Jacobi sweeps over delta-grouped constraints
        groups = top.offset_groups
        tgroups = top.tet_groups
        cnt = banded.xpbd_constraint_count(top)
        n = s.x.shape[0]
        lams0 = tuple(jnp.zeros((n,), s.x.dtype) for _ in groups.deltas)
        lamv0 = tuple(
            jnp.zeros((n,), s.x.dtype)
            for _ in (tgroups.deltas if tgroups is not None else ())
        )
        x_prevT = x_prev.T

        def body(carry, _):
            deltaT, lams, lamv, contact = carry
            dxT, lams, lamv = banded.xpbd_iteration_banded(
                top, cfg, x_prevT + deltaT, lams, lamv, cnt, dt
            )
            deltaT = deltaT + dxT
            delta2, pc = _project_delta(deltaT.T)
            return (delta2.T, lams, lamv, contact | pc), None

        contact0 = jnp.zeros(s.x.shape[0], bool)
        (deltaT, _, _, contact), _ = jax.lax.scan(
            body, (delta0.T, lams0, lamv0, contact0), None,
            length=cfg.xpbd.n_iterations
        )
        delta = deltaT.T
    else:
        lam0 = jnp.zeros((top.n_edges,), s.x.dtype)
        lam_vol0 = jnp.zeros((top.n_tets,), s.x.dtype)

        def body(carry, _):
            delta, lam, lam_vol, contact = carry
            dx, lam, lam_vol = xpbd.xpbd_iteration_dx(
                top, cfg, x_prev + delta, lam, lam_vol, dt, alive=alive,
                rest_scale=scale,
            )
            # contacts projected inside the loop (see oracle substep_xpbd)
            delta, pc = _project_delta(delta + dx)
            return (delta, lam, lam_vol, contact | pc), None

        contact0 = jnp.zeros(s.x.shape[0], bool)
        (delta, _, _, contact), _ = jax.lax.scan(
            body, (delta0, lam0, lam_vol0, contact0), None,
            length=cfg.xpbd.n_iterations
        )
    if (quats is not None or cfg.strain_limit.enabled
            or tether.motion_enabled(top, cfg)):
        # shape matching + strain limiting + motion constraints after the
        # Jacobi loop, then ONE more contact projection so the corrections
        # never leave penetration behind (oracle substep_xpbd)
        dxc = jnp.zeros_like(delta)
        if quats is not None:
            from .shapematch import shape_match_dx

            dxs, quats = shape_match_dx(top, cfg, x_prev + delta, quats)
            dxc = dxc + dxs
        if cfg.strain_limit.enabled:
            from .strainlimit import strain_limit_dx

            dxc = dxc + strain_limit_dx(top, cfg, x_prev + delta + dxc,
                                        alive=alive, rest_scale=scale)
        if tether.motion_enabled(top, cfg):
            dxc = dxc + tether.tether_dx(top, cfg, x_prev + delta + dxc)
        delta, pc = _project_delta(delta + dxc)
        contact = contact | pc
    # plane friction ONCE per substep, from the OR of the iterations'
    # pre-clamp contact masks (oracle substep_xpbd semantics)
    delta = collide.plane_friction_delta(top, cfg, delta, dt, contact)
    # sphere + capsule/box/SDF friction at the substep-end contact shells
    # (delta rebased)
    xe = x_prev + delta
    xf = collide.sphere_friction_positions(top, cfg, xe, x_prev, dt, movable)
    xf = collide.rest_friction_positions(top, cfg, xf, x_prev, dt, movable)
    delta = delta + (xf - xe)
    delta = jnp.where(movable[:, None], delta, 0.0)
    x = x_prev + delta
    scale = plastic_update(top, cfg, x, scale) if scale is not None else None
    alive = (tear_update(top, cfg, x, alive, rest_scale=scale)
             if alive is not None else s.edge_alive)
    return State(x=x, v=delta / dt, x_prev=x_prev, edge_alive=alive,
                 rest_scale=scale if scale is not None else s.rest_scale,
                 cluster_quat=quats if quats is not None else s.cluster_quat)


_SUBSTEP = {
    Solver.SEMI_IMPLICIT_EULER: substep_euler,
    Solver.VERLET: substep_verlet,
    Solver.XPBD: substep_xpbd,
}


def substep(top: Topology, cfg: SimConfig, s: State, dt: float) -> State:
    return _SUBSTEP[cfg.solver](top, cfg, s, dt)


def step_scan(top: Topology, cfg: SimConfig, s: State, dt: float, n_substeps: int) -> State:
    """``lax.scan`` over substeps — the body of the public jitted ``step``."""
    fn = _SUBSTEP[cfg.solver]

    def body(state, _):
        return fn(top, cfg, state, dt), None

    s, _ = jax.lax.scan(body, s, None, length=n_substeps)
    return s
