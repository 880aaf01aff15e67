"""Tracing / profiling / observability (SURVEY.md §5).

The reference's only instrumentation is the Unity Profiler.  The rebuild
exposes:

* :func:`trace` — context manager wrapping ``jax.profiler.trace`` for
  xprof/TensorBoard traces of benchmark runs.
* :func:`cost_analysis` — XLA's per-executable FLOP/byte estimates for a
  jitted step (compile-time, no execution).
* :func:`diagnostics` — per-step physics observables (energies, constraint
  residual, contact count) computed OUTSIDE the jitted hot loop — never
  inside the substep scan (SURVEY.md §5 "no logging inside the hot scan").
* :func:`checked_step` — a ``checkify``-wrapped step that turns NaN/Inf
  into hard errors (SURVEY.md §5 race detection / sanitizers: the
  functional model is race-free by construction; NaN guards are the
  remaining runtime check).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.state import State
from ..core.topology import Topology
from ..solver import step as _step_mod


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile a region: ``with trace(dir): run(...)`` then load the dir in
    TensorBoard / xprof.  Default: ``.tmp/trace`` in this checkout."""
    if log_dir is None:
        from .cache import CHECKOUT

        log_dir = str(CHECKOUT / ".tmp" / "trace")
    with jax.profiler.trace(log_dir):
        yield log_dir


def cost_analysis(top: Topology, cfg: SimConfig, state: State,
                  dt=None, n_substeps=None) -> Dict[str, float]:
    """XLA cost model for one compiled frame: flops, bytes accessed."""
    dt = cfg.dt if dt is None else dt
    n = cfg.n_substeps if n_substeps is None else n_substeps
    fn = jax.jit(lambda t, s: _step_mod.step_scan(t, cfg, s, dt, n))
    compiled = fn.lower(top, state).compile()
    costs = compiled.cost_analysis()
    if isinstance(costs, list):  # older jax returns a list per device
        costs = costs[0]
    return {k: v for k, v in costs.items() if isinstance(v, (int, float))}


@jax.jit
def _energies(edges, rest_length, edge_stiffness, inv_mass, x, v, alive):
    mass = jnp.where(inv_mass > 0, 1.0 / jnp.maximum(inv_mass, 1e-12), 0.0)
    ke = 0.5 * jnp.sum(mass[:, None] * v * v)
    d = x[edges[:, 1]] - x[edges[:, 0]]
    ext = (jnp.linalg.norm(d, axis=1) - rest_length) * alive
    pe = 0.5 * jnp.sum(edge_stiffness * ext * ext)
    residual = jnp.max(jnp.abs(ext))
    return ke, pe, residual


def diagnostics(top: Topology, cfg: SimConfig, state: State) -> Dict[str, float]:
    """Physics observables for logging/monitoring (host-side, between
    frames): kinetic/spring energy, max constraint residual, ground
    contacts.  Cheap: one fused kernel + scalar fetches."""
    # torn edges carry no force: exclude them from spring energy/residual
    alive = (state.edge_alive if state.edge_alive is not None
             else jnp.ones((top.edges.shape[0],), state.x.dtype))
    ke, pe, residual = _energies(
        top.edges, top.rest_length, top.edge_stiffness, top.inv_mass,
        state.x, state.v, alive,
    )
    contacts = jnp.sum(state.x[:, 1] <= top.plane_height + 1e-6)
    out = {
        "kinetic_energy": float(ke),
        "spring_energy": float(pe),
        "max_edge_residual": float(residual),
        "ground_contacts": int(contacts),
    }
    if state.edge_alive is not None:
        out["torn_edges"] = int(top.edges.shape[0]
                                - float(jnp.sum(state.edge_alive)))
    if cfg.self_collision.enabled:
        # capacity diagnostics: nonzero => the static budget soft-truncated
        # contacts this frame (raise max_per_cell / block_partners)
        p = cfg.self_collision
        if p.method == "block":
            from ..solver.blocksparse import self_collision_block_diagnostics

            d = self_collision_block_diagnostics(state.x, p)
            out["self_collision_dropped_tile_pairs"] = int(d["dropped_pairs"])
        elif p.method == "hash":
            from ..solver.hashgrid import hash_overflow_count

            out["self_collision_cell_overflows"] = int(
                hash_overflow_count(state.x, p)
            )
    if cfg.strain_limit.enabled:
        # worst relative elongation over alive edges vs the (plastic-
        # scaled) rest — should hover at/under max_stretch + the Jacobi
        # residual; a runaway value means the sweeps can't keep up
        a, b = top.edges[:, 0], top.edges[:, 1]
        rest = (top.rest_length if state.rest_scale is None
                else top.rest_length * state.rest_scale)
        length = jnp.linalg.norm(state.x[b] - state.x[a], axis=1)
        strain = (length - rest) / jnp.maximum(rest, 1e-12)
        out["max_strain"] = float(jnp.max(jnp.where(alive > 0.0, strain,
                                                    -jnp.inf)))
    if cfg.pressure.enabled and top.n_pressure_bodies > 0:
        from ..solver.pressure import body_volumes

        vols = body_volumes(top, state.x)
        ratio = vols / top.pressure_rest_volume
        # V/V0 per gas body: 1.0 = rest; << 1 = crushed (or an inverted
        # shell if it goes negative — a real finding)
        out["pressure_volume_ratio_min"] = float(jnp.min(ratio))
        out["pressure_volume_ratio_max"] = float(jnp.max(ratio))
    return out


import functools


@functools.partial(jax.jit, static_argnames=("cfg", "dt"))
def _contact_impulses(top: Topology, cfg: SimConfig, state: State, dt: float):
    from ..solver.collide import (
        _box_scalars,
        _capsule_scalars,
        _resolve_one_sphere,
        _sdf_scalars,
        _velocity_scalars,
        box_resolve_components,
        capsule_resolve_components,
        resolve_plane,
        sdf_resolve_components,
    )

    movable = top.inv_mass > 0.0
    m = jnp.where(movable, 1.0 / jnp.maximum(top.inv_mass, 1e-12), 0.0)
    g = jnp.asarray(cfg.gravity, state.x.dtype)
    v = state.v + dt * g[None, :]          # predicted velocities at contact
    # predicted positions: post-resolve states rest *exactly on* contact
    # surfaces (membership there is 1-ulp ill-conditioned), so advance one
    # substep — resting vertices land strictly inside and register
    x = state.x + dt * v
    r, f = cfg.collision.restitution, cfg.collision.friction

    def imp(v0, v1):
        return jnp.sum(m[:, None] * (v1 - v0), axis=0)

    out = {}
    if cfg.collision.enable_plane:
        x1, v1 = resolve_plane(
            x, v, top.plane_height, r, f, movable,
            w=(None if top.plane_velocity is None
               else [top.plane_velocity[c] for c in range(3)]))
        out["plane"] = imp(v, v1)
        x, v = x1, v1
    if cfg.collision.enable_spheres and top.n_spheres > 0:
        js = []
        for s in range(top.n_spheres):
            x1, v1 = _resolve_one_sphere(
                x, v, top.sphere_centers[s], top.sphere_radii[s], r, f,
                movable,
                w=(None if top.sphere_velocities is None
                   else top.sphere_velocities[s]),
            )
            js.append(imp(v, v1))
            x, v = x1, v1
        out["spheres"] = jnp.stack(js)
    xz = [x[:, 0], x[:, 1], x[:, 2]]
    vz = [v[:, 0], v[:, 1], v[:, 2]]

    def imp_c(vz0, vz1):
        return jnp.stack([jnp.sum(m * (vz1[c] - vz0[c])) for c in range(3)])

    if cfg.collision.enable_capsules and top.n_capsules > 0:
        js = []
        for s in range(top.n_capsules):
            p0, p1, rad = _capsule_scalars(top, s)
            xz1, vz1 = capsule_resolve_components(
                xz, vz, movable, p0, p1, rad, r, f,
                w=_velocity_scalars(top.capsule_velocities, s))
            js.append(imp_c(vz, vz1))
            xz, vz = xz1, vz1
        out["capsules"] = jnp.stack(js)
    if cfg.collision.enable_boxes and top.n_boxes > 0:
        js = []
        for s in range(top.n_boxes):
            c3, h, rot = _box_scalars(top, s)
            xz1, vz1 = box_resolve_components(
                xz, vz, movable, c3, h, rot, r, f,
                w=_velocity_scalars(top.box_velocities, s))
            js.append(imp_c(vz, vz1))
            xz, vz = xz1, vz1
        out["boxes"] = jnp.stack(js)
    if cfg.collision.enable_sdf and top.n_sdfs > 0:
        js = []
        for s in range(top.n_sdfs):
            gr, o, h = _sdf_scalars(top, s)
            xz1, vz1 = sdf_resolve_components(
                xz, vz, movable, gr, o, h, r, f,
                w=_velocity_scalars(top.sdf_velocities, s))
            js.append(imp_c(vz, vz1))
            xz, vz = xz1, vz1
        out["sdfs"] = jnp.stack(js)
    return out


def contact_impulses(top: Topology, cfg: SimConfig, state: State,
                     dt=None) -> Dict[str, jax.Array]:
    """Per-collider contact impulse for two-way rigidbody coupling.

    Runs one velocity-level resolve pass (the oracle's sequential
    plane -> spheres -> capsules -> boxes order) on the *predicted*
    state (``v_hat = v + dt*g``, ``x_hat = x + dt*v_hat`` — one substep
    ahead, so vertices resting exactly on a surface register as contacts)
    and reports, per collider, the impulse
    ``J = sum_i m_i * dv_i`` the resolve applies to the soft body.  The
    reaction on the rigid collider is ``-J`` (equivalent force ``-J/dt``):
    a cloth resting on the ground plane reports ``J/dt ~= (0, M*g, 0)``
    with ``M`` the supported mass — feed ``-J/dt`` to the game engine's
    rigidbody as the soft body's weight/push.

    Keys present: ``"plane"`` f32[3], ``"spheres"`` f32[S,3],
    ``"capsules"`` f32[C,3], ``"boxes"`` f32[B,3] — only for enabled
    collider sets.  Observable-tier (once per frame), not inside the
    substep scan.
    """
    return _contact_impulses(top, cfg, state,
                             float(cfg.dt if dt is None else dt))


def contact_impulses_batched(top: Topology, cfg: SimConfig, states: State,
                             dt=None) -> Dict[str, jax.Array]:
    """Per-scene :func:`contact_impulses` over a batched ``State[B, N, 3]``
    (RL coupling: feed each scene's ``-J/dt`` to its own rigidbodies).
    Keys as in contact_impulses with a leading batch axis."""
    d = float(cfg.dt if dt is None else dt)
    return jax.vmap(lambda s: _contact_impulses(top, cfg, s, d))(states)


def checked_step(top: Topology, cfg: SimConfig, state: State,
                 dt=None, n_substeps=None) -> State:
    """Step with checkify NaN/Inf guards: raises on the first non-finite
    value instead of silently propagating it."""
    from jax.experimental import checkify

    dt = cfg.dt if dt is None else float(dt)
    n = cfg.n_substeps if n_substeps is None else int(n_substeps)

    def impl(t, s):
        out = _step_mod.step_scan(t, cfg, s, dt, n)
        checkify.check(jnp.all(jnp.isfinite(out.x)), "non-finite positions")
        checkify.check(jnp.all(jnp.isfinite(out.v)), "non-finite velocities")
        return out

    checked = checkify.checkify(impl, errors=checkify.float_checks | checkify.user_checks)
    err, out = jax.jit(checked)(top, state)
    err.throw()
    return out
