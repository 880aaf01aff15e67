"""XPBD constraint projection with compliance — substepped Jacobi solver.

Implements BASELINE.json:9 ("XPBD cloth: distance + bending constraints with
compliance, substepped Jacobi solver") and the tet volume-preservation
constraint (BASELINE.json:10) as pure-JAX ops, mirroring
:func:`softbodyunity_tpu.oracle.reference.xpbd_iteration` /
``volume_projection``.

Jacobi projection is chosen over Gauss-Seidel because it is embarrassingly
parallel (SURVEY.md §7): per-constraint corrections
are computed independently, segment-summed per vertex, count-averaged, and
applied with an under-relaxation factor; convergence is bought with many
cheap substeps, XPBD's own recommendation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.topology import Topology


def distance_corrections(top: Topology, x, lam, dt, alive=None,
                         rest_scale=None):
    """Per-edge XPBD distance projection; returns (dx_edge_a, n, dlam, lam).
    Dead (torn) edges project nothing (TearParams); ``rest_scale``
    rescales the distance targets (PlasticityParams)."""
    w = top.inv_mass
    a = top.edges[:, 0]
    b = top.edges[:, 1]
    d = x[b] - x[a]
    length = jnp.linalg.norm(d, axis=1)
    n = d / jnp.maximum(length, 1e-12)[:, None]
    rest = (top.rest_length if rest_scale is None
            else top.rest_length * rest_scale)
    c_val = length - rest
    alpha_t = top.edge_compliance / (dt * dt)
    denom = w[a] + w[b] + alpha_t
    dlam = -(c_val + alpha_t * lam) / jnp.maximum(denom, 1e-12)
    if alive is not None:
        dlam = dlam * alive
    return n, dlam, lam + dlam


def volume_terms(top: Topology, x, lam_vol, compliance, dt):
    """Per-tet XPBD volume projection terms: gradients + dlam."""
    t = top.tets
    p0, p1, p2, p3 = x[t[:, 0]], x[t[:, 1]], x[t[:, 2]], x[t[:, 3]]
    vol = jnp.einsum("ij,ij->i", jnp.cross(p1 - p0, p2 - p0), p3 - p0) / 6.0
    c_v = vol - top.rest_volume
    g1 = jnp.cross(p2 - p0, p3 - p0) / 6.0
    g2 = jnp.cross(p3 - p0, p1 - p0) / 6.0
    g3 = jnp.cross(p1 - p0, p2 - p0) / 6.0
    g0 = -(g1 + g2 + g3)
    w = top.inv_mass
    alpha_v = compliance / (dt * dt)
    denom = (
        w[t[:, 0]] * jnp.einsum("ij,ij->i", g0, g0)
        + w[t[:, 1]] * jnp.einsum("ij,ij->i", g1, g1)
        + w[t[:, 2]] * jnp.einsum("ij,ij->i", g2, g2)
        + w[t[:, 3]] * jnp.einsum("ij,ij->i", g3, g3)
        + alpha_v
    )
    dlam = -(c_v + alpha_v * lam_vol) / jnp.maximum(denom, 1e-12)
    return (g0, g1, g2, g3), dlam, lam_vol + dlam


def xpbd_iteration_dx(top: Topology, cfg: SimConfig, x, lam, lam_vol, dt,
                      alive=None, rest_scale=None):
    """One Jacobi sweep over distance + volume constraints (oracle twin),
    returning the count-averaged, relaxed position INCREMENT (callers
    accumulate it in delta form for f32 drift control — see
    solver/step.py substep_xpbd).  ``alive`` removes torn edges from both
    the corrections and the Jacobi count."""
    n_v = x.shape[0]
    w = top.inv_mass
    a = top.edges[:, 0]
    b = top.edges[:, 1]
    n, dlam, lam = distance_corrections(top, x, lam, dt, alive=alive,
                                        rest_scale=rest_scale)
    dx = jax.ops.segment_sum(-(w[a] * dlam)[:, None] * n, a, num_segments=n_v)
    dx = dx + jax.ops.segment_sum((w[b] * dlam)[:, None] * n, b, num_segments=n_v)
    ones_e = jnp.ones_like(dlam) if alive is None else alive
    cnt = jax.ops.segment_sum(ones_e, a, num_segments=n_v)
    cnt = cnt + jax.ops.segment_sum(ones_e, b, num_segments=n_v)
    if top.n_tets > 0:
        grads, dlam_v, lam_vol = volume_terms(
            top, x, lam_vol, cfg.xpbd.compliance_volume, dt
        )
        ones_t = jnp.ones_like(dlam_v)
        for col, g in enumerate(grads):
            ids = top.tets[:, col]
            dx = dx + jax.ops.segment_sum(
                (w[ids] * dlam_v)[:, None] * g, ids, num_segments=n_v
            )
            cnt = cnt + jax.ops.segment_sum(ones_t, ids, num_segments=n_v)
    return cfg.xpbd.relaxation * dx / jnp.maximum(cnt, 1.0)[:, None], lam, lam_vol


def xpbd_iteration(top: Topology, cfg: SimConfig, x, lam, lam_vol, dt):
    """One Jacobi sweep applied to ``x`` directly (compat wrapper)."""
    dx, lam, lam_vol = xpbd_iteration_dx(top, cfg, x, lam, lam_vol, dt)
    return x + dx, lam, lam_vol


def volume_projection(top: Topology, x, stiffness: float):
    """PBD-style (compliance-free) volume projection used by the Euler/Verlet
    tet-cube path (BASELINE.json:10); oracle twin of ``volume_projection``."""
    if top.n_tets == 0 or stiffness == 0.0:
        return jnp.zeros_like(x)
    n_v = x.shape[0]
    w = top.inv_mass
    t = top.tets
    p0, p1, p2, p3 = x[t[:, 0]], x[t[:, 1]], x[t[:, 2]], x[t[:, 3]]
    vol = jnp.einsum("ij,ij->i", jnp.cross(p1 - p0, p2 - p0), p3 - p0) / 6.0
    c_val = vol - top.rest_volume
    g1 = jnp.cross(p2 - p0, p3 - p0) / 6.0
    g2 = jnp.cross(p3 - p0, p1 - p0) / 6.0
    g3 = jnp.cross(p1 - p0, p2 - p0) / 6.0
    g0 = -(g1 + g2 + g3)
    denom = (
        w[t[:, 0]] * jnp.einsum("ij,ij->i", g0, g0)
        + w[t[:, 1]] * jnp.einsum("ij,ij->i", g1, g1)
        + w[t[:, 2]] * jnp.einsum("ij,ij->i", g2, g2)
        + w[t[:, 3]] * jnp.einsum("ij,ij->i", g3, g3)
    )
    s = -c_val / jnp.maximum(denom, 1e-12)
    dx = jnp.zeros_like(x)
    cnt = jnp.zeros((n_v,), x.dtype)
    ones_t = jnp.ones_like(s)
    for col, g in enumerate((g0, g1, g2, g3)):
        ids = t[:, col]
        dx = dx + jax.ops.segment_sum((w[ids] * s)[:, None] * g, ids, num_segments=n_v)
        cnt = cnt + jax.ops.segment_sum(ones_t, ids, num_segments=n_v)
    dx = stiffness * dx / jnp.maximum(cnt, 1.0)[:, None]
    return jnp.where((w > 0.0)[:, None], dx, 0.0)
