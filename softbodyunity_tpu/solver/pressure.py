"""Closed-shell gas pressure forces — device twin of
``oracle/reference.py::pressure_forces`` (the binding semantics; see
``PressureParams`` and ``core.topology.enable_pressure``).

Notes: the volume reduction is a tiny ``segment_sum`` over triangle
body ids (P bodies, P is single digits) and the force scatter is the SAME
op class as the C11 vertex-normal recompute (one 3-corner scatter-add over
F triangles) — pressure bodies are irregular closed shells, so they live
on the exact jnp gather path like every non-grid mesh.  Pure function of
``x``: jit / vmap / grad-friendly, static shapes (triangles with no
enclosed gas carry body id -1 and are masked, never dropped).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.topology import Topology


def body_volumes(top: Topology, x: jax.Array) -> jax.Array:
    """Signed enclosed volume per pressure body: f32[P]."""
    tris = top.triangles
    body = top.tri_body
    n_bodies = top.n_pressure_bodies
    pa, pb, pc = x[tris[:, 0]], x[tris[:, 1]], x[tris[:, 2]]
    contrib = jnp.einsum("ij,ij->i", pa, jnp.cross(pb, pc)) / 6.0
    seg = jnp.where(body >= 0, body, n_bodies)
    return jax.ops.segment_sum(
        jnp.where(body >= 0, contrib, 0.0), seg,
        num_segments=n_bodies + 1,
    )[:n_bodies]


def pressure_forces(top: Topology, cfg: SimConfig, x: jax.Array) -> jax.Array:
    """Per-vertex pressure force f32[N,3] (oracle pressure_forces twin)."""
    pp = cfg.pressure
    tris = top.triangles
    body = top.tri_body
    vol = body_volumes(top, x)
    v0 = top.pressure_rest_volume
    p_body = pp.stiffness * (
        pp.inflation * v0 / jnp.maximum(vol, 1e-9 * v0) - 1.0
    )
    pa, pb, pc = x[tris[:, 0]], x[tris[:, 1]], x[tris[:, 2]]
    cross = jnp.cross(pb - pa, pc - pa)
    p_face = jnp.where(body >= 0, p_body[jnp.maximum(body, 0)], 0.0)
    f_corner = p_face[:, None] * cross / 6.0
    f = jnp.zeros_like(x)
    for col in range(3):
        f = f.at[tris[:, col]].add(f_corner)
    return f
