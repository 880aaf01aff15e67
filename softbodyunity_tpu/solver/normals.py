"""Vertex-normal recompute for rendering.

Device replacement for Unity's ``mesh.RecalculateNormals()``
(BASELINE.json:5 "vertex-normal recompute for rendering"; SURVEY.md C11):
area-weighted face normals segment-summed to vertices, then normalized.
Runs once per *rendered frame*, outside the substep scan.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def vertex_normals(triangles: jax.Array, x: jax.Array) -> jax.Array:
    """Area-weighted vertex normals, f32[N,3] unit vectors.

    Oracle twin: :func:`softbodyunity_tpu.oracle.reference.vertex_normals`.
    """
    n_v = x.shape[0]
    p0 = x[triangles[:, 0]]
    p1 = x[triangles[:, 1]]
    p2 = x[triangles[:, 2]]
    fn = jnp.cross(p1 - p0, p2 - p0)  # magnitude = 2*area => area weighting
    out = jnp.zeros_like(x)
    for c in range(3):
        out = out + jax.ops.segment_sum(fn, triangles[:, c], num_segments=n_v)
    norm = jnp.linalg.norm(out, axis=1)
    return out / jnp.maximum(norm, 1e-12)[:, None]
