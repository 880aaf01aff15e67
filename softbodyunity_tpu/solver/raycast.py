"""Ray queries against the deformed mesh — branchless Moller-Trumbore.

The interaction analogue of Unity's ``Physics.Raycast`` (mouse picking /
grabbing; pairs with :func:`softbodyunity_tpu.api.move_pins` for drag
interactions).  Oracle twin: ``oracle/reference.py::raycast`` is the
binding definition.

Notes: one gather of the triangle corners per *query* (not per
substep — same budget class as vertex normals, solver/normals.py), then
pure elementwise math and a single argmin reduction; no
data-dependent control flow, so the op is jit/vmap-friendly (vmap over
the ray axis batches interaction queries for free).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class RayHit(NamedTuple):
    """Nearest hit along a ray; a pytree of scalars (or [R]-batched)."""

    t: jax.Array      # f32[] distance in units of |direction|; inf = miss
    tri: jax.Array    # i32[] triangle index; -1 = miss
    u: jax.Array      # f32[] barycentric of corner 1
    v: jax.Array      # f32[] barycentric of corner 2
    point: jax.Array  # f32[3] world hit point (origin on a miss)


def raycast(triangles: jax.Array, x: jax.Array, origin: jax.Array,
            direction: jax.Array, eps: float = 1e-9) -> RayHit:
    """Nearest front- or back-face ray-triangle hit with ``t >= 0``.

    Oracle twin: :func:`softbodyunity_tpu.oracle.reference.raycast`
    (ties at exactly equal ``t`` break toward the lowest triangle index,
    which is ``argmin``'s rule on both paths).
    """
    o = jnp.asarray(origin, dtype=x.dtype)
    d = jnp.asarray(direction, dtype=x.dtype)
    p0 = x[triangles[:, 0]]
    p1 = x[triangles[:, 1]]
    p2 = x[triangles[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    h = jnp.cross(d[None, :], e2)
    a = jnp.einsum("fc,fc->f", e1, h)
    parallel = jnp.abs(a) < eps
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = o[None, :] - p0
    u = f * jnp.einsum("fc,fc->f", s, h)
    q = jnp.cross(s, e1)
    v = f * jnp.einsum("fc,fc->f", d[None, :], q)
    t = f * jnp.einsum("fc,fc->f", e2, q)
    hit = (~parallel) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
    t = jnp.where(hit, t, jnp.inf)
    i = jnp.argmin(t)
    miss = ~jnp.isfinite(t[i])
    return RayHit(
        t=t[i],
        tri=jnp.where(miss, -1, i).astype(jnp.int32),
        u=jnp.where(miss, 0.0, u[i]).astype(x.dtype),
        v=jnp.where(miss, 0.0, v[i]).astype(x.dtype),
        point=jnp.where(miss, o, o + t[i] * d).astype(x.dtype),
    )


def pick_vertex(triangles: jax.Array, x: jax.Array, origin: jax.Array,
                direction: jax.Array) -> jax.Array:
    """Vertex index to grab: the hit triangle's corner with the largest
    barycentric weight (i32[]; -1 on a miss).  Feed the result to
    ``api.move_pins`` handle ids for drag interactions."""
    hit = raycast(triangles, x, origin, direction)
    w = jnp.stack([1.0 - hit.u - hit.v, hit.u, hit.v])
    corner = jnp.argmax(w)
    tri_safe = jnp.maximum(hit.tri, 0)
    vid = triangles[tri_safe, corner].astype(jnp.int32)
    return jnp.where(hit.tri < 0, -1, vid)
