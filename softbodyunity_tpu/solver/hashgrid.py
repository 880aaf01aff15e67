"""On-device spatial hashing for self-collision (no host round-trips).

Implements BASELINE.json:5 "Self- and environment collision use on-device
spatial hashing so no host round-trips occur inside the loop" and config
BASELINE.json:11 (self-colliding cloth batch), i.e. SURVEY.md C12.

Design (SURVEY.md §7 "spatial hashing without dynamic shapes"):
everything is static-shaped under ``jit``:

1. quantize positions to cells of a ``G^3`` virtual grid anchored at the
   on-device AABB min corner (cell edge = ``cell_size``),
2. ``jax.lax.sort`` vertex ids by linear cell id,
3. each vertex binary-searches (``searchsorted``) the sorted cell-id array
   for the start of each of its 27 neighbour cells and examines a fixed
   window of ``max_per_cell`` candidates, masked by run membership.

When no cell run exceeds ``max_per_cell`` and ``cell_size >= radius`` this
reproduces the dense O(N^2) oracle rule *exactly* (same pair set); the cap
only soft-truncates pathological pile-ups.  The repulsion rule mirrors
:func:`softbodyunity_tpu.oracle.reference.self_collision_forces`:
``F = stiffness * (radius - dist) * dir`` for every pair with
``dist < radius``, no mesh-neighbour exclusions.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..core.config import SelfCollisionParams

# 27 neighbour-cell offsets, static
_OFFSETS = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int32,
)


def cell_ids(x: jax.Array, origin: jax.Array, cell_size: float, grid_dim: int):
    """Linear cell id per vertex, clipped into the G^3 grid: i32[N]."""
    c = jnp.floor((x - origin) / cell_size).astype(jnp.int32)
    c = jnp.clip(c, 0, grid_dim - 1)
    return (c[:, 0] * grid_dim + c[:, 1]) * grid_dim + c[:, 2]


def hash_overflow_count(x: jax.Array, p: SelfCollisionParams) -> jax.Array:
    """Number of vertices whose cell run exceeds ``max_per_cell`` — when 0,
    the hash pair set is EXACTLY the dense rule (the cap soft-truncates
    pile-ups silently otherwise; probe this when tuning max_per_cell)."""
    origin = jnp.min(x, axis=0) - 0.5 * p.cell_size
    cid = cell_ids(x, origin, p.cell_size, p.grid_dim)
    sorted_cid = jnp.sort(cid)
    starts = jnp.searchsorted(sorted_cid, sorted_cid, side="left")
    ends = jnp.searchsorted(sorted_cid, sorted_cid, side="right")
    return jnp.sum((ends - starts) > p.max_per_cell)


def self_collision_forces_hash(x: jax.Array, p: SelfCollisionParams) -> jax.Array:
    """Spatial-hash vertex-vertex repulsion forces: f32[N,3]."""
    n = x.shape[0]
    g = p.grid_dim
    k = p.max_per_cell

    origin = jnp.min(x, axis=0) - 0.5 * p.cell_size
    cid = cell_ids(x, origin, p.cell_size, g)

    # sort vertices by cell id (ascending); carry original index
    order = jnp.argsort(cid)
    sorted_cid = cid[order]                       # i32[N]
    sorted_x = x[order]                           # f32[N,3]

    # integer cell coords per vertex for neighbour enumeration
    c = jnp.floor((x - origin) / p.cell_size).astype(jnp.int32)
    c = jnp.clip(c, 0, g - 1)

    # Accumulate over the 27 neighbour cells one at a time (unrolled): peak
    # intermediates are [N, K, 3] instead of [N, 27, K, 3] — a 27x smaller
    # footprint, which matters at B=1024 vmapped scenes (BASELINE.json:11).
    slot = jnp.arange(k, dtype=jnp.int32)
    self_ids = jnp.arange(n, dtype=jnp.int32)
    f_total = jnp.zeros_like(x)
    for off in _OFFSETS:
        nb = c + jnp.asarray(off)                            # [N,3]
        in_grid = jnp.all((nb >= 0) & (nb < g), axis=-1)     # [N]
        nb_id = (nb[:, 0] * g + nb[:, 1]) * g + nb[:, 2]     # [N]
        starts = jnp.searchsorted(sorted_cid, nb_id)         # [N]
        cand = starts[:, None] + slot[None, :]               # [N,K]
        cand_clipped = jnp.minimum(cand, n - 1)
        cand_cid = sorted_cid[cand_clipped]                  # [N,K]
        valid = (cand < n) & (cand_cid == nb_id[:, None]) & in_grid[:, None]
        cand_pos = sorted_x[cand_clipped]                    # [N,K,3]
        diff = cand_pos - x[:, None, :]                      # x_j - x_i
        dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
        cand_orig = order[cand_clipped]                      # [N,K]
        active = valid & (cand_orig != self_ids[:, None]) & (dist < p.radius)
        dirs = diff / jnp.maximum(dist, 1e-12)[..., None]
        overlap = jnp.where(active, p.radius - dist, 0.0)
        f_total = f_total - jnp.sum(
            (p.stiffness * overlap)[..., None] * dirs, axis=1
        )
    return f_total
