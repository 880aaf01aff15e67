"""Spring-force accumulation over edge lists — pure-JAX ops.

Replaces the reference's per-edge C# ``for`` loop ("spring-force accumulation
over edge lists", BASELINE.json:5) with two formulations:

* :func:`spring_forces_gather` — per-edge force vectors, then a race-free
  per-vertex **gather** over the precomputed incidence table
  (``Topology.incident``).  Each output row is written by exactly one
  logical program (SURVEY.md §7 "hard parts": scatter-add -> CSR
  gather).
* :func:`spring_forces_segment` — ``segment_sum`` fallback over the
  endpoint-sorted edge list (XLA scatter path; used as a cross-check twin).

Both mirror :func:`softbodyunity_tpu.oracle.reference.spring_forces` bit-for-
semantics (f32 vs f64 rounding aside).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.topology import Topology


@jax.custom_jvp
def safe_sqrt(x):
    """``jnp.sqrt`` with a grad-safe derivative at 0.

    The PRIMAL is literally ``jnp.sqrt`` — compiled output is
    bit-identical to the plain op (the f64-exact oracle tier and the
    Pallas kernel twins pin spring forces to the bit; a
    ``where(safe, sqrt(where(...)))`` rewrite measurably changed XLA
    CPU codegen by ~50 ulps).  Only the JVP differs: sqrt'(0) = inf
    makes the backward pass 0/0-NaN for zero-length spring vectors —
    and truly coincident endpoints happen (a start-inside plane clamp
    snaps neighbouring vertices to the same point; phantom zero-padded
    stencil pairs meet the origin vertex).  The derivative evaluates
    the unsafe lanes at x = 1 and selects 0, so their cotangent is 0
    instead of NaN."""
    return jnp.sqrt(x)


@safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    (x,), (tx,) = primals, tangents
    safe = x > 0.0
    dydx = jnp.where(safe, 0.5 / jnp.sqrt(jnp.where(safe, x, 1.0)), 0.0)
    return jnp.sqrt(x), dydx * tx


@jax.custom_jvp
def _length_dir(d):
    """(length, unit-direction) of per-edge vectors ``d`` f32[E, 3].

    The PRIMAL is literally the pre-round-5 ops — compiled output is
    bit-identical (step_coupled vs step and the batched-hetero tests
    pin the gather-path forces to the bit; even selecting the RESULT of
    the 1/max division changed XLA fusion rounding by 1 ulp here).
    Only the JVP differs: at d == 0 exactly, sqrt'(0) is a 0/0 NaN and
    the 1e12-scale inv_len rides backward products into overflow — and
    truly coincident endpoints happen (a start-inside plane clamp snaps
    neighbours to the same point).  The tangents evaluate unsafe lanes
    at length 1 and select 0.  "Unsafe" is keyed on d, not |d|^2 (f32
    underflow makes d2 == 0 with d != 0, and those lanes legitimately
    carry the oracle's eps-clamped force)."""
    length = jnp.linalg.norm(d, axis=1)
    inv_len = 1.0 / jnp.maximum(length, 1e-12)
    return length, d * inv_len[:, None]


@_length_dir.defjvp
def _length_dir_jvp(primals, tangents):
    (d,), (td,) = primals, tangents
    length = jnp.linalg.norm(d, axis=1)
    n = d * (1.0 / jnp.maximum(length, 1e-12))[:, None]
    safe = jnp.any(d != 0.0, axis=1)
    inv = jnp.where(safe, 1.0 / jnp.maximum(length, 1e-12), 0.0)
    tl = jnp.sum(d * td, axis=1) * inv             # d|d| = (d . td)/|d|
    # dn = td/|d| - d (d . td)/|d|^3, clamped like the primal
    tn = td * inv[:, None] - d * (tl * inv * inv)[:, None]
    return (length, n), (tl, tn)


@jax.custom_jvp
def length_dir_planes(d):
    """Plane-layout twin of :func:`_length_dir` for ``d`` f32[3, ...]
    component rows (banded / stencil layouts): (length, unit-direction)
    with the pre-round-5 ops as the verbatim primal (bit-identical
    compiled forward — even a where-select on the division result
    shifted XLA fusion rounding by 1 ulp and broke the step_coupled /
    batched-hetero bit contracts) and grad-safe tangents at d == 0."""
    d2 = jnp.sum(d * d, axis=0)
    length = jnp.sqrt(d2)
    return length, d / jnp.maximum(length, 1e-12)


@length_dir_planes.defjvp
def _length_dir_planes_jvp(primals, tangents):
    (d,), (td,) = primals, tangents
    length = jnp.sqrt(jnp.sum(d * d, axis=0))
    n = d / jnp.maximum(length, 1e-12)
    safe = jnp.any(d != 0.0, axis=0)
    inv = jnp.where(safe, 1.0 / jnp.maximum(length, 1e-12), 0.0)
    tl = jnp.sum(d * td, axis=0) * inv
    tn = td * inv[None] - d * (tl * inv * inv)[None]
    return (length, n), (tl, tn)


@jax.custom_jvp
def length_dir_planes_mul(d):
    """Multiply-form twin of :func:`length_dir_planes` (the stencil
    Euler path multiplies by the reciprocal instead of dividing — the
    two round differently, and the primal must be the verbatim old
    ops for the bit contracts)."""
    length = jnp.sqrt(jnp.sum(d * d, axis=0))
    inv_len = 1.0 / jnp.maximum(length, 1e-12)
    return length, d * inv_len


@length_dir_planes_mul.defjvp
def _length_dir_planes_mul_jvp(primals, tangents):
    (d,), (td,) = primals, tangents
    length = jnp.sqrt(jnp.sum(d * d, axis=0))
    n = d * (1.0 / jnp.maximum(length, 1e-12))
    safe = jnp.any(d != 0.0, axis=0)
    inv = jnp.where(safe, 1.0 / jnp.maximum(length, 1e-12), 0.0)
    tl = jnp.sum(d * td, axis=0) * inv
    tn = td * inv[None] - d * (tl * inv * inv)[None]
    return (length, n), (tl, tn)


def edge_force_vectors(top: Topology, x: jax.Array, v: jax.Array,
                       cfg: SimConfig, alive=None, rest_scale=None):
    """Per-edge Hooke + axial-damper force on endpoint *a* (toward *b*):
    f32[E,3].  ``alive`` (TearParams liveness f32[E]) silences torn edges;
    ``rest_scale`` (PlasticityParams f32[E]) rescales the rest lengths."""
    a = top.edges[:, 0]
    b = top.edges[:, 1]
    d = x[b] - x[a]
    length, n = _length_dir(d)
    rel_v = jnp.einsum("ej,ej->e", v[b] - v[a], n,
                       precision=jax.lax.Precision.HIGHEST)
    rest = (top.rest_length if rest_scale is None
            else top.rest_length * rest_scale)
    fmag = top.edge_stiffness * (length - rest) + cfg.springs.damping * rel_v
    if alive is not None:
        fmag = fmag * alive
    return fmag[:, None] * n


def spring_forces_gather(top: Topology, x: jax.Array, v: jax.Array,
                         cfg: SimConfig, alive=None, rest_scale=None):
    """Race-free incidence-gather accumulation: f32[N,3]."""
    f_edge = edge_force_vectors(top, x, v, cfg, alive=alive,
                                rest_scale=rest_scale)
    # ghost row: padded incidence entries (id == E) gather zero force
    f_pad = jnp.concatenate([f_edge, jnp.zeros((1, 3), f_edge.dtype)], axis=0)
    gathered = f_pad[top.incident]                      # [N, D, 3]
    return jnp.einsum("nd,ndj->nj", top.incident_sign, gathered,
                      precision=jax.lax.Precision.HIGHEST)


def spring_forces_segment(top: Topology, x: jax.Array, v: jax.Array, cfg: SimConfig):
    """segment_sum twin (sorted-edge scatter path)."""
    f_edge = edge_force_vectors(top, x, v, cfg)
    n = x.shape[0]
    fa = jax.ops.segment_sum(f_edge, top.edges[:, 0], num_segments=n)
    fb = jax.ops.segment_sum(-f_edge, top.edges[:, 1], num_segments=n)
    return fa + fb


# Precision of the two float32 products in the Gram self-collision.  The
# |xi|^2 + |xj|^2 - 2 xi.xj cancellation turns Gram error into d^2 error
# for close pairs, so a low-mantissa product can flip contacts or make
# d^2 negative; PERF.md records the on-card comparison behind this value.
GRAM_PRECISION = jax.lax.Precision.HIGHEST


def pair_d2_gram(xc: jax.Array) -> jax.Array:
    """Squared pair distances [N, N] of centered positions via the Gram
    form, at :data:`GRAM_PRECISION`."""
    sq = jnp.sum(xc * xc, axis=-1)                            # [N]
    gram = jnp.dot(
        xc, xc.T, preferred_element_type=jnp.float32,
        precision=GRAM_PRECISION,
    )
    return sq[:, None] + sq[None, :] - 2.0 * gram


def self_collision_forces_dense_mxu(x: jax.Array, radius: float, stiffness: float):
    """Matmul-form pairwise repulsion for small-per-scene-N batched
    workloads (BASELINE.json:11).

    Identity with the oracle rule: with w_ij = k*(r-d_ij)/d_ij over active
    pairs,  f_i = (sum_j w_ij) x_i - (W @ x)_i.  Both the Gram matrix
    (d^2 = |xi|^2+|xj|^2-2 xi.xj) and W@x are batched matmuls; no sort,
    no gather.  Positions are centered first so the Gram cancellation
    stays well-conditioned in f32.  Above a few thousand vertices per
    scene the O(N^2) planes outgrow the sparse methods ("hash", "block").
    """
    xc = x - jnp.mean(x, axis=0, keepdims=True)
    d2 = pair_d2_gram(xc)
    n_v = x.shape[0]
    eye = jnp.eye(n_v, dtype=bool)
    # cancellation floor: clamp a radius-relative epsilon, not 1e-24, so a
    # residually-negative d2 can't fabricate a near-zero distance
    d = jnp.sqrt(jnp.maximum(d2, (1e-3 * radius) ** 2))
    active = (d < radius) & (~eye)
    w = jnp.where(active, stiffness * (radius - d) / d, 0.0)  # [N,N] >= 0
    row = jnp.sum(w, axis=1)                                  # [N]
    wx = jnp.dot(
        w, xc, preferred_element_type=jnp.float32,
        precision=GRAM_PRECISION,
    )
    return row[:, None] * xc - wx


def self_collision_forces_dense(x: jax.Array, radius: float, stiffness: float):
    """Brute-force O(N^2) pairwise repulsion — jnp twin of the oracle rule,
    used for small scenes and as the hash-grid test oracle."""
    diff = x[None, :, :] - x[:, None, :]
    dist2 = jnp.sum(diff * diff, axis=-1)
    dist = jnp.sqrt(dist2)
    n_v = x.shape[0]
    eye = jnp.eye(n_v, dtype=bool)
    dist = jnp.where(eye, jnp.inf, dist)
    overlap = radius - dist
    active = overlap > 0.0
    dirs = diff / jnp.maximum(dist, 1e-12)[:, :, None]
    f = -(stiffness * jnp.where(active, overlap, 0.0))[:, :, None] * dirs
    return jnp.sum(f, axis=1)
