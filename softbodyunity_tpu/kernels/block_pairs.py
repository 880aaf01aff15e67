"""GPU kernel for the block-sparse self-collision tile pairs (Pallas,
Triton route), and the one place that picks it.

The sorting, bounding boxes and partner lists stay in XLA
(solver/blocksparse.py).  The jnp twin there forms one [blk, blk] pair
plane per (tile, partner budget slot), masked or not, and reduces it in
HBM.  Here each program owns ``rows`` vertices of one i-tile and walks
only that tile's ``nvalid`` interacting partner tiles (partners are
sorted interacting-first), ``cols`` partner vertices at a time.  The
[rows, cols] pair block lives in registers and is reduced to forces in
the program, so nothing crosses programs and no pair plane reaches
device memory.

Math (equal to the twin up to rounding, tests hold it to 5e-4):

* direct per-component differences, no Gram form, so no matmul
  precision question;
* ``w = max(stiffness*radius/d - stiffness, 0)`` with ``d`` clamped at
  ``1e-3*radius``: positive iff ``d < radius``, as the twin's select;
* padded tail vertices sit at far coordinates, so their pairs with real
  vertices have ``w = 0``, and pad-vs-pad forces land on dropped rows;
* no self-pair mask: a bit-coincident pair has ``dx = 0`` exactly and a
  finite ``w``, so it adds exactly zero, as in the oracle.

The backward pass is the jnp twin's VJP (``jax.custom_vjp``), so
``jax.grad`` through a self-colliding scene works on the card.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from ..core.config import SelfCollisionParams
from ..solver import blocksparse
from ..solver.blocksparse import _sorted_tiles, _tile_partners

# launch shape: the fastest of two sweeps on an H100 (PERF.md) — few rows
# per program puts many programs in flight, a whole partner tile per step
# cuts the loop overhead
ROWS = 16         # i-tile vertices per program
COLS = 256        # partner vertices per inner-loop step
NUM_WARPS = 2
NUM_STAGES = 2


def pair_route() -> str:
    """'triton' on the GPU, 'jnp' (the differentiable twin) on the CPU.
    Any other platform has no implementation here."""
    platform = jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "jnp"
    raise ValueError(
        f"block self-collision has no implementation for platform "
        f"{platform!r} (gpu: Triton kernel, cpu: jnp twin)")


def _kernel(partners_ref, nvalid_ref, xi_ref, xj_ref, fo_ref, *, radius,
            stiffness, rows, cols, blk):
    i = pl.program_id(0)
    r0 = pl.program_id(1) * rows
    eps2 = (1e-3 * radius) ** 2
    c1 = stiffness * radius
    xi = [xi_ref[i, c, pl.ds(r0, rows)][:, None] for c in range(3)]

    def body(k, acc):
        pk = partners_ref[i, k]
        for c0 in range(0, blk, cols):           # static column chunks
            dx = [xi[c] - xj_ref[pk, c, pl.ds(c0, cols)][None, :]
                  for c in range(3)]
            d2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
            w = jnp.maximum(c1 * jax.lax.rsqrt(jnp.maximum(d2, eps2))
                            - stiffness, 0.0)
            acc = tuple(a + jnp.sum(w * d, axis=1) for a, d in zip(acc, dx))
        return acc

    zero = jnp.zeros((rows,), jnp.float32)
    acc = jax.lax.fori_loop(0, nvalid_ref[i], body, (zero, zero, zero))
    for c in range(3):
        fo_ref[i, c, pl.ds(r0, rows)] = acc[c]


@functools.partial(jax.jit, static_argnames=(
    "radius", "stiffness", "rows", "cols", "num_warps", "num_stages",
    "interpret"))
def block_pairs(xi_tiles, xj_tiles, nvalid, partners, *, radius, stiffness,
                rows=ROWS, cols=COLS, num_warps=NUM_WARPS,
                num_stages=NUM_STAGES, interpret=False):
    """Forces on ``xi_tiles`` f32[Bi, 3, blk] from the first ``nvalid[i]``
    partner tiles ``partners`` i32[Bi, K] of ``xj_tiles`` f32[Bj, 3, blk]
    -> f32[Bi, 3, blk] (sorted-tile order)."""
    b_i, _, blk = xi_tiles.shape
    rows, cols = min(rows, blk), min(cols, blk)
    if blk & (blk - 1) or blk % rows or blk % cols:
        raise ValueError(
            f"block_size {blk} must be a power of two divisible by the "
            f"kernel's rows={rows} and cols={cols}")
    kernel = functools.partial(_kernel, radius=radius, stiffness=stiffness,
                               rows=rows, cols=cols, blk=blk)
    # inside shard_map (the halo rows) the forces vary over the same mesh
    # axes as the local tiles
    vma = jax.typeof(xi_tiles).vma | jax.typeof(xj_tiles).vma
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((b_i, 3, blk), jnp.float32, vma=vma),
        grid=(b_i, blk // rows),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=num_warps,
                                            num_stages=num_stages),
        interpret=interpret,
        name="self_collision_block_pairs",
    )(partners, nvalid, xi_tiles, xj_tiles)


def _tiles_and_partners(xi, xall, p):
    """Sorted far-padded tiles of both sides plus the partner lists.
    ``xall is xi`` builds one tiling (the single-scene form)."""
    xb_i, valid_i, order_i, _ = _sorted_tiles(xi, p.cell_size, p.block_size)
    if xall is xi:
        xb_g, valid_g = xb_i, valid_i
        k = min(p.block_partners, xb_i.shape[0])
        partners, pvalid, _ = _tile_partners(xb_i, valid_i, p.radius, k)
    else:
        xb_g, valid_g, _, b_g = _sorted_tiles(xall, p.cell_size,
                                              p.block_size)
        k = min(p.block_partners, b_g)
        partners, pvalid, _ = _tile_partners(
            xb_i, valid_i, p.radius, k, xb_j=xb_g, valid_j=valid_g)
    nvalid = jnp.sum(pvalid, axis=1).astype(jnp.int32)
    # opposite far signs: pad-vs-pad pairs across two tilings sit 2e6
    # apart (never coincident); real-vs-pad exceeds radius either way
    xt_i = jnp.swapaxes(jnp.where(valid_i[..., None], xb_i, -1e6), 1, 2)
    xt_g = (xt_i if xall is xi else
            jnp.swapaxes(jnp.where(valid_g[..., None], xb_g, 1e6), 1, 2))
    return xt_i, xt_g, nvalid, partners.astype(jnp.int32), order_i


def _forward(xi, xall, p, interpret):
    xt_i, xt_g, nvalid, partners, order = _tiles_and_partners(xi, xall, p)
    f = block_pairs(xt_i, xt_g, nvalid, partners, radius=float(p.radius),
                    stiffness=float(p.stiffness), interpret=interpret)
    f_sorted = jnp.swapaxes(f, 1, 2).reshape(-1, 3)[:xi.shape[0]]
    return f_sorted[jnp.argsort(order)]


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def forces_block_kernel(x, p: SelfCollisionParams, interpret: bool = False):
    """Kernel twin of ``blocksparse.self_collision_forces_block``."""
    return _forward(x, x, p, interpret)


def _single_fwd(x, p, interpret):
    return _forward(x, x, p, interpret), x


def _single_bwd(p, interpret, x, g):
    _, vjp = jax.vjp(lambda y: blocksparse.self_collision_forces_block(y, p),
                     x)
    return vjp(g)


forces_block_kernel.defvjp(_single_fwd, _single_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def forces_block_dual_kernel(xi, xall, p: SelfCollisionParams,
                             interpret: bool = False):
    """Kernel twin of ``blocksparse.self_collision_forces_block_dual``:
    forces ON ``xi`` (a subset of ``xall``) from the exact global pair
    set (the row-sharded halo form)."""
    return _forward(xi, xall, p, interpret)


def _dual_fwd(xi, xall, p, interpret):
    return _forward(xi, xall, p, interpret), (xi, xall)


def _dual_bwd(p, interpret, res, g):
    _, vjp = jax.vjp(
        lambda a, b: blocksparse.self_collision_forces_block_dual(a, b, p),
        *res)
    return vjp(g)


forces_block_dual_kernel.defvjp(_dual_fwd, _dual_bwd)


def self_collision_forces_block(x, p: SelfCollisionParams):
    """Block-sparse self-collision forces f32[N, 3] on this platform."""
    if pair_route() == "triton":
        return forces_block_kernel(x, p)
    return blocksparse.self_collision_forces_block(x, p)


def self_collision_forces_block_dual(xi, xall, p: SelfCollisionParams):
    """Dual (halo) form of :func:`self_collision_forces_block`."""
    if pair_route() == "triton":
        return forces_block_dual_kernel(xi, xall, p)
    return blocksparse.self_collision_forces_block_dual(xi, xall, p)
