"""Offset-grouped ("banded") spring forces for arbitrary meshes — the
general edge-list path without gathers.

The classic edge loop gathers both endpoints of every edge and scatters
the forces back.  Observation: for any mesh with index
locality, most edges share the same index *delta* ``b - a`` — a regular
lattice (cloth grid, tet cube) has ~6-14 distinct deltas covering 100% of
edges.  Group edges by delta at build time; each group becomes

    xb = roll(x, -delta);  f_g = mask * hooke(xb - x);  F += f_g - roll(f_g, +delta)

— one roll in, one roll out, dense masked FMAs on ``[3, N]`` planes, zero
gathers, zero scatters.  Wrapped roll lanes always multiply into
mask-zeroed positions.  Edges whose delta group is too small fall back to the gather
path; the efficiency is ``(banded fraction) * stencil speed``.

This generalizes the grid stencil (kernels/stencil.py) to ANY topology and
is built automatically by :func:`build_offset_groups`; the solver uses it
whenever it covers enough of the edge list.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from .forces import length_dir_planes


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OffsetGroups:
    """Dense per-delta spring planes (built host-side, loaded once to HBM).

    For group g with delta d_g: vertex i owns an edge (i, i+d_g) iff
    ``mask[g, i] == 1``; its stiffness/rest/compliance live at ``[g, i]``.
    ``residual_*`` hold the leftover edges for the gather path.
    """

    mask: jax.Array        # f32[G, N] 1.0 where the edge exists
    stiffness: jax.Array   # f32[G, N]
    rest: jax.Array        # f32[G, N]
    compliance: jax.Array  # f32[G, N]
    residual_edges: jax.Array       # i32[R, 2]
    residual_rest: jax.Array        # f32[R]
    residual_stiffness: jax.Array   # f32[R]
    deltas: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True), default=()
    )
    # per-group (k, rest, compliance) when constant across the group, else
    # None — recorded host-side at build time so the scalars can be burned
    # in statically instead of carried as [G, N] planes
    uniform: Tuple[Optional[Tuple[float, float, float]], ...] = dataclasses.field(
        metadata=dict(static=True), default=()
    )

    @property
    def n_residual(self) -> int:
        return self.residual_edges.shape[0]


def build_offset_groups(
    n: int,
    edges: np.ndarray,
    rest: np.ndarray,
    stiffness: np.ndarray,
    compliance: np.ndarray,
    min_count: int = 32,
) -> "OffsetGroups":
    """Host-side grouping of edges by ``b - a`` (builders orient a < b)."""
    a = edges[:, 0].astype(np.int64)
    b = edges[:, 1].astype(np.int64)
    delta = b - a
    uniq, counts = np.unique(delta, return_counts=True)
    banded_deltas = [int(d) for d, c in zip(uniq, counts) if c >= min_count]
    g = len(banded_deltas)
    mask = np.zeros((max(g, 1), n), np.float64)
    k_pl = np.zeros((max(g, 1), n), np.float64)
    r_pl = np.zeros((max(g, 1), n), np.float64)
    c_pl = np.zeros((max(g, 1), n), np.float64)
    banded = np.zeros(edges.shape[0], bool)
    uniform = []
    for gi, d in enumerate(banded_deltas):
        sel = delta == d
        banded |= sel
        ai = a[sel]
        mask[gi, ai] = 1.0
        k_pl[gi, ai] = stiffness[sel]
        r_pl[gi, ai] = rest[sel]
        c_pl[gi, ai] = compliance[sel]
        ks, rs, cs = (
            np.unique(stiffness[sel].astype(np.float32)),
            np.unique(rest[sel].astype(np.float32)),
            np.unique(compliance[sel].astype(np.float32)),
        )
        uniform.append(
            (float(ks[0]), float(rs[0]), float(cs[0]))
            if len(ks) == 1 and len(rs) == 1 and len(cs) == 1
            else None
        )
    resid = ~banded
    return OffsetGroups(
        mask=jnp.asarray(mask, jnp.float32),
        stiffness=jnp.asarray(k_pl, jnp.float32),
        rest=jnp.asarray(r_pl, jnp.float32),
        compliance=jnp.asarray(c_pl, jnp.float32),
        residual_edges=jnp.asarray(edges[resid], jnp.int32),
        residual_rest=jnp.asarray(rest[resid], jnp.float32),
        residual_stiffness=jnp.asarray(stiffness[resid], jnp.float32),
        deltas=tuple(banded_deltas),
        uniform=tuple(uniform),
    )


def _roll_planes(a: jax.Array, shift: int) -> jax.Array:
    """roll along the vertex axis of [3, N] (or [G?, N]) planes."""
    return jnp.roll(a, shift, axis=-1)


def banded_spring_forces(
    groups: OffsetGroups, xT: jax.Array, vT: jax.Array, damping: float
) -> jax.Array:
    """Hooke + axial damper over the banded groups: f32[3, N].

    Mirrors the oracle's per-edge rule; each group is enumerated once with
    the force applied at the owner (+) and the neighbour (-) via rolls.
    """
    f = jnp.zeros_like(xT)
    for gi, delta in enumerate(groups.deltas):
        xb = _roll_planes(xT, -delta)
        vb = _roll_planes(vT, -delta)
        d = xb - xT
        # sqrt+div (not rsqrt) so the jnp path matches the oracle's
        # rounding to f64 exactness.  length_dir_planes keeps these EXACT ops as the compiled
        # primal and only swaps in grad-safe tangents (solver/forces.py).
        length, nrm = length_dir_planes(d)
        rel = jnp.sum((vb - vT) * nrm, axis=0)
        fmag = groups.mask[gi] * (
            groups.stiffness[gi] * (length - groups.rest[gi]) + damping * rel
        )
        fg = fmag * nrm
        f = f + fg - _roll_planes(fg, delta)
    return f


def residual_spring_forces(
    groups: OffsetGroups, x: jax.Array, v: jax.Array, damping: float
) -> jax.Array:
    """Gather-path forces for the (rare) edges outside every band: f32[N,3]."""
    if groups.n_residual == 0:
        return jnp.zeros_like(x)
    e = groups.residual_edges
    a, b = e[:, 0], e[:, 1]
    d = x[b] - x[a]
    length = jnp.linalg.norm(d, axis=1)
    n = d / jnp.maximum(length, 1e-12)[:, None]
    rel = jnp.einsum("ej,ej->e", v[b] - v[a], n,
                     precision=jax.lax.Precision.HIGHEST)
    fmag = groups.residual_stiffness * (length - groups.residual_rest) + damping * rel
    fe = fmag[:, None] * n
    out = jax.ops.segment_sum(fe, a, num_segments=x.shape[0])
    return out + jax.ops.segment_sum(-fe, b, num_segments=x.shape[0])


def spring_forces_banded(
    groups: OffsetGroups, x: jax.Array, v: jax.Array, cfg: SimConfig
) -> jax.Array:
    """Full spring forces [N, 3]: banded groups + residual gather edges."""
    xT = x.T
    vT = v.T
    f = banded_spring_forces(groups, xT, vT, cfg.springs.damping).T
    return f + residual_spring_forces(groups, x, v, cfg.springs.damping)


# ---------------------------------------------------------------------------
# Banded tet-volume projection
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TetGroups:
    """Tetrahedra grouped by their vertex-index delta pattern
    ``(t1-t0, t2-t0, t3-t0)`` — a lattice tet mesh (core/topology.tet_cube)
    has exactly 10 patterns (5 tets x 2 parities), so volume projection
    becomes rolls + dense FMAs, the same transformation as the banded
    springs.  Irregular tets fall into ``residual_*`` (gather path)."""

    mask: jax.Array          # f32[G, N]  1.0 where a tet is based at vertex i
    rest_volume: jax.Array   # f32[G, N]
    residual_tets: jax.Array         # i32[R, 4]
    residual_rest_volume: jax.Array  # f32[R]
    deltas: Tuple[Tuple[int, int, int], ...] = dataclasses.field(
        metadata=dict(static=True), default=()
    )
    # per-group rest volume when constant across the group, else None
    # (lattice tets of one delta pattern are congruent => always uniform)
    uniform_rest_volume: Tuple[Optional[float], ...] = dataclasses.field(
        metadata=dict(static=True), default=()
    )

    @property
    def n_residual(self) -> int:
        return self.residual_tets.shape[0]


def build_tet_groups(n: int, tets: np.ndarray, rest_volume: np.ndarray,
                     min_count: int = 32) -> "TetGroups":
    if tets.shape[0] == 0:
        z = np.zeros((1, n), np.float32)
        return TetGroups(
            mask=jnp.asarray(z), rest_volume=jnp.asarray(z),
            residual_tets=jnp.zeros((0, 4), jnp.int32),
            residual_rest_volume=jnp.zeros((0,), jnp.float32),
            deltas=(),
        )
    t0 = tets[:, 0].astype(np.int64)
    d = tets[:, 1:].astype(np.int64) - t0[:, None]        # [T, 3]
    patterns, inverse, counts = np.unique(
        d, axis=0, return_inverse=True, return_counts=True
    )
    keep = [i for i in range(len(patterns)) if counts[i] >= min_count]
    g = len(keep)
    mask = np.zeros((max(g, 1), n), np.float64)
    rv = np.zeros((max(g, 1), n), np.float64)
    banded = np.zeros(tets.shape[0], bool)
    deltas = []
    uniform_rv = []
    for gi, pi in enumerate(keep):
        sel = inverse == pi
        banded |= sel
        mask[gi, t0[sel]] = 1.0
        rv[gi, t0[sel]] = rest_volume[sel]
        deltas.append(tuple(int(x) for x in patterns[pi]))
        rvs = np.unique(rest_volume[sel].astype(np.float32))
        uniform_rv.append(float(rvs[0]) if len(rvs) == 1 else None)
    resid = ~banded
    return TetGroups(
        mask=jnp.asarray(mask, jnp.float32),
        rest_volume=jnp.asarray(rv, jnp.float32),
        residual_tets=jnp.asarray(tets[resid], jnp.int32),
        residual_rest_volume=jnp.asarray(rest_volume[resid], jnp.float32),
        deltas=tuple(deltas),
        uniform_rest_volume=tuple(uniform_rv),
    )


def _cross_planes(a, b):
    """cross product of two [3, N] plane stacks -> [3, N]."""
    return jnp.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def banded_volume_projection(
    groups: TetGroups, xT: jax.Array, wN: jax.Array, stiffness: float
) -> jax.Array:
    """PBD volume projection in banded form: dx planes f32[3, N].

    Oracle twin: oracle/reference.py volume_projection (count-averaged,
    stiffness-scaled, pinned vertices receive zero correction).
    """
    n = xT.shape[-1]
    dx = jnp.zeros_like(xT)
    cnt = jnp.zeros((n,), xT.dtype)
    for gi, (d1, d2, d3) in enumerate(groups.deltas):
        m = groups.mask[gi]
        p0 = xT
        p1 = _roll_planes(xT, -d1)
        p2 = _roll_planes(xT, -d2)
        p3 = _roll_planes(xT, -d3)
        e1, e2, e3 = p1 - p0, p2 - p0, p3 - p0
        g1 = _cross_planes(e2, e3) / 6.0
        g2 = _cross_planes(e3, e1) / 6.0
        g3 = _cross_planes(e1, e2) / 6.0
        g0 = -(g1 + g2 + g3)
        vol = jnp.sum(_cross_planes(e1, e2) * e3, axis=0) / 6.0
        c_val = vol - groups.rest_volume[gi]
        w0 = wN
        w1 = _roll_planes(wN, -d1)
        w2 = _roll_planes(wN, -d2)
        w3 = _roll_planes(wN, -d3)
        denom = (
            w0 * jnp.sum(g0 * g0, axis=0)
            + w1 * jnp.sum(g1 * g1, axis=0)
            + w2 * jnp.sum(g2 * g2, axis=0)
            + w3 * jnp.sum(g3 * g3, axis=0)
        )
        s = m * (-c_val) / jnp.maximum(denom, 1e-12)
        dx = dx + (w0 * s) * g0
        dx = dx + _roll_planes((w1 * s) * g1, d1)
        dx = dx + _roll_planes((w2 * s) * g2, d2)
        dx = dx + _roll_planes((w3 * s) * g3, d3)
        cnt = cnt + m + _roll_planes(m, d1) + _roll_planes(m, d2) + _roll_planes(m, d3)
    dx = stiffness * dx / jnp.maximum(cnt, 1.0)
    return jnp.where(wN > 0.0, dx, 0.0)


def volume_projection_banded(top, x: jax.Array, stiffness: float) -> jax.Array:
    """[N,3] wrapper combining banded tets + residual gather tets."""
    groups = top.tet_groups
    dx = banded_volume_projection(groups, x.T, top.inv_mass, stiffness).T
    if groups.n_residual > 0:
        from . import xpbd as _xpbd
        import dataclasses as _dc

        sub = _dc.replace(
            top, tets=groups.residual_tets, rest_volume=groups.residual_rest_volume
        )
        dx = dx + _xpbd.volume_projection(sub, x, stiffness)
    return dx


# ---------------------------------------------------------------------------
# Banded XPBD (distance + volume constraints with compliance)
# ---------------------------------------------------------------------------

def xpbd_iteration_banded(
    top, cfg: SimConfig, xT: jax.Array, lams, lam_vols, cnt, dt: float
):
    """One Jacobi sweep over banded distance + volume constraints,
    returning the relaxed position INCREMENT planes (delta-form caller
    accumulates; see solver/step.py substep_xpbd).

    Mirrors solver/xpbd.py::xpbd_iteration_dx exactly (same dlam, same
    count-averaging, same relaxation); lambdas are [N] planes per group.
    """
    groups: OffsetGroups = top.offset_groups
    tgroups: TetGroups = top.tet_groups
    wN = top.inv_mass
    dx = jnp.zeros_like(xT)
    new_lams = []
    for gi, delta in enumerate(groups.deltas):
        m = groups.mask[gi]
        xb = _roll_planes(xT, -delta)
        d = xb - xT
        # grad-safe norm, bit-identical forward (see spring_forces_banded)
        length, nrm = length_dir_planes(d)
        c_val = length - groups.rest[gi]
        alpha_t = groups.compliance[gi] / (dt * dt)
        wn = _roll_planes(wN, -delta)
        denom = jnp.maximum(wN + wn + alpha_t, 1e-12)
        dlam = -(c_val + alpha_t * lams[gi]) / denom * m
        new_lams.append(lams[gi] + dlam)
        dx = dx + (-(wN * dlam)) * nrm + _roll_planes((wn * dlam) * nrm, delta)
    new_lam_vols = []
    if tgroups is not None and len(tgroups.deltas) > 0:
        alpha_v = cfg.xpbd.compliance_volume / (dt * dt)
        for gi, (d1, d2_, d3) in enumerate(tgroups.deltas):
            m = tgroups.mask[gi]
            p0 = xT
            p1 = _roll_planes(xT, -d1)
            p2 = _roll_planes(xT, -d2_)
            p3 = _roll_planes(xT, -d3)
            e1, e2, e3 = p1 - p0, p2 - p0, p3 - p0
            g1 = _cross_planes(e2, e3) / 6.0
            g2 = _cross_planes(e3, e1) / 6.0
            g3 = _cross_planes(e1, e2) / 6.0
            g0 = -(g1 + g2 + g3)
            vol = jnp.sum(_cross_planes(e1, e2) * e3, axis=0) / 6.0
            c_v = vol - tgroups.rest_volume[gi]
            w0 = wN
            w1 = _roll_planes(wN, -d1)
            w2 = _roll_planes(wN, -d2_)
            w3 = _roll_planes(wN, -d3)
            denom = (
                w0 * jnp.sum(g0 * g0, axis=0)
                + w1 * jnp.sum(g1 * g1, axis=0)
                + w2 * jnp.sum(g2 * g2, axis=0)
                + w3 * jnp.sum(g3 * g3, axis=0)
                + alpha_v
            )
            dlam_v = -(c_v + alpha_v * lam_vols[gi]) / jnp.maximum(denom, 1e-12) * m
            new_lam_vols.append(lam_vols[gi] + dlam_v)
            dx = dx + (w0 * dlam_v) * g0
            dx = dx + _roll_planes((w1 * dlam_v) * g1, d1)
            dx = dx + _roll_planes((w2 * dlam_v) * g2, d2_)
            dx = dx + _roll_planes((w3 * dlam_v) * g3, d3)
    return cfg.xpbd.relaxation * dx / cnt, tuple(new_lams), tuple(new_lam_vols)


def xpbd_constraint_count(top) -> jax.Array:
    """Per-vertex constraint count [N] over banded edge + tet groups
    (== the general path's segment-sum count when residual is empty)."""
    groups: OffsetGroups = top.offset_groups
    tgroups: TetGroups = top.tet_groups
    n = top.inv_mass.shape[0]
    cnt = jnp.zeros((n,), jnp.float32)
    for gi, delta in enumerate(groups.deltas):
        m = groups.mask[gi]
        cnt = cnt + m + _roll_planes(m, delta)
    if tgroups is not None:
        for gi, (d1, d2, d3) in enumerate(tgroups.deltas):
            m = tgroups.mask[gi]
            cnt = cnt + m + _roll_planes(m, d1) + _roll_planes(m, d2) + _roll_planes(m, d3)
    return jnp.maximum(cnt, 1.0)


def xpbd_banded_applicable(top) -> bool:
    """Static gate: every edge and tet must be banded (no residual), so the
    count-average matches the general path exactly."""
    g = top.offset_groups
    t = top.tet_groups
    if g is None or len(g.deltas) == 0 or g.n_residual > 0:
        return False
    if t is not None and t.n_residual > 0:
        return False
    return True
