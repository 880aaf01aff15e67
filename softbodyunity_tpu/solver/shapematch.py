"""Meshless shape matching — device twin of the oracle's binding
semantics (``oracle/reference.py::shape_match_dx`` /
``extract_rotations``; Muller et al. "Meshless Deformations Based on
Shape Matching" + the 2016 branchless rotation extraction).

Clusters are irregular (any vertex subset), so this is a general jnp
path: the cluster reductions are one-hot matmuls at HIGHEST precision
(or ``segment_sum`` above :data:`ONEHOT_MAX_ELEMS`) and everything else
is elementwise.  The stencil path gates off when shape matching is on
(``kernels/dispatch.py``).

The shape matrix is accumulated about the CURRENT centroid,
``A = sum m_i (x_i - c) q_i^T``, which equals the oracle's uncentered
``sum m_i x_i q_i^T`` exactly in real arithmetic (the rest offsets are
mass-centered so ``sum m_i q_i = 0``) but avoids an ``|x| * eps``
rounding penalty in f32 when the body sits far from the origin.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.topology import Topology


def _quat_mul(p, q):
    """Batched Hamilton product, wxyz, [K, 4] x [K, 4] -> [K, 4]
    (oracle ``_quat_mul`` twin)."""
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw,
    ], axis=-1)


def _quat_from_rotvec(t):
    """Batched exponential map [K, 3] -> [K, 4] wxyz, series-safe near
    zero (oracle ``_quat_from_rotvec`` twin, branchless)."""
    angle = jnp.linalg.norm(t, axis=-1, keepdims=True)
    small = angle < 1e-12
    axis = t / jnp.where(small, 1.0, angle)
    h = 0.5 * angle
    w = jnp.where(small, 1.0, jnp.cos(h))
    xyz = jnp.where(small, 0.5 * t, jnp.sin(h) * axis)
    return jnp.concatenate([w, xyz], axis=-1)


def _quat_to_matrix(q):
    """Batched unit quaternion (wxyz) -> rotation matrix [K, 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)], axis=-1),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)], axis=-1),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)], axis=-1),
    ], axis=-2)


def extract_rotations(A, quats, iterations: int):
    """Rotation part of each cluster's shape matrix ``A`` f32[K, 3, 3]
    via the warm-started branchless quaternion iteration (oracle
    ``extract_rotations`` twin — identical fixed-iteration recurrence,
    so oracle and device agree to rounding).  ``iterations`` is static
    and small (default 4), so the sweep loop unrolls."""
    q = quats
    for _ in range(iterations):
        R = _quat_to_matrix(q)
        # omega = sum_cols r_i x a_i / (|sum R.A| + 1e-9)
        num = (jnp.cross(R[..., :, 0], A[..., :, 0])
               + jnp.cross(R[..., :, 1], A[..., :, 1])
               + jnp.cross(R[..., :, 2], A[..., :, 2]))
        den = jnp.abs((R * A).sum(axis=(-2, -1)))[..., None] + 1e-9
        qn = _quat_mul(_quat_from_rotvec(num / den), q)
        q = qn / jnp.linalg.norm(qn, axis=-1, keepdims=True)
    return q


# above this many one-hot matrix elements (N * K f32, 64 MB at the
# threshold) the dense-matmul formulation's memory traffic outgrows the
# gathers it replaces; fall back to the segment_sum path
ONEHOT_MAX_ELEMS = 2 ** 24


def _cross_rows(a, b):
    """Cross product on [3, ...] component-row stacks."""
    return jnp.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def _separable_axes(cid3):
    """Per-axis cell labels for a raster-separable cluster field, or None.

    ``cid3`` is the cluster id reshaped ``[nx, ny, nz]`` (-1 = no
    cluster).  Spatial-cell clustering (``enable_shape_matching
    (cell_size=...)``) on a regular lattice factors per raster axis:
    ``cid[i,j,k] = kmap[ax[i], ay[j], az[k]]`` with each axis label a
    CONSECUTIVE RUN of indices (cells are intervals of a monotone
    coordinate).  Run boundaries are detected from the data: slices i and
    i+1 belong to different cells iff any position movable in both
    carries different ids (same x-cell => identical ids wherever both are
    movable).  Ambiguous boundaries (no commonly-movable position) split
    conservatively; the caller VERIFIES the reconstruction exactly and
    falls back to the one-hot path on any mismatch, so this is never
    load-bearing for correctness."""
    import numpy as np

    axes = []
    for a in range(3):
        c = np.moveaxis(cid3, a, 0).reshape(cid3.shape[a], -1)
        both = (c[:-1] >= 0) & (c[1:] >= 0)
        differs = (c[:-1] != c[1:]) & both
        boundary = differs.any(axis=1) | ~both.any(axis=1)
        axes.append(np.concatenate([[0], np.cumsum(boundary)]).astype(
            np.int64))
    return axes


def kron_factors_host(cid, lattice_shape, n_clusters):
    """Host-side (concrete numpy) Kronecker factorization of a cluster
    field on a raster lattice: per-axis one-hots ``(f32[nx, ncx],
    f32[ny, ncy], f32[nz, ncz])`` and the occupied-cell map
    ``f32[ncx*ncy*ncz, K]``, or None when the field is not separable.

    Runs ONCE in :func:`softbodyunity_tpu.api.device_topology` (the
    host->device boundary — ``cluster_id`` is still concrete there; under
    jit dispatch it is a tracer) and the factors travel on the Topology
    as array data.  Exactness: the reconstruction
    ``kmap[ax[i], ay[j], az[k]] == cid[i,j,k]`` is verified entry by
    entry on the movable support; any mismatch returns None and callers
    keep the general one-hot path."""
    import numpy as np

    nx, ny, nz = lattice_shape
    cid3 = np.asarray(cid).reshape(nx, ny, nz)
    ax, ay, az = _separable_axes(cid3)
    ncx, ncy, ncz = int(ax[-1]) + 1, int(ay[-1]) + 1, int(az[-1]) + 1
    k = int(n_clusters)
    if ncx * ncy * ncz > max(4 * k, 64):
        # badly over-fragmented axes: not the cell structure we expect
        return None
    kmap = np.full((ncx, ncy, ncz), -1, np.int64)
    gx, gy, gz = np.meshgrid(ax, ay, az, indexing="ij")
    mov = cid3 >= 0
    kmap[gx[mov], gy[mov], gz[mov]] = cid3[mov]
    if not np.array_equal(kmap[gx, gy, gz][mov], cid3[mov]):
        return None                          # not separable: keep one-hot
    occ_oh = (kmap.reshape(-1)[:, None] == np.arange(k)).astype(np.float32)
    one_hot = lambda lbl, nc: (lbl[:, None] == np.arange(nc)).astype(
        np.float32)
    return one_hot(ax, ncx), one_hot(ay, ncy), one_hot(az, ncz), occ_oh


def shape_match_kron_statics(top: Topology):
    """Kronecker-factored cluster reduction data for raster lattices, or
    None when the Topology carries no factors (non-lattice or
    non-separable clusters — see :func:`kron_factors_host`).

    Spatial shape-matching clusters on a ``lattice_shape`` raster factor
    as a Kronecker product of three per-axis one-hots: the [N, K]
    one-hot matmuls of :func:`shape_match_dx` (~40 MB of device memory
    per read at 97k x 104)
    become three tiny per-axis contractions over the ``[nx, ny, nz]``
    reshaped raster plus an [n_cells, K] occupied-cell map, with traffic
    ~= the state planes themselves.  Tracer-safe: everything here is
    jnp on Topology arrays (loop-invariant — XLA hoists it out of the
    substep scan)."""
    if top.cluster_kron_x is None or top.cluster_id is None:
        return None
    ox, oy, oz = top.cluster_kron_x, top.cluster_kron_y, top.cluster_kron_z
    occ_oh = top.cluster_kron_cells
    dims = (ox.shape[0], oy.shape[0], oz.shape[0])
    if dims[0] * dims[1] * dims[2] != top.n_vertices:
        return None
    member = (top.cluster_id >= 0) & (top.inv_mass > 0.0)
    m = jnp.where(member, 1.0 / jnp.maximum(top.inv_mass, 1e-30), 0.0)
    # merged y*z factor: [ny*nz, ncy*ncz].  The reduction runs as
    # (x-batched) matmuls over the merged minor axis — a [46,46,46]
    # 3-factor chain measured ~7x slower from sub-lane-width relayouts
    # (minor dims 46 << 128 idle most lanes and every reshape copies)
    oyz = (oy[:, None, :, None] * oz[None, :, None, :]).reshape(
        oy.shape[0] * oz.shape[0], -1)
    r3 = top.cluster_rest.T
    nx = dims[0]
    # loop-invariant (built once, hoisted out of the substep scan), so
    # HIGHEST is free — a reduced-mantissa pass quantizes the cluster
    # masses to ~2e-3 relative, a noise floor under every per-substep dx
    hp = jax.lax.Precision.HIGHEST

    def _reduce(u):
        g = jnp.einsum("rw,wm->rm", u.reshape(-1, oyz.shape[0]), oyz,
                       precision=hp).reshape(u.shape[0], nx, -1)
        g = jnp.einsum("cxw,xa->caw", g, ox, precision=hp)
        return jnp.einsum("cg,gk->ck", g.reshape(u.shape[0], -1), occ_oh,
                          precision=hp)

    mass = _reduce(m[None])[0]
    # s_r[e, k] = sum_n w r_e: ~0 by mass-centering of the rest offsets;
    # subtracting c*s_r makes the single-pass shape matrix equal the
    # centered one exactly in real arithmetic (shape_match_dx_kron)
    s_r = _reduce(m[None] * r3)
    mass_k = jnp.maximum(mass, 1e-30)
    return dict(
        dims=dims, ox=ox, oyz=oyz, occ_oh=occ_oh,
        m=m, member=member, r3=r3, s_r=s_r,
        inv_mass_k=1.0 / mass_k,
        # cluster mass fractions: the warm global-centroid update
        # x0' = x0 + sum_k frac_k c_k needs only [K]-sized math
        mass_frac=mass_k / jnp.maximum(jnp.sum(mass), 1e-30),
        inv_mass_total=1.0 / jnp.maximum(jnp.sum(mass), 1e-30),
    )


def extract_rotations_cols(A, q, iterations: int):
    """Column-layout twin of :func:`extract_rotations`: ``A f32[3, 3, K]``
    (d, e, cluster) and ``q f32[4, K]`` with the cluster axis LAST, so
    every op in the iteration is a wide elementwise op instead of many
    small [K, 3, 3] relayouts.  Identical fixed-iteration recurrence to
    the oracle's ``extract_rotations``."""
    for _ in range(iterations):
        w, x, y, z = q[0], q[1], q[2], q[3]
        r00 = 1 - 2 * (y * y + z * z)
        r01 = 2 * (x * y - w * z)
        r02 = 2 * (x * z + w * y)
        r10 = 2 * (x * y + w * z)
        r11 = 1 - 2 * (x * x + z * z)
        r12 = 2 * (y * z - w * x)
        r20 = 2 * (x * z - w * y)
        r21 = 2 * (y * z + w * x)
        r22 = 1 - 2 * (x * x + y * y)
        rcols = (jnp.stack([r00, r10, r20]), jnp.stack([r01, r11, r21]),
                 jnp.stack([r02, r12, r22]))                   # [3, K] each
        num = sum(_cross_rows(rcols[i], A[:, i]) for i in range(3))
        den = jnp.abs(sum(rcols[i][d] * A[d, i] for i in range(3)
                          for d in range(3)))[None] + 1e-9
        t = num / den
        # quat exp map (oracle _quat_from_rotvec, column layout)
        angle = jnp.sqrt(jnp.sum(t * t, axis=0, keepdims=True))
        small = angle < 1e-12
        axis = t / jnp.where(small, 1.0, angle)
        h = 0.5 * angle
        dw = jnp.where(small, 1.0, jnp.cos(h))[0]
        dxyz = jnp.where(small, 0.5 * t, jnp.sin(h) * axis)
        # Hamilton product (dw, dxyz) * q, column layout
        qn = jnp.stack([
            dw * w - dxyz[0] * x - dxyz[1] * y - dxyz[2] * z,
            dw * x + dxyz[0] * w + dxyz[1] * z - dxyz[2] * y,
            dw * y - dxyz[0] * z + dxyz[1] * w + dxyz[2] * x,
            dw * z + dxyz[0] * y - dxyz[1] * x + dxyz[2] * w,
        ])
        q = qn / jnp.sqrt(jnp.sum(qn * qn, axis=0, keepdims=True))
    return q


# Precision of the per-substep one-hot contractions of the Kronecker form
# (the selector operand is exact 0/1 and the value operand is O(extent));
# PERF.md records the on-card comparison behind this value.
KRON_PRECISION = jax.lax.Precision.HIGHEST


def shape_match_dx_kron(cfg: SimConfig, statics, x3f, quats, x0=None):
    """Raster-separable twin of :func:`shape_match_dx_flat` with the
    [N, K] one-hot contractions replaced by per-axis Kronecker factors
    (see :func:`shape_match_kron_statics`).  ``x3f f32[3, n]`` are
    UNPADDED flat component rows in raster order.  Returns ``(dx
    f32[3, n], quats' f32[K, 4], x0' f32[3, 1])``.

    Cost shape: ONE 12-row reduce (centroid + shape-matrix moments) and
    ONE 7-row broadcast per substep; rotation extraction runs in column
    layout (:func:`extract_rotations_cols`).  The moments are
    accumulated about the WARM global mass centroid ``x0`` — the
    previous substep's, carried through the scan (pass ``None`` to
    bootstrap from the current positions with one reduce) — and
    recentered per cluster exactly via the loop-invariant ``s_r`` sums.
    Any reference point near the body conditions the single-pass reduce
    (the exactness of the recentering is reference-independent), so the
    one-substep lag is irrelevant; the fresh centroid comes back out of
    the SAME reduce via [K]-sized math, so the carry costs nothing.

    NOTHING at absolute-position scale enters a matmul: without the
    shift, the uncentered ``sum m x r`` reduce accumulates O(|x|·r)
    rounding that survives the exact real-arithmetic recentering —
    measured 2.3e-1 quat error at offset (100, 100.4, 100) vs 1.7e-7 at
    the origin, and even the per-cluster centroids contracted at
    absolute scale left 4.7e-4 relative error in ``dx`` on an
    accelerator (a resting jelly blew up to 112x its extent within 250
    frames).  The shift cancels
    exactly in ``dx = s (g - x)``, so it is never added back; the
    far-from-origin twin test locks the property in.  The wide matmuls
    contract one-hot rows at :data:`KRON_PRECISION`; everything feeding
    the ``x - c`` / ``g - x`` cancellations stays f32 elementwise."""
    sm = cfg.shape_match
    hp = KRON_PRECISION
    nx, ny, nz = statics["dims"]
    ox, oyz = statics["ox"], statics["oyz"]
    occ_oh = statics["occ_oh"]
    m, r3 = statics["m"], statics["r3"]
    n = nx * ny * nz
    ncx, ncyz = ox.shape[1], oyz.shape[1]

    def reduce(u):                                   # [C, n] -> [C, K]
        c = u.shape[0]
        g = jnp.einsum("rw,wm->rm", u.reshape(-1, ny * nz), oyz,
                       precision=hp).reshape(c, nx, ncyz)
        g = jnp.einsum("cxw,xa->caw", g, ox, precision=hp)
        return jnp.einsum("cg,gk->ck", g.reshape(c, -1), occ_oh,
                          precision=hp)

    def bcast(v):                                    # [C, K] -> [C, n]
        c = v.shape[0]
        g = jnp.einsum("ck,gk->cg", v, occ_oh, precision=hp)
        g = g.reshape(c, ncx, ncyz)
        g = jnp.einsum("caw,xa->cxw", g, ox, precision=hp)
        g = jnp.einsum("rm,wm->rw", g.reshape(-1, ncyz), oyz,
                       precision=hp)
        return g.reshape(c, n)

    if x0 is None:                                   # bootstrap
        x0 = (jnp.sum(m[None] * x3f, axis=1, keepdims=True)
              * statics["inv_mass_total"])           # [3, 1]
    xr = x3f - x0
    wx = m[None] * xr
    p12 = jnp.concatenate(
        [wx, (wx[:, None, :] * r3[None, :, :]).reshape(9, -1)])
    red = reduce(p12)                                     # [12, K]
    c = red[:3] * statics["inv_mass_k"][None, :]          # [3, K]
    # recenter: A[d,e] = sum w xr_d r_e - c_d S_r[e] (exact in real
    # arithmetic since sum w r = 0 by construction; conditioned because
    # xr is O(extent))
    A = (red[3:].reshape(3, 3, -1)
         - c[:, None, :] * statics["s_r"][None, :, :])    # [3, 3, K]
    q = extract_rotations_cols(A, quats.T, sm.iterations)  # [4, K]
    b = bcast(jnp.concatenate([c, q]))                    # [7, n]
    cb, qn = b[:3], b[3:]
    qw, qv = qn[0:1], qn[1:]
    # g - x = r3 + rot + (cb + x0) - x = r3 + rot + cb - xr: the x0
    # shift cancels exactly, so absolute coordinates never re-enter
    g_rel = r3 + 2.0 * _cross_rows(qv, _cross_rows(qv, r3) + qw * r3) + cb
    dx = sm.stiffness * (g_rel - xr)
    x0_new = x0 + jnp.sum(c * statics["mass_frac"][None, :], axis=1,
                          keepdims=True)                  # [3, 1]
    return jnp.where(statics["member"][None], dx, 0.0), q.T, x0_new


def shape_match_dx(top: Topology, cfg: SimConfig, x, quats):
    """Per-substep shape-matching position correction (oracle
    ``shape_match_dx`` twin): per cluster, current mass centroid ``c``,
    shape matrix ``A = sum m_i (x_i - c) q_i^T`` over movable members,
    rotation from :func:`extract_rotations` warm-started at ``quats``,
    goals ``g_i = R q_i + c``, ``dx_i = stiffness * (g_i - x_i)`` on
    movable members only (zero net momentum: ``sum m_i q_i = 0`` by
    construction in ``enable_shape_matching``).  Returns
    ``(dx f32[N, 3], quats' f32[K, 4])``.

    Formulation: the per-cluster reductions and the broadcast-back are
    expressed through a mass-weighted one-hot membership matrix
    ``W f32[N, K]`` — ``[K, N] @ [N, d]`` matmuls replace segment_sum
    scatters, and ``onehot @ per_cluster`` replaces the ``[cid]``
    gathers.  HIGHEST matmul precision: the A-matrix and centroid feed
    cancellations (``x - c[cid]``, ``g - x``) — reduced-mantissa
    products corrupt those (CLAUDE.md "Matmul precision").  Equal to the oracle in
    real arithmetic; reduction ORDER differs only by f32/f64 rounding.
    Scenes with ``N * K`` beyond ``ONEHOT_MAX_ELEMS`` take the
    segment_sum path instead."""
    sm = cfg.shape_match
    k = int(top.n_clusters)
    cid_raw = top.cluster_id
    member = (cid_raw >= 0) & (top.inv_mass > 0.0)
    m = jnp.where(member, 1.0 / jnp.maximum(top.inv_mass, 1e-30), 0.0)
    r = top.cluster_rest
    if x.shape[0] * k <= ONEHOT_MAX_ELEMS:
        hp = jax.lax.Precision.HIGHEST
        # cid == arange(K) never matches -1, so non-members drop out of
        # the plain one-hot too (used for the broadcast-backs)
        oh = (cid_raw[:, None] == jnp.arange(k, dtype=cid_raw.dtype)
              ).astype(x.dtype)
        w = m[:, None] * oh
        mass = jnp.sum(w, axis=0)
        cx = jnp.einsum("nk,nd->kd", w, x, precision=hp)
        c = cx / jnp.maximum(mass, 1e-30)[:, None]
        cb = jnp.einsum("nk,kd->nd", oh, c, precision=hp)     # c[cid]
        xc = x - cb
        A = jnp.einsum(
            "nk,nde->kde", w, xc[:, :, None] * r[:, None, :], precision=hp
        )
        quats = extract_rotations(A, quats, sm.iterations)
        qn = jnp.einsum("nk,kq->nq", oh, quats, precision=hp)  # quats[cid]
    else:
        cid = jnp.maximum(cid_raw, 0)
        mass = jax.ops.segment_sum(m, cid, num_segments=k)
        cx = jax.ops.segment_sum(m[:, None] * x, cid, num_segments=k)
        c = cx / jnp.maximum(mass, 1e-30)[:, None]
        cb = c[cid]
        xc = x - cb
        A = jax.ops.segment_sum(
            m[:, None, None] * xc[:, :, None] * r[:, None, :],
            cid, num_segments=k,
        )
        quats = extract_rotations(A, quats, sm.iterations)
        qn = quats[cid]
    # vectorized quat rotate of the rest offsets: v + 2 qv x (qv x v + qw v)
    qv, qw = qn[:, 1:], qn[:, 0:1]
    g = r + 2.0 * jnp.cross(qv, jnp.cross(qv, r) + qw * r) + cb
    dx = sm.stiffness * (g - x)
    return jnp.where(member[:, None], dx, 0.0), quats
