"""Signed-distance-field voxelization of triangle meshes (host-side).

The Unity ``MeshCollider`` analogue: an arbitrary **watertight** triangle
mesh becomes a static collider by baking it once, host-side, into a signed
distance grid that the solvers sample with trilinear interpolation
(``oracle/reference.py`` ``_sdf_sample_grad`` is the binding sampling
semantics; ``solver/collide.py`` mirrors it on device).

Why an SDF and not exact mesh contact: per-vertex trilinear sampling is
8 small gathers into a small grid — O(N) and shape-static — whereas
exact vertex-triangle contact is a broad-phase + dynamic candidate
lists.  Baking runs exactly once on the host
(same contract as topology construction, BASELINE.json:5 "loaded once
to HBM").

Build pipeline (float64 NumPy, vectorized over voxels x triangle chunks):

* unsigned distance = min over triangles of point-to-triangle distance
  (interior projection where the barycentric clamp keeps it, else the
  nearest of the three edge segments);
* sign by +x ray-crossing parity (odd = inside).  Watertight input is the
  caller's contract — Unity imposes the same on convex MeshColliders.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np


def _point_segment_dist2(p: np.ndarray, a: np.ndarray, b: np.ndarray
                         ) -> np.ndarray:
    """Squared distance from points p[P,3] to segments a->b ([T,3]) for
    every pair: returns [P, T]."""
    ab = b - a                                        # [T,3]
    l2 = np.maximum((ab * ab).sum(axis=1), 1e-300)    # [T]
    ap = p[:, None, :] - a[None, :, :]                # [P,T,3]
    t = np.clip((ap * ab[None, :, :]).sum(axis=2) / l2[None, :], 0.0, 1.0)
    closest = a[None, :, :] + t[:, :, None] * ab[None, :, :]
    d = p[:, None, :] - closest
    return (d * d).sum(axis=2)


def _point_triangle_dist2(p: np.ndarray, v0: np.ndarray, v1: np.ndarray,
                          v2: np.ndarray) -> np.ndarray:
    """Squared distance from points p[P,3] to triangles (v0,v1,v2)[T,3]:
    plane projection where the barycentric coordinates are interior, else
    the nearest edge segment.  Returns [P, T]."""
    n = np.cross(v1 - v0, v2 - v0)                    # [T,3]
    nn_raw = (n * n).sum(axis=1)                      # [T] (4*area^2)
    nn = np.maximum(nn_raw, 1e-300)
    ap = p[:, None, :] - v0[None, :, :]               # [P,T,3]
    dist_plane = (ap * n[None, :, :]).sum(axis=2)     # signed * |n|
    proj = p[:, None, :] - (dist_plane / nn)[:, :, None] * n[None, :, :]
    # barycentric of the projected point (w.r.t. v0,v1,v2)
    e0 = v1 - v0
    e1 = v2 - v0
    d00 = (e0 * e0).sum(axis=1)
    d01 = (e0 * e1).sum(axis=1)
    d11 = (e1 * e1).sum(axis=1)
    denom = np.maximum(d00 * d11 - d01 * d01, 1e-300)
    vp = proj - v0[None, :, :]
    d20 = (vp * e0[None, :, :]).sum(axis=2)
    d21 = (vp * e1[None, :, :]).sum(axis=2)
    bv = (d11 * d20 - d01 * d21) / denom
    bw = (d00 * d21 - d01 * d20) / denom
    # degenerate (zero-area) triangles — e.g. UV-sphere pole fans with
    # duplicated vertices — have n == 0 exactly, which makes the clamped
    # plane/barycentric math claim "interior at distance 0" for EVERY
    # point; force them onto the edge-distance branch (correct: a
    # degenerate triangle IS its edges).  The guard MUST use the raw
    # squared area: the clamped nn is >= 1e-300 > 0 and would pass.
    area_ok = nn_raw > 1e-18 * np.maximum(d00, d11) ** 2
    interior = (bv >= 0.0) & (bw >= 0.0) & (bv + bw <= 1.0) \
        & area_ok[None, :]
    d2_plane = dist_plane * dist_plane / nn[None, :]
    d2_edges = np.minimum(
        _point_segment_dist2(p, v0, v1),
        np.minimum(_point_segment_dist2(p, v1, v2),
                   _point_segment_dist2(p, v2, v0)),
    )
    return np.where(interior, d2_plane, d2_edges)


def _ray_parity_x(p: np.ndarray, v0: np.ndarray, v1: np.ndarray,
                  v2: np.ndarray) -> np.ndarray:
    """Crossing count (mod 2 gives inside) of +x rays from p[P,3] against
    triangles [T,3]: Moller-Trumbore specialized to direction (1,0,0)."""
    e1 = v1 - v0
    e2 = v2 - v0
    # h = dir x e2 with dir=(1,0,0) => (0, -e2z, e2y)
    hy = -e2[:, 2]
    hz = e2[:, 1]
    a = e1[:, 1] * hy + e1[:, 2] * hz                 # det [T]
    ok = np.abs(a) > 1e-14
    inv = 1.0 / np.where(ok, a, 1.0)
    s = p[:, None, :] - v0[None, :, :]                # [P,T,3]
    u = (s[:, :, 1] * hy[None, :] + s[:, :, 2] * hz[None, :]) * inv[None, :]
    q = np.cross(s, e1[None, :, :])                   # [P,T,3]
    v = q[:, :, 0] * inv[None, :]                     # dir . q, dir=(1,0,0)
    t = (q * e2[None, :, :]).sum(axis=2) * inv[None, :]
    hit = (
        ok[None, :]
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > 0.0)
    )
    return hit.sum(axis=1)


def sdf_from_mesh(
    vertices,
    triangles,
    resolution: int = 32,
    padding: float | None = None,
    chunk: int = 256,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Bake a watertight triangle mesh into ``(grid, origin, spacing)``.

    ``grid`` is f64[gx, gy, gz] signed distance (negative inside) sampled
    at ``origin + spacing * (i, j, k)`` with cubic voxels; ``resolution``
    voxels span the mesh's largest extent; ``padding`` world units of
    positive-distance margin surround the mesh on every side (default one
    voxel) so trilinear samples near the surface never clamp at the grid
    border.  Feed the result to
    :func:`softbodyunity_tpu.core.topology.add_colliders` (``sdf_grids=``)
    and enable with ``CollisionParams(enable_sdf=True)``.
    """
    verts = np.asarray(vertices, np.float64).reshape(-1, 3)
    tris = np.asarray(triangles, np.int64).reshape(-1, 3)
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    spacing = float((hi - lo).max()) / max(resolution - 1, 1)
    if spacing <= 0.0:
        raise ValueError("degenerate mesh: zero extent")
    thin = float((hi - lo).min())
    if thin < 2.0 * spacing:
        # a feature thinner than ~2 voxels barely registers as "inside"
        # after trilinear sampling — cloth falls straight through the
        # collider with no error anywhere downstream
        warnings.warn(
            f"sdf_from_mesh: thinnest mesh extent {thin:.4g} is under 2 "
            f"voxels at spacing {spacing:.4g}; contacts may tunnel. Raise "
            f"resolution to >= {int(np.ceil(2 * (hi - lo).max() / max(thin, 1e-12))) + 1} "
            "or thicken the geometry.",
            stacklevel=2,
        )
    if padding is None:
        padding = spacing
    pad_cells = max(int(np.ceil(padding / spacing)), 1)
    origin = lo - pad_cells * spacing
    dims = np.ceil((hi - lo) / spacing).astype(int) + 1 + 2 * pad_cells
    gx, gy, gz = (int(d) for d in dims)
    ii, jj, kk = np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(gz), indexing="ij"
    )
    pts = origin[None, :] + spacing * np.stack(
        [ii.ravel(), jj.ravel(), kk.ravel()], axis=1
    ).astype(np.float64)
    # tiny irrational nudge so +x parity rays never graze an edge/vertex
    # exactly (watertight meshes make such hits measure-zero; this removes
    # the residual risk from grid/mesh alignment)
    pts_ray = pts + np.array([0.0, 1.3e-9, 2.7e-9])
    npts = pts.shape[0]
    d2 = np.full(npts, np.inf)
    crossings = np.zeros(npts, dtype=np.int64)
    # chunk BOTH axes: the [P_chunk, T_chunk, 3] temporaries stay ~25 MB
    # (an unchunked 34^3-point x 2k-triangle bake thrashes at 100x that)
    pchunk = 2048
    for p0 in range(0, npts, pchunk):
        psl = slice(p0, p0 + pchunk)
        for t0 in range(0, tris.shape[0], chunk):
            tt = tris[t0:t0 + chunk]
            v0, v1, v2 = verts[tt[:, 0]], verts[tt[:, 1]], verts[tt[:, 2]]
            d2[psl] = np.minimum(
                d2[psl],
                _point_triangle_dist2(pts[psl], v0, v1, v2).min(axis=1),
            )
            crossings[psl] += _ray_parity_x(pts_ray[psl], v0, v1, v2)
    sign = np.where(crossings % 2 == 1, -1.0, 1.0)
    grid = (sign * np.sqrt(d2)).reshape(gx, gy, gz)
    return grid, origin, spacing


def sdf_from_sphere(center, radius: float, resolution: int = 24,
                    padding: float | None = None
                    ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Analytic sphere SDF grid (exact, no mesh): handy for tests and for
    scenes that want sphere contact through the same SDF code path."""
    c = np.asarray(center, np.float64)
    spacing = 2.0 * radius / max(resolution - 1, 1)
    if padding is None:
        padding = spacing
    pad_cells = max(int(np.ceil(padding / spacing)), 1)
    origin = c - radius - pad_cells * spacing
    g = resolution + 2 * pad_cells
    idx = np.arange(g)
    ii, jj, kk = np.meshgrid(idx, idx, idx, indexing="ij")
    pts = origin[None, None, None, :] + spacing * np.stack(
        [ii, jj, kk], axis=-1
    ).astype(np.float64)
    grid = np.linalg.norm(pts - c, axis=-1) - radius
    return grid, origin, spacing
