"""Render-mesh embedding (skinning): a detailed visual mesh driven by a
coarse simulation mesh.

Unity soft-body assets decouple the simulated proxy from the rendered
surface: a low-resolution lattice (or cage) is simulated and a
high-resolution ``Mesh`` is deformed to follow it each frame — the
"per-vertex mesh mutation" render-sync layer of the reference
(BASELINE.json:5; SURVEY.md §1a render-sync row).  The rebuild makes
that binding explicit and device-resident:

* **build time (host, float64)** — :func:`embed_mesh` locates each render
  vertex in the rest-pose simulation mesh: inside its containing
  tetrahedron (volumetric bodies — barycentric coordinates) or against its
  closest surface triangle (cloth — triangle barycentric + a signed offset
  along the face normal).  Both searches are uniform-grid accelerated so a
  one-time bind of a 100k-vertex render mesh to a 300k-tet lattice stays
  seconds, not minutes.
* **run time (device, f32)** — :func:`skin` is a tiny gather + weighted
  sum per render vertex, jit-compiled and vmappable.  Like
  :func:`softbodyunity_tpu.solver.normals.vertex_normals` it is an
  *observable-tier* op: it runs once per rendered frame outside the
  substep scan, so the gather is off the hot path by design.

The anchor layout is uniform across both modes — ``anchors i32[M,4]`` +
``weights f32[M,4]`` + ``offsets f32[M]`` — with the offset direction
defined by the normal of the triangle spanned by the first three anchors.
Tet embeddings carry ``offsets == 0`` (the barycentric sum is exact);
surface embeddings duplicate anchor 0 into lane 3 with weight 0.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .topology import HostTopology


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MeshEmbedding:
    """Static binding of ``M`` render vertices to the simulation mesh.

    A pytree of device arrays (like Topology): pass it through jit
    boundaries as an argument, never a closure constant.
    """

    anchors: jax.Array    # i32[M, 4] simulation-vertex ids
    weights: jax.Array    # f32[M, 4] convex weights (sum to 1)
    offsets: jax.Array    # f32[M]    signed offset along the face normal
    triangles: jax.Array  # i32[F, 3] render-mesh faces (for normals/render)

    @property
    def n_vertices(self) -> int:
        return self.anchors.shape[0]


# ---------------------------------------------------------------------------
# host-side build (float64 NumPy, one-time)
# ---------------------------------------------------------------------------


def _grid_buckets(lo: np.ndarray, hi: np.ndarray, cell: float):
    """Bucket items by every grid cell their [lo, hi] AABB overlaps.

    Returns ``{(i,j,k): [item ids]}``.  ``cell`` must be >= the largest
    AABB extent so each item overlaps at most 2 cells per axis.
    """
    ci = np.floor(lo / cell).astype(np.int64)
    cj = np.floor(hi / cell).astype(np.int64)
    buckets: dict = {}
    for t in range(lo.shape[0]):
        for ix in range(ci[t, 0], cj[t, 0] + 1):
            for iy in range(ci[t, 1], cj[t, 1] + 1):
                for iz in range(ci[t, 2], cj[t, 2] + 1):
                    buckets.setdefault((ix, iy, iz), []).append(t)
    return buckets


def _point_cells(pts: np.ndarray, cell: float) -> np.ndarray:
    return np.floor(pts / cell).astype(np.int64)


def _tet_barycentric(p: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """Barycentric coordinates of points ``p [K,3]`` in tets
    ``corners [K,4,3]`` (paired rows).  Returns ``[K,4]``; degenerate tets
    get ``-inf`` rows so the min-bary selection below never picks them."""
    a = corners[:, 0]
    m = np.stack([corners[:, 1] - a, corners[:, 2] - a, corners[:, 3] - a],
                 axis=2)                                   # [K,3,3] columns
    det = np.linalg.det(m)
    bad = np.abs(det) < 1e-30
    if bad.any():
        m = m + bad[:, None, None] * np.eye(3)
    b123 = np.linalg.solve(m, (p - a)[:, :, None])[:, :, 0]   # [K,3]
    b0 = 1.0 - b123.sum(axis=1)
    bary = np.concatenate([b0[:, None], b123], axis=1)
    bary[bad] = -np.inf
    return bary


def _embed_tets(pos: np.ndarray, tets: np.ndarray, pts: np.ndarray):
    """Containing-tet barycentric bind.  Points OUTSIDE every tet (a render
    surface always protrudes past a center-sampled voxel lattice) keep the
    UNCLAMPED barycentric coordinates of the least-extrapolating tet:
    barycentric coords are affine, so the rest pose is reproduced exactly
    everywhere and exterior points deform affinely with their nearest
    tet instead of being flattened onto it."""
    corners = pos[tets]                                    # [T,4,3]
    lo = corners.min(axis=1)
    hi = corners.max(axis=1)
    cell = max(float((hi - lo).max()), 1e-9)
    buckets = _grid_buckets(lo, hi, cell)
    pcells = _point_cells(pts, cell)

    m = pts.shape[0]
    anchors = np.zeros((m, 4), np.int64)
    weights = np.zeros((m, 4), np.float64)
    centroids = corners.mean(axis=1)
    for i in range(m):
        cand = buckets.get(tuple(pcells[i]), None)
        if not cand:
            # outside every tet AABB: search the 27-neighborhood, then
            # fall back to the globally nearest tet centroid
            cand = []
            cx, cy, cz = pcells[i]
            for ix in (cx - 1, cx, cx + 1):
                for iy in (cy - 1, cy, cy + 1):
                    for iz in (cz - 1, cz, cz + 1):
                        cand.extend(buckets.get((ix, iy, iz), ()))
            if not cand:
                cand = [int(np.argmin(
                    ((centroids - pts[i]) ** 2).sum(axis=1)))]
        cand = np.asarray(cand, np.int64)
        bary = _tet_barycentric(
            np.broadcast_to(pts[i], (cand.shape[0], 3)), corners[cand]
        )
        best = int(np.argmax(bary.min(axis=1)))
        t = cand[best]
        w = bary[best]
        if not np.isfinite(w).all():         # all-degenerate candidates
            w = np.full(4, 0.25)
        elif w.min() > -1e-9:
            # interior: clamp f64 rounding dust and renormalize
            w = np.clip(w, 0.0, None)
            w = w / w.sum()
        anchors[i] = tets[t]
        weights[i] = w
    return anchors, weights, np.zeros(m, np.float64)


def _closest_on_triangles(p: np.ndarray, tri_pts: np.ndarray):
    """Closest point on each of K triangles to one query point.

    ``tri_pts [K,3,3]`` -> (closest [K,3], barycentric [K,3]).  Vectorized
    version of the standard Ericson clamp-to-region algorithm, expressed as
    an interior solve + edge/vertex clamping via candidate enumeration.
    """
    a, b, c = tri_pts[:, 0], tri_pts[:, 1], tri_pts[:, 2]
    ab, ac = b - a, c - a
    d00 = (ab * ab).sum(1)
    d01 = (ab * ac).sum(1)
    d11 = (ac * ac).sum(1)
    ap = p[None, :] - a
    d20 = (ap * ab).sum(1)
    d21 = (ap * ac).sum(1)
    denom = np.maximum(d00 * d11 - d01 * d01, 1e-300)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    # clamp each edge parameter independently, then evaluate all three edge
    # projections plus the (clamped) interior point and keep the nearest
    def seg(q0, q1):
        d = q1 - q0
        t = ((p[None, :] - q0) * d).sum(1) / np.maximum((d * d).sum(1), 1e-300)
        t = np.clip(t, 0.0, 1.0)
        return q0 + t[:, None] * d

    v_i = np.clip(v, 0.0, 1.0)
    w_i = np.clip(w, 0.0, 1.0 - v_i)
    cands = np.stack(
        [a + v_i[:, None] * ab + w_i[:, None] * ac,
         seg(a, b), seg(b, c), seg(c, a)], axis=1)          # [K,4,3]
    d2 = ((cands - p[None, None, :]) ** 2).sum(2)
    pick = np.argmin(d2, axis=1)
    closest = cands[np.arange(len(a)), pick]
    # recover barycentric of the chosen point (project once more)
    cp = closest - a
    e20 = (cp * ab).sum(1)
    e21 = (cp * ac).sum(1)
    vb = (d11 * e20 - d01 * e21) / denom
    wb = (d00 * e21 - d01 * e20) / denom
    bary = np.stack([1.0 - vb - wb, vb, wb], axis=1)
    return closest, np.clip(bary, 0.0, 1.0)


def _embed_surface(pos: np.ndarray, tris: np.ndarray, pts: np.ndarray):
    """Closest-triangle bind with signed normal offset (cloth shells)."""
    tri_pts = pos[tris]                                    # [F,3,3]
    lo = tri_pts.min(axis=1)
    hi = tri_pts.max(axis=1)
    cell = max(float((hi - lo).max()), 1e-9)
    buckets = _grid_buckets(lo, hi, cell)
    pcells = _point_cells(pts, cell)
    centroids = tri_pts.mean(axis=1)

    m = pts.shape[0]
    anchors = np.zeros((m, 4), np.int64)
    weights = np.zeros((m, 4), np.float64)
    offsets = np.zeros(m, np.float64)
    for i in range(m):
        cand: list = []
        cx, cy, cz = pcells[i]
        r = 1
        # expand the neighborhood ring until it holds a candidate (render
        # vertices can sit several cells off the proxy surface)
        while not cand and r < 64:
            for ix in range(cx - r, cx + r + 1):
                for iy in range(cy - r, cy + r + 1):
                    for iz in range(cz - r, cz + r + 1):
                        cand.extend(buckets.get((ix, iy, iz), ()))
            r += 1
        if not cand:
            cand = [int(np.argmin(((centroids - pts[i]) ** 2).sum(axis=1)))]
        cand = np.unique(np.asarray(cand, np.int64))
        closest, bary = _closest_on_triangles(pts[i], tri_pts[cand])
        d2 = ((closest - pts[i]) ** 2).sum(1)
        best = int(np.argmin(d2))
        f = cand[best]
        a, b, c = tri_pts[f]
        n = np.cross(b - a, c - a)
        n_len = np.linalg.norm(n)
        n = n / n_len if n_len > 0 else np.array([0.0, 1.0, 0.0])
        anchors[i, :3] = tris[f]
        anchors[i, 3] = tris[f][0]
        w3 = bary[best]
        s = w3.sum()
        weights[i, :3] = w3 / s if s > 0 else np.full(3, 1.0 / 3.0)
        weights[i, 3] = 0.0
        offsets[i] = float(np.dot(pts[i] - closest[best], n))
    return anchors, weights, offsets


def embed_mesh(
    host: HostTopology,
    render_positions: np.ndarray,
    render_triangles: np.ndarray,
) -> MeshEmbedding:
    """Bind a render mesh to a built (rest-pose) simulation topology.

    Volumetric hosts (``host.tets`` nonempty) use containing-tet
    barycentric embedding — exact for any point inside the lattice, and
    exactly rigid for points coinciding with simulation vertices.  Surface
    hosts (cloth) use closest-triangle barycentric plus a signed offset
    along the rest-pose face normal, so a shell hovering off the proxy
    keeps its thickness as the proxy bends.

    Run once on the host at build time; drive frames with :func:`skin`.
    """
    pts = np.asarray(render_positions, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"render_positions must be [M,3], got {pts.shape}")
    tris = np.asarray(render_triangles, np.int64)
    if tris.ndim != 2 or tris.shape[1] != 3:
        raise ValueError(f"render_triangles must be [F,3], got {tris.shape}")
    if tris.size and (tris.min() < 0 or tris.max() >= pts.shape[0]):
        raise ValueError("render_triangles index outside render_positions")
    if host.tets.shape[0] > 0:
        anchors, weights, offsets = _embed_tets(
            host.positions0, np.asarray(host.tets, np.int64), pts)
    elif host.triangles.shape[0] > 0:
        anchors, weights, offsets = _embed_surface(
            host.positions0, np.asarray(host.triangles, np.int64), pts)
    else:
        raise ValueError("host topology has no tets and no triangles to "
                         "embed against")
    return MeshEmbedding(
        anchors=jnp.asarray(anchors, jnp.int32),
        weights=jnp.asarray(weights, jnp.float32),
        offsets=jnp.asarray(offsets, jnp.float32),
        triangles=jnp.asarray(tris, jnp.int32),
    )


# ---------------------------------------------------------------------------
# device-side runtime (per rendered frame)
# ---------------------------------------------------------------------------


@jax.jit
def skin(emb: MeshEmbedding, x: jax.Array) -> jax.Array:
    """Deform the embedded render mesh: f32[M,3] render positions from
    simulation positions ``x`` (f32[N,3]).

    Gather + weighted sum + normal offset; jit/vmap-friendly.  Runs per
    rendered frame (observable tier), never inside the substep scan.
    """
    g = x[emb.anchors]                                      # [M,4,3]
    p = jnp.einsum("mk,mkc->mc", emb.weights, g)
    a, b, c = g[:, 0], g[:, 1], g[:, 2]
    n = jnp.cross(b - a, c - a)
    n = n / jnp.maximum(
        jnp.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    return p + emb.offsets[:, None] * n


def skin_normals(emb: MeshEmbedding, x: jax.Array) -> jax.Array:
    """Unit vertex normals of the skinned render mesh (f32[M,3])."""
    from ..solver.normals import vertex_normals

    return vertex_normals(emb.triangles, skin(emb, x))
