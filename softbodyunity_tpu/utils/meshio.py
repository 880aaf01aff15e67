"""Render sync: get simulation state back to a renderer.

The reference hands state to Unity every frame via ``mesh.vertices =
positions; mesh.RecalculateNormals()`` ("C# per-vertex mesh mutation",
BASELINE.json:5).  The rebuild's equivalent is a single device->host
fetch per *rendered* frame (positions + normals computed on device), plus
exporters for offline viewing:

* :func:`frame` — one host-side (positions, normals) pair.
* :func:`write_obj` — Wavefront OBJ snapshot (any viewer opens it).
* :func:`record_rollout` — simulate n frames, return/save stacked
  positions+normals (the npz is a renderable animation).

Plus the *import* side of the asset pipeline (Unity scenes are built from
imported mesh assets; OBJ is the interchange format every DCC tool
exports):

* :func:`load_obj` — parse an OBJ into ``(vertices, triangles)``, ready
  for :func:`softbodyunity_tpu.core.topology.from_triangle_mesh` (soft
  body) or :func:`softbodyunity_tpu.core.sdf.sdf_from_mesh` (static
  collider bake).

All host-side, run once at scene build / frame export — never inside the
simulation loop (BASELINE.json:5 "no host round-trips").
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax

from .. import api
from ..core.config import SimConfig
from ..core.state import State
from ..core.topology import Topology
from ..solver.normals import vertex_normals


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file into ``(vertices f64[N,3], triangles i32[T,3])``.

    Supports the geometry subset that matters for simulation: ``v`` lines
    (extra components like vertex colors are ignored), ``f`` faces with any
    of the ``v``, ``v/vt``, ``v//vn``, ``v/vt/vn`` index forms, negative
    (relative) indices, and polygons with >3 vertices (triangulated as a
    fan around the first vertex, the standard convex-polygon split).
    Normals/texcoords/materials/objects/groups are skipped — topology
    construction recomputes what it needs.
    """
    verts = []
    faces = []
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                if len(parts) < 4:
                    raise ValueError(f"malformed vertex line: {line!r}")
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif tag == "f":
                if len(parts) < 4:
                    raise ValueError(f"malformed face line: {line!r}")
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    # OBJ is 1-based; negative counts back from the latest
                    # vertex (relative addressing, used by streaming
                    # exporters)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):   # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts:
        raise ValueError(f"no vertices in {path}")
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int32).reshape(-1, 3)
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError(
            f"face index out of range in {path}: "
            f"[{f.min()}, {f.max()}] vs {len(v)} vertices"
        )
    return v, f


def frame(top: Topology, state: State) -> Tuple[np.ndarray, np.ndarray]:
    """(positions f32[N,3], unit normals f32[N,3]) on host — the per-frame
    render handoff.  One fused device computation + one fetch."""
    n = jax.jit(vertex_normals)(top.triangles, state.x)
    return np.asarray(state.x), np.asarray(n)


def write_obj(path: str, top: Topology, state: State) -> None:
    """Wavefront OBJ snapshot with normals (1-indexed faces)."""
    v, n = frame(top, state)
    write_obj_raw(path, v, np.asarray(top.triangles), n)


def write_obj_raw(path: str, positions, triangles, normals=None) -> None:
    """OBJ from raw arrays — e.g. a skinned render mesh
    (:func:`softbodyunity_tpu.core.embed.skin`), which has its own
    vertices/faces distinct from the simulation Topology."""
    v = np.asarray(positions)
    tris = np.asarray(triangles)
    n = None if normals is None else np.asarray(normals)
    with open(path, "w") as f:
        f.write("# softbodyunity_tpu export\n")
        for p in v:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        if n is not None:
            for p in n:
                f.write(f"vn {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for t in tris:
            a, b, c = (int(i) + 1 for i in t)
            if n is not None:
                f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
            else:
                f.write(f"f {a} {b} {c}\n")


def record_rollout(
    top: Topology,
    cfg: SimConfig,
    state: State,
    n_frames: int,
    path: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray, State]:
    """Simulate ``n_frames`` frames, fetching (positions, normals) each
    frame — the animation record.  Saves to ``path`` (.npz) if given."""
    xs, ns = [], []
    for _ in range(n_frames):
        state = api.step(top, cfg, state)
        x, n = frame(top, state)
        xs.append(x)
        ns.append(n)
    xs = np.stack(xs)
    ns = np.stack(ns)
    if path:
        np.savez_compressed(
            path, positions=xs, normals=ns,
            triangles=np.asarray(top.triangles),
        )
    return xs, ns, state
