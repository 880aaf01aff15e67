"""Any mesh becomes a soft body: voxelize a surface mesh into a banded
tet lattice (the banded lattice path), simulate, and skin the original
mesh back on — the complete Unity proxy-lattice workflow.

    python examples/20_voxel_softbody.py [out_dir] [path/to/mesh.obj]

Without an OBJ argument a torus-ish icosphere is used.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import softbodyunity_tpu as sb
from softbodyunity_tpu.utils import meshio


def main(out_dir="/tmp/voxel_demo", obj_path=None, n_frames=120,
         resolution=10):
    os.makedirs(out_dir, exist_ok=True)
    if obj_path:
        verts, tris = meshio.load_obj(obj_path)
    else:
        verts, tris = sb.icosphere_mesh(radius=0.3, center=(0.0, 0.0, 0.0),
                                        subdivisions=3)
    # normalize placement: drop from just above the ground plane
    verts = verts - verts.min(axis=0, keepdims=True)
    verts[:, 1] += 0.25

    cfg = sb.SimConfig(
        springs=sb.SpringParams(k_structural=400.0, damping=0.4),
        collision=sb.CollisionParams(enable_plane=True, friction=0.3),
        volume_stiffness=0.5,
        global_damping=0.5,
    )
    host = sb.lattice_from_mesh(
        verts, tris, resolution=resolution, mass=0.02,
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=0.0,
    )
    emb = sb.embed_mesh(host, verts, tris)
    print(f"render mesh {verts.shape[0]} verts -> lattice "
          f"{int((host.inv_mass > 0).sum())} live verts, "
          f"{host.tets.shape[0]} tets")

    top, state = sb.init(host)
    for f in range(n_frames):
        state = sb.step(top, cfg, state)
        if f % 15 == 0:
            p = sb.skin(emb, state.x)
            n = sb.skin_normals(emb, state.x)
            meshio.write_obj_raw(f"{out_dir}/skin_{f:03d}.obj", p, tris, n)
    p = np.asarray(sb.skin(emb, state.x))
    assert np.isfinite(p).all()
    print(f"wrote {out_dir}/skin_*.obj; final y-range "
          f"[{p[:, 1].min():.3f}, {p[:, 1].max():.3f}]")


if __name__ == "__main__":
    main(*sys.argv[1:])
