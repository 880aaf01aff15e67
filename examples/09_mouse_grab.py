"""Mouse-grab interaction: raycast into the cloth, pick the nearest
vertex, and drag it along a path with kinematic pin updates — the Unity
editor "grab the cloth with the mouse" loop, headless.

``api.raycast`` is branchless Moller-Trumbore over the deformed triangles
(one gather per query, elementwise math, one argmin — oracle-twin tested);
``api.pick_vertex`` turns the hit into a vertex id for ``api.move_pins``.
Run: python examples/09_mouse_grab.py
"""

import numpy as np

import softbodyunity_tpu as sb
from softbodyunity_tpu import SimConfig, SpringParams


def main(n_frames: int = 60, nx: int = 16, ny: int = 16):
    cfg = SimConfig(springs=SpringParams(k_structural=400.0, k_shear=200.0,
                                         k_bend=80.0, damping=0.5),
                    global_damping=0.5)
    host = sb.cloth_grid(
        nx, ny, spacing=0.05, shear=True, bend=True, pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd, orientation="xy",
    )
    top, state = sb.init(host)

    # "click": a ray from the camera toward the cloth centre
    centre = np.asarray(state.x).mean(axis=0)
    origin = centre + np.array([0.0, 0.0, 1.0])
    hit = sb.raycast(top, state, origin, [0.0, 0.0, -1.0])
    vid = int(sb.pick_vertex(top, state, origin, [0.0, 0.0, -1.0]))
    print(f"ray hit triangle {int(hit.tri)} at t={float(hit.t):.3f}; "
          f"grabbed vertex {vid}")
    assert vid >= 0

    # "drag": move the grabbed vertex along an arc while the sim runs
    grab0 = np.asarray(state.x)[vid].copy()
    for frame in range(n_frames):
        s = (frame + 1) / n_frames
        target = grab0 + np.array([0.0, 0.1 * np.sin(np.pi * s), 0.3 * s])
        state = sb.move_pins(top, state, target[None, :], np.array([vid]))
        state = sb.step(top, cfg, state)

    x = np.asarray(state.x)
    assert np.isfinite(x).all()
    pulled = float(np.abs(x[:, 2]).max())
    print(f"after the drag: max |z| displacement {pulled:.3f} "
          f"(cloth followed the grab)")
    assert pulled > 0.2


if __name__ == "__main__":
    main()
