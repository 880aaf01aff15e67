"""Backend dispatch: route structured grid scenes to the stencil path.

:func:`maybe_fast_step` returns the stencil step (kernels/stencil.py)
when the scene qualifies, else None, and the caller runs the general
jnp path (solver/step.py, banded where the topology allows).
"""

from __future__ import annotations


def stencil_applicable(top, cfg) -> bool:
    """Whether the stencil path implements every feature of this scene.

    Off the stencil path: motion constraints (per-vertex tethers),
    shape-matching clusters, strain limiting and pressure bodies (the
    general path implements them), tet meshes, self-collision, and
    meshes that are not a uniform grid."""
    if cfg.motion.enabled and top.tether_anchor is not None:
        return False
    if cfg.shape_match.enabled and top.n_clusters > 0:
        return False
    if cfg.strain_limit.enabled:
        return False
    if cfg.pressure.enabled and top.n_pressure_bodies > 0:
        return False
    if top.n_tets > 0 or cfg.self_collision.enabled:
        return False
    return top.grid_shape is not None and top.grid_spacing is not None


def maybe_fast_step(top, cfg):
    """``fn(state, dt, n_substeps) -> state`` for the stencil path, or
    None when the scene does not qualify."""
    if not stencil_applicable(top, cfg):
        return None
    from .stencil import make_stencil_step

    return make_stencil_step(top, cfg)
