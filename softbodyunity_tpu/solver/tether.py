"""Per-vertex motion constraints — device twin of the oracle's binding
semantics (``oracle/reference.py::tether_dx``; the Unity Cloth
``maxDistance`` coefficient, set by ``core.topology.set_motion_constraints``
and animated with ``api.move_tethers``).

Pure per-vertex elementwise work (one norm + clamp per vertex): no
gathers, no matmuls, batched/sharded for free.  The stencil path gates
off when motion constraints are enabled (``kernels/dispatch.py``) — the
general jnp path is the implementation.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.topology import Topology


def motion_enabled(top: Topology, cfg: SimConfig) -> bool:
    """Static gate (oracle ``_motion_enabled`` twin): the config enables
    the feature AND the topology carries tether arrays."""
    return cfg.motion.enabled and top.tether_anchor is not None


def tether_dx(top: Topology, cfg: SimConfig, x):
    """Motion-constraint position correction (oracle ``tether_dx`` twin):
    clamp every movable vertex inside the sphere of radius
    ``tether_radius * scale`` around ``tether_anchor`` (``inf`` = free).
    Runs after integration / shape matching / strain limiting, before
    contact — contact always wins."""
    d = x - top.tether_anchor
    dist = jnp.linalg.norm(d, axis=1)
    r = top.tether_radius * cfg.motion.scale
    excess = jnp.maximum(dist - r, 0.0)
    n = d / jnp.maximum(dist, 1e-12)[:, None]
    dx = -excess[:, None] * n
    return jnp.where((top.inv_mass > 0.0)[:, None], dx, 0.0)
