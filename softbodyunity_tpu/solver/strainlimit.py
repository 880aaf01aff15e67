"""Strain limiting — device twin of the oracle's binding semantics
(``oracle/reference.py::strain_limit_dx``; Provot 1995 hard bound on
edge elongation, ``StrainLimitParams``).

Two formulations, equal in real arithmetic:

* **banded** (``_strain_limit_dx_banded``): when the topology's offset
  groups cover EVERY edge (grids, lattices, BFS-relabelled meshes), each
  Jacobi sweep is one roll-pair + dense masked FMAs per delta group on
  ``[3, N]`` planes — zero gathers.  Same transformation as
  ``banded.xpbd_iteration_banded``.
* **gather** fallback: any edge list; also taken when tearing or
  plasticity is active (per-edge alive/rest-scale state has no plane
  representation on this path yet).

The sweep loop is static and small, so it unrolls under jit.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.topology import Topology


def strain_limit_dx(top: Topology, cfg: SimConfig, x, alive=None,
                    rest_scale=None):
    """Total strain-limiting position correction (oracle
    ``strain_limit_dx`` twin): ``iterations`` Jacobi sweeps projecting
    every edge outside the ``[rest*(1-max_compress),
    rest*(1+max_stretch)]`` band back to the nearest bound, endpoint
    shares weighted by inverse mass, vertex updates averaged over the
    alive incident edges.  ``rest`` honours plasticity's scale; torn
    edges are inert; pinned vertices never move."""
    sl = cfg.strain_limit
    groups = top.offset_groups
    if (alive is None and rest_scale is None and groups is not None
            and len(groups.deltas) > 0 and groups.n_residual == 0):
        return _strain_limit_dx_banded(groups, cfg, x.T,
                                       top.inv_mass).T
    w = top.inv_mass
    a_idx = top.edges[:, 0]
    b_idx = top.edges[:, 1]
    rest = (top.rest_length if rest_scale is None
            else top.rest_length * rest_scale)
    hi = rest * (1.0 + sl.max_stretch)
    lo = (rest * (1.0 - sl.max_compress) if sl.max_compress >= 0.0
          else jnp.zeros_like(rest))
    wa, wb = w[a_idx], w[b_idx]
    denom = jnp.maximum(wa + wb, 1e-12)
    # Jacobi mean over the ALIVE incident edges (the xpbd_iteration
    # convention; continuous in x — see the oracle comment)
    e_cnt = (jnp.ones(a_idx.shape[0], x.dtype) if alive is None else alive)
    cnt = jnp.zeros(x.shape[0], x.dtype)
    cnt = cnt.at[a_idx].add(e_cnt)
    cnt = cnt.at[b_idx].add(e_cnt)
    inv_cnt = 1.0 / jnp.maximum(cnt, 1.0)
    x0 = x
    for _ in range(sl.iterations):
        d = x[b_idx] - x[a_idx]
        length = jnp.linalg.norm(d, axis=1)
        n = d / jnp.maximum(length, 1e-12)[:, None]
        c_val = length - jnp.clip(length, lo, hi)
        if alive is not None:
            c_val = c_val * alive
        corr = c_val / denom
        dx = jnp.zeros_like(x)
        dx = dx.at[a_idx].add((wa * corr)[:, None] * n)
        dx = dx.at[b_idx].add(-(wb * corr)[:, None] * n)
        x = x + dx * inv_cnt[:, None]
    return x - x0


def _strain_limit_dx_banded(groups, cfg: SimConfig, xT, wN):
    """Banded twin of the gather sweep: per delta group, the owner vertex
    i holds the edge (i, i+delta); corrections land at the owner
    directly and at the neighbour via one reverse roll (wrapped lanes
    annihilate on the mask-zeroed positions, the standard banded
    argument).  Count-normalization uses the static per-vertex edge
    count, exactly the oracle's alive count with no tearing."""
    from .banded import _roll_planes

    sl = cfg.strain_limit
    n = xT.shape[-1]
    cnt = jnp.zeros((n,), xT.dtype)
    for gi, delta in enumerate(groups.deltas):
        m = groups.mask[gi]
        cnt = cnt + m + _roll_planes(m, delta)
    inv_cnt = 1.0 / jnp.maximum(cnt, 1.0)
    x0T = xT
    for _ in range(sl.iterations):
        dxT = jnp.zeros_like(xT)
        for gi, delta in enumerate(groups.deltas):
            m = groups.mask[gi]
            rest = groups.rest[gi]
            hi = rest * (1.0 + sl.max_stretch)
            lo = (rest * (1.0 - sl.max_compress)
                  if sl.max_compress >= 0.0 else jnp.zeros_like(rest))
            xb = _roll_planes(xT, -delta)
            d = xb - xT
            length = jnp.sqrt(jnp.sum(d * d, axis=0))
            nrm = d / jnp.maximum(length, 1e-12)
            c_val = (length - jnp.clip(length, lo, hi)) * m
            wb = _roll_planes(wN, -delta)
            corr = c_val / jnp.maximum(wN + wb, 1e-12)
            dxT = dxT + (wN * corr) * nrm \
                - _roll_planes((wb * corr) * nrm, delta)
        xT = xT + dxT * inv_cnt
    return xT - x0T
