"""Multi-device scaling: shard the scene batch across a device mesh
(SURVEY.md C15).

The reference is single-threaded C# — its only "scaling" is whatever one
Unity frame can do.  The rebuild's scaling axes (SURVEY.md §2 parallelism
checklist):

* **data parallel** (this module): the 1024-scene batch axis
  (BASELINE.json:11) is sharded over a 1-D ``jax.sharding.Mesh``; every
  collective-free substep runs embarrassingly parallel, so the inner loop
  moves **no data between devices** — XLA compiles one SPMD program per
  device.
* **spatial decomposition** (:mod:`softbodyunity_tpu.parallel.halo`): the
  SP/CP analogue — one huge cloth split by grid rows over devices with
  ``shard_map`` + ``ppermute`` halo exchange each substep.

TP/PP/EP have no analogue in a particle sim (no weight matrices, no layer
pipeline, no experts) and are deliberately absent — see SURVEY.md §2.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import SimConfig
from ..core.state import State
from ..core.topology import Topology
from ..solver import step as _step_mod

BATCH_AXIS = "batch"


def make_mesh(devices=None, axis_name: str = BATCH_AXIS) -> Mesh:
    """1-D device mesh over all (or the given) devices."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def shard_batched_state(states: State, mesh: Mesh) -> State:
    """Place a ``State[B, N, 3]`` with the batch axis sharded over the mesh;
    B must divide evenly by the mesh size."""
    sharding = NamedSharding(mesh, P(BATCH_AXIS))
    return jax.tree.map(lambda a: jax.device_put(a, sharding), states)


def replicate_topology(top: Topology, mesh: Mesh) -> Topology:
    """Topology is identical for every scene: replicate it on all chips."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sharding), top)


@functools.lru_cache(maxsize=16)
def _compiled_sharded_step(cfg: SimConfig, dt: float, n_substeps: int,
                           mesh: Mesh, has_alive: bool, has_scale: bool):
    """SPMD batched step: with batch-sharded inputs XLA partitions the vmap
    over chips automatically; out_shardings pin the result layout so no
    resharding collective ever appears.  Per-edge feature planes
    (tearing liveness / plastic rest scales) shard on the batch axis
    like the vertex arrays."""
    state_sharding = NamedSharding(mesh, P(BATCH_AXIS))

    @functools.partial(
        jax.jit,
        out_shardings=State(
            x=state_sharding, v=state_sharding, x_prev=state_sharding,
            edge_alive=state_sharding if has_alive else None,
            rest_scale=state_sharding if has_scale else None,
        ),
    )
    def impl(top: Topology, states: State) -> State:
        fn = lambda s: _step_mod.step_scan(top, cfg, s, dt, n_substeps)
        return jax.vmap(fn)(states)

    return impl


def step_sharded(
    top: Topology,
    cfg: SimConfig,
    states: State,
    mesh: Mesh,
    dt: Optional[float] = None,
    n_substeps: Optional[int] = None,
) -> State:
    """Advance a batch-sharded ``State[B, N, 3]`` one frame on every chip."""
    from .batch import _ensure_tear_batched

    dt = cfg.dt if dt is None else float(dt)
    n = cfg.n_substeps if n_substeps is None else int(n_substeps)
    before = (states.edge_alive is not None, states.rest_scale is not None)
    states = _ensure_tear_batched(top, cfg, states)
    if (states.edge_alive is not None,
            states.rest_scale is not None) != before:
        # lazily-created feature planes: place them like the rest
        states = shard_batched_state(states, mesh)
    return _compiled_sharded_step(
        cfg, dt, n, mesh,
        states.edge_alive is not None, states.rest_scale is not None,
    )(top, states)


@functools.lru_cache(maxsize=16)
def _compiled_coupled_sharded(cfg: SimConfig, dt: float, n_substeps: int,
                              mesh: Mesh):
    """SPMD coupled step: cloth State AND RigidState batch-shard together
    (rigid props are per-scene), zero inner-loop collectives.  The output
    shardings are pinned leaf-by-leaf with ``with_sharding_constraint``
    (not a fixed out_shardings pytree) so optional leaves — tear liveness
    / plastic rest-scale planes, ball quaternions, promoted boxes —
    shard on the batch axis whenever present."""
    from ..solver.rigid import step_coupled_scan

    sh = NamedSharding(mesh, P(BATCH_AXIS))

    @jax.jit
    def impl(top: Topology, states: State, rigids):
        fn = lambda s, r: step_coupled_scan(top, cfg, s, r, dt, n_substeps)
        out_s, out_r = jax.vmap(fn)(states, rigids)
        pin = lambda t: jax.tree.map(
            lambda a: jax.lax.with_sharding_constraint(a, sh), t)
        return pin(out_s), pin(out_r)

    return impl


def step_coupled_sharded(
    top: Topology,
    cfg: SimConfig,
    states: State,
    rigids,
    mesh: Mesh,
    dt: Optional[float] = None,
    n_substeps: Optional[int] = None,
):
    """Advance batch-sharded coupled scenes (cloth + per-scene dynamic
    rigid spheres/boxes) one frame on every chip; returns
    ``(states, rigids)``.  Tearing/plasticity feature planes shard on the
    batch axis like the vertex arrays (Euler solver — the coupled
    Verlet/XPBD substeps reject them upstream in step_coupled_scan,
    matching the single-device contract)."""
    from .batch import _ensure_tear_batched

    dt = cfg.dt if dt is None else float(dt)
    n = cfg.n_substeps if n_substeps is None else int(n_substeps)
    before = (states.edge_alive is not None, states.rest_scale is not None)
    states = _ensure_tear_batched(top, cfg, states)
    if (states.edge_alive is not None,
            states.rest_scale is not None) != before:
        # lazily-created feature planes: place them like the rest
        states = shard_batched_state(states, mesh)
    return _compiled_coupled_sharded(cfg, dt, n, mesh)(top, states, rigids)
