"""Batched RL-rollout surface (BASELINE.json:11 "1024-scene vmapped cloth
batch ... for RL rollouts").

A thin, fully-jitted env wrapper over the batched stepping path:

* ``reset(key)`` — B jittered copies of the scene (decorrelated rollouts),
* ``step(state, actions)`` — actions are velocity impulses on a static set
  of *handle* vertices (grab points), applied before the frame's substeps;
  observations are positions+velocities of a static *observation* subset.

Everything is static-shaped and vmapped; shard the batch axis with
:mod:`softbodyunity_tpu.parallel.sharding` for multi-chip rollouts.  Reward
shaping is task-specific and left to the caller (obs carry what's needed).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.state import State
from ..core.topology import Topology
from ..solver import step as _step_mod
from . import batch as _batch


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    handle_ids: Tuple[int, ...]   # vertices that receive action impulses
    obs_ids: Tuple[int, ...]      # vertices whose x/v form the observation
    batch: int = 1024
    jitter_scale: float = 0.01    # initial per-scene position jitter
    # promote the scene's spheres to per-scene DYNAMIC rigid bodies
    # (solver/rigid.py): the env state becomes (State, RigidState), steps
    # run the coupled substeps, and the observation gains one [center,
    # velocity] row per sphere — juggle/keepy-uppy style tasks
    rigid_masses: Optional[Tuple[float, ...]] = None


class BatchedClothEnv:
    """vmapped multi-scene soft-body environment (one shared Topology).

    With ``EnvSpec.rigid_masses`` set, the env state handed through
    ``reset``/``step``/``rollout`` is a ``(State, RigidState)`` pair and
    observations append the rigid spheres' centers+velocities."""

    def __init__(self, top: Topology, cfg: SimConfig, rest: State, spec: EnvSpec):
        from ..solver.rigid import make_rigid_state, step_coupled_scan

        self.top = top
        self.cfg = cfg
        self.rest = rest
        self.spec = spec
        handle = jnp.asarray(spec.handle_ids, jnp.int32)
        obs = jnp.asarray(spec.obs_ids, jnp.int32)
        b = spec.batch
        coupled = spec.rigid_masses is not None
        self.coupled = coupled
        # keep the rest rigid state as HOST numpy: device arrays captured
        # as jit closure constants fetch at lowering time (CLAUDE.md trap)
        rigid0 = (jax.tree.map(np.asarray,
                               make_rigid_state(top, spec.rigid_masses))
                  if coupled else None)

        def _split(env_state):
            return env_state if coupled else (env_state, None)

        def _join(states, rigids):
            return (states, rigids) if coupled else states

        def _obs(states: State, rigids=None):
            o = jnp.concatenate(
                [states.x[:, obs, :], states.v[:, obs, :]], axis=-1
            )  # [B, O, 6]
            if coupled:
                ball = jnp.concatenate(
                    [rigids.centers, rigids.velocities], axis=-1
                )  # [B, S, 6]
                o = jnp.concatenate([o, ball], axis=1)
            return o

        @jax.jit
        def _reset(key):
            jitter = spec.jitter_scale * jax.random.normal(key, (b, 3))
            states = _batch.batch_state(rest, b, jitter=jitter)
            rigids = (jax.tree.map(
                lambda a: jnp.broadcast_to(a[None], (b,) + a.shape), rigid0)
                if coupled else None)
            return _join(states, rigids), _obs(states, rigids)

        @jax.jit
        def _step(top, env_state, actions):
            # actions f32[B, H, 3]: velocity impulses (delta-v) applied
            # directly to the handle vertices before the frame's substeps
            states, rigids = _split(env_state)
            dv = jnp.zeros_like(states.v)
            dv = dv.at[:, handle, :].set(actions)
            movable = (top.inv_mass > 0.0)[None, :, None]
            states = states.replace(v=jnp.where(movable, states.v + dv, 0.0))
            if coupled:
                fn = lambda s, r: step_coupled_scan(
                    top, cfg, s, r, cfg.dt, cfg.n_substeps)
                states, rigids = jax.vmap(fn)(states, rigids)
            else:
                fn = lambda s: _step_mod.step_scan(
                    top, cfg, s, cfg.dt, cfg.n_substeps)
                states = jax.vmap(fn)(states)
            return _join(states, rigids), _obs(states, rigids)

        self._reset = _reset
        self._step = _step
        self._rollouts = {}  # (policy_fn, n_frames) -> compiled executable

    @property
    def action_shape(self):
        return (self.spec.batch, len(self.spec.handle_ids), 3)

    @property
    def obs_shape(self):
        rows = len(self.spec.obs_ids) + (
            len(self.spec.rigid_masses) if self.coupled else 0)
        return (self.spec.batch, rows, 6)

    def reset(self, key):
        """-> (env_state, obs); env_state is State, or (State, RigidState)
        when the spec couples rigid bodies."""
        return self._reset(key)

    def step(self, env_state, actions):
        return self._step(self.top, env_state, actions)

    def rollout(self, key, policy_fn, n_frames: int) -> Tuple[State, jax.Array]:
        """On-device rollout: ``policy_fn(obs) -> actions`` traced into one
        jitted scan (zero host round-trips inside the rollout,
        BASELINE.json:5).  Compiled once per (policy_fn, n_frames) and
        reused across calls — pass a STABLE function object (a module-level
        fn or a held reference, with params flowing through ``obs`` or
        closure); a fresh lambda per call defeats the cache and re-compiles
        the full scan every rollout."""
        run = self._rollouts.get((policy_fn, n_frames))
        if run is None:
            if len(self._rollouts) >= 16:
                # bounded: evict the oldest executable rather than leak one
                # compiled scan per novel (policy, length) pair
                self._rollouts.pop(next(iter(self._rollouts)))

            @jax.jit
            def run(top, states, obs0):
                def body(carry, _):
                    states, obs = carry
                    states, obs = self._step(top, states, policy_fn(obs))
                    return (states, obs), None

                (states, obs), _ = jax.lax.scan(
                    body, (states, obs0), None, length=n_frames
                )
                return states, obs

            self._rollouts[(policy_fn, n_frames)] = run

        states, obs = self._reset(key)
        return run(self.top, states, obs)


def make_env(host, cfg: SimConfig, spec: Optional[EnvSpec] = None) -> BatchedClothEnv:
    from .. import api

    top, rest = api.init(host)
    if spec is None:
        n = top.n_vertices
        # the two top corners: row 0 spans vertices [0, nx) on a grid
        nx = top.grid_shape[1] if top.grid_shape is not None else int(np.sqrt(n))
        spec = EnvSpec(
            handle_ids=(0, nx - 1),
            obs_ids=tuple(range(0, n, max(1, n // 16))),
            batch=1024,
        )
    return BatchedClothEnv(top, cfg, rest, spec)
