"""Preset benchmark/rollout runner behind the CLI
(``python -m softbodyunity_tpu.bench <preset>``; SURVEY.md §5 "Config /
flag system": the registry of named presets is the reference's
Inspector-field analogue).

Emits one JSON row per run: timing + physics diagnostics, with the device
it ran on.  Timing is the marginal cost between two scan lengths, which
cancels the fixed dispatch and fetch latency.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import jax
import jax.numpy as jnp

from .. import api
from ..core.config import BACKENDS
from ..models import presets
from ..utils import profiling


def _make_run(top, cfg, n_substeps, backend):
    cfg = cfg.replace(backend=backend)

    def impl(t, s):
        # dispatch INSIDE the traced function (top as a jit argument, never
        # a closure constant — see CLAUDE.md)
        return jnp.mean(
            api._dispatch_step(t, cfg, s, cfg.dt, n_substeps).x)

    return jax.jit(impl)


def run_preset(
    name: str,
    backend: str = "jnp",
    n_frames: int = 100,
    profile_dir: Optional[str] = None,
    checkpoint: Optional[str] = None,
) -> dict:
    host, cfg = presets.build(name)
    top, state = api.init(host)
    n_sub = cfg.n_substeps

    # big/small must be far enough apart that the marginal rises above
    # the dispatch-latency noise
    small, big = n_sub, n_sub * max(20, min(n_frames, 200))
    run_small = _make_run(top, cfg, small, backend)
    run_big = _make_run(top, cfg, big, backend)
    float(run_small(top, state))
    float(run_big(top, state))

    def best(fn, repeats=3):
        b = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            float(fn(top, state))
            b = min(b, time.perf_counter() - t0)
        return b

    if profile_dir:
        with profiling.trace(profile_dir):
            float(run_big(top, state))

    t_s, t_b = best(run_small), best(run_big)
    per_substep = (t_b - t_s) / (big - small)
    if per_substep <= 0:
        # workload still inside dispatch noise: report honestly, not a lie
        per_substep = None
        substeps_per_sec = None
    else:
        substeps_per_sec = 1.0 / per_substep

    # advance a real trajectory for diagnostics / checkpoint
    final = api.step(top, cfg, state, n_substeps=big)
    diag = profiling.diagnostics(top, cfg, final)
    if checkpoint:
        from ..utils import checkpoint as ckpt

        ckpt.save_state(checkpoint, final)

    row = {
        "preset": name,
        "backend": backend,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "n_vertices": top.n_vertices,
        "n_edges": top.n_edges,
        "substeps_per_sec": round(substeps_per_sec, 1) if substeps_per_sec else None,
        "us_per_substep": round(per_substep * 1e6, 3) if per_substep else None,
        **diag,
    }
    return row


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m softbodyunity_tpu.bench",
        description="Run a named workload preset and print a JSON metrics row.",
    )
    p.add_argument("preset", choices=presets.names())
    p.add_argument("--backend", default="jnp", choices=list(BACKENDS))
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--profile-dir", default=None,
                   help="capture an xprof/TensorBoard trace into this dir")
    p.add_argument("--checkpoint", default=None,
                   help="save the final State to this .npz path")
    args = p.parse_args(argv)
    row = run_preset(
        args.preset, backend=args.backend, n_frames=args.frames,
        profile_dir=args.profile_dir, checkpoint=args.checkpoint,
    )
    print(json.dumps(row))


if __name__ == "__main__":
    main()
