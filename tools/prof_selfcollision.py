"""Block-sparse self-collision on the GPU: the Triton pair kernel against
the jnp twin, end to end through ``sb.step`` and alone.

Run on a machine with a GPU (it refuses anything else):

    python tools/prof_selfcollision.py [--presets a,b] [--frames N]
                                       [--drape N] [--sweep]

For each preset the cloth first drapes for ``--drape`` frames (so the
partner lists look like a running scene), then ``sb.step`` is timed for
``--frames`` frames with each route, in turns (kernel, twin, twin,
kernel).  ``--sweep`` also times the kernel alone over a few launch
shapes (rows, cols, warps, stages).  Every line names the card.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from softbodyunity_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

from softbodyunity_tpu import api
from softbodyunity_tpu.kernels import block_pairs
from softbodyunity_tpu.models import presets
from softbodyunity_tpu.solver import blocksparse


def _card():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        out = "nvidia-smi unavailable"
    return f"{jax.devices()[0].device_kind} ({out})"


def _time_frames(top, cfg, state, frames):
    state = api.step(top, cfg, state)              # compile + warm
    jax.block_until_ready(state.x)
    t0 = time.perf_counter()
    for _ in range(frames):
        state = api.step(top, cfg, state)
    jax.block_until_ready(state.x)
    return (time.perf_counter() - t0) / frames, state


def _with_route(route, fn, *args):
    saved = block_pairs.pair_route
    block_pairs.pair_route = lambda: route
    api._compiled_step.cache_clear()
    try:
        return fn(*args)
    finally:
        block_pairs.pair_route = saved
        api._compiled_step.cache_clear()


def _sweep(x, p, card):
    xt, _, nvalid, partners, _ = block_pairs._tiles_and_partners(x, x, p)
    kw = dict(radius=float(p.radius), stiffness=float(p.stiffness))
    ref = block_pairs.block_pairs(xt, xt, nvalid, partners, **kw)
    for rows, cols, warps, stages in ((16, 256, 4, 2), (8, 256, 4, 2),
                                      (16, 256, 2, 2), (16, 256, 8, 2),
                                      (16, 256, 4, 3), (32, 256, 4, 2),
                                      (16, 128, 4, 2), (64, 64, 4, 2)):
        fn = jax.jit(lambda a, b, c: block_pairs.block_pairs(
            a, a, b, c, rows=rows, cols=cols, num_warps=warps,
            num_stages=stages, **kw))
        try:
            out = fn(xt, nvalid, partners)
            jax.block_until_ready(out)
        except Exception as e:                      # noqa: BLE001
            print(f"  sweep rows={rows} cols={cols} warps={warps} "
                  f"stages={stages}: FAILED {type(e).__name__}: {e}"[:300],
                  flush=True)
            continue
        err = float(jnp.max(jnp.abs(out - ref)))
        t0 = time.perf_counter()
        for _ in range(50):
            out = fn(xt, nvalid, partners)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / 50
        print(f"  sweep rows={rows} cols={cols} warps={warps} "
              f"stages={stages}: {dt * 1e6:.1f} us/call, max|diff| {err:.3g}"
              f" [{card}]", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--presets",
                    default="cloth_selfcollide_16k,cloth_selfcollide_64k")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--drape", type=int, default=24)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        sys.exit(f"needs a GPU, found {jax.default_backend()!r}")
    card = _card()
    print(f"jax {jax.__version__} on {card}", flush=True)
    for name in args.presets.split(","):
        host, cfg = presets.build(name)
        top, state = api.init(host)
        p = cfg.self_collision
        for _ in range(args.drape):
            state = api.step(top, cfg, state)
        x = state.x
        diag = blocksparse.self_collision_block_diagnostics(x, p)
        f_k = block_pairs.forces_block_kernel(x, p)
        f_j = blocksparse.self_collision_forces_block(x, p)
        err = float(jnp.max(jnp.abs(f_k - f_j)))
        scale = float(jnp.max(jnp.abs(f_j)))
        print(f"{name}: n={x.shape[0]} dropped_pairs="
              f"{int(diag['dropped_pairs'])} kernel vs twin max|diff| "
              f"{err:.3g} (max|f| {scale:.3g})", flush=True)
        # the whole force call (sort, partners, pairs, unsort) alone
        for label, fn in (
                ("kernel", jax.jit(lambda y: block_pairs.forces_block_kernel(
                    y, p))),
                ("jnp twin", jax.jit(
                    lambda y: blocksparse.self_collision_forces_block(y, p)))):
            jax.block_until_ready(fn(x))
            t0 = time.perf_counter()
            for _ in range(20):
                out = fn(x)
            jax.block_until_ready(out)
            print(f"  {name} forces alone, {label}: "
                  f"{(time.perf_counter() - t0) / 20 * 1e6:.1f} us/call "
                  f"[{card}]", flush=True)
        times = {"triton": [], "jnp": []}
        for route in ("triton", "jnp", "jnp", "triton"):
            dt, _ = _with_route(route, _time_frames, top, cfg, state,
                                args.frames)
            times[route].append(dt)
            print(f"  {name} sb.step route={route}: {dt * 1e3:.3f} ms/frame "
                  f"({cfg.n_substeps / dt:.1f} substeps/s) [{card}]",
                  flush=True)
        print(f"{name} best ms/frame: triton "
              f"{min(times['triton']) * 1e3:.3f}, jnp "
              f"{min(times['jnp']) * 1e3:.3f} [{card}]", flush=True)
        if args.sweep:
            _sweep(x, p, card)


if __name__ == "__main__":
    main()
