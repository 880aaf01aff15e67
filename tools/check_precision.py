"""Float32 matmul precision on the GPU: ``Precision.HIGH`` (TF32 there)
against ``HIGHEST`` for the two products that feed cancellations.

Run on a machine with a GPU (it refuses anything else):

    python tools/check_precision.py [--gram-frames 300] [--jelly-frames 1000]

1. The Gram self-collision (``solver/forces.py`` ``GRAM_PRECISION``) on
   ``cloth_batch_rl`` x 1024 scenes: finiteness over the run, frame
   time, and at each checkpoint the contact set from the Gram ``d^2``
   against float64 distances of the same positions, plus the forces
   against the float64 oracle rule on a few scenes.
2. The Kronecker shape-match contractions (``solver/shapematch.py``
   ``KRON_PRECISION``) on ``jelly_voxel_50k``: ``dx`` against the
   float64 oracle at rest and after the run, and the stability of the
   main path (``sb.step``) over ``--jelly-frames`` frames.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from softbodyunity_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

from softbodyunity_tpu import api
from softbodyunity_tpu.models import presets
from softbodyunity_tpu.oracle import reference as oracle
from softbodyunity_tpu.parallel import batch
from softbodyunity_tpu.solver import forces, shapematch

PRECISIONS = {"HIGH": jax.lax.Precision.HIGH,
              "HIGHEST": jax.lax.Precision.HIGHEST}


def _contact_check(x, p):
    """Contact-set mismatches of the Gram d^2 against float64 distances of
    the same f32 positions.  ``x`` f32[B, N, 3] on the device."""
    xc = x - jnp.mean(x, axis=1, keepdims=True)
    d2 = np.asarray(jax.jit(jax.vmap(forces.pair_d2_gram))(xc), np.float64)
    xh = np.asarray(xc, np.float64)
    b, n, _ = xh.shape
    eye = np.eye(n, dtype=bool)[None]
    d_eps = 1e-3 * p.radius
    act_g = (np.sqrt(np.maximum(d2, d_eps ** 2)) < p.radius) & ~eye
    bad = wide = 0
    err = 0.0
    for s in range(0, b, 128):                     # host memory in chunks
        diff = xh[s:s + 128, :, None, :] - xh[s:s + 128, None, :, :]
        d2x = np.sum(diff * diff, axis=-1)
        act_x = (np.sqrt(np.maximum(d2x, d_eps ** 2)) < p.radius) & ~eye
        mism = act_x != act_g[s:s + 128]
        bad += int(mism.sum())
        # a mismatch whose true distance sits farther than 1e-4 radius
        # from the contact radius is not a rounding tie
        far = np.abs(np.sqrt(d2x) - p.radius) > 1e-4 * p.radius
        wide += int((mism & far).sum())
        near = (d2x < (2 * p.radius) ** 2) & ~eye
        err = max(err, float(np.max(np.where(near, np.abs(
            d2[s:s + 128] - d2x), 0.0))))
    return dict(active=int(act_g.sum()), mismatch=bad, mismatch_wide=wide,
                neg_d2=int((d2 < 0).sum()), max_d2_err_near=err)


def gram(frames, scenes, card):
    host, cfg = presets.build("cloth_batch_rl")
    top, state = api.init(host)
    p = cfg.self_collision
    jitter = jax.random.normal(jax.random.PRNGKey(0), (scenes, 3)) * 0.05
    chunk = min(50, frames)
    for name, prec in PRECISIONS.items():
        forces.GRAM_PRECISION = prec
        batch._compiled_rollout_batched.cache_clear()
        jax.clear_caches()
        states = batch.batch_state(state, scenes, jitter=jitter)
        out = batch.rollout_batched(top, cfg, states, chunk)   # compile
        jax.block_until_ready(out.x)
        t_run, done, finite = 0.0, 0, True
        while done < frames:
            t0 = time.perf_counter()
            states = batch.rollout_batched(top, cfg, states, chunk)
            jax.block_until_ready(states.x)
            t_run += time.perf_counter() - t0
            done += chunk
            finite = finite and bool(jnp.isfinite(states.x).all())
            c = _contact_check(states.x, p)
            print(f"gram {name} frame {done}: finite={finite} {c}",
                  flush=True)
        xs = np.asarray(states.x[:16], np.float64)
        f_dev = np.asarray(jax.vmap(
            lambda y: forces.self_collision_forces_dense_mxu(
                y, p.radius, p.stiffness))(states.x[:16]))
        ferr = max(float(np.max(np.abs(f_dev[i] - oracle.self_collision_forces(
            xs[i], p.radius, p.stiffness)))) for i in range(16))
        fmax = max(float(np.max(np.abs(oracle.self_collision_forces(
            xs[i], p.radius, p.stiffness)))) for i in range(16))
        print(f"gram {name}: {frames} frames x {scenes} scenes finite="
              f"{finite}, {t_run / done * 1e3:.3f} ms/frame "
              f"({scenes * done / t_run:.1f} env-steps/s), forces vs f64 "
              f"oracle max|diff| {ferr:.3g} (max|f| {fmax:.3g}) [{card}]",
              flush=True)
    forces.GRAM_PRECISION = jax.lax.Precision.HIGH


def jelly(frames, card):
    host, cfg = presets.build("jelly_voxel_50k")
    top, state = api.init(host)
    state = api.ensure_shapematch_state(top, cfg, state)
    kr = shapematch.shape_match_kron_statics(top)

    def kron_errors(tag, st):
        x64 = np.asarray(st.x, np.float64)
        q64 = np.asarray(st.cluster_quat, np.float64)
        dx_ref, _ = oracle.shape_match_dx(host, cfg, x64, q64)
        scale = float(np.max(np.abs(dx_ref))) + 1e-30
        for name, prec in PRECISIONS.items():
            shapematch.KRON_PRECISION = prec
            dx, _, _ = jax.jit(lambda x3, q: shapematch.shape_match_dx_kron(
                cfg, kr, x3, q))(st.x.T, st.cluster_quat)
            err = float(np.max(np.abs(np.asarray(dx, np.float64).T - dx_ref)))
            print(f"jelly kron {name} at {tag}: dx vs f64 oracle max|diff| "
                  f"{err:.3g} (max|dx| {scale:.3g})", flush=True)
        shapematch.KRON_PRECISION = jax.lax.Precision.HIGH
        dx_main, _ = jax.jit(lambda x, q: shapematch.shape_match_dx(
            top, cfg, x, q))(st.x, st.cluster_quat)
        err = float(np.max(np.abs(np.asarray(dx_main, np.float64) - dx_ref)))
        print(f"jelly main-path one-hot at {tag}: dx vs f64 oracle max|diff| "
              f"{err:.3g}", flush=True)

    kron_errors("rest", state)
    state = api.step(top, cfg, state)
    jax.block_until_ready(state.x)
    t0 = time.perf_counter()
    ext0 = float(jnp.max(jnp.abs(state.x - jnp.mean(state.x, axis=0))))
    for i in range(frames - 1):
        state = api.step(top, cfg, state)
    jax.block_until_ready(state.x)
    dt = (time.perf_counter() - t0) / (frames - 1)
    x = state.x
    ext = float(jnp.max(jnp.abs(x - jnp.mean(x, axis=0))))
    print(f"jelly main path {frames} frames: finite="
          f"{bool(jnp.isfinite(x).all())} extent {ext0:.4f} -> {ext:.4f} "
          f"min y {float(jnp.min(x[:, 1])):.4f}, {dt * 1e3:.3f} ms/frame "
          f"[{card}]", flush=True)
    kron_errors(f"frame {frames}", state)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gram-frames", type=int, default=300)
    ap.add_argument("--scenes", type=int, default=1024)
    ap.add_argument("--jelly-frames", type=int, default=1000)
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        sys.exit(f"needs a GPU, found {jax.default_backend()!r}")
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    card = f"{jax.devices()[0].device_kind} ({smi})"
    print(f"jax {jax.__version__} on {card}", flush=True)
    gram(args.gram_frames, args.scenes, card)
    jelly(args.jelly_frames, card)


if __name__ == "__main__":
    main()
