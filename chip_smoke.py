"""Chip smoke test: the soft-body engine's main path on one GPU.

    python chip_smoke.py            # one GPU: every single-device phase
    python chip_smoke.py --gpus 4   # only the multi-device legs, on 4 GPUs

Runs in ONE process.  It refuses to run without a GPU (no CPU fallback)
and exits non-zero if any phase fails.  Each phase prints one line with
its checks, their tolerances and the precision it ran at; the last line
is the contract line
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed.

Phases (preset sizes are the presets' own; nothing is shrunk):

* main: ``cloth_bench_64k`` through ``sb.step`` for 60 frames — finite,
  pins bit-frozen, nothing below the plane, unit normals, the first 16
  substeps against the float64 oracle, frame rate;
* one preset per route (stencil, banded jnp, lattice, shape matching,
  block self-collision, 1M cloth), each a few frames with its physical
  invariants and, where the oracle runs at that size, a few substeps
  against it;
* ``cloth_batch_rl`` x 1024 scenes through ``parallel/batch.py`` and the
  coupled rigid batch, each against the oracle on one scene;
* ``jax.grad`` through 64k stencil frames against central differences;
* the self-collision pair kernel against the jnp twin and the dense rule
  on the 16k preset, then ``sb.step`` with it on 16k and 64k.

With ``--gpus N`` only the multi-device legs run: the data-parallel RL
batch (N x 1024 scenes) against the same scenes on one card; the 64k
cloth split by rows, the 64k self-colliding curtain on the halo rows
(the dual-form pair kernel) and the 64k tet cube in slabs, each against
the single-card step.  Every leg checks that its arrays span N devices.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import subprocess
import sys
import time

ORACLE_TOL = 1e-4    # tests/test_oracle_parity.py f32-vs-f64 drift bound
F32 = "float32 state"


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


class PhaseFailed(Exception):
    pass


class Phase:
    """Collects ``(label, value, bound, ok)`` checks for one report line."""

    def __init__(self, name: str, precision: str):
        self.name, self.precision = name, precision
        self.items, self.info = [], []
        self.t0 = time.perf_counter()

    def check(self, label, ok, detail=""):
        self.items.append((label, bool(ok), detail))

    def le(self, label, value, bound, why=""):
        value = float(value)
        self.check(label, value <= bound,
                   f"{value:.3g} <= {bound:g}" + (f" ({why})" if why else ""))

    def note(self, text):
        self.info.append(text)

    def finish(self):
        bad = [lbl for lbl, ok, _ in self.items if not ok]
        checks = "; ".join(f"{lbl} {'ok' if ok else 'FAIL'} [{d}]"
                           for lbl, ok, d in self.items)
        extra = (" | " + "; ".join(self.info)) if self.info else ""
        status = "FAIL" if bad else "PASS"
        print(f"PHASE {self.name}: {status} {checks} | precision: "
              f"{self.precision} | {time.perf_counter() - self.t0:.1f} s"
              f"{extra}", flush=True)
        if bad:
            raise PhaseFailed(f"{self.name}: {', '.join(bad)}")


# --------------------------------------------------------------------------
# helpers shared by the phases
# --------------------------------------------------------------------------

def _build(name):
    from softbodyunity_tpu import api
    from softbodyunity_tpu.models import presets

    host, cfg = presets.build(name)
    top, state = api.init(host)
    state = api.ensure_tear_state(top, cfg, state)
    state = api.ensure_plastic_state(top, cfg, state)
    state = api.ensure_shapematch_state(top, cfg, state)
    return host, cfg, top, state


def _frames(top, cfg, state, n, timed=False):
    """``n`` frames of ``sb.step``; returns (state, seconds per frame)."""
    import jax

    from softbodyunity_tpu import api

    state = api.step(top, cfg, state)          # compile + first frame
    jax.block_until_ready(state.x)
    t0 = time.perf_counter()
    for _ in range(n - 1):
        state = api.step(top, cfg, state)
    jax.block_until_ready(state.x)
    dt = (time.perf_counter() - t0) / max(n - 1, 1)
    return state, dt


def _oracle_gap(host, cfg, top, state0, n_sub):
    """Max |x_device - x_oracle| after ``n_sub`` substeps from ``state0``
    (the float64 oracle starts from the same float32 state)."""
    import numpy as np

    from softbodyunity_tpu import api
    from softbodyunity_tpu.oracle import reference as oracle

    x = np.asarray(state0.x, np.float64)
    v = np.asarray(state0.v, np.float64)
    xp = np.asarray(state0.x_prev, np.float64)
    extras = {}
    if cfg.tear.enabled:
        extras["alive"] = np.asarray(state0.edge_alive, np.float64)
    if cfg.plasticity.enabled:
        extras["rest_scale"] = np.asarray(state0.rest_scale, np.float64)
    if oracle._shape_match_enabled(host, cfg):
        extras["quats"] = np.asarray(state0.cluster_quat, np.float64)
    want = oracle.step(host, cfg, x, v, xp, n_substeps=n_sub, **extras)[0]
    got = api.step(top, cfg, state0, n_substeps=n_sub)
    return float(np.max(np.abs(np.asarray(got.x, np.float64) - want)))


def _invariants(ph, host, cfg, state0, state):
    import numpy as np

    x = np.asarray(state.x)
    ph.check("finite", np.isfinite(x).all())
    pinned = np.asarray(host.inv_mass) == 0.0
    if pinned.any():
        ph.check("pins bit-frozen",
                 np.array_equal(x[pinned], np.asarray(state0.x)[pinned]),
                 f"{int(pinned.sum())} pins vs the f32 initial state")
    if cfg.collision.enable_plane:
        lo = float(x[:, 1].min())
        plane_y = float(host.plane_height)
        ph.check("above plane", lo >= plane_y - 1e-5,
                 f"min y {lo:.4f} >= {plane_y} - 1e-5")
    return x


def _precision_note():
    from softbodyunity_tpu.solver import forces

    return f"Gram products at {forces.GRAM_PRECISION.name}"


# --------------------------------------------------------------------------
# single-device phases
# --------------------------------------------------------------------------

def phase_main():
    import numpy as np

    from softbodyunity_tpu import api

    host, cfg, top, state0 = _build("cloth_bench_64k")
    ph = Phase("main cloth_bench_64k (256x256, Euler, 16 substeps/frame, "
               "stencil path)", f"{F32}; stencil path has no matmul")
    gap = _oracle_gap(host, cfg, top, state0, cfg.n_substeps)
    ph.le("first 16 substeps vs f64 oracle", gap, ORACLE_TOL,
          "the f32 drift bound of tests/test_oracle_parity.py")
    state, spf = _frames(top, cfg, state0, 60)
    _invariants(ph, host, cfg, state0, state)
    n = np.asarray(api.normals(top, state))
    ph.le("normals | |n| - 1 |", np.abs(np.linalg.norm(n, axis=1) - 1).max(),
          1e-5, "f32 rounding of a normalised vector")
    ph.note(f"60 frames: {1.0 / spf:.1f} frames/s, "
            f"{cfg.n_substeps / spf:.1f} substeps/s (block_until_ready, "
            f"after compile)")
    ph.finish()


ROUTES = [
    # preset, frames, oracle substeps (0 = the oracle does not run at
    # this size), path
    ("cloth_bench_64k_verlet", 10, 4, "stencil"),
    ("cloth_bench_64k_xpbd", 10, 2, "stencil"),
    ("cloth_tearing_64k", 10, 4, "stencil"),
    ("cloth_plastic_64k", 10, 4, "stencil"),
    ("cloth_wind_64k", 10, 4, "stencil"),
    ("cloth_strain_64k", 10, 4, "banded jnp"),
    ("softbody_cube_64k_xpbd", 10, 1, "banded lattice"),
    ("jelly_voxel_50k", 10, 2, "banded lattice + one-hot shape matching"),
    ("cloth_selfcollide_64k", 10, 0, "banded jnp + block self-collision"),
    ("cloth_bench_1m", 3, 0, "stencil"),
]


def phase_route(name, frames, n_oracle, path):
    import jax
    import numpy as np

    from softbodyunity_tpu.solver import blocksparse

    host, cfg, top, state0 = _build(name)
    prec = F32 + ("; one-hot cluster sums at HIGHEST" if "shape" in path
                  else "; banded contractions at HIGHEST" if "band" in path
                  else "")
    ph = Phase(f"route {name} ({top.n_vertices} vertices, {path})", prec)
    if n_oracle:
        ph.le(f"first {n_oracle} substeps vs f64 oracle",
              _oracle_gap(host, cfg, top, state0, n_oracle), ORACLE_TOL,
              "the f32 drift bound of tests/test_oracle_parity.py")
    else:
        ph.note("no oracle comparison: the NumPy oracle does not run at "
                "this size in a smoke budget")
    state, spf = _frames(top, cfg, state0, frames)
    x = _invariants(ph, host, cfg, state0, state)
    if cfg.tear.enabled:
        alive = np.asarray(state.edge_alive)
        ph.check("liveness only decreases",
                 alive.sum() <= np.asarray(state0.edge_alive).sum(),
                 f"{int(alive.size - alive.sum())} torn edges")
    if cfg.plasticity.enabled:
        s = np.asarray(state.rest_scale)
        pp = cfg.plasticity
        ph.check("rest scale in clamp",
                 s.min() >= pp.min_scale - 1e-6 and s.max() <= pp.max_scale
                 + 1e-6, f"[{s.min():.4f}, {s.max():.4f}]")
    if cfg.wind.enabled:
        moved = float(x[:, 0].mean() - np.asarray(state0.x)[:, 0].mean())
        ph.check("wind pushes downwind", moved > 0.0, f"mean dx {moved:.4f}")
    if cfg.shape_match.enabled:
        x0 = np.asarray(state0.x)
        e0 = np.abs(x0 - x0.mean(0)).max()
        e1 = np.abs(x - x.mean(0)).max()
        ph.check("jelly keeps its extent", e1 < 2.0 * e0,
                 f"{e0:.3f} -> {e1:.3f}")
    if cfg.self_collision.enabled:
        d = blocksparse.self_collision_block_diagnostics(
            state.x, cfg.self_collision)
        ph.check("dropped_pairs == 0", int(d["dropped_pairs"]) == 0,
                 f"{int(d['candidate_pairs'])} candidate tile pairs")
    if top.n_vertices >= 1 << 20:
        stats = jax.devices()[0].memory_stats() or {}
        ph.note(f"peak device memory "
                f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB")
    ph.note(f"{frames} frames: {1e3 * spf:.3f} ms/frame, "
            f"{cfg.n_substeps / spf:.1f} substeps/s")
    ph.finish()


def phase_batch():
    import jax
    import numpy as np

    from softbodyunity_tpu.oracle import reference as oracle
    from softbodyunity_tpu.parallel import batch

    host, cfg, top, state = _build("cloth_batch_rl")
    ph = Phase("batch cloth_batch_rl x 1024 (parallel/batch.py, dense "
               "Gram self-collision)", f"{F32}; {_precision_note()}")
    scenes = 1024
    jitter = jax.random.normal(jax.random.PRNGKey(0), (scenes, 3)) * 0.02
    s0 = batch.batch_state(state, scenes, jitter=jitter)
    one = batch.step_batched(top, cfg, s0)
    xo = np.asarray(s0.x[0], np.float64)
    # the oracle's self-collision is the dense rule; the device runs the
    # Gram form of the same rule
    want = oracle.step(host, cfg, xo, np.zeros_like(xo), xo)[0]
    ph.le("scene 0, one frame vs f64 oracle",
          np.abs(np.asarray(one.x[0], np.float64) - want).max(), ORACLE_TOL,
          "the f32 drift bound of tests/test_oracle_parity.py")
    out = batch.rollout_batched(top, cfg, s0, 20)     # compile + warm
    jax.block_until_ready(out.x)
    t0 = time.perf_counter()
    out = batch.rollout_batched(top, cfg, out, 20)
    jax.block_until_ready(out.x)
    dt = (time.perf_counter() - t0) / 20
    x = np.asarray(out.x)
    ph.check("finite", np.isfinite(x).all())
    ph.check("above plane", x[..., 1].min() >= host.plane_height - 1e-5,
             f"min y {x[..., 1].min():.4f}")
    pinned = np.asarray(host.inv_mass) == 0.0
    ph.check("pins bit-frozen",
             np.array_equal(x[:, pinned], np.asarray(s0.x)[:, pinned]))
    ph.note(f"20 timed frames: {scenes / dt:.1f} env-steps/s ({1e3 * dt:.3f} "
            f"ms/frame)")
    ph.finish()


def phase_coupled():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from softbodyunity_tpu.oracle import reference as oracle
    from softbodyunity_tpu.parallel import batch
    from softbodyunity_tpu.solver.rigid import (make_rigid_state,
                                                step_coupled_scan)

    host, cfg, top, state = _build("cloth_hanging_sphere")
    ph = Phase("coupled cloth_hanging_sphere x 1024 with a dynamic 0.5 kg "
               "ball each (solver/rigid.py)", f"{F32}; rigid stages at "
               "HIGHEST")
    scenes = 1024
    jitter = jax.random.normal(jax.random.PRNGKey(1), (scenes, 3)) * 0.01
    states = batch.batch_state(state, scenes, jitter=jitter)
    rigid = make_rigid_state(top, [0.5])
    rigids = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (scenes,) + a.shape), rigid)
    run = jax.jit(lambda t, s, r, n: jax.vmap(
        lambda si, ri: step_coupled_scan(t, cfg, si, ri, cfg.dt, n))(s, r),
        static_argnums=3)
    s1, r1 = run(top, states, rigids, cfg.n_substeps)
    xo = np.asarray(states.x[0], np.float64)
    want = oracle.step_coupled(
        host, cfg, xo, np.zeros_like(xo), xo,
        np.asarray(rigid.centers, np.float64),
        np.zeros((1, 3)), np.array([2.0]))
    ph.le("scene 0, one frame vs f64 oracle (cloth)",
          np.abs(np.asarray(s1.x[0], np.float64) - want[0]).max(), ORACLE_TOL,
          "the f32 drift bound of tests/test_oracle_parity.py")
    ph.le("scene 0, one frame vs f64 oracle (ball)",
          np.abs(np.asarray(r1.centers[0], np.float64) - want[3]).max(),
          ORACLE_TOL)
    t0 = time.perf_counter()
    for _ in range(30):
        s1, r1 = run(top, s1, r1, cfg.n_substeps)
    jax.block_until_ready(s1.x)
    dt = (time.perf_counter() - t0) / 30
    c = np.asarray(r1.centers)
    ph.check("finite", np.isfinite(np.asarray(s1.x)).all()
             and np.isfinite(c).all())
    ph.check("balls above the floor", c[:, 0, 1].min() > host.plane_height,
             f"min center y {c[:, 0, 1].min():.3f}")
    ph.note(f"31 frames: {scenes / dt:.1f} env-steps/s")
    ph.finish()


def phase_grad():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from softbodyunity_tpu import api
    from softbodyunity_tpu.kernels.stencil import make_stencil_step
    from softbodyunity_tpu.models import presets

    host, cfg = presets.build("cloth_bench_64k")
    ph = Phase("grad cloth_bench_64k, jax.grad through 2 stencil frames "
               "vs central differences of the float64 program",
               f"{F32} gradient, float64 differences; no matmul")
    key = jax.random.split(jax.random.PRNGKey(2), 4)
    n3 = (host.positions0.shape[0], 3)
    w = np.asarray(jax.random.normal(key[0], n3))
    dirs = [np.asarray(jax.random.normal(k, n3)) for k in key[1:]]
    dirs = [d / np.linalg.norm(d) for d in dirs]

    def program(dtype):
        top, state = api.init(host, dtype=dtype)
        step = make_stencil_step(top, cfg)

        @jax.jit
        def final_x(v0):
            s = state.replace(v=v0)
            for _ in range(2):
                s = step(s, cfg.dt, cfg.n_substeps)
            return s.x
        return state, final_x

    state, final_x = program(jnp.float32)
    wj = jnp.asarray(w, jnp.float32)
    g = np.asarray(jax.jit(jax.grad(
        lambda v0: jnp.sum(final_x(v0) * wj)))(state.v), np.float64)
    ph.check("finite gradient", np.isfinite(g).all())
    # central differences of the float64 program: no f32 rounding in the
    # difference, eps ~1e-4 m/s per component keeps the curvature error
    # far below the f32 gradient's own rounding
    eps = 1e-4 * math.sqrt(g.size)
    worst, rows = 0.0, []
    with jax.enable_x64(True):
        state64, final64 = program(jnp.float64)
        for d in dirs:
            dd = jnp.asarray(d, jnp.float64)
            dx = np.asarray(final64(state64.v + eps * dd)
                            - final64(state64.v - eps * dd))
            fd = float(np.sum(w * dx)) / (2 * eps)
            ad = float(np.sum(g * d))
            rows.append(f"ad {ad:.6g} fd {fd:.6g}")
            worst = max(worst, abs(ad - fd) / max(abs(fd), 1e-30))
    ph.le("f32 directional derivative vs f64 central difference "
          "(3 directions)", worst, 1e-2,
          "relative; f32 rounding in the gradient")
    ph.note("; ".join(rows))
    ph.finish()


def phase_kernel():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from softbodyunity_tpu import api
    from softbodyunity_tpu.kernels import block_pairs
    from softbodyunity_tpu.solver import blocksparse

    ph = Phase("kernel Triton self-collision pairs vs jnp twin and dense "
               "rule (cloth_selfcollide_16k, draped 12 frames)",
               f"{F32}; direct differences, no matmul")
    ph.check("route is the Triton kernel", block_pairs.pair_route() ==
             "triton")
    host, cfg, top, state = _build("cloth_selfcollide_16k")
    for _ in range(12):
        state = api.step(top, cfg, state)
    x, p = state.x, cfg.self_collision
    f_k = block_pairs.forces_block_kernel(x, p)
    f_t = blocksparse.self_collision_forces_block(x, p)

    eps = 1e-3 * p.radius

    @functools.partial(jax.jit, static_argnums=1)
    def dense(x, clamp):
        """The dense O(N^2) rule, in row chunks; ``clamp`` applies the
        block method's distance floor ``1e-3 * radius``."""
        def rows(xi):
            d = xi[:, None, :] - x[None, :, :]
            dist = jnp.sqrt(jnp.sum(d * d, axis=-1))
            if clamp:
                dist = jnp.maximum(dist, eps)
            w = jnp.where((dist < p.radius) & jnp.any(d != 0.0, axis=-1),
                          p.stiffness * (p.radius - dist)
                          / jnp.maximum(dist, 1e-12), 0.0)
            return jnp.sum(w[..., None] * d, axis=1)
        chunk = math.gcd(x.shape[0], 1024)
        return jax.lax.map(rows, x.reshape(-1, chunk, 3)).reshape(-1, 3)

    f_d = dense(x, True)
    scale = float(jnp.abs(f_d).max())
    ph.check("forces active", scale > 0.0, f"max|f| {scale:.3g}")
    err_t = np.abs(np.asarray(f_k) - np.asarray(f_t))
    err_d = np.abs(np.asarray(f_k) - np.asarray(f_d))
    ph.le("kernel vs twin (excess over 5e-4 + 1e-3|f|)",
          (err_t - 1e-3 * np.abs(np.asarray(f_t))).max(), 5e-4,
          "tests/test_blocksparse.py tolerance")
    ph.le("kernel vs dense rule with the same distance floor (excess over "
          "1e-3 + 1e-3|f|)", (err_d - 1e-3 * np.abs(np.asarray(f_d))).max(),
          1e-3, "tests/test_blocksparse.py folded-cloth tolerance")
    near = float(jnp.abs(dense(x, False) - f_d).max())
    ph.note(f"pairs closer than 1e-3*radius ({eps:.1e}) move the force by "
            f"at most {near:.3g} against the unfloored dense rule (bound "
            f"stiffness*radius = {p.stiffness * p.radius:.3g} per pair)")
    for name in ("cloth_selfcollide_16k", "cloth_selfcollide_64k"):
        host, cfg, top, s0 = _build(name)
        s, spf = _frames(top, cfg, s0, 10)
        ph.check(f"{name} finite", np.isfinite(np.asarray(s.x)).all())
        ph.note(f"{name} sb.step with the kernel: {1e3 * spf:.3f} ms/frame "
                f"({cfg.n_substeps / spf:.1f} substeps/s)")
    ph.finish()


# --------------------------------------------------------------------------
# multi-device legs (--gpus N)
# --------------------------------------------------------------------------

def _spans(ph, arr, n):
    devs = arr.sharding.device_set
    ph.check(f"spans {n} devices", len(devs) == n,
             f"{sorted(d.id for d in devs)}")


def leg_dp(n):
    import jax
    import numpy as np

    from softbodyunity_tpu.parallel import batch, sharding

    host, cfg, top, state = _build("cloth_batch_rl")
    ph = Phase(f"dp cloth_batch_rl {n} x 1024 scenes over {n} GPUs vs the "
               "same scenes on one GPU", f"{F32}; {_precision_note()}")
    scenes = 1024 * n
    jitter = jax.random.normal(jax.random.PRNGKey(0), (scenes, 3)) * 0.02
    s0 = batch.batch_state(state, scenes, jitter=jitter)
    mesh = sharding.make_mesh(jax.devices()[:n])
    sh = sharding.shard_batched_state(s0, mesh)
    top_r = sharding.replicate_topology(top, mesh)
    out = sharding.step_sharded(top_r, cfg, sh, mesh)
    jax.block_until_ready(out.x)
    _spans(ph, out.x, n)
    ref = batch.step_batched(top, cfg, s0)
    ph.le("max |sharded - one card|",
          np.abs(np.asarray(out.x) - np.asarray(ref.x)).max(), 1e-5,
          "per-device programs may fuse the batch differently")
    t0 = time.perf_counter()
    for _ in range(10):
        out = sharding.step_sharded(top_r, cfg, out, mesh)
    jax.block_until_ready(out.x)
    dt = (time.perf_counter() - t0) / 10
    ph.check("finite", np.isfinite(np.asarray(out.x)).all())
    ph.note(f"{scenes / dt:.1f} env-steps/s over {n} GPUs")
    ph.finish()


def _halo_cloth(n, name, drape, tol, why):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from softbodyunity_tpu import api
    from softbodyunity_tpu.parallel import halo

    host, cfg, top, state = _build(name)
    for _ in range(drape):
        state = api.step(top, cfg, state)
    path = ("dual-form pair kernel on the rows"
            if cfg.self_collision.enabled else "stencil rows")
    ph = Phase(f"halo {name} rows over {n} GPUs ({path}) vs one GPU",
               f"{F32}; no matmul")
    mesh = Mesh(np.array(jax.devices()[:n]), (halo.ROWS_AXIS,))
    fn = jax.jit(halo.make_halo_step(top, cfg, mesh), static_argnums=(5,))
    x3, v3, im3, phh = halo.shard_grid_state(top, state, mesh)
    xf, vf = fn(x3, v3, im3, phh, cfg.dt, cfg.n_substeps)
    jax.block_until_ready(xf)
    _spans(ph, xf, n)
    got = halo.unshard_to_state(xf, vf, cfg.dt)
    want = api.step(top, cfg, state)
    ph.le("max |rows - one card| after one frame",
          np.abs(np.asarray(got.x) - np.asarray(want.x)).max(), tol, why)
    t0 = time.perf_counter()
    for _ in range(5):
        xf, vf = fn(xf, vf, im3, phh, cfg.dt, cfg.n_substeps)
    jax.block_until_ready(xf)
    ph.check("finite", np.isfinite(np.asarray(xf)).all())
    ph.note(f"{1e3 * (time.perf_counter() - t0) / 5:.3f} ms/frame "
            f"over {n} GPUs")
    ph.finish()


def leg_halo_cloth(n):
    _halo_cloth(n, "cloth_bench_64k", 0, 1e-5,
                "tests/test_halo.py tolerance")


def leg_halo_selfcollide(n):
    _halo_cloth(n, "cloth_selfcollide_64k", 20, 3e-4,
                "tests/test_halo.py self-collision tolerance; the rows run "
                "stencil springs, the single card banded ones")


def leg_halo_lattice(n):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from softbodyunity_tpu.parallel import halo
    from softbodyunity_tpu.solver.step import step_scan

    host, cfg, top, state = _build("softbody_cube_64k")
    ph = Phase(f"halo softbody_cube_64k slabs over {n} GPUs vs one GPU",
               f"{F32}; banded contractions at HIGHEST")
    mesh = Mesh(np.array(jax.devices()[:n]), (halo.ROWS_AXIS,))
    fn = jax.jit(halo.make_halo_lattice_step(top, cfg, mesh),
                 static_argnums=(7,))
    args = halo.shard_lattice_state(top, state, mesh)
    xf, vf = fn(*args, cfg.dt, cfg.n_substeps)
    jax.block_until_ready(xf)
    _spans(ph, xf, n)
    ref = jax.jit(lambda t, s: step_scan(t, cfg, s, cfg.dt,
                                         cfg.n_substeps))(top, state)
    got = np.asarray(xf).reshape(3, -1).T
    ph.le("max |slabs - one card| after one frame",
          np.abs(got - np.asarray(ref.x)).max(), 3e-5,
          "tests/test_halo.py tolerance")
    ph.check("finite", np.isfinite(got).all())
    t0 = time.perf_counter()
    for _ in range(5):
        xf, vf = fn(xf, vf, *args[2:], cfg.dt, cfg.n_substeps)
    jax.block_until_ready(xf)
    ph.note(f"{1e3 * (time.perf_counter() - t0) / 5:.3f} ms/frame "
            f"over {n} GPUs")
    ph.finish()


# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpus", type=int, default=1,
                    help="N > 1: run only the multi-device legs on N GPUs")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    devices = jax.devices()
    if len(devices) < args.gpus:
        print(f"chip_smoke: --gpus {args.gpus} but JAX sees {len(devices)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from softbodyunity_tpu.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    t_start = time.perf_counter()
    print(f"card: {_card_line()}", flush=True)
    print(f"jax {jax.__version__}; device_kind {devices[0].device_kind}; "
          f"{len(devices)} visible; compile cache {cache}", flush=True)
    if args.gpus > 1:
        n = args.gpus
        phases = [lambda: leg_dp(n), lambda: leg_halo_cloth(n),
                  lambda: leg_halo_selfcollide(n),
                  lambda: leg_halo_lattice(n)]
    else:
        phases = ([phase_main]
                  + [lambda r=r: phase_route(*r) for r in ROUTES]
                  + [phase_batch, phase_coupled, phase_grad, phase_kernel])
    failed = []
    for run in phases:
        try:
            run()
        except PhaseFailed as e:
            failed.append(str(e))
        except Exception as e:  # noqa: BLE001 - reported, then exit 1
            print(f"PHASE ERROR: {type(e).__name__}: {e}"[:2000], flush=True)
            failed.append(type(e).__name__)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke: {len(failed)} phase(s) failed: {failed}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
