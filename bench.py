"""Benchmark harness (SURVEY.md C18): prints JSON lines with the headline
metric — substeps/sec on the 64k-vertex cloth (BASELINE.json:2,5) through
the same ``api`` dispatch a user gets — plus secondary parts (other
presets, the 1024-scene vmapped batch in env-steps/sec) as extra keys.
Every line names the device the numbers came from.

Run on a machine with a GPU: ``python bench.py`` (all parts) or
``python bench.py --part 64k`` (one part; names in ``_PARTS``).

Each part runs in a child process, one at a time, so only one process
ever holds the card; the parent never opens a JAX backend.  A part's
rate is the marginal cost between a small and a large on-device
``lax.scan`` workload, which cancels the fixed dispatch and fetch
latency; the host fetch of a device-reduced scalar is the barrier.  The
last stdout line is always a complete JSON record of everything measured
so far.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _setup_jax():
    import jax

    from softbodyunity_tpu.utils.cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"bench.py measures the GPU; JAX found {jax.default_backend()!r}")
    enable_compile_cache()
    return jax


def _device():
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def _best_time(run, args, repeats: int = 3) -> float:
    """Min wall time of ``float(run(*args))`` (the fetch is the barrier)."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        v = float(run(*args))
        best = min(best, time.perf_counter() - t0)
        assert v == v, "NaN in benchmark output"
    return best


def _marginal_throughput(make_run, args, small: int, big: int,
                         unit_per_frame: int):
    """Units/sec from the marginal time between two scan lengths; the big
    workload widens until the delta clears 8 ms of dispatch noise."""
    run_s = make_run(small)
    float(run_s(*args))  # compile + warm
    t_s = _best_time(run_s, args)
    for _ in range(4):
        run_b = make_run(big)
        float(run_b(*args))
        t_b = _best_time(run_b, args)
        if t_b - t_s >= 0.008:
            d = (t_b - t_s) / ((big - small) * unit_per_frame)
            return 1.0 / d
        _log(f"marginal delta {1e3 * (t_b - t_s):.1f} ms inside dispatch "
             f"noise; widening workload {big} -> {small + 4 * (big - small)}")
        big = small + 4 * (big - small)
    raise RuntimeError("marginal time never cleared the dispatch noise")


def _bench_preset_substeps(preset: str, small: int, big: int):
    """Substeps/sec of a preset through the production dispatch path (the
    route api.step takes)."""
    jax = _setup_jax()
    import jax.numpy as jnp

    from softbodyunity_tpu import api
    from softbodyunity_tpu.api import _dispatch_step
    from softbodyunity_tpu.models import presets

    host, cfg = presets.build(preset)
    top, state = api.init(host)
    state = api.ensure_tear_state(top, cfg, state)
    state = api.ensure_plastic_state(top, cfg, state)
    state = api.ensure_shapematch_state(top, cfg, state)

    def make_run(n_substeps):
        @jax.jit
        def run(top, state):
            return jnp.mean(_dispatch_step(top, cfg, state, cfg.dt, n_substeps).x)

        return run

    return _marginal_throughput(make_run, (top, state), small, big, 1)


def bench_batch_1024():
    """env-steps/sec, 1024 vmapped self-colliding scenes."""
    jax = _setup_jax()
    import numpy as np
    import jax.numpy as jnp

    from softbodyunity_tpu import api
    from softbodyunity_tpu.models import presets
    from softbodyunity_tpu.parallel import batch
    from softbodyunity_tpu.solver import step as step_mod

    host, cfg = presets.build("cloth_batch_rl")
    top, state = api.init(host)
    b = 1024
    rng = np.random.default_rng(0)
    jitter = (0.01 * rng.standard_normal((b, 3))).astype(np.float32)
    states = batch.batch_state(state, b, jitter=jitter)

    # differencing over the INNER substep-scan length; env-step =
    # n_substeps inner substeps, so env-steps/s = b / (n_substeps *
    # t_per_substep)
    def make_run(n_substeps):
        @jax.jit
        def run(top, states):
            fn = lambda s: step_mod.step_scan(top, cfg, s, cfg.dt, n_substeps)
            ss = jax.vmap(fn)(states)
            return jnp.mean(ss.x)

        return run

    per_substep_batch = 1.0 / _marginal_throughput(
        make_run, (top, states), cfg.n_substeps, 5 * cfg.n_substeps, 1
    )
    return b / (cfg.n_substeps * per_substep_batch)


def bench_coupled_batch():
    """env-steps/sec, 1024 vmapped COUPLED scenes: each cloth carries its
    own dynamic rigid ball with spin (solver/rigid.py), momentum exchanged
    in-substep on-device."""
    jax = _setup_jax()
    import numpy as np
    import jax.numpy as jnp

    from softbodyunity_tpu import api
    from softbodyunity_tpu.models import presets
    from softbodyunity_tpu.parallel import batch
    from softbodyunity_tpu.solver.rigid import (
        make_rigid_state,
        step_coupled_scan,
    )

    host, cfg = presets.build("cloth_hanging_sphere")
    top, state = api.init(host)
    b = 1024
    rng = np.random.default_rng(0)
    jitter = (0.01 * rng.standard_normal((b, 3))).astype(np.float32)
    states = batch.batch_state(state, b, jitter=jitter)
    rigid = make_rigid_state(top, [0.5])
    rigids = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (b,) + a.shape), rigid)

    def make_run(n_substeps):
        @jax.jit
        def run(top, states, rigids):
            fn = lambda s, r: step_coupled_scan(top, cfg, s, r, cfg.dt,
                                                n_substeps)
            ss, rr = jax.vmap(fn)(states, rigids)
            return jnp.mean(ss.x) + jnp.mean(rr.centers)

        return run

    per_substep_batch = 1.0 / _marginal_throughput(
        make_run, (top, states, rigids), cfg.n_substeps, 5 * cfg.n_substeps, 1
    )
    return b / (cfg.n_substeps * per_substep_batch)


def bench_grad_64k():
    """Fwd+backward substeps/sec, 64k cloth, stencil path.  One unit = one
    substep differentiated end-to-end (jax.grad of a scalar of the final
    state w.r.t. initial positions+velocities)."""
    jax = _setup_jax()
    import jax.numpy as jnp

    from softbodyunity_tpu import api
    from softbodyunity_tpu.kernels.stencil import make_stencil_step
    from softbodyunity_tpu.models import presets

    host, cfg = presets.build("cloth_bench_64k")
    top, state = api.init(host)
    step = make_stencil_step(top, cfg)

    def make_run(n_substeps):
        def loss(x, v):
            s2 = step(state.replace(x=x, v=v), cfg.dt, n_substeps)
            return jnp.mean(s2.x)

        g = jax.grad(loss, argnums=(0, 1))
        return jax.jit(lambda t, st: jnp.mean(g(st.x, st.v)[0]))

    return _marginal_throughput(make_run, (top, state), 8, 72, 1)


def bench_selfcollide_64k():
    """Substeps/sec, 64k single-scene self-colliding cloth.  Also asserts
    the partner budget is exact at the measured state: dropped_pairs == 0
    proves the block-sparse pair set equals the dense rule."""
    _setup_jax()

    from softbodyunity_tpu import api
    from softbodyunity_tpu.api import _dispatch_step
    from softbodyunity_tpu.models import presets
    from softbodyunity_tpu.solver.blocksparse import (
        self_collision_block_diagnostics,
    )

    v = _bench_preset_substeps("cloth_selfcollide_64k", 4, 24)
    host, cfg = presets.build("cloth_selfcollide_64k")
    top, state = api.init(host)
    state = _dispatch_step(top, cfg, state, cfg.dt, 24)
    d = self_collision_block_diagnostics(state.x, cfg.self_collision)
    dropped = int(d["dropped_pairs"])
    if dropped:
        raise RuntimeError(
            f"sc64k partner budget overflow: {dropped} dropped tile pairs "
            f"(raise SelfCollisionParams.block_partners)"
        )
    _log(f"sc64k exactness: dropped_pairs=0 "
         f"(candidates={int(d['candidate_pairs'])})")
    return v


# part -> (preset, small, big substep counts of the marginal measurement);
# wide spreads where the rate is high, so the delta clears the noise
_PRESET_PARTS = {
    "64k": ("cloth_bench_64k", 16, 1616),
    "cube": ("softbody_cube_64k", 8, 160),
    "xpbd64k": ("cloth_bench_64k_xpbd", 8, 160),
    "verlet64k": ("cloth_bench_64k_verlet", 16, 1616),
    "1m": ("cloth_bench_1m", 8, 64),
    "262k": ("cloth_bench_262k", 8, 520),
    "sc16k": ("cloth_selfcollide_16k", 8, 64),
    "cubeverlet": ("softbody_cube_64k_verlet", 8, 160),
    "voxsphere": ("voxel_sphere_50k", 8, 160),
    "cubexpbd": ("softbody_cube_64k_xpbd", 4, 32),
    # 1 Jacobi iteration per substep: the substep-instead-of-iterate
    # lever (Macklin et al. 2019)
    "cubexpbdsub": ("softbody_cube_64k_xpbd_sub", 8, 160),
    "strain64k": ("cloth_strain_64k", 8, 408),
    "jelly50k": ("jelly_voxel_50k", 8, 248),
    "tear64k": ("cloth_tearing_64k", 8, 1208),
    "plastic64k": ("cloth_plastic_64k", 8, 808),
    "tear262k": ("cloth_tearing_262k", 8, 520),
    "plastic262k": ("cloth_plastic_262k", 8, 520),
    "wind64k": ("cloth_wind_64k", 8, 808),
}

_PARTS = {
    part: (lambda a=args: _bench_preset_substeps(*a))
    for part, args in _PRESET_PARTS.items()
}
_PARTS.update({
    "batch": bench_batch_1024,
    "coupled": bench_coupled_batch,
    "grad64k": bench_grad_64k,
    "sc64k": bench_selfcollide_64k,
})

# secondary parts, in the order they run; the heavy 262k tier closes
_SECONDARY_ORDER = [
    ("batch", "env_steps_per_sec_1024_scenes"),
    ("coupled", "env_steps_per_sec_1024_coupled_rigid"),
    ("cubexpbdsub", "substeps_per_sec_64k_tet_cube_xpbd_substep"),
    ("cubexpbd", "substeps_per_sec_64k_tet_cube_xpbd"),
    ("strain64k", "substeps_per_sec_64k_strain_limited"),
    ("jelly50k", "substeps_per_sec_jelly_voxel_50k"),
    ("cubeverlet", "substeps_per_sec_64k_tet_cube_verlet"),
    ("grad64k", "substeps_per_sec_64k_backward_stencil"),
    ("voxsphere", "substeps_per_sec_voxel_sphere_97k_raster"),
    ("cube", "substeps_per_sec_64k_tet_cube"),
    ("xpbd64k", "substeps_per_sec_64k_xpbd"),
    ("1m", "substeps_per_sec_1m_cloth"),
    ("verlet64k", "substeps_per_sec_64k_verlet"),
    ("tear64k", "substeps_per_sec_64k_tearing"),
    ("plastic64k", "substeps_per_sec_64k_plastic"),
    ("wind64k", "substeps_per_sec_64k_wind"),
    ("sc16k", "substeps_per_sec_16k_selfcollide"),
    ("sc64k", "substeps_per_sec_64k_selfcollide"),
    ("262k", "substeps_per_sec_262k_cloth"),
    ("tear262k", "substeps_per_sec_262k_tearing"),
    ("plastic262k", "substeps_per_sec_262k_plastic"),
]


def _run_child(parts, timeout: float) -> dict:
    """Run parts in ONE child process; returns {part: float | error
    string}, plus "device" when the child got that far.  Parts the child
    never reached (crash / timeout) are absent."""
    try:
        out = subprocess.run(
            [sys.executable, __file__, "--part", ",".join(parts)],
            capture_output=True, text=True, timeout=timeout,
        )
        lines = out.stdout.strip().splitlines()
    except subprocess.TimeoutExpired as e:
        raw = e.stdout or ""
        lines = (raw.decode() if isinstance(raw, bytes) else raw
                 ).strip().splitlines()
    res = {}
    for line in lines:
        key, _, val = line.partition("=")
        if key == "device":
            res["device"] = json.loads(val)
        elif key in parts:
            res[key] = val if val.startswith("ERROR:") else float(val)
    return res


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--part":
        # child mode: one process, parts in order, one line each; one part
        # failing must not kill the rest
        _setup_jax()
        print(f"device={json.dumps(_device())}", flush=True)
        for part in sys.argv[2].split(","):
            try:
                print(f"{part}={_PARTS[part]()}", flush=True)
            except Exception as e:  # noqa: BLE001 - recorded per part
                print(f"{part}=ERROR:{e!r:.300}", flush=True)
        return
    # the internal deadline sits below an external wrapper's kill point,
    # and a complete JSON line is printed after every part
    deadline = time.monotonic() + float(
        os.environ.get("BENCH_DEADLINE_SECS", 1700.0))
    record = {"metric": "substeps/sec (64k-vertex cloth, one device)",
              "value": None, "unit": "substeps/s", "device": None,
              "secondary": {}}
    failures = {}

    def emit():
        out = dict(record)
        if failures:
            out["failures"] = failures
        print(json.dumps(out), flush=True)

    groups = [[("64k", None)]] + [
        _SECONDARY_ORDER[i:i + 2] for i in range(0, len(_SECONDARY_ORDER), 2)]
    for group in groups:
        parts = [p for p, _ in group]
        remaining = deadline - time.monotonic()
        if remaining < 90.0:
            for part in parts:
                failures[part] = "skipped: global deadline"
            continue
        _log(f"bench: {'+'.join(parts)} ...")
        res = _run_child(parts, max(120.0, min(600.0, remaining - 30.0)))
        record["device"] = record["device"] or res.get("device")
        kind = (record["device"] or {}).get("kind")
        for part, key in group:
            val = res.get(part)
            if isinstance(val, float):
                if key is None:
                    record["value"] = round(val, 1)
                else:
                    record["secondary"][key] = round(val, 1)
                _log(f"bench: {part} {val:,.1f} /s on {kind}")
            else:
                if key is not None:
                    record["secondary"][key] = None
                failures[part] = (val or "no output (timeout/crash)")[:500]
                _log(f"bench: {part} FAILED on {kind}")
        emit()


if __name__ == "__main__":
    main()
