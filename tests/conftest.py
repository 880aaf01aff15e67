"""Test harness config: run everything on the CPU with 8 virtual devices,
so batching and sharding tests need no accelerator (SURVEY.md §4
"Multi-device without a cluster").  Tests marked ``gpu`` need the card
and skip here; ``python chip_smoke.py`` runs the same checks on it.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

from softbodyunity_tpu.utils.cache import enable_compile_cache  # noqa: E402

# persistent compile cache: successive pytest runs skip recompilation
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_sessionstart(session):
    assert jax.devices()[0].platform == "cpu", "tests must run on CPU"
    assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided here, at run
    time, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run on the card with python chip_smoke.py")


@pytest.fixture
def f64_oracle_run():
    """``run(host, cfg, n_frames) -> (device State, oracle x, oracle
    extras)``: the device path that ``api.step`` picks for ``cfg``, in
    float64, beside the float64 oracle on the same scene.  ``extras``
    holds the oracle's ``alive`` / ``rest_scale`` / ``quats`` where the
    config carries them."""
    from softbodyunity_tpu import api
    from softbodyunity_tpu.oracle import reference as oracle

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)

    def run(host, cfg, n_frames):
        top, s = api.init(host, dtype=jax.numpy.float64)
        x = host.positions0.copy()
        v = np.zeros_like(x)
        xp = x.copy()
        extras = {}
        if cfg.tear.enabled:
            extras["alive"] = np.ones(host.edges.shape[0])
        if cfg.plasticity.enabled:
            extras["rest_scale"] = np.ones(host.edges.shape[0])
        if oracle._shape_match_enabled(host, cfg):
            extras["quats"] = np.tile([1.0, 0.0, 0.0, 0.0],
                                      (host.n_clusters, 1))
        for _ in range(n_frames):
            out = oracle.step(host, cfg, x, v, xp, **extras)
            x, v, xp = out[:3]
            extras = dict(zip(extras, out[3:]))
            s = api.step(top, cfg, s)
        return s, x, extras

    yield run
    jax.config.update("jax_enable_x64", prev)
