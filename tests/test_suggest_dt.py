"""api.suggest_dt: the explicit-integration stability helper (Gershgorin
bound on the spring network's stiffest mode; PERF.md records the silent
frame-12 NaN blow-up this prevents)."""

import numpy as np

from softbodyunity_tpu import api
from softbodyunity_tpu.core.topology import rope
from softbodyunity_tpu.models import presets


def test_scaling_ordering():
    """Finer grids (half spacing/mass) must get tighter suggestions —
    the failure the 512^2/1M presets once shipped with."""
    host64, cfg64 = presets.build("cloth_bench_64k")
    host262, cfg262 = presets.build("cloth_bench_262k")
    assert api.suggest_dt(host262, cfg262) < api.suggest_dt(host64, cfg64)
    # and both hand-tuned dts sit at or below the raw 2/omega bound
    assert cfg64.dt < api.suggest_dt(host64, cfg64) / 0.35
    assert cfg262.dt < api.suggest_dt(host262, cfg262) / 0.35


def test_suggested_dt_is_stable():
    """Simulating AT the suggestion stays finite where 2x the Gershgorin
    bound visibly diverges (vmax growth)."""
    host, cfg = presets.build("softbody_cube")
    dt = api.suggest_dt(host, cfg)
    top, state = api.init(host)
    s = state
    for _ in range(12):
        s = api.step(top, cfg, s, dt=dt, n_substeps=8)
    assert np.isfinite(np.asarray(s.x)).all()
    # far past the raw bound: the same scene diverges
    s = state
    for _ in range(12):
        s = api.step(top, cfg, s, dt=dt / 0.35 * 2.5, n_substeps=8)
    v = np.asarray(s.v)
    assert (not np.isfinite(v).all()) or np.abs(v).max() > 1e3


def test_edge_cases():
    host, cfg = presets.build("cloth_32_euler")
    # all-pinned scene: no dynamic mode, fall back to cfg.dt
    host.inv_mass[:] = 0.0
    assert api.suggest_dt(host, cfg) == cfg.dt
    # rope with free ends still returns a positive finite dt
    h = rope(8, pinned=())
    dt = api.suggest_dt(h, cfg)
    assert 0 < dt < 1.0
