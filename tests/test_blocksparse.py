"""Block-sparse self-collision vs the dense oracle rule (SURVEY.md C12 at
scale; VERDICT r1 #2)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbodyunity_tpu.core.config import SelfCollisionParams
from softbodyunity_tpu.solver.blocksparse import (
    BLOCK,
    self_collision_block_diagnostics,
    self_collision_forces_block,
)
from softbodyunity_tpu.solver.forces import self_collision_forces_dense


def _params(**kw):
    base = dict(
        enabled=True, method="block", radius=0.05, stiffness=10.0,
        cell_size=0.05, block_partners=16,
    )
    base.update(kw)
    return SelfCollisionParams(**base)


# 500 / 1000: non-multiples of the tile size exercise padding; 2048:
# multi-tile; block_size=128 covers the tunable tile size
@pytest.mark.parametrize("n,blk", [(100, BLOCK), (500, BLOCK),
                                   (1000, BLOCK), (2048, BLOCK),
                                   (1000, 128), (2048, 128)])
def test_block_matches_dense_random_cloud(n, blk):
    rng = np.random.default_rng(n)
    # a dense-ish cloud with plenty of contacts
    x = jnp.asarray(rng.uniform(0, 0.5, (n, 3)).astype(np.float32))
    p = _params(block_partners=-(-n // blk), block_size=blk)  # full budget
    diag = self_collision_block_diagnostics(x, p)
    assert int(diag["dropped_pairs"]) == 0
    f_blk = self_collision_forces_block(x, p)
    f_dns = self_collision_forces_dense(x, p.radius, p.stiffness)
    np.testing.assert_allclose(
        np.asarray(f_blk), np.asarray(f_dns), atol=5e-4, rtol=1e-4
    )


def test_block_matches_dense_folded_cloth():
    """Parity on a REAL folded configuration: a cloth sheet bent into three
    stacked layers (the workload the method exists for)."""
    n_side = 48
    xs, ys = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    u = xs.ravel() * 0.01
    # fold the strip back over itself twice in y, layers 0.004 apart
    layer = (ys.ravel() * 0.01 // 0.16).astype(int)
    yy = np.where(layer % 2 == 0, ys.ravel() * 0.01 % 0.16,
                  0.16 - ys.ravel() * 0.01 % 0.16)
    x = np.stack([u, yy, layer * 0.004], axis=1).astype(np.float32)
    x = jnp.asarray(x)
    p = _params(radius=0.006, cell_size=0.012, block_partners=16)
    diag = self_collision_block_diagnostics(x, p)
    assert int(diag["dropped_pairs"]) == 0
    f_blk = self_collision_forces_block(x, p)
    f_dns = self_collision_forces_dense(x, p.radius, p.stiffness)
    assert float(jnp.abs(f_dns).max()) > 0.0  # layers actually interact
    np.testing.assert_allclose(
        np.asarray(f_blk), np.asarray(f_dns), atol=5e-4, rtol=1e-4
    )


def test_block_overflow_counted_not_silent():
    # everything piled into one spot with a starved partner budget
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(0, 0.02, (4 * BLOCK, 3)).astype(np.float32))
    p = _params(block_partners=1)
    diag = self_collision_block_diagnostics(x, p)
    assert int(diag["dropped_pairs"]) > 0


def test_block_forces_vmappable():
    rng = np.random.default_rng(1)
    xs = jnp.asarray(rng.uniform(0, 0.3, (3, 400, 3)).astype(np.float32))
    p = _params(block_partners=2)
    f = jax.vmap(lambda x: self_collision_forces_block(x, p))(xs)
    assert f.shape == (3, 400, 3)
    assert bool(jnp.isfinite(f).all())


def test_hash_overflow_counter():
    from softbodyunity_tpu.solver.hashgrid import hash_overflow_count

    p = SelfCollisionParams(enabled=True, radius=0.05, cell_size=0.05,
                            grid_dim=16, max_per_cell=4)
    # one vertex per distinct cell: run lengths are all 1
    ii = np.arange(64)
    spread = jnp.asarray(np.stack(
        [(ii % 4 + 0.5) * 0.05, (ii // 4 % 4 + 0.5) * 0.05,
         (ii // 16 + 0.5) * 0.05], axis=1).astype(np.float32))
    assert int(hash_overflow_count(spread, p)) == 0
    piled = jnp.zeros((64, 3), jnp.float32)  # 64 verts in one cell
    assert int(hash_overflow_count(piled, p)) == 64


def test_16k_preset_steps_finite():
    """The shipping 16k block-sparse preset runs through api.step."""
    from softbodyunity_tpu import api
    from softbodyunity_tpu.models import presets

    host, cfg = presets.build("cloth_selfcollide_16k")
    top, state = api.init(host)
    for _ in range(3):
        state = api.step(top, cfg, state, n_substeps=2)
    assert bool(jnp.isfinite(state.x).all())


@pytest.mark.slow
def test_block_matches_dense_16k_folded():
    """Pair-set parity at the 16k preset scale on a folded configuration
    (128x128 sheet bent into stacked layers at the preset's radius) — the
    dense O(N^2) reference is 268M pairs, evaluated once."""
    from softbodyunity_tpu.models import presets

    _, cfg = presets.build("cloth_selfcollide_16k")
    p = cfg.self_collision
    n_side = 128
    xs, ys = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    u = xs.ravel() * 0.01
    span = 0.32
    layer = (ys.ravel() * 0.01 // span).astype(int)
    yy = np.where(layer % 2 == 0, ys.ravel() * 0.01 % span,
                  span - ys.ravel() * 0.01 % span)
    x = jnp.asarray(np.stack(
        [u, yy, layer * (p.radius * 0.75)], axis=1).astype(np.float32))
    diag = self_collision_block_diagnostics(x, p)
    assert int(diag["dropped_pairs"]) == 0, "partner budget too small"
    f_blk = self_collision_forces_block(x, p)
    f_dns = self_collision_forces_dense(x, p.radius, p.stiffness)
    assert float(jnp.abs(f_dns).max()) > 0.0  # layers actually interact
    np.testing.assert_allclose(
        np.asarray(f_blk), np.asarray(f_dns), atol=1e-3, rtol=1e-3
    )


def _cloud(n, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    return jnp.asarray(rng.uniform(0, 0.5, (n, 3)).astype(np.float32))


# the GPU pair kernel (kernels/block_pairs.py) in interpret mode; 500 is
# not a multiple of the 256-vertex tile, 2048 is
@pytest.mark.parametrize("n", [500, 2048])
def test_block_pallas_matches_jnp_twin(n):
    from softbodyunity_tpu.kernels.block_pairs import forces_block_kernel

    x = _cloud(n)
    p = _params(block_partners=min(8, -(-n // BLOCK)))
    f_jnp = self_collision_forces_block(x, p)
    f_pal = forces_block_kernel(x, p, True)
    np.testing.assert_allclose(
        np.asarray(f_pal), np.asarray(f_jnp), atol=5e-4, rtol=1e-3
    )


@pytest.mark.parametrize("n,blk", [(300, BLOCK), (1000, BLOCK),
                                   (1024, 128), (1000, 128)])
def test_block_pallas_matches_dense(n, blk):
    from softbodyunity_tpu.kernels.block_pairs import forces_block_kernel

    x = _cloud(n)
    p = _params(block_partners=-(-n // blk), block_size=blk)
    assert int(self_collision_block_diagnostics(x, p)["dropped_pairs"]) == 0
    f_pal = forces_block_kernel(x, p, True)
    f_dns = self_collision_forces_dense(x, p.radius, p.stiffness)
    np.testing.assert_allclose(
        np.asarray(f_pal), np.asarray(f_dns), atol=5e-4, rtol=1e-4
    )


@pytest.mark.parametrize("n,split", [(500, 3), (2048, 4)])
def test_block_pallas_dual_matches_twin(n, split):
    from softbodyunity_tpu.kernels.block_pairs import forces_block_dual_kernel
    from softbodyunity_tpu.solver.blocksparse import (
        self_collision_forces_block_dual)

    x = _cloud(n)
    p = _params(block_partners=-(-n // BLOCK))
    for part in range(split):                 # each device's row block
        xi = x[part * n // split:(part + 1) * n // split]
        f_twin = self_collision_forces_block_dual(xi, x, p)
        f_pal = forces_block_dual_kernel(xi, x, p, True)
        np.testing.assert_allclose(
            np.asarray(f_pal), np.asarray(f_twin), atol=5e-4, rtol=1e-3
        )


def test_block_pallas_tiles_without_partners():
    """A tile whose partner count is 0 gets exactly zero force; the
    others are untouched."""
    from softbodyunity_tpu.kernels import block_pairs

    x = _cloud(1024)
    p = _params(block_partners=4)
    xt, _, nvalid, partners, _ = block_pairs._tiles_and_partners(x, x, p)
    kw = dict(radius=p.radius, stiffness=p.stiffness, interpret=True)
    full = block_pairs.block_pairs(xt, xt, nvalid, partners, **kw)
    cut = nvalid.at[1].set(0).at[3].set(0)
    part = block_pairs.block_pairs(xt, xt, cut, partners, **kw)
    assert float(jnp.abs(full[1]).max()) > 0.0
    np.testing.assert_array_equal(np.asarray(part[1]), 0.0)
    np.testing.assert_array_equal(np.asarray(part[3]), 0.0)
    np.testing.assert_array_equal(np.asarray(part[0]), np.asarray(full[0]))
    np.testing.assert_array_equal(np.asarray(part[2]), np.asarray(full[2]))


@pytest.mark.parametrize("form", ["single", "dual"])
def test_block_pallas_grad_matches_twin(form):
    """``jax.grad`` through the kernel runs the twin's VJP."""
    from softbodyunity_tpu.kernels import block_pairs
    from softbodyunity_tpu.solver.blocksparse import (
        self_collision_forces_block_dual)

    x = _cloud(600)
    p = _params(block_partners=3)
    w = jnp.asarray(np.random.default_rng(1).normal(size=(600, 3)),
                    jnp.float32)
    if form == "single":
        kern = lambda y: block_pairs.forces_block_kernel(y, p, True)
        twin = lambda y: self_collision_forces_block(y, p)
    else:
        kern = lambda y: block_pairs.forces_block_dual_kernel(
            y[:200], y, p, True)
        twin = lambda y: self_collision_forces_block_dual(y[:200], y, p)
    g_k = jax.grad(lambda y: jnp.sum(kern(y) * w[:kern(y).shape[0]]))(x)
    g_t = jax.grad(lambda y: jnp.sum(twin(y) * w[:twin(y).shape[0]]))(x)
    assert float(jnp.abs(g_t).max()) > 0.0
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_t),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("rows,cols", [(16, 256), (64, 64), (32, 128)])
def test_block_kernel_lowers_for_cuda(rows, cols):
    """The kernel lowers through the Triton route for the card (the
    lowering runs here; only compiling the Triton IR needs the GPU)."""
    from softbodyunity_tpu.kernels import block_pairs

    x = _cloud(1024)
    p = _params(block_partners=4)
    xt, _, nvalid, partners, _ = block_pairs._tiles_and_partners(x, x, p)
    fn = jax.jit(lambda a, b, c: block_pairs.block_pairs(
        a, a, b, c, radius=p.radius, stiffness=p.stiffness, rows=rows,
        cols=cols))
    text = fn.trace(xt, nvalid, partners).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "self_collision_block_pairs" in text


@pytest.mark.parametrize("rows,cols", [(16, 256), (32, 128), (64, 64)])
def test_block_pallas_launch_shapes_agree(rows, cols):
    """Every launch shape of the sweep computes the same forces."""
    from softbodyunity_tpu.kernels import block_pairs

    x = _cloud(1024)
    p = _params(block_partners=4)
    xt, _, nvalid, partners, _ = block_pairs._tiles_and_partners(x, x, p)
    kw = dict(radius=p.radius, stiffness=p.stiffness, interpret=True)
    ref = block_pairs.block_pairs(xt, xt, nvalid, partners, **kw)
    got = block_pairs.block_pairs(xt, xt, nvalid, partners, rows=rows,
                                  cols=cols, **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_block_pallas_rejects_odd_block_size():
    from softbodyunity_tpu.kernels.block_pairs import forces_block_kernel

    p = _params(block_partners=2, block_size=96)
    with pytest.raises(ValueError, match="power of two"):
        forces_block_kernel(_cloud(300), p, True)


def test_block_kernel_compiled_on_gpu(gpu):
    """The compiled kernel (no interpret mode) against the twin."""
    from softbodyunity_tpu.kernels.block_pairs import forces_block_kernel

    x = _cloud(2048)
    p = _params(block_partners=8)
    np.testing.assert_allclose(
        np.asarray(forces_block_kernel(x, p)),
        np.asarray(self_collision_forces_block(x, p)), atol=5e-4, rtol=1e-3)


def test_64k_preset_builds_and_steps():
    from softbodyunity_tpu import api
    from softbodyunity_tpu.models import presets

    host, cfg = presets.build("cloth_selfcollide_64k")
    top, state = api.init(host)
    # flat sheet: the 0.32 sort cell keeps tiles compact => zero drops
    d = self_collision_block_diagnostics(state.x, cfg.self_collision)
    assert int(d["dropped_pairs"]) == 0
    # stepping immediately pools the sub-plane cloth into a pile (the
    # self-contact driver of this scene); drops there are the documented,
    # counted soft-truncation — just require stability
    state = api.step(top, cfg, state, n_substeps=2)
    assert bool(jnp.isfinite(state.x).all())
