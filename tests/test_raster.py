"""Rasterizer correctness: the deferred walk vs direct per-pixel oracle, fill-rule
adjacency (each boundary pixel covered exactly once), reversed-Z depth
semantics, and binned-vs-full-bin equivalence.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_renderer.kernels import raster
from tpu_renderer.kernels.vertex import triangle_setup

W, H = 128, 64  # one tile column, two tile rows (tile 32x128)
TILE_H, TILE_W = 32, 128
TILES_X, TILES_Y = W // TILE_W, H // TILE_H


def setup_from_screen(tris, zs):
    """Build TriangleSetup from screen-space pixel coords.

    tris: (T,3,2) pixel coords; zs: (T,3) NDC depth per corner.
    Identity viewproj, w=1: positions are NDC directly.
    """
    tris = np.asarray(tris, np.float32)
    zs = np.asarray(zs, np.float32)
    T = tris.shape[0]
    ndc = np.empty((T, 3, 3), np.float32)
    ndc[..., 0] = tris[..., 0] / W * 2 - 1
    ndc[..., 1] = tris[..., 1] / H * 2 - 1
    ndc[..., 2] = zs
    positions = ndc.reshape(-1, 3)
    tri_vidx = np.arange(T * 3, dtype=np.int32).reshape(T, 3)
    V = T * 3
    return triangle_setup(
        jnp.asarray(positions),
        jnp.zeros((V, 3), jnp.float32),
        jnp.ones((V, 4), jnp.float32),
        jnp.zeros((V, 2), jnp.float32),
        jnp.asarray(tri_vidx),
        jnp.zeros((T,), jnp.int32),
        jnp.ones((T,), bool),
        jnp.eye(4, dtype=jnp.float32)[None],
        jnp.ones((1,), bool),
        jnp.zeros((1,), jnp.int32),
        jnp.ones((1, 4), jnp.float32),
        jnp.eye(4, dtype=jnp.float32),
        W,
        H,
    )


def run_full(setup):
    packed, aabb, _ = raster.pad_for_raster(setup.packed, setup.aabb, setup.valid)
    T = packed.shape[0]
    bins, counts = raster.full_bins(T, TILES_X * TILES_Y, T)
    return raster.rasterize(
        packed, bins, counts,
        tiles_x=TILES_X, tiles_y=TILES_Y, tile_w=TILE_W, tile_h=TILE_H,
    )


def test_single_triangle_matches_oracle():
    setup = setup_from_screen(
        [[[10, 5], [100, 20], [40, 60]]], [[0.5, 0.5, 0.5]]
    )
    z, tid = run_full(setup)
    z_ref, tid_ref = raster.rasterize_reference(setup.packed, W, H)
    np.testing.assert_array_equal(np.asarray(tid), tid_ref)
    np.testing.assert_allclose(np.asarray(z), z_ref, atol=1e-6)
    assert (np.asarray(tid) == 0).sum() > 100  # it actually drew something


def test_random_triangles_match_oracle():
    rng = np.random.default_rng(7)
    T = 12
    tris = rng.uniform([-20, -20], [W + 20, H + 20], size=(T, 3, 2))
    zs = rng.uniform(0.05, 0.95, size=(T, 3))
    setup = setup_from_screen(tris, zs)
    z, tid = run_full(setup)
    z_ref, tid_ref = raster.rasterize_reference(setup.packed, W, H)
    np.testing.assert_array_equal(np.asarray(tid), tid_ref)
    np.testing.assert_allclose(np.asarray(z), z_ref, atol=1e-5)


def test_adjacent_triangles_cover_each_pixel_exactly_once():
    # A quad split along its diagonal; rasterize each half alone and check
    # the coverage masks partition the quad (top-left fill rule).
    quad = [[5.0, 5.0], [120.0, 5.0], [120.0, 60.0], [5.0, 60.0]]
    t0 = [quad[0], quad[1], quad[2]]
    t1 = [quad[0], quad[2], quad[3]]
    masks = []
    for t in (t0, t1):
        setup = setup_from_screen([t], [[0.5, 0.5, 0.5]])
        _, tid = run_full(setup)
        masks.append(np.asarray(tid) >= 0)
    both = masks[0].astype(int) + masks[1].astype(int)
    assert both.max() <= 1, "diagonal pixels covered twice"
    # strict interior of the quad is fully covered
    ys, xs = np.mgrid[0:H, 0:W]
    interior = (xs + 0.5 > 5) & (xs + 0.5 < 120) & (ys + 0.5 > 5) & (ys + 0.5 < 60)
    assert (both[interior] == 1).all(), "hole on the shared edge"


def test_reversed_z_nearer_wins_and_equal_z_later_wins():
    tri = [[10, 5], [100, 20], [40, 60]]
    # z=0.8 is nearer than z=0.2 under reversed-Z
    setup = setup_from_screen([tri, tri], [[0.2] * 3, [0.8] * 3])
    _, tid = run_full(setup)
    covered = np.asarray(tid)[np.asarray(tid) >= 0]
    assert (covered == 1).all()
    # swap order: nearer drawn first still wins
    setup = setup_from_screen([tri, tri], [[0.8] * 3, [0.2] * 3])
    _, tid = run_full(setup)
    covered = np.asarray(tid)[np.asarray(tid) >= 0]
    assert (covered == 0).all()
    # equal z: later triangle wins (GREATER_OR_EQUAL passes on equal)
    setup = setup_from_screen([tri, tri], [[0.5] * 3, [0.5] * 3])
    _, tid = run_full(setup)
    covered = np.asarray(tid)[np.asarray(tid) >= 0]
    assert (covered == 1).all()


def test_z_outside_01_is_clipped():
    setup = setup_from_screen(
        [[[10, 5], [100, 20], [40, 60]]], [[1.5, 1.5, 1.5]]
    )
    _, tid = run_full(setup)
    assert (np.asarray(tid) == -1).all()


def test_binned_matches_full():
    rng = np.random.default_rng(3)
    T = 10
    tris = rng.uniform([0, 0], [W, H], size=(T, 3, 2))
    zs = rng.uniform(0.1, 0.9, size=(T, 3))
    setup = setup_from_screen(tris, zs)
    z_full, tid_full = run_full(setup)
    packed, aabb, valid = raster.pad_for_raster(setup.packed, setup.aabb, setup.valid)
    caabb, cvalid = raster.chunk_aabbs(aabb, valid)
    cbins, _, overflow = raster.bin_triangles(
        caabb, cvalid,
        tiles_x=TILES_X, tiles_y=TILES_Y, tile_w=TILE_W, tile_h=TILE_H,
        bin_cap=16,
    )
    assert int(overflow) == 0
    bins, counts, overflow2 = raster.refine_bins(
        cbins, aabb, tiles_x=TILES_X, tiles_y=TILES_Y, tile_w=TILE_W,
        tile_h=TILE_H, tri_cap=32)
    assert int(overflow2) == 0
    # refined bins are tight: no tile sees more than the real triangles
    assert int(counts.max()) <= T
    z_b, tid_b = raster.rasterize(
        packed, bins, counts,
        tiles_x=TILES_X, tiles_y=TILES_Y, tile_w=TILE_W, tile_h=TILE_H,
    )
    np.testing.assert_array_equal(np.asarray(tid_b), np.asarray(tid_full))
    np.testing.assert_allclose(np.asarray(z_b), np.asarray(z_full), atol=1e-6)


def test_kernel_knob_config_roundtrip():
    """config.py is the single source of truth for the kernel knobs;
    RASTER_* env vars OVERRIDE it (conftest pins RASTER_CHUNK=8 for the CPU
    tier — applying the production config must not displace that)."""
    from tpu_renderer.config import RendererConfig

    assert raster.CHUNK == 8  # the conftest env override is active here
    cfg = RendererConfig()
    assert cfg.raster_chunk == 32  # production default
    raster.configure(chunk=cfg.raster_chunk, group=cfg.raster_group,
                     sort=cfg.raster_sort)
    assert raster.CHUNK == 8, "env override must win over config"
    assert raster.GROUP == min(cfg.raster_group, raster.CHUNK)
    assert raster.N_GROUPS * raster.GROUP == raster.CHUNK
    assert raster.ENTRY_GMASK_ALL == (1 << raster.N_GROUPS) - 1


@pytest.mark.slow
def test_kernel_knob_config_applies_without_env():
    """Without the env override, raster.configure takes the config value
    (subprocess: the conftest env must not leak in)."""
    import subprocess
    import sys

    code = (
        "import os\n"
        "for k in ('RASTER_CHUNK', 'RASTER_GROUP', 'RASTER_SORT'):\n"
        "    os.environ.pop(k, None)\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "from tpu_renderer.kernels import raster\n"
        "assert raster.CHUNK == 32, raster.CHUNK\n"
        "raster.configure(chunk=16, group=4, sort='morton')\n"
        "assert raster.CHUNK == 16\n"
        "assert raster.GROUP == 4 and raster.N_GROUPS == 4\n"
        "assert raster.SORT_MODE == 'morton'\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in __import__('os').environ.items()
           if not k.startswith('RASTER_')}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ok" in out.stdout
