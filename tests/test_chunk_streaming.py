"""The chunk-bin walks (rasterize_chunks / accumulate_chunks / peel_chunks)
must match the capped deferred path's per-triangle walks and the plain XLA
walk exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

# interpret-mode walks over many chunks dominate the suite runtime
pytestmark = pytest.mark.slow

from tpu_renderer import milestones
from tpu_renderer.kernels import raster, shade, vertex
from tpu_renderer.scene import flatten_scene

I4 = jnp.eye(4, dtype=jnp.float32)
# CHUNK_TEST_TILES shrinks the tile grid for the RASTER_CHUNK=32 subprocess
# tier (tests/test_chunk32.py): interpret-mode execution scales with
# n_tiles x entries x CHUNK, and a single tile still walks every code path.
import os as _os
TX, TY = (int(x) for x in _os.environ.get("CHUNK_TEST_TILES", "2,2").split(","))
KW = dict(tiles_x=TX, tiles_y=TY, tile_w=128, tile_h=32)


def _setup(scene):
    flat = flatten_scene(scene)
    b = flat.buffers
    vis = vertex.draw_visibility(I4, b.draw_model, b.draw_bounds_origin,
                                 b.draw_bounds_extents)
    s = vertex.triangle_setup(
        b.positions, b.normals, b.colors, b.uvs,
        b.opaque_tri_vidx, b.opaque_tri_draw, b.opaque_tri_valid,
        b.draw_model, vis, b.draw_mat, b.mat_color_factors, I4, 256, 64)
    rows = shade.build_shade_rows(s.packed, s.attrs, b.mat_meta, aabb=s.aabb)
    caabb, cvalid = raster.chunk_aabbs(s.aabb, s.valid)
    cbins, ccounts, _ = raster.bin_triangles(
        caabb, cvalid, bin_cap=max(caabb.shape[0], 8), **KW)
    return s, rows, cbins, ccounts


def _multi_quad_scene(n=7):
    import tpu_renderer.scene as sm

    scene = milestones.colored_quad_scene(z0=0.3, z1=0.9)
    rng = np.random.default_rng(5)
    scene.colors = rng.uniform(0, 1, scene.colors.shape).astype(np.float32)
    for k in range(n):
        node = sm.MeshNode(0, f"q{k}")
        m = np.eye(4, dtype=np.float32)
        m[0, 3] = rng.uniform(-0.5, 0.5)
        m[2, 3] = rng.uniform(-0.2, 0.2)
        node.refresh_transform(m)
        node.local_transform = m
        scene.nodes.append(node)
        scene.top_nodes.append(node)
    return scene


def _packed(cbins):
    """Capped chunk bins -> packed entries with every gmask group live."""
    return jnp.where(cbins >= 0, (cbins << raster.ENTRY_SHIFT)
                     | raster.ENTRY_GMASK_ALL, cbins)


def test_chunk_raster_matches_deferred_raster():
    """The chunk walk over chunk bins and the deferred walk over refined
    per-triangle bins visit each tile's triangles in the same order."""
    s, rows, cbins, ccounts = _setup(_multi_quad_scene())
    bins, counts, _ = raster.refine_bins(cbins, s.aabb, tri_cap=256, **KW)
    z1, t1 = raster.rasterize(s.packed, bins, counts, **KW)
    z2, t2, a2, m2, i2 = raster.rasterize_chunks(rows, _packed(cbins),
                                                 ccounts, **KW)
    np.testing.assert_array_equal(np.asarray(z1), np.asarray(z2))
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
    assert (np.asarray(t2) >= 0).any()


def test_chunk_accum_matches_xla_walk():
    s, rows, cbins, ccounts = _setup(_multi_quad_scene())
    light = jnp.asarray([0.2, 0.8, 0.5, 1.0, 0.1, 0.1, 0.1, 0.0], jnp.float32)
    z = jnp.full((TY * 32, TX * 128), raster.DEPTH_CLEAR, jnp.float32)
    a1, c1 = raster.accumulate_chunks(rows, _packed(cbins), ccounts, z, light,
                                      **KW)
    ar, ag, ab, c2 = raster._walk_xla(
        raster._accum_rule, rows, _packed(cbins), ccounts,
        raster._ACCUM_STATE, (z,), light, chunk=raster.CHUNK, **KW)
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    np.testing.assert_array_equal(np.asarray(a1), np.stack([ar, ag, ab]))
    assert int(c1.max()) > 1


def _full_setup(scene):
    s, rows, cbins, ccounts = _setup(scene)
    caabb, cvalid = raster.chunk_aabbs(s.aabb, s.valid)
    bins_full, counts_full = raster.bin_triangles_full(caabb, cvalid, **KW)
    return s, rows, cbins, ccounts, bins_full, counts_full


def test_bin_triangles_full_matches_capped():
    """Uncapped dense bins = capped bins when the cap is big enough.
    bins_full entries are packed cid << ENTRY_SHIFT | gmask (all-live
    gmask when no group AABBs are passed)."""
    s, rows, cbins, ccounts, bins_full, counts_full = _full_setup(
        _multi_quad_scene())
    np.testing.assert_array_equal(np.asarray(counts_full),
                                  np.asarray(ccounts))
    # the dense bins are exactly one column per chunk; the capped ones pad
    w = bins_full.shape[1]
    assert (np.asarray(cbins)[:, w:] == raster.NO_TRI).all()
    cb = np.asarray(cbins)[:, :w]
    bf = np.asarray(bins_full)
    live = cb >= 0
    np.testing.assert_array_equal(
        np.where(live, bf >> raster.ENTRY_SHIFT, -1), cb)
    assert ((bf[live] & raster.ENTRY_GMASK_ALL)
            == raster.ENTRY_GMASK_ALL).all()


def test_spatial_sorted_raster_matches_unsorted():
    """Rastering in spatial_sort order must produce the same framebuffer as
    submission order: plane evaluations are per-triangle, so with no exact
    z-ties between distinct triangles (true of this scene) the depth test
    picks the same winner regardless of walk order. tid maps back through
    the permutation."""
    scene = _multi_quad_scene(5 * raster.CHUNK)
    s, rows, cbins, ccounts = _setup(scene)
    caabb, cvalid = raster.chunk_aabbs(s.aabb, s.valid)
    bins_full, counts_full = raster.bin_triangles_full(caabb, cvalid, **KW)
    z1, t1, a1, m1, i1 = raster.rasterize_chunks(
        rows, bins_full, counts_full, **KW)

    T = rows.shape[0]
    aabb_s, valid_s, rows_s, orig = raster.spatial_sort(
        s.aabb, s.valid, rows, jnp.arange(T, dtype=jnp.int32))
    caabb_s, cvalid_s = raster.chunk_aabbs(aabb_s, valid_s)
    bins_s, counts_s = raster.bin_triangles_full(caabb_s, cvalid_s, **KW)
    # sorting must tighten (or at least not loosen) the chunk-bin entries
    assert int(counts_s.sum()) <= int(counts_full.sum())
    z2, t2, a2, m2, i2 = raster.rasterize_chunks(
        rows_s, bins_s, counts_s, **KW)

    np.testing.assert_array_equal(np.asarray(z1), np.asarray(z2))
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    t2n = np.asarray(t2)
    mapped = np.where(t2n >= 0, np.asarray(orig)[np.clip(t2n, 0, T - 1)], -1)
    np.testing.assert_array_equal(np.asarray(t1), mapped)


def test_gmask_bins_match_all_live():
    """Real group-mask bins (gmask bits from group_aabbs) must produce a
    bit-identical framebuffer to all-live bins: the gmask only ever skips
    groups whose AABB union misses the tile, which cannot cover a pixel
    there. Entry counts must tighten (or match)."""
    scene = _multi_quad_scene(5 * raster.CHUNK)
    s, rows, cbins, ccounts = _setup(scene)
    # spatial_sort scatters the quads' triangles into gmask-diverse chunks
    aabb_s, valid_s, rows_s = raster.spatial_sort(s.aabb, s.valid, rows)
    caabb, cvalid = raster.chunk_aabbs(aabb_s, valid_s)
    bins_a, counts_a = raster.bin_triangles_full(caabb, cvalid, **KW)
    gaabb, gvalid = raster.group_aabbs(aabb_s, valid_s)
    bins_g, counts_g = raster.bin_triangles_full(
        caabb, cvalid, gaabb=gaabb, gvalid=gvalid, **KW)
    assert int(counts_g.sum()) <= int(counts_a.sum())
    gm = np.asarray(bins_g) & raster.ENTRY_GMASK_ALL
    live = np.asarray(bins_g) >= 0
    assert (gm[live] > 0).all()
    if raster.N_GROUPS > 1:
        # the scene must actually exercise partial masks, else the test
        # proves nothing about the skip path
        assert (gm[live] != raster.ENTRY_GMASK_ALL).any()
    out_a = raster.rasterize_chunks(rows_s, bins_a, counts_a, **KW)
    out_g = raster.rasterize_chunks(rows_s, bins_g, counts_g, **KW)
    for a, g in zip(out_a, out_g):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(g))


def test_chunk_peel_matches_deferred_peel():
    """The chunk-bin peel must equal the deferred per-triangle peel across
    SEVERAL peel iterations (the `last` plane feeds back)."""
    s, rows, cbins, ccounts, bins_full, counts_full = _full_setup(
        _multi_quad_scene(5 * raster.CHUNK))
    bins_t, counts_t = raster.expand_bins(cbins, ccounts)
    hp, wp = TY * 32, TX * 128
    z = jnp.full((hp, wp), raster.DEPTH_CLEAR, jnp.float32)
    last1 = jnp.full((hp, wp), -1, jnp.int32)
    last2 = jnp.full((hp, wp), -1, jnp.int32)
    for _ in range(3):
        l1 = raster.rasterize_peel(s.packed, bins_t, counts_t, z, last1, **KW)
        l2, a2, m2, i2 = raster.peel_chunks(rows, bins_full, counts_full, z,
                                            last2, **KW)
        np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
        last1 = jnp.where(l1 < raster.ID_INF, l1, raster.ID_INF)
        last2 = jnp.where(l2 < raster.ID_INF, l2, raster.ID_INF)
    assert (np.asarray(l1) < raster.ID_INF).any()
