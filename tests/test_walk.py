"""The chunk-bin walk: the Pallas kernel (interpreted on the CPU), the plain
XLA walk and the per-pixel numpy oracle must agree.

Covers every per-fragment rule (opaque depth, transparency peel, additive
accumulation), the gmask group skip, tile grids that are not powers of two,
the winner-attribute gather that splits 31 gathered columns into the 6/13
public planes, and that each kernel lowers for the GPU (Triton) route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_renderer.scene as sm
from tpu_renderer import milestones
from tpu_renderer.kernels import raster, shade, vertex
from tpu_renderer.scene import flatten_scene

I4 = jnp.eye(4, dtype=jnp.float32)
LIGHT = jnp.asarray([0.2, 0.8, 0.5, 1.0, 0.1, 0.1, 0.1, 0.0], jnp.float32)
# 3x2 tiles: neither tile count is a power of two
KW = dict(tiles_x=3, tiles_y=2, tile_w=128, tile_h=32)
W, H = 3 * 128, 2 * 32
WALKS = {"pallas": raster._walk_pallas, "xla": raster._walk_xla}


def _quads(n=24, seed=5):
    scene = milestones.colored_quad_scene(z0=0.3, z1=0.9)
    rng = np.random.default_rng(seed)
    scene.colors = rng.uniform(0, 1, scene.colors.shape).astype(np.float32)
    for k in range(n):
        node = sm.MeshNode(0, f"q{k}")
        m = np.eye(4, dtype=np.float32)
        m[0, 3], m[1, 3] = rng.uniform(-0.8, 0.8, 2)
        m[2, 3] = rng.uniform(-0.2, 0.2)
        m[0, 0] = m[1, 1] = rng.uniform(0.2, 0.6)
        node.refresh_transform(m)
        node.local_transform = m
        scene.nodes.append(node)
        scene.top_nodes.append(node)
    return scene


def _inputs(scene=None, gmask=True):
    b = flatten_scene(scene or _quads()).buffers
    vis = vertex.draw_visibility(I4, b.draw_model, b.draw_bounds_origin,
                                 b.draw_bounds_extents)
    rows, aabb, valid = vertex.triangle_setup_rows(
        b.opaque_corners, b.opaque_tri_draw, b.opaque_tri_valid,
        b.draw_model, vis, I4, W, H, sun_dir=jnp.asarray([0.0, 0.6, 0.8]))
    aabb, valid, rows = raster.spatial_sort(aabb, valid, rows)
    caabb, cvalid = raster.chunk_aabbs(aabb, valid)
    g = raster.group_aabbs(aabb, valid) if gmask else (None, None)
    bins, counts = raster.bin_triangles_full(
        caabb, cvalid, gaabb=g[0], gvalid=g[1], **KW)
    return rows, bins, counts


def _walk(form, rule, state, rows, bins, counts, planes=(), params=None):
    return WALKS[form](rule, rows, bins, counts, state, planes, params,
                       chunk=raster.CHUNK, **KW)


def _oracle_rows(rows):
    """Fat rows -> (T, 16) setup rows for rasterize_reference."""
    packed = jnp.zeros((rows.shape[0], 16), jnp.float32)
    packed = packed.at[:, :12].set(rows[:, :12])
    return packed.at[:, vertex.COL_VALID].set(1.0)


@pytest.mark.parametrize("form", ["pallas", "xla"])
def test_opaque_walk_matches_reference(form):
    rows, bins, counts = _inputs()
    z, tid = _walk(form, raster._depth_rule, raster._DEPTH_STATE,
                   rows, bins, counts)
    z_ref, tid_ref = raster.rasterize_reference(_oracle_rows(rows), W, H)
    np.testing.assert_array_equal(np.asarray(tid), tid_ref)
    np.testing.assert_array_equal(np.asarray(z), z_ref)
    assert (tid_ref >= 0).mean() > 0.3  # the scene really covers the frame


@pytest.mark.parametrize("rule", ["depth", "peel", "accum"])
def test_pallas_walk_matches_xla_walk(rule):
    rows, bins, counts = _inputs()
    zb = jnp.asarray(np.random.default_rng(1).uniform(0, 0.5, (H, W)),
                     jnp.float32)
    last = jnp.full((H, W), 5, jnp.int32)
    rule_fn, state, planes, params = {
        "depth": (raster._depth_rule, raster._DEPTH_STATE, (), None),
        "peel": (raster._peel_rule, raster._PEEL_STATE, (zb, last), None),
        "accum": (raster._accum_rule, raster._ACCUM_STATE, (zb,), LIGHT),
    }[rule]
    a = _walk("pallas", rule_fn, state, rows, bins, counts, planes, params)
    x = _walk("xla", rule_fn, state, rows, bins, counts, planes, params)
    for u, v in zip(a, x):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    assert (np.asarray(a[-1]) != state[-1][0]).any()  # the rule fired


def test_gmask_skip_matches_all_live_bins():
    """Skipping GROUP sub-blocks whose box misses a tile must not change a
    pixel; real gmask bins hold fewer (or as many) entries."""
    rows, bins_g, counts_g = _inputs(gmask=True)
    _, bins_a, counts_a = _inputs(gmask=False)
    assert int(counts_g.sum()) <= int(counts_a.sum())
    live = np.asarray(bins_g) >= 0
    gm = np.asarray(bins_g) & raster.ENTRY_GMASK_ALL
    assert (gm[live] > 0).all()
    for form in WALKS:
        out_g = _walk(form, raster._depth_rule, raster._DEPTH_STATE, rows,
                      bins_g, counts_g)
        out_a = _walk(form, raster._depth_rule, raster._DEPTH_STATE, rows,
                      bins_a, counts_a)
        for g, a in zip(out_g, out_a):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(a))


def test_winner_attributes_match_per_pixel_evaluation():
    """The 31 gathered columns split into attrs (6), metas (13) and inv
    exactly as a direct per-pixel evaluation of the winner's planes."""
    rows, bins, counts = _inputs()
    z, tid, attrs, metas, inv = raster.rasterize_chunks(rows, bins, counts,
                                                         **KW)
    assert attrs.shape == (shade.N_ATTR, H, W)
    assert metas.shape == (shade.N_META, H, W) and inv.shape == (H, W)
    t, r = np.asarray(tid), np.asarray(rows)
    for yy, xx in ((5, 7), (40, 200), (63, 383), (20, 130)):
        X, Y = np.float32(xx + 0.5), np.float32(yy + 0.5)
        if t[yy, xx] < 0:
            assert float(inv[yy, xx]) == 0.0 and not np.asarray(
                metas[:, yy, xx]).any()
            continue
        g = r[t[yy, xx]]
        den = g[41] * X + g[42] * Y + g[43]
        np.testing.assert_allclose(float(inv[yy, xx]), 1.0 / den, rtol=1e-6)
        for a in range(shade.N_ATTR):
            num = g[13 + a] * X + g[19 + a] * Y + g[25 + a]
            np.testing.assert_allclose(float(attrs[a, yy, xx]), num / den,
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(metas[:, yy, xx]), g[31:44])
    assert (t >= 0).any() and (t < 0).any()


def test_peel_chunks_walks_layers_in_submission_order():
    """Successive peels return strictly increasing ids per pixel until no
    layer is left; each layer's attributes are those of its own id."""
    rows, bins, counts = _inputs()
    zb = jnp.zeros((H, W), jnp.float32)
    last = jnp.full((H, W), -1, jnp.int32)
    seen = []
    for _ in range(3):
        best, attrs, metas, inv = raster.peel_chunks(rows, bins, counts, zb,
                                                     last, **KW)
        found = np.asarray(best) < raster.ID_INF
        if seen:
            assert (np.asarray(best)[found] > np.asarray(last)[found]).all()
        ref = raster.winner_attributes(
            rows, jnp.where(best < raster.ID_INF, best, raster.NO_TRI))
        # (outside the jitted peel XLA may fuse the plane math differently)
        np.testing.assert_allclose(np.asarray(attrs), np.asarray(ref[0]),
                                   rtol=1e-5, atol=1e-6)
        seen.append(found.sum())
        last = jnp.where(best < raster.ID_INF, best, raster.ID_INF)
    assert seen[0] > seen[1] > 0  # the quads overlap: layer 2 is smaller


@pytest.mark.parametrize("fn", ["rasterize_chunks", "accumulate_chunks",
                                "peel_chunks"])
def test_kernel_lowers_for_gpu(fn, monkeypatch):
    """Every chunk walk lowers to a Triton custom call for the CUDA
    platform (no device needed: lowering happens in JAX)."""
    monkeypatch.setattr(raster, "interpret_mode", lambda: False)
    T = 4 * raster.CHUNK
    s = jax.ShapeDtypeStruct
    rows = s((T, 48), jnp.float32)
    bins = s((6, T // raster.CHUNK), jnp.int32)
    counts = s((6,), jnp.int32)
    zb, last = s((H, W), jnp.float32), s((H, W), jnp.int32)
    args = {"rasterize_chunks": (rows, bins, counts),
            "accumulate_chunks": (rows, bins, counts, zb, s((8,), jnp.float32)),
            "peel_chunks": (rows, bins, counts, zb, last)}[fn]
    f = getattr(raster, fn)
    text = f.trace(*args, **KW).lower(lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in text
    assert "raster_walk_" in text


def test_interpret_mode_only_on_cpu(monkeypatch):
    from tpu_renderer.kernels import common

    assert common.interpret_mode() is True  # this suite runs on the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert common.interpret_mode() is False
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pytest.raises(RuntimeError, match="no Pallas kernel route"):
        common.interpret_mode()


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["depth", "peel", "accum"])
def test_compiled_kernel_matches_xla_walk_on_gpu(gpu_backend, rule):
    """On the card the kernel is compiled by Triton (not interpreted) and
    must agree with the XLA walk; at this size no pixel is edge-exact."""
    assert raster.interpret_mode() is False
    rows, bins, counts = _inputs()
    zb = jnp.zeros((H, W), jnp.float32)
    rule_fn, state, planes, params = {
        "depth": (raster._depth_rule, raster._DEPTH_STATE, (), None),
        "peel": (raster._peel_rule, raster._PEEL_STATE,
                 (zb, jnp.full((H, W), -1, jnp.int32)), None),
        "accum": (raster._accum_rule, raster._ACCUM_STATE, (zb,), LIGHT),
    }[rule]
    a = _walk("pallas", rule_fn, state, rows, bins, counts, planes, params)
    x = _walk("xla", rule_fn, state, rows, bins, counts, planes, params)
    for u, v in zip(a, x):
        u, v = np.asarray(u), np.asarray(v)
        if u.dtype == np.float32:
            np.testing.assert_allclose(u, v, rtol=1e-5, atol=1e-6)
        else:
            assert (u == v).mean() >= 0.999
