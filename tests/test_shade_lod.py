"""Analytic mip-LOD gradients (shade.uv_gradients / C_GRAD fat-row columns).

The per-triangle uv screen gradients carried through the fused raster must
match the true derivative of the perspective-correct interpolated uv — at
INTERIOR pixels and, critically, at SILHOUETTE pixels, where the previous
quad-roll finite differences mixed neighboring primitives/background (the
divergence the reference never has: texture()'s implicit derivatives come
from same-primitive helper invocations, /root/reference/shaders/mesh.frag:15).
"""

import jax.numpy as jnp
import numpy as np

from tpu_renderer import math3d
from tpu_renderer.kernels import raster, shade, vertex

W, H = 128, 64
KW = dict(tiles_x=1, tiles_y=2, tile_w=128, tile_h=32)


def _perspective_tri_setup():
    """One textured triangle, oblique in depth => genuinely rational uv."""
    positions = np.asarray(
        [[-0.8, -0.6, -2.0], [0.9, -0.4, -6.0], [0.0, 0.8, -3.5]], np.float32)
    uvs = np.asarray([[0.0, 0.0], [4.0, 0.0], [0.0, 4.0]], np.float32)
    proj = math3d.vulkan_perspective(math3d.radians(70.0), W / H, 0.1, 100.0)
    setup = vertex.triangle_setup(
        jnp.asarray(positions),
        jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (3, 1)),
        jnp.ones((3, 4), jnp.float32),
        jnp.asarray(uvs),
        jnp.asarray([[0, 1, 2]], jnp.int32),
        jnp.zeros((1,), jnp.int32),
        jnp.ones((1,), bool),
        jnp.eye(4, dtype=jnp.float32)[None],
        jnp.ones((1,), bool),
        jnp.zeros((1,), jnp.int32),
        jnp.ones((1, 4), jnp.float32),
        jnp.asarray(proj),
        W, H,
        sun_dir=jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
    )
    return setup, np.asarray(uvs)


def _uv_exact(packed_row, uvs, X, Y):
    """Reference perspective-correct uv at (X, Y) from the setup planes."""
    c = [packed_row[3 * e] * X + packed_row[3 * e + 1] * Y
         + packed_row[3 * e + 2] for e in range(3)]
    den = c[0] + c[1] + c[2]
    u = (c[0] * uvs[0, 0] + c[1] * uvs[1, 0] + c[2] * uvs[2, 0]) / den
    v = (c[0] * uvs[0, 1] + c[1] * uvs[1, 1] + c[2] * uvs[2, 1]) / den
    return u, v


def test_uv_gradients_match_numeric_derivative_incl_silhouette():
    setup, uvs = _perspective_tri_setup()
    packed, aabb, valid = raster.pad_for_raster(setup.packed, setup.aabb,
                                                setup.valid)
    rows = shade.build_shade_rows(packed, jnp.pad(setup.attrs,
                                                  ((0, packed.shape[0] - 1),
                                                   (0, 0), (0, 0))),
                                  jnp.zeros((1, 8), jnp.float32))
    bins, counts = raster.full_bins(packed.shape[0] // raster.CHUNK,
                                    KW["tiles_x"] * KW["tiles_y"],
                                    packed.shape[0] // raster.CHUNK)
    # every tile walks every chunk, all gmask groups live
    bins = jnp.where(bins >= 0, (bins << raster.ENTRY_SHIFT)
                     | raster.ENTRY_GMASK_ALL, bins)
    z, tid, attrs, meta, inv = raster.rasterize_chunks(
        rows, bins, counts, **KW)
    tid = np.asarray(tid)
    covered = tid == 0
    assert covered.sum() > 200

    grads = shade.uv_gradients(attrs[4], attrs[5],
                               tuple(meta[6 + m] for m in range(6)), inv)
    grads = [np.asarray(g) for g in grads]

    # pick an interior pixel and a silhouette pixel (covered, with an
    # uncovered 4-neighbor) — the old quad-roll derivatives were wrong at
    # exactly the latter class
    interior = covered & np.roll(covered, 1, 0) & np.roll(covered, -1, 0) \
        & np.roll(covered, 1, 1) & np.roll(covered, -1, 1)
    edge = covered & ~interior
    row0 = np.asarray(packed[0], np.float64)
    for (yy, xx) in (tuple(np.argwhere(interior)[50]),
                     tuple(np.argwhere(edge)[3]),
                     tuple(np.argwhere(edge)[-2])):
        X, Y = xx + 0.5, yy + 0.5
        h = 1e-3
        up, _ = _uv_exact(row0, uvs, X + h, Y)
        um, _ = _uv_exact(row0, uvs, X - h, Y)
        _, vp = _uv_exact(row0, uvs, X, Y + h)
        _, vm = _uv_exact(row0, uvs, X, Y - h)
        dudx_ref = (up - um) / (2 * h)
        dvdy_ref = (vp - vm) / (2 * h)
        np.testing.assert_allclose(grads[0][yy, xx], dudx_ref,
                                   rtol=2e-3, atol=1e-6)
        np.testing.assert_allclose(grads[3][yy, xx], dvdy_ref,
                                   rtol=2e-3, atol=1e-6)


def test_pot_wrap_bit_identical():
    """The power-of-two REPEAT-wrap fast path (pot=True: bitwise AND) must
    be bit-identical to the int-mod path on POT textures, across negative
    and tiled uv ranges and all mip levels (shade._level_coords)."""
    import jax.numpy as jnp

    from tpu_renderer import resources

    rng = np.random.default_rng(11)
    tex = rng.integers(0, 256, (32, 64, 4), dtype=np.uint8)
    atlas = resources.build_atlas([tex])
    H, W = 16, 128
    u = jnp.asarray(rng.uniform(-3.0, 5.0, (H, W)).astype(np.float32))
    v = jnp.asarray(rng.uniform(-3.0, 5.0, (H, W)).astype(np.float32))
    meta = np.asarray(atlas.tex_meta[0])
    bx = jnp.full((H, W), float(meta[0]), jnp.float32)
    by = jnp.full((H, W), float(meta[1]), jnp.float32)
    w0 = jnp.full((H, W), float(meta[2]), jnp.float32)
    h0 = jnp.full((H, W), float(meta[3]), jnp.float32)
    n_lv = jnp.full((H, W), float(meta[4]), jnp.float32)
    flags = jnp.full((H, W), 7.0, jnp.float32)  # trilinear sampler
    # gradients spanning magnification through deep minification
    scale = jnp.asarray(
        rng.uniform(0.001, 4.0, (H, W)).astype(np.float32))
    grads = (scale / 64.0, scale / 64.0, scale / 32.0, scale / 32.0)
    a = shade.sample_texture(atlas, bx, by, w0, h0, n_lv, flags, u, v,
                             grads, trilinear=True, pot=False)
    b = shade.sample_texture(atlas, bx, by, w0, h0, n_lv, flags, u, v,
                             grads, trilinear=True, pot=True)
    for ca, cb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))


def test_engine_detects_pot():
    from tpu_renderer import milestones
    from tpu_renderer.config import RendererConfig
    from tpu_renderer.engine import Engine

    tex_pot = np.zeros((16, 16, 4), np.uint8)
    eng = Engine(RendererConfig(width=64, height=32))
    eng.init(scene=milestones.textured_quad_scene(tex_pot))
    assert eng._pot
    tex_npot = np.zeros((12, 20, 4), np.uint8)
    eng2 = Engine(RendererConfig(width=64, height=32))
    eng2.init(scene=milestones.textured_quad_scene(tex_npot))
    assert not eng2._pot
