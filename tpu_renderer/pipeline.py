"""The jit-compiled frame function — everything the reference does between
fence-wait and present (vk_engine.cpp:1218-1339) collapsed into one pure
function over device arrays:

    background compute pass     (draw_background, vk_engine.cpp:1341-1355)
    -> per-draw frustum cull    (is_visible, vk_engine.cpp:56-86; device-side)
    -> vertex transform + setup (mesh.vert + primitive assembly)
    -> tile binning + raster    (vkCmdDrawIndexed's fixed-function stage)
    -> deferred shading         (mesh.frag)
    -> transparent accumulation (additive blend pass, vk_engine.cpp:1673-1676;
       single-pass sum for untextured, unbounded peel loop for textured)
    -> unorm8 convert           (swapchain blit, vk_images.cpp:33-64)

All shapes are static per scene; the engine re-jits only when the scene or
the framebuffer extent changes (the resize path, vk_engine.cpp:1520-1534).
The command buffers, descriptor sets, pipeline barriers and semaphores of
the reference have no equivalent here — XLA dataflow orders the passes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpu_renderer.kernels import background as bg
from tpu_renderer.kernels import raster, shade, vertex
from tpu_renderer.kernels.common import pad_extent
from tpu_renderer.present import to_packed_u32
from tpu_renderer.resources import TextureAtlas


class SceneBuffers(NamedTuple):
    """Device-resident scene: the analog of GPUMeshBuffers + material
    descriptor sets + texture images (vk_types.h:106-110, vk_engine.h:45-75).
    Triangle arrays are pre-padded to raster.CHUNK multiples.
    """

    positions: jax.Array          # (V, 3) f32
    normals: jax.Array            # (V, 3) f32
    colors: jax.Array             # (V, 4) f32
    uvs: jax.Array                # (V, 2) f32
    opaque_tri_vidx: jax.Array    # (To, 3) i32
    opaque_tri_draw: jax.Array    # (To,) i32
    opaque_tri_valid: jax.Array   # (To,) bool
    transp_tri_vidx: jax.Array    # (Tt, 3) i32
    transp_tri_draw: jax.Array    # (Tt,) i32
    transp_tri_valid: jax.Array   # (Tt,) bool
    draw_model: jax.Array         # (D, 4, 4) f32 node world transforms
    draw_mat: jax.Array           # (D,) i32
    draw_opaque_mask: jax.Array   # (D,) bool — draw belongs to the opaque pass
    draw_bounds_origin: jax.Array   # (D, 3) f32
    draw_bounds_extents: jax.Array  # (D, 3) f32
    mat_color_factors: jax.Array  # (M, 4) f32
    mat_meta: jax.Array           # (M, 8) f32 — atlas base_x/base_y/w0/h0,
    #                               n_levels, filter_flags (texture binding state)
    atlas: TextureAtlas
    # corner-expanded static geometry (vertex.CornerData) — precomputed once
    # per scene so the frame function needs no per-corner vertex gathers
    # (the analog of the loader's one-time interleave, vk_loader.cpp:286-358)
    opaque_corners: "vertex.CornerData"
    transp_corners: "vertex.CornerData"


class FrameParams(NamedTuple):
    """Per-frame uniforms: GPUSceneData (vk_types.h:118-125) + the background
    push constants (vk_types.h:77-82)."""

    view: jax.Array       # (4,4) f32
    proj: jax.Array       # (4,4) f32
    bg_effect: jax.Array  # () i32 — 0 gradient, 1 sky (vk_engine.h:137)
    bg_data1: jax.Array   # (4,) f32
    bg_data2: jax.Array   # (4,) f32
    ambient: jax.Array    # (4,) f32
    sun_dir: jax.Array    # (4,) f32 (w = unused here; .xyz as mesh.frag:13)
    sun_color: jax.Array  # (4,) f32 (.w = sun power, mesh.frag:18)


def _concat_corners(a: "vertex.CornerData",
                    b: "vertex.CornerData") -> "vertex.CornerData":
    """Concatenate two CornerData blocks along the triangle axis (axis 0 on
    the (T, ...) fields, the MINOR axis on the T-minor twins). Both inputs
    are CHUNK-padded, so slices of downstream per-triangle results stay
    chunk-aligned."""
    cat = jnp.concatenate
    return vertex.CornerData(
        pos=cat([a.pos, b.pos]), nrm=cat([a.nrm, b.nrm]),
        col=cat([a.col, b.col]), uv=cat([a.uv, b.uv]),
        mat=cat([a.mat, b.mat]), meta6=cat([a.meta6, b.meta6]),
        posT=cat([a.posT, b.posT], axis=-1),
        nrmT=cat([a.nrmT, b.nrmT], axis=-1),
        colT=cat([a.colT, b.colT], axis=-1),
        uvT=cat([a.uvT, b.uvT], axis=-1),
        meta6T=cat([a.meta6T, b.meta6T], axis=-1))


def _bg_grad(d1, d2, hp: int, wp: int, height: int):
    yy = jnp.arange(hp, dtype=jnp.float32)[None, :, None] / jnp.float32(height)
    return d1[:, None, None] * (1.0 - yy) + d2[:, None, None] * yy \
        + jnp.zeros((4, hp, wp), jnp.float32)


def _bg_sky(d1, hp: int, wp: int, height: int):
    yy = jnp.broadcast_to(jnp.arange(hp, dtype=jnp.float32)[:, None], (hp, wp))
    xx = jnp.broadcast_to(jnp.arange(wp, dtype=jnp.float32)[None, :], (hp, wp))
    cr, cg, cb = bg._sky_math(xx, yy, (d1[0], d1[1], d1[2], d1[3]), height)
    return jnp.stack([cr, cg, cb, jnp.ones_like(cr)])


def _background(params: FrameParams, hp: int, wp: int, height: int):
    """Background compute pass (color attachment then LOADs, not clears:
    vk_initializers.cpp:125). The formulas are elementwise and XLA fuses
    them; kernels/background.py holds their GLSL transcriptions."""
    return jax.lax.switch(
        jnp.clip(params.bg_effect, 0, 1),
        [
            lambda d1, d2: _bg_grad(d1, d2, hp, wp, height),
            lambda d1, d2: _bg_sky(d1, hp, wp, height),
        ],
        params.bg_data1, params.bg_data2,
    )


@functools.partial(
    jax.jit, static_argnames=("width", "height", "tile_h", "tile_w"))
def background_fb(params: FrameParams, *, width: int, height: int,
                  tile_h: int = 32, tile_w: int = 128):
    """The background pass alone, at the padded draw extent.

    A pure function of the background effect/params: the reference runs
    draw_background every frame (vk_engine.cpp:1341-1355) but its inputs
    only change on user input, so the Engine caches this across frames and
    passes it to render_frame as bg_fb; render_frames hoists the same
    computation out of its scan."""
    wp, hp = pad_extent(width, height, tile_h, tile_w)
    return _background(params, hp, wp, height)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "tile_h", "tile_w",
                     "bin_cap", "tri_cap", "fp16", "transp_textured",
                     "fused", "trilinear", "pot", "out_width", "out_height"),
)
def render_frame(buffers: SceneBuffers, params: FrameParams, *,
                 width: int, height: int, tile_h: int = 32, tile_w: int = 128,
                 bin_cap: int = 512,
                 tri_cap: int = 1024, fp16: bool = True,
                 transp_textured: bool = True, fused: bool = True,
                 trilinear: bool = True, pot: bool = False,
                 out_width: int = None, out_height: int = None,
                 bg_fb=None, sort_orders=None):
    """Render one frame. Returns ((H, W) uint32 packed-RGBA image — see
    present.unpack_u8 for the host-side channel view — and an aux dict).

    out_width/out_height: when set and different from (width, height), the
    frame renders at (width, height) and upscales to the output extent
    with a linear blit — the LIVE version of the reference's dead
    _render_scale path (vk_engine.cpp:1220-1222, 1251-1252; filter
    semantics from vkCmdBlitImage2 VK_FILTER_LINEAR, vk_images.cpp:33-64).

    bg_fb: optional precomputed (4, Hp, Wp) background (render_frames hoists
    it out of the frame scan — the effect is a pure function of the
    background params, which the engine holds constant within a batch).

    sort_orders: optional (opaque, transparent) spatial-sort permutations
    (from frame_sort_orders) — temporal-coherence reuse that moves the
    per-frame argsort off the hot path; see raster.spatial_sort. Either
    element may be None to sort that pass fresh."""
    wp, hp = pad_extent(width, height, tile_h, tile_w)
    tiles_x, tiles_y = wp // tile_w, hp // tile_h
    n_tiles = tiles_x * tiles_y

    def q(x):
        # the draw image is R16G16B16A16_SFLOAT (vk_engine.cpp:749): writes
        # round to fp16
        return x.astype(jnp.float16).astype(jnp.float32) if fp16 else x

    # geometry products pin f32 precision: a GPU may run a default-precision
    # f32 matmul in TF32, which moves vertices by pixels at 1080p
    viewproj = jnp.matmul(params.proj, params.view,
                          precision=jax.lax.Precision.HIGHEST)

    fb = _background(params, hp, wp, height) if bg_fb is None else bg_fb
    fb = q(fb)

    aux = {}
    to = buffers.opaque_tri_vidx.shape[0]
    tt = buffers.transp_tri_vidx.shape[0]

    # --- frustum cull (opaque only — transparent surfaces are submitted
    # unculled, vk_engine.cpp:1459-1465) --------------------------------------
    vis = vertex.draw_visibility(viewproj, buffers.draw_model,
                                 buffers.draw_bounds_origin,
                                 buffers.draw_bounds_extents)
    all_vis = jnp.ones_like(vis)
    aux["visible_opaque_draws"] = jnp.sum(
        (vis & buffers.draw_opaque_mask).astype(jnp.int32))

    z = jnp.full((hp, wp), raster.DEPTH_CLEAR, jnp.float32)

    rows_t = t_aabb = t_valid = None
    if to > 0:
        if fused:
            # T-minor fused setup+rows (vertex.triangle_setup_rows): same
            # math as triangle_setup_c + build_shade_rows (parity-test
            # pinned)
            if tt > 0:
                # ONE setup over opaque ++ transparent: the plane math is
                # per-triangle elementwise, so slices of the combined call
                # are bit-identical to two separate calls — one launch, one
                # T-minor relayout, one 5-gather pass instead of two.
                # Transparent draws are never culled (vk_engine.cpp:1459-65):
                # they ride the combined per-draw visibility as always-true
                # (their draw_opaque_mask bit is False).
                corners_all = _concat_corners(
                    buffers.opaque_corners, buffers.transp_corners)
                vis_all = vis | ~buffers.draw_opaque_mask
                rows_all, aabb_all, valid_all = vertex.triangle_setup_rows(
                    corners_all,
                    jnp.concatenate([buffers.opaque_tri_draw,
                                     buffers.transp_tri_draw]),
                    jnp.concatenate([buffers.opaque_tri_valid,
                                     buffers.transp_tri_valid]),
                    buffers.draw_model, vis_all, viewproj,
                    width, height, sun_dir=params.sun_dir[:3],
                )
                rows, o_aabb, o_valid = \
                    rows_all[:to], aabb_all[:to], valid_all[:to]
                rows_t, t_aabb, t_valid = \
                    rows_all[to:], aabb_all[to:], valid_all[to:]
            else:
                rows, o_aabb, o_valid = vertex.triangle_setup_rows(
                    buffers.opaque_corners, buffers.opaque_tri_draw,
                    buffers.opaque_tri_valid, buffers.draw_model, vis,
                    viewproj, width, height, sun_dir=params.sun_dir[:3],
                )
        else:
            setup = vertex.triangle_setup_c(
                buffers.opaque_corners, buffers.opaque_tri_draw,
                buffers.opaque_tri_valid, buffers.draw_model, vis, viewproj,
                width, height, sun_dir=params.sun_dir[:3],
            )
            rows = shade.build_shade_rows(setup.packed, setup.attrs,
                                          aabb=setup.aabb,
                                          meta6=buffers.opaque_corners.meta6)
            o_aabb, o_valid = setup.aabb, setup.valid
        if fused:
            # screen-space spatial sort before chunking: tight chunk AABBs
            # -> fewer chunk-bin entries to walk (see raster.spatial_sort)
            aabb_s, valid_s, rows = raster.spatial_sort(
                o_aabb, o_valid, rows,
                order=None if sort_orders is None else sort_orders[0])
            caabb, cvalid = raster.chunk_aabbs(aabb_s, valid_s)
            # chunk-bin walk over UNCAPPED dense bins (no refine pass):
            # depth and winner id per pixel, then the winner's attribute
            # planes gathered by id; nothing can overflow or drop — parity
            # with the reference's capacity-cliff-free hardware raster
            # (vkCmdDrawIndexed, vk_engine.cpp:1453).
            overflow_c = jnp.int32(0)
            overflow_t = jnp.int32(0)
            # GROUP-granular boxes ride the bin entries as a gmask: the
            # walk skips dead sub-groups on a scalar bit test and entries
            # no group touches are never binned at all
            gaabb, gvalid = raster.group_aabbs(aabb_s, valid_s)
            cbins_full, ccounts = raster.bin_triangles_full(
                caabb, cvalid, tiles_x=tiles_x, tiles_y=tiles_y,
                tile_w=tile_w, tile_h=tile_h, gaabb=gaabb, gvalid=gvalid)
            z, tid, attrs_px, meta_px, inv_px = raster.rasterize_chunks(
                rows, cbins_full, ccounts,
                tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h)
            valid = tid >= 0
            shaded = shade.shade_fused(
                attrs_px, meta_px, inv_px, buffers.atlas, params.ambient[:3],
                params.sun_dir[:3], params.sun_color[3],
                trilinear=trilinear, pot=pot)
            rgb = jnp.where(valid[None], shaded, fb[:3])
            alpha = jnp.where(valid, jnp.float32(1.0), fb[3])
            fb = q(jnp.concatenate([rgb, alpha[None]], axis=0))
        else:
            caabb, cvalid = raster.chunk_aabbs(setup.aabb, setup.valid)
            cbins, ccounts, overflow_c = raster.bin_triangles(
                caabb, cvalid, tiles_x=tiles_x, tiles_y=tiles_y,
                tile_w=tile_w, tile_h=tile_h, bin_cap=bin_cap)
            bins, counts, overflow_t = raster.refine_bins(
                cbins, setup.aabb, tiles_x=tiles_x, tiles_y=tiles_y,
                tile_w=tile_w, tile_h=tile_h, tri_cap=tri_cap)
            z, tid = raster.rasterize(
                setup.packed, bins, counts,
                tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h)
            fb = q(shade.shade(
                tid, rows, buffers.atlas, params.ambient[:3],
                params.sun_dir[:3], params.sun_color[3], fb,
                trilinear=trilinear, pot=pot))
        aux["bin_overflow"] = overflow_c
        aux["bin_overflow_tris"] = overflow_t
        aux["opaque_triangles"] = jnp.sum(o_valid.astype(jnp.int32))

    # --- transparent pass: additive, depth-test-only, via depth peeling ------
    if tt > 0:
        if fused:
            if rows_t is None:  # to == 0: no combined setup ran above
                rows_t, t_aabb, t_valid = vertex.triangle_setup_rows(
                    buffers.transp_corners, buffers.transp_tri_draw,
                    buffers.transp_tri_valid, buffers.draw_model, all_vis,
                    viewproj, width, height, sun_dir=params.sun_dir[:3],
                )
        else:
            setup_t = vertex.triangle_setup_c(
                buffers.transp_corners, buffers.transp_tri_draw,
                buffers.transp_tri_valid, buffers.draw_model, all_vis,
                viewproj, width, height, sun_dir=params.sun_dir[:3],
            )
            rows_t = shade.build_shade_rows(setup_t.packed, setup_t.attrs,
                                            aabb=setup_t.aabb,
                                            meta6=buffers.transp_corners.meta6)
            t_aabb, t_valid = setup_t.aabb, setup_t.valid
        caabb_t, cvalid_t = raster.chunk_aabbs(t_aabb, t_valid)

        if fused and not transp_textured:
            # mesh.frag writes alpha = 1.0 always (shaders/mesh.frag:18), so
            # the reference's additive blend reduces to an order-independent
            # SUM over all transparent fragments — one raster pass shades and
            # accumulates EVERY layer (no peel cap; uncapped dense bins, so
            # nothing can overflow either; no expand/refine).
            overflow_tc = overflow_tt = jnp.int32(0)
            # the accumulation is an order-independent sum, so the spatial
            # sort is semantically free here; it keeps CHUNK-triangle AABB
            # unions tight (unsorted submission order interleaves meshes)
            aabb_ta, valid_ta, rows_ta = raster.spatial_sort(
                t_aabb, t_valid, rows_t,
                order=None if sort_orders is None else sort_orders[1])
            caabb_ta, cvalid_ta = raster.chunk_aabbs(aabb_ta, valid_ta)
            gaabb_ta, gvalid_ta = raster.group_aabbs(aabb_ta, valid_ta)
            cbins_tf, ccounts_tf = raster.bin_triangles_full(
                caabb_ta, cvalid_ta, tiles_x=tiles_x, tiles_y=tiles_y,
                tile_w=tile_w, tile_h=tile_h,
                gaabb=gaabb_ta, gvalid=gvalid_ta)
            light = jnp.concatenate([
                params.sun_dir[:3], params.sun_color[3:4],
                params.ambient[:3], jnp.zeros(1, jnp.float32)])
            acc, cnt = raster.accumulate_chunks(
                rows_ta, cbins_tf, ccounts_tf, z, light,
                tiles_x=tiles_x, tiles_y=tiles_y,
                tile_w=tile_w, tile_h=tile_h)
            covered = cnt > 0
            # first blended fragment scales dst by dstAlpha
            # (vk_pipelines.cpp:161-162); dst.a == 1 afterwards
            rgb = jnp.where(covered[None], acc + fb[:3] * fb[3][None], fb[:3])
            alpha = jnp.where(covered, jnp.float32(1.0), fb[3])
            fb = q(jnp.concatenate([rgb, alpha[None]], axis=0))
            layers_found = cnt.max()
        else:
            # textured transparency: peel one layer at a time in submission
            # order, looping until NO pixel finds another fragment — the
            # unbounded analog of the reference blending every fragment
            # (vk_engine.cpp:1459-1465). Each peel needs its own deferred
            # texture taps, which is why this path can't single-pass.
            if fused:
                # uncapped dense bins: the peel loop walks every overlap, so
                # this path can't overflow either
                overflow_tc = overflow_tt = jnp.int32(0)
                # the gmask bins drop entries no GROUP-box touches (a
                # strictly tighter bin)
                gaabb_t, gvalid_t = raster.group_aabbs(t_aabb, t_valid)
                cbins_tf, ccounts_tf = raster.bin_triangles_full(
                    caabb_t, cvalid_t, tiles_x=tiles_x, tiles_y=tiles_y,
                    tile_w=tile_w, tile_h=tile_h,
                    gaabb=gaabb_t, gvalid=gvalid_t)
            else:
                tbin_cap = min(bin_cap, max(tt // raster.CHUNK, 1))
                cbins_t, ccounts_t, overflow_tc = raster.bin_triangles(
                    caabb_t, cvalid_t, tiles_x=tiles_x, tiles_y=tiles_y,
                    tile_w=tile_w, tile_h=tile_h, bin_cap=tbin_cap)
                if tt <= 4096:
                    # small transparent sets: skip the refine pass; the peel
                    # loop evaluates the few extra chunk members instead
                    bins_t, counts_t = raster.expand_bins(cbins_t, ccounts_t)
                    overflow_tt = jnp.int32(0)
                else:
                    bins_t, counts_t, overflow_tt = raster.refine_bins(
                        cbins_t, t_aabb, tiles_x=tiles_x,
                        tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
                        tri_cap=tri_cap)

            def one_peel(fb, last):
                if fused:
                    layer, attrs_px, meta_px, inv_px = \
                        raster.peel_chunks(
                            rows_t, cbins_tf, ccounts_tf, z, last,
                            tiles_x=tiles_x, tiles_y=tiles_y,
                            tile_w=tile_w, tile_h=tile_h)
                    found = layer < raster.ID_INF
                    src = shade.shade_fused(
                        attrs_px, meta_px, inv_px, buffers.atlas,
                        params.ambient[:3],
                        params.sun_dir[:3], params.sun_color[3],
                        textured=transp_textured, trilinear=trilinear,
                        pot=pot)
                    # additive blend (vk_pipelines.cpp:157-167)
                    rgb = jnp.where(found[None], src + fb[:3] * fb[3][None], fb[:3])
                    alpha = jnp.where(found, jnp.float32(1.0), fb[3])
                    fb = q(jnp.concatenate([rgb, alpha[None]], axis=0))
                else:
                    layer = raster.rasterize_peel(
                        setup_t.packed, bins_t, counts_t, z, last,
                        tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h)
                    found = layer < raster.ID_INF
                    tid_layer = jnp.where(found, layer, -1)
                    fb = q(shade.blend_layer(
                        fb, tid_layer, rows_t, buffers.atlas,
                        params.ambient[:3], params.sun_dir[:3], params.sun_color[3],
                        textured=transp_textured, trilinear=trilinear,
                        pot=pot))
                last = jnp.where(found, layer, raster.ID_INF)
                return fb, last, found.any()

            def peel_body(carry):
                fbc, last, layers, _ = carry
                fbc, last, any_found = one_peel(fbc, last)
                return fbc, last, layers + any_found.astype(jnp.int32), any_found

            init = (fb, jnp.full((hp, wp), -1, jnp.int32),
                    jnp.zeros((), jnp.int32), jnp.asarray(True))
            fb, _, layers_found, _ = jax.lax.while_loop(
                lambda c: c[3], peel_body, init)
        # separate chunk vs triangle overflow so cap escalation widens only
        # the capacity that actually overflowed (engine._escalate_caps)
        aux["bin_overflow_transparent"] = overflow_tc
        aux["bin_overflow_transparent_tris"] = overflow_tt
        aux["transparent_layers"] = layers_found

    assert (out_width is None) == (out_height is None), \
        "out_width and out_height must be set together"
    if out_width is not None and (out_width, out_height) != (width, height):
        up = jax.image.resize(fb[:, :height, :width],
                              (4, out_height, out_width), method="linear")
        image = to_packed_u32(up, width=out_width, height=out_height)
    else:
        image = to_packed_u32(fb, width=width, height=height)
    return image, aux


def _frame_sort_orders(buffers: SceneBuffers, params: FrameParams, *,
                       width: int, height: int,
                       transp_textured: bool = True):
    """Spatial-sort permutations for the fused path's two sorted passes
    (opaque stream raster + untextured-transparent accumulation), computed
    for THIS camera but valid for any: binning re-derives tile overlap
    from the permuted AABBs every frame, so a reused permutation only
    loosens chunk locality (imperceptibly, for sub-degree camera deltas)
    — see raster.spatial_sort. Runs the same combined T-minor setup as
    render_frame; XLA dead-code-eliminates every output that doesn't feed
    the AABBs, leaving the transform + key + argsort.

    Kept as a hook and as the semantic pin that any permutation renders
    correctly (tests/test_engine.py); the product paths sort per frame."""
    viewproj = jnp.matmul(params.proj, params.view,
                          precision=jax.lax.Precision.HIGHEST)
    to = buffers.opaque_tri_vidx.shape[0]
    tt = buffers.transp_tri_vidx.shape[0]
    vis = vertex.draw_visibility(viewproj, buffers.draw_model,
                                 buffers.draw_bounds_origin,
                                 buffers.draw_bounds_extents)
    order_o = order_t = None
    want_t = tt > 0 and not transp_textured
    if to > 0 and tt > 0:
        corners_all = _concat_corners(
            buffers.opaque_corners, buffers.transp_corners)
        vis_all = vis | ~buffers.draw_opaque_mask
        _rows, aabb_all, valid_all = vertex.triangle_setup_rows(
            corners_all,
            jnp.concatenate([buffers.opaque_tri_draw,
                             buffers.transp_tri_draw]),
            jnp.concatenate([buffers.opaque_tri_valid,
                             buffers.transp_tri_valid]),
            buffers.draw_model, vis_all, viewproj,
            width, height, sun_dir=params.sun_dir[:3])
        order_o = raster.sort_order(aabb_all[:to], valid_all[:to])
        if want_t:
            order_t = raster.sort_order(aabb_all[to:], valid_all[to:])
    elif to > 0:
        _rows, aabb, valid = vertex.triangle_setup_rows(
            buffers.opaque_corners, buffers.opaque_tri_draw,
            buffers.opaque_tri_valid, buffers.draw_model, vis, viewproj,
            width, height, sun_dir=params.sun_dir[:3])
        order_o = raster.sort_order(aabb, valid)
    elif want_t:
        _rows, aabb, valid = vertex.triangle_setup_rows(
            buffers.transp_corners, buffers.transp_tri_draw,
            buffers.transp_tri_valid, buffers.draw_model,
            jnp.ones_like(vis), viewproj,
            width, height, sun_dir=params.sun_dir[:3])
        order_t = raster.sort_order(aabb, valid)
    return order_o, order_t


frame_sort_orders = jax.jit(
    _frame_sort_orders,
    static_argnames=("width", "height", "transp_textured"))


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "tile_h", "tile_w",
                     "bin_cap", "tri_cap", "fp16", "transp_textured",
                     "fused", "trilinear", "pot", "out_width", "out_height"),
)
def render_frames(buffers: SceneBuffers, params_batch: FrameParams, **kw):
    """Render a whole batch of frames in ONE device program (lax.scan) —
    the deep-pipelining analog of the reference's FRAME_OVERLAP in-flight
    frames (vk_engine.h:77), minus any host round trips between frames.

    params_batch: FrameParams with a leading frame axis on every leaf.
    Returns (last frame image, (F,) per-frame checksums).
    """

    # the background is a pure function of the bg params, which the engine
    # holds constant across a batch — compute it once outside the scan
    wp, hp = pad_extent(kw["width"], kw["height"],
                        kw.get("tile_h", 32), kw.get("tile_w", 128))
    first = jax.tree.map(lambda x: x[0], params_batch)
    bg_fb = _background(first, hp, wp, kw["height"])

    def step(_, p):
        img, _aux = render_frame(buffers, p, bg_fb=bg_fb, **kw)
        checksum = (img[::191, ::127] & 0xFF).astype(jnp.int32).sum()
        return img, checksum

    oh = kw.get("out_height") or kw["height"]
    ow = kw.get("out_width") or kw["width"]
    init = jnp.zeros((oh, ow), jnp.uint32)
    last, sums = jax.lax.scan(step, init, params_batch)
    return last, sums
