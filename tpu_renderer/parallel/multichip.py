"""Multi-chip rendering: SPMD over a ('rows', 'tri') device mesh.

Decomposition (sort-last + image-space hybrid — the renderer analog of
dp x tp):

* **rows** (image parallel): the framebuffer is split into horizontal bands
  of tiles; each device rasterizes + shades only its band. No communication
  — pixels are independent (the fragment-level parallelism a GPU gets from
  its SIMT rasterizer, here across chips).
* **tri** (triangle parallel, sort-last): the triangle set is sharded in
  chunk units; each device rasterizes its subset against its band, then the
  visibility buffers composite with two ``pmax`` collectives over the 'tri'
  axis (max depth, then max tri-id among depth ties — preserving the
  GREATER_OR_EQUAL later-wins rule). The additive transparent pass
  composites with a single ``psum`` (order-independent sum).

Band-local rasterization reuses the single-chip Pallas kernels unchanged:
a screen-space y translation is folded into the edge/depth plane constant
coefficients (e(X, Y+y0) = A·X + B·Y + (C + B·y0)), so each band rasters in
local coordinates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from tpu_renderer.kernels import raster, shade, vertex
from tpu_renderer.kernels.common import pad_extent
from tpu_renderer.pipeline import FrameParams, SceneBuffers
from tpu_renderer.present import to_packed_u32


def ensure_devices(n: int) -> None:
    """Fail unless the backend exposes at least n devices.

    A run never switches backends to find devices: a multi-device CPU run
    gets its virtual devices before the backend starts
    (XLA_FLAGS=--xla_force_host_platform_device_count=N or
    jax.config.update("jax_num_cpu_devices", N), as tests/conftest.py
    does)."""
    have = len(jax.devices())
    if have < n:
        raise RuntimeError(
            f"the mesh needs {n} devices; the {jax.default_backend()} "
            f"backend has {have}")


def make_mesh(n_rows: int, n_tri: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_rows * n_tri, (
        f"need {n_rows * n_tri} devices, have {len(devices)}")
    devs = np.asarray(devices[: n_rows * n_tri]).reshape(n_rows, n_tri)
    return Mesh(devs, axis_names=("rows", "tri"))


def _shift_rows_y(packed, y0):
    """Rebase edge/depth planes to band-local y: C += B * y0."""
    b_cols = packed[:, [1, 4, 7, 10]]
    shifted = packed.at[:, 2].add(b_cols[:, 0] * y0)
    shifted = shifted.at[:, 5].add(b_cols[:, 1] * y0)
    shifted = shifted.at[:, 8].add(b_cols[:, 2] * y0)
    shifted = shifted.at[:, 11].add(b_cols[:, 3] * y0)
    return shifted


def _shift_aabb_y(aabb, y0):
    return aabb.at[:, 1].add(-y0).at[:, 3].add(-y0)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "width", "height", "tile_h", "tile_w",
                     "bin_cap", "tri_cap", "fp16", "transp_textured",
                     "fused", "trilinear", "pot", "out_width", "out_height"),
)
def render_frame_multichip(buffers: SceneBuffers, params: FrameParams, *,
                           mesh: Mesh, width: int, height: int,
                           tile_h: int = 32, tile_w: int = 128,
                           bin_cap: int = 256,
                           tri_cap: int = 1024, fp16: bool = True,
                           transp_textured: bool = True, fused: bool = True,
                           trilinear: bool = True, pot: bool = False,
                           out_width: int = None, out_height: int = None):
    """Sharded frame: scene replicated, framebuffer sharded over 'rows',
    triangles sharded over 'tri'. Returns ((H, W) u32 packed-RGBA image,
    aux dict of device counters) like the single-chip render_frame: counts
    psum over 'tri', overflow diagnostics pmax over the mesh.

    trilinear / out_width / out_height mirror the single-chip render_frame
    statics: the single-tap fast path and the live render-scale upscale blit
    (applied after the bands gather) work identically under the mesh."""
    n_rows = mesh.shape["rows"]
    n_tri = mesh.shape["tri"]
    wp, hp = pad_extent(width, height, tile_h, tile_w * 1)
    # band height must be a tile multiple per device
    hp = -(-hp // (tile_h * n_rows)) * (tile_h * n_rows)
    band_h = hp // n_rows
    tiles_x = wp // tile_w
    tiles_y_band = band_h // tile_h

    to = buffers.opaque_tri_vidx.shape[0]
    tt = buffers.transp_tri_vidx.shape[0]
    # shard triangle arrays over 'tri' in chunk units
    def pad_to(n, m):
        return -(-n // m) * m

    def shard_tris(vidx, draw, valid):
        T = vidx.shape[0]
        tp = pad_to(max(T, 1), raster.CHUNK * n_tri)
        vidx = jnp.pad(vidx, ((0, tp - T), (0, 0)))
        draw = jnp.pad(draw, ((0, tp - T),), constant_values=-1)
        valid = jnp.pad(valid, ((0, tp - T),))
        return vidx, draw, valid

    ov, od, oval = shard_tris(buffers.opaque_tri_vidx, buffers.opaque_tri_draw,
                              buffers.opaque_tri_valid)
    tv, td, tval = shard_tris(buffers.transp_tri_vidx, buffers.transp_tri_draw,
                              buffers.transp_tri_valid)

    def shard_corner_planes(c, tp):
        """Pad the corner-expanded T-MINOR planes (vertex.CornerData twins)
        to the 'tri'-shard multiple. Only the planar twins + mat feed
        triangle_setup_rows; pad rows form dead triangles (draw = -1)."""
        padn = tp - c.mat.shape[0]
        p3 = ((0, 0), (0, 0), (0, padn))
        p2 = ((0, 0), (0, padn))
        return (jnp.pad(c.posT, p3), jnp.pad(c.nrmT, p3),
                jnp.pad(c.colT, p3), jnp.pad(c.uvT, p3),
                jnp.pad(c.meta6T, p2), jnp.pad(c.mat, ((0, padn),)))

    ocp = shard_corner_planes(buffers.opaque_corners, ov.shape[0])
    tcp = shard_corner_planes(buffers.transp_corners, tv.shape[0])

    def q(x):
        return x.astype(jnp.float16).astype(jnp.float32) if fp16 else x

    from tpu_renderer.pipeline import _background

    bg_full = q(_background(params, hp, wp, height))

    cp3 = P(None, None, "tri")
    cp_spec = (cp3, cp3, cp3, cp3, P(None, "tri"), P("tri"))
    aux_spec = {k: P() for k in (
        "visible_opaque_draws", "opaque_triangles", "bin_overflow",
        "bin_overflow_tris", "bin_overflow_transparent",
        "bin_overflow_transparent_tris", "transparent_layers")}

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(None, "rows", None), P("tri"), P("tri"),
                  P("tri"), P("tri"), P("tri"), P("tri"), cp_spec, cp_spec),
        out_specs=(P(None, "rows", None), aux_spec),
        check_vma=False,
    )
    def band_render(buffers, params, fb, ov, od, oval, tv, td, tval,
                    ocp, tcp):
        row = jax.lax.axis_index("rows")
        tri_idx = jax.lax.axis_index("tri")
        y0 = (row * band_h).astype(jnp.float32)

        # full f32 precision, as in the single-chip render_frame
        viewproj = jnp.matmul(params.proj, params.view,
                              precision=jax.lax.Precision.HIGHEST)

        vis = vertex.draw_visibility(viewproj, buffers.draw_model,
                                     buffers.draw_bounds_origin,
                                     buffers.draw_bounds_extents)

        def raster_set(vidx, draw, valid, visible, cplanes):
            if fused:
                # T-minor fused setup+rows — the SAME function as the
                # single-chip hot path (pipeline.py render_frame), with the
                # band-local y rebase folded into the plane constants at
                # setup (y0 kwarg) instead of a post-hoc row shift. Corner
                # planes arrive 'tri'-sharded, so the per-frame setup work
                # splits n_tri ways like the raster does.
                posT, nrmT, colT, uvT, meta6T, mat = cplanes
                corners = vertex.CornerData(
                    pos=None, nrm=None, col=None, uv=None, mat=mat,
                    meta6=None, posT=posT, nrmT=nrmT, colT=colT, uvT=uvT,
                    meta6T=meta6T)
                rows_l, aabb_l, valid_l = vertex.triangle_setup_rows(
                    corners, draw, valid, buffers.draw_model, visible,
                    viewproj, width, height, sun_dir=params.sun_dir[:3],
                    y0=y0)
                # shard-local screen-space sort (tight chunk AABBs, as on
                # the single-chip hot path), then UNCAPPED dense bins —
                # structurally overflow-free
                aabb_s, valid_s, rows_l = raster.spatial_sort(
                    aabb_l, valid_l, rows_l)
                caabb, cvalid = raster.chunk_aabbs(aabb_s, valid_s)
                gaabb, gvalid = raster.group_aabbs(aabb_s, valid_s)
                cbins, ccounts = raster.bin_triangles_full(
                    caabb, cvalid, tiles_x=tiles_x, tiles_y=tiles_y_band,
                    tile_w=tile_w, tile_h=tile_h, gaabb=gaabb, gvalid=gvalid)
                return (None, aabb_l, rows_l, cbins, ccounts, valid_l,
                        jnp.int32(0))
            setup = vertex.triangle_setup(
                buffers.positions, buffers.normals, buffers.colors,
                buffers.uvs, vidx, draw, valid, buffers.draw_model, visible,
                buffers.draw_mat, buffers.mat_color_factors, viewproj,
                width, height, sun_dir=params.sun_dir[:3])
            packed_l = _shift_rows_y(setup.packed, y0)
            aabb_l = _shift_aabb_y(setup.aabb, y0)
            rows_l = shade.build_shade_rows(packed_l, setup.attrs,
                                            buffers.mat_meta)
            caabb, cvalid = raster.chunk_aabbs(aabb_l, setup.valid)
            cbins, ccounts, overflow_c = raster.bin_triangles(
                caabb, cvalid, tiles_x=tiles_x, tiles_y=tiles_y_band,
                tile_w=tile_w, tile_h=tile_h,
                bin_cap=bin_cap)
            return (packed_l, aabb_l, rows_l, cbins, ccounts, setup.valid,
                    overflow_c)

        def refine(cbins, aabb_l):
            return raster.refine_bins(
                cbins, aabb_l, tiles_x=tiles_x, tiles_y=tiles_y_band,
                tile_w=tile_w, tile_h=tile_h, tri_cap=tri_cap)

        # aux counters, composited like the pixels are: sums psum over
        # 'tri' (each shard counts its triangle subset once; identical
        # across 'rows'), overflow diagnostics pmax over the whole mesh
        # (the engine's cap escalation only tests > 0)
        aux = {k: jnp.int32(0) for k in aux_spec}
        aux["visible_opaque_draws"] = jnp.sum(
            (vis & buffers.draw_opaque_mask).astype(jnp.int32))

        # opaque: local raster + sort-last composite over 'tri'
        packed_l, aabb_l, rows_local, cbins, ccounts, valid_o, oflow_c = \
            raster_set(ov, od, oval, vis, ocp)
        aux["opaque_triangles"] = jax.lax.psum(
            jnp.sum(valid_o.astype(jnp.int32)), "tri")
        aux["bin_overflow"] = jax.lax.pmax(oflow_c, ("rows", "tri"))
        t_shard = ov.shape[0]
        if fused:
            # chunk-bin walk, same as the single-chip hot path
            z, tid_local, attrs_l, meta_l, inv_l = raster.rasterize_chunks(
                rows_local, cbins, ccounts, tiles_x=tiles_x,
                tiles_y=tiles_y_band, tile_w=tile_w, tile_h=tile_h)
            tid = jnp.where(tid_local >= 0, tid_local + tri_idx * t_shard, -1)
            zmax = jax.lax.pmax(z, "tri")
            cand = jnp.where(z == zmax, tid, -1)
            tid_win = jax.lax.pmax(cand, "tri")
            z = zmax
            # exactly one shard holds the winner's interpolated attributes:
            # psum the masked planes instead of all_gather + per-pixel gather
            win = (cand == tid_win) & (tid_win >= 0)
            na, nm = shade.N_ATTR, shade.N_META
            planes = jnp.concatenate([attrs_l, meta_l, inv_l[None]], axis=0)
            planes = jax.lax.psum(jnp.where(win[None], planes, 0.0), "tri")
            shaded = shade.shade_fused(
                planes[:na], planes[na:na + nm], planes[na + nm],
                buffers.atlas, params.ambient[:3],
                params.sun_dir[:3], params.sun_color[3],
                trilinear=trilinear, pot=pot)
            valid = tid_win >= 0
            rgb = jnp.where(valid[None], shaded, fb[:3])
            alpha = jnp.where(valid, jnp.float32(1.0), fb[3])
            fb = q(jnp.concatenate([rgb, alpha[None]], axis=0))
        else:
            bins, counts, oflow_t = refine(cbins, aabb_l)
            aux["bin_overflow_tris"] = jax.lax.pmax(oflow_t, ("rows", "tri"))
            z, tid_local = raster.rasterize(
                packed_l, bins, counts, tiles_x=tiles_x,
                tiles_y=tiles_y_band, tile_w=tile_w, tile_h=tile_h)
            # local ids -> global ids (chunk-sharded: global = local + shard0)
            tid = jnp.where(tid_local >= 0, tid_local + tri_idx * t_shard, -1)
            zmax = jax.lax.pmax(z, "tri")
            tid = jnp.where(z == zmax, tid, -1)
            tid = jax.lax.pmax(tid, "tri")
            z = zmax
            # deferred shade needs the winning triangle's shade row: rows live
            # on the owning 'tri' shard; all_gather the (small) shade tables.
            rows_all = jax.lax.all_gather(rows_local, "tri", axis=0, tiled=True)
            fb = q(shade.shade(tid, rows_all, buffers.atlas,
                               params.ambient[:3], params.sun_dir[:3],
                               params.sun_color[3], fb,
                               trilinear=trilinear, pot=pot))

        # transparent: additive => psum partial contributions over 'tri'
        # (the same order-independent-sum semantics as the single-chip path;
        # a psum'd fragment COUNT drives the dstAlpha composite so a fragment
        # that shades to exactly black still counts as coverage)
        if tt > 0:
            all_vis = jnp.ones_like(vis)
            packed_tl, aabb_tl, rows_t, cbins_t, ccounts_t, _vt, oflow_tc = \
                raster_set(tv, td, tval, all_vis, tcp)
            aux["bin_overflow_transparent"] = jax.lax.pmax(
                oflow_tc, ("rows", "tri"))
            if fused and not transp_textured:
                light = jnp.concatenate([
                    params.sun_dir[:3], params.sun_color[3:4],
                    params.ambient[:3], jnp.zeros(1, jnp.float32)])
                delta, cnt = raster.accumulate_chunks(
                    rows_t, cbins_t, ccounts_t, z, light,
                    tiles_x=tiles_x, tiles_y=tiles_y_band,
                    tile_w=tile_w, tile_h=tile_h)
                delta = jax.lax.psum(delta, "tri")
                cnt = jax.lax.psum(cnt, "tri")
                # max per-pixel layer count == the single-chip while-loop's
                # iteration count (each iteration peels one layer everywhere)
                aux["transparent_layers"] = jax.lax.pmax(
                    cnt.max().astype(jnp.int32), "rows")
                covered = cnt > 0
                rgb = jnp.where(covered[None],
                                q(delta + fb[:3] * fb[3][None]), fb[:3])
                alpha = jnp.where(covered, 1.0, fb[3])
                fb = jnp.concatenate([rgb, alpha[None]], axis=0)
            else:
                if not fused:
                    bins_t, counts_t, oflow_tt = refine(cbins_t, aabb_tl)
                    aux["bin_overflow_transparent_tris"] = jax.lax.pmax(
                        oflow_tt, ("rows", "tri"))

                # textured: GLOBAL submission-order peel. Each iteration,
                # every 'tri' shard peels its local next-eligible layer,
                # candidates convert to global ids and a pmin elects the
                # per-pixel winner — exactly the single-chip peel's
                # next-smallest-id layer. The framebuffer composites and
                # fp16-quantizes PER LAYER like the single-chip textured
                # path does (pipeline.py one_peel), so sharded frames stay
                # bit-identical to single-chip even for stacked textured
                # transparency. (A per-shard peel + one psum'd delta was
                # cheaper — max local layers vs global layers iterations —
                # but quantized once at the end, a documented divergence
                # this replaces.)
                t_shard_t = tv.shape[0]
                base_id = tri_idx * t_shard_t
                na, nm = shade.N_ATTR, shade.N_META

                def peel_body(carry):
                    fbq, last, layers, _ = carry
                    # global 'last' ids -> local eligibility threshold:
                    # ids of this shard are globals [base_id, base_id+T);
                    # earlier-shard winners clamp to -1 (all eligible),
                    # later-shard winners stay above T (none eligible)
                    last_local = jnp.clip(last - base_id, -1, raster.ID_INF)
                    if fused:
                        layer_l, attrs_px, meta_px, inv_px = \
                            raster.peel_chunks(
                                rows_t, cbins_t, ccounts_t, z, last_local,
                                tiles_x=tiles_x, tiles_y=tiles_y_band,
                                tile_w=tile_w, tile_h=tile_h)
                    else:
                        layer_l = raster.rasterize_peel(
                            packed_tl, bins_t, counts_t, z, last_local,
                            tiles_x=tiles_x, tiles_y=tiles_y_band,
                            tile_w=tile_w, tile_h=tile_h)
                    found_l = layer_l < raster.ID_INF
                    gl = jnp.where(found_l, layer_l + base_id,
                                   raster.ID_INF)
                    layer = jax.lax.pmin(gl, "tri")
                    found = layer < raster.ID_INF
                    # exactly one shard holds the winner: psum the masked
                    # planes (the opaque composite's pattern)
                    win = found_l & (gl == layer)
                    if fused:
                        planes = jnp.concatenate(
                            [attrs_px, meta_px, inv_px[None]], axis=0)
                        planes = jax.lax.psum(
                            jnp.where(win[None], planes, 0.0), "tri")
                        src = shade.shade_fused(
                            planes[:na], planes[na:na + nm],
                            planes[na + nm], buffers.atlas,
                            params.ambient[:3], params.sun_dir[:3],
                            params.sun_color[3], textured=transp_textured,
                            trilinear=trilinear, pot=pot)
                    else:
                        tl_layer = jnp.where(found_l, layer_l, 0)
                        src = shade.shade_core(
                            tl_layer, rows_t, buffers.atlas,
                            params.ambient[:3], params.sun_dir[:3],
                            params.sun_color[3], textured=transp_textured,
                            trilinear=trilinear, pot=pot)
                        src = jax.lax.psum(
                            jnp.where(win[None], src, 0.0), "tri")
                    # additive blend + per-layer fp16 write-back
                    # (vk_pipelines.cpp:157-167; draw image rgba16f)
                    rgb = jnp.where(found[None],
                                    src + fbq[:3] * fbq[3][None], fbq[:3])
                    alpha = jnp.where(found, jnp.float32(1.0), fbq[3])
                    fbq = q(jnp.concatenate([rgb, alpha[None]], axis=0))
                    last = jnp.where(found, layer, raster.ID_INF)
                    return (fbq, last, layers + found.any().astype(jnp.int32),
                            found.any())

                init = (fb, jnp.full(z.shape, -1, jnp.int32),
                        jnp.zeros((), jnp.int32), jnp.asarray(True))
                fb, _, layers_found, _ = jax.lax.while_loop(
                    lambda c: c[3], peel_body, init)
                aux["transparent_layers"] = jax.lax.pmax(
                    layers_found, ("rows", "tri"))

        return fb, aux

    fb, aux = band_render(buffers, params, bg_full, ov, od, oval, tv, td,
                          tval, ocp, tcp)
    assert (out_width is None) == (out_height is None)
    if out_width is not None and (out_width, out_height) != (width, height):
        # live render-scale: linear upscale blit to the window extent, after
        # the row bands gather (vkCmdBlitImage2 VK_FILTER_LINEAR semantics,
        # vk_images.cpp:33-64)
        up = jax.image.resize(fb[:, :height, :width],
                              (4, out_height, out_width), method="linear")
        return to_packed_u32(up, width=out_width, height=out_height), aux
    return to_packed_u32(fb, width=width, height=height), aux
