"""Engine façade — init/run/draw/cleanup in the shape of the reference's
VulkanEngine (vk_engine.h:79-227, init vk_engine.cpp:171-201, run
:1161-1203, draw :1218-1339, cleanup :1131-1159), headless.

What disappears: instance/device bring-up (jax.devices()), swapchain
and semaphores (async dispatch + block_until_ready pacing replaces
FRAME_OVERLAP=3), command recording (the frame is one jitted call),
descriptor pools and pipeline objects (function specialization).

What stays: the frame loop, the FPS camera, scene update, the EngineStats
counters, and the background-effect selection.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import jax.numpy as jnp
import numpy as np

from tpu_renderer import math3d, scene as scene_mod
from tpu_renderer.camera import Camera
from tpu_renderer.config import RendererConfig
from tpu_renderer.pipeline import FrameParams, render_frame  # noqa: F401
from tpu_renderer.kernels import raster
from tpu_renderer.resources import FILTER_MIP_LINEAR

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class EngineStats:
    """Mirror of EngineStats (vk_engine.h:16-22)."""

    frame_time: float = 0.0        # ms
    triangle_count: int = 0
    drawcall_count: int = 0
    scene_update_time: float = 0.0  # ms
    mesh_draw_time: float = 0.0     # ms


class Engine:
    def __init__(self, config: Optional[RendererConfig] = None):
        self.config = config or RendererConfig()
        # kernel knobs: config.py is the source of truth; RASTER_* env vars
        # override inside configure() (the CPU test tier)
        raster.configure(chunk=self.config.raster_chunk,
                         group=self.config.raster_group,
                         sort=self.config.raster_sort)
        self.stats = EngineStats()
        self.camera = Camera(position=self.config.camera_position,
                             speed=self.config.camera_speed)
        self.scene: Optional[scene_mod.LoadedScene] = None
        self.flat: Optional[scene_mod.FlattenedDrawList] = None
        self.frame_number = 0
        self.current_background_effect = self.config.background_effect
        self._caps = None
        self._last_aux = None

    # -- init (vk_engine.cpp:171-201) ---------------------------------------

    def init(self, scene_path: Optional[str] = None,
             scene: Optional[scene_mod.LoadedScene] = None,
             variant=None) -> None:
        if self.config.multichip is not None:
            # the device mesh: fails when the backend has too few devices
            from tpu_renderer.parallel import multichip as mc

            rows, tri = self.config.multichip
            mc.ensure_devices(rows * tri)
            self.mesh = mc.make_mesh(rows, tri)
        else:
            self.mesh = None
        if scene is not None:
            self.scene = scene
        elif scene_path is not None:
            self.scene = scene_mod.load_scene(scene_path, variant=variant)
        else:
            # empty scene: background only
            self.scene = scene_mod.LoadedScene()
            scene_mod.default_materials_and_textures(self.scene)
        self.flat = scene_mod.flatten_scene(self.scene)
        self._compute_caps()

    def _compute_caps(self) -> None:
        """Static binning capacities from scene size (re-jit on change).

        Only the DEFERRED path (config.fused = False) consumes these — the
        fused slab path is uncapped by construction.
        """
        b = self.flat.buffers
        n_chunks = max(
            b.opaque_tri_vidx.shape[0] // raster.CHUNK,
            b.transp_tri_vidx.shape[0] // raster.CHUNK,
            1,
        )
        bin_cap = int(min(max(64, n_chunks), 512))
        tri_cap = 1024
        self._caps = dict(bin_cap=bin_cap, tri_cap=tri_cap)
        # Dense-bin memory guard: above dense_bin_max_chunks the fused
        # path's O(n_tiles x n_chunks) uncapped bins grow past the
        # envelope config.dense_bin_max_chunks documents, so the engine
        # auto-selects the bounded deferred path instead.
        self._fused = bool(self.config.fused
                           and n_chunks <= self.config.dense_bin_max_chunks)
        if self._fused != self.config.fused:
            logger.info(
                "scene has %d chunks > dense_bin_max_chunks=%d: "
                "falling back to the capped deferred raster path",
                n_chunks, self.config.dense_bin_max_chunks)
        # static per-scene draw/triangle counts for the stats HUD (computed
        # once — fetching the mask arrays per frame is host-transfer waste)
        self._n_transp_draws = int(np.sum(~np.asarray(b.draw_opaque_mask)))
        self._n_transp_tris = int(np.sum(np.asarray(b.transp_tri_valid)))
        self._n_opaque_draws = int(np.sum(np.asarray(b.draw_opaque_mask)))
        self._n_opaque_tris = int(np.sum(np.asarray(b.opaque_tri_valid)))
        # static: does ANY material trilinear-blend two mip levels? If not,
        # the shade stage drops its second tap gather entirely (see
        # shade.sample_texture)
        mm = np.asarray(b.mat_meta)
        self._trilinear = bool(np.any(
            (mm[:, 4] > 1)
            & (mm[:, 5].astype(np.int32) & FILTER_MIP_LINEAR).astype(bool)))
        # static: every bound texture has power-of-two dims -> the sampler's
        # REPEAT wrap is a bitwise AND instead of two integer-division mod
        # planes (bit-identical results; shade._level_coords)
        dims = mm[:, 2:4].astype(np.int64)
        self._pot = bool(np.all((dims > 0) & ((dims & (dims - 1)) == 0)))
        # auto quality (config.target_fps): pick the render scale the
        # measured cost model predicts hits the target on THIS scene
        self._auto_scale = self._pick_auto_scale()
        if self._auto_scale < 1.0:
            logger.info(
                "auto quality: predicted %.1f ms/frame at native extent > "
                "%.1f ms budget — engaging render scale %.2f",
                self._predict_frame_ms(1.0), 1000.0 / self.config.target_fps,
                self._auto_scale)

    # Frame-time model, fitted on an NVIDIA H100 80GB HBM3 at a 700 W power
    # limit (PERF.md): frame_ms(s) = fixed + Mpx*s^2*(base +
    # taps*tap) + blit (when s < 1), from three 1080p frame times of the
    # demo scene — trilinear 10.676 ms at s=1.0, trilinear 16.019 ms at
    # s=0.7, single-tap 10.719 ms at s=1.0.
    #   _COST_TAP_NS:   a mip tap: the two-tap scene is no slower (the fit
    #                   is -0.02 ns/px, taken as 0)
    #   _COST_BASE_NS:  per drawn pixel: the scaled frame is SLOWER, so the
    #                   fit is negative; taken as 0 (the frame's device time
    #                   is the raster walk, bound by its heaviest tile)
    #   _COST_FIXED_MS: the native frame
    #   _COST_BLIT_MS:  what drawing below native costs on top: the linear
    #                   upscale blit (0.83 ms timed alone at s=0.7) plus the
    #                   walk's heavier tiles (each tile covers more scene)
    # So the model keeps the native extent (1.0) for every target it meets
    # there — the trilinear scene meets 60 FPS at 1.0 — and predicts no
    # scale < 1 faster than native.
    # _COST_MARGIN keeps the pick under budget through run-to-run and scene
    # variance (a predicted 99%-of-budget frame is a coin flip).
    _COST_BASE_NS = 0.0
    _COST_TAP_NS = 0.0
    _COST_FIXED_MS = 10.68
    _COST_BLIT_MS = 5.34
    _COST_MARGIN = 0.97

    def _scene_taps(self) -> int:
        """Mip-tap gathers per textured pixel on this scene's hot path."""
        if self._trilinear:
            return 2
        mm = np.asarray(self.flat.buffers.mat_meta)
        return 1 if bool(np.any(mm[:, 4] >= 1)) else 0

    def _predict_frame_ms(self, s: float) -> float:
        cfg = self.config
        mpx = cfg.width * cfg.height / 1e6
        t = (self._COST_FIXED_MS
             + mpx * s * s * (self._COST_BASE_NS
                              + self._scene_taps() * self._COST_TAP_NS))
        return t + (self._COST_BLIT_MS if s < 1.0 else 0.0)

    def _pick_auto_scale(self) -> float:
        """Largest render scale in [auto_scale_min, 1] the cost model
        predicts hits config.target_fps (1.0 when no target is set or the
        native extent is already under budget)."""
        cfg = self.config
        if cfg.target_fps is None:
            return 1.0
        budget_ms = self._COST_MARGIN * 1000.0 / cfg.target_fps
        s = 1.0
        while s > cfg.auto_scale_min and self._predict_frame_ms(s) > budget_ms:
            s = round(s - 0.05, 2)
        return max(s, cfg.auto_scale_min)

    # -- per-frame ------------------------------------------------------------

    def frame_params(self) -> FrameParams:
        """update_scene's uniform block (vk_engine.cpp:1479-1512).

        Static pieces are uploaded once and cached; per frame only the view
        matrix crosses to the device (one small transfer).
        """
        cfg = self.config
        key = (cfg, self.current_background_effect)
        if getattr(self, "_params_cache_key", None) != key:
            proj = math3d.vulkan_perspective(
                math3d.radians(cfg.fov_y_deg), cfg.aspect, cfg.z_near, cfg.z_far)
            if self.current_background_effect == 0:
                d1, d2 = cfg.gradient_data1, cfg.gradient_data2
            else:
                d1, d2 = cfg.sky_data1, (0.0, 0.0, 0.0, 0.0)
            self._params_static = FrameParams(
                view=jnp.eye(4, dtype=jnp.float32),
                proj=jnp.asarray(proj),
                bg_effect=jnp.int32(self.current_background_effect),
                bg_data1=jnp.asarray(d1, jnp.float32),
                bg_data2=jnp.asarray(d2, jnp.float32),
                ambient=jnp.asarray(cfg.ambient_color, jnp.float32),
                sun_dir=jnp.asarray(cfg.sunlight_direction, jnp.float32),
                sun_color=jnp.asarray(cfg.sunlight_color, jnp.float32),
            )
            self._params_cache_key = key
        view = self.camera.get_view_matrix()
        return self._params_static._replace(view=jnp.asarray(view))

    def update_scene(self, top_matrix=None,
                     refresh_transforms: bool = False) -> FrameParams:
        t0 = time.perf_counter()
        self.camera.update()
        if refresh_transforms or top_matrix is not None:
            # animated nodes: re-collect node matrices (the reference
            # re-emits the whole draw list per frame, vk_engine.cpp:1479-1512)
            self.flat.refresh_transforms(self.scene, top_matrix)
        params = self.frame_params()
        self.stats.scene_update_time = (time.perf_counter() - t0) * 1000.0
        return params

    def draw_device(self, params: Optional[FrameParams] = None):
        """Render one frame, leaving the image on device (the swapchain
        analog: presenting never copies to host in the reference either).
        Returns (image device array, aux dict of device scalars)."""
        if params is None:
            params = self.update_scene()
        cfg = self.config
        if getattr(self, "mesh", None) is not None:
            # sharded product path: same statics, composited over the mesh;
            # aux counters composite too (psum/pmax collectives), so stats
            # and deferred-path cap escalation work exactly as single-chip
            from tpu_renderer.parallel.multichip import render_frame_multichip

            image, aux = render_frame_multichip(
                self.flat.buffers, params, mesh=self.mesh,
                tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                fp16=cfg.framebuffer_fp16,
                transp_textured=self._transp_textured(),
                fused=self._fused,
                trilinear=self._trilinear, pot=self._pot,
                **self._extents(),
                **self._caps,
            )
        else:
            image, aux = render_frame(
                self.flat.buffers, params,
                tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                fp16=cfg.framebuffer_fp16,
                transp_textured=self._transp_textured(),
                fused=self._fused,
                trilinear=self._trilinear, pot=self._pot,
                bg_fb=self._bg_fb_cached(params),
                **self._extents(),
                **self._caps,
            )
        self.frame_number += 1
        self._last_aux = aux
        return image, aux

    def _bg_fb_cached(self, params: FrameParams):
        """Background framebuffer, cached across frames: a pure function of
        the bg effect/params (frozen config) and the draw extent, so the
        per-frame paths (draw/draw_pipelined) skip its cost the
        same way render_frames hoists it out of the bench scan."""
        from tpu_renderer.pipeline import background_fb

        ext = self._extents()
        key = (self.current_background_effect, ext["width"], ext["height"])
        if getattr(self, "_bg_key", None) != key:
            cfg = self.config
            self._bg_fb = background_fb(
                params, width=ext["width"], height=ext["height"],
                tile_h=cfg.tile_h, tile_w=cfg.tile_w)
            self._bg_key = key
        return self._bg_fb

    def _extents(self) -> dict:
        """Render + output extents: render_scale shrinks the draw extent and
        the frame upscale-blits to the window extent (the reference's
        _render_scale path made live, vk_engine.cpp:1220-1222). With
        config.target_fps set, the auto-quality scale (never above the
        configured render_scale) applies instead."""
        cfg = self.config
        s = cfg.render_scale
        if cfg.target_fps is not None:
            s = min(s, getattr(self, "_auto_scale", 1.0))
        if s == 1.0:
            return dict(width=cfg.width, height=cfg.height)
        # derive the height from the EFFECTIVE width scale so non-round
        # scales can't break the aspect ratio (independent rounding of both
        # dims stretched the blit by up to ~1 px worth of anisotropy)
        w = max(1, int(round(cfg.width * s)))
        h = max(1, int(round(cfg.height * w / cfg.width)))
        return dict(width=w, height=h,
                    out_width=cfg.width, out_height=cfg.height)

    def draw(self, with_stats: bool = True, hud: bool = False) -> np.ndarray:
        """Render one frame; returns the (H, W, 4) uint8 image on host.

        On the default fused path nothing can overflow (uncapped slab bins).
        On the deferred path (config.fused = False), a frame that overflows
        a binning capacity escalates the caps and the SAME frame (same
        camera params — the scene is NOT re-integrated) redraws before
        returning, so the caller never sees dropped geometry (the reference
        pipeline has no capacity cliff to begin with, vk_engine.cpp:1453).

        hud=True burns the stats overlay into the frame (the ImGui window,
        vk_engine.cpp:1175-1191)."""
        t0 = time.perf_counter()
        params = self.update_scene()
        image, aux = self.draw_device(params)
        if with_stats:
            if self._fused:
                # fused dense bins are uncapped: overflow is structurally
                # impossible, so ONE batched counter fetch suffices (the
                # escalation loop below would re-fetch aux up to 4x per draw
                # for nothing)
                self._update_stats(aux)
            else:
                for _ in range(4):
                    caps = dict(self._caps)
                    self._update_stats(aux)  # escalates caps on overflow
                    if self._caps == caps:
                        break
                    image, aux = self.draw_device(params)
        from tpu_renderer.present import unpack_u8

        out = unpack_u8(np.asarray(image))
        self.stats.mesh_draw_time = (time.perf_counter() - t0) * 1000.0
        if hud:
            from tpu_renderer.hud import draw_stats

            out = out.copy()
            draw_stats(out, self.stats)
        return out

    # -- pipelined interactive path (FRAME_OVERLAP analog) -------------------

    FRAME_OVERLAP = 3  # frames in flight (vk_engine.h:77)

    def draw_pipelined(self, hud: bool = False,
                       stats_interval: int = 30,
                       present_cells=None):
        """Render one frame with FRAME_OVERLAP frames in flight; returns the
        host image of the frame submitted FRAME_OVERLAP-1 calls ago (None
        while the pipeline fills).

        The reference never presents the frame it just recorded either — it
        keeps 3 frames in flight and blocks only on the fence 3 frames back
        (vk_engine.cpp:1226-1240). Here: dispatch frame N, start its async
        device->host copy, then consume frame N-2's (already-transferred)
        image — the host transfer of one frame overlaps the device compute
        of the next two. Stats (one small device fetch) refresh every
        `stats_interval` frames instead of every frame; on the deferred path
        that delays overflow-escalation by up to an interval (the default
        fused path cannot overflow).
        """
        from collections import deque

        from tpu_renderer.present import unpack_u8

        if not hasattr(self, "_inflight"):
            import concurrent.futures

            self._inflight = deque()
            # one fetch thread: the blocking device->host read of frame
            # N-2 releases the GIL while it waits, overlapping the main
            # thread's dispatch of frame N
            self._fetcher = concurrent.futures.ThreadPoolExecutor(1)
        t0 = time.perf_counter()
        params = self.update_scene()
        image, aux = self.draw_device(params)
        if present_cells is not None:
            # present only the terminal raster's samples: a device-side
            # nearest subsample (same index map as frame_to_halfblocks)
            # shrinks the per-frame host transfer from megabytes to
            # kilobytes — the swapchain-present analog for a terminal
            cols, rows = present_cells
            h, w = image.shape
            ys = (np.arange(rows * 2) * (h / (rows * 2))).astype(np.int32)                 .clip(0, h - 1)
            xs = (np.arange(cols) * (w / cols)).astype(np.int32).clip(0, w - 1)
            image = image[jnp.asarray(ys)][:, jnp.asarray(xs)]
        image.copy_to_host_async()
        fut = self._fetcher.submit(np.asarray, image)
        self._inflight.append((fut, aux, self.frame_number))
        if len(self._inflight) < self.FRAME_OVERLAP:
            return None
        fut_old, aux_old, fno = self._inflight.popleft()
        out = unpack_u8(fut_old.result())
        if stats_interval and (fno - 1) % stats_interval == 0:
            self._update_stats(aux_old)
        self.stats.mesh_draw_time = (time.perf_counter() - t0) * 1000.0
        if hud and present_cells is None:
            from tpu_renderer.hud import draw_stats

            out = out.copy()
            draw_stats(out, self.stats)
        return out

    def flush_pipelined(self):
        """Drain in-flight frames (end of an interactive session)."""
        from tpu_renderer.present import unpack_u8

        out = None
        while getattr(self, "_inflight", None):
            fut, aux, _ = self._inflight.popleft()
            out = unpack_u8(fut.result())
        return out

    def _update_stats(self, aux) -> None:
        # one batched device->host transfer for all counters (the static
        # per-scene transparent counts were cached in _compute_caps)
        keys = sorted(aux.keys())
        vals = np.asarray(jnp.stack([aux[k].astype(jnp.int32) for k in keys])) \
            if keys else np.zeros(0, np.int32)
        a = dict(zip(keys, vals.tolist()))
        self.stats.triangle_count = (a.get("opaque_triangles",
                                           self._n_opaque_tris)
                                     + self._n_transp_tris)
        self.stats.drawcall_count = (a.get("visible_opaque_draws",
                                           self._n_opaque_draws)
                                     + self._n_transp_draws)
        chunk_of = (a.get("bin_overflow", 0)
                    + a.get("bin_overflow_transparent", 0))
        tri_of = (a.get("bin_overflow_tris", 0)
                  + a.get("bin_overflow_transparent_tris", 0))
        if chunk_of or tri_of:
            import logging

            logging.getLogger(__name__).warning(
                "bin overflow: %d chunk / %d tri entries dropped — escalating "
                "caps (re-jits on the next frame)", chunk_of, tri_of)
            self._escalate_caps(chunks=chunk_of > 0, tris=tri_of > 0)

    def _escalate_caps(self, chunks: bool = True, tris: bool = True) -> None:
        """Dense-scene fallback: double the OVERFLOWING binning capacity
        only (bounded) — doubling both would widen the refine sort for
        nothing. The next frame re-jits with the larger static shapes; the
        analog of the reference's growable descriptor pools
        (vk_descriptors.cpp:70-170).
        """
        c = self._caps
        self._caps = dict(
            bin_cap=min(c["bin_cap"] * 2, 8192) if chunks else c["bin_cap"],
            tri_cap=min(c["tri_cap"] * 2, 16384) if tris else c["tri_cap"],
        )

    def _transp_textured(self) -> bool:
        """Static: does any transparent material bind a real texture?"""
        from tpu_renderer.scene import TEX_WHITE

        return any(m.transparent and m.tex != TEX_WHITE
                   for m in self.scene.materials)

    # -- frame loop (vk_engine.cpp:1161-1203) --------------------------------

    def run(self, n_frames: int, on_frame=None) -> np.ndarray:
        """Headless run(): n_frames of update+draw; returns the last frame.

        on_frame(engine, frame_idx, image) may inject input (camera keys /
        cursor) — the replacement for the GLFW callbacks (camera.h:33-41).
        """
        image = None
        for i in range(n_frames):
            t0 = time.perf_counter()
            image = self.draw()
            self.stats.frame_time = (time.perf_counter() - t0) * 1000.0
            if on_frame is not None:
                on_frame(self, i, image)
        return image

    def resize(self, width: int, height: int) -> None:
        """resize_swapchain analog (vk_engine.cpp:1520-1534): re-jit at the
        new static extent (cached per extent by jax.jit)."""
        self.config = self.config.with_extent(width, height)
        self._compute_caps()

    def cleanup(self) -> None:
        self.scene = None
        self.flat = None
