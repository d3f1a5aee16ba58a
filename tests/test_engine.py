"""Engine façade: init/run/draw loop, camera interaction, stats, resize."""

import numpy as np
import pytest

from tpu_renderer.config import RendererConfig
from tpu_renderer.engine import Engine
from tpu_renderer.utils.demo import build_demo_glb
from tpu_renderer.utils.profiling import FrameTimer, stats_text


def _engine(tmp_path, w=256, h=64, grid=2):
    path = str(tmp_path / "scene.glb")
    build_demo_glb(path, grid=grid)
    cfg = RendererConfig(width=w, height=h, camera_position=(0.0, 2.0, 12.0))
    eng = Engine(cfg)
    eng.init(scene_path=path)
    return eng


def test_draw_and_stats(tmp_path):
    eng = _engine(tmp_path)
    img = eng.draw()
    assert img.shape == (64, 256, 4) and img.dtype == np.uint8
    assert eng.stats.triangle_count > 0
    assert eng.stats.drawcall_count > 0
    assert eng.frame_number == 1
    assert "triangles" in stats_text(eng.stats)


def test_run_loop_with_camera_input(tmp_path):
    eng = _engine(tmp_path)
    frames = []

    def on_frame(engine, i, image):
        frames.append(image.copy())
        # simulated GLFW input: press W, move mouse (camera.h:33-41 path)
        engine.camera.process_key("w", True)
        engine.camera.process_cursor(10.0 * i, 0.0)

    eng.run(3, on_frame=on_frame)
    assert len(frames) == 3
    # camera moved forward => later frames differ
    assert not np.array_equal(frames[0], frames[2])
    assert eng.camera.position[2] != 12.0 or eng.camera.yaw != 0.0


@pytest.mark.slow
def test_resize_rejits(tmp_path):
    eng = _engine(tmp_path)
    eng.draw()
    eng.resize(128, 32)
    img = eng.draw()
    assert img.shape == (32, 128, 4)


def test_background_effect_switch(tmp_path):
    eng = _engine(tmp_path)
    img_grad = eng.draw()
    eng.current_background_effect = 1  # sky (vk_engine.h:137 selector)
    img_sky = eng.draw()
    assert not np.array_equal(img_grad, img_sky)
    # sky top rows are dark; gradient default is white
    assert img_sky[0, 0, 2] < 100 and img_grad[0, 0, 2] == 255


def test_empty_scene_background_only():
    eng = Engine(RendererConfig(width=128, height=32))
    eng.init()
    img = eng.draw()
    assert (img == 255).all()  # solid white default gradient


def test_frame_timer():
    t = FrameTimer()
    for _ in range(3):
        with t:
            pass
    assert t.mean_ms >= 0 and len(t.samples) == 3


def test_hud_overlay(tmp_path):
    eng = _engine(tmp_path)
    img_plain = eng.draw()
    img_hud = eng.draw(hud=True)
    assert not np.array_equal(img_plain[:40, :150], img_hud[:40, :150])


def test_animated_node_transforms(tmp_path):
    """Per-frame node animation: the analog of the reference's every-frame
    scene re-flatten (update_scene, vk_engine.cpp:1487-1490 rotate path)."""
    from tpu_renderer import math3d

    eng = _engine(tmp_path)
    img0 = eng.draw()
    # move every cube node (note the reference's refresh_transform quirk:
    # rotating only a PARENT node has no effect on children — parity kept)
    for name, node in eng.scene.node_by_name.items():
        if name.startswith("cube_"):
            node.local_transform = (
                math3d.translate((0, 1.5, 0)) @ node.local_transform)
            node.refresh_transform(np.eye(4, dtype=np.float32))
    eng.update_scene(refresh_transforms=True)
    img1 = eng.draw()
    assert not np.array_equal(img0, img1)


@pytest.mark.slow
def test_dense_scene_never_overflows():
    """A scene whose per-tile chunk count exceeds the old default bin_cap
    renders completely in one draw: the fused path walks UNCAPPED slab bins,
    so there is no capacity to overflow and no escalate-and-redraw — parity
    with the capacity-cliff-free reference rasterizer (vk_engine.cpp:1453)."""
    import tpu_renderer.scene as sm
    from tpu_renderer import milestones
    from tpu_renderer.config import RendererConfig
    from tpu_renderer.engine import Engine
    from tpu_renderer.kernels import raster

    # stack quads in one spot until the chunk count exceeds the initial
    # bin_cap of 512 — every chunk lands in the same tiles
    scene = milestones.colored_quad_scene(z0=0.5, z1=0.5)
    scene.colors = np.tile(np.array([0, 1, 0, 1], np.float32), (4, 1))
    n_copies = 520 * raster.CHUNK // 2  # 2 tris per quad
    for k in range(n_copies - 1):
        node = sm.MeshNode(0, f"c{k}")
        node.refresh_transform(np.eye(4, dtype=np.float32))
        scene.nodes.append(node)
        scene.top_nodes.append(node)

    cfg = RendererConfig(width=128, height=32,
                         **milestones.UNLIT_CONFIG_OVERRIDES)
    eng = Engine(cfg)
    eng.init(scene=scene)
    import jax.numpy as jnp

    eng._params_cache = None
    params = eng.frame_params()._replace(view=jnp.eye(4, dtype=jnp.float32),
                                         proj=jnp.eye(4, dtype=jnp.float32))
    eng.update_scene = lambda **kw: params  # identity camera
    assert eng._caps["bin_cap"] <= 512
    img = eng.draw()
    a = {k: int(np.asarray(v)) for k, v in eng._last_aux.items()}
    assert a["bin_overflow"] == 0, a
    # no escalation happened — the slab loop absorbed the density
    assert eng._caps["bin_cap"] <= 512
    # the quad actually rendered (green center)
    assert img[16, 64][1] > 150


@pytest.mark.slow
def test_render_scale_upscale_blit():
    """render_scale < 1 draws at the scaled extent and linear-blits up to
    the window extent (the reference's _render_scale path made live,
    vk_engine.cpp:1220-1222; filter from vkCmdBlitImage2 VK_FILTER_LINEAR,
    vk_images.cpp:33-64)."""
    from tpu_renderer import milestones
    from tpu_renderer.config import RendererConfig

    scene = milestones.colored_triangle_scene()
    imgs = {}
    for s in (1.0, 0.5):
        cfg = RendererConfig(width=256, height=128, render_scale=s,
                             **milestones.UNLIT_CONFIG_OVERRIDES)
        eng = Engine(cfg)
        eng.init(scene=scene)
        import jax.numpy as jnp

        params = eng.frame_params()._replace(
            view=jnp.eye(4, dtype=jnp.float32),
            proj=jnp.eye(4, dtype=jnp.float32))
        img, _ = eng.draw_device(params)
        from tpu_renderer.present import unpack_u8

        imgs[s] = unpack_u8(np.asarray(img))
    assert imgs[0.5].shape == imgs[1.0].shape == (128, 256, 4)
    # the scaled render is blurrier but must be the same picture: compare
    # 8x8-box-averaged images
    a = imgs[1.0][..., :3].astype(np.float32).reshape(16, 8, 32, 8, 3).mean((1, 3))
    b = imgs[0.5][..., :3].astype(np.float32).reshape(16, 8, 32, 8, 3).mean((1, 3))
    assert np.abs(a - b).max() < 48, np.abs(a - b).max()
    # and the triangle's center pixel shades identically
    np.testing.assert_allclose(imgs[0.5][64, 128], imgs[1.0][64, 128], atol=30)


@pytest.mark.slow
def test_render_scale_supersampling():
    """render_scale > 1 = SSAA: draw at 2x, linear-blit down. Edges must
    come out smoother (more intermediate values) than the native render."""
    from tpu_renderer import milestones
    from tpu_renderer.config import RendererConfig

    import jax.numpy as jnp
    from tpu_renderer.present import unpack_u8

    scene = milestones.colored_triangle_scene()
    imgs = {}
    for s in (1.0, 2.0):
        cfg = RendererConfig(width=128, height=64, render_scale=s,
                             **milestones.UNLIT_CONFIG_OVERRIDES)
        eng = Engine(cfg)
        eng.init(scene=scene)
        params = eng.frame_params()._replace(
            view=jnp.eye(4, dtype=jnp.float32),
            proj=jnp.eye(4, dtype=jnp.float32))
        img, _ = eng.draw_device(params)
        imgs[s] = unpack_u8(np.asarray(img))
    assert imgs[2.0].shape == (64, 128, 4)
    # same picture coarsely
    a = imgs[1.0][..., :3].astype(np.float32).reshape(8, 8, 16, 8, 3).mean((1, 3))
    b = imgs[2.0][..., :3].astype(np.float32).reshape(8, 8, 16, 8, 3).mean((1, 3))
    assert np.abs(a - b).max() < 40
    # SSAA produces antialiased edge pixels: count "partial coverage" values
    def partials(im):
        g = im[..., 1].astype(int)
        return int(((g > 32) & (g < 223)).sum())

    assert partials(imgs[2.0]) > partials(imgs[1.0])


def test_deferred_dense_scene_escalates_and_redraws_same_frame():
    """config.fused=False keeps the capped deferred path: a dense scene
    overflows, the caps escalate, and the SAME frame (same camera params)
    redraws before draw() returns — the growable-descriptor-pool analog
    (vk_descriptors.cpp:70-170)."""
    import tpu_renderer.scene as sm
    from tpu_renderer import milestones
    from tpu_renderer.config import RendererConfig

    scene = milestones.colored_quad_scene(z0=0.5, z1=0.5)
    scene.colors = np.tile(np.array([0, 1, 0, 1], np.float32), (4, 1))
    rng = np.random.default_rng(3)
    for k in range(700):
        node = sm.MeshNode(0, f"q{k}")
        m = np.eye(4, dtype=np.float32)
        m[0, 3] = rng.uniform(-0.01, 0.01)
        node.refresh_transform(m)
        node.local_transform = m
        scene.nodes.append(node)
        scene.top_nodes.append(node)
    cfg = RendererConfig(width=128, height=32, fused=False,
                         **milestones.UNLIT_CONFIG_OVERRIDES)
    eng = Engine(cfg)
    eng.init(scene=scene)
    eng._caps = dict(bin_cap=64, tri_cap=128)  # force overflow
    import jax.numpy as jnp

    params = eng.frame_params()._replace(view=jnp.eye(4, dtype=jnp.float32),
                                         proj=jnp.eye(4, dtype=jnp.float32))
    calls = []
    eng.update_scene = lambda **kw: calls.append(1) or params
    img = eng.draw()
    # the redraw loop escalated (possibly several times) and the final
    # frame has no drops
    assert eng._caps["bin_cap"] > 64 or eng._caps["tri_cap"] > 128
    a = {k: int(np.asarray(v)) for k, v in eng._last_aux.items()}
    assert a["bin_overflow"] == 0 and a["bin_overflow_tris"] == 0, a
    # the SAME frame params were reused across the redraws: update_scene
    # ran exactly once (no double camera integration)
    assert len(calls) == 1
    assert img[16, 64][1] > 150  # the quad rendered (green center)


def test_multichip_product_path(tmp_path):
    """config.multichip routes Engine.draw through the sharded composite —
    the CLI `--multichip ROWSxTRI` product path (not just the module) —
    and the frame matches the single-chip engine on the same scene."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    path = str(tmp_path / "scene.glb")
    build_demo_glb(path, grid=2)
    kw = dict(width=128, height=64, camera_position=(0.0, 2.0, 12.0),
              fused=False)
    single = Engine(RendererConfig(**kw))
    single.init(scene_path=path)
    img_single = single.draw()

    multi = Engine(RendererConfig(multichip=(2, 2), **kw))
    multi.init(scene_path=path)
    assert multi.mesh is not None
    img_multi = multi.draw()
    # textured scene: composite-order f32 rounding may move a channel one
    # u8 step (the tests/test_multichip.py textured tolerance)
    diff = np.abs(img_multi.astype(np.int32) - img_single.astype(np.int32))
    assert diff.max() <= 1
    # stats fall back to the static counts on the sharded path
    assert multi.stats.triangle_count > 0


def test_dense_bin_guard_picks_bounded_path(tmp_path):
    """Dense-bin memory guard: scenes past config.dense_bin_max_chunks
    chunks must auto-select the capped deferred path — the fused path's
    uncapped bins are O(n_tiles x n_chunks) (config.dense_bin_max_chunks).

    The decision is host-side arithmetic over triangle counts, so a real
    2M-triangle flatten isn't needed to pin it: 2M tris / CHUNK chunks
    exceeds the default 32768-chunk threshold for every production CHUNK.
    """
    from tpu_renderer.kernels import raster

    cfg = RendererConfig()
    n_chunks_2m = 2_000_000 // raster.CHUNK
    assert n_chunks_2m > cfg.dense_bin_max_chunks  # 2M tris => bounded path

    # integration: a small real scene over a tiny threshold flips the
    # engine to the deferred path and still renders
    eng = _engine(tmp_path)  # grid=2 demo scene, a handful of chunks
    assert eng._fused  # default: under the threshold, fused stays on

    path = str(tmp_path / "scene.glb")
    cfg = RendererConfig(width=256, height=64, dense_bin_max_chunks=1,
                         camera_position=(0.0, 2.0, 12.0))
    eng2 = Engine(cfg)
    eng2.init(scene_path=path)
    assert not eng2._fused  # guard tripped: bounded deferred path
    img = eng2.draw()
    assert img.shape == (64, 256, 4) and img.dtype == np.uint8


def test_auto_quality_target_fps(tmp_path):
    """config.target_fps: the measured cost model engages render scale for
    scenes predicted over budget, leaves scenes it predicts under budget at
    native extent (stock trilinear glTF content at 1080p and 60 FPS, which
    the card meets), and the scaled draw still emits the full window
    extent (upscale blit)."""
    path = str(tmp_path / "tri_scene.glb")
    build_demo_glb(path, grid=2, trilinear=True)

    # stock (trilinear-sampler) content at 1080p is predicted under a 60 FPS
    # budget at native extent -> no scaling
    cfg60 = RendererConfig(width=1920, height=1080, target_fps=60.0,
                           camera_position=(0.0, 2.0, 12.0))
    eng60 = Engine(cfg60)
    eng60.init(scene_path=path)
    assert eng60._trilinear and eng60._scene_taps() == 2
    assert eng60._predict_frame_ms(1.0) < 1000.0 / 60.0
    assert eng60._auto_scale == 1.0
    # a target the model predicts missed at native extent -> a scale < 1
    cfg = RendererConfig(width=1920, height=1080, target_fps=240.0,
                         camera_position=(0.0, 2.0, 12.0))
    eng = Engine(cfg)
    eng.init(scene_path=path)
    assert cfg.auto_scale_min <= eng._auto_scale < 1.0
    ext = eng._extents()
    assert ext["out_width"] == 1920 and ext["width"] < 1920
    # no target -> native extent regardless of cost
    eng2 = Engine(RendererConfig(width=1920, height=1080,
                                 camera_position=(0.0, 2.0, 12.0)))
    eng2.init(scene_path=path)
    assert eng2._auto_scale == 1.0 and eng2._extents() == {
        "width": 1920, "height": 1080}

    # a scene under budget keeps native extent even WITH a target
    cfg3 = RendererConfig(width=256, height=64, target_fps=60.0,
                          camera_position=(0.0, 2.0, 12.0))
    eng3 = Engine(cfg3)
    eng3.init(scene_path=path)
    assert eng3._auto_scale == 1.0

    # end-to-end: an impossible target floors at auto_scale_min and the
    # draw still returns the window extent
    cfg4 = RendererConfig(width=256, height=64, target_fps=10000.0,
                          camera_position=(0.0, 2.0, 12.0))
    eng4 = Engine(cfg4)
    eng4.init(scene_path=path)
    assert eng4._auto_scale == cfg4.auto_scale_min
    img = eng4.draw()
    assert img.shape == (64, 256, 4) and img.dtype == np.uint8


def test_sort_order_reuse_matches_fresh_sort(tmp_path):
    """Temporal-coherence sort reuse (pipeline.frame_sort_orders): a frame
    rendered with a precomputed spatial-sort permutation is bit-identical
    to the fresh per-frame sort at the same camera, and a slightly STALE
    permutation still renders the same image — any permutation is
    semantically valid, only chunk locality shifts. (The product paths
    sort fresh every frame; this pins the hook's semantics.)"""
    import jax.numpy as jnp

    from tpu_renderer.pipeline import frame_sort_orders, render_frame

    path = str(tmp_path / "scene.glb")
    build_demo_glb(path, grid=3)
    cfg = RendererConfig(width=256, height=128,
                         camera_position=(0.0, 2.0, 8.0))
    eng = Engine(cfg)
    eng.init(scene_path=path)
    params = eng.update_scene()
    b = eng.flat.buffers
    kw = dict(width=256, height=128, fused=True,
              transp_textured=eng._transp_textured(),
              trilinear=eng._trilinear, pot=eng._pot)

    fresh, _ = render_frame(b, params, **kw)
    orders = frame_sort_orders(b, params, width=256, height=128,
                               transp_textured=eng._transp_textured())
    assert orders[0] is not None
    reused, _ = render_frame(b, params, sort_orders=orders, **kw)
    assert np.array_equal(np.asarray(fresh), np.asarray(reused))

    # stale: camera rotated ~2.3 deg, frame-0 orders reused
    eng.camera.yaw = np.float32(0.04)
    params2 = eng.update_scene()
    fresh2, _ = render_frame(b, params2, **kw)
    stale2, _ = render_frame(b, params2, sort_orders=orders, **kw)
    a, s = np.asarray(fresh2), np.asarray(stale2)
    assert (a != s).mean() < 1e-3  # z-tie tie-breaks only
