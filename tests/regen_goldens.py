"""Regenerate the golden PNGs for tests/test_goldens.py (CPU backend).

Run after an INTENTIONAL rendering-semantics change:
    python tests/regen_goldens.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def scenes():
    from tpu_renderer import milestones
    from tpu_renderer.utils.demo import checker_texture

    yield "triangle", milestones.colored_triangle_scene(), {}
    yield "quad_sky", milestones.colored_quad_scene(), dict(
        bg_effect=1, bg1=(0.1, 0.2, 0.4, 0.97))
    yield "textured", milestones.textured_quad_scene(checker_texture(32, 4)), {}


def render_structure(width: int, height: int):
    """Flagship full-scene golden: the structure scene through the whole
    loader + engine path (the reference's structure.glb flow,
    vk_engine.cpp:196-200). The 1080p variant is the slow-tier golden; the
    480x270 one covers the same path in the fast tier."""
    import tempfile

    from tpu_renderer.config import RendererConfig
    from tpu_renderer.engine import Engine
    from tpu_renderer.utils.demo import build_structure_glb

    path = os.path.join(tempfile.gettempdir(), "structure_golden.glb")
    build_structure_glb(path, seed=0)
    cfg = RendererConfig(width=width, height=height, background_effect=1,
                         camera_position=(0.0, 10.0, 42.0))
    eng = Engine(cfg)
    eng.camera.pitch = np.float32(-0.18)
    eng.init(scene_path=path)
    return np.asarray(eng.draw(hud=False))


def render_fast():
    from tests.test_pipeline_golden import render

    for name, scene, kw in scenes():
        img, _ = render(scene, **kw)
        yield name, np.asarray(img)
    yield "structure_480p", render_structure(480, 270)


def render_all():
    yield from render_fast()
    yield "structure_1080p", render_structure(1920, 1080)


if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"  # the goldens are CPU renders
    from tpu_renderer.present import save_png

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, img in render_all():
        save_png(img, os.path.join(GOLDEN_DIR, f"{name}.png"))
        print("wrote", name)
