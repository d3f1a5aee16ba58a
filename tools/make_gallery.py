"""Regenerate the docs/gallery renders (on the GPU; minutes of compiles).

Usage, from the repository root: python tools/make_gallery.py
"""

import os
import sys
import tempfile

sys.path.insert(0, __file__.rsplit("/", 2)[0])  # repo root for tpu_renderer

import numpy as np

GALLERY = os.path.join(os.path.dirname(__file__), "..", "docs", "gallery")


def main():
    from tpu_renderer import milestones
    from tpu_renderer.cli import main as cli_main
    from tpu_renderer.config import RendererConfig
    from tpu_renderer.engine import Engine
    from tpu_renderer.present import save_png
    from tpu_renderer.utils.demo import build_structure_glb

    os.makedirs(GALLERY, exist_ok=True)
    W, H = 960, 540

    def out(name):
        return os.path.join(GALLERY, name)

    cli_main(["milestone", "colored_triangle", "--width", str(W),
              "--height", str(H), "--out", out("01_colored_triangle.png")])
    cli_main(["milestone", "colored_quad", "--width", str(W),
              "--height", str(H), "--out", out("02_colored_quad.png")])
    cli_main(["milestone", "textured_quad", "--width", str(W),
              "--height", str(H), "--out", out("03_textured_quad.png")])
    cli_main(["milestone", "background_sky", "--width", str(W),
              "--height", str(H), "--out", out("04_sky_background.png")])
    cli_main(["demo", "--grid", "6", "--width", str(W), "--height", str(H),
              "--background", "1", "--out", out("05_demo_scene.png")])

    path = os.path.join(tempfile.gettempdir(), "structure_gallery.glb")
    build_structure_glb(path, seed=0)
    cfg = RendererConfig(width=W, height=H, background_effect=1,
                         camera_position=(0.0, 10.0, 42.0))
    eng = Engine(cfg)
    eng.camera.pitch = np.float32(-0.18)
    eng.init(scene_path=path)
    save_png(eng.draw(), out("06_structure_scene.png"))
    print("gallery written to", os.path.abspath(GALLERY))


if __name__ == "__main__":
    sys.exit(main())
