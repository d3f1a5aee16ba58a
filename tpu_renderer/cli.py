"""Command-line entry point — replaces main.cpp + the GLFW window loop with
headless rendering (PNG output) and a benchmark mode.

    python -m tpu_renderer.cli render scene.glb --out frame.png
    python -m tpu_renderer.cli demo --grid 12 --out demo.png
    python -m tpu_renderer.cli milestone colored_triangle --out tri.png
    python -m tpu_renderer.cli benchmark --frames 120 --width 1920 --height 1080
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from tpu_renderer import milestones, resources
from tpu_renderer.config import RendererConfig
from tpu_renderer.engine import Engine
from tpu_renderer.present import save_png
from tpu_renderer.utils.compile_cache import enable_compile_cache


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--width", type=int, default=1700)    # vk_engine.h:219
    p.add_argument("--height", type=int, default=900)
    p.add_argument("--out", default="frame.png")
    p.add_argument("--camera", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--yaw", type=float, default=0.0)
    p.add_argument("--pitch", type=float, default=0.0)
    p.add_argument("--background", type=int, default=0, choices=(0, 1),
                   help="0=gradient (default white), 1=sky")
    p.add_argument("--render-scale", type=float, default=1.0,
                   help="draw-extent scale; <1 renders fewer pixels and "
                        "linear-blits up (vk_engine.cpp:1220-1222 made live)")
    p.add_argument("--target-fps", type=float, default=None,
                   help="auto quality: engage the render-scale lever when "
                        "the measured cost model predicts the scene misses "
                        "this target at native extent")
    p.add_argument("--multichip", default=None, metavar="ROWSxTRI",
                   help="shard the frame over a ROWSxTRI device mesh "
                        "(e.g. 2x4): framebuffer row bands over 'rows', "
                        "triangles over 'tri'; the backend must expose "
                        "ROWS*TRI devices")


def _parse_multichip(args):
    s = getattr(args, "multichip", None)
    if not s:
        return None
    try:
        rows, tri = (int(v) for v in s.lower().split("x"))
        assert rows >= 1 and tri >= 1
    except Exception:
        raise SystemExit(f"bad --multichip {s!r}: expected ROWSxTRI, e.g. 2x4")
    return rows, tri


def _make_engine(args, camera_default=(30.0, 0.0, -85.0)) -> Engine:
    cam = tuple(args.camera) if args.camera else camera_default
    cfg = RendererConfig(width=args.width, height=args.height,
                         camera_position=cam,
                         background_effect=args.background,
                         render_scale=getattr(args, "render_scale", 1.0),
                         target_fps=getattr(args, "target_fps", None),
                         multichip=_parse_multichip(args))
    eng = Engine(cfg)
    eng.camera.yaw = np.float32(args.yaw)
    eng.camera.pitch = np.float32(args.pitch)
    return eng


def cmd_render(args) -> int:
    eng = _make_engine(args)
    eng.init(scene_path=args.scene, variant=args.variant)
    img = eng.draw()
    save_png(img, args.out)
    print(f"wrote {args.out}  ({eng.stats.triangle_count} tris, "
          f"{eng.stats.drawcall_count} draws, {eng.stats.mesh_draw_time:.2f} ms)")
    return 0


def cmd_demo(args) -> int:
    import tempfile

    from tpu_renderer.utils.demo import build_demo_glb

    path = tempfile.mktemp(suffix=".glb")
    build_demo_glb(path, grid=args.grid, seed=args.seed)
    eng = _make_engine(args, camera_default=(0.0, 4.0, args.grid * 2.2))
    eng.camera.pitch = np.float32(args.pitch - 0.15)
    eng.init(scene_path=path)
    img = eng.draw()
    save_png(img, args.out)
    print(f"wrote {args.out}  ({eng.stats.triangle_count} tris, "
          f"{eng.stats.drawcall_count} draws, {eng.stats.mesh_draw_time:.2f} ms)")
    return 0


def cmd_milestone(args) -> int:
    # the five BASELINE.json milestone configs; textured_quad uses the
    # checkerboard placeholder so it runs without an asset argument
    builders = {
        "colored_triangle": milestones.colored_triangle_scene,
        "colored_quad": milestones.colored_quad_scene,
        "textured_quad": lambda: milestones.textured_quad_scene(
            resources.make_error_checkerboard()),
        "background_gradient": None,  # background-only frame, gradient effect
        "background_sky": None,       # background-only frame, sky effect
    }
    if args.name == "--list" or args.name == "list":
        print("\n".join(builders))
        return 0
    if args.name not in builders:
        print(f"unknown milestone {args.name}; choices: {list(builders)}")
        return 1
    cfg = RendererConfig(width=args.width, height=args.height,
                         background_effect=1 if args.name == "background_sky" else 0,
                         **milestones.UNLIT_CONFIG_OVERRIDES)
    eng = Engine(cfg)
    scene = builders[args.name]() if builders[args.name] else None
    eng.init(scene=scene)
    # milestones are authored in NDC: identity view/proj
    import jax.numpy as jnp

    params = eng.frame_params()._replace(view=jnp.eye(4, dtype=jnp.float32),
                                         proj=jnp.eye(4, dtype=jnp.float32))
    from tpu_renderer.pipeline import render_frame

    img, _ = render_frame(eng.flat.buffers, params, width=args.width,
                          height=args.height, **eng._caps)
    from tpu_renderer.present import unpack_u8

    save_png(unpack_u8(np.asarray(img)), args.out)
    print(f"wrote {args.out}")
    return 0


def cmd_benchmark(args) -> int:
    import tempfile

    from tpu_renderer.utils.demo import build_demo_glb

    if args.scene:
        path = args.scene
        camera = tuple(args.camera) if args.camera else (30.0, 0.0, -85.0)
    else:
        path = tempfile.mktemp(suffix=".glb")
        build_demo_glb(path, grid=args.grid, seed=args.seed)
        camera = tuple(args.camera) if args.camera else (0.0, 4.0, args.grid * 2.2)

    cfg = RendererConfig(width=args.width, height=args.height,
                         camera_position=camera,
                         background_effect=args.background,
                         render_scale=getattr(args, "render_scale", 1.0),
                         multichip=_parse_multichip(args))
    eng = Engine(cfg)
    eng.camera.pitch = np.float32(args.pitch - 0.15)
    eng.camera.yaw = np.float32(args.yaw)
    eng.init(scene_path=path)

    # warmup (compile)
    eng.draw()
    # orbit slowly so frames differ (mirrors an interactive session)
    t0 = time.perf_counter()
    frames = args.frames
    for i in range(frames):
        eng.camera.yaw = np.float32(args.yaw + 0.002 * i)
        eng.draw()
    dt = time.perf_counter() - t0
    fps = frames / dt
    mtris = eng.stats.triangle_count * fps / 1e6
    result = {
        "fps": round(fps, 2),
        "frame_ms": round(1000 * dt / frames, 3),
        "triangles": eng.stats.triangle_count,
        "mtris_per_sec": round(mtris, 2),
        "drawcalls": eng.stats.drawcall_count,
        "width": args.width,
        "height": args.height,
    }
    print(json.dumps(result))
    return 0


def cmd_view(args) -> int:
    """Interactive terminal viewer (the GLFW window loop analog)."""
    import tempfile

    from tpu_renderer.utils.demo import build_demo_glb
    from tpu_renderer.viewer import run_viewer

    if args.scene:
        path = args.scene
        camera = tuple(args.camera) if args.camera else (0.0, 6.0, 20.0)
    else:
        path = tempfile.mktemp(suffix=".glb")
        build_demo_glb(path, grid=args.grid, seed=args.seed)
        camera = tuple(args.camera) if args.camera else (0.0, 4.0, args.grid * 2.2)
    cfg = RendererConfig(width=args.width, height=args.height,
                         camera_position=camera,
                         background_effect=args.background,
                         render_scale=getattr(args, "render_scale", 1.0),
                         multichip=_parse_multichip(args))
    eng = Engine(cfg)
    eng.camera.pitch = np.float32(args.pitch - 0.15)
    eng.init(scene_path=path)
    keys = list(args.keys) if args.keys is not None else None
    n = run_viewer(eng, n_frames=args.frames, keys=keys,
                   cols=args.cols, rows=args.rows)
    print(f"\n{n} frames")
    return 0


def main(argv=None) -> int:
    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="tpu_renderer")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a glTF/GLB scene to PNG")
    p.add_argument("scene")
    p.add_argument("--variant", default=None,
                   help="KHR_materials_variants selection (name or index)")
    _add_common(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("demo", help="render the procedural demo scene")
    p.add_argument("--grid", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    _add_common(p)
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("milestone", help="render a BASELINE milestone config")
    p.add_argument("name")
    _add_common(p)
    p.set_defaults(fn=cmd_milestone)

    p = sub.add_parser("view", help="interactive terminal viewer (wasd + arrows)")
    p.add_argument("--scene", default=None)
    p.add_argument("--grid", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N frames (default: run until q/ESC)")
    p.add_argument("--keys", default=None,
                   help="scripted per-frame input string (headless/testing)")
    p.add_argument("--cols", type=int, default=96)
    p.add_argument("--rows", type=int, default=24)
    _add_common(p)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("benchmark", help="steady-state FPS benchmark")
    p.add_argument("--scene", default=None)
    p.add_argument("--grid", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=60)
    _add_common(p)
    p.set_defaults(fn=cmd_benchmark)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
