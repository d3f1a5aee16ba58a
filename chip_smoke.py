"""Smoke run of the renderer on one GPU, at full 1080p width.

    python3 chip_smoke.py               # one card: every phase below
    python3 chip_smoke.py --multichip   # four cards: the sharded frame only

Phases (one process; any failure exits non-zero):

1. device    — JAX's platform/kind/count and nvidia-smi's name and power
               limit. Fails unless JAX runs on a GPU.
2. compile   — render_frame compiled at 1920x1080 for the demo, stress and
               textured-transparency scenes (every chunk-walk kernel),
               with the compiled program's memory analysis.
3. passes    — each raster pass on the card, the Pallas kernel against the
               plain XLA walk, on the demo and stress scenes at 1080p:
               opaque, accumulate and peel, plus the capped deferred pass
               against the opaque kernel. z must be bit-equal where the
               triangle ids agree, ids must agree on >= 99.99% of pixels,
               and the shaded u8 image within 1 step on >= 99.9%.
4. frames    — Engine.init + draw + 10 draw_pipelined frames and a 20-frame
               render_frames scan on the demo, trilinear, stress and
               textured-transparency scenes at 1920x1080 (median frame ms).
5. golden    — the structure scene at 1080p against the CPU golden
               tests/goldens/structure_1080p.png (>= 99.9% of pixels within
               2 u8 steps, the tolerance of tests/test_e2e_reference.py).
6. gpu tests — the tests marked `gpu`, in this process.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080


def log(*a):
    print(*a, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# scenes (all generated from seed 0)
# ---------------------------------------------------------------------------


def build_scenes(tmp: str) -> dict:
    """name -> (LoadedScene, camera position): the benchmark's scenes."""
    from tpu_renderer import scene as scene_mod
    from tpu_renderer.utils.demo import build_demo_glb

    out = {}
    for name, grid, tri in (("demo", 64, False), ("trilinear", 64, True),
                            ("stress", 128, False)):
        path = os.path.join(tmp, f"{name}.glb")
        build_demo_glb(path, grid=grid, seed=0, trilinear=tri)
        out[name] = (scene_mod.load_scene(path), (0.0, 6.0, grid * 2.0))
    # textured transparency: the demo scene with its glass material bound to
    # a real texture, so transparency takes the textured peel loop
    scene = scene_mod.load_scene(os.path.join(tmp, "demo.glb"))
    glass = [m for m in scene.materials if m.transparent]
    textured = next(m for m in scene.materials
                    if not m.transparent and m.tex != scene_mod.TEX_WHITE)
    for m in glass:
        m.tex = textured.tex
    out["textured_transparency"] = (scene, (0.0, 6.0, 128.0))
    return out


def make_engine(scene, camera):
    from tpu_renderer.config import RendererConfig
    from tpu_renderer.engine import Engine

    eng = Engine(RendererConfig(width=W, height=H, camera_position=camera))
    eng.camera.pitch = np.float32(-0.18)
    eng.init(scene=scene)
    return eng


def frame_kw(eng) -> dict:
    cfg = eng.config
    return dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                fp16=cfg.framebuffer_fp16,
                transp_textured=eng._transp_textured(), fused=eng._fused,
                trilinear=eng._trilinear, pot=eng._pot,
                **eng._extents(), **eng._caps)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_compile(engines: dict) -> None:
    from tpu_renderer.pipeline import render_frame

    for name in ("demo", "stress", "textured_transparency"):
        eng = engines[name]
        t0 = time.perf_counter()
        params = eng.update_scene()
        # the exact call Engine.draw makes, so its compile hits the cache
        compiled = render_frame.lower(
            eng.flat.buffers, params, bg_fb=eng._bg_fb_cached(params),
            **frame_kw(eng)).compile()
        log(f"[compile] {name}: render_frame compiled in "
            f"{time.perf_counter() - t0:.1f} s; transp_textured="
            f"{eng._transp_textured()}")
        log(f"[compile] {name}: memory_analysis: "
            f"{compiled.memory_analysis()}")


def frame_inputs(eng):
    """The opaque and transparent raster inputs of the engine's current
    frame, built exactly as pipeline.render_frame builds them."""
    import jax
    import jax.numpy as jnp

    from tpu_renderer.kernels import raster, vertex
    from tpu_renderer.kernels.common import pad_extent

    b = eng.flat.buffers
    p = eng.update_scene()
    cfg = eng.config
    wp, hp = pad_extent(W, H, cfg.tile_h, cfg.tile_w)
    tiles = dict(tiles_x=wp // cfg.tile_w, tiles_y=hp // cfg.tile_h,
                 tile_w=cfg.tile_w, tile_h=cfg.tile_h)
    viewproj = jnp.matmul(p.proj, p.view, precision=jax.lax.Precision.HIGHEST)
    vis = vertex.draw_visibility(viewproj, b.draw_model, b.draw_bounds_origin,
                                 b.draw_bounds_extents)
    out = {}
    for key, corners, draw, valid, dvis in (
            ("opaque", b.opaque_corners, b.opaque_tri_draw,
             b.opaque_tri_valid, vis),
            ("transparent", b.transp_corners, b.transp_tri_draw,
             b.transp_tri_valid, jnp.ones_like(vis))):
        rows, aabb, ok = vertex.triangle_setup_rows(
            corners, draw, valid, b.draw_model, dvis, viewproj, W, H,
            sun_dir=p.sun_dir[:3])
        aabb_s, ok_s, rows_s = raster.spatial_sort(aabb, ok, rows)
        caabb, cvalid = raster.chunk_aabbs(aabb_s, ok_s)
        gaabb, gvalid = raster.group_aabbs(aabb_s, ok_s)
        bins, counts = raster.bin_triangles_full(
            caabb, cvalid, gaabb=gaabb, gvalid=gvalid, **tiles)
        out[key] = dict(rows=rows_s, aabb=aabb_s, valid=ok_s, caabb=caabb,
                        cvalid=cvalid, bins=bins, counts=counts)
    light = jnp.concatenate([p.sun_dir[:3], p.sun_color[3:4], p.ambient[:3],
                             jnp.zeros(1, jnp.float32)])
    return out, tiles, p, light


def _shaded_u8(eng, p, rows, tid, hp, wp):
    import jax.numpy as jnp

    from tpu_renderer.kernels import raster, shade
    from tpu_renderer.present import to_packed_u32

    attrs, metas, inv = raster.winner_attributes(rows, tid)
    rgb = shade.shade_fused(attrs, metas, inv, eng.flat.buffers.atlas,
                            p.ambient[:3], p.sun_dir[:3], p.sun_color[3],
                            trilinear=eng._trilinear, pot=eng._pot)
    fb = jnp.concatenate([rgb, jnp.ones((1, hp, wp), jnp.float32)])
    fb = jnp.where((tid >= 0)[None], fb, 0.0)
    img = np.asarray(to_packed_u32(fb, width=W, height=H))
    return img.view(np.uint8).reshape(H, W, 4).astype(np.int32)


def _compare_ids(label, z_k, t_k, z_x, t_x) -> None:
    z_k, t_k, z_x, t_x = (np.asarray(a) for a in (z_k, t_k, z_x, t_x))
    same = t_k == t_x
    n = same.size
    z_bad = int(np.sum(same & (z_k.view(np.int32) != z_x.view(np.int32))))
    agree = same.mean()
    log(f"[passes] {label}: ids differ on {n - int(same.sum())} of {n} px "
        f"(agree {agree:.6%}); z not bit-equal on {z_bad} px where ids agree")
    assert z_bad == 0, f"{label}: z differs where the ids agree"
    assert agree >= 0.9999, f"{label}: ids agree on only {agree:.6%}"


def phase_passes(engines: dict, power: str) -> None:
    import jax
    import jax.numpy as jnp

    from tpu_renderer.kernels import raster

    walks = {"kernel": raster._walk_pallas, "xla": raster._walk_xla}
    for name in ("demo", "stress"):
        eng = engines[name]
        inp, tiles, p, light = frame_inputs(eng)
        hp, wp = tiles["tiles_y"] * tiles["tile_h"], tiles["tiles_x"] * tiles["tile_w"]
        o, t = inp["opaque"], inp["transparent"]
        log(f"[passes] {name}: {o['rows'].shape[0]} opaque + "
            f"{t['rows'].shape[0]} transparent tris; opaque bin entries "
            f"{int(o['counts'].sum())}, max per tile {int(o['counts'].max())}")
        res = {}
        for form, walk in walks.items():
            depth = jax.jit(lambda rows, bins, counts, _w=walk: _w(
                raster._depth_rule, rows, bins, counts, raster._DEPTH_STATE,
                chunk=raster.CHUNK, **tiles))
            accum = jax.jit(lambda rows, bins, counts, z, lt, _w=walk: _w(
                raster._accum_rule, rows, bins, counts, raster._ACCUM_STATE,
                (z,), lt, chunk=raster.CHUNK, **tiles))
            peel = jax.jit(lambda rows, bins, counts, z, last, _w=walk: _w(
                raster._peel_rule, rows, bins, counts, raster._PEEL_STATE,
                (z, last), chunk=raster.CHUNK, **tiles))
            z, tid = depth(o["rows"], o["bins"], o["counts"])
            acc = accum(t["rows"], t["bins"], t["counts"], z, light)
            last = jnp.full((hp, wp), -1, jnp.int32)
            layers = []
            for _ in range(2):
                (best,) = peel(t["rows"], t["bins"], t["counts"], z, last)
                layers.append(best)
                last = jnp.where(best < raster.ID_INF, best, raster.ID_INF)
            jax.block_until_ready((z, tid, acc, layers))
            # time each form once more, now compiled
            t0 = time.perf_counter()
            jax.block_until_ready(depth(o["rows"], o["bins"], o["counts"]))
            res[form] = dict(z=z, tid=tid, acc=acc, layers=layers,
                             ms=1000 * (time.perf_counter() - t0))
        k, x = res["kernel"], res["xla"]
        log(f"[passes] {name}: opaque walk alone {k['ms']:.3f} ms kernel, "
            f"{x['ms']:.3f} ms xla (card {power})")
        _compare_ids(f"{name} opaque", k["z"], k["tid"], x["z"], x["tid"])
        img_k = _shaded_u8(eng, p, o["rows"], k["tid"], hp, wp)
        img_x = _shaded_u8(eng, p, o["rows"], x["tid"], hp, wp)
        close = (np.abs(img_k - img_x).max(-1) <= 1).mean()
        log(f"[passes] {name} opaque shaded u8: within 1 step on {close:.6%}")
        assert close >= 0.999
        ck, cx = np.asarray(k["acc"][3]), np.asarray(x["acc"][3])
        cnt_same = (ck == cx).mean()
        acc_diff = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                       for a, b in zip(k["acc"][:3], x["acc"][:3]))
        log(f"[passes] {name} accumulate: fragment counts agree on "
            f"{cnt_same:.6%}; max |acc| difference {acc_diff:.3g}")
        assert cnt_same >= 0.9999 and acc_diff < 1.0 / 255
        for i, (lk, lx) in enumerate(zip(k["layers"], x["layers"])):
            same = (np.asarray(lk) == np.asarray(lx)).mean()
            log(f"[passes] {name} peel layer {i}: ids agree on {same:.6%}")
            assert same >= 0.9999
        # the capped deferred path (plain XLA walk over refined triangle
        # bins) against the opaque kernel, with caps that cannot overflow
        cmax = int(jnp.max(o["counts"]))
        cbins, ccounts, of_c = raster.bin_triangles(
            o["caabb"], o["cvalid"], bin_cap=max(cmax, 1), **tiles)
        tbins, tcounts, of_t = raster.refine_bins(
            cbins, o["aabb"], tri_cap=max(cmax, 1) * raster.CHUNK, **tiles)
        assert int(of_c) == 0 and int(of_t) == 0
        zd, td = raster.rasterize(o["rows"][:, :16], tbins, tcounts, **tiles)
        _compare_ids(f"{name} deferred vs kernel", k["z"], k["tid"], zd, td)


def _timed(fn, n):
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append(1000 * (time.perf_counter() - t0))
    return out


def phase_frames(engines: dict, power: str) -> None:
    import jax
    import jax.numpy as jnp

    from tpu_renderer.pipeline import render_frames

    for name in ("demo", "trilinear", "stress", "textured_transparency"):
        eng = engines[name]
        t0 = time.perf_counter()
        img = eng.draw()
        log(f"[frames] {name}: first draw (compile + run) "
            f"{time.perf_counter() - t0:.1f} s; image {img.shape}; "
            f"{eng.stats.triangle_count} tris, {eng.stats.drawcall_count} "
            f"draws")
        assert img.shape == (H, W, 4) and img[..., 3].min() == 255
        pipelined = []
        for i in range(10):
            eng.camera.yaw = np.float32(0.002 * i)
            t1 = time.perf_counter()
            eng.draw_pipelined(stats_interval=0)
            pipelined.append(1000 * (time.perf_counter() - t1))
        eng.flush_pipelined()
        params = []
        for i in range(20):
            eng.camera.yaw = np.float32(0.002 * i)
            params.append(eng.update_scene())
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *params)
        kw = frame_kw(eng)
        last, sums = render_frames(eng.flat.buffers, stacked, **kw)
        np.asarray(sums)  # compile + warm
        scans = _timed(lambda: np.asarray(
            render_frames(eng.flat.buffers, stacked, **kw)[1]), 3)
        ms = float(np.median(scans)) / 20
        final = np.asarray(last)
        assert final.shape == (H, W)
        log(f"[frames] {name}: median frame {ms:.3f} ms in a 20-frame "
            f"render_frames scan (3 runs: "
            f"{', '.join(f'{s / 20:.3f}' for s in scans)}); draw_pipelined "
            f"median {np.median(pipelined[3:]):.3f} ms/call; card {power}")


def phase_golden() -> None:
    """The structure scene at 1080p against the committed CPU golden."""
    import importlib.util

    from tpu_renderer.present import load_png

    # by path: an installed package may already own the name `tests`
    spec = importlib.util.spec_from_file_location(
        "regen_goldens", os.path.join(ROOT, "tests", "regen_goldens.py"))
    goldens = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(goldens)
    img = goldens.render_structure(W, H).astype(np.int32)
    golden = load_png(os.path.join(ROOT, "tests", "goldens",
                                   "structure_1080p.png")).astype(np.int32)
    diff = np.abs(img - golden).max(-1)
    beyond = int(np.sum(diff > 2))
    frac = 1.0 - beyond / diff.size
    log(f"[golden] structure 1080p vs CPU golden: {beyond} of {diff.size} px "
        f"beyond 2 u8 steps (within: {frac:.6%}; max step {int(diff.max())})")
    assert frac >= 0.999


def phase_gpu_tests() -> None:
    import pytest

    os.environ["RENDER_TESTS_ON_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_walk.py")])
    log(f"[gpu tests] pytest -m gpu exit code {int(rc)}")
    assert int(rc) == 0


def phase_multichip(n: int) -> None:
    import jax

    from tpu_renderer.config import RendererConfig
    from tpu_renderer.engine import Engine
    from tpu_renderer.parallel.multichip import make_mesh, render_frame_multichip
    from tpu_renderer.pipeline import render_frame
    from tpu_renderer.utils.demo import build_demo_glb

    assert len(jax.devices()) >= n, f"needs {n} GPUs, have {len(jax.devices())}"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "demo.glb")
        build_demo_glb(path, grid=64, seed=0)
        eng = Engine(RendererConfig(width=W, height=H,
                                    camera_position=(0.0, 6.0, 128.0)))
        eng.camera.pitch = np.float32(-0.18)
        eng.init(scene_path=path)
    params = eng.update_scene()
    kw = frame_kw(eng)
    single = np.asarray(render_frame(eng.flat.buffers, params, **kw)[0])
    single_u8 = single.view(np.uint8).reshape(H, W, 4).astype(np.int32)
    for rows, tri in ((2, 2), (4, 1)):
        mesh = make_mesh(rows, tri)
        kw_m = {k: v for k, v in kw.items()}
        multi, _aux = render_frame_multichip(eng.flat.buffers, params,
                                             mesh=mesh, **kw_m)
        multi = np.asarray(multi)
        t0 = time.perf_counter()
        jax.block_until_ready(render_frame_multichip(
            eng.flat.buffers, params, mesh=mesh, **kw_m))
        ms = 1000 * (time.perf_counter() - t0)
        diff = np.abs(multi.view(np.uint8).reshape(H, W, 4).astype(np.int32)
                      - single_u8).max(-1)
        n_diff = int(np.sum(diff > 0))
        n_beyond = int(np.sum(diff > 1))
        log(f"[multichip] {rows}x{tri}: {n_diff} of {diff.size} px differ "
            f"from the single-card frame ({n_beyond} by more than 1 u8 "
            f"step; max {int(diff.max())}); one frame {ms:.2f} ms")
        # the fused path breaks exact z ties per shard (shard-local sort):
        # a tie pixel may take the other triangle's color
        assert n_beyond <= diff.size // 1000, "more than 0.1% of pixels off"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card sharded frame phase")
    args = ap.parse_args(argv)

    import jax

    from tpu_renderer.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"[device] {device}")
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    power = gpu_name_and_power()
    log(f"[device] nvidia-smi: {power}")
    log(f"[device] compile cache: {enable_compile_cache()}")
    t_start = time.perf_counter()

    if args.multichip:
        phase_multichip(4)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            scenes = build_scenes(tmp)
        engines = {name: make_engine(scene, cam)
                   for name, (scene, cam) in scenes.items()}
        log(f"[setup] scenes built in {time.perf_counter() - t_start:.1f} s")
        for phase, fn in (("compile", lambda: phase_compile(engines)),
                          ("passes", lambda: phase_passes(engines, power)),
                          ("frames", lambda: phase_frames(engines, power)),
                          ("golden", phase_golden),
                          ("gpu tests", phase_gpu_tests)):
            t0 = time.perf_counter()
            fn()
            log(f"[{phase}] done in {time.perf_counter() - t0:.1f} s")
    log(f"[total] {time.perf_counter() - t_start:.1f} s; card {power}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
