"""Tracing / profiling — the equivalent of the reference's
std::chrono counters + ImGui stats HUD (SURVEY §5: vk_engine.cpp:1164-1200,
1358-1359, 1472-1476; display vk_engine.cpp:1186-1190).

* ``FrameTimer`` reproduces the EngineStats wall-clock counters.
* ``device_trace`` wraps jax.profiler for per-pass device timing (the
  analog of GPU timestamp queries, which the reference does not have).
* ``debug_mode`` enables the debug-config checks (the analog of the Vulkan
  validation layer, vk_engine.cpp:39-44): NaN checks.
"""

from __future__ import annotations

import contextlib
import time

import jax


class FrameTimer:
    """Rolling wall-clock stats like the reference's per-frame chrono."""

    def __init__(self, window: int = 60):
        self.window = window
        self.samples: list[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append((time.perf_counter() - self._t0) * 1000.0)
        if len(self.samples) > self.window:
            self.samples.pop(0)

    @property
    def mean_ms(self) -> float:
        return sum(self.samples) / max(len(self.samples), 1)

    @property
    def fps(self) -> float:
        m = self.mean_ms
        return 1000.0 / m if m else 0.0


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a device profile around a block (view with tensorboard or
    xprof). Replaces GPU timestamp queries."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def debug_mode():
    """Validation-layer analog: NaN/Inf checks on every op. Slow; debug only."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def stats_text(stats) -> str:
    """The ImGui stats window, as text (vk_engine.cpp:1186-1190)."""
    return (
        f"frametime {stats.frame_time:.3f} ms\n"
        f"drawtime {stats.mesh_draw_time:.3f} ms\n"
        f"update time {stats.scene_update_time:.3f} ms\n"
        f"triangles {stats.triangle_count}\n"
        f"draws {stats.drawcall_count}"
    )
