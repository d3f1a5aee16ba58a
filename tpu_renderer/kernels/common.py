"""Shared kernel helpers: tiling, padding, the Pallas interpreter switch."""

from __future__ import annotations

import jax


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def interpret_mode() -> bool:
    """Whether Pallas kernels run in the interpreter.

    Only on the CPU backend (the test suite). A GPU compiles them through
    Triton; any other backend has no route for them, and running them
    there in the interpreter would hide that, so it raises instead.
    """
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise RuntimeError(
        f"no Pallas kernel route for the {backend!r} backend (gpu or cpu)")


def pad_extent(width: int, height: int, tile_h: int, tile_w: int) -> tuple[int, int]:
    """Padded framebuffer extent: both dimensions pad to the raster tile
    (the visible extent is cropped at present). Vulkan images have opaque
    hardware tiling; here it is explicit."""
    return round_up(width, tile_w), round_up(height, tile_h)
