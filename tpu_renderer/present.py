"""Present path — replaces the swapchain blit + present
(vk_images.cpp:33-64 blit, vk_engine.cpp:1268-1336).

The reference blits the rgba16f draw image to a B8G8R8A8_UNORM swapchain
image (no color-space conversion: the surface is UNORM + SRGB_NONLINEAR,
so values are interpreted as already-encoded). Here: crop the padded planar
framebuffer, convert float -> unorm8 (clamp, round to nearest) packed into
one u32 plane on device, and view the bytes as (H, W, 4) uint8 RGBA on the
host — the channel split is a free numpy view after the transfer.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_renderer.utils import png


@functools.partial(jax.jit, static_argnames=("width", "height"))
def to_packed_u32(fb, *, width: int, height: int):
    """(4, Hp, Wp) float framebuffer -> (H, W) uint32, RGBA packed LE
    (r | g<<8 | b<<16 | a<<24 — byte order matches an RGBA8 image)."""
    crop = fb[:, :height, :width].astype(jnp.float32)
    q = jnp.clip(jnp.round(crop * 255.0), 0.0, 255.0).astype(jnp.uint32)
    return q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24)


def unpack_u8(packed: np.ndarray) -> np.ndarray:
    """Host: (H, W) uint32 packed plane -> (H, W, 4) uint8 RGBA (a view —
    zero copy; little-endian byte order matches the device packing)."""
    a = np.ascontiguousarray(np.asarray(packed))
    assert a.dtype == np.uint32
    return a.view(np.uint8).reshape(*a.shape, 4)


def save_png(image_u8: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(png.encode(np.asarray(image_u8)))


def load_png(path: str) -> np.ndarray:
    """PNG file -> (H, W, 4) uint8 RGBA (8-bit RGB/RGBA; utils/png.py)."""
    with open(path, "rb") as f:
        return png.decode(f.read())
