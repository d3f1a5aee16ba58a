"""Background compute passes — jnp transcriptions of the reference's
full-screen compute shaders.

* gradient: vertical mix(top, bottom, y/height) (gradient_color.comp:14-27).
* sky: star-field noise + vertical color gradient (sky.comp:17-91).

The reference dispatches 16x16 workgroups over the rgba16f draw image
(vk_engine.cpp:1341-1355). Here the formulas are elementwise planes that
XLA fuses: the frame uses them through ``pipeline._bg_grad`` /
``pipeline._bg_sky`` at the padded extent, and ``gradient_reference`` /
``sky_reference`` are the unit-test oracles at the visible extent. The
formulas are exact in f32 up to transcendental ULP differences.
"""

from __future__ import annotations

import jax.numpy as jnp


# ---------------------------------------------------------------------------
# gradient_color.comp — mix(data1, data2, y/height)
# ---------------------------------------------------------------------------


def gradient_reference(data1, data2, *, height: int, width: int):
    """jnp transcription of gradient_color.comp:14-27 (unit-test oracle)."""
    data1 = jnp.asarray(data1, jnp.float32)
    data2 = jnp.asarray(data2, jnp.float32)
    yy = jnp.arange(height, dtype=jnp.float32)[:, None]
    blend = jnp.broadcast_to(yy / jnp.float32(height), (height, width))
    return data1[:, None, None] * (1.0 - blend)[None] + data2[:, None, None] * blend[None]


# ---------------------------------------------------------------------------
# sky.comp — star field + vertical gradient
# ---------------------------------------------------------------------------


def _fract(x):
    return x - jnp.floor(x)


def _noise2d(x, y):
    # sky.comp:18-23 — fract(415.92653 * (cos(x*37) + cos(y*57)))
    return _fract(jnp.float32(415.92653) * (jnp.cos(x * jnp.float32(37.0)) + jnp.cos(y * jnp.float32(57.0))))


def _star(v, threshold):
    # sky.comp:26-33 — threshold + pow6 shaping
    shaped = ((v - threshold) / (jnp.float32(1.0) - threshold)) ** 6
    return jnp.where(v >= threshold, shaped, jnp.float32(0.0))


def _star_field(sample_x, sample_y, threshold):
    # sky.comp:36-54 — bilinear blend of 4 integer-lattice star samples
    fx = _fract(sample_x)
    fy = _fract(sample_y)
    x0 = jnp.floor(sample_x)
    y0 = jnp.floor(sample_y)
    v1 = _star(_noise2d(x0, y0), threshold)
    v2 = _star(_noise2d(x0, y0 + 1.0), threshold)
    v3 = _star(_noise2d(x0 + 1.0, y0), threshold)
    v4 = _star(_noise2d(x0 + 1.0, y0 + 1.0), threshold)
    return (v1 * (1.0 - fx) * (1.0 - fy)
            + v2 * (1.0 - fx) * fy
            + v3 * fx * (1.0 - fy)
            + v4 * fx * fy)


def _sky_math(xx, yy, data1, height: int):
    """Shared sky formula: xx/yy are pixel coord arrays, data1 is (4,) tuple-like."""
    r, g, b, threshold = data1
    grad = yy / jnp.float32(height)  # sky.comp:60 — data1.rgb * fragCoord.y / res.y
    # sky.comp:67-69 — crawl offset (0.2, -0.06) * frame 1
    star = _star_field(xx + jnp.float32(0.2), yy + jnp.float32(-0.06), threshold)
    return (r * grad + star, g * grad + star, b * grad + star)


def sky_reference(data1, *, height: int, width: int):
    """jnp transcription of sky.comp:57-91 (unit-test oracle)."""
    yy = jnp.broadcast_to(jnp.arange(height, dtype=jnp.float32)[:, None], (height, width))
    xx = jnp.broadcast_to(jnp.arange(width, dtype=jnp.float32)[None, :], (height, width))
    d = jnp.asarray(data1, jnp.float32)
    cr, cg, cb = _sky_math(xx, yy, (d[0], d[1], d[2], d[3]), height)
    return jnp.stack([cr, cg, cb, jnp.ones_like(cr)])
