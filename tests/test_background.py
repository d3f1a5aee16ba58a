"""Background passes vs direct GLSL formula transcriptions.

The shader formulas (gradient_color.comp:14-27, sky.comp:17-91) are pure
math, so the jnp references are exact oracles for the padded-extent planes
the frame uses (pipeline._bg_grad / _bg_sky / background_fb).
"""

import jax.numpy as jnp
import numpy as np

from tpu_renderer import pipeline
from tpu_renderer.kernels import background
from tpu_renderer.kernels.common import pad_extent


def test_gradient_matches_formula():
    w, h = 200, 100
    wp, hp = pad_extent(w, h, 32, 128)
    d1 = jnp.array([1.0, 0.0, 0.0, 1.0])
    d2 = jnp.array([0.0, 0.0, 1.0, 1.0])
    out = pipeline._bg_grad(d1, d2, hp, wp, h)
    ref = background.gradient_reference(d1, d2, height=h, width=w)
    np.testing.assert_allclose(np.asarray(out[:, :h, :w]), np.asarray(ref), atol=1e-6)


def test_gradient_default_is_solid_white():
    # Reference defaults: data1 = data2 = (1,1,1,1) (vk_engine.cpp:977-978)
    wp, hp = pad_extent(128, 32, 32, 128)
    out = pipeline._bg_grad(jnp.ones(4), jnp.ones(4), hp, wp, 32)
    np.testing.assert_allclose(np.asarray(out), 1.0, atol=1e-7)


def test_sky_matches_formula():
    w, h = 256, 64
    wp, hp = pad_extent(w, h, 32, 128)
    d1 = jnp.array([0.1, 0.2, 0.4, 0.97])
    out = pipeline._bg_sky(d1, hp, wp, h)
    ref = background.sky_reference(d1, height=h, width=w)
    np.testing.assert_allclose(np.asarray(out[:, :h, :w]), np.asarray(ref), atol=1e-5)


def test_sky_has_stars_and_gradient():
    w, h = 256, 128
    wp, hp = pad_extent(w, h, 32, 128)
    d1 = jnp.array([0.1, 0.2, 0.4, 0.97])
    out = np.asarray(pipeline._bg_sky(d1, hp, wp, h))[:, :h, :w]
    # vertical gradient: top rows darker than bottom rows in blue channel
    assert out[2, : h // 4].mean() < out[2, -h // 4 :].mean()
    # some stars exist: pixels well above the pure gradient value
    grad_only = 0.4 * np.arange(h, dtype=np.float32)[:, None] / h
    assert ((out[2] - grad_only) > 0.5).sum() > 0
    # alpha plane is 1
    np.testing.assert_allclose(out[3], 1.0)


def test_background_fb_effect_switch_at_padded_odd_extent():
    """background_fb pads an odd extent to whole tiles and selects the
    effect at run time (lax.switch on bg_effect, clipped to 0..1)."""
    w, h = 333, 45
    wp, hp = pad_extent(w, h, 32, 128)
    d1 = jnp.array([0.1, 0.2, 0.4, 0.97])
    d2 = jnp.array([0.9, 0.8, 0.7, 1.0])
    i4 = jnp.eye(4, dtype=jnp.float32)
    params = pipeline.FrameParams(
        view=i4, proj=i4, bg_effect=jnp.int32(0), bg_data1=d1, bg_data2=d2,
        ambient=jnp.zeros(4), sun_dir=jnp.zeros(4), sun_color=jnp.ones(4))
    grad = pipeline.background_fb(params, width=w, height=h)
    assert grad.shape == (4, hp, wp) == (4, 64, 384)
    np.testing.assert_allclose(
        np.asarray(grad[:, :h, :w]),
        np.asarray(background.gradient_reference(d1, d2, height=h, width=w)),
        atol=1e-6)
    for effect in (1, 7):  # out-of-range effects clip to the last (sky)
        sky = pipeline.background_fb(params._replace(bg_effect=jnp.int32(effect)),
                                     width=w, height=h)
        np.testing.assert_allclose(
            np.asarray(sky[:, :h, :w]),
            np.asarray(background.sky_reference(d1, height=h, width=w)),
            atol=1e-5)
