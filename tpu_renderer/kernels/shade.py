"""Deferred shading — mesh.frag (shaders/mesh.frag:12-19) evaluated per pixel
over the visibility buffer, plus the sampler/texture machinery the reference
gets from combined image samplers (input_structures.glsl:13-16, sampler
creation vk_loader.cpp:197-211, REPEAT addressing by Vulkan default).

Every per-pixel gather here is one small row: one prebaked bilinear-quad
row per sampled mip level (1 for nearest-mip samplers, 2 for trilinear),
plus — on the deferred path only — one 48-float *shade row* per pixel.
All elementwise math runs on channel-MAJOR (Hp, Wp) planes.

Everything outside the taps — perspective-correct interpolation, mip LOD
from analytic per-triangle derivatives, analytic mip addressing, filtering,
lighting — is elementwise work that XLA fuses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_renderer.resources import (
    FILTER_MAG_LINEAR,
    FILTER_MIN_LINEAR,
    FILTER_MIP_LINEAR,
)

# fat-row layout (48 f32 per triangle): everything the fused raster kernel
# and the deferred shade need about a triangle, in one gatherable row
C_EDGE = 0     # 9: edge planes (barycentric numerators)
C_Z = 9        # 3: affine depth plane
C_MAT = 12     # 1: material id
C_ATTR = 13    # 18: attribute-numerator PLANES, coefficient-major:
#                [pa x6, pb x6, pc x6] with num_a(X,Y) = pa*X + pb*Y + pc
#                = c0*A0 + c1*A1 + c2*A2 folded at setup (the GPU
#                plane-equation interpolator). Attribute order:
#                [light_num, r, g, b, u, v]. light_num = dot(model-rotated
#                normal, sun_dir): mesh.frag uses the interpolated normal
#                ONLY through this dot (shaders/mesh.frag:13), and the dot
#                commutes with linear interpolation, so one light-numerator
#                channel replaces the three normal channels. Per-pixel
#                interpolation is num_a * inv with inv = 1/den — 2 FMA + 1
#                mul instead of the 3-mul/2-add barycentric weighting.
C_TEX = 31     # 6: base_x, base_y, w0, h0, n_levels, filter_flags
C_GRAD = 37    # 6: nu_a, nu_b, nv_a, nv_b, den_a, den_b — per-triangle uv
#                screen-gradient constants: uv(X,Y) = num(X,Y)/den(X,Y) with
#                num/den linear planes, so duv/dX = (num_X - uv*den_X)/den;
#                the 6 plane slopes make the mip LOD analytic per triangle
#                (the hardware-matching fix for quad-derivative silhouette
#                divergence; /root/reference/shaders/mesh.frag:15 gets this
#                from texture()'s implicit same-primitive derivatives).
#                nu_*/nv_* duplicate the u/v attr-plane slopes (cols 17, 23,
#                18, 24) so the carried meta block stays contiguous.
C_DEN = 43     # 1: den_c — with den_a/den_b (C_GRAD+4/5) the denominator
#                plane den(X,Y) = sum of the three barycentric numerators;
#                carrying the 3 coefficients replaces the old per-pixel
#                csum framebuffer plane (csum is recomputed from the
#                winner's den plane in the XLA epilogue).
SHADE_COLS = 48
N_ATTR = 6     # interpolated attribute planes (light_num, rgb, uv)
N_META = 13    # per-winner constant planes (C_TEX 6 + C_GRAD 6 + den_c)


def build_shade_rows(packed, attrs, mat_meta=None, aabb=None, meta6=None):
    """(T,16) setup rows + (T,3,6) attrs + (M,8) material meta -> (T,48).

    mat_meta rows: [base_x, base_y, w0, h0, n_levels, filter_flags, 0, 0]
    (f32 values; all are small integers, exactly representable).
    Folds the per-corner attributes into numerator PLANES (see C_ATTR):
    pa_a = sum_i edge_i_Xslope * attr[i, a], etc.

    aabb: optional (T, 4) f32 (xmin, ymin, xmax, ymax) screen boxes,
    stored in columns 44-47 (the same columns triangle_setup_rows fills).
    When omitted, a never-skip sentinel box fills them.

    meta6: optional (T, 6) f32 — the per-triangle texture-binding row
    precomputed at scene flatten (vertex.CornerData.meta6); when given,
    the per-frame mat_meta gather is skipped (material bindings are
    static — the reference's descriptor sets are written once per scene
    too, vk_engine.cpp:1690-1714).
    """
    if meta6 is None:
        mat = packed[:, 13].astype(jnp.int32)
        meta = mat_meta[jnp.clip(mat, 0, mat_meta.shape[0] - 1)]  # (T, 8)
    else:
        meta = meta6
    A = packed[:, (0, 3, 6)]                 # (T, 3) edge-plane X slopes
    B = packed[:, (1, 4, 7)]                 # (T, 3) edge-plane Y slopes
    Cc = packed[:, (2, 5, 8)]                # (T, 3) edge-plane constants
    # full f32 precision: a GPU may run default-precision f32 in TF32
    hi = jax.lax.Precision.HIGHEST
    pa = jnp.einsum("tc,tca->ta", A, attrs, precision=hi)  # (T, 6) X slopes
    pb = jnp.einsum("tc,tca->ta", B, attrs, precision=hi)  # (T, 6) Y slopes
    pc = jnp.einsum("tc,tca->ta", Cc, attrs, precision=hi)  # (T, 6) constants
    grad = jnp.stack([
        pa[:, 4], pb[:, 4], pa[:, 5], pb[:, 5],
        jnp.sum(A, axis=1), jnp.sum(B, axis=1),
    ], axis=1)                               # (T, 6)
    den_c = jnp.sum(Cc, axis=1, keepdims=True)  # (T, 1)
    T = packed.shape[0]
    if aabb is None:
        aabb = jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 1e9, 1e9], jnp.float32), (T, 4))
    return jnp.concatenate(
        [
            packed[:, 0:12],
            packed[:, 13:14],
            pa, pb, pc,
            meta[:, :6],
            grad,
            den_c,
            aabb.astype(jnp.float32),
        ],
        axis=1,
    )


def _chan(texel_u32, shift: int):
    """One RGBA8 channel of a packed u32 texel plane -> f32 [0,1] plane."""
    return ((texel_u32 >> shift) & 0xFF).astype(jnp.float32) \
        * jnp.float32(1.0 / 255.0)


def uv_gradients(u, v, grad_meta, inv):
    """Analytic per-pixel uv screen gradients from the 6 per-triangle
    C_GRAD constants plus inv = 1/den(X,Y).

    uv = num/den (both linear in screen X, Y), so
    d(uv)/dX = (num_X - uv * den_X) * inv — exact where a GPU's 2x2
    helper-invocation quads only finite-difference the same primitive
    (and, unlike quad differencing of the interpolated planes, never mixes
    NEIGHBORING primitives at silhouettes/material boundaries).
    grad_meta: 6 planes [nu_a, nu_b, nv_a, nv_b, den_a, den_b].
    Returns (dudx, dudy, dvdx, dvdy) planes.
    """
    nu_a, nu_b, nv_a, nv_b, den_a, den_b = grad_meta
    dudx = (nu_a - u * den_a) * inv
    dudy = (nu_b - u * den_b) * inv
    dvdx = (nv_a - v * den_a) * inv
    dvdy = (nv_b - v * den_b) * inv
    return dudx, dudy, dvdx, dvdy


def _level_coords(w0, h0, li, u, v, pot: bool = False):
    """Texel addressing at mip level li: wrapped quad top-left + fractions.
    All arguments and results are (H, W) planes.

    pot (STATIC): every texture in the scene has power-of-two dims, so the
    REPEAT wrap is a bitwise AND (exact for negative x0 too — two's
    complement) instead of two integer-division mod planes. The engine
    detects this per scene (Engine._compute_caps); results are
    bit-identical where both paths are defined."""
    wl = jnp.maximum(w0.astype(jnp.int32) >> li, 1)
    hl = jnp.maximum(h0.astype(jnp.int32) >> li, 1)
    su = u * wl.astype(jnp.float32) - 0.5
    sv = v * hl.astype(jnp.float32) - 0.5
    x0 = jnp.floor(su).astype(jnp.int32)
    y0 = jnp.floor(sv).astype(jnp.int32)
    if pot:
        return wl, hl, x0 & (wl - 1), y0 & (hl - 1), su - x0, sv - y0
    return wl, hl, jnp.mod(x0, wl), jnp.mod(y0, hl), su - x0, sv - y0


def _sample_level(atlas, base_x, base_y, w0, h0, level, u, v, linear,
                  active=None, pot: bool = False):
    """One mip tap = ONE quad-row gather + planar filtering -> (r, g, b).

    Analytic addressing (packed pyramid, resources.build_atlas): with
    W2 = 2*max(w0, h0), level L sits at x = base_x + W2 - (W2 >> L) with
    size (w0>>L, h0>>L). `linear` selects bilinear vs nearest per pixel.
    `active` (optional bool mask): pixels whose result is unused get gather
    index 0 — the per-index issue cost is unavoidable, but masking keeps the
    address in-table without a separate validity clamp.
    """
    li = level.astype(jnp.int32)
    wl, hl, x0w, y0w, fu, fv = _level_coords(w0, h0, li, u, v, pot=pot)
    w2 = jnp.maximum(w0.astype(jnp.int32), h0.astype(jnp.int32)) << 1
    ex = base_x.astype(jnp.int32) + w2 - (w2 >> li)
    ey = base_y.astype(jnp.int32)

    flat = (ey + y0w) * atlas.width + (ex + x0w)
    if active is not None:
        flat = jnp.where(active, flat, 0)
    quad = atlas.quads[flat]                       # (H, W, 4) u32 — THE gather
    t00 = quad[..., 0]
    t10 = quad[..., 1]
    t01 = quad[..., 2]
    t11 = quad[..., 3]

    # nearest texel: floor(u*w) == x0 or x0+1; both live in this quad. The
    # select runs on the PACKED u32 planes (one select instead of three).
    nx = fu >= 0.5
    ny = fv >= 0.5
    near = jnp.where(nx, jnp.where(ny, t11, t10), jnp.where(ny, t01, t00))

    w11 = fu * fv
    w10 = fu - w11
    w01 = fv - w11
    w00 = 1.0 - fu - w01
    out = []
    for s in (0, 8, 16):
        bilin = (w00 * _chan(t00, s) + w10 * _chan(t10, s)
                 + w01 * _chan(t01, s) + w11 * _chan(t11, s))
        out.append(jnp.where(linear, bilin, _chan(near, s)))
    return tuple(out)


def sample_texture(atlas, base_x, base_y, w0, h0, n_levels, flags, u, v,
                   grads, trilinear: bool = True, pot: bool = False):
    """Full sampler: analytic per-triangle mip LOD, trilinear/nearest
    filtering, REPEAT wrap — two taps max. Planar in, (r, g, b) planes out.

    grads: (dudx, dudy, dvdx, dvdy) planes from uv_gradients — the
    per-triangle analytic derivatives, matching the hardware semantics of
    same-primitive helper-invocation quads (no cross-primitive
    contamination at silhouettes).

    trilinear=False is a STATIC fast path for scenes where no sampler mixes
    two mip levels (no FILTER_MIP_LINEAR material with a mipmapped
    texture): the per-pixel mip fraction is provably 0, so the second tap's
    whole-frame gather is skipped entirely. Results are bit-identical to the two-tap path.
    """
    fl = flags.astype(jnp.int32)
    dudx, dudy, dvdx, dvdy = grads
    rho_x = jnp.sqrt((dudx * w0) ** 2 + (dvdx * h0) ** 2)
    rho_y = jnp.sqrt((dudy * w0) ** 2 + (dvdy * h0) ** 2)
    rho = jnp.maximum(rho_x, rho_y)
    lod = jnp.log2(jnp.maximum(rho, jnp.float32(1e-12)))
    max_level = n_levels - 1.0
    lod = jnp.clip(lod, 0.0, max_level)

    mip_linear = (fl & FILTER_MIP_LINEAR) != 0
    # Vulkan: NEAREST mip mode picks ceil(lod + 0.5) - 1; LINEAR blends
    # floor/floor+1 by the fraction.
    l_near = jnp.clip(jnp.ceil(lod + 0.5) - 1.0, 0.0, max_level)
    l_lo = jnp.floor(lod)
    l_hi = jnp.minimum(l_lo + 1.0, max_level)
    frac = jnp.where(mip_linear, lod - l_lo, 0.0)
    lev_a = jnp.where(mip_linear, l_lo, l_near)
    lev_b = jnp.where(mip_linear, l_hi, l_near)

    mag_lin = (fl & FILTER_MAG_LINEAR) != 0
    min_lin = (fl & FILTER_MIN_LINEAR) != 0
    linear = jnp.where(lod > 0.0, min_lin, mag_lin)

    # two quad-row taps. The second tap's address is masked for pixels
    # whose mip fraction is 0 (mip-nearest samplers, magnified or
    # exactly-on-level pixels): its result is multiplied by 0 anyway.
    ca = _sample_level(atlas, base_x, base_y, w0, h0, lev_a, u, v, linear,
                       pot=pot)
    if not trilinear:
        return ca
    cb = _sample_level(atlas, base_x, base_y, w0, h0, lev_b, u, v, linear,
                       active=frac > 0.0, pot=pot)
    inv = 1.0 - frac
    return tuple(a * inv + b * frac for a, b in zip(ca, cb))


def light_and_texture(light_num, color_in, uv, texmeta, grads, atlas,
                      ambient_rgb, sun_power, textured: bool = True,
                      trilinear: bool = True, pot: bool = False):
    """mesh.frag:12-19 given already-interpolated attribute PLANES.

    light_num: interpolated dot(N, sun_dir) plane (N model-rotated, NOT
    renormalized — the dot commutes with the interpolation, mesh.frag:13);
    color_in: (r, g, b) planes; uv: (u, v) planes; texmeta: 6-tuple of
    planes [base_x, base_y, w0, h0, n_levels, filter_flags]; grads:
    (dudx, dudy, dvdx, dvdy) planes (ignored when not textured).
    Returns (r, g, b) planes.
    """
    if textured:
        tex = sample_texture(atlas, texmeta[0], texmeta[1], texmeta[2],
                             texmeta[3], texmeta[4], texmeta[5], uv[0], uv[1],
                             grads, trilinear=trilinear, pot=pot)
    else:
        tex = (None, None, None)
    # mesh.frag:13 — light = max(dot(N, sunlight_direction.xyz), 0.1)
    light = jnp.maximum(light_num, jnp.float32(0.1))
    # mesh.frag:15-18
    scale = light * sun_power
    out = []
    for c in range(3):
        color = color_in[c] * tex[c] if textured else color_in[c]
        out.append(color * scale + color * ambient_rgb[c])
    return tuple(out)


def shade_fused(attrs, meta, inv, atlas, ambient_rgb, sun_dir, sun_power,
                textured: bool = True, trilinear: bool = True,
                pot: bool = False):
    """Shade from the fused raster outputs (no per-pixel row gather).

    attrs: (6, Hp, Wp) interpolated [light_num, rgb, uv] planes;
    meta: (12, Hp, Wp) per-winner constant planes (tex 6 + uv-grad 6);
    inv: (Hp, Wp) 1/csum plane (for the analytic uv gradients).
    sun_dir is unused here (the light dot is baked into attrs[0] at vertex
    setup) — kept in the signature for call-site symmetry.
    Returns (3, Hp, Wp) rgb (channel-major — never a channel-minor image).
    """
    del sun_dir
    grads = uv_gradients(attrs[4], attrs[5],
                         tuple(meta[6 + m] for m in range(6)), inv) \
        if textured else None
    r, g, b = light_and_texture(
        attrs[0], (attrs[1], attrs[2], attrs[3]),
        (attrs[4], attrs[5]), tuple(meta[m] for m in range(6)), grads,
        atlas, ambient_rgb, sun_power, textured=textured,
        trilinear=trilinear, pot=pot)
    return jnp.stack([r, g, b])


def shade_core(t, shade_rows, atlas, ambient_rgb, sun_dir, sun_power,
               textured: bool = True, trilinear: bool = True,
               pot: bool = False):
    """mesh.frag for per-pixel triangle index t (clamped valid index; pixels
    whose t is a placeholder produce garbage the caller masks).
    Returns (3, H, W) f32 linear rgb.
    """
    del sun_dir  # baked into the light-numerator attribute channel
    hp, wp = t.shape
    g = shade_rows[t]                                  # (Hp,Wp,48) — gather 1

    xx = jax.lax.broadcasted_iota(jnp.int32, (hp, wp), 1).astype(jnp.float32) + 0.5
    yy = jax.lax.broadcasted_iota(jnp.int32, (hp, wp), 0).astype(jnp.float32) + 0.5
    den = g[..., C_GRAD + 4] * xx + g[..., C_GRAD + 5] * yy + g[..., C_DEN]
    inv = jnp.where(den != 0.0, 1.0 / den, 0.0)

    # perspective-correct interpolation: numerator plane eval * 1/den
    interp = [
        (g[..., C_ATTR + a] * xx + g[..., C_ATTR + 6 + a] * yy
         + g[..., C_ATTR + 12 + a]) * inv
        for a in range(N_ATTR)
    ]
    grads = uv_gradients(interp[4], interp[5],
                         tuple(g[..., C_GRAD + m] for m in range(6)), inv) \
        if textured else None
    r, gg, b = light_and_texture(
        interp[0], (interp[1], interp[2], interp[3]),
        (interp[4], interp[5]), tuple(g[..., C_TEX + m] for m in range(6)),
        grads, atlas, ambient_rgb, sun_power, textured=textured,
        trilinear=trilinear, pot=pot)
    return jnp.stack([r, gg, b])


def shade(tid, shade_rows, atlas, ambient_rgb, sun_dir, sun_power,
          background, trilinear: bool = True, pot: bool = False):
    """Opaque pass: mesh.frag over the visibility buffer.

    tid: (Hp, Wp) i32 visibility buffer (-1 = background)
    background: (4, Hp, Wp) f32 — survives where no geometry (the LOAD-op
    color attachment semantics, vk_initializers.cpp:125)
    Returns (4, Hp, Wp) f32.
    """
    valid = tid >= 0
    t = jnp.where(valid, tid, 0)
    out_rgb = shade_core(t, shade_rows, atlas, ambient_rgb, sun_dir,
                         sun_power, trilinear=trilinear, pot=pot)
    rgb = jnp.where(valid[None, :, :], out_rgb, background[:3])
    alpha = jnp.where(valid, jnp.float32(1.0), background[3])
    return jnp.concatenate([rgb, alpha[None]], axis=0)


def blend_layer(fb, tid, shade_rows, atlas, ambient_rgb, sun_dir, sun_power,
                textured: bool = True, trilinear: bool = True,
                pot: bool = False):
    """Transparent additive blend of one peeled layer into the framebuffer.

    Blend state from enable_blending_additive (vk_pipelines.cpp:157-167):
    rgb = src*1 + dst*dstAlpha, alpha = src (mesh.frag always writes a=1).
    tid: (Hp, Wp) i32 layer triangle ids (-1 = no fragment).
    Returns the blended (4, Hp, Wp) framebuffer.
    """
    found = tid >= 0
    t = jnp.where(found, tid, 0)
    src = shade_core(t, shade_rows, atlas, ambient_rgb, sun_dir, sun_power,
                     textured=textured, trilinear=trilinear, pot=pot)
    dst_rgb = fb[:3]
    dst_a = fb[3]
    rgb = jnp.where(found[None], src + dst_rgb * dst_a[None], dst_rgb)
    alpha = jnp.where(found, jnp.float32(1.0), dst_a)
    return jnp.concatenate([rgb, alpha[None]], axis=0)
