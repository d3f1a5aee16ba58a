"""Vertex stage + triangle setup — the equivalent of mesh.vert
(shaders/mesh.vert:29-38) plus the fixed-function primitive assembly inside
vkCmdDrawIndexed (vk_engine.cpp:1453).

Design:

* All draws are processed as one batched op over a flat triangle array —
  the reference's per-draw loop with push constants (vk_engine.cpp:1409-1453)
  becomes a gather of per-draw matrices by ``tri_draw`` id.
* Rasterization is set up in **2D homogeneous coordinates** (no near-plane
  clipping pass needed): for each triangle we compute the adjugate of
  M = [[Xh0,Xh1,Xh2],[Yh0,Yh1,Yh2],[w0,w1,w2]] where (Xh, Yh) are
  viewport-mapped clip coords kept homogeneous. For a pixel p = (X, Y, 1),
  c = adj(M) @ p / det gives perspective-correct barycentric weights:
  the pixel is inside iff all c_i > 0 (plus a top-left tie rule), attributes
  interpolate as sum(c_i * a_i) / sum(c_i), and NDC depth is the affine
  function z(X, Y) = sum(c_i * zclip_i). Triangles fully behind the eye
  self-reject (no pixel with w=1 is a positive combination of negative-w
  vertices), and the per-pixel z in [0,1] test reproduces near/far clipping.
* Frustum culling replicates is_visible (vk_engine.cpp:56-86) per draw on
  device, including its quirks (plain w-divide without sign guard, [-1.5,1.5]
  min/max seeds).

Packed setup row layout (16 f32 per triangle):
  [A0,B0,C0, A1,B1,C1, A2,B2,C2, zA,zB,zC, valid, mat_id, 0, 0]
where edge_i(X, Y) = A_i*X + B_i*Y + C_i (already normalized by |det| so the
edge values ARE the barycentric weights c_i).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Geometry products run at full f32 precision: on a GPU a default-precision
# f32 contraction may run in TF32 (~3 decimal digits), which moves vertices
# by pixels at 1080p.
_HIGHEST = jax.lax.Precision.HIGHEST

# Column indices in the packed setup row.
COL_E = 0          # 9 edge coefficients
COL_Z = 9          # 3 depth-plane coefficients
COL_VALID = 12
COL_MAT = 13
SETUP_COLS = 16

# Per-corner attribute channels: light_num(1) + color_rgb(3) + uv(2).
# light_num = dot(model-rotated corner normal, sun_dir): the fragment shader
# uses the interpolated normal ONLY inside this dot (mesh.frag:13), and the
# dot commutes with linear interpolation, so interpolating the scalar dot is
# exactly equivalent (and 2 channels cheaper) than interpolating the normal.
ATTR_COLS = 6


class TriangleSetup(NamedTuple):
    packed: jax.Array   # (T, 16) f32 — see layout above
    aabb: jax.Array     # (T, 4) f32 — (xmin, ymin, xmax, ymax) in pixels, clamped
    attrs: jax.Array    # (T, 3, ATTR_COLS) f32 — per-corner shading attributes
    valid: jax.Array    # (T,) bool


class CornerData(NamedTuple):
    """Corner-expanded static geometry, precomputed ONCE per scene.

    Vertex positions/normals/colors/uvs and the per-triangle material are
    constant across frames (only node transforms animate), so the per-corner
    gathers positions[tri_vidx] etc. move out of the frame function into
    scene flattening. The reference pays the analogous cost
    once too: vertices are interleaved at load time (vk_loader.cpp:286-358)
    and the GPU's vertex fetch streams them contiguously.
    """

    pos: jax.Array    # (T, 3, 3) f32 — corner positions (mesh space)
    nrm: jax.Array    # (T, 3, 3) f32 — corner normals (mesh space)
    col: jax.Array    # (T, 3, 3) f32 — corner rgb * material color_factors
    #                   (mesh.vert:36 — both factors are static)
    uv: jax.Array     # (T, 3, 2) f32
    mat: jax.Array    # (T,) i32 — material id (padding rows -> 0)
    meta6: jax.Array  # (T, 6) f32 — mat_meta[:, :6] texture-binding row
    # T-MINOR twins of the static fields, laid out (corner, comp, T) /
    # (col, T) so triangle_setup_rows' per-frame plane math runs on dense
    # (T,) planes. Built once per scene alongside the originals.
    posT: jax.Array   # (3, 3, T) f32
    nrmT: jax.Array   # (3, 3, T) f32
    colT: jax.Array   # (3, 3, T) f32
    uvT: jax.Array    # (3, 2, T) f32
    meta6T: jax.Array  # (6, T) f32


def expand_corners(positions, normals, colors, uvs, tri_vidx, tri_draw,
                   tri_valid, draw_mat, mat_color_factors,
                   mat_meta=None) -> CornerData:
    """Build CornerData from indexed geometry. Pure; runs once per scene
    (called by scene.flatten_scene) or inside the compatibility
    triangle_setup wrapper for small/test scenes."""
    vidx = jnp.asarray(tri_vidx)
    draw = jnp.asarray(tri_draw)
    draw_mat = jnp.asarray(draw_mat)
    static_ok = jnp.asarray(tri_valid) & (draw >= 0)
    if draw_mat.shape[0]:
        mat = jnp.where(static_ok, draw_mat[jnp.clip(draw, 0, None)], 0)
    else:
        mat = jnp.zeros(draw.shape, jnp.int32)
    mat = mat.astype(jnp.int32)
    pos = jnp.asarray(positions)[vidx]
    nrm = jnp.asarray(normals)[vidx]
    factors = jnp.asarray(mat_color_factors)
    col = jnp.asarray(colors)[vidx][..., :3] * factors[mat][:, None, :3]
    uv = jnp.asarray(uvs)[vidx]
    if mat_meta is None:
        meta6 = jnp.zeros((vidx.shape[0], 6), jnp.float32)
    else:
        mat_meta = jnp.asarray(mat_meta)
        meta6 = mat_meta[jnp.clip(mat, 0, mat_meta.shape[0] - 1), :6]
    return CornerData(pos=pos, nrm=nrm, col=col, uv=uv, mat=mat, meta6=meta6,
                      posT=jnp.transpose(pos, (1, 2, 0)),
                      nrmT=jnp.transpose(nrm, (1, 2, 0)),
                      colT=jnp.transpose(col, (1, 2, 0)),
                      uvT=jnp.transpose(uv, (1, 2, 0)),
                      meta6T=meta6.T)


def draw_visibility(viewproj, draw_model, bounds_origin, bounds_extents):
    """Per-draw frustum cull — exact semantics of is_visible (vk_engine.cpp:56-86).

    bounds_origin/extents: (D, 3) AABB center/half-extent in mesh space.
    Returns (D,) bool.
    """
    corners = jnp.array(
        [[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1],
         [-1, 1, 1], [-1, 1, -1], [-1, -1, 1], [-1, -1, -1]],
        dtype=jnp.float32,
    )  # vk_engine.cpp:57-60
    m = jnp.einsum("ij,djk->dik", viewproj, draw_model, precision=_HIGHEST)  # viewproj * obj.transform
    pts = bounds_origin[:, None, :] + corners[None, :, :] * bounds_extents[:, None, :]
    pts_h = jnp.concatenate([pts, jnp.ones_like(pts[..., :1])], axis=-1)  # (D,8,4)
    v = jnp.einsum("dij,dcj->dci", m, pts_h, precision=_HIGHEST)  # (D,8,4)
    # vk_engine.cpp:73-75 — unguarded w-divide (quirk kept: no w>0 test)
    ndc = v[..., :3] / v[..., 3:4]
    # vk_engine.cpp:64-65 — min/max seeded at +-1.5
    mn = jnp.minimum(ndc.min(axis=1), 1.5)
    mx = jnp.maximum(ndc.max(axis=1), -1.5)
    # vk_engine.cpp:81-86
    rejected = (
        (mn[:, 2] > 1.0) | (mx[:, 2] < 0.0)
        | (mn[:, 0] > 1.0) | (mx[:, 0] < -1.0)
        | (mn[:, 1] > 1.0) | (mx[:, 1] < -1.0)
    )
    return ~rejected


def triangle_setup(
    positions,      # (V, 3) f32
    normals,        # (V, 3) f32
    colors,         # (V, 4) f32
    uvs,            # (V, 2) f32
    tri_vidx,       # (T, 3) i32 — global vertex ids per corner
    tri_draw,       # (T,) i32 — draw id per triangle
    tri_valid,      # (T,) bool — padding mask
    draw_model,     # (D, 4, 4) f32 — node world matrices
    draw_visible,   # (D,) bool — frustum cull result (True = render)
    draw_mat,       # (D,) i32 — material id per draw
    mat_color_factors,  # (M, 4) f32 — material UBO color_factors
    viewproj,       # (4, 4) f32
    width: int,
    height: int,
    sun_dir=None,   # (3,) f32 — sunlight_direction.xyz (mesh.frag:13);
    #                 None (visibility-only tests) bakes a zero light dot
) -> TriangleSetup:
    """Batched mesh.vert + primitive setup (compatibility form over indexed
    geometry). The hot path precomputes CornerData once per scene and calls
    triangle_setup_c directly; this wrapper expands corners inline (same
    math, tested equivalent) for oracle tests and small scenes."""
    corners = expand_corners(positions, normals, colors, uvs, tri_vidx,
                             tri_draw, tri_valid, draw_mat, mat_color_factors)
    return triangle_setup_c(corners, tri_draw, tri_valid, draw_model,
                            draw_visible, viewproj, width, height,
                            sun_dir=sun_dir)


def triangle_setup_c(
    corners: CornerData,
    tri_draw,       # (T,) i32
    tri_valid,      # (T,) bool
    draw_model,     # (D, 4, 4) f32
    draw_visible,   # (D,) bool
    viewproj,       # (4, 4) f32
    width: int,
    height: int,
    sun_dir=None,
) -> TriangleSetup:
    """Per-frame half of mesh.vert + primitive setup over corner-expanded
    geometry. All shapes static; fully jittable.

    Per-frame gathers are exactly 5 small-row lookups per triangle: the four
    mvp columns + one packed [rotated-sun | visibility] per-draw row —
    everything else (positions, normals, colors, uvs, material binding) was
    corner-expanded once at scene flatten (see CornerData)."""
    f32 = jnp.float32
    W = f32(width)
    H = f32(height)

    mvp = jnp.einsum("ij,djk->dik", viewproj, draw_model, precision=_HIGHEST)           # (D,4,4)
    # mesh.frag:13 consumes the model-rotated normal ONLY via
    # dot(model3 @ n, sun_dir) == dot(n, model3^T @ sun_dir): rotate the sun
    # into each draw's mesh space ONCE per draw instead of gathering the
    # (D, 3, 3) rotation per triangle (36-byte rows pay ~3x per index).
    sd = jnp.zeros(3, f32) if sun_dir is None \
        else jnp.asarray(sun_dir, f32)[:3]
    ls = jnp.einsum("dji,j->di", draw_model[:, :3, :3], sd, precision=_HIGHEST)          # (D,3)
    # pack the frustum-cull bit into the same row: one gather serves both
    lsvis = jnp.concatenate(
        [ls, draw_visible.astype(f32)[:, None]], axis=1)             # (D,4)

    # Gather mvp COLUMN-wise: four (D, 4) 16-byte-row gathers.
    # clip_c = x*M[:,0] + y*M[:,1] + z*M[:,2] + M[:,3] (pos_h w = 1).
    mcol = [mvp[:, :, k][tri_draw][:, None, :] for k in range(4)]    # 4x(T,1,4)
    pos = corners.pos                                                # (T,3,3)
    clip = (pos[..., 0:1] * mcol[0] + pos[..., 1:2] * mcol[1]
            + pos[..., 2:3] * mcol[2] + mcol[3])                     # (T,3,4)

    w = clip[..., 3]
    zc = clip[..., 2]
    # Vulkan viewport transform kept homogeneous: X = (x/w*0.5 + 0.5)*W etc.
    xh = (clip[..., 0] + w) * (f32(0.5) * W)
    yh = (clip[..., 1] + w) * (f32(0.5) * H)
    p = jnp.stack([xh, yh, w], axis=-1)                              # (T,3,3) corners x (Xh,Yh,w)

    # adj(M) rows = cross products of the other two columns (columns = corners)
    e0 = jnp.cross(p[:, 1], p[:, 2])
    e1 = jnp.cross(p[:, 2], p[:, 0])
    e2 = jnp.cross(p[:, 0], p[:, 1])
    det = jnp.sum(e0 * p[:, 0], axis=-1)

    lv = lsvis[tri_draw]                                             # (T,4)
    good = tri_valid & (tri_draw >= 0) & (lv[:, 3] > 0) & (det != 0.0) & jnp.isfinite(det)

    s = jnp.where(det < 0, f32(-1.0), f32(1.0))[:, None]
    inv_det = jnp.where(det == 0.0, f32(0.0), f32(1.0) / jnp.abs(det))[:, None]
    c0 = e0 * s * inv_det
    c1 = e1 * s * inv_det
    c2 = e2 * s * inv_det
    cplane = jnp.stack([c0, c1, c2], axis=1)                          # (T,3,3)

    # Degenerate/culled triangles: force edges to "never covered" (c = -1).
    dead_row = jnp.array([0.0, 0.0, -1.0], f32)
    cplane = jnp.where(good[:, None, None], cplane, dead_row[None, None, :])

    # Depth plane: z(X,Y) = sum_i c_i(X,Y) * zclip_i  — affine in (X,Y).
    zplane = jnp.einsum("tec,te->tc", cplane, zc, precision=_HIGHEST)                     # (T,3)

    # Screen AABB for binning. Only trustworthy when all w are comfortably
    # positive; otherwise the triangle crosses the eye plane and its screen
    # footprint is unbounded => conservative full frame.
    w_ok = jnp.all(w > f32(1e-6), axis=-1)
    safe_w = jnp.where(w == 0.0, f32(1e-20), w)
    sx = xh / safe_w
    sy = yh / safe_w
    xmin = jnp.where(w_ok, sx.min(-1), f32(0.0))
    ymin = jnp.where(w_ok, sy.min(-1), f32(0.0))
    xmax = jnp.where(w_ok, sx.max(-1), W)
    ymax = jnp.where(w_ok, sy.max(-1), H)
    empty = jnp.array([-1.0, -1.0, -2.0, -2.0], f32)  # xmax < xmin => binned nowhere
    aabb = jnp.stack(
        [jnp.clip(xmin, 0.0, W), jnp.clip(ymin, 0.0, H),
         jnp.clip(xmax, 0.0, W), jnp.clip(ymax, 0.0, H)], axis=-1)
    aabb = jnp.where(good[:, None], aabb, empty[None, :])

    # Per-corner shading attributes — color/uv/material are static
    # (CornerData); only the light dot is per-frame.
    # mesh.vert:35 — outNormal = (renderMatrix * vec4(n, 0)).xyz (NOT
    # normalized), consumed only through dot(N, sun_dir) in mesh.frag:13 —
    # bake the dot per corner (linear, so interpolation commutes); computed
    # in mesh space against the pre-rotated sun (see lsvis above)
    light_num = jnp.einsum("tci,ti->tc", corners.nrm, lv[:, :3], precision=_HIGHEST)[..., None]
    attrs = jnp.concatenate([light_num, corners.col, corners.uv], axis=-1)

    packed = jnp.zeros((tri_draw.shape[0], SETUP_COLS), f32)
    packed = packed.at[:, COL_E:COL_E + 9].set(cplane.reshape(-1, 9))
    packed = packed.at[:, COL_Z:COL_Z + 3].set(zplane)
    packed = packed.at[:, COL_VALID].set(good.astype(f32))
    packed = packed.at[:, COL_MAT].set(corners.mat.astype(f32))

    return TriangleSetup(packed=packed, aabb=aabb, attrs=attrs, valid=good)


def triangle_setup_rows(
    corners: CornerData,
    tri_draw,       # (T,) i32
    tri_valid,      # (T,) bool
    draw_model,     # (D, 4, 4) f32
    draw_visible,   # (D,) bool
    viewproj,       # (4, 4) f32
    width: int,
    height: int,
    sun_dir=None,
    y0=None,        # () f32 — band-local y rebase for the multichip row
    #                 bands (parallel/multichip.py): every linear plane's
    #                 constant gets C += B*y0 and the AABB shifts -y0, with
    #                 the exact rounding ORDER of the gathered path's
    #                 _shift_rows_y (edge C shifted BEFORE the attribute
    #                 numerator planes are formed; the depth plane shifted
    #                 AFTER composition), so sharded frames keep compositing
    #                 bit-identically to the single-chip pipeline.
):
    """T-minor fast path: triangle_setup_c + shade.build_shade_rows fused,
    computed on dense (T,)-lane planes, returning (rows48, aabb, valid).

    Bit-identical to ``shade.build_shade_rows(triangle_setup_c(...))`` (a
    parity test pins this): it does the 5 per-frame row gathers once,
    relayouts them T-minor ONCE, runs all plane math on dense (T,) planes
    from the pre-transposed CornerData twins, and emits the (T, 48)
    fat-row block with one final stack+transpose.

    Reference analog: mesh.vert + the fixed-function primitive setup
    (vk_engine.cpp:1453 vkCmdDrawIndexed feeds both from one vertex stream).
    """
    f32 = jnp.float32
    W = f32(width)
    H = f32(height)
    T = tri_draw.shape[0]

    mvp = jnp.einsum("ij,djk->dik", viewproj, draw_model, precision=_HIGHEST)            # (D,4,4)
    sd = jnp.zeros(3, f32) if sun_dir is None \
        else jnp.asarray(sun_dir, f32)[:3]
    ls = jnp.einsum("dji,j->di", draw_model[:, :3, :3], sd, precision=_HIGHEST)          # (D,3)
    lsvis = jnp.concatenate(
        [ls, draw_visible.astype(f32)[:, None]], axis=1)             # (D,4)

    # the same 5 column-wise 16-byte-row gathers as triangle_setup_c, then
    # ONE (T, 20) -> (20, T) relayout puts everything T-minor
    mcols = [mvp[:, :, k][tri_draw] for k in range(4)]               # 4x(T,4)
    g = jnp.concatenate(mcols + [lsvis[tri_draw]], axis=1).T         # (20,T)
    m = [[g[j * 4 + c] for c in range(4)] for j in range(4)]         # m[j][c]
    lv = [g[16], g[17], g[18], g[19]]

    pos = corners.posT                                               # (3,3,T)
    # clip_c = x*M[:,0] + y*M[:,1] + z*M[:,2] + M[:,3] — same add order as
    # triangle_setup_c's broadcast chain
    clip = [[pos[i][0] * m[0][c] + pos[i][1] * m[1][c]
             + pos[i][2] * m[2][c] + m[3][c]
             for c in range(4)] for i in range(3)]                   # [i][c]
    w = [clip[i][3] for i in range(3)]
    zc = [clip[i][2] for i in range(3)]
    xh = [(clip[i][0] + w[i]) * (f32(0.5) * W) for i in range(3)]
    yh = [(clip[i][1] + w[i]) * (f32(0.5) * H) for i in range(3)]
    p = [(xh[i], yh[i], w[i]) for i in range(3)]

    def cross(u, v):
        return (u[1] * v[2] - u[2] * v[1],
                u[2] * v[0] - u[0] * v[2],
                u[0] * v[1] - u[1] * v[0])

    e0 = cross(p[1], p[2])
    e1 = cross(p[2], p[0])
    e2 = cross(p[0], p[1])
    det = e0[0] * p[0][0] + e0[1] * p[0][1] + e0[2] * p[0][2]

    good = tri_valid & (tri_draw >= 0) & (lv[3] > 0) \
        & (det != 0.0) & jnp.isfinite(det)
    s = jnp.where(det < 0, f32(-1.0), f32(1.0))
    inv_det = jnp.where(det == 0.0, f32(0.0), f32(1.0) / jnp.abs(det))
    dead = (f32(0.0), f32(0.0), f32(-1.0))
    # cplane[e][c]: edge-plane coefficient c of edge e, dead rows forced to
    # the never-covered (0, 0, -1) row exactly as triangle_setup_c
    cp = [[jnp.where(good, (e[c] * s) * inv_det, dead[c])
           for c in range(3)] for e in (e0, e1, e2)]
    # depth plane z(X,Y): einsum("tec,te->tc", cplane, zc) — from the
    # GLOBAL edge planes, then (multichip) shifted post-composition
    zplane = [cp[0][c] * zc[0] + cp[1][c] * zc[1] + cp[2][c] * zc[2]
              for c in range(3)]
    if y0 is not None:
        zplane[2] = zplane[2] + zplane[1] * y0
        # edge C rebased BEFORE pa/pb/pc/den_c form below (dead rows keep
        # their (0, 0, -1) never-covered form: B is 0 there)
        cp = [[e[0], e[1], e[2] + e[1] * y0] for e in cp]

    # screen AABB (same guards as triangle_setup_c)
    w_ok = (w[0] > f32(1e-6)) & (w[1] > f32(1e-6)) & (w[2] > f32(1e-6))
    sw = [jnp.where(w[i] == 0.0, f32(1e-20), w[i]) for i in range(3)]
    sx = [xh[i] / sw[i] for i in range(3)]
    sy = [yh[i] / sw[i] for i in range(3)]
    zero = jnp.zeros((T,), f32)
    xmin = jnp.where(w_ok, jnp.minimum(jnp.minimum(sx[0], sx[1]), sx[2]), zero)
    ymin = jnp.where(w_ok, jnp.minimum(jnp.minimum(sy[0], sy[1]), sy[2]), zero)
    xmax = jnp.where(w_ok, jnp.maximum(jnp.maximum(sx[0], sx[1]), sx[2]), W)
    ymax = jnp.where(w_ok, jnp.maximum(jnp.maximum(sy[0], sy[1]), sy[2]), H)
    empty = (f32(-1.0), f32(-1.0), f32(-2.0), f32(-2.0))
    ab = [jnp.where(good, jnp.clip(v, 0.0, hi), e)
          for v, hi, e in ((xmin, W, empty[0]), (ymin, H, empty[1]),
                           (xmax, W, empty[2]), (ymax, H, empty[3]))]
    if y0 is not None:
        # band-local AABB (the _shift_aabb_y analog; empty boxes stay empty)
        ab = [ab[0], ab[1] - y0, ab[2], ab[3] - y0]

    # per-corner attributes [light_num, r, g, b, u, v] (see shade.C_ATTR);
    # light = dot(corner normal, mesh-space sun) — einsum("tci,ti->tc")
    nrm, col, uv = corners.nrmT, corners.colT, corners.uvT
    attrs = [[nrm[i][0] * lv[0] + nrm[i][1] * lv[1] + nrm[i][2] * lv[2],
              col[i][0], col[i][1], col[i][2], uv[i][0], uv[i][1]]
             for i in range(3)]                                      # [i][a]

    # numerator planes: pa/pb/pc = einsum("tc,tca->ta", A/B/C, attrs) with
    # A/B/C = the post-where edge-plane coefficient columns
    A = [cp[e][0] for e in range(3)]
    B = [cp[e][1] for e in range(3)]
    Cc = [cp[e][2] for e in range(3)]
    pa = [A[0] * attrs[0][a] + A[1] * attrs[1][a] + A[2] * attrs[2][a]
          for a in range(6)]
    pb = [B[0] * attrs[0][a] + B[1] * attrs[1][a] + B[2] * attrs[2][a]
          for a in range(6)]
    pc = [Cc[0] * attrs[0][a] + Cc[1] * attrs[1][a] + Cc[2] * attrs[2][a]
          for a in range(6)]
    sumA = A[0] + A[1] + A[2]
    sumB = B[0] + B[1] + B[2]
    den_c = Cc[0] + Cc[1] + Cc[2]
    grad = [pa[4], pb[4], pa[5], pb[5], sumA, sumB]
    meta6 = corners.meta6T

    # the 48-column fat-row layout of shade.build_shade_rows
    planes = (
        [cp[e][c] for e in range(3) for c in range(3)]       # 0-8 edges
        + zplane                                             # 9-11 depth
        + [corners.mat.astype(f32)]                          # 12 material
        + pa + pb + pc                                       # 13-30 attrs
        + [meta6[k] for k in range(6)]                       # 31-36 tex meta
        + grad                                               # 37-42 uv grads
        + [den_c]                                            # 43 den const
        + ab                                                 # 44-47 aabb
    )
    rows = jnp.stack(planes, axis=0).T                       # (T, 48)
    aabb = jnp.stack(ab, axis=0).T                           # (T, 4)
    return rows, aabb, good
