"""Tile rasterizer — the replacement for the fixed-function rasterizer +
reversed-Z depth test the reference gets inside vkCmdDrawIndexed
(vk_engine.cpp:1453, depth state GREATER_OR_EQUAL at vk_engine.cpp:1659,
depth clear 0.0 at vk_initializers.cpp:144).

Architecture (blockwise over pixels):

1. Triangles are grouped into *chunks* of CHUNK consecutive triangles
   (after a screen-space spatial sort, so chunk AABBs stay tight).
2. ``bin_triangles_full`` (XLA) bins chunk AABBs to framebuffer tiles — a
   dense broadcast overlap test + row-wise sort compaction. Each entry
   carries a GROUP-granular mask of which sub-blocks of the chunk overlap
   the tile (``gmask``).
3. The bin walk: every tile visits its entries in order and evaluates each
   triangle's edge and depth planes over the tile's pixels with a
   per-fragment *rule* (depth test, transparency peel, or additive
   accumulation) that updates a small per-pixel state. Opaque and peel
   passes resolve only depth and the winning triangle id; the winner's
   attribute planes are gathered by id afterwards (``winner_attributes``).

The walk has two forms with identical semantics: ``_walk_pallas``, the
Pallas kernel the chunk passes use (it won every measured frame on the
card by 5-6x, PERF.md), and ``_walk_xla``, plain jax.numpy — the reference
the kernel is tested against, and the walk of the capped deferred path
(``rasterize`` / ``rasterize_peel`` over per-triangle bins from
``refine_bins``).
"""

from __future__ import annotations

import functools
import os as _os_mod

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from tpu_renderer.kernels import shade
from tpu_renderer.kernels import vertex as vx
from tpu_renderer.kernels.common import cdiv, interpret_mode

DEPTH_CLEAR = 0.0  # vk_initializers.cpp:144 (reversed-Z)
NO_TRI = -1
ID_INF = 0x7FFFFFF  # "no fragment" marker of the peel (> any triangle id)
# Triangles per binning chunk (the coarse-bin granularity). The env
# override exists for the CPU test tier (tests/conftest.py pins 8: the
# interpreter's cost scales with the per-entry unroll).
CHUNK = int(_os_mod.environ.get("RASTER_CHUNK", "32"))
# screen-space triangle sort key (see spatial_sort); RASTER_SORT env wins
SORT_MODE = "hilbert"

# gmask skip groups: dense-bin entries carry a per-(tile, chunk) bitmask of
# which GROUP-triangle sub-blocks' AABB unions actually overlap the tile
# (entry = cid << ENTRY_SHIFT | gmask, built by bin_triangles_full). The
# kernel walk skips whole dead groups on a scalar bit test; entries whose
# gmask is 0 (the chunk union box overlaps the tile but no member group
# does) are dropped at bin time.
GROUP = int(_os_mod.environ.get("RASTER_GROUP", str(min(8, CHUNK))))
N_GROUPS = CHUNK // GROUP  # 4 at the production CHUNK=32 / GROUP=8
assert N_GROUPS * GROUP == CHUNK and N_GROUPS <= 8
# bins entries: cid << ENTRY_SHIFT | gmask. 4 bits hold the default 4-group
# mask; finer GROUP granularities (N_GROUPS up to 8) widen to 8 — which
# pushes the bin sort keys past i16 beyond 127 chunks (_dense_sorted_entries)
ENTRY_SHIFT = 4 if N_GROUPS <= 4 else 8
ENTRY_GMASK_ALL = (1 << N_GROUPS) - 1  # "every group live" (unpacked bins)


def configure(*, chunk=None, group=None, sort=None):
    """Apply kernel knobs from RendererConfig (config.py is the single
    source of truth for production values; the RASTER_* env vars WIN over
    config for the CPU test tier — tests/conftest.py pins RASTER_CHUNK=8
    there).

    Must run before the first render trace: the knobs are compiled into
    the walk's unrolls, so mixing two values of the same knob in one
    process is unsupported.
    """
    global CHUNK, GROUP, N_GROUPS
    global ENTRY_SHIFT, ENTRY_GMASK_ALL, SORT_MODE
    env = _os_mod.environ
    if chunk is not None and "RASTER_CHUNK" not in env:
        CHUNK = int(chunk)
    if group is not None and "RASTER_GROUP" not in env:
        GROUP = min(int(group), CHUNK)
    else:
        GROUP = min(GROUP, CHUNK)  # keep GROUP <= a reconfigured CHUNK
    N_GROUPS = CHUNK // GROUP
    assert N_GROUPS * GROUP == CHUNK and N_GROUPS <= 8
    ENTRY_SHIFT = 4 if N_GROUPS <= 4 else 8
    ENTRY_GMASK_ALL = (1 << N_GROUPS) - 1
    if sort is not None and "RASTER_SORT" not in env:
        SORT_MODE = str(sort)


_EMPTY_AABB = (-1.0, -1.0, -2.0, -2.0)


def pad_tris(n: int) -> int:
    return cdiv(n, CHUNK) * CHUNK


def pad_for_raster(packed, aabb, valid):
    """Pad triangle arrays to a CHUNK multiple with inert rows.

    Padding rows get zero edge planes (never covered: zero edge value with a
    false top-left flag) and the canonical empty AABB (binned nowhere).
    """
    T = packed.shape[0]
    Tp = pad_tris(T)
    if Tp != T:
        packed = jnp.pad(packed, ((0, Tp - T), (0, 0)))
        empty = jnp.broadcast_to(jnp.asarray(_EMPTY_AABB, aabb.dtype), (Tp - T, 4))
        aabb = jnp.concatenate([aabb, empty], axis=0)
        valid = jnp.pad(valid, (0, Tp - T))
    return packed, aabb, valid


def spatial_sort(aabb, valid, *payloads, order=None):
    """Reorder triangles along a Hilbert curve over 8-px screen cells so
    CHUNK groups get TIGHT, roughly-square chunk AABBs.

    order: an optional precomputed permutation (from sort_order) — the
    key build + argsort are skipped and only the payload permute runs.
    ANY permutation renders correctly (binning re-derives overlap from the
    permuted AABBs each frame); a stale one only loosens chunk locality.

    Submission order groups triangles by mesh (a cube = 12 tris), so chunks
    straddle primitives and their AABBs span whole tiles; a space-filling
    curve makes chunks 2D-local blobs, so fewer (tile, chunk) bin entries
    exist and more of each entry's triangles really overlap its tile.
    RASTER_SORT=band|morton|bandserp selects the other keys. Safe for
    depth-tested opaque geometry: the result is order-independent except
    exact z-ties (a GPU's raster has no submission-order guarantee between
    overlapping equal-z fragments either). The sort is stable, so same-cell
    triangles keep submission order. Invalid triangles sort to the end
    (their chunks bin nowhere).

    Returns (aabb, valid, *payloads) all reordered by the same permutation.
    """
    if order is None:
        order = sort_order(aabb, valid)
    return (aabb[order], valid[order]) + tuple(p[order] for p in payloads)


def sort_order(aabb, valid):
    """The spatial-sort permutation alone (see spatial_sort)."""
    y0 = jnp.floor(aabb[:, 1]).astype(jnp.int32)
    x0 = jnp.floor(aabb[:, 0]).astype(jnp.int32)
    _mode = _os_mod.environ.get("RASTER_SORT", SORT_MODE)
    if _mode.startswith("morton"):
        shift = int(_mode[6:] or 3)  # morton / morton2 / morton4 ...
        def _spread(v):  # 12 -> 24 bit spread (x|y cells up to 4096)
            v = (v | (v << 8)) & 0x00F00F
            v = (v | (v << 4)) & 0x0C30C3
            return (v | (v << 2)) & 0x249249
        cx = jnp.clip(x0 >> shift, 0, 4095)
        cy = jnp.clip(y0 >> shift, 0, 4095)
        key = _spread(cx) | (_spread(cy) << 1)
    elif _mode == "hilbert":
        n = 12  # 4096 cells
        x = jnp.clip(x0 >> 3, 0, 4095)
        y = jnp.clip(y0 >> 3, 0, 4095)
        key = jnp.zeros_like(x)
        for i in range(n - 1, -1, -1):
            s = jnp.int32(1 << i)
            rx = ((x & s) > 0).astype(jnp.int32)
            ry = ((y & s) > 0).astype(jnp.int32)
            key = key + s * s * ((3 * rx) ^ ry)
            # rotate quadrant
            swap = ry == 0
            fx = jnp.where(swap & (rx == 1), s - 1 - x, x)
            fy = jnp.where(swap & (rx == 1), s - 1 - y, y)
            x = jnp.where(swap, fy, fx)
            y = jnp.where(swap, fx, fy)
    elif _mode == "bandserp":
        # tile-row-aligned serpentine: 32-px band major (the raster tile
        # height), x-cell minor with a snaked 8-px y inside the band, so
        # chunks rarely straddle tile rows (A/B candidate vs hilbert)
        band = jnp.clip(y0 >> 5, 0, (1 << 15) - 1)
        xc = jnp.clip(x0 >> 3, 0, 4095)
        yl = jnp.clip((y0 >> 3) & 3, 0, 3)
        ys = jnp.where((xc & 1) == 1, 3 - yl, yl)
        key = (band << 14) | (xc << 2) | ys
    else:  # band-major round-3 key, kept for A/B comparison
        key = (jnp.clip(y0 >> 3, 0, (1 << 20) - 1) * 1024
               + jnp.clip(x0 >> 5, 0, 1023))
    key = jnp.where(valid, key, jnp.int32(2 ** 31 - 1))
    return jnp.argsort(key)  # stable: same-band keeps submission order


def chunk_aabbs(aabb, valid):
    """(T,4) per-tri AABBs -> (T/CHUNK, 4) chunk AABBs (+ chunk validity)."""
    T = aabb.shape[0]
    assert T % CHUNK == 0, "pad triangle arrays to CHUNK first"
    a = aabb.reshape(-1, CHUNK, 4)
    v = valid.reshape(-1, CHUNK)
    big = jnp.float32(1e30)
    xmin = jnp.where(v, a[..., 0], big).min(-1)
    ymin = jnp.where(v, a[..., 1], big).min(-1)
    xmax = jnp.where(v, a[..., 2], -big).max(-1)
    ymax = jnp.where(v, a[..., 3], -big).max(-1)
    any_valid = v.any(-1)
    empty = jnp.asarray(_EMPTY_AABB, jnp.float32)
    out = jnp.stack([xmin, ymin, xmax, ymax], -1)
    return jnp.where(any_valid[:, None], out, empty[None]), any_valid


def group_aabbs(aabb, valid):
    """(T,4) per-tri AABBs -> (T/GROUP, 4) skip-group AABBs (+ validity).

    Group i of chunk c covers triangles [c*CHUNK + i*GROUP, ... + GROUP);
    feeding these to bin_triangles_full produces per-entry gmask bits the
    stream raster uses to skip dead sub-blocks (see GROUP above)."""
    T = aabb.shape[0]
    assert T % GROUP == 0
    a = aabb.reshape(-1, GROUP, 4)
    v = valid.reshape(-1, GROUP)
    big = jnp.float32(1e30)
    xmin = jnp.where(v, a[..., 0], big).min(-1)
    ymin = jnp.where(v, a[..., 1], big).min(-1)
    xmax = jnp.where(v, a[..., 2], -big).max(-1)
    ymax = jnp.where(v, a[..., 3], -big).max(-1)
    any_valid = v.any(-1)
    empty = jnp.asarray(_EMPTY_AABB, jnp.float32)
    out = jnp.stack([xmin, ymin, xmax, ymax], -1)
    return jnp.where(any_valid[:, None], out, empty[None]), any_valid


# ---------------------------------------------------------------------------
# Binning (operates on chunk AABBs)
# ---------------------------------------------------------------------------


def _dense_sorted_hits(aabb, valid, *, tiles_x: int, tiles_y: int,
                       tile_w: int, tile_h: int):
    """Dense (n_tiles, T) AABB-overlap matrix compacted by a row-wise sort.

    Hits keep their slot id (submission order); misses sort behind as
    T + slot. Returns (key_sorted (n_tiles, T) i32, counts (n_tiles,) i32
    exact per-tile hit counts). Shared by bin_triangles (capped) and
    bin_triangles_full (uncapped).
    """
    T = aabb.shape[0]
    n_tiles = tiles_x * tiles_y
    packed = _pack_tile_aabb(aabb, tiles_x, tiles_y, tile_w, tile_h)
    hit = valid[None, :] & _tile_overlap(packed, tiles_x, tiles_y)
    counts = jnp.sum(hit.astype(jnp.int32), axis=1)
    if T < 32767:
        # the row-wise sort dominates binning cost and scales with key
        # bytes: chunk ids fit i16 for scenes under ~262k triangles, so
        # sort half-width keys (misses all collapse to 32767 — their order
        # is irrelevant, every consumer masks slots beyond counts)
        slot = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int16)[None, :],
                                (n_tiles, T))
        key = jnp.where(hit, slot, jnp.int16(32767))
        return jax.lax.sort(key, dimension=1).astype(jnp.int32), counts
    slot = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None, :],
                            (n_tiles, T))
    key = jnp.where(hit, slot, slot + T)
    return jax.lax.sort(key, dimension=1), counts


def _tile_overlap(packed, tiles_x: int, tiles_y: int):
    """(n,) packed tile-coord AABBs -> (n_tiles, n) bool overlap matrix."""
    n_tiles = tiles_x * tiles_y
    tiles = jnp.arange(n_tiles, dtype=jnp.int32)
    tx = (tiles % tiles_x)[:, None]
    ty = (tiles // tiles_x)[:, None]
    x0 = (packed & 0xFF)[None, :]
    y0 = ((packed >> 8) & 0xFF)[None, :]
    x1 = ((packed >> 16) & 0xFF)[None, :]
    y1 = ((packed >> 24) & 0xFF)[None, :]
    return ((x0 <= x1)
            & (x0 <= tx) & (x1 >= tx) & (y0 <= ty) & (y1 >= ty))


def _dense_sorted_entries(aabb, valid, gaabb, gvalid, *, tiles_x: int,
                          tiles_y: int, tile_w: int, tile_h: int):
    """Packed-entry variant of _dense_sorted_hits for the stream kernels.

    Returns (entry_sorted (n_tiles, T) i32, counts) where a live entry is
    cid << ENTRY_SHIFT | gmask. With gaabb/gvalid (GROUP-granular boxes from
    group_aabbs), gmask marks which sub-groups overlap the tile and entries
    whose gmask would be 0 are dropped entirely — a strictly tighter bin
    than the chunk-union test (the union box can overlap tiles that sit in
    a gap between the member groups). Without them, every binned entry
    carries ENTRY_GMASK_ALL (no skips, identical raster behavior).

    The i16 sort fast path needs T * 16 + 15 < 32767, i.e. <= 2047 chunks
    (~65k triangles at CHUNK=32); larger scenes pay an i32 row sort.
    """
    T = aabb.shape[0]
    n_tiles = tiles_x * tiles_y
    if gaabb is None:
        packed = _pack_tile_aabb(aabb, tiles_x, tiles_y, tile_w, tile_h)
        hit = valid[None, :] & _tile_overlap(packed, tiles_x, tiles_y)
        gm = jnp.where(hit, jnp.int32(ENTRY_GMASK_ALL), 0)
    else:
        assert gaabb.shape[0] == T * N_GROUPS
        pg = _pack_tile_aabb(gaabb, tiles_x, tiles_y, tile_w, tile_h)
        pg = pg.reshape(T, N_GROUPS)
        gv = gvalid.reshape(T, N_GROUPS)
        gm = jnp.zeros((n_tiles, T), jnp.int32)
        for g in range(N_GROUPS):
            hg = gv[None, :, g] & _tile_overlap(pg[:, g], tiles_x, tiles_y)
            gm = gm | (hg.astype(jnp.int32) << g)
    hit = gm > 0
    counts = jnp.sum(hit.astype(jnp.int32), axis=1)
    if (T << ENTRY_SHIFT) + ENTRY_GMASK_ALL < 32767:
        slot = jnp.arange(T, dtype=jnp.int16)[None, :] << ENTRY_SHIFT
        key = jnp.where(hit, slot + gm.astype(jnp.int16), jnp.int16(32767))
        return jax.lax.sort(key, dimension=1).astype(jnp.int32), counts
    slot = jnp.arange(T, dtype=jnp.int32)[None, :] << ENTRY_SHIFT
    key = jnp.where(hit, slot + gm, jnp.int32(1) << 30)
    return jax.lax.sort(key, dimension=1), counts


@functools.partial(
    jax.jit,
    static_argnames=("tiles_x", "tiles_y", "tile_w", "tile_h", "bin_cap"),
)
def bin_triangles(aabb, valid, *, tiles_x: int, tiles_y: int, tile_w: int,
                  tile_h: int, bin_cap: int):
    """Build per-tile bins from AABBs (normally *chunk* AABBs).

    DENSE formulation: a broadcast (n_tiles, T) AABB-overlap test followed by
    a row-wise single-array sort for compaction. No gathers, no global sort,
    no entry budget. The hit matrix is bound by n_tiles * n_chunks, which
    stays small because items are CHUNK-triangle groups.

    Returns (bins (n_tiles, bin_cap) i32 item ids padded with -1,
             counts (n_tiles,) i32 — clamped to bin_cap,
             overflow () i32 — total entries dropped beyond bin_cap).
    """
    T = aabb.shape[0]
    key_sorted, full_counts = _dense_sorted_hits(
        aabb, valid, tiles_x=tiles_x, tiles_y=tiles_y,
        tile_w=tile_w, tile_h=tile_h)
    eff_cap = min(bin_cap, T)
    counts = jnp.minimum(full_counts, eff_cap)
    in_bin = jnp.arange(eff_cap, dtype=jnp.int32)[None, :] < counts[:, None]
    bins = jnp.where(in_bin, key_sorted[:, :eff_cap], NO_TRI)
    if eff_cap < bin_cap:
        bins = jnp.pad(bins, ((0, 0), (0, bin_cap - eff_cap)),
                       constant_values=NO_TRI)
    overflow = jnp.sum(full_counts - counts)
    return bins, counts, overflow


@functools.partial(
    jax.jit,
    static_argnames=("tiles_x", "tiles_y", "tile_w", "tile_h"),
)
def bin_triangles_full(aabb, valid, *, tiles_x: int, tiles_y: int,
                       tile_w: int, tile_h: int, gaabb=None, gvalid=None):
    """Dense binning with NO capacity: every (tile, item) overlap is kept.

    Same dense broadcast-overlap + row-wise-sort as bin_triangles, but the
    output keeps the full sorted width: nothing can ever overflow or drop,
    and the walk's trip count per tile is its exact entry count. The
    reference's pipeline has no capacity cliff either (vkCmdDrawIndexed,
    vk_engine.cpp:1453).

    Memory envelope: the dense bins are n_tiles x n_chunks i32 (+ the same
    in sort keys, i16 under 2047 chunks / ~65k tris since the gmask pack
    took 4 key bits; i32 beyond) — ~24 MB per million triangles at
    1080p/32x128 tiles. Scenes past config.dense_bin_max_chunks raster
    through the capped bin_triangles + engine cap-escalation path instead
    (Engine._compute_caps).

    gaabb/gvalid: optional group_aabbs output; adds real per-entry gmask
    bits (and drops entries no group touches). Without them every entry
    packs ENTRY_GMASK_ALL.

    Returns (bins (n_tiles, T) i32 PACKED entries cid << ENTRY_SHIFT |
             gmask, padded with -1; counts (n_tiles,) i32 — exact, never
             clamped).
    """
    T = aabb.shape[0]
    key_sorted, counts = _dense_sorted_entries(
        aabb, valid, gaabb, gvalid, tiles_x=tiles_x, tiles_y=tiles_y,
        tile_w=tile_w, tile_h=tile_h)
    in_bin = jnp.arange(T, dtype=jnp.int32)[None, :] < counts[:, None]
    return jnp.where(in_bin, key_sorted, NO_TRI), counts


def full_bins(n_chunks: int, n_tiles: int, bin_cap: int):
    """Trivial binning: every tile tests every chunk (small scenes/tests)."""
    assert bin_cap >= n_chunks
    slot = np.arange(bin_cap, dtype=np.int32)
    row = np.where(slot < n_chunks, slot, NO_TRI)
    bins = jnp.asarray(np.broadcast_to(row, (n_tiles, bin_cap)).copy())
    counts = jnp.full((n_tiles,), n_chunks, jnp.int32)
    return bins, counts


def _pack_tile_aabb(aabb, tiles_x: int, tiles_y: int, tile_w: int, tile_h: int):
    """Per-triangle tile-coordinate AABB packed into one u32
    (tx0 | ty0<<8 | tx1<<16 | ty1<<24). Empty AABBs pack to tx0 > tx1.
    Requires tiles_x, tiles_y <= 255 (true for any <32k-wide framebuffer).
    """
    tx0 = jnp.clip(jnp.floor(aabb[:, 0] / tile_w).astype(jnp.int32), 0, tiles_x - 1)
    ty0 = jnp.clip(jnp.floor(aabb[:, 1] / tile_h).astype(jnp.int32), 0, tiles_y - 1)
    tx1 = jnp.floor(aabb[:, 2] / tile_w).astype(jnp.int32)
    ty1 = jnp.floor(aabb[:, 3] / tile_h).astype(jnp.int32)
    empty = (aabb[:, 2] < aabb[:, 0]) | (aabb[:, 3] < aabb[:, 1]) | (tx1 < 0) | (ty1 < 0)
    tx1 = jnp.clip(tx1, 0, tiles_x - 1)
    ty1 = jnp.clip(ty1, 0, tiles_y - 1)
    # empty: force tx0 > tx1 so no tile matches
    tx0 = jnp.where(empty, 1, tx0)
    tx1 = jnp.where(empty, 0, tx1)
    return tx0 | (ty0 << 8) | (tx1 << 16) | (ty1 << 24)


def expand_bins(chunk_bins, chunk_counts):
    """Chunk bins -> per-triangle bins WITHOUT the tightening pass.

    For small triangle sets the refine stage costs more than letting the
    raster loop evaluate the few extra misses; this just expands each binned
    chunk to its CHUNK member ids (order preserved).
    """
    n_tiles, bcap = chunk_bins.shape
    tri = jnp.where(chunk_bins >= 0, chunk_bins, 0)[:, :, None] * CHUNK \
        + jnp.arange(CHUNK, dtype=jnp.int32)[None, None, :]
    tri = tri.reshape(n_tiles, bcap * CHUNK)
    slot_ok = jnp.repeat(chunk_bins >= 0, CHUNK, axis=1)
    return jnp.where(slot_ok, tri, NO_TRI), chunk_counts * CHUNK


@functools.partial(
    jax.jit,
    static_argnames=("tiles_x", "tiles_y", "tile_w", "tile_h", "tri_cap"),
)
def refine_bins(chunk_bins, aabb, *, tiles_x: int, tiles_y: int,
                tile_w: int, tile_h: int, tri_cap: int):
    """Chunk bins -> tight per-TRIANGLE bins, entirely in XLA.

    For every (tile, binned chunk) pair, test the CHUNK member triangles'
    AABBs against the tile's pixel-center bounds, then compact each tile's
    hits with a row-wise sort. Dead/culled triangles have
    empty AABBs and drop out here, so the raster loop sees only real work.

    Returns (tri_bins (n_tiles, tri_cap) i32, tri_counts (n_tiles,) i32,
             overflow () i32).
    """
    n_tiles, bcap = chunk_bins.shape
    T = aabb.shape[0]
    ncand = bcap * CHUNK

    tri = jnp.where(chunk_bins >= 0, chunk_bins, 0)[:, :, None] * CHUNK \
        + jnp.arange(CHUNK, dtype=jnp.int32)[None, None, :]
    tri = tri.reshape(n_tiles, ncand)
    slot_ok = jnp.repeat(chunk_bins >= 0, CHUNK, axis=1)

    # One ROW gather per chunk slot: all CHUNK packed tile-AABB words of a
    # chunk at once.
    packed_tc = _pack_tile_aabb(aabb, tiles_x, tiles_y, tile_w, tile_h)
    chunk_rows = packed_tc.reshape(-1, CHUNK)          # (T/CHUNK, CHUNK)
    safe_chunks = jnp.clip(chunk_bins, 0, chunk_rows.shape[0] - 1)
    cand = chunk_rows[safe_chunks].reshape(n_tiles, ncand)

    tile_id = jnp.arange(n_tiles, dtype=jnp.int32)
    tx = tile_id % tiles_x
    ty = tile_id // tiles_x
    ctx0 = cand & 0xFF
    cty0 = (cand >> 8) & 0xFF
    ctx1 = (cand >> 16) & 0xFF
    cty1 = (cand >> 24) & 0xFF
    hit = (slot_ok
           & (ctx0 <= tx[:, None]) & (ctx1 >= tx[:, None])
           & (cty0 <= ty[:, None]) & (cty1 >= ty[:, None])
           & (ctx0 <= ctx1))

    full_counts = jnp.sum(hit.astype(jnp.int32), axis=1)
    eff_cap = min(tri_cap, ncand)  # can't hold more than the candidate set
    counts = jnp.minimum(full_counts, eff_cap)

    # Compaction by ROW-WISE sort. Candidate tri ids are ascending within a
    # tile (bin_triangles
    # emits chunk ids in ascending = submission order), so sorting the tri
    # id itself keeps submission order AND needs only ONE sorted array
    # (half the sort bandwidth of a (key, value) pair): misses sort behind
    # every real id via a large offset.
    slot = jnp.broadcast_to(jnp.arange(ncand, dtype=jnp.int32)[None, :], tri.shape)
    key = jnp.where(hit, tri, jnp.int32(1 << 29) + slot)
    key_sorted = jax.lax.sort(key, dimension=1)

    in_bin = jnp.arange(eff_cap, dtype=jnp.int32)[None, :] < counts[:, None]
    tri_bins = jnp.where(in_bin, key_sorted[:, :eff_cap], NO_TRI)
    overflow = jnp.sum(full_counts - counts)
    return tri_bins, counts, overflow


# ---------------------------------------------------------------------------
# Per-fragment rules
#
# A rule maps (state, planes, p, r, X, Y, idx, live) -> new state for ONE
# triangle over a block of pixels:
#   state  tuple of per-pixel planes (the walk's carry)
#   planes tuple of per-pixel inputs (opaque depth, last peeled id)
#   p(k)   scalar parameter k (the accumulation's light vector)
#   r(col) the triangle's setup-row coefficient `col` (a scalar in the
#          kernel, a per-tile (n_tiles, 1, 1) column in the XLA walk)
#   X, Y   pixel-center coordinate planes
#   idx    the triangle's id; live: bool mask of real entries, or None
# The same functions run inside the Pallas kernel and the XLA walk, so the
# two forms share every comparison and every rounding step.
# ---------------------------------------------------------------------------


def _edge_in(r, e, X, Y):
    """Edge e's coverage with the top-left fill rule: a zero edge value
    counts as covered iff the interior lies in +x (left edge) or, for a
    horizontal edge, below (top edge). Adjacent triangles compute exactly
    negated coefficients on a shared edge, so every boundary pixel is
    covered exactly once."""
    a, b = r(3 * e), r(3 * e + 1)
    val = a * X + b * Y + r(3 * e + 2)
    top_left = (a > 0.0) | ((a == 0.0) & (b > 0.0))
    return jnp.where(top_left, val >= 0.0, val > 0.0)


def _covered(r, X, Y):
    """(coverage, depth) of one triangle. The far-plane test zv <= 1 is
    explicit; zv >= 0 is implied by every rule's depth test against a
    plane that starts at DEPTH_CLEAR = 0 (near/far "clip" in [0, 1])."""
    zv = r(9) * X + r(10) * Y + r(11)
    cov = (_edge_in(r, 0, X, Y) & _edge_in(r, 1, X, Y) & _edge_in(r, 2, X, Y)
           & (zv <= 1.0))
    return cov, zv


def _depth_rule(state, planes, p, r, X, Y, idx, live):
    """Opaque visibility: reversed-Z GREATER_OR_EQUAL with depth write
    (vk_engine.cpp:1659); equal depth goes to the later triangle of the
    walk (bins are in chunk order, chunks in sorted order)."""
    z, tid = state
    cov, zv = _covered(r, X, Y)
    take = cov & (zv >= z)
    if live is not None:
        take &= live
    return jnp.where(take, zv, z), jnp.where(take, idx, tid)


def _peel_rule(state, planes, p, r, X, Y, idx, live):
    """One transparency peel: among fragments that pass the depth test
    against the opaque z (depth write off, vk_engine.cpp:1673-1676) and
    have an id above the last peeled layer, keep the SMALLEST id —
    submission-order peeling (vk_engine.cpp:1459-1465)."""
    (best,) = state
    zbase, last = planes
    cov, zv = _covered(r, X, Y)
    take = cov & (zv >= zbase) & (idx > last) & (idx < best)
    if live is not None:
        take &= live
    return (jnp.where(take, idx, best),)


def _accum_rule(state, planes, p, r, X, Y, idx, live):
    """Order-independent transparent accumulation (untextured materials).

    The reference's transparent pass is additive blending with
    dstAlpha-scaling (vk_pipelines.cpp:157-167), and mesh.frag always
    writes alpha = 1.0 (shaders/mesh.frag:18), so after the first blended
    fragment dst.a == 1 and the pass reduces to a SUM of every transparent
    fragment that passes the depth test against the opaque z. Each
    fragment is shaded here (mesh.frag:12-18 with tex factor 1): the
    perspective-correct light numerator and color, numerator planes over
    the denominator plane (shade.C_ATTR, shade.C_DEN).
    p: [sun_dir xyz, sun_power, ambient rgb, 0]; the light dot is baked
    into the light numerator at setup, so sun_dir is unused here.
    """
    ar, ag, ab, cnt = state
    (zbase,) = planes
    cov, zv = _covered(r, X, Y)
    take = cov & (zv >= zbase)
    if live is not None:
        take &= live
    den = r(41) * X + r(42) * Y + r(43)
    inv = jnp.where(den != 0.0, 1.0 / den, 0.0)
    ln = (r(13) * X + r(19) * Y + r(25)) * inv
    cr = (r(14) * X + r(20) * Y + r(26)) * inv
    cg = (r(15) * X + r(21) * Y + r(27)) * inv
    cb = (r(16) * X + r(22) * Y + r(28)) * inv
    scale = jnp.maximum(ln, jnp.float32(0.1)) * p(3)
    ar = jnp.where(take, ar + cr * (scale + p(4)), ar)
    ag = jnp.where(take, ag + cg * (scale + p(5)), ag)
    ab = jnp.where(take, ab + cb * (scale + p(6)), ab)
    return ar, ag, ab, jnp.where(take, cnt + 1, cnt)


# per-pixel state (fill value, dtype) of each rule
_DEPTH_STATE = ((DEPTH_CLEAR, jnp.float32), (NO_TRI, jnp.int32))
_PEEL_STATE = ((ID_INF, jnp.int32),)
_ACCUM_STATE = ((0.0, jnp.float32),) * 3 + ((0, jnp.int32),)


# ---------------------------------------------------------------------------
# The bin walk, in two forms
# ---------------------------------------------------------------------------


def _pixel_planes(hp: int, wp: int):
    """Full-frame pixel-center coordinate planes (Vulkan: +0.5)."""
    X = jax.lax.broadcasted_iota(jnp.int32, (hp, wp), 1).astype(jnp.float32) \
        + jnp.float32(0.5)
    Y = jax.lax.broadcasted_iota(jnp.int32, (hp, wp), 0).astype(jnp.float32) \
        + jnp.float32(0.5)
    return X, Y


def _tile_coords(i, j, tile_h: int, tile_w: int):
    """Pixel centers of tile (i, j) in global screen coordinates."""
    yy = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0) + i * tile_h
    xx = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1) + j * tile_w
    X = xx.astype(jnp.float32) + jnp.float32(0.5)
    Y = yy.astype(jnp.float32) + jnp.float32(0.5)
    return X, Y


def _to_tiles(a, tiles_x: int, tiles_y: int, tile_h: int, tile_w: int):
    """(Hp, Wp) plane -> (n_tiles, tile_h, tile_w), tiles in row-major order."""
    return a.reshape(tiles_y, tile_h, tiles_x, tile_w).transpose(0, 2, 1, 3) \
        .reshape(tiles_y * tiles_x, tile_h, tile_w)


def _from_tiles(a, tiles_x: int, tiles_y: int, tile_h: int, tile_w: int):
    return a.reshape(tiles_y, tiles_x, tile_h, tile_w).transpose(0, 2, 1, 3) \
        .reshape(tiles_y * tile_h, tiles_x * tile_w)


def _walk_xla(rule, rows, bins, counts, init, planes=(), params=None, *,
              chunk: int, tiles_x: int, tiles_y: int, tile_w: int,
              tile_h: int):
    """The bin walk in plain jax.numpy/lax (the reference form).

    Step k gathers every tile's k-th bin entry and evaluates its triangles
    over ALL tiles at once, for max(counts) steps; tiles whose lists are
    shorter, and gmask groups that miss a tile, are masked through the
    rule's `live` input. The per-tile visiting order is the same as the
    kernel's, so results are identical.

    rows: (T, C) setup rows (only the columns the rule reads matter).
    bins: (n_tiles, W) i32 — packed chunk entries cid << ENTRY_SHIFT |
      gmask when chunk > 1, plain triangle ids when chunk == 1.
    init: the rule's ((fill, dtype), ...) state spec.
    Returns the final state as (Hp, Wp) planes.
    """
    tiles = functools.partial(_to_tiles, tiles_x=tiles_x, tiles_y=tiles_y,
                              tile_h=tile_h, tile_w=tile_w)
    X, Y = (tiles(a) for a in _pixel_planes(tiles_y * tile_h,
                                            tiles_x * tile_w))
    planes = tuple(tiles(a) for a in planes)
    p = None if params is None else (lambda k: params[k])
    n_tiles = tiles_x * tiles_y
    blocks = rows.reshape(rows.shape[0] // chunk, chunk, rows.shape[1])

    def step(k, state):
        entry = jax.lax.dynamic_index_in_dim(bins, k, axis=1, keepdims=False)
        live = (k < counts) & (entry >= 0)
        cid = entry >> ENTRY_SHIFT if chunk > 1 else entry
        cid = jnp.where(live, cid, 0)
        blk = blocks[cid]                                  # (n_tiles, chunk, C)
        for t in range(chunk):
            on = live
            if chunk > 1:
                on = on & (((entry >> (t // GROUP)) & 1) != 0)
            state = rule(state, planes, p,
                         lambda col, _t=t: blk[:, _t, col][:, None, None],
                         X, Y, (cid * chunk + t)[:, None, None],
                         on[:, None, None])
        return state

    state = tuple(jnp.full((n_tiles, tile_h, tile_w), v, dt) for v, dt in init)
    state = jax.lax.fori_loop(0, jnp.max(counts), step, state)
    return tuple(_from_tiles(s, tiles_x, tiles_y, tile_h, tile_w)
                 for s in state)


# Warps per kernel program: a 32x128 tile over 256 threads keeps 16 pixels
# of (z, tid) plus the per-triangle temporaries in registers.
_NUM_WARPS = 8


def _walk_pallas(rule, rows, bins, counts, init, planes=(), params=None, *,
                 chunk: int, tiles_x: int, tiles_y: int, tile_w: int,
                 tile_h: int):
    """The bin walk as a Pallas kernel through Triton.

    One program per tile walks ONLY its own list (a data-dependent trip
    count: the XLA form pays max(counts) steps on every tile), loads each
    entry's triangle coefficients as scalars from the (T, C) rows in
    device memory, and skips a GROUP sub-block on a clear gmask bit with a
    uniform branch. The per-pixel state lives in registers for the whole
    walk; only the final state is stored. Same arguments and results as
    _walk_xla, for chunk bins (chunk > 1).
    """
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    n_planes = len(planes)
    if params is None:
        params = jnp.zeros((1,), jnp.float32)

    def kernel(counts_ref, bins_ref, rows_ref, params_ref, *refs):
        plane_refs, out_refs = refs[:n_planes], refs[n_planes:]
        i = pl.program_id(0)
        j = pl.program_id(1)
        tile = i * tiles_x + j
        X, Y = _tile_coords(i, j, tile_h, tile_w)
        pv = tuple(ref[...] for ref in plane_refs)

        def p(k):
            return params_ref[k]

        def group(first, g):
            def run(state):
                for t in range(g * GROUP, (g + 1) * GROUP):
                    state = rule(state, pv, p,
                                 lambda col, _t=t: rows_ref[first + _t, col],
                                 X, Y, first + t, None)
                return state
            return run

        def step(e, state):
            entry = bins_ref[tile, e]
            first = (entry >> ENTRY_SHIFT) * chunk
            for g in range(N_GROUPS):
                state = jax.lax.cond(((entry >> g) & 1) != 0, group(first, g),
                                     lambda s: s, state)
            return state

        state = tuple(jnp.full((tile_h, tile_w), v, dt) for v, dt in init)
        state = jax.lax.fori_loop(0, counts_ref[tile], step, state)
        for ref, s in zip(out_refs, state):
            ref[...] = s

    whole = pl.BlockSpec()
    tile_spec = pl.BlockSpec((tile_h, tile_w), lambda i, j: (i, j))
    return pl.pallas_call(
        kernel,
        out_shape=tuple(jax.ShapeDtypeStruct((hp, wp), dt) for _, dt in init),
        grid=(tiles_y, tiles_x),
        in_specs=[whole] * 4 + [tile_spec] * n_planes,
        out_specs=tuple(tile_spec for _ in init),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret_mode(),
        name=f"raster_walk_{rule.__name__.strip('_')}",
    )(counts, bins, rows, params, *planes)


def winner_attributes(rows, tid):
    """Shading inputs of each pixel's winning triangle, gathered by id.

    rows: (T, 48) fat rows (kernels/shade layout); tid: (Hp, Wp) i32 with
    NO_TRI where nothing won. Evaluates the winner's attribute-numerator
    and denominator planes at the pixel centers and returns the public
    (attrs (N_ATTR, Hp, Wp) perspective-divided [light_num, rgb, uv],
    metas (N_META, Hp, Wp) = [tex6, uv-grad6, den_c], inv (Hp, Wp) = 1/den).
    Winnerless pixels read zeros: den 0 -> inv 0 -> attrs 0 (callers mask
    them by tid).
    """
    hp, wp = tid.shape
    X, Y = _pixel_planes(hp, wp)
    hit = tid >= 0
    lo, hi = shade.C_ATTR, shade.C_DEN + 1
    g = rows[:, lo:hi].T[:, jnp.where(hit, tid, 0)]         # (31, Hp, Wp)
    g = jnp.where(hit[None], g, 0.0)
    a = shade.N_ATTR
    d = shade.C_GRAD + 4 - lo  # den_a, den_b, den_c
    den = g[d] * X + g[d + 1] * Y + g[d + 2]
    inv = jnp.where(den != 0.0, 1.0 / den, 0.0)
    nums = jnp.stack([g[k] * X + g[a + k] * Y + g[2 * a + k]
                      for k in range(a)])
    return nums * inv[None], g[shade.C_TEX - lo:], inv


_TILE_ARGS = ("tiles_x", "tiles_y", "tile_w", "tile_h")


@functools.partial(jax.jit, static_argnames=_TILE_ARGS)
def rasterize_chunks(fat_rows, bins, counts, *, tiles_x: int, tiles_y: int,
                     tile_w: int, tile_h: int):
    """Opaque raster over uncapped dense chunk bins.

    fat_rows: (T, 48) f32, T % CHUNK == 0; bins/counts: bin_triangles_full
    output over the chunk AABBs. Nothing is capped or dropped — the
    reference's hardware raster has no capacity cliff either
    (vkCmdDrawIndexed, vk_engine.cpp:1453).
    Returns (z, tid, attrs (N_ATTR,Hp,Wp), metas (N_META,Hp,Wp), inv).
    """
    z, tid = _walk_pallas(_depth_rule, fat_rows, bins, counts, _DEPTH_STATE,
                          chunk=CHUNK, tiles_x=tiles_x, tiles_y=tiles_y,
                          tile_w=tile_w, tile_h=tile_h)
    return (z, tid) + winner_attributes(fat_rows, tid)


@functools.partial(jax.jit, static_argnames=_TILE_ARGS)
def accumulate_chunks(fat_rows, bins, counts, z_base, light, *,
                      tiles_x: int, tiles_y: int, tile_w: int, tile_h: int):
    """Sum-shade ALL transparent fragments in one pass (untextured path;
    see _accum_rule), over uncapped dense chunk bins.

    light: (8,) f32 [sun_dir xyz, sun_power, ambient rgb, 0].
    Returns (acc (3, Hp, Wp) f32 summed src colors,
             cnt (Hp, Wp) i32 fragments blended per pixel).
    """
    ar, ag, ab, cnt = _walk_pallas(
        _accum_rule, fat_rows, bins, counts, _ACCUM_STATE, (z_base,), light,
        chunk=CHUNK, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w,
        tile_h=tile_h)
    return jnp.stack([ar, ag, ab]), cnt


@functools.partial(jax.jit, static_argnames=_TILE_ARGS)
def peel_chunks(fat_rows, bins, counts, z_base, last_id, *, tiles_x: int,
                tiles_y: int, tile_w: int, tile_h: int):
    """One transparency peel over uncapped dense chunk bins (_peel_rule).

    Returns (best id (ID_INF where no layer), attrs (N_ATTR,Hp,Wp),
    metas (N_META,Hp,Wp), inv (Hp,Wp)) of the peeled layer.
    """
    (best,) = _walk_pallas(_peel_rule, fat_rows, bins, counts, _PEEL_STATE,
                           (z_base, last_id), chunk=CHUNK, tiles_x=tiles_x,
                           tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h)
    tid = jnp.where(best < ID_INF, best, NO_TRI)
    return (best,) + winner_attributes(fat_rows, tid)


@functools.partial(jax.jit, static_argnames=_TILE_ARGS)
def rasterize(packed, bins, counts, *, tiles_x: int, tiles_y: int,
              tile_w: int, tile_h: int):
    """Visibility raster of the capped deferred path.

    packed: (T, 16) f32 setup rows (kernels/vertex.py layout)
    bins:   (n_tiles, tri_cap) i32 per-TRIANGLE ids (refine_bins output),
            counts: (n_tiles,) i32
    Returns (z (Hp, Wp) f32, tri_id (Hp, Wp) i32).
    """
    return _walk_xla(_depth_rule, packed, bins, counts, _DEPTH_STATE,
                     chunk=1, tiles_x=tiles_x, tiles_y=tiles_y,
                     tile_w=tile_w, tile_h=tile_h)


@functools.partial(jax.jit, static_argnames=_TILE_ARGS)
def rasterize_peel(packed, bins, counts, z_base, last_id, *, tiles_x: int,
                   tiles_y: int, tile_w: int, tile_h: int):
    """One transparency peel of the capped deferred path: per pixel, the
    smallest triangle id > last_id that covers the pixel and passes the
    depth test against z_base.

    bins: per-TRIANGLE ids (refine_bins or expand_bins output).
    Returns (Hp, Wp) i32 with ID_INF where no fragment was found.
    """
    (best,) = _walk_xla(_peel_rule, packed, bins, counts, _PEEL_STATE,
                        (z_base, last_id), chunk=1, tiles_x=tiles_x,
                        tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h)
    return best


# ---------------------------------------------------------------------------
# Reference rasterizer (numpy, per-pixel loop) — the unit-test oracle
# ---------------------------------------------------------------------------


def rasterize_reference(packed, width: int, height: int):
    """Direct per-pixel evaluation of the same math. Tiny inputs only."""
    packed = np.asarray(packed)
    T = packed.shape[0]
    z = np.full((height, width), DEPTH_CLEAR, np.float32)
    tid = np.full((height, width), NO_TRI, np.int32)
    for t in range(T):
        row = packed[t]
        if row[vx.COL_VALID] == 0.0:
            continue
        for y in range(height):
            for x in range(width):
                X, Y = np.float32(x + 0.5), np.float32(y + 0.5)
                cov = True
                for e in range(3):
                    a, b, c = row[3 * e], row[3 * e + 1], row[3 * e + 2]
                    val = a * X + b * Y + c
                    tl = (a > 0) or (a == 0 and b > 0)
                    cov &= (val > 0) or (val == 0 and tl)
                if not cov:
                    continue
                zv = row[9] * X + row[10] * Y + row[11]
                if zv < 0.0 or zv > 1.0:
                    continue
                if zv >= z[y, x]:
                    z[y, x] = zv
                    tid[y, x] = t
    return z, tid
