"""Tile binning: map each screen tile to its index-ordered splat list.

The reference is splat-major scatter (each splat walks its own footprint,
main.cpp:419-537). The production path inverts this: the screen is cut
into (tile_h x tile_w)-pixel tiles and each tile gathers the splats whose
conservative bounding box (Form.pdf section 12) intersects it, preserving
splat *index order* (the compositing order contract, Form.pdf p2).

Binning is the standard sort-based pipeline, fully static-shaped for XLA:

 1. per splat: clamped tile-space bbox from the exact covariance bbox
    half-extents (sqrt(s22), sqrt(s11) scaled by 3 -- main.cpp:488-489)
 2. duplicate (splat, tile) pairs into a flat buffer at cumsum offsets
 3. stable-sort by tile id (duplicates were laid out in splat order, so
    equal tiles keep index order)
 4. slice each tile's run into a padded (n_tiles, K) id matrix

Capacity caps (duplicate buffer, per-tile K) are static; overflow is counted
and reported, never silently dropped (returned in BinStats).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.ops import geometry
from gs2d_tpu.ops.numerics import trunc_to_int
from gs2d_tpu.params import GaussianParams

# Field order in the packed per-splat parameter rows consumed by the
# rasterizers (16 fields: a power-of-two row).
FIELD_PX = 0
FIELD_PY = 1
FIELD_A = 2      # inv_cov[0][0]
FIELD_B = 3      # inv_cov[1][0] (== [0][1])
FIELD_D = 4      # inv_cov[1][1]
FIELD_H = 5      # bbox half-height * bounds (row walk extent)
FIELD_CR = 6
FIELD_CG = 7
FIELD_CB = 8
FIELD_OP = 9
FIELD_SX = 10
FIELD_SY = 11
FIELD_COS = 12
FIELD_SIN = 13
FIELD_VALID = 14
N_FIELDS = 16


class TileBinning(NamedTuple):
    """Static-shaped binning of splats onto screen tiles."""

    ids: jax.Array          # (n_tiles, K) int32 splat ids, -1 padding
    tile_params: jax.Array  # (n_tiles, K, N_FIELDS) f32 packed params
    count: jax.Array        # (n_tiles,) int32 live entries per tile
    n_dropped: jax.Array    # scalar int32: entries lost to capacity caps


def packed_fields(p: GaussianParams, bounds: float = 3.0) -> jax.Array:
    """(N_FIELDS, N) packed per-splat scalars shared by fwd/bwd kernels.

    ``bounds`` is the sigma cutoff of the row walk (cfg.splat_bounds)."""
    s11, s12, s22 = geometry.cov_of(p.sx, p.sy, p.rot)
    a, b, d, det = geometry.inv_cov_of(s11, s12, s22)
    h = geometry.bbox_half_height(a, det, bounds)
    n = p.pos.shape[0]
    f = jnp.zeros((N_FIELDS, n), jnp.float32)
    f = f.at[FIELD_PX].set(p.pos[:, 0])
    f = f.at[FIELD_PY].set(p.pos[:, 1])
    f = f.at[FIELD_A].set(a)
    f = f.at[FIELD_B].set(b)
    f = f.at[FIELD_D].set(d)
    f = f.at[FIELD_H].set(h)
    f = f.at[FIELD_CR].set(p.color[:, 0])
    f = f.at[FIELD_CG].set(p.color[:, 1])
    f = f.at[FIELD_CB].set(p.color[:, 2])
    f = f.at[FIELD_OP].set(p.opacity)
    f = f.at[FIELD_SX].set(p.sx)
    f = f.at[FIELD_SY].set(p.sy)
    f = f.at[FIELD_COS].set(jnp.cos(p.rot))
    f = f.at[FIELD_SIN].set(jnp.sin(p.rot))
    f = f.at[FIELD_VALID].set(1.0)
    return f


def splat_tile_bbox(p: GaussianParams, cfg: SplatConfig):
    """Per-splat tile-index bbox (tx0, tx1, ty0, ty1), clamped to the grid.

    Uses the exact covariance bbox half-extents in x and y
    (main.cpp:488-489): hx = sqrt(inv_cov[1][1]*det)*3, hy likewise. The row
    walk in the kernel re-applies the exact truncated bounds, so the tile
    bbox only needs to be conservative.
    """
    bbox, _ = _bbox_and_quad(p, cfg)
    return bbox


def _bbox_and_quad(p: GaussianParams, cfg: SplatConfig, margin: float = 0.0):
    """splat_tile_bbox plus the inverse-covariance quadratic (a, b, d) and
    position columns it was derived from (shared with tile_may_touch).

    ``margin`` expands the bbox half-extents by that many pixels -- the
    lazy-rebinning slack (see pairs_covered_by): a margined binning stays a
    superset of the exact pair set while every splat's footprint drifts
    less than the margin.

    The quad tuple carries a per-splat effective Mahalanobis cutoff k2:
    None (meaning cfg.cutoff_sq) by default; under opacity-adaptive
    culling (cfg.opacity_cull_alpha > 0) a per-splat array shrunk to the
    visibility bound 2*ln(op/alpha) -- see the config field's derivation.
    Margined calls double the opacity headroom so lazy caches survive
    opacity growth up to 2x between rebins; splats whose peak alpha is
    below the threshold (k2 <= 0, including parked op==0 dead slots) bin
    zero tiles via the offscreen flag. The default path traces EXACTLY
    the pre-cull computation (k2 None, no extra ops), preserving both
    the bitwise goldens and the persistent compilation cache."""
    s11, s12, s22 = geometry.cov_of(p.sx, p.sy, p.rot)
    a, b, d, det = geometry.inv_cov_of(s11, s12, s22)
    k2 = None
    invisible = False
    if cfg.opacity_cull_alpha > 0.0:
        headroom = 2.0 if margin > 0 else 1.0
        k2 = jnp.minimum(
            jnp.full(p.opacity.shape, jnp.float32(cfg.cutoff_sq)),
            jnp.float32(2.0) * jnp.log(
                jnp.maximum(p.opacity, jnp.float32(1e-30))
                * jnp.float32(headroom / cfg.opacity_cull_alpha)))
        invisible = k2 <= 0.0
        # Half-extents scale with the cutoff radius (they are linear in
        # ``bounds`` = sqrt(cutoff_sq), geometry.bbox_half_height).
        shrink = jnp.sqrt(jnp.maximum(k2, 0.0)) \
            / jnp.float32(cfg.splat_bounds)
        hy = geometry.bbox_half_height(a, det, cfg.splat_bounds) \
            * shrink + margin
        hx = geometry.bbox_half_width(d, det, cfg.splat_bounds) \
            * shrink + margin
    else:
        hy = geometry.bbox_half_height(a, det, cfg.splat_bounds) + margin
        hx = geometry.bbox_half_width(d, det, cfg.splat_bounds) + margin
    px, py = p.pos[:, 0], p.pos[:, 1]
    # Pixel bounds use the same trunc semantics as the rasterizer loops.
    x0 = trunc_to_int(px - hx)
    x1 = trunc_to_int(px + hx)
    y0 = trunc_to_int(py - hy)
    y1 = trunc_to_int(py + hy)
    tx0 = jnp.clip(x0 // cfg.tile_w, 0, cfg.n_tiles_x - 1)
    tx1 = jnp.clip(x1 // cfg.tile_w, 0, cfg.n_tiles_x - 1)
    ty0 = jnp.clip(y0 // cfg.tile_h, 0, cfg.n_tiles_y - 1)
    ty1 = jnp.clip(y1 // cfg.tile_h, 0, cfg.n_tiles_y - 1)
    # Fully off-screen (or below-threshold-everywhere) splats bin zero tiles.
    offscreen = (x1 < 0) | (x0 >= cfg.width) | (y1 < 0) | (y0 >= cfg.height)
    if k2 is not None:
        offscreen = offscreen | invisible
    return (tx0, tx1, ty0, ty1, offscreen), (px, py, a, b, d, k2)


# Fp slack of the conservative ellipse-rect test (tile_may_touch): the
# kernels decide coverage from their own fp evaluation of the same
# quadratic, so the cull must under-approximate by a margin. Relative part
# scales with the evaluated terms (covers cancellation), absolute part
# guards the cutoff comparison (cutoff_sq is 9.0 by default).
CULL_REL_MARGIN = 1e-5
CULL_ABS_MARGIN = 1e-3


def _col(v):
    """Broadcast a per-splat column (None passes through: default k2)."""
    return None if v is None else v[:, None]


def tile_may_touch(px, py, a, b, d, tx, tyg, cfg: SplatConfig,
                   margin: float = 0.0, k2=None):
    """Conservative per-(splat, tile) test: can the splat's Mahalanobis
    ellipse reach any pixel the kernels would walk on tile (tyg, tx)?

    The rasterizers (render_gpu.splat_terms; reference main.cpp:489-509)
    walk pixels whose row has real quadratic roots and whose column index
    lies in [trunc(px+r0), trunc(px+r1)] -- so every walked pixel center
    (x+0.5, y+0.5) has, in v = center - pos coordinates, vy inside the
    ellipse's vertical extent and vx in [r0 - 0.5, r1 + 1.5] (trunc slack,
    including the toward-zero rounding of negative interval ends). A tile
    can therefore be culled iff the exact ellipse {q(v) <= cutoff_sq},
    q(v) = a vx^2 + 2b vx vy + d vy^2, misses the tile's pixel-center rect
    expanded by [-1.5, +0.5] in x.

    Minimizing the quadratic over the rect is exact: if the rect contains
    the center the min is 0; otherwise the min lies on the boundary, and on
    each edge the restriction is a 1-D convex quadratic (a, d > 0) whose
    clamped stationary point is the edge minimum. Each edge min carries a
    term-magnitude fp margin; non-finite or degenerate inputs never cull.
    Inputs broadcast elementwise; returns a bool array.

    ``margin`` expands the tile rect by that many pixels on every side
    (lazy-rebinning slack, matching _bbox_and_quad's margin). ``k2``
    overrides the Mahalanobis cutoff per splat (broadcasting with the
    other inputs) -- the opacity-adaptive visibility bound from
    _bbox_and_quad; None keeps the geometric cfg.cutoff_sq.
    """
    tw, th = cfg.tile_w, cfg.tile_h
    k2 = jnp.float32(cfg.cutoff_sq) if k2 is None else k2
    rel = jnp.float32(CULL_REL_MARGIN)
    m = jnp.float32(margin)
    x_edge = (tx * tw).astype(jnp.float32)
    y_edge = (tyg * th).astype(jnp.float32)
    rx0 = x_edge - jnp.float32(1.0) - px - m
    rx1 = x_edge + jnp.float32(tw) - px + m
    ry0 = y_edge + jnp.float32(0.5) - py - m
    ry1 = y_edge + jnp.float32(th) - jnp.float32(0.5) - py + m

    def edge_vx(c):  # vx fixed at c, minimize over vy in [ry0, ry1]
        vy = jnp.clip(-b * c / d, ry0, ry1)
        t1, t2, t3 = a * c * c, jnp.float32(2.0) * b * c * vy, d * vy * vy
        return (t1 + t2 + t3) - rel * (jnp.abs(t1) + jnp.abs(t2)
                                       + jnp.abs(t3))

    def edge_vy(r):  # vy fixed at r, minimize over vx in [rx0, rx1]
        vx = jnp.clip(-b * r / a, rx0, rx1)
        t1, t2, t3 = a * vx * vx, jnp.float32(2.0) * b * vx * r, d * r * r
        return (t1 + t2 + t3) - rel * (jnp.abs(t1) + jnp.abs(t2)
                                       + jnp.abs(t3))

    qmin = jnp.minimum(jnp.minimum(edge_vx(rx0), edge_vx(rx1)),
                       jnp.minimum(edge_vy(ry0), edge_vy(ry1)))
    center_inside = (rx0 <= 0.0) & (0.0 <= rx1) & (ry0 <= 0.0) & (0.0 <= ry1)
    healthy = (jnp.isfinite(px) & jnp.isfinite(py) & jnp.isfinite(b)
               & (a > 0.0) & (d > 0.0)
               & jnp.isfinite(a) & jnp.isfinite(d))
    return (~healthy) | center_inside \
        | (qmin <= k2 + jnp.float32(CULL_ABS_MARGIN))


def pairs_covered_by(p_now: GaussianParams, snap: GaussianParams,
                     cfg: SplatConfig, margin: float) -> jax.Array:
    """Is the EXACT current pair set still covered by the binning built
    from ``snap`` with ``margin`` px of slack? (lazy-rebinning tripwire)

    Enumerates the exact (margin 0) pair set of ``p_now`` on the
    (N, max_tiles_per_splat) slot grid and tests each live pair for
    membership in the margined bin-time footprint: inside snap's expanded
    tile bbox AND passing snap's margin-expanded ellipse-rect test -- the
    exact predicates bin_splats(margin=...) used, so membership here means
    the pair is in the cached lists. Splat index order never changes, so a
    covered subset renders identically through the cached binning (to
    <= 1 ulp of excess-precision slot-shift noise; see test_resident.py).

    Returns a scalar bool: True while the cache is valid. Any current
    bbox truncation (count_full > cap) returns False -- forcing a rebin
    whose n_dropped tripwire reports the overflow (never silent).
    """
    cap = cfg.max_tiles_per_splat
    (tx0, tx1, ty0, ty1, off), (px, py, a, b, d, qk2) = \
        _bbox_and_quad(p_now, cfg)
    w_t = tx1 - tx0 + 1
    count_full = jnp.where(off, 0, w_t * (ty1 - ty0 + 1))
    count = jnp.minimum(count_full, cap)
    slot = jnp.arange(cap, dtype=jnp.int32)
    ly = slot[None, :] // jnp.maximum(w_t, 1)[:, None]
    lx = slot[None, :] % jnp.maximum(w_t, 1)[:, None]
    txg = tx0[:, None] + lx
    tyg = ty0[:, None] + ly
    live = slot[None, :] < count[:, None]
    if cfg.exact_cull:
        live = live & tile_may_touch(
            px[:, None], py[:, None], a[:, None], b[:, None], d[:, None],
            txg, tyg, cfg, k2=_col(qk2))

    (mtx0, mtx1, mty0, mty1, moff), (bpx, bpy, ba, bb, bd, bk2) = \
        _bbox_and_quad(snap, cfg, margin)
    inb = (txg >= mtx0[:, None]) & (txg <= mtx1[:, None]) \
        & (tyg >= mty0[:, None]) & (tyg <= mty1[:, None]) \
        & ~moff[:, None]
    member = inb & tile_may_touch(
        bpx[:, None], bpy[:, None], ba[:, None], bb[:, None], bd[:, None],
        txg, tyg, cfg, margin, k2=_col(bk2))
    ok = jnp.all(~live | member)
    return ok & jnp.all(count_full <= cap)


def bin_splats(
    p: GaussianParams,
    cfg: SplatConfig,
    max_per_tile: int,
    dup_capacity: int | None = None,  # unused (kept for API compat)
    max_tiles_per_splat: int | None = None,
    _force_segmented: bool = False,
    band_row0=0,
    band_rows: int | None = None,
    counts_only: bool = False,
    margin: float = 0.0,
) -> TileBinning:
    """Build the per-tile splat lists (index order preserved within a tile).

    max_tiles_per_splat caps the duplicate expansion per splat (a splat
    covering more tiles gets its bbox truncated; counted in n_dropped).

    ``band_row0`` (traced ok) / ``band_rows`` (static) restrict binning to a
    horizontal band of tile rows -- the unit of tile-axis sharding. Tile ids
    in the result are band-local.

    ``counts_only`` skips the id-matrix build and parameter pregather and
    returns just the *untruncated* per-tile counts (n_tiles,) -- used to
    auto-tune the static per-tile capacity (see tune_tile_capacity).

    ``margin`` (pixels) expands every splat's footprint (bbox AND cull
    rect), producing a superset binning that stays valid while splats
    drift less than the margin -- the lazy-rebinning contract checked by
    ``pairs_covered_by``. Superset pairs contribute exactly nothing in the
    kernels, so renders are mathematically identical (<= 1 ulp of
    excess-precision slot-shift noise through the compiled loops).
    """
    n = p.pos.shape[0]
    if band_rows is None:
        band_rows = cfg.n_tiles_y
        band_row0 = 0
    n_tiles = band_rows * cfg.n_tiles_x
    if max_tiles_per_splat is None:
        max_tiles_per_splat = cfg.max_tiles_per_splat
    (tx0, tx1, ty0, ty1, offscreen), (px, py, qa, qb, qd, qk2) = \
        _bbox_and_quad(p, cfg, margin)
    # Shift to band-local tile rows and clip.
    band_row0 = jnp.asarray(band_row0, jnp.int32)
    offscreen = offscreen | (ty1 < band_row0) \
        | (ty0 > band_row0 + (band_rows - 1))
    ty0 = jnp.clip(ty0 - band_row0, 0, band_rows - 1)
    ty1 = jnp.clip(ty1 - band_row0, 0, band_rows - 1)
    w_t = tx1 - tx0 + 1
    h_t = ty1 - ty0 + 1
    count_full = jnp.where(offscreen, 0, w_t * h_t)
    count = jnp.minimum(count_full, max_tiles_per_splat)
    dropped_bbox = jnp.sum(count_full - count)

    # Dense expansion: one key per (splat, slot) -- dead slots get the max
    # key and sort to the end. Sorting the dense (N * cap) array directly
    # avoids a compaction scatter.
    slot = jnp.arange(max_tiles_per_splat, dtype=jnp.int32)
    local_y = slot[None, :] // jnp.maximum(w_t, 1)[:, None]
    local_x = slot[None, :] % jnp.maximum(w_t, 1)[:, None]
    tile_id = ((ty0[:, None] + local_y) * cfg.n_tiles_x
               + tx0[:, None] + local_x).astype(jnp.int32)
    live = slot[None, :] < count[:, None]
    if cfg.exact_cull:
        # Drop bbox tiles the splat's ellipse provably cannot touch (the
        # corner tiles of rotated/anisotropic splats -- see tile_may_touch).
        # Culled pairs simply vanish from the sorted runs; they are exact
        # removals, not capacity drops, so n_dropped is unaffected.
        live = live & tile_may_touch(
            px[:, None], py[:, None], qa[:, None], qb[:, None], qd[:, None],
            tx0[:, None] + local_x,
            band_row0 + ty0[:, None] + local_y, cfg, margin,
            k2=_col(qk2))

    # Key packing: tile_id in the high bits, splat id (or segment-local id)
    # in the low bits, so a plain value sort yields per-tile runs already in
    # splat index order (the compositing-order contract, Form.pdf p2). When
    # tile_bits + splat_bits would overflow int31, the splat axis is cut into
    # segments that each fit: every segment sorts independently (one batched
    # lax.sort) and tiles stitch their per-segment runs in segment order --
    # segment s's splats all precede segment s+1's, so order is preserved.
    tile_bits = max(n_tiles.bit_length(), 1)
    splat_bits = max((n - 1).bit_length(), 1)
    seg_bits = min(splat_bits, 30 - tile_bits)
    if seg_bits <= 0:
        raise ValueError(f"too many tiles for int32 keys: {n_tiles}")
    n_seg_cap = 1 << seg_bits
    n_segments = -(-n // n_seg_cap)
    if _force_segmented and n_segments == 1:
        n_segments, n_seg_cap = 2, -(-n // 2)
    nseg = -(-n // n_segments)  # splats per segment (last padded)

    splat_ids = jnp.arange(n, dtype=jnp.int32)[:, None] * jnp.ones_like(slot)[None, :]
    local_bits = max((nseg - 1).bit_length(), 1)
    shift = jnp.int32(1 << local_bits)
    pad_key = jnp.int32(jnp.iinfo(jnp.int32).max)
    local_id = splat_ids % jnp.int32(nseg)
    key = tile_id * shift + local_id
    key = jnp.where(live, key, pad_key)

    pad_rows = n_segments * nseg - n
    if pad_rows:
        key = jnp.concatenate(
            [key, jnp.full((pad_rows, max_tiles_per_splat), pad_key)], axis=0)
    key = key.reshape(n_segments, nseg * max_tiles_per_splat)
    sorted_key = jax.lax.sort(key, dimension=-1)   # (S, nseg*cap), batched

    mask_live = sorted_key != pad_key
    seg_tile = jnp.where(mask_live, sorted_key >> local_bits,
                         jnp.int32(0x7FFFFFFF))   # (S, M)
    seg_local = jnp.where(mask_live, sorted_key & (shift - 1), jnp.int32(-1))

    # Per-(segment, tile) runs.
    tiles_iota = jnp.arange(n_tiles, dtype=jnp.int32)
    seg_starts = jax.vmap(
        lambda row: jnp.searchsorted(row, tiles_iota, side="left"))(
            seg_tile).astype(jnp.int32)            # (S, n_tiles)
    seg_ends = jax.vmap(
        lambda row: jnp.searchsorted(row, tiles_iota, side="right"))(
            seg_tile).astype(jnp.int32)
    seg_counts = seg_ends - seg_starts             # (S, n_tiles)
    # Stitch: tile t's list is segment 0's run, then segment 1's, ...
    tile_count_full = jnp.sum(seg_counts, axis=0)
    if counts_only:
        return tile_count_full
    tile_count = jnp.minimum(tile_count_full, max_per_tile)
    dropped_tile = jnp.sum(tile_count_full - tile_count)

    base = jnp.cumsum(seg_counts, axis=0) - seg_counts  # (S, n_tiles) excl.
    k = jnp.arange(max_per_tile, dtype=jnp.int32)
    ids = jnp.full((n_tiles, max_per_tile), jnp.int32(-1))
    for s in range(n_segments):
        pos = k[None, :] - base[s][:, None]                  # (n_tiles, K)
        in_seg = (pos >= 0) & (pos < seg_counts[s][:, None]) \
            & (k[None, :] < tile_count[:, None])
        gidx = jnp.where(in_seg, seg_starts[s][:, None] + pos, 0)
        got = seg_local[s][gidx] + jnp.int32(s * nseg)
        ids = jnp.where(in_seg, got, ids)
    valid = k[None, :] < tile_count[:, None]

    # Pre-gather packed params row-major ((N, F) rows are contiguous 64-byte
    # fetches) into the (n_tiles, K, F) layout.
    fields_rows = jnp.transpose(packed_fields(p, cfg.splat_bounds))  # (N, F)
    safe_ids = jnp.where(ids >= 0, ids, 0)
    tp = fields_rows[safe_ids]                     # (n_tiles, K, F)
    # Benign padding: opacity 0 (no contribution), unit scales/inverse-cov
    # (no 0/0 in gradient formulas), h = -1 (empty row range). This keeps
    # padded slots NaN-free so the rasterizer may process them unguarded.
    pad_vals = jnp.zeros((N_FIELDS,), jnp.float32)
    pad_vals = pad_vals.at[jnp.array([FIELD_A, FIELD_D, FIELD_SX, FIELD_SY,
                                      FIELD_COS])].set(1.0)
    pad_vals = pad_vals.at[FIELD_H].set(-1.0)
    tile_params = jnp.where(valid[:, :, None], tp, pad_vals[None, None, :])

    return TileBinning(
        ids=ids,
        tile_params=tile_params,
        count=tile_count,
        n_dropped=(dropped_bbox + dropped_tile).astype(jnp.int32),
    )


# Production pixel tile (tile_h, tile_w): a power-of-two pixel count for
# the GPU kernel's one-program-per-tile walk, chosen on the card (PERF.md).
PRODUCTION_TILE = (16, 16)


def tune_tile_shape(cfg: SplatConfig) -> SplatConfig:
    """The production tile shape. SplatConfig keeps its own default for the
    tests; production entries (CLI, benchmarks) call this. Callers honoring
    an explicit user tile shape should skip it."""
    th, tw = PRODUCTION_TILE
    return cfg.replace(tile_h=th, tile_w=tw)


def tune_max_tiles_per_splat(
    p: GaussianParams,
    cfg: SplatConfig,
    margin: float = 2.0,
) -> SplatConfig:
    """Size the per-splat tile cap from the *measured* bbox coverage.

    ``max_tiles_per_splat`` sets the dense expansion's sort width
    (N * cap keys every iteration); the static default (32) is ~5x the
    real coverage at 32-row tiles, so the binning sort is mostly padding.
    Take the max measured per-splat tile count * margin, round up to a
    power of two (shape-stable across densify-block re-tunes), and clamp
    to the whole grid. Splats grow during fitting; overflow is counted in
    n_dropped (the tripwire on which fit() re-tunes), exactly like the
    per-tile capacity.
    """
    def coverage(q):
        # Size for the margined (lazy-rebinning) footprint when enabled.
        (tx0, tx1, ty0, ty1, offscreen), _ = _bbox_and_quad(
            q, cfg, cfg.rebin_margin)
        return jnp.max(jnp.where(offscreen, 0,
                                 (tx1 - tx0 + 1) * (ty1 - ty0 + 1)))

    m = int(jax.device_get(jax.jit(coverage)(p)))
    cap = 1 << max(2, (max(1, int(m * margin)) - 1).bit_length())
    return cfg.replace(max_tiles_per_splat=min(
        cap, cfg.n_tiles_x * cfg.n_tiles_y))


def tune_rebin_margin(
    p: GaussianParams,
    cfg: SplatConfig,
    candidates: tuple = (2.0, 1.0),
    max_inflation: float = 0.30,
) -> SplatConfig:
    """Pick the lazy-rebinning slack from the MEASURED pair inflation.

    A margined binning adds pairs that are always masked in the kernel
    (they only buy fewer rebins), so the slack is a trade: pair inflation
    costs kernel time every step, rebins cost a binning pass on cache
    misses. The hardware sweeps (BASELINE.md "Lazy rebinning on hardware")
    show margin 1-2 saturating the win at ordinary densities, but a dense
    overlapping population can inflate the margined pair set far past the
    ~7% the bench workload pays -- there the slack should shrink or turn
    off rather than tax every step.

    Called with cfg.rebin_margin < 0 (the CLI's --rebin-margin -1 = auto):
    bins counts-only at margin 0 and at each candidate (descending), picks
    the largest candidate whose total pair count stays within
    ``max_inflation`` of exact, and falls back to 0 (eager per-step
    rebinning) when even the smallest candidate exceeds it."""
    base = int(jax.device_get(jax.jit(
        lambda q: bin_splats(q, cfg, 1, counts_only=True).sum())(p)))
    for m in sorted(candidates, reverse=True):
        n = int(jax.device_get(jax.jit(
            lambda q, m=m: bin_splats(q, cfg, 1, counts_only=True,
                                      margin=m).sum())(p)))
        if base == 0 or n <= base * (1.0 + max_inflation):
            return cfg.replace(rebin_margin=float(m))
    return cfg.replace(rebin_margin=0.0)


def tune_tile_capacity(
    p: GaussianParams,
    cfg: SplatConfig,
    margin: float = 1.5,
    chunk: int = 256,
) -> SplatConfig:
    """Pick the static per-tile capacity from the *measured* tile counts.

    The capacity K scales the pregather, the scan length, and the gradient
    scatter (all O(n_tiles * K)); the default heuristic
    (render_tiles.max_per_tile) can overshoot the true maximum count by
    5-10x on mid-scale workloads. This bins once in counts-only mode (no
    pregather), takes max * margin, and rounds up: <= 256 to a multiple of
    64, above that to a multiple of ``chunk``, which keeps the set of
    compiled shapes small. Counts drift during fitting;
    overflow is caught by the n_dropped tripwire, on which fit() re-tunes.

    Also right-sizes ``max_tiles_per_splat`` (the binning sort width) from
    the same population (tune_max_tiles_per_splat).
    """
    cfg = tune_max_tiles_per_splat(p, cfg)
    counts = jax.jit(
        lambda q: bin_splats(q, cfg, 1, counts_only=True,
                             margin=cfg.rebin_margin))(p)
    m = int(jax.device_get(counts.max()))
    k = max(64, int(m * margin))
    if k <= 256:
        k = -(-k // 64) * 64
    else:
        k = -(-k // chunk) * chunk
    return cfg.replace(max_splats_per_tile=k)
