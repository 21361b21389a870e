"""GPU tile rasterizer: one Pallas-Triton program per pixel tile.

The kernels consume the flat (tile, splat) pair list of
``ops/tiles_flat.bin_splats_flat``: tile t owns the pair rows
``[start[t], start[t] + count[t])`` of one (M, N_FIELDS) array of packed
per-splat scalars, in ascending splat index (the compositing order,
Form.pdf p2).

- **Forward.** One program per tile walks the tile's pairs in order and
  composites the whole (tile_h * tile_w) pixel block per pair, keeping the
  tile's color and transmittance T in registers for the whole walk. The
  reference's per-pixel early-out (T < 1/256, main.cpp:518-521) and its
  truncated integer loop bounds (main.cpp:490-508) are masks, so results
  match the sequential C++ loop allclose. The walk leaves the loop once
  every pixel of the tile is saturated; all later pairs would be masked
  out, so the exit is exact.
- **Backward.** The same walk replays the composite with the
  cotangent-weighted carry (``bwd_splat_step``) and block-reduces nine
  per-pair moments over the tile's pixels. Each pair stores them as its own
  row of an (M, 16) array, so there are no atomics; ``sum_pairs`` then
  sums the rows per splat, in the same order on every run, and
  ``moments_to_grads`` turns the moments into parameter gradients.

The per-pair math (``splat_terms``, ``fwd_one``, ``bwd_splat_step``,
``moments_to_grads``) is plain jnp with a field accessor ``f(i)``: inside the
kernel ``f`` reads one scalar of the pair row and the pixel planes are 1-D
(tile_h * tile_w,) vectors; the plain XLA path (ops/render_tiles.py) passes
(n_tiles, 1) columns and (n_tiles, tile_h * tile_w) planes, vectorising the
same expressions over every tile at once.

Moment rows of the backward (``G_*`` indices):
  0 M1=sum z*vx, 1 M2=sum z*vy, 2 M3=sum z*vx^2, 3 M4=sum z*vx*vy,
  4 M5=sum z*vy^2, 5-7 color grads, 8 M0=sum z
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from gs2d_tpu import backend
from gs2d_tpu.config import EXP_APPROX_FLUSH, SplatConfig
from gs2d_tpu.ops import tiles as tl
from gs2d_tpu.ops.tiles_flat import FlatBinning
from gs2d_tpu.params import GaussianParams

G_PX, G_PY, G_SX, G_SY, G_ROT, G_CR, G_CG, G_CB, G_OP = range(9)
N_GRAD_FIELDS = 16  # 9 used; a power of two, as a Triton block row must be

# Pairs walked between two saturation checks. The check is a block-wide
# max-reduce, so it runs once per group of pairs, not per pair.
SAT_CHECK_EVERY = 16
# Warps per tile program. A tile's moments are block reductions, and fewer
# warps keep them inside a warp's shuffles.
NUM_WARPS = 2


# ---------------------------------------------------------------------------
# Per-pair math (shared with the plain XLA path, ops/render_tiles.py).
# ---------------------------------------------------------------------------

def exp_term(x, use_approx: bool):
    """exp(x) with the reference's fast approximation (main.cpp:49-83)."""
    if not use_approx:
        return jnp.exp(x)
    x = jnp.float32(1.0) + x * jnp.float32(0.125)
    flush = x < jnp.float32(EXP_APPROX_FLUSH)
    x = x * x
    x = x * x
    x = x * x
    return jnp.where(flush, jnp.float32(0.0), x)


def _trunc_i32(x):
    return jnp.trunc(x).astype(jnp.int32)


def tile_pixels(cfg: SplatConfig, tile, row0_px=0):
    """Pixel coordinates of band-local tile index ``tile`` (tiles run
    row-major), flattened to tile_h * tile_w pixels; ``row0_px`` offsets
    rows into global coordinates for band rendering. ``tile`` may be a
    scalar (one kernel program) or an (n_tiles, 1) column (every tile)."""
    th, tw = cfg.tile_h, cfg.tile_w
    i = jax.lax.broadcasted_iota(jnp.int32, (th * tw,), 0)
    ty = tile // cfg.n_tiles_x
    tx = tile % cfg.n_tiles_x
    yy = row0_px + ty * th + i // tw
    xx = tx * tw + i % tw
    fy = yy.astype(jnp.float32) + jnp.float32(0.5)
    fx = xx.astype(jnp.float32) + jnp.float32(0.5)
    inside = (yy < cfg.height) & (xx < cfg.width)
    return yy, xx, fy, fx, inside


def splat_terms(f, px_coords, T, cfg: SplatConfig):
    """One pair's coverage and alpha over the tile's pixels.

    Returns (live mask, alpha, vx, vy, (cr, cg, cb))."""
    yy, xx, fy, fx, inside = px_coords
    px, py = f(tl.FIELD_PX), f(tl.FIELD_PY)
    a, b, d = f(tl.FIELD_A), f(tl.FIELD_B), f(tl.FIELD_D)
    h = f(tl.FIELD_H)
    op = f(tl.FIELD_OP)

    vy = fy - py
    vx = fx - px

    # Row walk bounds: y in [trunc(py-h), trunc(py+h)] (main.cpp:490-492).
    row_ok = (yy >= _trunc_i32(py - h)) & (yy <= _trunc_i32(py + h))

    # Exact per-row x interval from the ellipse quadratic
    # (main.cpp:497-509, Form.pdf section 13).
    qb = jnp.float32(2.0) * b * vy
    qc = d * vy * vy - jnp.float32(cfg.cutoff_sq)
    disc = qb * qb - jnp.float32(4.0) * a * qc
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    sgn = jnp.where(qb < 0.0, jnp.float32(-1.0), jnp.float32(1.0))
    kq = (-qb - sgn * sq) * jnp.float32(0.5)
    r0 = kq / a
    r1 = qc / kq
    col_ok = (xx >= _trunc_i32(px + jnp.minimum(r0, r1))) \
        & (xx <= _trunc_i32(px + jnp.maximum(r0, r1)))

    d2 = a * vx * vx + jnp.float32(2.0) * b * vx * vy + d * vy * vy
    alpha = exp_term(jnp.float32(-0.5) * d2, cfg.use_exp_approx) * op
    live = row_ok & (disc >= 0.0) & col_ok & inside \
        & (T >= jnp.float32(cfg.min_throughput))
    return live, alpha, vx, vy, (f(tl.FIELD_CR), f(tl.FIELD_CG),
                                 f(tl.FIELD_CB))


def fwd_one(f, px_coords, cfg: SplatConfig, carry):
    """Composite one pair onto the (cr, cg, cb, T) carry."""
    cr, cg, cb, T = carry
    live, alpha, _, _, (sr, sg, sb) = splat_terms(f, px_coords, T, cfg)
    w = jnp.where(live, T * alpha, jnp.float32(0.0))
    return (cr + w * sr, cg + w * sg, cb + w * sb,
            jnp.where(live, T * (jnp.float32(1.0) - alpha), T))


def bwd_splat_step(f, px_coords, cfg: SplatConfig, carry, gf, gc_rgb, reduce):
    """One pair's backward contribution: replay plus nine moment sums.

    The replay carry is the cotangent-weighted prefix color
    ``ga = sum_ch gc_ch * C_prefix_ch`` (one plane) and T. dL/dalpha only
    consumes the prefix through ``sum_ch gc_ch * (c_ch*T - S_ch/(1-alpha))``
    with suffix S = final - prefix (main.cpp:616-630), which factors as
    ``T*gcdot - (gf - ga)/(1-alpha)`` with ``gcdot = sum_ch gc_ch*c_ch`` and
    the per-pixel constant ``gf = sum_ch gc_ch*fin_ch``.

    The geometry gradients (main.cpp:635-683, Form.pdf sections 8-10) are
    per-splat scalar combinations of the z-moments ``M0=sum z``,
    ``M1=sum z*vx``, ``M2=sum z*vy``, ``M3=sum z*vx^2``, ``M4=sum z*vx*vy``,
    ``M5=sum z*vy^2`` with z = dL/dalpha * alpha; ``moments_to_grads``
    applies them. ``reduce`` sums a pixel plane over the tile's pixels.

    Returns (new (ga, T) carry, tuple of 9 sums in G_* order)."""
    ga, T = carry
    gc_r, gc_g, gc_b = gc_rgb
    live, alpha, vx, vy, (sr, sg, sb) = splat_terms(f, px_coords, T, cfg)
    mw = live.astype(jnp.float32)

    # dL/dc = sum gC * alpha * T (main.cpp:617-620); the same weight drives
    # the replay composite.
    w_c = alpha * T * mw
    gcdot = gc_r * sr + gc_g * sg + gc_b * sb
    ga = ga + w_c * gcdot

    # (1 - alpha + 1e-15) guard, reassociation-proof (see render_jax).
    inv1ma = jnp.float32(1.0) / jnp.where(
        alpha >= jnp.float32(1.0), jnp.float32(1e-15),
        jnp.float32(1.0) - alpha)
    dL_da = (T * gcdot - (gf - ga) * inv1ma) * mw
    # dalpha/dparam is proportional to alpha for mu, s, theta (Form.pdf
    # sections 8-10), so z is the common factor of every moment.
    z = dL_da * alpha
    zvx = z * vx
    zvy = z * vy
    sums = (reduce(zvx), reduce(zvy), reduce(zvx * vx), reduce(zvx * vy),
            reduce(zvy * vy), reduce(gc_r * w_c), reduce(gc_g * w_c),
            reduce(gc_b * w_c), reduce(z))
    T = jnp.where(live, T * (jnp.float32(1.0) - alpha), T)
    return (ga, T), sums


def moments_to_grads(m: GaussianParams, fields: jax.Array) -> GaussianParams:
    """Per-splat scalar combinations turning the raw z-moments into
    parameter gradients (main.cpp:635-704, Form.pdf sections 8-11).

    ``m`` is a GaussianParams-shaped carrier of the reduced moments
    (pos=(M1, M2), sx=M3, sy=M4, rot=M5, opacity=M0, color final);
    ``fields`` is the (N_FIELDS, n) packed table (tiles.packed_fields).
    With z = dL/dalpha * alpha and v the pixel offset:

      d/dmu    = a*M1 + b*M2, d*M2 + b*M1      (main.cpp:635-640)
      d/dsx    = 1/sx^3 * sum z*u^2,  u = cos*vx + sin*vy  (main.cpp:657-662)
      d/dsy    = 1/sy^3 * sum z*w^2,  w = sin*vx - cos*vy
      d/dtheta = -(sx^2-sy^2)/(sx^2 sy^2) * sum z*u*w      (main.cpp:680-683)
      d/dop    = sum dL/dalpha * G = M0 / op               (main.cpp:703)

    where sum z*u^2 = cos^2*M3 + 2 sin cos*M4 + sin^2*M5 (w^2 and u*w
    analogous). Linear in the moments, so sums of partial moments before or
    after this map commute."""
    a, b, d = fields[tl.FIELD_A], fields[tl.FIELD_B], fields[tl.FIELD_D]
    c, s = fields[tl.FIELD_COS], fields[tl.FIELD_SIN]
    sx, sy, op = fields[tl.FIELD_SX], fields[tl.FIELD_SY], fields[tl.FIELD_OP]
    m1, m2 = m.pos[:, 0], m.pos[:, 1]
    m3, m4, m5, m0 = m.sx, m.sy, m.rot, m.opacity
    cc, ss, cs = c * c, s * s, c * s
    inv_sx3 = 1.0 / (sx * sx * sx)
    inv_sy3 = 1.0 / (sy * sy * sy)
    th_s = -(sx * sx - sy * sy) / (sx * sx * sy * sy)
    return GaussianParams(
        pos=jnp.stack([a * m1 + b * m2, d * m2 + b * m1], axis=-1),
        sx=inv_sx3 * (cc * m3 + 2.0 * (cs * m4) + ss * m5),
        sy=inv_sy3 * (ss * m3 - 2.0 * (cs * m4) + cc * m5),
        rot=th_s * (cs * (m3 - m5) + (ss - cc) * m4),
        color=m.color,
        # M0/op reconstructs sum dL/dalpha * G (alpha = G*op). Dead slots
        # parked by densify/prune have op == 0 and exactly zero moments, so
        # the true gradient is 0: guard the 0/0 rather than poison Adam
        # with NaN (the reference emits G directly, main.cpp:703).
        opacity=jnp.where(op > 0.0, m0 / jnp.where(op > 0.0, op, 1.0), 0.0),
    )


def fields_of(params: GaussianParams, cfg: SplatConfig) -> jax.Array:
    """The (N_FIELDS, n) packed per-splat scalars for moments_to_grads --
    the same expression that built the pair rows, so XLA CSEs it."""
    return tl.packed_fields(params, cfg.splat_bounds)


def grads_of_rows(ids: jax.Array, rows: jax.Array,
                  n_splats: int) -> GaussianParams:
    """Sum per-pair moment rows (P, >=9) onto the splat axis with one
    scatter-add (the plain path's dense lists). Rows whose id is negative
    (padding) are dropped: they go to a positive out-of-range index, since
    a -1 would wrap to splat n-1."""
    ids = jnp.where(ids >= 0, ids, jnp.int32(n_splats))
    acc = jnp.zeros((n_splats, rows.shape[-1]), jnp.float32).at[ids].add(
        rows, mode="drop")
    return _as_moments(acc)


def sum_pairs(binning: FlatBinning, rows: jax.Array) -> GaussianParams:
    """Sum the kernel's per-pair moment rows per splat in a fixed order.

    Each splat's pairs are one contiguous run of expansion rows
    (tiles_flat.FlatBinning); gathering the rows back into that order and
    summing every run with a segmented scan gives the same result on every
    run, where a scatter-add on a GPU adds in whatever order its atomics
    land. Rows whose id is negative (padding, culled pairs, rows outside a
    sub-band) count as zero -- such rows may hold garbage, since no program
    writes them."""
    e_cap = binning.pair_of.shape[0]
    pos = binning.pair_of
    vals = jnp.where((binning.ids[pos] >= 0)[:, None], rows[pos, :9],
                     jnp.float32(0.0))
    first = jnp.zeros((e_cap,), jnp.bool_).at[binning.splat_start].set(
        True, mode="drop")

    def add(a, b):
        (va, fa), (vb, fb) = a, b
        return jnp.where(fb[:, None], vb, va + vb), fa | fb

    run_sums, _ = jax.lax.associative_scan(add, (vals, first))
    end = jnp.minimum(binning.splat_start + binning.splat_count, e_cap)
    has = end > binning.splat_start
    acc = jnp.where(has[:, None],
                    run_sums[jnp.clip(end - 1, 0, e_cap - 1)],
                    jnp.float32(0.0))
    return _as_moments(acc)


def _as_moments(acc: jax.Array) -> GaussianParams:
    """(N, >=9) per-splat sums in G_* order -> the moment carrier."""
    return GaussianParams(
        pos=acc[:, (G_PX, G_PY)],
        sx=acc[:, G_SX], sy=acc[:, G_SY], rot=acc[:, G_ROT],
        color=acc[:, (G_CR, G_CG, G_CB)],
        opacity=acc[:, G_OP],
    )


def identity_trans(cfg: SplatConfig, hp: int, wp: int, row0_px=0):
    """Identity transmittance plane: 1 inside the image, 0 on padding.

    Out-of-image pixels never composite (the ``inside`` mask), so zero is
    exact there -- and it lets the saturation exit ignore padding, which
    would otherwise pin max(T) at 1 on boundary tiles."""
    yy = row0_px + jnp.arange(hp, dtype=jnp.int32)[:, None]
    xx = jnp.arange(wp, dtype=jnp.int32)[None, :]
    return ((yy < cfg.height) & (xx < cfg.width)).astype(jnp.float32)


def to_tiles(img: jax.Array, cfg: SplatConfig) -> jax.Array:
    """(Hb, Wp, ...) padded image rows -> (n_tiles, tile_h*tile_w, ...)
    tile-major pixel planes (tiles row-major, pixels row-major within)."""
    th, tw = cfg.tile_h, cfg.tile_w
    hb, wp = img.shape[:2]
    rest = img.shape[2:]
    x = img.reshape((hb // th, th, wp // tw, tw) + rest)
    x = jnp.swapaxes(x, 1, 2)
    return x.reshape(((hb // th) * (wp // tw), th * tw) + rest)


def from_tiles(planes: jax.Array, cfg: SplatConfig, gy: int) -> jax.Array:
    """Inverse of ``to_tiles``: (n_tiles, P, ...) -> (gy*tile_h, Wp, ...)."""
    th, tw = cfg.tile_h, cfg.tile_w
    gx = cfg.n_tiles_x
    rest = planes.shape[2:]
    x = planes.reshape((gy, gx, th, tw) + rest)
    x = jnp.swapaxes(x, 1, 2)
    return x.reshape((gy * th, gx * tw) + rest)


# ---------------------------------------------------------------------------
# The Pallas-Triton kernels.
# ---------------------------------------------------------------------------

def _walk(start, end, step, carry, get_t, mt):
    """Walk pairs [start, end) in groups of SAT_CHECK_EVERY, leaving as
    soon as every pixel of the tile is saturated (max T < mt): from then on
    every pair is masked out, so the exit changes nothing. Returns
    (first pair not walked, carry)."""
    def cond(st):
        p, cur = st
        return (p < end) & (jnp.max(get_t(cur)) >= mt)

    def body(st):
        p, cur = st
        hi = jnp.minimum(p + SAT_CHECK_EVERY, end)
        return hi, jax.lax.fori_loop(p, hi, step, cur)

    return jax.lax.while_loop(cond, body, (start, carry))


def _fwd_kernel(off_ref, start_ref, count_ref, rows_ref,
                cr_ref, cg_ref, cb_ref, t_ref, *, cfg: SplatConfig):
    t = pl.program_id(0)
    px_coords = tile_pixels(cfg, t, off_ref[0])
    s = start_ref[t]
    zero = jnp.zeros((cfg.tile_h * cfg.tile_w,), jnp.float32)

    def step(p, carry):
        return fwd_one(lambda i: rows_ref[p, i], px_coords, cfg, carry)

    _, (cr, cg, cb, T) = _walk(
        s, s + count_ref[t], step,
        (zero, zero, zero, px_coords[4].astype(jnp.float32)),
        lambda c: c[3], jnp.float32(cfg.min_throughput))
    cr_ref[...] = cr
    cg_ref[...] = cg
    cb_ref[...] = cb
    t_ref[...] = T


def _bwd_kernel(off_ref, start_ref, count_ref, rows_ref,
                fr_ref, fg_ref, fb_ref, gr_ref, gg_ref, gb_ref,
                ga_ref, tin_ref, out_ref, *, cfg: SplatConfig):
    t = pl.program_id(0)
    px_coords = tile_pixels(cfg, t, off_ref[0])
    s = start_ref[t]
    end = s + count_ref[t]
    gc_rgb = (gr_ref[...], gg_ref[...], gb_ref[...])
    gf = gc_rgb[0] * fr_ref[...] + gc_rgb[1] * fg_ref[...] \
        + gc_rgb[2] * fb_ref[...]
    lane = jax.lax.broadcasted_iota(jnp.int32, (N_GRAD_FIELDS,), 0)

    def step(p, carry):
        carry, sums = bwd_splat_step(
            lambda i: rows_ref[p, i], px_coords, cfg, carry, gf, gc_rgb,
            jnp.sum)
        row = jnp.zeros((N_GRAD_FIELDS,), jnp.float32)
        for j, v in enumerate(sums):
            row = jnp.where(lane == j, v, row)
        out_ref[p, :] = row
        return carry

    p_exit, _ = _walk(s, end, step, (ga_ref[...], tin_ref[...]),
                      lambda c: c[1], jnp.float32(cfg.min_throughput))

    # Pairs after a saturation exit contribute exactly zero.
    def zero_row(p, c):
        out_ref[p, :] = jnp.zeros((N_GRAD_FIELDS,), jnp.float32)
        return c

    jax.lax.fori_loop(p_exit, end, zero_row, 0)


def _band(cfg: SplatConfig, band_row0, band_rows):
    gy = cfg.n_tiles_y if band_rows is None else band_rows
    off = jnp.asarray([jnp.asarray(band_row0, jnp.int32) * cfg.tile_h],
                      jnp.int32)
    return gy, gy * cfg.n_tiles_x, off


def _plane_spec(cfg: SplatConfig):
    return pl.BlockSpec((None, cfg.tile_h * cfg.tile_w), lambda t: (t, 0))


def _whole():
    return pl.BlockSpec(memory_space=pl.ANY)


def _call(kernel, cfg: SplatConfig, n_tiles, in_specs, out_specs, out_shape,
          name):
    backend.check_kernel(cfg)
    return pl.pallas_call(
        functools.partial(kernel, cfg=cfg),
        grid=(n_tiles,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=cfg.interpret,
        name=name,
    )


def forward_flat(
    binning: FlatBinning,
    cfg: SplatConfig,
    band_row0=0,
    band_rows: int | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Rasterize from a flat binning. Returns the padded (color (Hp, Wp, 3),
    T (Hp, Wp)); with band args, the band (band_rows*tile_h rows)."""
    gy, n_tiles, off = _band(cfg, band_row0, band_rows)
    p = cfg.tile_h * cfg.tile_w
    plane = jax.ShapeDtypeStruct((n_tiles, p), jnp.float32)
    cr, cg, cb, T = _call(
        _fwd_kernel, cfg, n_tiles,
        in_specs=[_whole(), _whole(), _whole(), _whole()],
        out_specs=[_plane_spec(cfg)] * 4,
        out_shape=[plane] * 4, name="gs2d_raster_fwd",
    )(off, binning.start, binning.count, binning.rows)
    color = jnp.stack([from_tiles(c, cfg, gy) for c in (cr, cg, cb)], -1)
    return color, from_tiles(T, cfg, gy)


def backward_flat(
    binning: FlatBinning,
    final_color: jax.Array,
    g_color: jax.Array,
    n_splats: int,
    cfg: SplatConfig,
    params: GaussianParams,
    carry_in=None,
    band_row0=0,
    band_rows: int | None = None,
) -> GaussianParams:
    """Analytic gradients from a flat binning and an upstream cotangent.

    ``final_color``/``g_color`` are padded (Hp, Wp, 3) (band-shaped with
    band args); ``carry_in`` is the (C, T) composite entering this splat
    shard (the ordered-monoid prefix under splat sharding; identity when
    None)."""
    gy, n_tiles, off = _band(cfg, band_row0, band_rows)
    hp, wp = gy * cfg.tile_h, cfg.padded_width
    if carry_in is None:
        ga = jnp.zeros((hp, wp), jnp.float32)
        t_in = identity_trans(cfg, hp, wp, off[0])
    else:
        # Replay carry entering this shard: ga = sum_ch gc*C_in.
        ga = jnp.sum(g_color * carry_in[0], axis=-1)
        t_in = carry_in[1]
    planes = [to_tiles(x, cfg) for x in (
        final_color[..., 0], final_color[..., 1], final_color[..., 2],
        g_color[..., 0], g_color[..., 1], g_color[..., 2], ga, t_in)]
    m = binning.rows.shape[0]
    rows = _call(
        _bwd_kernel, cfg, n_tiles,
        in_specs=[_whole()] * 4 + [_plane_spec(cfg)] * 8,
        out_specs=_whole(),
        out_shape=jax.ShapeDtypeStruct((m, N_GRAD_FIELDS), jnp.float32),
        name="gs2d_raster_bwd",
    )(off, binning.start, binning.count, binning.rows, *planes)
    del n_splats  # the binning's splat runs fix the splat axis
    return moments_to_grads(sum_pairs(binning, rows), fields_of(params, cfg))


def l2_render_and_grads_flat(
    binning: FlatBinning,
    ref_chw: jax.Array,
    n_splats: int,
    cfg: SplatConfig,
    params: GaussianParams,
    band_row0=0,
    band_rows: int | None = None,
) -> Tuple[jax.Array, GaussianParams]:
    """L2 train path on the flat layout: forward, cotangent, backward.

    ``ref_chw`` is the padded (1, 3, Hp, Wp) target (the band's slice with
    band args). Returns (color cropped to the image -- or the raw band --
    and parameter gradients)."""
    color_p, _ = forward_flat(binning, cfg, band_row0=band_row0,
                              band_rows=band_rows)
    gC = color_p - jnp.transpose(ref_chw[0], (1, 2, 0))  # main.cpp:616
    grads = backward_flat(binning, color_p, gC, n_splats, cfg, params,
                          band_row0=band_row0, band_rows=band_rows)
    if band_rows is None:
        color_p = color_p[: cfg.height, : cfg.width]
    return color_p, grads
