"""Tile rasterization entry points, and the plain XLA tile path.

The plain path is a ``lax.scan`` over the slots of the dense per-tile lists
(``tiles.bin_splats``), vectorised over every tile at once: each scan step
composites slot k of every tile's list onto (n_tiles, tile_h*tile_w) pixel
planes with the same per-pair math as the GPU kernel
(ops/render_gpu.py). It runs wherever XLA runs; every tile is padded to
the longest list and the composite planes round-trip through memory at
each step, which is what the kernel avoids.

``production_render`` / ``l2_step`` dispatch by the resolved binning
layout (gs2d_tpu.backend): "flat" runs the Pallas-Triton kernel, "dense"
the plain path.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from gs2d_tpu import backend
from gs2d_tpu.config import SplatConfig
from gs2d_tpu.ops import render_gpu as rg
from gs2d_tpu.ops import tiles as tl
from gs2d_tpu.ops import tiles_flat as tlf
from gs2d_tpu.params import GaussianParams


def pad_ref_chw(ref: jax.Array, cfg: SplatConfig) -> jax.Array:
    """Zero-pad an (H, W, 3) target to the (1, 3, Hp, Wp) step layout."""
    out = jnp.zeros((1, 3, cfg.padded_height, cfg.padded_width), jnp.float32)
    return out.at[0, :, : cfg.height, : cfg.width].set(
        jnp.transpose(jnp.asarray(ref, jnp.float32), (2, 0, 1)))


def max_per_tile(cfg: SplatConfig) -> int:
    """Static per-tile capacity of the dense lists (a heuristic when
    cfg.max_splats_per_tile is unset; tune_binning measures it)."""
    if cfg.max_splats_per_tile is not None:
        return cfg.max_splats_per_tile
    return min(max(256, cfg.n_splats // 4), 4096)


def _band_pixels(cfg: SplatConfig, band_row0, band_rows):
    gy = cfg.n_tiles_y if band_rows is None else band_rows
    n_tiles = gy * cfg.n_tiles_x
    row0 = jnp.asarray(band_row0, jnp.int32) * cfg.tile_h
    tiles = jnp.arange(n_tiles, dtype=jnp.int32)[:, None]
    return gy, n_tiles, row0, rg.tile_pixels(cfg, tiles, row0)


def _slots(binning: tl.TileBinning) -> jax.Array:
    """(K, n_tiles, N_FIELDS): the scan's per-step slice is slot k of every
    tile's list."""
    return jnp.swapaxes(binning.tile_params, 0, 1)


def _column(fk):
    return lambda i: fk[:, i:i + 1]


def forward_tiled(
    binning: tl.TileBinning, cfg: SplatConfig, band_row0=0,
    band_rows: int | None = None, crop: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Plain-path rasterization from dense lists. Returns (color (H, W, 3),
    T (H, W)); with band args or ``crop=False`` the padded (band) shape."""
    gy, n_tiles, _, px = _band_pixels(cfg, band_row0, band_rows)
    zero = jnp.zeros((n_tiles, cfg.tile_h * cfg.tile_w), jnp.float32)

    def step(carry, fk):
        return rg.fwd_one(_column(fk), px, cfg, carry), None

    (cr, cg, cb, T), _ = jax.lax.scan(
        step, (zero, zero, zero, px[4].astype(jnp.float32)), _slots(binning))
    color = jnp.stack([rg.from_tiles(c, cfg, gy) for c in (cr, cg, cb)], -1)
    trans = rg.from_tiles(T, cfg, gy)
    if crop and band_rows is None:
        return color[: cfg.height, : cfg.width], trans[: cfg.height,
                                                       : cfg.width]
    return color, trans


def backward_tiled(
    binning: tl.TileBinning,
    final_color: jax.Array,
    g_color: jax.Array,
    n_splats: int,
    cfg: SplatConfig,
    params: GaussianParams,
    carry_in=None,
    band_row0=0,
    band_rows: int | None = None,
) -> GaussianParams:
    """Plain-path analytic gradients from dense lists and a cotangent.

    ``final_color``/``g_color`` (and ``carry_in``) are image-shaped
    (H, W, ...) or already padded to the (band) grid. ``carry_in`` =
    (C_in, T_in) is the composite entering this splat shard (identity when
    None)."""
    gy, n_tiles, row0, px = _band_pixels(cfg, band_row0, band_rows)
    hp, wp = gy * cfg.tile_h, cfg.padded_width

    def pad(img):
        if img.shape[:2] == (hp, wp):
            return img
        out = jnp.zeros((hp, wp) + img.shape[2:], jnp.float32)
        return out.at[: cfg.height, : cfg.width].set(img)

    fin, gc = pad(final_color), pad(g_color)
    if carry_in is None:
        ga = jnp.zeros((hp, wp), jnp.float32)
        t_in = rg.identity_trans(cfg, hp, wp, row0)
    else:
        ga = jnp.sum(gc * pad(carry_in[0]), axis=-1)
        t_in = pad(carry_in[1])
    gc_rgb = tuple(rg.to_tiles(gc[..., c], cfg) for c in range(3))
    fin_t = rg.to_tiles(fin, cfg)
    gf = sum(gc_rgb[c] * fin_t[..., c] for c in range(3))

    def step(carry, fk):
        carry, sums = rg.bwd_splat_step(
            _column(fk), px, cfg, carry, gf, gc_rgb,
            lambda x: jnp.sum(x, axis=-1))
        return carry, jnp.stack(sums, axis=-1)

    _, mom = jax.lax.scan(
        step, (rg.to_tiles(ga, cfg), rg.to_tiles(t_in, cfg)),
        _slots(binning))                                 # (K, n_tiles, 9)
    rows = jnp.swapaxes(mom, 0, 1).reshape(-1, mom.shape[-1])
    return rg.moments_to_grads(
        rg.grads_of_rows(binning.ids.reshape(-1), rows, n_splats),
        rg.fields_of(params, cfg))


def l2_render_and_grads(
    binning: tl.TileBinning,
    ref_chw: jax.Array,
    n_splats: int,
    cfg: SplatConfig,
    params: GaussianParams,
    band_row0=0,
    band_rows: int | None = None,
) -> Tuple[jax.Array, GaussianParams]:
    """Plain-path L2 train evaluation, same contract as
    ``render_gpu.l2_render_and_grads_flat``."""
    color_p, _ = forward_tiled(binning, cfg, band_row0=band_row0,
                               band_rows=band_rows, crop=False)
    gC = color_p - jnp.transpose(ref_chw[0], (1, 2, 0))  # main.cpp:616
    grads = backward_tiled(binning, color_p, gC, n_splats, cfg, params,
                           band_row0=band_row0, band_rows=band_rows)
    if band_rows is None:
        color_p = color_p[: cfg.height, : cfg.width]
    return color_p, grads


# ---------------------------------------------------------------------------
# Layout dispatch.
# ---------------------------------------------------------------------------

def _check_flat_statics(cfg: SplatConfig) -> None:
    if cfg.flat_capacity is None:
        raise ValueError("flat binning capacity unset; call "
                         "tune_binning(params, cfg)")


def tune_binning(params: GaussianParams, cfg: SplatConfig,
                 n_bands: int = 1) -> SplatConfig:
    """Fill the static capacities of cfg's layout from measured counts,
    where unset: flat_capacity (flat) or max_splats_per_tile (dense).
    ``n_bands`` sizes the flat capacity for per-device bands under
    tile-axis sharding."""
    if backend.resolve_binning(cfg) == "flat":
        if cfg.flat_capacity is None:
            cfg = tlf.tune_flat_config(params, cfg, n_bands=n_bands)
    elif cfg.max_splats_per_tile is None:
        cfg = tl.tune_tile_capacity(params, cfg)
    return cfg


def l2_step(params: GaussianParams, ref_chw: jax.Array, cfg: SplatConfig):
    """One L2 render+grad evaluation on cfg's layout.

    Returns (color (H, W, 3), grads, n_dropped)."""
    n = params.pos.shape[0]
    if backend.resolve_binning(cfg) == "flat":
        _check_flat_statics(cfg)
        b = tlf.bin_splats_flat(params, cfg, cfg.flat_capacity)
        color, grads = rg.l2_render_and_grads_flat(b, ref_chw, n, cfg, params)
    else:
        b = tl.bin_splats(params, cfg, max_per_tile(cfg))
        color, grads = l2_render_and_grads(b, ref_chw, n, cfg, params)
    return color, grads, b.n_dropped


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def production_render(params: GaussianParams, cfg: SplatConfig) -> jax.Array:
    """Differentiable rasterization on cfg's layout: (H, W, 3) color with
    the analytic backward as its VJP (any upstream cotangent), so loss
    heads autodiffed on top (train/ssim.py) run the production path."""
    return _prod_fwd(params, cfg)[0]


def _prod_fwd(params: GaussianParams, cfg: SplatConfig):
    n = params.pos.shape[0]
    if n != cfg.n_splats:
        raise ValueError(f"params hold {n} splats, cfg says {cfg.n_splats}")
    if backend.resolve_binning(cfg) == "flat":
        _check_flat_statics(cfg)
        b = tlf.bin_splats_flat(params, cfg, cfg.flat_capacity)
        color_pad, _ = rg.forward_flat(b, cfg)
        return color_pad[: cfg.height, : cfg.width], (b, color_pad)
    b = tl.bin_splats(params, cfg, max_per_tile(cfg))
    color, _ = forward_tiled(b, cfg)
    return color, (b, color)


def _prod_render_fwd(params, cfg):
    color, res = _prod_fwd(params, cfg)
    return color, (params,) + res


def _prod_render_bwd(cfg, res, g_color):
    params, binning, color = res
    n = cfg.n_splats
    if backend.resolve_binning(cfg) == "flat":
        g_pad = jnp.zeros(color.shape, jnp.float32).at[
            : cfg.height, : cfg.width].set(g_color)
        return (rg.backward_flat(binning, color, g_pad, n, cfg, params),)
    return (backward_tiled(binning, color, g_color, n, cfg, params),)


production_render.defvjp(_prod_render_fwd, _prod_render_bwd)
