"""Flat (tile, splat) pair binning: the GPU kernel's input layout.

The dense binning (ops/tiles.py) pads every tile's list to a static
capacity K, so its pregather and gradient scatter cost O(n_tiles * K) rows
even when the mean tile count is far below the max. This module keeps one
flat array of (tile, splat) pairs sorted by (tile id, splat index):

    ids   (M,)    flat splat ids; tile t owns rows [start[t], start[t]+count[t])
    rows  (M, F)  pregathered per-splat scalars (ops/tiles.py packed_fields)
    start (n_tiles,) run starts (exclusive cumsum of the counts)

One kernel program per tile walks its own run (ops/render_gpu.py) and the
backward writes one moment row per pair. The layout also keeps the way
back to splat order: splat s owns the expansion rows [splat_start[s],
splat_start[s] + splat_count[s]), and ``pair_of`` maps each expansion row
to its pair row, so the per-splat gradient sum is a segmented sum over
contiguous runs in a fixed order, with no atomics (render_gpu.sum_pairs).
Cost: O(total pairs) rows end to end.
Order contract: runs are in ascending splat index (compositing order,
Form.pdf p2), exactly like the dense binner.

Construction is an exact-count expansion (each splat owns exactly w*h rows,
no per-splat slot cap, so coverage is never bbox-truncated) followed by ONE
stable sort keyed on the tile id alone: expansion rows are already in splat
order, so stability gives the (tile, splat) lexicographic order without
packing composite sort keys (which would overflow int32 at 4K tile counts).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.ops import tiles as tl
from gs2d_tpu.params import GaussianParams


class FlatBinning(NamedTuple):
    """Flat (tile, splat) pair layout; see module docstring."""

    ids: jax.Array     # (M,) int32, -1 on padding rows
    rows: jax.Array    # (M, N_FIELDS) f32 pregathered params, benign padding
    start: jax.Array   # (n_tiles,) int32 run starts
    count: jax.Array   # (n_tiles,) int32 live entries per tile
    n_dropped: jax.Array  # scalar int32: pairs lost to capacity caps
    pair_of: jax.Array      # (M,) int32 pair row of each expansion row
    splat_start: jax.Array  # (N,) int32 first expansion row of each splat
    splat_count: jax.Array  # (N,) int32 expansion rows of each splat


def tune_flat_capacity(
    p: GaussianParams,
    cfg: SplatConfig,
    margin: float = 1.5,
    n_bands: int = 1,
    bin_margin: float = 0.0,
) -> int:
    """Measure tile counts and pick the flat capacity M with headroom.

    Counts drift during fitting; overflow trips FlatBinning.n_dropped and
    the caller re-tunes.

    ``n_bands > 1`` sizes for banded binning under tile-axis sharding: each
    band of ``n_tiles_y / n_bands`` tile rows is binned separately per
    device, so the (SPMD-uniform) capacity is the max over bands.

    ``bin_margin`` measures with that many pixels of footprint slack --
    lazy-rebinning callers (cfg.rebin_margin > 0) bin a margined superset,
    which must be sized AS the superset: capacity tuned from margin-0
    counts can overflow on the very first margined bin, making the lazy
    cache permanently invalid (n_dropped > 0 forces a rebin every step
    while still dropping pairs).
    """
    counts = jax.jit(
        lambda q: tl.bin_splats(q, cfg, 1, counts_only=True,
                                margin=bin_margin))(p)
    counts = jax.device_get(counts)
    if n_bands > 1:
        if cfg.n_tiles_y % n_bands:
            raise ValueError(
                f"{cfg.n_tiles_y} tile rows not divisible by {n_bands} bands")
        need = int(counts.reshape(n_bands, -1).sum(axis=1).max())
    else:
        need = int(counts.sum())
    return max(1, int(need * margin))


def tune_flat_config(p: GaussianParams, cfg: SplatConfig,
                     margin: float = 1.5, n_bands: int = 1) -> SplatConfig:
    """Fill cfg.flat_capacity from measured tile counts.

    With lazy rebinning on (cfg.rebin_margin > 0) this also (a) sizes the
    tripwire slot grid: tiles.pairs_covered_by enumerates exact footprints
    on a max_tiles_per_splat grid and conservatively rebins EVERY step
    once any splat exceeds it -- a cap the flat layout itself doesn't
    have, so it must be measured, not defaulted; and (b) measures capacity
    with the margined footprints, so the superset binning the lazy cache
    builds can never overflow a capacity sized for margin 0."""
    if cfg.rebin_margin > 0:
        cfg = tl.tune_max_tiles_per_splat(p, cfg)
    return cfg.replace(flat_capacity=tune_flat_capacity(
        p, cfg, margin=margin, n_bands=n_bands, bin_margin=cfg.rebin_margin))


def pregather_rows(ids: jax.Array, p: GaussianParams,
                   cfg: SplatConfig) -> jax.Array:
    """Pregather packed per-splat params onto the flat rows.

    O(M) rows through the gather unit -- the only param-dependent part of
    the flat layout, so the lazy-rebinning cache re-runs just this per
    step while the expansion + sort structure (ids/start/count) is
    reused. Padding rows (id -1) get numerically benign values (the same
    pad_vals contract as ops/tiles.py)."""
    fields_rows = jnp.transpose(tl.packed_fields(p, cfg.splat_bounds))
    safe = jnp.where(ids >= 0, ids, 0)
    rows = fields_rows[safe]                        # (M, F)
    pad_vals = jnp.zeros((tl.N_FIELDS,), jnp.float32)
    pad_vals = pad_vals.at[jnp.array([tl.FIELD_A, tl.FIELD_D, tl.FIELD_SX,
                                      tl.FIELD_SY, tl.FIELD_COS])].set(1.0)
    pad_vals = pad_vals.at[tl.FIELD_H].set(-1.0)
    return jnp.where((ids >= 0)[:, None], rows, pad_vals[None, :])


def bin_splats_flat(
    p: GaussianParams,
    cfg: SplatConfig,
    m_cap: int,
    band_row0=0,
    band_rows: int | None = None,
    ids_only: bool = False,
    margin: float = 0.0,
) -> FlatBinning:
    """Build the flat (tile, splat) pair layout.

    ``m_cap`` (static) caps the total flat rows; overflow is counted in
    n_dropped (never silent). Band arguments restrict binning to a band of
    tile rows, as in bin_splats.

    ``ids_only`` skips the per-row parameter pregather (rows comes back
    as a (1, N_FIELDS) placeholder) -- for the lazy-rebinning cache,
    which re-pregathers from the live params every step
    (``pregather_rows``). ``margin`` (pixels) expands every footprint
    (bbox AND cull test) by that slack, making the pair set a superset
    that stays valid while splats drift less than the margin -- the same
    contract as ``tiles.bin_splats(margin=...)``, checked by
    ``tiles.pairs_covered_by``.
    """
    if band_rows is None:
        band_rows = cfg.n_tiles_y
        band_row0 = 0
    n_tiles = band_rows * cfg.n_tiles_x

    # --- exact-count pair expansion ---------------------------------------
    # Each splat owns a run of exactly w*h rows in the expansion array (no
    # per-splat slot cap, so large splats are never bbox-truncated). The
    # row -> owning-splat map is built with ONE scatter+cumsum (+1 at every
    # run start; coincident starts of empty splats telescope so empty runs
    # are skipped); every other per-splat value then arrives through ONE
    # multi-channel row gather instead of one broadcast per channel.
    (tx0, tx1, ty0, ty1, offscreen), (qpx, qpy, qa, qb, qd, qk2) = \
        tl._bbox_and_quad(p, cfg, margin)
    band_row0 = jnp.asarray(band_row0, jnp.int32)
    offscreen = offscreen | (ty1 < band_row0) \
        | (ty0 > band_row0 + (band_rows - 1))
    ty0 = jnp.clip(ty0 - band_row0, 0, band_rows - 1)
    ty1 = jnp.clip(ty1 - band_row0, 0, band_rows - 1)
    w_t = tx1 - tx0 + 1
    h_t = ty1 - ty0 + 1
    cnt = jnp.where(offscreen, 0, w_t * h_t)
    starts = jnp.cumsum(cnt) - cnt                  # exclusive, (n,)
    total = starts[-1] + cnt[-1]
    e_cap = m_cap                                   # expansion capacity
    # Pairs past the capacity (the highest splat indices) are dropped and
    # counted.
    dropped_exp = jnp.maximum(total - e_cap, 0)

    e = jnp.arange(e_cap, dtype=jnp.int32)
    live_e = e < total
    owner_inc = jnp.zeros((e_cap,), jnp.int32).at[starts[1:]].add(
        1, mode="drop")                             # starts >= e_cap drop
    owner = jnp.cumsum(owner_inc)                   # (E,) splat per row

    chans = [starts, w_t, ty0, tx0]
    if cfg.exact_cull:
        bc = lambda v: jax.lax.bitcast_convert_type(
            v.astype(jnp.float32), jnp.int32)
        chans += [bc(qpx), bc(qpy), bc(qa), bc(qb), bc(qd)]
        if qk2 is not None:
            chans.append(bc(qk2))
    ch = jnp.stack(chans, axis=1)[owner]            # ONE (E, C) row gather

    rank = e - ch[:, 0]
    wb = jnp.maximum(ch[:, 1], 1)
    ly = rank // wb
    lx = rank - ly * wb
    ty_e = ch[:, 2] + ly
    tx_e = ch[:, 3] + lx
    tile_e = ty_e * cfg.n_tiles_x + tx_e
    if cfg.exact_cull:
        # Exact-ellipse tile culling (tiles.tile_may_touch) on the exact
        # f32 bit patterns fetched by the row gather.
        fc = lambda i: jax.lax.bitcast_convert_type(ch[:, i], jnp.float32)
        live_e = live_e & tl.tile_may_touch(
            fc(4), fc(5), fc(6), fc(7), fc(8),
            tx_e, band_row0 + ty_e, cfg, margin,
            k2=fc(9) if qk2 is not None else None)
    tile_e = jnp.where(live_e, tile_e, jnp.int32(n_tiles))  # dead rows last
    splat_e = jnp.where(live_e, owner, -1)

    # --- one stable sort by tile id ---------------------------------------
    # Expansion rows are in ascending splat order, so a stable sort on the
    # (small-int) tile key alone yields (tile, splat)-lexicographic order:
    # exactly the compositing order the kernels need (Form.pdf p2).
    sorted_tile, sorted_id, sorted_e = jax.lax.sort(
        (tile_e, splat_e, e), num_keys=1, is_stable=True)
    # The sort is a permutation of the expansion rows; invert it (unique
    # indices, so the scatter is exact).
    pair_of = jnp.zeros((e_cap,), jnp.int32).at[sorted_e].set(e)

    # Live rows are already at their final flat positions: tile t's run
    # starts where the sorted keys reach t, and dead rows (splat id -1)
    # sort to the end.
    tiles_iota = jnp.arange(n_tiles, dtype=jnp.int32)
    start = jnp.searchsorted(sorted_tile, tiles_iota,
                             side="left").astype(jnp.int32)
    end = jnp.searchsorted(sorted_tile, tiles_iota,
                           side="right").astype(jnp.int32)
    ids = sorted_id

    rows = (jnp.zeros((1, tl.N_FIELDS), jnp.float32) if ids_only
            else pregather_rows(ids, p, cfg))

    return FlatBinning(
        ids=ids, rows=rows, start=start, count=end - start,
        n_dropped=dropped_exp.astype(jnp.int32), pair_of=pair_of,
        splat_start=starts.astype(jnp.int32),
        splat_count=cnt.astype(jnp.int32),
    )
