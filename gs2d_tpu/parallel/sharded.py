"""Sharded training: shard_map over a (data, tile, splat) mesh.

Parallelization strategy (all net-new; the reference is single-thread):

- **data axis**: independent images; each owns a full splat population.
- **tile axis**: each device renders a horizontal band of rows. Forward is
  embarrassingly parallel; per-splat gradients are partial sums over the
  band's pixels and get ``psum``'d over this axis (the gradient
  all-reduce).
- **splat axis**: each device owns a contiguous, index-ordered slice of the
  splat population plus its Adam state (tensor-parallel analog). Per-pixel
  composite partials (C, T) combine exactly in index order with the ordered
  monoid  combine((Ca,Ta),(Cb,Tb)) = (Ca + Ta*Cb, Ta*Tb)  -- Form.pdf
  section 5's blend is associative over ordered segments. Implemented with
  ``all_gather`` + an exclusive prefix fold (log-depth collective); the
  prefix (C_in, T_in) entering each shard feeds the local backward replay.

Early-out note: the reference's T < 1/256 skip (main.cpp:518-521) is a
mid-chain predicate on the *global* running transmittance, which breaks
associativity. When the splat axis is sharded (>1), rendering runs with the
threshold disabled (min_throughput = 0): the composite is then exactly the
associative monoid, single- and multi-shard results agree to fp rounding,
and the deviation from the thresholded reference output is bounded by
1/256 per channel. With one splat shard the reference semantics are kept
bit-for-bit.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.ops.render_jax import render_backward_band, render_forward_band
from gs2d_tpu.params import GaussianParams
from gs2d_tpu.parallel.mesh import DATA_AXIS, SPLAT_AXIS, TILE_AXIS
from gs2d_tpu.train.adam import adam_update
from gs2d_tpu.train.loop import StepAux, TrainState, init_train_state
from gs2d_tpu.train.metrics import psnr_from_mse

try:  # jax >= 0.7 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


def params_pspec() -> GaussianParams:
    """PartitionSpecs for a batched (B, N, ...) GaussianParams pytree."""
    return GaussianParams(
        pos=P(DATA_AXIS, SPLAT_AXIS, None),
        sx=P(DATA_AXIS, SPLAT_AXIS),
        sy=P(DATA_AXIS, SPLAT_AXIS),
        rot=P(DATA_AXIS, SPLAT_AXIS),
        color=P(DATA_AXIS, SPLAT_AXIS, None),
        opacity=P(DATA_AXIS, SPLAT_AXIS),
    )


def state_pspec() -> TrainState:
    from gs2d_tpu.train.adam import AdamState

    pp = params_pspec()
    return TrainState(
        params=pp,
        opt=AdamState(m=pp, v=pp, beta1t=P(DATA_AXIS), beta2t=P(DATA_AXIS),
                      step=P(DATA_AXIS)),
    )


def ref_pspec():
    return P(DATA_AXIS, TILE_AXIS, None, None)


def init_batched_state(cfg: SplatConfig, batch: int) -> TrainState:
    """Batched train state: same deterministic init replicated per image
    (each image then evolves its own population)."""
    one = init_train_state(cfg)

    def tile_leaf(x):
        return jnp.broadcast_to(x[None], (batch,) + x.shape)

    return jax.tree.map(tile_leaf, one)


def pad_ref_batch(refs, cfg: SplatConfig) -> jax.Array:
    """(B, H, W, 3) targets zero-padded to the tile grid (B, Hp, Wp, 3)."""
    refs = jnp.asarray(refs, jnp.float32)
    b = refs.shape[0]
    out = jnp.zeros((b, cfg.padded_height, cfg.padded_width, 3), jnp.float32)
    return out.at[:, : cfg.height, : cfg.width].set(refs)


def _ordered_monoid_fold(C_loc, T_loc, axis: str):
    """Combine per-shard (C, T) partials in index order over ``axis``.

    Returns (final color, final T, prefix C entering this shard, prefix T
    entering this shard). log-depth: one all_gather + an on-chip fold over
    the (small) shard axis.
    """
    idx = jax.lax.axis_index(axis)
    Call = jax.lax.all_gather(C_loc, axis)  # (S, bh, W, 3)
    Tall = jax.lax.all_gather(T_loc, axis)  # (S, bh, W)
    s = Call.shape[0]
    # Exclusive prefix products of transmittance, in index order.
    Texc = jnp.concatenate(
        [jnp.ones_like(Tall[:1]), jnp.cumprod(Tall[:-1], axis=0)], axis=0)
    fin = jnp.sum(Call * Texc[..., None], axis=0)
    T_fin = Texc[-1] * Tall[-1]
    # Prefix entering shard idx: combine of shards < idx.
    mask = (jnp.arange(s) < idx).astype(jnp.float32)
    C_in = jnp.sum(Call * Texc[..., None] * mask[:, None, None, None], axis=0)
    T_in = Texc[idx]
    return fin, T_fin, C_in, T_in


def _ordered_monoid_scan(C_loc, T_loc, axis: str):
    """Log-depth distributed ordered combine (Hillis-Steele over ppermute).

    The blend monoid  combine((Ca,Ta),(Cb,Tb)) = (Ca + Ta*Cb, Ta*Tb)  is
    scanned across the splat-shard axis with log2(S) neighbour shifts
    instead of an S-wide all_gather: per link each round moves one band,
    so comm volume is O(band * log S) vs O(band * S). Returns the same
    (fin, T_fin, C_in, T_in) as ``_ordered_monoid_fold``.
    """
    s = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)

    def combine(older, newer):
        (Ca, Ta), (Cb, Tb) = older, newer
        return Ca + Ta[..., None] * Cb, Ta * Tb

    # Inclusive prefix: after round j, acc_d = combine of shards
    # [max(0, d - 2^j + 1), d].
    acc = (C_loc, T_loc)
    shift = 1
    while shift < s:
        perm = [(i, (i + shift) % s) for i in range(s)]
        recv = (jax.lax.ppermute(acc[0], axis, perm),
                jax.lax.ppermute(acc[1], axis, perm))
        merged = combine(recv, acc)
        use = idx >= shift
        acc = (jnp.where(use, merged[0], acc[0]),
               jnp.where(use, merged[1], acc[1]))
        shift *= 2

    # Total (for gC) to every shard: select the last shard's inclusive
    # prefix and broadcast with a masked psum.
    is_last = idx == s - 1
    fin = jax.lax.psum(jnp.where(is_last, acc[0], 0.0), axis)
    T_fin = jax.lax.psum(jnp.where(is_last, acc[1], 0.0), axis)

    # Exclusive prefix entering this shard: previous shard's inclusive acc.
    perm1 = [(i, (i + 1) % s) for i in range(s)]
    C_prev = jax.lax.ppermute(acc[0], axis, perm1)
    T_prev = jax.lax.ppermute(acc[1], axis, perm1)
    first = idx == 0
    C_in = jnp.where(first, jnp.zeros_like(C_prev), C_prev)
    T_in = jnp.where(first, jnp.ones_like(T_prev), T_prev)
    return fin, T_fin, C_in, T_in


def _tile_band_step(params, ref_band, cfg_shard, n_splat, monoid,
                    band_tile_rows, overlap_chunks, cot_fn=None,
                    prebuilt=None):
    """Production per-device band step (inside shard_map).

    ``cot_fn`` (band color -> band cotangent) replaces the L2 cotangent
    for perceptual objectives (SSIM needs cross-band windows, so the
    caller gathers the full image inside it).

    ``prebuilt`` skips the binning build and uses the given band-scoped
    flat binning instead (the lazy-rebinning cache of the scanned sharded
    fitter).

    Bins the device's band once (cfg.binning: the flat pair list for the
    GPU kernel, or dense lists for the plain path; flat capacity is sized
    per band via ``tune_binning(n_bands=...)``), then computes (final band
    color, grads psum'd over the tile axis, n_dropped). The backward runs
    in ``overlap_chunks`` tile-row sub-bands; each sub-band's gradient psum
    is issued as soon as that sub-band finishes, so XLA's scheduler can
    overlap the collective with the next sub-band's compute. With splat
    shards the ordered (C, T) monoid combine runs between the forward and
    the backward.
    """
    from gs2d_tpu import backend
    from gs2d_tpu.ops import render_gpu as rg
    from gs2d_tpu.ops import render_tiles as rt
    from gs2d_tpu.ops import tiles as tlmod
    from gs2d_tpu.ops import tiles_flat as tlf

    cfg = cfg_shard
    flat = backend.resolve_binning(cfg) == "flat"
    gx = cfg.n_tiles_x
    th = cfg.tile_h
    n_local = params.pos.shape[0]
    band_r0 = jax.lax.axis_index(TILE_AXIS) * band_tile_rows
    if prebuilt is not None:
        binning = prebuilt
    elif flat:
        binning = tlf.bin_splats_flat(
            params, cfg, cfg.flat_capacity,
            band_row0=band_r0, band_rows=band_tile_rows)
    else:
        binning = tlmod.bin_splats(params, cfg, rt.max_per_tile(cfg),
                                   band_row0=band_r0,
                                   band_rows=band_tile_rows)
    rows_per = band_tile_rows // overlap_chunks
    n_band_tiles = band_tile_rows * gx

    def sub_binning(sub):
        t0, t1 = sub * rows_per * gx, (sub + 1) * rows_per * gx
        if flat:
            # A sub-band owns the contiguous pair rows [start[t0], row_hi);
            # rows outside it are never written by this sub-call's
            # kernel, so mask their ids out of the segment sum.
            row_lo = binning.start[t0]
            row_hi = binning.start[t1] if t1 < n_band_tiles \
                else jnp.int32(cfg.flat_capacity)
            j = jnp.arange(cfg.flat_capacity, dtype=jnp.int32)
            in_sub = (j >= row_lo) & (j < row_hi)
            return binning._replace(
                ids=jnp.where(in_sub, binning.ids, jnp.int32(-1)),
                start=binning.start[t0:t1], count=binning.count[t0:t1])
        return tlmod.TileBinning(
            ids=binning.ids[t0:t1], tile_params=binning.tile_params[t0:t1],
            count=binning.count[t0:t1], n_dropped=binning.n_dropped)

    def sub_px(sub):
        return slice(sub * rows_per * th, (sub + 1) * rows_per * th)

    if n_splat == 1 and cot_fn is None:
        grads = None
        bands = []
        l2 = rg.l2_render_and_grads_flat if flat else rt.l2_render_and_grads
        for sub in range(overlap_chunks):
            px = sub_px(sub)
            ref_chw = jnp.transpose(ref_band[px], (2, 0, 1))[None]
            C_sub, g_sub = l2(
                sub_binning(sub), ref_chw, n_local, cfg, params,
                band_row0=band_r0 + sub * rows_per, band_rows=rows_per)
            g_sub = jax.lax.psum(g_sub, TILE_AXIS)
            grads = g_sub if grads is None else jax.tree.map(
                jnp.add, grads, g_sub)
            bands.append(C_sub)
        fin = jnp.concatenate(bands, axis=0)
        return fin, grads, binning.n_dropped

    # Splat-sharded (or a non-L2 head): forward the whole band,
    # ordered-combine, then the backward replay with the incoming (C, T)
    # prefix.
    if flat:
        C_loc, T_loc = rg.forward_flat(binning, cfg, band_row0=band_r0,
                                       band_rows=band_tile_rows)
    else:
        C_loc, T_loc = rt.forward_tiled(binning, cfg, band_row0=band_r0,
                                        band_rows=band_tile_rows)
    if n_splat > 1:
        fin, _, C_in, T_in = monoid(C_loc, T_loc, SPLAT_AXIS)
        carry = (C_in, T_in)
    else:
        fin, carry = C_loc, None
    gC = (fin - ref_band) if cot_fn is None else cot_fn(fin)
    backward = rg.backward_flat if flat else rt.backward_tiled
    grads = None
    for sub in range(overlap_chunks):
        px = sub_px(sub)
        g_sub = backward(
            sub_binning(sub), fin[px], gC[px], n_local, cfg, params,
            carry_in=None if carry is None else (carry[0][px], carry[1][px]),
            band_row0=band_r0 + sub * rows_per, band_rows=rows_per)
        g_sub = jax.lax.psum(g_sub, TILE_AXIS)
        grads = g_sub if grads is None else jax.tree.map(
            jnp.add, grads, g_sub)
    return fin, grads, binning.n_dropped


def _validate_band_mesh(cfg: SplatConfig, mesh: Mesh, combine: str,
                        renderer: str, overlap_chunks: int):
    """Shared mesh/band validation for the sharded step builders.

    Returns (band_h, band_tile_rows, overlap_chunks) after checking the
    tile-axis band alignment, splat divisibility, and flat statics."""
    if combine not in ("fold", "scan"):
        raise ValueError(f"unknown combine {combine!r}")
    if renderer not in ("scan", "tiles"):
        raise ValueError(f"unknown renderer {renderer!r}")
    if renderer == "tiles":
        from gs2d_tpu import backend

        if backend.resolve_binning(cfg) == "flat" \
                and cfg.flat_capacity is None:
            raise ValueError(
                "flat binning capacity unset; call tune_binning(params, "
                "cfg, n_bands=<tile axis size>) before building the step")
    n_tile = mesh.shape[TILE_AXIS]
    n_splat = mesh.shape[SPLAT_AXIS]
    if cfg.padded_height % n_tile:
        raise ValueError(
            f"padded height {cfg.padded_height} not divisible by tile axis "
            f"{n_tile}; adjust tile_h or mesh")
    if cfg.n_splats % n_splat:
        raise ValueError("n_splats must divide over the splat axis")
    band_h = cfg.padded_height // n_tile
    if renderer == "tiles" and band_h % cfg.tile_h:
        raise ValueError("tile-axis bands must align to tile_h for the "
                         "tiles renderer")
    band_tile_rows = band_h // cfg.tile_h
    if overlap_chunks <= 0:
        overlap_chunks = 1
        if n_tile > 1 and renderer == "tiles":
            for c in (4, 3, 2):
                if band_tile_rows % c == 0:
                    overlap_chunks = c
                    break
    if band_tile_rows % overlap_chunks:
        raise ValueError(
            f"band of {band_tile_rows} tile rows not divisible by "
            f"overlap_chunks={overlap_chunks}")
    return band_h, band_tile_rows, overlap_chunks


def _ssim_cot_fn(cfg: SplatConfig, band_h: int, ssim_lambda: float,
                 ref_band, y0):
    """Band cotangent of the mixed L2+SSIM objective.

    SSIM windows cross band boundaries: gather the full image over the
    tile axis, autodiff the loss head on it (replicated compute, one
    image-sized gather), slice this band of the cotangent back."""
    from gs2d_tpu.train.ssim import mixed_loss

    def cot_fn(fin_band):
        full = jax.lax.all_gather(fin_band, TILE_AXIS, axis=0, tiled=True)
        ref_full = jax.lax.all_gather(ref_band, TILE_AXIS, axis=0,
                                      tiled=True)

        def head(c):
            return mixed_loss(c[: cfg.height, : cfg.width],
                              ref_full[: cfg.height, : cfg.width],
                              ssim_lambda)

        g_full = jax.grad(head)(full)
        return jax.lax.dynamic_slice_in_dim(g_full, y0, band_h, 0)

    return cot_fn


def _band_cache_fns(cfg: SplatConfig, band_tile_rows: int):
    """(make_cache, binning_of) for the lazy-rebinning band cache, or
    (None, None) when cfg's layout has no cacheable binning structure.

    The cache is the per-device band-scoped flat id structure built with
    ``cfg.rebin_margin`` px of footprint slack plus the params snapshot it
    was built from; ``binning_of`` re-runs the O(M) row pregather from the
    LIVE params. Same contract as the single-device lazy cache
    (train/loop.py::_fused_step_body), checked per device by the exact
    ``tiles.pairs_covered_by`` tripwire."""
    from gs2d_tpu import backend
    from gs2d_tpu.ops import tiles_flat as tlf

    if backend.resolve_binning(cfg) != "flat":
        return None, None

    def make_cache(params):
        b = tlf.bin_splats_flat(
            params, cfg, cfg.flat_capacity,
            band_row0=jax.lax.axis_index(TILE_AXIS) * band_tile_rows,
            band_rows=band_tile_rows, ids_only=True,
            margin=cfg.rebin_margin)
        return b, params

    def binning_of(cache, params):
        b = cache[0]
        return b._replace(rows=tlf.pregather_rows(b.ids, params, cfg))

    return make_cache, binning_of


def make_sharded_train_step(cfg: SplatConfig, mesh: Mesh,
                            combine: str = "fold",
                            renderer: str = "scan",
                            overlap_chunks: int = 0,
                            ssim_lambda: float = 0.0):
    """Build the jitted multi-device train step.

    State is batched (B, N, ...) and sharded (data, splat); targets are
    (B, Hp, Wp, 3) sharded (data, tile). ``combine`` picks the splat-axis
    ordered-combine implementation: "fold" (all_gather + on-device prefix,
    best for small shard counts) or "scan" (log-depth ppermute rounds).
    ``renderer`` picks the per-shard rasterizer: "scan" (lax.scan
    reference path, any mesh) or "tiles" (the production tile path of
    cfg.binning; each device bins and rasterizes its own band of tile rows
    -- the band must align to tile_h).

    Structure of the tiles path: with splat shards the ordered (C, T)
    monoid combine sits between the forward and the backward. The
    backward is cut into ``overlap_chunks`` tile-row sub-bands
    whose per-chunk gradient ``psum`` overlaps the remaining sub-bands'
    compute (the north-star "all-reduce overlapped with the backward tile
    sweep"; 0 = auto: largest divisor of the band <= 4 when the tile axis
    is sharded, else 1). Returns (step_fn, shardings dict).

    ``ssim_lambda`` > 0 optimizes the (1-lam)*L2 + lam*(1-SSIM) mix
    (train/ssim.py): SSIM windows cross band boundaries, so each device
    all_gathers the band colors over the tile axis, autodiffs the loss
    head on the full image (replicated compute, one image-sized gather),
    and slices its band of the cotangent back for the analytic backward.
    Reported mse stays the plain L2 metric.
    """
    band_h, band_tile_rows, overlap_chunks = _validate_band_mesh(
        cfg, mesh, combine, renderer, overlap_chunks)
    monoid = _ordered_monoid_fold if combine == "fold" else _ordered_monoid_scan
    n_tile = mesh.shape[TILE_AXIS]
    n_splat = mesh.shape[SPLAT_AXIS]
    # Sharded splat axis -> exact associative monoid (threshold off).
    cfg_shard = cfg.replace(min_throughput=0.0) if n_splat > 1 else cfg
    n_real_px = cfg.height * cfg.width * 3

    def one_image_step(params: GaussianParams, opt, ref_band):
        y0 = jax.lax.axis_index(TILE_AXIS) * band_h

        cot_fn = _ssim_cot_fn(cfg, band_h, ssim_lambda, ref_band, y0) \
            if ssim_lambda else None

        if renderer == "tiles":
            fin, grads, n_drop = _tile_band_step(
                params, ref_band, cfg_shard, n_splat, monoid,
                band_tile_rows, overlap_chunks, cot_fn=cot_fn)
            gC = fin - ref_band
        else:
            C_loc, T_loc = render_forward_band(params, cfg_shard, y0, band_h)
            n_drop = jnp.int32(0)
            if n_splat > 1:
                fin, _, C_in, T_in = monoid(C_loc, T_loc, SPLAT_AXIS)
                carry_in = (C_in, T_in)
            else:
                fin = C_loc
                carry_in = None
            gC = fin - ref_band  # dL/dC of the L2 objective (main.cpp:616)
            g_obj = gC if cot_fn is None else cot_fn(fin)
            grads = render_backward_band(
                params, fin, g_obj, cfg_shard, y0, band_h, carry_in)
            # Gradient all-reduce over the pixel-band axis.
            grads = jax.lax.psum(grads, TILE_AXIS)

        # Densify signal: |dL/d pos| per local splat shard (grads are
        # already tile-psum'd, so this matches the unsharded signal).
        gmag = jnp.linalg.norm(grads.pos, axis=-1)
        params_new, opt_new = adam_update(params, grads, opt, cfg)

        # Metrics: MSE over real pixels only (band sums psum'd over tiles).
        band_sq = jnp.sum(gC * gC)  # zero on padding by construction
        mse = jax.lax.psum(band_sq, TILE_AXIS) * jnp.float32(255.0 * 255.0) \
            / jnp.float32(n_real_px)
        return params_new, opt_new, mse, n_drop, gmag

    def local_step(state: TrainState, refs):
        # vmap over the local batch slice.
        def img(params, m, v, b1t, b2t, stp, ref_band):
            opt = type(state.opt)(m=m, v=v, beta1t=b1t, beta2t=b2t, step=stp)
            p_new, o_new, mse, n_drop, gmag = one_image_step(
                params, opt, ref_band)
            return p_new, o_new.m, o_new.v, o_new.beta1t, o_new.beta2t, \
                o_new.step, mse, n_drop, gmag

        p_new, m_new, v_new, b1t, b2t, stp, mse, n_drop, gmag = jax.vmap(img)(
            state.params, state.opt.m, state.opt.v, state.opt.beta1t,
            state.opt.beta2t, state.opt.step, refs)
        opt = type(state.opt)(m=m_new, v=v_new, beta1t=b1t, beta2t=b2t,
                              step=stp)
        new_state = TrainState(params=p_new, opt=opt)

        bad_local = jnp.float32(0.0)
        for leaf in jax.tree.leaves(p_new):
            bad_local = bad_local + jnp.sum(
                (~jnp.isfinite(leaf)).astype(jnp.float32))
        bad = jax.lax.psum(jax.lax.psum(bad_local, SPLAT_AXIS), TILE_AXIS)
        finite = bad == 0.0

        # Total dropped splat-tile pairs this step across all shards (the
        # binning coverage contract; see ops/tiles.py).
        drop_total = jax.lax.psum(jax.lax.psum(jax.lax.psum(
            jnp.sum(n_drop), SPLAT_AXIS), TILE_AXIS), DATA_AXIS)

        aux = StepAux(mse=mse, psnr=psnr_from_mse(mse),
                      all_finite=jnp.broadcast_to(finite, mse.shape),
                      n_dropped=drop_total, pos_grad_mag=gmag,
                      # The per-step sharded step bins eagerly by design;
                      # lazy rebinning under the mesh lives in the scanned
                      # fitter (make_fit_scan_sharded), which reports it.
                      rebinned=jnp.int32(0))
        return new_state, aux

    sspec = state_pspec()
    aux_spec = StepAux(mse=P(DATA_AXIS), psnr=P(DATA_AXIS),
                       all_finite=P(DATA_AXIS), n_dropped=P(),
                       pos_grad_mag=P(DATA_AXIS, SPLAT_AXIS),
                       rebinned=P())

    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=(sspec, ref_pspec()),
        out_specs=(sspec, aux_spec),
        check_vma=False,
    )
    step = jax.jit(sharded)

    shardings = {
        "state": jax.tree.map(lambda s: NamedSharding(mesh, s), sspec),
        "ref": NamedSharding(mesh, ref_pspec()),
    }
    return step, shardings


def make_fit_scan_sharded(cfg: SplatConfig, mesh: Mesh, *,
                          combine: str = "fold",
                          renderer: str = "tiles",
                          overlap_chunks: int = 0,
                          ssim_lambda: float = 0.0,
                          with_grad_mag: bool = False):
    """On-device multi-iteration SHARDED fitter: shard_map(lax.scan(step)).

    The distributed counterpart of ``train.loop.make_fit_scan_fused``: one
    device program per mesh executes ``n_iters`` complete sharded
    iterations (band binning + kernels + monoid combine + grad psum +
    Adam) with zero host round-trips.

    ``cfg.rebin_margin`` > 0 enables lazy rebinning UNDER the mesh for the
    flat layout: each device carries its band's margined
    binning cache in the scan state, runs the exact
    ``tiles.pairs_covered_by`` tripwire on its local splat shard every
    step, and ``lax.cond``-rebins only its own band when a footprint
    escapes the slack (no collective in either branch, so devices decide
    independently; the aux's ``rebinned`` flag is the pmax across the
    mesh). The local batch is mapped with ``lax.map``, not vmap: vmap
    would degrade the rebin cond into a both-branches select.

    With ``with_grad_mag`` the (B, N) densify signal is accumulated in
    the scan carry and replaces the aux's per-step field (same contract
    as make_fit_scan_fused). Returns (fit_k(state, refs, n_iters) ->
    (state, stacked StepAux), shardings dict).
    """
    band_h, band_tile_rows, overlap_chunks = _validate_band_mesh(
        cfg, mesh, combine, renderer, overlap_chunks)
    monoid = _ordered_monoid_fold if combine == "fold" else _ordered_monoid_scan
    n_tile = mesh.shape[TILE_AXIS]
    n_splat = mesh.shape[SPLAT_AXIS]
    cfg_shard = cfg.replace(min_throughput=0.0) if n_splat > 1 else cfg
    n_real_px = cfg.height * cfg.width * 3
    n_local = cfg.n_splats // n_splat

    make_cache = binning_of = None
    if renderer == "tiles" and cfg.rebin_margin > 0:
        make_cache, binning_of = _band_cache_fns(cfg_shard, band_tile_rows)
    lazy = make_cache is not None

    from gs2d_tpu.ops import tiles as tlmod

    def img_step(params, opt, ref_band, cache):
        y0 = jax.lax.axis_index(TILE_AXIS) * band_h
        cot_fn = _ssim_cot_fn(cfg, band_h, ssim_lambda, ref_band, y0) \
            if ssim_lambda else None
        rebinned = jnp.int32(0)
        prebuilt = None
        if lazy:
            covered = tlmod.pairs_covered_by(
                params, cache[1], cfg_shard, cfg.rebin_margin) \
                & (cache[0].n_dropped == 0)
            cache = jax.lax.cond(
                covered, lambda c: c,
                lambda c: make_cache(params), cache)
            prebuilt = binning_of(cache, params)
            rebinned = (~covered).astype(jnp.int32)
        if renderer == "tiles":
            fin, grads, n_drop = _tile_band_step(
                params, ref_band, cfg_shard, n_splat, monoid,
                band_tile_rows, overlap_chunks, cot_fn=cot_fn, prebuilt=prebuilt)
            gC = fin - ref_band
        else:
            C_loc, T_loc = render_forward_band(params, cfg_shard, y0, band_h)
            n_drop = jnp.int32(0)
            if n_splat > 1:
                fin, _, C_in, T_in = monoid(C_loc, T_loc, SPLAT_AXIS)
                carry_in = (C_in, T_in)
            else:
                fin = C_loc
                carry_in = None
            gC = fin - ref_band
            g_obj = gC if cot_fn is None else cot_fn(fin)
            grads = render_backward_band(
                params, fin, g_obj, cfg_shard, y0, band_h, carry_in)
            grads = jax.lax.psum(grads, TILE_AXIS)
        gmag = jnp.linalg.norm(grads.pos, axis=-1)
        params_new, opt_new = adam_update(params, grads, opt, cfg)
        band_sq = jnp.sum(gC * gC)
        mse = jax.lax.psum(band_sq, TILE_AXIS) * jnp.float32(255.0 * 255.0) \
            / jnp.float32(n_real_px)
        return params_new, opt_new, mse, n_drop, gmag, rebinned, cache

    def local_fit(state: TrainState, refs, n_iters: int):
        b_local = refs.shape[0]
        if lazy:
            caches0 = jax.lax.map(make_cache, state.params)
        else:
            caches0 = jnp.zeros((b_local,), jnp.int32)
        accum0 = jnp.zeros((b_local, n_local), jnp.float32)

        def body(carry, _):
            st, caches, acc = carry

            def img(t):
                params, m, v, b1t, b2t, stp, ref_band, cache = t
                opt = type(st.opt)(m=m, v=v, beta1t=b1t, beta2t=b2t,
                                   step=stp)
                p2, o2, mse, n_drop, gmag, reb, cache = img_step(
                    params, opt, ref_band, cache)
                return (p2, o2.m, o2.v, o2.beta1t, o2.beta2t, o2.step,
                        mse, n_drop, gmag, reb, cache)

            (p2, m2, v2, b1t, b2t, stp, mse, n_drop, gmag, reb,
             caches) = jax.lax.map(
                img, (st.params, st.opt.m, st.opt.v, st.opt.beta1t,
                      st.opt.beta2t, st.opt.step, refs, caches))
            opt = type(st.opt)(m=m2, v=v2, beta1t=b1t, beta2t=b2t, step=stp)
            new_state = TrainState(params=p2, opt=opt)

            bad_local = jnp.float32(0.0)
            for leaf in jax.tree.leaves(p2):
                bad_local = bad_local + jnp.sum(
                    (~jnp.isfinite(leaf)).astype(jnp.float32))
            bad = jax.lax.psum(jax.lax.psum(bad_local, SPLAT_AXIS),
                               TILE_AXIS)
            finite = bad == 0.0
            drop_total = jax.lax.psum(jax.lax.psum(jax.lax.psum(
                jnp.sum(n_drop), SPLAT_AXIS), TILE_AXIS), DATA_AXIS)
            # 1 when ANY device-image rebinned this step (matches the
            # single-chip flag's "this step paid a rebin" meaning).
            reb_any = jnp.max(reb)
            for ax in (SPLAT_AXIS, TILE_AXIS, DATA_AXIS):
                reb_any = jax.lax.pmax(reb_any, ax)
            acc = acc + gmag
            aux = StepAux(
                mse=mse, psnr=psnr_from_mse(mse),
                all_finite=jnp.broadcast_to(finite, mse.shape),
                n_dropped=drop_total,
                pos_grad_mag=jnp.float32(0.0), rebinned=reb_any)
            return (new_state, caches, acc), aux

        (state, _, accum), auxes = jax.lax.scan(
            body, (state, caches0, accum0), None, length=n_iters)
        if with_grad_mag:
            auxes = auxes._replace(pos_grad_mag=accum)
        return state, auxes

    sspec = state_pspec()
    aux_spec = StepAux(
        mse=P(None, DATA_AXIS), psnr=P(None, DATA_AXIS),
        all_finite=P(None, DATA_AXIS), n_dropped=P(None),
        pos_grad_mag=(P(DATA_AXIS, SPLAT_AXIS) if with_grad_mag
                      else P(None)),
        rebinned=P(None))

    @functools.lru_cache(maxsize=8)
    def _sharded_for(n_iters: int):
        return shard_map(
            functools.partial(local_fit, n_iters=n_iters), mesh=mesh,
            in_specs=(sspec, ref_pspec()),
            out_specs=(sspec, aux_spec),
            check_vma=False)

    @functools.partial(jax.jit, static_argnames=("n_iters",))
    def fit_k(state: TrainState, refs, n_iters: int):
        return _sharded_for(n_iters)(state, refs)

    shardings = {
        "state": jax.tree.map(lambda s: NamedSharding(mesh, s), sspec),
        "ref": NamedSharding(mesh, ref_pspec()),
    }
    return fit_k, shardings


def fit_sharded(
    refs,
    cfg: SplatConfig,
    mesh: Mesh,
    iterations: int,
    state: Optional[TrainState] = None,
    log_every: int = 0,
    log_fn=print,
    combine: str = "fold",
    renderer: str = "scan",
    overlap_chunks: int = 0,
    densify_every: int = 0,
    densify_cfg=None,
    ssim_lambda: float = 0.0,
    scan_chunk: int = 0,
    checkpoint_every: int = 0,
    checkpoint_fn=None,
):
    """Host driver for multi-device fitting over a batch of targets.

    ``densify_every`` enables per-image adaptive density control from the
    on-device accumulated |dL/d pos| signal (StepAux.pos_grad_mag); the
    densify op itself runs jitted on the sharded state (GSPMD inserts the
    collectives its argsort needs). ``ssim_lambda`` > 0 optimizes the
    mixed L2+SSIM objective (see make_sharded_train_step).

    ``scan_chunk`` > 1 runs iterations in on-device ``lax.scan`` blocks of
    that size via ``make_fit_scan_sharded`` (no host dispatch per step;
    lazy rebinning per
    ``cfg.rebin_margin`` runs under the mesh). Logging/densify granularity
    becomes the block (blocks are clipped to densify boundaries).

    ``checkpoint_fn(state, done)`` is called every ``checkpoint_every``
    completed iterations (block-granular under scan_chunk) with the live
    sharded batched state -- the sharding-aware Checkpointer
    (io/checkpoint.py) saves it per shard."""
    n_tile = mesh.shape[TILE_AXIS]
    if renderer == "tiles" and cfg.n_tiles_y % n_tile:
        # Round the tile grid so each device's band is whole tile rows
        # (extra rows are pure padding; results are identical).
        cfg = cfg.replace(tile_rows_multiple=n_tile)
    refs = pad_ref_batch(jnp.asarray(refs), cfg)
    batch = refs.shape[0]
    if state is None:
        state = init_batched_state(cfg, batch)
    if renderer == "tiles":
        from gs2d_tpu.ops import render_tiles as rt

        # Size the statics from image 0's population (the deterministic
        # init; uniform static across shards). Each shard bins a slice of
        # the splats, so the full-population per-band measurement is a safe
        # upper bound.
        p0 = jax.tree.map(lambda x: x[0], state.params)
        if cfg.rebin_margin < 0:
            # --rebin-margin -1 = auto, as in the single-device fit().
            from gs2d_tpu.ops import tiles as _tl

            cfg = _tl.tune_rebin_margin(p0, cfg)
        cfg = rt.tune_binning(p0, cfg, n_bands=n_tile)
    densify_fn = None
    if densify_every:
        from gs2d_tpu.train.densify import (DensifyConfig,
                                            densify_and_prune_batched)

        dcfg = densify_cfg or DensifyConfig()
        densify_fn = jax.jit(functools.partial(
            densify_and_prune_batched, cfg=cfg, dcfg=dcfg))
    if scan_chunk and scan_chunk > 1:
        fit_k, shardings = make_fit_scan_sharded(
            cfg, mesh, combine=combine, renderer=renderer,
            overlap_chunks=overlap_chunks, ssim_lambda=ssim_lambda,
            with_grad_mag=bool(densify_every))
        state = jax.device_put(state, shardings["state"])
        refs = jax.device_put(refs, shardings["ref"])
        return _fit_sharded_scanned(
            state, refs, fit_k, cfg, iterations, scan_chunk, log_every,
            log_fn, densify_every, densify_fn, checkpoint_every,
            checkpoint_fn)
    step, shardings = make_sharded_train_step(cfg, mesh, combine=combine,
                                              renderer=renderer,
                                              overlap_chunks=overlap_chunks,
                                              ssim_lambda=ssim_lambda)
    state = jax.device_put(state, shardings["state"])
    refs = jax.device_put(refs, shardings["ref"])
    accum = None
    history = []
    warned_drop = False
    for it in range(iterations):
        state, aux = step(state, refs)
        if densify_fn is not None:
            accum = aux.pos_grad_mag if accum is None \
                else accum + aux.pos_grad_mag
            if (it + 1) % densify_every == 0 and it + 1 < iterations:
                state = densify_fn(state, accum, seed=it + 1)
                accum = None
        if log_every and (it % log_every == 0 or it == iterations - 1):
            mse = [float(m) for m in aux.mse]
            history.append({"iter": it, "mse": mse})
            if log_fn:
                log_fn(f"{it} itr, mse {mse}")
            if not warned_drop and int(jnp.asarray(aux.n_dropped)) > 0:
                warned_drop = True
                if log_fn:
                    log_fn(f"WARNING: binning capacity overflow at iter {it}:"
                           f" {int(jnp.asarray(aux.n_dropped))} splat-tile "
                           "pairs dropped; raise max_splats_per_tile")
        if checkpoint_every and checkpoint_fn \
                and (it + 1) % checkpoint_every == 0:
            checkpoint_fn(state, it + 1)
    jax.block_until_ready(jax.tree.leaves(state)[0])
    return state, history


def _fit_sharded_scanned(state, refs, fit_k, cfg, iterations, scan_chunk,
                         log_every, log_fn, densify_every, densify_fn,
                         checkpoint_every=0, checkpoint_fn=None):
    """fit_sharded body for scan_chunk > 1: on-device sharded scan blocks.

    Mirrors train.loop._fit_scanned: per-block fetch of the stacked aux,
    NaN tripwire raise, capacity-overflow and persistent-rebin warnings,
    densify at block boundaries (blocks are clipped so densify_every is a
    block edge)."""
    import numpy as _np

    history = []
    warned_drop = False
    warned_rebin = False
    accum = None
    done = 0
    while done < iterations:
        n = min(scan_chunk, iterations - done)
        if densify_every:
            to_boundary = densify_every - done % densify_every
            n = min(n, to_boundary)
        state, auxes = fit_k(state, refs, n)
        mse_block = jax.device_get(auxes.mse)          # (n, B)
        finite_block = jax.device_get(auxes.all_finite)
        if not bool(finite_block.all()):
            bad = int(_np.argmin(finite_block.all(axis=1)))
            raise FloatingPointError(
                f"non-finite splat parameters at iteration {done + bad} "
                "(reference aborts here, main.cpp:752-785)")
        if densify_fn is not None:
            g = auxes.pos_grad_mag                     # block-accumulated
            accum = g if accum is None else accum + g
            end = done + n
            if end % densify_every == 0 and end < iterations:
                state = densify_fn(state, accum, seed=end)
                accum = None
        if not warned_drop:
            total_drop = int(jax.device_get(jnp.sum(
                jnp.asarray(auxes.n_dropped))))
            if total_drop > 0:
                warned_drop = True
                if log_fn:
                    log_fn(f"WARNING: binning capacity overflow: {total_drop}"
                           " splat-tile pairs dropped in this block")
        if not warned_rebin and cfg.rebin_margin > 0 and n >= 8:
            # Same tripwire economics as the single-chip scanned fitter
            # (train/loop.py): a block where every step rebinds means the
            # cache never validates -- strictly worse than eager binning.
            reb = int(jax.device_get(jnp.sum(jnp.asarray(auxes.rebinned))))
            if reb == n:
                warned_rebin = True
                if log_fn:
                    log_fn(
                        "WARNING: lazy rebinning rebinned on every step of "
                        f"this {n}-step block (cache never validates); "
                        "re-tune binning or set rebin_margin=0")
        for j in range(n):
            it = done + j
            if log_every and (it % log_every == 0 or it == iterations - 1):
                mse = [float(m) for m in mse_block[j]]
                history.append({"iter": it, "mse": mse})
                if log_fn:
                    log_fn(f"{it} itr, mse {mse}")
        done += n
        if checkpoint_every and checkpoint_fn \
                and done % checkpoint_every == 0:
            checkpoint_fn(state, done)
    jax.block_until_ready(jax.tree.leaves(state)[0])
    return state, history
