"""Adaptive density control: densify (clone/split) and prune.

The reference fits a fixed 1024-splat population (main.cpp:271). For the
large-scale configs (BASELINE.json configs[4]: 4K multi-image, 4M Gaussians,
densify/prune) the framework adds 3DGS-style density control adapted to 2D
image fitting, designed for static shapes:

- **Static capacity**: the population lives in fixed-size (N, ...) arrays so
  jit never recompiles. Dead slots are parked off-screen (pos = -1e6) with
  opacity 0, which the tile binner excludes for free (off-screen bbox) --
  no ragged shapes anywhere.
- **Prune**: kill splats whose opacity fell to the clamp floor (they were
  being optimized toward invisibility) or whose screen footprint collapsed.
- **Clone/split**: slots freed by pruning are filled by copies of the
  highest-position-gradient splats (under-reconstructed regions): small
  splats are cloned with a jittered position, large ones split with halved
  scales, following the 3DGS recipe re-derived for the 2D case.

All decisions are pure jnp (argsort/where) so the whole operation jits.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.ops.numerics import pcg3d_unit
from gs2d_tpu.params import DEAD_POS, GaussianParams
from gs2d_tpu.train.adam import AdamState
from gs2d_tpu.train.loop import TrainState


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    prune_opacity: float = 0.105     # at/near the 0.1 clamp floor
    prune_min_scale: float = 1.01    # both sigmas pinned at the 1.0 floor
    split_scale_threshold: float = 24.0  # sigma above which split, not clone
    clone_pos_jitter: float = 1.0    # pixels
    split_scale_factor: float = 0.6  # 3DGS uses /1.6
    max_fraction: float = 0.25       # densify at most this fraction per call


def live_mask(params: GaussianParams) -> jax.Array:
    return params.pos[:, 0] > DEAD_POS * 0.5


def n_live(params: GaussianParams) -> jax.Array:
    return jnp.sum(live_mask(params).astype(jnp.int32))


def densify_and_prune(
    state: TrainState,
    pos_grad_mag: jax.Array,
    cfg: SplatConfig,
    dcfg: DensifyConfig = DensifyConfig(),
    seed: int = 0,
) -> TrainState:
    """One density-control step.

    ``pos_grad_mag`` (N,) is the accumulated position-gradient magnitude used
    as the under-reconstruction signal (3DGS's view-space gradient norm).
    Adam moments of re-used slots are reset -- a fresh splat must not inherit
    a dead splat's momentum.
    """
    p = state.params
    n = p.pos.shape[0]

    alive = live_mask(p)
    # --- prune ------------------------------------------------------------
    degenerate = (p.sx <= dcfg.prune_min_scale) & (p.sy <= dcfg.prune_min_scale)
    transparent = p.opacity <= dcfg.prune_opacity
    if not cfg.optimize_opacity:
        transparent = jnp.zeros_like(transparent)  # opacity frozen: keep
    kill = alive & (transparent | degenerate)
    alive = alive & ~kill

    # --- choose donors ----------------------------------------------------
    score = jnp.where(alive, pos_grad_mag, -jnp.inf)
    order = jnp.argsort(-score)  # donors: best first
    # free slots: dead first
    free_order = jnp.argsort(alive.astype(jnp.int32), stable=True)
    n_free = n - jnp.sum(alive.astype(jnp.int32))
    budget = jnp.minimum(n_free, jnp.int32(n * dcfg.max_fraction))

    slot_idx = jnp.arange(n, dtype=jnp.int32)
    use = slot_idx < budget                    # first `budget` pairs act
    donor = order[slot_idx]                    # donor for pair i
    target = free_order[slot_idx]              # slot to fill for pair i
    donor_ok = jnp.take(score, donor) > 0.0    # only meaningful gradients
    act = use & donor_ok

    # --- build children ---------------------------------------------------
    r = pcg3d_unit(jnp.stack([
        slot_idx.astype(jnp.uint32),
        jnp.full((n,), seed, jnp.uint32),
        jnp.full((n,), 0x9E3779B9, jnp.uint32)], axis=-1))
    jitter = (r[:, :2] - 0.5) * (2.0 * dcfg.clone_pos_jitter)

    d_pos = jnp.take(p.pos, donor, axis=0)
    d_sx = jnp.take(p.sx, donor)
    d_sy = jnp.take(p.sy, donor)
    big = jnp.maximum(d_sx, d_sy) > dcfg.split_scale_threshold
    scale_f = jnp.where(big, dcfg.split_scale_factor, 1.0)

    child = GaussianParams(
        pos=jnp.clip(d_pos + jitter, 0.0,
                     jnp.asarray([cfg.width - 1, cfg.height - 1], jnp.float32)),
        sx=jnp.maximum(d_sx * scale_f, cfg.scale_min),
        sy=jnp.maximum(d_sy * scale_f, cfg.scale_min),
        rot=jnp.take(p.rot, donor),
        color=jnp.take(p.color, donor, axis=0),
        opacity=jnp.take(p.opacity, donor),
    )
    # split also shrinks the donor in place
    donor_scale = jnp.ones((n,), jnp.float32).at[donor].min(
        jnp.where(act & big, dcfg.split_scale_factor, 1.0))

    # --- scatter children into their slots --------------------------------
    def place(dst, src_rows, reset_dead):
        out = dst
        if reset_dead is not None:
            out = jnp.where(_bc(kill, out), reset_dead, out)
        upd = jnp.where(_bc(act, src_rows), src_rows,
                        jnp.take(out, target, axis=0))
        return out.at[target].set(upd)

    def _bc(mask, arr):
        return mask.reshape(mask.shape + (1,) * (arr.ndim - 1))

    dead_pos = jnp.full_like(p.pos, DEAD_POS)
    new_params = GaussianParams(
        pos=place(p.pos, child.pos, dead_pos),
        sx=place(p.sx * donor_scale, child.sx, jnp.ones_like(p.sx)),
        sy=place(p.sy * donor_scale, child.sy, jnp.ones_like(p.sy)),
        rot=place(p.rot, child.rot, jnp.zeros_like(p.rot)),
        color=place(p.color, child.color, jnp.zeros_like(p.color)),
        opacity=place(p.opacity, child.opacity, jnp.zeros_like(p.opacity)),
    )

    # --- reset Adam moments of touched slots ------------------------------
    touched = jnp.zeros((n,), bool).at[target].set(act) | kill

    def reset_moment(m):
        return jnp.where(_bc(touched, m), 0.0, m)

    opt = state.opt
    new_opt = AdamState(
        m=jax.tree.map(reset_moment, opt.m),
        v=jax.tree.map(reset_moment, opt.v),
        beta1t=opt.beta1t, beta2t=opt.beta2t, step=opt.step,
    )
    return TrainState(params=new_params, opt=new_opt)


def densify_and_prune_batched(state: TrainState, pos_grad_mag, cfg,
                              dcfg: DensifyConfig = DensifyConfig(),
                              seed: int = 0) -> TrainState:
    """Batched (B, N, ...) version for multi-image populations."""
    import jax

    return jax.vmap(
        lambda s, g: densify_and_prune(s, g, cfg, dcfg, seed)
    )(state, pos_grad_mag)


def fit_adaptive_batched(
    refs,
    cfg: SplatConfig,
    iterations: int,
    densify_every: int,
    state: TrainState | None = None,
    dcfg: DensifyConfig = DensifyConfig(),
    scan_chunk: int = 50,
    log_every: int = 0,
    log_fn=print,
    opacity_reset_every: int = 0,
    opacity_reset_value: float = 0.3,
):
    """Batched multi-image adaptive-density fitting -- the assembled
    north-star configs[4] shape on one chip: B independent images, each
    with its own population, densify/prune per image, every binning
    layout (flat included).

    The scan-batched fitter (train/loop.py::make_fit_scan_batched with
    the densify signal) accumulates each image's (N,) |dL/d pos| in the
    scan carry; windows end in a vmapped densify_and_prune. Binning
    statics are shared across the batch (SPMD-uniform shapes), so
    re-tunes take the max need over images; per-image divergence past
    the tuning margin trips n_dropped -- never silent -- and re-tunes.

    Returns (state, history); history mse records are per-image lists.
    """
    import jax
    import jax.numpy as jnp

    from gs2d_tpu import backend
    from gs2d_tpu.ops import render_tiles as rt
    from gs2d_tpu.parallel.sharded import init_batched_state
    from gs2d_tpu.train.loop import make_fit_scan_batched

    b = len(refs)
    if state is None:
        state = init_batched_state(cfg, b)

    def retune(cfg):
        # Shared statics must cover EVERY image's population: tune per
        # image, take the max (B is small).
        untuned = cfg.replace(flat_capacity=None, max_splats_per_tile=None)
        tuned = [rt.tune_binning(jax.tree.map(lambda x: x[i], state.params),
                                 untuned) for i in range(b)]

        def most(field):
            vals = [getattr(t, field) for t in tuned]
            return None if vals[0] is None else max(vals)

        return cfg.replace(flat_capacity=most("flat_capacity"),
                           max_splats_per_tile=most("max_splats_per_tile"),
                           max_tiles_per_splat=most("max_tiles_per_splat"))

    flat = backend.resolve_binning(cfg) == "flat"
    if (cfg.flat_capacity if flat else cfg.max_splats_per_tile) is None:
        cfg = retune(cfg)

    def pad_refs(cfg):
        return jnp.stack([rt.pad_ref_chw(jnp.asarray(r), cfg)
                          for r in refs])

    refsp = pad_refs(cfg)
    fit_k = make_fit_scan_batched(cfg, True)
    history = []
    done = 0
    chunk = max(1, scan_chunk)
    while done < iterations:
        window = min(densify_every, iterations - done)
        accum = jnp.zeros((b, cfg.n_splats), jnp.float32)
        drops = jnp.int32(0)
        w_done = 0
        while w_done < window:
            n = min(chunk, window - w_done)
            state, auxes = fit_k(state, refsp, n)
            accum = accum + auxes.pos_grad_mag
            drops = drops + jnp.sum(jnp.asarray(auxes.n_dropped))
            if log_every:
                mse = jax.device_get(auxes.mse)  # (n, B)
                for j in range(n):
                    it = done + w_done + j
                    if it % log_every == 0 or it == iterations - 1:
                        rec = {"iter": it,
                               "mse": [float(x) for x in mse[j]]}
                        history.append(rec)
                        if log_fn:
                            log_fn(f"{it} itr, mse " + " ".join(
                                f"{x:.4f}" for x in mse[j]))
            w_done += n
        prev = done
        done += window
        if done < iterations:
            state = densify_and_prune_batched(state, accum, cfg, dcfg,
                                              seed=done)
            if opacity_reset_every and cfg.optimize_opacity and \
                    done // opacity_reset_every > prev // opacity_reset_every:
                state = opacity_reset(state, cfg, opacity_reset_value)
            window_drops = int(jax.device_get(drops))
            if window_drops > 0:
                if log_fn:
                    log_fn(f"WARNING: binning capacity overflow: "
                           f"{window_drops} splat-tile pairs dropped in "
                           f"the window ending at {done}; re-tuning "
                           f"capacities")
                cfg = retune(cfg)
                refsp = pad_refs(cfg)
                fit_k = make_fit_scan_batched(cfg, True)
    jax.block_until_ready(state.params.pos)
    return state, history


def opacity_reset(state: TrainState, cfg: SplatConfig,
                  value: float = 0.3) -> TrainState:
    """Periodic opacity reset (the 3DGS floater-control schedule).

    Caps every opacity at ``value`` and zeroes the opacity Adam moments, so
    splats must re-earn their opacity from fresh gradients; splats that
    never do drift to the clamp floor and are culled by the next prune.
    Lower-only (min), so parked dead slots (opacity 0) stay dead. Only
    meaningful with cfg.optimize_opacity=True (the reference keeps opacity
    frozen, main.cpp:317; this schedule is for the adaptive-density
    configs, BASELINE.json configs[4]).
    """
    p = state.params
    params = p.replace(opacity=jnp.minimum(p.opacity, jnp.float32(value)))
    opt = state.opt.replace(
        m=state.opt.m.replace(opacity=jnp.zeros_like(state.opt.m.opacity)),
        v=state.opt.v.replace(opacity=jnp.zeros_like(state.opt.v.opacity)))
    return TrainState(params=params, opt=opt)


def fit_adaptive(
    ref,
    cfg: SplatConfig,
    iterations: int,
    densify_every: int,
    state: TrainState | None = None,
    dcfg: DensifyConfig = DensifyConfig(),
    scan_chunk: int = 0,
    log_every: int = 0,
    log_fn=print,
    reorder_every: int = 0,
    opacity_reset_every: int = 0,
    opacity_reset_value: float = 0.3,
):
    """Production adaptive-density fitting on the production tile path.

    The densification signal -- |dL/d pos| accumulated over the preceding
    window (the 3DGS view-space gradient recipe) -- is summed ON DEVICE by
    the train step itself (StepAux.pos_grad_mag; inside the scan carry when
    ``scan_chunk`` > 1), so enabling densify adds no host transfers and no
    extra rendering passes. Every ``densify_every`` iterations the window's
    accumulated signal drives densify_and_prune; ``reorder_every`` (a
    multiple of densify_every, or used alone) interleaves Morton reordering.

    Returns (state, history).
    """
    import jax
    import jax.numpy as jnp

    from gs2d_tpu.ops import render_tiles as rt
    from gs2d_tpu.train.loop import (init_train_state, make_fit_scan_fused,
                                     make_train_step_fused)

    if state is None:
        state = init_train_state(cfg)

    def retune(cfg):
        """(Re-)derive the binning capacity statics from the population."""
        return rt.tune_binning(state.params, cfg.replace(
            flat_capacity=None, max_splats_per_tile=None))

    cfg = rt.tune_binning(state.params, cfg)
    refp = rt.pad_ref_chw(jnp.asarray(ref), cfg)

    history = []
    done = 0
    while done < iterations:
        window = min(densify_every, iterations - done)
        accum = jnp.zeros((cfg.n_splats,), jnp.float32)
        drops = jnp.int32(0)  # device-side window overflow accumulator
        if scan_chunk and scan_chunk > 1:
            fit_k = make_fit_scan_fused(cfg, True)
            w_done = 0
            while w_done < window:
                n = min(scan_chunk, window - w_done)
                state, auxes = fit_k(state, refp, n)
                accum = accum + auxes.pos_grad_mag
                drops = drops + jnp.sum(jnp.asarray(auxes.n_dropped))
                if log_every:
                    mse = jax.device_get(auxes.mse)
                    for j in range(n):
                        it = done + w_done + j
                        if it % log_every == 0 or it == iterations - 1:
                            rec = {"iter": it, "mse": float(mse[j])}
                            history.append(rec)
                            if log_fn:
                                log_fn(f"{it} itr, mse {rec['mse']:.4f}")
                w_done += n
        else:
            step = make_train_step_fused(cfg, True)
            for j in range(window):
                state, aux = step(state, refp)
                accum = accum + aux.pos_grad_mag  # device-side, async
                drops = drops + jnp.asarray(aux.n_dropped)
                it = done + j
                if log_every and (it % log_every == 0
                                  or it == iterations - 1):
                    rec = {"iter": it, "mse": float(aux.mse)}
                    history.append(rec)
                    if log_fn:
                        log_fn(f"{it} itr, mse {rec['mse']:.4f}")
        prev = done
        done += window
        if done < iterations:
            state = densify_and_prune(state, accum, cfg, dcfg, seed=done)
            # Fire when the window CROSSED a reset boundary, so any
            # opacity_reset_every works, not only multiples of densify_every.
            if opacity_reset_every and cfg.optimize_opacity and \
                    done // opacity_reset_every > prev // opacity_reset_every:
                state = opacity_reset(state, cfg, opacity_reset_value)
            if reorder_every and done % reorder_every == 0:
                from gs2d_tpu.train.reorder import reorder_state

                state = reorder_state(state, cfg)
            # Densify concentrates clones/splits into the already-fullest
            # tiles; if this window overflowed a static capacity (pairs were
            # dropped -- wrong gradients for the dropped pairs), warn and
            # re-derive the capacity statics from the new population before
            # the next window ("overflow is never silent", ops/tiles.py).
            window_drops = int(jax.device_get(drops))
            if window_drops > 0:
                if log_fn:
                    log_fn(f"WARNING: binning capacity overflow: "
                           f"{window_drops} splat-tile pairs dropped in the "
                           f"window ending at {done}; re-tuning capacities")
                cfg = retune(cfg)
                refp = rt.pad_ref_chw(jnp.asarray(ref), cfg)
    jax.block_until_ready(state.params.pos)
    return state, history
