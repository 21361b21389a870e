"""The fitting loop: jitted train step + host-side driver.

One reference GUI frame == one optimization iteration (main.cpp:334-851):
forward rasterize, analytic backward, Adam with constraints, NaN tripwire,
MSE report. Here that iteration is a single jitted ``train_step`` that stays
entirely on device; the host driver only reads back scalar metrics (and
images when asked), replacing the reference's per-frame texture upload.

The reference's NaN abort (main.cpp:752-785) becomes a recoverable on-device
``all_finite`` flag returned from the step; the driver raises (or restores a
checkpoint) instead of ``abort()``.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.ops import render_jax
from gs2d_tpu.params import GaussianParams, init_params
from gs2d_tpu.train.adam import AdamState, adam_update, init_adam_state
from gs2d_tpu.train.metrics import mse_255, psnr_from_mse
from gs2d_tpu.utils import pytree


@pytree.dataclass
class TrainState:
    """Everything the reference would need to resume a fit: splats, Adam
    moments, bias powers, iteration count (main.cpp:271-278)."""

    params: GaussianParams
    opt: AdamState


@functools.lru_cache(maxsize=32)
def _init_train_state_jit(cfg: SplatConfig):
    def mk():
        params = init_params(cfg)
        return TrainState(params=params, opt=init_adam_state(params))

    return jax.jit(mk)


def init_train_state(cfg: SplatConfig) -> TrainState:
    # One device program instead of ~100 eager dispatches.
    return _init_train_state_jit(cfg)()


class StepAux(NamedTuple):
    mse: jax.Array        # 0-255-scale MSE of the pre-update render
    psnr: jax.Array
    all_finite: jax.Array  # NaN tripwire flag (recoverable main.cpp:752-785)
    # Splat-tile pairs lost to static binning capacity caps this step (the
    # tile pipeline's coverage contract; 0 on the scan path which has no
    # binning). Surfaced so capacity overflow is never silent.
    n_dropped: jax.Array = 0
    # (N,) |dL/d pos| of this step -- the densification signal (3DGS's
    # view-space gradient norm, accumulated over the window by the fit
    # drivers). Scalar 0 when the step was built without it.
    pos_grad_mag: jax.Array = 0
    # 1 when this step rebuilt the cached binning (lazy rebinning,
    # cfg.rebin_margin > 0); 0 on cache hits and on uncached paths.
    rebinned: jax.Array = 0


RenderFn = Callable[[GaussianParams, SplatConfig], jax.Array]


def _make_loss_fn(render, cfg: SplatConfig, ssim_lambda: float):
    """L2 (reference objective) or the (1-lam)*L2 + lam*(1-SSIM) mix.

    Either way the rasterizer's analytic custom VJP supplies dC/dparams;
    only the (autodiffed) head on top of the rendered image differs."""
    if ssim_lambda:
        from gs2d_tpu.train.ssim import mixed_loss

        def loss_fn(params, ref):
            color = render(params, cfg)
            return mixed_loss(color, ref, ssim_lambda), color

        return loss_fn

    def loss_fn(params, ref):
        color = render(params, cfg)
        d = color - ref
        # 0.5*sum(d^2) makes the per-pixel cotangent exactly C - ref, the
        # reference's dL/dC (main.cpp:616).
        return jnp.float32(0.5) * jnp.sum(d * d), color

    return loss_fn


@functools.lru_cache(maxsize=32)
def make_train_step(cfg: SplatConfig, render_fn: Optional[RenderFn] = None,
                    ssim_lambda: float = 0.0):
    """Build a jitted train step closed over the static config.

    Memoized on (cfg, render_fn, ssim_lambda) so repeated fit() calls
    (densify blocks, resume) reuse the compiled step instead of re-tracing.

    ``render_fn`` must be differentiable w.r.t. params (the default is the
    scan renderer with the analytic custom VJP; the production tile renderer plugs
    in identically). ``ssim_lambda`` > 0 switches the objective to the
    perceptual mix (train/ssim.py).
    """
    render = render_fn if render_fn is not None else render_jax.render
    loss_fn = _make_loss_fn(render, cfg, ssim_lambda)

    @jax.jit
    def train_step(state: TrainState, ref: jax.Array):
        (_, color), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, ref
        )
        params, opt = adam_update(state.params, grads, state.opt, cfg)
        finite = jnp.all(
            jnp.array(
                [jnp.all(jnp.isfinite(leaf)) for leaf in jax.tree.leaves(params)]
            )
        )
        mse = mse_255(color, ref)
        return TrainState(params=params, opt=opt), StepAux(
            mse=mse, psnr=psnr_from_mse(mse), all_finite=finite
        )

    return train_step


def make_fit_scan(cfg: SplatConfig, render_fn: Optional[RenderFn] = None,
                  unroll: int = 1, ssim_lambda: float = 0.0):
    """Build a jitted multi-iteration fitter: ``lax.scan`` over train steps.

    One device program executes ``n_iters`` full iterations without host
    round-trips. Returns
    ``fit_k(state, ref, n_iters)`` with ``n_iters`` static; outputs the final
    state plus per-iteration (mse, psnr, all_finite) histories.
    """
    render = render_fn if render_fn is not None else render_jax.render
    loss_fn = _make_loss_fn(render, cfg, ssim_lambda)

    def one_step(state: TrainState, ref):
        (_, color), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, ref
        )
        params, opt = adam_update(state.params, grads, state.opt, cfg)
        finite = jnp.all(
            jnp.array(
                [jnp.all(jnp.isfinite(leaf)) for leaf in jax.tree.leaves(params)]
            )
        )
        mse = mse_255(color, ref)
        return TrainState(params=params, opt=opt), StepAux(
            mse=mse, psnr=psnr_from_mse(mse), all_finite=finite
        )

    @functools.partial(jax.jit, static_argnames=("n_iters",))
    def fit_k(state: TrainState, ref: jax.Array, n_iters: int):
        def body(carry, _):
            new_state, aux = one_step(carry, ref)
            return new_state, aux

        state, auxes = jax.lax.scan(
            body, state, None, length=n_iters, unroll=unroll
        )
        return state, auxes

    return fit_k


def fit(
    ref: jax.Array,
    cfg: SplatConfig,
    iterations: int,
    render_fn: Optional[RenderFn] = None,
    state: Optional[TrainState] = None,
    log_every: int = 0,
    log_fn=print,
    checkpoint_every: int = 0,
    checkpoint_fn=None,
    raise_on_nonfinite: bool = True,
    use_fused: bool = False,
    scan_chunk: int = 0,
    ssim_lambda: float = 0.0,
    iter_offset: int = 0,
):
    """Host driver for the fitting loop (the reference's while-NextFrame loop,
    main.cpp:334-851, minus the GUI).

    ``use_fused`` switches to the production tile L2 train step (ignores
    ``render_fn``; the layout follows cfg.binning, gs2d_tpu/backend.py).
    ``scan_chunk`` > 1 runs iterations in on-device ``lax.scan`` blocks of
    that size (no host dispatch per step; logging/checkpoint granularity
    becomes the block). ``ssim_lambda`` > 0 uses the perceptual L2+SSIM
    mix, which runs on the modular custom-VJP path (the tile step
    hard-codes the L2 cotangent). ``iter_offset`` shifts logged/recorded iteration numbers
    (callers running fit() in blocks -- densify windows, resume -- pass the
    global start so logs and history stay globally numbered; checkpoint_fn
    steps remain block-relative). Returns (state, history) where history is
    a list of per-logged-step dicts.
    """
    if state is None:
        state = init_train_state(cfg)
    if ssim_lambda:
        use_fused = False
    if use_fused:
        from gs2d_tpu.ops import render_tiles as rt

        if cfg.rebin_margin < 0:
            # --rebin-margin -1 = auto: pick the slack from the measured
            # pair inflation (falls back to eager when a margin taxes the
            # kernel more than it saves in binning).
            from gs2d_tpu.ops import tiles as _tl

            cfg = _tl.tune_rebin_margin(state.params, cfg)
        # Measure the real per-tile / total pair counts and size the static
        # capacities to them. Each fit() call (e.g. per densify block)
        # re-tunes; rounding keeps the set of compiled shapes small.
        cfg = rt.tune_binning(state.params, cfg)
        step_fn = make_train_step_fused(cfg)
        ref = rt.pad_ref_chw(jnp.asarray(ref), cfg)
    else:
        if cfg.rebin_margin != 0:
            cfg = cfg.replace(rebin_margin=0.0)  # modular path rebins eagerly
        step_fn = make_train_step(cfg, render_fn, ssim_lambda=ssim_lambda)
    if use_fused and scan_chunk and scan_chunk > 1 and _needs_split(cfg):
        # Scanning would fuse binning+kernels into one program; at these
        # step times (>1 s) dispatch overhead is noise, so run split steps.
        if log_fn:
            log_fn("scan_chunk ignored: flat capacity exceeds the "
                   "single-program memory budget (split steps)")
        scan_chunk = 0
    if scan_chunk and scan_chunk > 1:
        return _fit_scanned(
            ref, cfg, iterations, state, scan_chunk,
            use_fused=use_fused, render_fn=render_fn, log_every=log_every,
            log_fn=log_fn, checkpoint_every=checkpoint_every,
            checkpoint_fn=checkpoint_fn,
            raise_on_nonfinite=raise_on_nonfinite, ssim_lambda=ssim_lambda,
            iter_offset=iter_offset)
    history = []
    t0 = time.perf_counter()
    warned_drop = [False]

    def check_finite(aux, it):
        # Reading the flag syncs the device, so only do it at log points --
        # steps in between stay asynchronously pipelined.
        if raise_on_nonfinite and not bool(aux.all_finite):
            raise FloatingPointError(
                f"non-finite splat parameters at iteration {it} "
                "(reference aborts here, main.cpp:752-785)"
            )
        if not warned_drop[0] and int(jnp.asarray(aux.n_dropped)) > 0:
            warned_drop[0] = True
            if log_fn:
                log_fn(
                    f"WARNING: binning capacity overflow at iteration {it}: "
                    f"{int(jnp.asarray(aux.n_dropped))} splat-tile pairs "
                    "dropped; raise max_splats_per_tile / max_tiles_per_splat"
                )

    aux = None
    for it in range(iterations):
        state, aux = step_fn(state, ref)
        if log_every and (it % log_every == 0 or it == iterations - 1):
            check_finite(aux, it)
            mse = float(aux.mse)
            rec = {
                "iter": it + iter_offset,
                "mse": mse,
                "psnr": float(aux.psnr),
                "n_dropped": int(aux.n_dropped),
                "elapsed_s": time.perf_counter() - t0,
            }
            history.append(rec)
            if log_fn:
                log_fn(f"{it + iter_offset} itr, mse {mse:.4f}, "
                       f"psnr {rec['psnr']:.2f} dB")
        if checkpoint_every and checkpoint_fn and (it + 1) % checkpoint_every == 0:
            checkpoint_fn(state, it + 1)
    if aux is not None:
        check_finite(aux, iterations - 1)
    jax.block_until_ready(state.params.pos)
    return state, history


def _fit_scanned(
    ref, cfg, iterations, state, scan_chunk, *, use_fused, render_fn,
    log_every, log_fn, checkpoint_every, checkpoint_fn, raise_on_nonfinite,
    ssim_lambda=0.0, iter_offset=0,
):
    """fit() body for scan_chunk > 1: on-device K-iteration scan blocks.

    ``ref`` is already padded (fused) or raw (modular). History records come
    from the per-iteration aux arrays the scan stacks, so log_every keeps
    working inside a block (values are fetched after the block completes --
    iteration timing within a block is not observable, elapsed_s is
    block-granular)."""
    fit_k = make_fit_scan_fused(cfg) if use_fused else \
        make_fit_scan(cfg, render_fn, ssim_lambda=ssim_lambda)
    history = []
    t0 = time.perf_counter()
    warned_drop = False
    warned_rebin = False
    done = 0
    while done < iterations:
        n = min(scan_chunk, iterations - done)
        state, auxes = fit_k(state, ref, n)
        mse_block = jax.device_get(auxes.mse)
        finite_block = jax.device_get(auxes.all_finite)
        if raise_on_nonfinite and not bool(finite_block.all()):
            import numpy as _np

            bad = int(_np.argmin(finite_block))
            raise FloatingPointError(
                f"non-finite splat parameters at iteration {done + bad} "
                "(reference aborts here, main.cpp:752-785)")
        if not warned_drop:
            total_drop = int(jax.device_get(jnp.sum(
                jnp.asarray(auxes.n_dropped))))
            if total_drop > 0:
                warned_drop = True
                if log_fn:
                    log_fn(f"WARNING: binning capacity overflow: {total_drop}"
                           " splat-tile pairs dropped in this block")
        if not warned_rebin and cfg.rebin_margin > 0 and n >= 8:
            # Lazy rebinning should mostly hit the cache; a block where
            # EVERY step rebinds means the tripwire never validates (a
            # footprint exceeds the slot grid, or the margined binning
            # drops pairs) -- strictly worse than rebin_margin=0, because
            # each step pays the tripwire AND the full rebin. Conservative
            # direction (never wrong results), so warn, don't raise.
            reb = int(jax.device_get(jnp.sum(jnp.asarray(auxes.rebinned))))
            if reb == n:
                warned_rebin = True
                if log_fn:
                    log_fn(
                        "WARNING: lazy rebinning rebinned on every step of "
                        f"this {n}-step block (cache never validates); "
                        "re-tune binning (tune_flat_config / "
                        "tune_tile_capacity) or set rebin_margin=0")
        elapsed = time.perf_counter() - t0
        drop_block = jax.device_get(jnp.broadcast_to(
            jnp.asarray(auxes.n_dropped), (n,)))
        for j in range(n):
            it = done + j
            if log_every and (it % log_every == 0 or it == iterations - 1):
                mse = float(mse_block[j])
                psnr = float(jax.device_get(auxes.psnr)[j])
                rec = {"iter": it + iter_offset, "mse": mse, "psnr": psnr,
                       "n_dropped": int(drop_block[j]), "elapsed_s": elapsed}
                history.append(rec)
                if log_fn:
                    log_fn(f"{it + iter_offset} itr, mse {mse:.4f}, "
                           f"psnr {psnr:.2f} dB")
        done += n
        if checkpoint_every and checkpoint_fn and \
                done % checkpoint_every == 0:
            checkpoint_fn(state, done)
    jax.block_until_ready(state.params.pos)
    return state, history


def _fused_step_body(cfg: SplatConfig, with_grad_mag: bool = False):
    """The production tile train iteration as a pure function (shared by
    the single-step, scanned, and batched wrappers). The layout follows
    cfg.binning (render_tiles.l2_step). ``with_grad_mag`` adds the (N,)
    |dL/d pos| densify signal to the aux."""
    from gs2d_tpu import backend
    from gs2d_tpu.ops import render_gpu as rg
    from gs2d_tpu.ops import render_tiles as rt
    from gs2d_tpu.ops import tiles as tl

    def tail(state, ref_chw, color, grads, n_dropped, rebinned=0):
        gmag = jnp.linalg.norm(grads.pos, axis=-1) if with_grad_mag else 0
        params, opt = adam_update(state.params, grads, state.opt, cfg)
        finite = jnp.all(
            jnp.array(
                [jnp.all(jnp.isfinite(leaf)) for leaf in jax.tree.leaves(params)]
            )
        )
        ref_crop = jnp.transpose(
            ref_chw[0], (1, 2, 0))[: cfg.height, : cfg.width]
        mse = mse_255(color, ref_crop)
        return TrainState(params=params, opt=opt), StepAux(
            mse=mse, psnr=psnr_from_mse(mse), all_finite=finite,
            n_dropped=n_dropped, pos_grad_mag=gmag, rebinned=rebinned,
        )

    def one_step(state: TrainState, ref_chw: jax.Array):
        color, grads, n_dropped = rt.l2_step(state.params, ref_chw, cfg)
        return tail(state, ref_chw, color, grads, n_dropped)

    if not (cfg.rebin_margin > 0
            and backend.resolve_binning(cfg) == "flat"):
        return one_step

    # --- lazy rebinning (flat layout) ---------------------------------------
    # The flat structure (expansion + one stable sort -> ids/start/count) is
    # param-dependent only through the pair SET, so a margined superset is
    # reusable across steps; the per-row parameter pregather
    # (tiles_flat.pregather_rows, the only live-param consumer) re-runs
    # every step. The exact validity tripwire (tiles.pairs_covered_by) runs
    # every step and lax.cond rebins only when some splat's exact footprint
    # escaped its slack; superset pairs contribute exactly nothing.
    from gs2d_tpu.ops import tiles_flat as tlf

    def make_flat_cache(params):
        b = tlf.bin_splats_flat(params, cfg, cfg.flat_capacity,
                                ids_only=True, margin=cfg.rebin_margin)
        return b, params

    def one_step_flat_cached(state: TrainState, ref_chw, cache):
        covered = tl.pairs_covered_by(
            state.params, cache[1], cfg, cfg.rebin_margin) \
            & (cache[0].n_dropped == 0)
        cache = jax.lax.cond(
            covered, lambda c: c,
            lambda c: make_flat_cache(state.params), cache)
        b = cache[0]
        binning = b._replace(rows=tlf.pregather_rows(b.ids, state.params,
                                                     cfg))
        color, grads = rg.l2_render_and_grads_flat(
            binning, ref_chw, cfg.n_splats, cfg, state.params)
        new_state, aux = tail(state, ref_chw, color, grads, b.n_dropped,
                              rebinned=(~covered).astype(jnp.int32))
        return new_state, aux, cache

    one_step.make_bin_cache = make_flat_cache
    one_step.cached = one_step_flat_cached
    return one_step


# Flat capacities above this many rows split the step into two device
# programs (binning | kernels+adam) so the binner's sort temporaries and the
# kernels' M-row buffers never coexist in one XLA allocation plan.
SPLIT_STEP_ROWS = 6 * 1024 * 1024


def _needs_split(cfg: SplatConfig) -> bool:
    from gs2d_tpu import backend

    return backend.resolve_binning(cfg) == "flat" \
        and (cfg.flat_capacity or 0) > SPLIT_STEP_ROWS


@functools.lru_cache(maxsize=32)
def _make_split_step_fused(cfg: SplatConfig, with_grad_mag: bool):
    from gs2d_tpu.ops import render_gpu as rg
    from gs2d_tpu.ops import tiles_flat as tlf

    bin_fn = jax.jit(lambda p: tlf.bin_splats_flat(p, cfg, cfg.flat_capacity))

    @jax.jit
    def tail(state: TrainState, binning, ref_chw):
        color, grads = rg.l2_render_and_grads_flat(
            binning, ref_chw, cfg.n_splats, cfg, state.params)
        gmag = jnp.linalg.norm(grads.pos, axis=-1) if with_grad_mag else 0
        params, opt = adam_update(state.params, grads, state.opt, cfg)
        finite = jnp.all(jnp.array(
            [jnp.all(jnp.isfinite(leaf)) for leaf in jax.tree.leaves(params)]))
        ref_crop = jnp.transpose(
            ref_chw[0], (1, 2, 0))[: cfg.height, : cfg.width]
        mse = mse_255(color, ref_crop)
        return TrainState(params=params, opt=opt), StepAux(
            mse=mse, psnr=psnr_from_mse(mse), all_finite=finite,
            n_dropped=binning.n_dropped, pos_grad_mag=gmag)

    def step(state: TrainState, ref_chw: jax.Array):
        return tail(state, bin_fn(state.params), ref_chw)

    return step


@functools.lru_cache(maxsize=32)
def make_train_step_fused(cfg: SplatConfig, with_grad_mag: bool = False):
    """Production single-device train step: binning, tile forward, L2
    cotangent, tile backward, gradient segment sum and Adam in one jitted
    program (memoized on cfg so repeated fit() calls reuse it). The target
    must be pre-padded once with ``render_tiles.pad_ref_chw`` (pass the
    padded (1,3,Hp,Wp) array). Semantically identical to the modular
    custom-VJP path; specialized to the reference's L2 objective.

    Very large flat workloads run as two chained device programs (see
    SPLIT_STEP_ROWS); at those step times dispatch overhead is noise.
    """
    if _needs_split(cfg):
        return _make_split_step_fused(cfg, with_grad_mag)
    return jax.jit(_fused_step_body(cfg, with_grad_mag))


@functools.lru_cache(maxsize=32)
def make_fit_scan_fused(cfg: SplatConfig, with_grad_mag: bool = False):
    """On-device multi-iteration fitter: ``lax.scan`` of the production
    tile step.

    One device program executes ``n_iters`` complete iterations (binning +
    tile forward/backward + Adam) with zero host round-trips. Returns
    ``fit_k(state, ref_chw, n_iters)`` (``n_iters`` static) -> (final state,
    stacked per-iteration StepAux histories). With ``with_grad_mag`` the
    (N,) densify signal is summed in the scan carry (not stacked per iter)
    and replaces the aux's per-step field.
    """
    one_step = _fused_step_body(cfg, with_grad_mag)
    cached = getattr(one_step, "cached", None)

    @functools.partial(jax.jit, static_argnames=("n_iters",))
    def fit_k(state: TrainState, ref_chw: jax.Array, n_iters: int):
        accum0 = jnp.zeros((cfg.n_splats,), jnp.float32)

        def body(carry, _):
            st, acc, cache = carry
            if cached is not None:
                new_state, aux, cache = cached(st, ref_chw, cache)
            else:
                new_state, aux = one_step(st, ref_chw)
            if with_grad_mag:
                acc = acc + aux.pos_grad_mag
                aux = aux._replace(pos_grad_mag=0)
            return (new_state, acc, cache), aux

        cache0 = one_step.make_bin_cache(state.params) \
            if cached is not None else 0
        (state, accum, _), auxes = jax.lax.scan(
            body, (state, accum0, cache0), None, length=n_iters)
        if with_grad_mag:
            auxes = auxes._replace(pos_grad_mag=accum)
        return state, auxes

    return fit_k


def fit_with_recovery(
    ref: jax.Array,
    cfg: SplatConfig,
    iterations: int,
    checkpointer,
    render_fn: Optional[RenderFn] = None,
    checkpoint_every: int = 100,
    max_recoveries: int = 3,
    lr_backoff: float = 0.5,
    log_every: int = 0,
    log_fn=print,
):
    """Failure-tolerant fitting: the reference hard-aborts on non-finite
    parameters (main.cpp:752-785); here the NaN tripwire triggers a restore
    from the latest checkpoint with the learning rate backed off (a divergent
    step replayed identically would fault identically), up to
    ``max_recoveries`` times.

    Returns (state, history, n_recoveries).
    """
    state = init_train_state(cfg)
    step0, state = checkpointer.restore_latest(state)
    done = step0 or 0
    recoveries = 0
    history = []

    def ckpt(s, it):
        checkpointer.save(done + it, s, cfg)

    while done < iterations:
        try:
            state, hist = fit(
                ref, cfg, iterations - done, render_fn=render_fn, state=state,
                log_every=log_every, log_fn=log_fn,
                checkpoint_every=checkpoint_every, checkpoint_fn=ckpt)
            for rec in hist:
                rec["iter"] += done
            history.extend(hist)
            done = iterations
        except FloatingPointError:
            recoveries += 1
            if recoveries > max_recoveries:
                raise
            cfg = cfg.replace(learning_rate=cfg.learning_rate * lr_backoff)
            step0, state = checkpointer.restore_latest(init_train_state(cfg))
            restored = step0 or 0
            if log_fn:
                log_fn(f"non-finite parameters: restored checkpoint "
                       f"{restored}, lr backed off to {cfg.learning_rate}")
            done = restored
    checkpointer.save(iterations, state, cfg)
    return state, history, recoveries


def make_batched_train_step_fused(cfg: SplatConfig):
    """Multi-image single-device train step: the production tile step
    mapped over the batch with a sequential ``jax.lax.map``.

    State is batched (B, N, ...) (see parallel.sharded.init_batched_state);
    targets are pre-padded (B, 1, 3, Hp, Wp). Each image owns an independent
    splat population (the data-parallel axis collapsed onto one device).
    The body is the production ``_fused_step_body`` per image (flat needs
    the capacity from ``tune_binning``, sized on the init population which
    is identical across images; per-image divergence past the tuning
    margin surfaces in n_dropped, never silently).
    """
    if _needs_split(cfg):
        raise ValueError(
            "flat capacity exceeds the single-program budget "
            f"(SPLIT_STEP_ROWS={SPLIT_STEP_ROWS}); batch fitting at this "
            "scale should run images separately (or on a data-axis mesh)")
    one_step = _fused_step_body(cfg)

    def body(state: TrainState, refs_chw: jax.Array):
        def img(t):
            params, opt, ref_chw = t
            st, aux = one_step(TrainState(params=params, opt=opt), ref_chw)
            return st.params, st.opt, aux.mse, aux.n_dropped

        params, opt, mse, n_drop = jax.lax.map(
            img, (state.params, state.opt, refs_chw))
        finite = jnp.all(
            jnp.array(
                [jnp.all(jnp.isfinite(leaf)) for leaf in jax.tree.leaves(params)]
            )
        )
        return TrainState(params=params, opt=opt), StepAux(
            mse=mse, psnr=psnr_from_mse(mse),
            all_finite=jnp.broadcast_to(finite, mse.shape),
            n_dropped=jnp.sum(n_drop))

    train_step = jax.jit(body)
    train_step.body = body
    return train_step


def make_fit_scan_batched(cfg: SplatConfig, with_grad_mag: bool = False):
    """On-device multi-iteration batched fitter: ``lax.scan`` of the
    lax.map'd tile step (one device program fits B independent images for
    n_iters iterations, matching make_fit_scan_fused's contract).

    ``cfg.rebin_margin`` > 0 carries a per-image lazy-rebinning cache in
    the scan state (flat layout): under ``lax.map`` the rebin ``lax.cond``
    stays a real cond per image (vmap would degrade it to a both-branches
    select).

    ``with_grad_mag`` sums each image's (N,) densification signal in the
    scan carry (returned as the aux's (B, N) pos_grad_mag, matching
    make_fit_scan_fused's contract) -- the batched adaptive-density
    driver (train/densify.py::fit_adaptive_batched) feeds it to the
    vmapped densify/prune."""
    if _needs_split(cfg):
        raise ValueError(
            "flat capacity exceeds the single-program budget; see "
            "make_batched_train_step_fused")
    one_step = _fused_step_body(cfg, with_grad_mag)
    cached = getattr(one_step, "cached", None)

    @functools.partial(jax.jit, static_argnames=("n_iters",))
    def fit_k(state: TrainState, refs_chw: jax.Array, n_iters: int):
        b = refs_chw.shape[0]
        caches0 = jax.lax.map(one_step.make_bin_cache, state.params) \
            if cached is not None else jnp.zeros((b,), jnp.int32)
        accum0 = jnp.zeros((b, cfg.n_splats), jnp.float32) \
            if with_grad_mag else 0

        def body(carry, _):
            st, acc, caches = carry

            def img(t):
                params, opt, ref_chw, cache = t
                st_i = TrainState(params=params, opt=opt)
                if cached is not None:
                    new_st, aux, cache = cached(st_i, ref_chw, cache)
                else:
                    new_st, aux = one_step(st_i, ref_chw)
                return (new_st.params, new_st.opt, aux.mse, aux.n_dropped,
                        aux.rebinned, aux.pos_grad_mag, cache)

            params, opt, mse, n_drop, reb, gm, caches = jax.lax.map(
                img, (st.params, st.opt, refs_chw, caches))
            if with_grad_mag:
                acc = acc + gm
            finite = jnp.all(jnp.array(
                [jnp.all(jnp.isfinite(leaf))
                 for leaf in jax.tree.leaves(params)]))
            aux = StepAux(
                mse=mse, psnr=psnr_from_mse(mse),
                all_finite=jnp.broadcast_to(finite, mse.shape),
                n_dropped=jnp.sum(n_drop),
                rebinned=jnp.max(jnp.asarray(reb)))
            return (TrainState(params=params, opt=opt), acc, caches), aux

        (state, accum, _), auxes = jax.lax.scan(
            body, (state, accum0, caches0), None, length=n_iters)
        if with_grad_mag:
            auxes = auxes._replace(pos_grad_mag=accum)
        return state, auxes

    return fit_k
