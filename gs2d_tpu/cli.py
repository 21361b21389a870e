"""Command-line fitting app: the reference's GUI loop, headless.

Replaces the reference's interactive shell (main.cpp:236-856): target-image
ingestion, the restartable fitting loop, per-iteration metrics, render dumps
(instead of texture uploads), checkpoint/resume (instead of RAM-only state),
and optional debug-overlay output (instead of the live eigen-axis display).

Usage:
  python -m gs2d_tpu.fit assets/squirrel_cls_mini.jpg --splats 1024 \
      --iters 2000 --out runs/squirrel --checkpoint-every 500
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gs2d_tpu.fit",
        description="Fit 2D Gaussian splats to a target image.")
    p.add_argument("image", nargs="+",
                   help="target image path(s); more than one runs the "
                        "batched multi-image fit (one independent splat "
                        "population per image -- BASELINE configs[4]; all "
                        "images must share dimensions)")
    p.add_argument("--splats", type=int, default=1024,
                   help="population size (reference default 1024)")
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--out", default="runs/fit", help="output directory")
    p.add_argument("--renderer", choices=["auto", "tiles", "scan"],
                   default="auto",
                   help="tiles (= auto) is the production tile step: the "
                        "Pallas-Triton kernel on a GPU, the plain XLA tile "
                        "path elsewhere; scan is the whole-image reference "
                        "renderer")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--lr-decay-iters", type=int, default=0,
                   help="decay lr exponentially to --lr-final over this many "
                        "iterations, then hold (0 = constant lr, the "
                        "reference behavior)")
    p.add_argument("--lr-final", type=float, default=0.005)
    p.add_argument("--optimize-opacity", action="store_true",
                   help="update opacity too (reference toggle, default off)")
    p.add_argument("--exact-exp", action="store_true",
                   help="exact exp instead of the (1+x/8)^8 approximation")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --out")
    p.add_argument("--recover", action="store_true",
                   help="on non-finite parameters, restore the latest "
                        "checkpoint with halved lr instead of aborting")
    p.add_argument("--save-render-every", type=int, default=0)
    p.add_argument("--densify-every", type=int, default=0,
                   help="run densify/prune every N iterations (0 = off)")
    p.add_argument("--reorder-every", type=int, default=0,
                   help="re-sort splats along the Morton curve every N "
                        "iterations (improves binning locality at large N; "
                        "changes the compositing order)")
    p.add_argument("--scan-chunk", type=int, default=0,
                   help="run iterations in on-device lax.scan blocks of this "
                        "size (0 = one dispatch per iteration); removes host "
                        "round-trips")
    p.add_argument("--max-per-tile", type=int, default=0,
                   help="per-tile splat capacity of the dense layout")
    p.add_argument("--tile-h", type=int, default=0,
                   help="pixel-tile height of the tiles renderer (0 = the "
                        "production tile shape, tiles.PRODUCTION_TILE)")
    p.add_argument("--binning", choices=["auto", "dense", "flat"],
                   default="auto",
                   help="tile binning layout: flat = the GPU kernel's pair "
                        "list, dense = the plain XLA path's per-tile lists; "
                        "auto = flat on a GPU, dense elsewhere")
    p.add_argument("--rebin-margin", type=float, default=0.0,
                   help="lazy rebinning: bin with this many pixels of "
                        "footprint slack and reuse the binning across scan "
                        "steps until a splat escapes it (flat layout + "
                        "--scan-chunk only; 0 = rebin every step; "
                        "-1 = auto from measured pair inflation)")
    p.add_argument("--opacity-cull", type=float, default=0.0,
                   nargs="?", const=1.0 / 256.0, metavar="ALPHA",
                   help="opacity-adaptive footprint culling: skip "
                        "(splat, tile) pairs whose every pixel alpha "
                        "would fall below ALPHA (bare flag = 1/256, the "
                        "reference's early-out constant). Lossy by < "
                        "ALPHA/pixel/pair; pays on trained or reset "
                        "opacities (op < 0.35)")
    p.add_argument("--mesh", default="",
                   help="data,tile,splat axis sizes for multi-device runs "
                        "(e.g. 1,2,4); empty = single device")
    p.add_argument("--opacity-reset-every", type=int, default=0,
                   help="cap opacities at 0.3 and zero their Adam moments "
                        "every N iterations (3DGS floater control; needs "
                        "--optimize-opacity and --densify-every)")
    p.add_argument("--ssim", type=float, default=0.0, metavar="LAMBDA",
                   help="mix lambda*(1-SSIM) into the objective (0 = pure "
                        "L2, the reference objective); runs on the modular "
                        "custom-VJP path")
    p.add_argument("--profile", action="store_true",
                   help="print phase timing summary at the end")
    return p


def _final_render(params, cfg):
    """The production render of a fitted population, with capacities
    measured on that population (the fit's own may predate densify)."""
    from gs2d_tpu.ops import render_tiles as rt

    cfg = rt.tune_binning(params, cfg.replace(flat_capacity=None,
                                              max_splats_per_tile=None))
    return rt.production_render(params, cfg)


def _fit_batch(args, cfg, refs, logger) -> int:
    """Batched multi-image fit (BASELINE configs[4] shape): one independent
    splat population per image on one device (`--mesh` with a data axis
    spreads the same computation across devices via fit_sharded instead)."""
    import time

    import jax
    import jax.numpy as jnp

    from gs2d_tpu.io.image import save_image
    from gs2d_tpu.ops import render_tiles as rt
    from gs2d_tpu.ops import tiles as tl
    from gs2d_tpu.parallel.sharded import init_batched_state
    from gs2d_tpu.train.loop import init_train_state, \
        make_batched_train_step_fused, make_fit_scan_batched

    # Never silently drop a flag that changes the objective, the
    # trajectory, or durability: the sharded driver composes all of these
    # with multi-image fitting.
    for flag in ("mesh", "resume", "recover", "checkpoint_every", "ssim",
                 "reorder_every", "save_render_every"):
        if getattr(args, flag):
            print(f"error: --{flag.replace('_', '-')} is not supported with "
                  "the single-chip multi-image batch fitter; use "
                  "--mesh 1,1,1 (fit_sharded composes multi-image with "
                  "checkpoint/resume, ssim, and densify)")
            return 2
    b = len(refs)
    p0 = init_train_state(cfg).params
    if cfg.rebin_margin < 0:
        cfg = tl.tune_rebin_margin(p0, cfg)
    if args.densify_every:
        # Assembled configs[4]: B images x adaptive density per image.
        from gs2d_tpu.train.densify import fit_adaptive_batched

        t0 = time.perf_counter()
        state, hist = fit_adaptive_batched(
            refs, cfg, iterations=args.iters,
            densify_every=args.densify_every,
            scan_chunk=max(args.scan_chunk, 1), log_every=args.log_every,
            log_fn=print, opacity_reset_every=args.opacity_reset_every)
        for rec in hist:
            logger.log(**rec)
        total = time.perf_counter() - t0
        print(f"fit {b} images x {args.iters} adaptive iters in "
              f"{total:.2f}s ({args.iters / total:.1f} batched iters/s)")
        for i in range(b):
            img = _final_render(
                jax.tree.map(lambda x: x[i], state.params), cfg)
            save_image(os.path.join(args.out, f"render_final_{i:02d}.png"),
                       jax.device_get(img))
        logger.close()
        return 0
    # Statics sized on the (shared) init population; per-image divergence
    # past the margin surfaces in n_dropped.
    cfg = rt.tune_binning(p0, cfg)
    refs_chw = jnp.stack([rt.pad_ref_chw(jnp.asarray(r), cfg) for r in refs])
    state = init_batched_state(cfg, b)
    t0 = time.perf_counter()
    aux = None
    if args.scan_chunk and args.scan_chunk > 1:
        fit_k = make_fit_scan_batched(cfg)
        done = 0
        while done < args.iters:
            n = min(args.scan_chunk, args.iters - done)
            state, auxes = fit_k(state, refs_chw, n)
            if not bool(jax.device_get(auxes.all_finite).all()):
                raise FloatingPointError(
                    f"non-finite splat parameters in block at {done}")
            mse_block = jax.device_get(auxes.mse)
            for j in range(n):
                it = done + j
                if args.log_every and (it % args.log_every == 0
                                       or it == args.iters - 1):
                    mse = [float(x) for x in mse_block[j]]
                    logger.log(iter=it, mse=mse)
                    print(f"{it} itr, mse "
                          + " ".join(f"{m:.2f}" for m in mse))
            done += n
        jax.block_until_ready(state.params.pos)
    else:
        step = make_batched_train_step_fused(cfg)
        for it in range(args.iters):
            state, aux = step(state, refs_chw)
            if args.log_every and (it % args.log_every == 0
                                   or it == args.iters - 1):
                if not bool(aux.all_finite.all()):
                    raise FloatingPointError(
                        f"non-finite splat parameters at iteration {it}")
                mse = [float(x) for x in jax.device_get(aux.mse)]
                logger.log(iter=it, mse=mse)
                print(f"{it} itr, mse " + " ".join(f"{m:.2f}" for m in mse))
        jax.block_until_ready(state.params.pos)
    total = time.perf_counter() - t0
    print(f"fit {b} images x {args.iters} iters in {total:.2f}s "
          f"({args.iters / total:.1f} batched iters/s)")
    for i in range(b):
        img = _final_render(jax.tree.map(lambda x: x[i], state.params), cfg)
        save_image(os.path.join(args.out, f"render_final_{i:02d}.png"),
                   jax.device_get(img))
    logger.close()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax
    import jax.numpy as jnp

    import gs2d_tpu
    gs2d_tpu.enable_compilation_cache()

    from gs2d_tpu import backend
    from gs2d_tpu.config import SplatConfig
    from gs2d_tpu.io.checkpoint import Checkpointer
    from gs2d_tpu.io.image import load_image, save_image
    from gs2d_tpu.ops import render_jax
    from gs2d_tpu.ops import render_tiles as rt
    from gs2d_tpu.train.loop import fit, init_train_state
    from gs2d_tpu.utils.profiling import JsonlLogger, ThroughputCounter

    print(backend.describe())

    refs = [load_image(path) for path in args.image]
    h, w = refs[0].shape[:2]
    if any(r.shape != refs[0].shape for r in refs):
        print("error: multi-image batch fitting requires equal dimensions")
        return 2
    ref = refs[0]
    cfg = SplatConfig(
        width=w, height=h, n_splats=args.splats,
        learning_rate=args.lr,
        lr_final=args.lr_final, lr_decay_iters=args.lr_decay_iters,
        optimize_opacity=args.optimize_opacity,
        use_exp_approx=not args.exact_exp,
        max_splats_per_tile=args.max_per_tile or None,
        binning=args.binning,
        rebin_margin=args.rebin_margin,
        opacity_cull_alpha=args.opacity_cull,
    )
    from gs2d_tpu.ops.tiles import tune_tile_shape

    cfg = tune_tile_shape(cfg)
    if args.tile_h:
        cfg = cfg.replace(tile_h=args.tile_h)
    refj = jnp.asarray(ref)

    use_tiles = args.renderer != "scan"
    if use_tiles:
        # Production-layout differentiable render (cfg.binning):
        # perceptual heads (--ssim) autodiff on top of it and still run the
        # production tile path at every scale.
        from gs2d_tpu.params import init_params

        cfg = rt.tune_binning(init_params(cfg), cfg)
        render_fn = rt.production_render
    else:
        render_fn = render_jax.render
    render_final = _final_render if use_tiles else render_jax.render

    os.makedirs(args.out, exist_ok=True)
    logger = JsonlLogger(os.path.join(args.out, "metrics.jsonl"))

    if len(refs) > 1 and not args.mesh:
        return _fit_batch(args, cfg, refs, logger)
    ck = Checkpointer(os.path.join(args.out, "checkpoints")) \
        if (args.checkpoint_every or args.resume) else None

    if args.mesh:
        from gs2d_tpu.parallel.mesh import make_mesh
        from gs2d_tpu.parallel.sharded import fit_sharded, init_batched_state
        for flag in ("reorder_every", "save_render_every", "recover"):
            if getattr(args, flag):
                print(f"error: --{flag.replace('_', '-')} is not supported "
                      "on the mesh path")
                return 2
        data, tile, splat = (int(x) for x in args.mesh.split(","))
        mesh = make_mesh(data=data, tile=tile, splat=splat)
        # Multi-image + mesh: the batch IS the data axis (each image an
        # independent population; the configs[4] shape end-to-end).
        refs_b = jnp.stack([jnp.asarray(r) for r in refs])
        if refs_b.shape[0] % data:
            print(f"error: batch of {refs_b.shape[0]} images does not "
                  f"divide over data axis {data}")
            return 2
        state_b = None
        if args.resume and ck is not None:
            step, state_b = ck.restore_latest(
                init_batched_state(cfg, refs_b.shape[0]))
            if step is None:
                print(f"error: --resume found no checkpoint under "
                      f"{os.path.join(args.out, 'checkpoints')}")
                return 2
            print(f"resumed from checkpoint step {step}")
        ckpt_fn = (lambda s, it: ck.save(it, s, cfg)) \
            if (ck is not None and args.checkpoint_every) else None
        state_b, hist = fit_sharded(
            refs_b, cfg, mesh, iterations=args.iters,
            state=state_b, log_every=args.log_every,
            renderer="tiles" if use_tiles else "scan",
            ssim_lambda=args.ssim, scan_chunk=args.scan_chunk,
            densify_every=args.densify_every,
            checkpoint_every=args.checkpoint_every, checkpoint_fn=ckpt_fn)
        for rec in hist:
            logger.log(**rec)
        for i in range(refs_b.shape[0]):
            img = render_final(
                jax.tree.map(lambda x: x[i], state_b.params), cfg)
            name = "render_final.png" if refs_b.shape[0] == 1 \
                else f"render_final_{i:02d}.png"
            save_image(os.path.join(args.out, name), jax.device_get(img))
        logger.close()
        print(f"done (sharded over {mesh.shape})")
        return 0

    state = init_train_state(cfg)
    start_iter = 0
    if args.resume and ck is not None:
        step, state = ck.restore_latest(state)
        if step is None:
            # Silently starting over would discard the run the user asked
            # to continue (and overwrite its artifacts at the end).
            print(f"error: --resume found no checkpoint under "
                  f"{os.path.join(args.out, 'checkpoints')}")
            return 2
        start_iter = step
        print(f"resumed from checkpoint step {step}")

    if args.recover:
        from gs2d_tpu.train.loop import fit_with_recovery
        if ck is None:
            ck = Checkpointer(os.path.join(args.out, "checkpoints"))
        state, hist, n_rec = fit_with_recovery(
            refj, cfg, args.iters, ck, render_fn=render_fn,
            checkpoint_every=args.checkpoint_every or 100,
            log_every=args.log_every)
        for rec in hist:
            logger.log(**rec)
        img = render_final(state.params, cfg)
        save_image(os.path.join(args.out, "render_final.png"),
                   jax.device_get(img))
        print(f"done ({n_rec} recoveries)")
        return 0

    tc = ThroughputCounter(h, w, args.splats)
    t_start = time.perf_counter()
    it_done = [start_iter]

    def log_fn(msg):
        print(msg)

    def on_ckpt(state, it):
        # ``it`` is block-relative (fit() restarts at 0 each densify block);
        # it_done[0] tracks the global iteration across blocks and resume.
        ck.save(it_done[0] + it, state, cfg)

    if args.densify_every and use_tiles and (args.ssim or
                                              args.checkpoint_every):
        # fit_adaptive hard-codes the fused L2 objective and takes no
        # checkpoint hook; silently dropping either flag would hand the
        # user pure-L2 training / no checkpoints. Fall back to the modular
        # fit() block path below, which honors both.
        print("note: --densify-every with --ssim/--checkpoint-every uses "
              "the modular (non-fused) block path")
        use_adaptive = False
    else:
        use_adaptive = bool(args.densify_every and use_tiles)
    if use_adaptive:
        # Production adaptive-density path: the densify signal accumulates
        # on device inside the train step (no extra render/grad passes).
        from gs2d_tpu.train.densify import fit_adaptive

        state, hist = fit_adaptive(
            refj, cfg, iterations=args.iters,
            densify_every=args.densify_every, state=state,
            scan_chunk=args.scan_chunk, log_every=args.log_every,
            log_fn=log_fn, reorder_every=args.reorder_every,
            opacity_reset_every=args.opacity_reset_every)
        for rec in hist:
            rec["iter"] += it_done[0]
            logger.log(**rec)
        it_done[0] += args.iters
        remaining = 0
    else:
        remaining = args.iters
    block = remaining
    # Renders are dumped at block boundaries, so every N-iteration cadence
    # (densify, reorder, mid-fit render) bounds the block size.
    for every in (args.densify_every, args.reorder_every,
                  args.save_render_every):
        if every:
            block = min(block, every)
    while remaining > 0:
        n = min(block, remaining)
        state, hist = fit(
            refj, cfg, iterations=n, render_fn=render_fn, state=state,
            log_every=args.log_every, log_fn=log_fn,
            checkpoint_every=args.checkpoint_every,
            checkpoint_fn=on_ckpt if ck else None,
            use_fused=use_tiles, scan_chunk=args.scan_chunk,
            ssim_lambda=args.ssim, iter_offset=it_done[0])
        for rec in hist:
            logger.log(**rec)
        it_done[0] += n
        remaining -= n
        if remaining > 0 and args.densify_every \
                and it_done[0] % args.densify_every == 0:
            from gs2d_tpu.ops.render_jax import l2_loss
            from gs2d_tpu.train.densify import densify_and_prune
            g = jax.grad(l2_loss)(state.params, refj, cfg)
            mag = jnp.linalg.norm(g.pos, axis=-1)
            state = densify_and_prune(state, mag, cfg, seed=it_done[0])
            print(f"densify/prune at iter {it_done[0]}")
        if remaining > 0 and args.reorder_every \
                and it_done[0] % args.reorder_every == 0:
            from gs2d_tpu.train.reorder import reorder_state
            state = reorder_state(state, cfg)
            print(f"morton reorder at iter {it_done[0]}")
        if args.save_render_every \
                and it_done[0] % args.save_render_every == 0:
            img = render_final(state.params, cfg)
            save_image(os.path.join(args.out, f"render_{it_done[0]:06d}.png"),
                       jax.device_get(img))

    total = time.perf_counter() - t_start
    rates = tc.rates(total / max(args.iters, 1))
    print(f"fit {args.iters} iters in {total:.2f}s "
          f"({rates['iters_per_s']:.1f} iters/s)")
    logger.log(event="done", seconds=total, **rates)

    img = render_final(state.params, cfg)
    save_image(os.path.join(args.out, "render_final.png"), jax.device_get(img))
    if ck is not None:
        ck.save(start_iter + args.iters, state, cfg)
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
