#!/usr/bin/env python
"""On-card check of the production path: one GPU, one process.

Phases (any failed check stops the run with a non-zero exit):

(a) Device: JAX must run on a GPU; prints the card (nvidia-smi), the JAX
    version and XLA_FLAGS.
(b) Kernel against reference: the Pallas-Triton tile kernel
    (ops/render_gpu.py) and the plain XLA tile path (ops/render_tiles.py)
    each render and differentiate a seeded random population, and the
    forward image and all nine gradient arrays are compared with the scan
    reference (ops/render_jax.py, einsums at precision HIGHEST) at
    268x213/1 024, 535x426/10 240 and 1920x1080/100 000 splats.
(c) Main path: the CLI (gs2d_tpu.cli.main) fits the reference workload
    for 200 iterations and must land near the C++ MSE; the CLI fits
    535x426 with 10 240 splats and densify/prune; train.loop.fit runs a
    few fused steps at 1920x1080 with 1 000 000 splats.

With ``--four`` it runs only the four-card path: fit_sharded on a (1,2,2)
mesh at 1920x1080 with 100 000 splats against the one-card fit from the
same initial state.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# Phase (b) tolerances.
# Forward: the color is a front-to-back sum of at most a few hundred f32
# terms, so reassociation and fma contraction move it by ~1e-6; a pixel
# whose transmittance lands within rounding of the 1/256 early-out may take
# one more or one fewer splat, which moves it by at most 1/256. So: max abs
# error <= 1/256 on at most FWD_FLIP_FRAC of the pixels, 1e-4 on the rest.
FWD_TOL = 1e-4
FWD_FLIP_TOL = 1.0 / 256.0
FWD_FLIP_FRAC = 1e-4
# Gradients: max abs error over the array, relative to the array's largest
# magnitude -- the 1e-4 class (sums over up to ~10^4 pixels reassociate).
GRAD_TOL = 1e-4
# Phase (c): MSE-255 of the reference workload at iteration 200 against the
# C++ loop's 109.18 (BASELINE.md). f32 rounding differences from the C++
# loop compound over 200 Adam steps; 1% stays far inside one iteration's
# progress at that point of the fit (~0.5 MSE-255 per iteration).
CPP_MSE_200 = 109.18
MSE_REL_TOL = 0.01
# Phase (b) cases: width, height, splats, bundled target (None: synthetic).
CASES = ((268, 213, 1024, "squirrel_cls_mini.png"),
         (535, 426, 10240, "squirrel_cls.png"),
         (1920, 1080, 100_000, None))
GRAD_NAMES = ("pos_x", "pos_y", "sx", "sy", "rot", "color_r", "color_g",
              "color_b", "opacity")


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def phase_device():
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX finds no GPU (platform {devs[0].platform!r})")
    print(f"card: {card()}")
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"devices: {devs[0].platform} {devs[0].device_kind} x{len(devs)}")
    return devs


def random_params(n, w, h, seed=0):
    """A seeded, well-conditioned random population (tests/helpers.py)."""
    import numpy as np

    from gs2d_tpu.params import GaussianParams

    rng = np.random.default_rng(seed)
    f32 = np.float32
    return GaussianParams(
        pos=np.stack([rng.uniform(-3, w + 3, n), rng.uniform(-3, h + 3, n)],
                     -1).astype(f32),
        sx=rng.uniform(1.5, 12.0, n).astype(f32),
        sy=rng.uniform(1.5, 12.0, n).astype(f32),
        rot=rng.uniform(0.0, np.pi, n).astype(f32),
        color=rng.uniform(0.0, 1.0, (n, 3)).astype(f32),
        opacity=rng.uniform(0.3, 1.0, n).astype(f32))


def grad_arrays(g):
    return (g.pos[:, 0], g.pos[:, 1], g.sx, g.sy, g.rot, g.color[:, 0],
            g.color[:, 1], g.color[:, 2], g.opacity)


def compare(label, color, grads, c_ref, g_ref):
    import numpy as np

    err = np.abs(np.asarray(color) - np.asarray(c_ref))
    big = float((err > FWD_TOL).mean())
    print(f"  {label} forward: max abs {err.max():.3e} "
          f"(tol {FWD_FLIP_TOL:.3e} on <= {FWD_FLIP_FRAC:g} of pixels, "
          f"{FWD_TOL:.0e} elsewhere), rel {err.max() / max(1e-30, float(np.abs(c_ref).max())):.3e}, "
          f"pixels above {FWD_TOL:.0e}: {big:.2e}")
    check(err.max() <= FWD_FLIP_TOL and big <= FWD_FLIP_FRAC,
          f"{label} forward differs from the reference")
    for name, a, b in zip(GRAD_NAMES, grad_arrays(grads), grad_arrays(g_ref)):
        a, b = np.asarray(a), np.asarray(b)
        abs_err = float(np.abs(a - b).max())
        rel = abs_err / max(1e-30, float(np.abs(b).max()))
        print(f"  {label} d/d{name}: max abs {abs_err:.3e}, "
              f"rel {rel:.3e} (tol {GRAD_TOL:.0e})")
        check(np.isfinite(a).all() and rel <= GRAD_TOL,
              f"{label} gradient d/d{name} differs from the reference")


def phase_kernel_vs_reference():
    for case in CASES:
        check_case(*case)


def check_case(w, h, n, asset):
    """Kernel and plain path against the scan reference on one case."""
    import jax
    import jax.numpy as jnp

    from gs2d_tpu.config import SplatConfig
    from gs2d_tpu.io.image import load_asset, synthetic_target
    from gs2d_tpu.ops import render_gpu as rg
    from gs2d_tpu.ops import render_tiles as rt
    from gs2d_tpu.ops import tiles as tl
    from gs2d_tpu.ops import tiles_flat as tlf
    from gs2d_tpu.ops.render_jax import render_backward, render_forward
    from gs2d_tpu.ops.tiles import tune_tile_shape

    print(f"(b) {w}x{h}, {n} splats")
    ref = jnp.asarray(load_asset(asset) if asset
                      else synthetic_target(h, w))
    p = jax.tree.map(jnp.asarray, random_params(n, w, h))
    cfg = tune_tile_shape(SplatConfig(width=w, height=h, n_splats=n))

    @jax.jit
    def reference(p):
        c, _ = render_forward(p, cfg)
        return c, render_backward(p, c, c - ref, cfg)

    c_ref, g_ref = reference(p)

    kcfg = rt.tune_binning(p, cfg.replace(binning="flat"))
    refc = rt.pad_ref_chw(ref, kcfg)

    @jax.jit
    def kernel(p):
        b = tlf.bin_splats_flat(p, kcfg, kcfg.flat_capacity)
        c, g = rg.l2_render_and_grads_flat(b, refc, n, kcfg, p)
        return c, g, b.n_dropped

    pcfg = rt.tune_binning(p, cfg.replace(binning="dense"))

    @jax.jit
    def plain(p):
        b = tl.bin_splats(p, pcfg, pcfg.max_splats_per_tile)
        c, g = rt.l2_render_and_grads(b, refc, n, pcfg, p)
        return c, g, b.n_dropped

    for label, fn in (("kernel", kernel), ("plain", plain)):
        color, grads, dropped = fn(p)
        check(int(dropped) == 0, f"{label} binning dropped pairs")
        compare(label, color, grads, c_ref, g_ref)


def phase_main_path():
    import jax
    import jax.numpy as jnp

    from gs2d_tpu import cli
    from gs2d_tpu.config import SplatConfig
    from gs2d_tpu.io.image import synthetic_target
    from gs2d_tpu.ops.tiles import tune_tile_shape
    from gs2d_tpu.train.loop import fit

    here = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="chip_smoke_")

    def cli_fit(name, args):
        run = os.path.join(out, name)
        t0 = time.perf_counter()
        rc = cli.main(args + ["--out", run])
        check(rc == 0, f"CLI {name} exited {rc}")
        with open(os.path.join(run, "metrics.jsonl")) as fh:
            recs = [json.loads(line) for line in fh]
        print(f"  CLI {name}: {time.perf_counter() - t0:.1f} s wall "
              "(compile included; information only)")
        return [r for r in recs if "mse" in r]

    print("(c) CLI, reference workload 268x213, 1024 splats, 200 iters")
    recs = cli_fit("mini", [
        os.path.join(here, "assets", "squirrel_cls_mini.png"),
        "--splats", "1024", "--iters", "200", "--scan-chunk", "100",
        "--log-every", "50"])
    mse200 = next(r["mse"] for r in recs if r["iter"] == 199)
    rel = abs(mse200 - CPP_MSE_200) / CPP_MSE_200
    print(f"  MSE-255 at iteration 200: {mse200:.4f} vs C++ {CPP_MSE_200} "
          f"(rel {rel:.2e}, tol {MSE_REL_TOL:.0e})")
    check(rel <= MSE_REL_TOL, "mini fit MSE at iteration 200 off the C++")

    print("(c) CLI, 535x426, 10240 splats, densify/prune")
    recs = cli_fit("densify", [
        os.path.join(here, "assets", "squirrel_cls.png"),
        "--splats", "10240", "--iters", "60", "--densify-every", "20",
        "--scan-chunk", "20", "--log-every", "20"])
    first, last = recs[0]["mse"], recs[-1]["mse"]
    print(f"  MSE-255 {first:.2f} -> {last:.2f}")
    check(last == last and last < first, "densify fit did not lower the MSE")

    print("(c) train.loop.fit, 1920x1080, 1000000 splats, fused steps")
    cfg = tune_tile_shape(SplatConfig(width=1920, height=1080,
                                      n_splats=1_000_000))
    ref = jnp.asarray(synthetic_target(1080, 1920))
    t0 = time.perf_counter()
    _, hist = fit(ref, cfg, iterations=6, log_every=1, log_fn=None,
                  use_fused=True)
    mses = [r["mse"] for r in hist]
    drops = [r["n_dropped"] for r in hist]
    steps = [b["elapsed_s"] - a["elapsed_s"] for a, b in zip(hist, hist[1:])]
    print(f"  MSE-255 per step: {[round(m, 3) for m in mses]}; n_dropped "
          f"{drops}")
    print(f"  step time (host clock, information only): "
          f"{sorted(steps)[len(steps) // 2] * 1e3:.1f} ms median of "
          f"{len(steps)}; total {time.perf_counter() - t0:.1f} s with compile")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak device memory (information only): "
          f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB")
    check(all(m == m and m < float("inf") for m in mses),
          "1M fit not finite")
    check(all(d == 0 for d in drops), "1M fit dropped pairs")
    check(mses[-1] < mses[0], "1M fit did not lower the MSE")


def phase_four():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gs2d_tpu.config import SplatConfig
    from gs2d_tpu.io.image import synthetic_target
    from gs2d_tpu.ops import render_tiles as rt
    from gs2d_tpu.ops.tiles import tune_tile_shape
    from gs2d_tpu.parallel.mesh import make_mesh
    from gs2d_tpu.parallel.sharded import fit_sharded, init_batched_state
    from gs2d_tpu.train.loop import fit

    check(len(jax.devices()) >= 4, f"--four needs 4 GPUs, found "
          f"{len(jax.devices())}")
    w, h, n, iters = 1920, 1080, 100_000, 4
    cfg = tune_tile_shape(SplatConfig(width=w, height=h, n_splats=n))
    ref = synthetic_target(h, w)
    state0 = init_batched_state(cfg, 1)
    one0 = jax.tree.map(lambda x: x[0], state0)

    print("(four) fit_sharded on mesh (1,2,2), 1920x1080, 100000 splats")
    t0 = time.perf_counter()
    _, hist_s = fit_sharded(ref[None], cfg, make_mesh(1, 2, 2), iters,
                            state=state0, log_every=1, log_fn=None,
                            renderer="tiles")
    print(f"  {time.perf_counter() - t0:.1f} s with compile")
    mse_s = np.asarray([r["mse"][0] for r in hist_s])

    # The splat axis runs the composite without the 1/256 early-out (its
    # blend must be associative across shards); the one-card fit with the
    # same setting must agree to rounding...
    print("(four) one-card fit from the same initial state")
    _, hist_1 = fit(jnp.asarray(ref), cfg.replace(min_throughput=0.0), iters,
                    state=one0, log_every=1, log_fn=None, use_fused=True)
    mse_1 = np.asarray([r["mse"] for r in hist_1])
    rel = np.abs(mse_s - mse_1) / mse_1
    print(f"  MSE-255 sharded {mse_s.round(4).tolist()} vs one-card "
          f"{mse_1.round(4).tolist()}: max rel {rel.max():.2e} (tol 1e-4)")
    check(rel.max() <= 1e-4, "sharded fit differs from the one-card fit")

    # ...and turning the early-out off moves the one-card render by at
    # most 1/256 per channel (the documented deviation).
    c_on = rt.production_render(one0.params, rt.tune_binning(one0.params, cfg))
    cfg_off = cfg.replace(min_throughput=0.0)
    c_off = rt.production_render(one0.params,
                                 rt.tune_binning(one0.params, cfg_off))
    dev = float(jnp.abs(c_on - c_off).max())
    print(f"  early-out on vs off: max abs {dev:.3e} (tol {1 / 256:.3e})")
    check(dev <= 1.0 / 256.0 + 1e-6, "early-out deviation above 1/256")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="On-card check of the "
                                 "production path.")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path and its "
                         "comparison")
    args = ap.parse_args(argv)
    try:
        devs = phase_device()
        if args.four:
            phase_four()
        else:
            phase_kernel_vs_reference()
            phase_main_path()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
