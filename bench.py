#!/usr/bin/env python
"""Step time of the production train step on a GPU, kernel against plain.

For each cell (image size, splat count) this times the full train step --
binning, tile forward, backward, gradient segment sum and Adam -- two ways:
``kernel`` (binning "flat": the Pallas-Triton tile kernel,
ops/render_gpu.py) and ``plain`` (binning "dense": the plain XLA scan,
ops/render_tiles.py). Each time is the median of ``--steps`` steps after
compilation, each step ended by ``block_until_ready``.

Needs a GPU: without one it exits non-zero. Prints one JSON line per
(cell, path) and names the card (``nvidia-smi``) and the JAX device first.

Usage: python bench.py [--cells mini,mid,1080p_100k,1080p_1m]
                       [--paths kernel,plain] [--steps 20]
                       [--tile 16x16] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# name -> (width, height, splats, target)
CELLS = {
    "mini": (268, 213, 1024, "squirrel_cls_mini.png"),
    "mid": (535, 426, 10240, "squirrel_cls.png"),
    "1080p_100k": (1920, 1080, 100_000, None),
    "1080p_1m": (1920, 1080, 1_000_000, None),
}
PATHS = {"kernel": "flat", "plain": "dense"}


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def time_cell(cell: str, path: str, steps: int, tile):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gs2d_tpu.config import SplatConfig
    from gs2d_tpu.io.image import load_asset, synthetic_target
    from gs2d_tpu.ops import render_tiles as rt
    from gs2d_tpu.ops.tiles import tune_tile_shape
    from gs2d_tpu.train.loop import init_train_state, make_train_step_fused

    w, h, n, asset = CELLS[cell]
    ref = load_asset(asset) if asset else synthetic_target(h, w)
    cfg = tune_tile_shape(SplatConfig(width=w, height=h, n_splats=n,
                                      binning=PATHS[path]))
    if tile:
        cfg = cfg.replace(tile_h=tile[0], tile_w=tile[1])
    state = init_train_state(cfg)
    t0 = time.perf_counter()
    cfg = rt.tune_binning(state.params, cfg)
    step = make_train_step_fused(cfg)
    refc = rt.pad_ref_chw(jnp.asarray(ref), cfg)
    state, aux = step(state, refc)
    jax.block_until_ready(state)
    setup_s = time.perf_counter() - t0
    mse0 = float(aux.mse)
    times = []
    for _ in range(steps):
        t = time.perf_counter()
        state, aux = step(state, refc)
        jax.block_until_ready(state)
        times.append(time.perf_counter() - t)
    q1, med, q3 = np.percentile(np.asarray(times) * 1e3, [25, 50, 75])
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "cell": cell, "path": path, "width": w, "height": h, "splats": n,
        "tile": [cfg.tile_h, cfg.tile_w], "steps": steps,
        "step_ms_median": float(med), "step_ms_q1": float(q1),
        "step_ms_q3": float(q3), "setup_s": setup_s,
        "mse_first": mse0, "mse_last": float(aux.mse),
        "n_dropped": int(aux.n_dropped),
        "finite": bool(aux.all_finite),
        "flat_capacity": cfg.flat_capacity,
        "max_splats_per_tile": cfg.max_splats_per_tile,
        "peak_bytes": stats.get("peak_bytes_in_use"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--paths", default="kernel,plain")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--tile", default="", help="HxW (default: production)")
    ap.add_argument("--out", default="", help="also append JSON lines here")
    args = ap.parse_args(argv)

    import jax

    import gs2d_tpu

    gs2d_tpu.enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"error: no GPU (JAX runs on {dev.platform!r})",
              file=sys.stderr)
        return 1
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card()}
    print(json.dumps({"device": device}), flush=True)
    tile = tuple(int(x) for x in args.tile.split("x")) if args.tile else None
    for cell in args.cells.split(","):
        for path in args.paths.split(","):
            rec = time_cell(cell, path, args.steps, tile)
            rec["device"] = device
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
