"""Configuration for the 2D Gaussian splatting framework.

Every named constant of the reference implementation is captured here as a
single frozen dataclass (the reference hardcodes them as #defines / literals):

- ``splat_bounds`` / ``min_throughput``: reference main.cpp:7-8
- Adam hyperparameters: reference main.cpp:136-137 (betas), main.cpp:154 (eps),
  main.cpp:715 (learning rate)
- init ranges: reference main.cpp:294-302
- clamp constraints: reference main.cpp:741-749
- default splat count: reference main.cpp:271
- opacity optimization off by default: reference main.cpp:317, 735

The config is a pytree-free static object: it is hashable so it can be passed
as a static argument to ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SplatConfig:
    """Static hyperparameters of the 2D Gaussian splatting fitter."""

    # --- image / workload -------------------------------------------------
    width: int = 268
    height: int = 213
    n_splats: int = 1024  # reference main.cpp:271

    # --- rasterization ----------------------------------------------------
    # Mahalanobis cutoff in units of sigma (reference main.cpp:7).
    splat_bounds: float = 3.0
    # Front-to-back early-termination threshold on transmittance
    # (reference main.cpp:8, 518-521).
    min_throughput: float = 1.0 / 256.0
    # Use the (1+x/8)^8 fast exp (reference main.cpp:49-83). Setting this to
    # False switches to exact exp, the reference's own numerical-validation
    # mode (main.cpp:51).
    use_exp_approx: bool = True

    # --- optimizer (reference-faithful Adam) ------------------------------
    adam_beta1: float = 0.9   # reference main.cpp:136
    adam_beta2: float = 0.99  # reference main.cpp:137
    adam_eps: float = 1.0e-15  # reference main.cpp:154
    learning_rate: float = 0.05  # reference main.cpp:715
    optimize_opacity: bool = False  # reference main.cpp:317 (UI default)
    # Exponential learning-rate decay (net-new; the reference holds lr
    # constant, main.cpp:715). When ``lr_decay_iters`` > 0 the effective rate
    # at optimizer step t is lr * (lr_final/lr)^(min(t,T)/T) -- the 3DGS
    # position-lr schedule generalized to all parameters. Computed on-device
    # from AdamState.step, so one compiled step serves the whole schedule.
    lr_final: float = 0.005
    lr_decay_iters: int = 0

    # --- init ranges (reference main.cpp:294-302) -------------------------
    init_scale_min: float = 6.0
    init_scale_max: float = 10.0
    init_color: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    init_opacity: float = 1.0

    # --- clamp constraints (reference main.cpp:741-749) -------------------
    scale_min: float = 1.0
    scale_max: float = 1024.0
    opacity_min: float = 0.1
    opacity_max: float = 1.0

    # --- production rasterizer (net-new, tile pipeline) -------------------
    # Pixel tile shape. The GPU kernel runs one program per tile on
    # tile_h * tile_w pixels, which must be a power of two; production
    # entry points pick the shape with tiles.tune_tile_shape.
    tile_h: int = 8
    tile_w: int = 128
    # Per-tile splat list capacity of the dense layout; None picks a
    # heuristic from the workload at bin time.
    max_splats_per_tile: Optional[int] = None
    # Cap on tiles per splat in the dense binning expansion (bbox rows x
    # cols); larger splats get a row-major-truncated bbox, counted in
    # TileBinning.n_dropped.
    max_tiles_per_splat: int = 32
    # Exact-ellipse tile culling in binning (net-new): drop (splat, tile)
    # pairs whose Mahalanobis ellipse provably cannot touch any pixel the
    # rasterizer would walk on that tile (conservative ellipse-rect
    # separation, tiles.tile_may_touch). The reference bins nothing
    # (splat-major walk, main.cpp:489-509). Culled pairs contribute exactly
    # nothing.
    exact_cull: bool = True
    # Lazy rebinning (net-new): when > 0, the scan fitter bins with this
    # many pixels of footprint slack and reuses the binning across steps
    # until some splat's exact footprint escapes its slack
    # (tiles.pairs_covered_by -- an exact, conservative test). Superset
    # pairs contribute exactly nothing mathematically, so trajectories
    # match per-step rebinning (to <= 1 ulp/step of excess-precision
    # slot-shift noise). 0 disables (bin every step). The flat layout
    # honors it (margined superset pair rows, train/loop.py); -1 on the CLI
    # auto-tunes the margin from measured pair inflation. dense always
    # rebins.
    rebin_margin: float = 0.0
    # Opacity-adaptive footprint culling (net-new): when > 0, a splat's
    # BINNED footprint shrinks from the geometric 3-sigma ellipse to the
    # region where it can still deposit alpha >= this threshold. alpha =
    # op * G with G <= exp(-q/2) (the fast exp underestimates the true
    # exp, so the bound is conservative), hence every pixel with alpha >=
    # t satisfies q <= 2*ln(op/t). That is TIGHTER than the reference's
    # fixed 3-sigma bound (q <= 9) exactly when op < e^4.5 * t (op < 0.35
    # at the 1/256 default) -- i.e. on populations with trained or reset
    # opacities, where it prunes (splat, tile) pairs whose every pixel
    # contribution is below the threshold. Those pairs ARE composited by
    # the reference (its per-pair alpha has no floor; only the cumulative
    # T < 1/256 early-out, main.cpp:8), so this is lossy-by-epsilon:
    # each dropped pair changes a pixel by < t pre-transmittance. Off by
    # default; bitwise parity tests must keep it off. Margined
    # (lazy-rebinning) binnings double the opacity headroom so cached
    # pair sets survive opacity growth up to 2x between rebins
    # (tiles._bbox_and_quad; the pairs_covered_by tripwire catches any
    # escape exactly). 1/256 matches the early-out constant.
    opacity_cull_alpha: float = 0.0

    # --- binning layout (net-new; gs2d_tpu/backend.py) ---------------------
    # "flat": the flat pair list (ops/tiles_flat.py) walked by the
    #   Pallas-Triton kernel (ops/render_gpu.py) -- GPU only.
    # "dense": padded (n_tiles, K) lists (ops/tiles.py) and the plain XLA
    #   scan (ops/render_tiles.py) -- any platform.
    # "auto": flat on a GPU, dense elsewhere (backend.resolve_binning).
    binning: str = "auto"
    # Total pair rows of the flat layout (static; set by
    # tiles_flat.tune_flat_config from measured counts).
    flat_capacity: Optional[int] = None
    # Run the Triton kernel in Pallas interpret mode (tests on the CPU).
    # Never chosen from the platform: the caller asks for it.
    interpret: bool = False
    # Round the tile grid's row count up to a multiple of this. Tile-axis
    # sharding needs every device band to be whole tile rows, so
    # fit_sharded sets it to the tile-axis size when the image's natural
    # grid doesn't divide. Extra rows are ordinary padding: outside-image
    # pixels never composite, so results are identical.
    tile_rows_multiple: int = 1

    @property
    def image_shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def cutoff_sq(self) -> float:
        return self.splat_bounds * self.splat_bounds

    @property
    def n_tiles_y(self) -> int:
        base = -(-self.height // self.tile_h)
        m = self.tile_rows_multiple
        return -(-base // m) * m

    @property
    def n_tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def padded_height(self) -> int:
        return self.n_tiles_y * self.tile_h

    @property
    def padded_width(self) -> int:
        return self.n_tiles_x * self.tile_w

    def replace(self, **kw) -> "SplatConfig":
        return dataclasses.replace(self, **kw)


# Flush-to-zero threshold of the fast exp: smallest y = 1 + x/8 whose cubed
# squaring (y^8) is still normal; derived by bisection in the reference
# (main.cpp:53-73) and hardcoded there (main.cpp:75).
EXP_APPROX_FLUSH = 0.00001814586175896693021059036255

PI = math.pi
