"""Opacity-adaptive footprint culling (cfg.opacity_cull_alpha).

Contract: with threshold t > 0, binning may drop exactly those
(splat, tile) pairs whose every pixel contribution stays below t --
alpha = op * G with G <= exp(-q/2), so q <= 2*ln(op/t) bounds every
visible pixel (config.py derivation; the reference composites such pairs,
main.cpp:489-521, so this is an opt-in lossy-by-epsilon cull and every
bitwise-parity test keeps it off). Splats with op >= e^{4.5} * t (0.35 at
t=1/256) must bin IDENTICALLY to the geometric 3-sigma footprint.
"""

import jax
import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.ops import geometry
from gs2d_tpu.ops import tiles as tl
from gs2d_tpu.ops import tiles_flat as tlf
from gs2d_tpu.params import GaussianParams

from tests.test_binning_fuzz import (
    dense_per_tile,
    flat_per_tile,
    make_params,
    splats_strategy,
)

ALPHA = 1.0 / 256.0


def with_opacity(p: GaussianParams, op) -> GaussianParams:
    return p.replace(opacity=np.asarray(op, np.float32))


def min_tile_q(p: GaussianParams, i: int, t: int, cfg: SplatConfig):
    """Minimum Mahalanobis quadratic of splat i over tile t's ON-IMAGE
    pixel centers (numpy, f64 from the f32 quadratic)."""
    s11, s12, s22 = geometry.cov_of(p.sx, p.sy, p.rot)
    a, b, d, _ = geometry.inv_cov_of(s11, s12, s22)
    a, b, d = (np.float64(np.asarray(v)[i]) for v in (a, b, d))
    ty, tx = divmod(t, cfg.n_tiles_x)
    ys = np.arange(ty * cfg.tile_h, min((ty + 1) * cfg.tile_h, cfg.height))
    xs = np.arange(tx * cfg.tile_w, min((tx + 1) * cfg.tile_w, cfg.width))
    if not len(ys) or not len(xs):
        return np.inf
    vy = (ys + 0.5 - np.float64(p.pos[i, 1]))[:, None]
    vx = (xs + 0.5 - np.float64(p.pos[i, 0]))[None, :]
    q = a * vx * vx + 2.0 * b * vx * vy + d * vy * vy
    return float(q.min())


def max_tile_alpha(p: GaussianParams, i: int, t: int, cfg: SplatConfig):
    """Exact-exp upper bound on splat i's alpha over tile t's pixel
    centers (an upper bound on the kernels' fast-exp alpha, which
    underestimates exp)."""
    return float(np.asarray(p.opacity)[i]
                 * np.exp(-0.5 * min_tile_q(p, i, t, cfg)))


@settings(max_examples=15, deadline=None)
@given(splats_strategy(10),
       st.lists(st.floats(min_value=0.375, max_value=1.0, width=32,
                          allow_nan=False), min_size=10, max_size=10))
def test_noop_above_threshold(data, ops):
    """op >= e^{4.5}/256 = 0.3516: the visibility bound exceeds the
    geometric cutoff, so culled binning is IDENTICAL to unculled."""
    n = 10
    base = SplatConfig(width=96, height=72, n_splats=n, tile_h=32)
    culled = base.replace(opacity_cull_alpha=ALPHA)
    p = with_opacity(make_params(data, n), ops)
    assert dense_per_tile(p, base) == dense_per_tile(p, culled)
    assert flat_per_tile(p, base) == flat_per_tile(p, culled)


@settings(max_examples=15, deadline=None)
@given(splats_strategy(10),
       st.lists(st.floats(min_value=0.03125, max_value=1.0, width=32,
                          allow_nan=False), min_size=10, max_size=10))
def test_dropped_pairs_are_invisible_fuzz(data, ops):
    """Every pair the cull drops must have max tile alpha < the threshold
    (up to the conservative fp slack of the ellipse-rect test), both
    layouts must agree, and kept lists must stay ascending subsets."""
    n = 10
    base = SplatConfig(width=96, height=72, n_splats=n, tile_h=32)
    culled = base.replace(opacity_cull_alpha=ALPHA)
    p = with_opacity(make_params(data, n), ops)
    full = dense_per_tile(p, base)
    got = dense_per_tile(p, culled)
    assert got == flat_per_tile(p, culled)
    for t, ids in full.items():
        kept = got.get(t, [])
        assert kept == sorted(set(kept))
        assert set(kept) <= set(ids)
        for i in set(ids) - set(kept):
            # 1.02: fp slack (the cull evaluates the quadratic in f32
            # with a relative under-approximation margin, and the k2
            # crossover at op = e^{4.5}*ALPHA sits exactly at the bound).
            assert max_tile_alpha(p, i, t, culled) < ALPHA * 1.02, \
                f"visible pair (splat {i}, tile {t}) culled"
    for t, ids in got.items():
        assert set(ids) <= set(full.get(t, [])), f"tile {t}: new pair"


def test_below_threshold_splat_binned_nowhere():
    """A splat whose PEAK alpha is below the threshold (op < 1/256,
    e.g. a parked dead slot) must bin zero tiles in every layout."""
    n = 4
    cfg = SplatConfig(width=96, height=72, n_splats=n, tile_h=32,
                      opacity_cull_alpha=ALPHA)
    p = GaussianParams(
        pos=np.array([[48.0, 36.0]] * n, np.float32),
        sx=np.full((n,), 8.0, np.float32),
        sy=np.full((n,), 8.0, np.float32),
        rot=np.zeros((n,), np.float32),
        color=np.full((n, 3), 0.5, np.float32),
        opacity=np.array([0.0, ALPHA * 0.9, 0.5, 1.0], np.float32))
    got = dense_per_tile(p, cfg)
    seen = set()
    for ids in got.values():
        seen |= set(ids)
    assert seen == {2, 3}
    assert got == flat_per_tile(p, cfg)


def test_lazy_cache_headroom():
    """Margined (cached) binnings carry 2x opacity headroom: with fixed
    geometry, opacity growth below 2x can never trip pairs_covered_by
    (the member footprint at snap opacity * 2 contains every live
    footprint up to op_now <= 2 * op_snap, before even counting the
    pixel margin)."""
    n = 2
    cfg = SplatConfig(width=128, height=96, n_splats=n, tile_h=32,
                      opacity_cull_alpha=ALPHA)
    snap = GaussianParams(
        pos=np.array([[64.0, 48.0], [20.0, 70.0]], np.float32),
        sx=np.full((n,), 12.0, np.float32),
        sy=np.full((n,), 12.0, np.float32),
        rot=np.zeros((n,), np.float32),
        color=np.full((n, 3), 0.5, np.float32),
        opacity=np.array([0.11, 0.12], np.float32))
    margin = 2.0
    check = jax.jit(lambda a, b: tl.pairs_covered_by(a, b, cfg, margin))
    assert bool(check(snap, snap))
    grown = with_opacity(snap, np.asarray(snap.opacity) * 1.9)
    assert bool(check(grown, snap)), "growth under the 2x headroom tripped"


@settings(max_examples=20, deadline=None)
@given(splats_strategy(8),
       st.lists(st.floats(min_value=0.03125, max_value=1.0, width=32,
                          allow_nan=False), min_size=8, max_size=8),
       st.lists(st.floats(min_value=0.25, max_value=4.0, width=32,
                          allow_nan=False), min_size=8, max_size=8),
       st.lists(st.tuples(
           st.floats(min_value=-4.0, max_value=4.0, width=32,
                     allow_nan=False),
           st.floats(min_value=-4.0, max_value=4.0, width=32,
                     allow_nan=False)), min_size=8, max_size=8))
def test_tripwire_soundness_with_cull_fuzz(data, ops, op_mul, drifts):
    """SOUNDNESS of the lazy-rebinning tripwire under opacity culling:
    whenever pairs_covered_by says the cache is valid after position AND
    opacity drift, every (splat, tile) pair holding an alpha-visible
    pixel of the drifted population must be present in the cached
    margined binning. (Whether it trips is a performance question; this
    is the property renders depend on.)"""
    n = 8
    cfg = SplatConfig(width=96, height=72, n_splats=n, tile_h=16,
                      opacity_cull_alpha=ALPHA)
    p_old = with_opacity(make_params(data, n), ops)
    p_new = GaussianParams(
        pos=p_old.pos + np.asarray(drifts, np.float32),
        sx=p_old.sx, sy=p_old.sy, rot=p_old.rot, color=p_old.color,
        opacity=np.clip(np.asarray(p_old.opacity)
                        * np.asarray(op_mul, np.float32), 0.0, 1.0))
    margin = 2.0
    covered = bool(jax.jit(
        lambda a, b: tl.pairs_covered_by(a, b, cfg, margin))(p_new, p_old))
    if not covered:
        return  # tripping forces a rebin: always safe
    got = jax.jit(lambda q: tl.bin_splats(
        q, cfg, 64, max_tiles_per_splat=64,
        margin=margin))(p_old)
    ids = np.asarray(got.ids)
    count = np.asarray(got.count)
    assert int(got.n_dropped) == 0
    cached = {t: set(ids[t, : count[t]].tolist())
              for t in range(ids.shape[0])}
    op_new = np.asarray(p_new.opacity)
    for i in range(n):
        for t in range(ids.shape[0]):
            # Demand presence only for CLEARLY composited-and-visible
            # pairs: qmin safely inside the geometric walk (q <= 9; the
            # kernel never composites beyond it regardless of opacity)
            # AND alpha safely above the threshold (1.05x: the cull's fp
            # slack can flip exact boundary pixels either way).
            q = min_tile_q(p_new, i, t, cfg)
            if q <= cfg.cutoff_sq - 0.05 \
                    and op_new[i] * np.exp(-0.5 * q) >= ALPHA * 1.05:
                assert i in cached.get(t, set()), \
                    f"covered cache is missing visible pair ({i}, {t})"


def test_render_delta_bounded():
    """Cull-on vs cull-off through the production dense kernel path: the
    rendered images agree to a few thresholds per pixel on a population
    of low-opacity splats (each dropped pair changes a pixel by < ALPHA
    pre-transmittance)."""
    import jax.numpy as jnp

    from gs2d_tpu.ops import render_gpu as rg
    from gs2d_tpu.ops import render_tiles as rp
    from gs2d_tpu.ops import tiles_flat as tlf

    rng = np.random.default_rng(7)
    n = 64
    cfg = SplatConfig(width=128, height=96, n_splats=n, tile_h=32,
                      interpret=True)
    p = GaussianParams(
        pos=rng.uniform([0, 0], [128, 96], (n, 2)).astype(np.float32),
        sx=rng.uniform(2, 10, n).astype(np.float32),
        sy=rng.uniform(2, 10, n).astype(np.float32),
        rot=rng.uniform(0, np.pi, n).astype(np.float32),
        color=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        opacity=rng.uniform(0.1, 0.3, n).astype(np.float32))
    ref = np.full((96, 128, 3), 0.25, np.float32)
    refc = rp.pad_ref_chw(jnp.asarray(ref), cfg)

    def render(c, layout):
        if layout == "dense":
            b = tl.bin_splats(p, c, 64)
            C, _ = rp.l2_render_and_grads(b, refc, n, c, p)
        else:
            b = tlf.bin_splats_flat(p, c, tlf.tune_flat_capacity(p, c))
            C, _ = rg.l2_render_and_grads_flat(b, refc, n, c, p)
        return np.asarray(C)

    for layout in ("dense", "flat"):
        base = render(cfg, layout)
        culled = render(cfg.replace(opacity_cull_alpha=ALPHA), layout)
        # Bound: dropped pairs per pixel is small on this density; 8
        # pairs' worth of threshold absorbs transmittance-chain
        # amplification.
        assert np.abs(culled - base).max() < 8 * ALPHA
        assert np.abs(culled - base).max() > 0  # the cull dropped work


def test_counts_shrink_on_low_opacity():
    """The cull must actually reduce pair counts on a reset-opacity
    population (the point of the feature)."""
    rng = np.random.default_rng(3)
    n = 256
    cfg = SplatConfig(width=256, height=192, n_splats=n, tile_h=32)
    p = GaussianParams(
        pos=rng.uniform([0, 0], [256, 192], (n, 2)).astype(np.float32),
        sx=rng.uniform(4, 16, n).astype(np.float32),
        sy=rng.uniform(4, 16, n).astype(np.float32),
        rot=rng.uniform(0, np.pi, n).astype(np.float32),
        color=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        opacity=np.full((n,), 0.1, np.float32))  # post-reset decay floor
    base = int(np.asarray(jax.jit(lambda q: tl.bin_splats(
        q, cfg, 1, counts_only=True))(p)).sum())
    culled_cfg = cfg.replace(opacity_cull_alpha=ALPHA)
    culled = int(np.asarray(jax.jit(lambda q: tl.bin_splats(
        q, culled_cfg, 1, counts_only=True))(p)).sum())
    # Tile-granular (32x128 tiles), so far below the ~28% pixel-area
    # shrink at op=0.1 -- the cull only removes whole boundary tiles.
    assert culled < 0.92 * base, (base, culled)
