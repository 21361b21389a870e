"""Property-based fuzzing of the binning layouts.

For random populations/configs, both binning layouts must produce exactly
the brute-force (splat, tile) incidence set, in ascending splat order per
tile -- the compositing-order contract (Form.pdf p2) that every kernel
relies on. Complements the fixed-seed tests with adversarial shapes
(off-screen splats, degenerate scales, single-pixel coverage, rotations).
"""

import jax
import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.ops import geometry
from gs2d_tpu.ops import tiles as tl
from gs2d_tpu.ops import tiles_flat as tlf
from gs2d_tpu.ops.numerics import trunc_to_int
from gs2d_tpu.params import GaussianParams


def brute_force_incidence(p: GaussianParams, cfg: SplatConfig):
    """Reference (splat -> sorted tile list) map straight from the bbox
    definition (main.cpp:488-491 trunc semantics), NumPy only."""
    s11, s12, s22 = geometry.cov_of(p.sx, p.sy, p.rot)
    a, b, d, det = geometry.inv_cov_of(s11, s12, s22)
    hy = np.asarray(geometry.bbox_half_height(a, det, cfg.splat_bounds))
    hx = np.asarray(geometry.bbox_half_width(d, det, cfg.splat_bounds))
    px = np.asarray(p.pos[:, 0])
    py = np.asarray(p.pos[:, 1])
    x0 = np.asarray(trunc_to_int(px - hx))
    x1 = np.asarray(trunc_to_int(px + hx))
    y0 = np.asarray(trunc_to_int(py - hy))
    y1 = np.asarray(trunc_to_int(py + hy))
    out = {}
    for i in range(len(px)):
        if x1[i] < 0 or x0[i] >= cfg.width or y1[i] < 0 or y0[i] >= cfg.height:
            continue
        tx0 = min(max(x0[i] // cfg.tile_w, 0), cfg.n_tiles_x - 1)
        tx1 = min(max(x1[i] // cfg.tile_w, 0), cfg.n_tiles_x - 1)
        ty0 = min(max(y0[i] // cfg.tile_h, 0), cfg.n_tiles_y - 1)
        ty1 = min(max(y1[i] // cfg.tile_h, 0), cfg.n_tiles_y - 1)
        for ty in range(ty0, ty1 + 1):
            for tx in range(tx0, tx1 + 1):
                out.setdefault(ty * cfg.n_tiles_x + tx, []).append(i)
    return out


def brute_force_coverage(p: GaussianParams, cfg: SplatConfig):
    """Per-pixel walked set, mimicking the kernel masks exactly
    (render_gpu.splat_terms; main.cpp:489-511 trunc semantics): a
    (splat -> set of tile ids) map of tiles holding at least one pixel the
    kernel would touch for that splat. f32 arithmetic like the kernels."""
    f32 = np.float32
    s11, s12, s22 = geometry.cov_of(p.sx, p.sy, p.rot)
    a, b, d, det = geometry.inv_cov_of(s11, s12, s22)
    a, b, d = np.asarray(a, f32), np.asarray(b, f32), np.asarray(d, f32)
    h = np.asarray(geometry.bbox_half_height(a, det, cfg.splat_bounds), f32)
    px = np.asarray(p.pos[:, 0], f32)
    py = np.asarray(p.pos[:, 1], f32)
    k2 = f32(cfg.cutoff_sq)
    yy = np.arange(cfg.height, dtype=np.int32)[:, None]
    xx = np.arange(cfg.width, dtype=np.int32)[None, :]
    fy = yy.astype(f32) + f32(0.5)
    fx = xx.astype(f32) + f32(0.5)
    out = {}
    for i in range(len(px)):
        vy = fy - py[i]
        beg_y = np.trunc(py[i] - h[i]).astype(np.int32)
        end_y = np.trunc(py[i] + h[i]).astype(np.int32)
        row_ok = (yy >= beg_y) & (yy <= end_y)
        qb = f32(2.0) * b[i] * vy
        qc = d[i] * vy * vy - k2
        disc = qb * qb - f32(4.0) * a[i] * qc
        q_ok = disc >= 0.0
        sq = np.sqrt(np.maximum(disc, f32(0.0)))
        sgn = np.where(qb < 0.0, f32(-1.0), f32(1.0))
        kq = (-qb - sgn * sq) * f32(0.5)
        with np.errstate(divide="ignore", invalid="ignore"):
            r0 = kq / a[i]
            r1 = qc / kq
        # NaN/inf roots only occur where q_ok is False; make the cast quiet.
        r0 = np.nan_to_num(r0, nan=0.0, posinf=1e9, neginf=-1e9)
        r1 = np.nan_to_num(r1, nan=0.0, posinf=1e9, neginf=-1e9)
        beg_x = np.trunc(px[i] + np.minimum(r0, r1)).astype(np.int32)
        end_x = np.trunc(px[i] + np.maximum(r0, r1)).astype(np.int32)
        col_ok = (xx >= beg_x) & (xx <= end_x)
        cover = row_ok & q_ok & col_ok
        ys, xs = np.nonzero(cover)
        tiles = set((ys // cfg.tile_h) * cfg.n_tiles_x + xs // cfg.tile_w)
        if tiles:
            out[i] = tiles
    return out


def check_binning_contract(per_tile_got, p, cfg):
    """Assert the culled-binning contract: per tile, ids are strictly
    ascending (compositing order), a subset of the bbox incidence, and a
    superset of the tiles whose pixels the kernels actually walk."""
    bbox = brute_force_incidence(p, cfg)
    covered = brute_force_coverage(p, cfg)
    for t, got in per_tile_got.items():
        assert got == sorted(set(got)), f"tile {t}: order"
        assert set(got) <= set(bbox.get(t, [])), f"tile {t}: not in bbox"
    for i, tiles in covered.items():
        for t in tiles:
            assert i in per_tile_got.get(t, []), \
                f"covered splat {i} culled from tile {t}"


def splats_strategy(n):
    f32 = st.floats(min_value=-20.0, max_value=160.0, width=32,
                    allow_nan=False)
    scale = st.floats(min_value=1.0, max_value=64.0, width=32,
                      allow_nan=False)
    rot = st.floats(min_value=0.0, max_value=3.140625, width=32,
                    allow_nan=False)
    return st.tuples(
        st.lists(st.tuples(f32, f32), min_size=n, max_size=n),
        st.lists(scale, min_size=n, max_size=n),
        st.lists(scale, min_size=n, max_size=n),
        st.lists(rot, min_size=n, max_size=n),
    )


def make_params(data, n):
    pos, sx, sy, rot = data
    return GaussianParams(
        pos=np.asarray(pos, np.float32),
        sx=np.asarray(sx, np.float32),
        sy=np.asarray(sy, np.float32),
        rot=np.asarray(rot, np.float32),
        color=np.full((n, 3), 0.5, np.float32),
        opacity=np.ones((n,), np.float32),
    )


def dense_per_tile(p, cfg, k=16):
    b = jax.jit(lambda q: tl.bin_splats(q, cfg, k, max_tiles_per_splat=32))(p)
    ids = np.asarray(b.ids)
    count = np.asarray(b.count)
    assert int(b.n_dropped) == 0
    return {t: [int(x) for x in ids[t, : count[t]]]
            for t in range(ids.shape[0]) if count[t]}


def flat_per_tile(p, cfg, cap=1024):
    b = jax.jit(lambda q: tlf.bin_splats_flat(q, cfg, cap))(p)
    ids = np.asarray(b.ids)
    start = np.asarray(b.start)
    count = np.asarray(b.count)
    assert int(b.n_dropped) == 0
    n_tiles = cfg.n_tiles_x * cfg.n_tiles_y
    return {t: [int(x) for x in ids[start[t]: start[t] + count[t]]]
            for t in range(n_tiles) if count[t]}


@settings(max_examples=25, deadline=None)
@given(splats_strategy(12))
def test_dense_binning_matches_brute_force(data):
    n = 12
    cfg = SplatConfig(width=96, height=72, n_splats=n, tile_h=32,
                      exact_cull=False)
    p = make_params(data, n)
    want = brute_force_incidence(p, cfg)
    got = dense_per_tile(p, cfg)
    for t in set(want) | set(got):
        assert got.get(t, []) == want.get(t, []), f"tile {t}"


@settings(max_examples=25, deadline=None)
@given(splats_strategy(12))
def test_flat_binning_matches_brute_force(data):
    n = 12
    cfg = SplatConfig(width=96, height=72, n_splats=n, tile_h=32,
                      exact_cull=False)
    p = make_params(data, n)
    want = brute_force_incidence(p, cfg)
    got = flat_per_tile(p, cfg)
    for t in set(want) | set(got):
        assert got.get(t, []) == want.get(t, []), f"tile {t}"


@settings(max_examples=25, deadline=None)
@given(splats_strategy(12))
def test_culled_binning_contract_fuzz(data):
    """With exact-ellipse culling on (the default), both layouts must bin
    every tile the kernels walk (never cull covered work), only tiles from
    the bbox, in ascending order -- and must agree with each other."""
    n = 12
    cfg = SplatConfig(width=96, height=72, n_splats=n, tile_h=32)
    assert cfg.exact_cull
    p = make_params(data, n)
    dense = dense_per_tile(p, cfg)
    flat = flat_per_tile(p, cfg)
    assert dense == flat
    check_binning_contract(dense, p, cfg)


@settings(max_examples=6, deadline=None)
@given(splats_strategy(8))
def test_fused_kernel_matches_scan_fuzz(data):
    """Random populations through the GPU kernel (interpret) vs the scan
    renderer: forward allclose-at-fp32, gradients allclose."""
    import jax.numpy as jnp

    from gs2d_tpu.ops import render_gpu as rg
    from gs2d_tpu.ops import render_tiles as rp
    from gs2d_tpu.ops import tiles_flat as tlf
    from gs2d_tpu.ops.render_jax import render_backward, render_forward

    n = 8
    cfg = SplatConfig(width=64, height=48, n_splats=n, tile_h=32,
                      interpret=True)
    p = make_params(data, n)
    ref = np.full((48, 64, 3), 0.25, np.float32)
    refc = rp.pad_ref_chw(jnp.asarray(ref), cfg)
    b = tlf.bin_splats_flat(p, cfg, max(1, tlf.tune_flat_capacity(p, cfg)))
    C, g = rg.l2_render_and_grads_flat(b, refc, n, cfg, p)
    C1, _ = render_forward(p, cfg)
    g1 = render_backward(p, C1, C1 - jnp.asarray(ref), cfg)
    np.testing.assert_allclose(np.asarray(C), np.asarray(C1), atol=3e-7)
    for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
        a, c = np.asarray(getattr(g1, f)), np.asarray(getattr(g, f))
        # Geometry gradients derive from the z-moments, whose round-5
        # SEPARABLE reduction reassociates the tile sums (y-partials
        # before the vx monomials). On extreme-anisotropy footprints the
        # moment partials cancel ~1000:1, so the two f32 orders can
        # differ ~1e-3 relative (hypothesis example: sx 41.5/sy 1.0,
        # rot 3.0 -> rot grad 0.2859 vs 0.2857); color/opacity sums
        # have no monomial stage and stay at the 1e-4 class.
        tol = 1e-4 if f in ("color", "opacity") else 1e-3
        atol = tol * max(1.0, np.abs(a).max())
        np.testing.assert_allclose(c, a, atol=atol, err_msg=f)


@settings(max_examples=20, deadline=None)
@given(splats_strategy(10),
       st.lists(st.tuples(
           st.floats(min_value=-6.0, max_value=6.0, width=32,
                     allow_nan=False),
           st.floats(min_value=-6.0, max_value=6.0, width=32,
                     allow_nan=False)), min_size=10, max_size=10),
       st.floats(min_value=0.875, max_value=1.125, width=32,
                 allow_nan=False))
def test_lazy_rebin_tripwire_soundness_fuzz(data, drifts, scale_mul):
    """SOUNDNESS of the lazy-rebinning tripwire: whenever
    pairs_covered_by(p_new, p_old, margin) says the cache is valid, every
    exact pair of p_new must actually be present in the margined binning
    built from p_old -- otherwise lazy rebinning would silently render
    with missing pairs. (The other direction -- tripping unnecessarily --
    costs only a rebin and is exercised by the drift tests.) Fuzzes random
    drifts both under and past the margin, including scale growth."""
    n = 10
    cfg = SplatConfig(width=64, height=48, n_splats=n, tile_h=16)
    p_old = make_params(data, n)
    drift = np.asarray(drifts, np.float32)
    p_new = GaussianParams(
        pos=p_old.pos + drift,
        sx=np.clip(p_old.sx * np.float32(scale_mul), 1.0, 1024.0),
        sy=np.clip(p_old.sy * np.float32(scale_mul), 1.0, 1024.0),
        rot=p_old.rot, color=p_old.color, opacity=p_old.opacity)
    margin = 2.0
    covered = bool(jax.jit(
        lambda a, b: tl.pairs_covered_by(a, b, cfg, margin))(p_new, p_old))
    if not covered:
        return  # tripping is always safe (forces a rebin)
    got = jax.jit(lambda q: tl.bin_splats(
        q, cfg, 64, max_tiles_per_splat=64,
        margin=margin))(p_old)
    ids = np.asarray(got.ids)
    count = np.asarray(got.count)
    assert int(got.n_dropped) == 0
    cached = {t: set(ids[t, : count[t]].tolist())
              for t in range(ids.shape[0])}
    exact = brute_force_incidence(p_new, cfg)
    covered_px = brute_force_coverage(p_new, cfg)
    # Every tile whose PIXELS p_new actually touches must hold the splat
    # in the cached margined lists (bbox-only pairs may be culled).
    for i, tiles in covered_px.items():
        for t in tiles:
            assert i in cached.get(t, set()), \
                f"tripwire said covered but pair (splat {i}, tile {t}) " \
                "is missing from the cached binning"
    del exact
