"""The production tile L2 train path -- the plain XLA path and the GPU
kernel in interpret mode on CPU -- vs the reference scan path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.io.image import synthetic_target
from gs2d_tpu.ops import render_gpu as rg
from gs2d_tpu.ops import render_tiles as rp
from gs2d_tpu.ops import tiles as tl
from gs2d_tpu.ops import tiles_flat as tlf
from gs2d_tpu.ops.render_jax import render_backward, render_forward
from gs2d_tpu.train.loop import init_train_state, make_train_step, \
    make_train_step_fused
from tests.helpers import random_splats, to_params

H, W = 48, 64


def case(rng, n, **kw):
    cfg = SplatConfig(width=W, height=H, n_splats=n, **kw)
    s = random_splats(rng, n, W, H)
    ref = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return cfg, to_params(s), ref


class TestFusedKernel:
    @pytest.mark.parametrize("layout", ["dense", "flat"])
    def test_matches_scan_path(self, rng, layout):
        cfg, p, ref = case(rng, 128, interpret=True)
        refc = rp.pad_ref_chw(jnp.asarray(ref), cfg)
        if layout == "dense":
            b = tl.bin_splats(p, cfg, 128)
            C, g = rp.l2_render_and_grads(b, refc, 128, cfg, p)
        else:
            b = tlf.bin_splats_flat(p, cfg, tlf.tune_flat_capacity(p, cfg))
            C, g = rg.l2_render_and_grads_flat(b, refc, 128, cfg, p)
        C1, _ = render_forward(p, cfg)
        g1 = render_backward(p, C1, C1 - jnp.asarray(ref), cfg)
        np.testing.assert_allclose(np.asarray(C), np.asarray(C1), atol=3e-7)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            a, c = np.asarray(getattr(g1, f)), np.asarray(getattr(g, f))
            atol = 1e-4 * max(1.0, np.abs(a).max())
            np.testing.assert_allclose(c, a, atol=atol, err_msg=f)

    @pytest.mark.parametrize("layout", ["dense", "flat"])
    def test_train_step_fused_matches_modular(self, rng, layout):
        """One optimizer step via the tile step == via the custom-VJP
        scan path (same Adam, same cotangent)."""
        cfg = SplatConfig(width=W, height=H, n_splats=64,
                          max_splats_per_tile=64, binning=layout,
                          interpret=True)
        ref = synthetic_target(H, W)
        state = init_train_state(cfg)
        cfg = rp.tune_binning(state.params, cfg)

        fused = make_train_step_fused(cfg)
        refc = rp.pad_ref_chw(jnp.asarray(ref), cfg)
        s_f, aux_f = fused(state, refc)

        modular = make_train_step(cfg)
        s_m, aux_m = modular(state, jnp.asarray(ref))

        assert np.isclose(float(aux_f.mse), float(aux_m.mse), rtol=1e-5)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            a = np.asarray(getattr(s_m.params, f))
            c = np.asarray(getattr(s_f.params, f))
            np.testing.assert_allclose(c, a, rtol=1e-4, atol=2e-3, err_msg=f)

    def test_fit_scan_fused_matches_step_loop(self, rng):
        """K iterations via the on-device lax.scan == K single-step calls
        (bitwise: same traced computation, same order)."""
        from gs2d_tpu.train.loop import make_fit_scan_fused

        cfg = SplatConfig(width=W, height=H, n_splats=64,
                          max_splats_per_tile=64)
        ref = synthetic_target(H, W)
        refc = rp.pad_ref_chw(jnp.asarray(ref), cfg)
        step = make_train_step_fused(cfg)
        s_loop = init_train_state(cfg)
        mses = []
        for _ in range(5):
            s_loop, aux = step(s_loop, refc)
            mses.append(float(aux.mse))

        fit_k = make_fit_scan_fused(cfg)
        s_scan, auxes = fit_k(init_train_state(cfg), refc, 5)
        np.testing.assert_allclose(np.asarray(auxes.mse), mses, rtol=1e-6)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            np.testing.assert_allclose(
                np.asarray(getattr(s_scan.params, f)),
                np.asarray(getattr(s_loop.params, f)),
                rtol=1e-5, atol=1e-5, err_msg=f)

    def test_fit_scan_chunk_driver(self, rng):
        """fit(scan_chunk=K) produces the same history records as fit()."""
        from gs2d_tpu.train.loop import fit

        cfg = SplatConfig(width=W, height=H, n_splats=64,
                          max_splats_per_tile=64)
        ref = jnp.asarray(synthetic_target(H, W))
        _, h_plain = fit(ref, cfg, iterations=6, log_every=2, log_fn=None,
                         use_fused=True)
        _, h_scan = fit(ref, cfg, iterations=6, log_every=2, log_fn=None,
                        use_fused=True, scan_chunk=4)
        assert [r["iter"] for r in h_scan] == [r["iter"] for r in h_plain]
        for a, b in zip(h_scan, h_plain):
            assert np.isclose(a["mse"], b["mse"], rtol=1e-5)

    def test_fused_convergence(self, rng):
        cfg = SplatConfig(width=W, height=H, n_splats=64,
                          max_splats_per_tile=64)
        ref = synthetic_target(H, W)
        refc = rp.pad_ref_chw(jnp.asarray(ref), cfg)
        step = make_train_step_fused(cfg)
        state = init_train_state(cfg)
        first = None
        for i in range(25):
            state, aux = step(state, refc)
            if first is None:
                first = float(aux.mse)
        assert float(aux.mse) < first * 0.7


class TestTileLayout:
    @pytest.mark.parametrize("tile", [(8, 128), (16, 16), (4, 32)])
    def test_to_from_tiles_roundtrip(self, rng, tile):
        """Tile-major planes and the padded image map one to one, and
        plane row t holds tile t's pixels in row-major order."""
        cfg = SplatConfig(width=W, height=H, tile_h=tile[0], tile_w=tile[1])
        img = jnp.asarray(rng.uniform(
            0, 1, (cfg.padded_height, cfg.padded_width, 3)), jnp.float32)
        planes = rg.to_tiles(img, cfg)
        assert planes.shape == (cfg.n_tiles_y * cfg.n_tiles_x,
                                tile[0] * tile[1], 3)
        np.testing.assert_array_equal(
            np.asarray(rg.from_tiles(planes, cfg, cfg.n_tiles_y)),
            np.asarray(img))
        t = cfg.n_tiles_x + 1 if cfg.n_tiles_y > 1 else 0
        ty, tx = divmod(t, cfg.n_tiles_x)
        block = np.asarray(img)[ty * tile[0]:(ty + 1) * tile[0],
                                tx * tile[1]:(tx + 1) * tile[1]]
        np.testing.assert_array_equal(np.asarray(planes[t]),
                                      block.reshape(-1, 3))

    @pytest.mark.parametrize("row0", [0, 8])
    def test_tile_pixels(self, row0):
        """Per-tile pixel coordinates, band offset and the inside mask."""
        cfg = SplatConfig(width=20, height=12, tile_h=4, tile_w=8)
        yy, xx, fy, fx, inside = (np.asarray(a) for a in rg.tile_pixels(
            cfg, jnp.arange(cfg.n_tiles_x)[:, None], row0))
        assert yy.shape == (cfg.n_tiles_x, 32)
        np.testing.assert_array_equal(yy[:, :8], row0)
        np.testing.assert_array_equal(xx[2, :8], np.arange(16, 24))
        np.testing.assert_array_equal(fx, xx + 0.5)
        np.testing.assert_array_equal(inside, (yy < 12) & (xx < 20))


class TestBatchedFused:
    def test_batch_matches_per_image(self, rng):
        from gs2d_tpu.parallel.sharded import init_batched_state
        from gs2d_tpu.train.loop import make_batched_train_step_fused

        cfg = SplatConfig(width=W, height=H, n_splats=32,
                          max_splats_per_tile=32)
        refs = np.stack([synthetic_target(H, W, seed=s) for s in (0, 2)])
        refs_chw = jnp.stack([rp.pad_ref_chw(jnp.asarray(r), cfg)
                              for r in refs])
        state = init_batched_state(cfg, 2)
        bstep = make_batched_train_step_fused(cfg)
        bstate, baux = bstep(state, refs_chw)

        sstep = make_train_step_fused(cfg)
        for i in range(2):
            s_i = jax.tree.map(lambda x: x[i], state)
            out_i, aux_i = sstep(s_i, refs_chw[i])
            assert np.isclose(float(baux.mse[i]), float(aux_i.mse), rtol=1e-6)
            for f in ("pos", "color"):
                np.testing.assert_allclose(
                    np.asarray(getattr(bstate.params, f))[i],
                    np.asarray(getattr(out_i.params, f)), atol=1e-6)


class TestBatchedScanFitter:
    def test_scan_matches_stepped(self, rng):
        """The batched scan fitter == iterating the batched step."""
        from gs2d_tpu.parallel.sharded import init_batched_state
        from gs2d_tpu.train.loop import (make_batched_train_step_fused,
                                         make_fit_scan_batched)

        cfg = SplatConfig(width=W, height=H, n_splats=32,
                          max_splats_per_tile=32)
        refs = np.stack([synthetic_target(H, W, seed=s) for s in (0, 2)])
        refs_chw = jnp.stack([rp.pad_ref_chw(jnp.asarray(r), cfg)
                              for r in refs])
        state = init_batched_state(cfg, 2)

        s_scan, auxes = make_fit_scan_batched(cfg)(state, refs_chw, 5)
        bstep = make_batched_train_step_fused(cfg)
        s_it = state
        for _ in range(5):
            s_it, aux = bstep(s_it, refs_chw)
        np.testing.assert_allclose(np.asarray(auxes.mse[-1]),
                                   np.asarray(aux.mse), rtol=1e-6)
        for f in ("pos", "color", "opacity"):
            np.testing.assert_allclose(
                np.asarray(getattr(s_scan.params, f)),
                np.asarray(getattr(s_it.params, f)), atol=1e-6, err_msg=f)


class TestChunkedModular:
    def test_forward_backward_chunked_matches_scan(self, rng):
        """A deep capacity (K=512, mostly padding slots) through the plain
        forward/backward matches the scan reference."""
        n = 512
        cfg = SplatConfig(width=W, height=H, n_splats=n)
        s = random_splats(rng, n, W, H)
        p = to_params(s)
        ref = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)

        b = tl.bin_splats(p, cfg, 512)
        C, T = rp.forward_tiled(b, cfg)
        C1, T1 = render_forward(p, cfg)
        np.testing.assert_allclose(np.asarray(C), np.asarray(C1), atol=3e-7)
        np.testing.assert_allclose(np.asarray(T), np.asarray(T1), atol=3e-7)

        g = rp.backward_tiled(b, C, C - jnp.asarray(ref), n, cfg, p)
        g1 = render_backward(p, C1, C1 - jnp.asarray(ref), cfg)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            a, c = np.asarray(getattr(g1, f)), np.asarray(getattr(g, f))
            atol = 1e-4 * max(1.0, np.abs(a).max())
            np.testing.assert_allclose(c, a, atol=atol, err_msg=f)

    def test_chunked_saturation(self, rng):
        """Opaque overlapping splats saturate T mid-list; the plain path's
        masked slots contribute exact zeros and the composite still matches
        the scan path."""
        n = 512
        cfg = SplatConfig(width=W, height=H, n_splats=n)
        s = random_splats(rng, n, W, H, opacity_range=(0.9, 1.0))
        s.pos[:] = np.float32([W / 2, H / 2]) \
            + rng.normal(0, 3.0, (n, 2)).astype(np.float32)
        p = to_params(s)
        ref = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)

        b = tl.bin_splats(p, cfg, 512)
        C, T = rp.forward_tiled(b, cfg)
        C1, T1 = render_forward(p, cfg)
        assert (np.asarray(T1) < 1.0 / 256.0).any()
        np.testing.assert_allclose(np.asarray(C), np.asarray(C1), atol=3e-7)

        g = rp.backward_tiled(b, C, C - jnp.asarray(ref), n, cfg, p)
        g1 = render_backward(p, C1, C1 - jnp.asarray(ref), cfg)
        for f in ("pos", "color", "opacity"):
            a, c = np.asarray(getattr(g1, f)), np.asarray(getattr(g, f))
            atol = 2e-4 * max(1.0, np.abs(a).max())
            np.testing.assert_allclose(c, a, atol=atol, err_msg=f)


class TestTileHeight:
    """The tile shape must be a pure layout change -- forward equal to
    ~1 ulp (different fusion shapes per block geometry), grads equal up to
    partition reassociation."""

    def test_tile_h_equivalence(self, rng):
        cfg0, p, ref = case(rng, 64, max_splats_per_tile=64)
        outs = {}
        for th in (8, 16, 32):
            cfg = cfg0.replace(tile_h=th)
            b = tl.bin_splats(p, cfg, 64)
            refc = rp.pad_ref_chw(jnp.asarray(ref), cfg)
            color, grads = rp.l2_render_and_grads(b, refc, 64, cfg, p)
            outs[th] = (np.asarray(color)[:H, :W],
                        jax.tree.map(np.asarray, grads))
        for th in (16, 32):
            np.testing.assert_allclose(outs[8][0], outs[th][0],
                                       rtol=3e-7, atol=2e-7)
            for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
                np.testing.assert_allclose(
                    getattr(outs[8][1], f), getattr(outs[th][1], f),
                    rtol=1e-3, atol=2e-6, err_msg=f"{f} th={th}")

    def test_tune_tile_height(self):
        """The production tile shape is a power-of-two pixel count (the
        kernel's block) at every image size."""
        for w, h in ((W, H), (3840, 2160)):
            cfg = tl.tune_tile_shape(SplatConfig(width=w, height=h))
            assert (cfg.tile_h, cfg.tile_w) == tl.PRODUCTION_TILE
            px = cfg.tile_h * cfg.tile_w
            assert px & (px - 1) == 0


class TestDeadSlotGrads:
    """moments_to_grads must emit exactly-zero (not NaN) opacity gradients
    for dead slots (opacity == 0, as densify/prune parks them).

    Regression (ADVICE round 4, medium): the moment-form refactor computed
    the opacity gradient as M0/op, which is 0/0 = NaN on dead slots where
    the reference form (main.cpp:703, dalpha/do = G) gives exact 0. The
    NaN was masked by freeze_dead_slots in the trainer but contaminated
    any direct consumer of the returned grads."""

    def test_zero_opacity_grads_are_zero(self, rng):
        from gs2d_tpu.train.densify import DEAD_POS
        cfg, p, ref = case(rng, 64, max_splats_per_tile=64)
        # park slots 0..4 the way densify_and_prune does
        p = jax.tree.map(jnp.asarray, p)
        p = p.replace(
            pos=p.pos.at[:5].set(DEAD_POS),
            opacity=p.opacity.at[:5].set(0.0))
        b = tl.bin_splats(p, cfg, 64)
        refc = rp.pad_ref_chw(jnp.asarray(ref), cfg)
        _, g = rp.l2_render_and_grads(b, refc, 64, cfg, p)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            arr = np.asarray(getattr(g, f))
            assert np.isfinite(arr).all(), f"{f} grads not finite"
        assert (np.asarray(g.opacity)[:5] == 0.0).all()


class TestBatchedFlatLayout:
    """Batched multi-image fitting on the FLAT layout (north-star configs[4]
    needs flat at 4K-scale populations; round-4 VERDICT missing item 4)."""

    def test_flat_batched_matches_single(self, rng):
        from gs2d_tpu.parallel.sharded import init_batched_state
        from gs2d_tpu.train.loop import (make_batched_train_step_fused,
                                         make_train_step_fused)

        cfg = SplatConfig(width=W, height=H, n_splats=96, binning="flat",
                          interpret=True)
        from gs2d_tpu.params import init_params
        cfg = tlf.tune_flat_config(init_params(cfg), cfg)
        refs = np.stack([synthetic_target(H, W, seed=s) for s in (0, 2)])
        refs_chw = jnp.stack([rp.pad_ref_chw(jnp.asarray(r), cfg)
                              for r in refs])
        state = init_batched_state(cfg, 2)
        bstate, baux = make_batched_train_step_fused(cfg)(state, refs_chw)
        sstep = make_train_step_fused(cfg)
        for i in range(2):
            s_i = jax.tree.map(lambda x: x[i], state)
            out_i, aux_i = sstep(s_i, refs_chw[i])
            assert np.isclose(float(baux.mse[i]), float(aux_i.mse),
                              rtol=1e-6)
            for f in ("pos", "color"):
                np.testing.assert_allclose(
                    np.asarray(getattr(bstate.params, f))[i],
                    np.asarray(getattr(out_i.params, f)), atol=1e-6)

    def test_flat_batched_scan_with_lazy_rebinning(self, rng):
        """Scanned batched fitter carries per-image flat caches; margin=2
        trajectory matches eager margin=0 within the documented drift."""
        from gs2d_tpu.params import init_params
        from gs2d_tpu.parallel.sharded import init_batched_state
        from gs2d_tpu.train.loop import make_fit_scan_batched

        cfg0 = SplatConfig(width=W, height=H, n_splats=96, binning="flat",
                           interpret=True)
        cfg0 = tlf.tune_flat_config(init_params(cfg0), cfg0)
        refs = np.stack([synthetic_target(H, W, seed=s) for s in (0, 2)])
        refs_chw = jnp.stack([rp.pad_ref_chw(jnp.asarray(r), cfg0)
                              for r in refs])
        state = init_batched_state(cfg0, 2)
        s_eager, _ = make_fit_scan_batched(cfg0)(state, refs_chw, 4)
        cfg2 = cfg0.replace(rebin_margin=2.0)
        s_lazy, auxes = make_fit_scan_batched(cfg2)(state, refs_chw, 4)
        assert np.asarray(auxes.rebinned).shape == (4,)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            np.testing.assert_allclose(
                np.asarray(getattr(s_lazy.params, f)),
                np.asarray(getattr(s_eager.params, f)),
                rtol=1e-4, atol=2e-4, err_msg=f)
