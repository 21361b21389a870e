"""Tile binning invariants and tile-path parity: the plain XLA path and
the GPU kernel (interpret mode on CPU) against the scan renderer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.ops import render_gpu as rg
from gs2d_tpu.ops import render_tiles as rp
from gs2d_tpu.ops import tiles as tl
from gs2d_tpu.ops import tiles_flat as tlf
from gs2d_tpu.ops.render_jax import render_backward, render_forward
from tests.helpers import random_splats, to_params

H, W = 48, 64


def make_case(rng, n, **kw):
    cfg = SplatConfig(width=W, height=H, n_splats=n, interpret=True)
    s = random_splats(rng, n, W, H, **kw)
    return cfg, s, to_params(s)


class TestBinning:
    def test_ids_sorted_and_in_order(self, rng):
        cfg, s, p = make_case(rng, 96)
        b = tl.bin_splats(p, cfg, 96)
        ids = np.asarray(b.ids)
        count = np.asarray(b.count)
        assert int(b.n_dropped) == 0
        for t in range(ids.shape[0]):
            live = ids[t, : count[t]]
            # index order within a tile is strictly increasing (no dups)
            assert (np.diff(live) > 0).all() if len(live) > 1 else True
            assert (ids[t, count[t]:] == -1).all()

    def test_covers_all_contributing_splats(self, rng):
        """Every splat covering a pixel (per the exact reference bounds) must
        appear in that pixel's tile list."""
        cfg, s, p = make_case(rng, 64)
        b = tl.bin_splats(p, cfg, 64)
        ids = np.asarray(b.ids)
        count = np.asarray(b.count)
        # brute force: coverage from the scan renderer internals
        from gs2d_tpu.ops.render_jax import _coverage, _splat_scalars
        scal = _splat_scalars(p)
        for i in range(p.pos.shape[0]):
            si = {k: v[i] for k, v in scal.items()}
            mask = np.asarray(_coverage(si["px"], si["py"], si["a"], si["b"],
                                        si["d"], si["h"], cfg)[0])
            ys, xs = np.nonzero(mask)
            tiles_needed = set(zip(ys // cfg.tile_h, xs // cfg.tile_w))
            for ty, tx in tiles_needed:
                t = ty * cfg.n_tiles_x + tx
                assert i in ids[t, : count[t]], (i, ty, tx)

    def test_capacity_overflow_reported(self, rng):
        cfg, s, p = make_case(rng, 64)
        s.pos[:] = np.float32([W / 2, H / 2])  # all splats on one tile stack
        p = to_params(s)
        b = tl.bin_splats(p, cfg, max_per_tile=8)
        assert int(b.n_dropped) > 0

    def test_offscreen_excluded(self, rng):
        cfg, s, p = make_case(rng, 32)
        s.pos[:, 0] += 10000.0
        b = tl.bin_splats(to_params(s), cfg, 32)
        assert int(b.count.sum()) == 0

    def test_counts_only_matches_full(self, rng):
        """counts_only returns the untruncated per-tile counts."""
        cfg, s, p = make_case(rng, 96)
        full = tl.bin_splats(p, cfg, 96)
        counts = tl.bin_splats(p, cfg, 1, counts_only=True)
        np.testing.assert_array_equal(np.asarray(counts),
                                      np.asarray(full.count))

    def test_tune_tile_capacity(self, rng):
        """Tuned capacity covers the measured max with margin; binning at the
        tuned K drops nothing."""
        cfg, s, p = make_case(rng, 96)
        cfg = SplatConfig(width=W, height=H, n_splats=96)
        tuned = tl.tune_tile_capacity(p, cfg)
        k = tuned.max_splats_per_tile
        counts = tl.bin_splats(p, cfg, 1, counts_only=True)
        assert k >= int(np.asarray(counts).max())
        assert k % 64 == 0 if k <= 256 else k % 256 == 0
        b = tl.bin_splats(p, tuned, k)
        assert int(b.n_dropped) == 0


def forward_of(layout, p, cfg, k):
    """(color, T) cropped to the image, from the plain path or the kernel."""
    if layout == "dense":
        return rp.forward_tiled(tl.bin_splats(p, cfg, k), cfg)
    b = tlf.bin_splats_flat(p, cfg, max(1, tlf.tune_flat_capacity(p, cfg)))
    C, T = rg.forward_flat(b, cfg)
    return C[:H, :W], T[:H, :W]


class TestPallasForward:
    @pytest.mark.parametrize("layout", ["dense", "flat"])
    @pytest.mark.parametrize("n", [1, 64, 192])
    def test_matches_scan_renderer(self, rng, n, layout):
        cfg, s, p = make_case(rng, n)
        C1, T1 = render_forward(p, cfg)
        C2, T2 = forward_of(layout, p, cfg, max(n, 8))
        np.testing.assert_allclose(np.asarray(C2), np.asarray(C1), atol=3e-7)
        np.testing.assert_allclose(np.asarray(T2), np.asarray(T1), atol=3e-7)

    @pytest.mark.parametrize("layout", ["dense", "flat"])
    def test_saturated(self, rng, layout):
        cfg, s, p = make_case(rng, 64, opacity_range=(0.95, 1.0))
        s.pos[:] = np.float32([W / 2, H / 2]) + np.asarray(
            rng.normal(0, 2.0, (64, 2)), np.float32)
        p = to_params(s)
        C1, T1 = render_forward(p, cfg)
        C2, T2 = forward_of(layout, p, cfg, 64)
        assert (np.asarray(T1) < 1 / 256).any()
        np.testing.assert_allclose(np.asarray(C2), np.asarray(C1), atol=3e-7)


class TestPallasBackward:
    @pytest.mark.parametrize("layout", ["dense", "flat"])
    def test_matches_scan_backward(self, rng, layout):
        cfg, s, p = make_case(rng, 96)
        C, _ = render_forward(p, cfg)
        ref = jnp.asarray(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
        gC = C - ref
        g1 = render_backward(p, C, gC, cfg)
        if layout == "dense":
            g2 = rp.backward_tiled(tl.bin_splats(p, cfg, 96), C, gC, 96,
                                   cfg, p)
        else:
            b = tlf.bin_splats_flat(p, cfg, tlf.tune_flat_capacity(p, cfg))
            pad = lambda x: jnp.zeros(
                (cfg.padded_height, cfg.padded_width, 3)).at[:H, :W].set(x)
            g2 = rg.backward_flat(b, pad(C), pad(gC), 96, cfg, p)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            a, c = np.asarray(getattr(g1, f)), np.asarray(getattr(g2, f))
            atol = 1e-4 * max(1.0, np.abs(a).max())
            np.testing.assert_allclose(c, a, atol=atol, err_msg=f)

    def test_custom_vjp_trains(self, rng):
        """End-to-end: the production render plugs into the train loop."""
        from gs2d_tpu.io.image import synthetic_target
        from gs2d_tpu.train.loop import fit

        cfg = SplatConfig(width=W, height=H, n_splats=64)
        ref = jnp.asarray(synthetic_target(H, W))
        state, hist = fit(ref, cfg, iterations=30,
                          render_fn=rp.production_render,
                          log_every=10, log_fn=None)
        assert hist[-1]["mse"] < hist[0]["mse"] * 0.8


class TestSegmentedSortFallback:
    def test_matches_single_segment_path(self, rng):
        """The segmented sort (used when packed keys would overflow int32 at
        huge N) must bin identically to the single-segment path."""
        cfg, s, p = make_case(rng, 96)
        a = tl.bin_splats(p, cfg, 96)
        b = tl.bin_splats(p, cfg, 96, _force_segmented=True)
        np.testing.assert_array_equal(np.asarray(a.ids), np.asarray(b.ids))
        np.testing.assert_array_equal(np.asarray(a.count), np.asarray(b.count))
        np.testing.assert_array_equal(
            np.asarray(a.tile_params), np.asarray(b.tile_params))


class TestBinningPolicy:
    """backend.resolve_binning: the layout follows the platform."""

    def test_auto_policy(self):
        from gs2d_tpu import backend

        mk = lambda **kw: SplatConfig(width=535, height=426, n_splats=1024,
                                      **kw)
        # The test run is on the CPU: auto picks the plain path's layout.
        assert backend.platform() == "cpu"
        assert backend.resolve_binning(mk()) == "dense"
        assert backend.resolve_binning(mk(binning="dense")) == "dense"
        assert backend.resolve_binning(mk(binning="flat")) == "flat"

    def test_unknown_binning_raises(self):
        from gs2d_tpu import backend

        for bad in ("bogus", "resident", "window"):
            with pytest.raises(ValueError):
                backend.resolve_binning(SplatConfig(binning=bad))


class TestKernelGate:
    """The kernel runs compiled only on a GPU; interpret mode only when
    the config asks for it."""

    def test_flat_without_gpu_raises(self, rng):
        from gs2d_tpu import backend

        cfg, s, p = make_case(rng, 8)
        cfg = cfg.replace(interpret=False)
        with pytest.raises(ValueError, match="needs a GPU"):
            backend.check_kernel(cfg)
        b = tlf.bin_splats_flat(p, cfg, 64)
        with pytest.raises(ValueError, match="needs a GPU"):
            rg.forward_flat(b, cfg)

    def test_interpret_allowed(self, rng):
        from gs2d_tpu import backend

        cfg, s, p = make_case(rng, 8)
        backend.check_kernel(cfg)  # interpret=True: no error
        assert "platform=cpu" in backend.describe()


class TestTuneRebinMargin:
    """--rebin-margin -1 (auto): slack from measured pair inflation."""

    def test_sparse_keeps_full_margin(self, rng):
        # Big footprints spanning several tiles: 2px of slack barely moves
        # the binned-pair count.
        cfg, s, p = make_case(rng, 16)
        s.sx[:] = 12.0
        s.sy[:] = 12.0
        out = tl.tune_rebin_margin(
            to_params(s), cfg.replace(rebin_margin=-1.0))
        assert out.rebin_margin == 2.0

    def test_tiny_footprints_back_off(self, rng):
        # Tiny splats on small tiles: every pixel of slack spills most
        # footprints into neighbour tiles, inflating pairs far past 30%.
        n = 64
        cfg = SplatConfig(width=W, height=H, n_splats=n, tile_h=8)
        s = random_splats(rng, n, W, H)
        s.sx[:] = 0.8
        s.sy[:] = 0.8
        out = tl.tune_rebin_margin(
            to_params(s), cfg.replace(rebin_margin=-1.0))
        assert out.rebin_margin < 2.0

    def test_monotone_superset(self, rng):
        # The tuned margin always bins a superset of the exact pairs.
        cfg, s, p = make_case(rng, 32)
        out = tl.tune_rebin_margin(p, cfg.replace(rebin_margin=-1.0))
        exact = int(tl.bin_splats(p, cfg, 1, counts_only=True).sum())
        marg = int(tl.bin_splats(p, cfg, 1, counts_only=True,
                                 margin=out.rebin_margin).sum())
        assert marg >= exact
