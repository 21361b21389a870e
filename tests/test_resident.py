"""Lazy rebinning: the exact coverage tripwire (tiles.pairs_covered_by),
margined superset binnings, and the cached-binning scan fitter, on the GPU
kernel in interpret mode on CPU."""

import jax
import jax.numpy as jnp
import numpy as np

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.io.image import synthetic_target
from gs2d_tpu.ops import render_gpu as rg
from gs2d_tpu.ops import render_tiles as rt
from gs2d_tpu.ops import tiles as tl
from gs2d_tpu.ops import tiles_flat as tlf
from tests.helpers import random_splats, to_params

H, W = 48, 64


def case(rng, n, **kw):
    cfg = SplatConfig(width=W, height=H, n_splats=n, interpret=True, **kw)
    s = random_splats(rng, n, W, H)
    ref = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return cfg, to_params(s), ref


class TestLazyRebinning:
    def test_pairs_covered_by_self(self, rng):
        """A population always covers itself (margin 0 and margined)."""
        cfg, p, _ = case(rng, 96, tile_h=32)
        for m in (0.0, 2.0):
            assert bool(tl.pairs_covered_by(p, p, cfg, m))

    def test_pairs_covered_by_drift(self, rng):
        """Small drift stays covered under the margin; drift that carries
        a footprint into a tile row outside the margined set must trip."""
        cfg, p, _ = case(rng, 96, tile_h=32)
        margin = 3.0
        small = p.replace(pos=p.pos + 0.5)
        assert bool(tl.pairs_covered_by(small, p, cfg, margin))
        # One splat near the middle of tile row 0 (rows 0-31): sigma 3 ->
        # bbox y in [1, 19]; +3 px margin stays in row 0. Shifting +24 px
        # pushes the exact bbox into row 1, which the margined bin-time
        # footprint never contained.
        from gs2d_tpu.params import GaussianParams

        one = GaussianParams(
            pos=jnp.asarray([[32.0, 10.0]], jnp.float32),
            sx=jnp.asarray([3.0], jnp.float32),
            sy=jnp.asarray([3.0], jnp.float32),
            rot=jnp.asarray([0.0], jnp.float32),
            color=jnp.full((1, 3), 0.5, jnp.float32),
            opacity=jnp.ones((1,), jnp.float32),
        )
        moved = one.replace(pos=one.pos + jnp.asarray([[0.0, 24.0]]))
        assert bool(tl.pairs_covered_by(one, one, cfg, margin))
        assert not bool(tl.pairs_covered_by(moved, one, cfg, margin))

    def test_pairs_covered_by_growth(self, rng):
        """Scale growth beyond the margin trips the test."""
        cfg, p, _ = case(rng, 64, tile_h=32)
        grown = p.replace(sx=p.sx * 4.0, sy=p.sy * 4.0)
        assert not bool(tl.pairs_covered_by(grown, p, cfg, 2.0))

    def test_margined_binning_is_superset(self, rng):
        """Every exact pair appears in the margined lists, in order."""
        cfg, p, _ = case(rng, 96, tile_h=32)
        exact = tl.bin_splats(p, cfg, 96)
        margined = tl.bin_splats(p, cfg, 96, margin=4.0)
        e_ids, e_cnt = np.asarray(exact.ids), np.asarray(exact.count)
        m_ids, m_cnt = np.asarray(margined.ids), np.asarray(margined.count)
        for t in range(e_ids.shape[0]):
            es = [int(x) for x in e_ids[t, : e_cnt[t]]]
            ms = [int(x) for x in m_ids[t, : m_cnt[t]]]
            assert set(es) <= set(ms), f"tile {t}"
            assert ms == sorted(ms), f"tile {t}: order"

    def test_margined_binning_same_program(self, rng):
        """Superset pairs contribute exactly nothing mathematically (a
        numpy replay of the composite over both lists is bitwise equal);
        through the compiled kernel, inserting pairs shifts later splats
        through the compiled kernel, inserting pairs may move the result by
        <= 1 ulp of fma-contraction noise. Assert to that standard."""
        cfg, p, ref = case(rng, 96, tile_h=32)
        refc = rt.pad_ref_chw(jnp.asarray(ref), cfg)
        m = tlf.tune_flat_capacity(p, cfg, bin_margin=4.0)

        @jax.jit
        def both(p, refc):
            exact = tlf.bin_splats_flat(p, cfg, m)
            marg = tlf.bin_splats_flat(p, cfg, m, margin=4.0)
            a = rg.l2_render_and_grads_flat(exact, refc, 96, cfg, p)
            b = rg.l2_render_and_grads_flat(marg, refc, 96, cfg, p)
            return a, b

        (C_e, g_e), (C_m, g_m) = both(p, refc)
        np.testing.assert_allclose(np.asarray(C_m), np.asarray(C_e),
                                   atol=5e-7)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            a_, c_ = np.asarray(getattr(g_e, f)), np.asarray(getattr(g_m, f))
            atol = 1e-5 * max(1.0, np.abs(a_).max())
            np.testing.assert_allclose(c_, a_, atol=atol, err_msg=f)

    def test_scan_fitter_with_lazy_rebinning(self, rng):
        """The cached-binning scan fitter matches per-step rebinning (to
        the documented cross-program XLA Adam-fusion drift, ~1e-7/step --
        the pair-set itself is proven bitwise-equivalent in the
        same-program test above), while hitting the cache on most steps."""
        from gs2d_tpu.train.loop import init_train_state, make_fit_scan_fused

        cfg = SplatConfig(width=W, height=H, n_splats=64, tile_h=32,
                          binning="flat", interpret=True)
        ref = synthetic_target(H, W)
        refc = rt.pad_ref_chw(jnp.asarray(ref), cfg)
        n_iters = 12

        state0 = init_train_state(cfg)
        cfg = tlf.tune_flat_config(state0.params,
                                   cfg.replace(rebin_margin=4.0))
        cfg = cfg.replace(rebin_margin=0.0)
        s_base, aux_base = make_fit_scan_fused(cfg)(state0, refc, n_iters)

        cfg_lazy = cfg.replace(rebin_margin=4.0)
        state0 = init_train_state(cfg_lazy)
        s_lazy, aux_lazy = make_fit_scan_fused(cfg_lazy)(state0, refc,
                                                         n_iters)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            np.testing.assert_allclose(
                np.asarray(getattr(s_lazy.params, f)),
                np.asarray(getattr(s_base.params, f)),
                atol=1e-4, err_msg=f)
        np.testing.assert_allclose(np.asarray(aux_lazy.mse),
                                   np.asarray(aux_base.mse), rtol=1e-5)
        rebins = int(np.asarray(aux_lazy.rebinned).sum())
        assert rebins < n_iters, "cache never hit"
