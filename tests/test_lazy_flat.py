"""Lazy rebinning on the FLAT layout (tiles_flat margin/ids_only +
train/loop one_step_flat_cached), in interpret mode on CPU.

The flat structure (exact-count expansion + one stable sort) is
param-dependent only through the pair SET; a margined superset stays valid
while splats drift less than the margin, and superset pairs composite to
exactly nothing (tests/test_resident.py::TestLazyRebinning pins the
tripwire itself). The per-row parameter
pregather (tiles_flat.pregather_rows) is re-run from the live params every
step, so cached-structure renders see current parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.io.image import synthetic_target
from gs2d_tpu.ops import render_tiles as rt
from gs2d_tpu.ops import tiles_flat as tlf
from tests.helpers import random_splats, to_params

H, W = 64, 128


def case(rng, n, **kw):
    cfg = SplatConfig(width=W, height=H, n_splats=n, binning="flat",
                      interpret=True, **kw)
    s = random_splats(rng, n, W, H)
    p = to_params(s)
    cfg = tlf.tune_flat_config(p, cfg)
    ref = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return cfg, p, ref


class TestFlatLazyRebinning:
    def test_margined_flat_is_superset(self, rng):
        """Every exact flat pair appears in the margined layout, and each
        tile's run keeps ascending splat order (the compositing contract)."""
        cfg, p, _ = case(rng, 96, tile_h=32)
        exact = tlf.bin_splats_flat(p, cfg, cfg.flat_capacity)
        marg = tlf.bin_splats_flat(p, cfg, cfg.flat_capacity * 2,
                                   margin=4.0)
        assert int(exact.n_dropped) == 0 and int(marg.n_dropped) == 0
        e_ids, m_ids = np.asarray(exact.ids), np.asarray(marg.ids)
        e_st, m_st = np.asarray(exact.start), np.asarray(marg.start)
        e_ct, m_ct = np.asarray(exact.count), np.asarray(marg.count)
        for t in range(e_st.shape[0]):
            es = [int(x) for x in e_ids[e_st[t]:e_st[t] + e_ct[t]]]
            ms = [int(x) for x in m_ids[m_st[t]:m_st[t] + m_ct[t]]]
            assert set(es) <= set(ms), f"tile {t}"
            assert ms == sorted(ms), f"tile {t}: order"

    def test_ids_only_plus_pregather_matches(self, rng):
        """ids_only binning + pregather_rows == the one-shot binning."""
        cfg, p, _ = case(rng, 64, tile_h=32)
        full = tlf.bin_splats_flat(p, cfg, cfg.flat_capacity)
        ids = tlf.bin_splats_flat(p, cfg, cfg.flat_capacity, ids_only=True)
        np.testing.assert_array_equal(np.asarray(ids.ids),
                                      np.asarray(full.ids))
        rows = tlf.pregather_rows(ids.ids, p, cfg)
        np.testing.assert_array_equal(np.asarray(rows),
                                      np.asarray(full.rows))

    def test_tune_sizes_for_the_margin(self, rng):
        """tune_flat_config with cfg.rebin_margin > 0 must (a) size the
        capacity so the margined superset binning never drops pairs, and
        (b) size the tripwire slot grid (max_tiles_per_splat) to the
        margined footprints -- otherwise pairs_covered_by returns False on
        every step and the lazy cache degrades to worse-than-eager
        (round-3 advisor findings)."""
        from gs2d_tpu.ops import tiles as tl

        n = 96
        w2, h2 = 256, 256  # 32x2 tile grid at tile_h=8
        cfg = SplatConfig(width=w2, height=h2, n_splats=n, binning="flat",
                          tile_h=8, rebin_margin=8.0)
        s = random_splats(rng, n, w2, h2)
        # Small splats: an 8 px margin multiplies their footprints several-
        # fold, far beyond the capacity tuner's generic 1.5x headroom.
        s.sx[:] = rng.uniform(1.5, 3.0, n).astype(np.float32)
        s.sy[:] = rng.uniform(1.5, 3.0, n).astype(np.float32)
        # Plus centered big splats whose EXACT footprint (~24 rows x 2 cols)
        # exceeds the default 32-slot tripwire grid.
        s.sx[:4] = 30.0
        s.sy[:4] = 30.0
        s.pos[:4] = (w2 / 2.0, h2 / 2.0)
        p = to_params(s)

        # Pre-fix pin (keeps the regression meaningful): with the DEFAULT
        # 32-slot tripwire grid, the centered big splats' exact footprints
        # (~24 rows x 2 cols = 48 tiles) overflow the enumeration and
        # covered == False on a population that did not move at all --
        # i.e. the lazy cache would rebin every step.
        assert not bool(tl.pairs_covered_by(p, p, cfg, cfg.rebin_margin))

        cfg = tlf.tune_flat_config(p, cfg)
        b = tlf.bin_splats_flat(p, cfg, cfg.flat_capacity,
                                margin=cfg.rebin_margin)
        assert int(b.n_dropped) == 0, "margined superset overflowed capacity"
        # The slot grid covers the margined footprint: the tripwire accepts
        # the unchanged population (nothing moved, so the cache IS valid).
        assert bool(tl.pairs_covered_by(p, p, cfg, cfg.rebin_margin))

    def test_scan_fitter_with_flat_lazy_rebinning(self, rng):
        """The flat cached-binning scan fitter matches per-step rebinning
        (to the documented cross-program XLA Adam-fusion drift) while
        hitting the cache on most steps."""
        from gs2d_tpu.train.loop import init_train_state, make_fit_scan_fused

        cfg = SplatConfig(width=W, height=H, n_splats=64, binning="flat",
                          tile_h=32, interpret=True)
        state0 = init_train_state(cfg)
        cfg = tlf.tune_flat_config(state0.params, cfg)
        ref = synthetic_target(H, W)
        refc = rt.pad_ref_chw(jnp.asarray(ref), cfg)
        n_iters = 12

        s_base, aux_base = make_fit_scan_fused(cfg)(state0, refc, n_iters)
        assert int(np.asarray(aux_base.rebinned).sum()) == 0  # uncached path

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
