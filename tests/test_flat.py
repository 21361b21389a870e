"""Flat pair binning + the Pallas-Triton kernel (interpret mode on CPU) vs
the dense plain path and the scan renderer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.ops import render_gpu as rg
from gs2d_tpu.ops import render_tiles as rt
from gs2d_tpu.ops import tiles as tl
from gs2d_tpu.ops import tiles_flat as tlf
from gs2d_tpu.ops.render_jax import render_backward, render_forward
from tests.helpers import random_splats, to_params

H, W = 48, 64


def make_case(rng, n, **kw):
    cfg = SplatConfig(width=W, height=H, n_splats=n, interpret=True)
    s = random_splats(rng, n, W, H, **kw)
    return cfg, s, to_params(s)


def flat_of(p, cfg, margin=2.0):
    m = tlf.tune_flat_capacity(p, cfg, margin=margin)
    return tlf.bin_splats_flat(p, cfg, m), m


class TestFlatBinning:
    def test_runs_match_dense(self, rng):
        """Per-tile runs (content and order) equal the dense binner's."""
        cfg, s, p = make_case(rng, 96)
        dense = tl.bin_splats(p, cfg, 96)
        flat, m = flat_of(p, cfg)
        ids = np.asarray(flat.ids)
        start = np.asarray(flat.start)
        count = np.asarray(flat.count)
        d_ids = np.asarray(dense.ids)
        d_count = np.asarray(dense.count)
        assert int(flat.n_dropped) == 0
        np.testing.assert_array_equal(count, d_count)
        for t in range(len(count)):
            run = ids[start[t]: start[t] + count[t]]
            np.testing.assert_array_equal(run, d_ids[t, : count[t]])
        # rows between runs are padding
        live = np.zeros(m, bool)
        for t in range(len(count)):
            live[start[t]: start[t] + count[t]] = True
        assert (ids[~live] == -1).all()

    def test_runs_contiguous(self, rng):
        """Runs are packed back to back: start is the exclusive cumsum of
        the counts, and the live rows are exactly the first sum(count)."""
        cfg, s, p = make_case(rng, 64)
        flat, m = flat_of(p, cfg)
        start = np.asarray(flat.start)
        count = np.asarray(flat.count)
        np.testing.assert_array_equal(start, np.cumsum(count) - count)
        ids = np.asarray(flat.ids)
        assert (ids[: count.sum()] >= 0).all()
        assert (ids[count.sum():] == -1).all()

    @pytest.mark.parametrize("m_cap", [1, 16, 40])
    def test_capacity_overflow_counted(self, rng, m_cap):
        """Pairs past the capacity are dropped and counted, never silent:
        kept + dropped covers the uncapped pair count (dropped counts
        expansion rows, before the exact-ellipse cull)."""
        cfg, s, p = make_case(rng, 64)
        full, _ = flat_of(p, cfg)
        flat = tlf.bin_splats_flat(p, cfg, m_cap=m_cap)
        kept = int(np.asarray(flat.count).sum())
        assert kept <= m_cap and int(flat.n_dropped) > 0
        assert kept + int(flat.n_dropped) >= int(np.asarray(full.count).sum())

    def test_segmented_matches(self, rng):
        """Re-binning with a larger capacity yields identical runs."""
        cfg, s, p = make_case(rng, 96)
        a, m = flat_of(p, cfg)
        b = tlf.bin_splats_flat(p, cfg, 2 * m)
        n_live = int(np.asarray(a.count).sum())
        np.testing.assert_array_equal(np.asarray(a.ids)[:n_live],
                                      np.asarray(b.ids)[:n_live])
        np.testing.assert_array_equal(np.asarray(a.start),
                                      np.asarray(b.start))


class TestSumPairs:
    @pytest.mark.parametrize("mask_band", [False, True])
    def test_matches_scatter_add(self, rng, mask_band):
        """The fixed-order per-splat sum of pair rows equals a scatter-add
        of the same rows; rows with id -1 (padding, culled pairs, rows
        outside a sub-band) hold garbage and count as zero."""
        cfg, s, p = make_case(rng, 96)
        flat, m = flat_of(p, cfg)
        if mask_band:
            half = int(np.asarray(flat.start)[len(flat.start) // 2])
            flat = flat._replace(ids=jnp.where(
                jnp.arange(m) < half, flat.ids, -1))
        ids = np.asarray(flat.ids)
        rows = rng.normal(0, 1, (m, rg.N_GRAD_FIELDS)).astype(np.float32)
        rows[ids < 0] = np.nan
        got = rg.sum_pairs(flat, jnp.asarray(rows))
        want = rg.grads_of_rows(flat.ids, jnp.where(
            (flat.ids >= 0)[:, None], jnp.asarray(rows), 0.0), 96)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-5, atol=1e-5, err_msg=f)


class TestFlatKernels:
    @pytest.mark.parametrize("n", [32, 96])
    def test_forward_matches_scan(self, rng, n):
        cfg, s, p = make_case(rng, n)
        flat, m = flat_of(p, cfg)
        C, T = rg.forward_flat(flat, cfg)
        C1, T1 = render_forward(p, cfg)
        np.testing.assert_allclose(
            np.asarray(C)[:H, :W], np.asarray(C1), atol=3e-7)
        np.testing.assert_allclose(
            np.asarray(T)[:H, :W], np.asarray(T1), atol=3e-7)

    def test_l2_matches_dense_fused(self, rng):
        cfg, s, p = make_case(rng, 96)
        ref = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        refc = rt.pad_ref_chw(jnp.asarray(ref), cfg)

        dense = tl.bin_splats(p, cfg, 96)
        C_d, g_d = rt.l2_render_and_grads(dense, refc, 96, cfg, p)

        flat, m = flat_of(p, cfg)
        C_f, g_f = rg.l2_render_and_grads_flat(flat, refc, 96, cfg, p)

        np.testing.assert_allclose(np.asarray(C_f), np.asarray(C_d),
                                   atol=3e-7)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            a = np.asarray(getattr(g_d, f))
            b = np.asarray(getattr(g_f, f))
            atol = 1e-5 * max(1.0, np.abs(a).max())
            np.testing.assert_allclose(b, a, atol=atol, err_msg=f)

    def test_backward_matches_scan(self, rng):
        cfg, s, p = make_case(rng, 64)
        flat, m = flat_of(p, cfg)
        C1, _ = render_forward(p, cfg)
        gC = jnp.asarray(
            rng.uniform(-1, 1, (H, W, 3)).astype(np.float32))
        g1 = render_backward(p, C1, gC, cfg)

        hp, wp = cfg.padded_height, cfg.padded_width
        fin_p = jnp.zeros((hp, wp, 3)).at[:H, :W].set(C1)
        gC_p = jnp.zeros((hp, wp, 3)).at[:H, :W].set(gC)
        g2 = rg.backward_flat(flat, fin_p, gC_p, 64, cfg, p)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            a = np.asarray(getattr(g1, f))
            b = np.asarray(getattr(g2, f))
            atol = 1e-4 * max(1.0, np.abs(a).max())
            np.testing.assert_allclose(b, a, atol=atol, err_msg=f)

    def test_train_step_flat_matches_dense(self, rng):
        """make_train_step_fused with binning='flat' == binning='dense'."""
        from gs2d_tpu.io.image import synthetic_target
        from gs2d_tpu.train.loop import init_train_state, make_train_step_fused

        base = SplatConfig(width=W, height=H, n_splats=64)
        ref = synthetic_target(H, W)
        state = init_train_state(base)

        cfg_d = base.replace(binning="dense", max_splats_per_tile=64)
        refc = rt.pad_ref_chw(jnp.asarray(ref), cfg_d)
        s_d, aux_d = make_train_step_fused(cfg_d)(state, refc)

        cfg_f = tlf.tune_flat_config(
            init_train_state(base).params,
            base.replace(binning="flat", interpret=True))
        s_f, aux_f = make_train_step_fused(cfg_f)(state, refc)

        assert np.isclose(float(aux_f.mse), float(aux_d.mse), rtol=1e-6)
        assert int(aux_f.n_dropped) == 0
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            np.testing.assert_allclose(
                np.asarray(getattr(s_f.params, f)),
                np.asarray(getattr(s_d.params, f)),
                rtol=1e-4, atol=2e-3, err_msg=f)

    def test_split_step_matches_combined(self, rng, monkeypatch):
        """The two-program (bin | kernels+adam) step for huge flat
        capacities == the single-program step."""
        import gs2d_tpu.train.loop as loop
        from gs2d_tpu.io.image import synthetic_target
        from gs2d_tpu.train.loop import init_train_state

        base = SplatConfig(width=W, height=H, n_splats=64)
        cfg_f = tlf.tune_flat_config(
            init_train_state(base).params,
            base.replace(binning="flat", interpret=True))
        ref = synthetic_target(H, W)
        refc = rt.pad_ref_chw(jnp.asarray(ref), cfg_f)
        state = init_train_state(cfg_f)

        loop.make_train_step_fused.cache_clear()
        loop._make_split_step_fused.cache_clear()
        s_one, aux_one = loop.make_train_step_fused(cfg_f)(state, refc)

        monkeypatch.setattr(loop, "SPLIT_STEP_ROWS", 0)
        loop.make_train_step_fused.cache_clear()
        s_two, aux_two = loop.make_train_step_fused(cfg_f)(state, refc)
        loop.make_train_step_fused.cache_clear()

        assert np.isclose(float(aux_two.mse), float(aux_one.mse), rtol=1e-6)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            np.testing.assert_allclose(
                np.asarray(getattr(s_two.params, f)),
                np.asarray(getattr(s_one.params, f)),
                rtol=1e-6, atol=1e-6, err_msg=f)

    def test_banded_matches_full(self, rng):
        """Two bands rendered/differentiated separately == the full image
        (the 4K band-streaming building block)."""
        cfg, s, p = make_case(rng, 64)
        ref = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        refc = rt.pad_ref_chw(jnp.asarray(ref), cfg)
        flat_full, m = flat_of(p, cfg)
        C_full, g_full = rg.l2_render_and_grads_flat(flat_full, refc, 64,
                                                     cfg, p)

        rows = cfg.n_tiles_y // 2
        th = cfg.tile_h
        g_acc = None
        bands = []
        for b in range(2):
            r0 = b * rows
            m_b = tlf.tune_flat_capacity(p, cfg, margin=2.0)
            fb = tlf.bin_splats_flat(p, cfg, m_b, band_row0=r0,
                                     band_rows=rows)
            ref_band = refc[:, :, r0 * th:(r0 + rows) * th, :]
            C_b, g_b = rg.l2_render_and_grads_flat(
                fb, ref_band, 64, cfg, p, band_row0=r0, band_rows=rows)
            bands.append(C_b)
            g_acc = g_b if g_acc is None else jax.tree.map(
                jnp.add, g_acc, g_b)
        C_j = jnp.concatenate(bands, axis=0)[:H, :W]
        np.testing.assert_allclose(np.asarray(C_j), np.asarray(C_full),
                                   atol=3e-7)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            a = np.asarray(getattr(g_full, f))
            b_ = np.asarray(getattr(g_acc, f))
            atol = 1e-5 * max(1.0, np.abs(a).max())
            np.testing.assert_allclose(b_, a, atol=atol, err_msg=f)
