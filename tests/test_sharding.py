"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Validates the net-new distributed layer (SURVEY.md section 2 table 2):
tile-axis (band) sharding, splat-axis ordered-monoid sharding, data-axis
batching, and their composition -- all against the single-device renderer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.io.image import synthetic_target
from gs2d_tpu.ops.render_jax import render_forward
from gs2d_tpu.ops.render_tiles import tune_binning
from gs2d_tpu.params import init_params
from gs2d_tpu.parallel.mesh import make_mesh
from gs2d_tpu.parallel.sharded import (
    fit_sharded, init_batched_state, make_sharded_train_step, pad_ref_batch)
from gs2d_tpu.train.loop import init_train_state, make_train_step

H, W = 32, 64  # padded height 32 divides tile axes 1/2/4


def cfg_for(n_splats=64, **kw):
    return SplatConfig(width=W, height=H, n_splats=n_splats, **kw)


def single_device_reference(cfg, ref, iters):
    state = init_train_state(cfg)
    step = make_train_step(cfg)
    for _ in range(iters):
        state, aux = step(state, ref)
    return state, float(aux.mse)


MESHES = [
    {"data": 1, "tile": 1, "splat": 1},
    {"data": 1, "tile": 4, "splat": 1},
    {"data": 1, "tile": 1, "splat": 4},
    {"data": 1, "tile": 2, "splat": 2},
    {"data": 2, "tile": 2, "splat": 2},
]


class TestShardedTraining:
    @pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
        f"{k}{v}" for k, v in a.items()))
    def test_matches_single_device(self, axes):
        """A few sharded iterations track the unsharded step.

        With splat sharding the early-out is disabled (exact monoid), so the
        comparison uses min_throughput=0 everywhere for an apples-to-apples
        check at tight tolerance.
        """
        cfg = cfg_for(min_throughput=0.0)
        ref = jnp.asarray(synthetic_target(H, W))
        want_state, want_mse = single_device_reference(cfg, ref, 3)

        mesh = make_mesh(**axes)
        batch = axes["data"]
        refs = jnp.broadcast_to(ref[None], (batch, H, W, 3))
        state, hist = fit_sharded(refs, cfg, mesh, iterations=3, log_every=1,
                                  log_fn=None)
        # Post-Adam parameters: Adam's m/(sqrt(v)+eps) normalization can
        # amplify a 1-ulp gradient difference on a near-zero-gradient splat
        # to O(lr) in one step, so the bound here is a fraction of lr=0.05;
        # gradients themselves are compared tightly in
        # test_grad_psum_over_tiles / the renderer parity tests.
        for b in range(batch):
            np.testing.assert_allclose(
                np.asarray(state.params.pos)[b], np.asarray(want_state.params.pos),
                rtol=1e-4, atol=2e-2)
            np.testing.assert_allclose(
                np.asarray(state.params.color)[b],
                np.asarray(want_state.params.color), rtol=1e-4, atol=2e-2)
        assert np.allclose(hist[-1]["mse"], want_mse, rtol=1e-3)

    @pytest.mark.parametrize("axes", [MESHES[3], MESHES[4]],
                             ids=lambda a: "x".join(
                                 f"{k}{v}" for k, v in a.items()))
    def test_matches_single_device_tight_at_small_lr(self, axes):
        """Pin the sharded update math tighter than the production-lr test
        above: Adam amplifies a 1-ulp gradient difference to O(lr) on
        near-zero-gradient parameters, so at lr=1e-4 the post-Adam
        parameter drift must shrink to atol 1e-4 -- catching any real
        (non-noise) divergence the loose production check could hide."""
        cfg = cfg_for(min_throughput=0.0, learning_rate=1e-4)
        ref = jnp.asarray(synthetic_target(H, W))
        want_state, _ = single_device_reference(cfg, ref, 3)

        mesh = make_mesh(**axes)
        batch = axes["data"]
        refs = jnp.broadcast_to(ref[None], (batch, H, W, 3))
        state, _ = fit_sharded(refs, cfg, mesh, iterations=3, log_fn=None)
        for b in range(batch):
            for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
                np.testing.assert_allclose(
                    np.asarray(getattr(state.params, f))[b],
                    np.asarray(getattr(want_state.params, f)),
                    atol=1e-4, err_msg=f)

    def test_thresholded_vs_monoid_bounded(self):
        """With the reference threshold on, splat sharding deviates by at
        most ~1/256 per channel from the sequential semantics."""
        cfg = cfg_for(96)
        ref = jnp.asarray(synthetic_target(H, W))
        p = init_params(cfg)
        C_seq, _ = render_forward(p, cfg)
        C_mono, _ = render_forward(p, cfg.replace(min_throughput=0.0))
        assert float(jnp.abs(C_seq - C_mono).max()) <= 1.0 / 256.0 + 1e-5

    def test_data_axis_independence(self):
        """Different targets on the data axis evolve independently."""
        cfg = cfg_for(min_throughput=0.0)
        mesh = make_mesh(data=2, tile=2, splat=2)
        refs = jnp.stack([synthetic_target(H, W, seed=0),
                          synthetic_target(H, W, seed=3)])
        state, hist = fit_sharded(refs, cfg, mesh, iterations=2)
        # populations must have diverged from each other
        d = np.abs(np.asarray(state.params.color[0])
                   - np.asarray(state.params.color[1])).max()
        assert d > 1e-5
        # and each matches its own single-device fit
        for b in range(2):
            want, _ = single_device_reference(cfg, refs[b], 2)
            np.testing.assert_allclose(
                np.asarray(state.params.color)[b], np.asarray(want.params.color),
                rtol=1e-4, atol=1e-4)

    def test_grad_psum_over_tiles(self):
        """Tile-sharded gradients equal full-image gradients (psum check)."""
        from gs2d_tpu.ops.render_jax import render_backward
        cfg = cfg_for(min_throughput=0.0)
        ref = jnp.asarray(synthetic_target(H, W))
        mesh = make_mesh(tile=4)
        step, shardings = make_sharded_train_step(cfg, mesh)
        state = init_batched_state(cfg, 1)
        refs = pad_ref_batch(ref[None], cfg)
        new_state, aux = step(jax.device_put(state, shardings["state"]),
                              jax.device_put(refs, shardings["ref"]))
        # compare against the unsharded step
        sstate = init_train_state(cfg)
        sstep = make_train_step(cfg)
        want, _ = sstep(sstate, ref)
        np.testing.assert_allclose(
            np.asarray(new_state.params.pos)[0], np.asarray(want.params.pos),
            rtol=1e-5, atol=1e-5)

    def test_mesh_validation(self):
        cfg = cfg_for(n_splats=50)  # 50 doesn't divide by 4
        with pytest.raises(ValueError):
            make_sharded_train_step(cfg, make_mesh(splat=4))


class TestRingScanCombine:
    @pytest.mark.parametrize("splat", [2, 4, 8])
    def test_scan_matches_fold(self, splat):
        """The log-depth ppermute ordered combine == the all_gather fold."""
        cfg = cfg_for(64, min_throughput=0.0)
        ref = jnp.asarray(synthetic_target(H, W))
        mesh = make_mesh(splat=splat)
        refs = pad_ref_batch(ref[None], cfg)
        out = {}
        for combine in ("fold", "scan"):
            step, sh = make_sharded_train_step(cfg, mesh, combine=combine)
            state = jax.device_put(init_batched_state(cfg, 1), sh["state"])
            r = jax.device_put(refs, sh["ref"])
            new_state, aux = step(state, r)
            out[combine] = (new_state, float(aux.mse[0]))
        a, b = out["fold"][0], out["scan"][0]
        for x, y in zip(jax.tree.leaves(a.params), jax.tree.leaves(b.params)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=1e-5, atol=2e-4)
        assert np.isclose(out["fold"][1], out["scan"][1], rtol=1e-5)


class TestShardedPallasRenderer:
    @pytest.mark.parametrize("axes", [
        {"splat": 1}, {"splat": 2}, {"splat": 4},
        {"tile": 2}, {"tile": 4}, {"tile": 2, "splat": 2},
        {"data": 2, "tile": 2, "splat": 2},
    ], ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
    @pytest.mark.parametrize("layout", ["dense", "flat"])
    def test_pallas_matches_scan(self, axes, layout):
        """Sharded tile rasterization (the plain path, and the GPU kernel in
        interpret mode, inside shard_map) == the scan path on the same
        mesh, for splat, tile, and combined sharding."""
        cfg = cfg_for(32, min_throughput=0.0, max_splats_per_tile=32,
                      binning=layout, interpret=True)
        cfg = tune_binning(init_params(cfg), cfg, n_bands=axes.get("tile", 1))
        ref = jnp.asarray(synthetic_target(H, W))
        mesh = make_mesh(**axes)
        batch = axes.get("data", 1)
        refs = pad_ref_batch(jnp.broadcast_to(ref[None], (batch, H, W, 3)), cfg)
        out = {}
        for renderer in ("scan", "tiles"):
            step, sh = make_sharded_train_step(cfg, mesh, renderer=renderer)
            state = jax.device_put(init_batched_state(cfg, batch), sh["state"])
            r = jax.device_put(refs, sh["ref"])
            new_state, aux = step(state, r)
            out[renderer] = (new_state, float(aux.mse[0]))
        assert np.isclose(out["scan"][1], out["tiles"][1], rtol=1e-5)
        for x, y in zip(jax.tree.leaves(out["scan"][0].params),
                        jax.tree.leaves(out["tiles"][0].params)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=1e-4, atol=2e-3)

    @pytest.mark.parametrize("axes", [
        {"splat": 2}, {"tile": 2}, {"tile": 2, "splat": 2},
    ], ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
    def test_flat_binning_matches_scan(self, axes):
        """Sharded kernel on the FLAT pair binning == the scan path on the
        same mesh (each device flat-bins its own band; with splat shards
        the monoid combine sits between forward_flat and backward_flat)."""
        cfg = cfg_for(32, min_throughput=0.0, binning="flat", interpret=True)
        cfg_flat = tune_binning(
            init_params(cfg), cfg, n_bands=axes.get("tile", 1))
        ref = jnp.asarray(synthetic_target(H, W))
        mesh = make_mesh(**axes)
        refs = pad_ref_batch(ref[None], cfg_flat)
        out = {}
        for renderer in ("scan", "tiles"):
            step, sh = make_sharded_train_step(cfg_flat, mesh,
                                               renderer=renderer)
            state = jax.device_put(init_batched_state(cfg_flat, 1),
                                   sh["state"])
            r = jax.device_put(refs, sh["ref"])
            new_state, aux = step(state, r)
            out[renderer] = (new_state, float(aux.mse[0]))
        assert np.isclose(out["scan"][1], out["tiles"][1], rtol=1e-5)
        for x, y in zip(jax.tree.leaves(out["scan"][0].params),
                        jax.tree.leaves(out["tiles"][0].params)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=1e-4, atol=2e-3)

    @pytest.mark.parametrize("axes", [{"tile": 2}, {"tile": 2, "splat": 2}])
    def test_flat_overlap_chunks_equivalent(self, axes):
        """Chunked backward + per-chunk grad psum under the flat layout ==
        the single-psum form (sub-band id masking drops unwritten rows)."""
        cfg = cfg_for(32, min_throughput=0.0, binning="flat", interpret=True)
        cfg_flat = tune_binning(
            init_params(cfg), cfg, n_bands=axes["tile"])
        ref = jnp.asarray(synthetic_target(H, W))
        mesh = make_mesh(**axes)
        refs = pad_ref_batch(ref[None], cfg_flat)
        out = {}
        for oc in (1, 2):  # band is 2 tile rows on this mesh
            step, sh = make_sharded_train_step(cfg_flat, mesh,
                                               renderer="tiles",
                                               overlap_chunks=oc)
            state = jax.device_put(init_batched_state(cfg_flat, 1),
                                   sh["state"])
            r = jax.device_put(refs, sh["ref"])
            new_state, aux = step(state, r)
            out[oc] = (new_state, float(aux.mse[0]))
        assert np.isclose(out[1][1], out[2][1], rtol=1e-6)
        for x, y in zip(jax.tree.leaves(out[1][0].params),
                        jax.tree.leaves(out[2][0].params)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("axes", [{"tile": 2}, {"tile": 2, "splat": 2}])
    def test_overlap_chunks_equivalent(self, axes):
        """Chunked backward + per-chunk grad psum (the overlapped all-reduce
        structure) == the single-psum form, for both the L2 (splat=1) and
        split (splat>1) plain tile paths."""
        cfg = cfg_for(32, min_throughput=0.0, max_splats_per_tile=32,
                      binning="dense")
        ref = jnp.asarray(synthetic_target(H, W))
        mesh = make_mesh(**axes)
        refs = pad_ref_batch(ref[None], cfg)
        out = {}
        for oc in (1, 2):  # band is 2 tile rows on this mesh
            step, sh = make_sharded_train_step(cfg, mesh, renderer="tiles",
                                               overlap_chunks=oc)
            state = jax.device_put(init_batched_state(cfg, 1), sh["state"])
            r = jax.device_put(refs, sh["ref"])
            new_state, aux = step(state, r)
            out[oc] = (new_state, float(aux.mse[0]))
        assert np.isclose(out[1][1], out[2][1], rtol=1e-6)
        for x, y in zip(jax.tree.leaves(out[1][0].params),
                        jax.tree.leaves(out[2][0].params)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=1e-5, atol=1e-4)


class TestShardedSaturatingWalk:
    def test_flat_banded_saturating_matches_scan(self, monkeypatch):
        """The kernel's saturation exit under tile-axis band sharding, at a
        check after every pair. Only tile sharding: with splat shards the
        threshold is auto-disabled, which makes the exit a structural
        no-op."""
        from gs2d_tpu.ops import render_gpu as rg

        monkeypatch.setattr(rg, "SAT_CHECK_EVERY", 1)
        # Opaque population so bands actually saturate mid-list.
        cfg = cfg_for(48, binning="flat", interpret=True)
        cfg_flat = tune_binning(init_params(cfg), cfg, n_bands=2)
        ref = jnp.asarray(synthetic_target(H, W))
        mesh = make_mesh(tile=2)
        refs = pad_ref_batch(ref[None], cfg_flat)
        out = {}
        for renderer in ("scan", "tiles"):
            step, sh = make_sharded_train_step(cfg_flat, mesh,
                                               renderer=renderer)
            state = jax.device_put(init_batched_state(cfg_flat, 1),
                                   sh["state"])
            r = jax.device_put(refs, sh["ref"])
            new_state, aux = step(state, r)
            out[renderer] = (new_state, float(aux.mse[0]))
        assert np.isclose(out["scan"][1], out["tiles"][1], rtol=1e-5)
        for x, y in zip(jax.tree.leaves(out["scan"][0].params),
                        jax.tree.leaves(out["tiles"][0].params)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=1e-4, atol=2e-3)


class TestScannedShardedFitter:
    """make_fit_scan_sharded: the on-device scanned sharded fitter
    (shard_map(lax.scan(step))) must match the per-step sharded driver on
    every mesh shape and binning layout, with lazy rebinning carried in
    the scan state per device band (net-new; the reference's hot loop is
    main.cpp:334-851)."""

    @pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
        f"{k}{v}" for k, v in a.items()))
    def test_scan_renderer_matches_stepwise(self, axes):
        from gs2d_tpu.parallel.sharded import make_fit_scan_sharded

        cfg = cfg_for(min_throughput=0.0)
        ref = jnp.asarray(synthetic_target(H, W))
        mesh = make_mesh(**axes)
        batch = axes["data"]
        refs = jnp.broadcast_to(ref[None], (batch, H, W, 3))
        want, hist = fit_sharded(refs, cfg, mesh, iterations=3, log_fn=None)

        fit_k, sh = make_fit_scan_sharded(cfg, mesh, renderer="scan")
        state = jax.device_put(init_batched_state(cfg, batch), sh["state"])
        refs_p = jax.device_put(pad_ref_batch(refs, cfg), sh["ref"])
        state, auxes = fit_k(state, refs_p, 3)
        assert auxes.mse.shape == (3, batch)
        assert bool(np.asarray(auxes.all_finite).all())
        for f in ("pos", "color"):
            np.testing.assert_allclose(
                np.asarray(getattr(state.params, f)),
                np.asarray(getattr(want.params, f)),
                rtol=1e-4, atol=2e-2, err_msg=f)

    @pytest.mark.parametrize("layout,margin", [
        ("dense", 0.0), ("flat", 0.0), ("flat", 2.0)])
    def test_pallas_layouts_and_lazy_rebinning(self, layout, margin):
        """Scanned tile fitter on a (1,2,2) mesh == the eager per-step
        sharded tile step; with rebin_margin > 0 the cached binning is
        carried across scan iterations per device band."""
        from gs2d_tpu.parallel.sharded import (make_fit_scan_sharded,
                                               make_sharded_train_step)

        mesh = make_mesh(data=1, tile=2, splat=2)
        cfg = cfg_for(min_throughput=0.0, max_splats_per_tile=64,
                      binning=layout, rebin_margin=margin, interpret=True)
        cfg = tune_binning(init_params(cfg), cfg, n_bands=2)
        ref = jnp.asarray(synthetic_target(H, W))
        refs = jnp.broadcast_to(ref[None], (1, H, W, 3))

        step, sh = make_sharded_train_step(
            cfg.replace(rebin_margin=0.0), mesh, renderer="tiles")
        st_ref = jax.device_put(init_batched_state(cfg, 1), sh["state"])
        refs_p = jax.device_put(pad_ref_batch(refs, cfg), sh["ref"])
        for _ in range(3):
            st_ref, aux = step(st_ref, refs_p)

        fit_k, sh2 = make_fit_scan_sharded(cfg, mesh, renderer="tiles")
        state = jax.device_put(init_batched_state(cfg, 1), sh2["state"])
        state, auxes = fit_k(state, refs_p, 3)
        np.testing.assert_allclose(
            float(np.asarray(auxes.mse)[-1, 0]), float(aux.mse[0]),
            rtol=1e-5)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            np.testing.assert_allclose(
                np.asarray(getattr(state.params, f)),
                np.asarray(getattr(st_ref.params, f)),
                rtol=1e-4, atol=2e-2, err_msg=f)

    def test_lazy_rebin_fires_on_margin_escape(self):
        """Force a rebin: after a step with a huge lr the footprints move
        past the margin, so the second step must rebin (rebinned=1) and
        still match eager binning."""
        from gs2d_tpu.parallel.sharded import make_fit_scan_sharded

        mesh = make_mesh(tile=2)
        cfg = cfg_for(min_throughput=0.0, binning="flat", interpret=True,
                      rebin_margin=0.5, learning_rate=3.0)
        cfg = tune_binning(init_params(cfg), cfg, n_bands=2)
        ref = jnp.asarray(synthetic_target(H, W))
        refs = jnp.broadcast_to(ref[None], (1, H, W, 3))
        fit_k, sh = make_fit_scan_sharded(cfg, mesh, renderer="tiles")
        state = jax.device_put(init_batched_state(cfg, 1), sh["state"])
        refs_p = jax.device_put(pad_ref_batch(refs, cfg), sh["ref"])
        state, auxes = fit_k(state, refs_p, 4)
        reb = np.asarray(auxes.rebinned)
        assert reb.dtype == np.int32 and reb.shape == (4,)
        assert reb[1:].sum() >= 1, "lr=3.0 moves splats past 0.5px margin"
        # eager reference trajectory
        cfg0 = cfg.replace(rebin_margin=0.0)
        fit_k0, sh0 = make_fit_scan_sharded(cfg0, mesh, renderer="tiles")
        st0 = jax.device_put(init_batched_state(cfg0, 1), sh0["state"])
        st0, _ = fit_k0(st0, refs_p, 4)
        np.testing.assert_allclose(
            np.asarray(state.params.pos), np.asarray(st0.params.pos),
            rtol=1e-4, atol=2e-2)

    def test_fit_sharded_scan_chunk_with_densify(self):
        """The host driver's scan_chunk path: blocks clip to densify
        boundaries, pos_grad_mag accumulates across blocks, populations
        stay finite and capacity-stable."""
        from gs2d_tpu.train.densify import live_mask

        mesh = make_mesh(data=2, tile=2, splat=2)
        cfg = cfg_for(min_throughput=0.0, binning="flat", interpret=True,
                      rebin_margin=2.0)
        ref = jnp.asarray(synthetic_target(H, W))
        refs = jnp.broadcast_to(ref[None], (2, H, W, 3))
        state, hist = fit_sharded(
            refs, cfg, mesh, iterations=8, log_every=4, log_fn=None,
            renderer="tiles", scan_chunk=3, densify_every=4)
        assert np.isfinite(np.asarray(state.params.pos)).all()
        assert state.params.pos.shape[1] == cfg.n_splats  # static capacity
        assert int(live_mask(jax.tree.map(
            lambda x: x[0], state.params)).sum()) > 0
        assert hist and len(hist[-1]["mse"]) == 2


class TestShardedCheckpointing:
    def test_scan_chunk_checkpoint_resume_bitwise(self, tmp_path):
        """fit_sharded(scan_chunk, checkpoint_every): a fit resumed from
        its checkpoint continues the exact trajectory of an unbroken run
        (the reference's resume contract, main.cpp:271-278, under the
        mesh)."""
        from gs2d_tpu.io.checkpoint import Checkpointer
        from gs2d_tpu.parallel.sharded import init_batched_state

        mesh = make_mesh(tile=2, splat=2)
        cfg = cfg_for(min_throughput=0.0, binning="flat", interpret=True,
                      rebin_margin=2.0)
        cfg = tune_binning(init_params(cfg), cfg, n_bands=2)
        ref = jnp.asarray(synthetic_target(H, W))
        refs = jnp.broadcast_to(ref[None], (1, H, W, 3))

        full, _ = fit_sharded(refs, cfg, mesh, iterations=6, log_fn=None,
                              renderer="tiles", scan_chunk=3)

        ck = Checkpointer(str(tmp_path / "ck"))
        half, _ = fit_sharded(
            refs, cfg, mesh, iterations=3, log_fn=None,
            renderer="tiles", scan_chunk=3,
            checkpoint_every=3, checkpoint_fn=lambda s, it: ck.save(it, s))
        step, restored = ck.restore_latest(init_batched_state(cfg, 1))
        assert step == 3
        resumed, _ = fit_sharded(refs, cfg, mesh, iterations=3,
                                 state=restored, log_fn=None,
                                 renderer="tiles", scan_chunk=3)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            np.testing.assert_array_equal(
                np.asarray(getattr(resumed.params, f)),
                np.asarray(getattr(full.params, f)), err_msg=f)
