"""SSIM objective: window statistics vs a dense NumPy implementation, and
the mixed loss actually optimizing through the analytic render VJP."""

import jax
import jax.numpy as jnp
import numpy as np

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.io.image import synthetic_target
from gs2d_tpu.train.ssim import mixed_loss, ssim


def ssim_numpy(a, b, window=11, sigma=1.5, data_range=1.0):
    """Dense reference: explicit 2-D Gaussian window, same SAME padding."""
    x = np.arange(window) - (window - 1) / 2.0
    k1 = np.exp(-0.5 * (x / sigma) ** 2)
    k1 /= k1.sum()
    k2 = np.outer(k1, k1)

    def blur(img):
        out = np.zeros_like(img)
        h, w = img.shape[:2]
        ph = pw = window // 2
        pad = np.zeros((h + 2 * ph, w + 2 * pw) + img.shape[2:], img.dtype)
        pad[ph:ph + h, pw:pw + w] = img
        for dy in range(window):
            for dx in range(window):
                out += k2[dy, dx] * pad[dy:dy + h, dx:dx + w]
        return out

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a ** 2
    var_b = blur(b * b) - mu_b ** 2
    cov = blur(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(s.mean())


class TestSsim:
    def test_identity(self, rng):
        a = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
        assert np.isclose(float(ssim(jnp.asarray(a), jnp.asarray(a))), 1.0,
                          atol=1e-6)

    def test_matches_dense_numpy(self, rng):
        a = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
        got = float(ssim(jnp.asarray(a), jnp.asarray(b)))
        want = ssim_numpy(a, b)
        assert np.isclose(got, want, atol=2e-4), (got, want)

    def test_noise_lowers_ssim_more_than_shift(self, rng):
        """Structural property: constant luminance shift barely moves SSIM,
        structured noise of the same L2 magnitude hurts it."""
        a = synthetic_target(32, 40)
        shift = np.clip(a + 0.05, 0, 1)
        noise = np.clip(
            a + rng.choice([-0.05, 0.05], a.shape).astype(np.float32), 0, 1)
        s_shift = float(ssim(jnp.asarray(a), jnp.asarray(shift)))
        s_noise = float(ssim(jnp.asarray(a), jnp.asarray(noise)))
        assert s_shift > s_noise


class TestSsimTraining:
    def test_fit_with_ssim_converges(self, rng):
        """The mixed objective descends through the analytic custom VJP
        (modular path) and ends with higher SSIM than at init."""
        from gs2d_tpu.ops.render_jax import render
        from gs2d_tpu.train.loop import fit, init_train_state

        cfg = SplatConfig(width=64, height=48, n_splats=64)
        ref = jnp.asarray(synthetic_target(48, 64))
        s0 = init_train_state(cfg)
        ssim0 = float(ssim(render(s0.params, cfg), ref))
        state, hist = fit(ref, cfg, iterations=40, state=s0, log_every=20,
                          log_fn=None, ssim_lambda=0.2)
        assert hist[-1]["mse"] < hist[0]["mse"]
        ssim1 = float(ssim(render(state.params, cfg), ref))
        assert ssim1 > ssim0

    def test_lambda_zero_matches_l2_step(self, rng):
        """ssim_lambda=0 must be the reference objective exactly (same
        factory path, no behavior change)."""
        from gs2d_tpu.train.loop import fit, init_train_state

        cfg = SplatConfig(width=64, height=48, n_splats=32)
        ref = jnp.asarray(synthetic_target(48, 64))
        s0 = init_train_state(cfg)
        s_a, _ = fit(ref, cfg, iterations=3, state=s0, log_fn=None)
        s_b, _ = fit(ref, cfg, iterations=3, state=s0, log_fn=None,
                     ssim_lambda=0.0)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            np.testing.assert_array_equal(
                np.asarray(getattr(s_a.params, f)),
                np.asarray(getattr(s_b.params, f)))

    def test_mixed_loss_gradients_finite(self, rng):
        from gs2d_tpu.ops.render_jax import render
        from gs2d_tpu.params import init_params

        cfg = SplatConfig(width=64, height=48, n_splats=32)
        ref = jnp.asarray(synthetic_target(48, 64))
        p = init_params(cfg)
        g = jax.grad(
            lambda q: mixed_loss(render(q, cfg), ref, 0.5))(p)
        for leaf in jax.tree.leaves(g):
            assert np.isfinite(np.asarray(leaf)).all()


class TestSsimProductionKernels:
    """The mixed objective through production_render (the plain path and
    the GPU kernel in interpret mode, with an arbitrary autodiffed
    cotangent) must match the scan-path custom VJP."""

    def _grads(self, render_fn, p, ref, cfg):
        return jax.grad(
            lambda q: mixed_loss(render_fn(q, cfg), ref, 0.3))(p)

    def _check(self, cfg, rng):
        from gs2d_tpu.ops.render_jax import render as render_scan
        from gs2d_tpu.ops.render_tiles import production_render
        from gs2d_tpu.params import init_params

        ref = jnp.asarray(synthetic_target(cfg.height, cfg.width))
        p = init_params(cfg)
        want = self._grads(render_scan, p, ref, cfg)
        got = self._grads(production_render, p, ref, cfg)
        for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
            a = np.asarray(getattr(want, f))
            b = np.asarray(getattr(got, f))
            atol = 1e-4 * max(1.0, np.abs(a).max())
            np.testing.assert_allclose(b, a, atol=atol, err_msg=f)

    def test_dense(self, rng):
        self._check(SplatConfig(width=64, height=48, n_splats=32,
                                binning="dense", max_splats_per_tile=32,
                                tile_h=32), rng)

    def test_resident(self, rng):
        """The kernel at a 16x16 tile, the production tile shape."""
        from gs2d_tpu.ops.tiles_flat import tune_flat_config
        from gs2d_tpu.params import init_params

        cfg = SplatConfig(width=64, height=48, n_splats=32, binning="flat",
                          interpret=True, tile_h=16, tile_w=16)
        cfg = tune_flat_config(init_params(cfg), cfg)
        self._check(cfg, rng)

    def test_flat(self, rng):
        from gs2d_tpu.ops.tiles_flat import tune_flat_config
        from gs2d_tpu.params import init_params

        cfg = SplatConfig(width=64, height=48, n_splats=32, binning="flat",
                          interpret=True, tile_h=32)
        cfg = tune_flat_config(init_params(cfg), cfg)
        self._check(cfg, rng)


class TestSsimSharded:
    """The mixed objective under the (data, tile, splat) mesh: SSIM
    windows cross band boundaries, so the sharded step gathers the image
    for the loss head; a few sharded iterations must track the
    single-device mixed fit (post-Adam tolerance as in test_sharding)."""

    def _run(self, axes, renderer):
        from gs2d_tpu.parallel.mesh import make_mesh
        from gs2d_tpu.parallel.sharded import fit_sharded
        from gs2d_tpu.train.loop import fit, init_train_state

        cfg = SplatConfig(width=64, height=32, n_splats=32,
                          min_throughput=0.0, max_splats_per_tile=32)
        ref = jnp.asarray(synthetic_target(32, 64))
        want, _ = fit(ref, cfg, iterations=3, state=init_train_state(cfg),
                      log_fn=None, ssim_lambda=0.2)
        mesh = make_mesh(**axes)
        got, _ = fit_sharded(ref[None], cfg, mesh, iterations=3,
                             log_fn=None, renderer=renderer,
                             ssim_lambda=0.2)
        for f in ("pos", "color", "opacity"):
            np.testing.assert_allclose(
                np.asarray(getattr(got.params, f))[0],
                np.asarray(getattr(want.params, f)),
                rtol=1e-4, atol=2e-2, err_msg=f)

    def test_scan_mesh(self):
        self._run({"data": 1, "tile": 2, "splat": 2}, "scan")

    def test_pallas_mesh(self):
        self._run({"data": 1, "tile": 2, "splat": 2}, "tiles")

    def test_pallas_tile_only(self):
        self._run({"data": 1, "tile": 4, "splat": 1}, "tiles")

    def test_scanned_sharded_fitter_ssim(self):
        """The on-device scanned sharded fitter with the mixed objective
        (forces the split fwd/cot_fn/bwd structure even at one splat
        shard) matches the per-step sharded driver."""
        from gs2d_tpu.parallel.mesh import make_mesh
        from gs2d_tpu.parallel.sharded import (
            fit_sharded, init_batched_state, make_fit_scan_sharded,
            pad_ref_batch)

        cfg = SplatConfig(width=64, height=32, n_splats=32,
                          min_throughput=0.0, max_splats_per_tile=32)
        ref = jnp.asarray(synthetic_target(32, 64))
        mesh = make_mesh(data=1, tile=2, splat=2)
        want, _ = fit_sharded(ref[None], cfg, mesh, iterations=3,
                              log_fn=None, renderer="tiles",
                              ssim_lambda=0.2)
        fit_k, sh = make_fit_scan_sharded(cfg, mesh, renderer="tiles",
                                          ssim_lambda=0.2)
        import jax as _jax
        state = _jax.device_put(init_batched_state(cfg, 1), sh["state"])
        refs_p = _jax.device_put(pad_ref_batch(ref[None], cfg), sh["ref"])
        state, auxes = fit_k(state, refs_p, 3)
        assert bool(np.asarray(auxes.all_finite).all())
        for f in ("pos", "color", "opacity"):
            np.testing.assert_allclose(
                np.asarray(getattr(state.params, f)),
                np.asarray(getattr(want.params, f)),
                rtol=1e-4, atol=1e-3, err_msg=f)
