"""Density-control tests: static-capacity prune/clone/split semantics."""

import jax
import jax.numpy as jnp
import numpy as np

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.io.image import synthetic_target
from gs2d_tpu.ops.render_jax import l2_loss
from gs2d_tpu.train.densify import (
    DEAD_POS, densify_and_prune, live_mask, n_live)
from gs2d_tpu.train.loop import fit, init_train_state

H, W = 32, 64


def test_prune_degenerate_and_fill():
    cfg = SplatConfig(width=W, height=H, n_splats=16)
    state = init_train_state(cfg)
    p = state.params
    # collapse splats 0..3 to the scale floor -> prune targets
    p = p.replace(sx=p.sx.at[:4].set(1.0), sy=p.sy.at[:4].set(1.0))
    state = state.replace(params=p)
    # big position gradients on splats 8..11 -> donors
    g = jnp.zeros((16,)).at[8:12].set(10.0)
    new = densify_and_prune(state, g, cfg)
    # population stays at capacity; pruned slots were refilled by clones
    assert int(n_live(new.params)) == 16
    # children carry donor colors/scales near the donors'
    assert np.isfinite(np.asarray(new.params.pos)).all()


def test_prune_without_donors_leaves_dead_slots():
    cfg = SplatConfig(width=W, height=H, n_splats=8)
    state = init_train_state(cfg)
    p = state.params
    p = p.replace(sx=p.sx.at[:3].set(1.0), sy=p.sy.at[:3].set(1.0))
    state = state.replace(params=p)
    new = densify_and_prune(state, jnp.zeros((8,)), cfg)
    assert int(n_live(new.params)) == 5
    dead = ~np.asarray(live_mask(new.params))
    assert dead.sum() == 3
    assert (np.asarray(new.params.pos)[dead] <= DEAD_POS * 0.5).all()


def test_split_shrinks_large_donor():
    cfg = SplatConfig(width=W, height=H, n_splats=8)
    state = init_train_state(cfg)
    p = state.params
    p = p.replace(sx=p.sx.at[0].set(1.0), sy=p.sy.at[0].set(1.0),  # dead-ish
                  )
    p = p.replace(sx=p.sx.at[5].set(40.0), sy=p.sy.at[5].set(40.0))  # huge
    state = state.replace(params=p)
    g = jnp.zeros((8,)).at[5].set(10.0)
    new = densify_and_prune(state, g, cfg)
    assert float(new.params.sx[5]) < 40.0  # donor was shrunk by the split


def test_moments_reset_on_touched_slots():
    cfg = SplatConfig(width=W, height=H, n_splats=8)
    state = init_train_state(cfg)
    m = jax.tree.map(lambda x: jnp.ones_like(x), state.opt.m)
    state = state.replace(opt=state.opt.replace(m=m, v=m))
    p = state.params.replace(sx=state.params.sx.at[:2].set(1.0),
                             sy=state.params.sy.at[:2].set(1.0))
    state = state.replace(params=p)
    g = jnp.zeros((8,)).at[6].set(5.0)
    new = densify_and_prune(state, g, cfg)
    # the refilled slot's moments are zeroed; untouched slots keep theirs
    m_sx = np.asarray(new.opt.m.sx)
    assert (m_sx == 0).sum() >= 1
    assert (m_sx == 1).sum() >= 5


def test_dead_slots_survive_training_steps():
    """Dead (pruned, unrefilled) slots must stay dead through Adam + clamps.

    Regression: clamp_params used to clip the DEAD_POS sentinel back into the
    image box and raise opacity to the 0.1 floor, resurrecting pruned splats
    as visible sigma-1 black splats at the corner (ADVICE round 1, high)."""
    cfg = SplatConfig(width=W, height=H, n_splats=8)
    state = init_train_state(cfg)
    p = state.params
    p = p.replace(sx=p.sx.at[:3].set(1.0), sy=p.sy.at[:3].set(1.0))
    state = state.replace(params=p)
    state = densify_and_prune(state, jnp.zeros((8,)), cfg)
    assert int(n_live(state.params)) == 5

    ref = jnp.asarray(synthetic_target(H, W))
    state, _ = fit(ref, cfg, iterations=3, state=state, log_fn=None)
    dead = ~np.asarray(live_mask(state.params))
    assert dead.sum() == 3, "dead slots resurrected by clamp/Adam"
    assert (np.asarray(state.params.pos)[dead, 0] <= DEAD_POS * 0.5).all()
    assert (np.asarray(state.params.opacity)[dead] == 0.0).all()


def test_step_signal_matches_explicit_grad():
    """StepAux.pos_grad_mag == |jax.grad(l2_loss).pos| at the same state."""
    from gs2d_tpu.ops import render_tiles as rp
    from gs2d_tpu.train.loop import make_train_step_fused

    cfg = SplatConfig(width=W, height=H, n_splats=32, max_splats_per_tile=32)
    ref = jnp.asarray(synthetic_target(H, W))
    state = init_train_state(cfg)
    step = make_train_step_fused(cfg, True)
    refp = rp.pad_ref_chw(ref, cfg)
    _, aux = step(state, refp)
    g = jax.grad(l2_loss)(state.params, ref, cfg)
    want = jnp.linalg.norm(g.pos, axis=-1)
    np.testing.assert_allclose(np.asarray(aux.pos_grad_mag),
                               np.asarray(want), rtol=1e-3, atol=1e-4)


def test_fit_adaptive_refills_and_improves():
    """Adaptive density control refills pruned capacity from the on-device
    signal and beats the same budget spent with the capacity left dead."""
    from gs2d_tpu.train.densify import fit_adaptive
    from gs2d_tpu.train.loop import fit

    cfg = SplatConfig(width=W, height=H, n_splats=32, max_splats_per_tile=32)
    ref = jnp.asarray(synthetic_target(H, W))
    state0 = init_train_state(cfg)
    # collapse a third of the population to the prune threshold
    p = state0.params
    p = p.replace(sx=p.sx.at[:10].set(1.0), sy=p.sy.at[:10].set(1.0))
    state0 = state0.replace(params=p)

    sA, hA = fit_adaptive(ref, cfg, iterations=40, densify_every=10,
                          state=state0, log_every=39, log_fn=None)
    sB, hB = fit(ref, cfg, iterations=40, state=state0, log_every=39,
                 log_fn=None, use_fused=True)
    assert int(n_live(sA.params)) == 32  # refilled to capacity
    assert hA[-1]["mse"] < hB[-1]["mse"] * 1.02  # at least on par


def test_fit_adaptive_scan_path():
    """fit_adaptive with scan_chunk uses the in-carry accumulated signal."""
    from gs2d_tpu.train.densify import fit_adaptive

    cfg = SplatConfig(width=W, height=H, n_splats=32, max_splats_per_tile=32)
    ref = jnp.asarray(synthetic_target(H, W))
    state, hist = fit_adaptive(ref, cfg, iterations=20, densify_every=10,
                               scan_chunk=5, log_every=19, log_fn=None)
    assert np.isfinite(hist[-1]["mse"])


def test_training_still_converges_after_densify():
    cfg = SplatConfig(width=W, height=H, n_splats=48)
    ref = jnp.asarray(synthetic_target(H, W))
    state, hist0 = fit(ref, cfg, iterations=20, log_every=19, log_fn=None)
    g = jax.grad(l2_loss)(state.params, ref, cfg)
    mag = jnp.linalg.norm(g.pos, axis=-1)
    state = densify_and_prune(state, mag, cfg)
    state, hist1 = fit(ref, cfg, iterations=20, state=state, log_every=19,
                       log_fn=None)
    assert hist1[-1]["mse"] <= hist0[-1]["mse"] * 1.1  # no blow-up


def test_opacity_reset():
    """Reset caps live opacities, zeroes their Adam moments, leaves dead
    slots and every other field untouched."""
    from gs2d_tpu.train.densify import opacity_reset
    from gs2d_tpu.train.loop import init_train_state

    cfg = SplatConfig(width=W, height=H, n_splats=16, optimize_opacity=True)
    ref = jnp.asarray(synthetic_target(H, W))
    state, _ = fit(ref, cfg, iterations=5, log_fn=None)
    state = state.replace(
        opt=state.opt.replace(
            m=state.opt.m.replace(
                opacity=jnp.ones_like(state.opt.m.opacity))))
    out = opacity_reset(state, cfg, value=0.3)
    assert float(out.params.opacity.max()) <= 0.3 + 1e-6
    assert float(jnp.abs(out.opt.m.opacity).max()) == 0.0
    np.testing.assert_array_equal(np.asarray(out.params.pos),
                                  np.asarray(state.params.pos))
    np.testing.assert_array_equal(np.asarray(out.opt.m.pos),
                                  np.asarray(state.opt.m.pos))


def test_fit_adaptive_with_opacity_reset():
    from gs2d_tpu.train.densify import fit_adaptive

    cfg = SplatConfig(width=W, height=H, n_splats=32, max_splats_per_tile=32,
                      optimize_opacity=True)
    ref = jnp.asarray(synthetic_target(H, W))
    state, hist = fit_adaptive(ref, cfg, iterations=30, densify_every=10,
                               opacity_reset_every=10, log_every=29,
                               log_fn=None)
    assert np.isfinite(hist[-1]["mse"])
    assert hist[-1]["mse"] < hist[0]["mse"] if len(hist) > 1 else True


def test_fit_adaptive_batched_multi_image():
    """Assembled configs[4] shape at test scale: B=2 images, independent
    populations, densify/prune per image, flat layout + lazy rebinning.
    Each image's mse must improve and the populations must diverge."""
    from gs2d_tpu.train.densify import fit_adaptive_batched

    cfg = SplatConfig(width=W, height=H, n_splats=32, binning="flat",
                      interpret=True, rebin_margin=2.0)
    refs = [synthetic_target(H, W, seed=0), synthetic_target(H, W, seed=3)]
    state, hist = fit_adaptive_batched(
        refs, cfg, iterations=30, densify_every=10, scan_chunk=5,
        log_every=29, log_fn=None)
    first, last = hist[0]["mse"], hist[-1]["mse"]
    assert len(last) == 2 and all(np.isfinite(last))
    assert last[0] < first[0] and last[1] < first[1]
    # Different targets -> diverged populations after shared init.
    pos = np.asarray(state.params.pos)
    assert np.abs(pos[0] - pos[1]).max() > 0.5


def test_fit_adaptive_batched_resident_with_reset():
    """Batched adaptive path on the flat layout (the GPU kernel in
    interpret mode) with lazy rebinning and opacity resets (optimize_opacity
    on): runs, stays finite, refills capacity."""
    from gs2d_tpu.train.densify import fit_adaptive_batched

    cfg = SplatConfig(width=W, height=H, n_splats=32, binning="flat",
                      interpret=True, rebin_margin=2.0,
                      optimize_opacity=True)
    refs = [synthetic_target(H, W, seed=1), synthetic_target(H, W, seed=2)]
    state, hist = fit_adaptive_batched(
        refs, cfg, iterations=24, densify_every=8, scan_chunk=4,
        log_every=23, log_fn=None, opacity_reset_every=8)
    assert all(np.isfinite(hist[-1]["mse"]))
    assert int(n_live(jax.tree.map(lambda x: x[0], state.params))) == 32
    assert int(n_live(jax.tree.map(lambda x: x[1], state.params))) == 32
