"""The in-kernel saturation exit must be invisible: a tile whose every
pixel is saturated (T < 1/256) early in its splat list exercises the exact
early exit of the GPU kernel's walk (render_gpu._walk), and the outputs must
equal the scan renderer's and the plain path's, with exactly-zero gradient
rows for the pairs after the exit."""

import jax.numpy as jnp
import numpy as np
import pytest

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.ops import render_gpu as rg
from gs2d_tpu.ops import render_tiles as rt
from gs2d_tpu.ops import tiles as tl
from gs2d_tpu.ops import tiles_flat as tlf
from gs2d_tpu.ops.render_jax import render_backward, render_forward
from gs2d_tpu.params import GaussianParams

H, W = 32, 128  # one 32x128 tile exactly (no padding pixels)


def opaque_stack(n=192):
    """n huge opaque splats covering the whole tile, then distinct tail
    splats whose contribution must be exactly zero post-saturation."""
    rng = np.random.default_rng(7)
    pos = np.stack([rng.uniform(20, 100, n), rng.uniform(8, 24, n)],
                   -1).astype(np.float32)
    return GaussianParams(
        pos=pos,
        sx=np.full((n,), 60.0, np.float32),
        sy=np.full((n,), 30.0, np.float32),
        rot=rng.uniform(0, np.pi, n).astype(np.float32),
        color=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        opacity=np.full((n,), 1.0, np.float32),
    )


@pytest.mark.parametrize("check_every", [1, 16, 64])
def test_saturated_tile_bitwise_flat_vs_scan(monkeypatch, check_every):
    """At any saturation-check spacing (1 = after every pair; 64 = past
    the saturation point in one group) the kernel matches the scan."""
    monkeypatch.setattr(rg, "SAT_CHECK_EVERY", check_every)
    cfg = SplatConfig(width=W, height=H, n_splats=192, tile_h=32,
                      binning="flat", interpret=True)
    p = opaque_stack()
    ref = np.zeros((H, W, 3), np.float32)
    refc = rt.pad_ref_chw(jnp.asarray(ref), cfg)

    # Sanity: the tile really saturates well before the list ends.
    C1, T1 = render_forward(p, cfg)
    assert float(jnp.max(T1)) < cfg.min_throughput

    cfg = tlf.tune_flat_config(p, cfg)
    b = tlf.bin_splats_flat(p, cfg, cfg.flat_capacity)
    C, g = rg.l2_render_and_grads_flat(b, refc, 192, cfg, p)
    g1 = render_backward(p, C1, C1 - jnp.asarray(ref), cfg)
    np.testing.assert_allclose(np.asarray(C), np.asarray(C1), atol=3e-7)
    for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
        a, c = np.asarray(getattr(g1, f)), np.asarray(getattr(g, f))
        atol = 1e-4 * max(1.0, np.abs(a).max())
        np.testing.assert_allclose(c, a, atol=atol, err_msg=f)
    # Post-saturation splats: zero gradients, exactly.
    assert np.all(np.asarray(g.opacity)[-32:] == 0.0)


def test_saturated_tile_chunked_vs_plain_dense():
    """The kernel (saturation exit) == the plain path (no exit, every slot
    walked), bitwise on the forward, on a fully saturated tile; a larger
    dense capacity (padding slots) changes nothing."""
    cfg = SplatConfig(width=W, height=H, n_splats=192, tile_h=32,
                      interpret=True)
    p = opaque_stack()
    ref = np.zeros((H, W, 3), np.float32)
    refc = rt.pad_ref_chw(jnp.asarray(ref), cfg)
    b_pad = tl.bin_splats(p, cfg, 512)
    C_c, g_c = rt.l2_render_and_grads(b_pad, refc, 192, cfg, p)
    b_plain = tl.bin_splats(p, cfg, 192)
    C_p, g_p = rt.l2_render_and_grads(b_plain, refc, 192, cfg, p)
    np.testing.assert_array_equal(np.asarray(C_c), np.asarray(C_p))
    for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
        np.testing.assert_array_equal(
            np.asarray(getattr(g_c, f)), np.asarray(getattr(g_p, f)),
            err_msg=f)
    b = tlf.bin_splats_flat(p, cfg, tlf.tune_flat_capacity(p, cfg))
    C_k, g_k = rg.l2_render_and_grads_flat(b, refc, 192, cfg, p)
    np.testing.assert_array_equal(np.asarray(C_k), np.asarray(C_p))
    for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
        a = np.asarray(getattr(g_p, f))
        np.testing.assert_allclose(
            np.asarray(getattr(g_k, f)), a,
            atol=1e-5 * max(1.0, np.abs(a).max()), err_msg=f)
