"""Differentiable SSIM for perceptual fitting objectives.

The reference optimizes plain L2 (main.cpp:616: dL/dC = C - ref); this
module adds the structural-similarity objective from the Gaussian-splatting
literature (loss = (1-lam)*L2 + lam*(1 - SSIM), lam typically 0.2), which
trades a little PSNR for visibly better edge/texture reconstruction.

The SSIM head runs as plain JAX on top of the rasterizer's analytic
custom-VJP (render_tiles.production_render): XLA differentiates the window
statistics, the analytic backward supplies dC/dparams. The Gaussian window
is applied as two separable depthwise 1-D convolutions -- the XLA-friendly
formulation (static shapes, maps onto the conv units) rather than the
literature's dense 11x11 window.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=8)
def _gauss_kernel_np(window: int, sigma: float):
    # NumPy on purpose: an lru_cache of jnp arrays built while TRACING
    # would trap a tracer and poison every later trace with an
    # UnexpectedTracerError (latent order-sensitivity: tests passed only
    # when an eager call primed the cache first; found round 5 via the
    # scanned sharded SSIM path).
    import numpy as np

    x = np.arange(window, dtype=np.float32) - (window - 1) / 2.0
    k = np.exp(-0.5 * (x / np.float32(sigma)) ** 2)
    return k / np.sum(k)


def _gauss_kernel(window: int, sigma: float):
    return jnp.asarray(_gauss_kernel_np(window, sigma))


def _blur(img, window: int, sigma: float):
    """Separable depthwise Gaussian blur of an (H, W, C) image."""
    k = _gauss_kernel(window, sigma)
    c = img.shape[-1]
    x = jnp.transpose(img, (2, 0, 1))[None]          # (1, C, H, W)
    kv = jnp.broadcast_to(k[None, None, :, None], (c, 1, window, 1))
    kh = jnp.broadcast_to(k[None, None, None, :], (c, 1, 1, window))
    dn = jax.lax.conv_dimension_numbers(x.shape, kv.shape,
                                        ("NCHW", "OIHW", "NCHW"))
    # HIGHEST keeps TF32 out of the windows on a GPU.
    x = jax.lax.conv_general_dilated(x, kv, (1, 1), "SAME",
                                     dimension_numbers=dn,
                                     feature_group_count=c,
                                     precision=jax.lax.Precision.HIGHEST)
    x = jax.lax.conv_general_dilated(x, kh, (1, 1), "SAME",
                                     dimension_numbers=dn,
                                     feature_group_count=c,
                                     precision=jax.lax.Precision.HIGHEST)
    return jnp.transpose(x[0], (1, 2, 0))


def ssim(a, b, window: int = 11, sigma: float = 1.5,
         data_range: float = 1.0):
    """Mean SSIM between (H, W, C) images (Wang et al. 2004 constants)."""
    c1 = jnp.float32((0.01 * data_range) ** 2)
    c2 = jnp.float32((0.03 * data_range) ** 2)
    blur = functools.partial(_blur, window=window, sigma=sigma)
    mu_a = blur(a)
    mu_b = blur(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = blur(a * a) - mu_aa
    var_b = blur(b * b) - mu_bb
    cov = blur(a * b) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * cov + c2)) / (
        (mu_aa + mu_bb + c1) * (var_a + var_b + c2))
    return jnp.mean(s)


def mixed_loss(color, ref, lam: float):
    """(1-lam) * 0.5*sum((C-ref)^2) + lam * (1 - SSIM) * npix.

    Both terms are scaled to the un-normalized L2 convention the analytic
    backward uses (0.5*sum d^2, cotangent C - ref), so ``lam=0`` reproduces
    the reference objective bitwise up to the (1-lam) factor on the lr.
    """
    d = color - ref
    l2 = jnp.float32(0.5) * jnp.sum(d * d)
    npix = jnp.float32(color.shape[0] * color.shape[1])
    return (jnp.float32(1.0 - lam) * l2
            + jnp.float32(lam) * (jnp.float32(1.0) - ssim(color, ref)) * npix)
