"""Pure-JAX reference rasterizer: scan over splats, gather over pixels.

This is the framework's *semantic reference path*: jit-able, differentiable,
runs on any backend unchanged, and reproduces the reference C++ loop
semantics (main.cpp:418-712) in vectorized form. The production path is the
tile pipeline (ops/render_tiles.py, ops/render_gpu.py); both are tested
against the loop-faithful NumPy oracle.

Design notes (not a port):

- The reference is splat-major *scatter* (each splat walks its own pixel
  footprint, main.cpp:419-537). Sequential splat order only matters through
  the per-pixel compositing state (C, T), so the same result is obtained by a
  *gather*: ``lax.scan`` over splats in index order carrying the full-image
  (C, T) state, with each step a masked vectorized composite over all pixels.
- The reference's early-termination (T < 1/256, main.cpp:518-521) becomes a
  per-pixel mask; its truncated-int loop bounds (main.cpp:490-508) become an
  integer coverage predicate so edge pixels match exactly.
- The backward pass is the reference's hand-derived analytic gradient
  (main.cpp:548-712, Form.pdf sections 6-11), exposed as a ``jax.custom_vjp``
  rather than autodiff through the blend. Note it is intentionally the
  reference's formula: the derivative of exp is taken as exact even when the
  forward uses the (1+x/8)^8 approximation, and the suffix color is divided by
  (1 - alpha + 1e-15) -- so grads match the C++ bit-closely, not jax.grad of
  the approximate forward.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.ops import geometry
from gs2d_tpu.ops.numerics import exp_ref, sign_of, trunc_to_int
from gs2d_tpu.params import GaussianParams


def _splat_scalars(p: GaussianParams, bounds: float = 3.0):
    """Stack per-splat scalars consumed by the scan: one row per splat.

    ``bounds`` is the row-walk sigma cutoff (cfg.splat_bounds)."""
    s11, s12, s22 = geometry.cov_of(p.sx, p.sy, p.rot)
    a, b, d, det = geometry.inv_cov_of(s11, s12, s22)
    h = geometry.bbox_half_height(a, det, bounds)
    return {
        "px": p.pos[:, 0], "py": p.pos[:, 1],
        "a": a, "b": b, "d": d, "h": h,
        "color": p.color, "opacity": p.opacity,
        "sx": p.sx, "sy": p.sy, "rot": p.rot,
    }


def _coverage(px, py, a, b, d, h, cfg: SplatConfig, y0=0, band_h=None):
    """Integer coverage mask of one splat over the padded pixel grid.

    Reproduces the reference's loop bounds exactly: rows y in
    [trunc(py-h), trunc(py+h)] (main.cpp:490-492) and per-row columns
    x in [trunc(px+r0), trunc(px+r1)] from the ellipse quadratic
    (main.cpp:497-511, Form.pdf section 13). Returns (mask (H,W), vx (W,),
    vy (H,), alpha terms are computed by the caller).

    ``y0``/``band_h`` select a horizontal band of rows [y0, y0+band_h) in
    global coordinates -- the unit of tile-axis sharding (y0 may be traced,
    e.g. axis_index * band_h inside shard_map).
    """
    H = cfg.padded_height if band_h is None else band_h
    W = cfg.padded_width
    yi = y0 + jax.lax.broadcasted_iota(jnp.int32, (H, 1), 0)[:, 0]
    xi = jax.lax.broadcasted_iota(jnp.int32, (1, W), 1)[0, :]

    beg_y = trunc_to_int(py - h)
    end_y = trunc_to_int(py + h)
    row_ok = (yi >= beg_y) & (yi <= end_y) & (yi < cfg.height)

    vy = (yi.astype(jnp.float32) + jnp.float32(0.5)) - py  # (H,)
    qb = jnp.float32(2.0) * b * vy
    qc = d * vy * vy - jnp.float32(cfg.cutoff_sq)
    det_q = qb * qb - jnp.float32(4.0) * a * qc
    q_ok = det_q >= 0.0
    sdet = jnp.sqrt(jnp.maximum(det_q, 0.0))
    k = (-qb - sign_of(qb) * sdet) * jnp.float32(0.5)
    x0 = k / a
    x1 = qc / k
    beg_x = trunc_to_int(px + jnp.minimum(x0, x1))
    end_x = trunc_to_int(px + jnp.maximum(x0, x1))

    col_ok = (xi[None, :] >= beg_x[:, None]) & (xi[None, :] <= end_x[:, None])
    mask = row_ok[:, None] & q_ok[:, None] & col_ok & (xi[None, :] < cfg.width)

    vx = (xi.astype(jnp.float32) + jnp.float32(0.5)) - px  # (W,)
    return mask, vx, vy


def _alpha_of(s, vx, vy, cfg: SplatConfig):
    """G = exp(-0.5 v^T Sigma^-1 v) and alpha = G * opacity (main.cpp:523-527)."""
    d2 = (s["a"] * vx * vx)[None, :] + (jnp.float32(2.0) * s["b"]) * vx[None, :] * vy[:, None] \
        + (s["d"] * vy * vy)[:, None]
    G = exp_ref(jnp.float32(-0.5) * d2, cfg.use_exp_approx)
    return G, G * s["opacity"]


def render_forward_band(
    params: GaussianParams,
    cfg: SplatConfig,
    y0=0,
    band_h: int | None = None,
    carry_in: Tuple[jax.Array, jax.Array] | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Front-to-back composite over splats in index order on a row band.

    The band [y0, y0 + band_h) in global rows is the unit of tile-axis
    sharding; ``carry_in`` is the incoming per-pixel (C, T) composite state
    (the ordered-monoid partial from earlier splat shards). Returns the raw
    padded band (C (band_h, Wp, 3), T (band_h, Wp)).
    """
    scal = _splat_scalars(params, cfg.splat_bounds)
    H = cfg.padded_height if band_h is None else band_h
    W = cfg.padded_width
    if carry_in is None:
        carry_in = (jnp.zeros((H, W, 3), jnp.float32),
                    jnp.ones((H, W), jnp.float32))

    def step(carry, s):
        C, T = carry
        mask, vx, vy = _coverage(s["px"], s["py"], s["a"], s["b"], s["d"],
                                 s["h"], cfg, y0, band_h)
        _, alpha = _alpha_of(s, vx, vy, cfg)
        live = mask & (T >= jnp.float32(cfg.min_throughput))
        w = jnp.where(live, T * alpha, jnp.float32(0.0))
        C = C + w[..., None] * s["color"]
        T = jnp.where(live, T * (jnp.float32(1.0) - alpha), T)
        return (C, T), None

    (C, T), _ = jax.lax.scan(step, carry_in, scal)
    return C, T


def render_forward(
    params: GaussianParams, cfg: SplatConfig
) -> Tuple[jax.Array, jax.Array]:
    """Front-to-back composite over splats in index order.

    Returns (color (H, W, 3), transmittance (H, W)) on the *unpadded* image.
    """
    C, T = render_forward_band(params, cfg)
    return C[: cfg.height, : cfg.width], T[: cfg.height, : cfg.width]


def render_backward_band(
    params: GaussianParams,
    fin: jax.Array,
    gC: jax.Array,
    cfg: SplatConfig,
    y0=0,
    band_h: int | None = None,
    carry_in: Tuple[jax.Array, jax.Array] | None = None,
) -> GaussianParams:
    """Analytic VJP on a row band with an incoming composite carry.

    ``fin``/``gC`` are the band's final color and upstream cotangent on the
    padded band grid; ``carry_in`` the (C, T) monoid partial entering this
    splat shard (prefix of earlier shards). Implements the replay strategy of
    main.cpp:548-712.
    """
    scal = _splat_scalars(params, cfg.splat_bounds)
    H = cfg.padded_height if band_h is None else band_h
    W = cfg.padded_width
    if carry_in is None:
        carry_in = (jnp.zeros((H, W, 3), jnp.float32),
                    jnp.ones((H, W), jnp.float32))
    C0, T0 = carry_in

    def step(carry, s):
        C, T = carry
        mask, vx, vy = _coverage(s["px"], s["py"], s["a"], s["b"], s["d"],
                                 s["h"], cfg, y0, band_h)
        G, alpha = _alpha_of(s, vx, vy, cfg)
        live = mask & (T >= jnp.float32(cfg.min_throughput))
        mw = live.astype(jnp.float32)

        # dL/dc_i = sum_px gC * alpha * T   (main.cpp:617-620)
        w_c = alpha * T * mw
        # HIGHEST keeps TF32 out of the reference on a GPU.
        g_col = jnp.einsum("hwc,hw->c", gC, w_c,
                           precision=jax.lax.Precision.HIGHEST)

        # replay composite to get suffix color S (main.cpp:622-627)
        C = C + jnp.where(live, T * alpha, 0.0)[..., None] * s["color"]
        S = fin - C
        # Zero-division guard on (1 - alpha + 1e-15) (main.cpp:628). Written
        # as a select because XLA's algebraic simplifier reassociates the
        # literal form into (1 + 1e-15) - alpha == 1 - alpha, which is 0 when
        # alpha == 1 exactly and turns the whole gradient NaN. For alpha < 1
        # in fp32, 1 - alpha >= 2^-24 and adding 1e-15 is a no-op, so this
        # select is bit-identical to the reference's expression.
        one_m_a = jnp.where(
            alpha >= jnp.float32(1.0),
            jnp.float32(1e-15),
            jnp.float32(1.0) - alpha,
        )
        dC_dalpha = s["color"][None, None, :] * T[..., None] - S / one_m_a[..., None]
        dL_da = jnp.einsum("hwc,hwc->hw", gC, dC_dalpha,
                           precision=jax.lax.Precision.HIGHEST) * mw

        a, b, d = s["a"], s["b"], s["d"]
        vxg = vx[None, :]
        vyg = vy[:, None]
        # d(alpha)/d(mu) (main.cpp:635-640, Form.pdf section 8); b == c.
        dal_dx = jnp.float32(0.5) * alpha * (jnp.float32(2.0) * a * vxg + (b + b) * vyg)
        dal_dy = jnp.float32(0.5) * alpha * (jnp.float32(2.0) * d * vyg + (b + b) * vxg)
        g_px = jnp.sum(dL_da * dal_dx)
        g_py = jnp.sum(dL_da * dal_dy)

        cosT = jnp.cos(s["rot"])
        sinT = jnp.sin(s["rot"])
        vxx = vxg * vxg
        vxy = vxg * vyg
        vyy = vyg * vyg
        # d(alpha)/d(sx, sy) (main.cpp:657-662, Form.pdf section 9)
        sx, sy = s["sx"], s["sy"]
        dal_dsx = alpha / (sx * sx * sx) * (
            cosT * cosT * vxx + jnp.float32(2.0) * sinT * cosT * vxy + sinT * sinT * vyy)
        dal_dsy = alpha / (sy * sy * sy) * (
            sinT * sinT * vxx - jnp.float32(2.0) * sinT * cosT * vxy + cosT * cosT * vyy)
        g_sx = jnp.sum(dL_da * dal_dsx)
        g_sy = jnp.sum(dL_da * dal_dsy)

        # d(alpha)/d(theta) (main.cpp:680-683, Form.pdf section 10)
        dal_dth = alpha * (sx * sx - sy * sy) / (sx * sx * sy * sy) * (
            (cosT * cosT - sinT * sinT) * vxy - sinT * cosT * (vxx - vyy))
        g_rot = jnp.sum(dL_da * dal_dth)

        # d(alpha)/d(opacity) = G (main.cpp:703)
        g_op = jnp.sum(dL_da * G)

        T = jnp.where(live, T * (jnp.float32(1.0) - alpha), T)
        grads = (jnp.stack([g_px, g_py]), g_sx, g_sy, g_rot, g_col, g_op)
        return (C, T), grads

    _, (g_pos, g_sx, g_sy, g_rot, g_col, g_op) = jax.lax.scan(step, (C0, T0), scal)
    return GaussianParams(
        pos=g_pos, sx=g_sx, sy=g_sy, rot=g_rot, color=g_col, opacity=g_op
    )


def render_backward(
    params: GaussianParams, final_color: jax.Array, g_color: jax.Array,
    cfg: SplatConfig,
) -> GaussianParams:
    """Analytic VJP of ``render_forward`` on the full image.

    ``final_color`` is the forward output; ``g_color`` the upstream cotangent
    dL/dC (for the reference's pure-L2 objective it is C - ref, main.cpp:616).
    """
    H, W = cfg.padded_height, cfg.padded_width
    fin = jnp.zeros((H, W, 3), jnp.float32).at[: cfg.height, : cfg.width].set(
        final_color)
    gC = jnp.zeros((H, W, 3), jnp.float32).at[: cfg.height, : cfg.width].set(
        g_color)
    return render_backward_band(params, fin, gC, cfg)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def render(params: GaussianParams, cfg: SplatConfig) -> jax.Array:
    """Differentiable splat rasterization; gradients are the reference's
    hand-derived analytic backward, not autodiff through the blend."""
    return render_forward(params, cfg)[0]


def _render_fwd(params, cfg):
    color = render_forward(params, cfg)[0]
    return color, (params, color)


def _render_bwd(cfg, res, g_color):
    params, color = res
    return (render_backward(params, color, g_color, cfg),)


render.defvjp(_render_fwd, _render_bwd)


def l2_loss(params: GaussianParams, ref: jax.Array, cfg: SplatConfig) -> jax.Array:
    """0.5 * sum((C - ref)^2): the implicit objective whose per-pixel gradient
    is the reference's dL/dC = C - ref (main.cpp:616)."""
    C = render(params, cfg)
    d = C - ref
    return jnp.float32(0.5) * jnp.sum(d * d)
