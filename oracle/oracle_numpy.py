"""Loop-faithful NumPy oracle of the reference 2D Gaussian splatting trainer.

This is the framework's ground truth for unit tests: an independent
re-implementation of the reference algorithm (/root/reference/main.cpp) that
keeps the *semantics* of the sequential C++ loops -- splat-index-ordered
front-to-back compositing, truncated integer loop bounds, float32 arithmetic,
the (1+x/8)^8 fast exponential, the transmittance early-out at 1/256 -- while
being written as row-vectorized NumPy for tolerable speed.

It is intentionally NOT accelerator-idiomatic and NOT fast; it exists so the JAX and
Pallas paths have something loop-faithful to be allclose against.

Semantics mirrored (with reference citations):
  forward compositing       main.cpp:418-538
  backward replay + grads   main.cpp:548-712 (Form.pdf sections 6-11)
  bounds walk               main.cpp:487-509 (Form.pdf sections 12-13)
  Adam + constraints        main.cpp:714-750
  MSE metric                main.cpp:796-807
"""

from __future__ import annotations

import dataclasses

import numpy as np

F = np.float32
MIN_THROUGHPUT = F(1.0 / 256.0)
BOUNDS = F(3.0)
EXP_FLUSH = F(0.00001814586175896693021059036255)


def exp_approx(x):
    """(1 + x/8)^8 with flush-to-zero guard (main.cpp:49-83)."""
    x = F(1.0) + x * F(0.125)
    flush = x < EXP_FLUSH
    x = x * x
    x = x * x
    x = x * x
    return np.where(flush, F(0.0), x).astype(np.float32)


def pcg3d(v):
    v = np.asarray(v, np.uint64)  # widen to emulate uint32 wraparound manually
    M = np.uint64(0xFFFFFFFF)
    v = (v * np.uint64(1664525) + np.uint64(1013904223)) & M
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x = (x + y * z) & M
    y = (y + z * x) & M
    z = (z + x * y) & M
    x = x ^ (x >> np.uint64(16))
    y = y ^ (y >> np.uint64(16))
    z = z ^ (z >> np.uint64(16))
    x = (x + y * z) & M
    y = (y + z * x) & M
    z = (z + x * y) & M
    return np.stack([x, y, z], axis=-1).astype(np.uint32)


@dataclasses.dataclass
class Splats:
    """SoA splat state (the oracle's equivalent of std::vector<Splat>)."""

    pos: np.ndarray      # (N, 2)
    sx: np.ndarray       # (N,)
    sy: np.ndarray       # (N,)
    rot: np.ndarray      # (N,)
    color: np.ndarray    # (N, 3)
    opacity: np.ndarray  # (N,)

    def copy(self):
        return Splats(*(getattr(self, f.name).copy() for f in dataclasses.fields(self)))


def init_splats(n, width, height):
    """Deterministic init (main.cpp:280-307), including the mix(r0, W-1, r0)
    position quirk."""
    i = np.arange(n, dtype=np.uint32)
    ones = np.full(n, 0xFFFFFFFF, np.uint32)
    r0 = pcg3d(np.stack([i, np.zeros(n, np.uint32), ones], -1)).astype(np.float32) / F(4294967296.0)
    r1 = pcg3d(np.stack([i, np.ones(n, np.uint32), ones], -1)).astype(np.float32) / F(4294967296.0)

    def mix(a, b, t):
        return (a * (F(1.0) - t) + b * t).astype(np.float32)

    pos = np.stack(
        [mix(r0[:, 0], F(width - 1), r0[:, 0]), mix(r0[:, 1], F(height - 1), r0[:, 1])], -1
    )
    sx = mix(F(6.0), F(10.0), r1[:, 0])
    sy = mix(F(6.0), F(10.0), r1[:, 1])
    rot = (F(np.pi) * r1[:, 2]).astype(np.float32)
    color = np.full((n, 3), 0.5, np.float32)
    opacity = np.ones(n, np.float32)
    return Splats(pos, sx, sy, rot, color, opacity)


def _cov_terms(s: Splats, i: int):
    """Per-splat covariance, inverse, and row-walk terms, float32 scalar math
    in the reference's operation order (main.cpp:206-221, 423-436)."""
    sx, sy, rot = F(s.sx[i]), F(s.sy[i]), F(s.rot[i])
    c, sn = F(np.cos(rot)), F(np.sin(rot))
    l0, l1 = sx * sx, sy * sy
    s11 = l0 * c * c + l1 * sn * sn
    s12 = (l0 - l1) * sn * c
    s22 = l0 + l1 - s11
    det = s11 * s22 - s12 * s12
    a = s22 / det
    b = -s12 / det
    d = s11 / det
    return c, sn, a, b, d, det


def _row_range(px, py, a, b, d, y, width):
    """Exact per-row x interval from the Mahalanobis ellipse quadratic
    (main.cpp:497-509, Form.pdf section 13). Returns (xs, vy) or None."""
    vy = F(y + 0.5) - py
    qb = F(2.0) * b * vy
    qc = d * vy * vy - BOUNDS * BOUNDS
    det_q = qb * qb - F(4.0) * a * qc
    if det_q < 0.0:
        return None
    sign = F(-1.0) if qb < 0.0 else F(1.0)
    k = (-qb - sign * np.sqrt(det_q, dtype=np.float32)) * F(0.5)
    x0 = k / a
    x1 = qc / k
    beg = int(px + min(x0, x1))  # C float->int truncation (main.cpp:507)
    end = int(px + max(x0, x1))
    lo, hi = max(beg, 0), min(end, width - 1)
    if lo > hi:
        return None
    return np.arange(lo, hi + 1), vy


def forward(s: Splats, height, width):
    """Front-to-back composite in splat index order (main.cpp:418-538).

    Returns (color (H,W,3), final transmittance T (H,W))."""
    C = np.zeros((height, width, 3), np.float32)
    T = np.ones((height, width), np.float32)
    n = s.pos.shape[0]
    for i in range(n):
        px, py = F(s.pos[i, 0]), F(s.pos[i, 1])
        _, _, a, b, d, det = _cov_terms(s, i)
        h = np.sqrt(a * det, dtype=np.float32) * BOUNDS  # main.cpp:489
        beg_y, end_y = int(py - h), int(py + h)
        op = F(s.opacity[i])
        col = s.color[i]
        for y in range(beg_y, end_y + 1):
            if y < 0 or y >= height:
                continue
            rr = _row_range(px, py, a, b, d, y, width)
            if rr is None:
                continue
            xs, vy = rr
            t = T[y, xs]
            m = t >= MIN_THROUGHPUT
            vx = (xs.astype(np.float32) + F(0.5)) - px
            d2 = a * vx * vx + F(2.0) * b * vx * vy + d * vy * vy
            alpha = exp_approx(F(-0.5) * d2) * op
            w = np.where(m, t * alpha, F(0.0))
            C[y, xs] += w[:, None] * col[None, :]
            T[y, xs] = np.where(m, t * (F(1.0) - alpha), t)
    return C, T


def backward(s: Splats, C0, ref, height, width):
    """Analytic gradients by replaying the composite (main.cpp:548-712).

    C0 is the forward's final color image; ref the target. Returns a Splats of
    gradients (dSplats)."""
    n = s.pos.shape[0]
    g = Splats(
        np.zeros((n, 2), np.float32), np.zeros(n, np.float32), np.zeros(n, np.float32),
        np.zeros(n, np.float32), np.zeros((n, 3), np.float32), np.zeros(n, np.float32),
    )
    C1 = np.zeros((height, width, 3), np.float32)
    T1 = np.ones((height, width), np.float32)
    for i in range(n):
        px, py = F(s.pos[i, 0]), F(s.pos[i, 1])
        cosT, sinT, a, b, d, det = _cov_terms(s, i)
        h = np.sqrt(a * det, dtype=np.float32) * BOUNDS
        beg_y, end_y = int(py - h), int(py + h)
        op = F(s.opacity[i])
        col = s.color[i]
        sx, sy = F(s.sx[i]), F(s.sy[i])
        for y in range(beg_y, end_y + 1):
            if y < 0 or y >= height:
                continue
            rr = _row_range(px, py, a, b, d, y, width)
            if rr is None:
                continue
            xs, vy = rr
            t = T1[y, xs]
            m = t >= MIN_THROUGHPUT
            if not m.any():
                continue
            vx = (xs.astype(np.float32) + F(0.5)) - px
            d2 = a * vx * vx + F(2.0) * b * vx * vy + d * vy * vy
            G = exp_approx(F(-0.5) * d2)
            alpha = G * op
            fin = C0[y, xs]
            dL_dC = fin - ref[y, xs]  # pure L2 (main.cpp:616)
            dC_dc = alpha * t
            mw = m.astype(np.float32)
            g.color[i] += (dL_dC * (dC_dc * mw)[:, None]).sum(0)

            w = np.where(m, t * alpha, F(0.0))
            C1[y, xs] += w[:, None] * col[None, :]
            S = fin - C1[y, xs]  # suffix color (main.cpp:627, Form.pdf section 7)
            dC_dalpha = col[None, :] * t[:, None] - S / (F(1.0) - alpha + F(1e-15))[:, None]
            dL_da = (dL_dC * dC_dalpha).sum(1) * mw

            # b == c in the symmetric inverse covariance (main.cpp:635-640).
            dal_dx = F(0.5) * alpha * (F(2.0) * a * vx + (b + b) * vy)
            dal_dy = F(0.5) * alpha * (F(2.0) * d * vy + (b + b) * vx)
            g.pos[i, 0] += (dL_da * dal_dx).sum()
            g.pos[i, 1] += (dL_da * dal_dy).sum()

            # d(alpha)/d(sx, sy) (main.cpp:657-662, Form.pdf section 9)
            vxx, vxy, vyy = vx * vx, vx * vy, vy * vy
            dal_dsx = alpha / (sx * sx * sx) * (
                cosT * cosT * vxx + F(2.0) * sinT * cosT * vxy + sinT * sinT * vyy)
            dal_dsy = alpha / (sy * sy * sy) * (
                sinT * sinT * vxx - F(2.0) * sinT * cosT * vxy + cosT * cosT * vyy)
            g.sx[i] += (dL_da * dal_dsx).sum()
            g.sy[i] += (dL_da * dal_dsy).sum()

            # d(alpha)/d(theta) (main.cpp:680-683, Form.pdf section 10)
            dal_dth = alpha * (sx * sx - sy * sy) / (sx * sx * sy * sy) * (
                (cosT * cosT - sinT * sinT) * vxy - sinT * cosT * (vxx - vyy))
            g.rot[i] += (dL_da * dal_dth).sum()

            # d(alpha)/d(opacity) = G (main.cpp:703)
            g.opacity[i] += (dL_da * G).sum()

            T1[y, xs] = np.where(m, t * (F(1.0) - alpha), t)
    return g


@dataclasses.dataclass
class AdamState:
    m: Splats
    v: Splats
    beta1t: float = 1.0
    beta2t: float = 1.0


def init_adam(n):
    z = lambda *shape: np.zeros(shape, np.float32)
    mk = lambda: Splats(z(n, 2), z(n), z(n), z(n), z(n, 3), z(n))
    return AdamState(mk(), mk())


def adam_step(s: Splats, g: Splats, st: AdamState, lr=0.05, b1=0.9, b2=0.99,
              eps=1e-15, optimize_opacity=False, width=None, height=None):
    """Per-parameter Adam with external bias powers + clamps (main.cpp:714-750)."""
    st.beta1t *= b1
    st.beta2t *= b2
    lr, b1, b2, eps = F(lr), F(b1), F(b2), F(eps)
    b1t, b2t = F(st.beta1t), F(st.beta2t)

    def upd(val, grad, m, v):
        m_new = (b1 * m + (F(1.0) - b1) * grad).astype(np.float32)
        v_new = (b2 * v + (F(1.0) - b2) * grad * grad).astype(np.float32)
        m_hat = m_new / (F(1.0) - b1t)
        v_hat = v_new / (F(1.0) - b2t)
        out = (val - lr * m_hat / (np.sqrt(v_hat, dtype=np.float32) + eps)).astype(np.float32)
        return out, m_new, v_new

    for f in ("color", "pos", "sx", "sy", "rot", "opacity"):
        if f == "opacity" and not optimize_opacity:
            continue
        val, m_new, v_new = upd(getattr(s, f), getattr(g, f), getattr(st.m, f), getattr(st.v, f))
        setattr(s, f, val)
        setattr(st.m, f, m_new)
        setattr(st.v, f, v_new)

    s.pos[:, 0] = np.clip(s.pos[:, 0], F(0.0), F(width - 1))
    s.pos[:, 1] = np.clip(s.pos[:, 1], F(0.0), F(height - 1))
    s.sx = np.clip(s.sx, F(1.0), F(1024.0))
    s.sy = np.clip(s.sy, F(1.0), F(1024.0))
    s.color = np.clip(s.color, F(0.0), F(1.0))
    s.opacity = np.clip(s.opacity, F(0.1), F(1.0))
    return s, st


def mse_255(C, ref):
    """MSE in 8-bit units, float64 accumulate (main.cpp:796-806)."""
    d = (C.astype(np.float64) - ref.astype(np.float64)) * 255.0
    return (d * d).sum() / (C.shape[0] * C.shape[1] * 3)


def train_iteration(s, st, ref, height, width, optimize_opacity=False):
    """One full reference iteration: forward, backward, Adam, MSE."""
    C0, _ = forward(s, height, width)
    g = backward(s, C0, ref, height, width)
    s, st = adam_step(s, g, st, optimize_opacity=optimize_opacity,
                      width=width, height=height)
    return s, st, C0, g, mse_255(C0, ref)
