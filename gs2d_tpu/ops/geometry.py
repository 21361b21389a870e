"""Splat geometry: covariance construction, inversion, eigen-decomposition.

Vectorized over the splat axis (shapes (N,) -> (N, ...)). The math follows the
reference's expanded trigonometric forms so that float32 rounding matches:

- ``cov_of``: Sigma = R diag(sx^2, sy^2) R^T expanded directly in terms of
  cos/sin (reference main.cpp:206-221, Form.pdf section 2)
- ``inv_cov_of``: adjugate / det closed form (reference main.cpp:432-436,
  Form.pdf section 3)
- ``eigenvalues_2x2`` / ``eigenvectors_of_cov``: stable symmetric 2x2 eigen
  solve (reference main.cpp:188-196, 223-234); used for visualization and
  debugging, not the hot path
- ``bbox_half_height``: the exact covariance bounding-box extent
  sqrt(inv_cov[0][0] * det) * bounds (reference main.cpp:489)
"""

from __future__ import annotations

import jax.numpy as jnp


def cov_of(sx, sy, rot):
    """Covariance entries (s11, s12, s22) from scale/rotation parameters.

    Expanded form (reference main.cpp:206-221):
      s11 = sx^2 cos^2 + sy^2 sin^2
      s12 = (sx^2 - sy^2) sin cos
      s22 = sx^2 + sy^2 - s11
    """
    c = jnp.cos(rot)
    s = jnp.sin(rot)
    l0 = sx * sx
    l1 = sy * sy
    s11 = l0 * c * c + l1 * s * s
    s12 = (l0 - l1) * s * c
    s22 = l0 + l1 - s11
    return s11, s12, s22


def det_of_cov(s11, s12, s22):
    """det(Sigma) computed the way the reference does in its backward pass
    (main.cpp:560): s11*s22 - s12*s12."""
    return s11 * s22 - s12 * s12


def inv_cov_of(s11, s12, s22):
    """Closed-form inverse of the symmetric 2x2 covariance.

    Returns (a, b, d, det) with inv = [[a, b], [b, d]]
    (adjugate/det; reference main.cpp:432-436)."""
    det = det_of_cov(s11, s12, s22)
    a = s22 / det
    b = -s12 / det
    d = s11 / det
    return a, b, d, det


def eigenvalues_2x2(s11, s12, s22):
    """Eigenvalues of the symmetric 2x2 matrix, lambda0 >= lambda1
    (reference main.cpp:188-196)."""
    mean = (s11 + s22) * jnp.float32(0.5)
    det = det_of_cov(s11, s12, s22)
    d = jnp.sqrt(jnp.maximum(mean * mean - det, 0.0))
    return mean + d, mean - d, det


def eigenvectors_of_cov(s11, s12, s22, lambda0):
    """Unit eigenvectors (e0 for lambda0, e1 perpendicular), branch chosen for
    numerical stability (reference main.cpp:223-234)."""
    eps = jnp.float32(1e-15)
    ex = jnp.where(s11 < s22, s12 + eps, lambda0 - s22)
    ey = jnp.where(s11 < s22, lambda0 - s11, s12 + eps)
    norm = jnp.sqrt(ex * ex + ey * ey)
    e0 = jnp.stack([ex / norm, ey / norm], axis=-1)
    e1 = jnp.stack([-e0[..., 1], e0[..., 0]], axis=-1)
    return e0, e1


def bbox_half_height(a_inv, det, bounds):
    """Vertical half-extent of the exact covariance bounding box:
    sqrt(inv_cov[0][0] * det) * bounds (reference main.cpp:489).

    Note inv_cov[0][0] * det == s22 algebraically; computing it through the
    inverse matches the reference's float32 rounding."""
    return jnp.sqrt(a_inv * det) * jnp.float32(bounds)


def bbox_half_width(d_inv, det, bounds):
    """Horizontal half-extent, sqrt(inv_cov[1][1] * det) * bounds
    (reference main.cpp:488, used for tile binning)."""
    return jnp.sqrt(d_inv * det) * jnp.float32(bounds)
