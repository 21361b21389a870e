"""Splat parameters as a structure-of-arrays pytree.

The reference stores an array-of-structs ``std::vector<Splat>`` with 9 DOF per
splat (main.cpp:85-93). On an accelerator the idiomatic layout is SoA: one contiguous
array per parameter, so every kernel reads dense vectors and sharding is a
one-line ``NamedSharding`` on the splat axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gs2d_tpu.config import PI, SplatConfig
from gs2d_tpu.ops.numerics import pcg3d_unit
from gs2d_tpu.utils import pytree

# Sentinel x-position of a dead (pruned, not-yet-refilled) splat slot. Dead
# slots are parked far off-screen so tile binning excludes them for free; they
# must survive clamping untouched (see clamp_params) or they resurrect as
# visible splats at the image corner.
DEAD_POS = -1.0e6


@pytree.dataclass
class GaussianParams:
    """9-DOF per-splat parameters (reference main.cpp:85-93), SoA layout.

    Attributes:
      pos:     (N, 2) float32 -- screen-space center (x, y), pixels
      sx, sy:  (N,)  float32 -- principal standard deviations, pixels
      rot:     (N,)  float32 -- rotation of the major axis, radians
      color:   (N, 3) float32 -- RGB in [0, 1]
      opacity: (N,)  float32 -- peak alpha in [0, 1]
    """

    pos: jax.Array
    sx: jax.Array
    sy: jax.Array
    rot: jax.Array
    color: jax.Array
    opacity: jax.Array

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def astype(self, dtype):
        return jax.tree.map(lambda x: x.astype(dtype), self)


def init_params(cfg: SplatConfig) -> GaussianParams:
    """Deterministic splat initialization (reference main.cpp:280-307).

    Uses two pcg3d draws per splat: r0 = pcg3d(i, 0, 0xFFFFFFFF),
    r1 = pcg3d(i, 1, 0xFFFFFFFF), each normalized to [0,1).

    Position keeps the reference's quirk (main.cpp:294-295): it lerps *from*
    r0 *to* (size - 1) *by* r0 -- i.e. mix(r0, W-1, r0) -- rather than a plain
    uniform; reproducing it keeps the fitted trajectories comparable.
    Scales are uniform in [6, 10], rotation uniform in [0, pi), color mid-gray,
    opacity 1.
    """
    n = cfg.n_splats
    i = jnp.arange(n, dtype=jnp.uint32)
    ones = jnp.full((n,), 0xFFFFFFFF, dtype=jnp.uint32)
    zeros = jnp.zeros((n,), dtype=jnp.uint32)
    r0 = pcg3d_unit(jnp.stack([i, zeros, ones], axis=-1))
    r1 = pcg3d_unit(jnp.stack([i, zeros + 1, ones], axis=-1))

    def mix(a, b, t):
        # GLSL mix: x*(1-a) + y*a.
        return a * (1.0 - t) + b * t

    w = jnp.float32(cfg.width - 1)
    h = jnp.float32(cfg.height - 1)
    pos = jnp.stack(
        [mix(r0[:, 0], w, r0[:, 0]), mix(r0[:, 1], h, r0[:, 1])], axis=-1
    )
    sx = mix(jnp.float32(cfg.init_scale_min), jnp.float32(cfg.init_scale_max), r1[:, 0])
    sy = mix(jnp.float32(cfg.init_scale_min), jnp.float32(cfg.init_scale_max), r1[:, 1])
    rot = jnp.float32(PI) * r1[:, 2]
    color = jnp.broadcast_to(
        jnp.asarray(cfg.init_color, jnp.float32), (n, 3)
    )
    opacity = jnp.full((n,), cfg.init_opacity, jnp.float32)
    return GaussianParams(pos=pos, sx=sx, sy=sy, rot=rot, color=color, opacity=opacity)


def zeros_like_params(params: GaussianParams) -> GaussianParams:
    """A zero gradient pytree matching ``params`` (the reference's fresh
    ``dSplats`` each iteration, main.cpp:550)."""
    return jax.tree.map(jnp.zeros_like, params)


def clamp_params(params: GaussianParams, cfg: SplatConfig) -> GaussianParams:
    """Post-update box constraints (reference main.cpp:740-749).

    Dead slots (pos parked at DEAD_POS by densify/prune) are preserved one
    level up in adam_update, which knows the pre-update state -- clamping
    here is unconditional, exactly like the reference."""
    lohi = jnp.asarray(
        [[0.0, cfg.width - 1], [0.0, cfg.height - 1]], jnp.float32
    )
    pos = jnp.clip(params.pos, lohi[None, :, 0], lohi[None, :, 1])
    return params.replace(
        pos=pos,
        sx=jnp.clip(params.sx, cfg.scale_min, cfg.scale_max),
        sy=jnp.clip(params.sy, cfg.scale_min, cfg.scale_max),
        color=jnp.clip(params.color, 0.0, 1.0),
        opacity=jnp.clip(params.opacity, cfg.opacity_min, cfg.opacity_max),
    )


def freeze_dead_slots(
    pre: GaussianParams, post: GaussianParams
) -> GaussianParams:
    """Restore dead slots (pos parked at DEAD_POS before the update) to their
    pre-update values. Without this, clamping resurrects pruned splats as
    visible sigma-1 splats clipped to the image corner (ADVICE round 1)."""
    dead = pre.pos[..., 0] <= jnp.float32(DEAD_POS * 0.5)

    def keep(orig, new):
        m = dead.reshape(dead.shape + (1,) * (orig.ndim - dead.ndim))
        return jnp.where(m, orig, new)

    return jax.tree.map(keep, pre, post)
