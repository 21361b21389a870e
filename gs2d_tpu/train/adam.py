"""Reference-faithful Adam on the splat parameter pytree.

The reference keeps 9 independent scalar Adam states per splat
(main.cpp:139-166) with external bias-correction powers beta1t/beta2t that are
multiplied *before* the updates each iteration (main.cpp:718-719), and clamps
parameters afterwards (main.cpp:740-749). This module reproduces those
semantics as a pure pytree transformation (SoA moments, same float32 math),
which is the accelerator-idiomatic form: one fused elementwise update over (N,)-shaped
arrays instead of 9N scalar calls.

optax is deliberately not used for the core update: its scale_by_adam applies
bias correction with int step counts and a different eps placement; matching
the reference requires the exact formula value - lr * m_hat / (sqrt(v_hat) + 1e-15)
(main.cpp:144-156).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.params import (GaussianParams, clamp_params, freeze_dead_slots,
                             zeros_like_params)
from gs2d_tpu.utils import pytree


@pytree.dataclass
class AdamState:
    """First/second moments (SoA, mirrors SplatAdam main.cpp:158-166) plus the
    running bias powers and iteration count (main.cpp:274-278)."""

    m: GaussianParams
    v: GaussianParams
    beta1t: jax.Array  # scalar f32, product of beta1 over steps
    beta2t: jax.Array
    step: jax.Array    # scalar i32


def init_adam_state(params: GaussianParams) -> AdamState:
    return AdamState(
        m=zeros_like_params(params),
        v=zeros_like_params(params),
        beta1t=jnp.float32(1.0),
        beta2t=jnp.float32(1.0),
        step=jnp.int32(0),
    )


def adam_update(
    params: GaussianParams,
    grads: GaussianParams,
    state: AdamState,
    cfg: SplatConfig,
) -> tuple[GaussianParams, AdamState]:
    """One optimizer step: bias powers, 9 per-splat Adam updates (opacity gated
    by cfg.optimize_opacity, main.cpp:735-738), then clamps."""
    b1 = jnp.float32(cfg.adam_beta1)
    b2 = jnp.float32(cfg.adam_beta2)
    lr = jnp.float32(cfg.learning_rate)
    if cfg.lr_decay_iters > 0:
        # Exponential decay lr -> lr_final over lr_decay_iters steps, then
        # held; a traced function of the on-device step counter (no
        # recompiles across the schedule).
        frac = jnp.minimum(
            state.step.astype(jnp.float32) / jnp.float32(cfg.lr_decay_iters),
            jnp.float32(1.0))
        lr = lr * jnp.power(jnp.float32(cfg.lr_final / cfg.learning_rate),
                            frac)
    eps = jnp.float32(cfg.adam_eps)
    beta1t = state.beta1t * b1
    beta2t = state.beta2t * b2

    def upd(value, g, m, v):
        m_new = b1 * m + (jnp.float32(1.0) - b1) * g
        v_new = b2 * v + (jnp.float32(1.0) - b2) * g * g
        m_hat = m_new / (jnp.float32(1.0) - beta1t)
        v_hat = v_new / (jnp.float32(1.0) - beta2t)
        return value - lr * m_hat / (jnp.sqrt(v_hat) + eps), m_new, v_new

    new_p, new_m, new_v = {}, {}, {}
    fields = ["pos", "sx", "sy", "rot", "color", "opacity"]
    for f in fields:
        value, g = getattr(params, f), getattr(grads, f)
        m, v = getattr(state.m, f), getattr(state.v, f)
        if f == "opacity" and not cfg.optimize_opacity:
            # Reference leaves both the value and the Adam moments untouched
            # when the toggle is off (main.cpp:735-738).
            new_p[f], new_m[f], new_v[f] = value, m, v
        else:
            new_p[f], new_m[f], new_v[f] = upd(value, g, m, v)

    updated = GaussianParams(**new_p)
    # Slots parked dead by densify/prune must not be clamped back on-screen.
    params = freeze_dead_slots(params, clamp_params(updated, cfg))
    state = AdamState(
        m=GaussianParams(**new_m),
        v=GaussianParams(**new_v),
        beta1t=beta1t,
        beta2t=beta2t,
        step=state.step + 1,
    )
    return params, state
