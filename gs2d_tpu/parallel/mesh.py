"""Device-mesh construction helpers.

The framework shards over up to three logical axes (SURVEY.md section 2):

- ``data``:  independent target images, each with its own splat population
             (data parallel; no cross-talk)
- ``tile``:  horizontal bands of screen rows (the context/sequence-parallel
             analog -- pixels are the "sequence"); per-splat gradients are
             psum'd over this axis
- ``splat``: contiguous index-ordered slices of the splat population (the
             tensor-parallel analog); per-pixel (C, T) composite partials are
             combined in index order over this axis (the ordered-monoid
             stand-in for ring attention)

The reference has no distributed layer at all (single thread, main.cpp);
everything here is net-new.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
TILE_AXIS = "tile"
SPLAT_AXIS = "splat"
AXES = (DATA_AXIS, TILE_AXIS, SPLAT_AXIS)


def make_mesh(
    data: int = 1,
    tile: int = 1,
    splat: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """A (data, tile, splat) mesh over the given (or all) devices.

    Axis sizes must multiply to the device count.
    """
    if devices is None:
        devices = jax.devices()
    n = data * tile * splat
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(data, tile, splat)
    return Mesh(dev, AXES)


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1, 1)
