"""Where the rasterizer runs: decided here and nowhere else.

- On a GPU the production step runs the Pallas-Triton tile kernel
  (ops/render_gpu.py) over the flat pair list (binning "flat").
- On any other platform it runs the plain XLA tile path
  (ops/render_tiles.py) over the dense per-tile lists (binning "dense").
- Pallas interpret mode runs only when the config asks for it
  (``SplatConfig.interpret``, set by the tests); it is never chosen because
  of the platform.
"""

from __future__ import annotations

import jax

LAYOUTS = ("dense", "flat")


def platform() -> str:
    """The default device's platform ("gpu", "cpu", ...)."""
    return jax.devices()[0].platform


def describe() -> str:
    """One line naming the devices this process runs on."""
    devs = jax.devices()
    return (f"platform={devs[0].platform} device_kind={devs[0].device_kind}"
            f" count={len(devs)}")


def resolve_binning(cfg) -> str:
    """The concrete binning layout of ``cfg`` ("auto" follows the platform:
    the kernel's flat layout on a GPU, the plain path's dense lists
    elsewhere)."""
    if cfg.binning == "auto":
        return "flat" if platform() == "gpu" else "dense"
    if cfg.binning not in LAYOUTS:
        raise ValueError(f"unknown binning {cfg.binning!r}; expected auto, "
                         + " or ".join(LAYOUTS))
    return cfg.binning


def check_kernel(cfg) -> None:
    """Refuse to lower the Triton kernel where it cannot run."""
    if not cfg.interpret and platform() != "gpu":
        raise ValueError(
            "binning='flat' runs the Pallas-Triton kernel, which needs a GPU "
            f"(this process runs on {platform()!r}); use binning='dense' "
            "or 'auto', or set interpret=True to run it in Pallas interpret "
            "mode")
