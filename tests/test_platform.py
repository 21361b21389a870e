"""Platform plumbing: PNG I/O without Pillow, the compile-cache location,
the pytree dataclasses, and the on-card kernel check."""

import dataclasses
import os
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gs2d_tpu
from gs2d_tpu.io import image
from gs2d_tpu.params import GaussianParams


def _png(path, pix, ctype, ftype):
    """Write an 8-bit PNG whose every scanline uses filter ``ftype``."""
    h, w, ch = pix.shape
    bpp, stride = ch, w * ch
    rows = pix.reshape(h, stride).astype(np.int32)
    raw = bytearray()
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros(stride, np.int32)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            pa, pb = np.abs(prev - upleft), np.abs(left - upleft)
            pc = np.abs(left + prev - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([ftype]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                              0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(bytes(raw)))
                 + chunk(b"IEND", b""))


class TestPng:
    @pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
    def test_reads_every_filter(self, tmp_path, rng, ftype):
        pix = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
        path = str(tmp_path / "a.png")
        _png(path, pix, 2, ftype)
        np.testing.assert_array_equal(image.read_png(path), pix)

    @pytest.mark.parametrize("ctype,ch", [(0, 1), (6, 4)])
    def test_gray_and_alpha_load_as_rgb(self, tmp_path, rng, ctype, ch):
        pix = rng.integers(0, 256, (5, 6, ch), dtype=np.uint8)
        path = str(tmp_path / "b.png")
        _png(path, pix, ctype, 4)
        rgb = image.load_image(path)
        assert rgb.shape == (5, 6, 3) and rgb.dtype == np.float32
        want = pix[..., :1] if ch == 1 else pix[..., :3]
        np.testing.assert_array_equal(
            np.rint(rgb * 255).astype(np.uint8),
            np.broadcast_to(want, (5, 6, 3)))

    def test_save_load_roundtrip(self, tmp_path, rng):
        img = rng.uniform(0, 1, (11, 13, 3)).astype(np.float32)
        path = str(tmp_path / "c.png")
        image.save_image(path, img)
        back = image.load_image(path)
        np.testing.assert_allclose(back, img, atol=0.5 / 255 + 1e-6)

    def test_png_needs_no_pillow(self, tmp_path, monkeypatch):
        """The main path's image I/O (bundled PNG targets, PNG renders)
        works with Pillow unimportable; other formats say what is missing."""
        monkeypatch.setitem(sys.modules, "PIL", None)
        ref = image.load_asset("squirrel_cls_mini.png")
        assert ref.shape == (213, 268, 3)
        image.save_image(str(tmp_path / "d.png"), ref)
        with pytest.raises(ImportError, match="Pillow"):
            image.load_image(os.path.join(image.ASSETS_DIR,
                                          "squirrel_cls_mini.jpg"))

    def test_bundled_png_matches_jpeg(self):
        """The PNG targets are the JPEGs decoded once, pixel for pixel."""
        pytest.importorskip("PIL")
        for name in ("squirrel_cls_mini", "squirrel_cls"):
            np.testing.assert_array_equal(
                image.load_asset(name + ".png"),
                image.load_asset(name + ".jpg"))


class TestCompileCache:
    def test_env_dir_is_honoured(self, monkeypatch, tmp_path):
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert gs2d_tpu.enable_compilation_cache() == str(tmp_path)
        assert calls == []  # JAX reads the variable itself

    def test_default_is_fixed_path_in_checkout(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = gs2d_tpu.enable_compilation_cache()
        root = os.path.dirname(os.path.dirname(gs2d_tpu.__file__))
        assert path == os.path.join(root, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]
        with open(os.path.join(root, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()


def _params(n=3):
    return GaussianParams(
        pos=jnp.arange(2 * n, dtype=jnp.float32).reshape(n, 2),
        sx=jnp.ones(n), sy=jnp.ones(n), rot=jnp.zeros(n),
        color=jnp.full((n, 3), 0.5), opacity=jnp.ones(n))


class TestPytreeDataclass:
    def test_leaves_in_field_order(self):
        p = _params()
        leaves = jax.tree.leaves(p)
        assert [x.shape for x in leaves] == [(3, 2), (3,), (3,), (3,),
                                             (3, 3), (3,)]

    def test_replace(self):
        p = _params()
        q = p.replace(sx=p.sx * 2)
        assert float(q.sx[0]) == 2.0 and float(p.sx[0]) == 1.0
        assert q.pos is p.pos

    def test_jit_roundtrip(self):
        out = jax.jit(lambda p: jax.tree.map(lambda x: x + 1, p))(_params())
        assert isinstance(out, GaussianParams)
        assert float(out.opacity[0]) == 2.0

    def test_frozen(self):
        p = _params()
        with pytest.raises(dataclasses.FrozenInstanceError):
            p.sx = p.sy


@pytest.mark.gpu
def test_kernel_matches_reference_on_card(gpu):
    """Phase (b) of chip_smoke.py at the reference workload: the compiled
    Triton kernel and the plain path against the scan reference."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke

    chip_smoke.check_case(268, 213, 1024, "squirrel_cls_mini.png")
