"""Target-image ingestion and render export.

The reference loads an 8-bit JPEG and converts to float32 RGBA (main.cpp:
254-258, prlib Image2DRGBA8_to_Image2DRGBA32); only RGB participates in the
fit. Here: decode -> float32 RGB in [0, 1] (value / 255). PNG is read and
written with zlib and numpy alone; other formats need Pillow, which is an
optional dependency.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

ASSETS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets")

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type -> samples per pixel


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (types 0-4)."""
    out = np.zeros((height, stride), np.uint8)
    src = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        ftype, line = src[y, 0], src[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG to uint8 (H, W, channels)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB(A) "
                         "PNG is supported without Pillow")
    ch = _CHANNELS[ctype]
    pix = _unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    return pix.reshape(height, width, ch)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Encode uint8 (H, W, 3) RGB as a PNG (filter 0, zlib level 6)."""
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(kind, body):
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body \
            + struct.pack(">I", crc)

    with open(path, "wb") as fh:
        fh.write(_PNG_SIG
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw, 6))
                 + chunk(b"IEND", b""))


def _pillow():
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - depends on the install
        raise ImportError("images other than PNG need Pillow (pip install "
                          "pillow); PNG works without it") from e
    return Image


def load_image(path: str) -> np.ndarray:
    """Decode an image file to float32 RGB (H, W, 3) in [0, 1]."""
    if path.lower().endswith(".png"):
        pix = read_png(path)
        if pix.shape[2] in (1, 2):       # gray (+ alpha)
            pix = np.repeat(pix[..., :1], 3, axis=2)
        arr = pix[..., :3].astype(np.float32)
    else:
        with _pillow().open(path) as im:
            arr = np.asarray(im.convert("RGB"), dtype=np.float32)
    return arr / np.float32(255.0)


def load_asset(name: str) -> np.ndarray:
    """Load one of the bundled target images (squirrel_cls_mini.png 268x213,
    squirrel_cls.png 535x426 -- the reference's bin/ assets, decoded once
    from its JPEGs)."""
    return load_image(os.path.join(ASSETS_DIR, name))


def save_image(path: str, color: np.ndarray) -> None:
    """Write a float32 [0,1] RGB array (PNG natively, else via Pillow)."""
    arr = np.clip(np.asarray(color) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if path.lower().endswith(".png"):
        write_png(path, arr)
    else:
        _pillow().fromarray(arr).save(path)


def synthetic_target(height: int, width: int, seed: int = 0) -> np.ndarray:
    """A deterministic smooth synthetic target for tests (no file IO)."""
    y = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :]
    r = 0.5 + 0.5 * np.sin(6.0 * x + seed) * np.cos(5.0 * y)
    g = 0.5 + 0.5 * np.cos(4.0 * x) * np.sin(7.0 * y + seed)
    b = x * y
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0).astype(np.float32)
