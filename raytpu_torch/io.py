"""Image output (counterpart of ``raytpu/io.py``; numpy only).

The reference displays via a fullscreen-quad blit (CSVersion/ShaderDisplay.hlsl)
and ships one golden screenshot (examples/12depth20rays.png).  We write PNG
(stdlib-only encoder) and PPM files instead.  Internal images are (H, W, 3)
f32 in [0,1] with row 0 at the BOTTOM (v = 0); files are written top-down.

The writers take numpy arrays (a CPU tensor converts implicitly).  A CUDA
image is brought to the host by the caller (``img.cpu().numpy()``): this
module never moves data between devices on its own.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img) -> np.ndarray:
    """[0,1] f32 -> u8, flipped to display orientation (top row first)."""
    arr = np.asarray(img)
    arr = np.clip(arr, 0.0, 1.0)
    return (arr[::-1] * 255.0 + 0.5).astype(np.uint8)


def save_ppm(path: str, img) -> None:
    arr = to_uint8(img)
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def save_png(path: str, img) -> None:
    """Minimal RGB8 PNG writer (no external deps)."""
    arr = to_uint8(img)
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 9))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def save_image(path: str, img) -> None:
    if path.endswith(".ppm"):
        save_ppm(path, img)
    else:
        save_png(path, img)
