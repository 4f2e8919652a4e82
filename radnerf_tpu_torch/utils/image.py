"""Image input and output of the port's datasets and loops.

``imread`` returns what the JAX provider's ``_imread_rgb`` returns (float32
in [0, 1], RGB or RGBA; a grey image as RGB) and ``imread_u8`` the bytes
before the division. The decoder is chosen by the file's content, not by its
name: ``cv2`` where it is installed (the JAX provider's own decoder), else
PIL; without either, PNG content (8-bit, not interlaced, grey, grey+alpha,
RGB or RGBA) goes through this module's own reader (stdlib ``zlib``), and
anything else raises ``ImportError``. ``write_png`` is this module's own
encoder; ``write_video`` writes an mp4 through ``imageio`` where it is
present and can, and per-frame PNGs otherwise, as the JAX ``Trainer.test``
does when its mp4 write fails.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the 8-bit PNGs the own reader takes
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# uint8 -> float32 exactly as numpy's ``astype(np.float32) / 255.0``; a
# lookup keeps the device from dividing (CUDA divides by a Python scalar
# through its reciprocal, an ulp off for some bytes)
U8_TO_UNIT = np.arange(256, dtype=np.float32) / np.float32(255.0)


class _NotOwnPng(Exception):
    """PNG content the own reader does not take (palette, 16-bit,
    interlaced)."""


def _read_png(data: bytes, path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced grey / grey+alpha / RGB / RGBA PNG:
    uint8 [H, W, C] in the file's channel order."""
    pos, idat, header = len(PNG_SIGNATURE), [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: a PNG without IHDR or IDAT")
    W, H, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _PNG_CHANNELS:
        raise _NotOwnPng
    bpp = _PNG_CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[:H * (1 + W * bpp)].reshape(H, 1 + W * bpp)
    kinds, filt = rows[:, 0], rows[:, 1:].reshape(H, W, bpp)
    if not kinds.any():
        return filt.copy()
    if kinds.max() > 4:
        raise ValueError(f"{path}: PNG filter type {int(kinds.max())}")
    return _unfilter(kinds, filt.astype(np.int32)).astype(np.uint8)


def _unfilter(kinds: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters (Sub, Up, Average, Paeth). A pixel needs its
    left, upper and upper-left neighbours, so the pixels of one
    anti-diagonal (row + column = k) are reconstructed together."""
    H, W, _ = filt.shape
    out = np.zeros((H + 1, W + 1, filt.shape[2]), np.int32)  # a zero row and column
    for k in range(H + W - 1):
        r = np.arange(max(0, k - W + 1), min(H, k + 1))
        x = k - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]  # left, up, upper-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(kinds[r][:, None], [np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        out[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return out[1:, 1:]


def _read_with_library(path: str):
    """Decode through cv2, else PIL: uint8 [H, W, C] RGB or RGBA; None when
    neither is installed."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError(f"{path}: cv2 cannot decode it")
        if img.ndim == 2:
            return cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)
        code = cv2.COLOR_BGRA2RGBA if img.shape[-1] == 4 else cv2.COLOR_BGR2RGB
        return cv2.cvtColor(img, code)
    try:
        from PIL import Image
    except ImportError:
        return None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA" if "A" in im.getbands() else "RGB"))


def imread_u8(path: str) -> np.ndarray:
    """An image file as uint8 [H, W, 3 or 4], RGB or RGBA (grey expanded to
    RGB, grey+alpha to RGBA), decoded by content (module note)."""
    img = _read_with_library(path)
    if img is not None:
        return img
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        try:
            img = _read_png(data, path)
        except _NotOwnPng:
            raise ImportError(f"{path} is a palette, 16-bit or interlaced PNG, and decoding "
                              "it needs cv2 or PIL; neither is installed") from None
        if img.shape[-1] <= 2:  # grey (+ alpha): the grey value in R, G and B
            img = np.concatenate([np.repeat(img[..., :1], 3, axis=-1), img[..., 1:]], axis=-1)
        return img
    raise ImportError(f"{path} is not PNG content, and decoding it needs cv2 or PIL; "
                      "neither is installed")


def imread(path: str) -> np.ndarray:
    """float32 [H, W, 3 or 4] in [0, 1] (JAX provider ``_imread_rgb``)."""
    return U8_TO_UNIT[imread_u8(path)]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray):
    """Write uint8 [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4] (RGBA) as an
    8-bit PNG (every row unfiltered)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    color = {1: 0, 3: 2, 4: 6}[C]
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def write_video(path: str, frames: np.ndarray, fps: int = 25) -> list:
    """uint8 frames [T, H, W, 3] as an mp4 at ``path`` through imageio, or,
    where imageio is absent or has no mp4 writer, as ``<stem>_<i:04d>.png``
    beside it. Returns the files written."""
    try:
        import imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        try:
            imageio.mimwrite(path, frames, fps=fps, quality=8, macro_block_size=1)
            return [path]
        except ValueError:  # "Could not find a backend": no ffmpeg plugin
            pass
    stem = os.path.splitext(path)[0]
    paths = [f"{stem}_{i:04d}.png" for i in range(len(frames))]
    for p, img in zip(paths, frames):
        write_png(p, img)
    return paths
