"""Image files of the port's loaders and writers.

Every 8-bit, non-interlaced grey, grey + alpha, RGB or RGBA PNG file (the
blender layout's format) is read and written by the small codec below, on
every machine, so the CPU and the card read images through the same code:
all five row filters on reading, filter 0 on writing.  Other files (JPEG,
16-bit or palette PNGs) go through imageio, as the reference reads them,
and so do JPEG and GIF writes (``imwrite``, ``mimwrite``); imageio is
imported only when such a file is read or written.  The H100 machine has no
imageio, so there they raise ``ImageioMissing``, an ImportError (and a
RuntimeError) that names imageio.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}         # colour type -> samples a pixel
_COLOUR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _imageio():
    try:
        import imageio.v2 as imageio
    except ImportError:
        return None
    return imageio


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 [H, W] or [H, W, C] (C in 1-4) -> an 8-bit PNG file."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOUR_TYPE:
        raise ValueError(f"write_png takes 1-4 channels, not {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], 1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter(kinds: np.ndarray, lines: np.ndarray, bpp: int) -> np.ndarray:
    """Filtered rows [h, w * bpp] (uint8) with their filters ``kinds`` [h]
    undone (PNG spec 9.2) -> uint8 [h, w * bpp].

    A byte depends on its left, upper and upper-left neighbours, so the
    pixels of one anti-diagonal (y + x constant) are independent: the loop
    walks the h + w - 1 diagonals, each in one vectorised step, whatever
    mix of filters the rows use."""
    if not np.isin(kinds, (0, 1, 2, 3, 4)).all():
        raise ValueError(f"unknown PNG row filter in {sorted(set(kinds.tolist()))}")
    h, n = lines.shape
    w = n // bpp
    line = lines.reshape(h, w, bpp).astype(np.int32)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)   # a zero row above, a zero column left
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        k = kinds[y][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([k == 1, k == 2, k == 3, k == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (line[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, n)


def _codec_reads(path: str) -> bool:
    """Whether ``path`` is a PNG file the codec reads (its IHDR comes first)."""
    with open(path, "rb") as f:
        head = f.read(29)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR" or len(head) < 29:
        return False
    depth, colour, interlace = head[24], head[25], head[28]
    return depth == 8 and colour in _CHANNELS and not interlace


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced PNG file -> uint8 [H, W, C] (C in 1-4; grey
    gives [H, W])."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(f"{path}: the codec reads only 8-bit, non-interlaced grey/RGB(A) "
                         f"PNGs (bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace})")
    c = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w * c + 1)
    img = _unfilter(raw[:, 0], raw[:, 1:], c).reshape(h, w, c)
    return img[..., 0] if c == 1 else img


class ImageioMissing(ImportError, RuntimeError):
    """A file other than an 8-bit PNG was read or written without imageio."""


def _need_imageio(path: str):
    imageio = _imageio()
    if imageio is None:
        raise ImageioMissing(f"{path}: this file needs imageio (without it the port reads "
                             "and writes only 8-bit grey/RGB(A) PNG files)")
    return imageio


def imread(path: str) -> np.ndarray:
    if path.lower().endswith(".png") and _codec_reads(path):
        return read_png(path)
    return _need_imageio(path).imread(path)


def imwrite(path: str, img: np.ndarray) -> None:
    """One image: PNG through the codec, anything else (JPEG) through
    imageio."""
    if path.lower().endswith(".png"):
        write_png(path, img)
    else:
        _need_imageio(path).imwrite(path, img)


def mimwrite(path: str, frames, **kwargs) -> None:
    """An animation (GIF) of uint8 frames, through imageio."""
    _need_imageio(path).mimwrite(path, frames, **kwargs)
