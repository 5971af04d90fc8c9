"""PNG decoding for the host images, with ``zlib`` and numpy (the port's
stand-in for PIL, which the GPU host does not have).

``load_rgb(path)`` returns what ``np.asarray(Image.open(path).convert("RGB"))``
returns, (H, W, 3) uint8, for 8-bit non-interlaced PNGs of colour types 0
(grey), 2 (RGB), 3 (palette), 4 (grey and alpha) and 6 (RGBA): grey is
replicated into the three channels, palette indices are looked up, and
alpha is dropped without compositing. Interlaced files and bit depths other
than 8 raise. Every chunk's CRC is checked.

The row filters (None, Sub, Up, Average, Paeth) are reversed by the native
library (``data/native.py:png_unfilter``, C++ in ``csrc/fastcsv.cpp``):
Average and Paeth carry a dependency from each pixel to the next along a
row, so numpy can only vectorise them across a pixel's channels.
``unfilter_numpy`` is that plain version; the tests and ``chip_smoke.py``
hold the library to it and time both.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type: samples a pixel
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PNGError(ValueError):
    pass


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG file (bad signature)")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise PNGError("truncated chunk header")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise PNGError(f"truncated {ctype!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise PNGError(f"CRC mismatch in a {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise PNGError("no IEND chunk")


def parse(data: bytes) -> Tuple[Dict[str, int], np.ndarray, bytes]:
    """(header fields, palette (n, 3) uint8 or None, the inflated image
    data) of a PNG file's bytes; raises on what ``load_rgb`` does not take."""
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            w, h, depth, colour, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
            header = {"width": w, "height": h, "depth": depth, "colour": colour,
                      "interlace": interlace}
            if comp != 0 or filt != 0:
                raise PNGError(f"unknown compression {comp} or filter method {filt}")
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError("no IHDR chunk")
    if header["interlace"] != 0:
        raise PNGError("interlaced PNG (Adam7) is not supported")
    if header["depth"] != 8:
        raise PNGError(f"bit depth {header['depth']} is not supported (8 only)")
    if header["colour"] not in CHANNELS:
        raise PNGError(f"unknown colour type {header['colour']}")
    if header["colour"] == 3 and palette is None:
        raise PNGError("palette image without a PLTE chunk")
    return header, palette, zlib.decompress(b"".join(idat))


def unfilter_numpy(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The plain version of ``native.png_unfilter``: row by row, Sub as a
    wrapping cumulative sum per channel, Up as one add, Average and Paeth
    pixel by pixel across the channels."""
    rows = np.asarray(raw, dtype=np.uint8).reshape(height, row_bytes + 1)
    out = np.empty((height, row_bytes), dtype=np.uint8)
    prev = np.zeros(row_bytes, dtype=np.int32)
    for r in range(height):
        ftype, x = int(rows[r, 0]), rows[r, 1:].astype(np.int32)
        if ftype == 0:
            cur = x
        elif ftype == 1:
            cur = np.cumsum(x.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:
            cur = (x + prev) & 255
        elif ftype in (3, 4):
            cur = np.empty(row_bytes, dtype=np.int32)
            zero = np.zeros(bpp, dtype=np.int32)
            for i in range(0, row_bytes, bpp):
                a = cur[i - bpp:i] if i else zero
                b = prev[i:i + bpp]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - bpp:i] if i else zero
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                cur[i:i + bpp] = (x[i:i + bpp] + pred) & 255
        else:
            raise PNGError(f"unknown PNG filter type {ftype} in row {r}")
        out[r] = cur
        prev = cur
    return out


def decode(data: bytes, unfilter=None) -> np.ndarray:
    """A PNG file's bytes -> (H, W, 3) uint8, as PIL's ``convert("RGB")``.
    ``unfilter`` (default: the native library) reverses the row filters."""
    if unfilter is None:
        from .native import png_unfilter as unfilter
    header, palette, raw = parse(data)
    w, h, colour = header["width"], header["height"], header["colour"]
    bpp = CHANNELS[colour]
    pix = unfilter(np.frombuffer(raw, dtype=np.uint8), h, w * bpp, bpp).reshape(h, w, bpp)
    if colour == 3:
        lut = np.zeros((256, 3), dtype=np.uint8)  # indices past the palette read black
        lut[:len(palette)] = palette[:256]
        return lut[pix[..., 0]]
    if colour in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def load_rgb(path: str, unfilter=None) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))`` without PIL."""
    with open(path, "rb") as f:
        return decode(f.read(), unfilter)
