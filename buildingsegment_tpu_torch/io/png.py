"""Minimal PNG encoder and decoder (stdlib zlib and numpy).

The port's copy of ``buildingsegment_tpu/io/png.py``.  The reference
vendors stb_image_write and calls only ``stbi_write_png``
(tmc3/TMC3.cpp:98,108,119) to dump three RGB rasters; the encoder here
emits the format directly: signature, IHDR, one zlib IDAT of filter-0
scanlines, IEND.  The decoder defilters through the native codec
(``native/binding.py``) where it is built, as the JAX module does, and
else through :func:`defilter_numpy`, its plain version (our own PNGs use
filter 0 only, so re-reading them never reaches its per-byte
Average/Paeth loop).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_png", "encode_png", "read_png", "defilter_numpy"]


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray) -> bytes:
    """Encode uint8 image [H, W] (gray) or [H, W, C] (C=1/3/4) to PNG bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError("PNG encoder expects uint8")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # filter byte 0 (None) prepended to each scanline
    raw = np.concatenate(
        [np.zeros((h, 1), dtype=np.uint8), img.reshape(h, w * c)], axis=1
    ).tobytes()
    idat = zlib.compress(raw, 6)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", idat)
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG back to uint8 [H, W, C].

    Supports the filter our encoder emits plus the other standard ones
    (0-4), so round-trip tests and the contour stage can re-load
    rendered rasters.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    ihdr = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("missing IHDR")
    w, h, depth, color_type, _, _, interlace = ihdr
    if depth != 8 or interlace != 0:
        raise ValueError("unsupported PNG variant")
    c = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * c
    if len(raw) < h * (stride + 1):
        raise ValueError("truncated PNG data")

    tags = np.frombuffer(raw, np.uint8)[: h * (stride + 1)].reshape(
        h, stride + 1
    )[:, 0]
    bad = tags[tags > 4]
    if bad.size:
        raise ValueError(f"unsupported filter {int(bad[0])}")

    from buildingsegment_tpu_torch.native.binding import png_defilter_native

    out = png_defilter_native(raw, h, stride, c)
    if out is not None:
        return out.reshape(h, w, c)
    return defilter_numpy(raw, h, w, c)


def defilter_numpy(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    """Undo the PNG scanline filters (0-4) of ``h`` rows of ``w`` pixels
    of ``c`` bytes → uint8[h, w, c] (the plain version of the native
    defilter)."""
    stride = w * c
    tags = np.frombuffer(raw, np.uint8)[: h * (stride + 1)].reshape(
        h, stride + 1
    )[:, 0]
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        filt = tags[y]
        line = np.frombuffer(
            raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], dtype=np.uint8
        ).copy()
        if filt == 0:
            pass
        elif filt == 1:  # Sub: per-channel prefix sum mod 256
            cols = line.reshape(w, c).astype(np.int64)
            line = (np.cumsum(cols, axis=0) & 0xFF).astype(
                np.uint8
            ).reshape(stride)
        elif filt == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        else:  # Average / Paeth — sequential left dependency
            line = line.astype(np.int32)
            pv = prev.astype(np.int32)
            for i in range(stride):
                a = line[i - c] if i >= c else 0
                b = pv[i]
                if filt == 3:
                    line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
                else:
                    cc = pv[i - c] if i >= c else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                    line[i] = (line[i] + pred) & 0xFF
            line = line.astype(np.uint8)
        out[y] = line
        prev = out[y]
    return out.reshape(h, w, c)
