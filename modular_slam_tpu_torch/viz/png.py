"""Minimal dependency-free PNG codec, numpy-only (a copy of
modular_slam_tpu/viz/png.py, which the port may not import).

Writes 8-bit gray/RGB and 16-bit gray; reads the same back
(non-interlaced, color types 0/2, bit depths 8/16, every filter).  The
dataset writer (eval/make_dataset.py) uses it, and the dataset reader
(io/tum.py) ends its decoder chain with `read_png`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H,W] uint8/uint16 gray or [H,W,3] uint8 RGB."""
    with open(path, "wb") as f:
        _write_to(f, img)


def encode_png(img: np.ndarray) -> bytes:
    """In-memory variant of write_png (for the web viewer)."""
    import io

    buf = io.BytesIO()
    _write_to(buf, img)
    return buf.getvalue()


def _write_to(f, img: np.ndarray) -> None:
    img = np.ascontiguousarray(img)
    if img.ndim == 2 and img.dtype == np.uint8:
        color_type, bit_depth = 0, 8
        raw, stride = img.tobytes(), img.shape[1]
    elif img.ndim == 2 and img.dtype == np.uint16:
        color_type, bit_depth = 0, 16
        raw, stride = img.astype(">u2").tobytes(), img.shape[1] * 2
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        color_type, bit_depth = 2, 8
        raw, stride = img.tobytes(), img.shape[1] * 3
    else:
        raise ValueError(f"unsupported image shape/dtype {img.shape} {img.dtype}")
    h = img.shape[0]
    lines = bytearray()
    for y in range(h):
        lines.append(0)
        lines += raw[y * stride: (y + 1) * stride]
    ihdr = struct.pack(
        ">IIBBBBB", img.shape[1], h, bit_depth, color_type, 0, 0, 0)
    f.write(_MAGIC)
    f.write(_chunk(b"IHDR", ihdr))
    f.write(_chunk(b"IDAT", zlib.compress(bytes(lines), 6)))
    f.write(_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    if pb <= pc:
        return b
    return c


def read_png(path: str) -> np.ndarray:
    """Read non-interlaced 8/16-bit gray or 8-bit RGB PNG (all filters)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _MAGIC:
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = bytearray()
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        tag = data[pos + 4: pos + 8]
        payload = data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if color_type == 0:
        channels = 1
    elif color_type == 2:
        channels = 3
    else:
        raise ValueError(f"color type {color_type} unsupported")
    bpp = channels * (bit_depth // 8)
    stride = w * bpp
    raw = zlib.decompress(bytes(idat))

    out = bytearray(h * stride)
    prev = bytearray(stride)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = bytearray(raw[y * (stride + 1) + 1: (y + 1) * (stride + 1)])
        if ftype == 1:  # Sub
            for i in range(bpp, stride):
                line[i] = (line[i] + line[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            for i in range(stride):
                line[i] = (line[i] + prev[i]) & 0xFF
        elif ftype == 3:  # Average
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                c = prev[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + _paeth(a, prev[i], c)) & 0xFF
        elif ftype != 0:
            raise ValueError(f"filter {ftype} unsupported")
        out[y * stride: (y + 1) * stride] = line
        prev = line

    if bit_depth == 8:
        arr = np.frombuffer(bytes(out), np.uint8)
    else:
        arr = np.frombuffer(bytes(out), ">u2").astype(np.uint16)
    if channels == 1:
        return arr.reshape(h, w)
    return arr.reshape(h, w, 3)
