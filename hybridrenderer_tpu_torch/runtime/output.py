"""Headless framebuffer output: PNG encode and decode in pure Python
(hybridrenderer_tpu/runtime/output.py). Images are numpy arrays; call
``tensor.cpu().numpy()`` first.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def to_u8(img) -> np.ndarray:
    """Float [0,1] (H,W,3|4) → uint8."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return a


def encode_png(img) -> bytes:
    """Encode (H, W, {1,3,4}) image (float [0,1] or uint8) as PNG bytes."""
    a = to_u8(img)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img) -> str:
    """Write (H, W, {1,3,4}) image (float [0,1] or uint8) as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader (8-bit, non-interlaced, RGB/RGBA/gray)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    assert bit_depth == 8, "only 8-bit PNG supported"
    channels = {0: 1, 2: 3, 6: 4, 4: 2}[color_type]
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 2:  # up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 1:  # sub
            for i in range(channels, stride):
                line[i] = (int(line[i]) + int(line[i - channels])) & 0xFF
        elif ftype == 3:  # average
            for i in range(stride):
                left = int(line[i - channels]) if i >= channels else 0
                line[i] = (int(line[i]) + ((left + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # paeth
            for i in range(stride):
                a_ = int(line[i - channels]) if i >= channels else 0
                b_ = int(prev[i])
                c_ = int(prev[i - channels]) if i >= channels else 0
                p = a_ + b_ - c_
                pa, pb, pc = abs(p - a_), abs(p - b_), abs(p - c_)
                pr = a_ if (pa <= pb and pa <= pc) else (b_ if pb <= pc else c_)
                line[i] = (int(line[i]) + pr) & 0xFF
        out[y] = line
        prev = out[y]
    return out.reshape(h, w, channels)
