"""Image IO helpers: a minimal PNG encoder and decoder on zlib alone, so
rendering, the viewer and training read and write PNGs without PIL. PIL is
used, where installed, only to read other formats (io.dataset)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

def _png_bytes(arr: np.ndarray) -> bytes:
    """Minimal PNG encoder for uint8 [H, W, {1,3,4}] arrays."""
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    return img


def write_png(img, path: str) -> None:
    """Write a float [0,1] or uint8 image to a PNG file."""
    with open(path, "wb") as f:
        f.write(_png_bytes(to_uint8(img)))


def encode_png(img) -> bytes:
    """Encode to PNG bytes (for the web viewer)."""
    return _png_bytes(to_uint8(img))


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # PNG color type → samples per pixel


def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    """Undo the per-row PNG filters (spec §9) of 8-bit samples."""
    stride = w * c
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:                                   # None
            cur = line.copy()
        elif kind == 2:                                 # Up
            cur = line + prev
        elif kind == 1:                                 # Sub
            cur = np.cumsum(line.reshape(w, c), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind in (3, 4):                            # Average, Paeth
            cur = np.zeros(stride, np.uint8)
            for i in range(stride):
                a = int(cur[i - c]) if i >= c else 0
                b = int(prev[i])
                if kind == 3:
                    pred = (a + b) // 2
                else:
                    cc = int(prev[i - c]) if i >= c else 0
                    pa, pb, pc = abs(b - cc), abs(a - cc), abs(a + b - 2 * cc)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else cc)
                cur[i] = (int(line[i]) + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, c)


def decode_png(data: bytes) -> np.ndarray:
    """Decode a non-interlaced 8-bit PNG (gray, gray+alpha, RGB or RGBA —
    what write_png and common tools write) → uint8 [H, W, C]."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = ihdr
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type "
                         f"{color}, interlace {interlace}")
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[color])


def read_image(path: str) -> np.ndarray:
    """Read a PNG to float32 [0,1] [H, W, 3] (gray is expanded, alpha is
    dropped)."""
    with open(path, "rb") as f:
        arr = decode_png(f.read())
    if arr.shape[-1] <= 2:
        arr = np.repeat(arr[..., :1], 3, axis=-1)
    return arr[..., :3].astype(np.float32) / 255.0
