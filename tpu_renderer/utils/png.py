"""Minimal PNG codec on the standard library's zlib and numpy.

Covers what the renderer writes and what glTF files usually embed:
8-bit RGB and RGBA, non-interlaced, with all five scanline filter types.
Other valid PNG forms (palette, grayscale, 16-bit, Adam7) raise
``Unsupported``, and callers may hand those to another decoder. Corrupt
data raises ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # color type -> channels (RGB, RGBA)


class Unsupported(ValueError):
    """A well-formed PNG in a form this codec does not decode."""


def _chunk(tag: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(tag + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)


def encode(image: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> PNG bytes (filter type 0 on every row)."""
    a = np.ascontiguousarray(image, np.uint8)
    h, w, c = a.shape
    ctype = {3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)],
                         axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while True:
        head = data[pos:pos + 8]
        if len(head) < 8:
            raise ValueError("PNG ends before its IEND chunk")
        n, tag = struct.unpack(">I4s", head)
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"PNG chunk {tag!r} is truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {tag!r} fails its CRC")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray,
                  c: int) -> np.ndarray:
    if ftype == 0:
        return line
    if ftype == 1:  # Sub: running sum per channel, modulo 256
        return np.cumsum(line.reshape(-1, c), axis=0, dtype=np.uint8) \
            .reshape(-1)
    if ftype == 2:  # Up
        return line + prev
    if ftype not in (3, 4):
        raise ValueError(f"PNG filter type {ftype} does not exist")
    # Average and Paeth depend on the decoded left neighbour: sequential
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        left = cur[i - c] if i >= c else 0
        if ftype == 3:
            pred = (left + up[i]) >> 1
        else:
            pred = _paeth(left, up[i], up[i - c] if i >= c else 0)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA (RGB gets alpha 255)."""
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError("not a PNG (bad signature)")
    ihdr, idat = None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _comp, _filter, interlace = ihdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise Unsupported(f"PNG bit depth {depth}, color type {ctype}, "
                          f"interlace {interlace}")
    c = _CHANNELS[ctype]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, c)
    out = out.reshape(h, w, c)
    if c == 3:
        out = np.concatenate([out, np.full((h, w, 1), 255, np.uint8)], axis=2)
    return out
