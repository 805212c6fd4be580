"""A small PNG reader and writer for the examples, on ``zlib`` and numpy.

The examples read the committed tiles (``examples/data/*.png``: 8-bit RGB,
non-interlaced) and write their panels without PIL or matplotlib. Example
support code, not a package API.

- :func:`read_png`: an 8-bit RGB or RGBA non-interlaced PNG as an
  (H, W, 3) uint8 array (alpha dropped, as PIL's ``convert("RGB")`` drops
  it), every row filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) undone
  exactly; any other PNG, a bad chunk CRC or a file that is not a PNG
  raises ``ValueError``.
- :func:`write_png`: an (H, W, 3) uint8 array as an 8-bit RGB PNG, filter 0
  on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_BYTES_A_PIXEL = {2: 3, 6: 4}  # colour type (RGB, RGBA) -> bytes a pixel at bit depth 8


def _chunks(data: bytes, path: str):
    """(type, body) of each chunk up to IEND, every CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"{path}: truncated chunk")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:end - 4]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[end - 4:end])[0]:
            raise ValueError(f"{path}: bad CRC in the {kind.decode('latin-1')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end
    raise ValueError(f"{path}: no IEND chunk")


def _unfilter(raw: bytes, h: int, w: int, bpp: int, path: str) -> np.ndarray:
    """Undo each row's filter: (H, W, bpp) uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {rows.size} bytes of image data, not {h * (1 + w * bpp)}")
    rows = rows.reshape(h, 1 + w * bpp)
    kinds = rows[:, 0].astype(np.int32)
    if kinds.max() > 4:
        raise ValueError(f"{path}: unknown row filter {kinds.max()}")
    filtered = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    # A zero row above the image and a zero column left of it: the bytes
    # the filters read outside the image are 0.
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    # A pixel's predictor reads its left, upper and upper-left neighbours,
    # all decoded before it along the anti-diagonals r + c = d, so each
    # anti-diagonal is decoded at once.
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        left, up, up_left = out[r + 1, c], out[r, c + 1], out[r, c]
        p = left + up - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        kind = kinds[r][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [left, up, (left + up) >> 1, paeth], 0)
        out[r + 1, c + 1] = (filtered[r, c] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB or RGBA non-interlaced PNG as (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{path}: IHDR of {len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, colour, compression, filter_method, interlace = header
    if depth != 8 or colour not in _BYTES_A_PIXEL or compression or filter_method or interlace:
        raise ValueError(f"{path}: only 8-bit RGB or RGBA non-interlaced PNGs are read (bit depth "
                         f"{depth}, colour type {colour}, interlace {interlace})")
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, _BYTES_A_PIXEL[colour], path)
    return np.ascontiguousarray(pixels[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, hwc_u8) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    img = np.asarray(hwc_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape:
        raise ValueError(f"write_png takes a non-empty (H, W, 3) uint8 array, got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # the leading byte of each row: filter 0
    raw[:, 1:] = img.reshape(h, 3 * w)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))
