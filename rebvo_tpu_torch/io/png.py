"""A small PNG codec on zlib and numpy (the port reads EuRoC frames with
it; the JAX package's dataset reader uses PIL, which the port does not
depend on).

    img = read_png(path)          # uint8 / uint16, [H, W] or [H, W, C]
    write_png(path, img)          # the same kinds, any of the 5 filters

What it reads: non-interlaced PNGs of colour type 0 (grey), 2 (RGB) or
6 (RGBA) at bit depth 8 or 16, rows filtered by any of the five filter
types (None, Sub, Up, Average, Paeth). Anything else raises ValueError
naming the format. Sub and Up are undone with whole-row numpy ops;
Average and Paeth depend on the pixel to the left and are undone byte by
byte in Python, so files that use them (as libpng's adaptive filtering
does) decode slower than the writer's own output (Up by default).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> samples per pixel
_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha", 6: "RGBA"}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(ftype: int, row: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Reconstruct one row (uint8 [stride]) from its filtered bytes."""
    if ftype == 0:
        return row
    if ftype == 1:                                    # Sub: running sum
        return np.cumsum(row.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if ftype == 2:                                    # Up
        return row + prev
    if ftype not in (3, 4):
        raise ValueError(f"PNG: unknown row filter type {ftype}")
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:                                # Average
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:                                         # Paeth
            c = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(a, b, c)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file (see the module note for what it reads)."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind not in (b"PLTE", b"IEND") and not kind[0] & 0x20:
            raise ValueError(f"PNG critical chunk "
                             f"{kind.decode('latin-1')} is not supported")
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} "
                         f"({_NAMES.get(ctype, 'unknown')}) is not supported:"
                         f" grey, RGB and RGBA only")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} is not supported: 8 or 16 "
                         f"only")
    if interlace != 0:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if comp != 0 or filt != 0:
        raise ValueError(f"PNG compression/filter method {comp}/{filt} is "
                         f"not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev,
                                      bpp)
    img = out.view(">u2").astype(np.uint16) if depth == 16 else out
    img = img.reshape(height, width, ch)
    return img[..., 0] if ch == 1 else img


def _filter_rows(raw: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    """Filter every row of `raw` (uint8 [H, stride]) with one filter."""
    a = np.zeros_like(raw)
    a[:, bpp:] = raw[:, :-bpp]
    b = np.zeros_like(raw)
    b[1:] = raw[:-1]
    if ftype == 0:
        return raw
    if ftype == 1:
        return raw - a
    if ftype == 2:
        return raw - b
    if ftype == 3:
        return raw - ((a.astype(np.int32) + b) >> 1).astype(np.uint8)
    if ftype == 4:
        c = np.zeros_like(raw)
        c[1:, bpp:] = raw[:-1, :-bpp]
        ai, bi, ci = (x.astype(np.int32) for x in (a, b, c))
        p = ai + bi - ci
        pa, pb, pc = np.abs(p - ai), np.abs(p - bi), np.abs(p - ci)
        pred = np.where((pa <= pb) & (pa <= pc), ai, np.where(pb <= pc, bi,
                                                               ci))
        return raw - pred.astype(np.uint8)
    raise ValueError(f"PNG: unknown row filter type {ftype}")


def write_png(path: str, img: np.ndarray, filter_type: int = 2,
              level: int = 6) -> None:
    """Encode a uint8 or uint16 image, [H, W] (grey) or [H, W, 3|4]
    (RGB, RGBA), every row with `filter_type` (0-4)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png: uint8 or uint16 only, got {img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if img.ndim not in (2, 3) or ctype is None:
        raise ValueError(f"write_png: shape {img.shape} is not grey, RGB or "
                         f"RGBA")
    height, width = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    raw = img.astype(">u2" if depth == 16 else np.uint8).reshape(height, -1)
    raw = raw.view(np.uint8).reshape(height, -1)
    filt = _filter_rows(raw, filter_type, ch * depth // 8)
    body = np.concatenate([np.full((height, 1), filter_type, np.uint8),
                           filt], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data +
                struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as fh:
        fh.write(_SIGNATURE)
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                            ctype, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(body.tobytes(), level)))
        fh.write(chunk(b"IEND", b""))
