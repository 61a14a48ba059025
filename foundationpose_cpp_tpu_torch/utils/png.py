"""PNG read and write with the standard library's zlib and numpy only.

The JAX package reads and writes its images through cv2 or PIL
(``utils/io.py``, ``utils/synthetic.py``, ``meshio/procedural.py``); the
port's machines may have neither, so the port keeps this codec instead.

Reader: non-interlaced PNGs of colour type 0 (gray), 2 (RGB), 3 (palette),
4 (gray + alpha) and 6 (RGBA) at bit depth 8 or 16 (palette indices also at
1, 2 or 4 bits), with all five row filters. Adam7 interlacing raises.
Returns uint8 or uint16 (native byte order) arrays shaped (H, W) for gray
and (H, W, C) otherwise; a palette expands to RGB, or RGBA when the file
has a tRNS chunk.

Writer: 8-bit gray (H, W) uint8, 8-bit RGB (H, W, 3) uint8 and 16-bit gray
(H, W) uint16, unfiltered rows.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: PNG ends without an IEND chunk")


def _paeth_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prior[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """(h, stride) uint8 scanlines from the filtered stream."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, cur = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            rec = cur.copy()
        elif kind == 1:  # Sub: a running sum mod 256 along each byte lane
            # (bpp divides stride: a whole pixel, or 1 for sub-byte palettes)
            rec = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            rec = cur + prior
        elif kind in (3, 4):
            buf = bytearray(cur.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prior.tobytes(), bpp)
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG row filter {kind}")
        out[y] = rec
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode the PNG at ``path``; see the module docstring for the formats."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header = None
    idat, palette, trns = [], None, None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNGs are not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    allowed = (1, 2, 4, 8) if ctype == 3 else (8, 16)
    if depth not in allowed:
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth {depth} is not supported")
    ch = _CHANNELS[ctype]
    bits = w * ch * depth
    stride = (bits + 7) // 8
    bpp = max(1, ch * depth // 8)
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, bpp, path)

    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        idx = np.unpackbits(rows, axis=1)[:, : w * depth] if depth < 8 else rows
        if depth < 8:
            weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
            idx = (idx.reshape(h, w, depth) * weights).sum(axis=-1).astype(np.uint8)
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        rgb = palette[idx]
        if trns is None:
            return rgb
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[: len(trns)] = trns[: len(palette)]
        return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)

    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        img = rows.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, img: np.ndarray) -> None:
    """Encode 8-bit gray (H, W) or RGB (H, W, 3) uint8, or 16-bit gray (H, W)
    uint16, to ``path``."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        depth, ctype, samples = 8, 0, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, ctype, samples = 8, 2, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, samples = 16, 0, img.astype(">u2")
    else:
        raise ValueError(
            f"write_png takes (H, W) or (H, W, 3) uint8, or (H, W) uint16; got "
            f"{img.shape} {img.dtype}"
        )
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                 + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))
