"""A PNG codec on zlib and numpy: the port's counterpart of
``cv2.imread(path, cv2.IMREAD_COLOR)`` for PNG files, of PIL's header
read, and of ``cv2.imwrite`` for fixtures.

The data layer decodes frames with OpenCV where it imports and with
:func:`imread_png` where it does not (``data/imdb.py`` ``read_frame``),
and reads every header with :func:`read_png_size`: its on-device paths
(``--device_augment``, ``--device_dataset``) thus train where neither
OpenCV nor PIL is installed.

Decoded: non-interlaced PNGs of bit depth 8 in colour type gray (0), RGB
(2) or RGBA (6), with any of the five row filters.  As cv2 does, gray
becomes three equal channels and alpha is dropped; the result is BGR
uint8 [H, W, 3].  PNG is lossless, so it equals cv2's decode bit for
bit.  Anything else (palette, 16-bit, interlaced, a bad CRC) raises
``ValueError`` naming the file.

Sub and Up rows are vectorised (Sub is a running sum in uint8 along the
row).  Avg and Paeth depend on the reconstructed left neighbour, so they
loop along the row in Python, one byte at a time: a file written with
adaptive filters (as libpng and cv2 write) decodes far slower than one
written with filter 0 only.  :func:`encode_png` writes any one filter
for every row, or chooses each row's filter as libpng does.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk after the signature, CRC-checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError("{}: not a PNG file".format(path))
    pos = 8
    while pos + 12 <= len(data):
        length, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError("{}: truncated {} chunk".format(
                path, kind.decode("latin-1")))
        payload = data[pos + 8:end]
        crc, = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError("{}: bad CRC in the {} chunk".format(
                path, kind.decode("latin-1")))
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("{}: no IEND chunk".format(path))


def _header(payload: bytes, path: str):
    if len(payload) != 13:
        raise ValueError("{}: bad IHDR chunk".format(path))
    return struct.unpack(">IIBBBBB", payload)


def read_png_size(path: str) -> Tuple[int, int]:
    """(width, height) from the IHDR chunk, reading 33 bytes."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError("{}: not a PNG file".format(path))
    width, height = struct.unpack(">II", head[16:24])
    return width, height


def _unfilter_avg(line: bytes, up: bytes, bpp: int) -> bytes:
    out = bytearray(line)
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    return bytes(out)


def _unfilter_paeth(line: bytes, up: bytes, bpp: int) -> bytes:
    out = bytearray(line)
    for i in range(len(out)):
        if i >= bpp:
            a, c = out[i - bpp], up[i - bpp]
        else:
            a = c = 0
        b = up[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (out[i] + pred) & 0xFF
    return bytes(out)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    """Undo the per-row filters: [height, stride] uint8 samples."""
    if len(raw) != height * (stride + 1):
        raise ValueError("{}: image data holds {} bytes, expected {}".format(
            path, len(raw), height * (stride + 1)))
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros((stride,), np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:
            np.add(line, prev, out=out[y])
        elif kind == 3:
            out[y] = np.frombuffer(_unfilter_avg(
                line.tobytes(), prev.tobytes(), bpp), np.uint8)
        elif kind == 4:
            out[y] = np.frombuffer(_unfilter_paeth(
                line.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError("{}: unknown row filter {} in row {}".format(
                path, int(kind), y))
        prev = out[y]
    return out


def imread_png(path: str) -> np.ndarray:
    """Decode a PNG to BGR uint8 [H, W, 3], as ``cv2.imread(path)``."""
    with open(path, "rb") as f:
        data = f.read()
    header = None
    idat = []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = _header(payload, path)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise ValueError("{}: no IHDR or IDAT chunk".format(path))
    width, height, depth, colour, compression, filt, interlace = header
    if depth != 8 or colour not in _CHANNELS or compression != 0 or \
            filt != 0 or interlace != 0:
        raise ValueError(
            "{}: unsupported PNG (bit depth {}, colour type {}, interlace "
            "{}); decoded are non-interlaced 8-bit gray, RGB and "
            "RGBA".format(path, depth, colour, interlace))
    bpp = _CHANNELS[colour]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError("{}: corrupt image data ({})".format(path, e))
    pixels = _unfilter(raw, height, width * bpp, bpp, path).reshape(
        height, width, bpp)
    if bpp == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, 2::-1])


def row_filters(path: str) -> np.ndarray:
    """The row filter (0 none, 1 Sub, 2 Up, 3 Avg, 4 Paeth) of each row
    of a PNG that :func:`imread_png` decodes: [height] uint8."""
    with open(path, "rb") as f:
        chunks = list(_chunks(f.read(), path))
    width, height, _, colour, _, _, _ = _header(chunks[0][1], path)
    raw = zlib.decompress(b"".join(p for k, p in chunks if k == b"IDAT"))
    stride = width * _CHANNELS[colour] + 1
    return np.frombuffer(raw, np.uint8).reshape(height, stride)[:, 0].copy()


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _filter_rows(rows: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """Apply one PNG row filter to every row of [H, stride] uint8 samples
    (the encoder sees the unfiltered neighbours, so this vectorises)."""
    x = rows.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if filter_type == 0:
        pred = np.zeros_like(x)
    elif filter_type == 1:
        pred = left
    elif filter_type == 2:
        pred = up
    elif filter_type == 3:
        pred = (left + up) >> 1
    elif filter_type == 4:
        upleft = np.zeros_like(x)
        upleft[1:, bpp:] = x[:-1, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    else:
        raise ValueError("PNG row filters are 0..4, got {}".format(
            filter_type))
    return ((x - pred) & 0xFF).astype(np.uint8)


def _adaptive_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Each row filtered by the filter whose residuals, read as signed
    bytes, have the least sum of magnitudes (libpng's adaptive choice);
    [H, stride + 1] with the filter byte first."""
    filtered = np.stack([_filter_rows(rows, bpp, f) for f in range(5)])
    cost = np.abs(filtered.view(np.int8).astype(np.int32)).sum(axis=2)
    best = np.argmin(cost, axis=0)  # [H]; ties go to the lower filter
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = best
    out[:, 1:] = filtered[best, np.arange(rows.shape[0])]
    return out


def encode_png(bgr_u8: np.ndarray, level: int = 6,
               filter_type: Optional[int] = 0) -> bytes:
    """BGR uint8 [H, W, 3] -> the bytes of an 8-bit RGB PNG whose rows all
    use ``filter_type`` (0 none, 1 Sub, 2 Up, 3 Avg, 4 Paeth), or, with
    ``filter_type=None``, each row the filter libpng's adaptive choice
    would give it."""
    im = np.asarray(bgr_u8)
    if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
        raise ValueError("encode_png takes BGR uint8 [H, W, 3], got {} "
                         "{}".format(im.dtype, im.shape))
    height, width, _ = im.shape
    samples = im[:, :, ::-1].reshape(height, width * 3)
    if filter_type is None:
        rows = _adaptive_rows(samples, 3)
    else:
        rows = np.empty((height, width * 3 + 1), np.uint8)
        rows[:, 0] = filter_type
        rows[:, 1:] = _filter_rows(samples, 3, filter_type)
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, bgr_u8: np.ndarray, level: int = 6,
              filter_type: Optional[int] = 0) -> None:
    """Write BGR uint8 [H, W, 3] as an 8-bit RGB PNG (:func:`encode_png`)."""
    data = encode_png(bgr_u8, level, filter_type)
    with open(path, "wb") as f:
        f.write(data)
