"""BMP reader/writer (host side, NumPy).

TPU-native replacement for the reference's `src/bitmap.c` (SURVEY.md component
1): one pass over an in-memory buffer into an (H, W, 3) uint8 RGB array instead
of a double file read into per-channel pointer arrays. Fixes the reference's
known gaps (README.md:18-19): 4-byte row padding is handled, top-down bitmaps
(negative height) are handled, and BITMAPINFOHEADER/V4/V5 header sizes are all
accepted. 32-bit BGRA input is also accepted (alpha dropped).
"""

from __future__ import annotations

import struct

import numpy as np


class BmpError(ValueError):
    """Raised for malformed or unsupported BMP files (cf. bitmap.h:14-17)."""


# The channel order this reader assumes. BI_BITFIELDS files carry explicit
# masks (at absolute offset 54 in both the BITMAPINFOHEADER+masks and V4/V5
# layouts); anything other than these defaults would silently swap channels,
# so such files are rejected instead.
_DEFAULT_MASKS = (0x00FF0000, 0x0000FF00, 0x000000FF)  # R, G, B


def _check_bitfields_masks(mask_bytes: bytes) -> None:
    if len(mask_bytes) < 12:
        raise BmpError("BI_BITFIELDS file truncated before channel masks")
    masks = struct.unpack_from("<III", mask_bytes, 0)
    if masks != _DEFAULT_MASKS:
        raise BmpError(
            f"unsupported BI_BITFIELDS channel masks {tuple(hex(m) for m in masks)}"
            " (only the BGR(A) defaults are supported)"
        )


def decode_bmp(data: bytes) -> np.ndarray:
    """Parse a BMP byte buffer into an (H, W, 3) uint8 RGB array."""
    if len(data) < 54:
        raise BmpError("file too small to be a BMP")
    if data[0:2] != b"BM":
        raise BmpError("bad magic (expected 'BM')")
    pixel_offset = struct.unpack_from("<I", data, 10)[0]
    header_size = struct.unpack_from("<I", data, 14)[0]
    if header_size < 40:
        raise BmpError(f"unsupported DIB header size {header_size}")
    width, height = struct.unpack_from("<ii", data, 18)
    planes, bpp = struct.unpack_from("<HH", data, 26)
    compression = struct.unpack_from("<I", data, 30)[0]
    if planes != 1:
        raise BmpError(f"planes must be 1, got {planes}")
    if compression not in (0, 3):  # BI_RGB or BI_BITFIELDS (default masks only)
        raise BmpError(f"unsupported compression {compression}")
    if compression == 3:
        _check_bitfields_masks(data[54:66])
    if bpp not in (24, 32):
        raise BmpError(f"unsupported bit depth {bpp} (need 24 or 32)")
    if width <= 0 or height == 0:
        raise BmpError(f"bad dimensions {width}x{height}")

    top_down = height < 0
    h = abs(height)
    channels = bpp // 8
    row_stride = (width * channels + 3) & ~3
    needed = pixel_offset + row_stride * h
    if len(data) < needed:
        raise BmpError(f"truncated pixel data: have {len(data)}, need {needed}")

    raw = np.frombuffer(data, dtype=np.uint8, count=row_stride * h, offset=pixel_offset)
    rows = raw.reshape(h, row_stride)[:, : width * channels]
    px = rows.reshape(h, width, channels)
    if not top_down:
        px = px[::-1]
    # BGR(A) -> RGB (alpha, if present, is dropped)
    return np.ascontiguousarray(px[..., [2, 1, 0]])


def read_bmp(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_bmp(f.read())


class BmpRowReader:
    """Seekable row-range reader for BMPs too large to materialize — the
    on-disk source for the streaming mosaic encoder
    (parallel/mosaic.encode_mosaic_stream). Same format coverage as
    decode_bmp (24/32-bit, bottom-up or top-down, padded rows); rows() takes
    image (top-down) coordinates regardless of the file's row order.

    The reference reads its whole BMP twice into per-channel heap arrays
    (src/bitmap.c:102-152); this reads exactly the rows a stripe needs, once.
    """

    def __init__(self, path: str):
        self._f = open(path, "rb")
        head = self._f.read(54)
        if len(head) < 54 or head[0:2] != b"BM":
            self._f.close()
            raise BmpError("bad magic (expected 'BM')")
        self._pixel_offset = struct.unpack_from("<I", head, 10)[0]
        header_size = struct.unpack_from("<I", head, 14)[0]
        width, height = struct.unpack_from("<ii", head, 18)
        planes, bpp = struct.unpack_from("<HH", head, 26)
        compression = struct.unpack_from("<I", head, 30)[0]
        if (header_size < 40 or planes != 1 or compression not in (0, 3)
                or bpp not in (24, 32) or width <= 0 or height == 0):
            self._f.close()
            raise BmpError("unsupported BMP for row streaming")
        if compression == 3:
            try:
                _check_bitfields_masks(self._f.read(12))
            except BmpError:
                self._f.close()
                raise
        self.width = width
        self.height = abs(height)
        self._top_down = height < 0
        self._channels = bpp // 8
        self._stride = (width * self._channels + 3) & ~3

    def rows(self, r0: int, r1: int) -> np.ndarray:
        """Image rows [r0, r1) as (r1-r0, width, 3) uint8 RGB."""
        if not 0 <= r0 < r1 <= self.height:
            raise ValueError(f"row range [{r0}, {r1}) outside 0..{self.height}")
        n = r1 - r0
        # File row index of image row i: i (top-down) or height-1-i (bottom-up).
        file_first = r0 if self._top_down else self.height - r1
        self._f.seek(self._pixel_offset + file_first * self._stride)
        raw = self._f.read(n * self._stride)
        if len(raw) < n * self._stride:
            raise BmpError("truncated pixel data")
        a = np.frombuffer(raw, dtype=np.uint8).reshape(n, self._stride)
        px = a[:, : self.width * self._channels].reshape(
            n, self.width, self._channels
        )
        if not self._top_down:
            px = px[::-1]
        return np.ascontiguousarray(px[..., [2, 1, 0]])

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def encode_bmp(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> 24-bit bottom-up BMP bytes (BITMAPINFOHEADER)."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {rgb.shape}")
    h, w, _ = rgb.shape
    row_stride = (w * 3 + 3) & ~3
    img_size = row_stride * h
    bgr = rgb[::-1, :, ::-1]  # bottom-up, RGB->BGR
    rows = np.zeros((h, row_stride), dtype=np.uint8)
    rows[:, : w * 3] = bgr.reshape(h, w * 3)
    header = struct.pack(
        "<2sIHHI", b"BM", 54 + img_size, 0, 0, 54
    ) + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, img_size, 2835, 2835, 0, 0)
    return header + rows.tobytes()


def write_bmp(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_bmp(rgb))
