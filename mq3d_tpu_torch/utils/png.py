"""PNG IO on zlib + numpy (8-bit gray, RGB and RGBA).

The reference writes and reads PNGs with cv2 (reference:
scripts/dataio/image_data_io.py:64-81).  This module needs neither cv2 nor
PIL.  `imwrite` encodes through the native IO runtime (utils/native.py,
csrc/mqio.cpp); `encode_png` is its plain version, filter-0 scanlines
through Python's zlib, the same bytes where both link the same zlib.  The
reader undoes all five PNG row filters, so it reads what cv2, PIL or either
writer produce.  Three-channel arrays are BGR at this module's surface, as
with cv2.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import List, Optional

import numpy as np

from mq3d_tpu_torch.utils import native

_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray, compression_level: int = 3) -> bytes:
    """(H, W) gray or (H, W, 3) BGR uint8 -> PNG bytes."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        colour_type, data = 0, img
    elif img.ndim == 3 and img.shape[2] == 3:
        colour_type, data = 2, img[..., ::-1]  # BGR -> RGB
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.empty((h, 1 + data[0].size), np.uint8)
    rows[:, 0] = 0  # filter type 0 (None) on every scanline
    rows[:, 1:] = data.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
    return b"".join([
        _MAGIC,
        _chunk(b"IHDR", ihdr),
        _chunk(b"IDAT", zlib.compress(rows.tobytes(), compression_level)),
        _chunk(b"IEND", b""),
    ])


def write_png_batch_plain(paths: List[Path], imgs: np.ndarray,
                          compression_level: int = 3) -> np.ndarray:
    """Plain version of native.write_png_batch: encode_png per image, one
    after another.  Returns the mask of files written (all)."""
    for p, img in zip(paths, imgs):
        Path(p).write_bytes(encode_png(img, compression_level))
    return np.ones(len(paths), bool)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters: (h, 1 + stride) -> (h, stride)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for r in range(h):
        ftype = raw[r, 0]
        line = raw[r, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 1:  # Sub: running sum per byte lane of the pixel
            cur = line.copy()
            for c in range(bpp):
                cur[c::bpp] = np.cumsum(line[c::bpp]) & 0xFF
        else:  # Average (3) and Paeth (4) depend on the left neighbour
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                elif ftype == 4:
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                else:
                    raise ValueError(f"bad PNG filter type {ftype}")
                cur[i] = (cur[i] + pred) & 0xFF
        out[r] = cur
        prev = cur
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) gray or (H, W, C) array in file channel order
    (RGB / RGBA).  8-bit, non-interlaced files only."""
    if blob[:8] != _MAGIC:
        raise ValueError("not a PNG file")
    pos = 8
    idat = []
    header = None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour_type, _, _, interlace = header
    if depth != 8 or interlace != 0 or colour_type not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {colour_type}, "
            f"interlace {interlace})")
    ch = _CHANNELS[colour_type]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + stride)
    if (raw[:, 0] == 0).all():
        pix = raw[:, 1:]
    else:
        pix = _unfilter(raw, h, stride, ch)
    return pix.reshape(h, w) if ch == 1 else pix.reshape(h, w, ch)


def imread_bgr(path: Path) -> Optional[np.ndarray]:
    """(H, W, 3) BGR uint8, or None when the file does not exist."""
    path = Path(path)
    if not path.exists():
        return None
    img = decode_png(path.read_bytes())
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    elif img.shape[2] == 2:  # gray + alpha
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., 2::-1] if img.shape[2] >= 3 else img)


def imwrite(path: Path, img: np.ndarray, compression_level: int = 3):
    """Write a PNG through the native runtime; float arrays are
    rounded-and-clipped to uint8 the way cv2.imwrite does (saturate_cast).
    Raises when the file cannot be written."""
    path = Path(path)
    if path.suffix.lower() != ".png":
        raise ValueError(f"only PNG is supported: {path}")
    path.parent.mkdir(parents=True, exist_ok=True)
    if img.dtype != np.uint8:
        img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    if not native.write_png(path, img, compression_level):
        raise OSError(f"failed to write {path}")
