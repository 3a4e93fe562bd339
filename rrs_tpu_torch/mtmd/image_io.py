"""Image decoding and resizing without Pillow.

The JAX package opens images with Pillow and resizes them with
``Image.BICUBIC`` (``rrs_tpu/mtmd/clip.py`` ``preprocess_image*``,
``rrs_tpu/mtmd/pipeline.py`` ``decode_image_b64``). The port decodes PNG
itself, with ``zlib`` and ``struct`` (8-bit greyscale, greyscale + alpha,
RGB, RGBA and palette images, 1 / 2 / 4-bit greyscale and palette images; not
interlaced; all five row filters), and its
``resize_bicubic`` is a NumPy copy of Pillow's two-pass resample:
a = -0.5, the support widened by the downscale factor, the coefficients
normalised and put in 22-bit fixed point, and a uint8 round and clip after
each pass, so that it gives Pillow's bytes. Other formats (JPEG, WebP, ...)
are decoded by Pillow where it can be imported; where it cannot, they raise
a ValueError that names the format and the missing decoder.
"""

from __future__ import annotations

import io
import math
import struct
import zlib

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PRECISION_BITS = 32 - 8 - 2
# color type -> samples a pixel (greyscale, RGB, palette, grey + alpha, RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def sniff_format(data: bytes) -> str:
    """The image format of a file's first bytes ("png", "jpeg", "webp",
    "gif", "bmp" or "unknown")."""
    if data.startswith(PNG_MAGIC):
        return "png"
    if data.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if data.startswith(b"BM"):
        return "bmp"
    return "unknown"


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes -> uint8 RGB array [H, W, 3] (Pillow's
    ``convert("RGB")``: alpha dropped, greyscale replicated, palette
    looked up)."""
    fmt = sniff_format(data)
    if fmt == "png":
        return decode_png(data)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"cannot decode a {fmt} image: only PNG is decoded without "
                         f"Pillow, and Pillow is not installed") from None
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint8)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: raw holds h rows of a filter byte and
    stride bytes. Returns uint8 [h, stride]."""
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG: image data is truncated")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, cur = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            line = cur.copy()
        elif ftype == 1:            # Sub: running sum along each channel
            line = (np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.int64) % 256) \
                .astype(np.uint8).reshape(-1)
        elif ftype == 2:            # Up
            line = cur + prior
        elif ftype in (3, 4):       # Average / Paeth: sequential along the row
            c, p = cur.tolist(), prior.tolist()
            line = [0] * stride
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + p[i]) >> 1
                else:
                    b, cc = p[i], p[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - cc), abs(a - cc), abs(a + b - 2 * cc)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else cc
                line[i] = (c[i] + pred) & 255
            line = np.asarray(line, np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {ftype}")
        out[y] = line
        prior = line
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 RGB [H, W, 3]. 8-bit samples, or 1 / 2 / 4-bit
    greyscale and palette indices; not interlaced; every chunk's CRC is
    checked."""
    if not data.startswith(PNG_MAGIC):
        raise ValueError("not a PNG file")
    pos, ihdr, palette, idat = len(PNG_MAGIC), None, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError("PNG: truncated chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG: bad CRC in chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG: unknown color type {ctype}")
    if depth != 8 and not (depth in (1, 2, 4) and ctype in (0, 3)):
        raise ValueError(f"PNG: bit depth {depth} of color type {ctype} is not decoded")
    if interlace:
        raise ValueError("PNG: interlaced images are not decoded")
    ch = _CHANNELS[ctype]
    if depth == 8:
        px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    else:                                             # packed greyscale / palette indices
        rows = _unfilter(zlib.decompress(b"".join(idat)), h, -(-w * depth // 8), 1)
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        px = (bits.astype(np.uint8) << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            -1, dtype=np.uint8)[..., None]
        if ctype == 0:                                # scale the grey levels to 0..255
            px = px * np.uint8(255 // (2 ** depth - 1))
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without a PLTE chunk")
        return palette[np.minimum(px[..., 0], len(palette) - 1)]
    if ch <= 2:                                       # greyscale (+ alpha)
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] -> PNG bytes (filter 0 on every row): the
    writer of the test and smoke images."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body \
            + struct.pack(">I", zlib.crc32(kind + body))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    return (PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    bicubic filter over the whole input: per output index its first input
    index, its tap count and its int32 fixed-point taps."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        if ww != 0.0:
            k = [v / ww for v in k]
        kk[xx, :xmax] = [int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0
                         else int(0.5 + v * (1 << _PRECISION_BITS)) for v in k]
        bounds[xx] = (xmin, xmax)
    return bounds, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` of a uint8 [H, W, C] image: fixed-point taps
    summed from a half, shifted down and clipped to uint8."""
    bounds, kk = _coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)              # [in, other, C]
    out = np.empty((out_size,) + src.shape[1:], np.uint8)
    for i in range(out_size):
        lo, n = int(bounds[i, 0]), int(bounds[i, 1])
        acc = (1 << (_PRECISION_BITS - 1)) + np.tensordot(kk[i, :n], src[lo:lo + n], axes=1)
        out[i] = np.clip(acc >> _PRECISION_BITS, 0, 255)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [height, width, C], Pillow's
    ``Image.resize((width, height), Image.BICUBIC)`` byte for byte: the
    horizontal pass first, then the vertical, each only where the size
    changes."""
    img = np.asarray(img, np.uint8)
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    return img
