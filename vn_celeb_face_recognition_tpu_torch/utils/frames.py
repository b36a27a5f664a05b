"""Images without PIL: a zlib + numpy PNG reader and writer, numpy
copies of PIL's bicubic and bilinear resizes, and ``build_frames`` (a
mirror of ``bench.build_frames``: real face crops pasted on a flat
background).
"""

import glob
import os
import struct
import zlib

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA_DIR = os.path.join(_REPO_ROOT, "data")

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(rows, bpp):
    """Undo the per-scanline PNG filters (types 0-4).
    rows: [H, 1 + stride] uint8 as stored; returns [H, stride] uint8."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:]
        if ftype == 0:  # None
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum along each channel
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
            cur = (cur % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            raw = line.tolist()
            up = prev.tolist()
            cur_l = [0] * stride
            for x in range(stride):
                left = cur_l[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (left + up[x]) >> 1
                else:
                    ul = up[x - bpp] if x >= bpp else 0
                    pred = _paeth(left, up[x], ul)
                cur_l[x] = (raw[x] + pred) & 0xFF
            cur = np.asarray(cur_l, dtype=np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path):
    """Decode an 8-bit RGB non-interlaced PNG (the repo's face images)
    to [H, W, 3] uint8."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color != 2 or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{color}, interlace {interlace}); 8-bit RGB non-interlaced "
            "only")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    rows = raw[:h * (1 + w * 3)].reshape(h, 1 + w * 3)
    return _unfilter(rows, 3).reshape(h, w, 3)


def _png_chunk(ctype, data):
    return (struct.pack(">I", len(data)) + ctype + data
            + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF))


def write_png(path, img):
    """Encode [H, W, 3] uint8 as an 8-bit RGB PNG (filter 0 on every
    row); ``read_png`` and PIL read it back unchanged."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)
    data = (_PNG_SIG
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(data)


# ---------------------------------------------------------------------------
# PIL's bicubic and bilinear resizes (8-bit, fixed point), in numpy
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x):
    a = -0.5
    x = np.abs(x)
    return np.where(
        x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


def _resample_matrix(in_size, out_size, filt, support):
    """[out, in] int64 fixed-point coefficients, as PIL computes them
    (the filter's support scaled by the reduction factor, normalised per
    output, rounded to 22 fractional bits)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    mat = np.zeros((out_size, in_size), dtype=np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax)
        k = filt((xs - center + 0.5) / filterscale)
        ww = k.sum()
        if ww != 0.0:
            k = k / ww
        fixed = k * (1 << _PRECISION_BITS)
        mat[xx, xmin:xmax] = np.where(fixed < 0, np.trunc(fixed - 0.5),
                                      np.trunc(fixed + 0.5)).astype(np.int64)
    return mat


def _clip8(acc):
    acc = (acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def _resize(img, size, filt, support):
    out_w, out_h = size
    x = img
    if out_w != x.shape[1]:
        m = _resample_matrix(x.shape[1], out_w, filt, support)
        x = _clip8(np.einsum("ow,hwc->hoc", m, x.astype(np.int64)))
    if out_h != x.shape[0]:
        m = _resample_matrix(x.shape[0], out_h, filt, support)
        x = _clip8(np.einsum("oh,hwc->owc", m, x.astype(np.int64)))
    return x


def resize_bicubic(img, size):
    """[H, W, C] uint8 -> [size[1], size[0], C] uint8, equal to PIL's
    ``Image.resize(size)`` (BICUBIC) on an RGB image: a horizontal pass,
    then a vertical one, each rounded to 8 bits."""
    return _resize(img, size, _bicubic, 2.0)


def resize_bilinear(img, size):
    """The same with PIL's triangle filter (``Image.BILINEAR``, support
    1), as ``Image.fromarray(img).resize(size, Image.BILINEAR)``."""
    return _resize(img, size, _bilinear, 1.0)


def face_files():
    return sorted(glob.glob(os.path.join(DATA_DIR, "*.png")))


def build_frames(batch, size, faces_per_frame, face_px=144):
    """[batch, size, size, 3] uint8 frames with real face crops (the
    repo's ``data/*.png``, resized to ``face_px``) pasted on a grid over
    a flat grey (90) background."""
    files = face_files()
    if not files:
        raise FileNotFoundError(f"no face images under {DATA_DIR}")
    crops = [resize_bicubic(read_png(f), (face_px, face_px))
             for f in files[:faces_per_frame * batch]]
    frames = np.full((batch, size, size, 3), 90, dtype=np.uint8)
    grid = int(np.ceil(np.sqrt(faces_per_frame)))
    cell = size // grid
    pad = max((cell - face_px) // 2, 0)
    idx = 0
    for b in range(batch):
        for f in range(faces_per_frame):
            r, c = divmod(f, grid)
            y0 = r * cell + pad
            x0 = c * cell + pad
            frames[b, y0:y0 + face_px, x0:x0 + face_px] = \
                crops[idx % len(crops)]
            idx += 1
    return frames
