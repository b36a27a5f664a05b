"""Images without PIL: a zlib + numpy PNG reader and writer,
``read_image`` (PNG here, JPEG through the IO runtime or cv2), numpy
copies of PIL's bicubic and bilinear resizes and of the runtime's bilinear
resize,
and ``build_frames`` (a mirror of ``bench.build_frames``: real face crops
pasted on a flat background).
"""

import functools
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


# samples a pixel by PNG colour type: grey, RGB, palette index, grey +
# alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def read_png(path):
    """Decode a non-interlaced 8-bit PNG to [H, W, 3] uint8 RGB, as
    ``cv2.imread(path, cv2.IMREAD_COLOR)`` decodes it (then BGR -> RGB):
    grey is replicated into the three channels, a palette index is looked
    up, and alpha (and a tRNS chunk) is dropped, not composited. Adam7
    interlace and bit depths other than 8 raise ``ValueError``."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if interlace != 0:
        raise ValueError(f"{path}: Adam7-interlaced PNGs are not supported")
    if depth != 8 or color not in _PNG_CHANNELS:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{color}); 8-bit grey, grey + alpha, palette, RGB and RGBA "
            "only")
    ch = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size < h * (1 + w * ch):
        raise ValueError(f"{path}: truncated image data")
    rows = raw[:h * (1 + w * ch)].reshape(h, 1 + w * ch)
    px = _unfilter(rows, ch).reshape(h, w, ch)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        return palette[px[..., 0]]
    if ch <= 2:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_image(path, use_native=None):
    """Decode an image file to [H, W, 3] uint8 RGB. The decoder is chosen by
    the file's signature: PNG by ``read_png``; JPEG by the port's IO runtime
    (``native.loader.decode_jpeg_file``, libjpeg) or by
    ``cv2.imread(path, cv2.IMREAD_COLOR)`` turned to RGB, as
    ``native.loader.use_runtime`` resolves ``use_native`` (None: the
    runtime when it builds here, else cv2). Any other file raises
    ``ValueError``; a JPEG with neither reader raises ``RuntimeError``."""
    with open(path, "rb") as fh:
        head = fh.read(8)
    if head == _PNG_SIG:
        return read_png(path)
    if head[:2] == b"\xff\xd8":
        from ..native import loader

        if loader.use_runtime("image_io", use_native, "JPEG images"):
            return loader.decode_jpeg_file(path)
        cv2 = loader.cv2_module("image_io", use_native, "JPEG images")
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"{path}: cv2 could not decode the file")
        return np.ascontiguousarray(img[..., ::-1])
    raise ValueError(f"{path}: neither a PNG nor a JPEG file (signature "
                     f"{head.hex()})")


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


@functools.lru_cache(maxsize=1024)
def _resample_taps(in_size, out_size, filt, support):
    """(first [out], coefficients [out, taps]) of each output pixel, as PIL
    computes them: the filter's support scaled by the reduction factor,
    normalised per output, rounded to 22 fractional bits (int64; a row's
    unused taps are 0). Output ``o`` reads input pixels ``first[o] +
    t``. Cached; do not write to the result."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    rows = []
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
        rows.append((xmin, np.where(fixed < 0, np.trunc(fixed - 0.5),
                                    np.trunc(fixed + 0.5)).astype(np.int64)))
    taps = max(len(k) for _, k in rows)  # <= in_size
    first = np.empty(out_size, dtype=np.int64)
    coef = np.zeros((out_size, taps), dtype=np.int64)
    for xx, (x0, k) in enumerate(rows):
        # a window at the right edge starts earlier, so that every tap
        # reads a pixel; its coefficients move right by as much
        first[xx] = min(x0, in_size - taps)
        shift = x0 - first[xx]
        coef[xx, shift:shift + len(k)] = k
    for a in (first, coef):
        a.setflags(write=False)
    return first, coef


def _clip8(acc):
    acc = (acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def _resample_rows(x, out_size, filt, support):
    """Resample axis 0 of ``x`` [n, ...] uint8 to ``out_size``: each output
    row is the int64 sum of its taps' rows times their coefficients (exact,
    as PIL's 32-bit accumulators are for 8-bit input), rounded to 8 bits."""
    first, coef = _resample_taps(x.shape[0], out_size, filt, support)
    acc = np.zeros((out_size,) + x.shape[1:], dtype=np.int64)
    c = coef.reshape(coef.shape + (1,) * (x.ndim - 1))
    for t in range(coef.shape[1]):
        acc += c[:, t] * x[first + t]
    return _clip8(acc)


def _resize(img, size, filt, support):
    out_w, out_h = size
    x = img
    if out_w != x.shape[1]:
        x = _resample_rows(x.transpose(1, 0, 2), out_w, filt,
                           support).transpose(1, 0, 2)
    if out_h != x.shape[0]:
        x = _resample_rows(x, out_h, filt, support)
    return np.ascontiguousarray(x)


def resize_bicubic(img, size):
    """[H, W, C] uint8 -> [size[1], size[0], C] uint8, equal to PIL's
    ``Image.resize(size)`` (BICUBIC) on an RGB image: a horizontal pass,
    then a vertical one, each rounded to 8 bits."""
    return _resize(img, size, _bicubic, 2.0)


def resize_bilinear(img, size):
    """The same with PIL's triangle filter (``Image.BILINEAR``, support
    1), as ``Image.fromarray(img).resize(size, Image.BILINEAR)``."""
    return _resize(img, size, _bilinear, 1.0)


def _half_pixel_taps(in_size, out_size):
    """Source rows (or columns) and weights of one output axis, in float32
    as the runtime's C++ computes them."""
    scale = np.float32(in_size) / np.float32(out_size)
    f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * scale
    f = np.maximum(f - np.float32(0.5), np.float32(0.0))
    i0 = f.astype(np.int64)
    i1 = np.minimum(i0 + 1, in_size - 1)
    return i0, i1, f - i0.astype(np.float32)


def resize_bilinear_half_pixel(img, size):
    """[H, W, 3] uint8 -> [size[1], size[0], 3] uint8, bit-exact to the JAX
    package's native runtime (``vn_resize_bilinear``, the resize of
    ``find_embedding --image_size``): half-pixel centres clamped at 0, two
    taps per axis, every product and sum rounded to float32, then
    ``+ 0.5`` and truncation."""
    tw, th = size
    src = np.asarray(img, np.float32)
    y0, y1, wy = _half_pixel_taps(src.shape[0], th)
    x0, x1, wx = _half_pixel_taps(src.shape[1], tw)
    one = np.float32(1.0)
    wx, wy = wx[None, :, None], wy[:, None, None]

    def row(y):
        return src[y][:, x0] * (one - wx) + src[y][:, x1] * wx

    v = row(y0) * (one - wy) + row(y1) * wy
    return (v + np.float32(0.5)).astype(np.uint8)


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
