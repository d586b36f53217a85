"""Image buffers and IO.

Equivalents of the reference's image machinery (``src/util/image.h``,
vendored lodepng): the HDR film is a plain ``(H, W, 3)`` float array; LDR
conversion is the reference's fixed gamma-2.2 / exposure transform
(``image.h:208-223``) expressed as an array op, and PNG IO is a small
``zlib``/``struct`` codec (:func:`read_png`, :func:`write_png`).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

GAMMA = 2.2
LEVEL = 1.0
# exposure = sqrt(2^level), image.h:212-213
EXPOSURE = float(np.sqrt(2.0 ** LEVEL))

# Rec.601 luma weights used by CGL's Color::illum() / Vector3D::illum().
ILLUM_WEIGHTS = np.array([0.2126, 0.7152, 0.0722], dtype=np.float64)


def illum(rgb):
    """Luminance, matching ``Vector3D::illum()``."""
    import numpy as xp

    rgb = xp.asarray(rgb)
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def to_color(hdr):
    """HDR film -> [0,1] LDR, matching ``HDRImageBuffer::toColor`` (image.h:208-223).

    out = clamp((c * exposure) ** (1/gamma), 0, 1) with gamma=2.2, exposure=sqrt(2).
    Works on NumPy or JAX arrays (pure function of the input namespace).
    """
    xp = _namespace_of(hdr)
    scaled = xp.maximum(hdr * EXPOSURE, 0.0)
    return xp.clip(scaled ** (1.0 / GAMMA), 0.0, 1.0)


def tonemap(hdr, gamma=GAMMA, level=1.0, key=0.18, wht=5.0):
    """Global Reinhard-style tonemap, matching ``HDRImageBuffer::tonemap`` (image.h:176-203)."""
    xp = _namespace_of(hdr)
    lum = illum(hdr)
    avg = xp.exp(xp.mean(xp.log(1e-7 + lum)))
    exposure = xp.sqrt(2.0 ** level)
    s = hdr * (key / avg)
    s = s * (((lum + 1.0) / (wht * wht)) / (lum + 1.0))[..., None]
    return xp.maximum(s * exposure, 0.0) ** (1.0 / gamma)


def _namespace_of(a):
    if type(a).__module__.startswith("jax"):
        import jax.numpy as jnp

        return jnp
    return np


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels: gray, RGB, gray+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (types 0-4) -> (height, stride) uint8."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        off = y * (stride + 1)
        kind = raw[off]
        line = np.frombuffer(raw, np.uint8, stride, off + 1)
        if kind == 0:  # None
            cur = line.copy()
        elif kind == 1:  # Sub: running sum per byte lane, modulo 256
            pad = -stride % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).ravel()[:stride]
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: sequential in x
            cur = bytearray(stride)
            up, src = prev.tobytes(), line.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (src[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path) -> np.ndarray:
    """Decode a non-interlaced 8- or 16-bit gray, gray+alpha, RGB or RGBA PNG.

    Returns (H, W) for gray, else (H, W, C); dtype uint8 or uint16.
    """
    data = open(path, "rb").read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _comp, _filt, interlace = header
    if color not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (color type {color}, bit depth {depth}, "
            f"interlace {interlace})"
        )
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if depth == 16:
        rows = rows.view(">u2").astype(np.uint16)
    img = rows.reshape(height, width, ch)
    return img[..., 0] if ch == 1 else img


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (
        struct.pack(">I", len(body)) + tag + body
        + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)
    )


def write_png(path, pixels: np.ndarray, level: int = 1) -> None:
    """Encode uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA as a PNG.

    Scanlines use filter type 0; ``level`` is the zlib level (1 keeps a
    1080p frame fast to write, and the file stays lossless).
    """
    arr = np.ascontiguousarray(pixels, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    height, width, ch = arr.shape
    color = {1: 0, 3: 2, 4: 6}.get(ch)
    if color is None:
        raise ValueError(f"write_png: {ch} channels (want 1, 3 or 4)")
    lines = np.zeros((height, 1 + width * ch), np.uint8)
    lines[:, 1:] = arr.reshape(height, -1)
    header = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(lines.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))


def load_png_gray(path) -> np.ndarray:
    """Load a grayscale aperture/bokeh mask PNG as float (H, W) in [0, 1].

    Matches ``CameraApertureTexture::init`` (camera.h:26-83): only the red
    channel (the gray channel of a gray PNG) is used, scaled to [0, 1].
    """
    arr = read_png(path)
    red = arr if arr.ndim == 2 else arr[..., 0]
    return red.astype(np.float32) / float(np.iinfo(red.dtype).max)


def load_png_rgb(path) -> np.ndarray:
    """Load a PNG as float RGB (H, W, 3) in [0, 1] (gray is replicated, alpha dropped)."""
    arr = read_png(path)
    if arr.ndim == 2:
        arr = arr[..., None]
    rgb = arr[..., [0, 0, 0]] if arr.shape[-1] <= 2 else arr[..., :3]
    return rgb.astype(np.float32) / float(np.iinfo(arr.dtype).max)


def save_png(path, ldr: np.ndarray) -> None:
    """Save a [0,1] float (H, W, 3) or (H, W) image as 8-bit PNG."""
    arr = np.asarray(ldr)
    write_png(path, np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8))


def save_hdr_png(path, hdr: np.ndarray, flip_y: bool = False) -> None:
    """Gamma-correct an HDR film and save, like ``save_image`` (raytraced_renderer.cpp:717-755).

    Film row 0 is the BOTTOM of the view (sensor y=0 maps to cy=-tan(vFov/2)
    in ``generate_ray``, camera.cpp:278-305 — same formula both frameworks),
    so PNG writers pass ``flip_y=True`` to emit a right-side-up image, the
    exact counterpart of the reference's ``save_image`` y-flip.  Proven
    against the real C++ binary: tests/test_reference_binary.py renders the
    same camera both sides and the PNGs match row-for-row only with the flip
    (an earlier revision believed the film was top-down; the golden test
    falsified that).
    """
    ldr = to_color(np.asarray(hdr))
    if flip_y:
        ldr = ldr[::-1]
    save_png(path, ldr)


def sampling_rate_heatmap(sample_counts: np.ndarray, max_samples: int) -> np.ndarray:
    """Sampling-rate debug image, matching ``save_sampling_rate`` (raytraced_renderer.cpp:757-788).

    Blue (low) -> green (mid) -> red (high) ramp over rate = count/max.
    """
    rate = np.asarray(sample_counts, dtype=np.float32) / float(max_samples)
    h, w = rate.shape
    out = np.zeros((h, w, 3), dtype=np.float32)
    lo = rate <= 0.5
    out[..., 0] = np.where(lo, 0.0, (rate - 0.5) * 2.0)
    out[..., 1] = np.where(lo, rate * 2.0, 1.0 - (rate - 0.5) * 2.0)
    out[..., 2] = np.where(lo, 1.0 - rate * 2.0, 0.0)
    return np.clip(out, 0.0, 1.0)
