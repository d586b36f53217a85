"""PNG codec (utils.image): round trips and every scanline filter on read."""

import struct
import zlib

import numpy as np
import pytest

from lens_flare.lens.aperture import ApertureTexture, blade_aperture
from lens_flare.utils.image import load_png_gray, load_png_rgb, read_png, write_png


def _filtered_png(path, img, kind, depth=8):
    """Encode ``img`` with every scanline using PNG filter ``kind`` (0-4)."""
    arr = img if img.ndim == 3 else img[..., None]
    h, w, ch = arr.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    if depth == 16:
        raw = arr.astype(">u2").view(np.uint8).reshape(h, -1).astype(np.int64)
    else:
        raw = arr.reshape(h, -1).astype(np.int64)
    bpp = ch * depth // 8
    out = bytearray()
    prev = np.zeros(raw.shape[1], np.int64)
    for row in raw:
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(kind)
        out += ((row - pred) % 256).astype(np.uint8).tobytes()
        prev = row

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(bytes(out))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(23, 31), (23, 31, 3), (23, 31, 4)], ids=["gray", "rgb", "rgba"])
def test_png_roundtrip(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), img)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_png_reads_every_filter_type(tmp_path, kind):
    img = np.random.default_rng(kind).integers(0, 256, (17, 13, 3)).astype(np.uint8)
    img[5:9] = img[4]  # flat rows give the predictors runs to work on
    _filtered_png(tmp_path / "f.png", img, kind)
    np.testing.assert_array_equal(read_png(tmp_path / "f.png"), img)


def test_png_16bit_and_gray_alpha(tmp_path):
    rng = np.random.default_rng(1)
    g16 = rng.integers(0, 65536, (9, 11)).astype(np.uint16)
    _filtered_png(tmp_path / "g16.png", g16, 4, depth=16)
    np.testing.assert_array_equal(read_png(tmp_path / "g16.png"), g16)
    np.testing.assert_allclose(load_png_gray(tmp_path / "g16.png"), g16 / 65535.0, rtol=1e-6)
    ga = rng.integers(0, 256, (9, 11, 2)).astype(np.uint8)
    _filtered_png(tmp_path / "ga.png", ga, 1)
    rgb = load_png_rgb(tmp_path / "ga.png")
    assert rgb.shape == (9, 11, 3)
    np.testing.assert_allclose(rgb[..., 1], ga[..., 0] / 255.0)


def test_png_rejects_other_files(tmp_path):
    (tmp_path / "x.png").write_bytes(b"GIF89a not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "x.png")
    with pytest.raises(ValueError, match="channels"):
        write_png(tmp_path / "y.png", np.zeros((4, 4, 2), np.uint8))


def test_blade_aperture_png_roundtrip(tmp_path):
    mask = blade_aperture(64, 5, dust=3, seed=2)
    assert mask.shape == (64, 64) and 0.2 < mask.mean() < 0.6
    np.testing.assert_array_equal(mask, blade_aperture(64, 5, dust=3, seed=2))
    assert not np.array_equal(mask, blade_aperture(64, 5, dust=3, seed=3))
    write_png(tmp_path / "ap.png", np.round(mask * 255).astype(np.uint8))
    tex = ApertureTexture.load(tmp_path / "ap.png")
    np.testing.assert_allclose(tex.values, np.round(mask * 255) / 255.0, atol=1e-7)
    assert 0 < tex.min_x < tex.max_x < 63
