"""The built-in PNG codec (utils/png.py) and image loading without Pillow."""

import logging
import struct
import sys
import zlib

import numpy as np
import pytest

from tpu_renderer import gltf
from tpu_renderer.utils import png


def _image(h=13, w=17, c=4, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)


def _png_with_filter(img, ftype):
    """Encode img with one scanline filter type on every row."""
    h, w, c = img.shape
    a = img.reshape(h, w * c).astype(np.int64)
    prev = np.zeros(w * c, np.int64)
    rows = []
    for y in range(h):
        x = a[y]
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(np.concatenate([[ftype], (x - pred) % 256]))
        prev = x
    raw = np.asarray(rows, np.uint8).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(raw)) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_roundtrip(channels):
    img = _image(c=channels)
    out = png.decode(png.encode(img))
    assert out.shape == (13, 17, 4) and out.dtype == np.uint8
    np.testing.assert_array_equal(out[..., :channels], img)
    if channels == 3:
        assert (out[..., 3] == 255).all()


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_decodes_every_filter_type(ftype):
    for c in (3, 4):
        img = _image(c=c, seed=ftype)
        np.testing.assert_array_equal(
            png.decode(_png_with_filter(img, ftype))[..., :c], img)


def test_corrupt_and_unsupported_pngs():
    data = bytearray(png.encode(_image()))
    data[40] ^= 0xFF  # inside IDAT: the chunk CRC no longer matches
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data))
    with pytest.raises(ValueError, match="signature"):
        png.decode(b"GIF89a" + bytes(20))
    ihdr16 = struct.pack(">IIBBBBB", 4, 4, 16, 6, 0, 0, 0)
    sixteen_bit = (png.SIGNATURE + png._chunk(b"IHDR", ihdr16)
                   + png._chunk(b"IDAT", zlib.compress(bytes(4 * 33)))
                   + png._chunk(b"IEND", b""))
    with pytest.raises(png.Unsupported):
        png.decode(sixteen_bit)
    # a corrupt image maps to None (the error checkerboard), quietly named
    assert gltf._decode_image(bytes(data), "bad") is None


@pytest.fixture
def no_pillow(monkeypatch):
    """Make `import PIL` fail, as on a machine without Pillow."""
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_demo_scene_textures_load_without_pillow(tmp_path, no_pillow):
    from tpu_renderer import scene as scene_mod
    from tpu_renderer.utils import demo

    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    path = str(tmp_path / "demo.glb")
    demo.build_demo_glb(path, grid=2, seed=0)
    scene = scene_mod.load_scene(path)
    want = [demo.checker_texture(), demo.gradient_texture(),
            demo.noise_texture()]
    got = [t for t in scene.textures if t.shape == want[0].shape]
    for w in want:
        assert any(np.array_equal(w, g) for g in got), "texture not loaded"


def test_missing_decoder_is_logged_not_corrupt(no_pillow, caplog):
    jpeg = b"\xff\xd8\xff\xe0" + bytes(64)
    with caplog.at_level(logging.WARNING, logger="tpu_renderer.gltf"):
        assert gltf._decode_image(jpeg, "photo.jpg") is None
    assert "photo.jpg" in caplog.text and "Pillow" in caplog.text
