"""The port's PNG codec, image IO and texture loading, with no PIL or cv2.

PNG round trips against PIL both ways for every format the codec takes
(exact: PNG is lossless), every row filter on hand-built files, the port's
``utils/io`` against the JAX package's on files written by cv2 and PIL
(exact), and the textured-OBJ load with PIL and cv2 blocked against the JAX
loader's texture (exact). A subprocess with PIL and cv2 blocked imports
every port module.
"""

import pathlib
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from foundationpose_cpp_tpu.meshio import mesh_loader as jload
from foundationpose_cpp_tpu.meshio import procedural as jproc
from foundationpose_cpp_tpu.utils import io as jio
from foundationpose_cpp_tpu_torch.meshio import mesh_loader as tload
from foundationpose_cpp_tpu_torch.meshio import procedural as tproc
from foundationpose_cpp_tpu_torch.utils import io as tio
from foundationpose_cpp_tpu_torch.utils import png

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smooth(h, w, c, dtype=np.uint8):
    """Gradients, so that libpng's and PIL's adaptive filters pick Sub, Up,
    Average and Paeth rows, plus noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    top = 65536 if dtype == np.uint16 else 256
    chans = [(xx * (3 + k) + yy * (5 - k) + (xx * yy) // 7) for k in range(c)]
    img = np.stack(chans, axis=-1) % top
    img = img + np.random.default_rng(c).integers(0, 3, img.shape)
    return (img % top).astype(dtype)[..., 0] if c == 1 else (img % top).astype(dtype)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_write_then_pil_reads_the_same(tmp_path, kind):
    img = {"gray8": _smooth(31, 45, 1), "rgb8": _smooth(31, 45, 3),
           "gray16": _smooth(31, 45, 1, np.uint16)}[kind]
    path = tmp_path / "w.png"
    png.write_png(str(path), img)
    back = np.asarray(Image.open(path))
    assert back.dtype == img.dtype or kind == "gray16"  # PIL opens 16-bit gray as I;16
    np.testing.assert_array_equal(back.astype(img.dtype), img)
    np.testing.assert_array_equal(png.read_png(str(path)), img)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA", "I;16", "P256", "P16", "P2", "PA"])
def test_pil_written_reads_the_same(tmp_path, mode):
    path = tmp_path / "p.png"
    rgb = _smooth(40, 52, 3)
    if mode == "L":
        im, want = Image.fromarray(rgb[..., 0]), rgb[..., 0]
    elif mode == "RGB":
        im, want = Image.fromarray(rgb), rgb
    elif mode in ("RGBA", "LA"):
        arr = _smooth(40, 52, 4 if mode == "RGBA" else 2)
        im, want = Image.fromarray(arr, mode), arr
    elif mode == "I;16":
        arr = _smooth(40, 52, 1, np.uint16)
        im, want = Image.fromarray(arr), arr
    else:
        colors = {"P256": 256, "P16": 12, "P2": 2, "PA": 40}[mode]
        im = Image.fromarray(rgb).quantize(colors)
        if mode == "PA":
            im.info["transparency"] = bytes(range(0, 200, 5))
            want = np.asarray(im.convert("RGBA"))
        else:
            want = np.asarray(im.convert("RGB"))
    im.save(path)
    if mode == "PA":
        assert Image.open(path).mode == "P" and "transparency" in Image.open(path).info
    got = png.read_png(str(path))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [3, 4])
def test_cv2_written_16bit_color_reads_the_same(tmp_path, channels):
    """Colour types 2 and 6 at 16 bits (PIL cannot write them): cv2 stores
    BGR(A) as RGB(A) on disk."""
    cv2 = pytest.importorskip("cv2")
    rgba = _smooth(19, 27, channels, np.uint16)
    bgra = np.concatenate([rgba[..., 2::-1], rgba[..., 3:]], axis=-1)
    path = tmp_path / "c16.png"
    assert cv2.imwrite(str(path), bgra)
    got = png.read_png(str(path))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, rgba)


def _png_bytes(rows, w, h, depth, ctype, interlace=0):
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return png.SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b"")


def _filter_rows(img_rows, bpp, kinds):
    """Encode scanlines with the given filter per row (the PNG spec's
    definitions, written plainly)."""
    out, prior = bytearray(), bytes(len(img_rows[0]))
    for row, kind in zip(img_rows, kinds):
        enc = bytearray()
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            enc.append((x - pred) % 256)
        out += bytes([kind]) + enc
        prior = row
    return bytes(out)


@pytest.mark.parametrize("kind", ["rgb8", "gray16"])
def test_every_row_filter(tmp_path, kind):
    img = _smooth(15, 21, 3) if kind == "rgb8" else _smooth(15, 21, 1, np.uint16)
    raw = img.astype(">u2") if kind == "gray16" else img
    rows = [bytes(r) for r in np.ascontiguousarray(raw).view(np.uint8).reshape(15, -1)]
    data = _filter_rows(rows, 3 if kind == "rgb8" else 2, [y % 5 for y in range(15)])
    path = tmp_path / "f.png"
    path.write_bytes(_png_bytes(data, 21, 15, 8 if kind == "rgb8" else 16, 2 if kind == "rgb8" else 0))
    np.testing.assert_array_equal(png.read_png(str(path)), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)).astype(img.dtype), img)


def test_interlaced_and_corrupt_files_raise(tmp_path):
    rows = _filter_rows([bytes(6)] * 2, 3, [0, 0])
    path = tmp_path / "i.png"
    path.write_bytes(_png_bytes(rows, 2, 2, 8, 2, interlace=1))
    with pytest.raises(ValueError, match="Adam7"):
        png.read_png(str(path))
    data = bytearray(_png_bytes(rows, 2, 2, 8, 2))
    data[-20] ^= 0xFF  # inside the IDAT chunk: its CRC no longer holds
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(str(path))
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(path))
    with pytest.raises(ValueError, match="write_png takes"):
        png.write_png(str(path), np.zeros((2, 2), np.float32))


def test_cv2_written_frames_read_like_jax(tmp_path):
    """BGR written by cv2.imwrite, BGRA, 16-bit depth with holes, masks in
    0/1 and 0/255: the port's io equals the JAX package's exactly."""
    cv2 = pytest.importorskip("cv2")
    rgb = _smooth(24, 32, 3)
    cv2.imwrite(str(tmp_path / "bgr.png"), rgb[..., ::-1])
    bgra = np.dstack([rgb[..., ::-1], np.full((24, 32), 200, np.uint8)])
    cv2.imwrite(str(tmp_path / "bgra.png"), bgra)
    depth = _smooth(24, 32, 1, np.uint16)
    depth[3:7, 4:9] = 0
    cv2.imwrite(str(tmp_path / "d.png"), depth)
    mask = np.zeros((24, 32), np.uint8)
    mask[2:9, 3:12] = 1
    cv2.imwrite(str(tmp_path / "m.png"), mask)
    for name in ("bgr.png", "bgra.png"):
        got = tio.read_rgb(str(tmp_path / name))
        np.testing.assert_array_equal(got, jio.read_rgb(str(tmp_path / name)))
        np.testing.assert_array_equal(got, rgb)
    got = tio.read_depth(str(tmp_path / "d.png"))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jio.read_depth(str(tmp_path / "d.png")))
    np.testing.assert_array_equal(tio.read_mask(str(tmp_path / "m.png")),
                                  jio.read_mask(str(tmp_path / "m.png")))
    np.testing.assert_array_equal(tio.read_rgb(str(tmp_path / "d.png")),
                                  jio.read_rgb(str(tmp_path / "d.png")))


def test_pil_written_gray_and_rgb_depth_read_like_jax(tmp_path):
    gray = _smooth(8, 8, 1)
    Image.fromarray(gray).save(tmp_path / "g.png")
    rgbish = _smooth(6, 6, 3)
    Image.fromarray(rgbish).save(tmp_path / "d3.png")
    np.testing.assert_array_equal(tio.read_rgb(str(tmp_path / "g.png")),
                                  jio.read_rgb(str(tmp_path / "g.png")))
    np.testing.assert_array_equal(tio.read_depth(str(tmp_path / "d3.png")),
                                  jio.read_depth(str(tmp_path / "d3.png")))
    with pytest.raises(FileNotFoundError):
        tio.read_rgb(str(tmp_path / "nope.png"))


def test_textured_obj_loads_its_texture_without_pil_or_cv2(tmp_path, monkeypatch):
    """The texture of a textured OBJ whose PNG exists, loaded with PIL and
    cv2 blocked: before the PNG codec the port fell back to the 2x2 gray
    without a word; now it equals the JAX loader's (PIL) texture."""
    obj = tmp_path / "house.obj"
    jproc.write_obj(jproc.textured_house(), str(obj), str(tmp_path / "house.png"))
    want = jload.load_mesh("house", str(obj))
    assert want.texture.shape == (96, 96, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = tload.load_mesh("house", str(obj))
    np.testing.assert_array_equal(got.texture, want.texture)
    np.testing.assert_array_equal(got.vertices, want.vertices)


def test_port_write_obj_matches_jax(tmp_path):
    house = tproc.textured_house()
    tproc.write_obj(house, str(tmp_path / "t.obj"), str(tmp_path / "t.png"))
    jproc.write_obj(jproc.textured_house(), str(tmp_path / "j.obj"), str(tmp_path / "j.png"))
    t_text = (tmp_path / "t.obj").read_text().replace("t.mtl", "X")
    j_text = (tmp_path / "j.obj").read_text().replace("j.mtl", "X")
    assert t_text == j_text
    assert (tmp_path / "t.mtl").read_text().replace("t.png", "X") == \
        (tmp_path / "j.mtl").read_text().replace("j.png", "X")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
    got = tload.load_mesh("t", str(tmp_path / "t.obj"))
    np.testing.assert_array_equal(got.texture, jload.load_mesh("j", str(tmp_path / "j.obj")).texture)


def test_texture_formats_and_fallbacks(tmp_path, monkeypatch):
    """A missing texture file gives the reference's gray; a non-PNG texture
    goes through PIL, and without PIL raises, naming the file."""
    obj = tmp_path / "c.obj"
    tproc.write_obj(tproc.textured_cube(), str(obj))
    (tmp_path / "c.mtl").write_text("newmtl m\nmap_Kd gone.png\n")
    text = obj.read_text()
    obj.write_text("mtllib c.mtl\n" + text)
    gray = tload.load_mesh("c", str(obj)).texture
    np.testing.assert_array_equal(gray, np.full((2, 2, 3), 100 / 255.0, np.float32))

    rgb = _smooth(10, 12, 3)
    Image.fromarray(rgb).save(tmp_path / "t.bmp")
    (tmp_path / "c.mtl").write_text("newmtl m\nmap_Kd t.bmp\n")
    np.testing.assert_array_equal(tload.load_mesh("c", str(obj)).texture,
                                  rgb.astype(np.float32) / 255.0)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="t.bmp"):
        tload.load_mesh("c", str(obj))


PERF_MODULES = ("ops.probe_grid", "tools.probe_grid_overhead", "tools.profile_nets",
                "tools.bench_stem", "tools.bench_attn", "tools.profile_register")


def test_port_imports_no_pil_cv2_or_jax():
    """Every port module imports with PIL, cv2 and JAX blocked (the probe
    kernel's module and the perf harnesses among them), and none of PIL,
    cv2, JAX or the JAX package ends up loaded."""
    code = (
        "import sys\n"
        "for m in ('PIL', 'PIL.Image', 'cv2', 'jax', 'jax.numpy'): sys.modules[m] = None\n"
        "import importlib, pkgutil, foundationpose_cpp_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'foundationpose_cpp_tpu_torch.demo_dataset' in names, names\n"
        f"want = {['foundationpose_cpp_tpu_torch.' + m for m in PERF_MODULES]!r}\n"
        "assert set(want) <= set(names), sorted(set(want) - set(names))\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and (m in "
        "('jax', 'PIL', 'cv2', 'foundationpose_cpp_tpu') or m.startswith(('jax.', 'PIL.', "
        "'cv2.', 'foundationpose_cpp_tpu.')))]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
