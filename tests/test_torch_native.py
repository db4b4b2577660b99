"""The port's native preprocessing library (`tokenpacker_tpu_torch/image/
native.py`, its C++ built here with g++ into a temporary directory)
against the JAX package's numpy references and PIL, as
`tests/test_native.py` holds the JAX package's library: the resize
against `hd_tiler._resize_bilinear` (1e-4), the normalization against
`normalize_u8`'s numpy branch (1e-5), the HD slicing against
`slice_image(use_native=False)` (2e-4), the JPEG decode against PIL (mean
absolute difference below 1). The library is loaded for these tests only
(the module's handle is restored after each), so no other test's
`slice_image` takes the native path.
"""

import io
import shutil

import numpy as np
import pytest
from PIL import Image

from tokenpacker_tpu.image.hd_tiler import _resize_bilinear as jax_resize_bilinear
from tokenpacker_tpu.image.hd_tiler import choose_grid
from tokenpacker_tpu.image.hd_tiler import slice_image as jax_slice_image
from tokenpacker_tpu_torch.image import hd_tiler, native
from tokenpacker_tpu_torch.image.io import load_image

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is not installed")

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("native_build")


@pytest.fixture
def lib(build_dir, monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    native.build(build_dir)
    return native.load(build_dir)


def test_builds_into_the_given_directory_only(lib, build_dir):
    built = sorted(p.name for p in build_dir.iterdir())
    assert len(built) == 1 and built[0].startswith("libtpp-") and built[0].endswith(".so")
    assert native.available()
    assert native.jpeg_available() == built[0].endswith("-jpeg.so")


@pytest.mark.parametrize("shape,dst", [((3, 213, 347), (100, 150)), ((1, 40, 52), (336, 336)),
                                       ((3, 336, 336), (336, 336))])
def test_resize_matches_jax_numpy(lib, shape, dst):
    img = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(native.resize_bilinear(img, *dst), jax_resize_bilinear(img, *dst),
                               rtol=1e-4, atol=1e-4)


def test_normalize_matches_jax_numpy(lib):
    img = np.random.default_rng(1).integers(0, 255, (60, 80, 3), dtype=np.uint8)
    want = ((img.astype(np.float32) / 255.0 - np.asarray(MEAN, np.float32))
            / np.asarray(STD, np.float32)).transpose(2, 0, 1)
    np.testing.assert_allclose(native.normalize_u8(img, MEAN, STD), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(400, 700), (300, 320), (900, 250)])
def test_hd_slice_matches_jax_numpy(lib, hw):
    img = np.random.default_rng(2).standard_normal((3,) + hw).astype(np.float32)
    want, hb, wb = jax_slice_image(img, patch_num=9, use_native=False)
    got, hb2, wb2 = hd_tiler.slice_image(img, patch_num=9)  # the native path: built
    assert (hb, wb) == (hb2, wb2) == choose_grid(*hw, 9)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    plain, _, _ = hd_tiler.slice_image(img, patch_num=9, use_native=False)
    np.testing.assert_allclose(plain, want, rtol=1e-6, atol=1e-6)


def test_jpeg_decode_matches_pil(lib, tmp_path):
    if not native.jpeg_available():
        pytest.skip("built without libjpeg (no jpeglib.h)")
    arr = np.random.default_rng(0).integers(0, 255, (47, 63, 3), dtype=np.uint8)
    path = tmp_path / "x.jpg"
    Image.fromarray(arr).save(path, "JPEG", quality=95)
    want = np.asarray(Image.open(path).convert("RGB"))
    got = native.decode_jpeg(path.read_bytes())
    assert got.shape == want.shape
    assert np.mean(np.abs(got.astype(int) - want.astype(int))) < 1.0
    assert load_image(str(path)).size == (63, 47)
    with pytest.raises(ValueError):
        native.decode_jpeg(b"not a jpeg")
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    png = tmp_path / "y.jpg"  # a PNG under a JPEG name: libjpeg refuses, PIL reads it
    png.write_bytes(buf.getvalue())
    np.testing.assert_array_equal(np.asarray(load_image(str(png))), arr)


def test_without_the_library_the_paths_are_numpys(monkeypatch, tmp_path):
    """Nothing built: slice_image takes numpy (JAX's when libtpp.so is
    absent) and load_image PIL."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    assert not native.available() and not native.jpeg_available()
    img = np.random.default_rng(3).standard_normal((3, 300, 500)).astype(np.float32)
    got, hb, wb = hd_tiler.slice_image(img)
    want, hb2, wb2 = jax_slice_image(img, use_native=False)
    assert (hb, wb) == (hb2, wb2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert list(tmp_path.iterdir()) == []
