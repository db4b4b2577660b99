"""Where the port's native preprocessing library (`tokenpacker_tpu_torch/
image/native.py`) is not built, the image paths are the JAX package's
numpy ones, and nothing but an explicit `native.build()` builds it.

- Without the C++ source (a copy of the package with no `native/`, as an
  install that ships no `.cpp` would be): `available()` is False,
  `build()` refuses, and `slice_image`, `resize_bilinear` and
  `normalize_u8` return what the JAX package's numpy functions return,
  bit for bit.
- With g++ and the source, in a fresh process whose `BUILD_DIR` is an
  empty directory: `resize_bilinear`, `normalize_u8`, `slice_image`,
  `load_image` and `jpeg_available` leave it empty and `available()`
  False; `native.build()` (and `python -m
  tokenpacker_tpu_torch.image.native`) builds it, and then `available()`
  is True.
- `TOKENPACKER_NATIVE_LIB` names the library to load first, as in the
  JAX package.

Each check runs in a child process, so no module state (the loaded
library) reaches another test.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tokenpacker_tpu.image.hd_tiler import _resize_bilinear as jax_resize_bilinear
from tokenpacker_tpu.image.hd_tiler import slice_image as jax_slice_image
from tokenpacker_tpu_torch.image import native

REPO = Path(__file__).resolve().parent.parent
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is not installed")


def _inputs(tmp: Path) -> dict:
    """The images every child sees, saved where it reads them."""
    rng = np.random.default_rng(5)
    arrays = {"img": rng.standard_normal((3, 300, 520)).astype(np.float32),
              "small": rng.standard_normal((3, 40, 52)).astype(np.float32),
              "u8": rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)}
    np.savez(tmp / "in.npz", **arrays)
    Image.fromarray(arrays["u8"]).save(tmp / "x.jpg", "JPEG", quality=95)
    return arrays


def _child(code: str, root: Path, tmp: Path, env: dict | None = None) -> dict:
    """Run `code` in a fresh interpreter that imports the port from `root`;
    it prints one JSON line last, which is returned."""
    run_env = {k: v for k, v in os.environ.items() if k != "TOKENPACKER_NATIVE_LIB"}
    run_env.update(PYTHONPATH=str(root), **(env or {}))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code), str(tmp)],
                          cwd=root, env=run_env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


PATHS = """
    import json, sys
    from pathlib import Path
    import numpy as np
    from tokenpacker_tpu_torch.image import hd_tiler, native
    from tokenpacker_tpu_torch.image.io import load_image
    tmp = Path(sys.argv[1])
    x = np.load(tmp / "in.npz")
    out = {{"available_before": native.available()}}
    {setup}
    crops, hb, wb = hd_tiler.slice_image(x["img"])
    np.savez(tmp / "out.npz", crops=crops, resized=native.resize_bilinear(x["small"], 336, 336),
             normalized=native.normalize_u8(x["u8"], {mean}, {std}),
             loaded=np.asarray(load_image(str(tmp / "x.jpg"))))
    out.update(grid=[hb, wb], available_after=native.available(),
               jpeg=native.jpeg_available(), module=native.__file__)
    {after}
    print(json.dumps(out))
"""


def _paths(setup: str = "", after: str = "") -> str:
    indent = lambda s: textwrap.indent(textwrap.dedent(s), "    ").strip()  # noqa: E731
    return PATHS.format(setup=indent(setup), after=indent(after), mean=MEAN, std=STD)


def _assert_numpy_paths(tmp: Path, arrays: dict, res: dict):
    got = np.load(tmp / "out.npz")
    want, hb, wb = jax_slice_image(arrays["img"], use_native=False)
    assert res["grid"] == [hb, wb]
    np.testing.assert_array_equal(got["crops"], want)
    np.testing.assert_array_equal(got["resized"], jax_resize_bilinear(arrays["small"], 336, 336))
    norm = ((arrays["u8"].astype(np.float32) / 255.0 - np.asarray(MEAN, np.float32))
            / np.asarray(STD, np.float32)).transpose(2, 0, 1)
    np.testing.assert_array_equal(got["normalized"], norm)
    with Image.open(tmp / "x.jpg") as im:
        np.testing.assert_array_equal(got["loaded"], np.asarray(im.convert("RGB")))


def test_without_the_source_the_paths_are_numpys(tmp_path):
    """F3: a copy of the package without `native/` takes the numpy paths
    and raises nothing; `build()` says the source is missing."""
    root = tmp_path / "site"
    shutil.copytree(REPO / "tokenpacker_tpu_torch", root / "tokenpacker_tpu_torch",
                    ignore=shutil.ignore_patterns("native", "_kernels_build", "__pycache__"))
    arrays = _inputs(tmp_path)
    res = _child(_paths(after="""
        try:
            native.build(tmp / "build")
            out["build"] = "built"
        except RuntimeError as e:
            out["build"] = str(e)
    """), root, tmp_path)
    assert res["module"].startswith(str(root))
    assert not res["available_before"] and not res["available_after"] and not res["jpeg"]
    assert "is not installed" in res["build"], res["build"]
    assert not (tmp_path / "build").exists()
    _assert_numpy_paths(tmp_path, arrays, res)


@needs_gxx
def test_only_build_builds_the_library(tmp_path):
    """F2: with g++ and the source, the image paths in a fresh process
    leave an empty BUILD_DIR empty and keep numpy's values; `build()` then
    fills it, and `available()` turns True in that process and the next."""
    build = tmp_path / "build"
    build.mkdir()
    arrays = _inputs(tmp_path)
    res = _child(_paths(setup=f"native.BUILD_DIR = Path({str(build)!r})", after="""
        out["left"] = sorted(p.name for p in native.BUILD_DIR.iterdir())
        out["built"] = native.build().name
        out["available_built"] = native.available()
    """), REPO, tmp_path)
    assert res["module"].startswith(str(REPO))
    assert res["left"] == [], res["left"]
    assert not res["available_before"] and not res["available_after"] and not res["jpeg"]
    _assert_numpy_paths(tmp_path, arrays, res)
    assert res["available_built"] and res["built"].startswith("libtpp-")
    assert sorted(p.name for p in build.iterdir()) == [res["built"]]
    later = _child(f"""
        import json
        from pathlib import Path
        from tokenpacker_tpu_torch.image import native
        native.BUILD_DIR = Path({str(build)!r})
        name = Path(native.load()._name).name
        print(json.dumps({{"available": native.available(), "name": name}}))
    """, REPO, tmp_path)
    assert later == {"available": True, "name": res["built"]}


@needs_gxx
def test_the_build_command_and_the_env_library(tmp_path):
    """`python -m tokenpacker_tpu_torch.image.native --build-dir DIR` builds
    into DIR and prints the path; TOKENPACKER_NATIVE_LIB makes a process
    whose own BUILD_DIR is empty load that file (and only it), as the JAX
    package's `_find_lib` does."""
    proc = subprocess.run([sys.executable, "-m", "tokenpacker_tpu_torch.image.native",
                           "--build-dir", str(tmp_path / "cmd")], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    built = Path(proc.stdout.strip().splitlines()[-1])
    assert built.parent == tmp_path / "cmd" and built.exists()
    named = tmp_path / "elsewhere" / "libmine.so"
    named.parent.mkdir()
    shutil.copy(built, named)
    (tmp_path / "empty").mkdir()
    res = _child(f"""
        import json
        from pathlib import Path
        import numpy as np
        from tokenpacker_tpu_torch.image import native
        native.BUILD_DIR = Path({str(tmp_path / "empty")!r})
        out = {{"available": native.available()}}
        img = np.random.default_rng(0).standard_normal((3, 40, 52)).astype(np.float32)
        out["resized"] = native.resize_bilinear(img, 30, 30).tolist()
        out["loaded"] = native._LIB._name
        print(json.dumps(out))
    """, REPO, tmp_path, env={"TOKENPACKER_NATIVE_LIB": str(named)})
    assert res["available"] and res["loaded"] == str(named)
    img = np.random.default_rng(0).standard_normal((3, 40, 52)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(res["resized"], np.float32),
                               jax_resize_bilinear(img, 30, 30), rtol=1e-4, atol=1e-4)
    assert list((tmp_path / "empty").iterdir()) == []


def test_a_missing_source_counts_as_not_built(monkeypatch, tmp_path):
    """In this process too: with SOURCE gone, no build matches and the
    numpy paths answer (`_name` reads no file)."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("TOKENPACKER_NATIVE_LIB", raising=False)
    assert native._name(True) is None and native._built(tmp_path) is None
    assert not native.available() and not native.jpeg_available()
    img = np.random.default_rng(1).standard_normal((3, 33, 47)).astype(np.float32)
    np.testing.assert_array_equal(native.resize_bilinear(img, 20, 25),
                                  jax_resize_bilinear(img, 20, 25))
    with pytest.raises(RuntimeError, match="not built"):
        native.load()
