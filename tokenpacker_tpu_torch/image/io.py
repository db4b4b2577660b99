"""Image loading (counterpart of `tokenpacker_tpu/image/io.py`).

`load_image` decodes through PIL, as the reference does. The JAX
package's native libjpeg decode (built from `native/`) is a host-side
speed path that is not ported yet (ROADMAP queue 1); both return the same
RGB image for a baseline JPEG.
"""

from __future__ import annotations

from PIL import Image


def load_image(path: str) -> Image.Image:
    with Image.open(path) as img:
        return img.convert("RGB")
