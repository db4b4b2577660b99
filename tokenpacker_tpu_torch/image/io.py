"""Image loading (counterpart of `tokenpacker_tpu/image/io.py`): a JPEG
decodes through the native libjpeg decoder (`image/native`) when its
library is built with libjpeg, anything else (or a JPEG it refuses)
through PIL, as the JAX package's front door does. Both return the same
RGB image for a baseline JPEG.
"""

from __future__ import annotations

from PIL import Image

from tokenpacker_tpu_torch.image import native

_JPEG_EXT = (".jpg", ".jpeg", ".JPG", ".JPEG")


def load_image(path: str) -> Image.Image:
    if path.endswith(_JPEG_EXT) and native.jpeg_available():
        try:
            with open(path, "rb") as f:
                return Image.fromarray(native.decode_jpeg(f.read()), "RGB")
        except ValueError:
            pass  # not decodable by libjpeg: PIL below
    with Image.open(path) as img:
        return img.convert("RGB")
