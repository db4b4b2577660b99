"""LLaVA's pad-mode preprocessing (`image_aspect_ratio: pad`): the picture is
padded to a square with the CLIP mean colour, then CLIPImageProcessor's
steps for openai/clip-vit-large-patch14-336: bicubic resize of the shortest
edge to 336, centre crop, 1/255, CLIP mean and std."""

from __future__ import annotations

import numpy as np
from PIL import Image

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def pad_square(img: Image.Image) -> Image.Image:
    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    out = Image.new(img.mode, (side, side), tuple(int(m * 255) for m in MEAN))
    out.paste(img, ((side - w) // 2, (side - h) // 2))
    return out


def pad_mode_pixels(path, size: int = 336) -> np.ndarray:
    """[size, size, 3] float32, CLIP-normalized."""
    img = pad_square(Image.open(path).convert("RGB"))
    w, h = img.size
    short = min(w, h)
    nw, nh = round(w * size / short), round(h * size / short)
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - np.array(MEAN, np.float32)) / np.array(STD, np.float32)
