"""Image preprocessing with CLIP semantics (counterpart of
`tokenpacker_tpu/image/processing.py`).

numpy + PIL on the host. Pad mode: `expand2square` to the CLIP mean
colour, then the HF `CLIPImageProcessor` defaults for
openai/clip-vit-large-patch14-336 (bicubic shortest-edge resize, centre
crop, 1/255, CLIP mean/std). Slice mode (HD): ToTensor + Normalize, then
`hd_tiler.slice_image`.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from tokenpacker_tpu_torch.constants import CLIP_IMAGE_MEAN, CLIP_IMAGE_SIZE, CLIP_IMAGE_STD
from tokenpacker_tpu_torch.image.hd_tiler import slice_image

_MEAN = np.array(CLIP_IMAGE_MEAN, dtype=np.float32)
_STD = np.array(CLIP_IMAGE_STD, dtype=np.float32)


def expand2square(pil_img: Image.Image, background_color) -> Image.Image:
    """Pad to square with the given background, image centred."""
    width, height = pil_img.size
    if width == height:
        return pil_img
    if width > height:
        result = Image.new(pil_img.mode, (width, width), background_color)
        result.paste(pil_img, (0, (width - height) // 2))
        return result
    result = Image.new(pil_img.mode, (height, height), background_color)
    result.paste(pil_img, ((height - width) // 2, 0))
    return result


def to_tensor_normalize(pil_img: Image.Image) -> np.ndarray:
    """ToTensor + Normalize(CLIP mean/std): [C, H, W] float32."""
    arr = np.asarray(pil_img.convert("RGB"), dtype=np.float32) / 255.0
    arr = (arr - _MEAN) / _STD
    return arr.transpose(2, 0, 1)


def clip_preprocess(pil_img: Image.Image, size: int = CLIP_IMAGE_SIZE) -> np.ndarray:
    """Bicubic shortest-edge resize, centre crop, rescale, normalize.
    Returns [C, size, size] float32."""
    img = pil_img.convert("RGB")
    w, h = img.size
    short = min(w, h)
    new_w, new_h = round(w * size / short), round(h * size / short)
    img = img.resize((new_w, new_h), Image.BICUBIC)
    left = (new_w - size) // 2
    top = (new_h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return to_tensor_normalize(img)


def process_image(pil_img: Image.Image, image_aspect_ratio: str | None = "pad",
                  patch_num: int = 9, image_size: int | None = None):
    """Returns (crops [n, C, S, S], h_block, w_block); n == 1 unless
    image_aspect_ratio == "slice". S defaults to the ViT-L/14-336 input."""
    size = image_size or CLIP_IMAGE_SIZE
    if image_aspect_ratio == "pad":
        bg = tuple(int(x * 255) for x in CLIP_IMAGE_MEAN)
        return clip_preprocess(expand2square(pil_img, bg), size)[None], 1, 1
    if image_aspect_ratio == "slice":
        return slice_image(to_tensor_normalize(pil_img), patch_num, block=size)
    return clip_preprocess(pil_img, size)[None], 1, 1


def process_images(images, image_aspect_ratio="pad", patch_num=9, image_size=None):
    """Batch wrapper: (crops [total, C, S, S], [(h_block, w_block)] per image)."""
    tensors, blocks = [], []
    for im in images:
        t, hb, wb = process_image(im, image_aspect_ratio, patch_num, image_size)
        tensors.append(t)
        blocks.append((hb, wb))
    return np.concatenate(tensors, axis=0), blocks


def to_model_input(crops: np.ndarray, dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """[n, C, H, W] numpy -> [n, H, W, C] tensor (channels-last for the tower)."""
    return torch.from_numpy(np.ascontiguousarray(crops.transpose(0, 2, 3, 1))).to(
        device=device, dtype=dtype
    )
