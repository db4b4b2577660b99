"""TokenPacker-HD image tiler (counterpart of `tokenpacker_tpu/image/hd_tiler.py`).

numpy on the host:

1. `choose_grid(h, w, patch_num)` picks (h_block, w_block) from the
   candidate list, maximizing resolution coverage + 0.1 * IoU against the
   1.4x-scaled image box.
2. `slice_image(img)` resizes aspect-preserving (bilinear) into a
   zero-padded (336*h_block, 336*w_block) canvas, cuts it row-major into
   336x336 crops and, when there is more than one crop, appends a 336x336
   global view of the canvas.

The bilinear resize is the dense-matrix form of `ops/layers.
bilinear_resize_matrix`, which reproduces `F.interpolate(mode='bilinear',
align_corners=False)`.
"""

from __future__ import annotations

import numpy as np

from tokenpacker_tpu_torch.ops.layers import bilinear_resize_matrix

BLOCK_SIZE = 336

# Candidate (h_block, w_block) grids per patch budget.
GRIDS_9 = [
    (1, 1),
    (1, 2), (2, 1),
    (1, 3), (3, 1),
    (2, 2), (1, 4), (4, 1),
    (1, 5), (5, 1),
    (1, 6), (6, 1), (2, 3), (3, 2),
    (1, 7), (7, 1),
    (4, 2), (2, 4), (1, 8), (8, 1),
    (3, 3), (1, 9), (9, 1),
]

GRIDS_16 = GRIDS_9 + [
    (2, 5), (5, 2),
    (2, 6), (6, 2), (3, 4), (4, 3),
    (2, 7), (7, 2),
    (3, 5), (5, 3),
    (2, 8), (8, 2), (4, 4),
]

GRIDS_25 = GRIDS_16 + [
    (3, 6), (6, 3), (2, 9), (9, 2),
    (4, 5), (5, 4), (2, 10), (10, 2),
    (3, 7), (7, 3),
    (11, 2), (2, 11),
    (4, 6), (6, 4), (12, 2), (2, 12), (3, 8), (8, 3), (4, 6), (6, 4),
    (5, 5),
]

_GRIDS = {9: GRIDS_9, 16: GRIDS_16, 25: GRIDS_25}


def grid_candidates(patch_num: int) -> list[tuple[int, int]]:
    try:
        return _GRIDS[patch_num]
    except KeyError:
        raise NotImplementedError(f"patch_num must be in {{9,16,25}}, got {patch_num}")


def choose_grid(h: int, w: int, patch_num: int = 9, block: int = BLOCK_SIZE) -> tuple[int, int]:
    """(h_block, w_block) for an h x w image:
    score = round(h*r)*round(w*r)/area + 0.1*IoU(grid_box, 1.4*image_box),
    r = min(block*hb/h, block*wb/w), both boxes at the origin."""
    grids = np.array(grid_candidates(patch_num), dtype=np.float64)  # [M, 2]
    gh, gw = grids[:, 0] * block, grids[:, 1] * block
    areas = gh * gw

    ratio = np.minimum(gh / h, gw / w)
    score = np.round(h * ratio) * np.round(w * ratio) / areas

    ih, iw = np.minimum(gh, 1.4 * h), np.minimum(gw, 1.4 * w)
    inter = ih * iw
    union = areas + (1.4 * h) * (1.4 * w) - inter
    iou = inter / (union + 1e-5)

    idx = int(np.argmax(score + iou * 0.1))
    hb, wb = grid_candidates(patch_num)[idx]
    return int(hb), int(wb)


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """img: [C, H, W] float -> [C, out_h, out_w], torch-interpolate semantics."""
    wh = bilinear_resize_matrix(img.shape[1], out_h)
    ww = bilinear_resize_matrix(img.shape[2], out_w)
    return np.einsum("oh,pw,chw->cop", wh, ww, img, optimize=True)


def _fit_into(h: int, w: int, canvas_h: int, canvas_w: int) -> tuple[int, int]:
    """Aspect-preserving target size that fills the canvas."""
    h_ratio = canvas_h / h
    w_ratio = canvas_w / w
    if h_ratio <= w_ratio:
        return canvas_h, min(canvas_w, round(w * h_ratio))
    return min(canvas_h, round(h * w_ratio)), canvas_w


def slice_image(img: np.ndarray, patch_num: int = 9, block: int = BLOCK_SIZE,
                use_native: bool = True) -> tuple[np.ndarray, int, int]:
    """img: [C, H, W] float (already CLIP-normalized) -> (crops
    [n_crops (+1), C, block, block], h_block, w_block): row-major crops of
    a zero-padded canvas, plus a global view when there is more than one.
    With `use_native`, the C++ library (`image/native`) slices when it is
    built, as the JAX package's does; numpy otherwise."""
    c, h, w = img.shape
    hb, wb = choose_grid(h, w, patch_num, block)
    if use_native:
        from tokenpacker_tpu_torch.image import native

        if native.available():
            th, tw = _fit_into(h, w, block * hb, block * wb)
            gh, gw = _fit_into(h, w, block, block)
            return native.hd_slice(np.ascontiguousarray(img, np.float32), hb, wb, block, th, tw,
                                   gh, gw), hb, wb
    th, tw = _fit_into(h, w, block * hb, block * wb)
    canvas = np.zeros((c, block * hb, block * wb), dtype=img.dtype)
    canvas[:, :th, :tw] = _resize_bilinear(img, th, tw)

    crops = [
        canvas[:, block * i : block * (i + 1), block * j : block * (j + 1)]
        for i in range(hb)
        for j in range(wb)
    ]
    if len(crops) > 1:
        gh, gw = _fit_into(h, w, block, block)
        # the global view resizes the canvas, not the original image
        g = np.zeros((c, block, block), dtype=img.dtype)
        g[:, :gh, :gw] = _resize_bilinear(canvas, gh, gw)
        crops.append(g)
    return np.stack(crops), hb, wb


def num_visual_tokens(hb: int, wb: int, tokens_per_view: int) -> int:
    """Sequence length of one HD image after slice splicing: per row, wb
    views + (wb-1) separators + 1 newline; plus the global view and a
    newline when there is more than one crop."""
    n = hb * (wb * tokens_per_view + (wb - 1) + 1)
    if hb * wb > 1:
        n += tokens_per_view + 1
    return n
