"""TokenPacker-HD's grid rule (which h_block x w_block tiling an image of a
given size gets), the benchmark's own copy: the traffic draws image sizes
and derives each request's grid and view count from it, and the reference
rebuilds the splice order from the grid alone.

score = round(h*r) * round(w*r) / grid_area + 0.1 * IoU(grid box, 1.4 x image
box), r = min(336*hb/h, 336*wb/w), over the candidate grids of the budget.
"""

from __future__ import annotations

import numpy as np

BLOCK = 336
GRIDS = {
    9: [(1, 1), (1, 2), (2, 1), (1, 3), (3, 1), (2, 2), (1, 4), (4, 1), (1, 5), (5, 1), (1, 6),
        (6, 1), (2, 3), (3, 2), (1, 7), (7, 1), (4, 2), (2, 4), (1, 8), (8, 1), (3, 3), (1, 9),
        (9, 1)],
}


def choose_grid(h: int, w: int, patch_num: int = 9, block: int = BLOCK) -> tuple[int, int]:
    grids = np.array(GRIDS[patch_num], dtype=np.float64)
    gh, gw = grids[:, 0] * block, grids[:, 1] * block
    areas = gh * gw
    ratio = np.minimum(gh / h, gw / w)
    coverage = np.round(h * ratio) * np.round(w * ratio) / areas
    inter = np.minimum(gh, 1.4 * h) * np.minimum(gw, 1.4 * w)
    iou = inter / (areas + (1.4 * h) * (1.4 * w) - inter + 1e-5)
    hb, wb = GRIDS[patch_num][int(np.argmax(coverage + 0.1 * iou))]
    return int(hb), int(wb)


def views(hb: int, wb: int) -> int:
    """Crops, plus the global view when there is more than one."""
    return hb * wb + (1 if hb * wb > 1 else 0)


def spliced_image_len(hb: int, wb: int, tokens_per_view: int) -> int:
    """Positions an image takes in slice mode: per row wb views, wb - 1
    separators and a newline; then the global view and a newline."""
    n = hb * (wb * tokens_per_view + wb)
    return n + (tokens_per_view + 1 if hb * wb > 1 else 0)
