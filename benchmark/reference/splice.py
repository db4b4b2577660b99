"""Where a prompt's text and visual tokens land, worked out from its token
ids and its image's grid alone.

Single view (pad mode): the image hole becomes the view's tokens.
TokenPacker-HD (slice mode): the hole becomes the crops row by row, a
separator token between the views of a row and a newline token after each
row, then, when there is more than one crop, the global view and a newline.
Crops arrive row-major with the global view last.
"""

from __future__ import annotations

import torch

IMAGE_TOKEN_INDEX = -200


def order(ids, grid: tuple[int, int] | None, sep_id: int, newline_id: int) -> list:
    """The spliced sequence as a list of items: an int is a text token id, a
    tuple ("view", k) the k-th view's tokens."""
    out = []
    for t in ids:
        t = int(t)
        if t != IMAGE_TOKEN_INDEX:
            out.append(t)
            continue
        if grid is None:
            out.append(("view", 0))
            continue
        hb, wb = grid
        for r in range(hb):
            for c in range(wb):
                if c:
                    out.append(sep_id)
                out.append(("view", r * wb + c))
            out.append(newline_id)
        if hb * wb > 1:
            out += [("view", hb * wb), newline_id]
    return out


def embed(items: list, visual: torch.Tensor, wte: torch.Tensor) -> torch.Tensor:
    """items (from `order`), visual [views, tokens, D] -> input embeddings
    [positions, D] in float32."""
    parts, text = [], []

    def flush():
        if text:
            parts.append(wte[torch.tensor(text, device=wte.device)].float())
            text.clear()

    for it in items:
        if isinstance(it, tuple):
            flush()
            parts.append(visual[it[1]].float())
        else:
            text.append(it)
    flush()
    return torch.cat(parts)
