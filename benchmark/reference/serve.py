"""The reference's reading of a served answer: one forward over the prompt
and the tokens the program served, and the logits at each served token's
position."""

from __future__ import annotations

import torch

from reference import clip, mpt, projector, splice


@torch.no_grad()
def answer_logits(weights: dict, conf: dict, ids, grid, pixels: torch.Tensor, served: list,
                  prec) -> torch.Tensor:
    """ids: the prompt's token ids with the image hole; grid: (h_block,
    w_block) in slice mode, None for one view; pixels [views, H, W, 3];
    served: the program's tokens. Returns [len(served), V] float32: row j
    the logits that predict served[j]."""
    tok = conf["assumed"]["tokenizer"]
    feats, multi = clip.tower(weights["vision"], conf["vision"], pixels, prec)
    visual = projector.project(weights["projector"], conf["projector"], feats, multi, prec)
    lm = weights["lm"]
    items = splice.order(ids, grid if conf["image_aspect_ratio"] == "slice" else None,
                         tok["sep_id"], tok["newline_id"])
    prompt = splice.embed(items, visual, lm["wte"])
    fed = torch.tensor(served[:-1], dtype=torch.long, device=prompt.device)
    x = torch.cat([prompt, lm["wte"][fed].float()])
    hid = mpt.hidden(lm, conf["lm"], x[None], prec)[0]
    return mpt.logits(lm, hid[prompt.shape[0] - 1:], prec)


def gaps(ref_logits: torch.Tensor, tokens) -> torch.Tensor:
    """How far each token's logit lies below the reference's best there."""
    idx = torch.as_tensor(tokens, device=ref_logits.device).long()
    return ref_logits.max(-1).values - ref_logits.gather(-1, idx[:, None])[:, 0]
