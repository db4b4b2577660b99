"""TokenPacker's projector (CircleRadon/TokenPacker, `TokenPacker` in
multimodal_projector/builder.py): the queries are the penultimate features
bilinearly downsampled by the scale factor s; keys and values are MLPs of the
multi-level concat; each query attends, through one multi-head attention,
over the s x s fine positions of its own region; an MLP maps the result to
the LM's width."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ln(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["scale"].float(), p["bias"].float(), eps)


def _mlp(p, x, prec):
    h = F.gelu(prec.linear(x, p["fc1"]["kernel"], p["fc1"]["bias"]))
    return prec.linear(h, p["fc2"]["kernel"], p["fc2"]["bias"])


def _regions(x: torch.Tensor, grid: int, s: int) -> torch.Tensor:
    """[N, grid*grid, C] row-major -> [N, (grid/s)^2, s*s, C]: each coarse
    cell's s x s fine positions."""
    n, _, c = x.shape
    g = grid // s
    x = x.reshape(n, g, s, g, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, g * g, s * s, c)


def project(pp: dict, p: dict, feats: torch.Tensor, multi: torch.Tensor, prec) -> torch.Tensor:
    """feats [N, P, W], multi [N, P, 4W] -> visual tokens [N, (grid/s)^2, D]."""
    n, npos, _ = feats.shape
    grid, s, heads, e, eps = int(npos**0.5), p["scale_factor"], p["num_heads"], p["embed_dim"], p["ln_eps"]
    g = grid // s
    key = _ln(_mlp(pp["k_proj"], multi, prec), pp["ln_k"], eps)
    value = _ln(_mlp(pp["v_proj"], multi, prec), pp["ln_v"], eps)
    q = feats.float().reshape(n, grid, grid, -1).permute(0, 3, 1, 2)
    q = F.interpolate(q, size=(g, g), mode="bilinear", align_corners=False)
    q = q.permute(0, 2, 3, 1).reshape(n, g * g, -1)
    query = _ln(prec.linear(q, pp["q_proj"]["kernel"]), pp["ln_q"], eps)
    a = pp["attn"]
    hd = e // heads
    qh = prec.linear(query, a["q"]["kernel"], a["q"]["bias"]).reshape(n, g * g, 1, heads, hd)
    kh = _regions(prec.linear(key, a["k"]["kernel"], a["k"]["bias"]), grid, s)
    vh = _regions(prec.linear(value, a["v"]["kernel"], a["v"]["bias"]), grid, s)
    kh = kh.reshape(n, g * g, s * s, heads, hd)
    vh = vh.reshape(n, g * g, s * s, heads, hd)
    # per region and head: one query over its s*s keys
    qh, kh, vh = (t.permute(0, 1, 3, 2, 4) for t in (qh, kh, vh))  # [N, G, H, ., hd]
    attn = torch.softmax(prec.bmm(qh, kh.transpose(-1, -2)) * hd**-0.5, dim=-1)
    out = prec.bmm(attn, vh).reshape(n, g * g, e)
    out = prec.linear(out, a["o"]["kernel"], a["o"]["bias"])
    return _mlp(pp["mlp"], out, prec)
