"""CLIP ViT-L/14-336's vision tower as LLaVA reads it (HF `CLIPVisionModel`):
a 14x14 patch convolution without bias, a class token and learned
positions, the pre-LayerNorm, then pre-LN blocks (16-head attention with
biases, quick-GELU MLP). LLaVA takes hidden state -2 without the class
token; TokenPacker also concatenates hidden states 12, 16, 22 and 23."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ln(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["scale"].float(), p["bias"].float(), eps)


def tower(vp: dict, v: dict, images: torch.Tensor, prec):
    """images [N, H, W, 3] (CLIP-normalized) -> (features [N, P, W], the
    multi-level concat [N, P, 4W]) in float32."""
    n = images.shape[0]
    p, w, heads = v["patch_size"], v["hidden_size"], v["num_attention_heads"]
    eps = v["layer_norm_eps"]
    patches = F.unfold(images.float().permute(0, 3, 1, 2), kernel_size=p, stride=p)
    x = prec.linear(patches.transpose(1, 2), vp["patch_embed"]["kernel"])
    cls = vp["class_embedding"].float().expand(n, 1, w)
    x = torch.cat([cls, x], dim=1) + vp["pos_embed"].float()
    x = _ln(x, vp["pre_ln"], eps)
    depth = v["num_hidden_layers"] + 1
    select = v["select_layer"] % depth
    wanted = {select, *v["multi_layers"]}
    hidden = {0: x}
    t, hd = x.shape[1], w // heads
    for i in range(max(wanted)):
        lp = vp["layers"][i]
        h = _ln(x, lp["ln1"], eps)
        q, k, vv = (prec.linear(h, lp["attn"][m]["kernel"], lp["attn"][m]["bias"])
                    .reshape(n, t, heads, hd).transpose(1, 2) for m in ("q", "k", "v"))
        attn = torch.softmax(prec.bmm(q, k.transpose(-1, -2)) * hd**-0.5, dim=-1)
        o = prec.bmm(attn, vv).transpose(1, 2).reshape(n, t, w)
        x = x + prec.linear(o, lp["attn"]["o"]["kernel"], lp["attn"]["o"]["bias"])
        h = _ln(x, lp["ln2"], eps)
        h = prec.linear(h, lp["mlp"]["fc1"]["kernel"], lp["mlp"]["fc1"]["bias"])
        h = h * torch.sigmoid(1.702 * h)
        x = x + prec.linear(h, lp["mlp"]["fc2"]["kernel"], lp["mlp"]["fc2"]["bias"])
        hidden[i + 1] = x
    feats = hidden[select][:, 1:]
    multi = torch.cat([hidden[l] for l in v["multi_layers"]], dim=-1)[:, 1:]
    return feats, multi
