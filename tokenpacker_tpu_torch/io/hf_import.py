"""Reference-format projector state dicts (counterpart of the projector
part of `tokenpacker_tpu/io/hf_import.py`).

The reference names the projector's modules `mm_projector.{q_proj_1,
k_proj_1, v_proj_1, ln_{q,k,v}_1, clip_attn, mlp}` (projector
builder.py:59-83), with torch's `[out, in]` Linear weights and the packed
`clip_attn.in_proj_weight`. The port keeps the JAX package's `[in, out]`
kernels, so every weight is transposed exactly once here.
`export_tokenpacker` writes what stage 1 saves as `mm_projector.bin`;
`import_tokenpacker` reads it back. The tower and LM importers come with
the checkpoint loader (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tokenpacker_tpu_torch.config import ProjectorConfig


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _t(x, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _lin(sd: Mapping, name: str, dtype) -> dict:
    p = {"kernel": _t(_np(sd[f"{name}.weight"]).T, dtype)}
    if f"{name}.bias" in sd:
        p["bias"] = _t(_np(sd[f"{name}.bias"]), dtype)
    return p


def _ln(sd: Mapping, name: str, dtype) -> dict:
    return {"scale": _t(_np(sd[f"{name}.weight"]), dtype),
            "bias": _t(_np(sd[f"{name}.bias"]), dtype)}


def strip_prefix(sd: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def import_tokenpacker(sd: Mapping, cfg: ProjectorConfig, dtype=torch.float32) -> dict:
    """sd: keys relative to the projector module (`q_proj_1.weight`, ...),
    values torch tensors or numpy arrays -> the port's projector params."""
    e = cfg.embed_dim
    in_w = _np(sd["clip_attn.in_proj_weight"])  # [3E, E]
    in_b = _np(sd["clip_attn.in_proj_bias"])  # [3E]
    return {
        "q_proj": {"kernel": _t(_np(sd["q_proj_1.weight"]).T, dtype), "bias": None},
        "k_proj": {"fc1": _lin(sd, "k_proj_1.0", dtype), "fc2": _lin(sd, "k_proj_1.2", dtype)},
        "v_proj": {"fc1": _lin(sd, "v_proj_1.0", dtype), "fc2": _lin(sd, "v_proj_1.2", dtype)},
        "ln_q": _ln(sd, "ln_q_1", dtype),
        "ln_k": _ln(sd, "ln_k_1", dtype),
        "ln_v": _ln(sd, "ln_v_1", dtype),
        "attn": {
            name: {"kernel": _t(in_w[i * e:(i + 1) * e].T, dtype),
                   "bias": _t(in_b[i * e:(i + 1) * e], dtype)}
            for i, name in enumerate(("q", "k", "v"))
        } | {"o": _lin(sd, "clip_attn.out_proj", dtype)},
        "mlp": {"fc1": _lin(sd, "mlp.0", dtype), "fc2": _lin(sd, "mlp.2", dtype)},
    }


def export_tokenpacker(params, dtype=np.float32) -> dict:
    """Inverse of `import_tokenpacker`: reference-layout numpy arrays, the
    `mm_projector.bin` layout without its `model.mm_projector.` prefix."""

    def a(x):
        return _np(x).astype(dtype)

    def t(x):
        return a(x).T

    at = params["attn"]
    out = {
        "q_proj_1.weight": t(params["q_proj"]["kernel"]),
        "k_proj_1.0.weight": t(params["k_proj"]["fc1"]["kernel"]),
        "k_proj_1.0.bias": a(params["k_proj"]["fc1"]["bias"]),
        "k_proj_1.2.weight": t(params["k_proj"]["fc2"]["kernel"]),
        "k_proj_1.2.bias": a(params["k_proj"]["fc2"]["bias"]),
        "v_proj_1.0.weight": t(params["v_proj"]["fc1"]["kernel"]),
        "v_proj_1.0.bias": a(params["v_proj"]["fc1"]["bias"]),
        "v_proj_1.2.weight": t(params["v_proj"]["fc2"]["kernel"]),
        "v_proj_1.2.bias": a(params["v_proj"]["fc2"]["bias"]),
        "ln_q_1.weight": a(params["ln_q"]["scale"]),
        "ln_q_1.bias": a(params["ln_q"]["bias"]),
        "ln_k_1.weight": a(params["ln_k"]["scale"]),
        "ln_k_1.bias": a(params["ln_k"]["bias"]),
        "ln_v_1.weight": a(params["ln_v"]["scale"]),
        "ln_v_1.bias": a(params["ln_v"]["bias"]),
        "clip_attn.in_proj_weight": np.concatenate([t(at[x]["kernel"]) for x in ("q", "k", "v")]),
        "clip_attn.in_proj_bias": np.concatenate([a(at[x]["bias"]) for x in ("q", "k", "v")]),
        "clip_attn.out_proj.weight": t(at["o"]["kernel"]),
        "clip_attn.out_proj.bias": a(at["o"]["bias"]),
        "mlp.0.weight": t(params["mlp"]["fc1"]["kernel"]),
        "mlp.0.bias": a(params["mlp"]["fc1"]["bias"]),
        "mlp.2.weight": t(params["mlp"]["fc2"]["kernel"]),
        "mlp.2.bias": a(params["mlp"]["fc2"]["bias"]),
    }
    return out
