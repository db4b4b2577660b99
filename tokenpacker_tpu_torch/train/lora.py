"""LoRA and QLoRA fine-tuning (counterpart of `tokenpacker_tpu/train/lora.py`).

Reference parity (SURVEY.md §2.3, train.py:168-181 find_all_linear_names,
train.py:827-874): adapters attach to the LM's linear layers q, k, v, o,
gate, up and down, never to `embed`, `lm_head`, the tower or the
projector; the projector trains in full beside them. On MPT the rule
matches only the ffn's `up` and `down` (its attention is `wqkv` / `out`),
as in the JAX package (ROADMAP R13's neighbour, the MPT target rule). A
fused `qkv` / `gateup` leaf is never a target, so a QLoRA base is
quantized unfused (`ops/quantize.quantize_tree(_4bit)`).

The adapter tree mirrors the LM's per-layer list:
{"layers": [{group: {name: {"a": [in, r], "b": [r, out]}}}]}. An
adapter over a quantized leaf is bf16 whatever the model dtype; over a
dense leaf it takes the leaf's dtype. a ~ N(0, 1) * 0.01 and b = 0.

Differences from the JAX package (ROADMAP R14, R15):
- R14: JAX seeds each adapter with `hash(keystr(path))`, which Python
  salts per process; here a is drawn from a `torch.Generator` seeded
  from the seed and the CRC-32 of the path, the same in every process.
- R15: `LoraConfig.dropout` is written to `adapter_config.json` and not
  applied, as in the JAX package.
- Over a dense leaf the term is added unmerged, x @ W + (x @ a) @ (s b)
  (s = alpha / r), instead of JAX's merged W + s a b: the same function,
  without a merged copy of the LM a step.
"""

from __future__ import annotations

import contextlib
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.models.vlm import vlm_loss
from tokenpacker_tpu_torch.ops.quantize import is_q4leaf, is_qleaf
from tokenpacker_tpu_torch.train.step import (
    Optimizer,
    TrainConfig,
    leaves_with_paths,
    mesh_grads,
    warmup_cosine,
)


@dataclass(frozen=True)
class LoraConfig:
    r: int = 128
    alpha: int = 256
    dropout: float = 0.05  # recorded in adapter_config.json, not applied (R15)
    train_projector: bool = True


TARGETS = ("q", "k", "v", "o", "gate", "up", "down")

# the reference's module names of the targets (export_lora_state_dict); MPT's
# up / down take llama's names, as in the JAX package
NAME_MAP = {
    "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
    "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
    "down": "mlp.down_proj",
}


def _is_quant(leaf) -> bool:
    return is_qleaf(leaf) or is_q4leaf(leaf)


def _kernel_shape_dtype(kernel):
    """[in, out] and the adapter dtype of a dense or quantized kernel."""
    if isinstance(kernel, dict):
        if "q" in kernel:
            return tuple(kernel["q"].shape), torch.bfloat16, kernel["q"].device
        key = next(k for k in kernel if k.startswith("q4:"))
        packed = kernel[key]
        return (packed.shape[-2] * 2, packed.shape[-1]), torch.bfloat16, packed.device
    return tuple(kernel.shape), kernel.dtype, kernel.device


def targets(lm_params) -> list[tuple[int, str, str]]:
    """(layer, group, name) of every target module of the LM, in layer order:
    a dict under a layer whose key is a target and that holds a `kernel`."""
    out = []
    for i, layer in enumerate(lm_params["layers"]):
        for group, sub in layer.items():
            if not isinstance(sub, dict):
                continue
            for name, mod in sub.items():
                if name in TARGETS and isinstance(mod, dict) and "kernel" in mod:
                    out.append((i, group, name))
    return out


def path_seed(seed: int, i: int, group: str, name: str) -> int:
    """The generator seed of one adapter: the CRC-32 of the run's seed and
    its path, stable across processes (R14). 32 bits: the CPU generator
    (mt19937) reads no more of a seed."""
    return zlib.crc32(f"{seed}:lm/layers/{i}/{group}/{name}/kernel".encode())


def init_lora(seed: int, params, cfg: LoraConfig) -> dict:
    """The adapter tree for every target of params["lm"] (dense, int8 or
    4-bit): a from N(0, 1) * 0.01 on a CPU generator per adapter, moved to
    the kernel's device; b zeros."""
    layers = [{} for _ in params["lm"]["layers"]]
    for i, group, name in targets(params["lm"]):
        kernel = params["lm"]["layers"][i][group][name]["kernel"]
        (d_in, d_out), dtype, device = _kernel_shape_dtype(kernel)
        gen = torch.Generator().manual_seed(path_seed(seed, i, group, name))
        a = (torch.randn(d_in, cfg.r, generator=gen) * 0.01).to(device=device, dtype=dtype)
        b = torch.zeros(cfg.r, d_out, device=device, dtype=dtype)
        layers[i].setdefault(group, {})[name] = {"a": a, "b": b}
    return {"layers": layers}


def adapter_leaves(lora) -> list[torch.Tensor]:
    """Every a and b of the tree, in a fixed order."""
    return [t for layer in lora["layers"] for sub in layer.values() for ab in sub.values()
            for t in (ab["a"], ab["b"])]


def merge_lora_params(params, lora, cfg: LoraConfig) -> dict:
    """The params with each target carrying its adapter for `ops/layers.linear`:
    over a quantized kernel, `lora_a` and `lora_b * alpha / r` inside the
    leaf (the JAX package's form); over a dense one, the same two beside
    `kernel` (the unmerged term). Only the dicts along the targets' paths
    are new; every tensor is shared."""
    scale = cfg.alpha / cfg.r
    lm = params["lm"]
    layers = list(lm["layers"])
    for i, layer in enumerate(lora["layers"]):
        if not layer:
            continue
        new_layer = dict(layers[i])
        for group, sub in layer.items():
            new_group = dict(new_layer[group])
            for name, ab in sub.items():
                mod = new_group[name]
                extra = {"lora_a": ab["a"], "lora_b": (ab["b"] * scale).to(ab["b"].dtype)}
                if _is_quant(mod["kernel"]):
                    new_group[name] = {**mod, "kernel": {**mod["kernel"], **extra}}
                else:
                    new_group[name] = {**mod, **extra}
            new_layer[group] = new_group
        layers[i] = new_layer
    return {**params, "lm": {**lm, "layers": layers}}


def lora_loss(lora, params, vlm_cfg: TokenPackerVLMConfig, lcfg: LoraConfig, batch: dict,
              remat: str = ""):
    """`vlm_loss` of the params with the adapters attached. The projector
    trains in place (its tensors are the optimizer's), so it needs no
    substitution as in the JAX package's functional step."""
    return vlm_loss(merge_lora_params(params, lora, lcfg), vlm_cfg, batch, remat=remat)


def make_lora_train_step(vlm_cfg: TokenPackerVLMConfig, lcfg: LoraConfig, opt, remat: str = ""):
    """step(lora, base_params, opt_state, batch) -> (lora, opt_state,
    metrics): the loss, the gradients of the optimizer's leaves (the
    adapters, then the projector when it trains) and one optimizer
    micro-step in place (`train/step.Optimizer`). `grad_norm` is the
    global norm of those gradients. On the optimizer's mesh the batch is
    this rank's 'data' rows of the global batch and the adapters'
    gradients are all-reduced over 'data': the JAX loop shards no
    parameter and uses its mesh for the global batch alone, and this
    computes the same step."""

    def step(lora, base_params, opt_state, batch):
        with opt.mesh if opt.mesh is not None else contextlib.nullcontext():
            loss, metrics = lora_loss(lora, base_params, vlm_cfg, lcfg, batch, remat)
            grads, grad_norm = mesh_grads(loss, opt)
            opt.update(grads, opt_state)
        return lora, opt_state, {"loss": metrics["loss"].detach(), "n_tokens": metrics["n_tokens"],
                                 "grad_norm": grad_norm}

    return step


def export_lora_state_dict(lora, cfg: LoraConfig) -> dict:
    """The reference's adapter dict: `base_model.model.model.layers.{i}.
    <module>.lora_A.weight` [r, in] and `.lora_B.weight` [out, r] as fp32
    numpy, b without the alpha / r scale, in the JAX package's key order
    (targets by sorted group and name, then by layer)."""
    by_target: dict[tuple[str, str], list[tuple[int, dict]]] = {}
    for i, layer in enumerate(lora["layers"]):
        for group, sub in layer.items():
            for name, ab in sub.items():
                by_target.setdefault((group, name), []).append((i, ab))
    out = {}
    for group, name in sorted(by_target):
        for i, ab in by_target[(group, name)]:
            key = f"base_model.model.model.layers.{i}.{NAME_MAP[name]}"
            out[f"{key}.lora_A.weight"] = ab["a"].detach().float().cpu().numpy().T.copy()
            out[f"{key}.lora_B.weight"] = ab["b"].detach().float().cpu().numpy().T.copy()
    return out


def import_lora_state_dict(sd: dict, lora) -> None:
    """Copy an `export_lora_state_dict` dict (the reference's adapter file)
    into the tensors of `lora`, in place, each in its own dtype; raises on
    a missing key."""
    with torch.no_grad():
        for i, layer in enumerate(lora["layers"]):
            for group, sub in layer.items():
                for name, ab in sub.items():
                    key = f"base_model.model.model.layers.{i}.{NAME_MAP[name]}"
                    for part, t in (("A", ab["a"]), ("B", ab["b"])):
                        w = sd[f"{key}.lora_{part}.weight"]
                        w = torch.as_tensor(np.asarray(w)) if not isinstance(w, torch.Tensor) else w
                        t.copy_(w.t())


def lora_schedule(base_lr: float, warmup_ratio: float, total: int):
    """The JAX package's LoRA schedule: `optax.warmup_cosine_decay_schedule(0,
    lr, max(warmup, 1), total + 1)` with warmup = max(min(int(ratio *
    total), total - 1), 0), so the first update has lr 0; a constant lr
    for a run of one update."""
    if total <= 1:
        return lambda count: base_lr
    warmup = max(min(int(warmup_ratio * total), total - 1), 0)
    return warmup_cosine(base_lr, max(warmup, 1), total + 1)


def make_lora_optimizer(tcfg: TrainConfig, lcfg: LoraConfig, lora, projector,
                        total: int, mesh=None) -> Optimizer:
    """AdamW over the adapters (lr `learning_rate`) and, when it trains, the
    projector (`mm_projector_lr`, else `learning_rate`), with one global
    clip over both and `lora_schedule` over `total` updates; those leaves
    are marked `requires_grad_(True)`. weight_decay is tcfg's (the JAX
    package always applies optax's 1e-4: ROADMAP R15)."""
    groups = {"lora": adapter_leaves(lora)}
    schedules = {"lora": lora_schedule(tcfg.learning_rate, tcfg.warmup_ratio, total)}
    if lcfg.train_projector:
        groups["projector"] = [t for _, t in leaves_with_paths(projector)]
        schedules["projector"] = lora_schedule(tcfg.mm_projector_lr or tcfg.learning_rate,
                                               tcfg.warmup_ratio, total)
    for leaves in groups.values():
        for t in leaves:
            t.requires_grad_(True)
    return Optimizer(tcfg, groups, schedules, global_clip=True, mesh=mesh)
