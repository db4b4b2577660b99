"""Multi-LoRA serving (counterpart of `tokenpacker_tpu/serve/multi_lora.py`):
many adapters over one shared base, chosen per request.

- Every adapter loads unmerged (`load_adapter`): per target linear an
  [L, in, r] A and an [L, r, out] B, the PEFT `alpha/r` scaling folded
  into B.
- `SlotLora` stacks them per layer for the tree's own layout: each
  layer's target leaf gets `slot_lora_a` [n, in, rcat] and `slot_lora_b`
  [n, rcat, out] (the fused `qkv` / `gateup` leaves a concatenated A and
  a block-diagonal B; a mixed rank is padded to the largest), plus one
  selection tensor `slot_lora_sel` [slots, n] that every layer shares
  (a one-hot row per batch slot, all zeros for the base model).
  `ops/layers.linear` adds `((x @ a) @ b) . sel` after the base product.
- On an int8 fused-layout tree (`ops/fused_decode.fused_eligible`) it also
  builds K4's bundle once (`ops/fused_decode.build_fd_lora`), so the
  decode step and the verify round add the same term inside K4; the
  per-layer stacks are then views into the bundle, so the device holds
  each adapter once.
- An adapter's non-LoRA trainables (the projector of a LLaVA LoRA
  checkpoint) apply to its requests' admissions only
  (`prefill_params`).
- Over a sharded tree (`parallel/sharding.shard_params`) each rank holds
  its target's share of every stack (`parallel/sharding.local_slot_lora`:
  b's columns of a column-parallel target, a's rows of a row-parallel
  one) and the selection and projector whole. Such a tree decodes per
  layer (`generate.fused_weights`), so no K4 bundle is built.

The adapter set is fixed when the batcher is built. `set_slot` writes one
host row and the one [slots, n] device tensor in place: the stacks, the
bundle and the batcher's `FusedWeights` table are never rebuilt, and the
parameter tree of `overlay` stays valid across admissions.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from tokenpacker_tpu_torch.io.hf_import import import_tokenpacker, strip_prefix
from tokenpacker_tpu_torch.io.weights import params_to
from tokenpacker_tpu_torch.ops.fused_decode import build_fd_lora, fused_eligible
from tokenpacker_tpu_torch.parallel.sharding import local_slot_lora, mesh_of

TARGETS = (
    ("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
    ("mlp", "gate"), ("mlp", "up"), ("mlp", "down"),
)

# the reference's projection names (train.py's find_all_linear_names) ->
# the (group, leaf) paths of the parameter tree
_TORCH_NAMES = {
    "self_attn.q_proj": ("attn", "q"),
    "self_attn.k_proj": ("attn", "k"),
    "self_attn.v_proj": ("attn", "v"),
    "self_attn.o_proj": ("attn", "o"),
    "mlp.gate_proj": ("mlp", "gate"),
    "mlp.up_proj": ("mlp", "up"),
    "mlp.down_proj": ("mlp", "down"),
}


def target_dims(lm_cfg) -> dict:
    d, f = lm_cfg.hidden_size, lm_cfg.intermediate_size
    hq = lm_cfg.num_attention_heads * lm_cfg.head_dim
    hkv = lm_cfg.kv_heads * lm_cfg.head_dim
    return {
        ("attn", "q"): (d, hq), ("attn", "k"): (d, hkv),
        ("attn", "v"): (d, hkv), ("attn", "o"): (hq, d),
        ("mlp", "gate"): (d, f), ("mlp", "up"): (d, f),
        ("mlp", "down"): (f, d),
    }


class Adapter:
    """One LoRA adapter, unmerged: {(group, leaf): (a [L, in, r], b [L, r,
    out])} float32 numpy arrays (the scaling folded into b; a target may be
    missing), its rank, and optional projector params."""

    def __init__(self, lora: dict, r: int, projector=None):
        self.lora = lora
        self.r = r
        self.projector = projector


def load_adapter(path: str, cfg, dtype=torch.bfloat16) -> Adapter:
    """Read a PEFT LoRA directory (adapter_config.json, adapter_model.bin
    and an optional non_lora_trainables.bin) without merging. torch's
    lora_A.weight is [r, in] and lora_B.weight [out, r]; the tree's
    kernels are [in, out], so a = A^T and b = (alpha / r) B^T. Keys that
    are not LM layer projections are skipped. The projector of
    non_lora_trainables.bin goes through `io/hf_import.import_tokenpacker`
    in `dtype`, on the CPU."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        acfg = json.load(f)
    r = int(acfg["r"])
    scaling = acfg["lora_alpha"] / acfg["r"]
    sd = torch.load(os.path.join(path, "adapter_model.bin"), map_location="cpu",
                    weights_only=True)
    n_layers = cfg.lm.num_hidden_layers
    per_layer: dict[tuple, dict[int, tuple]] = {t: {} for t in TARGETS}
    for k in sd:
        if not k.endswith("lora_A.weight"):
            continue
        parts = k.replace("base_model.model.", "").removesuffix(".lora_A.weight").split(".")
        if len(parts) < 4 or parts[0] != "model" or parts[1] != "layers":
            continue  # not an LM layer projection: not servable per slot
        tgt = _TORCH_NAMES.get(".".join(parts[3:]))
        if tgt is None:
            continue
        a = sd[k].float().numpy().T  # [in, r]
        b = sd[k.replace("lora_A", "lora_B")].float().numpy().T * scaling
        per_layer[tgt][int(parts[2])] = (a, b)

    dims = target_dims(cfg.lm)
    lora = {}
    for tgt, by_layer in per_layer.items():
        if not by_layer:
            continue
        din, dout = dims[tgt]
        a = np.zeros((n_layers, din, r), np.float32)
        b = np.zeros((n_layers, r, dout), np.float32)
        for i, (ai, bi) in by_layer.items():
            a[i], b[i] = ai, bi
        lora[tgt] = (a, b)

    projector = None
    nlt_file = os.path.join(path, "non_lora_trainables.bin")
    if os.path.exists(nlt_file):
        nlt = torch.load(nlt_file, map_location="cpu", weights_only=True)
        nlt = {k.replace("base_model.model.", ""): v for k, v in nlt.items()}
        proj_sd = strip_prefix(nlt, "model.mm_projector.")
        if proj_sd:
            projector = import_tokenpacker(proj_sd, cfg.projector, dtype)
    return Adapter(lora, r, projector)


def has_slot_lora(lm_params: dict) -> bool:
    """True when the LM tree carries slot-LoRA leaves (`SlotLora`)."""
    for layer in lm_params.get("layers") or []:
        for grp in ("attn", "mlp"):
            for leaf in layer.get(grp, {}).values():
                if isinstance(leaf, dict) and "slot_lora_a" in leaf:
                    return True
    return False


def _bundle_views(fd: dict, n: int) -> list[dict]:
    """The per-layer stacks of a fused-layout tree as views into K4's
    bundle (`build_fd_lora`): a target's A [in, W] columns are its n
    adapters' rcat columns in turn, so [n, in, rcat] is a split and a
    permute of them; its B [W, out] rows split into [n, rcat, out]."""
    wq, wo, wg, wd = fd["widths"]

    def a_view(a, lo, w):
        return a[:, lo:lo + w].unflatten(1, (n, w // n)).permute(1, 0, 2)

    def b_view(b):
        return b.unflatten(0, (n, b.shape[0] // n))

    return [{("attn", "qkv"): (a_view(fd["a_d"][i], 0, wq), b_view(fd["b_qkv"][i])),
             ("attn", "o"): (a_view(fd["a_d"][i], wq, wo), b_view(fd["b_o"][i])),
             ("mlp", "gateup"): (a_view(fd["a_d"][i], wq + wo, wg), b_view(fd["b_gu"][i])),
             ("mlp", "down"): (a_view(fd["a_f"][i], 0, wd), b_view(fd["b_down"][i]))}
            for i in range(fd["a_d"].shape[0])]


class SlotLora:
    """Per-slot adapter selection and the parameter overlays of the
    continuous batchers (module docstring). params: the base tree on its
    device, whole or a rank's shards; cfg: the model's config (its full
    widths, also over a sharded tree); adapters: {name: Adapter};
    num_slots: the batcher's slots."""

    def __init__(self, params, cfg, adapters: dict[str, Adapter], num_slots: int,
                 dtype=torch.bfloat16):
        if cfg.lm.model_family != "llama":
            raise ValueError("multi-LoRA serving supports llama-family LMs")
        if not adapters:
            raise ValueError("adapters must be a non-empty {name: Adapter}")
        lm = params["lm"]
        layers = lm["layers"]
        device = layers[0]["input_ln"]["scale"].device
        fused_qkv = "qkv" in layers[0]["attn"]
        fused_gateup = "gateup" in layers[0]["mlp"]
        self.names = sorted(adapters)
        self.r = max(a.r for a in adapters.values())
        self.projectors = {name: params_to(adapters[name].projector, device, dtype)
                           for name in self.names if adapters[name].projector is not None}
        dims = target_dims(cfg.lm)
        r = self.r

        def padded(ad: Adapter, tgt, i):
            """Layer i of one target, the rank padded to r with zeros
            (the padded columns of a meet zero rows of b)."""
            din, dout = dims[tgt]
            a = np.zeros((din, r), np.float32)
            b = np.zeros((r, dout), np.float32)
            if tgt in ad.lora:
                ai, bi = ad.lora[tgt]
                a[:, :ai.shape[-1]] = ai[i]
                b[:bi.shape[-2]] = bi[i]
            return a, b

        def stack(tgts, i):
            """[n, in, r * len(tgts)] concatenated A and [n, r * len(tgts),
            sum(outs)] block-diagonal B of layer i."""
            a_parts, b_parts = [], []
            for name in self.names:
                ads = [padded(adapters[name], t, i) for t in tgts]
                outs = [b.shape[-1] for _, b in ads]
                b_blk = np.zeros((r * len(tgts), sum(outs)), np.float32)
                off = 0
                for j, (_, b) in enumerate(ads):
                    b_blk[j * r:(j + 1) * r, off:off + outs[j]] = b
                    off += outs[j]
                a_parts.append(np.concatenate([a for a, _ in ads], axis=-1))
                b_parts.append(b_blk)
            return (torch.from_numpy(np.stack(a_parts)).to(dtype),
                    torch.from_numpy(np.stack(b_parts)).to(dtype))

        qkv = [("attn", "q"), ("attn", "k"), ("attn", "v")]
        plan = [(qkv, ("attn", "qkv"))] if fused_qkv else [([t], t) for t in qkv]
        plan.append(([("attn", "o")], ("attn", "o")))
        gateup = [("mlp", "gate"), ("mlp", "up")]
        plan += [(gateup, ("mlp", "gateup"))] if fused_gateup else [([t], t) for t in gateup]
        plan.append(([("mlp", "down")], ("mlp", "down")))
        # per layer {params-layout target: (a, b)}, on the CPU
        stacks = [{out: stack(tgts, i) for tgts, out in plan} for i in range(len(layers))]

        # K4's bundle, built once, where the decode step runs K4. The
        # device then holds the adapters once: the per-layer stacks are
        # views into the bundle.
        self._fd = None
        if mesh_of(lm) is None and fused_eligible(lm, cfg.lm):
            fd = build_fd_lora(stacks, cfg.lm, dtype)
            self._fd = {k: v.to(device) if torch.is_tensor(v) else v for k, v in fd.items()}
            self.stacks = _bundle_views(self._fd, len(self.names))
        else:
            self.stacks = [{(grp, leaf): tuple(t.to(device) for t in local_slot_lora(
                layer[grp][leaf], a, b)) for (grp, leaf), (a, b) in st.items()}
                for layer, st in zip(layers, stacks)]
        n = len(self.names)
        self._sel = np.zeros((num_slots, n), np.float32)  # host truth
        self.sel = torch.zeros((num_slots, n), dtype=torch.float32, device=device)

    def adapter_index(self, name: str | None) -> int | None:
        if name is None:
            return None
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"unknown adapter {name!r}; loaded: {self.names}") from None

    def set_slot(self, slot: int, name: str | None):
        """Point a slot at an adapter (None: the base model): one host row,
        copied into the shared [slots, n] device tensor in place."""
        idx = self.adapter_index(name)
        self._sel[slot] = 0.0
        if idx is not None:
            self._sel[slot, idx] = 1.0
        self.sel[slot].copy_(torch.from_numpy(self._sel[slot]))

    def _inject(self, base_params, sel: torch.Tensor):
        lm = dict(base_params["lm"])
        layers = []
        for layer, stacks in zip(lm["layers"], self.stacks):
            layer = dict(layer)
            for (grp, leaf), (a, b) in stacks.items():
                sub = dict(layer[grp])
                sub[leaf] = {**sub[leaf], "slot_lora_a": a, "slot_lora_b": b,
                             "slot_lora_sel": sel}
                layer[grp] = sub
            layers.append(layer)
        lm["layers"] = layers
        return {**base_params, "lm": lm}

    def overlay(self, base_params):
        """Decode-time params: the stacks and the slots' selection tensor on
        every target leaf, and on a K4 tree K4's bundle with the same
        selection as `lm["fd_slot_lora"]`. The tree reads the selection
        tensor that `set_slot` updates, so it is made once."""
        out = self._inject(base_params, self.sel)
        if self._fd is not None:
            out["lm"]["fd_slot_lora"] = {**self._fd, "sel": self.sel}
        return out

    def prefill_params(self, base_params, name: str | None):
        """Admission-time params for one request (batch 1): a [1, n]
        selection row, and the adapter's projector where it has one."""
        idx = self.adapter_index(name)
        sel = torch.zeros((1, len(self.names)), dtype=torch.float32, device=self.sel.device)
        if idx is not None:
            sel[0, idx] = 1.0
        out = self._inject(base_params, sel)
        if name is not None and name in self.projectors:
            out = {**out, "projector": self.projectors[name]}
        return out
