"""Checkpoint surgery tools (counterpart of `tokenpacker_tpu/io/surgery.py`).

The reference's loose scripts:
- `extract_mm_projector` (scripts/extract_mm_projector.py:24-47): the
  `mm_projector` keys of a full or sharded checkpoint into
  `mm_projector.bin` (a trainer's directory: its last `checkpoint-*`);
- `merge_lora` (scripts/merge_lora_weights.py): a LoRA adapter merged into
  its base (`api._load_lora_merged`), saved as a full checkpoint;
- `consolidate` (llava/model/consolidate.py): a checkpoint directory
  copied with its `config.json` rewritten by the port's config.

All of them read and write HF-layout checkpoints, on the host.

    python -m tokenpacker_tpu_torch.io.surgery extract-mm-projector --model-path DIR --output FILE
    python -m tokenpacker_tpu_torch.io.surgery merge-lora --model-path DIR --model-base DIR \\
        --save-model-path DIR
    python -m tokenpacker_tpu_torch.io.surgery consolidate --src DIR --dst DIR
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil

import torch

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.io.checkpoint import load_any_state_dict


def extract_mm_projector(model_path: str, output: str):
    """Keep the keys that contain "mm_projector"; a directory without
    `pytorch_model*` files reads its last `checkpoint-*` directory, as the
    reference's --checkpoint-* handling."""
    if os.path.isdir(model_path) and not glob.glob(os.path.join(model_path, "pytorch_model*")):
        ckpts = sorted(glob.glob(os.path.join(model_path, "checkpoint-*")))
        if ckpts:
            model_path = ckpts[-1]
    sd = load_any_state_dict(model_path)
    proj = {k: v for k, v in sd.items() if "mm_projector" in k}
    if not proj:
        raise ValueError("no mm_projector keys found")
    torch.save({k: torch.as_tensor(v) for k, v in proj.items()}, output)
    print(f"wrote {len(proj)} tensors to {output}")


def merge_lora(model_path: str, model_base: str, save_path: str):
    """Merge the LoRA deltas into the base weights (fp32, on the host) and
    save a full checkpoint: `pytorch_model.bin` in fp32 and `config.json`."""
    from tokenpacker_tpu_torch.api import _load_lora_merged
    from tokenpacker_tpu_torch.io.hf_export import export_vlm_state_dict, to_torch_state_dict

    cfg = TokenPackerVLMConfig.from_json(os.path.join(model_path, "config.json"))
    params = _load_lora_merged(model_path, model_base, cfg, torch.float32, "cpu")
    os.makedirs(save_path, exist_ok=True)
    sd = export_vlm_state_dict(params, cfg)
    torch.save(to_torch_state_dict(sd), os.path.join(save_path, "pytorch_model.bin"))
    with open(os.path.join(save_path, "config.json"), "w") as f:
        json.dump(cfg.to_hf_dict(), f, indent=2)
    print(f"merged checkpoint saved to {save_path}")


def consolidate(src: str, dst: str):
    """Copy a checkpoint directory's files, `config.json` normalised."""
    os.makedirs(dst, exist_ok=True)
    cfg = TokenPackerVLMConfig.from_json(os.path.join(src, "config.json"))
    for f in glob.glob(os.path.join(src, "*")):
        if os.path.basename(f) != "config.json":
            shutil.copy(f, dst)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(cfg.to_hf_dict(), f, indent=2)
    print(f"consolidated {src} -> {dst}")


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("extract-mm-projector")
    sp.add_argument("--model-path", required=True)
    sp.add_argument("--output", required=True)

    sp = sub.add_parser("merge-lora")
    sp.add_argument("--model-path", required=True)
    sp.add_argument("--model-base", required=True)
    sp.add_argument("--save-model-path", required=True)

    sp = sub.add_parser("consolidate")
    sp.add_argument("--src", required=True)
    sp.add_argument("--dst", required=True)

    args = p.parse_args(argv)
    if args.cmd == "extract-mm-projector":
        extract_mm_projector(args.model_path, args.output)
    elif args.cmd == "merge-lora":
        merge_lora(args.model_path, args.model_base, args.save_model_path)
    else:
        consolidate(args.src, args.dst)


if __name__ == "__main__":
    main()
