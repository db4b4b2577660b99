"""Training CLI (counterpart of `tokenpacker_tpu/train/train.py`): the flag
surface of the reference recipes, run on one device.

  python -m tokenpacker_tpu_torch.train.train \
      --stage pretrain --model-path <vicuna> --data-path blip_558k.json \
      --image-folder images/ --output-dir checkpoints/stage1 \
      --learning-rate 1e-3 --version plain --per-device-batch-size 32

QLoRA (reference train.py:827-874): `--bits 4 --lora-enable` (or 8)
quantizes the frozen LM and trains rank-r adapters and the projector,
writing the reference's LoRA layout (`adapter_model.bin`,
`adapter_config.json`, `non_lora_trainables.bin`), which
`api.load_pretrained_model(ckpt, model_base=...)` and
`serve/multi_lora.load_adapter` read.

The flags are the JAX CLI's, plus `--device` (default cuda; cpu on
request). `--remat` goes to `RunConfig.remat`. The model loads through
`api.load_pretrained_model` in bf16.

Across ranks (`parallel/mesh`): run it under torchrun, one process per
card, and the trainer builds a ('data', 'model') mesh over the world
with `--tp` ranks to a 'model' row (each rank on `cuda:LOCAL_RANK`, NCCL;
`--device cpu` runs gloo):

  torchrun --nproc-per-node 8 -m tokenpacker_tpu_torch.train.train \
      --tp 2 --model-path ... --data-path ... --output-dir ...

Without torchrun the world is one rank, as before.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

import torch

from tokenpacker_tpu_torch.data.dataset import SupervisedDataset
from tokenpacker_tpu_torch.train.lora import LoraConfig
from tokenpacker_tpu_torch.train.step import TrainConfig
from tokenpacker_tpu_torch.train.trainer import RunConfig, Trainer

BITS_NEED_LORA = ("--bits 4/8 quantizes a FROZEN base and therefore requires "
                  "--lora-enable (QLoRA); full-precision training ignores --bits")


def _remat_policy(v: str) -> str:
    if v in ("full", "dots") or (v.startswith("dots:") and v.split(":", 1)[1].isdigit()):
        return v
    raise argparse.ArgumentTypeError(f"--remat must be 'full', 'dots', or 'dots:K' (got {v!r})")


def build_parser():
    p = argparse.ArgumentParser()
    # model
    p.add_argument("--model-path", required=True, help="base LLM or full VLM checkpoint")
    p.add_argument("--model-base", default=None)
    p.add_argument("--pretrain-mm-mlp-adapter", default=None, help="stage-1 mm_projector.bin")
    p.add_argument("--scale-factor", type=int, default=2)
    p.add_argument("--version", default="v1", help="conversation template (plain for stage 1)")
    # data
    p.add_argument("--data-path", required=True)
    p.add_argument("--image-folder", default=".")
    p.add_argument("--image-aspect-ratio", default="pad", choices=["pad", "slice", "none"])
    p.add_argument("--patch-num", type=int, default=9)
    p.add_argument("--model-max-length", type=int, default=2048)
    # optimization
    p.add_argument("--stage", choices=["pretrain", "finetune"], default="finetune")
    p.add_argument("--learning-rate", type=float, default=2e-5)
    p.add_argument("--mm-projector-lr", type=float, default=None,
                   help="the projector's lr (stage 2 and LoRA; the JAX package's LoRA loop "
                        "ignores it: ROADMAP R15)")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="AdamW's decoupled decay (the JAX package's LoRA loop always applies "
                        "1e-4: ROADMAP R15)")
    p.add_argument("--warmup-ratio", type=float, default=0.03)
    p.add_argument("--num-train-epochs", type=int, default=1)
    p.add_argument("--per-device-batch-size", type=int, default=16)
    p.add_argument("--remat", nargs="?", const="full", default=None, type=_remat_policy,
                   help="per-layer rematerialization (activation checkpointing) of the LM: "
                        "'full' (the bare flag) recomputes each layer; 'dots' saves the "
                        "products' outputs and recomputes the rest; 'dots:K' applies 'dots' "
                        "to the last K layers and 'full' to the others")
    p.add_argument("--gradient-accumulation-steps", type=int, default=1,
                   help="micro-steps per optimizer step (reference global batch 256/128 = "
                        "per-device-batch x devices x this)")
    p.add_argument("--group-by-modality-length", action="store_true")
    # run
    p.add_argument("--output-dir", required=True)
    p.add_argument("--save-steps", type=int, default=500)
    p.add_argument("--save-total-limit", type=int, default=1)
    p.add_argument("--no-async-save", action="store_true",
                   help="block on checkpoint disk writes (default: stage-2 writes overlap "
                        "the next steps)")
    p.add_argument("--logging-steps", type=int, default=1)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks per 'model' row of the mesh; the world "
                        "(torchrun's processes) must be a multiple of it, the rest is 'data'")
    p.add_argument("--seed", type=int, default=42)
    # quantized / LoRA training (reference train.py:100-111, 827-874)
    p.add_argument("--bits", type=int, default=16, choices=[16, 8, 4])
    p.add_argument("--lora-enable", action="store_true")
    p.add_argument("--lora-r", type=int, default=64)
    p.add_argument("--lora-alpha", type=int, default=16)
    p.add_argument("--lora-dropout", type=float, default=0.05,
                   help="written to adapter_config.json; not applied, as in the JAX package "
                        "(ROADMAP R15)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> Trainer:
    """Parse `argv`, load the model, train; returns the Trainer (its
    `history`, params and, after LoRA, `lora`)."""
    args = build_parser().parse_args(argv)
    if args.bits in (4, 8) and not args.lora_enable:
        raise SystemExit(BITS_NEED_LORA)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    from tokenpacker_tpu_torch import api
    from tokenpacker_tpu_torch.io.hf_import import import_tokenpacker, strip_prefix

    if args.device == "cuda" and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"  # a rank of torchrun's

    tokenizer, model, _, _ = api.load_pretrained_model(args.model_path, args.model_base,
                                                       device=args.device)
    cfg = dataclasses.replace(model.config, scale_factor=args.scale_factor,
                              patch_num=args.patch_num,
                              image_aspect_ratio=args.image_aspect_ratio,
                              model_max_length=args.model_max_length)
    params = model.params
    del model  # its Generator would keep the dense LM alive beside a quantized one

    if args.pretrain_mm_mlp_adapter:
        sd = torch.load(args.pretrain_mm_mlp_adapter, map_location="cpu", weights_only=True)
        params["projector"] = import_tokenpacker(strip_prefix(sd, "model.mm_projector."),
                                                 cfg.projector, cfg.dtype, args.device)

    dataset = SupervisedDataset(args.data_path, tokenizer, image_folder=args.image_folder,
                                image_aspect_ratio=args.image_aspect_ratio,
                                patch_num=args.patch_num, version=args.version,
                                model_max_length=args.model_max_length,
                                image_size=cfg.vision.image_size)
    tcfg = TrainConfig(stage=args.stage, learning_rate=args.learning_rate,
                       mm_projector_lr=args.mm_projector_lr, weight_decay=args.weight_decay,
                       warmup_ratio=args.warmup_ratio,
                       gradient_accumulation_steps=args.gradient_accumulation_steps)
    lora_cfg = None
    if args.lora_enable:
        lora_cfg = LoraConfig(r=args.lora_r, alpha=args.lora_alpha, dropout=args.lora_dropout)
    rcfg = RunConfig(output_dir=args.output_dir, num_train_epochs=args.num_train_epochs,
                     per_device_batch_size=args.per_device_batch_size,
                     save_steps=args.save_steps, save_total_limit=args.save_total_limit,
                     async_save=not args.no_async_save, logging_steps=args.logging_steps,
                     group_by_modality_length=args.group_by_modality_length, seed=args.seed,
                     tp=args.tp, seq_pad_to=args.model_max_length, bits=args.bits,
                     lora=lora_cfg, remat=args.remat or "")
    trainer = Trainer(cfg, tcfg, rcfg, params, dataset, tokenizer, device=args.device)
    del params
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
