#!/bin/bash
# Stage 2 — full SFT (reference scripts/v1_5/finetune.sh recipe: lr 2e-5,
# global batch 128, pad aspect, v1 template, modality-grouped sampler).
# NUM_DEVICES: ranks over 'data' (1: one card). Extra arguments go to the CLI.
python -m tokenpacker_tpu_torch.train.train \
    --stage finetune \
    --version v1 \
    --model-path "${MODEL_PATH:-lmsys/vicuna-7b-v1.5}" \
    --pretrain-mm-mlp-adapter "${ADAPTER:-./checkpoints/tokenpacker-7b-pretrain/checkpoint-final/mm_projector.bin}" \
    --data-path "${DATA_PATH:-./playground/data/llava_v1_5_mix665k.json}" \
    --image-folder "${IMAGE_FOLDER:-./playground/data}" \
    --image-aspect-ratio pad \
    --scale-factor "${SCALE_FACTOR:-2}" \
    --learning-rate 2e-5 \
    --group-by-modality-length \
    --per-device-batch-size 16 \
    --gradient-accumulation-steps "${GRAD_ACCUM:-$(((128 / 16) / ${NUM_DEVICES:-1}))}" \
    --num-train-epochs 1 \
    --model-max-length 2048 \
    --output-dir "${OUTPUT_DIR:-./checkpoints/tokenpacker-7b}" \
    "$@"
