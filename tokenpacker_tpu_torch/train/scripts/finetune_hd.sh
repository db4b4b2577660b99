#!/bin/bash
# Stage 2 HD (reference scripts/v1_5/finetune_hd.sh): slice aspect, patch_num 9.
# NUM_DEVICES: ranks over 'data' (1: one card). Extra arguments go to the CLI.
python -m tokenpacker_tpu_torch.train.train \
    --stage finetune --version v1 \
    --model-path "${MODEL_PATH:-lmsys/vicuna-7b-v1.5}" \
    --pretrain-mm-mlp-adapter "${ADAPTER:?set ADAPTER}" \
    --data-path "${DATA_PATH:?set DATA_PATH}" \
    --image-folder "${IMAGE_FOLDER:-./playground/data}" \
    --image-aspect-ratio slice --patch-num "${PATCH_NUM:-9}" \
    --scale-factor "${SCALE_FACTOR:-2}" \
    --learning-rate 2e-5 --group-by-modality-length \
    --per-device-batch-size 8 --model-max-length 2048 \
    --gradient-accumulation-steps "${GRAD_ACCUM:-$(((128 / 8) / ${NUM_DEVICES:-1}))}" \
    --output-dir "${OUTPUT_DIR:-./checkpoints/tokenpacker-hd-7b}" \
    "$@"
