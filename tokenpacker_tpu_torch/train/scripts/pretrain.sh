#!/bin/bash
# Stage 1 — projector alignment (reference scripts/v1_5/pretrain.sh recipe:
# lr 1e-3, global batch 256, 1 epoch, cosine+3% warmup, plain template).
# NUM_DEVICES is the number of ranks over 'data' (1: one card); the
# accumulation makes up the rest of the global batch. Extra arguments go
# to the CLI (e.g. --device cpu, --tp 2 under torchrun).
python -m tokenpacker_tpu_torch.train.train \
    --stage pretrain \
    --version plain \
    --model-path "${MODEL_PATH:-lmsys/vicuna-7b-v1.5}" \
    --data-path "${DATA_PATH:-./playground/data/blip_laion_cc_sbu_558k.json}" \
    --image-folder "${IMAGE_FOLDER:-./playground/data/images}" \
    --scale-factor "${SCALE_FACTOR:-2}" \
    --learning-rate 1e-3 \
    --per-device-batch-size 32 \
    --gradient-accumulation-steps "${GRAD_ACCUM:-$(((256 / 32) / ${NUM_DEVICES:-1}))}" \
    --num-train-epochs 1 \
    --model-max-length 2048 \
    --save-steps 500 \
    --output-dir "${OUTPUT_DIR:-./checkpoints/tokenpacker-7b-pretrain}" \
    "$@"
