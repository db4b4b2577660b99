#!/bin/bash
# TextVQA val (reference scripts/v1_5/eval/textvqa.sh shape): OCR-token
# prompts, VQA soft-accuracy scoring.
CKPT="${CKPT:?set CKPT}"
DIR="${DIR:-./playground/data/eval/textvqa}"
NAME="${NAME:-tokenpacker-tpu-7b}"
python -m tokenpacker_tpu_torch.eval.benchmarks vqa \
    --model-path "$CKPT" \
    --question-file "$DIR/llava_textvqa_val_v051_ocr.jsonl" \
    --image-folder "${IMAGES:-$DIR/train_images}" \
    --answers-file "$DIR/answers/$NAME.jsonl" \
    --batch-size "${BATCH:-16}" --conv-mode vicuna_v1 $EXTRA_ARGS
python -m tokenpacker_tpu_torch.eval.score_cli textvqa \
    --annotation-file "$DIR/TextVQA_0.5.1_val.json" \
    --result-file "$DIR/answers/$NAME.jsonl"
