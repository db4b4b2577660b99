#!/bin/bash
# OCRBench (reference scripts/v1_5/eval/ocr_bench.sh shape): per-category
# substring scoring, self-scored by the ocrbench runner.
CKPT="${CKPT:?set CKPT}"
DIR="${DIR:-./playground/data/eval/ocr_bench}"
NAME="${NAME:-tokenpacker-tpu-7b}"
python -m tokenpacker_tpu_torch.eval.benchmarks ocrbench \
    --model-path "$CKPT" \
    --question-file "${OCRBENCH_FILE:-$DIR/OCRBench.json}" \
    --image-folder "${IMAGES:-$DIR/OCRBench_Images}" \
    --answers-file "$DIR/answers/$NAME.jsonl" \
    --batch-size "${BATCH:-16}" --conv-mode vicuna_v1 $EXTRA_ARGS
