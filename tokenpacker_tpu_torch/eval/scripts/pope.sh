#!/bin/bash
# POPE (reference scripts/v1_5/eval/pope.sh shape): yes/no hallucination
# probe over COCO, scored with TP/FP/F1 per split.
CKPT="${CKPT:?set CKPT}"
DIR="${DIR:-./playground/data/eval/pope}"
NAME="${NAME:-tokenpacker-tpu-7b}"
python -m tokenpacker_tpu_torch.eval.benchmarks vqa \
    --model-path "$CKPT" \
    --question-file "$DIR/llava_pope_test.jsonl" \
    --image-folder "${IMAGES:-$DIR/val2014}" \
    --answers-file "$DIR/answers/$NAME.jsonl" \
    --batch-size "${BATCH:-16}" --conv-mode vicuna_v1 $EXTRA_ARGS
python -m tokenpacker_tpu_torch.eval.score_cli pope \
    --annotation-dir "$DIR/coco" \
    --question-file "$DIR/llava_pope_test.jsonl" \
    --result-file "$DIR/answers/$NAME.jsonl"
