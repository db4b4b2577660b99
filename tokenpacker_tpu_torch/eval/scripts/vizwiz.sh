#!/bin/bash
# VizWiz test (reference scripts/v1_5/eval/vizwiz.sh shape): generate +
# submission-format convert.
CKPT="${CKPT:?set CKPT}"
DIR="${DIR:-./playground/data/eval/vizwiz}"
NAME="${NAME:-tokenpacker-tpu-7b}"
python -m tokenpacker_tpu_torch.eval.benchmarks vqa \
    --model-path "$CKPT" \
    --question-file "$DIR/llava_test.jsonl" \
    --image-folder "${IMAGES:-$DIR/test}" \
    --answers-file "$DIR/answers/$NAME.jsonl" \
    --batch-size "${BATCH:-16}" --conv-mode vicuna_v1 $EXTRA_ARGS
python -m tokenpacker_tpu_torch.eval.convert vizwiz \
    --src "$DIR/answers/$NAME.jsonl" \
    --annotation-file "$DIR/llava_test.jsonl" \
    --dst "$DIR/answers_upload/$NAME.json"
