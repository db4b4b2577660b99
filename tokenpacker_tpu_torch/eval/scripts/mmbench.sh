#!/bin/bash
# MMBench dev (reference scripts/v1_5/eval/mmbench.sh shape): tsv + base64
# images + option rotation; produces the upload xlsx-equivalent json and a
# local circular-eval score.
CKPT="${CKPT:?set CKPT}"
SPLIT="${SPLIT:-mmbench_dev_20230712}"
DIR="${DIR:-./playground/data/eval/mmbench}"
NAME="${NAME:-tokenpacker-tpu-7b}"
python -m tokenpacker_tpu_torch.eval.benchmarks mmbench \
    --model-path "$CKPT" \
    --question-file "$DIR/$SPLIT.tsv" \
    --answers-file "$DIR/answers/$SPLIT/$NAME.jsonl" \
    --single-pred-prompt \
    --batch-size "${BATCH:-16}" --conv-mode vicuna_v1 $EXTRA_ARGS
mkdir -p "$DIR/answers_upload/$SPLIT"
python -m tokenpacker_tpu_torch.eval.convert mmbench \
    --annotation-file "$DIR/$SPLIT.tsv" \
    --result-file "$DIR/answers/$SPLIT/$NAME.jsonl" \
    --dst "$DIR/answers_upload/$SPLIT/$NAME.xlsx"
python -m tokenpacker_tpu_torch.eval.score_cli mmbench \
    --annotation-file "$DIR/$SPLIT.tsv" \
    --result-file "$DIR/answers/$SPLIT/$NAME.jsonl"
