#!/bin/bash
# MME (reference scripts/v1_5/eval/mme.sh shape): generate + per-category
# answer files for the official eval_tool, + accuracy/acc+ via our scorer.
CKPT="${CKPT:?set CKPT}"
DIR="${DIR:-./playground/data/eval/MME}"
NAME="${NAME:-tokenpacker-tpu-7b}"
python -m tokenpacker_tpu_torch.eval.benchmarks vqa \
    --model-path "$CKPT" \
    --question-file "$DIR/llava_mme.jsonl" \
    --image-folder "$DIR/MME_Benchmark_release_version" \
    --answers-file "$DIR/answers/$NAME.jsonl" \
    --batch-size "${BATCH:-16}" --conv-mode vicuna_v1 $EXTRA_ARGS
python -m tokenpacker_tpu_torch.eval.convert mme \
    --src "$DIR/answers/$NAME.jsonl" \
    --annotation-dir "$DIR/MME_Benchmark_release_version" \
    --dst-dir "$DIR/eval_tool/answers/$NAME"
