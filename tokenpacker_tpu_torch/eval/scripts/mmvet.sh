#!/bin/bash
# MM-Vet (reference scripts/v1_5/eval/mmvet.sh shape): generate + convert to
# the GPT-4-judged results json.
CKPT="${CKPT:?set CKPT}"
DIR="${DIR:-./playground/data/eval/mm-vet}"
NAME="${NAME:-tokenpacker-tpu-7b}"
python -m tokenpacker_tpu_torch.eval.benchmarks vqa \
    --model-path "$CKPT" \
    --question-file "$DIR/llava-mm-vet.jsonl" \
    --image-folder "${IMAGES:-$DIR/images}" \
    --answers-file "$DIR/answers/$NAME.jsonl" \
    --batch-size "${BATCH:-16}" --conv-mode vicuna_v1 $EXTRA_ARGS
mkdir -p "$DIR/results"
python -m tokenpacker_tpu_torch.eval.convert mmvet \
    --src "$DIR/answers/$NAME.jsonl" \
    --dst "$DIR/results/$NAME.json"
