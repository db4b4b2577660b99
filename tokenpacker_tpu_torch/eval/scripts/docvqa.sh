#!/bin/bash
# DocVQA test (reference scripts/v1_5/eval/docvqa.sh shape): the HD flagship
# bench — slice-mode tiling, chunked fan-out + merge + submission convert.
CKPT="${CKPT:?set CKPT}"
DIR="${DIR:-./playground/data/eval/docvqa}"
NAME="${NAME:-tokenpacker-tpu-7b}"
CHUNKS="${CHUNKS:-1}"
for IDX in $(seq 0 $((CHUNKS-1))); do
  python -m tokenpacker_tpu_torch.eval.benchmarks docvqa \
      --model-path "$CKPT" \
      --question-file "$DIR/data/test_v1.0.json" \
      --image-folder "${IMAGES:-$DIR/images}" \
      --answers-file "$DIR/answers/$NAME/chunk$IDX.jsonl" \
      --num-chunks "$CHUNKS" --chunk-idx "$IDX" \
      --image-aspect-ratio slice \
      --batch-size "${BATCH:-8}" --conv-mode vicuna_v1 $EXTRA_ARGS &
done
wait
cat "$DIR/answers/$NAME"/chunk*.jsonl > "$DIR/answers/$NAME/merge.jsonl"
python -m tokenpacker_tpu_torch.eval.convert docvqa \
    --src "$DIR/answers/$NAME/merge.jsonl" \
    --dst "$DIR/answers/$NAME/submit.json"
