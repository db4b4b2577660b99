#!/bin/bash
# VQAv2 test-dev (reference scripts/v1_5/eval/vqav2.sh shape): chunked
# fan-out + cat merge + EvalAI submission convert. On one card a single
# batched process is usually faster: CHUNKS=1 (default).
CKPT="${CKPT:?set CKPT}"
SPLIT="${SPLIT:-llava_vqav2_mscoco_test-dev2015}"
DIR="${DIR:-./playground/data/eval/vqav2}"
CHUNKS="${CHUNKS:-1}"
for IDX in $(seq 0 $((CHUNKS-1))); do
  python -m tokenpacker_tpu_torch.eval.benchmarks vqa \
      --model-path "$CKPT" \
      --question-file "$DIR/$SPLIT.jsonl" \
      --image-folder "${IMAGES:-$DIR/test2015}" \
      --answers-file "$DIR/answers/$SPLIT/chunk$IDX.jsonl" \
      --num-chunks "$CHUNKS" --chunk-idx "$IDX" \
      --batch-size "${BATCH:-16}" --conv-mode vicuna_v1 $EXTRA_ARGS &
done
wait
cat "$DIR/answers/$SPLIT"/chunk*.jsonl > "$DIR/answers/$SPLIT/merge.jsonl"
python -m tokenpacker_tpu_torch.eval.convert vqav2 \
    --src "$DIR/answers/$SPLIT/merge.jsonl" \
    --test-split "$DIR/$SPLIT.jsonl" \
    --dst "$DIR/answers_upload/$SPLIT.json"
