#!/bin/bash
# GQA eval (reference scripts/v1_5/eval/gqa.sh shape): chunked fan-out +
# cat merge. On one card a single batched process is usually faster:
# set CHUNKS=1.
CKPT="${CKPT:?set CKPT}"
SPLIT="llava_gqa_testdev_balanced"
GQADIR="${GQADIR:-./playground/data/eval/gqa}"
CHUNKS="${CHUNKS:-1}"
for IDX in $(seq 0 $((CHUNKS-1))); do
  python -m tokenpacker_tpu_torch.eval.benchmarks vqa \
      --model-path "$CKPT" \
      --question-file "$GQADIR/$SPLIT.jsonl" \
      --image-folder "$GQADIR/images" \
      --answers-file "$GQADIR/answers/$SPLIT/chunk$IDX.jsonl" \
      --num-chunks "$CHUNKS" --chunk-idx "$IDX" \
      --batch-size 16 --conv-mode vicuna_v1 $EXTRA_ARGS &
done
wait
cat "$GQADIR/answers/$SPLIT"/chunk*.jsonl > "$GQADIR/answers/$SPLIT/merge.jsonl"
python -m tokenpacker_tpu_torch.eval.convert gqa \
    --src "$GQADIR/answers/$SPLIT/merge.jsonl" \
    --dst "$GQADIR/testdev_balanced_predictions.json"
