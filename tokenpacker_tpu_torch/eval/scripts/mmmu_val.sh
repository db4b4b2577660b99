#!/bin/bash
# MMMU validation (reference scripts/v1_5/eval/mmmu_val.sh shape): chunked
# fan-out over the HF dataset, json-dict merge, self-scored.
CKPT="${CKPT:?set CKPT}"
DATA="${DATA:-MMMU/MMMU}"
DIR="${DIR:-./playground/data/eval/MMMU}"
NAME="${NAME:-tokenpacker-tpu-7b}"
CHUNKS="${CHUNKS:-1}"
mkdir -p "$DIR/answers/$NAME"
for IDX in $(seq 0 $((CHUNKS-1))); do
  python -m tokenpacker_tpu_torch.eval.mmmu run \
      --model-path "$CKPT" \
      --data-path "$DATA" \
      --split validation \
      --num-chunks "$CHUNKS" --chunk-idx "$IDX" \
      --batch-size "${BATCH:-8}" --conv-mode vicuna_v1 $EXTRA_ARGS \
      --output "$DIR/answers/$NAME/chunk$IDX.json" &
done
wait
python - "$DIR/answers/$NAME" <<'PY'
import glob, json, sys
merged = {}
for f in sorted(glob.glob(sys.argv[1] + "/chunk*.json")):
    merged.update(json.load(open(f)))
json.dump(merged, open(sys.argv[1] + "/merge.json", "w"), indent=2)
PY
python -m tokenpacker_tpu_torch.eval.mmmu score \
    --answers "$DIR/answers/$NAME/merge.json" \
    --answer-dict "${ANSWER_DICT:-$DIR/answer_dict_val.json}"
