#!/bin/bash
# Stage 1 HD (reference scripts/v1_5/pretrain_hd.sh): slice aspect, patch_num 9.
SCALE_FACTOR="${SCALE_FACTOR:-2}" OUTPUT_DIR="${OUTPUT_DIR:-./checkpoints/tokenpacker-hd-7b-pretrain}" \
exec bash "$(dirname "$0")/pretrain.sh" \
    --image-aspect-ratio slice --patch-num "${PATCH_NUM:-9}" "$@"
