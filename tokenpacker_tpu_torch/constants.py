"""Constants of the port (the values of `tokenpacker_tpu/constants.py`
that the serving and training paths use; a test holds them equal)."""

import os as _os

# serving: the controller drops a worker whose last heartbeat is older than
# the expiration; workers beat every interval (reference llava/constants.py:1-2)
CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15

LOGDIR = _os.environ.get("LOGDIR", ".")  # the web UI's conversation and vote logs

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"

# CLIP ViT-L/14-336 geometry
CLIP_IMAGE_SIZE = 336
CLIP_PATCH_SIZE = 14
CLIP_RAW_GRID = CLIP_IMAGE_SIZE // CLIP_PATCH_SIZE  # 24

# CLIP preprocessing statistics (openai/clip-vit-large-patch14-336)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
