"""Model constants of the port (the values of `tokenpacker_tpu/constants.py`
that the serving path uses; a test holds them equal)."""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200

# CLIP ViT-L/14-336 geometry
CLIP_IMAGE_SIZE = 336
CLIP_PATCH_SIZE = 14
CLIP_RAW_GRID = CLIP_IMAGE_SIZE // CLIP_PATCH_SIZE  # 24

# CLIP preprocessing statistics (openai/clip-vit-large-patch14-336)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
