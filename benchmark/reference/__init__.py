"""The plain reference: LLaVA-MPT with the TokenPacker projector, written from
the published models in plain float32 `torch` (TF32 off), with no kernel,
cache or batching of the program. It reads the benchmark's weights and
inputs and imports nothing of the program, of JAX or of the JAX package.

- `clip`: CLIP ViT-L/14-336 as LLaVA reads it (hidden states -2 and the
  multi-level layers 12, 16, 22, 23);
- `projector`: TokenPacker's point-to-region cross-attention;
- `splice`: where text and visual tokens land (single view, and
  TokenPacker-HD's slice order);
- `mpt`: MPT-7B's decoder (ALiBi, LayerNorm without bias, exact GELU, tied
  logits);
- `image`: LLaVA's pad-mode preprocessing of a picture file;
- `train`: stage 1's loss and its AdamW updates;
- `precision`: float32 products, or the float8 control.
"""

import torch


def exact_float32():
    """Float32 products stay float32 on the card: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
