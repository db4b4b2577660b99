"""HD slice mode of the port against the JAX package on the CPU: the grid
choice, the tiler, slice-mode preprocessing, the slice-mode splice plan
(all exactly equal), and tiny-VLM HD greedy generation in fp32 (token ids
equal to the JAX engine's).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from tokenpacker_tpu import generate as jax_generate
from tokenpacker_tpu.config import preset_config as jax_preset_config
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from tokenpacker_tpu.image import hd_tiler as jax_tiler
from tokenpacker_tpu.image import processing as jax_processing
from tokenpacker_tpu.models import splice as jax_splice
from tokenpacker_tpu_torch import generate
from tokenpacker_tpu_torch.config import MODEL_PRESETS, preset_config, tiny_vlm_config
from tokenpacker_tpu_torch.image import hd_tiler, processing
from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_from_jax, params_to_jax
from tokenpacker_tpu_torch.models import splice

SEP, NEWLINE = 7, 8  # stand-in ids of "," and "\n" in the tiny vocabulary


@pytest.mark.parametrize("patch_num", [9, 16, 25])
def test_choose_grid_equals_jax(patch_num):
    sizes = [(h, w) for h in (17, 90, 224, 336, 500, 671, 1008, 1500, 2900)
             for w in (23, 100, 336, 480, 672, 1200, 3000)]
    for h, w in sizes:
        assert hd_tiler.choose_grid(h, w, patch_num) == jax_tiler.choose_grid(h, w, patch_num), (h, w)
    assert hd_tiler.grid_candidates(patch_num) == jax_tiler.grid_candidates(patch_num)
    for hb, wb in hd_tiler.grid_candidates(patch_num):
        assert hd_tiler.num_visual_tokens(hb, wb, 144) == jax_tiler.num_visual_tokens(hb, wb, 144)


@pytest.mark.parametrize("shape,block", [((3, 120, 200), 56), ((3, 300, 90), 56), ((3, 40, 40), 56),
                                         ((3, 700, 500), 336)])
def test_slice_image_equals_jax(shape, block):
    img = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got, hb, wb = hd_tiler.slice_image(img, 9, block)
    want, jhb, jwb = jax_tiler.slice_image(img, 9, block, use_native=False)
    assert (hb, wb) == (jhb, jwb)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(640, 480), (200, 700), (336, 336)])
def test_process_images_slice_equals_jax(size):
    arr = np.random.default_rng(1).integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    imgs = [Image.fromarray(arr), Image.fromarray(arr[: size[1] // 2])]
    got, blocks = processing.process_images(imgs, "slice", 9)
    want, jblocks = jax_processing.process_images(imgs, "slice", 9)
    assert blocks == jblocks
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("blocks,with_labels", [
    ([[(3, 3)], [(1, 2), (2, 1)]], True),
    ([[(1, 1)], [(2, 2)]], False),
    ([[(1, 3), (1, 1)], [(4, 2)]], True),
])
def test_slice_splice_plan_equals_jax(blocks, with_labels):
    ids = [np.array([1, 5] + [IMAGE_TOKEN_INDEX, 9] * len(b) + [10], np.int64) for b in blocks]
    labels = [np.where(x < 0, IGNORE_INDEX, x) for x in ids] if with_labels else None
    args = (ids, blocks, 4, "slice", SEP, NEWLINE, 0)
    got = splice.build_splice_plan(*args, labels=labels, pad_to=256)
    want = jax_splice.build_splice_plan(*args, labels=labels, pad_to=256)
    for name in ("token_ids", "is_image", "image_slot", "attn_mask", "labels", "lengths"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_presets_equal_jax():
    for name in MODEL_PRESETS:
        got, want = preset_config(name), jax_preset_config(name)
        assert (got.scale_factor, got.patch_num, got.image_aspect_ratio) == (
            want.scale_factor, want.patch_num, want.image_aspect_ratio)
        for field in ("hidden_size", "intermediate_size", "num_hidden_layers",
                      "num_attention_heads", "kv_heads", "vocab_size"):
            assert getattr(got.lm, field) == getattr(want.lm, field), (name, field)
    hd = preset_config("sunshine-lwt/TokenPacker-HD-7b-9patch-144token")
    assert (hd.image_aspect_ratio, hd.patch_num, hd.lm.num_hidden_layers) == ("slice", 9, 32)
    with pytest.raises(KeyError):
        preset_config("tokenpacker-30b")


def test_hd_greedy_tokens_equal_jax():
    """Two requests with one HD image each (a 3x2 grid and a single crop
    at the tiny tower's 56-pixel block), slice-mode splice, 8 greedy
    tokens in fp32: token ids equal to the JAX engine's."""
    cfg = tiny_vlm_config(image_aspect_ratio="slice")
    cfg_j = jax_tiny_config(image_aspect_ratio="slice")
    tree = params_to_jax(init_vlm_on_device(cfg, seed=6, device="cpu", dtype=torch.float32))
    params = params_from_jax(tree, cfg)
    rng = np.random.default_rng(2)
    images = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
              for h, w in ((150, 100), (50, 50))]
    crops, blocks = processing.process_images(images, "slice", 9, cfg.vision.image_size)
    assert blocks == [(3, 2), (1, 1)] and crops.shape[0] == 7 + 1
    ids = [np.array([1, 17, IMAGE_TOKEN_INDEX, 40, 41], np.int64),
           np.array([1, IMAGE_TOKEN_INDEX, 30, 31, 32, 33], np.int64)]
    plan = splice.build_splice_plan(ids, [[b] for b in blocks], cfg.tokens_per_view, "slice",
                                    SEP, NEWLINE, pad_to=64)
    batch = {"token_ids": plan.token_ids, "is_image": plan.is_image,
             "image_slot": plan.image_slot, "lengths": plan.lengths,
             "images": crops.transpose(0, 2, 3, 1).copy()}
    want = jax_generate.Generator(tree, cfg_j).generate(batch, max_new_tokens=8, check_every=4)
    got = generate.Generator(params, cfg).generate(batch, max_new_tokens=8, check_every=4)
    assert got.sequences == want.sequences
    assert all(len(s) >= 6 for s in got.sequences), got.sequences
