"""The training data path of the PyTorch port against the JAX package, on
the CPU: conversation templates, `preprocess`, `SupervisedDataset`,
`collate`, the length-grouped samplers, image loading and the
`mm_projector.bin` export. All of it is host-side numpy / PIL, so every
result must be equal, byte for byte or array for array.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from tokenpacker_tpu.data import conversation as jax_conv
from tokenpacker_tpu.data import dataset as jax_dataset
from tokenpacker_tpu.data import preprocess as jax_pre
from tokenpacker_tpu.data.mm_tokenize import tokenizer_image_token as jax_tokenize
from tokenpacker_tpu.image import native as jax_native
from tokenpacker_tpu.image.io import load_image as jax_load_image
from tokenpacker_tpu.io import hf_import as jax_hf
from tokenpacker_tpu_torch.config import tiny_vlm_config
from tokenpacker_tpu_torch.data import conversation, dataset, preprocess
from tokenpacker_tpu_torch.data.mm_tokenize import tokenizer_image_token
from tokenpacker_tpu_torch.image.io import load_image
from tokenpacker_tpu_torch.io import hf_import
from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_from_jax, params_to_jax
from tests.test_trainer import Tok

TURNS = [
    [("human", "hi <image> there")],
    [("human", "<image>\nwhat is this"), ("gpt", "a cat")],
    [("human", "q1"), ("gpt", "a1"), ("human", "q2"), ("gpt", "a2")],
    [("human", "q1"), ("gpt", None)],
]


def _render(module, name, turns):
    conv = module.conv_templates[name].copy()
    for role, text in turns:
        conv.append_message(conv.roles[0 if role == "human" else 1], text)
    try:
        return conv.get_prompt()
    except Exception as e:  # the plain template cannot render two turns
        return type(e).__name__


def test_template_registry_equal_jax():
    assert list(conversation.conv_templates) == list(jax_conv.conv_templates)
    for name, jax_tpl in jax_conv.conv_templates.items():
        tpl = conversation.conv_templates[name]
        for field in ("system", "roles", "messages", "offset", "sep", "sep2", "version"):
            assert getattr(tpl, field) == getattr(jax_tpl, field), (name, field)
        assert tpl.sep_style.name == jax_tpl.sep_style.name, name


@pytest.mark.parametrize("name", list(jax_conv.conv_templates))
@pytest.mark.parametrize("turns", range(len(TURNS)))
def test_get_prompt_byte_equal_jax(name, turns):
    assert _render(conversation, name, TURNS[turns]) == _render(jax_conv, name, TURNS[turns])


def test_image_turn_normalized_like_jax():
    for name in ("v1", "v0_mmtag", "llava_llama_2"):
        convs = []
        for module in (conversation, jax_conv):
            conv = module.conv_templates[name].copy()
            conv.append_message(conv.roles[0], ("look <image> here", None, "Default"))
            conv.append_message(conv.roles[1], None)
            convs.append(conv.get_prompt())
        assert convs[0] == convs[1], name


@pytest.mark.parametrize("prompt", ["<image>\ndescribe", "a <image> b <image> c", "no image",
                                    "<image>"])
def test_tokenizer_image_token_equal_jax(prompt):
    got = tokenizer_image_token(prompt, Tok(), return_array=True)
    want = jax_tokenize(prompt, Tok(), return_array=True)
    np.testing.assert_array_equal(got, want)


SOURCES = {
    "plain": [[{"from": "human", "value": "<image>\nDescribe."},
               {"from": "gpt", "value": "a red cat"}]],
    "v1": [[{"from": "human", "value": "<image>\nwhat is this"}, {"from": "gpt", "value": "a cat"},
            {"from": "human", "value": "what color"}, {"from": "gpt", "value": "red"}]],
    "llama_2": [[{"from": "human", "value": "<image>\nwhat is it"},
                 {"from": "gpt", "value": "a dog"}]],
    "mpt": [[{"from": "human", "value": "<image>\nname it"}, {"from": "gpt", "value": "a cup"},
             {"from": "human", "value": "more"}, {"from": "gpt", "value": "blue"}]],
}


@pytest.mark.parametrize("version,has_image", [(v, True) for v in SOURCES]
                         + [(v, False) for v in SOURCES if v != "plain"])
def test_preprocess_ids_and_labels_equal_jax(version, has_image):
    """The `tests/test_preprocess.py` word tokenizer, a fresh one per side.
    It adds a BOS to every chunk, so the mpt round arithmetic mismatches
    and masks the whole target, on both sides alike. (The plain template
    requires an image turn.)"""
    outs = []
    for module in (preprocess, jax_pre):
        src = json.loads(json.dumps(SOURCES[version]))
        if has_image:
            src = module.preprocess_multimodal(src, version=version)
        else:
            for turn in src[0]:
                turn["value"] = turn["value"].replace("<image>\n", "")
        outs.append(module.preprocess(src, Tok(), has_image=has_image, version=version))
    for key in ("input_ids", "labels"):
        assert len(outs[0][key]) == len(outs[1][key]) == 1
        np.testing.assert_array_equal(outs[0][key][0], outs[1][key][0], err_msg=key)
        assert outs[0][key][0].dtype == outs[1][key][0].dtype == np.int64
    assert (outs[0]["labels"][0] != -100).any() == (version != "mpt")


def test_preprocess_multimodal_equal_jax():
    for version in ("v1", "v1_mmtag"):
        for start_end in (False, True):
            src = [[{"from": "human", "value": "what <image> is it"}, {"from": "gpt", "value": "x"}]]
            got = preprocess.preprocess_multimodal(json.loads(json.dumps(src)), True, start_end, version)
            want = jax_pre.preprocess_multimodal(json.loads(json.dumps(src)), True, start_end, version)
            assert got == want


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The tiny dataset of tests/test_trainer.py (8 image records of 40x52,
    2 text-only) plus one JPEG record."""
    root = tmp_path_factory.mktemp("data")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    recs = []
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, (40, 52, 3), dtype=np.uint8)).save(img_dir / f"im{i}.png")
        recs.append({"id": str(i), "image": f"im{i}.png", "conversations": [
            {"from": "human", "value": "<image>\nwhat is this"},
            {"from": "gpt", "value": f"object {i}"}]})
    for i in range(2):
        recs.append({"id": f"t{i}", "conversations": [
            {"from": "human", "value": "hello"}, {"from": "gpt", "value": "hi there " * (i + 1)}]})
    Image.fromarray(rng.integers(0, 255, (33, 47, 3), dtype=np.uint8)).save(img_dir / "im8.jpg",
                                                                            quality=90)
    recs.append({"id": "8", "image": "im8.jpg", "conversations": [
        {"from": "human", "value": "<image>\nand this"}, {"from": "gpt", "value": "a jpeg"}]})
    path = root / "data.json"
    path.write_text(json.dumps(recs))
    return str(path), str(img_dir)


def test_load_image_equal_jax(records):
    """PIL decodes on both sides; where the JAX package has its native
    libjpeg built it decodes JPEGs there, within tests/test_native.py's
    mean difference of 1 level (IDCT build variants)."""
    _, img_dir = records
    for name in ("im0.png", "im8.jpg"):
        got, want = load_image(f"{img_dir}/{name}"), jax_load_image(f"{img_dir}/{name}")
        assert got.mode == want.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(Image.open(f"{img_dir}/{name}").convert("RGB")))
        diff = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
        assert diff.mean() < 1.0 if name.endswith(".jpg") else not diff.any()


@pytest.mark.parametrize("version,aspect", [("v1", "pad"), ("plain", "pad"), ("v1", "slice")])
def test_dataset_items_equal_jax(records, version, aspect):
    path, img_dir = records
    ds = dataset.SupervisedDataset(path, Tok(), image_folder=img_dir, version=version,
                                   image_aspect_ratio=aspect)
    jds = jax_dataset.SupervisedDataset(path, Tok(), image_folder=img_dir, version=version,
                                        image_aspect_ratio=aspect)
    assert len(ds) == len(jds) == 11
    assert ds.lengths == jds.lengths and ds.modality_lengths == jds.modality_lengths
    idx = [i for i in range(11) if version != "plain" or "image" in ds.records[i]]
    if jax_native.jpeg_available():  # the JAX side would decode the JPEG natively
        idx = [i for i in idx if not ds.records[i].get("image", "").endswith(".jpg")]
    for i in idx:
        got, want = ds[i], jds[i]
        assert sorted(got) == sorted(want), i
        for key in want:
            if isinstance(want[key], np.ndarray):
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{i} {key}")
            else:
                assert got[key] == want[key], (i, key)
    for pad_to in (None, 2048):
        items = [ds[i] for i in idx[:4]] + [ds[idx[-1]]]
        jitems = [jds[i] for i in idx[:4]] + [jds[idx[-1]]]
        got = dataset.collate(items, 144, 29892, 13, 0, pad_to=pad_to)
        want = jax_dataset.collate(jitems, 144, 29892, 13, 0, pad_to=pad_to)
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            if isinstance(w, np.ndarray):
                assert got[key].dtype == w.dtype, key
                np.testing.assert_array_equal(got[key], w, err_msg=key)
            else:
                assert got[key] == w, key


@pytest.mark.parametrize("group_by_modality", [False, True])
@pytest.mark.parametrize("batch,world,seed", [(4, 1, 0), (2, 3, 5), (8, 2, 42)])
def test_sampler_orders_equal_jax(group_by_modality, batch, world, seed):
    rng = np.random.default_rng(seed)
    lengths = (rng.integers(1, 300, 61) * rng.choice([-1, 1], 61)).tolist()
    if not group_by_modality:
        lengths = [abs(x) for x in lengths]
    got = list(dataset.LengthGroupedSampler(batch, world, lengths, group_by_modality, seed))
    want = list(jax_dataset.LengthGroupedSampler(batch, world, lengths, group_by_modality, seed))
    assert got == want and sorted(got) == list(range(61))


def test_export_tokenpacker_equal_jax_and_round_trips():
    cfg = tiny_vlm_config()
    params = init_vlm_on_device(cfg, seed=4, device="cpu", dtype=torch.float32)
    params["projector"]["q_proj"]["bias"] = None  # the JAX tree's layout
    tree = params_to_jax({"projector": params["projector"]})["projector"]
    got, want = hf_import.export_tokenpacker(params["projector"]), jax_hf.export_tokenpacker(tree)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    sd = {f"model.mm_projector.{k}": torch.from_numpy(v) for k, v in got.items()}
    back = hf_import.import_tokenpacker(hf_import.strip_prefix(sd, "model.mm_projector."),
                                        cfg.projector)
    want_tree = params_from_jax({"projector": jax_hf.import_tokenpacker(
        jax_hf.strip_prefix(sd, "model.mm_projector."), cfg.projector)}, cfg)["projector"]
    flat_b, flat_w = params_to_jax(back), params_to_jax(want_tree)

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif b is None:
            assert a is None, path
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)

    walk(flat_b, flat_w)
    walk(flat_b, params_to_jax(params["projector"]))
