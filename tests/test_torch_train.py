"""The training path of the PyTorch port against the JAX package, on the
CPU at the tiny geometry in fp32: `vlm_loss` and its gradients, the
remat modes, the optimizer (both stages, `mm_projector_lr`, clipping,
gradient accumulation against `optax.MultiSteps`), the schedule, and
`Trainer.train()` with its checkpoints.

Weights are made once by the port from a seed and handed to JAX as numpy.
The JAX model attends through its masked SDPA on the CPU, the port
through K2's causal path; pad rows differ between the two, but their
labels are IGNORE_INDEX, so loss and gradients agree. Tolerances:
- loss: 1e-5 relative (fp32, sums in another order);
- gradients: 1e-4 relative plus 1e-5 of the leaf's largest magnitude
  (fp32 chains through the tower-free backward of 2 layers);
- parameters after Adam steps: 1e-4 relative plus 5e-5 absolute, 5% of
  the peak lr of 1e-3. Adam divides by the root of the second moment, so
  an element whose gradient is near rounding noise moves by a share of
  lr that the rounding decides (one element of 16384 moved 1.2e-5 apart
  in the accumulation case).
"""

import dataclasses
import json
import os

import numpy as np
import optax
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from tokenpacker_tpu.data.dataset import SupervisedDataset as JaxDataset
from tokenpacker_tpu.models.vlm import vlm_loss as jax_vlm_loss
from tokenpacker_tpu.train import step as jax_step
from tokenpacker_tpu.train.trainer import RunConfig as JaxRunConfig
from tokenpacker_tpu.train.trainer import Trainer as JaxTrainer
from tokenpacker_tpu_torch.config import tiny_vlm_config
from tokenpacker_tpu_torch.data.dataset import SupervisedDataset
from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_from_jax, params_to_jax
from tokenpacker_tpu_torch.models.splice import build_splice_plan
from tokenpacker_tpu_torch.models.vlm import vlm_loss
from tokenpacker_tpu_torch.train.step import (
    TrainConfig,
    leaves_with_paths,
    make_optimizer,
    make_train_step,
    warmup_cosine_decay,
)
from tokenpacker_tpu_torch.train.trainer import RunConfig, Trainer
from tests.test_trainer import Tok

LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)


def _batch(cfg, seed, n=2):
    """A spliced batch as numpy (JAX's keys) and as port tensors."""
    rng = np.random.default_rng(seed)
    ids, labels = [], []
    for i in range(n):
        text = rng.integers(3, cfg.lm.vocab_size, 5 + 2 * i)
        ids.append(np.concatenate([[1, 5, IMAGE_TOKEN_INDEX], text]).astype(np.int64))
        labels.append(np.concatenate([[IGNORE_INDEX] * 3, text]).astype(np.int64))
    plan = build_splice_plan(ids, [[(1, 1)]] * n, cfg.tokens_per_view, labels=labels, pad_to=24)
    s = cfg.vision.image_size
    np_batch = {
        "images": rng.standard_normal((n, s, s, 3)).astype(np.float32),
        "token_ids": plan.token_ids, "is_image": plan.is_image, "image_slot": plan.image_slot,
        "positions": np.broadcast_to(np.arange(24), (n, 24)).astype(np.int32),
        "key_valid": plan.attn_mask, "labels": plan.labels,
    }
    port = {k: torch.from_numpy(np.array(v)) for k, v in np_batch.items() if k != "key_valid"}
    for k in ("token_ids", "image_slot", "positions", "labels"):
        port[k] = port[k].long()
    return {k: jnp.asarray(v) for k, v in np_batch.items()}, port


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_vlm_config()
    tree = params_to_jax(init_vlm_on_device(cfg, seed=0, device="cpu", dtype=torch.float32))
    cfg_j = jax_tiny_config()
    vag = jax.jit(jax.value_and_grad(lambda p, b: jax_vlm_loss(p, cfg_j, b), has_aux=True))
    return cfg_j, cfg, tree, [_batch(cfg, s) for s in (0, 1)], vag


def _fresh(tree, cfg):
    return params_from_jax(tree, cfg)


def _grad_tree(params, leaves, grads):
    by_id = {id(p): g for p, g in zip(leaves, grads)}

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if node is None:
            return None
        return by_id.get(id(node), torch.zeros_like(node))

    return params_to_jax(walk(params))


def _port_loss_and_grads(cfg, params, batch, remat=""):
    leaves = [p for path, p in leaves_with_paths(params) if path[0] != "vision"]
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = vlm_loss(params, cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), metrics, _grad_tree(params, leaves, grads)


def _assert_tree_close(got, want, rtol=1e-4, rel_atol=1e-5, path=""):
    if isinstance(want, dict):
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, rel_atol, f"{path}/{k}")
    elif want is not None:
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rel_atol * float(np.abs(want).max()) + 1e-12, err_msg=path)


def test_vlm_loss_and_grads_match_jax(setup):
    cfg_j, cfg, tree, batches, vag = setup
    (want_loss, want_m), want_g = vag(tree, batches[0][0])
    loss, metrics, grads = _port_loss_and_grads(cfg, _fresh(tree, cfg), batches[0][1])
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    assert int(metrics["n_tokens"]) == int(want_m["n_tokens"])
    for part in ("projector", "lm"):
        _assert_tree_close(grads[part], want_g[part], path=part)
    assert any(np.abs(x).max() > 0 for x in jax.tree.leaves(grads["lm"]))


@pytest.mark.parametrize("remat", ["full", "dots", "dots:1", "dots:0", "dots:99"])
def test_remat_modes_equal_no_remat(setup, remat):
    """As the JAX package's test_remat_matches_no_remat: recomputation
    changes neither the loss nor the gradients."""
    cfg_j, cfg, tree, batches, vag = setup
    l0, _, g0 = _port_loss_and_grads(cfg, _fresh(tree, cfg), batches[1][1])
    l1, _, g1 = _port_loss_and_grads(cfg, _fresh(tree, cfg), batches[1][1], remat=remat)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g0)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_unknown_remat_mode_raises(setup):
    cfg_j, cfg, tree, batches, vag = setup
    with pytest.raises(ValueError, match="remat"):
        vlm_loss(_fresh(tree, cfg), cfg, batches[0][1], remat="1")


@pytest.mark.parametrize("total,warmup_ratio,lr", [(10, 0.03, 1e-3), (3, 0.03, 2e-5),
                                                   (100, 0.1, 1e-4), (1, 0.5, 1.0)])
def test_schedule_equals_optax(total, warmup_ratio, lr):
    """optax evaluates in float32: equal to 1e-6 of the peak."""
    tcfg = TrainConfig(total_steps=total, warmup_ratio=warmup_ratio)
    want = jax_step._schedule(lr, tcfg)
    got = warmup_cosine_decay(lr, tcfg)
    for count in range(total + 5):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-6 * lr)


OPT_CASES = {
    "pretrain": (TrainConfig(stage="pretrain", learning_rate=1e-3, total_steps=10), [0, 0, 0]),
    "finetune": (TrainConfig(stage="finetune", learning_rate=1e-3, mm_projector_lr=2e-3,
                             weight_decay=0.01, max_grad_norm=0.05, total_steps=10), [0, 1, 0]),
    "accumulate": (TrainConfig(stage="finetune", learning_rate=1e-3, total_steps=10,
                               gradient_accumulation_steps=2), [0, 1, 1, 0]),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_steps_match_optax(setup, case):
    """Micro-steps of `make_train_step` on both sides from the same weights:
    loss and parameters after each. The first update has lr = 0; in the
    accumulation case the parameters move only every second micro-step."""
    cfg_j, cfg, tree, batches, vag = setup
    tcfg, order = OPT_CASES[case]
    jparams = jax.tree.map(jnp.asarray, tree)
    tx = jax_step.make_optimizer(tcfg, jparams)
    jstate = tx.init(jparams)
    jstep = jax_step.make_train_step(cfg_j, tx)
    params = _fresh(tree, cfg)
    opt = make_optimizer(tcfg, params)
    state = opt.init()
    step = make_train_step(cfg, opt)
    before = jax.tree.map(np.copy, params_to_jax(params))  # params_to_jax shares memory
    for i, b in enumerate(order):
        if i == 0:  # grad_norm over the trained groups (ROADMAP R7)
            _, grads = vag(jparams, batches[b][0])
            trained = ["projector"] + (["lm"] if tcfg.stage == "finetune" else [])
            want_norm = float(optax.global_norm({k: grads[k] for k in trained}))
        jparams, jstate, jm = jstep(jparams, jstate, batches[b][0])
        params, state, m = step(params, state, batches[b][1])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        if i == 0:
            np.testing.assert_allclose(float(m["grad_norm"]), want_norm, rtol=1e-4)
        got = params_to_jax(params)
        for part in ("vision", "projector", "lm"):
            for (path, a), w in zip(jax.tree_util.tree_leaves_with_path(got[part]),
                                    jax.tree.leaves(jparams[part])):
                np.testing.assert_allclose(a, np.asarray(w), **PARAM_TOL,
                                           err_msg=f"{case} step {i} {part}{path}")
    moved = {part: any(np.abs(a - b).max() > 0 for a, b in
                       zip(jax.tree.leaves(got[part]), jax.tree.leaves(before[part])))
             for part in ("vision", "projector", "lm")}
    assert moved == {"vision": False, "projector": True, "lm": tcfg.stage == "finetune"}
    assert all(not p.requires_grad for _, p in leaves_with_paths(params["vision"]))


@pytest.fixture
def tiny_data(tmp_path):
    """tests/test_trainer.py's dataset: 8 images of 40x52, 2 text-only."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    records = []
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, (40, 52, 3), dtype=np.uint8)).save(img_dir / f"im{i}.png")
        records.append({"id": str(i), "image": f"im{i}.png", "conversations": [
            {"from": "human", "value": "<image>\nwhat is this"},
            {"from": "gpt", "value": f"object {i}"}]})
    for i in range(2):
        records.append({"id": f"t{i}", "conversations": [
            {"from": "human", "value": "hello"}, {"from": "gpt", "value": "hi there"}]})
    (tmp_path / "data.json").write_text(json.dumps(records))
    return str(tmp_path / "data.json"), str(img_dir)


def _tiny_dataset(base, size):
    class TinyDS(base):
        """Crops the 336 pad-mode view to the tiny tower's input size."""

        def __getitem__(self, i):
            item = super().__getitem__(i)
            if "image" in item:
                item["image"] = item["image"][:, :, :size, :size].copy()
            return item

    return TinyDS


@pytest.mark.parametrize("stage", ["pretrain", "finetune"])
def test_trainer_matches_jax_trainer(setup, tiny_data, tmp_path, stage):
    """3 epochs of 1 batch of 8 (the JAX trainer: 1 per device on the
    8-device CPU mesh) from the same weights; the same order of samples."""
    cfg_j, cfg, tree, _, _ = setup
    data_path, img_dir = tiny_data
    size = cfg.vision.image_size
    version = "plain" if stage == "pretrain" else "v1"
    if stage == "pretrain":  # the plain template takes image records only
        recs = json.loads(open(data_path).read())[:8]
        data_path = str(tmp_path / "images_only.json")
        open(data_path, "w").write(json.dumps(recs))
    tcfg = TrainConfig(stage=stage, learning_rate=1e-3, mm_projector_lr=2e-3)
    common = dict(num_train_epochs=3, save_steps=100, seq_pad_to=64, seed=3)

    jds = _tiny_dataset(JaxDataset, size)(data_path, Tok(), image_folder=img_dir, version=version)
    jt = JaxTrainer(cfg_j, jax_step.TrainConfig(**dataclasses.asdict(tcfg)),
                    JaxRunConfig(output_dir=str(tmp_path / "jax"), per_device_batch_size=1,
                                 **common), jax.tree.map(jnp.asarray, tree), jds, Tok())
    want = jax.device_get(jt.train())

    ds = _tiny_dataset(SupervisedDataset, size)(data_path, Tok(), image_folder=img_dir,
                                                 version=version)
    out = tmp_path / "port"
    rcfg = RunConfig(output_dir=str(out), per_device_batch_size=8, **common)
    trainer = Trainer(cfg, tcfg, rcfg, _fresh(tree, cfg), ds, Tok(), device="cpu")
    got = params_to_jax(trainer.train())
    assert [r["step"] for r in trainer.history] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    for part in ("vision", "projector", "lm"):
        for (path, a), w in zip(jax.tree_util.tree_leaves_with_path(got[part]),
                                jax.tree.leaves(want[part])):
            np.testing.assert_allclose(a, np.asarray(w), **PARAM_TOL, err_msg=f"{part}{path}")

    ckpt = out / "checkpoint-3"
    if stage == "pretrain":
        sd = torch.load(ckpt / "mm_projector.bin", weights_only=True)
        jsd = torch.load(tmp_path / "jax" / "checkpoint-3" / "mm_projector.bin",
                         weights_only=True)
        assert list(sd) == list(jsd)
        assert all(k.startswith("model.mm_projector.") for k in sd)
        for k in jsd:
            np.testing.assert_allclose(sd[k].numpy(), jsd[k].numpy(), **PARAM_TOL, err_msg=k)
    else:
        assert os.path.isfile(ckpt / "state.pt")
        again = Trainer(cfg, tcfg, rcfg, init_vlm_on_device(cfg, 9, "cpu", torch.float32), ds,
                        Tok(), device="cpu")
        opt = make_optimizer(tcfg, again.params)
        step, opt_state = again.try_resume(opt.init())
        assert step == 3 and opt_state["count"] == {"projector": 3, "lm": 3}
        for a, b in zip(jax.tree.leaves(params_to_jax(again.params)), jax.tree.leaves(got)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(opt_state["mu"]["lm"], trainer.opt_state["mu"]["lm"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_trainer_refuses_what_is_not_ported(setup, tiny_data):
    cfg_j, cfg, tree, _, _ = setup
    data_path, img_dir = tiny_data
    ds = SupervisedDataset(data_path, Tok(), image_folder=img_dir)
    params = _fresh(tree, cfg)
    # a world of one rank has no 'model' axis of 2 (JAX's mesh error);
    # tests/test_torch_parallel.py trains at tp = 2 over 4 ranks
    with pytest.raises(ValueError, match="1 devices not divisible by tp=2"):
        Trainer(cfg, TrainConfig(), RunConfig(tp=2), params, ds, Tok(), device="cpu")
    with pytest.raises(ValueError, match="bits=4"):  # a quantized base needs LoRA
        Trainer(cfg, TrainConfig(), RunConfig(bits=4), params, ds, Tok(), device="cpu")
    with pytest.raises(TypeError, match="LoraConfig"):
        Trainer(cfg, TrainConfig(), RunConfig(lora=object()), params, ds, Tok(), device="cpu")
    with pytest.raises(ValueError, match="is on cpu"):
        Trainer(cfg, TrainConfig(), RunConfig(), params, ds, Tok())  # device="cuda" by default
