"""LoRA and QLoRA training of the PyTorch port against the JAX package, on
the CPU at the tiny geometry: the target rule, `linear`'s QLoRA term, the
loss and its gradients, three optimizer steps, the reference-layout
export, the quantized product's autograd Function, and ROADMAP R14 and
R15 shown beside JAX's behaviour.

Weights are made by the port from a seed; the quantized bases are the
port's `quantize_tree(_4bit)` with min_size 1024 (the tiny kernels are
smaller than the default 2^16), handed to JAX through `params_to_jax`.
Adapters are the port's `init_lora` with b drawn at random (b = 0 would
give a no gradient), carried to JAX with `io/weights.lora_to_jax`,
because JAX's own init is not repeatable (R14).

Tolerances:
- outputs, losses and gradients of fp32 leaves: rtol and atol 2e-5 (fp32,
  the same function with sums in another order);
- gradients of the bf16 adapters over quantized leaves: both sides round
  an fp32 gradient to bf16, so the two may land one bf16 step apart:
  rtol 2^-7 (two steps of 2^-8) plus 2e-5 of the leaf's largest value;
- after three optimizer steps: rtol and atol 1e-4 for fp32 leaves (as
  `test_torch_train.PARAM_TOL`). For bf16 adapters, each leaf's RMS
  difference within STEP_RMS_SHARE of the peak lr and every element
  within STEP_LR_SHARE of it: optax computes the bf16 moments and the
  update in bf16 arithmetic, the port in fp32 and rounds once, and Adam's
  normalized update is about +-lr whatever the size of an element's
  gradient, so an element whose gradient lies at bf16 rounding level may
  move a step of ~lr the other way (the CPU run read at most 4.9e-4 and
  9.8e-4 apart at lr 1e-3, on about 1% of the elements). A wrong lr,
  schedule or moment moves every element by a share of lr.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tokenpacker_tpu.config import LMConfig as JaxLMConfig
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.data.dataset import SupervisedDataset as JaxDataset
from tokenpacker_tpu.models.vlm import vlm_loss as jax_vlm_loss
from tokenpacker_tpu.ops import layers as jax_layers
# imported here, outside any trace: JAX's `linear` imports it lazily, and a
# first import inside a jit would make its module-level codebook a tracer
from tokenpacker_tpu.ops import quantize as _jax_quantize  # noqa: F401
from tokenpacker_tpu.train import lora as jax_lora
from tokenpacker_tpu.train import step as jax_step
from tokenpacker_tpu.train.trainer import RunConfig as JaxRunConfig
from tokenpacker_tpu.train.trainer import Trainer as JaxTrainer
from tokenpacker_tpu_torch.config import LMConfig, tiny_vlm_config
from tokenpacker_tpu_torch.data.dataset import SupervisedDataset
from tokenpacker_tpu_torch.io.weights import (
    init_vlm_on_device,
    lora_from_jax,
    lora_to_jax,
    params_from_jax,
    params_to_jax,
)
from tokenpacker_tpu_torch.ops import layers
from tokenpacker_tpu_torch.ops import quantize as tq
from tokenpacker_tpu_torch.train.lora import (
    LoraConfig,
    adapter_leaves,
    export_lora_state_dict,
    init_lora,
    lora_loss,
    make_lora_optimizer,
    make_lora_train_step,
    targets,
)
from tokenpacker_tpu_torch.train.step import TrainConfig, leaves_with_paths
from tokenpacker_tpu_torch.train.trainer import RunConfig, Trainer
from tests.test_torch_train import _batch, _tiny_dataset, tiny_data  # noqa: F401 (fixture)
from tests.test_trainer import Tok

TOL = dict(rtol=2e-5, atol=2e-5)
LCFG = LoraConfig(r=4, alpha=8)
MIN_SIZE = 1024
MPT_LM = dict(vocab_size=256, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4, model_family="mpt", alibi=True, tie_word_embeddings=True)
FORMS = ("dense", "int8", "nf4", "mpt")
STEP_LR = 1e-3
STEP_LR_SHARE, STEP_RMS_SHARE = 1.5, 0.1


def _quantize(params, form):
    if form == "int8":
        return {**params, "lm": tq.quantize_tree(params["lm"], min_size=MIN_SIZE)}
    if form == "nf4":
        return {**params, "lm": tq.quantize_tree_4bit(params["lm"], "nf4", min_size=MIN_SIZE)}
    return params


def _cfgs(form):
    if form == "mpt":
        return tiny_vlm_config(lm=LMConfig(**MPT_LM)), jax_tiny_config(lm=JaxLMConfig(**MPT_LM))
    return tiny_vlm_config(), jax_tiny_config()


def _setup(form, seed=0):
    """(port cfg, JAX cfg, port params, JAX tree, adapters with b at random)."""
    cfg, cfg_j = _cfgs(form)
    params = _quantize(init_vlm_on_device(cfg, seed=seed, device="cpu", dtype=torch.float32),
                       form)
    lora = init_lora(seed + 1, params, LCFG)
    g = torch.Generator().manual_seed(seed + 2)
    with torch.no_grad():
        for layer in lora["layers"]:
            for sub in layer.values():
                for ab in sub.values():
                    ab["b"].copy_(torch.randn(ab["b"].shape, generator=g) * 0.05)
    tree = jax.tree.map(jnp.asarray, params_to_jax(params))
    return cfg, cfg_j, params, tree, lora


def _jax_lora(lora):
    """The port's adapters as JAX's tree, each in the port's dtype."""
    dtypes = {}
    for layer in lora["layers"][:1]:
        for group, sub in layer.items():
            for name, ab in sub.items():
                dtypes[(group, name)] = ab["a"].dtype
    tree = lora_to_jax(lora)
    for (group, name), dt in dtypes.items():
        node = tree["lm"]["layers"][group][name]["kernel"]
        jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
        for part in ("a", "b"):
            node[part] = jnp.asarray(node[part], jdt)
    return tree


def _close(got, want, bf16: bool, err_msg="", steps=False):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if bf16 and steps:
        rms = float(np.sqrt(np.mean(np.square(got - want))))
        assert rms <= STEP_RMS_SHARE * STEP_LR, f"{err_msg}: RMS difference {rms}"
        np.testing.assert_allclose(got, want, rtol=0, atol=STEP_LR_SHARE * STEP_LR,
                                   err_msg=err_msg)
    elif bf16:
        np.testing.assert_allclose(got, want, rtol=2.0**-7,
                                   atol=2e-5 * float(np.abs(want).max()), err_msg=err_msg)
    else:
        tol = dict(rtol=1e-4, atol=1e-4) if steps else TOL
        np.testing.assert_allclose(got, want, **tol, err_msg=err_msg)


def _compare_lora(got_lora, want_jax, steps=False, what=""):
    for i, layer in enumerate(got_lora["layers"]):
        for group, sub in layer.items():
            for name, ab in sub.items():
                node = want_jax["lm"]["layers"][group][name]["kernel"]
                for part in ("a", "b"):
                    _close(ab[part].detach().float(), np.asarray(node[part], np.float32)[i],
                           ab[part].dtype == torch.bfloat16, f"{what} {i}.{group}.{name}.{part}",
                           steps)


@pytest.mark.parametrize("form", FORMS)
def test_targets_match_jax(form):
    """The adapter tree covers JAX's target set, with JAX's shapes (per
    layer) and dtypes: bf16 over quantized leaves, the leaf's dtype over
    dense ones; on MPT only the ffn's up and down."""
    cfg, cfg_j, params, tree, _ = _setup(form)
    lora = init_lora(0, params, LCFG)
    want = jax.eval_shape(lambda: jax_lora.init_lora(jax.random.PRNGKey(0), tree, LCFG))
    want_set = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        names = [str(getattr(p, "key", p)) for p in path]
        want_set[(names[2], names[3], names[5])] = (tuple(leaf.shape), leaf.dtype)
    got_set = {}
    for layer in lora["layers"]:
        for group, sub in layer.items():
            for name, ab in sub.items():
                for part in ("a", "b"):
                    t = ab[part]
                    jdt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
                    got_set[(group, name, part)] = ((cfg.lm.num_hidden_layers, *t.shape), jdt)
    assert got_set == want_set
    names = {(g, n) for _, g, n in targets(params["lm"])}
    if form == "mpt":
        assert names == {("ffn", "up"), ("ffn", "down")}
    else:
        assert len(names) == 7
    quantized = form in ("int8", "nf4")
    for (group, name, _), (_, dt) in got_set.items():
        leaf = params["lm"]["layers"][0][group][name]["kernel"]
        assert (dt == jnp.bfloat16) == (quantized and isinstance(leaf, dict))


@pytest.mark.parametrize("m", [4, 40])
@pytest.mark.parametrize("form", ["int8", "nf4"])
def test_linear_lora_term_matches_jax(form, m):
    """`linear` over an int8 / nf4 leaf carrying lora_a / lora_b: x @ W_q +
    (x @ a) @ b, as JAX's `linear` (M 4: K6's or the weight-only route;
    M 40: the dequantized product)."""
    rng = np.random.default_rng(m)
    w = torch.from_numpy(rng.standard_normal((128, 96)).astype(np.float32) * 0.05)
    leaf = (dict(zip(("q", "scale"), tq.quantize_int8(w))) if form == "int8"
            else tq.quantize_4bit(w, 64, "nf4"))
    a = torch.from_numpy(rng.standard_normal((128, 8)).astype(np.float32) * 0.1).bfloat16()
    b = torch.from_numpy(rng.standard_normal((8, 96)).astype(np.float32) * 0.1).bfloat16()
    x = rng.standard_normal((2, m // 2, 128)).astype(np.float32)
    p = {"kernel": {**leaf, "lora_a": a, "lora_b": b},
         "bias": torch.from_numpy(rng.standard_normal(96).astype(np.float32))}
    got = layers.linear(p, torch.from_numpy(x))
    jp = {"kernel": {**{k: jnp.asarray(v.numpy()) for k, v in leaf.items()},
                     "lora_a": jnp.asarray(a.float().numpy(), jnp.bfloat16),
                     "lora_b": jnp.asarray(b.float().numpy(), jnp.bfloat16)},
          "bias": jnp.asarray(p["bias"].numpy())}
    want = jax_layers.linear(jp, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    without = layers.linear({"kernel": leaf, "bias": p["bias"]}, torch.from_numpy(x))
    assert (got - without).abs().max() > 1e-3  # the term is there


def _port_grads(cfg, params, lora, batch):
    opt_leaves = adapter_leaves(lora) + [t for _, t in leaves_with_paths(params["projector"])]
    for t in opt_leaves:
        t.requires_grad_(True)
    loss, _ = lora_loss(lora, params, cfg, LCFG, batch)
    grads = dict(zip(map(id, opt_leaves), torch.autograd.grad(loss, opt_leaves)))
    for t in opt_leaves:
        t.requires_grad_(False)
    return loss.item(), grads


@pytest.mark.parametrize("form", FORMS)
def test_loss_and_grads_match_jax(form):
    """`vlm_loss` with the adapters attached, and the gradients of every a,
    b and projector leaf, against `jax.value_and_grad` of JAX's loss_fn
    (`merge_lora_params` then `vlm_loss`) over the same base."""
    cfg, cfg_j, params, tree, lora = _setup(form)
    jbatch, batch = _batch(cfg, 0)
    jl = _jax_lora(lora)

    def loss_fn(trainable, base, b):
        lo, proj = trainable
        p = {**base, "projector": proj}
        return jax_vlm_loss(jax_lora.merge_lora_params(p, lo, LCFG), cfg_j, b)

    (want_loss, _), (want_g, want_pg) = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        (jl, tree["projector"]), tree, jbatch)
    loss, grads = _port_grads(cfg, params, lora, batch)
    np.testing.assert_allclose(loss, float(want_loss), **TOL)
    got_g = {"layers": [{g: {n: {k: grads[id(t)] for k, t in ab.items()} for n, ab in sub.items()}
                         for g, sub in layer.items()} for layer in lora["layers"]]}
    _compare_lora(got_g, jax.device_get(want_g), what="grad")
    pg = {path: grads[id(t)] for path, t in leaves_with_paths(params["projector"])}
    want_flat = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v) for path, v in
                 jax.tree_util.tree_leaves_with_path(want_pg)}
    # atol: 2e-5 of the projector's largest gradient (the key bias and
    # ln_k.bias have an exact gradient of 0: both sides hold rounding noise)
    pmax = max(float(np.abs(w).max()) for w in want_flat.values())
    for path, g in pg.items():
        np.testing.assert_allclose(g.numpy(), want_flat[tuple(map(str, path))], rtol=2e-5,
                                   atol=2e-5 * pmax, err_msg=str(path))
    assert any(float(g.abs().max()) > 0 for g in grads.values())


def _jax_lora_tx(tcfg, total):
    """The JAX trainer's `tx` (`_train_lora`): clip, then optax.adamw with
    its default weight decay 1e-4."""
    warmup = max(min(int(tcfg.warmup_ratio * total), total - 1), 0)
    lr = optax.warmup_cosine_decay_schedule(0.0, tcfg.learning_rate, max(warmup, 1), total + 1)
    return optax.chain(optax.clip_by_global_norm(tcfg.max_grad_norm), optax.adamw(lr))


@pytest.mark.parametrize("form", ["dense", "nf4"])
def test_three_steps_match_jax(form):
    """Three steps of `make_lora_train_step` against `lora_train_step_factory`
    with the trainer's tx, weight_decay 1e-4 (what JAX applies) and a
    clip that binds: loss each step, adapters and projector after each."""
    cfg, cfg_j, params, tree, lora = _setup(form)
    tcfg = TrainConfig(learning_rate=STEP_LR, weight_decay=1e-4, max_grad_norm=0.5,
                       warmup_ratio=0.3)
    total = 3
    opt = make_lora_optimizer(tcfg, LCFG, lora, params["projector"], total)
    state = opt.init()
    step = make_lora_train_step(cfg, LCFG, opt)
    tx = _jax_lora_tx(tcfg, total)
    trainable = (_jax_lora(lora), tree["projector"])
    jstate = tx.init(trainable)
    jstep = jax_lora.lora_train_step_factory(cfg_j, LCFG, tx)
    for i, b in enumerate((0, 1, 0)):
        jbatch, batch = _batch(cfg, b)
        trainable, jstate, jm = jstep(trainable, tree, jstate, jbatch)
        _, state, m = step(lora, params, state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
        _compare_lora(lora, jax.device_get(trainable[0]), steps=True, what=f"step {i}")
        got = params_to_jax(params["projector"])
        for (path, a), w in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree.leaves(trainable[1])):
            np.testing.assert_allclose(a, np.asarray(w), rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {i} projector{path}")


@pytest.mark.parametrize("form", ["dense", "nf4"])
def test_export_equals_jax(form):
    """`export_lora_state_dict` against JAX's on the same adapters: the
    same keys in the same order, equal fp32 values; lora_from_jax gives
    the adapters back."""
    cfg, _, params, _, lora = _setup(form)
    jl = _jax_lora(lora)
    got = export_lora_state_dict(lora, LCFG)
    want = jax_lora.export_lora_state_dict(jax.device_get(jl), LCFG)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = lora_from_jax(jax.tree.map(np.asarray, jl), cfg.lm.num_hidden_layers)
    for x, y in zip(adapter_leaves(back), adapter_leaves(lora)):
        assert torch.equal(x.to(y.dtype), y)


@pytest.mark.parametrize("form", ["int8", "nf4"])
@pytest.mark.parametrize("m", [4, 40])
def test_quantized_product_function(form, m):
    """Under autograd the base product keeps x's gradient, dx equals the
    dequantized product's, and the Function saves the quantized leaf:
    no tensor of the weight's [in, out] shape in a float dtype."""
    rng = np.random.default_rng(m)
    w = torch.from_numpy(rng.standard_normal((128, 96)).astype(np.float32) * 0.05)
    leaf = (dict(zip(("q", "scale"), tq.quantize_int8(w))) if form == "int8"
            else tq.quantize_4bit(w, 64, "nf4"))
    dense = (tq.dequantize_int8(leaf["q"], leaf["scale"], torch.float32) if form == "int8"
             else tq.dequantize_4bit(leaf, torch.float32))
    x = torch.from_numpy(rng.standard_normal((m, 128)).astype(np.float32)).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal((m, 96)).astype(np.float32))
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = layers.linear({"kernel": leaf}, x)
    assert y.grad_fn is not None
    (dx,) = torch.autograd.grad(y, x, dy)
    x2 = x.detach().clone().requires_grad_(True)
    (want,) = torch.autograd.grad(x2 @ dense, x2, dy)
    torch.testing.assert_close(dx, want, **TOL)
    assert not any(dt.is_floating_point and shape == (128, 96) for dt, shape in saved), saved
    assert any(dt in (torch.int8, torch.uint8) for dt, _ in saved)


R14_PATH = "['lm']['layers']['attn']['q']['kernel']"


def test_r14_jax_seed_differs_across_processes_port_does_not(tmp_path):
    """R14: JAX folds `hash(keystr(path)) % 2**31` into the key; Python
    salts str hashes per process, so two processes disagree. The port's
    init_lora gives the same adapters in another process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONHASHSEED"}
    code = f"print(hash({R14_PATH!r}) % 2**31)"
    hashes = {subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, check=True).stdout.strip() for _ in range(3)}
    assert len(hashes) > 1, hashes
    script = (
        "import torch, sys\n"
        "from tokenpacker_tpu_torch.config import tiny_vlm_config\n"
        "from tokenpacker_tpu_torch.io.weights import init_vlm_on_device\n"
        "from tokenpacker_tpu_torch.train.lora import LoraConfig, init_lora, adapter_leaves\n"
        "p = init_vlm_on_device(tiny_vlm_config(), seed=0, device='cpu', dtype=torch.float32)\n"
        "l = init_lora(5, p, LoraConfig(r=4, alpha=8))\n"
        "torch.save(adapter_leaves(l), sys.argv[1])\n"
        "assert 'jax' not in sys.modules\n")
    out = tmp_path / "adapters.pt"
    subprocess.run([sys.executable, "-c", script, str(out)], env={**env, "PYTHONPATH": os.getcwd()},
                   check=True, cwd=os.getcwd())
    here = adapter_leaves(init_lora(5, init_vlm_on_device(tiny_vlm_config(), seed=0,
                                                          device="cpu", dtype=torch.float32),
                                    LoraConfig(r=4, alpha=8)))
    there = torch.load(out, weights_only=True)
    assert len(here) == len(there) == 28
    assert all(torch.equal(a, b) for a, b in zip(here, there))
    assert not torch.equal(here[0], adapter_leaves(init_lora(6, init_vlm_on_device(
        tiny_vlm_config(), seed=0, device="cpu", dtype=torch.float32), LoraConfig(r=4, alpha=8)))[0])


def test_r15_jax_ignores_decay_and_projector_lr_port_applies_them(tiny_data, tmp_path):
    """R15: JAX's `_train_lora` builds `adamw(lr)` with optax's default decay
    and one lr, so weight_decay 0 or 0.1 and mm_projector_lr set or not
    give it the same adapters and projector; the port's Trainer applies
    both, so its results differ (one step of 8 samples over the dense
    base, lr 1e-3)."""
    data_path, img_dir = tiny_data
    cfg, cfg_j = _cfgs("dense")
    tree = params_to_jax(init_vlm_on_device(cfg, seed=0, device="cpu", dtype=torch.float32))
    size = cfg.vision.image_size
    settings = (dict(weight_decay=0.0, mm_projector_lr=None),
                dict(weight_decay=0.1, mm_projector_lr=1e-2))
    jax_out, port_out = [], []
    for i, s in enumerate(settings):
        common = dict(num_train_epochs=1, save_steps=100, seq_pad_to=64, seed=3,
                      lora=LCFG)
        tcfg = TrainConfig(learning_rate=1e-3, **s)
        jds = _tiny_dataset(JaxDataset, size)(data_path, Tok(), image_folder=img_dir)
        jt = JaxTrainer(cfg_j, jax_step.TrainConfig(**dataclasses.asdict(tcfg)),
                        JaxRunConfig(output_dir=str(tmp_path / f"jax{i}"),
                                     per_device_batch_size=1, **common),
                        jax.tree.map(jnp.asarray, tree), jds, Tok())
        jax_out.append(jax.device_get(jt.train()))
        ds = _tiny_dataset(SupervisedDataset, size)(data_path, Tok(), image_folder=img_dir)
        t = Trainer(cfg, tcfg, RunConfig(output_dir=str(tmp_path / f"port{i}"),
                                         per_device_batch_size=8, **common),
                    params_from_jax(tree, cfg), ds, Tok(), device="cpu")
        lo, proj = t.train()
        port_out.append((adapter_leaves(lo), [p.detach().clone() for _, p in
                                              leaves_with_paths(proj)]))
    for a, b in zip(jax.tree.leaves(jax_out[0]), jax.tree.leaves(jax_out[1])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    a_moved = [not torch.equal(x, y) for x, y in zip(port_out[0][0], port_out[1][0])]
    p_moved = [not torch.equal(x, y) for x, y in zip(port_out[0][1], port_out[1][1])]
    assert any(a_moved) and any(p_moved)
