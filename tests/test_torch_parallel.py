"""The port's parallel code on gloo process groups of the CPU, against the
JAX package on its 8-device CPU mesh.

One module fixture spawns a world of 4 ranks (dp 2 x tp 2) once, through
`tokenpacker_tpu_torch.parallel.dryrun` (the children import the port,
never JAX), and runs its scenarios there: two Trainer steps of stage 2
and two LoRA steps, HD prefill with the crops split over 'data',
tensor-parallel `Generator` greedy and speculative decoding on the tiny
config and on the 13B-width int8 fused tree at 2 layers, the paged
batcher scenario of `__graft_entry__._dryrun_tp_serving_batcher`, and
multi-LoRA serving (two adapters and the base model) through both
batchers over the tiny config's dense tree and its int8 fused tree. Each
child holds its result to the port's world of one (rank 0 runs the same
work without a mesh); the tests here hold rank 0's results to the JAX
package (the batcher's tokens to JAX's single-device greedy ones, the
multi-LoRA batchers' to JAX's batchers on its dp 4 x tp 2 mesh). The
weights are the port's seeded ones, written to a file the children read,
and given to JAX through `params_to_jax`. Every child has a timeout and
the whole group is killed on a failure.

Tolerances: the loss within rtol 1e-5 and the updated leaves within rtol
3e-4 / atol 3e-5 (`__graft_entry__.py:317-322`); HD logits within 2e-5
(`:433`); tokens equal. The sharding rules are compared leaf for leaf
with JAX's specs (the port drops JAX's leading layer axis), on (4, 2),
(2, 2) and (8, 1) meshes, and a rank's shards with the
`addressable_shards` of JAX's NamedShardings.
"""

import dataclasses
import threading

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.generate import Generator as JaxGenerator
from tokenpacker_tpu.models.lm_api import lm_logits as jax_lm_logits
from tokenpacker_tpu.models.vlm import init_vlm as jax_init_vlm
from tokenpacker_tpu.models.vlm import vlm_hidden as jax_vlm_hidden
from tokenpacker_tpu.ops import quantize as jax_quantize
from tokenpacker_tpu.parallel import mesh as jax_mesh
from tokenpacker_tpu.parallel import sharding as jax_sharding
from tokenpacker_tpu.serve import multi_lora as jax_multi_lora
from tokenpacker_tpu.serve.scheduler import ContinuousBatcher as JaxBatcher
from tokenpacker_tpu.serve.scheduler import PagedContinuousBatcher as JaxPaged
from tokenpacker_tpu.train import lora as jax_lora
from tokenpacker_tpu.train import step as jax_step
from tokenpacker_tpu_torch.config import LMConfig, tiny_vlm_config
from tokenpacker_tpu_torch.io.weights import (
    init_vlm_on_device,
    lora_to_jax,
    params_from_jax,
    params_to_jax,
)
from tokenpacker_tpu_torch.ops.quantize import fuse_llama_layers
from tokenpacker_tpu_torch.parallel import dryrun, sharding
from tokenpacker_tpu_torch.parallel.mesh import Mesh, make_mesh, single_device_mesh
from tokenpacker_tpu_torch.serve.multi_lora import Adapter, SlotLora
from tokenpacker_tpu_torch.train.lora import LoraConfig, init_lora

CHILD_TIMEOUT = 120


def _jax_cfg(port_cfg):
    """The JAX config of a port config (the same fields)."""
    lm = jax_tiny_config().lm.__class__(**{f.name: getattr(port_cfg.lm, f.name)
                                            for f in dataclasses.fields(LMConfig)})
    return jax_tiny_config(lm=lm)


def _jax_tree(port_params):
    return jax.tree.map(jnp.asarray, params_to_jax(port_params))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Rank 0's results of the 4-rank run, the weights, and the JAX
    references that need no child result (computed while the children
    run)."""
    work = tmp_path_factory.mktemp("parallel")
    weights = {name: dryrun.seeded_weights(name)
               for name in ("train", "hd", "tiny", "batcher", "mpt")}
    weights["wide"] = dryrun.int8_fused(
        init_vlm_on_device(dryrun.wide_13b_config(), 7, "cpu", torch.float32))
    torch.save(weights, work / "weights.pt")
    box = {}

    def run():
        try:
            box["outs"] = dryrun.launch(4, [
                "--device", "cpu", "--scenarios", "train,hd,serving,batcher,lora_batcher",
                "--weights", str(work / "weights.pt"), "--out", str(work / "out.pt")],
                CHILD_TIMEOUT, env={"OMP_NUM_THREADS": "2"})
        except Exception as e:  # noqa: BLE001 - re-raised in the tests
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    refs = {}
    cfg = tiny_vlm_config()
    cfg_j = _jax_cfg(cfg)
    # HD prefill on one device (JAX's hd_logits)
    batch = dryrun.hd_batch(cfg, 2)
    params_j = _jax_tree(weights["hd"])

    def hd_logits(p, b):
        hidden, _ = jax_vlm_hidden(p, cfg_j, b)
        idx = jnp.maximum(b["lengths"] - 1, 0)
        last = jnp.take_along_axis(hidden, idx[:, None, None], axis=1)[:, 0]
        return jax_lm_logits(p["lm"], cfg_j.lm, last[:, None, :])[:, 0]

    refs["hd"] = np.asarray(jax.jit(hd_logits)(params_j, {k: jnp.asarray(v)
                                                          for k, v in batch.items()}))
    # greedy tokens on one device
    tiny_j = _jax_tree(weights["tiny"])
    for name, new, seed in (("tiny", 5, 0), ("tiny_spec", 8, 3)):
        b = dryrun.serving_batch(cfg, seed)
        refs[name] = JaxGenerator(tiny_j, cfg_j).generate(b, max_new_tokens=new).sequences[0]
    mpt = dryrun.mpt_tiny_config()
    refs["mpt"] = JaxGenerator(_jax_tree(weights["mpt"]), _jax_cfg(mpt)).generate(
        dryrun.serving_batch(mpt, 0), max_new_tokens=5).sequences[0]
    wide = dryrun.wide_13b_config()
    b = dryrun.serving_batch(wide, 7, "slice")
    refs["wide"] = JaxGenerator(_jax_tree(weights["wide"]), _jax_cfg(wide)).generate(
        b, max_new_tokens=4).sequences[0]
    # the batcher scenario's two prompts, greedy on one device
    batcher_j = _jax_tree(weights["batcher"])
    for name, prompt, new in (("batcher_p1", list(range(2, 10)), 6),
                              ("batcher_p2", list(range(3, 15)), 64)):
        refs[name] = JaxGenerator(batcher_j, cfg_j).generate(
            dryrun.text_request(prompt), max_new_tokens=new).sequences[0]
    refs["lora"] = _jax_lora_batchers(weights)
    thread.join(CHILD_TIMEOUT + 30)
    if "error" in box:
        raise box["error"]
    out = torch.load(work / "out.pt", weights_only=False)
    return {"out": out, "refs": refs, "weights": weights, "log": box["outs"][0]}


def _jax_lora_batchers(weights) -> dict:
    """The `lora_batcher` scenario in the JAX package: both batchers with
    the same two adapters over the trees `shard_params` puts on JAX's
    dp 4 x tp 2 mesh of the 8-device CPU, and the base model's greedy
    tokens on one device with no adapter loaded."""
    mesh = jax_mesh.make_mesh(dp=4, tp=2, devices=jax.devices()[:8])
    ads = {n: jax_multi_lora.Adapter(lora, r)
           for n, (lora, r) in dryrun.lora_adapters(tiny_vlm_config().lm).items()}
    out = {}
    cfg_j = jax_tiny_config()
    for tree, (params, _) in dryrun.lora_trees(weights.get).items():
        tree_j = _jax_tree(params)
        out[f"{tree}/base"] = JaxGenerator(tree_j, cfg_j).generate(
            dryrun.text_request(dryrun.LORA_PROMPTS[0]), max_new_tokens=6).sequences[0]
        with jax.set_mesh(mesh):
            sharded = jax_sharding.shard_params(tree_j, mesh)
        for kind in ("dense", "paged"):
            batcher = (JaxBatcher(sharded, cfg_j, num_slots=2, max_seq_len=64, adapters=ads)
                       if kind == "dense" else
                       JaxPaged(sharded, cfg_j, num_slots=2, num_pages=64, page_size=4,
                                max_pages_per_seq=16, prefix_cache=True, prefill_chunk_size=8,
                                adapters=ads))
            batcher.start()
            try:
                out[f"{tree}/{kind}"] = dryrun.serve_adapters(batcher, dryrun.LORA_PROMPTS, 6,
                                                              kind == "paged")
            finally:
                batcher.stop()
    return out


def _torch_tree(node):
    if isinstance(node, dict):
        return {k: _torch_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_torch_tree(v) for v in node]
    return torch.from_numpy(node) if isinstance(node, np.ndarray) else node


def _jax_train(weights, batches, tcfg):
    cfg_j = jax_tiny_config()
    params = _jax_tree(weights)
    tx = jax_step.make_optimizer(tcfg, params)
    opt_state = tx.init(params)
    step = jax_step.make_train_step(cfg_j, tx)
    losses = []
    for b in batches:
        b = {k: jnp.asarray(v) for k, v in b.items()
             if k not in ("attn_mask", "lengths") and v is not None}
        params, opt_state, metrics = step(params, opt_state, b)
        losses.append(float(metrics["loss"]))
    return losses, jax.device_get(params)


def test_dp_tp_trainer_steps_match_jax(world):
    """Two Trainer steps of stage 2 on dp 2 x tp 2 (the first at lr 0, the
    second at the peak: warmup of one update) against JAX's
    make_train_step on the same global batches."""
    got = world["out"]["train"]["finetune"]
    tcfg = jax_step.TrainConfig(stage="finetune", learning_rate=1e-3, mm_projector_lr=2e-3,
                                max_grad_norm=0.5, total_steps=len(got["batches"]))
    losses, want = _jax_train(world["weights"]["train"], got["batches"], tcfg)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    port = params_to_jax(_torch_tree(got["params"]))
    moved = 0
    for (path, a), w in zip(jax.tree_util.tree_leaves_with_path(port), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(w), rtol=3e-4, atol=3e-5, err_msg=str(path))
    before = params_to_jax(world["weights"]["train"])
    for a, b in zip(jax.tree.leaves(port["lm"]), jax.tree.leaves(before["lm"])):
        moved += bool(np.abs(a - b).max() > 0)
    assert moved == len(jax.tree.leaves(port["lm"]))  # every LM leaf trained


def test_dp_tp_lora_steps_match_jax(world):
    """Two LoRA steps of the Trainer over the mesh (no parameter sharded,
    the global batch split over 'data', the adapters' gradients
    all-reduced) against JAX's `lora_train_step_factory` with the JAX
    loop's tx (clip, adamw with its weight decay 1e-4) from the port's
    initial adapters (JAX's own are salted per process, R14) on the same
    global batches: loss within rtol 1e-5, adapters and projector within
    rtol 3e-4 / atol 3e-5."""
    got = world["out"]["train"]["lora"]
    batches = got["batches"]
    weights = world["weights"]["train"]
    lcfg = LoraConfig(r=4, alpha=8)
    start = init_lora(3, params_from_jax(params_to_jax(weights), tiny_vlm_config()), lcfg)
    total = len(batches)
    lr = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, total + 1)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(lr))
    base = _jax_tree(weights)
    trainable = (jax.tree.map(jnp.asarray, lora_to_jax(start)), base["projector"])
    state = tx.init(trainable)
    step = jax_lora.lora_train_step_factory(jax_tiny_config(), jax_lora.LoraConfig(r=4, alpha=8),
                                            tx)
    losses = []
    for b in batches:
        b = {k: jnp.asarray(v) for k, v in b.items()
             if k not in ("attn_mask", "lengths") and v is not None}
        trainable, state, metrics = step(trainable, base, state, b)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    want_lora, want_proj = jax.device_get(trainable)
    port_lora = lora_to_jax(_torch_tree(got["params"]["lora"]))
    port_proj = params_to_jax(_torch_tree(got["params"]["projector"]))
    for part, a, w in (("lora", port_lora, want_lora), ("projector", port_proj, want_proj)):
        for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a), jax.tree.leaves(w)):
            np.testing.assert_allclose(x, np.asarray(y), rtol=3e-4, atol=3e-5,
                                       err_msg=f"{part}{path}")
    assert any(np.abs(x).max() > 0 for x in jax.tree.leaves(port_lora))
    assert "dryrun train[lora]: mesh={'data': 2, 'model': 2}" in world["log"]


def test_hd_prefill_with_vision_dp_matches_jax(world):
    np.testing.assert_allclose(world["out"]["hd"]["logits"], world["refs"]["hd"],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["tiny", "tiny_spec", "mpt", "wide"])
def test_tp_generator_matches_jax(world, case):
    """Greedy (and, for tiny_spec, speculative k=3) tokens of the sharded
    Generator equal JAX's single-device greedy tokens; MPT's heads split
    over 'model' with their own ALiBi slopes."""
    assert world["out"]["serving"][case]["tokens"] == world["refs"][case]


def test_tp_paged_batcher_scenario(world):
    """`__graft_entry__._dryrun_tp_serving_batcher` on the sharded int8
    fused tree: the cold, warm and concurrent requests give JAX's
    single-device greedy tokens, the cancelled one a prefix of JAX's, with
    a prefix hit and no page leaked (and, as in the child, the same as the
    port's unsharded batcher)."""
    got, ref = world["out"]["batcher"]["got"], world["out"]["batcher"]["ref"]
    want, longer = world["refs"]["batcher_p1"], world["refs"]["batcher_p2"]
    assert got["cold"] == got["warm"] == got["other"] == want, (got, want)
    assert len(got["cancelled"]) >= 2
    assert got["cancelled"] == longer[:len(got["cancelled"])], (got["cancelled"], longer)
    dryrun.check_batcher(got, ref)
    assert got["reused"] > 0 and got["leaked"] == 0


@pytest.mark.parametrize("case", ["fp32/dense", "fp32/paged", "int8/dense", "int8/paged"])
def test_tp_lora_batchers_match_jax(world, case):
    """Two adapters (ranks 4 and 2) and the base model through the port's
    dense or paged batcher over the sharded dense or int8 fused tree (dp 2
    x tp 2): every request's greedy tokens, the prefix tokens reused and
    the pages leaked equal those of JAX's batcher of the same kind on its
    dp 4 x tp 2 mesh (and, in the child, the port's world of one). The
    base request equals JAX's run with no adapter loaded; the paged
    batcher's base request takes none of ad_a's cached pages, and ad_a's
    repeat takes them."""
    got, want = world["out"]["lora_batcher"][case], world["refs"]["lora"][case]
    assert got == want, (got, want)
    tokens = got["tokens"]
    assert tokens[2] == world["refs"]["lora"][case.split("/")[0] + "/base"]
    assert tokens[0] != tokens[2] and tokens[0] == tokens[3]
    assert got["leaked"] == 0
    if case.endswith("paged"):
        assert got["reused"][0] == 0 < got["reused"][1], got["reused"]


# -- the rules, without processes -------------------------------------------------


def _port_mesh(dp, tp, rank=0):
    return Mesh(("data", "model"), (dp, tp), "cpu", rank=rank)


def _jax_named_mesh(dp, tp):
    return jax_mesh.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])


def _trees():
    """(name, JAX tree of shapes or arrays) of the trees the rules are held on."""
    import tokenpacker_tpu.config as jc
    from tokenpacker_tpu.models.mpt import mpt_config

    tiny = jax_tiny_config()
    wide = jax_tiny_config(lm=dataclasses.replace(jc.vicuna_13b(), num_hidden_layers=2,
                                                  vocab_size=512, max_position_embeddings=512))
    mpt = jax_tiny_config(lm=mpt_config(d_model=64, n_heads=4, n_layers=2, vocab_size=256))

    def shapes(cfg, fn=lambda p: p):
        return jax.eval_shape(lambda: fn(jax_init_vlm(jax.random.PRNGKey(0), cfg)))

    def int8(p):
        return {**p, "lm": jax_quantize.quantize_tree(jax_quantize.fuse_llama_layers(p["lm"]),
                                                      min_size=1)}

    def q4(p):
        return {**p, "lm": jax_quantize.quantize_tree_4bit(
            jax_quantize.fuse_llama_layers(p["lm"]), min_size=1)}

    return {"tiny": shapes(tiny), "13b": shapes(wide), "int8": shapes(tiny, int8),
            "q4": shapes(tiny, q4), "mpt": shapes(mpt)}


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 2), (8, 1)])
def test_sharding_rules_equal_jax_leaf_for_leaf(dp, tp):
    mesh_j, mesh_p = _jax_named_mesh(dp, tp), _port_mesh(dp, tp)
    for name, tree in _trees().items():
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            want = jax_sharding._spec_for(path, leaf, mesh_j)
            names = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
            shape = tuple(leaf.shape)
            if names[0] == "lm" and "layers" in names:  # JAX's leading L axis
                i = names.index("layers") + 1
                names = names[:i] + ["0"] + names[i:]
                want, shape = tuple(want)[1:], shape[1:]
            got = sharding._spec_for(names, shape, mesh_p)
            strip = lambda s: tuple(s) + (None,) * (len(shape) - len(tuple(s)))  # noqa: E731
            assert strip(got) == strip(want), (name, names, got, want)


@pytest.fixture(scope="module")
def tree_j():
    """JAX's tiny init (jitted: eager init takes seconds on the CPU)."""
    cfg = jax_tiny_config()
    return jax.device_get(jax.jit(lambda key: jax_init_vlm(key, cfg))(jax.random.PRNGKey(2)))


def test_vlm_param_shardings_on_the_port_tree(tree_j):
    """vlm_param_shardings over the port's tree (the JAX init moved with
    params_from_jax) names the JAX spec of every leaf."""
    cfg = tiny_vlm_config()
    specs = sharding.vlm_param_shardings(params_from_jax(tree_j, cfg), _port_mesh(4, 2))
    want = jax_sharding.vlm_param_shardings(tree_j, _jax_named_mesh(4, 2))
    assert specs["lm"]["layers"][1]["attn"]["q"]["kernel"] == ("data", "model")
    assert tuple(want["lm"]["layers"]["attn"]["q"]["kernel"].spec)[1:] == ("data", "model")
    assert specs["lm"]["layers"][0]["mlp"]["down"]["kernel"] == ("model", "data")
    assert specs["lm"]["embed"] == tuple(want["lm"]["embed"].spec) == ("data", "model")
    assert specs["lm"]["norm"]["scale"] == tuple(want["lm"]["norm"]["scale"].spec) == ()


def _jax_shard(x, spec, mesh_j, rank):
    arr = jax.device_put(np.asarray(x), NamedSharding(mesh_j, spec))
    dev = np.asarray(mesh_j.devices).reshape(-1)[rank]
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)


@pytest.mark.parametrize("fused", [False, True])
def test_a_ranks_shards_equal_jax_addressable_shards(tree_j, fused):
    """Every rank's local leaves equal the shards JAX's NamedSharding puts
    on that device; a fused qkv / gateup leaf (split by part) equals the
    concatenation of JAX's shards of the unfused q, k, v (gate, up)."""
    cfg = tiny_vlm_config()
    dp, tp = 2, 2
    mesh_j = _jax_named_mesh(dp, tp)
    specs_j = jax_sharding.vlm_param_shardings(tree_j, mesh_j)
    port = params_from_jax(tree_j, cfg)
    if fused:
        port = {**port, "lm": fuse_llama_layers(port["lm"])}
    parts = {"qkv": ("q", "k", "v"), "gateup": ("gate", "up")}
    for rank in range(dp * tp):
        local = sharding.shard_params(port, _port_mesh(dp, tp, rank), cfg)
        for path, leaf in sharding._walk(local):
            names = list(path)
            if "layers" in names:  # the LM's and the tower's stacked layers
                i = names.index("layers")
                layer, rest = int(names[i + 1]), names[i + 2:]
                srcs = parts.get(rest[1], (rest[1],)) if len(rest) > 1 else (None,)
                want = []
                for src in srcs:
                    sub = rest if src is None else [rest[0], src] + rest[2:]
                    node, spec = tree_j[names[0]]["layers"], specs_j[names[0]]["layers"]
                    for k in sub:
                        node, spec = node[k], spec[k]
                    full = np.asarray(node)[layer]
                    want.append(_jax_shard(full, jax.sharding.PartitionSpec(
                        *tuple(spec.spec)[1:]), mesh_j, rank))
                want = np.concatenate(want, axis=-1)
            else:
                node, spec = tree_j, specs_j
                for k in names:
                    node, spec = node[k], spec[k]
                want = _jax_shard(node, spec.spec, mesh_j, rank)
            np.testing.assert_array_equal(leaf.numpy(), want, err_msg=f"rank {rank} {path}")


def test_presets_and_mesh_errors():
    """The presets name JAX's keys (reckoned for 80 GB: every one fits one
    card, `PARALLEL_PRESETS`); the mesh keeps JAX's errors."""
    assert sorted(sharding.PARALLEL_PRESETS) == sorted(jax_sharding.PARALLEL_PRESETS)
    assert all(v == {"tp": 1} for v in sharding.PARALLEL_PRESETS.values())
    sizes = {k: sharding.preset_footprint(k) for k in sharding.PARALLEL_PRESETS}
    assert max(v["total_gib"] for v in sizes.values()) < sharding.CARD_GIB
    assert sizes["13b-int8"]["weights_gib"] < sizes["13b-bf16"]["weights_gib"] / 1.9
    mesh = sharding.recommended_mesh("13b-int8", device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(KeyError, match="unknown preset"):
        sharding.recommended_mesh("70b", device="cpu")
    with pytest.raises(ValueError, match="1 devices not divisible by tp=2"):
        make_mesh(tp=2, device="cpu")
    with pytest.raises(ValueError, match=r"dp\*tp = 2 != 1 devices"):
        make_mesh(dp=2, tp=1, device="cpu")
    with pytest.raises(ValueError, match=r"dp\*tp = 6 != 8 devices"):
        jax_mesh.make_mesh(dp=3, tp=2)
    assert single_device_mesh("cpu").shape == {"data": 1, "model": 1}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 2)])
def test_local_slot_lora_follows_the_kernels_placement(dp, tp, fused):
    """`SlotLora` over a rank's shards holds the full stacks cut as that
    rank's kernels are cut (`sharding.local_slot_lora`): b's columns of a
    column-parallel target, q, k and v (gate and up) each by its own
    columns on a fused leaf, and a's rows of a row-parallel one; the
    selection stays whole. The same columns of the full kernel are the
    rank's kernel, and the row-parallel terms of a 'data' row's ranks sum
    to the whole term."""
    cfg = tiny_vlm_config()
    lm = cfg.lm
    params = init_vlm_on_device(cfg, 4, "cpu", torch.float32)
    if fused:
        params = {**params, "lm": fuse_llama_layers(params["lm"])}
    ads = {n: Adapter(lora, r) for n, (lora, r) in dryrun.lora_adapters(lm).items()}
    full = SlotLora(params, cfg, ads, 2, dtype=torch.float32)
    hq, hkv, f = lm.num_attention_heads * lm.head_dim, lm.kv_heads * lm.head_dim, \
        lm.intermediate_size
    column_parts = {"qkv": (hq, hkv, hkv), "gateup": (f, f), "q": (hq,), "k": (hkv,),
                    "v": (hkv,), "gate": (f,), "up": (f,)}
    partial, whole = {}, {}
    for rank in range(dp * tp):
        mesh = _port_mesh(dp, tp, rank)
        m, d = mesh.axis("model").index, mesh.axis("data").index
        sharded = sharding.shard_params(params, mesh, cfg)
        local = SlotLora(sharded, cfg, ads, 2, dtype=torch.float32)
        assert local.sel.shape == full.sel.shape
        for i, (mine, theirs) in enumerate(zip(local.stacks, full.stacks)):
            assert mine.keys() == theirs.keys()
            for (grp, leaf), (a, b) in mine.items():
                fa, fb = theirs[(grp, leaf)]
                if leaf in column_parts:
                    starts = np.cumsum((0,) + column_parts[leaf][:-1])
                    cols = torch.cat([torch.arange(o + m * w // tp, o + (m + 1) * w // tp)
                                      for o, w in zip(starts, column_parts[leaf])])
                    assert torch.equal(a, fa) and torch.equal(b, fb[..., cols]), (rank, leaf)
                    w_full = params["lm"]["layers"][i][grp][leaf]["kernel"]
                    w_local = sharded["lm"]["layers"][i][grp][leaf]["kernel"]
                    assert torch.equal(w_local, w_full.chunk(dp)[d][:, cols]), (rank, leaf)
                else:  # o, down
                    rows = torch.arange(fa.shape[1]).chunk(tp)[m]
                    assert torch.equal(a, fa[:, rows]) and torch.equal(b, fb), (rank, leaf)
                    x = torch.randn(3, fa.shape[1], generator=torch.Generator().manual_seed(i))
                    partial.setdefault((i, leaf, d), []).append(
                        torch.einsum("bd,ndr,nro->bno", x[:, rows], a, b))
                    whole[(i, leaf)] = torch.einsum("bd,ndr,nro->bno", x, fa, fb)
    for (i, leaf, _), terms in partial.items():
        assert len(terms) == tp
        torch.testing.assert_close(sum(terms), whole[(i, leaf)], rtol=1e-5, atol=1e-5)
