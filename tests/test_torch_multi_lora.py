"""Multi-LoRA serving of the port against the JAX package on the CPU, on the
same seeded weights and numpy adapters: `load_adapter` (PEFT directories
and the JAX trainer's export), the `SlotLora` stacks, `ops/layers.linear`'s
slot term over every base kind, K4-LoRA's plain version against the JAX
kernel in interpret mode (T = 1 and the T = 3 verify form, int8 and bf16
caches, the mixed-rank rig), and both batchers' greedy tokens per
adapter, with and without speculation, against the JAX batchers'.

Two geometries: `tests/test_fused_decode`'s rig (D = 512, heads of 128,
an int8 fused tree, so the dense batcher's steps run K4-LoRA; text
prompts) and the tiny VLM (heads of 16, per-layer steps; image prompts,
for the projector override). The adapters follow the JAX tests': "ad_a"
of rank 4 over all seven targets and "ad_b" of rank 2 over q and down
only, scaled so that greedy streams leave the base model's. Every
tolerance is stated where it is used.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tokenpacker_tpu.config import TokenPackerVLMConfig as JaxVLMConfig
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.ops import fused_decode as jax_fd
from tokenpacker_tpu.ops import layers as jax_layers
from tokenpacker_tpu.serve import multi_lora as jml
from tokenpacker_tpu.serve.scheduler import ContinuousBatcher as JaxBatcher
from tokenpacker_tpu.serve.scheduler import PagedContinuousBatcher as JaxPaged
from tokenpacker_tpu_torch.config import TokenPackerVLMConfig, tiny_vlm_config
from tokenpacker_tpu_torch.generate import (
    decode_step_cb,
    device_batch,
    insert_into_cache,
    prefill,
)
from tokenpacker_tpu_torch.io.hf_import import export_tokenpacker
from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_to, params_to_jax
from tokenpacker_tpu_torch.models.llama import KVCache
from tokenpacker_tpu_torch.ops import fused_decode, layers
from tokenpacker_tpu_torch.ops import quantize as tq
from tokenpacker_tpu_torch.serve import multi_lora
from tokenpacker_tpu_torch.serve.scheduler import ContinuousBatcher, PagedContinuousBatcher
from test_torch_fused_decode import B, LENGTHS, PRE, _int8_trees, _jax_prefill_cache, _to_torch
from test_torch_speculative import K, _request

MAX_NEW = 6
PAGED = dict(num_slots=2, num_pages=64, page_size=4, max_pages_per_seq=24)


def _numpy_adapters(lm_cfg, seed, scale=0.3):
    """{name: (lora, r)}: "ad_a" rank 4 over every target, "ad_b" rank 2
    over q and down (the JAX tests' mixed-rank pair), float32 numpy."""
    rng = np.random.default_rng(seed)
    dims = multi_lora.target_dims(lm_cfg)
    n_layers = lm_cfg.num_hidden_layers

    def make(r, targets):
        return {t: ((scale * rng.standard_normal((n_layers, dims[t][0], r))).astype(np.float32),
                    (scale * rng.standard_normal((n_layers, r, dims[t][1]))).astype(np.float32))
                for t in targets}

    return {"ad_a": (make(4, multi_lora.TARGETS), 4),
            "ad_b": (make(2, [("attn", "q"), ("mlp", "down")]), 2)}


def _both(ads, projectors=None):
    """The same adapters as the JAX package's and the port's Adapter
    objects; projectors: {name: port projector params}."""
    projectors = projectors or {}
    jax_ads = {n: jml.Adapter(lora, r, params_to_jax(projectors[n]) if n in projectors else None)
               for n, (lora, r) in ads.items()}
    port_ads = {n: multi_lora.Adapter(lora, r, projectors.get(n)) for n, (lora, r) in ads.items()}
    return jax_ads, port_ads


def _assert_trees_equal(port_tree, jax_tree, path=""):
    if port_tree is None:
        assert jax_tree is None, path
        return
    if isinstance(port_tree, dict):
        assert set(port_tree) == set(jax_tree), path
        for k in port_tree:
            _assert_trees_equal(port_tree[k], jax_tree[k], f"{path}.{k}")
        return
    np.testing.assert_array_equal(port_tree.float().numpy(), np.asarray(jax_tree, np.float32),
                                  err_msg=path)


@pytest.fixture(scope="module")
def vlm():
    """The tiny VLM in fp32 in both packages, with adapters; ad_b carries a
    projector (its non-LoRA trainables): the base projector plus noise."""
    cfg = tiny_vlm_config()
    params = init_vlm_on_device(cfg, seed=11, device="cpu", dtype=torch.float32)
    proj = params_to(params["projector"], "cpu", torch.float32)
    g = torch.Generator().manual_seed(3)
    for leaf in (proj["mlp"]["fc1"], proj["mlp"]["fc2"]):
        leaf["kernel"] = leaf["kernel"] + 0.5 * torch.randn(leaf["kernel"].shape, generator=g)
    jax_ads, port_ads = _both(_numpy_adapters(cfg.lm, 1), {"ad_b": proj})
    return {"cfg": cfg, "cfg_j": jax_tiny_config(), "params": params,
            "tree": params_to_jax(params), "jax_ads": jax_ads, "port_ads": port_ads}


@pytest.fixture(scope="module")
def rig():
    """`_int8_trees`' fused-decode rig (bf16, int8 fused layout, K4's
    geometry) with its adapters, as full-model params of both packages."""
    cfg_j, lm_cfg, tree, port = _int8_trees(seed=3)
    jax_ads, port_ads = _both(_numpy_adapters(lm_cfg, 5))
    return {"cfg_j": JaxVLMConfig(lm=cfg_j, dtype=jnp.bfloat16),
            "cfg": TokenPackerVLMConfig(lm=lm_cfg, dtype=torch.bfloat16),
            "tree": {"lm": tree}, "params": {"lm": port}, "jax_ads": jax_ads,
            "port_ads": port_ads}


# -- load_adapter --------------------------------------------------------------


def test_load_adapter_matches_jax(vlm, tmp_path):
    """A PEFT directory (q in layers 0 and 1, down in layer 1, a vision key
    that is skipped, a projector in non_lora_trainables.bin) loads into the
    same arrays and projector as the JAX `load_adapter`: the torch [r, in]
    / [out, r] weights transposed, alpha / r folded into b, bit for bit."""
    cfg, cfg_j = vlm["cfg"], vlm["cfg_j"]
    d, f = cfg.lm.hidden_size, cfg.lm.intermediate_size
    r, alpha = 2, 8
    g = torch.Generator().manual_seed(0)
    sd = {}
    for name, din, dout in (("layers.0.self_attn.q_proj", d, d),
                            ("layers.1.self_attn.q_proj", d, d), ("layers.1.mlp.down_proj", f, d),
                            ("vision_tower.layers.0.q_proj", 32, 32)):
        sd[f"base_model.model.model.{name}.lora_A.weight"] = torch.randn(r, din, generator=g)
        sd[f"base_model.model.model.{name}.lora_B.weight"] = torch.randn(dout, r, generator=g)
    torch.save(sd, tmp_path / "adapter_model.bin")
    proj = {f"base_model.model.model.mm_projector.{k}": torch.from_numpy(v)
            for k, v in export_tokenpacker(vlm["params"]["projector"]).items()}
    torch.save(proj, tmp_path / "non_lora_trainables.bin")
    (tmp_path / "adapter_config.json").write_text(json.dumps({"r": r, "lora_alpha": alpha}))

    got = multi_lora.load_adapter(str(tmp_path), cfg, torch.float32)
    want = jml.load_adapter(str(tmp_path), cfg_j, jnp.float32)
    assert got.r == want.r == r
    assert set(got.lora) == set(want.lora) == {("attn", "q"), ("mlp", "down")}
    for tgt, (a, b) in got.lora.items():
        np.testing.assert_array_equal(a, want.lora[tgt][0])
        np.testing.assert_array_equal(b, want.lora[tgt][1])
    a, b = got.lora[("attn", "q")]
    np.testing.assert_array_equal(b[1], sd["base_model.model.model.layers.1.self_attn.q_proj"
                                           ".lora_B.weight"].numpy().T * (alpha / r))
    _assert_trees_equal(got.projector, want.projector)


def test_load_adapter_reads_the_jax_training_export(vlm, tmp_path):
    """An adapter trained and saved by the JAX trainer
    (`train/lora.export_lora_state_dict`, the reference PEFT layout) loads
    into the port as into the JAX package: every target, equal arrays."""
    from tokenpacker_tpu.train.lora import LoraConfig, export_lora_state_dict, init_lora

    lcfg = LoraConfig(r=2, alpha=6)
    lora = init_lora(jax.random.PRNGKey(7), jax.tree.map(jnp.asarray, vlm["tree"]), lcfg)
    rng = np.random.default_rng(8)
    lora = jax.tree.map(lambda x: 0.1 * rng.standard_normal(x.shape).astype(np.float32), lora)
    sd = export_lora_state_dict(lora, lcfg)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               tmp_path / "adapter_model.bin")
    (tmp_path / "adapter_config.json").write_text(
        json.dumps({"r": lcfg.r, "lora_alpha": lcfg.alpha, "peft_type": "LORA"}))
    got = multi_lora.load_adapter(str(tmp_path), vlm["cfg"])
    want = jml.load_adapter(str(tmp_path), vlm["cfg_j"])
    assert set(got.lora) == set(multi_lora.TARGETS) == set(want.lora)
    for tgt, (a, b) in got.lora.items():
        np.testing.assert_array_equal(a, want.lora[tgt][0])
        np.testing.assert_array_equal(b, want.lora[tgt][1])
    src = lora["lm"]["layers"]["attn"]["q"]["kernel"]
    np.testing.assert_allclose(got.lora[("attn", "q")][1], src["b"] * (lcfg.alpha / lcfg.r),
                               rtol=1e-6)


# -- SlotLora --------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["q/k/v and gate/up", "fused qkv and gateup"])
def test_slot_lora_stacks_equal_jax(vlm, rig, layout):
    """Per layer and target leaf the port's [n, in, rcat] / [n, rcat, out]
    stacks equal the JAX [L, n, ...] stacks' layer slice, bit for bit (the
    mixed rank padded with zeros, the fused leaves' concatenated A and
    block-diagonal B); the overlay carries them and one shared selection."""
    m = vlm if layout.startswith("q/k/v") else rig
    cfg_j = SimpleNamespace(lm=m["cfg_j"].lm, dtype=jnp.float32)
    cfg = SimpleNamespace(lm=m["cfg"].lm, dtype=torch.float32)
    want = jml.SlotLora(m["tree"], cfg_j, m["jax_ads"], 3, dtype=jnp.float32)
    got = multi_lora.SlotLora(m["params"], cfg, m["port_ads"], 3, dtype=torch.float32)
    assert got.names == want.names and got.r == want.r == 4
    assert set(got.stacks[0]) == set(want.stacks)
    for i, stacks in enumerate(got.stacks):
        for key, (a, b) in stacks.items():
            np.testing.assert_array_equal(a.numpy(), np.asarray(want.stacks[key][0][i]))
            np.testing.assert_array_equal(b.numpy(), np.asarray(want.stacks[key][1][i]))
    over = got.overlay(m["params"])
    assert multi_lora.has_slot_lora(over["lm"]) and not multi_lora.has_slot_lora(m["params"]["lm"])
    leaves = [layer["attn"]["o"]["slot_lora_sel"] for layer in over["lm"]["layers"]]
    assert all(s is got.sel for s in leaves)
    got.set_slot(1, "ad_b")
    assert got.sel.tolist() == [[0, 0], [0, 1], [0, 0]]
    assert over["lm"]["layers"][0]["attn"]["o"]["slot_lora_sel"][1].tolist() == [0, 1]
    assert ("fd_slot_lora" in over["lm"]) == layout.startswith("fused")


def test_slot_lora_refuses_what_jax_refuses(vlm):
    """As the JAX SlotLora: a non-llama LM and an empty adapter set raise;
    an unknown adapter name is a KeyError."""
    import dataclasses

    cfg, params, ads = vlm["cfg"], vlm["params"], vlm["port_ads"]
    mpt = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, model_family="mpt"))
    with pytest.raises(ValueError, match="llama"):
        multi_lora.SlotLora(params, mpt, ads, 2)
    with pytest.raises(ValueError, match="non-empty"):
        multi_lora.SlotLora(params, cfg, {}, 2)
    sl = multi_lora.SlotLora(params, cfg, ads, 2)
    with pytest.raises(KeyError, match="nope"):
        sl.set_slot(0, "nope")
    with pytest.raises(KeyError):
        sl.prefill_params(params, "nope")


# -- ops/layers.linear's slot term ------------------------------------------------


def _slot_leaves(rng, k, n, n_ad=2, r=4):
    a = (0.3 * rng.standard_normal((n_ad, k, r))).astype(np.float32)
    b = (0.3 * rng.standard_normal((n_ad, r, n))).astype(np.float32)
    return a, b


@pytest.mark.parametrize("base,m", [("bf16", 8), ("int8", 8), ("nf4", 8), ("nf4", 40),
                                    ("w8a8", 64), ("w8a8", 256)])
def test_linear_slot_term_matches_jax(base, m):
    """x [2, m/2, 256] through a [256, 128] leaf with the slot term, sample 0
    on adapter 1 and sample 1 on none. The term that `linear` adds (its
    output less the same leaf's without the term, fp32) equals the JAX
    package's within 1e-5 of its largest value over every base kind: K6
    (nf4, M <= 32) or the dequantized product (M > 32), K7 (w8a8, M <= 64)
    or K8 (M >= 256), the weight-only int8 product, bf16; sample 1's rows
    are the base exactly. The bf16 base is also held whole in bf16 against
    the JAX linear: within one bf16 step (2^-8) of its largest value."""
    rng = np.random.default_rng(m)
    kd, nd = 256, 128
    w = (0.05 * rng.standard_normal((kd, nd))).astype(np.float32)
    x = rng.standard_normal((2, m // 2, kd)).astype(np.float32)
    a, b = _slot_leaves(rng, kd, nd)
    sel = np.array([[0, 1], [0, 0]], np.float32)
    wt = torch.from_numpy(w)
    if base == "bf16":
        kernel = wt
    elif base == "nf4":
        kernel = tq.quantize_4bit(wt)
    else:
        kernel = dict(zip(("q", "scale"), tq.quantize_int8(wt)))
    slot = {"slot_lora_a": torch.from_numpy(a), "slot_lora_b": torch.from_numpy(b),
            "slot_lora_sel": torch.from_numpy(sel)}
    xt = torch.from_numpy(x)
    y_base = layers.linear({"kernel": kernel}, xt, w8a8=base == "w8a8")
    y = layers.linear({"kernel": kernel, **slot}, xt, w8a8=base == "w8a8")
    jslot = {"slot_lora_a": a, "slot_lora_b": b, "slot_lora_sel": sel}
    jw = jnp.asarray(w)
    jy_base = jax_layers.linear({"kernel": jw}, jnp.asarray(x))
    jy = jax_layers.linear({"kernel": jw, **jslot}, jnp.asarray(x))
    want = np.asarray(jy) - np.asarray(jy_base)
    got = (y - y_base).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(want[0]).max() > 1.0
    assert torch.equal(y[1], y_base[1])
    if base == "bf16":
        yb = layers.linear({"kernel": torch.from_numpy(w).bfloat16(),
                            **{k: v.bfloat16() for k, v in slot.items()}}, xt.bfloat16())
        jyb = jax_layers.linear({"kernel": jw.astype(jnp.bfloat16),
                                 **{k: jnp.asarray(v, jnp.bfloat16) for k, v in jslot.items()}},
                                jnp.asarray(x, jnp.bfloat16))
        jyb = np.asarray(jyb, np.float32)
        assert yb.dtype == torch.bfloat16
        assert np.abs(yb.float().numpy() - jyb).max() <= 2**-8 * np.abs(jyb).max()


def test_qlora_over_a_quantized_base_stays_refused():
    """The JAX package's QLoRA `lora_a` on a quantized kernel is training's
    (train/lora), apart from serving's slot term: a pair that is not [in,
    r] / [r, out] is refused; a well-formed pair adds its term beside the
    slot term, both as JAX's `linear` adds them."""
    rng = np.random.default_rng(3)
    q4 = tq.quantize_4bit(torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)))
    w = torch.zeros((64, 128))
    with pytest.raises(RuntimeError):
        layers.linear({"kernel": {**q4, "lora_a": w, "lora_b": w}}, torch.zeros(1, 64))
    arr = {"lora_a": rng.standard_normal((64, 2)), "lora_b": rng.standard_normal((2, 128)),
           "slot_lora_a": rng.standard_normal((2, 64, 3)),
           "slot_lora_b": rng.standard_normal((2, 3, 128)),
           "slot_lora_sel": np.array([[0.0, 1.0], [1.0, 0.0]]), "x": rng.standard_normal((2, 64))}
    arr = {k: v.astype(np.float32) for k, v in arr.items()}
    t = {k: torch.from_numpy(v) for k, v in arr.items()}
    got = layers.linear({"kernel": {**q4, "lora_a": t["lora_a"], "lora_b": t["lora_b"]},
                         **{k: t[k] for k in ("slot_lora_a", "slot_lora_b", "slot_lora_sel")}},
                        t["x"])
    jq4 = {k: jnp.asarray(v.numpy()) for k, v in q4.items()}
    want = jax_layers.linear({"kernel": {**jq4, "lora_a": jnp.asarray(arr["lora_a"]),
                                         "lora_b": jnp.asarray(arr["lora_b"])},
                              **{k: jnp.asarray(arr[k]) for k in ("slot_lora_a", "slot_lora_b",
                                                                  "slot_lora_sel")}},
                             jnp.asarray(arr["x"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_zero_selection_is_the_base_exactly(vlm):
    """A request on no adapter: prefill under `prefill_params(base, None)`
    gives the base model's logits and cache bit for bit (an all-zero row
    adds an exact zero), as the JAX test holds."""
    cfg, params = vlm["cfg"], vlm["params"]
    sl = multi_lora.SlotLora(params, cfg, vlm["port_ads"], 2)
    batch = _request(cfg, 0)
    dev = device_batch(batch, torch.float32, "cpu")
    base, cache_b = prefill(params, cfg, dev, 40)
    none, cache_n = prefill(sl.prefill_params(params, None), cfg, dev, 40)
    assert torch.equal(base, none) and torch.equal(cache_b.k, cache_n.k)
    with_a, _ = prefill(sl.prefill_params(params, "ad_a"), cfg, dev, 40)
    assert (with_a - base).abs().max() > 0.1


def _merged(params, adapter):
    """Oracle: the adapter folded into dense fp32 kernels."""
    out = params_to(params, "cpu", torch.float32)
    for i, layer in enumerate(out["lm"]["layers"]):
        for (grp, leaf), (a, b) in adapter.lora.items():
            k = layer[grp][leaf]["kernel"]
            layer[grp][leaf]["kernel"] = k + torch.from_numpy(a[i] @ b[i])
    return out


def test_overlay_equals_merged_weights(vlm):
    """decode_step_cb on the overlay, slot 0 on ad_a and slot 1 on none, after
    admissions under `prefill_params`: slot 0's logits equal decoding with
    ad_a merged into the kernels within 1e-4 of their largest value (fp32,
    the same function in another order), slot 1's equal the base's."""
    cfg, params = vlm["cfg"], vlm["params"]
    sl = multi_lora.SlotLora(params, cfg, vlm["port_ads"], 2, dtype=torch.float32)
    sl.set_slot(0, "ad_a")
    dev = device_batch(_request(cfg, 2), torch.float32, "cpu")
    n = int(dev["lengths"][0])

    def step(admit, decode):
        """Admit the prompt into both slots under admit[slot], one step on
        `decode`."""
        cache = KVCache.create(cfg.lm, 2, 48, dtype=torch.float32)
        for slot, p in enumerate(admit):
            insert_into_cache(cache, prefill(p, cfg, dev, 48)[1], slot)
        lens = torch.tensor([n, n], dtype=torch.int32)
        return decode_step_cb(decode, cfg, cache, torch.tensor([3, 3]), lens,
                              torch.ones(2, dtype=torch.bool), fused=False)[0]

    got = step([sl.prefill_params(params, "ad_a"), sl.prefill_params(params, None)],
               sl.overlay(params))
    merged = _merged(params, vlm["port_ads"]["ad_a"])
    want_a = step([merged, merged], merged)[0]
    want_b = step([params, params], params)[1]
    assert (got[0] - want_a).abs().max() <= 1e-4 * want_a.abs().max()
    assert torch.equal(got[1], want_b)
    assert (got[0] - want_b).abs().max() > 0.1


# -- K4-LoRA's plain version ----------------------------------------------------------


@pytest.mark.parametrize("cache_dtype", ["int8", "bf16"])
@pytest.mark.parametrize("t", [1, 3])
def test_plain_k4_lora_matches_jax_interpret(rig, cache_dtype, t):
    """The rig's 2 layers, slot 0 on ad_a (all targets) and slot 1 on ad_b
    (rank 2, q and down), at decode step 2 over the JAX test's prefilled
    cache: `fused_decode_hidden` (t = 1) or `fused_verify_hidden` (t = 3)
    with the port's bundle against the JAX kernel in interpret mode with
    its own. Held within the JAX tests' bounds for this comparison (the
    fused kernel against the XLA slot-LoRA path): 2e-2 of max|hidden| at
    T = 1, 3e-2 in the verify form, whose causal chain of fed tokens
    compounds the 0.3-scale adapters' bf16 reorderings. The term is no
    rounding: the hidden state moves by O(max|hidden|) against the base.
    With both selection rows zero the output is the base K4's bit for bit."""
    cfg_j, cfg = rig["cfg_j"].lm, rig["cfg"].lm
    tree, port = rig["tree"]["lm"], rig["params"]["lm"]
    jsl = jml.SlotLora(rig["tree"], SimpleNamespace(lm=cfg_j, dtype=jnp.bfloat16),
                       rig["jax_ads"], 2)
    psl = multi_lora.SlotLora(rig["params"], rig["cfg"], rig["port_ads"], 2)
    for sl in (jsl, psl):
        sl.set_slot(0, "ad_a")
        sl.set_slot(1, "ad_b")
    jo, po = jsl.overlay(rig["tree"])["lm"], psl.overlay(rig["params"])["lm"]
    int8 = cache_dtype == "int8"
    jc = _jax_prefill_cache(tree, cfg_j, jnp.int8 if int8 else jnp.bfloat16)
    step = 2
    emb = (0.1 * np.random.default_rng(4).standard_normal((B, t, cfg.hidden_size))).astype(
        np.float32)
    pos = (LENGTHS[:, None] + step + np.arange(t)).astype(np.int32)
    wpos = np.full((B,), PRE + step, np.int32)
    start2 = np.full((B,), PRE, np.int32)
    jargs = (jc.k, jc.v, jnp.asarray(LENGTHS), jnp.asarray(start2), jnp.asarray(wpos),
             jnp.asarray(wpos))
    if t == 1:
        out = jax_fd.fused_decode_hidden(
            jo, cfg_j, jnp.asarray(emb[:, 0], jnp.bfloat16), *jargs,
            positions=jnp.asarray(pos[:, 0]), interpret=True, k_scale=jc.k_scale,
            v_scale=jc.v_scale, slot_lora=jo["fd_slot_lora"])
    else:
        out = jax_fd.fused_verify_hidden(
            jo, cfg_j, jnp.asarray(emb, jnp.bfloat16), *jargs, jnp.asarray(pos), interpret=True,
            k_scale=jc.k_scale, v_scale=jc.v_scale, slot_lora=jo["fd_slot_lora"])
    want = np.asarray(out[0], np.float32).reshape(B, t, -1)

    def port_run(lm, slot_lora):
        c = [_to_torch(x) if x is not None else None
             for x in (jc.k, jc.v, jc.k_scale if int8 else None, jc.v_scale if int8 else None)]
        h = torch.from_numpy(emb).bfloat16()
        args = (c[0], c[1], torch.from_numpy(LENGTHS), torch.from_numpy(start2),
                torch.from_numpy(wpos), torch.from_numpy(wpos))
        if t == 1:
            hid = fused_decode.fused_decode_hidden(
                lm, cfg, h[:, 0], *args, torch.from_numpy(pos[:, 0]), k_scale=c[2], v_scale=c[3],
                slot_lora=slot_lora)[0]
        else:
            hid = fused_decode.fused_verify_hidden(
                lm, cfg, h, *args, torch.from_numpy(pos), k_scale=c[2], v_scale=c[3],
                slot_lora=slot_lora)[0]
        return hid.float().reshape(B, t, -1).numpy()

    got = port_run(po, po["fd_slot_lora"])
    base = port_run(port, None)
    tol = (2e-2 if t == 1 else 3e-2) * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    assert np.abs(got - base).max() > 10 * tol
    psl.set_slot(0, None)
    psl.set_slot(1, None)
    assert np.array_equal(port_run(po, po["fd_slot_lora"]), base)


def test_k4_lora_bundle_layout():
    """`build_fd_lora` on the mixed-rank stacks: A's columns and B's rows
    per adapter at j * rcat, `expand` mapping each one-hot row to its
    adapter's columns in the qkv | o | gateup | down order, no padding;
    the mask of the verify form repeats each sample's row per fed token."""
    cfg_j, lm_cfg, tree, port = _int8_trees(seed=3)
    _, port_ads = _both(_numpy_adapters(lm_cfg, 5))
    sl = multi_lora.SlotLora({"lm": port}, TokenPackerVLMConfig(lm=lm_cfg), port_ads, 2,
                             dtype=torch.float32)
    fd = sl._fd
    d, f = lm_cfg.hidden_size, lm_cfg.intermediate_size
    assert fd["widths"] == (24, 8, 16, 8)  # n = 2, r = 4: 3r, r, 2r, r columns an adapter
    assert fd["a_d"].shape == (2, d, 48) and fd["a_f"].shape == (2, f, 8)
    assert fd["b_qkv"].shape == (2, 24, 3 * d) and fd["b_gu"].shape == (2, 16, 2 * f)
    a_qkv, b_qkv = sl.stacks[1][("attn", "qkv")]
    assert torch.equal(fd["a_d"][1, :, 12:24], a_qkv[1])
    assert torch.equal(fd["b_qkv"][1, 12:], b_qkv[1])
    assert torch.equal(fd["a_f"][0, :, :4], sl.stacks[0][("mlp", "down")][0][0])
    sel = torch.tensor([[0.0, 1.0], [1.0, 0.0]])
    selm = fused_decode._lora_args({**fd, "sel": sel}, 3)
    assert selm.shape == (6, 56)
    assert selm[:3, 12:24].eq(1).all() and selm[:3, :12].eq(0).all() and selm[3:, :12].eq(1).all()
    assert selm[:3, 52:].eq(1).all() and selm[3:, 48:52].eq(1).all()


def test_fused_stacks_are_views_into_the_bundle():
    """On a K4 tree the adapters are held once: every per-layer stack that
    `linear` reads lies in the storage of K4's bundle, and a write to the
    bundle shows in the stack."""
    cfg_j, lm_cfg, tree, port = _int8_trees(seed=3)
    _, port_ads = _both(_numpy_adapters(lm_cfg, 5))
    sl = multi_lora.SlotLora({"lm": port}, TokenPackerVLMConfig(lm=lm_cfg), port_ads, 2,
                             dtype=torch.float32)
    fd = sl._fd
    owners = {fd[k].untyped_storage().data_ptr()
              for k in ("a_d", "a_f", "b_qkv", "b_o", "b_gu", "b_down")}
    for stacks in sl.stacks:
        for a, b in stacks.values():
            assert a.untyped_storage().data_ptr() in owners
            assert b.untyped_storage().data_ptr() in owners
    fd["a_f"][1, 0, 5] = 7.0  # adapter 1's second column of down's A, layer 1
    assert sl.stacks[1][("mlp", "down")][0][1, 0, 1] == 7.0


# -- the batchers --------------------------------------------------------------------


def _text_batch(prompt):
    ids = np.asarray(prompt, np.int64)[None]
    return {"token_ids": ids, "is_image": np.zeros_like(ids, bool),
            "image_slot": np.zeros_like(ids, np.int32), "lengths": np.array([ids.shape[1]]),
            "images": None}


def _serve(batcher, work):
    """Submit (request, adapter) pairs in order; the greedy tokens of each."""
    batcher.start()
    try:
        return [f.result(timeout=600) for f in
                [batcher.submit(dict(r), MAX_NEW, adapter=a) for r, a in work]]
    finally:
        batcher.stop()


@pytest.fixture(scope="module")
def rig_work():
    p = list(range(2, 10))
    return [(_text_batch(p), "ad_a"), (_text_batch(p), None), (_text_batch(p[::-1]), "ad_b"),
            (_text_batch(p), "ad_b")]


@pytest.fixture(scope="module")
def rig_jax_tokens(rig, rig_work):
    """The JAX dense batcher's tokens on the rig (its XLA slot-LoRA path on
    the CPU)."""
    return _serve(JaxBatcher(rig["tree"], rig["cfg_j"], num_slots=2, max_seq_len=32,
                             adapters=rig["jax_ads"]), rig_work)


@pytest.mark.parametrize("mode", ["plain", "speculative", "chunked speculative"])
def test_dense_batcher_k4_lora_matches_jax(rig, rig_work, rig_jax_tokens, mode):
    """The rig's 4 requests over 2 slots under ad_a, none, ad_b and ad_b
    (an admission into a slot that held another adapter): the port's
    dense batcher, whose steps run K4-LoRA's plain version and whose
    rounds its verify form, gives the JAX batcher's greedy tokens, with
    and without speculation and chunked admissions; the adapters change
    the streams."""
    kw = {"plain": {}, "speculative": {"speculative_k": K},
          "chunked speculative": {"prefill_chunk_size": 4, "speculative_k": K}}[mode]
    batcher = ContinuousBatcher(rig["params"], rig["cfg"], device="cpu", num_slots=2,
                                max_seq_len=32, adapters=rig["port_ads"], **kw)
    launches = (fused_decode.fused_decode_hidden.lora_launches,
                fused_decode.fused_verify_hidden.lora_launches)
    assert batcher.fused is True and "fd_slot_lora" in batcher.params["lm"]
    got = _serve(batcher, rig_work)
    assert got == rig_jax_tokens
    assert got[0] != got[1] and got[0] != got[3]
    # the CPU runs the plain version: no kernel launch is counted
    assert launches == (fused_decode.fused_decode_hidden.lora_launches,
                        fused_decode.fused_verify_hidden.lora_launches)
    if "speculative" in mode:
        assert batcher.stats["verify_rounds"] > 0


@pytest.fixture(scope="module")
def vlm_work(vlm):
    cfg = vlm["cfg"]
    r0, r1 = _request(cfg, 0, extra=3), _request(cfg, 1, extra=6)
    return [(r0, "ad_a"), (r1, None), (r0, "ad_b"), (r0, "ad_a")]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_vlm_batchers_with_adapters_match_jax(vlm, vlm_work, kind):
    """The tiny VLM (per-layer steps, image prompts, ad_b with its own
    projector) through the dense or the paged batcher, with and without
    speculation: tokens equal the JAX batcher's of the same kind. The
    paged one reuses ad_a's pages for the repeat under ad_a and none of
    them for the same prompt under ad_b."""
    make = {"dense": (ContinuousBatcher, JaxBatcher, dict(num_slots=2, max_seq_len=64)),
            "paged": (PagedContinuousBatcher, JaxPaged, PAGED)}[kind]
    port_cls, jax_cls, kw = make
    want = _serve(jax_cls(vlm["tree"], vlm["cfg_j"], adapters=vlm["jax_ads"], **kw), vlm_work)
    for spec in (0, K):
        batcher = port_cls(vlm["params"], vlm["cfg"], device="cpu", adapters=vlm["port_ads"],
                           speculative_k=spec, **kw)
        assert _serve(batcher, vlm_work) == want, spec
        if kind == "paged":
            stats = batcher.prefix.stats()
            assert stats["prefix_cache_hits"] == 1, stats
    assert want[0] != want[2]


def test_prefix_pages_are_not_shared_across_adapters(vlm):
    """The adapter's name seeds the prefix hashes: the same prompt under
    ad_a, then ad_b, then none maps no cached page; a repeat under ad_b
    maps ad_b's pages and gives its tokens."""
    cfg = vlm["cfg"]
    req = _request(cfg, 4, extra=10)
    batcher = PagedContinuousBatcher(vlm["params"], cfg, device="cpu", adapters=vlm["port_ads"],
                                     **PAGED)
    hits = []
    batcher.start()
    try:
        toks = []
        for a in ("ad_a", "ad_b", None, "ad_b"):
            toks.append(batcher.submit(dict(req), MAX_NEW, adapter=a).result(timeout=300))
            hits.append(batcher.prefix.stats()["prefix_cache_hits"])
    finally:
        batcher.stop()
    assert hits == [0, 0, 0, 1]
    assert toks[3] == toks[1] and toks[0] != toks[1]


def test_projector_override_applies_at_admission_only(vlm):
    """ad_b's projector goes into its requests' admissions (prefill_params)
    and nowhere else: the batcher's step params keep the base projector,
    and a request's first token under ad_b's projector with none of ad_b's
    LoRA terms differs from the base's."""
    cfg, params = vlm["cfg"], vlm["params"]
    batcher = ContinuousBatcher(params, cfg, device="cpu", num_slots=2, max_seq_len=64,
                                adapters=vlm["port_ads"])
    sl = batcher.slot_lora
    assert batcher.params["projector"] is params["projector"]
    assert sl.prefill_params(params, "ad_b")["projector"] is sl.projectors["ad_b"]
    assert sl.prefill_params(params, "ad_a")["projector"] is params["projector"]
    dev = device_batch(_request(cfg, 0), torch.float32, "cpu")
    base = prefill(params, cfg, dev, 40)[0]
    proj_only = prefill({**params, "projector": sl.projectors["ad_b"]}, cfg, dev, 40)[0]
    assert (proj_only - base).abs().max() > 1e-3


@pytest.mark.parametrize("cls", [ContinuousBatcher, PagedContinuousBatcher])
def test_submit_refuses_an_unknown_adapter(vlm, cls):
    """As the JAX batchers of the same kind: an adapter name that is not
    loaded, or any name when none are, returns a future that already holds
    the KeyError, with the same message; nothing is queued. A dead loop
    is reported first, as in JAX."""
    paged = cls is PagedContinuousBatcher
    kw = PAGED if paged else dict(num_slots=2, max_seq_len=64)
    jax_cls = JaxPaged if paged else JaxBatcher
    made = {}
    for side, make, params, cfg, ads in (
            ("port", lambda p, c, **k: cls(p, c, device="cpu", **k, **kw), vlm["params"],
             vlm["cfg"], vlm["port_ads"]),
            ("jax", lambda p, c, **k: jax_cls(p, c, **k, **kw), vlm["tree"], vlm["cfg_j"],
             vlm["jax_ads"])):
        made[side] = (make(params, cfg, adapters=ads), make(params, cfg))
    got = {}
    for side, (with_ads, plain) in made.items():
        futs = (with_ads.submit(_request(vlm["cfg"], 0), 4, adapter="nope"),
                plain.submit(_request(vlm["cfg"], 0), 4, adapter="ad_a"))
        assert all(f.done() for f in futs), side
        got[side] = [(type(f.exception()), str(f.exception())) for f in futs]
        assert with_ads.queue.empty() and plain.queue.empty(), side
    assert got["port"] == got["jax"]
    assert got["port"][0][0] is KeyError and "nope" in got["port"][0][1]
    assert "no LoRA adapters" in got["port"][1][1]
    with_ads = made["port"][0]
    with_ads.dead = RuntimeError("boom")
    fut = with_ads.submit(_request(vlm["cfg"], 0), 4, adapter="nope")
    assert isinstance(fut.exception(), RuntimeError) and with_ads.queue.empty()
