"""Pipeline parallelism, ring attention and the multi-process train step
of the port on gloo process groups of the CPU, against the JAX package
on its 8-device CPU mesh.

Two worlds are spawned once each (`tokenpacker_tpu_torch.parallel.dryrun`,
children that import the port and never JAX): 2 ranks (dp 1 x pp 2, a
ring of 2) and 4 ranks (dp 2 x pp 2, a ring of 4). The pipeline's
forward and backward of mean(h^2) through a 4-layer stack of the tiny
config are held to JAX's `pipeline_llama_hidden` on the same meshes and
to its scan reference (`llama_apply`): loss within rtol 1e-5, gradients
within rtol 3e-4 / atol 3e-5 (`tests/test_pipeline.py`). Ring attention
(causal and not) is held to JAX's `ring_attention` over 2 and 4 devices
and to full attention within 2e-5. `parallel/multihost`'s train step as
2 processes (tp 2) equals the world of one within 1e-5
(`tests/test_multihost.py:51`). Every child has a timeout and its group is
killed on a failure.
"""

import re
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tokenpacker_tpu.models.llama import llama_apply, make_attention_bias
from tokenpacker_tpu.ops.flash_attention import attention_reference
from tokenpacker_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from tokenpacker_tpu.parallel import mesh as jax_mesh
from tokenpacker_tpu.parallel import pipeline as jax_pipeline
from tokenpacker_tpu_torch.io.weights import params_to_jax
from tokenpacker_tpu_torch.parallel import dryrun, pipeline
from tokenpacker_tpu_torch.parallel.mesh import Mesh
from tokenpacker_tpu_torch.parallel.multihost import run_dryrun

CHILD_TIMEOUT = 90


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{2: rank 0's results, 4: ...} of the two spawned worlds, and the
    multihost processes' outputs, run side by side."""
    work = tmp_path_factory.mktemp("pipeline")
    box = {}

    def run(n):
        try:
            dryrun.launch(n, ["--device", "cpu", "--scenarios", "pipeline,ring", "--pp", "2",
                              "--out", str(work / f"out{n}.pt")], CHILD_TIMEOUT,
                          env={"OMP_NUM_THREADS": "1"})
            box[n] = torch.load(work / f"out{n}.pt", weights_only=False)
        except Exception as e:  # noqa: BLE001 - re-raised in the tests
            box[f"error{n}"] = e

    def multihost():
        try:
            box["multihost"] = dryrun.launch(
                2, ["--device", "cpu", "--tp", "2"], CHILD_TIMEOUT,
                module="tokenpacker_tpu_torch.parallel.multihost",
                env={"OMP_NUM_THREADS": "1"},
                rank_flags=lambda r, n, port: ["--coordinator", f"127.0.0.1:{port}",
                                               "--num-processes", str(n),
                                               "--process-id", str(r)])
        except Exception as e:  # noqa: BLE001
            box["error_mh"] = e

    threads = [threading.Thread(target=run, args=(2,)), threading.Thread(target=run, args=(4,)),
               threading.Thread(target=multihost)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(CHILD_TIMEOUT + 30)
    for key in ("error2", "error4", "error_mh"):
        if key in box:
            raise box[key]
    return box


def _jax_pipeline(out, m: int = 2):
    """JAX's pipeline and scan reference on the run's weights and input:
    (loss, grads) of each."""
    dp, pp, layers = out["dp"], out["pp"], out["layers"]
    lm = dryrun._tiny(num_hidden_layers=layers).lm
    port = dryrun.seeded_weights("pipeline")
    params = jax.tree.map(jnp.asarray,
                          params_to_jax({**port, "layers": port["layers"][:layers]}))
    from tokenpacker_tpu.config import tiny_vlm_config

    cfg = tiny_vlm_config().lm.__class__(**{**tiny_vlm_config().lm.__dict__,
                                            "num_hidden_layers": layers})
    x = jnp.asarray(out["x"])
    b, t = x.shape[:2]
    positions = jnp.broadcast_to(jnp.arange(t), (b, t))
    key_valid = jnp.ones((b, t), bool)
    mesh = jax_pipeline.make_pp_mesh(pp=pp, dp=dp, devices=jax.devices()[:dp * pp])

    def pp_loss(p):
        h = jax_pipeline.pipeline_llama_hidden(p, cfg, x, positions, key_valid, mesh,
                                               num_microbatches=m)
        return jnp.mean(h ** 2)

    def ref_loss(p):
        bias = make_attention_bias(positions, key_valid, jnp.zeros((), jnp.int32), t)
        h, _ = llama_apply(p, cfg, x, positions, bias, cache=None, use_flash=False)
        return jnp.mean(h ** 2)

    sharded = jax.device_put(params, jax_pipeline.pp_param_shardings(params, mesh))
    assert lm.hidden_size == cfg.hidden_size
    return (jax.jit(jax.value_and_grad(pp_loss))(sharded),
            jax.jit(jax.value_and_grad(ref_loss))(params))


def _port_grad_tree(grads: dict, like):
    """The port's {'layers/i/...': grad} as JAX's stacked tree."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + [k]) for k, v in node.items()}
        if path and path[0] == "layers":
            return np.stack([grads["/".join(["layers", str(i)] + path[1:])]
                             for i in range(node.shape[0])])
        return grads["/".join(path)]
    return walk(like, [])


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_forward_and_backward_match_jax(worlds, n):
    out = worlds[n]["pipeline"]
    assert (out["dp"], out["pp"]) == ((1, 2) if n == 2 else (2, 2))
    (pl, pg), (rl, rg) = _jax_pipeline(out)
    for loss, grads in ((pl, pg), (rl, rg)):
        np.testing.assert_allclose(out["loss"], float(loss), rtol=1e-5)
        got = _port_grad_tree(out["grads"], jax.device_get(grads))
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(grads),
                                jax.tree.leaves(got)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=3e-4, atol=3e-5, err_msg=str(path))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(worlds, n, causal):
    out = worlds[n]["ring"]
    q, k, v = (jnp.asarray(a) for a in out["qkv"])
    mesh = jax_mesh.make_mesh(dp=n, tp=1, devices=jax.devices()[:n])
    sharding = NamedSharding(mesh, P(None, "data"))
    with jax.set_mesh(mesh):
        want = jax_ring_attention(*(jax.device_put(a, sharding) for a in (q, k, v)), mesh,
                                  axis="data", causal=causal)
    np.testing.assert_allclose(out[causal], np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out[causal], np.asarray(attention_reference(q, k, v,
                                                                           causal=causal)),
                               rtol=2e-5, atol=2e-5)


def test_multihost_two_processes_match_the_world_of_one(worlds):
    expected = run_dryrun(tp=1, device="cpu")
    losses = []
    for pid, text in enumerate(worlds["multihost"]):
        m = re.search(rf"multihost_dryrun: pid={pid}/2 .* loss=([0-9.]+) OK", text)
        assert m, text[-2000:]
        losses.append(float(m.group(1)))
    assert losses[0] == losses[1]
    assert abs(losses[0] - expected) < 1e-5, (losses, expected)


def test_pipeline_keeps_jax_divisibility_errors():
    with pytest.raises(ValueError, match="1 devices not divisible by pp=3"):
        pipeline.make_pp_mesh(pp=3, device="cpu")
    with pytest.raises(ValueError, match=r"dp\*pp = 4 != 1 devices"):
        pipeline.make_pp_mesh(pp=2, dp=2, device="cpu")
    stages = Mesh(("data", "stage"), (1, 4), "cpu", rank=0)
    with pytest.raises(ValueError, match="6 layers not divisible by 4 stages"):
        pipeline.shard_pp_params({"layers": [{}] * 6}, stages)
    rows = Mesh(("data", "stage"), (2, 1), "cpu", rank=0)
    with pytest.raises(ValueError, match="batch 6 not divisible by dp\\*microbatches 4"):
        pipeline.pipeline_llama_hidden({"layers": []}, dryrun._tiny().lm,
                                       torch.zeros(6, 4, 64), torch.zeros(6, 4), None, rows, 2)
    assert pipeline.pp_param_shardings({"layers": [{}, {}], "norm": {}}, stages) == {
        "layers": [("stage",), ("stage",)], "norm": ()}
