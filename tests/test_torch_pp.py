"""The port's pipeline parallelism (``flute_tpu_torch.parallel.pp``) against
the JAX package's, the seven tests of ``tests/test_pp.py`` with the stages
on ``"cpu"``, on JAX's tiny Llama (w4sym, chunk 128) carried over by
``interop``.

In one process every stage runs the model's own code, so the pipeline
gives the monolithic ``llama.forward``'s bits, prefill and decode alike;
against JAX's ``PipelinedModel`` the logits are held to the bf16 threshold
(1.1e-2 of the largest logit). Microbatching gives the sequential
pipeline's bits and caches, resident per microbatch: a steady-state step
concatenates no whole cache and writes each microbatch's cache in place.
tp x pp (two stages of tp = 2) runs in a gloo world of 4 against JAX's
``build_tp`` over four virtual devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_tp_ranks
from test_torch_llama import to_numpy_tree

from flute_tpu.models import llama as jllama
from flute_tpu.parallel import make_mesh as jmake_mesh
from flute_tpu.parallel.pp import PipelinedModel as JPipelinedModel
from flute_tpu.parallel.pp import split_stages as jsplit_stages
from flute_tpu_torch import interop
from flute_tpu_torch.models import llama
from flute_tpu_torch.parallel import launch
from flute_tpu_torch.parallel.pp import (
    PipelinedModel,
    merge_cache_microbatches,
    split_cache_microbatches,
    split_stages,
)

BF16_RTOL = 1.1e-2


def max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.fixture(scope="module")
def tiny_q():
    jconfig = jllama.LlamaConfig.tiny()
    jq = jllama.quantize_model(jllama.init_params(jconfig, rng=0), 4, 64, chunk=128)
    tree = to_numpy_tree(jq)
    return jconfig, jq, llama.LlamaConfig.tiny(), interop.params_from_numpy(tree, device="cpu"), tree


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tokens(seed, b, t):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 100, (b, t)))


def build(config, params):
    return PipelinedModel.build(params, config, num_stages=2, devices=["cpu"])


def test_split_stages_covers_all_layers(tiny_q):
    jconfig, jq, config, params, _ = tiny_q
    for n in (1, 2, 3):
        stages, jstages = split_stages(params, n), jsplit_stages(jq, n)
        assert [len(s["layers"]) for s in stages] == [len(s["layers"]) for s in jstages]
        assert [sorted(s) for s in stages] == [sorted(s) for s in jstages]
    stages = split_stages(params, 2)
    assert sum(len(s["layers"]) for s in stages) == config.num_layers
    assert "embed" in stages[0] and "final_norm" in stages[1]


def test_pipelined_forward_matches_monolithic(tiny_q):
    jconfig, jq, config, params, _ = tiny_q
    pm = build(config, params)
    b, t, s = 2, 6, 12
    toks = tokens(1, b, t)
    logits_pp, _ = pm.forward(toks, pm.init_cache(b, s), 0)
    with torch.inference_mode():
        logits_1, _ = llama.forward(params, config, toks, llama.init_cache(config, b, s, device="cpu"), 0)
    np.testing.assert_array_equal(logits_pp.numpy(), logits_1.numpy())
    jpm = JPipelinedModel.build(jq, jconfig, num_stages=2, devices=jax.devices()[:2])
    jlogits, _ = jpm.forward(jnp.asarray(toks.numpy(), jnp.int32), jpm.init_cache(b, s), 0)
    assert max_rel(logits_pp.numpy(), jlogits) < BF16_RTOL


def test_pipelined_decode_steps(tiny_q):
    """Decode through the pipeline: the same bits run after run, and the
    monolithic forward's at every step."""
    _, _, config, params, _ = tiny_q
    pm = build(config, params)
    prompt = torch.tensor([[3, 7, 11, 15]])

    def run(fwd, cache):
        logits, cache = fwd(prompt, cache, 0)
        steps = [logits[:, -1].clone()]
        pos = prompt.shape[1]
        for _ in range(3):
            nxt = torch.argmax(steps[-1], dim=-1)[:, None]
            logits, cache = fwd(nxt, cache, pos)
            steps.append(logits[:, -1].clone())
            pos += 1
        return torch.stack(steps)

    a = run(pm.forward, pm.init_cache(1, 12))
    np.testing.assert_array_equal(a.numpy(), run(pm.forward, pm.init_cache(1, 12)).numpy())
    with torch.inference_mode():
        mono = run(lambda t, c, p: llama.forward(params, config, t, c, p),
                   llama.init_cache(config, 1, 12, device="cpu"))
    np.testing.assert_array_equal(a.numpy(), mono.numpy())


def _assert_caches_equal(a, b):
    for ca, cb in zip(a, b):
        for kv in ("k", "v"):
            for x, y in zip(ca[kv], cb[kv]):
                np.testing.assert_array_equal(x.float().numpy(), y.float().numpy())


def test_microbatched_matches_sequential(tiny_q):
    _, _, config, params, _ = tiny_q
    pm = build(config, params)
    b, t, s = 4, 6, 12
    toks = tokens(2, b, t)
    logits_seq, caches_seq = pm.forward(toks, pm.init_cache(b, s), 0)
    logits_mb, caches_mb = pm.forward_microbatched(toks, pm.init_cache(b, s), 0,
                                                   num_microbatches=2)
    np.testing.assert_array_equal(logits_mb.numpy(), logits_seq.numpy())
    _assert_caches_equal(caches_seq, caches_mb)
    # per-sequence positions (the continuous-batching path) microbatch too
    pos = torch.tensor([0, 1, 0, 2])
    lv_seq, _ = pm.forward(toks, pm.init_cache(b, s), pos)
    lv_mb, _ = pm.forward_microbatched(toks, pm.init_cache(b, s), pos, num_microbatches=2)
    np.testing.assert_array_equal(lv_mb.numpy(), lv_seq.numpy())
    with pytest.raises(ValueError):
        pm.forward_microbatched(toks[:3], pm.init_cache(3, s), 0, num_microbatches=2)


def test_microbatched_resident_caches(tiny_q):
    """Split once, step on the per-microbatch form, merge at the end: the
    sequential pipeline's logits and caches."""
    _, _, config, params, _ = tiny_q
    pm = build(config, params)
    b, t, s = 4, 4, 12
    toks = tokens(5, b, t)
    caches_mb = split_cache_microbatches(pm.init_cache(b, s), 2)
    logits, caches_mb = pm.forward_microbatched(toks, caches_mb, 0, num_microbatches=2)
    assert isinstance(caches_mb[0], list) and len(caches_mb[0]) == 2
    assert caches_mb[0][0]["k"][0].shape[0] == b // 2
    caches = pm.init_cache(b, s)
    lg, caches = pm.forward(toks, caches, 0)
    pos = t
    for _ in range(2):
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        logits, caches_mb = pm.forward_microbatched(nxt, caches_mb, pos, num_microbatches=2)
        lg, caches = pm.forward(torch.argmax(lg[:, -1], dim=-1)[:, None], caches, pos)
        pos += 1
    np.testing.assert_array_equal(logits.numpy(), lg.numpy())
    _assert_caches_equal(caches, merge_cache_microbatches(caches_mb))


def test_microbatched_steady_state_has_no_full_cache_concat(tiny_q, monkeypatch):
    """A steady-state step on resident caches concatenates no whole-batch
    cache (only the logits), and writes each microbatch's cache in place."""
    _, _, config, params, _ = tiny_q
    pm = build(config, params)
    b, s, m = 4, 12, 2
    caches_mb = split_cache_microbatches(pm.init_cache(b, s), m)
    ptrs = [[c["k"][0].data_ptr() for c in stage] for stage in caches_mb]
    shapes = []
    cat = torch.cat

    def recording_cat(xs, *args, **kw):
        out = cat(xs, *args, **kw)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "cat", recording_cat)
    logits, caches_mb = pm.forward_microbatched(torch.full((b, 1), 5), caches_mb, 3,
                                                num_microbatches=m)
    full = (b, config.num_kv_heads, s, config.head_dim)
    assert full not in shapes and (b, 1, config.vocab_size) in shapes
    assert [[c["k"][0].data_ptr() for c in stage] for stage in caches_mb] == ptrs
    assert all(c["k"][0][:, :, 3].abs().sum() > 0 for stage in caches_mb for c in stage)


def test_pp_tp_composition(tiny_q):
    """tp x pp (ranks 0-1 hold stage 0, ranks 2-3 stage 1, tp = 2 each):
    every rank's prefill logits within the threshold of JAX's composed
    model over four virtual devices and of the port's pipeline in one
    process, and its decode step's within it of the one-process pipeline's
    on the same token; the ranks agree bit for bit."""
    jconfig, jq, config, params, tree = tiny_q
    b, t, s = 2, 6, 12
    toks = tokens(6, b, t).numpy()
    world = launch.run(torch_tp_ranks.pp_tp_rank, 4, tree, toks, s, threads=1, timeout=300)
    assert [w["stages"] for w in world] == [[True, False]] * 2 + [[False, True]] * 2
    for w in world[1:]:
        np.testing.assert_array_equal(w["logits"], world[0]["logits"])
        np.testing.assert_array_equal(w["step"], world[0]["step"])
    devs = jax.devices()
    jpm = JPipelinedModel.build_tp(jq, jconfig, [jmake_mesh(tp=2, dp=1, devices=devs[0:2]),
                                                 jmake_mesh(tp=2, dp=1, devices=devs[2:4])])
    jlogits, _ = jpm.forward(jnp.asarray(toks, jnp.int32), jpm.init_cache(b, s), 0)
    assert max_rel(world[0]["logits"], jlogits) < BF16_RTOL
    pm = build(config, params)
    caches = pm.init_cache(b, s)
    lg, caches = pm.forward(torch.from_numpy(toks), caches, 0)
    assert max_rel(world[0]["logits"], lg.numpy()) < BF16_RTOL
    nxt = torch.from_numpy(world[0]["logits"][:, -1].argmax(-1))[:, None]
    step, _ = pm.forward(nxt, caches, t)
    assert max_rel(world[0]["step"], step.numpy()) < BF16_RTOL
