"""The port's serving engines under tensor parallelism, on the CPU: each of
``Engine``, ``ContinuousBatchingEngine``, ``PagedEngine`` (dense prefill
with a shared prefix block, pool prefill in chunks, Gemma-2) and
``PagedSpeculativeEngine`` (self-draft, a greedy and a sampled slot) at
tp = 2 in one gloo world of 2 (``parallel.launch``, rank functions in
``torch_tp_ranks``), against the same engine at tp = 1 in this process on
the same weights: JAX's tiny fused w4sym Llama and its tiny Gemma-2,
carried over by ``interop``, the fused layers permuted rank-major on the
ranks. These are the runs of ``tests/test_tp_serving.py``.

Greedy tokens equal the tp = 1 engine's; every rank's tokens (sampled ones
too: the same seeds, the same logits) equal rank 0's; no block is left in
use; ``Engine`` runs two all-reduces per block per forward; no TP engine is
graphed. The world and the JAX quantization cost about 30 s here.
"""

import pytest
import torch
import torch_tp_ranks
from test_torch_llama import to_numpy_tree

from flute_tpu.models import gemma2 as jgemma2
from flute_tpu.models import llama as jllama
from flute_tpu_torch import interop
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.parallel import launch
from flute_tpu_torch.serving import (
    ContinuousBatchingEngine,
    Engine,
    PagedEngine,
    PagedSpeculativeEngine,
)

SYSTEM = list(range(1, 9))
SAMPLED = dict(temperature=0.9, top_k=40, seed=123)
# name: (engine, params, fused, keywords, requests (prompt, new tokens, sampling))
RUNS = {
    "engine": ("Engine", "llama_fused", True, dict(max_len=64, batch_size=2),
               ([[5, 9, 2, 7], [11, 3]], 8)),
    "continuous": ("ContinuousBatchingEngine", "llama_fused", True,
                   dict(num_slots=4, max_len=64),
                   [([5, 9, 2, 7], 6, {}), ([11, 3], 5, {}), ([1, 2, 3], 4, {}),
                    ([7, 7, 1], 5, SAMPLED)]),
    "paged_prefix": ("PagedEngine", "llama_fused", True,
                     dict(num_slots=1, block_size=8, num_blocks=10, max_len=32,
                          prefix_cache_blocks=2),
                     [(SYSTEM + [5, 9], 6, {}), (SYSTEM + [11], 5, {}), ([7, 3], 4, {})]),
    "paged_pool": ("PagedEngine", "llama_fused", True,
                   dict(num_slots=2, block_size=8, num_blocks=12, max_len=32,
                        pool_prefill=True, prefill_chunk=4),
                   [([3, 17, 42, 9], 8, {}), ([11, 5, 8, 1, 13, 2, 7], 8, {})]),
    "paged_gemma2": ("PagedEngine", "gemma2", False,
                     dict(num_slots=2, block_size=8, num_blocks=10, max_len=32),
                     [([3, 17, 42, 9], 6, {}), ([11, 5, 8], 6, {})]),
    "paged_spec": ("PagedSpeculativeEngine", "llama_fused", True,
                   dict(k=3, num_slots=2, block_size=8, num_blocks=12, max_len=32),
                   [([3, 17, 42, 9], 8, {}), ([11, 5], 8, SAMPLED)]),
}
CLASSES = {"Engine": Engine, "ContinuousBatchingEngine": ContinuousBatchingEngine,
           "PagedEngine": PagedEngine, "PagedSpeculativeEngine": PagedSpeculativeEngine}


@pytest.fixture(scope="module")
def trees():
    lcfg, gcfg = jllama.LlamaConfig.tiny(), jgemma2.Gemma2Config.tiny()
    return {
        "llama_fused": to_numpy_tree(jllama.quantize_model(
            jllama.init_params(lcfg, rng=0), 4, 64, chunk=128, fuse=True)),
        "gemma2": to_numpy_tree(jgemma2.quantize_model(jgemma2.init_params(gcfg, rng=0), 4, 64)),
    }


@pytest.fixture(scope="module")
def world(trees):
    runs = [(name, *spec) for name, spec in RUNS.items()]
    return launch.run(torch_tp_ranks.engines_rank, 2, trees, runs, threads=1, timeout=600)


def tp1_run(trees, name):
    """The run at tp = 1 in this process: tokens and the engine."""
    cls, key, _, kw, reqs = RUNS[name]
    cfg = gemma2.Gemma2Config.tiny() if key == "gemma2" else llama.LlamaConfig.tiny()
    params = interop.params_from_numpy(trees[key], device="cpu")
    kw = dict(kw, device="cpu")
    if cls == "PagedSpeculativeEngine":
        kw.update(draft_params=params, draft_config=cfg)
    eng = CLASSES[cls](params=params, config=cfg, **kw)
    if cls == "Engine":
        prompts, n = reqs
        return eng.generate(prompts, max_new_tokens=n), eng
    rids = [eng.submit(p, max_new_tokens=n, **s) for p, n, s in reqs]
    out = eng.run()
    return [out[r] for r in rids], eng


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(RUNS))
def test_tp2_engine_gives_the_tp1_tokens(trees, world, name):
    want, eng1 = tp1_run(trees, name)
    got = world[0][name]
    reqs = RUNS[name][4]
    greedy = range(len(want)) if RUNS[name][0] == "Engine" else [
        i for i, (_, _, s) in enumerate(reqs) if not s]
    for i in greedy:
        assert got["tokens"][i] == want[i], (name, i)
    for r in world[1:]:
        assert r[name]["tokens"] == got["tokens"]  # sampled slots too
    if got["blocks_in_use"] is not None:
        assert got["blocks_in_use"] == 0 == eng1.blocks_in_use
    if name == "paged_prefix":
        assert got["prefix_hits"] == eng1.prefix_hits == 1
    assert got["graphed"] is False and all(len(t) > 0 for t in got["tokens"])


def test_engine_runs_two_all_reduces_per_block_per_forward(world):
    """``Engine.generate`` of 8 tokens: one prefill and 7 decode steps."""
    layers = llama.LlamaConfig.tiny().num_layers
    for r in world:
        assert r["engine"]["all_reduces"] == 2 * layers * 8
        for name in RUNS:
            assert r[name]["all_reduces"] % (2 * layers) == 0 and r[name]["all_reduces"] > 0


def test_which_engines_take_a_mesh():
    """The four engines take a mesh; the dense speculative engine has none,
    as in the JAX package."""
    from flute_tpu.serving import speculative as jspeculative
    from flute_tpu_torch.serving import SpeculativeEngine

    assert "mesh" not in SpeculativeEngine.__dataclass_fields__
    assert "mesh" not in jspeculative.SpeculativeEngine.__dataclass_fields__
    assert all("mesh" in cls.__dataclass_fields__ for cls in CLASSES.values())
