"""The port's PagedSpeculativeEngine against the JAX package's on
``LlamaConfig.tiny()`` (w4sym, fused; JAX's weights carried over by
``interop.params_from_numpy``), and the invariants of
``tests/test_paged_spec.py`` on the port alone.

* Against JAX: the self-draft, greedy, k = 3, three ragged requests on
  three slots. Tokens are identical at every step before the first one
  where JAX's top-1/top-2 margin (its dense Engine's logits) is within
  twice the bf16 threshold (1.1e-2 of the largest logit); the first
  token's logprob within twice the threshold of JAX's, scaled by the
  largest logit; no block in use at the end, in both.
* On the CPU, at these sizes, the paged T = k+1 verify gives the bits of
  PagedEngine's T = 1 step, so the emitted greedy stream is PagedEngine's
  exactly, whatever the draft. The draft's dense T = 1 logits do not share
  those bits (dense and paged attention add in other orders), so a
  self-draft accepts almost every proposal, not all, and its sampled
  stream is held by the
  distribution of ``make_accept_fn`` (``tests/test_torch_speculative.py``),
  its determinism per seed and slot, and top-k 1 being greedy.
"""

import numpy as np
import pytest
import torch
from test_torch_continuous import first_ties
from test_torch_engine import BF16_RTOL, build_models, jax_trajectory

from flute_tpu.serving.paged_spec import PagedSpeculativeEngine as JPagedSpec
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.serving import PagedEngine, PagedSpeculativeEngine, SamplingParams

NEW_TOKENS = 8
PROMPTS = [[3, 17, 42, 9], [11, 5]]
KW = dict(block_size=8, num_blocks=16, max_len=64)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Many small CPU ops beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return build_models(4)


@pytest.fixture(scope="module")
def bad_draft(models):
    _, _, config, _, _ = models
    return llama.quantize_model(llama.init_params(config, seed=7, device="cpu"), group_size=64,
                                fuse=True, device="cpu")


def paged_spec(config, target, draft, k=3, slots=2, **kw):
    kw = {**KW, **kw}
    return PagedSpeculativeEngine(params=target, config=config, draft_params=draft,
                                  draft_config=config, k=k, num_slots=slots, device="cpu", **kw)


def serve(eng, prompts, n=NEW_TOKENS, **kw):
    rids = [eng.submit(p, max_new_tokens=n, **kw) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def paged_greedy(config, params, prompts, n, **kw):
    kw = {**KW, **kw}
    return serve(PagedEngine(params=params, config=config, num_slots=len(prompts), device="cpu",
                             **kw), prompts, n)


@pytest.fixture(scope="module")
def jax_paged_spec(models):
    jconfig, jq, _, _, prompts = models
    jtokens, jlogits = jax_trajectory(jconfig, jq, prompts)
    n = len(prompts)
    jl = jlogits[:, :n]
    scale = np.abs(jl).max(axis=-1)
    top2 = np.sort(jl, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * BF16_RTOL * scale
    assert decided.mean() > 0.5, "too many near-ties for the test to say anything"
    jeng = JPagedSpec(params=jq, config=jconfig, draft_params=jq, draft_config=jconfig, k=3,
                      num_slots=n, block_size=8, num_blocks=16, max_len=48)
    rids = [jeng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    out = jeng.run()
    assert jeng.blocks_in_use == 0
    ties = first_ties(decided)
    tokens = [out[r] for r in rids]
    for i, tie in enumerate(ties):
        assert tokens[i][:tie] == jtokens[i, :tie].tolist()
    return dict(tokens=tokens, ties=ties, scale=scale,
                first_lp=[jeng.finished_logprobs[r][0] for r in rids])


def test_self_draft_matches_jax(models, jax_paged_spec):
    _, _, config, tq, prompts = models
    eng = paged_spec(config, tq, tq, slots=len(prompts), num_blocks=16, max_len=48)
    rids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    out = eng.run()
    tokens = [out[r] for r in rids]
    assert [len(t) for t in tokens] == [NEW_TOKENS] * len(prompts)
    for i, tie in enumerate(jax_paged_spec["ties"]):
        assert tokens[i][:tie] == jax_paged_spec["tokens"][i][:tie], i
        lp = eng.finished_logprobs[rids[i]]
        assert len(lp) == 1  # as JAX: the rounds record no logprobs
        assert abs(lp[0] - jax_paged_spec["first_lp"][i]) <= 2 * BF16_RTOL * jax_paged_spec[
            "scale"][0, i]
    assert eng.blocks_in_use == 0 and eng.stats.bonus > 0


def test_self_draft_is_paged_greedy_with_bonus(models):
    _, _, config, tq, _ = models
    eng = paged_spec(config, tq, tq)
    assert serve(eng, PROMPTS) == paged_greedy(config, tq, PROMPTS, NEW_TOKENS)
    assert eng.stats.bonus > 0 and eng.stats.acceptance_rate > 0.8
    assert eng.stats.rounds <= -(-NEW_TOKENS // (eng.k + 1)) + 1
    assert eng.blocks_in_use == 0


def test_bad_draft_and_k1_still_greedy(models, bad_draft):
    _, _, config, tq, _ = models
    want = paged_greedy(config, tq, PROMPTS, 10)
    eng = paged_spec(config, tq, bad_draft)
    assert serve(eng, PROMPTS, 10) == want
    assert eng.stats.acceptance_rate < 1.0 and eng.blocks_in_use == 0
    assert serve(paged_spec(config, tq, bad_draft, k=1), PROMPTS, 10) == want


def test_sampling(models, bad_draft):
    """Sampled self-draft: almost every proposal accepted; a request's
    tokens depend on its seed alone (not on the batch or its slot); top-k 1
    is the greedy stream, even with a bad draft; a greedy neighbour keeps
    its greedy tokens; a stop token truncates the stream."""
    _, _, config, tq, _ = models
    kw = dict(temperature=0.9, top_k=40, seed=123)
    eng = paged_spec(config, tq, tq)
    both = serve(eng, PROMPTS, 10, **kw)
    assert eng.stats.acceptance_rate > 0.8 and eng.blocks_in_use == 0
    alone = serve(paged_spec(config, tq, tq, slots=1), PROMPTS[1:], 10, **kw)
    assert alone[0] == both[1]
    mixed = paged_spec(config, tq, tq)
    r1 = mixed.submit(PROMPTS[0], max_new_tokens=10)
    r2 = mixed.submit(PROMPTS[1], max_new_tokens=10, **kw)
    out = mixed.run()
    assert out[r1] == paged_greedy(config, tq, PROMPTS[:1], 10)[0]
    assert out[r2] == both[1]
    top1 = serve(paged_spec(config, tq, bad_draft), PROMPTS, 10,
                 sampling=SamplingParams(temperature=1.0, top_k=1, seed=3))
    assert top1 == paged_greedy(config, tq, PROMPTS, 10)
    stop = both[0][4]
    cut = serve(paged_spec(config, tq, tq), PROMPTS[:1], 10, stop_token_ids=(stop,), **kw)[0]
    assert cut == both[0][:both[0].index(stop)]


def test_pool_pressure_and_prefix_sharing(models):
    """Four requests sharing a one-block prefix on a pool too small for all
    at once: they queue, share the block by reference, give the greedy
    tokens, and every block comes back."""
    _, _, config, tq, _ = models
    common = [5, 9, 2, 14, 3, 8, 1, 6]  # one block of 8
    prompts = [common + [i + 20] for i in range(4)]
    kw = dict(num_blocks=10, max_len=40, prefix_cache_blocks=2)
    eng = paged_spec(config, tq, tq, k=2, **kw)
    waited = []
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    while eng.step():
        waited.append(bool(eng._queue))
    out = eng.run()
    assert [out[r] for r in rids] == paged_greedy(config, tq, prompts, 6, num_blocks=40,
                                                  max_len=40)
    assert any(waited) and eng.prefix_hits >= 1 and eng.blocks_in_use == 0


def test_pool_prefill(models):
    _, _, config, tq, _ = models
    prompts = [[3, 17, 42, 9], [11, 5, 8, 1, 13, 2, 7]]
    eng = paged_spec(config, tq, tq, num_blocks=14, max_len=48, pool_prefill=True,
                     prefill_chunk=4)
    assert serve(eng, prompts) == paged_greedy(config, tq, prompts, NEW_TOKENS)
    assert eng.stats.bonus > 0 and eng.blocks_in_use == 0


def test_gemma2_target_and_draft():
    """Gemma-2 on both sides: the softcap and the sliding window (8 in the
    tiny config, crossed by the k-ahead run) in K6's plain version, the
    draft through its own dense forward."""
    config = gemma2.Gemma2Config.tiny()
    params = gemma2.quantize_model(gemma2.init_params(config, seed=0, device="cpu"),
                                   group_size=64, fuse=True, device="cpu")
    prompts = [[3, 17, 42, 9], [11, 5, 8, 1, 13, 2]]
    kw = dict(num_blocks=12, max_len=32)
    eng = paged_spec(config, params, params, **kw)
    assert eng._dfwd is gemma2.forward
    assert serve(eng, prompts) == paged_greedy(config, params, prompts, NEW_TOKENS, **kw)
    assert eng.stats.bonus > 0 and eng.blocks_in_use == 0


def test_guards(models):
    _, _, config, tq, _ = models
    with pytest.raises(ValueError, match="draft_params"):
        PagedSpeculativeEngine(params=tq, config=config, device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        paged_spec(config, tq, tq, k=0)
    with pytest.raises(TypeError, match="make_mesh"):
        paged_spec(config, tq, tq, mesh=object())
    eng = paged_spec(config, tq, tq, k=4, slots=1, num_blocks=8, max_len=32)
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(list(range(20)), max_new_tokens=8)  # 20 + 8 + (4 + 1) > 32
    eng.submit(list(range(20)), max_new_tokens=7)
    with pytest.raises(ValueError, match="penalties"):
        eng.submit([1, 2], max_new_tokens=4, repetition_penalty=1.2)
    plain = PagedEngine(params=tq, config=config, device="cpu", **KW)
    plain.submit(list(range(20)), max_new_tokens=8, repetition_penalty=1.2)  # the parent takes both
