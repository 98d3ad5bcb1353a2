"""The port's ContinuousBatchingEngine against the JAX package's on
``LlamaConfig.tiny()`` (w4sym, fused; JAX's weights carried over by
``interop.params_from_numpy``), and the invariants of
``tests/test_continuous.py`` on the port alone.

* Against JAX: three ragged requests on two slots (one waits for a slot),
  greedy. Tokens are identical at every step before the first one where
  JAX's top-1/top-2 margin is within twice the bf16 threshold (1.1e-2 of
  the largest logit, as ``tests/test_torch_engine.py`` gates); the
  logprobs of those steps within twice the threshold of JAX's, scaled by
  the step's largest logit.
* The port alone: the static ``Engine``'s greedy tokens; chunked prefill
  equal to a whole bucket; the prefix store (hit counting, divergent
  tails, LRU, its unit behaviour); eos and ``stop_token_ids``; penalties;
  per-request sampling (keyed per request, top-k 1 equal to greedy,
  logprobs); Gemma-2; the guards.
"""

from collections import OrderedDict

import numpy as np
import pytest
import torch
from test_torch_engine import BF16_RTOL, build_models, jax_trajectory

from flute_tpu.serving.continuous import ContinuousBatchingEngine as JContinuous
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.serving import ContinuousBatchingEngine, Engine, SamplingParams

NEW_TOKENS = 8


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


def engine(config, params, **kw):
    kw = {"num_slots": 2, "max_len": 32, **kw}
    return ContinuousBatchingEngine(params=params, config=config, device="cpu", **kw)


def run(eng, prompts, n=NEW_TOKENS, **kw):
    rids = [eng.submit(p, max_new_tokens=n, **kw) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids], [eng.finished_logprobs[r] for r in rids]


def first_ties(decided):
    return [int(np.argmin(col)) if not col.all() else len(col) for col in decided.T]


@pytest.fixture(scope="module")
def jax_continuous(models):
    """JAX's continuous engine on the three prompts (two slots), and which
    of its steps are decided (JAX's dense Engine's logits)."""
    jconfig, jq, _, _, prompts = models
    jtokens, jlogits = jax_trajectory(jconfig, jq, prompts)
    n = len(prompts)
    jl = jlogits[:, :n]
    scale = np.abs(jl).max(axis=-1)  # [steps, n]
    top2 = np.sort(jl, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * BF16_RTOL * scale
    assert decided.mean() > 0.5, "too many near-ties for the test to say anything"
    jeng = JContinuous(params=jq, config=jconfig, num_slots=2, max_len=32)
    rids = [jeng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    out = jeng.run()
    ties = first_ties(decided)
    tokens = [out[r] for r in rids]
    for i, tie in enumerate(ties):
        assert tokens[i][:tie] == jtokens[i, :tie].tolist()
    return dict(tokens=tokens, logprobs=[jeng.finished_logprobs[r] for r in rids], ties=ties,
                scale=scale)


def test_greedy_matches_jax_continuous_engine(models, jax_continuous):
    _, _, config, tq, prompts = models
    eng = engine(config, tq)
    tokens, logprobs = run(eng, prompts)
    assert [len(t) for t in tokens] == [NEW_TOKENS] * len(prompts)
    compared = 0
    for i, tie in enumerate(jax_continuous["ties"]):
        assert tokens[i][:tie] == jax_continuous["tokens"][i][:tie], i
        got = np.asarray(logprobs[i][:tie])
        want = np.asarray(jax_continuous["logprobs"][i][:tie])
        tol = 2 * BF16_RTOL * jax_continuous["scale"][:tie, i]
        assert (np.abs(got - want) <= tol).all(), (i, got - want)
        compared += tie
    assert compared >= len(prompts), jax_continuous["ties"]


def test_more_requests_than_slots_match_the_static_engine(models):
    """Five requests on two slots: every one gets its budget, each equal to
    the static Engine's greedy tokens for its prompt (the port's dense
    prefill and decode agree with Engine's here, as JAX's do), and a second
    run gives the same tokens."""
    _, _, config, tq, _ = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 100, rng.integers(2, 6)).tolist() for _ in range(5)]
    tokens, _ = run(engine(config, tq), prompts, n=5)
    want = Engine(params=tq, config=config, batch_size=5, max_len=32,
                  device="cpu").generate(prompts, max_new_tokens=5)
    assert tokens == want
    assert run(engine(config, tq), prompts, n=5)[0] == tokens


def test_chunked_prefill_matches_whole_bucket(models):
    _, _, config, tq, _ = models
    prompts = [[1, 5, 9], list(range(2, 25))]  # short, and long (chunks of 8)
    whole = run(engine(config, tq, max_len=64), prompts, n=5)
    assert run(engine(config, tq, max_len=64, prefill_chunk=8), prompts, n=5)[0] == whole[0]
    assert run(engine(config, tq, max_len=64, prefill_chunk=5), prompts, n=5)[0] == whole[0]


def test_prefix_cache_hits_and_divergent_tails(models):
    """A request extending a seen prompt splices the cached blocks and
    prefills only the rest, with the uncached engine's tokens; two tails
    diverging after a shared system prefix both hit its blocks; LRU bounds
    the store."""
    _, _, config, tq, _ = models

    def serve(prompts, entries):
        eng = engine(config, tq, num_slots=1, max_len=64, prefix_cache_entries=entries,
                     prefix_block=4)
        outs = [run(eng, [p], n=5)[0][0] for p in prompts]
        return outs, eng

    base = [1, 5, 9, 2, 6]
    grow = [base, base + [10, 14], base + [10, 14, 3]]
    cold, _ = serve(grow, 0)
    warm, eng = serve(grow, 4)
    assert warm == cold
    assert (eng.prefix_hits, eng.prefix_block_hits, len(eng._prefix_store)) == (2, 2, 2)
    assert len(serve(grow, 1)[1]._prefix_store) == 1
    system = [7, 3, 11, 2, 9, 4, 13, 1]  # two blocks of 4
    tails = [system, system + [21, 22, 23], system + [31, 32]]
    cold, _ = serve(tails, 0)
    warm, eng = serve(tails, 8)
    assert warm == cold
    assert (eng.prefix_hits, eng.prefix_block_hits) == (2, 4)


def test_prefix_store_and_lookup_unit():
    """The block store alone: blocks hold their K/V columns, a lookup is
    contiguous from position 0 over a proper prefix, LRU evicts."""
    eng = object.__new__(ContinuousBatchingEngine)
    eng.prefix_block, eng.prefix_cache_entries = 4, 3
    eng._prefix_store = OrderedDict()
    prompt = list(range(100, 112))  # three blocks of 4
    s = torch.arange(32, dtype=torch.float32).reshape(1, 1, 16, 2)
    eng._store_prefix(prompt, {"k": [s], "v": [s + 100]}, start=0, plen=12)
    assert len(eng._prefix_store) == 3
    assert torch.equal(eng._prefix_store[tuple(prompt[:8])]["k"][0], s[:, :, 4:8])
    assert len(eng._find_prefix(prompt[:8] + [7, 7, 7])) == 2
    assert len(eng._find_prefix(prompt[:8])) == 1  # one token must stay to prefill
    del eng._prefix_store[tuple(prompt[:4])]
    assert eng._find_prefix(prompt) == []
    eng._store_prefix(list(range(200, 208)), {"k": [s], "v": [s]}, start=0, plen=8)
    assert len(eng._prefix_store) == 3 and tuple(prompt[:8]) not in eng._prefix_store


def test_eos_and_stop_tokens(models):
    _, _, config, tq, _ = models
    full = run(engine(config, tq), [[3, 17, 42, 9], [11, 5]])[0]
    eng = engine(config, tq, eos_id=full[0][1])
    assert run(eng, [[3, 17, 42, 9]])[0][0] == full[0][:1]
    stop = full[0][3]
    eng = engine(config, tq)
    seen = []
    eng.token_callback = lambda rid, tok: seen.append((rid, tok))
    r1 = eng.submit([3, 17, 42, 9], max_new_tokens=NEW_TOKENS, stop_token_ids=(stop,))
    r2 = eng.submit([11, 5], max_new_tokens=NEW_TOKENS)
    out = eng.run()
    assert out[r1] == full[0][:full[0].index(stop)]
    assert out[r2] == full[1]
    assert [t for r, t in seen if r == r1] == out[r1]


def test_penalties(models):
    """Default penalties are an identity; repetition and presence penalties
    break the tiny model's loops, the first draw included."""
    _, _, config, tq, _ = models
    prompts = [[3, 17, 42, 9], [11, 5]]
    base, base_lp = run(engine(config, tq), prompts)
    assert any(a == b for t in base for a, b in zip(t, t[1:])), "no loop to break"
    again = run(engine(config, tq), prompts, sampling=SamplingParams(repetition_penalty=1.0))
    assert again == (base, base_lp)
    pen = run(engine(config, tq), prompts, repetition_penalty=1.8)[0]
    assert pen != base and run(engine(config, tq), prompts, repetition_penalty=1.8)[0] == pen
    assert all(a != b for t in pen for a, b in zip(t, t[1:]))
    pres = run(engine(config, tq), prompts, presence_penalty=4.0)[0]
    assert all(a != b for t in pres for a, b in zip(t, t[1:]))


def test_per_request_sampling(models):
    """Sampled requests beside a greedy one: the greedy slot is unaffected,
    a sampled request's tokens depend on its seed alone (not on the batch
    or its slot), top-k 1 is greedy with the same logprobs, and logprobs
    are finite and <= 0."""
    _, _, config, tq, _ = models
    p = [1, 5, 9]
    hot = dict(temperature=3.0, top_k=50)
    eng = engine(config, tq, num_slots=3, max_len=48)
    g = eng.submit(p, max_new_tokens=6)
    s1 = eng.submit(p, max_new_tokens=6, seed=1, **hot)
    s2 = eng.submit(p, max_new_tokens=6, seed=2, **hot)
    out = eng.run()
    greedy, greedy_lp = run(engine(config, tq, num_slots=1, max_len=48), [p], n=6)
    assert out[g] == greedy[0]
    alone = run(engine(config, tq, num_slots=1, max_len=48), [p], n=6, seed=2, **hot)
    assert out[s2] == alone[0][0] and out[s1] != out[s2]
    lp = eng.finished_logprobs[s1]
    assert len(lp) == 6 and all(np.isfinite(v) and v <= 0 for v in lp)
    top1, top1_lp = run(engine(config, tq, num_slots=1, max_len=48), [p], n=6,
                        temperature=0.5, top_k=1)
    assert top1 == greedy
    np.testing.assert_allclose(top1_lp, greedy_lp, rtol=2e-3, atol=2e-4)


def test_gemma2_continuous_engine():
    """Gemma-2 served by default (the config's family, with a [B] pos into
    gemma2.forward): the static Engine's greedy tokens."""
    config = gemma2.Gemma2Config.tiny()
    params = gemma2.quantize_model(gemma2.init_params(config, seed=0, device="cpu"),
                                   group_size=64, fuse=True, device="cpu")
    prompts = [[1, 5, 9], [2, 6, 10, 14], [3, 7]]
    eng = engine(config, params)
    assert eng.forward is gemma2.forward and eng.init_cache is gemma2.init_cache
    tokens, _ = run(eng, prompts, n=4)
    want = Engine(params=params, config=config, forward=gemma2.forward,
                  init_cache=gemma2.init_cache, batch_size=3, max_len=32,
                  device="cpu").generate(prompts, max_new_tokens=4)
    assert tokens == want


def test_guards(models):
    _, _, config, tq, _ = models
    with pytest.raises(TypeError, match="make_mesh"):
        engine(config, tq, mesh=object())
    eng = engine(config, tq)
    assert eng.forward is llama.forward
    with pytest.raises(ValueError, match="either"):
        eng.submit([1, 2], sampling=SamplingParams(), temperature=1.0)
    # a request stops at the cache's end
    eng = engine(config, tq, max_len=16)
    assert len(run(eng, [[1, 2, 3]], n=40)[0][0]) == 16 - 3
