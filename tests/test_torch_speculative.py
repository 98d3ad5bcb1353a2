"""The port's dense SpeculativeEngine and its modified-rejection step against
the JAX package's on ``LlamaConfig.tiny()`` (w4sym, fused; JAX's weights
carried over by ``interop.params_from_numpy``), and the invariants of
``tests/test_speculative.py`` on the port alone.

* Against JAX: the self-draft, greedy, k = 3, three ragged prompts. Tokens
  are identical at every step before the first one where JAX's top-1/top-2
  margin (its dense Engine's logits) is within twice the bf16 threshold
  (1.1e-2 of the largest logit).
* On the CPU, at these sizes, the port's dense T = 1 and T = k+1 steps give
  the same bits (the plain LUT-GEMM's rows do not depend on M; attention
  sums every row in K order), so the port's speculative stream is its
  Engine's greedy stream exactly, whatever the draft, and a self-draft's
  sampled stream is the continuous engine's for the same seeds: both held
  bit for bit.
* ``make_accept_fn`` preserves the target distribution: 8192 slots, a q
  unrelated to p, the first emitted token's histogram within 4 binomial
  sigma (+2e-3) of p, acceptance at position 0 within 0.02 of
  sum(min(p, q)), and bonus tokens distributed as p_k.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_continuous import first_ties
from test_torch_engine import BF16_RTOL, build_models, jax_trajectory

from flute_tpu.serving.speculative import SpeculativeEngine as JSpeculative
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.serving import (
    ContinuousBatchingEngine,
    Engine,
    SamplingParams,
    SpeculativeEngine,
    make_accept_fn,
)

NEW_TOKENS = 8
PROMPTS = [[3, 17, 42, 9], [11, 5]]


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
def drafts(models):
    """A worst-case draft (other random weights) and a one-layer draft."""
    _, _, config, _, _ = models
    bad = llama.quantize_model(llama.init_params(config, seed=7, device="cpu"), group_size=64,
                               fuse=True, device="cpu")
    shallow_config = dataclasses.replace(config, num_layers=1)
    shallow = llama.quantize_model(llama.init_params(shallow_config, seed=3, device="cpu"),
                                   group_size=64, fuse=True, device="cpu")
    return bad, (shallow_config, shallow)


def spec(config, target, draft, draft_config=None, k=3, batch=2, **kw):
    return SpeculativeEngine(target, config, draft, draft_config or config, k=k, max_len=96,
                             batch_size=batch, device="cpu", **kw)


def greedy(config, params, prompts, n, **kw):
    return Engine(params=params, config=config, max_len=96, batch_size=len(prompts),
                  device="cpu", **kw).generate(prompts, max_new_tokens=n)


@pytest.fixture(scope="module")
def jax_spec(models):
    """JAX's speculative engine (self-draft, greedy) on the three prompts,
    and which steps are decided (JAX's dense Engine's logits)."""
    jconfig, jq, _, _, prompts = models
    jtokens, jlogits = jax_trajectory(jconfig, jq, prompts)
    n = len(prompts)
    jl = jlogits[:, :n]
    top2 = np.sort(jl, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * BF16_RTOL * np.abs(jl).max(axis=-1)
    assert decided.mean() > 0.5, "too many near-ties for the test to say anything"
    jeng = JSpeculative(target_params=jq, target_config=jconfig, draft_params=jq,
                        draft_config=jconfig, k=3, max_len=96, batch_size=n)
    tokens = jeng.generate(prompts, max_new_tokens=NEW_TOKENS)
    ties = first_ties(decided)
    for i, tie in enumerate(ties):
        assert tokens[i][:tie] == jtokens[i, :tie].tolist()
    return dict(tokens=tokens, ties=ties, stats=jeng.stats)


def test_self_draft_matches_jax(models, jax_spec):
    _, _, config, tq, prompts = models
    eng = spec(config, tq, tq, batch=len(prompts))
    tokens = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
    assert [len(t) for t in tokens] == [NEW_TOKENS] * len(prompts)
    for i, tie in enumerate(jax_spec["ties"]):
        assert tokens[i][:tie] == jax_spec["tokens"][i][:tie], i
    if min(jax_spec["ties"]) == NEW_TOKENS:  # no near tie: the rounds are JAX's too
        assert dataclasses.astuple(eng.stats) == dataclasses.astuple(jax_spec["stats"])
    assert eng.stats.acceptance_rate == 1.0  # draft and verify share bits on the CPU


def test_self_draft_matches_greedy_with_bonus(models):
    _, _, config, tq, _ = models
    n = 12
    eng = spec(config, tq, tq)
    assert eng.generate(PROMPTS, max_new_tokens=n) == greedy(config, tq, PROMPTS, n)
    assert eng.stats.acceptance_rate == 1.0 and eng.stats.bonus > 0
    assert eng.stats.rounds <= -(-n // (eng.k + 1)) + 1


def test_bad_and_shallow_drafts_still_greedy(models, drafts):
    """An unrelated draft and a one-layer draft (another config: only the
    vocabulary must match) change the speed, never the tokens."""
    _, _, config, tq, _ = models
    bad, (shallow_config, shallow) = drafts
    want = greedy(config, tq, PROMPTS, 12)
    eng = spec(config, tq, bad)
    assert eng.generate(PROMPTS, max_new_tokens=12) == want
    assert 0 < eng.stats.proposed and eng.stats.accepted < eng.stats.proposed
    eng = spec(config, tq, shallow, shallow_config, k=4, batch=1)
    assert eng.generate(PROMPTS[:1], max_new_tokens=10) == [want[0][:10]]


def test_k1_is_plain_decode(models, drafts):
    _, _, config, tq, _ = models
    eng = spec(config, tq, drafts[0], k=1, batch=1)
    assert eng.generate([[11, 5]], max_new_tokens=8) == greedy(config, tq, [[11, 5]], 8)


def test_eos_and_catch_up_with_mixed_slots(models):
    """A sequence stops at eos inside an accepted run; with slot 0 done and
    slot 1 fully accepting, catch-up fills mix slots with and without a
    straggler, and slot 1 still gives the greedy tokens."""
    _, _, config, tq, _ = models
    want = greedy(config, tq, PROMPTS, 16)
    # the first token of sequence 0 that is new to it and absent from 1
    cut = next(i for i, t in enumerate(want[0]) if i and t not in want[0][:i] + want[1])
    eng = spec(config, tq, tq)
    got = eng.generate(PROMPTS, max_new_tokens=16, eos_id=want[0][cut])
    assert got == [want[0][:cut], want[1]]
    assert eng.stats.bonus > 0


def test_accept_preserves_target_distribution():
    rng = np.random.default_rng(0)
    v, b, k = 16, 8192, 2
    p0, q0, pb = (rng.dirichlet(np.ones(v) * 0.3) for _ in range(3))
    p = np.concatenate([np.tile(p0, (b, k, 1)), np.tile(pb, (b, 1, 1))], axis=1)
    q = np.tile(q0, (b, k, 1))
    proposals = rng.choice(v, size=(b, k), p=q0)
    accept = make_accept_fn(k)
    a, corr, bonus = (t.numpy() for t in accept(
        np.arange(b), np.ones(b, np.int64), torch.from_numpy(proposals),
        torch.from_numpy(np.log(p)).float(), torch.from_numpy(np.log(q)).float()))
    first = np.where(a >= 1, proposals[:, 0], corr)
    hist = np.bincount(first, minlength=v) / b
    tol = 4 * np.sqrt(p0 * (1 - p0) / b) + 2e-3
    assert (np.abs(hist - p0) <= tol).all(), np.abs(hist - p0) / tol
    assert abs(float((a >= 1).mean()) - float(np.minimum(p0, q0).sum())) < 0.02
    full = a == k
    assert full.sum() > 500
    bh = np.bincount(bonus[full], minlength=v) / full.sum()
    btol = 4 * np.sqrt(pb * (1 - pb) / full.sum()) + 2e-3
    assert (np.abs(bh - pb) <= btol).all(), np.abs(bh - pb) / btol
    # the draws are keyed: the same seeds and counts give the same results
    again = accept(np.arange(8), np.ones(8, np.int64), torch.from_numpy(proposals[:8]),
                   torch.from_numpy(np.log(p[:8])).float(), torch.from_numpy(np.log(q[:8])).float())
    assert all(np.array_equal(x.numpy(), y[:8]) for x, y in zip(again, (a, corr, bonus)))


def test_sampled_self_draft_is_the_continuous_stream(models):
    """Draft == target, temperature > 0: every proposal is accepted (p and q
    share bits on the CPU) and the stream is the continuous engine's for
    the same per-request seeds, bit for bit; again with the same seeds, the
    same tokens."""
    _, _, config, tq, _ = models
    sp = [SamplingParams(temperature=0.9, seed=s + 5) for s in range(2)]
    cont = ContinuousBatchingEngine(params=tq, config=config, num_slots=2, max_len=96,
                                    device="cpu")
    rids = [cont.submit(p, max_new_tokens=10, sampling=s) for p, s in zip(PROMPTS, sp)]
    res = cont.run()
    eng = spec(config, tq, tq)
    got = eng.generate(PROMPTS, max_new_tokens=10, sampling=sp)
    assert got == [res[r] for r in rids]
    assert eng.stats.acceptance_rate == 1.0
    assert spec(config, tq, tq).generate(PROMPTS, max_new_tokens=10, sampling=sp) == got


def test_sampled_top_k1_is_greedy_and_stop_tokens(models, drafts):
    """top_k = 1 makes p and q one-hot: the rejection step is the greedy
    acceptance, even with a bad draft. A stop token truncates the sampled
    stream where it first appears."""
    _, _, config, tq, _ = models
    want = spec(config, tq, drafts[0]).generate(PROMPTS, max_new_tokens=10)
    got = spec(config, tq, drafts[0]).generate(
        PROMPTS, max_new_tokens=10, sampling=SamplingParams(temperature=1.0, top_k=1, seed=3))
    assert got == want
    sp = SamplingParams(temperature=0.9, top_k=40, seed=123)
    full = spec(config, tq, tq, batch=1).generate(PROMPTS[:1], max_new_tokens=12, sampling=sp)[0]
    stop = full[4]
    cut = spec(config, tq, tq, batch=1).generate(
        PROMPTS[:1], max_new_tokens=12, sampling=dataclasses.replace(sp, stop_token_ids=(stop,)))
    assert cut[0] == full[:full.index(stop)]


def test_gemma2_self_draft():
    config = gemma2.Gemma2Config.tiny()
    params = gemma2.quantize_model(gemma2.init_params(config, seed=0, device="cpu"),
                                   group_size=64, fuse=True, device="cpu")
    eng = spec(config, params, params)
    want = greedy(config, params, PROMPTS, 8, forward=gemma2.forward,
                  init_cache=gemma2.init_cache)
    assert eng.generate(PROMPTS, max_new_tokens=8) == want
    assert eng.stats.bonus > 0


def test_guards(models):
    _, _, config, tq, _ = models
    with pytest.raises(ValueError, match="k must be"):
        spec(config, tq, tq, k=0)
    eng = spec(config, tq, tq)
    with pytest.raises(ValueError, match="penalties"):
        eng.generate(PROMPTS, sampling=SamplingParams(temperature=1.0, repetition_penalty=1.2))
    with pytest.raises(ValueError, match="batch_size"):
        eng.generate(PROMPTS * 2)
    with pytest.raises(ValueError, match="sampling params"):
        eng.generate(PROMPTS, sampling=[SamplingParams()])
