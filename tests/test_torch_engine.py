"""The port's serving engine against the JAX package's on ``tiny()``.

Both engines serve the same ragged prompts greedily from the same quantized
params (made by the JAX package, carried over through interop). The port is
then teacher-forced with JAX's tokens and its step logits are held against
JAX's within the bf16 threshold. Token identity is asserted at every step
where JAX's top-1/top-2 margin exceeds twice that threshold, so a near-tie
cannot make the test a coin flip; the port's own greedy run must match JAX
up to the first such near-tie of each sequence. This holds at w4sym and at
W3 (the wide layout).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_llama import to_numpy_tree

from flute_tpu.models import llama as jllama
from flute_tpu.serving import Engine as JEngine
from flute_tpu_torch import interop
from flute_tpu_torch.models import llama
from flute_tpu_torch.serving import Engine, greedy_generate, greedy_generate_fused, sample_logits

BF16_RTOL = 1.1e-2
PROMPT_LENGTHS = (3, 11, 7)
NEW_TOKENS = 8
BATCH, MAX_LEN = 4, 64


def build_models(num_bits):
    jconfig = jllama.LlamaConfig.tiny()
    jq = jllama.quantize_model(jllama.init_params(jconfig, rng=0), num_bits, 64, fuse=True)
    tq = interop.params_from_numpy(to_numpy_tree(jq), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, jconfig.vocab_size, n).tolist() for n in PROMPT_LENGTHS]
    return jconfig, jq, llama.LlamaConfig.tiny(), tq, prompts


@pytest.fixture(scope="module")
def models():
    return build_models(4)


def left_pad(prompts, plen=16):
    """The engines' prefill block: prompts left-padded to the 16 bucket."""
    toks = np.zeros((BATCH, plen), np.int64)
    offsets = np.full((BATCH,), plen, np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
        offsets[i] = plen - len(p)
    return toks, offsets


def jax_trajectory(jconfig, jq, prompts):
    """JAX's greedy tokens [B, steps] and the logits [steps, B, V] that chose
    them, from the JAX engine's own compiled steps."""
    eng = JEngine(params=jq, config=jconfig, batch_size=BATCH, max_len=MAX_LEN)
    out = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
    toks, offsets = left_pad(prompts)
    offs = jnp.asarray(offsets, jnp.int32)
    logits, cache = eng._prefill(jq, jnp.asarray(toks, jnp.int32), eng._new_cache(), offs)
    steps = [np.asarray(logits)]
    for s in range(NEW_TOKENS - 1):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        logits, cache = eng._decode(jq, nxt, cache, jnp.int32(16 + s), offs)
        steps.append(np.asarray(logits))
    steps = np.stack(steps)
    tokens = steps.argmax(-1).T
    for i, o in enumerate(out):
        assert o == tokens[i].tolist()
    return tokens, steps


def port_teacher_forced(config, tq, prompts, tokens):
    eng = Engine(params=tq, config=config, batch_size=BATCH, max_len=MAX_LEN, device="cpu")
    toks, offsets = left_pad(prompts)
    offs = torch.from_numpy(offsets)
    logits, cache = eng.prefill(torch.from_numpy(toks), offs)
    steps = [logits.numpy()]
    for s in range(NEW_TOKENS - 1):
        logits, cache = eng.decode(torch.from_numpy(tokens[:, s:s + 1]), cache, 16 + s, offs)
        steps.append(logits.numpy())
    return np.stack(steps)


def check_greedy_matches_jax_engine(models):
    jconfig, jq, config, tq, prompts = models
    jtokens, jlogits = jax_trajectory(jconfig, jq, prompts)
    tlogits = port_teacher_forced(config, tq, prompts, jtokens)
    n = len(prompts)
    jl, tl = jlogits[:, :n], tlogits[:, :n]
    scale = np.abs(jl).max(axis=-1)  # [steps, n]
    assert (np.abs(tl - jl).max(axis=-1) / scale).max() < BF16_RTOL
    top2 = np.sort(jl, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * BF16_RTOL * scale  # [steps, n]
    assert decided.mean() > 0.5, "too many near-ties for the test to say anything"
    np.testing.assert_array_equal(
        np.where(decided, tl.argmax(-1), -1), np.where(decided, jtokens[:n].T, -1)
    )

    eng = Engine(params=tq, config=config, batch_size=BATCH, max_len=MAX_LEN, device="cpu")
    out = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
    assert [len(o) for o in out] == [NEW_TOKENS] * n
    for i, o in enumerate(out):
        first_tie = int(np.argmin(decided[:, i])) if not decided[:, i].all() else NEW_TOKENS
        assert o[:first_tie] == jtokens[i, :first_tie].tolist()
    assert len(eng.last_timings["decode_s"]) == NEW_TOKENS - 1


def test_greedy_matches_jax_engine(models):
    check_greedy_matches_jax_engine(models)


def test_greedy_matches_jax_engine_w3():
    jconfig, jq, config, tq, prompts = build_models(3)
    assert all(len(layer["down"].planes) == 1 for layer in tq["layers"])  # w3wide
    check_greedy_matches_jax_engine((jconfig, jq, config, tq, prompts))


def test_fused_loop_matches_engine(models):
    _, _, config, tq, _ = models
    rng = np.random.default_rng(8)
    prompts = rng.integers(1, config.vocab_size, (2, 16))
    fused = greedy_generate_fused(tq, config, torch.from_numpy(prompts), 5, max_len=32)
    eng = greedy_generate(tq, config, prompts.tolist(), 5, max_len=32, device="cpu")
    assert fused.tolist() == eng


def test_eos_and_batch_limit(models):
    _, _, config, tq, prompts = models
    eng = Engine(params=tq, config=config, batch_size=BATCH, max_len=MAX_LEN, device="cpu")
    first = eng.generate(prompts, max_new_tokens=2)
    eos = first[0][0]
    out = eng.generate(prompts, max_new_tokens=2, eos_id=eos)
    assert out[0] == []
    for o, f in zip(out[1:], first[1:]):
        assert o == [t for t in f if t != eos][:len(o)]
    with pytest.raises(ValueError):
        eng.generate(prompts * 2, max_new_tokens=1)


def test_sample_logits():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    best = torch.argmax(logits, dim=-1)
    assert torch.equal(sample_logits(logits, 0.0), best)
    gen = torch.Generator().manual_seed(1)
    assert torch.equal(sample_logits(logits, 1.0, top_k=1, generator=gen), best)
    assert torch.equal(sample_logits(logits, 1.0, top_p=1e-6, generator=gen), best)
    top3 = torch.topk(logits, 3, dim=-1).indices
    for _ in range(20):
        s = sample_logits(logits, 1.5, top_k=3, generator=gen)
        assert bool((top3 == s[:, None]).any(dim=-1).all())
    a = sample_logits(logits, 1.0, generator=torch.Generator().manual_seed(5))
    b = sample_logits(logits, 1.0, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
